"""The receive half of a quantized gossip round on the card.

Replaces ``repro.kernels.gossip_combine.quantized_combine_pallas`` (the
Pallas TPU kernel) and the tap rolls of the level plane and grid scalars
that feed it: the kernel ``csrc/quantized_combine.cu`` reads each
neighbour's levels in place through the (K, n_out) source-row table.  Its
plain version is :func:`repro_torch.kernels.ref.quantized_combine_ref`.
For a ring (K = 3) an element moves 25 bytes for 4 K flops, so device
memory bounds it.

``m`` and the replicas hold the n_out output rows and the table names
rows of the n_src level rows ``lvl`` (and their grids ``lo``, ``scale``):
a process holding all n workers passes the (n, D) plane every worker sent
and the (K, n) table; a process per worker passes its (1, D) row, the (K,
D) levels it holds (its own, then the K - 1 it received, in tap order) and
the (K, 1) table of :func:`repro_torch.kernels.gossip_combine.
own_row_table`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, router
from .stochastic_quantize import check_dest

MAX_TAPS = 8
_fns: dict = {}


def check_combine_out(m, hnbr, lvl, out) -> tuple:
    """``out = (out, hnbr_new)``: an (n, D) fp32 buffer that is m itself or
    apart from m, hnbr and lvl, and a (K-1, n, D) fp32 buffer that is hnbr
    itself or apart from every other operand.  None allocates both."""
    if out is None:
        return (torch.empty(m.shape, dtype=torch.float32, device=m.device),
                torch.empty(hnbr.shape, dtype=torch.float32,
                            device=hnbr.device))
    res, hnbr_new = out
    check_dest(res, m, torch.float32, "out", m, (m, hnbr, lvl))
    check_dest(hnbr_new, hnbr, torch.float32, "hnbr_new", hnbr,
               (m, hnbr, lvl, res))
    return res, hnbr_new


def _fn():
    if "f32" not in _fns:
        fn = build.library("quantized_combine").quantized_combine_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return _fns["f32"]


def quantized_combine_cuda(m: torch.Tensor, hnbr: torch.Tensor,
                           lvl: torch.Tensor, lo: torch.Tensor,
                           scale: torch.Tensor, src: torch.Tensor, weights,
                           out: Optional[tuple] = None) -> tuple:
    """m: (n_out, D) fp32; hnbr: (K-1, n_out, D) fp32; lvl: (n_src, D)
    uint8; lo, scale: n_src fp32; src: (K, n_out) int32 rows of lvl, self
    tap first; weights: K floats -> (out (n_out, D), hnbr_new (K-1, n_out,
    D)).

    ``out``, if given, is ``(out, hnbr_new)``; ``out`` may be ``m`` and
    ``hnbr_new`` may be ``hnbr`` (the round then runs in place).  Every
    entry of ``src`` must name a row of ``lvl`` (the table lives on the
    card and is not read back).
    """
    if m.device.type != "cuda" or any(
            x.device != m.device for x in (hnbr, lvl, lo, scale, src)):
        raise ValueError("quantized_combine_cuda takes its tensors on one "
                         "CUDA device")
    if any(x.dtype != torch.float32 for x in (m, hnbr, lo, scale)) \
            or lvl.dtype != torch.uint8 or src.dtype != torch.int32:
        raise TypeError("need float32 m, hnbr, lo, scale, uint8 lvl and "
                        "int32 src")
    if m.dim() != 2 or lvl.dim() != 2 or lvl.shape[1] != m.shape[1] \
            or src.dim() != 2 or src.shape[1] != m.shape[0]:
        raise ValueError(f"need m (n_out, D), lvl (n_src, D) and src (K, "
                         f"n_out), got {tuple(m.shape)}, {tuple(lvl.shape)} "
                         f"and {tuple(src.shape)}")
    k, n = src.shape
    n_src, d = lvl.shape
    w = [float(x) for x in weights]
    if len(w) != k or not 1 <= k <= MAX_TAPS:
        raise ValueError(f"need 1..{MAX_TAPS} taps with one weight each, got "
                         f"{k} taps and {len(w)} weights")
    if hnbr.shape != (k - 1, n, d):
        raise ValueError(f"need hnbr {(k - 1, n, d)}, got "
                         f"{tuple(hnbr.shape)}")
    if lo.numel() != n_src or scale.numel() != n_src \
            or not 1 <= n <= 65535:
        raise ValueError(f"need 1..65535 output rows and one grid per level "
                         f"row, got {n} output rows, {n_src} level rows, lo "
                         f"{tuple(lo.shape)}, scale {tuple(scale.shape)}")
    if not all(x.is_contiguous() for x in (m, hnbr, lvl, lo, scale, src)):
        raise ValueError("quantized_combine_cuda takes contiguous tensors")
    res, hnbr_new = check_combine_out(m, hnbr, lvl, out)
    c_w = (ctypes.c_float * k)(*w)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(m.data_ptr(), hnbr.data_ptr(), hnbr_new.data_ptr(),
                    lvl.data_ptr(), lo.data_ptr(), scale.data_ptr(),
                    src.data_ptr(), c_w, res.data_ptr(), k, n, n_src, d,
                    stream)
    if err:
        raise RuntimeError(f"quantized_combine kernel launch failed: CUDA "
                           f"error {err}")
    router.count("quantized_combine")
    return res, hnbr_new
