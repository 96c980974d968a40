"""The send half of a quantized gossip round on the card.

Replaces ``repro.kernels.gossip_combine.stochastic_quantize_pallas`` (the
Pallas TPU kernel).  The kernel is ``csrc/stochastic_quantize.cu``; its
plain version is :func:`repro_torch.kernels.ref.stochastic_quantize_ref`.
It moves 17 bytes per element (m, h and the draws in; the uint8 level and
the new replica out), so device memory bounds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, router

_fns: dict = {}


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the storage spans of two tensors intersect."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def check_dest(dest: torch.Tensor, like: torch.Tensor, dtype: torch.dtype,
               name: str, may_be: Optional[torch.Tensor],
               apart_from) -> None:
    """``dest`` is a contiguous ``dtype`` buffer of ``like``'s shape and
    device that is ``may_be`` itself or overlaps none of ``apart_from``."""
    if (dest.shape != like.shape or dest.dtype != dtype
            or dest.device != like.device or not dest.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{tuple(like.shape)} tensor on {like.device}")
    if may_be is not None and dest.data_ptr() == may_be.data_ptr():
        return
    if any(overlaps(dest, x) for x in apart_from):
        raise ValueError(f"{name} overlaps an input it must not")


def check_quantize_out(m, h, rnd, out) -> tuple:
    """``out = (lvl, h_new)``: an (n, D) uint8 plane apart from every
    input, and an (n, D) fp32 buffer that is h itself or apart from m, h
    and rnd.  None allocates both."""
    if out is None:
        return (torch.empty(m.shape, dtype=torch.uint8, device=m.device),
                torch.empty(m.shape, dtype=torch.float32, device=m.device))
    lvl, h_new = out
    check_dest(h_new, m, torch.float32, "h_new", h, (m, h, rnd))
    check_dest(lvl, m, torch.uint8, "lvl", None, (m, h, rnd, h_new))
    return lvl, h_new


def _fn():
    if "f32" not in _fns:
        fn = build.library("stochastic_quantize").stochastic_quantize_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return _fns["f32"]


def stochastic_quantize_cuda(m: torch.Tensor, h: torch.Tensor,
                             rnd: torch.Tensor, lo: torch.Tensor,
                             scale: torch.Tensor, levels: float,
                             out: Optional[tuple] = None) -> tuple:
    """m, h, rnd: (n, D) fp32; lo, scale: n fp32 -> (lvl uint8, h_new).

    ``out``, if given, is ``(lvl, h_new)``; ``h_new`` may be ``h`` itself
    (the replica is then updated in place).
    """
    if m.device.type != "cuda" or any(
            x.device != m.device for x in (h, rnd, lo, scale)):
        raise ValueError("stochastic_quantize_cuda takes its tensors on one "
                         "CUDA device")
    if any(x.dtype != torch.float32 for x in (m, h, rnd, lo, scale)):
        raise TypeError("stochastic_quantize_cuda takes float32 tensors")
    if m.dim() != 2 or h.shape != m.shape or rnd.shape != m.shape:
        raise ValueError(f"need m, h, rnd of one (n, D) shape, got "
                         f"{tuple(m.shape)}, {tuple(h.shape)}, "
                         f"{tuple(rnd.shape)}")
    n, d = m.shape
    if lo.numel() != n or scale.numel() != n:
        raise ValueError(f"need {n} row grids, got lo {tuple(lo.shape)} and "
                         f"scale {tuple(scale.shape)}")
    if not 1 <= n <= 65535:
        raise ValueError(f"need 1..65535 rows, got {n}")
    if not all(x.is_contiguous() for x in (m, h, rnd, lo, scale)):
        raise ValueError("stochastic_quantize_cuda takes contiguous tensors")
    lvl, h_new = check_quantize_out(m, h, rnd, out)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(m.data_ptr(), h.data_ptr(), rnd.data_ptr(), lo.data_ptr(),
                    scale.data_ptr(), lvl.data_ptr(), h_new.data_ptr(),
                    float(levels), n, d, stream)
    if err:
        raise RuntimeError(f"stochastic_quantize kernel launch failed: CUDA "
                           f"error {err}")
    router.count("stochastic_quantize")
    return lvl, h_new
