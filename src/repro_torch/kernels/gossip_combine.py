"""One tap-gossip round on the card: ``out[i] = sum_k w_k * m[src[k, i]]``.

Replaces ``repro.kernels.gossip_combine.gossip_combine_pallas`` (the Pallas
TPU kernel) and the tap rolls that build its (K, n, D) input stack: the
kernel ``csrc/gossip_combine.cu`` reads each neighbour row in place.  Its
plain version is :func:`repro_torch.kernels.ref.gossip_combine_ref`.  Each
output element costs K loads and one store, so device memory bounds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, router

MAX_TAPS = 8
MAX_ROWS = 46            # n rows x 256 tile columns + table fit in 48 KB
_fns: dict = {}


def check_out(m: torch.Tensor, out: torch.Tensor) -> None:
    """``out`` must be a contiguous fp32 buffer of m's shape, on m's
    device, apart from m: the round reads neighbour rows of m."""
    if (out.shape != m.shape or out.dtype != torch.float32
            or out.device != m.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {tuple(m.shape)} "
                         f"tensor on {m.device}")
    size = m.numel() * m.element_size()
    if abs(out.data_ptr() - m.data_ptr()) < size:
        raise ValueError("out must not overlap m")


def _fn():
    if "f32" not in _fns:
        fn = build.library("gossip_combine").gossip_combine_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return _fns["f32"]


def gossip_combine_cuda(m: torch.Tensor, src: torch.Tensor, weights,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """m: (n, D) fp32; src: (K, n) int32 rows; weights: K floats -> (n, D).

    ``out``, if given, is a contiguous (n, D) fp32 buffer that does not
    overlap ``m``; the result is written there (gossip rounds ping-pong
    between two buffers).
    """
    if m.device.type != "cuda" or src.device != m.device:
        raise ValueError("gossip_combine_cuda takes m and src on one CUDA "
                         "device")
    if m.dtype != torch.float32 or src.dtype != torch.int32:
        raise TypeError(f"need float32 m and int32 src, got {m.dtype} and "
                        f"{src.dtype}")
    if m.dim() != 2 or src.dim() != 2 or src.shape[1] != m.shape[0]:
        raise ValueError(f"need m (n, D) and src (K, n), got "
                         f"{tuple(m.shape)} and {tuple(src.shape)}")
    k, n = src.shape
    w = [float(x) for x in weights]
    if len(w) != k or not 1 <= k <= MAX_TAPS:
        raise ValueError(f"need 1..{MAX_TAPS} taps with one weight each, got "
                         f"{k} taps and {len(w)} weights")
    if n > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows (workers), got {n}")
    if not (m.is_contiguous() and src.is_contiguous()):
        raise ValueError("gossip_combine_cuda takes contiguous tensors")
    if out is None:
        out = torch.empty_like(m)
    else:
        check_out(m, out)
    c_w = (ctypes.c_float * k)(*w)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(m.data_ptr(), src.data_ptr(), c_w, out.data_ptr(), k, n,
                    m.shape[1], stream)
    if err:
        raise RuntimeError(f"gossip_combine kernel launch failed: CUDA error "
                           f"{err}")
    router.count("gossip_combine")
    return out
