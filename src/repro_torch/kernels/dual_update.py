"""The fused eq.-7 prox on the card: ``w = w0 - z * (0.5 / beta)``.

Replaces ``repro.kernels.dual_update.dual_update_pallas`` (the Pallas TPU
kernel).  The kernel is ``csrc/dual_update.cu``; its plain version is
:func:`repro_torch.kernels.ref.dual_update_ref`.  It moves 12 bytes per
element (10 with a bf16 anchor) for two flops, so device memory bounds it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, router

_DTYPES = {torch.float32: "dual_update_f32",
           torch.bfloat16: "dual_update_bf16"}
_fns: dict = {}


def _fn(dtype: torch.dtype):
    if dtype not in _fns:
        fn = getattr(build.library("dual_update"), _DTYPES[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def dual_update_cuda(z: torch.Tensor, w0: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """fp32 ``w0 - z * (0.5 / beta)`` of z's shape; z fp32, w0 fp32/bf16."""
    if z.device.type != "cuda" or w0.device != z.device:
        raise ValueError("dual_update_cuda takes z and w0 on one CUDA device")
    if z.dtype != torch.float32:
        raise TypeError(f"z must be float32, got {z.dtype}")
    if w0.dtype not in _DTYPES:
        raise TypeError(f"w0 must be float32 or bfloat16, got {w0.dtype}")
    if z.shape != w0.shape:
        raise ValueError(f"shape mismatch: z {tuple(z.shape)} vs w0 "
                         f"{tuple(w0.shape)}")
    if not (z.is_contiguous() and w0.is_contiguous()):
        raise ValueError("dual_update_cuda takes contiguous tensors")
    out = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(w0.dtype)(z.data_ptr(), w0.data_ptr(), out.data_ptr(),
                            float(beta), z.numel(), stream)
    if err:
        raise RuntimeError(f"dual_update kernel launch failed: CUDA error "
                           f"{err}")
    router.count("dual_update")
    return out
