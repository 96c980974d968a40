"""Online-softmax attention, forward, on the card (GQA, causal, window).

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the
Pallas TPU kernel).  The kernel is ``csrc/flash_attention.cu``; its plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`.  At prefill
shapes the arithmetic bounds it (about 4 hd flops per visible query-key
pair); this first version runs its products on the CUDA cores in fp32.

q is (B, H, Sq, hd) and k, v are (B, KV, Skv, hd), each with any strides
but a contiguous head dim: the model passes permuted views of its
(B, S, KV, G, hd) tensors and the kernel reads them in place.  The output
is allocated (B, Sq, H, hd) and returned as its (B, H, Sq, hd) view, so
the model's ``out.transpose(1, 2).reshape(B, Sq, H hd)`` is free.  There is
no backward kernel yet.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build, router

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
_fns: dict = {}


def softmax_scale(hd: int) -> float:
    """1/sqrt(hd) taken in double and rounded to fp32, as the Pallas kernel
    takes it; for hd in (32, 64, 128) it equals fp32 1 / fp32 sqrt(hd)."""
    return float(np.float32(1.0 / math.sqrt(hd)))


def _fn(dtype: torch.dtype):
    if dtype not in _fns:
        fn = getattr(build.library("flash_attention"), _DTYPES[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, q_offset: int) -> None:
    """Raise on what the kernel does not take."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a float32 or bfloat16 dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, Sq, hd) and k, v (B, KV, Skv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh < 1 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"form grouped-query attention")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if skv < 1:
        raise ValueError("need at least one key")
    if window < 0 or q_offset < 0:
        raise ValueError(f"need window >= 0 and q_offset >= 0, got {window} "
                         f"and {q_offset}")
    if max(q.numel(), k.numel(), q_offset + sq + max(skv, window)) >= 2 ** 31:
        raise ValueError("sizes past 2^31 are not supported")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, causal: bool, window: int,
                q_offset: int) -> tuple:
    """The C function's arguments after the four pointers: sizes, the 12
    (batch, head, seq) strides of q, k, v and out, scale and mask."""
    b, h, sq, hd = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    c_strides = (ctypes.c_int64 * 12)(*strides)
    return (b, h, k.shape[1], sq, k.shape[2], hd, c_strides,
            softmax_scale(hd), int(bool(causal)), int(window), int(q_offset))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """(B, H, Sq, hd) x (B, KV, Skv, hd) -> (B, H, Sq, hd) in q's dtype."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention_cuda takes q, k, v on one CUDA "
                         "device")
    check_inputs(q, k, v, window, q_offset)
    b, h, sq, hd = q.shape
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(),
                           *launch_args(q, k, v, out, causal, window,
                                        q_offset), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    router.count("flash_attention")
    return out
