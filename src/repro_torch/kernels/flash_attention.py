"""Online-softmax attention, forward, on the card (GQA, causal, window).

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the
Pallas TPU kernel).  Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.  At prefill shapes the
arithmetic bounds it (about 4 hd flops per visible query-key pair).  Two
kernel bodies compute it, and :func:`body` picks one per call:

  * ``"tensor_core"``, ``csrc/flash_attention_sm90.cu``: bf16 q, k, v that
    TMA can read (base addresses and batch, head and sequence strides
    positive multiples of 16 bytes), which every call of the model is;
    products on the tensor cores (``wgmma``), tiles loaded by TMA;
  * ``"cuda_core"``, ``csrc/flash_attention.cu``: everything else (fp32,
    rows that are not 16-byte aligned); products on the CUDA cores in fp32.

Both raise if they fail to build or launch; neither falls back to the
plain version.  Each launch counts under ``flash_attention`` and under
``flash_attention.<body>``.

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
from typing import Optional

import numpy as np
import torch

from . import build, router

HEAD_DIMS = (32, 64, 128)
BODIES = ("tensor_core", "cuda_core")
_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
_fns: dict = {}
# the tensor-core body's tiles: 128 query rows, 128 keys; TMA boxes of at
# most 64 columns (128 bytes, the widest swizzle)
TC_ROWS = 128
TC_BOX_COLS = 64


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


def _fn_sm90():
    if "sm90" not in _fns:
        fn = build.library("flash_attention_sm90").flash_attention_sm90_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_int64)] * 2
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["sm90"] = fn
    return _fns["sm90"]


def _tma_readable(t: torch.Tensor) -> bool:
    nbytes = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * nbytes % 16 == 0 for s in t.stride()[:3])


def body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel body takes these (checked) inputs: ``"tensor_core"``
    for bf16 q, k, v whose base addresses and batch, head and sequence
    strides are positive multiples of 16 bytes, else ``"cuda_core"``."""
    if q.dtype == torch.bfloat16 and all(_tma_readable(t) for t in (q, k, v)):
        return "tensor_core"
    return "cuda_core"


def tma_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list:
    """The tensor maps of q, k and v, 9 values each: dims (hd, S, heads,
    B) innermost first, the byte strides of S, heads and B, and the box
    (columns, rows) that one TMA load copies."""
    args = []
    for t in (q, k, v):
        b, heads, s, hd = t.shape
        nbytes = t.element_size()
        sb, sh, ss = t.stride()[:3]
        args += [hd, s, heads, b, ss * nbytes, sh * nbytes, sb * nbytes,
                 min(hd, TC_BOX_COLS), TC_ROWS]
    return args


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
                         q_offset: int = 0,
                         force_body: Optional[str] = None) -> torch.Tensor:
    """(B, H, Sq, hd) x (B, KV, Skv, hd) -> (B, H, Sq, hd) in q's dtype.

    ``force_body="cuda_core"`` runs the CUDA-core body on inputs that
    :func:`body` would give the tensor cores (``chip_smoke.py`` times the
    two side by side); the tensor-core body takes only what it can read.
    """
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention_cuda takes q, k, v on one CUDA "
                         "device")
    check_inputs(q, k, v, window, q_offset)
    which = body(q, k, v)
    if force_body is not None:
        if force_body not in BODIES:
            raise ValueError(f"unknown body {force_body!r}; choose from "
                             f"{BODIES}")
        if force_body == "tensor_core" and which != "tensor_core":
            raise ValueError("the tensor-core body takes bf16 q, k, v with "
                             "16-byte aligned rows only")
        which = force_body
    b, h, sq, hd = q.shape
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if which == "tensor_core":
            maps = (ctypes.c_int64 * 27)(*tma_args(q, k, v))
            o_strides = (ctypes.c_int64 * 3)(*out.stride()[:3])
            err = _fn_sm90()(*ptrs, b, h, k.shape[1], sq, k.shape[2], hd,
                             maps, o_strides, softmax_scale(hd),
                             int(bool(causal)), int(window), int(q_offset),
                             stream)
        else:
            err = _fn(q.dtype)(*ptrs, *launch_args(q, k, v, out, causal,
                                                   window, q_offset), stream)
    if err:
        what = (f"tensor map encode failed: CUresult {err - 1000}"
                if which == "tensor_core" and err >= 1000
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {which} kernel launch failed: "
                           f"{what}")
    router.count("flash_attention")
    router.count(f"flash_attention.{which}")
    return out
