"""The RWKV6 chunked wkv scan on the card (forward, from a zero state).

Replaces ``repro.kernels.rwkv6_scan.rwkv6_scan_pallas`` (the Pallas TPU
kernel).  The kernel is ``csrc/rwkv6_scan.cu``; its plain version is
:func:`repro_torch.kernels.ref.rwkv6_chunk_ref`.  It works in chunks of 16
tokens with the Pallas kernel's exponent clip (+-60), so it computes the
TPU kernel's function, clip included; with typical decays the clip never
fires and both equal the sequential recurrence.

The chunks are grouped into segments of ``SEGMENT_CHUNKS``, and three
launches run in order on the current stream: each segment's state from a
zero start and its decay product (parallel over batch, head and segment),
the carry of the state across segments (parallel over the state's
elements), then y from each segment's start state (parallel as the first).
The scratch between them (:func:`launch_plan`) is allocated here; the
products run on the tensor cores in 3xTF32.

r, k, v and decay are (B, H, S, hd), each with any strides but a
contiguous head dim: the model passes (B, S, H, hd) projections seen
through a transpose, and the kernel reads them in place; r, k, v share a
float32 or bfloat16 dtype, decay is either.  u is (H, hd), read once per
head.  y is allocated (B, S, H, hd) fp32 and returned as its (B, H, S, hd)
view, beside the fp32 (B, H, hd, hd) state after token S.  There is no
backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, router

HEAD_DIMS = (32, 64)
CHUNK = 16                   # tokens per chunk, the Pallas kernel's default
SEGMENT_CHUNKS = 8           # chunks per segment (L)
CARRY_THREADS = 256          # threads per block of the carry launch
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def _fn():
    if "rwkv6_scan" not in _fns:
        fn = build.library("rwkv6_scan").rwkv6_scan
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["rwkv6_scan"] = fn
    return _fns["rwkv6_scan"]


def launch_plan(b: int, h: int, s: int, hd: int,
                seg_chunks: int = SEGMENT_CHUNKS) -> dict:
    """The kernel's launches for a (B, H, S, hd) scan: chunks, segments
    of ``seg_chunks`` chunks (the last may be short), the (x, y, z) grids
    and block sizes of the segment passes (A and C: hd / 16 warps a block)
    and of the carry (B), and the scratch shapes (each segment's state,
    transposed, then its decay row), which the wrapper allocates as one
    fp32 buffer."""
    chunks = -(-s // CHUNK)
    segments = -(-chunks // seg_chunks)
    states = b * h * hd * hd
    return {"chunks": chunks, "seg_chunks": seg_chunks,
            "segments": segments,
            "segment_grid": (segments, h, b), "segment_threads": 2 * hd,
            "carry_grid": (-(-states // CARRY_THREADS), 1, 1),
            "carry_threads": CARRY_THREADS,
            "scratch": {"states": (b, h, segments, hd, hd),
                        "decays": (b, h, segments, hd)},
            "scratch_floats": b * h * segments * (hd * hd + hd)}


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 decay: torch.Tensor, u: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share a float32 or bfloat16 dtype, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if decay.dtype not in _DTYPES:
        raise TypeError(f"decay must be float32 or bfloat16, got "
                        f"{decay.dtype}")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == decay.shape):
        raise ValueError(f"need r, k, v, decay of one (B, H, S, hd) shape, "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(decay.shape)}")
    b, h, s, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u must be (H, hd) = {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if max(t.numel() for t in (r, k, v, decay)) >= 2 ** 31 \
            or max(b, h) >= 2 ** 16:
        raise ValueError("sizes past 2^31 elements, or 2^16 batch rows or "
                         "heads, are not supported")
    if any(t.stride(-1) != 1 for t in (r, k, v, decay)):
        raise ValueError("the head dim of r, k, v and decay must be "
                         "contiguous")


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    decay: torch.Tensor, u: torch.Tensor) -> tuple:
    """(B, H, S, hd) inputs, u (H, hd) -> (y (B, H, S, hd) fp32, state
    (B, H, hd, hd) fp32)."""
    return _scan(r, k, v, decay, u, SEGMENT_CHUNKS)


def _scan(r, k, v, decay, u, seg_chunks: int) -> tuple:
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, decay, u)):
        raise ValueError("rwkv6_scan_cuda takes r, k, v, decay and u on one "
                         "CUDA device")
    check_inputs(r, k, v, decay, u)
    b, h, s, hd = r.shape
    y = torch.empty((b, s, h, hd), dtype=torch.float32,
                    device=dev).transpose(1, 2)
    if s == 0 or y.numel() == 0:
        return y, torch.zeros((b, h, hd, hd), dtype=torch.float32,
                              device=dev)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    scratch = torch.empty(launch_plan(b, h, s, hd, seg_chunks)
                          ["scratch_floats"], dtype=torch.float32, device=dev)
    u32 = u.float().contiguous()
    strides = [st for t in (r, k, v, decay, y) for st in t.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                    decay.data_ptr(), u32.data_ptr(), y.data_ptr(),
                    state.data_ptr(), scratch.data_ptr(), b, h, s, hd,
                    seg_chunks, (ctypes.c_int64 * 15)(*strides),
                    _DTYPES[r.dtype],
                    _DTYPES[decay.dtype], stream)
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    router.count("rwkv6_scan")
    return y, state
