"""GQA causal self-attention: training, prefill and KV-cache decode
(counterpart of ``repro.models.attention``: qk-norm, sliding windows,
linear and ring caches).

Queries are laid out (B, S, KV, G, hd): query head h = kv * G + g reads
KV head kv.  The JAX package computes the softmax blockwise (online
softmax, ``flash_attention``) in plain JAX, outside any Pallas kernel.
Here:

  * training (``attend_train``) is one masked softmax in plain torch ops,
    in fp32, with the same masking (causal, and the sliding window): it
    is differentiated, and the flash kernel has no backward yet.  The
    scores of one layer, (B, S, H, S) fp32, are 100 MB at the qwen2-1.5b
    session shape;
  * prefill (:func:`qkv_rope`, a token chunk at a time, then
    :func:`flash_prefill`) runs
    :func:`repro_torch.kernels.ops.flash_attention`, the hand-written
    kernel on the card, on permuted views of the (B, S, KV, G, hd)
    tensors, in query chunks of ``PREFILL_ROWS`` rows, each with the keys
    it can see (from ``window - 1`` before it under a window) and its
    ``q_offset``;
  * decode (``decode_attend``) attends one new token per row to its cache
    in plain torch, as the JAX package does outside any Pallas kernel; it
    writes the new K/V row into the cache in place.  A linear cache holds
    position p at row p; a ring cache (sliding window, capacity <= the
    window) at row p % capacity, and a row's validity follows from the
    absolute position it holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from .common import ArchConfig, apply_rope, init_linear, rms_norm

NEG_INF = -1e30
# query rows one flash call takes at prefill: keeps q under the kernel's
# 2^31-element limit at the long_500k shape (524,288 x 32 x 128)
PREFILL_ROWS = 65536


def attention_params(cfg: ArchConfig, generator: torch.Generator,
                     layers: int) -> dict:
    """Stacked (layers, ...) attention leaves, JAX names and layout."""
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt, dev = cfg.torch_dtype, generator.device
    p = {
        "wq": init_linear((layers, d, h * hd), dt, generator),
        "wk": init_linear((layers, d, kv * hd), dt, generator),
        "wv": init_linear((layers, d, kv * hd), dt, generator),
        "wo": init_linear((layers, h * hd, d), dt, generator),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((layers, h * hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((layers, kv * hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((layers, kv * hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((layers, hd), dtype=torch.float32,
                                 device=dev)
        p["k_norm"] = torch.ones((layers, hd), dtype=torch.float32,
                                 device=dev)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Returns q (B,S,KV,G,hd), k, v (B,S,KV,hd)."""
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    g = cfg.num_heads // kv
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.reshape(b, s, kv, g, hd), k.reshape(b, s, kv, hd)
    if "q_norm" in p:                          # per head, before rope
        q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
    return q, k, v.reshape(b, s, kv, hd)


def qkv_rope(p: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ArchConfig) -> tuple:
    """q (B,S,KV,G,hd), k, v (B,S,KV,hd), q and k rotated to
    ``positions``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q.reshape(b, s, -1, cfg.hd), positions,
                   cfg.rope_theta).reshape(q.shape)
    return q, apply_rope(k, positions, cfg.rope_theta), v


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd) -> (B,S,KV,G,hd) in q's dtype;
    ``window`` > 0 also masks keys ``window`` or more positions back."""
    s, hd = q.shape[1], q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    scores = torch.einsum("bqkgh,bckh->bqgkc", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    hidden = pos[None, :] > pos[:, None]                   # (q, c) future
    if window > 0:
        hidden |= (pos[:, None] - pos[None, :]) >= window
    scores = scores.masked_fill(hidden[None, :, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1).clamp(min=1e-30)
    out = torch.einsum("bqgkc,bckh->bqgkh", p, v.float()) / denom[..., None]
    return out.transpose(2, 3).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Causal attention of a prompt through the flash kernel: q
    (B,S,KV,G,hd), k/v (B,S,KV,hd) -> (B, S, H hd) in q's dtype.

    Queries go in chunks of ``PREFILL_ROWS`` rows; the chunk from row c
    reads keys from ``c - window + 1`` (under a window; else from 0) and
    passes the rows' offset into that slice as ``q_offset``, so every
    call stays under the kernel's size limit and no call reads a key its
    rows cannot see.
    """
    b, s, kvh, g, hd = q.shape
    # (B, KV, G, S, hd) merges to (B, H, S, hd) as a view: head kv G + g
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, hd)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if s <= PREFILL_ROWS:
        out = kops.flash_attention(qh, kh, vh, causal=True, window=window,
                                   q_offset=0)
        return out.transpose(1, 2).reshape(b, s, -1)
    out = q.new_empty((b, s, kvh * g, hd))
    for c0 in range(0, s, PREFILL_ROWS):
        c1 = min(c0 + PREFILL_ROWS, s)
        k0 = max(0, c0 - window + 1) if window > 0 else 0
        out[:, c0:c1] = kops.flash_attention(
            qh[:, :, c0:c1], kh[:, :, k0:c1], vh[:, :, k0:c1], causal=True,
            window=window, q_offset=c0 - k0).transpose(1, 2)
    return out.reshape(b, s, -1)


def attend_train(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence causal self-attention with rotary positions, masked
    to ``cfg.sliding_window`` when it is set."""
    b, s, _ = x.shape
    q, k, v = qkv_rope(p, x, positions, cfg)
    return causal_attention(q, k, v, cfg.sliding_window).reshape(
        b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """A KV cache: k, v (..., B, cap, KV, hd); ``ring`` selects the ring
    layout of sliding-window caches (position p at row p % cap)."""

    k: torch.Tensor
    v: torch.Tensor
    ring: bool = False


def init_cache(cfg: ArchConfig, batch: int, capacity: int, *, ring: bool,
               device) -> KVCache:
    shape = (batch, capacity, cfg.num_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                   ring)


def decode_attend(p: dict, x: torch.Tensor, pos, cache: KVCache,
                  cfg: ArchConfig, *, window: int = 0) -> tuple:
    """One-token decode.  x: (B, 1, d); pos: the current position.

    ``pos`` is a scalar (every row at one position) or a (B,) vector of
    per-row positions (the slot engine: each row writes its own cache row
    and masks its own valid prefix).  The new K/V row is written into
    ``cache`` in place, at row ``pos`` (linear; clamped to the last row)
    or ``pos % cap`` (ring); returns (out (B, 1, d), cache).
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    hd = cfg.hd
    pos = torch.as_tensor(pos, device=x.device)
    posq = pos.reshape(-1, 1)              # (B, 1) per row or (1, 1) shared
    q, k, v = qkv_rope(p, x, posq, cfg)

    cap = cache.k.shape[1]
    row = pos % cap if cache.ring else pos.clamp(0, cap - 1)
    if pos.dim() == 1:
        rows = torch.arange(b, device=x.device)
        cache.k[rows, row] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, row] = v[:, 0].to(cache.v.dtype)
    else:
        cache.k.index_copy_(1, row.reshape(1), k.to(cache.k.dtype))
        cache.v.index_copy_(1, row.reshape(1), v.to(cache.v.dtype))

    idx = torch.arange(cap, device=x.device)[None, :]
    if cache.ring:
        # row i holds the largest position p <= pos with p % cap == i
        abs_pos = posq - (posq - idx) % cap
        valid = (abs_pos >= 0) & (abs_pos <= posq)
    else:
        abs_pos = idx
        valid = idx <= posq
    if window > 0:
        valid &= (posq - abs_pos) < window
    root = torch.sqrt(torch.tensor(float(hd), device=x.device))
    scores = torch.einsum("bqkgh,bckh->bqgkc", q.float(),
                          cache.k.float()) / root
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqgkc,bckh->bqgkh", probs, cache.v.float())
    out = out.permute(0, 1, 3, 2, 4).reshape(b, 1, -1).to(x.dtype)
    return out @ p["wo"], cache
