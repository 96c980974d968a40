"""GQA causal self-attention: training, prefill and KV-cache decode
(counterpart of ``repro.models.attention``, linear caches).

Queries are laid out (B, S, KV, G, hd): query head h = kv * G + g reads
KV head kv.  The JAX package computes the softmax blockwise (online
softmax, ``flash_attention``) in plain JAX, outside any Pallas kernel.
Here:

  * training (``attend_train``) is one masked softmax in plain torch ops,
    in fp32, with the same masking: it is differentiated, and the flash
    kernel has no backward yet.  The scores of one layer, (B, S, H, S)
    fp32, are 100 MB at the qwen2-1.5b session shape;
  * prefill (``attend_train(..., return_kv=True)``) runs
    :func:`repro_torch.kernels.ops.flash_attention`, the hand-written
    kernel on the card, on permuted views of the (B, S, KV, G, hd)
    tensors;
  * decode (``decode_attend``) attends one new token per row to its
    linear cache in plain torch, as the JAX package does outside any
    Pallas kernel; it writes the new K/V row into the cache in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from .common import ArchConfig, apply_rope, init_linear

NEG_INF = -1e30


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
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Returns q (B,S,KV,G,hd), k, v (B,S,KV,hd)."""
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    g = cfg.num_heads // kv
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, kv, g, hd), k.reshape(b, s, kv, hd),
            v.reshape(b, s, kv, hd))


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd) -> (B,S,KV,G,hd) in q's dtype."""
    s, hd = q.shape[1], q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    scores = torch.einsum("bqkgh,bckh->bqgkc", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    future = pos[None, :] > pos[:, None]                   # (q, c)
    scores = scores.masked_fill(future[None, :, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1).clamp(min=1e-30)
    out = torch.einsum("bqgkc,bckh->bqgkh", p, v.float()) / denom[..., None]
    return out.transpose(2, 3).to(q.dtype)


def attend_train(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig, *, return_kv: bool = False):
    """Full-sequence causal self-attention with rotary positions.

    With ``return_kv`` (prefill) the attention runs the flash kernel and
    the roped k and v, (B, S, KV, hd) each, come back too: the decode cache
    contents after a prefill of this sequence.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q.reshape(b, s, -1, cfg.hd), positions,
                   cfg.rope_theta).reshape(q.shape)
    k = apply_rope(k, positions, cfg.rope_theta)
    if not return_kv:
        return causal_attention(q, k, v).reshape(b, s, -1) @ p["wo"]
    # (B, KV, G, S, hd) merges to (B, H, S, hd) as a view: head kv G + g
    out = kops.flash_attention(
        q.permute(0, 2, 3, 1, 4).reshape(b, -1, s, cfg.hd),
        k.transpose(1, 2), v.transpose(1, 2), causal=True, window=0,
        q_offset=0)
    out = out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]
    return out, (k, v)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """A KV cache: k, v (..., B, cap, KV, hd); ``ring`` selects the ring
    layout of sliding-window caches, which is not ported."""

    k: torch.Tensor
    v: torch.Tensor
    ring: bool = False


def init_cache(cfg: ArchConfig, batch: int, capacity: int, *, ring: bool,
               device) -> KVCache:
    if ring:
        raise NotImplementedError("ring (sliding-window) KV caches are not "
                                  "ported")
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
    ``cache`` in place; returns (out (B, 1, d), cache).
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    if cache.ring:
        raise NotImplementedError("ring (sliding-window) KV caches are not "
                                  "ported")
    hd = cfg.hd
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    posq = pos.reshape(-1, 1)              # (B, 1) per row or (1, 1) shared
    q = apply_rope(q.reshape(b, 1, -1, hd), posq,
                   cfg.rope_theta).reshape(q.shape)
    k = apply_rope(k, posq, cfg.rope_theta)

    cap = cache.k.shape[1]
    row = pos.clamp(0, cap - 1)
    if pos.dim() == 1:
        rows = torch.arange(b, device=x.device)
        cache.k[rows, row] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, row] = v[:, 0].to(cache.v.dtype)
    else:
        cache.k.index_copy_(1, row.reshape(1), k.to(cache.k.dtype))
        cache.v.index_copy_(1, row.reshape(1), v.to(cache.v.dtype))

    idx = torch.arange(cap, device=x.device)[None, :]
    valid = idx <= posq
    if window > 0:
        valid &= (posq - idx) < window
    root = torch.sqrt(torch.tensor(float(hd), device=x.device))
    scores = torch.einsum("bqkgh,bckh->bqgkc", q.float(),
                          cache.k.float()) / root
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqgkc,bckh->bqgkh", probs, cache.v.float())
    out = out.permute(0, 1, 3, 2, 4).reshape(b, 1, -1).to(x.dtype)
    return out @ p["wo"], cache
