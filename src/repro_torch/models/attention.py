"""GQA causal self-attention for training (counterpart of
``repro.models.attention``, train path).

Queries are laid out (B, S, KV, G, hd): query head h = kv * G + g reads
KV head kv.  The JAX package computes the softmax blockwise (online
softmax, ``flash_attention``) in plain JAX, outside any Pallas kernel; here
it is one masked softmax in plain torch ops, in fp32, with the same
masking.  The scores of one layer, (B, S, H, S) fp32, are 100 MB at the
qwen2-1.5b session shape.
"""
from __future__ import annotations

import numpy as np
import torch

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
                 cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence causal self-attention with rotary positions."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q.reshape(b, s, -1, cfg.hd), positions,
                   cfg.rope_theta).reshape(q.shape)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = causal_attention(q, k, v)
    return out.reshape(b, s, -1) @ p["wo"]
