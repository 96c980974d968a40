"""GQA attention: training, prefill and KV-cache decode (counterpart of
``repro.models.attention``: qk-norm, sliding windows, linear and ring
caches, and whisper's non-causal encoder and cross-attention).

Queries are laid out (B, S, KV, G, hd): query head h = kv * G + g reads
KV head kv.  The JAX package computes the softmax blockwise (online
softmax, ``flash_attention``) in plain JAX, outside any Pallas kernel.
Here:

  * training (``attend_train``) is one masked softmax in plain torch ops,
    in fp32, with the same masking (causal or not, and the sliding
    window; Sq may differ from Skv): it is differentiated, and the flash
    kernel has no backward yet.  The scores of one layer, (B, Sq, H, Skv)
    fp32, are 100 MB at the qwen2-1.5b session shape and 2.3 GB in
    whisper's encoder (32 x 1500 frames);
  * prefill (:func:`qkv_rope`, a token chunk at a time, then
    :func:`flash_prefill`) runs
    :func:`repro_torch.kernels.ops.flash_attention`, the hand-written
    kernel on the card, on permuted views of the (B, S, KV, G, hd)
    tensors, in query chunks of ``PREFILL_ROWS`` rows, each with the keys
    it can see (from ``window - 1`` before it under a window; every key
    when not causal) and its ``q_offset``;
  * decode (``decode_attend``) attends one new token per row to its cache
    in plain torch, as the JAX package does outside any Pallas kernel; it
    writes the new K/V row into the cache in place.  A linear cache holds
    position p at row p; a ring cache (sliding window, capacity <= the
    window) at row p % capacity, and a row's validity follows from the
    absolute position it holds.  With ``cross_kv`` it is whisper's
    cross-attention: q unroped against the encoder's fixed K and V, every
    row valid, the cache untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kops
from .common import ArchConfig, apply_rope, init_linear, rms_norm

NEG_INF = -1e30
# query rows one flash call takes at prefill: keeps q under the kernel's
# 2^31-element limit at the long_500k shape (524,288 x 32 x 128)
PREFILL_ROWS = 65536


def attention_plan(cfg: ArchConfig, layers: int, *,
                   cross: bool = False) -> list:
    """``(name, make(generator))`` of the stacked (layers, ...) attention
    leaves in draw order, JAX names and layout; a cross-attention
    (``cross``) never takes the QKV bias."""
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.torch_dtype

    def linear(shape):
        return lambda g: init_linear(shape, dt, g)

    def const(fill, shape, dtype):
        return lambda g: torch.full(shape, fill, dtype=dtype,
                                    device=g.device)

    plan = [("wq", linear((layers, d, h * hd))),
            ("wk", linear((layers, d, kv * hd))),
            ("wv", linear((layers, d, kv * hd))),
            ("wo", linear((layers, h * hd, d)))]
    if cfg.qkv_bias and not cross:
        plan += [("bq", const(0.0, (layers, h * hd), dt)),
                 ("bk", const(0.0, (layers, kv * hd), dt)),
                 ("bv", const(0.0, (layers, kv * hd), dt))]
    if cfg.qk_norm:
        plan += [("q_norm", const(1.0, (layers, hd), torch.float32)),
                 ("k_norm", const(1.0, (layers, hd), torch.float32))]
    return plan


def attention_params(cfg: ArchConfig, generator: torch.Generator,
                     layers: int, *, cross: bool = False) -> dict:
    """Stacked (layers, ...) attention leaves, JAX names and layout; a
    cross-attention (``cross``) never takes the QKV bias."""
    return {k: make(generator)
            for k, make in attention_plan(cfg, layers, cross=cross)}


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 kv_input: Optional[torch.Tensor] = None, tp=None):
    """Returns q (B,S,KV,G,hd), k, v (B,Skv,KV,hd); k and v project
    ``kv_input`` (cross-attention) when it is given, else x.  KV and G
    are the heads the leaves of ``p`` hold: all, or a model rank's share
    (with ``tp``, whose ranks that share a KV head gather its columns
    here, before the reshape, the qk-norm and the rope)."""
    b, s, _ = x.shape
    hd = cfg.hd
    xkv = x if kv_input is None else kv_input
    skv = xkv.shape[1]
    q, k, v = x @ p["wq"], xkv @ p["wk"], xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if tp is not None:
        k, v = tp.gather_kv(k, v)
    kvh = k.shape[-1] // hd
    q, k = q.reshape(b, s, kvh, -1, hd), k.reshape(b, skv, kvh, hd)
    if "q_norm" in p:                          # per head, before rope
        q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
    return q, k, v.reshape(b, skv, kvh, hd)


def qkv_rope(p: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ArchConfig, tp=None) -> tuple:
    """q (B,S,KV,G,hd), k, v (B,S,KV,hd), q and k rotated to
    ``positions``; KV is the heads the leaves of ``p`` hold (all, or a
    model rank's share: its blocks of ``wq``/``wk``/``wv``, its KV head
    gathered through ``tp``)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, tp=tp)
    q = apply_rope(q.reshape(b, s, -1, cfg.hd), positions,
                   cfg.rope_theta).reshape(q.shape)
    return q, apply_rope(k, positions, cfg.rope_theta), v


def _softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    hidden: torch.Tensor) -> torch.Tensor:
    """The masked softmax of q (B,Sq,KV,G,hd) over k/v (B,Skv,KV,hd) in
    fp32, ``hidden`` (1 or B, Sq, Skv) True where a key is masked; out
    (B,Sq,KV,G,hd) in q's dtype."""
    hd = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    scores = torch.einsum("bqkgh,bckh->bqgkc", q.float(), k.float()) * scale
    scores = scores.masked_fill(hidden[:, :, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1).clamp(min=1e-30)
    out = torch.einsum("bqgkc,bckh->bqgkh", p, v.float()) / denom[..., None]
    return out.transpose(2, 3).to(q.dtype)


def _hidden(qpos: torch.Tensor, skv: int, causal: bool,
            window: int) -> torch.Tensor:
    """(Sq, Skv) True where key j is masked for the query at ``qpos``."""
    qpos = qpos[:, None]
    kpos = torch.arange(skv, device=qpos.device)[None, :]
    hidden = torch.zeros((qpos.shape[0], skv), dtype=torch.bool,
                         device=qpos.device)
    if causal:
        hidden |= kpos > qpos                              # (q, c) future
    if window > 0:
        hidden |= (qpos - kpos) >= window
    return hidden


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int = 0, *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,KV,G,hd), k/v (B,Skv,KV,hd) -> (B,Sq,KV,G,hd) in q's dtype,
    query i at position i and key j at j: ``causal`` masks keys past the
    query, ``window`` > 0 keys ``window`` or more positions back."""
    qpos = torch.arange(q.shape[1], device=q.device)
    return _softmax_attend(q, k, v,
                           _hidden(qpos, k.shape[1], causal, window)[None])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, q_offset=0,
                    kv_valid: Optional[torch.Tensor] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    accum_dtype=None) -> torch.Tensor:
    """JAX's ``flash_attention`` signature and layout: q (B, Sq, KV, G,
    hd), k and v (B, Skv, KV, hd) -> (B, Sq, KV, G, hd) in q's dtype.

    ``q_offset`` (an int or a 0-d tensor) is the absolute position of
    q[:, 0] against the keys at 0 .. Skv - 1; ``kv_valid`` (B, Skv) bool
    masks the cache slots that hold no token.  The body is the plain
    masked softmax of :func:`masked_attention` in fp32 (one score tensor,
    no blocks: ``q_chunk``, ``kv_chunk`` and ``accum_dtype`` are JAX's
    blocking and change nothing here).  Not a kernel route: the prefill
    reaches the CUDA kernel through :func:`flash_prefill`."""
    qpos = torch.as_tensor(q_offset, device=q.device) \
        + torch.arange(q.shape[1], device=q.device)
    hidden = _hidden(qpos, k.shape[1], causal, window)[None]
    if kv_valid is not None:
        hidden = hidden | ~kv_valid.to(torch.bool)[:, None, :]
    return _softmax_attend(q, k, v, hidden)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, *, causal: bool = True) -> torch.Tensor:
    """Attention of a prompt through the flash kernel: q (B,Sq,KV,G,hd),
    k/v (B,Skv,KV,hd) -> (B, Sq, H hd) in q's dtype (query i at position
    i, key j at j, as :func:`masked_attention`).

    Queries go in chunks of ``PREFILL_ROWS`` rows; the chunk of rows c0
    to c1 reads keys from ``c0 - window + 1`` (under a window; else from
    0) to c1 (causal; else to Skv) and passes the rows' offset into that
    slice as ``q_offset``, so every call stays under the kernel's size
    limit and no call reads a key its rows cannot see.
    """
    b, s, kvh, g, hd = q.shape
    skv = k.shape[1]
    # (B, KV, G, S, hd) merges to (B, H, S, hd) as a view: head kv G + g
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, hd)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if s <= PREFILL_ROWS:
        out = kops.flash_attention(qh, kh, vh, causal=causal, window=window,
                                   q_offset=0)
        return out.transpose(1, 2).reshape(b, s, -1)
    out = q.new_empty((b, s, kvh * g, hd))
    for c0 in range(0, s, PREFILL_ROWS):
        c1 = min(c0 + PREFILL_ROWS, s)
        k0 = max(0, c0 - window + 1) if window > 0 else 0
        k1 = c1 if causal else skv
        out[:, c0:c1] = kops.flash_attention(
            qh[:, :, c0:c1], kh[:, :, k0:k1], vh[:, :, k0:k1], causal=causal,
            window=window, q_offset=c0 - k0).transpose(1, 2)
    return out.reshape(b, s, -1)


def attend_train(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig, *, causal: bool = True,
                 window: Optional[int] = None,
                 kv_input: Optional[torch.Tensor] = None,
                 rope: bool = True, return_kv: bool = False, tp=None,
                 prefix: str = "blocks.attn."):
    """Full-sequence attention (training; whisper's encoder and
    cross-attention too): rotary positions unless ``rope`` is off (the
    keys of ``kv_input`` at 0..Skv-1), masked causally unless ``causal``
    is off and to ``window`` (default ``cfg.sliding_window``).  With
    ``return_kv`` also the (roped) k and v, (B, Skv, KV, hd): the decode
    cache's contents after a prefill of this sequence.  With ``tp`` this
    rank's heads, column-parallel ``wq``/``wk``/``wv`` and row-parallel
    ``wo`` (:class:`repro_torch.dist.tp.TensorParallel`; ``prefix`` names
    the leaves, ``"blocks.xattn."`` for whisper's cross-attention, whose
    ``kv_input`` every model rank holds whole and reads with its own
    columns of ``wk`` and ``wv``: it enters through ``tp.copy`` too)."""
    b, s, _ = x.shape
    if tp is not None:
        p, x = tp.attention(p, x, prefix)
        if kv_input is not None and tp.split(prefix + "wk"):
            kv_input = tp.copy(kv_input)
    q, k, v = _project_qkv(p, x, cfg, kv_input, tp)
    if rope:
        kv_pos = positions if kv_input is None else torch.arange(
            k.shape[1], device=x.device)
        q = apply_rope(q.reshape(b, s, -1, cfg.hd), positions,
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    window = cfg.sliding_window if window is None else window
    out = masked_attention(q, k, v, window, causal=causal).reshape(
        b, s, -1) @ p["wo"]
    if tp is not None:
        out = tp.attention_out(out, prefix)
    return (out, (k, v)) if return_kv else out


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


def _softmax_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> torch.Tensor:
    """One query per row: q (B,1,KV,G,hd) against k/v (B,C,KV,hd) in fp32,
    keys masked where the (B|1, C) ``valid`` is false -> (B, 1, H hd)
    fp32."""
    b, hd = q.shape[0], q.shape[-1]
    root = torch.sqrt(torch.tensor(float(hd), device=q.device))
    scores = torch.einsum("bqkgh,bckh->bqgkc", q.float(), k.float()) / root
    if valid is not None:
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqgkc,bckh->bqgkh", probs, v.float())
    return out.permute(0, 1, 3, 2, 4).reshape(b, 1, -1)


def decode_attend(p: dict, x: torch.Tensor, pos, cache: KVCache,
                  cfg: ArchConfig, *, window: int = 0,
                  cross_kv: Optional[tuple] = None, cross_len: int = 0,
                  tp=None) -> tuple:
    """One-token decode.  x: (B, 1, d); pos: the current position.  The
    heads are those the leaves of ``p`` and the cache hold (all, or a
    model rank's share; ``tp`` gathers a KV head its ranks share).

    ``pos`` is a scalar (every row at one position) or a (B,) vector of
    per-row positions (the slot engine: each row writes its own cache row
    and masks its own valid prefix).  The new K/V row is written into
    ``cache`` in place, at row ``pos`` (linear; clamped to the last row)
    or ``pos % cap`` (ring); returns (out (B, 1, d), cache).  With
    ``cross_kv = (k, v)``, each (B, Skv, KV, hd), this is cross-attention
    against the encoder's K and V (whisper): q is not roped, every key is
    valid, and ``cache`` is returned untouched.  ``cross_len`` is taken
    and not read, as in JAX, whose body never reads it either.  With
    ``tp`` the cross-attention reads this rank's heads of ``cross_kv``.
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    if cross_kv is not None:
        g = cfg.num_heads // cfg.num_kv_heads
        q = (x @ p["wq"]).reshape(b, 1, -1, g, cfg.hd)
        if "q_norm" in p:
            q = rms_norm(q, p["q_norm"])
        out = _softmax_read(q, *cross_kv, None).to(x.dtype)
        return out @ p["wo"], cache
    pos = torch.as_tensor(pos, device=x.device)
    posq = pos.reshape(-1, 1)              # (B, 1) per row or (1, 1) shared
    q, k, v = qkv_rope(p, x, posq, cfg, tp)

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
    out = _softmax_read(q, cache.k, cache.v, valid).to(x.dtype)
    return out @ p["wo"], cache
