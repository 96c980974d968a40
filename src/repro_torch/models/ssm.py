"""RWKV6 ("Finch") time-mix with data-dependent per-channel decay.

Counterpart of the RWKV6 half of ``repro.models.ssm`` (Mamba2 is not
ported).  The wkv recurrence runs in two forms:

  * prefill and training, :func:`rwkv6_forward`: under autograd the plain
    chunked scan :func:`rwkv6_chunked_scan` at ``cfg.ssm_chunk`` (the JAX
    model's own ``lax.scan`` over chunks; there is no backward kernel);
    under ``torch.no_grad()`` :func:`repro_torch.kernels.ops.rwkv6_scan`,
    the hand-written kernel on the card, reading the projections in place;
  * decode, :func:`rwkv6_decode`: the O(1)-state one-token step, plain
    torch.

Block leaves are stacked over the layers, ``(L, ...)``, as the dense
family's; a linear is ``(in, out)`` for ``x @ W``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .common import ArchConfig, init_linear

RWKV_HD = 64
LORA = 64            # rank of the decay's low-rank projection
CLIP = 60.0          # exponent clip of the chunked scan


def rwkv6_dims(cfg: ArchConfig) -> tuple:
    """(heads, head dim) of the time-mix."""
    return cfg.d_model // RWKV_HD, RWKV_HD


def rwkv6_state_heads(cfg: ArchConfig) -> int:
    """Head count of the decode state: ``cfg.head_pad_to`` where it is
    larger than the model's heads (rwkv6-3b: 40 -> 48, the layout the JAX
    package shards head-aligned), else the heads.  Exact: padded channels
    carry r = k = v = 0 and decay 1, so their state stays zero."""
    heads, _ = rwkv6_dims(cfg)
    if cfg.head_pad_to and cfg.head_pad_to > heads:
        return cfg.head_pad_to
    return heads


def _pad_heads(t: torch.Tensor, cfg: ArchConfig,
               value: float = 0.0) -> torch.Tensor:
    """Pad the trailing flat channel dim from heads hd to padded heads hd."""
    heads, hd = rwkv6_dims(cfg)
    ph = rwkv6_state_heads(cfg)
    if ph == heads:
        return t
    return F.pad(t, (0, (ph - heads) * hd), value=value)


def rwkv6_params(cfg: ArchConfig, generator: torch.Generator,
                 layers: int) -> dict:
    """The time-mix leaves, stacked over ``layers``, with JAX's names,
    dtypes and init: token-shift mixes 0.5, decay bias -6 and bonus 0 (fp32),
    linears truncated normal over sqrt(fan_in)."""
    d, L = cfg.d_model, layers
    heads, hd = rwkv6_dims(cfg)
    dt, dev = cfg.torch_dtype, generator.device

    def lin(*shape):
        return init_linear((L,) + shape, dt, generator)

    return {
        "mu": torch.full((L, 4, d), 0.5, dtype=dt, device=dev),
        "w_r": lin(d, d),
        "w_k": lin(d, d),
        "w_v": lin(d, d),
        "w_g": lin(d, d),
        "decay_a": lin(d, LORA),
        "decay_b": lin(LORA, d),
        "decay_bias": torch.full((L, d), -6.0, dtype=torch.float32,
                                 device=dev),
        "u_bonus": torch.zeros((L, heads, hd), dtype=torch.float32,
                               device=dev),
        "w_out": lin(d, d),
        "ln_x": torch.ones((L, d), dtype=torch.float32, device=dev),
    }


def _rwkv_proj(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> tuple:
    """Token-shift projections.  x, x_prev: (B, S, d).  Returns r, k, v, g
    in x's dtype and the decay exp(-exp(bias + lora)) in fp32."""
    mu = p["mu"]

    def mix(i):
        return x * mu[i] + x_prev * (1.0 - mu[i])
    r = mix(0) @ p["w_r"]
    k = mix(1) @ p["w_k"]
    v = mix(2) @ p["w_v"]
    wdec = (mix(3) @ p["decay_a"]) @ p["decay_b"]
    wdec = -torch.exp(p["decay_bias"] + wdec.float())     # log-decay < 0
    decay = torch.exp(wdec)                               # (B, S, d) in (0, 1)
    g = F.silu(x @ p["w_g"])
    return r, k, v, decay, g


def rwkv6_chunked_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       decay: torch.Tensor, u: torch.Tensor,
                       chunk: int) -> tuple:
    """The chunked wkv scan in plain torch, differentiable: the JAX model's
    ``chunk_step`` (and the Pallas kernel's arithmetic at its chunk).

    r, k, v, decay: (B, S, H, hd) fp32; u: (H, hd).  Each chunk takes the
    inter-chunk term from the carried state, the intra-chunk term from the
    strictly lower (C, C) tile of factored decays, and the bonus; the
    factored exponents are clipped at +-60, which only matters where a
    chunk's cumulative decay falls below e^-60.  The tail is padded with
    r = k = v = 0, decay 1, which leaves the state alone.  Returns (y (B,
    S, H, hd), the state after token S (B, H, hd, hd)).
    """
    b, s, h, hd = r.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)

    def chunks(t):
        return t.reshape(b, n, chunk, h, hd).unbind(1)
    tri = torch.arange(chunk, device=r.device)
    tri = (tri[:, None] > tri[None, :])[None, :, None, :]
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for rb, kb, vb, db in zip(chunks(r), chunks(k), chunks(v),
                              chunks(decay)):
        logd = torch.log(torch.clamp(db, min=1e-20))
        cums = torch.cumsum(logd, dim=1)                  # (B, C, H, hd)
        rd = rb * torch.exp(torch.clamp(cums - logd, -CLIP, CLIP))
        y_inter = torch.einsum("bthd,bhde->bthe", rd, state)
        kd = kb * torch.exp(torch.clamp(-cums, -CLIP, CLIP))
        att = torch.einsum("bthd,buhd->bthu", rd, kd)
        att = torch.where(tri, att, 0.0)
        y_intra = torch.einsum("bthu,buhe->bthe", att, vb)
        bonus = torch.einsum("bthd,bthd->bth", rb, u[None, None] * kb)
        total = cums[:, -1]                               # (B, H, hd)
        wu = torch.exp(total[:, None] - cums)
        state = (torch.exp(total)[..., None] * state
                 + torch.einsum("buhd,buhe->bhde", kb * wu, vb))
        ys.append(y_inter + y_intra + bonus[..., None] * vb)
    return torch.cat(ys, dim=1)[:, :s], state


class RWKVState(NamedTuple):
    s: torch.Tensor          # (B, state heads, hd, hd) wkv state, fp32
    x_prev: torch.Tensor     # (B, d) last normed input (token shift)


def _norm_gate_out(p: dict, y: torch.Tensor, g: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Per-head norm of y (..., heads, hd), ln_x over the first d channels,
    the gate, and the output projection in x's dtype."""
    d = x.shape[-1]
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6)
    y = y.reshape(*y.shape[:-2], -1)[..., :d] * p["ln_x"]
    return (y * g.float()).to(x.dtype) @ p["w_out"]


def rwkv6_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, chunk: int = 0,
                  return_state: bool = False):
    """Time-mix over a sequence.  x: (B, S, d), normed.

    Under autograd the wkv scan is the plain chunked one at ``chunk`` (or
    ``cfg.ssm_chunk``); otherwise :func:`repro_torch.kernels.ops.
    rwkv6_scan` (the kernel on the card).  ``return_state`` also returns
    the :class:`RWKVState` for decode, its heads padded to
    :func:`rwkv6_state_heads`.
    """
    b, s, d = x.shape
    heads, hd = rwkv6_dims(cfg)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, decay, g = _rwkv_proj(p, x, x_prev)
    shape = (b, s, heads, hd)
    if torch.is_grad_enabled():
        y, state = rwkv6_chunked_scan(
            *(t.reshape(shape).float() for t in (r, k, v, decay)),
            p["u_bonus"], chunk or cfg.ssm_chunk)
    else:
        y, state = kops.rwkv6_scan(
            *(t.reshape(shape).transpose(1, 2) for t in (r, k, v, decay)),
            p["u_bonus"])
        y = y.transpose(1, 2)
    out = _norm_gate_out(p, y, g, x)
    if not return_state:
        return out
    ph = rwkv6_state_heads(cfg)
    if ph != heads:
        state = F.pad(state, (0, 0, 0, 0, 0, ph - heads))
    return out, RWKVState(state, x[:, -1])


def rwkv6_init_state(cfg: ArchConfig, batch: int, device) -> RWKVState:
    _, hd = rwkv6_dims(cfg)
    ph = rwkv6_state_heads(cfg)
    return RWKVState(
        torch.zeros((batch, ph, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=cfg.torch_dtype,
                    device=device))


def rwkv6_decode(p: dict, x: torch.Tensor, state: RWKVState,
                 cfg: ArchConfig) -> tuple:
    """One-token step.  x: (B, 1, d), normed.  Returns (out (B, 1, d), the
    new :class:`RWKVState`); r, k, v and the decay are padded to the
    state's heads."""
    b = x.shape[0]
    _, hd = rwkv6_dims(cfg)
    ph = rwkv6_state_heads(cfg)
    r, k, v, decay, g = _rwkv_proj(p, x, state.x_prev[:, None, :])
    r, k, v = (_pad_heads(t, cfg) for t in (r, k, v))
    decay = _pad_heads(decay, cfg, value=1.0)

    def heads(t):
        return t[:, 0].reshape(b, ph, hd).float()
    r, k, v, dc = heads(r), heads(k), heads(v), heads(decay)
    u = _pad_heads(p["u_bonus"].reshape(-1), cfg).reshape(ph, hd)
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", r, state.s + u[..., None] * kv)
    s_new = dc[..., None] * state.s + kv
    return _norm_gate_out(p, y[:, None], g, x), RWKVState(s_new, x[:, 0])
