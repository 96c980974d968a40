"""Sequence-state blocks: Mamba2 (SSD) and RWKV6 ("Finch") time-mix.

Counterpart of ``repro.models.ssm``.  Mamba2, the backbone of the
``"hybrid"`` family (zamba2), runs in two forms, both plain torch as the
JAX package's are plain ``jnp`` (it has no Pallas kernel):

  * training and prefill, :func:`mamba2_forward`: the chunked SSD scan
    :func:`ssd_chunked_scan` at ``cfg.ssm_chunk``, the JAX model's
    ``chunk_step``, except that the intra-chunk decay is masked *before*
    its exponent (JAX exponentiates the positive t < u exponents, which
    overflow past about 88, and masks after: the value is the same, but
    its gradient is 0 x inf = NaN once a chunk holds about 130 tokens);
  * decode, :func:`mamba2_decode`: the O(1)-state one-token step.

Over a model axis both take ``tp`` and run a rank's heads: the whole
packed leaves cut to them (:func:`mamba2_rank_leaves`), up to the gated
norm (:func:`mamba2_inner`, :func:`mamba2_step`), whose mean square sums
every rank's part (:func:`mamba2_squares`, :func:`mamba2_norm_out`).

The wkv recurrence of RWKV6 runs in two forms:

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

# ---------------------------------------------------------------------------
# Mamba2 (SSD, a scalar decay per head)
# ---------------------------------------------------------------------------

MAMBA_HD = 64


def mamba2_dims(cfg: ArchConfig) -> tuple:
    """(inner width, heads, head dim) of the Mamba2 block."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // MAMBA_HD, MAMBA_HD


def mamba2_plan(cfg: ArchConfig, layers: int) -> list:
    """``(name, make(generator))`` of the Mamba2 leaves, stacked over
    ``layers``, in draw order, with JAX's names, dtypes and init: ``w_in``
    projects to [x | z | B C | dt], the depthwise conv is truncated normal
    times 0.5, a_log and dt_bias 0, the D skip and the output norm 1
    (fp32)."""
    d, L, ns = cfg.d_model, layers, cfg.ssm_state
    d_in, heads, _ = mamba2_dims(cfg)
    dt = cfg.torch_dtype

    def lin(*shape, scale=None):
        return lambda g: init_linear((L,) + shape, dt, g, scale=scale)

    def f32(fill, *shape):
        return lambda g: torch.full((L,) + shape, fill, dtype=torch.float32,
                                    device=g.device)

    return [("w_in", lin(d, 2 * d_in + 2 * ns + heads)),
            ("conv_w", lin(cfg.conv_width, d_in + 2 * ns, scale=0.5)),
            ("a_log", f32(0.0, heads)),
            ("dt_bias", f32(0.0, heads)),
            ("d_skip", f32(1.0, heads)),
            ("w_out", lin(d_in, d)),
            ("norm_z", f32(1.0, d_in))]


def mamba2_params(cfg: ArchConfig, generator: torch.Generator,
                  layers: int) -> dict:
    """The Mamba2 leaves of :func:`mamba2_plan`, drawn."""
    return {k: make(generator) for k, make in mamba2_plan(cfg, layers)}


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, heads, hd, ns) SSM state, fp32
    conv: torch.Tensor     # (B, conv_width - 1, d_in + 2 ns) conv tail


def mamba2_rank_leaves(p: dict, r: int, m: int, copy=None,
                       cut: bool = True) -> dict:
    """One layer's Mamba2 leaves (or the layer-stacked ones) as model rank
    ``r`` of ``m`` reads them, its ``heads / m`` heads: from the whole
    ``w_in`` its x and z columns, B and C whole and its dt columns (packed
    as ``_mamba_split`` reads them), from the whole ``conv_w`` its x
    channels and B and C; ``a_log``, ``dt_bias`` and ``d_skip`` its heads
    and ``norm_z`` its channels, each through ``copy`` (a replicated leaf
    read in part: its gradient is summed over the ranks).  ``cut`` False:
    ``w_in`` and ``conv_w`` are the rank's already.  ``w_out`` is taken
    as it is (its rows are the rank's block)."""
    d_in = p["norm_z"].shape[-1]
    heads = p["a_log"].shape[-1]
    c, h = d_in // m, heads // m
    out = dict(p)
    if cut:
        ns = (p["conv_w"].shape[-1] - d_in) // 2
        w, cw = p["w_in"], p["conv_w"]
        out["w_in"] = torch.cat([w.narrow(-1, a, n) for a, n in (
            (r * c, c), (d_in + r * c, c), (2 * d_in, 2 * ns),
            (2 * d_in + 2 * ns + r * h, h))], dim=-1)
        out["conv_w"] = torch.cat([cw.narrow(-1, r * c, c),
                                   cw.narrow(-1, d_in, 2 * ns)], dim=-1)
    copy = copy or (lambda t: t)
    for k in ("a_log", "dt_bias", "d_skip"):
        out[k] = copy(p[k]).narrow(-1, r * h, h)
    out["norm_z"] = copy(p["norm_z"]).narrow(-1, r * c, c)
    return out


def _mamba_split(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple:
    """x @ w_in split into x (..., c), z (..., c), B C (..., 2 ns) and dt
    (..., heads), c the inner channels ``p`` holds (d_in, or a model
    rank's, :func:`mamba2_rank_leaves`)."""
    c, ns = p["norm_z"].shape[-1], cfg.ssm_state
    proj = x @ p["w_in"]
    return (proj[..., :c], proj[..., c:2 * c], proj[..., 2 * c:2 * c + 2 * ns],
            proj[..., 2 * c + 2 * ns:])


def _causal_conv(u: torch.Tensor, w: torch.Tensor, tail) -> tuple:
    """Depthwise causal conv and SiLU.  u: (B, S, C); w: (K, C); tail:
    (B, K-1, C) or None (zeros).  The taps are summed in JAX's order,
    first to last.  Returns (out, the new tail: the last K-1 inputs)."""
    k, s = w.shape[0], u.shape[1]
    if tail is None:
        tail = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    up = torch.cat([tail, u], dim=1)
    out = up[:, :s] * w[0]
    for i in range(1, k):
        out = out + up[:, i:i + s] * w[i]
    return F.silu(out), (up[:, s:] if k > 1 else tail)


def ssd_chunked_scan(x: torch.Tensor, b_mat: torch.Tensor,
                     c_mat: torch.Tensor, decay: torch.Tensor,
                     chunk: int) -> tuple:
    """The chunked SSD scan in plain torch, differentiable.

    x: (B, S, H, hd) dt-scaled inputs, b_mat, c_mat: (B, S, ns), decay:
    (B, S, H) in (0, 1], all fp32.  Per chunk: the intra-chunk term
    ``y_t = sum_{u <= t} exp(cums_t - cums_u) (C_t . B_u) x_u`` from the
    gated (B, H, t, u) scores and one batched product over u (never a
    (B, t, u, H, hd) tensor), the carried state's term, and the state
    update.  The t < u exponents are set to -inf before ``exp``.  The
    tail is padded with x = B = C = 0, decay 1, which leaves the state
    alone.  Returns (y (B, S, H, hd), the state after token S (B, H, hd,
    ns)).
    """
    bsz, s, h, hd = x.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b_mat, c_mat = (F.pad(t, (0, 0, 0, pad)) for t in (b_mat, c_mat))
        decay = F.pad(decay, (0, 0, 0, pad), value=1.0)
    idx = torch.arange(chunk, device=x.device)
    future = idx[None, :] > idx[:, None]                  # (t, u): u > t
    state = x.new_zeros((bsz, h, hd, b_mat.shape[-1]))
    ys = []
    for xc, bc, cc, dc in zip(*(t.split(chunk, dim=1)
                                for t in (x, b_mat, c_mat, decay))):
        cums = torch.cumsum(torch.log(torch.clamp(dc, min=1e-20)), dim=1)
        ch = cums.transpose(1, 2)                         # (B, H, C)
        gate = (ch[..., :, None] - ch[..., None, :]).masked_fill(
            future, float("-inf")).exp()                  # (B, H, t, u)
        scores = gate * (cc @ bc.transpose(1, 2))[:, None]
        y_intra = (scores @ xc.transpose(1, 2)).transpose(1, 2)
        y_inter = torch.einsum("bts,bhds->bthd", cc,
                               state) * cums.exp()[..., None]
        total = cums[:, -1]                               # (B, H)
        w_u = torch.exp(total[:, None, :] - cums)         # (B, C, H)
        state = (total.exp()[:, :, None, None] * state
                 + torch.einsum("buhd,bus->bhds", xc * w_u[..., None], bc))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s], state


def mamba2_squares(y: torch.Tensor, tp=None) -> list:
    """The gated norm's statistic of y (..., c) fp32: with ``tp`` each
    model rank's sum of squares over its channels (..., 1), gathered over
    "model" in model order (``tp.gather_model``, summed: every rank's
    norm reads every rank's part, so each part's gradient is summed over
    them); else None (the mean over y's own channels)."""
    if tp is None:
        return None
    parts = tp.gather_model((y * y).sum(dim=-1, keepdim=True), -1,
                            summed=True)
    return list(parts.split(1, dim=-1))


def mamba2_norm_out(p: dict, y: torch.Tensor, z: torch.Tensor,
                    x: torch.Tensor, d_in: int, squares=None) -> torch.Tensor:
    """The gated RMS norm of y (..., c) fp32 by SiLU(z), then the output
    projection in x's dtype.  The mean square is over y's channels, or
    (``squares``: every model rank's sum of squares, in model order,
    :func:`mamba2_squares`) their sum in that order over all ``d_in``
    channels, JAX's mean over the whole inner width."""
    if squares is None:
        var = (y * y).mean(dim=-1, keepdim=True)
    else:
        var = squares[0]
        for part in squares[1:]:
            var = var + part
        var = var / d_in
    y = y * torch.rsqrt(var + 1e-6)
    y = y * p["norm_z"] * F.silu(z.float())
    return y.to(x.dtype) @ p["w_out"]


def _dt_decay(p: dict, dt: torch.Tensor) -> tuple:
    """(softplus(dt + dt_bias), exp(dt * -exp(a_log))), fp32."""
    dt = F.softplus(dt.float() + p["dt_bias"])
    return dt, torch.exp(dt * -torch.exp(p["a_log"]))


def mamba2_inner(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 chunk: int = 0) -> tuple:
    """Mamba2 over a sequence up to its gated norm, on the heads ``p``
    holds.  x: (B, S, d), normed.  Returns (y (B, S, c) fp32, z (B, S, c),
    the :class:`MambaState` after the sequence, its conv tail in the
    model's dtype)."""
    b, s, _ = x.shape
    k = cfg.conv_width
    c = p["norm_z"].shape[-1]
    heads, hd = c // MAMBA_HD, MAMBA_HD
    xi, z, bc, dt = _mamba_split(p, x, cfg)
    conv_in = torch.cat([xi, bc], dim=-1)
    conv_tail = (conv_in[:, s - (k - 1):] if s >= k - 1
                 else F.pad(conv_in, (0, 0, k - 1 - s, 0)))
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], None)
    bmat, cmat = conv_out[..., c:].float().chunk(2, dim=-1)
    dt, decay = _dt_decay(p, dt)
    xh = conv_out[..., :c].reshape(b, s, heads, hd).float()
    y, h_final = ssd_chunked_scan(xh * dt[..., None], bmat, cmat, decay,
                                  chunk or cfg.ssm_chunk)
    y = (y + p["d_skip"][:, None] * xh).reshape(b, s, c)
    return y, z, MambaState(h_final, conv_tail.to(cfg.torch_dtype))


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                   chunk: int = 0, return_state: bool = False, tp=None):
    """Mamba2 over a sequence.  x: (B, S, d), normed -> (B, S, d).

    The SSD scan is :func:`ssd_chunked_scan` at ``chunk`` (or
    ``cfg.ssm_chunk``).  ``return_state`` also returns the
    :class:`MambaState` after the sequence (the decode hand-off).

    With ``tp`` (a :class:`repro_torch.dist.tp.TensorParallel`) ``p``
    holds this rank's blocks: ``tp.mamba_leaves`` gives the leaves as its
    ``heads / M`` heads read them, x enters through ``tp.copy``, the gated
    norm's mean square sums every rank's part (:func:`mamba2_squares`)
    and the row-parallel ``w_out`` product is summed over "model"; the
    state is the rank's heads, its conv tail its x channels and B, C."""
    if tp is not None:
        p = tp.mamba_leaves(p)
        x = tp.copy(x)
    y, z, state = mamba2_inner(p, x, cfg, chunk)
    out = mamba2_norm_out(p, y, z, x, mamba2_dims(cfg)[0],
                          mamba2_squares(y, tp))
    if tp is not None:
        out = tp.reduce(out)
    return (out, state) if return_state else out


def mamba2_init_state(cfg: ArchConfig, batch: int, device,
                      heads: int = 0) -> MambaState:
    """Zero states of ``heads`` heads (default all; a model rank's: its
    conv tail its heads' x channels and B, C)."""
    d_in, all_heads, hd = mamba2_dims(cfg)
    heads = heads or all_heads
    return MambaState(
        torch.zeros((batch, heads, hd, cfg.ssm_state), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, cfg.conv_width - 1,
                     heads * hd + 2 * cfg.ssm_state),
                    dtype=cfg.torch_dtype, device=device))


def mamba2_step(p: dict, x: torch.Tensor, state: MambaState,
                cfg: ArchConfig) -> tuple:
    """One token up to the gated norm, on the heads ``p`` holds.  x: (B,
    1, d), normed.  Returns (y (B, 1, c) fp32, z, the new
    :class:`MambaState`)."""
    b = x.shape[0]
    c = p["norm_z"].shape[-1]
    heads, hd = c // MAMBA_HD, MAMBA_HD
    xi, z, bc, dt = _mamba_split(p, x, cfg)
    conv_out, tail = _causal_conv(torch.cat([xi, bc], dim=-1), p["conv_w"],
                                  state.conv)
    bmat, cmat = conv_out[:, 0, c:].float().chunk(2, dim=-1)
    dt, decay = _dt_decay(p, dt[:, 0])                    # (B, heads)
    xh = conv_out[:, 0, :c].reshape(b, heads, hd).float()
    h_new = decay[..., None, None] * state.h + torch.einsum(
        "bhd,bs->bhds", xh * dt[..., None], bmat)
    y = torch.einsum("bhds,bs->bhd", h_new, cmat) + p["d_skip"][:, None] * xh
    return y.reshape(b, 1, c), z, MambaState(h_new, tail)


def mamba2_decode(p: dict, x: torch.Tensor, state: MambaState,
                  cfg: ArchConfig, tp=None) -> tuple:
    """One-token step.  x: (B, 1, d), normed.  Returns (out (B, 1, d), the
    new :class:`MambaState`).  ``tp`` as in :func:`mamba2_forward`: the
    state holds this rank's heads."""
    if tp is not None:
        p = tp.mamba_leaves(p)
    y, z, new = mamba2_step(p, x, state, cfg)
    out = mamba2_norm_out(p, y, z, x, mamba2_dims(cfg)[0],
                          mamba2_squares(y, tp))
    if tp is not None:
        out = tp.reduce(out)
    return out, new


# ---------------------------------------------------------------------------
# RWKV6 ("Finch") time-mix with data-dependent decay
# ---------------------------------------------------------------------------

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


def _pad_heads(t: torch.Tensor, heads: int,
               value: float = 0.0) -> torch.Tensor:
    """Pad the trailing flat channel dim with ``value`` to ``heads`` heads
    of ``RWKV_HD``."""
    pad = heads * RWKV_HD - t.shape[-1]
    return F.pad(t, (0, pad), value=value) if pad else t


def rwkv6_plan(cfg: ArchConfig, layers: int) -> list:
    """``(name, make(generator))`` of the time-mix leaves, stacked over
    ``layers``, in draw order, with JAX's names, dtypes and init:
    token-shift mixes 0.5, decay bias -6 and bonus 0 (fp32), linears
    truncated normal over sqrt(fan_in)."""
    d, L = cfg.d_model, layers
    heads, hd = rwkv6_dims(cfg)
    dt = cfg.torch_dtype

    def lin(*shape):
        return lambda g: init_linear((L,) + shape, dt, g)

    def full(shape, fill, dtype):
        return lambda g: torch.full((L,) + shape, fill, dtype=dtype,
                                    device=g.device)

    return [("mu", full((4, d), 0.5, dt)),
            ("w_r", lin(d, d)),
            ("w_k", lin(d, d)),
            ("w_v", lin(d, d)),
            ("w_g", lin(d, d)),
            ("decay_a", lin(d, LORA)),
            ("decay_b", lin(LORA, d)),
            ("decay_bias", full((d,), -6.0, torch.float32)),
            ("u_bonus", full((heads, hd), 0.0, torch.float32)),
            ("w_out", lin(d, d)),
            ("ln_x", full((d,), 1.0, torch.float32))]


def rwkv6_params(cfg: ArchConfig, generator: torch.Generator,
                 layers: int) -> dict:
    """The time-mix leaves of :func:`rwkv6_plan`, drawn."""
    return {k: make(generator) for k, make in rwkv6_plan(cfg, layers)}


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
    """Per-head norm of y (..., heads, hd), ln_x over the gate's channels
    (the heads a state pads past them are dropped), the gate, and the
    output projection in x's dtype."""
    c = g.shape[-1]
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6)
    y = y.reshape(*y.shape[:-2], -1)[..., :c] * p["ln_x"]
    return (y * g.float()).to(x.dtype) @ p["w_out"]


def rwkv6_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, chunk: int = 0,
                  return_state: bool = False, tp=None):
    """Time-mix over a sequence.  x: (B, S, d), normed.

    Under autograd the wkv scan is the plain chunked one at ``chunk`` (or
    ``cfg.ssm_chunk``); otherwise :func:`repro_torch.kernels.ops.
    rwkv6_scan` (the kernel on the card).  ``return_state`` also returns
    the :class:`RWKVState` for decode, its heads padded to
    :func:`rwkv6_state_heads` where the call holds every head.

    The heads are those of ``p``'s projections: with ``tp`` (a
    :class:`repro_torch.dist.tp.TensorParallel`) ``p`` holds this rank's
    blocks, ``tp.ssm_leaves`` gives the leaves as its ``H / M`` heads read
    them, x enters through ``tp.copy`` and the row-parallel ``w_out``
    product is summed over "model"; the state is the rank's heads, not
    padded.
    """
    if tp is not None:
        p = tp.ssm_leaves(p, "blocks.tmix.")
        x = tp.copy(x)
    b, s, d = x.shape
    hd = RWKV_HD
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, decay, g = _rwkv_proj(p, x, x_prev)
    heads = r.shape[-1] // hd
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
    if tp is not None:
        out = tp.reduce(out)
    if not return_state:
        return out
    ph = rwkv6_state_heads(cfg)
    if heads == rwkv6_dims(cfg)[0] and ph != heads:
        state = F.pad(state, (0, 0, 0, 0, 0, ph - heads))
    return out, RWKVState(state, x[:, -1])


def rwkv6_init_state(cfg: ArchConfig, batch: int, device,
                     heads: int = 0) -> RWKVState:
    """Zero states of ``heads`` heads (default
    :func:`rwkv6_state_heads`)."""
    hd = RWKV_HD
    return RWKVState(
        torch.zeros((batch, heads or rwkv6_state_heads(cfg), hd, hd),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=cfg.torch_dtype,
                    device=device))


def rwkv6_decode(p: dict, x: torch.Tensor, state: RWKVState,
                 cfg: ArchConfig, tp=None) -> tuple:
    """One-token step.  x: (B, 1, d), normed.  Returns (out (B, 1, d), the
    new :class:`RWKVState`); r, k, v and the decay are padded to the
    state's heads.  ``tp`` as in :func:`rwkv6_forward`: the state holds
    this rank's heads."""
    if tp is not None:
        p = tp.ssm_leaves(p, "blocks.tmix.")
    b = x.shape[0]
    hd = RWKV_HD
    ph = state.s.shape[1]
    r, k, v, decay, g = _rwkv_proj(p, x, state.x_prev[:, None, :])
    r, k, v = (_pad_heads(t, ph) for t in (r, k, v))
    decay = _pad_heads(decay, ph, value=1.0)

    def heads(t):
        return t[:, 0].reshape(b, ph, hd).float()
    r, k, v, dc = heads(r), heads(k), heads(v), heads(decay)
    u = _pad_heads(p["u_bonus"].reshape(-1), ph).reshape(ph, hd)
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", r, state.s + u[..., None] * kv)
    s_new = dc[..., None] * state.s + kv
    out = _norm_gate_out(p, y[:, None], g, x)
    if tp is not None:
        out = tp.reduce(out)
    return out, RWKVState(s_new, x[:, 0])
