"""The LMs: init, training forward, loss, serving, weight bridge.

Counterpart of ``repro.models.model`` for all of its families: dense
(GQA, with optional qk-norm, QKV bias and sliding window), ``"vlm"`` (the
dense stack fed embeddings, ``batch["embeds"]``: the vision front end is
stubbed, as in JAX), ``"moe"`` (dense attention and a top-k MoE
feed-forward, :mod:`.moe`), the RWKV6 ``"ssm"`` family, the ``"hybrid"``
family (zamba2: Mamba2 blocks and one *shared* dense block applied after
every ``attn_every``-th layer) and ``"audio"`` (whisper: an encoder of
dense blocks with no causal mask over ``batch["enc_embeds"]``, the
precomputed frame embeddings, and decoder blocks of causal
self-attention, cross-attention to the encoder's output and an MLP).
Parameters are a flat dict keyed by dotted names (``"blocks.attn.wq"``)
in the JAX package's leaf order, so a dual or a gradient is a dict of the
same keys.  As in JAX, each block leaf is stacked over the layers, ``(L,
...)``, the hybrid's shared block (``"shared_attn.*"``) is not, the
encoder's blocks are ``"encoder.blocks.*"``, the embed and unembed take
``cfg.padded_vocab`` rows (logits are sliced back to ``vocab_size``), and
a linear is stored ``(in, out)`` for ``x @ W``: the qwen2 model has 15
leaves at any depth, the RWKV6 model 20, the hybrid 20, whisper 27.
:class:`DenseLM` is the ``nn.Module`` that owns them (of any family);
:func:`forward_aux` (hidden and the MoE load-balance loss) and
:func:`lm_loss` are plain functions of a parameter dict, so the gossip
step can evaluate each worker's own primal.  Each block is
recomputed in the backward pass (``torch.utils.checkpoint``), as the JAX
model checkpoints each scanned block.

Serving: :func:`prefill` runs a prompt (attention through the flash
kernel; ssm: the wkv scan through its kernel; hybrid: the Mamba2 scan in
plain torch and the shared block's attention through the flash kernel;
audio: the encoder, the decoder's self-attention and its
cross-attention, each through the flash kernel) and returns the last
real token's logits and a :class:`DecodeState`;
:func:`decode_step` advances every row one token.  The caches are stacked
over the layers with batch on axis 1, as in JAX: KV caches (L, B, cap,
KV, hd), linear, or ring caches of capacity ``min(window, S)`` under a
sliding window; ssm states ``{"tmix": RWKVState(s (L, B, heads, hd, hd),
x_prev (L, B, d)), "cmix_prev": (L, B, d)}``; hybrid ``{"mamba":
MambaState(h (L, B, heads, hd, ns), conv (L, B, K-1, d_in + 2 ns)),
"attn": KVCache (A, B, cap, KV, hd)}``, one KV row for each of the A
applications of the shared block; audio the decoder's KV caches and,
beside them, ``DecodeState.enc_kv``: the cross-attention's K and V of
the encoder output, (L, B, encoder_seq, KV, hd) each, fixed after the
prefill.  They are updated in place (a copy per step would move the
whole cache); :func:`insert_decode_state` and :func:`evict_decode_state`
write and clear one slot row of every cache tensor in place.  The
prefill takes a prompt's token-wise work (norms, projections, rope, the
dense MLP) ``attn.PREFILL_ROWS`` tokens at a time, so a 524,288-token
prompt holds no (S, d_ff) tensor; the MoE feed-forward takes the whole
prompt (its groups and capacities are per sequence); whisper's blocks
take a prompt (at most 448 tokens) and the 1500 frames whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn
from . import moe, ssm
from .common import ArchConfig, init_linear, rms_norm, swiglu

BLOCKS = "blocks."
SHARED = "shared_attn."
ENCODER = "encoder."
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _leaf_key(name: str) -> tuple:
    return tuple(name.split("."))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device, JAX names and layout."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"only the {', '.join(FAMILIES)} families are "
                         f"ported, got {cfg.family!r}")
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    dt, dev = cfg.torch_dtype, generator.device
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    params = {
        "embed": init_linear((cfg.padded_vocab, d), dt, generator,
                             scale=1.0),
        "unembed": init_linear((d, cfg.padded_vocab), dt, generator),
        "final_norm": ones(d),
    }
    if cfg.family == "audio":
        params.update({BLOCKS + k: v for k, v in _encdec_params(
            cfg, generator, L).items()})
        params.update({ENCODER + BLOCKS + k: v for k, v in _dense_params(
            cfg, generator, cfg.encoder_layers).items()})
        params[ENCODER + "final_norm"] = ones(d)
        return ordered(params)
    if cfg.family == "hybrid":
        params["blocks.ln1"] = ones(L, d)
        for k, v in ssm.mamba2_params(cfg, generator, L).items():
            params[f"blocks.mamba.{k}"] = v
        if cfg.attn_every:
            params.update({SHARED + k: v[0] for k, v in _dense_params(
                cfg, generator, 1).items()})
        return ordered(params)
    if cfg.family == "ssm":
        for k, v in ssm.rwkv6_params(cfg, generator, L).items():
            params[f"blocks.tmix.{k}"] = v
        params.update({
            "blocks.ln1": ones(L, d),
            "blocks.ln2": ones(L, d),
            "blocks.cmix.mu": torch.full((L, 2, d), 0.5, dtype=dt,
                                         device=dev),
            "blocks.cmix.w_k": init_linear((L, d, ff), dt, generator),
            "blocks.cmix.w_v": init_linear((L, ff, d), dt, generator),
            "blocks.cmix.w_r": init_linear((L, d, d), dt, generator),
        })
        return ordered(params)
    params.update({BLOCKS + k: v for k, v in _dense_params(
        cfg, generator, L).items()})
    return ordered(params)


def _dense_params(cfg: ArchConfig, generator: torch.Generator,
                  layers: int) -> dict:
    """A dense (or MoE) block's leaves, stacked over ``layers``, keyed
    below the block (``"attn.wq"``)."""
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    p = {"ln1": torch.ones((layers, d), dtype=torch.float32,
                           device=generator.device),
         "ln2": torch.ones((layers, d), dtype=torch.float32,
                           device=generator.device)}
    if cfg.is_moe:
        for k, v in moe.moe_params(cfg, generator, layers).items():
            p[f"moe.{k}"] = v
    else:
        p.update({
            "mlp.w_gate": init_linear((layers, d, ff), dt, generator),
            "mlp.w_up": init_linear((layers, d, ff), dt, generator),
            "mlp.w_down": init_linear((layers, ff, d), dt, generator),
        })
    for k, v in attn.attention_params(cfg, generator, layers).items():
        p[f"attn.{k}"] = v
    return p


def _encdec_params(cfg: ArchConfig, generator: torch.Generator,
                   layers: int) -> dict:
    """A whisper decoder block's leaves, stacked over ``layers``: a dense
    block's (ln1, the self-attention, ln2, the MLP), then ln_x and the
    cross-attention (no QKV bias)."""
    p = _dense_params(cfg, generator, layers)
    p["ln_x"] = torch.ones((layers, cfg.d_model), dtype=torch.float32,
                           device=generator.device)
    for k, v in attn.attention_params(cfg, generator, layers,
                                      cross=True).items():
        p[f"xattn.{k}"] = v
    return p


def ordered(params: dict) -> dict:
    """The dict in the JAX package's leaf order (sorted key paths)."""
    return {k: params[k] for k in sorted(params, key=_leaf_key)}


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _dense_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                 p: dict, causal: bool = True) -> tuple:
    """(the block's output, its load-balance loss: None without
    experts)."""
    x = x + attn.attend_train(p["attn"], rms_norm(x, p["ln1"]), positions,
                              cfg, causal=causal)
    h, aux = _ffn(x, p, cfg)
    return x + h, aux


def _encoder_block(x: torch.Tensor, positions: torch.Tensor,
                   cfg: ArchConfig, p: dict) -> torch.Tensor:
    """A whisper encoder block: a dense block with no causal mask (its
    self-attention roped over the frames)."""
    return _dense_block(x, positions, cfg, p, causal=False)[0]


def _encdec_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                  p: dict, enc_out: torch.Tensor) -> torch.Tensor:
    """A whisper decoder block: causal self-attention, cross-attention to
    ``enc_out`` (no rope, no mask), the MLP."""
    x = x + attn.attend_train(p["attn"], rms_norm(x, p["ln1"]), positions,
                              cfg)
    x = x + attn.attend_train(p["xattn"], rms_norm(x, p["ln_x"]), positions,
                              cfg, causal=False, window=0, kv_input=enc_out,
                              rope=False)
    return x + _ffn(x, p, cfg)[0]


def _cmix(x: torch.Tensor, xn: torch.Tensor, xp: torch.Tensor,
          cm: dict) -> torch.Tensor:
    """The RWKV6 channel mix on the residual x: xn normed, xp its token
    shift."""
    k_in = xn * cm["mu"][0] + xp * (1 - cm["mu"][0])
    r_in = xn * cm["mu"][1] + xp * (1 - cm["mu"][1])
    v = torch.square(torch.relu(k_in @ cm["w_k"])) @ cm["w_v"]
    return x + torch.sigmoid(r_in @ cm["w_r"]) * v


def _rwkv_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                p: dict) -> tuple:
    """(the block's output, None: no load-balance loss)."""
    x = x + ssm.rwkv6_forward(p["tmix"], rms_norm(x, p["ln1"]), cfg)
    xn = rms_norm(x, p["ln2"])
    return _cmix(x, xn, F.pad(xn, (0, 0, 1, 0))[:, :-1], p["cmix"]), None


def _mamba_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                 p: dict) -> tuple:
    """(the block's output, None: no load-balance loss)."""
    return x + ssm.mamba2_forward(p["mamba"], rms_norm(x, p["ln1"]),
                                  cfg), None


def _shared(params: dict) -> dict:
    """The hybrid's shared dense block, nested (``{"attn": ..., "mlp":
    ...}``)."""
    return _nest({k[len(SHARED):]: v for k, v in params.items()
                  if k.startswith(SHARED)})


def _applies_shared(cfg: ArchConfig, layer: int) -> bool:
    """Whether the hybrid's shared block follows ``layer`` (layers k-1,
    2k-1, ... for ``attn_every`` k; never for k = 0)."""
    return bool(cfg.attn_every) and (layer + 1) % cfg.attn_every == 0


def _layers(params: dict, cfg: ArchConfig, prefix: str = BLOCKS):
    """Each layer's nested block parameters, in order: the decoder's
    (``"blocks."``), or the encoder's (``"encoder.blocks."``)."""
    per_layer = {k[len(prefix):]: v.unbind(0) for k, v in params.items()
                 if k.startswith(prefix)}
    layers = cfg.encoder_layers if prefix != BLOCKS else cfg.num_layers
    for layer in range(layers):
        yield _nest({k: v[layer] for k, v in per_layer.items()})


def _ffn(x: torch.Tensor, p: dict, cfg: ArchConfig) -> tuple:
    """The block's feed-forward of the residual x: (h, the fp32
    load-balance loss, None without experts)."""
    xn = rms_norm(x, p["ln2"])
    if cfg.is_moe:
        return moe.moe_forward(p["moe"], xn, cfg)
    mp = p["mlp"]
    return swiglu(xn, mp["w_gate"], mp["w_up"], mp["w_down"]), None


def _embed(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The decoder's input: ``batch["embeds"]`` in the model's dtype (a
    copy: the prefill updates it in place), else the tokens' rows of the
    embedding."""
    if "embeds" in batch:
        return batch["embeds"].to(cfg.torch_dtype, copy=True)
    return F.embedding(batch["tokens"], params["embed"])


def _run(fn, x: torch.Tensor, *args):
    """``fn(x, *args)``, recomputed in the backward pass
    (``torch.utils.checkpoint``) when a gradient is being taken."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


def _encoder_forward(params: dict, cfg: ArchConfig,
                     enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over (B, frames, d) embeddings: the blocks with
    no causal mask, each checkpointed, then the final norm."""
    x = enc_embeds.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in _layers(params, cfg, ENCODER + BLOCKS):
        x = _run(_encoder_block, x, positions, cfg, lp)
    return rms_norm(x, params[ENCODER + "final_norm"])


def forward_aux(params: dict, cfg: ArchConfig, batch) -> tuple:
    """Training forward: a batch (``{"tokens"}``, ``{"embeds"}``, and
    ``"enc_embeds"`` for audio; a bare (B, S) token tensor is taken as
    ``{"tokens": ...}``) -> (final-normed hidden (B, S, d), the fp32
    load-balance loss summed over the layers), as JAX's ``forward``."""
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "audio":
        enc_out = _encoder_forward(params, cfg, batch["enc_embeds"])
        for lp in _layers(params, cfg):
            x = _run(_encdec_block, x, positions, cfg, lp, enc_out)
        return rms_norm(x, params["final_norm"]), aux
    block = {"ssm": _rwkv_block, "hybrid": _mamba_block}.get(cfg.family,
                                                             _dense_block)
    shared = _shared(params) if cfg.family == "hybrid" else None
    for layer, lp in enumerate(_layers(params, cfg)):
        x, a = _run(block, x, positions, cfg, lp)
        if a is not None:
            aux = aux + a
        if _applies_shared(cfg, layer):
            x, _ = _run(_dense_block, x, positions, cfg, shared)
    return rms_norm(x, params["final_norm"]), aux


def forward(params: dict, cfg: ArchConfig, batch) -> torch.Tensor:
    """Training forward: a batch or (B, S) tokens (as
    :func:`forward_aux`) -> final-normed hidden (B, S, d)."""
    return forward_aux(params, cfg, batch)[0]


def _vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits without the padded vocabulary's columns."""
    if cfg.padded_vocab != cfg.vocab_size:
        return logits[..., :cfg.vocab_size]
    return logits


def logits_fn(params: dict, cfg: ArchConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """(..., d) hidden -> (..., vocab_size) logits."""
    return _vocab(cfg, hidden @ params["unembed"])


def lm_loss(params: dict, cfg: ArchConfig, batch: dict,
            seq_weights: Optional[torch.Tensor] = None,
            denom: Optional[torch.Tensor] = None):
    """Next-token cross-entropy plus ``0.01 * aux`` (the MoE load-balance
    loss, 0 without experts); returns (total, {"loss", "aux", "ntok"}), as
    JAX's.

    Labels < 0 are masked.  ``seq_weights`` (B,) are AMB's eq.-3
    per-sequence inclusion weights: the loss is the weighted mean over the
    included sequences, with denominator ``max(sum mask * w, 1)``.  A
    worker that holds only its own rows of the global batch passes the
    global ``denom`` (that maximum over every worker's rows), so its loss
    is its share of the global one.
    """
    hidden, aux = forward_aux(params, cfg, batch)
    logits = logits_fn(params, cfg, hidden).float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    tok_nll = (logz - gold) * mask                          # (B, S)
    if seq_weights is not None:
        w = seq_weights[:, None].float()
        if denom is None:
            denom = torch.clamp((mask * w).sum(), min=1.0)
        loss = (tok_nll * w).sum() / denom
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = tok_nll.sum() / denom
    return loss + 0.01 * aux, {"loss": loss, "aux": aux, "ntok": denom}


# ---------------------------------------------------------------------------
# Serving: prefill and KV-cache decode
# ---------------------------------------------------------------------------

def _check_servable(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"serving the {cfg.family!r} family is not "
                                  f"ported ({', '.join(FAMILIES)} only)")


class DecodeState:
    """Decode state: the layer-stacked caches (a :class:`KVCache`, the
    ssm state dict, or the hybrid's ``{"mamba", "attn"}``), the
    position(s) the next token is written at (a 0-d tensor, or (B,) per
    slot), and for audio ``enc_kv``, the cross-attention's (k, v) of the
    encoder output (None for the other families)."""

    def __init__(self, caches, pos: torch.Tensor, enc_kv=None):
        self.caches, self.pos, self.enc_kv = caches, pos, enc_kv


def _cache_tensors(tree) -> list:
    """Every tensor of a cache tree (dataclass, tuple or dict), in order;
    each has batch on axis 1."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for sub in tree for t in _cache_tensors(sub)]


def _ssm_caches(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero ssm decode states stacked over the layers."""
    one = ssm.rwkv6_init_state(cfg, batch, device)
    L = cfg.num_layers
    return {"tmix": ssm.RWKVState(one.s.new_zeros((L,) + one.s.shape),
                                  one.x_prev.new_zeros(
                                      (L,) + one.x_prev.shape)),
            "cmix_prev": one.x_prev.new_zeros((L,) + one.x_prev.shape)}


def _last_hidden(params: dict, x: torch.Tensor, last_pos) -> tuple:
    """The final-normed hidden of each row's last real token, and the
    position decode resumes at (S, or last_pos + 1 per row)."""
    b, s, _ = x.shape
    dev = x.device
    if last_pos is None:
        return (rms_norm(x[:, -1:], params["final_norm"]),
                torch.tensor(s, device=dev))
    sel = torch.as_tensor(last_pos, device=dev).long().reshape(-1)
    sel = sel.expand(b).clone()
    hidden = rms_norm(x[torch.arange(b, device=dev), sel][:, None],
                      params["final_norm"])
    return hidden, sel + 1


def _prefill_ssm(params: dict, cfg: ArchConfig, x: torch.Tensor) -> tuple:
    """The RWKV6 stack over a prompt: (the last layer's output, the
    stacked decode states after its last token)."""
    caches = _ssm_caches(cfg, x.shape[0], x.device)
    for layer, lp in enumerate(_layers(params, cfg)):
        h, st = ssm.rwkv6_forward(lp["tmix"], rms_norm(x, lp["ln1"]), cfg,
                                  return_state=True)
        caches["tmix"].s[layer] = st.s
        caches["tmix"].x_prev[layer] = st.x_prev
        x = x + h
        xn = rms_norm(x, lp["ln2"])
        x = _cmix(x, xn, F.pad(xn, (0, 0, 1, 0))[:, :-1], lp["cmix"])
        caches["cmix_prev"][layer] = xn[:, -1]
    return x, caches


def _ring_from_linear(k: torch.Tensor, cap: int) -> torch.Tensor:
    """The last ``cap`` positions of (B, S, ...) in their ring rows
    (position p at row p % cap); zero-padded to ``cap`` when S < cap."""
    b, s = k.shape[:2]
    out = k.new_zeros((b, cap) + k.shape[2:])
    if s <= cap:
        out[:, :s] = k
        return out
    slots = torch.arange(s - cap, s, device=k.device) % cap
    out[:, slots] = k[:, s - cap:]
    return out


def _prefill_dense_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                         caches: Optional[attn.KVCache], row: int, *,
                         causal: bool = True) -> None:
    """One dense or MoE block ``p`` over a prompt, in place on ``x``: its
    token-wise work ``attn.PREFILL_ROWS`` tokens at a time, its attention
    through the flash kernel (with no causal mask unless ``causal``: the
    whisper encoder), its k and v written into cache row ``row`` (linear:
    rows 0..S-1; ring: packed as it comes; ``caches`` None: kept
    nowhere)."""
    b, s, _ = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.hd
    positions = torch.arange(s, device=x.device)[None, :]
    chunks = [slice(c, min(c + attn.PREFILL_ROWS, s))
              for c in range(0, s, attn.PREFILL_ROWS)]
    ap = p["attn"]
    q = x.new_empty((b, s, kvh, cfg.num_heads // kvh, hd))
    if caches is None or caches.ring:
        k, v = x.new_empty((b, s, kvh, hd)), x.new_empty((b, s, kvh, hd))
    else:
        k, v = caches.k[row, :, :s], caches.v[row, :, :s]
    for c in chunks:
        q[:, c], k[:, c], v[:, c] = attn.qkv_rope(
            ap, rms_norm(x[:, c], p["ln1"]), positions[:, c], cfg)
    out = attn.flash_prefill(q, k, v, cfg.sliding_window, causal=causal)
    del q
    if caches is not None and caches.ring:
        cap = caches.k.shape[2]
        caches.k[row] = _ring_from_linear(k, cap)
        caches.v[row] = _ring_from_linear(v, cap)
    del k, v
    for c in chunks:
        x[:, c].add_(out[:, c] @ ap["wo"])
        if not cfg.is_moe:
            x[:, c].add_(_ffn(x[:, c], p, cfg)[0])
    del out
    if cfg.is_moe:
        x.add_(_ffn(x, p, cfg)[0])


def _prefill_encdec_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                          enc_out: torch.Tensor, caches: attn.KVCache,
                          enc_kv: tuple, row: int) -> None:
    """One whisper decoder block over a prompt, in place on ``x``: causal
    self-attention through the flash kernel (its k and v into cache row
    ``row``), cross-attention to ``enc_out`` through the flash kernel with
    no mask and no rope (its k and v into ``enc_kv``'s row ``row``), the
    MLP."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = attn.qkv_rope(p["attn"], rms_norm(x, p["ln1"]), positions,
                            cfg)
    if caches.ring:
        cap = caches.k.shape[2]
        caches.k[row] = _ring_from_linear(k, cap)
        caches.v[row] = _ring_from_linear(v, cap)
    else:
        caches.k[row, :, :s] = k
        caches.v[row, :, :s] = v
    x.add_(attn.flash_prefill(q, k, v, cfg.sliding_window)
           @ p["attn"]["wo"])
    q, k, v = attn._project_qkv(p["xattn"], rms_norm(x, p["ln_x"]), cfg,
                                kv_input=enc_out)
    enc_kv[0][row], enc_kv[1][row] = k, v
    x.add_(attn.flash_prefill(q, k, v, 0, causal=False) @ p["xattn"]["wo"])
    x.add_(_ffn(x, p, cfg)[0])


def _prefill_audio(params: dict, cfg: ArchConfig, x: torch.Tensor,
                   enc_embeds: torch.Tensor, cap: int) -> tuple:
    """Whisper over a prompt: the encoder (its blocks through
    :func:`_prefill_dense_block` with no causal mask and no cache), then
    the decoder in place on ``x``; returns (the decoder's KV caches of
    ``cap`` rows, ``enc_kv``: (k, v) each (L, B, frames, KV, hd))."""
    enc = enc_embeds.to(cfg.torch_dtype, copy=True)
    for lp in _layers(params, cfg, ENCODER + BLOCKS):
        _prefill_dense_block(lp, cfg, enc, None, 0, causal=False)
    enc = rms_norm(enc, params[ENCODER + "final_norm"])
    b = x.shape[0]
    caches = _kv_caches(cfg, cfg.num_layers, b, cap, x.dtype, x.device)
    enc_kv = _enc_kv(cfg, b, enc.shape[1], x.device)
    for layer, lp in enumerate(_layers(params, cfg)):
        _prefill_encdec_block(lp, cfg, x, enc, caches, enc_kv, layer)
    return caches, enc_kv


def _enc_kv(cfg: ArchConfig, batch: int, frames: int, device) -> tuple:
    """Zero cross-attention K and V, (L, B, frames, KV, hd) each."""
    shape = (cfg.num_layers, batch, frames, cfg.num_kv_heads, cfg.hd)
    return tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                 for _ in range(2))


def _kv_caches(cfg: ArchConfig, rows: int, batch: int, cap: int, dtype,
               device) -> attn.KVCache:
    """Zero KV caches (rows, B, cap, KV, hd), ring under a window."""
    shape = (rows, batch, cap, cfg.num_kv_heads, cfg.hd)
    return attn.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        cfg.sliding_window > 0)


def _hybrid_caches(cfg: ArchConfig, batch: int, cap: int, device) -> dict:
    """Zero hybrid caches: every layer's Mamba2 state, and a KV cache of
    ``cap`` rows for each application of the shared block (one, unused,
    without it, as in JAX)."""
    one = ssm.mamba2_init_state(cfg, batch, device)
    apps = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    return {"mamba": ssm.MambaState(*(t.new_zeros((cfg.num_layers,)
                                                  + t.shape) for t in one)),
            "attn": _kv_caches(cfg, max(apps, 1), batch, cap,
                               cfg.torch_dtype, device)}


def _prefill_hybrid(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    cap: int) -> tuple:
    """The hybrid stack over a prompt: (the last layer's output, {"mamba":
    each layer's state after the prompt, "attn": each application's KV
    cache of ``cap`` rows}).  ``x`` is updated in place."""
    caches = _hybrid_caches(cfg, x.shape[0], cap, x.device)
    shared, app = _shared(params), 0
    for layer, lp in enumerate(_layers(params, cfg)):
        h, st = ssm.mamba2_forward(lp["mamba"], rms_norm(x, lp["ln1"]), cfg,
                                   return_state=True)
        x.add_(h)
        caches["mamba"].h[layer] = st.h
        caches["mamba"].conv[layer] = st.conv
        del h, st
        if _applies_shared(cfg, layer):
            _prefill_dense_block(shared, cfg, x, caches["attn"], app)
            app += 1
    return x, caches


@torch.no_grad()
def prefill(params: dict, cfg: ArchConfig, batch: dict,
            extra_capacity: int = 0, last_pos=None) -> tuple:
    """Process a full prompt; returns (last-token logits (B, V) in the
    parameters' dtype, DecodeState ready for :func:`decode_step`).

    Dense and MoE: the caches hold the prompt's S positions and
    ``extra_capacity`` empty slots, or under a sliding window are ring
    caches of capacity ``min(window, S)`` (no extra capacity, as in JAX).
    ``last_pos`` (int or (B,)) is each request's final real prompt token,
    for prompts right-padded to a shared length: logits are taken there
    and decode resumes at ``last_pos + 1`` (causal attention keeps the
    real prefix independent of the padding, and the padded cache rows stay
    masked until decode overwrites them).  Ssm: the states after the
    prompt's last token, their heads padded to ``cfg.head_pad_to``
    (``extra_capacity`` does not apply; a recurrent state absorbs padding,
    so serve prompts at their exact length).  Hybrid: the Mamba2 states
    after the prompt, and one KV cache row for each application of the
    shared block, sized as the dense family's.  Audio: the decoder's KV
    caches, sized as the dense family's, and ``enc_kv``.  The batch is
    ``{"tokens"}`` or ``{"embeds"}`` (vlm), with ``"enc_embeds"`` for
    audio; the logits have ``vocab_size`` columns.
    """
    _check_servable(cfg)
    x = _embed(params, cfg, batch)
    b, s, _ = x.shape
    window = cfg.sliding_window
    cap = min(window, s) if window > 0 else s + extra_capacity
    enc_kv = None
    if cfg.family == "ssm":
        x, caches = _prefill_ssm(params, cfg, x)
    elif cfg.family == "hybrid":
        x, caches = _prefill_hybrid(params, cfg, x, cap)
    elif cfg.family == "audio":
        caches, enc_kv = _prefill_audio(params, cfg, x, batch["enc_embeds"],
                                        cap)
    else:
        caches = _kv_caches(cfg, cfg.num_layers, b, cap, x.dtype, x.device)
        for layer, lp in enumerate(_layers(params, cfg)):
            _prefill_dense_block(lp, cfg, x, caches, layer)
    hidden, pos = _last_hidden(params, x, last_pos)
    return (logits_fn(params, cfg, hidden)[:, 0],
            DecodeState(caches, pos, enc_kv))


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      per_slot_pos: bool = False,
                      device="cuda") -> DecodeState:
    """Zero caches for ``cache_len`` tokens per row (ring caches of
    ``min(window, cache_len)`` rows under a sliding window; ssm: zero
    states, of a size independent of ``cache_len``; audio: also a zero
    ``enc_kv`` of ``encoder_seq`` frames, 1500 if it is unset, as in JAX);
    ``per_slot_pos`` gives a (batch,) position vector (the slot array,
    rows decode at their own depths) instead of a shared scalar."""
    _check_servable(cfg)
    device = resolve_device(device)
    ring = cfg.sliding_window > 0
    cap = min(cfg.sliding_window, cache_len) if ring else cache_len
    enc_kv = None
    if cfg.family == "audio":
        enc_kv = _enc_kv(cfg, batch, cfg.encoder_seq or 1500, device)
    if cfg.family == "ssm":
        caches = _ssm_caches(cfg, batch, device)
    elif cfg.family == "hybrid":
        caches = _hybrid_caches(cfg, batch, cap, device)
    else:
        caches = _kv_caches(cfg, cfg.num_layers, batch, cap,
                            cfg.torch_dtype, device)
    pos = torch.zeros((batch,) if per_slot_pos else (), dtype=torch.long,
                      device=device)
    return DecodeState(caches, pos, enc_kv)


@torch.no_grad()
def insert_decode_state(state: DecodeState, one: DecodeState,
                        slot: int) -> DecodeState:
    """Write a batch-1 state (from :func:`prefill`) into row ``slot`` of the
    slot array, in place: row ``slot`` of every cache tensor (batch on axis
    1) is overwritten whole, so ``one``'s caches must match it (dense:
    prefill with ``extra_capacity = cap - prompt_len``; audio: ``enc_kv``
    too); ``state.pos`` must be the per-slot (B,) form."""
    for big, small in zip(_cache_tensors((state.caches, state.enc_kv)),
                          _cache_tensors((one.caches, one.enc_kv))):
        big[:, slot] = small[:, 0]
    state.pos[slot] = one.pos.reshape(-1)[0]
    return state


@torch.no_grad()
def evict_decode_state(state: DecodeState, slot: int) -> DecodeState:
    """Zero row ``slot``'s caches and position in place (a retired slot
    keeps no residue of its last request; audio: its ``enc_kv`` row
    too)."""
    for big in _cache_tensors((state.caches, state.enc_kv)):
        big[:, slot] = 0
    state.pos[slot] = 0
    return state


@torch.no_grad()
def decode_step(params: dict, cfg: ArchConfig, state: DecodeState,
                token: torch.Tensor) -> tuple:
    """One-token decode.  token: (B,) -> (logits (B, vocab_size),
    DecodeState at ``pos + 1`` over the same, updated, caches)."""
    _check_servable(cfg)
    x = F.embedding(token.long(), params["embed"])[:, None, :]
    if cfg.family == "audio":
        x = _decode_audio(params, cfg, state, x)
    else:
        decode = {"ssm": _decode_ssm, "hybrid": _decode_hybrid}.get(
            cfg.family, _decode_dense)
        x = decode(params, cfg, state.caches, state.pos, x)
    hidden = rms_norm(x, params["final_norm"])
    logits = logits_fn(params, cfg, hidden)[:, 0]
    return logits, DecodeState(state.caches, state.pos + 1, state.enc_kv)


def _decode_dense(params: dict, cfg: ArchConfig, caches: attn.KVCache,
                  pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through the dense or MoE stack (the window masks a linear
    cache too); the KV rows are written in place."""
    for layer, lp in enumerate(_layers(params, cfg)):
        cache = attn.KVCache(caches.k[layer], caches.v[layer], caches.ring)
        h, _ = attn.decode_attend(lp["attn"], rms_norm(x, lp["ln1"]), pos,
                                  cache, cfg, window=cfg.sliding_window)
        x = x + h
        x = x + _ffn(x, lp, cfg)[0]
    return x


def _decode_audio(params: dict, cfg: ArchConfig, state: DecodeState,
                  x: torch.Tensor) -> torch.Tensor:
    """One token through whisper's decoder: self-attention to the KV
    caches (rows written in place), cross-attention to ``enc_kv``."""
    caches, (ek, ev) = state.caches, state.enc_kv
    for layer, lp in enumerate(_layers(params, cfg)):
        cache = attn.KVCache(caches.k[layer], caches.v[layer], caches.ring)
        h, _ = attn.decode_attend(lp["attn"], rms_norm(x, lp["ln1"]),
                                  state.pos, cache, cfg,
                                  window=cfg.sliding_window)
        x = x + h
        h, _ = attn.decode_attend(lp["xattn"], rms_norm(x, lp["ln_x"]),
                                  state.pos, cache, cfg,
                                  cross_kv=(ek[layer], ev[layer]))
        x = x + h
        x = x + _ffn(x, lp, cfg)[0]
    return x


def _decode_ssm(params: dict, cfg: ArchConfig, caches: dict,
                pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through the RWKV6 stack (``pos`` is not read: the state is
    the context); the states are updated in place."""
    tmix = caches["tmix"]
    for layer, lp in enumerate(_layers(params, cfg)):
        st = ssm.RWKVState(tmix.s[layer], tmix.x_prev[layer])
        h, new = ssm.rwkv6_decode(lp["tmix"], rms_norm(x, lp["ln1"]), st,
                                  cfg)
        tmix.s[layer] = new.s
        tmix.x_prev[layer] = new.x_prev
        x = x + h
        xn = rms_norm(x, lp["ln2"])
        x = _cmix(x, xn, caches["cmix_prev"][layer][:, None], lp["cmix"])
        caches["cmix_prev"][layer] = xn[:, 0]
    return x


def _decode_hybrid(params: dict, cfg: ArchConfig, caches: dict,
                   pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through the hybrid stack: each Mamba2 layer's state and
    each application's KV row are updated in place."""
    mamba, kv = caches["mamba"], caches["attn"]
    shared, app = _shared(params), 0
    for layer, lp in enumerate(_layers(params, cfg)):
        h, new = ssm.mamba2_decode(
            lp["mamba"], rms_norm(x, lp["ln1"]),
            ssm.MambaState(mamba.h[layer], mamba.conv[layer]), cfg)
        mamba.h[layer] = new.h
        mamba.conv[layer] = new.conv
        x = x + h
        if _applies_shared(cfg, layer):
            cache = attn.KVCache(kv.k[app], kv.v[app], kv.ring)
            h, _ = attn.decode_attend(shared["attn"],
                                      rms_norm(x, shared["ln1"]), pos,
                                      cache, cfg, window=cfg.sliding_window)
            x = x + h
            x = x + _ffn(x, shared, cfg)[0]
            app += 1
    return x


class DenseLM(nn.Module):
    """The LM (of any ported family) as an ``nn.Module``; parameters keep
    their dotted JAX names (``named_parameters()``), and :meth:`params`
    gives the flat dict the functional :func:`forward` and :func:`lm_loss`
    take."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, value in ordered(params).items():
            *path, leaf = name.split(".")
            owner = self
            for part in path:
                if not hasattr(owner, part):
                    owner.add_module(part, nn.Module())
                owner = getattr(owner, part)
            owner.register_parameter(leaf, nn.Parameter(value))

    def params(self) -> dict:
        return ordered(dict(self.named_parameters()))

    def forward(self, batch) -> torch.Tensor:
        return forward(self.params(), self.cfg, batch)


# ---------------------------------------------------------------------------
# Weight bridge to the JAX package's parameter tree (numpy arrays)
# ---------------------------------------------------------------------------

def _flatten_tree(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def from_jax_params(tree, cfg: ArchConfig, device="cuda") -> DenseLM:
    """A :class:`DenseLM` from the JAX package's nested parameter tree of
    numpy-convertible arrays (bf16 leaves arrive as ``ml_dtypes``
    bfloat16 and keep that dtype; the fp32 round trip is exact)."""
    device = resolve_device(device)
    params = {}
    for name, arr in _flatten_tree(tree).items():
        arr = np.asarray(arr)
        dtype = getattr(torch, str(arr.dtype))
        params[name] = torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=dtype)
    return DenseLM(cfg, params)


def to_jax_params(module: DenseLM) -> dict:
    """The nested parameter tree of float32 numpy arrays (cast them to the
    JAX leaves' dtypes on the JAX side; bf16 values are exact in fp32)."""
    flat = {k: v.detach().float().cpu().numpy()
            for k, v in module.params().items()}
    return _nest(flat)
