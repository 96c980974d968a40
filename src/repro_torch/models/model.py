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

Serving over a model axis (every family):
:func:`prefill`,
:func:`decode_step` and :func:`init_decode_state` take ``tp`` (a
:class:`repro_torch.dist.tp.TensorParallel` under the serving layout,
``fsdp_axis=None``) as :func:`forward_aux` does, and ``params`` then
holds this rank's blocks: each rank computes its ``H / M`` query and
``KV / M`` KV heads (the flash call takes only those; with more model
ranks than KV heads the ``M / KV`` ranks that share a head each hold
``hd / (M / KV)`` of its columns, gather the head before the qk-norm and
the rope, and hold equal caches of it), its experts (the MoE layer,
:func:`repro_torch.models.moe.moe_forward`), its RWKV6 heads and their
states (not padded; :func:`repro_torch.models.ssm.rwkv6_forward` and
:func:`_cmix`), whisper's encoder, self- and cross-attention heads and
its heads of ``enc_kv``, the hybrid's Mamba2 heads (their states: h
by heads, the conv tail the heads' x channels and B, C;
:func:`repro_torch.models.ssm.mamba2_forward`) and its shared block's
heads, sums the row-parallel
``wo``, MLP and expert products over "model", looks tokens up in its
rows of the vocabulary, and returns its ``padded_vocab / M`` columns of
the logits, unsliced (the caller gathers them, then slices to
``vocab_size``: ``TensorParallel.vocab_logits``, so that no pick takes a
padded row's column).  Training over a model axis reads the same leaves
as FSDP x TP or TP blocks (:func:`forward_aux`), whisper's encoder
blocks gathered under their own names (``"encoder.blocks."``), the
hybrid's shared block gathered over "data" once a step and applied after
every ``attn_every``-th layer.
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
XATTN = BLOCKS + "xattn."         # whisper's cross-attention leaves
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _leaf_key(name: str) -> tuple:
    return tuple(name.split("."))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device, JAX names and layout."""
    return ordered({k: make(generator) for k, make in param_plan(cfg)})


def param_plan(cfg: ArchConfig) -> list:
    """Every leaf in :func:`init_params`' draw order, each as ``(name,
    make(generator))``: making them one at a time draws what
    :func:`init_params` draws, so a caller can keep a slice of each leaf
    and drop the rest before the next is made (the sharded sessions; an
    expert leaf's ``make`` is a :class:`repro_torch.models.moe.Layered`).
    Audio: the head, the decoder blocks (a dense block's leaves, then
    ``ln_x`` and the cross-attention's), the encoder blocks, the
    encoder's final norm.  Hybrid: the head, the blocks (``ln1``, then the
    Mamba2 leaves), the shared block drawn as a one-layer dense block and
    cut to its layer."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"only the {', '.join(FAMILIES)} families are "
                         f"ported, got {cfg.family!r}")
    d, dt, v = cfg.d_model, cfg.torch_dtype, cfg.padded_vocab
    head = [("embed", lambda g: init_linear((v, d), dt, g, scale=1.0)),
            ("unembed", lambda g: init_linear((d, v), dt, g)),
            ("final_norm", lambda g: torch.ones((d,), dtype=torch.float32,
                                                device=g.device))]
    if cfg.family == "ssm":
        plan = _ssm_plan(cfg, cfg.num_layers)
    elif cfg.family == "hybrid":
        ones, _ = _makers(cfg, cfg.num_layers)
        plan = [("ln1", ones)] + [(f"mamba.{k}", make) for k, make in
                                  ssm.mamba2_plan(cfg, cfg.num_layers)]
    elif cfg.family == "audio":
        plan = _encdec_plan(cfg, cfg.num_layers)
    else:
        plan = _dense_plan(cfg, cfg.num_layers)
    plan = head + [(BLOCKS + k, make) for k, make in plan]
    if cfg.family == "audio":
        plan += [(ENCODER + BLOCKS + k, make)
                 for k, make in _dense_plan(cfg, cfg.encoder_layers)]
        plan.append((ENCODER + "final_norm", head[2][1]))
    if cfg.family == "hybrid" and cfg.attn_every:
        plan += [(SHARED + k, lambda g, make=make: make(g)[0])
                 for k, make in _dense_plan(cfg, 1)]
    return plan


def _makers(cfg: ArchConfig, layers: int) -> tuple:
    """(a layer-stacked fp32 norm of ones, ``linear(shape)``: an
    ``init_linear`` in the model's dtype), each as ``make(generator)``."""
    def ones(g):
        return torch.ones((layers, cfg.d_model), dtype=torch.float32,
                          device=g.device)

    def linear(shape):
        return lambda g: init_linear(shape, cfg.torch_dtype, g)
    return ones, linear


def _ssm_plan(cfg: ArchConfig, layers: int) -> list:
    """``(key below the block, make(generator))`` of an RWKV6 block's
    leaves, stacked over ``layers``, in draw order: the time mix, the
    norms, the channel mix."""
    d, ff = cfg.d_model, cfg.d_ff
    ones, linear = _makers(cfg, layers)
    return ([(f"tmix.{k}", make) for k, make in ssm.rwkv6_plan(cfg, layers)]
            + [("ln1", ones), ("ln2", ones),
               ("cmix.mu", lambda g: torch.full((layers, 2, d), 0.5,
                                                dtype=cfg.torch_dtype,
                                                device=g.device)),
               ("cmix.w_k", linear((layers, d, ff))),
               ("cmix.w_v", linear((layers, ff, d))),
               ("cmix.w_r", linear((layers, d, d)))])


def _dense_plan(cfg: ArchConfig, layers: int) -> list:
    """``(key below the block, make(generator))`` of a dense or MoE
    block's leaves, stacked over ``layers``, in draw order: the norms,
    the MLP (MoE: :func:`repro_torch.models.moe.moe_plan`), the
    attention."""
    d, ff = cfg.d_model, cfg.d_ff
    ones, linear = _makers(cfg, layers)
    if cfg.is_moe:
        ffn = [(f"moe.{k}", make) for k, make in moe.moe_plan(cfg, layers)]
    else:
        ffn = [("mlp.w_gate", linear((layers, d, ff))),
               ("mlp.w_up", linear((layers, d, ff))),
               ("mlp.w_down", linear((layers, ff, d)))]
    return ([("ln1", ones), ("ln2", ones)] + ffn
            + [(f"attn.{k}", make)
               for k, make in attn.attention_plan(cfg, layers)])


def _encdec_plan(cfg: ArchConfig, layers: int) -> list:
    """``(key below the block, make(generator))`` of a whisper decoder
    block's leaves, stacked over ``layers``, in draw order: a dense
    block's (the norms, the MLP, the self-attention), then ``ln_x`` and
    the cross-attention (no QKV bias)."""
    ones, _ = _makers(cfg, layers)
    return (_dense_plan(cfg, layers) + [("ln_x", ones)]
            + [(f"xattn.{k}", make)
               for k, make in attn.attention_plan(cfg, layers, cross=True)])


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
                 p: dict, causal: bool = True, group=None,
                 tp=None, prefix: str = BLOCKS,
                 gathered: bool = False) -> tuple:
    """(the block's output, its load-balance loss: None without experts;
    ``group`` as in :func:`repro_torch.models.moe.moe_forward`).  With
    ``tp`` (:class:`repro_torch.dist.tp.TensorParallel`) ``p`` holds this
    rank's blocks of the leaves under ``prefix`` (``"encoder.blocks."``:
    whisper's encoder; ``"shared_attn."``: the hybrid's shared block),
    gathered over "data" here unless ``gathered`` (the caller gathered
    them), and the attention and MLP run tensor-parallel over
    "model"."""
    if tp is not None and not gathered:
        p = tp.block(p, prefix)
    x = x + attn.attend_train(p["attn"], rms_norm(x, p["ln1"]), positions,
                              cfg, causal=causal, tp=tp,
                              prefix=prefix + "attn.")
    h, aux = _ffn(x, p, cfg, group, tp, prefix)
    return x + h, aux


def _encoder_block(x: torch.Tensor, positions: torch.Tensor,
                   cfg: ArchConfig, p: dict, tp=None) -> torch.Tensor:
    """A whisper encoder block: a dense block with no causal mask (its
    self-attention roped over the frames)."""
    return _dense_block(x, positions, cfg, p, causal=False, tp=tp,
                        prefix=ENCODER + BLOCKS)[0]


def _encdec_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                  p: dict, enc_out: torch.Tensor, tp=None) -> torch.Tensor:
    """A whisper decoder block: causal self-attention, cross-attention to
    ``enc_out`` (no rope, no mask), the MLP.  With ``tp`` this rank's
    heads of both attentions (the cross-attention's ``wk`` and ``wv``
    columns read ``enc_out``, which every model rank holds whole)."""
    if tp is not None:
        p = tp.block(p)
    x = x + attn.attend_train(p["attn"], rms_norm(x, p["ln1"]), positions,
                              cfg, tp=tp)
    x = x + attn.attend_train(p["xattn"], rms_norm(x, p["ln_x"]), positions,
                              cfg, causal=False, window=0, kv_input=enc_out,
                              rope=False, tp=tp, prefix=XATTN)
    return x + _ffn(x, p, cfg, tp=tp)[0]


def _cmix(x: torch.Tensor, xn: torch.Tensor, xp: torch.Tensor,
          cm: dict, tp=None) -> torch.Tensor:
    """The RWKV6 channel mix on the residual x: xn normed, xp its token
    shift.  With ``tp`` (xn and xp through ``tp.copy``) ``cm`` holds this
    rank's blocks: its ``d_ff / M`` columns of the squared-ReLU key are
    gathered over "model" (``w_v`` is split by its d_model columns, not
    its ffn rows), and its ``d / M`` output channels are gathered into the
    residual."""
    if tp is not None:
        cm = tp.ssm_leaves(cm, "blocks.cmix.")
    k_in = xn * cm["mu"][0] + xp * (1 - cm["mu"][0])
    r_in = xn * cm["mu"][1] + xp * (1 - cm["mu"][1])
    k = torch.square(torch.relu(k_in @ cm["w_k"]))
    if tp is not None:
        k = tp.gather_model(k, -1, summed=True)
    out = torch.sigmoid(r_in @ cm["w_r"]) * (k @ cm["w_v"])
    if tp is not None:
        out = tp.gather_model(out, -1, summed=False)
    return x + out


def _rwkv_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                p: dict, tp=None) -> tuple:
    """(the block's output, None: no load-balance loss).  With ``tp`` ``p``
    holds this rank's blocks, gathered over "data" here, and the time and
    channel mixes run over "model" (:func:`repro_torch.models.ssm.
    rwkv6_forward`, :func:`_cmix`)."""
    if tp is not None:
        p = tp.block(p)
    x = x + ssm.rwkv6_forward(p["tmix"], rms_norm(x, p["ln1"]), cfg, tp=tp)
    xn = rms_norm(x, p["ln2"])
    if tp is not None:
        xn = tp.copy(xn)
    return _cmix(x, xn, F.pad(xn, (0, 0, 1, 0))[:, :-1], p["cmix"], tp), None


def _mamba_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                 p: dict, tp=None) -> tuple:
    """(the block's output, None: no load-balance loss).  With ``tp`` ``p``
    holds this rank's blocks, gathered over "data" here, and Mamba2 runs
    on the rank's heads (:func:`repro_torch.models.ssm.mamba2_forward`)."""
    if tp is not None:
        p = tp.block(p)
    return x + ssm.mamba2_forward(p["mamba"], rms_norm(x, p["ln1"]), cfg,
                                  tp=tp), None


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


def _ffn(x: torch.Tensor, p: dict, cfg: ArchConfig, group=None,
         tp=None, prefix: str = BLOCKS) -> tuple:
    """The block's feed-forward of the residual x: (h, the fp32
    load-balance loss, None without experts)."""
    xn = rms_norm(x, p["ln2"])
    if cfg.is_moe:
        return moe.moe_forward(p["moe"], xn, cfg, group, tp)
    mp = p["mlp"]
    if tp is not None:
        return tp.mlp(lambda h: swiglu(h, mp["w_gate"], mp["w_up"],
                                       mp["w_down"]), xn,
                      prefix + "mlp."), None
    return swiglu(xn, mp["w_gate"], mp["w_up"], mp["w_down"]), None


def _embed(params: dict, cfg: ArchConfig, batch: dict,
           tp=None) -> torch.Tensor:
    """The decoder's input: ``batch["embeds"]`` in the model's dtype (a
    copy: the prefill updates it in place), else the tokens' rows of the
    embedding (with ``tp``, the vocab-parallel lookup)."""
    if "embeds" in batch:
        return batch["embeds"].to(cfg.torch_dtype, copy=True)
    if tp is not None:
        return tp.embed(params["embed"], batch["tokens"])
    return F.embedding(batch["tokens"], params["embed"])


def _run(fn, x: torch.Tensor, *args, **kwargs):
    """``fn(x, *args, **kwargs)``, recomputed in the backward pass
    (``torch.utils.checkpoint``) when a gradient is being taken."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False, **kwargs)
    return fn(x, *args, **kwargs)


def _encoder_forward(params: dict, cfg: ArchConfig,
                     enc_embeds: torch.Tensor, tp=None) -> torch.Tensor:
    """Whisper's encoder over (B, frames, d) embeddings: the blocks with
    no causal mask, each checkpointed, then the final norm (replicated:
    every model rank holds the output whole).  With ``tp`` this rank's
    heads and MLP columns."""
    x = enc_embeds.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    extra = {} if tp is None else {"tp": tp}
    for lp in _layers(params, cfg, ENCODER + BLOCKS):
        x = _run(_encoder_block, x, positions, cfg, lp, **extra)
    return rms_norm(x, params[ENCODER + "final_norm"])


def forward_aux(params: dict, cfg: ArchConfig, batch, group=None,
                tp=None) -> tuple:
    """Training forward: a batch (``{"tokens"}``, ``{"embeds"}``, and
    ``"enc_embeds"`` for audio; a bare (B, S) token tensor is taken as
    ``{"tokens": ...}``) -> (final-normed hidden (B, S, d), the fp32
    load-balance loss summed over the layers), as JAX's ``forward``.
    ``group``: this process's worker of a process group, whose MoE layers
    take the routing counts across the workers (the exact step).
    ``tp``: this rank's place in a worker spread over a model axis
    (:class:`repro_torch.dist.tp.TensorParallel`), whose blocks
    ``params`` holds."""
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    x = _embed(params, cfg, batch, tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "audio":
        enc_out = _encoder_forward(params, cfg, batch["enc_embeds"], tp)
        extra = {} if tp is None else {"tp": tp}
        for lp in _layers(params, cfg):
            x = _run(_encdec_block, x, positions, cfg, lp, enc_out, **extra)
        return rms_norm(x, params["final_norm"]), aux
    block = {"ssm": _rwkv_block, "hybrid": _mamba_block}.get(cfg.family,
                                                             _dense_block)
    extra = {"group": group} if group is not None and cfg.is_moe else {}
    shared, shared_extra = None, {}
    if cfg.family == "hybrid":
        shared = _shared(params)
    if tp is not None:
        extra["tp"] = tp
        if shared is not None:
            # gathered over "data" once a step, outside the checkpointed
            # applications: the gradient accumulates over every
            # application before the one reduce-scatter
            shared = tp.block(shared, SHARED)
            shared_extra = {"tp": tp, "prefix": SHARED, "gathered": True}
    for layer, lp in enumerate(_layers(params, cfg)):
        x, a = _run(block, x, positions, cfg, lp, **extra)
        if a is not None:
            aux = aux + a
        if _applies_shared(cfg, layer):
            x, _ = _run(_dense_block, x, positions, cfg, shared,
                        **shared_extra)
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


def logits_fn(params: dict, cfg: ArchConfig, hidden: torch.Tensor,
              tp=None) -> torch.Tensor:
    """(..., d) hidden -> (..., vocab_size) logits.  With ``tp`` splitting
    the vocabulary over "model": this rank's ``padded_vocab / M`` columns,
    not sliced (the last rank's hold the padded rows' columns: take the
    whole logits through ``tp.vocab_logits``, which cuts them)."""
    logits = hidden @ params["unembed"]
    if tp is not None and tp.split("unembed"):
        return logits
    return _vocab(cfg, logits)


def lm_loss(params: dict, cfg: ArchConfig, batch: dict,
            seq_weights: Optional[torch.Tensor] = None,
            denom: Optional[torch.Tensor] = None, group=None, tp=None):
    """Next-token cross-entropy plus ``0.01 * aux`` (the MoE load-balance
    loss, 0 without experts); returns (total, {"loss", "aux", "ntok"}), as
    JAX's.

    Labels < 0 are masked.  ``seq_weights`` (B,) are AMB's eq.-3
    per-sequence inclusion weights: the loss is the weighted mean over the
    included sequences, with denominator ``max(sum mask * w, 1)``.  A
    worker that holds only its own rows of the global batch passes the
    global ``denom`` (that maximum over every worker's rows), so its loss
    is its share of the global one; with ``group`` (an MoE model's
    exact step over a process group) so is its ``aux``.  With ``tp`` the
    logits stay split by columns over "model" (the vocab-parallel
    cross-entropy), and every model rank of a worker returns the same
    numbers.
    """
    hidden, aux = forward_aux(params, cfg, batch, group, tp)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    nll = None if tp is None else tp.token_nll(
        hidden, params["unembed"], labels, cfg.vocab_size)
    if nll is None:
        unembed = params["unembed"] if tp is None \
            else tp.gather("unembed", params["unembed"])
        logits = _vocab(cfg, hidden @ unembed).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = logz - gold
    tok_nll = nll * mask                                    # (B, S)
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


def _ssm_caches(cfg: ArchConfig, batch: int, device, tp=None) -> dict:
    """Zero ssm decode states stacked over the layers (with ``tp``, this
    rank's heads, not padded)."""
    one = ssm.rwkv6_init_state(cfg, batch, device,
                               0 if tp is None else tp.ssm_heads(cfg))
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


def _prefill_ssm(params: dict, cfg: ArchConfig, x: torch.Tensor,
                 tp=None) -> tuple:
    """The RWKV6 stack over a prompt: (the last layer's output, the
    stacked decode states after its last token; with ``tp`` this rank's
    heads)."""
    caches = _ssm_caches(cfg, x.shape[0], x.device, tp)
    for layer, lp in enumerate(_layers(params, cfg)):
        h, st = ssm.rwkv6_forward(lp["tmix"], rms_norm(x, lp["ln1"]), cfg,
                                  return_state=True, tp=tp)
        caches["tmix"].s[layer] = st.s
        caches["tmix"].x_prev[layer] = st.x_prev
        x = x + h
        xn = rms_norm(x, lp["ln2"])
        x = _cmix(x, xn, F.pad(xn, (0, 0, 1, 0))[:, :-1], lp["cmix"], tp)
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
                         causal: bool = True, tp=None,
                         prefix: str = BLOCKS) -> None:
    """One dense or MoE block ``p`` over a prompt, in place on ``x``: its
    token-wise work ``attn.PREFILL_ROWS`` tokens at a time, its attention
    through the flash kernel (with no causal mask unless ``causal``: the
    whisper encoder), its k and v written into cache row ``row`` (linear:
    rows 0..S-1; ring: packed as it comes; ``caches`` None: kept
    nowhere).  With ``tp`` this rank's heads, the row-parallel products
    summed over "model" (``prefix``: where the block's leaves sit,
    ``"encoder.blocks."`` for whisper's encoder)."""
    b, s, _ = x.shape
    hd = cfg.hd
    kvh = cfg.num_kv_heads if tp is None else tp.kv_heads(cfg)
    qh = cfg.num_heads if tp is None else tp.q_heads(cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    chunks = [slice(c, min(c + attn.PREFILL_ROWS, s))
              for c in range(0, s, attn.PREFILL_ROWS)]
    ap = p["attn"] if tp is None else tp.heads(p["attn"], prefix + "attn.")
    q = x.new_empty((b, s, kvh, qh // kvh, hd))
    if caches is None or caches.ring:
        k, v = x.new_empty((b, s, kvh, hd)), x.new_empty((b, s, kvh, hd))
    else:
        k, v = caches.k[row, :, :s], caches.v[row, :, :s]
    for c in chunks:
        q[:, c], k[:, c], v[:, c] = attn.qkv_rope(
            ap, rms_norm(x[:, c], p["ln1"]), positions[:, c], cfg, tp)
    out = attn.flash_prefill(q, k, v, cfg.sliding_window, causal=causal)
    del q
    if caches is not None and caches.ring:
        cap = caches.k.shape[2]
        caches.k[row] = _ring_from_linear(k, cap)
        caches.v[row] = _ring_from_linear(v, cap)
    del k, v
    for c in chunks:
        h = out[:, c] @ ap["wo"]
        x[:, c].add_(h if tp is None else tp.attention_out(h,
                                                           prefix + "attn."))
        if not cfg.is_moe:
            x[:, c].add_(_ffn(x[:, c], p, cfg, tp=tp, prefix=prefix)[0])
    del out
    if cfg.is_moe:
        x.add_(_ffn(x, p, cfg, tp=tp)[0])


def _prefill_encdec_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                          enc_out: torch.Tensor, caches: attn.KVCache,
                          enc_kv: tuple, row: int, tp=None) -> None:
    """One whisper decoder block over a prompt, in place on ``x``: causal
    self-attention through the flash kernel (its k and v into cache row
    ``row``), cross-attention to ``enc_out`` through the flash kernel with
    no mask and no rope (its k and v into ``enc_kv``'s row ``row``), the
    MLP.  With ``tp`` this rank's heads of both, the row-parallel products
    summed over "model"."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    ap = p["attn"] if tp is None else tp.heads(p["attn"])
    q, k, v = attn.qkv_rope(ap, rms_norm(x, p["ln1"]), positions, cfg, tp)
    if caches.ring:
        cap = caches.k.shape[2]
        caches.k[row] = _ring_from_linear(k, cap)
        caches.v[row] = _ring_from_linear(v, cap)
    else:
        caches.k[row, :, :s] = k
        caches.v[row, :, :s] = v
    h = attn.flash_prefill(q, k, v, cfg.sliding_window) @ ap["wo"]
    x.add_(h if tp is None else tp.attention_out(h))
    xp = p["xattn"] if tp is None else tp.heads(p["xattn"], XATTN)
    q, k, v = attn._project_qkv(xp, rms_norm(x, p["ln_x"]), cfg,
                                kv_input=enc_out, tp=tp)
    enc_kv[0][row], enc_kv[1][row] = k, v
    h = attn.flash_prefill(q, k, v, 0, causal=False) @ xp["wo"]
    x.add_(h if tp is None else tp.attention_out(h, XATTN))
    x.add_(_ffn(x, p, cfg, tp=tp)[0])


def _prefill_audio(params: dict, cfg: ArchConfig, x: torch.Tensor,
                   enc_embeds: torch.Tensor, cap: int, tp=None) -> tuple:
    """Whisper over a prompt: the encoder (its blocks through
    :func:`_prefill_dense_block` with no causal mask and no cache), then
    the decoder in place on ``x``; returns (the decoder's KV caches of
    ``cap`` rows, ``enc_kv``: (k, v) each (L, B, frames, KV, hd); with
    ``tp`` this rank's KV heads of both)."""
    enc = enc_embeds.to(cfg.torch_dtype, copy=True)
    for lp in _layers(params, cfg, ENCODER + BLOCKS):
        _prefill_dense_block(lp, cfg, enc, None, 0, causal=False, tp=tp,
                             prefix=ENCODER + BLOCKS)
    enc = rms_norm(enc, params[ENCODER + "final_norm"])
    b = x.shape[0]
    caches = _kv_caches(cfg, cfg.num_layers, b, cap, x.dtype, x.device, tp)
    enc_kv = _enc_kv(cfg, b, enc.shape[1], x.device, tp)
    for layer, lp in enumerate(_layers(params, cfg)):
        _prefill_encdec_block(lp, cfg, x, enc, caches, enc_kv, layer, tp)
    return caches, enc_kv


def _enc_kv(cfg: ArchConfig, batch: int, frames: int, device,
            tp=None) -> tuple:
    """Zero cross-attention K and V, (L, B, frames, KV, hd) each (with
    ``tp``, this rank's KV heads)."""
    kv = cfg.num_kv_heads if tp is None else tp.kv_heads(cfg)
    shape = (cfg.num_layers, batch, frames, kv, cfg.hd)
    return tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                 for _ in range(2))


def _kv_caches(cfg: ArchConfig, rows: int, batch: int, cap: int, dtype,
               device, tp=None) -> attn.KVCache:
    """Zero KV caches (rows, B, cap, KV, hd), ring under a window (with
    ``tp``, this rank's KV heads)."""
    kv = cfg.num_kv_heads if tp is None else tp.kv_heads(cfg)
    shape = (rows, batch, cap, kv, cfg.hd)
    return attn.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        cfg.sliding_window > 0)


def _hybrid_caches(cfg: ArchConfig, batch: int, cap: int, device,
                   tp=None) -> dict:
    """Zero hybrid caches: every layer's Mamba2 state, and a KV cache of
    ``cap`` rows for each application of the shared block (one, unused,
    without it, as in JAX); with ``tp`` this rank's Mamba2 heads (its conv
    tail its x channels and B, C) and KV heads."""
    one = ssm.mamba2_init_state(cfg, batch, device,
                                0 if tp is None else tp.mamba_heads(cfg))
    apps = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    return {"mamba": ssm.MambaState(*(t.new_zeros((cfg.num_layers,)
                                                  + t.shape) for t in one)),
            "attn": _kv_caches(cfg, max(apps, 1), batch, cap,
                               cfg.torch_dtype, device, tp)}


def _prefill_hybrid(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    cap: int, tp=None) -> tuple:
    """The hybrid stack over a prompt: (the last layer's output, {"mamba":
    each layer's state after the prompt, "attn": each application's KV
    cache of ``cap`` rows}; with ``tp`` this rank's heads of both).  ``x``
    is updated in place."""
    caches = _hybrid_caches(cfg, x.shape[0], cap, x.device, tp)
    shared, app = _shared(params), 0
    for layer, lp in enumerate(_layers(params, cfg)):
        h, st = ssm.mamba2_forward(lp["mamba"], rms_norm(x, lp["ln1"]), cfg,
                                   return_state=True, tp=tp)
        x.add_(h)
        caches["mamba"].h[layer] = st.h
        caches["mamba"].conv[layer] = st.conv
        del h, st
        if _applies_shared(cfg, layer):
            _prefill_dense_block(shared, cfg, x, caches["attn"], app, tp=tp,
                                 prefix=SHARED)
            app += 1
    return x, caches


@torch.no_grad()
def prefill(params: dict, cfg: ArchConfig, batch: dict,
            extra_capacity: int = 0, last_pos=None, tp=None) -> tuple:
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
    audio; the logits have ``vocab_size`` columns.  ``tp``: this rank's
    blocks over a model axis (see the module note).
    """
    _check_servable(cfg)
    x = _embed(params, cfg, batch, tp)
    b, s, _ = x.shape
    window = cfg.sliding_window
    cap = min(window, s) if window > 0 else s + extra_capacity
    enc_kv = None
    if cfg.family == "ssm":
        x, caches = _prefill_ssm(params, cfg, x, tp)
    elif cfg.family == "hybrid":
        x, caches = _prefill_hybrid(params, cfg, x, cap, tp)
    elif cfg.family == "audio":
        caches, enc_kv = _prefill_audio(params, cfg, x, batch["enc_embeds"],
                                        cap, tp)
    else:
        caches = _kv_caches(cfg, cfg.num_layers, b, cap, x.dtype, x.device,
                            tp)
        for layer, lp in enumerate(_layers(params, cfg)):
            _prefill_dense_block(lp, cfg, x, caches, layer, tp=tp)
    hidden, pos = _last_hidden(params, x, last_pos)
    return (logits_fn(params, cfg, hidden, tp)[:, 0],
            DecodeState(caches, pos, enc_kv))


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      per_slot_pos: bool = False, device="cuda",
                      tp=None) -> DecodeState:
    """Zero caches for ``cache_len`` tokens per row (ring caches of
    ``min(window, cache_len)`` rows under a sliding window; ssm: zero
    states, of a size independent of ``cache_len``; audio: also a zero
    ``enc_kv`` of ``encoder_seq`` frames, 1500 if it is unset, as in JAX);
    ``per_slot_pos`` gives a (batch,) position vector (the slot array,
    rows decode at their own depths) instead of a shared scalar.  ``tp``:
    this rank's KV heads' caches, or its RWKV6 or Mamba2 heads' states
    (over a model axis)."""
    _check_servable(cfg)
    device = resolve_device(device)
    ring = cfg.sliding_window > 0
    cap = min(cfg.sliding_window, cache_len) if ring else cache_len
    enc_kv = None
    if cfg.family == "audio":
        enc_kv = _enc_kv(cfg, batch, cfg.encoder_seq or 1500, device, tp)
    if cfg.family == "ssm":
        caches = _ssm_caches(cfg, batch, device, tp)
    elif cfg.family == "hybrid":
        caches = _hybrid_caches(cfg, batch, cap, device, tp)
    else:
        caches = _kv_caches(cfg, cfg.num_layers, batch, cap,
                            cfg.torch_dtype, device, tp)
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
                token: torch.Tensor, tp=None, group=None) -> tuple:
    """One-token decode.  token: (B,) -> (logits (B, vocab_size),
    DecodeState at ``pos + 1`` over the same, updated, caches).  ``tp``:
    this rank's blocks over a model axis: the vocab-parallel lookup, its
    heads, and its columns of the logits (see :func:`logits_fn`).  ``group``: the
    :class:`repro_torch.dist.group.WorkerGroup` whose workers each hold
    B of the slot rows (the slot engine over a group): an MoE layer
    gathers every worker's rows and dispatches them as one group, as JAX
    dispatches a decode batch."""
    _check_servable(cfg)
    if tp is None:
        x = F.embedding(token.long(), params["embed"])[:, None, :]
    else:
        x = tp.embed(params["embed"], token.long())[:, None, :]
    if cfg.family == "audio":
        x = _decode_audio(params, cfg, state, x, tp)
    elif cfg.family == "ssm":
        x = _decode_ssm(params, cfg, state.caches, x, tp)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, state.caches, state.pos, x, tp)
    else:
        x = _decode_dense(params, cfg, state.caches, state.pos, x, tp,
                          group if cfg.is_moe else None)
    hidden = rms_norm(x, params["final_norm"])
    logits = logits_fn(params, cfg, hidden, tp)[:, 0]
    return logits, DecodeState(state.caches, state.pos + 1, state.enc_kv)


def _decode_dense(params: dict, cfg: ArchConfig, caches: attn.KVCache,
                  pos: torch.Tensor, x: torch.Tensor, tp=None,
                  group=None) -> torch.Tensor:
    """One token through the dense or MoE stack (the window masks a linear
    cache too); the KV rows are written in place.  With ``tp`` this
    rank's heads, the row-parallel products summed over "model"; with
    ``group`` an MoE layer's input gathered over the workers (see
    :func:`decode_step`)."""
    for layer, lp in enumerate(_layers(params, cfg)):
        cache = attn.KVCache(caches.k[layer], caches.v[layer], caches.ring)
        ap = lp["attn"] if tp is None else tp.heads(lp["attn"])
        h, _ = attn.decode_attend(ap, rms_norm(x, lp["ln1"]), pos, cache,
                                  cfg, window=cfg.sliding_window, tp=tp)
        x = x + (h if tp is None else tp.attention_out(h))
        if cfg.is_moe and group is not None:
            rows = x.shape[0]
            h = _ffn(group.gather_rows(x), lp, cfg, tp=tp)[0]
            x = x + h[group.worker * rows:(group.worker + 1) * rows]
        else:
            x = x + _ffn(x, lp, cfg, tp=tp)[0]
    return x


def _decode_audio(params: dict, cfg: ArchConfig, state: DecodeState,
                  x: torch.Tensor, tp=None) -> torch.Tensor:
    """One token through whisper's decoder: self-attention to the KV
    caches (rows written in place), cross-attention to ``enc_kv``.  With
    ``tp`` this rank's heads of both (its heads of ``enc_kv``), the
    row-parallel products summed over "model"."""
    caches, (ek, ev) = state.caches, state.enc_kv
    for layer, lp in enumerate(_layers(params, cfg)):
        cache = attn.KVCache(caches.k[layer], caches.v[layer], caches.ring)
        ap = lp["attn"] if tp is None else tp.heads(lp["attn"])
        h, _ = attn.decode_attend(ap, rms_norm(x, lp["ln1"]), state.pos,
                                  cache, cfg, window=cfg.sliding_window,
                                  tp=tp)
        x = x + (h if tp is None else tp.attention_out(h))
        xp = lp["xattn"] if tp is None else tp.heads(lp["xattn"], XATTN)
        h, _ = attn.decode_attend(xp, rms_norm(x, lp["ln_x"]), state.pos,
                                  cache, cfg, cross_kv=(ek[layer], ev[layer]),
                                  tp=tp)
        x = x + (h if tp is None else tp.attention_out(h, XATTN))
        x = x + _ffn(x, lp, cfg, tp=tp)[0]
    return x


def _decode_ssm(params: dict, cfg: ArchConfig, caches: dict,
                x: torch.Tensor, tp=None) -> torch.Tensor:
    """One token through the RWKV6 stack (the state is the context: no
    position); the states are updated in place (with ``tp``, this rank's
    heads')."""
    tmix = caches["tmix"]
    for layer, lp in enumerate(_layers(params, cfg)):
        st = ssm.RWKVState(tmix.s[layer], tmix.x_prev[layer])
        h, new = ssm.rwkv6_decode(lp["tmix"], rms_norm(x, lp["ln1"]), st,
                                  cfg, tp)
        tmix.s[layer] = new.s
        tmix.x_prev[layer] = new.x_prev
        x = x + h
        xn = rms_norm(x, lp["ln2"])
        x = _cmix(x, xn, caches["cmix_prev"][layer][:, None], lp["cmix"],
                  tp)
        caches["cmix_prev"][layer] = xn[:, 0]
    return x


def _decode_hybrid(params: dict, cfg: ArchConfig, caches: dict,
                   pos: torch.Tensor, x: torch.Tensor,
                   tp=None) -> torch.Tensor:
    """One token through the hybrid stack: each Mamba2 layer's state and
    each application's KV row are updated in place (with ``tp``, this
    rank's heads', the row-parallel products summed over "model")."""
    mamba, kv = caches["mamba"], caches["attn"]
    shared, app = _shared(params), 0
    prefix = SHARED + "attn."
    for layer, lp in enumerate(_layers(params, cfg)):
        h, new = ssm.mamba2_decode(
            lp["mamba"], rms_norm(x, lp["ln1"]),
            ssm.MambaState(mamba.h[layer], mamba.conv[layer]), cfg, tp)
        mamba.h[layer] = new.h
        mamba.conv[layer] = new.conv
        x = x + h
        if _applies_shared(cfg, layer):
            cache = attn.KVCache(kv.k[app], kv.v[app], kv.ring)
            ap = shared["attn"] if tp is None else tp.heads(shared["attn"],
                                                            prefix)
            h, _ = attn.decode_attend(ap, rms_norm(x, shared["ln1"]), pos,
                                      cache, cfg, window=cfg.sliding_window,
                                      tp=tp)
            x = x + (h if tp is None else tp.attention_out(h, prefix))
            x = x + _ffn(x, shared, cfg, tp=tp, prefix=SHARED)[0]
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
