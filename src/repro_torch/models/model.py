"""The dense decoder-only LM: init, training forward, loss, weight bridge.

Counterpart of ``repro.models.model`` for the dense family.  Parameters
are a flat dict keyed by dotted names (``"blocks.attn.wq"``) in the JAX
package's leaf order, so a dual or a gradient is a dict of the same keys.
As in JAX, each block leaf is stacked over the layers, ``(L, ...)``, and a
linear is stored ``(in, out)`` for ``x @ W``: the model has 15 leaves at
any depth.  :class:`DenseLM` is the ``nn.Module`` that owns them;
:func:`forward` and :func:`lm_loss` are plain functions of a parameter
dict, so the gossip step can evaluate each worker's own primal.  Each
block is recomputed in the backward pass (``torch.utils.checkpoint``), as
the JAX model checkpoints each scanned block.

Serving (dense family, linear caches): :func:`prefill` runs a prompt
through the flash kernel and returns the last real token's logits and a
:class:`DecodeState`; :func:`decode_step` advances every row one token.
The caches are stacked over the layers, (L, B, cap, KV, hd), as in JAX,
and are updated in place (a copy per step would move the whole cache);
:func:`insert_decode_state` and :func:`evict_decode_state` write and clear
one slot row in place.  Sliding-window ring caches and the other families
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn
from .common import ArchConfig, init_linear, rms_norm, swiglu

BLOCKS = "blocks."


def _leaf_key(name: str) -> tuple:
    return tuple(name.split("."))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device, JAX names and layout."""
    if cfg.family != "dense":
        raise ValueError(f"only the dense family is ported, got "
                         f"{cfg.family!r}")
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    dt, dev = cfg.torch_dtype, generator.device
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    params = {
        "embed": init_linear((cfg.vocab_size, d), dt, generator, scale=1.0),
        "unembed": init_linear((d, cfg.vocab_size), dt, generator),
        "final_norm": ones(d),
        "blocks.ln1": ones(L, d),
        "blocks.ln2": ones(L, d),
        "blocks.mlp.w_gate": init_linear((L, d, ff), dt, generator),
        "blocks.mlp.w_up": init_linear((L, d, ff), dt, generator),
        "blocks.mlp.w_down": init_linear((L, ff, d), dt, generator),
    }
    for k, v in attn.attention_params(cfg, generator, L).items():
        params[f"blocks.attn.{k}"] = v
    return ordered(params)


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
                 p: dict) -> torch.Tensor:
    x = x + attn.attend_train(p["attn"], rms_norm(x, p["ln1"]), positions,
                              cfg)
    return x + _mlp(x, p)


def _layers(params: dict, cfg: ArchConfig):
    """Each layer's nested block parameters, in order."""
    per_layer = {k[len(BLOCKS):]: v.unbind(0) for k, v in params.items()
                 if k.startswith(BLOCKS)}
    for layer in range(cfg.num_layers):
        yield _nest({k: v[layer] for k, v in per_layer.items()})


def _mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    mp = p["mlp"]
    return swiglu(rms_norm(x, p["ln2"]), mp["w_gate"], mp["w_up"],
                  mp["w_down"])


def forward(params: dict, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: (B, S) tokens -> final-normed hidden (B, S, d)."""
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for lp in _layers(params, cfg):
        if torch.is_grad_enabled():
            x = checkpoint(_dense_block, x, positions, cfg, lp,
                           use_reentrant=False)
        else:
            x = _dense_block(x, positions, cfg, lp)
    return rms_norm(x, params["final_norm"])


def logits_fn(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ params["unembed"]


def lm_loss(params: dict, cfg: ArchConfig, batch: dict,
            seq_weights: Optional[torch.Tensor] = None):
    """Next-token cross-entropy; returns (total, {"loss", "ntok"}).

    Labels < 0 are masked.  ``seq_weights`` (B,) are AMB's eq.-3
    per-sequence inclusion weights: the loss is the weighted mean over the
    included sequences, with denominator ``max(sum mask * w, 1)``.
    """
    hidden = forward(params, cfg, batch["tokens"])
    logits = logits_fn(params, hidden).float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    tok_nll = (logz - gold) * mask                          # (B, S)
    if seq_weights is not None:
        w = seq_weights[:, None].float()
        denom = torch.clamp((mask * w).sum(), min=1.0)
        loss = (tok_nll * w).sum() / denom
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = tok_nll.sum() / denom
    return loss, {"loss": loss, "ntok": denom}


# ---------------------------------------------------------------------------
# Serving: prefill and KV-cache decode
# ---------------------------------------------------------------------------

def _check_servable(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"serving the {cfg.family!r} family is not "
                                  f"ported (dense only)")
    if cfg.sliding_window > 0:
        raise NotImplementedError("sliding-window ring caches are not "
                                  "ported; serve with linear caches")


class DecodeState:
    """Decode state: the layer-stacked KV cache and the position(s) the
    next token is written at (a 0-d tensor, or (B,) per slot)."""

    def __init__(self, caches: attn.KVCache, pos: torch.Tensor):
        self.caches, self.pos = caches, pos


@torch.no_grad()
def prefill(params: dict, cfg: ArchConfig, batch: dict,
            extra_capacity: int = 0, last_pos=None) -> tuple:
    """Process a full prompt; returns (last-token logits (B, V) in the
    parameters' dtype, DecodeState ready for :func:`decode_step`).

    The caches hold the prompt's S positions and ``extra_capacity`` empty
    slots.  ``last_pos`` (int or (B,)) is each request's final real prompt
    token, for prompts right-padded to a shared length: logits are taken
    there and decode resumes at ``last_pos + 1`` (causal attention keeps
    the real prefix independent of the padding, and the padded cache rows
    stay masked until decode overwrites them).
    """
    _check_servable(cfg)
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"])
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    shape = (cfg.num_layers, b, s + extra_capacity, cfg.num_kv_heads, cfg.hd)
    caches = attn.KVCache(torch.zeros(shape, dtype=x.dtype, device=dev),
                          torch.zeros(shape, dtype=x.dtype, device=dev))
    for layer, lp in enumerate(_layers(params, cfg)):
        h, (k, v) = attn.attend_train(lp["attn"], rms_norm(x, lp["ln1"]),
                                      positions, cfg, return_kv=True)
        caches.k[layer, :, :s] = k
        caches.v[layer, :, :s] = v
        x = x + h
        x = x + _mlp(x, lp)
    if last_pos is None:
        hidden = rms_norm(x[:, -1:], params["final_norm"])
        pos = torch.tensor(s, device=dev)
    else:
        sel = torch.as_tensor(last_pos, device=dev).long().reshape(-1)
        sel = sel.expand(b).clone()
        hidden = rms_norm(x[torch.arange(b, device=dev), sel][:, None],
                          params["final_norm"])
        pos = sel + 1
    logits = (hidden @ params["unembed"])[:, 0]
    return logits, DecodeState(caches, pos)


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      per_slot_pos: bool = False,
                      device="cuda") -> DecodeState:
    """Zero caches for ``cache_len`` tokens per row; ``per_slot_pos`` gives a
    (batch,) position vector (the slot array, rows decode at their own
    depths) instead of a shared scalar."""
    _check_servable(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.hd)
    caches = attn.KVCache(
        torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        torch.zeros(shape, dtype=cfg.torch_dtype, device=device))
    pos = torch.zeros((batch,) if per_slot_pos else (), dtype=torch.long,
                      device=device)
    return DecodeState(caches, pos)


@torch.no_grad()
def insert_decode_state(state: DecodeState, one: DecodeState,
                        slot: int) -> DecodeState:
    """Write a batch-1 state (from :func:`prefill`) into row ``slot`` of the
    slot array, in place: the row's whole capacity is overwritten, so
    ``one``'s caches must match it (prefill with ``extra_capacity = cap -
    prompt_len``); ``state.pos`` must be the per-slot (B,) form."""
    state.caches.k[:, slot] = one.caches.k[:, 0]
    state.caches.v[:, slot] = one.caches.v[:, 0]
    state.pos[slot] = one.pos.reshape(-1)[0]
    return state


@torch.no_grad()
def evict_decode_state(state: DecodeState, slot: int) -> DecodeState:
    """Zero row ``slot``'s caches and position in place (a retired slot
    keeps no residue of its last request)."""
    state.caches.k[:, slot] = 0
    state.caches.v[:, slot] = 0
    state.pos[slot] = 0
    return state


@torch.no_grad()
def decode_step(params: dict, cfg: ArchConfig, state: DecodeState,
                token: torch.Tensor) -> tuple:
    """One-token decode.  token: (B,) -> (logits (B, V), DecodeState at
    ``pos + 1`` over the same, updated, caches)."""
    _check_servable(cfg)
    x = F.embedding(token.long(), params["embed"])[:, None, :]
    pos = state.pos
    for layer, lp in enumerate(_layers(params, cfg)):
        cache = attn.KVCache(state.caches.k[layer], state.caches.v[layer])
        h, _ = attn.decode_attend(lp["attn"], rms_norm(x, lp["ln1"]), pos,
                                  cache, cfg, window=cfg.sliding_window)
        x = x + h
        x = x + _mlp(x, lp)
    hidden = rms_norm(x, params["final_norm"])
    logits = (hidden @ params["unembed"])[:, 0]
    return logits, DecodeState(state.caches, pos + 1)


class DenseLM(nn.Module):
    """The dense LM as an ``nn.Module``; parameters keep their dotted JAX
    names (``named_parameters()``), and :meth:`params` gives the flat dict
    the functional :func:`forward` and :func:`lm_loss` take."""

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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), self.cfg, tokens)


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
