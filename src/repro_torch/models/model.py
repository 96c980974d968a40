"""The decoder-only LMs: init, training forward, loss, weight bridge.

Counterpart of ``repro.models.model`` for the dense family and the RWKV6
``"ssm"`` family.  Parameters are a flat dict keyed by dotted names
(``"blocks.attn.wq"``) in the JAX package's leaf order, so a dual or a
gradient is a dict of the same keys.  As in JAX, each block leaf is
stacked over the layers, ``(L, ...)``, and a linear is stored ``(in,
out)`` for ``x @ W``: the dense model has 15 leaves at any depth, the
RWKV6 model 20.  :class:`DenseLM` is the ``nn.Module`` that owns them (of
either family); :func:`forward` and :func:`lm_loss` are plain functions of
a parameter dict, so the gossip step can evaluate each worker's own
primal.  Each block is recomputed in the backward pass
(``torch.utils.checkpoint``), as the JAX model checkpoints each scanned
block.

Serving: :func:`prefill` runs a prompt (dense: attention through the flash
kernel; ssm: the wkv scan through its kernel) and returns the last real
token's logits and a :class:`DecodeState`; :func:`decode_step` advances
every row one token.  The caches are stacked over the layers with batch on
axis 1, as in JAX: dense KV caches (L, B, cap, KV, hd); ssm states
``{"tmix": RWKVState(s (L, B, heads, hd, hd), x_prev (L, B, d)),
"cmix_prev": (L, B, d)}``.  They are updated in place (a copy per step
would move the whole cache); :func:`insert_decode_state` and
:func:`evict_decode_state` write and clear one slot row of every cache
tensor in place.  Sliding-window ring caches and the other families raise
``NotImplementedError``.
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
from . import ssm
from .common import ArchConfig, init_linear, rms_norm, swiglu

BLOCKS = "blocks."


def _leaf_key(name: str) -> tuple:
    return tuple(name.split("."))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters on the generator's device, JAX names and layout."""
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"only the dense and ssm families are ported, got "
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
    }
    if cfg.family == "ssm":
        for k, v in ssm.rwkv6_params(cfg, generator, L).items():
            params[f"blocks.tmix.{k}"] = v
        params.update({
            "blocks.cmix.mu": torch.full((L, 2, d), 0.5, dtype=dt,
                                         device=dev),
            "blocks.cmix.w_k": init_linear((L, d, ff), dt, generator),
            "blocks.cmix.w_v": init_linear((L, ff, d), dt, generator),
            "blocks.cmix.w_r": init_linear((L, d, d), dt, generator),
        })
        return ordered(params)
    params.update({
        "blocks.mlp.w_gate": init_linear((L, d, ff), dt, generator),
        "blocks.mlp.w_up": init_linear((L, d, ff), dt, generator),
        "blocks.mlp.w_down": init_linear((L, ff, d), dt, generator),
    })
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


def _cmix(x: torch.Tensor, xn: torch.Tensor, xp: torch.Tensor,
          cm: dict) -> torch.Tensor:
    """The RWKV6 channel mix on the residual x: xn normed, xp its token
    shift."""
    k_in = xn * cm["mu"][0] + xp * (1 - cm["mu"][0])
    r_in = xn * cm["mu"][1] + xp * (1 - cm["mu"][1])
    v = torch.square(torch.relu(k_in @ cm["w_k"])) @ cm["w_v"]
    return x + torch.sigmoid(r_in @ cm["w_r"]) * v


def _rwkv_block(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                p: dict) -> torch.Tensor:
    x = x + ssm.rwkv6_forward(p["tmix"], rms_norm(x, p["ln1"]), cfg)
    xn = rms_norm(x, p["ln2"])
    return _cmix(x, xn, F.pad(xn, (0, 0, 1, 0))[:, :-1], p["cmix"])


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
    block = _rwkv_block if cfg.family == "ssm" else _dense_block
    for lp in _layers(params, cfg):
        if torch.is_grad_enabled():
            x = checkpoint(block, x, positions, cfg, lp, use_reentrant=False)
        else:
            x = block(x, positions, cfg, lp)
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
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"serving the {cfg.family!r} family is not "
                                  f"ported (dense only, and ssm)")
    if cfg.sliding_window > 0:
        raise NotImplementedError("sliding-window ring caches are not "
                                  "ported; serve with linear caches")


class DecodeState:
    """Decode state: the layer-stacked caches (a :class:`KVCache`, or the
    ssm state dict) and the position(s) the next token is written at (a
    0-d tensor, or (B,) per slot)."""

    def __init__(self, caches, pos: torch.Tensor):
        self.caches, self.pos = caches, pos


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


@torch.no_grad()
def prefill(params: dict, cfg: ArchConfig, batch: dict,
            extra_capacity: int = 0, last_pos=None) -> tuple:
    """Process a full prompt; returns (last-token logits (B, V) in the
    parameters' dtype, DecodeState ready for :func:`decode_step`).

    Dense: the caches hold the prompt's S positions and ``extra_capacity``
    empty slots.  ``last_pos`` (int or (B,)) is each request's final real
    prompt token, for prompts right-padded to a shared length: logits are
    taken there and decode resumes at ``last_pos + 1`` (causal attention
    keeps the real prefix independent of the padding, and the padded cache
    rows stay masked until decode overwrites them).  Ssm: the states after
    the prompt's last token, their heads padded to ``cfg.head_pad_to``
    (``extra_capacity`` does not apply; a recurrent state absorbs padding,
    so serve prompts at their exact length).
    """
    _check_servable(cfg)
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"])
    if cfg.family == "ssm":
        x, caches = _prefill_ssm(params, cfg, x)
        hidden, pos = _last_hidden(params, x, last_pos)
        return (hidden @ params["unembed"])[:, 0], DecodeState(caches, pos)
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
    hidden, pos = _last_hidden(params, x, last_pos)
    return (hidden @ params["unembed"])[:, 0], DecodeState(caches, pos)


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      per_slot_pos: bool = False,
                      device="cuda") -> DecodeState:
    """Zero caches for ``cache_len`` tokens per row (ssm: zero states, of
    a size independent of ``cache_len``); ``per_slot_pos`` gives a
    (batch,) position vector (the slot array, rows decode at their own
    depths) instead of a shared scalar."""
    _check_servable(cfg)
    device = resolve_device(device)
    if cfg.family == "ssm":
        caches = _ssm_caches(cfg, batch, device)
    else:
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
    slot array, in place: row ``slot`` of every cache tensor (batch on axis
    1) is overwritten whole, so ``one``'s caches must match it (dense:
    prefill with ``extra_capacity = cap - prompt_len``); ``state.pos``
    must be the per-slot (B,) form."""
    for big, small in zip(_cache_tensors(state.caches),
                          _cache_tensors(one.caches)):
        big[:, slot] = small[:, 0]
    state.pos[slot] = one.pos.reshape(-1)[0]
    return state


@torch.no_grad()
def evict_decode_state(state: DecodeState, slot: int) -> DecodeState:
    """Zero row ``slot``'s caches and position in place (a retired slot
    keeps no residue of its last request)."""
    for big in _cache_tensors(state.caches):
        big[:, slot] = 0
    state.pos[slot] = 0
    return state


@torch.no_grad()
def decode_step(params: dict, cfg: ArchConfig, state: DecodeState,
                token: torch.Tensor) -> tuple:
    """One-token decode.  token: (B,) -> (logits (B, V), DecodeState at
    ``pos + 1`` over the same, updated, caches)."""
    _check_servable(cfg)
    x = F.embedding(token.long(), params["embed"])[:, None, :]
    decode = _decode_ssm if cfg.family == "ssm" else _decode_dense
    x = decode(params, cfg, state.caches, state.pos, x)
    hidden = rms_norm(x, params["final_norm"])
    logits = (hidden @ params["unembed"])[:, 0]
    return logits, DecodeState(state.caches, state.pos + 1)


def _decode_dense(params: dict, cfg: ArchConfig, caches: attn.KVCache,
                  pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through the dense stack; the KV rows are written in place."""
    for layer, lp in enumerate(_layers(params, cfg)):
        cache = attn.KVCache(caches.k[layer], caches.v[layer])
        h, _ = attn.decode_attend(lp["attn"], rms_norm(x, lp["ln1"]), pos,
                                  cache, cfg, window=cfg.sliding_window)
        x = x + h
        x = x + _mlp(x, lp)
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


class DenseLM(nn.Module):
    """The LM (dense or ssm family) as an ``nn.Module``; parameters keep
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
