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
    mp = p["mlp"]
    return x + swiglu(rms_norm(x, p["ln2"]), mp["w_gate"], mp["w_up"],
                      mp["w_down"])


def forward(params: dict, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: (B, S) tokens -> final-normed hidden (B, S, d)."""
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    per_layer = {k[len(BLOCKS):]: v.unbind(0) for k, v in params.items()
                 if k.startswith(BLOCKS)}
    for layer in range(cfg.num_layers):
        lp = _nest({k: v[layer] for k, v in per_layer.items()})
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
