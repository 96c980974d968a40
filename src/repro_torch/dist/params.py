"""Rule-based parameter layout: name x shape -> one mesh axis (or None)
per dimension (counterpart of ``repro.dist.params``).

The layout is FSDP x TP: every weight matrix puts its d_model side on the
``"data"`` axis (fully sharded parameters, all-gathered per layer) and its
wide side (heads, ffn, experts, vocab) on ``"model"`` (tensor parallel).
Rules are keyed by the leaf's path, so the same function lays out the
parameters, optimizer-state trees that mirror them (``z.blocks.attn.wq``)
and the dry-run's meta tensors alike:

  embed    (V, d)        -> ("model", "data")
  unembed  (d, V)        -> ("data", "model")
  in-proj  (d, h*hd|ff)  -> ("data", "model")     wq/wk/wv/w_gate/w_up/...
  out-proj (h*hd|ff, d)  -> ("model", "data")     wo/w_down/w_out
  moe      (E, d, ff)    -> ("model", "data", None) expert dim on "model"
  norms / biases / scalars -> ()  (replicated)

A leading stacked-layer dim (anything under ``blocks``) is never sharded,
and an axis the mesh lacks, or whose extent does not divide the dim (or
exceeds it), is dropped (the whisper 51,865-vocabulary rule).  The port's
dotted names split where JAX's ``/`` paths do.  :func:`placements` turns a
spec into DTensor ``Shard`` / ``Replicate`` placements; the live sessions
keep each worker's parameters whole on its process (ROADMAP.md, module
item 4a), and the dry-run reads these specs for its per-rank bytes and
collectives.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..launch.mesh import axis_names, mesh_shape

# Leaves whose *first* of the two trailing dims is the wide (TP) side.
_OUT_PROJ = frozenset({"wo", "w_down", "w_out", "decay_b"})
# MoE in-projections: (E, d, ff), d_model is the middle dim.
_MOE_IN = frozenset({"w_gate", "w_up"})


def _keep(axis: Optional[str], dim: int, mesh) -> Optional[str]:
    """Drop an axis the mesh lacks or whose extent does not divide ``dim``."""
    if axis is None or axis not in axis_names(mesh):
        return None
    extent = mesh_shape(mesh)[axis]
    if extent <= 1 or dim < extent or dim % extent != 0:
        return None
    return axis


def param_spec(name: str, shape, mesh,
               fsdp_axis: Optional[str] = "data") -> tuple:
    """One mesh axis name or None per dimension of the parameter at path
    ``name`` (``blocks.attn.wq`` or ``blocks/attn/wq``) with ``shape``;
    ``()`` for a replicated leaf.

    ``fsdp_axis=None`` (serving) replicates the d_model side instead of
    fully sharding it; the TP side stays on "model" either way.
    """
    parts = re.split(r"[./]", name)
    leaf = parts[-1]
    shape = tuple(int(s) for s in shape)
    nlead = 1 if "blocks" in parts[:-1] else 0   # stacked layers
    core = shape[nlead:]
    if len(core) <= 1:
        return ()                                # norms, biases, scalars

    data, model = fsdp_axis, "model"
    spec: list = [None] * len(core)
    if "moe" in parts and len(core) >= 3:
        spec[0] = model                          # expert dim
        spec[1 if leaf in _MOE_IN else len(core) - 1] = data
    elif leaf == "embed":
        spec[-2:] = [model, data]                # (vocab, d)
    elif leaf == "unembed":
        spec[-2:] = [data, model]                # (d, vocab)
    elif leaf in _OUT_PROJ:
        spec[-2:] = [model, data]
    else:
        spec[-2:] = [data, model]                # in-projections (default)

    full = [None] * nlead + spec
    return tuple(_keep(a, d, mesh) for a, d in zip(full, shape))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: for each mesh axis,
    ``Shard(d)`` where dim d names it (alone or in a tuple of axes, major
    first), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in axis_names(mesh):
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_extent(spec: tuple, mesh) -> int:
    """How many ways a leaf with ``spec`` is split over the mesh."""
    shape = mesh_shape(mesh)
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= shape[axis]
    return n


def _leaves(tree, prefix: str = ""):
    """(dotted name, tensor) for every tensor of nested dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


def tree_specs(tree, mesh, fsdp_axis: Optional[str] = "data") -> dict:
    """:func:`param_spec` of every tensor leaf of a (nested) dict, keyed by
    its dotted name.  Parameter trees and optimizer-state trees that
    mirror them (``{"z": {...}, "t": 0}``) alike: the rules key on the
    trailing path components; non-tensor leaves are left out."""
    return {name: param_spec(name, leaf.shape, mesh, fsdp_axis)
            for name, leaf in _leaves(tree)}


def tree_shardings(tree, mesh, fsdp_axis: Optional[str] = "data") -> dict:
    """DTensor placements for every tensor leaf, keyed as
    :func:`tree_specs`."""
    return {name: placements(spec, mesh)
            for name, spec in tree_specs(tree, mesh, fsdp_axis).items()}
