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
spec into DTensor ``Shard`` / ``Replicate`` placements, and the dry-run
reads these specs for its per-rank bytes and collectives.

A live session with a model axis holds plain tensors, each rank its own
block of every leaf (:func:`shard_tree`, or :func:`init_shards`, which
draws one whole leaf at a time in ``init_params``' order and keeps its
block, so the blocks equal slices of the one-process initialisation bit
for bit); :func:`gather_tree` puts the blocks of every mesh coordinate
back together.
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


def block_slices(spec: tuple, shape, mesh, coord) -> tuple:
    """The ``(start, size)`` of each dimension of the block that the rank
    at mesh coordinate ``coord`` (one index per axis, in the mesh's axis
    order) holds of a leaf of ``shape`` laid out by ``spec``."""
    names, extents = axis_names(mesh), mesh_shape(mesh)
    out = []
    for dim, axis in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append((0, int(dim)))
            continue
        size = int(dim) // extents[axis]
        out.append((coord[names.index(axis)] * size, size))
    return tuple(out)


def shard_leaf(leaf: torch.Tensor, spec: tuple, mesh,
               coord) -> torch.Tensor:
    """This coordinate's block of one leaf: a copy of its own (the whole
    leaf may then be freed)."""
    block = leaf.detach()
    for d, (start, size) in enumerate(block_slices(spec, leaf.shape, mesh,
                                                   coord)):
        if size != leaf.shape[d]:
            block = block.narrow(d, start, size)
    return block.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: dict, mesh, coord,
               fsdp_axis: Optional[str] = "data") -> dict:
    """The blocks of every leaf of a flat parameter (or dual) dict that
    the rank at ``coord`` holds under :func:`param_spec`."""
    return {name: shard_leaf(leaf, param_spec(name, leaf.shape, mesh,
                                              fsdp_axis), mesh, coord)
            for name, leaf in tree.items()}


def gather_tree(shards: dict, mesh, shapes: dict,
                fsdp_axis: Optional[str] = "data") -> dict:
    """The whole tree from ``{coordinate: block dict}`` over every mesh
    coordinate; ``shapes`` gives each leaf's whole shape (the layout's
    divisibility rule reads it).  Each block lands in its place, so the
    blocks of an axis a leaf is replicated over must be equal."""
    out = {}
    for name, shape in shapes.items():
        spec = param_spec(name, shape, mesh, fsdp_axis)
        leaf = None
        for coord, tree in shards.items():
            block = tree[name]
            if leaf is None:
                leaf = block.new_empty(tuple(int(s) for s in shape))
            index = tuple(slice(a, a + n) for a, n in
                          block_slices(spec, shape, mesh, coord))
            leaf[index] = block
        out[name] = leaf
    return out


def init_shards(cfg, generator: torch.Generator, mesh, coord,
                fsdp_axis: Optional[str] = "data") -> dict:
    """This coordinate's blocks of ``init_params(cfg, generator)``: each
    leaf is drawn whole, in ``init_params``' order (so the generator
    stream is the same), and only its block is kept, so at most one whole
    leaf is live; an expert leaf (``models.moe.Layered``) is drawn a
    layer at a time, and only the layer's block is kept, so its stack is
    never whole.  Every family (``models.param_plan``)."""
    from ..models.model import ordered, param_plan
    from ..models.moe import Layered
    out = {}
    for name, make in param_plan(cfg):
        if isinstance(make, Layered):
            shape = (make.layers,) + make.shape
            spec = param_spec(name, shape, mesh, fsdp_axis)
            sl = block_slices(spec, shape, mesh, coord)
            block = torch.empty(tuple(n for _, n in sl), dtype=make.dtype,
                                device=generator.device)
            for layer in range(make.layers):
                one = make.layer(generator)
                block[layer] = one[tuple(slice(a, a + n)
                                         for a, n in sl[1:])]
                del one
            out[name] = block
            continue
        leaf = make(generator)
        out[name] = shard_leaf(leaf, param_spec(name, leaf.shape, mesh,
                                                fsdp_axis), mesh, coord)
        del leaf
    return ordered(out)
