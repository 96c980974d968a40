"""Abstract inputs for every (arch x input-shape) pair: tensors on the
``meta`` device with their per-dimension mesh axes (counterpart of
``repro.launch.specs``; JAX's ShapeDtypeStructs with a NamedSharding).

Nothing is allocated: the dry-run (:mod:`repro_torch.launch.dryrun`)
counts a step on these.  Audio and VLM front ends are stubbed as in JAX:
the inputs carry frame and patch *embeddings* of the right shape.  A spec
is a tuple with one entry per dimension: None, a mesh axis name, or a
tuple of them (the batch over ``("pod", "data")``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..configs import InputShape
from ..models import init_decode_state, init_params
from ..models.common import ArchConfig, MetaGenerator
from ..models.model import _cache_tensors
from .mesh import axis_names, mesh_shape


class ShapeSpec(NamedTuple):
    """A meta tensor and its per-dimension mesh axes."""

    value: torch.Tensor
    spec: tuple


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _nworkers(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in batch_axes(mesh))


def _bspec(mesh, batch: int, ndim: int) -> tuple:
    lead = batch_axes(mesh) if batch % _nworkers(mesh) == 0 else None
    return (lead,) + (None,) * (ndim - 1)


def _meta(mesh, shape, dtype, batch_dim0: bool = True) -> ShapeSpec:
    spec = _bspec(mesh, shape[0], len(shape)) if batch_dim0 else ()
    return ShapeSpec(torch.empty(shape, dtype=dtype, device="meta"), spec)


def train_input_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {"labels": _meta(mesh, (b, s), torch.int32)}
    if cfg.input_mode == "embeds":
        batch["embeds"] = _meta(mesh, (b, s, cfg.d_model), cfg.torch_dtype)
    else:
        batch["tokens"] = _meta(mesh, (b, s), torch.int32)
    if cfg.family == "audio":
        enc = cfg.encoder_seq or 1500
        batch["enc_embeds"] = _meta(mesh, (b, enc, cfg.d_model),
                                    cfg.torch_dtype)
    return batch


def prefill_input_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    batch = train_input_specs(cfg, shape, mesh)
    batch.pop("labels")
    return batch


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree on ``meta`` (shapes and dtypes, no draw)."""
    return init_params(cfg, MetaGenerator())


def abstract_decode_state(cfg: ArchConfig, shape: InputShape):
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             device="meta")


def state_leaves(state) -> list:
    """Every tensor of a decode state: the caches, the position, and
    audio's ``enc_kv``."""
    return _cache_tensors((state.caches, state.pos, state.enc_kv))


def decode_state_specs(state_sds, mesh, global_batch: int) -> list:
    """(leaf, spec) for every tensor of the decode state, in
    :func:`state_leaves` order: batch on the worker axes, one large inner
    dim (cache seq / heads / state) on "model" when divisible."""
    baxes = batch_axes(mesh)
    n = _nworkers(mesh)
    msize = mesh_shape(mesh)["model"]

    def leaf_spec(shp) -> tuple:
        if len(shp) <= 1:
            return ()
        axes: list = [None] * len(shp)
        # dim0 is the stacked-layer dim; dim1 is batch.
        if shp[1] == global_batch and global_batch % n == 0:
            axes[1] = baxes
        for i in range(2, len(shp)):
            if shp[i] % msize == 0 and shp[i] >= msize:
                axes[i] = "model"
                break
        return tuple(axes)

    return [(leaf, leaf_spec(tuple(leaf.shape)))
            for leaf in state_leaves(state_sds)]


def decode_token_spec(shape: InputShape, mesh) -> ShapeSpec:
    return _meta(mesh, (shape.global_batch,), torch.int32)


def worker_batch_spec(mesh) -> ShapeSpec:
    """b_i(t): per-worker AMB minibatch sizes for this epoch."""
    return ShapeSpec(torch.empty((_nworkers(mesh),), dtype=torch.int32,
                                 device="meta"), (batch_axes(mesh),))
