"""Mesh-scoped sharding context and the logical-axis constraint helper
(counterpart of ``repro.dist.sharding``).

Code that shards an activation names *logical* axes (``"batch"``,
``"seq"``, ``"vocab"``, ``"expert"``) through :func:`constrain`.  Under
:func:`use_sharding` those resolve to the active mesh's axes ("batch"
spans the worker axes ``("pod", "data")``, vocab and experts go on
``"model"``); outside a mesh, on a plain tensor, or on a dimension the
mesh extent does not divide (the whisper-vocabulary rule), the
annotation is a no-op.  As in JAX, the models never call
:func:`constrain`: a worker's activations stay whole on its process.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from ..launch.mesh import axis_names, mesh_shape

_STATE = threading.local()

# logical activation axis -> candidate mesh axes (filtered by presence).
LOGICAL_AXES = {
    "batch": ("pod", "data"),     # AMB worker axes (data parallel)
    "seq": (),                    # no sequence parallelism
    "vocab": ("model",),
    "expert": ("model",),
    "model": ("model",),
    "heads": ("model",),
}


def active_mesh():
    """The mesh installed by the innermost :func:`use_sharding`, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_sharding(mesh):
    """Install ``mesh`` as the ambient mesh for :func:`constrain` calls
    (per thread, restored on exit)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def _resolve(mesh, logical: Optional[str], dim: int):
    """Mesh axes for one logical axis on a dim of extent ``dim``: None,
    one axis name, or a tuple of them (JAX's PartitionSpec entry)."""
    if logical is None:
        return None
    names, shape = axis_names(mesh), mesh_shape(mesh)
    axes = tuple(a for a in LOGICAL_AXES[logical] if a in names)
    if not axes:
        return None
    extent = math.prod(shape[a] for a in axes)
    if extent <= 1 or dim % extent != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def constrain(x: torch.Tensor, *logical_axes: Optional[str]):
    """``x`` redistributed to the resolved placements when it is a
    ``DTensor`` under the active mesh; ``x`` itself otherwise.

    One logical name (or None) per dimension of ``x``.  Axes whose mesh
    extent does not divide the dimension are dropped (replicated) rather
    than erroring, as :func:`repro_torch.dist.params.param_spec` drops
    them.
    """
    from torch.distributed.tensor import DTensor

    from .params import placements
    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x                      # unmeshed or a plain tensor
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain: {len(logical_axes)} logical axes for rank-{x.ndim}")
    spec = tuple(_resolve(mesh, name, d)
                 for name, d in zip(logical_axes, x.shape))
    return x.redistribute(mesh, placements(spec, mesh))
