"""Meshes over a ``torch.distributed`` process group (counterpart of
``repro.launch.mesh``).

A JAX mesh names its axes ``("data", "model")`` or ``("pod", "data",
"model")``: ``"data"`` and ``"pod"`` enumerate the AMB workers, ``"model"``
is tensor parallelism inside a worker.  Here a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group that is already initialised (one process per device, or
several processes on one card under gloo), built by ``init_device_mesh``
with JAX's axis names; rank r sits at the row-major coordinate of r.  The
dry-run's meshes are :class:`AbstractMesh` (names and extents, no ranks).

The functions here read both kinds, and JAX's own duck-typed meshes
(``axis_names`` and a ``shape`` dict), by name: :func:`axis_names`,
:func:`mesh_shape`.  Nothing here initialises a process group; a mesh
whose extents do not multiply to the world size is refused, never
shrunk.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and extents, with no ranks behind it (the
    dry-run's 256- and 512-chip meshes)."""

    axis_names: tuple
    shape: dict               # axis name -> extent, as JAX's mesh.shape

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def axis_names(mesh) -> tuple:
    """The mesh's axis names, major to minor."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """Axis name -> extent (JAX's ``mesh.shape``)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def abstract(shape: tuple, names: tuple) -> AbstractMesh:
    return AbstractMesh(tuple(names), dict(zip(names, (int(s)
                                                       for s in shape))))


def production_extents(multi_pod: bool = False) -> tuple:
    """JAX's production layout: (16, 16) over ("data", "model"), one v5e
    pod of 256 chips, or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _device_mesh(shape: tuple, names: tuple, device: str):
    """``init_device_mesh`` over the initialised group, which must hold
    exactly prod(shape) ranks."""
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or have != need:
        raise RuntimeError(
            f"need {need} devices, have {have} (start {need} ranks, e.g. "
            f"python -m torch.distributed.run --nproc-per-node {need}, and "
            f"initialise the process group first)")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if str(device).startswith("cuda") else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 (256 ranks) or 2x16x16 (512 ranks) over the initialised group.

    Axes: "data" = AMB workers (data parallel / FSDP), "model" =
    tensor/expert parallel inside a worker, "pod" = the cross-pod worker
    axis (consensus spans ("pod", "data") jointly).
    """
    shape, names = production_extents(multi_pod)
    return _device_mesh(shape, names, device)


def make_host_mesh(data: int = 2, model: int = 2, *, pod: int = 1,
                   device: str = "cuda"):
    """The (data, model) or (pod, data, model) mesh of the process group
    that is already initialised; its world size must be the product of
    the extents."""
    if pod > 1:
        return _device_mesh((pod, data, model), ("pod", "data", "model"),
                            device)
    return _device_mesh((data, model), ("data", "model"), device)
