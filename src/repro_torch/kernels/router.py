"""Which body of a kernel runs: decided from the tensor's device.

Counterpart of ``repro.kernels.router``.  Every public wrapper in
:mod:`repro_torch.kernels.ops` has two bodies, the hand-written CUDA kernel
and its plain PyTorch version (:mod:`repro_torch.kernels.ref`):

  * a tensor on a CUDA device runs the kernel, and a kernel that fails to
    build or launch raises; it never falls back to the plain version;
  * a tensor on the CPU runs the plain version (there is no kernel there).

``force="kernel"`` or ``force="ref"`` overrides the choice for one call:
the tests and ``chip_smoke.py`` use it to hold a kernel against its plain
version on the same CUDA tensors.

Each kernel wrapper calls :func:`count` once per launch, so a run can show
that its main path went through the kernels (:func:`launches`,
:func:`reset_launches`).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

FORCES = ("kernel", "ref")

_launches: collections.Counter = collections.Counter()


def resolve(x: torch.Tensor, force: Optional[str] = None) -> str:
    """``"kernel"`` for a CUDA tensor, ``"ref"`` for a CPU tensor."""
    if force is not None:
        if force not in FORCES:
            raise ValueError(f"unknown kernel force {force!r}; "
                             f"choose from {FORCES}")
        if force == "kernel" and x.device.type != "cuda":
            raise ValueError("the CUDA kernels take CUDA tensors only")
        return force
    if x.device.type == "cuda":
        return "kernel"
    if x.device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernel body for device {x.device}")


def count(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _launches[name] += 1


def launches() -> dict:
    """Launches per kernel name since the last :func:`reset_launches`."""
    return dict(_launches)


def reset_launches() -> None:
    _launches.clear()
