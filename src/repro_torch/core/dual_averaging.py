"""Dual averaging (Nesterov 2009; Xiao 2010): the paper's optimization core.

Counterpart of ``repro.core.dual_averaging``.  The primal update (eq. 7)

    w(t+1) = argmin_{w in W} { <w, z(t+1)> + beta(t+1) ||w||^2 }

is closed-form over W = R^d or an L2 ball of radius R:

    w = -z / (2 beta)                  (unconstrained)
    w = Pi_{||w||<=R} (-z / (2 beta))  (ball)

The unconstrained prox is :func:`repro_torch.kernels.ops.dual_update` with
a zero anchor, so on the card it runs the CUDA prox kernel.
``beta(t) = K + sqrt(t / mu)`` per Lemma 8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class BetaSchedule:
    """beta(t) = k + sqrt(t / mu) * scale; non-decreasing in t (t >= 1).

    Evaluated in float32, as the JAX package evaluates it on a float32
    ``t``, so both give the same bits for the prox.
    """

    k: float = 1.0
    mu: float = 1.0
    scale: float = 1.0

    def __call__(self, t) -> float:
        f = np.float32
        return float(f(self.k) + f(self.scale) * np.sqrt(f(t) / f(self.mu)))


def prox_step(z: torch.Tensor, beta: float,
              radius: Optional[float] = None) -> torch.Tensor:
    """argmin_w <w,z> + beta ||w||^2 in fp32 (optionally over the ball
    ||w|| <= radius, the norm taken over the whole tensor)."""
    z = z.float().contiguous()
    w = kops.dual_update(z, torch.zeros_like(z), beta)
    if radius is not None:
        nrm = torch.linalg.vector_norm(w.reshape(-1))
        w = w * torch.clamp(radius / torch.clamp(nrm, min=1e-30), max=1.0)
    return w


def prox_step_tree(z: dict, beta: float,
                   radius: Optional[float] = None) -> dict:
    """Dict version; the ball constraint is applied per leaf."""
    return {k: prox_step(zl, beta, radius) for k, zl in z.items()}


@dataclasses.dataclass(frozen=True)
class DualAveraging:
    """Single-machine dual averaging (per node, and the FMB/AMB update)."""

    beta: BetaSchedule = BetaSchedule()
    radius: Optional[float] = None

    def init_primal(self, like: torch.Tensor) -> torch.Tensor:
        # w(1) = argmin h(w) = 0 (paper eq. 2)
        return torch.zeros_like(like)

    def init_dual(self, like: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(like)

    def update(self, z: torch.Tensor, g: torch.Tensor, t: int) -> tuple:
        """z(t+1) = z(t) + g(t); w(t+1) = prox(z(t+1), beta(t+1))."""
        z_new = z + g
        return z_new, prox_step(z_new, self.beta(t + 1), self.radius)
