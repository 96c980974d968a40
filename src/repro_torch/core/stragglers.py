"""Straggler compute-time models and the AMB minibatch rule (paper §5).

Counterpart of ``repro.core.stragglers``.  A model returns an ``(n,
b_max)`` tensor of the time each worker needs for its s-th gradient of the
epoch; :func:`amb_batch_sizes` turns that into b_i(t) under a deadline T.
Random draws come from the ``torch.Generator`` the caller passes.
"""
from __future__ import annotations

import dataclasses

import torch


class StragglerModel:
    """Base: subclasses sample per-gradient times."""

    b_ref: int = 1

    def per_gradient_times(self, generator: torch.Generator, n: int,
                           b_max: int) -> torch.Tensor:
        raise NotImplementedError

    def mean_batch_time(self) -> float:
        raise NotImplementedError

    def std_batch_time(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Deterministic(StragglerModel):
    """Homogeneous cluster: every gradient takes the same time."""

    grad_time: float = 1.0
    b_ref: int = 1

    def per_gradient_times(self, generator, n, b_max):
        return torch.full((n, b_max), self.grad_time, dtype=torch.float32)

    def mean_batch_time(self):
        return self.grad_time * self.b_ref

    def std_batch_time(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class ShiftedExponential(StragglerModel):
    """T_i(t) = zeta + Exp(lam) per batch of b_ref gradients; linear progress.

    Paper App. I.2 uses lam = 2/3, zeta = 1, b_ref = 600.
    """

    lam: float = 2.0 / 3.0
    zeta: float = 1.0
    b_ref: int = 600

    def per_gradient_times(self, generator, n, b_max):
        draws = torch.empty(n, dtype=torch.float32,
                            device=generator.device).exponential_(
                                1.0, generator=generator)
        per_grad = (self.zeta + draws / self.lam) / self.b_ref
        return per_grad[:, None].expand(n, b_max).contiguous()

    def mean_batch_time(self):
        return self.zeta + 1.0 / self.lam

    def std_batch_time(self):
        return 1.0 / self.lam


def amb_batch_sizes(per_grad_times: torch.Tensor,
                    budget_t: float) -> torch.Tensor:
    """b_i(t): gradients finished before the fixed compute deadline T."""
    cum = torch.cumsum(per_grad_times, dim=1)
    return (cum <= budget_t).sum(dim=1).to(torch.int32)
