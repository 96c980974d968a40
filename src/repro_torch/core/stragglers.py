"""Straggler compute-time models and the budgets built on them (paper §5,
App. H, App. I.2-I.4).

Counterpart of ``repro.core.stragglers``.  A model returns an ``(n,
b_max)`` tensor of the time each worker needs for its s-th gradient of the
epoch, on the device of the ``torch.Generator`` the caller passes:

  * :class:`ShiftedExponential` — T ~ zeta + Exp(lam) per reference batch
    of ``b_ref`` gradients, linear progress within it (App. I.2);
  * :class:`InducedGroups` — EC2 background-job stragglers: groups of
    nodes with their own zeta and lam (App. I.3);
  * :class:`PauseModel` — the HPC experiment: after every gradient a node
    pauses max(0, N(mu_g, g^2)) ms (App. I.4).

From these, :func:`amb_batch_sizes` gives b_i(t) under a deadline T and
:func:`fmb_finish_times` FMB's per-node finishing times.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


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

    def expected_max_batch_time(self, n: int) -> float:
        """E[max_i T_i] = zeta + H_n / lam (App. H eq. 81, exact form)."""
        h_n = float(np.sum(1.0 / np.arange(1, n + 1)))
        return self.zeta + h_n / self.lam


def _group_of_nodes(group_sizes, n: int) -> np.ndarray:
    groups = np.repeat(np.arange(len(group_sizes)), group_sizes)
    if len(groups) != n:
        raise ValueError(f"group sizes sum to {len(groups)}, need n={n}")
    return groups


@dataclasses.dataclass(frozen=True)
class InducedGroups(StragglerModel):
    """EC2 background-job stragglers (App. I.3).

    ``group_sizes`` nodes per group; group g's per-batch time is
    ``zeta_g + Exp(lam_g)``: the paper's three clusters (~10 s fast, ~20 s
    intermediate, ~30 s bad for b_ref = 585) are zetas (9, 18, 27), lams 1.
    """

    group_sizes: Sequence[int] = (5, 2, 3)
    zetas: Sequence[float] = (9.0, 18.0, 27.0)
    lams: Sequence[float] = (1.0, 1.0, 1.0)
    b_ref: int = 585

    def per_gradient_times(self, generator, n, b_max):
        groups = _group_of_nodes(self.group_sizes, n)
        dev = generator.device
        zeta = torch.tensor(np.asarray(self.zetas, np.float32)[groups],
                            device=dev)
        lam = torch.tensor(np.asarray(self.lams, np.float32)[groups],
                           device=dev)
        draws = torch.empty(n, dtype=torch.float32, device=dev).exponential_(
            1.0, generator=generator)
        t_batch = zeta + draws / lam
        return (t_batch / self.b_ref)[:, None].expand(n, b_max).contiguous()

    def _means(self) -> tuple:
        groups = _group_of_nodes(self.group_sizes, sum(self.group_sizes))
        lams = np.asarray(self.lams)[groups]
        return np.asarray(self.zetas)[groups] + 1.0 / lams, lams

    def mean_batch_time(self):
        return float(self._means()[0].mean())

    def std_batch_time(self):
        means, lams = self._means()
        second = means ** 2 + 1.0 / lams ** 2
        return float(np.sqrt(second.mean() - means.mean() ** 2))


@dataclasses.dataclass(frozen=True)
class PauseModel(StragglerModel):
    """HPC pause model (App. I.4): per-gradient time = base +
    max(0, N(mu_g, sigma_g^2)) ms, sigma_g = g (g in 1..groups).

    Paper: 5 groups, mus = (5, 10, 20, 35, 55) ms.
    """

    group_sizes: Sequence[int] = (10, 10, 10, 10, 10)
    mus_ms: Sequence[float] = (5.0, 10.0, 20.0, 35.0, 55.0)
    base_ms: float = 1.5
    b_ref: int = 10

    def per_gradient_times(self, generator, n, b_max):
        groups = _group_of_nodes(self.group_sizes, n)
        dev = generator.device
        mu = torch.tensor(np.asarray(self.mus_ms, np.float32)[groups],
                          device=dev)[:, None]
        sg = torch.tensor(groups.astype(np.float32) + 1.0,
                          device=dev)[:, None]
        noise = torch.randn((n, b_max), generator=generator,
                            dtype=torch.float32, device=dev)
        pauses = torch.clamp(mu + sg * noise, min=0.0)
        return (self.base_ms + pauses) / 1000.0            # seconds

    def mean_batch_time(self):
        groups = _group_of_nodes(self.group_sizes, sum(self.group_sizes))
        mu = np.asarray(self.mus_ms)[groups].mean()
        return float((self.base_ms + mu) * self.b_ref / 1000.0)

    def std_batch_time(self):
        groups = _group_of_nodes(self.group_sizes, sum(self.group_sizes))
        per_node = (self.base_ms + np.asarray(self.mus_ms)[groups]) \
            * self.b_ref / 1000.0
        return float(per_node.std())


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------


def amb_batch_sizes(per_grad_times: torch.Tensor,
                    budget_t: float) -> torch.Tensor:
    """b_i(t): gradients finished before the fixed compute deadline T."""
    cum = torch.cumsum(per_grad_times, dim=1)
    return (cum <= budget_t).sum(dim=1).to(torch.int32)


def fmb_finish_times(per_grad_times: torch.Tensor,
                     b_per_node: int) -> torch.Tensor:
    """Per-node time to finish exactly b/n gradients."""
    if b_per_node < 1:
        raise ValueError("b_per_node >= 1")
    if b_per_node > per_grad_times.shape[1]:
        raise ValueError("b_max too small for requested FMB batch")
    return torch.cumsum(per_grad_times, dim=1)[:, b_per_node - 1]


def amb_budget_from_fmb(model: StragglerModel, n: int,
                        b_global: int) -> float:
    """Lemma 6: T = (1 + n/b) mu makes E[b_AMB] >= b_FMB, with mu the mean
    time of b/n gradients (the models time batches of b_ref)."""
    mu = model.mean_batch_time() * (b_global / n) / getattr(model, "b_ref", 1)
    return (1.0 + n / b_global) * mu


def amb_budget_calibrated(model: StragglerModel, n: int, b_global: int,
                          generator: Optional[torch.Generator] = None,
                          epochs: int = 64, b_max: Optional[int] = None,
                          device="cuda") -> float:
    """Empirical T such that E[b(T)] ~= b_global (the paper's own method).

    Lemma 6 assumes identically distributed T_i; for heterogeneous
    clusters (InducedGroups, PauseModel) it overshoots, so the paper
    calibrates T instead (App. I.4).  This bisects T 60 times against
    ``epochs`` epochs of drawn times, on the generator's device: the
    counts are compared there and only the final T comes to the host.
    ``generator`` defaults to one seeded 0 on ``device``.
    """
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    if b_max is None:
        b_max = max(4 * b_global // n, 16)
    times = torch.stack([model.per_gradient_times(generator, n, b_max)
                         for _ in range(epochs)])       # (epochs, n, b_max)
    cum = torch.cumsum(times, dim=2)
    # bisect in float64 and compare in float32, as the JAX version compares
    # float32 sums with a Python float
    lo = torch.zeros((), dtype=torch.float64, device=times.device)
    hi = times.sum(dim=2).max().double()
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        mean_b = (cum <= mid.float()).sum(dim=(1, 2)).float().mean()
        below = mean_b < b_global
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return float(hi)


def bertsimas_max_bound(mu: float, sigma: float, n: int) -> float:
    """E[max_i T_i] <= mu + sigma sqrt(n-1) (Arnold-Groeneveld /
    Bertsimas)."""
    return mu + sigma * float(np.sqrt(max(n - 1, 0)))
