"""The epoch clock behind the fixed-compute-time contract (counterpart of
``repro.api.clock``).

``epoch(generator)`` returns the (n, b_max) per-gradient times and the
deadline T of one epoch; the session turns them into b_i(t).

  * :class:`SimulatedClock` — times from the straggler model; T explicit
    or the Lemma-6 ``(1 + n/b) mu``.
  * :class:`MeasuredClock` — the model gives only the relative spread
    across workers; the seconds per gradient are an EMA of the measured
    step time (the session synchronises the card before reading it).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.stragglers import StragglerModel
from .specs import CLOCK_KINDS, ClockSpec


class Clock:
    def epoch(self, generator: torch.Generator
              ) -> Tuple[torch.Tensor, float]:
        raise NotImplementedError

    def update(self, step_seconds: float, global_b: float) -> None:
        pass

    def set_budget(self, budget: float) -> None:
        """Pin the compute budget T (a restore re-pins the one in force)."""
        raise NotImplementedError


class SimulatedClock(Clock):
    """Paper-evaluation clock: model times, Lemma-6 (or explicit) T."""

    def __init__(self, model: StragglerModel, n: int, batch_per_worker: int,
                 compute_time: Optional[float] = None):
        self.model, self.n, self.bpw = model, n, batch_per_worker
        derived = (1.0 + n / (n * batch_per_worker)) * model.mean_batch_time()
        self.budget_t = derived if compute_time is None else compute_time

    def epoch(self, generator):
        return (self.model.per_gradient_times(generator, self.n, self.bpw),
                self.budget_t)

    def set_budget(self, budget):
        self.budget_t = float(budget)


class MeasuredClock(Clock):
    """b_i(t) from measured step times: model heterogeneity, real unit."""

    def __init__(self, model: StragglerModel, n: int, batch_per_worker: int,
                 ema: float = 0.7, compute_time: Optional[float] = None):
        self.model, self.n, self.bpw = model, n, batch_per_worker
        self.ema = ema
        self.compute_time = compute_time
        self.model_unit = model.mean_batch_time() / model.b_ref
        self.sec_per_grad: Optional[float] = None   # EMA; None until a step

    def _unit(self) -> float:
        return self.sec_per_grad if self.sec_per_grad is not None \
            else self.model_unit

    def update(self, step_seconds, global_b):
        obs = step_seconds / max(global_b, 1.0)
        self.sec_per_grad = (obs if self.sec_per_grad is None else
                             self.ema * self.sec_per_grad
                             + (1.0 - self.ema) * obs)

    def budget(self) -> float:
        """Lemma-6 T in measured seconds: (1 + n/b) * mu_measured."""
        return (1.0 + self.n / (self.n * self.bpw)) * self._unit() * self.bpw

    def times(self, generator) -> torch.Tensor:
        """(n, b_max) per-gradient times in *measured* seconds."""
        rel = self.model.per_gradient_times(generator, self.n, self.bpw) \
            / self.model_unit                       # mean-1 heterogeneity
        return rel * self._unit()

    def epoch(self, generator):
        budget = self.budget() if self.compute_time is None \
            else self.compute_time
        return self.times(generator), budget

    def set_budget(self, budget):
        # pinning ends the clock's own Lemma-6 re-derivation
        self.compute_time = float(budget)


def make_clock(spec: ClockSpec, n: int, batch_per_worker: int) -> Clock:
    model = spec.make_model(batch_per_worker)
    if spec.kind == "simulated":
        return SimulatedClock(model, n, batch_per_worker, spec.compute_time)
    if spec.kind == "measured":
        return MeasuredClock(model, n, batch_per_worker, ema=spec.ema,
                             compute_time=spec.compute_time)
    raise ValueError(f"unknown clock kind {spec.kind!r}; "
                     f"choose from {CLOCK_KINDS}")
