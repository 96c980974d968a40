"""Fault models: deterministic fleet-state processes (counterpart of
``repro.faults.models``, numpy only).

A :class:`FaultModel` says what happens to the fleet as a pure function
of the epoch index:

    ``model.fleet(epoch, n) -> FleetState(active (n,) bool, slow (n,))``

Purity is what a restore relies on: the injector samples the fleet state
from scratch every epoch, so a restored session replays the fault
trajectory the saved one would have seen, and two runs with one seed see
the same failures whatever their timing.  The models compose with the
straggler models of :mod:`repro_torch.core.stragglers`: the stragglers
draw each epoch's per-gradient times, a fail-slow factor multiplies them
(the deadline then shrinks that worker's b_i(t)), and fail-stop or churn
removes workers through ``AMBSession.set_active``.

  * :class:`FailStop` — named workers go down at an epoch, and may come
    back.
  * :class:`FailSlow` — named workers run ``factor`` x slower over a
    window of epochs.
  * :class:`PoissonChurn` — per-worker alternating renewal: up-times
    ~ Geometric(leave_rate), down-times ~ Geometric(rejoin_rate), each
    worker from its own seed; ``pin`` workers never leave.
  * :class:`CorrelatedOutage` — a group of workers drops together every
    ``period`` epochs.
  * :class:`Compose` — AND of the memberships, product of the slowdowns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FleetState:
    """One epoch's fleet: membership and per-gradient time multipliers."""

    active: np.ndarray        # (n,) bool: up this epoch
    slow: np.ndarray          # (n,) float: 1.0 is nominal speed

    @property
    def healthy(self) -> bool:
        return bool(self.active.all() and np.all(self.slow == 1.0))


def _nominal(n: int) -> FleetState:
    return FleetState(active=np.ones(n, dtype=bool),
                      slow=np.ones(n, dtype=np.float64))


class FaultModel:
    """A deterministic epoch -> :class:`FleetState` process; pure in
    ``epoch``, so a restore replays the same trajectory."""

    def fleet(self, epoch: int, n: int) -> FleetState:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FailStop(FaultModel):
    """``workers`` go down at epoch ``at``, and back at ``until`` if set."""

    workers: Tuple[int, ...]
    at: int = 0
    until: Optional[int] = None

    def fleet(self, epoch: int, n: int) -> FleetState:
        st = _nominal(n)
        down = epoch >= self.at and (self.until is None
                                     or epoch < self.until)
        if down:
            st.active[list(self.workers)] = False
        return st


@dataclasses.dataclass(frozen=True)
class FailSlow(FaultModel):
    """``workers`` run ``factor`` x slower on epochs [start, stop)."""

    workers: Tuple[int, ...]
    factor: float = 4.0
    start: int = 0
    stop: Optional[int] = None

    def fleet(self, epoch: int, n: int) -> FleetState:
        st = _nominal(n)
        if epoch >= self.start and (self.stop is None or epoch < self.stop):
            st.slow[list(self.workers)] = float(self.factor)
        return st


@dataclasses.dataclass(frozen=True)
class PoissonChurn(FaultModel):
    """Independent per-worker alternating-renewal churn.

    Worker i (for i >= ``pin``) alternates up and down phases of
    geometric length, mean ``1/leave_rate`` epochs up and
    ``1/rejoin_rate`` down, drawn from ``default_rng((seed, i))`` walked
    from epoch 0 on every query.  The first ``pin`` workers never leave,
    so at least one worker is always up.
    """

    leave_rate: float = 0.25
    rejoin_rate: float = 0.5
    seed: int = 0
    pin: int = 1

    def fleet(self, epoch: int, n: int) -> FleetState:
        st = _nominal(n)
        for i in range(max(self.pin, 0), n):
            rng = np.random.default_rng((self.seed, i))
            t, up = 0, True
            while True:
                dur = int(rng.geometric(
                    self.leave_rate if up else self.rejoin_rate))
                if t + dur > epoch:
                    break
                t += dur
                up = not up
            st.active[i] = up
        return st


@dataclasses.dataclass(frozen=True)
class CorrelatedOutage(FaultModel):
    """``group`` is down for ``duration`` epochs every ``period``, from
    ``start``: a rack or power-domain failure, the case that coded
    placement must spread replicas across groups to survive."""

    group: Tuple[int, ...]
    period: int = 8
    duration: int = 2
    start: int = 2

    def fleet(self, epoch: int, n: int) -> FleetState:
        st = _nominal(n)
        if epoch >= self.start \
                and (epoch - self.start) % self.period < self.duration:
            st.active[list(self.group)] = False
        return st


@dataclasses.dataclass(frozen=True)
class Compose(FaultModel):
    """AND of memberships, product of slowdowns, across ``models``."""

    models: Tuple[FaultModel, ...]

    def fleet(self, epoch: int, n: int) -> FleetState:
        st = _nominal(n)
        for m in self.models:
            sub = m.fleet(epoch, n)
            st.active[:] &= sub.active       # in place: the fields are frozen
            st.slow[:] *= sub.slow
        return st
