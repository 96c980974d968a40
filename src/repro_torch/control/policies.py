"""The three control policies: budget, staleness, batch damping
(counterpart of ``repro.control.policies``).

Each policy is a frozen dataclass that maps smoothed telemetry to a
proposal for one knob; :class:`repro_torch.control.controller.Controller`
owns cadence, hysteresis and actuation.  The policies keep no state, so a
decision is reproducible from a telemetry snapshot, which is what the
save and restore path relies on.

* :class:`BudgetPolicy` — the online Lemma 6 (``core.extensions.
  AdaptiveBudget`` is this class): re-solve ``T = (1 + n/b) mu`` from the
  EMA'd mean per-gradient time ``tau`` (``mu = (b/n) tau``).  ``tau`` is
  the arithmetic mean over nodes of ``T / b_i``; inverting the aggregate
  rate ``b(t)/T`` instead gives the harmonic mean of the node rates,
  which undershoots Lemma 6's T whenever node times are random.
* :class:`StalenessPolicy` — the async epoch takes ``max(T, T_c / D)``,
  so the smallest staleness that keeps epochs compute-bound is ``D =
  ceil(T_c / T)``; it moves only when the ratio clears the boundary by
  ``hysteresis``, and ``gamma = 1/(2D)`` goes with it.
* :class:`BatchDampingPolicy` — a marginal gradient is worth less once
  the batch passes the noise scale ``B_noise = tr(Sigma) / ||grad
  L||^2``; grow the effective batch target toward ``alpha * B_noise``
  (never below the launch target), at most ``grow`` x a decision and
  capped by the data layout.  The target feeds :class:`BudgetPolicy`'s
  re-solve, so the batch moves through the deadline T.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BudgetPolicy:
    """Online Lemma 6: re-solve the compute budget T from per-node times.

    * :meth:`solve` — the controller's path, host floats in and out;
    * :meth:`init` / :meth:`update` — the EMA form on tensors that the
      simulator's adaptive run (``run_amb_adaptive``) steps with:

        tau_ema(t+1) = ema * tau_ema(t) + (1 - ema) * mean_i T(t)/b_i(t)
        T(t+1)       = clip((1 + n/b) * (b/n) * tau_ema, t_min, t_max)
    """

    b_target: int
    ema: float = 0.9
    t_min: float = 1e-3
    t_max: float = 1e6

    def solve(self, tau: float, n: int,
              b_target: Optional[int] = None) -> float:
        """Lemma-6 T from a mean per-gradient time (host floats)."""
        bt = float(self.b_target if b_target is None else b_target)
        mu = (bt / n) * tau
        return float(min(max((1.0 + n / bt) * mu, self.t_min), self.t_max))

    def init(self, t0: float, device=None) -> dict:
        # tau < 0 marks "no observation yet": the first update adopts the
        # observed mean per-gradient time instead of averaging it with
        # the one the (possibly badly mistuned) initial T implies
        return {"t_budget": torch.tensor(t0, dtype=torch.float32,
                                         device=device),
                "tau": torch.tensor(-1.0, dtype=torch.float32,
                                    device=device)}

    def update(self, state: dict, b_observed: torch.Tensor) -> dict:
        """``b_observed``: the (n,) per-node minibatch sizes b_i(t)."""
        b = torch.clamp(b_observed.to(torch.float32), min=1.0)
        tau_obs = torch.mean(state["t_budget"] / b)
        tau = torch.where(state["tau"] < 0.0, tau_obs,
                          self.ema * state["tau"]
                          + (1.0 - self.ema) * tau_obs)
        n = b_observed.shape[0]
        mu = (self.b_target / n) * tau
        t_new = torch.clamp((1.0 + n / self.b_target) * mu, self.t_min,
                            self.t_max)
        return {"t_budget": t_new, "tau": tau}


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """AMB-DG staleness from the measured ``T_c / T``.

    ``propose(d_cur, ratio)`` returns ``d_cur`` unless the ratio clears
    the deadband: raise to ``D* = ceil(ratio)`` only when ``ratio > d_cur
    + hysteresis``; lower to ``D*`` only when ``ratio <= d_cur - 1 -
    hysteresis``.  A ratio on a boundary never flips D back and forth.
    """

    d_max: int = 8
    hysteresis: float = 0.25

    def target(self, ratio: float) -> int:
        """The ideal without hysteresis: the smallest D with T_c / D <= T."""
        return int(min(max(math.ceil(ratio - 1e-9), 1), self.d_max))

    def propose(self, d_cur: int, ratio: float) -> int:
        ideal = self.target(ratio)
        if ideal > d_cur and ratio > d_cur + self.hysteresis:
            return ideal
        if ideal < d_cur and ratio <= d_cur - 1 - self.hysteresis:
            return ideal
        return d_cur

    @staticmethod
    def gamma(d: int) -> float:
        """The delayed-mixing damping that goes with D (1/(2D); 1 at D=1)."""
        return 1.0 if d <= 1 else 1.0 / (2.0 * d)


@dataclasses.dataclass(frozen=True)
class BatchDampingPolicy:
    """Grow the effective batch target as the gradient noise scale grows.

    ``propose(b_cur, noise_scale)`` moves the target toward ``alpha *
    noise_scale``, clipped to ``[b_floor, b_cap]``, never shrinking and
    growing at most ``grow`` x a decision; relative moves within
    ``deadband`` are dropped.  Without noise telemetry it returns
    ``b_cur``.
    """

    b_floor: int
    b_cap: int
    alpha: float = 1.0
    grow: float = 2.0
    deadband: float = 0.25

    def propose(self, b_cur: int, noise_scale: Optional[float]) -> int:
        if noise_scale is None:
            return b_cur
        want = self.alpha * noise_scale
        want = min(max(want, float(self.b_floor)), float(self.b_cap))
        want = min(want, self.grow * b_cur)       # rate limit
        want = max(want, float(min(b_cur, self.b_cap)))   # grow only
        prop = int(round(want))
        if abs(prop - b_cur) <= self.deadband * b_cur:
            return b_cur
        return prop
