"""One controller over the runtime knobs: budget, staleness, batch
(counterpart of ``repro.control.controller``, pure host state).

``Controller.observe(record)`` is the whole loop: fold the epoch's
:class:`repro_torch.control.telemetry.EpochRecord` into the telemetry
EMAs and, on the decision cadence after warm-up, consult the three
policies and emit a :class:`ControlAction` that names only the knobs
that move.  The session applies it (the budget into the clock, the
staleness by drain and rebuild); the controller touches no tensor, so it
goes into ``session.json`` and a restored run replays its decisions bit
for bit.

Against thrash: at most one decision every ``interval`` epochs and none
before ``warmup``; the policies see only EMAs; budget moves under
``deadband`` and batch moves under the batch policy's deadband are
dropped; the budget moves at most ``max_step`` x a decision; the
staleness only when the ratio clears the hysteresis band.  The order is
fixed: batch first (it changes what Lemma 6 solves for), then budget (at
the possibly new target), then staleness (T_c over the budget that will
be in force next epoch).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .policies import BatchDampingPolicy, BudgetPolicy, StalenessPolicy
from .telemetry import EpochRecord, Telemetry


@dataclasses.dataclass
class ControlAction:
    """One decision: only the knobs that move are not None."""

    epoch: int
    budget: Optional[float] = None       # new compute budget T (seconds)
    staleness: Optional[int] = None      # new D (async driver)
    gamma: Optional[float] = None        # 1/(2D), the companion of D
    b_target: Optional[int] = None       # new effective-batch target
    reason: str = ""

    @property
    def nontrivial(self) -> bool:
        return (self.budget is not None or self.staleness is not None
                or self.b_target is not None)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Controller:
    """Telemetry in, :class:`ControlAction` out.

    Args:
      spec: a :class:`repro_torch.api.specs.ControllerSpec` (only its
        scalar fields are read).
      n_workers: Lemma 6's n.
      comm_time: the consensus window T_c (seconds).
      b_target: the launch effective-batch target (Lemma 6's b), also the
        batch policy's floor.
      b_cap: the batch ceiling, ``n * batch_per_worker``.
      staleness: the D in force at launch.
      async_mode: whether the session runs the async driver (the
        staleness retune is suppressed otherwise).
    """

    def __init__(self, spec, *, n_workers: int, comm_time: float,
                 b_target: int, b_cap: int, staleness: int = 1,
                 async_mode: bool = False):
        self.spec = spec
        self.n = int(n_workers)
        self.comm_time = float(comm_time)
        self.async_mode = bool(async_mode)
        self.telemetry = Telemetry(ema=spec.ema)
        self.budget_policy = BudgetPolicy(b_target=int(b_target))
        self.staleness_policy = StalenessPolicy(d_max=spec.d_max,
                                                hysteresis=spec.hysteresis)
        self.batch_policy = BatchDampingPolicy(b_floor=int(b_target),
                                               b_cap=int(b_cap))
        # the live knob values the session mirrors
        self.b_target = int(b_target)
        self.staleness = int(staleness)
        self.budget: Optional[float] = None   # adopted from the first record
        self._since_decision = 0
        self.decisions = 0                    # non-trivial actions emitted

    # -- the loop ----------------------------------------------------------

    def observe(self, rec: EpochRecord) -> Optional[ControlAction]:
        """Fold one epoch's record; maybe emit an action (see cadence)."""
        self.telemetry.update(rec)
        if self.budget is None:
            self.budget = float(rec.budget_s)
        self._since_decision += 1
        if (self.telemetry.epochs_seen < self.spec.warmup
                or self._since_decision < self.spec.interval):
            return None
        self._since_decision = 0
        action = self._decide(rec.t)
        if action is None or not action.nontrivial:
            return None
        self.decisions += 1
        return action

    def _decide(self, epoch: int) -> Optional[ControlAction]:
        spec = self.spec
        action = ControlAction(epoch=epoch)
        reasons = []

        # 1) batch damping: the target Lemma 6 solves for next
        if spec.batch:
            prop = self.batch_policy.propose(self.b_target,
                                             self.telemetry.noise_scale)
            if prop != self.b_target:
                ns = self.telemetry.noise_scale
                reasons.append(f"b_target {self.b_target}->{prop} "
                               f"(noise_scale~{ns:.1f})")
                self.b_target = prop
                action.b_target = prop

        # 2) budget: online Lemma 6 at the (possibly new) target
        if spec.budget and self.telemetry.tau is not None:
            want = self.budget_policy.solve(self.telemetry.tau, self.n,
                                            b_target=self.b_target)
            cur = self.budget
            want = min(max(want, cur / spec.max_step), cur * spec.max_step)
            if abs(want - cur) > spec.deadband * max(cur, 1e-12):
                reasons.append(f"T {cur:.4g}->{want:.4g} "
                               f"(tau~{self.telemetry.tau:.4g})")
                self.budget = want
                action.budget = want

        # 3) staleness: T_c over the budget that will be in force
        if spec.staleness and self.async_mode and self.budget:
            ratio = self.comm_time / max(self.budget, 1e-12)
            prop = self.staleness_policy.propose(self.staleness, ratio)
            if prop != self.staleness:
                reasons.append(f"D {self.staleness}->{prop} "
                               f"(T_c/T~{ratio:.2f})")
                self.staleness = prop
                action.staleness = prop
                action.gamma = self.staleness_policy.gamma(prop)

        action.reason = "; ".join(reasons)
        return action

    # -- save / restore ----------------------------------------------------

    def to_state(self) -> dict:
        """A JSON-ready snapshot; with the spec it fixes every later
        decision."""
        return {"telemetry": self.telemetry.to_state(),
                "b_target": self.b_target, "staleness": self.staleness,
                "budget": self.budget,
                "since_decision": self._since_decision,
                "decisions": self.decisions}

    def load_state(self, state: dict) -> None:
        self.telemetry = Telemetry.from_state(state["telemetry"])
        self.b_target = int(state["b_target"])
        self.staleness = int(state["staleness"])
        self.budget = (None if state.get("budget") is None
                       else float(state["budget"]))
        self._since_decision = int(state.get("since_decision", 0))
        self.decisions = int(state.get("decisions", 0))
