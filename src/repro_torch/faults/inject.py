"""Drive a :class:`~repro_torch.faults.models.FaultModel` through a
session (counterpart of ``repro.faults.inject``).

``AMBSession.run(..., faults=...)`` calls :meth:`FaultInjector.apply`
before each epoch, which

  1. samples the epoch's :class:`~repro_torch.faults.models.FleetState`;
  2. keeps worker 0 up if the whole fleet is down (an epoch needs a
     survivor);
  3. on a membership change, calls ``session.set_active``, which drains
     in-flight consensus under the old operator and rebuilds gossip on
     the survivors; a re-admitted worker resumes from its kept dual;
  4. on a change of the slowdowns, calls ``session.set_slowdown``.

Membership events (epoch and mask) are kept on ``injector.events``.  The
injector holds nothing but the last applied mask and slowdowns, so a
fresh injector over the same model, after a restore, replays the same
trajectory.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .models import FaultModel, FleetState


class FaultInjector:
    """Apply a fault model's fleet state to a session, epoch by epoch."""

    def __init__(self, model: FaultModel):
        self.model = model
        self._mask: Optional[tuple] = None
        self._slow: Optional[tuple] = None
        self.events: list = []

    def apply(self, session, epoch: int) -> FleetState:
        """Sample ``epoch``'s fleet state and actuate it on ``session``."""
        st = self.model.fleet(int(epoch), session.n_workers)
        active = np.asarray(st.active, dtype=bool).copy()
        if not active.any():
            active[0] = True        # quorum guard: an epoch needs a survivor
        mask = tuple(bool(a) for a in active)
        if mask != self._mask:
            session.set_active(active)
            self.events.append({"epoch": int(epoch),
                                "active": [int(a) for a in active]})
            self._mask = mask
        slow = tuple(float(s) for s in st.slow)
        if slow != self._slow:
            session.set_slowdown(None if all(s == 1.0 for s in slow)
                                 else st.slow)
            self._slow = slow
        return FleetState(active=active, slow=np.asarray(st.slow))

    @property
    def membership_changes(self) -> int:
        """The membership transitions applied so far (the first epoch's
        mask counts as one)."""
        return len(self.events)
