"""Fault injection: churn, outages and slowdowns (counterpart of
``repro.faults``).

AMB absorbs workers that are *slow* (their b_i(t) shrinks, down to 0);
this package exercises workers that *vanish*:

  * :mod:`.models` — pure, epoch-indexed :class:`FaultModel` processes
    (:class:`FailStop`, :class:`FailSlow`, :class:`PoissonChurn`,
    :class:`CorrelatedOutage`, :class:`Compose`) giving a
    :class:`FleetState`: the membership mask and per-worker slowdowns.
  * :mod:`.inject` — :class:`FaultInjector`, which drives a model through
    :class:`repro_torch.api.AMBSession`: membership changes go through
    ``set_active`` (drain first, survivor relayout, duals kept across a
    leave and a rejoin), slowdowns scale the clock's per-gradient draws.

Pair with ``TrainSpec.redundancy`` (:mod:`repro_torch.dist.redundancy`)
so the gradient estimate stays unbiased while workers are down.  The
models are numpy only, so they equal the JAX package's bit for bit.
"""
from .models import (Compose, CorrelatedOutage, FailSlow,   # noqa: F401
                     FailStop, FaultModel, FleetState, PoissonChurn)
from .inject import FaultInjector                           # noqa: F401

__all__ = [
    "Compose", "CorrelatedOutage", "FailSlow", "FailStop", "FaultModel",
    "FaultInjector", "FleetState", "PoissonChurn",
]
