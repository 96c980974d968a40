"""Online self-tuning of budget, staleness and batch (counterpart of
``repro.control``).

  * :mod:`.telemetry` — :class:`EpochRecord` per epoch (measured times,
    per-node b_i(t), the gradient-noise estimate) and the
    :class:`Telemetry` EMAs over them.
  * :mod:`.policies` — :class:`BudgetPolicy` (online Lemma 6),
    :class:`StalenessPolicy` (AMB-DG D and gamma = 1/(2D) from the
    measured T_c / T) and :class:`BatchDampingPolicy` (the batch target
    follows the gradient noise scale).
  * :mod:`.controller` — one :class:`Controller` that takes the records,
    applies cadence, hysteresis and clipping, and emits
    :class:`ControlAction`\\ s for the session to actuate.

Configured by :class:`repro_torch.api.specs.ControllerSpec` and wired
into :class:`repro_torch.api.AMBSession`.  The package imports nothing
from ``repro_torch.api`` or ``repro_torch.core``; only
:meth:`BudgetPolicy.init` / :meth:`BudgetPolicy.update` use torch.
"""
from .controller import ControlAction, Controller                # noqa: F401
from .policies import (BatchDampingPolicy, BudgetPolicy,         # noqa: F401
                       StalenessPolicy)
from .telemetry import EpochRecord, Telemetry                    # noqa: F401

__all__ = [
    "BatchDampingPolicy", "BudgetPolicy", "ControlAction", "Controller",
    "EpochRecord", "StalenessPolicy", "Telemetry",
]
