"""The dual-averaging step size (paper eq. 7, Lemma 8).

Counterpart of ``repro.core.dual_averaging``; only :class:`BetaSchedule`
is on the ported path so far.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
