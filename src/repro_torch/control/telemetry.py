"""Per-epoch telemetry for the online controller (counterpart of
``repro.control.telemetry``, numpy only).

One :class:`EpochRecord` per ``AMBSession.step``: the measured compute
and consensus times, the realised b_i(t), and, when the step was built
with ``noise_stats`` (:class:`repro_torch.dist.amb.NoiseStats`), a
gradient-noise estimate from the *between-worker* dispersion of the
per-worker mean gradients.  :class:`Telemetry` folds the records into
EMAs; the policies read only these, so one noisy draw cannot flip a
decision.

The noise estimate, in the "gradient noise scale" form: worker i's mean
gradient over b_i samples has covariance Sigma / b_i, so the b-weighted
dispersion around the eq.-6 weighted mean, ``Dw = sum_i (b_i/B)
||g_i - gbar||^2``, has expectation ``tr(Sigma) (n-1)/B``.  Hence
``tr(Sigma) ~= Dw B/(n-1)``, and the unbiased squared full-gradient norm
is ``||gbar||^2 - Dw/(n-1)``.  Their ratio, ``B_noise = tr(Sigma) /
||grad L||^2``, is the batch size past which averaging stops paying.
Numerator and denominator are EMA'd apart: a ratio of EMAs is steadier
than an EMA of ratios when the denominator passes near zero.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class EpochRecord:
    """What one AMB epoch measured (host floats only)."""

    t: int                    # epoch index (the session's step count)
    budget_s: float           # compute budget T of this epoch
    comm_time_s: float        # consensus window T_c
    step_s: float             # measured host time of the step
    loss: float
    b: np.ndarray             # (n,) realised b_i(t)
    global_batch: float       # sum_i min(b_i, per-worker cap)
    staleness: int = 1        # D in force when the epoch ran
    tau_s: Optional[float] = None          # measured mean per-gradient s
    grad_sq_norm: Optional[float] = None   # ||gbar||^2 (biased; see above)
    grad_var: Optional[float] = None       # Dw, the b-weighted dispersion


class Telemetry:
    """EMAs over :class:`EpochRecord` streams (all None until observed).

    * ``tau`` — mean per-gradient seconds: the record's measured
      ``tau_s`` (elapsed time of the gradients each node finished, over
      their count; exact even when b_i reaches the per-worker cap) when
      there is one, else ``mean_i T / b_i``, which over-estimates it when
      a node reaches the cap early and idles out the window (and then
      the Lemma-6 re-solve feeds back on itself).
    * ``ratio`` — T_c / T, which the staleness retune keys on.
    * ``trace_sigma`` / ``grad_sq`` — the noise numerator and the
      bias-corrected denominator; ``noise_scale`` is their ratio.
    * ``loss`` — the smoothed train loss.
    """

    def __init__(self, ema: float = 0.8):
        self.ema = float(ema)
        self.tau: Optional[float] = None
        self.ratio: Optional[float] = None
        self.trace_sigma: Optional[float] = None
        self.grad_sq: Optional[float] = None
        self.loss: Optional[float] = None
        self.epochs_seen = 0

    def _fold(self, cur: Optional[float], obs: float) -> float:
        if cur is None:
            return float(obs)
        return self.ema * cur + (1.0 - self.ema) * float(obs)

    def update(self, rec: EpochRecord) -> None:
        b = np.maximum(np.asarray(rec.b, dtype=np.float64), 1.0)
        n = int(b.shape[0])
        if rec.tau_s is not None:
            self.tau = self._fold(self.tau, rec.tau_s)
        elif rec.budget_s > 0.0:
            self.tau = self._fold(self.tau, float(np.mean(rec.budget_s / b)))
        if rec.budget_s > 0.0:
            self.ratio = self._fold(self.ratio,
                                    rec.comm_time_s / rec.budget_s)
        self.loss = self._fold(self.loss, rec.loss)
        if (rec.grad_sq_norm is not None and rec.grad_var is not None
                and n > 1 and rec.global_batch >= 1.0):
            big_b = float(rec.global_batch)
            tr = rec.grad_var * big_b / (n - 1)
            g2 = max(rec.grad_sq_norm - rec.grad_var / (n - 1), 0.0)
            self.trace_sigma = self._fold(self.trace_sigma, tr)
            self.grad_sq = self._fold(self.grad_sq, g2)
        self.epochs_seen += 1

    @property
    def noise_scale(self) -> Optional[float]:
        """``tr(Sigma) / ||grad L||^2``; None until noise stats arrive."""
        if self.trace_sigma is None or self.grad_sq is None:
            return None
        return self.trace_sigma / max(self.grad_sq, 1e-12)

    # -- save / restore ----------------------------------------------------

    def to_state(self) -> dict:
        return {"ema": self.ema, "tau": self.tau, "ratio": self.ratio,
                "trace_sigma": self.trace_sigma, "grad_sq": self.grad_sq,
                "loss": self.loss, "epochs_seen": self.epochs_seen}

    @classmethod
    def from_state(cls, state: dict) -> "Telemetry":
        t = cls(ema=state.get("ema", 0.8))
        for k in ("tau", "ratio", "trace_sigma", "grad_sq", "loss"):
            setattr(t, k, state.get(k))
        t.epochs_seen = int(state.get("epochs_seen", 0))
        return t
