"""Closed-form bounds from the paper's analysis (Thm 2, Thm 4, Thm 7,
App. H), on Python floats.

Counterpart of ``repro.core.regret``: measured regret from
:mod:`repro_torch.core.engine` must sit below the Thm-2 bound, and the
AMB/FMB wall-clock ratio must respect Thm 7.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """§4.1 constants: Lipschitz L, smoothness K, noise sigma, diameter D."""

    lip_l: float
    smooth_k: float
    sigma: float
    diameter: float


def theorem2_bound(consts: ProblemConstants, *, f_gap0: float, beta_tau: float,
                   h_wstar: float, eps: float, c_max: float, mu: float,
                   m: float) -> float:
    """Thm 2 sample-path regret bound (eq. 17)."""
    k, d, l, s = consts.smooth_k, consts.diameter, consts.lip_l, consts.sigma
    return float(
        c_max * (f_gap0 + beta_tau * h_wstar)
        + 0.75 * k**2 * eps**2 * c_max * mu**1.5
        + (2 * k * d * eps + 0.5 * s**2 + 2 * l * eps) * c_max * np.sqrt(m)
    )


def theorem4_bound(consts: ProblemConstants, *, f_gap0: float, beta_tau: float,
                   h_wstar: float, eps: float, c_bar: float, b_hat: float,
                   m_bar: float) -> float:
    """Thm 4 expected regret bound."""
    k, d, l, s = consts.smooth_k, consts.diameter, consts.lip_l, consts.sigma
    return float(
        c_bar * (f_gap0 + beta_tau * h_wstar)
        + 0.75 * k**2 * eps**2 * c_bar**2.5
        + (2 * k * d * eps + c_bar * s**2 / (2 * b_hat) + 2 * l * eps * c_bar)
        * np.sqrt(m_bar)
    )


def theorem7_ratio(mu: float, sigma: float, n: int) -> float:
    """S_F / S_A <= 1 + (sigma/mu) sqrt(n-1) (eq. 20)."""
    return float(1.0 + (sigma / mu) * np.sqrt(max(n - 1, 0)))


def shifted_exp_ratio(lam: float, zeta: float, n: int, b: float) -> float:
    """App. H exact ratio (eq. 83): (log-order speedup of AMB over FMB)."""
    h_n = float(np.sum(1.0 / np.arange(1, n + 1)))  # exact E[max] uses H_n
    s_f = h_n / lam + zeta
    s_a = (1.0 + n / b) * (1.0 / lam + zeta)
    return float(s_f / s_a)


def shifted_exp_asymptotic_ratio(lam: float, zeta: float, n: int) -> float:
    """App. H eq. 84: S_F/S_A -> log(n) / (1 + lam*zeta)."""
    return float(np.log(n) / (1.0 + lam * zeta))
