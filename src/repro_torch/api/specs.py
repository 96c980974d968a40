"""Frozen configuration for the Session API (counterpart of
``repro.api.specs``), with the fields the ported slice uses.

  * :class:`TrainSpec` — what trains: architecture, worker count, sizes,
    seed.
  * :class:`ClockSpec` — the fixed-compute-time contract: straggler model,
    budget T (explicit, or Lemma 6 when ``None``), window T_c.
  * :class:`ConsensusSpec` — how workers agree: strategy, gossip graph and
    rounds, the dual-averaging beta schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.dual_averaging import BetaSchedule
from ..core.stragglers import (Deterministic, ShiftedExponential,
                               StragglerModel)

CLOCK_KINDS = ("measured", "simulated")
STRAGGLER_MODELS = ("shifted_exp", "deterministic")


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Architecture and workers: ``data`` workers, on one device."""

    arch: str = "qwen2-1.5b"
    smoke: bool = False               # reduced config variant
    seq_len: int = 256
    batch_per_worker: int = 8         # b/n: target per-worker minibatch
    data: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ClockSpec:
    """Straggler model, budget T (None = Lemma 6; 0.0 is honoured), T_c."""

    kind: str = "measured"            # measured | simulated
    compute_time: Optional[float] = None
    comm_time: float = 0.5            # consensus window T_c (sim seconds)
    straggler: str = "shifted_exp"    # shifted_exp | deterministic
    lam: float = 2.0 / 3.0            # ShiftedExponential rate (paper I.2)
    zeta: float = 1.0                 # ShiftedExponential shift
    grad_time: float = 1.0            # Deterministic per-gradient time
    ema: float = 0.7                  # measured-clock EMA smoothing

    def make_model(self, b_ref: int) -> StragglerModel:
        if self.straggler == "shifted_exp":
            return ShiftedExponential(lam=self.lam, zeta=self.zeta,
                                      b_ref=b_ref)
        if self.straggler == "deterministic":
            return Deterministic(grad_time=self.grad_time, b_ref=b_ref)
        raise ValueError(f"unknown straggler model {self.straggler!r}; "
                         f"choose from {STRAGGLER_MODELS}")


@dataclasses.dataclass(frozen=True)
class ConsensusSpec:
    """Consensus strategy and the dual-averaging beta schedule."""

    consensus: str = "exact"          # exact | gossip | gossip_q8 | gossip_q4
    graph: str = "ring"               # ring | torus
    gossip_rounds: int = 5
    torus_shape: Optional[Tuple[int, int]] = None
    lazy: float = 0.5
    radius: Optional[float] = None    # prox trust region (per leaf)
    beta_k: float = 50.0              # beta_mu=None defaults to the
    beta_mu: Optional[float] = None   # global batch b
    beta_scale: float = 200.0

    def beta(self, global_batch: int) -> BetaSchedule:
        mu = float(global_batch) if self.beta_mu is None else self.beta_mu
        return BetaSchedule(k=self.beta_k, mu=mu, scale=self.beta_scale)

    def to_amb_config(self, global_batch: int, seed: int = 0):
        from ..dist.amb import AMBConfig
        return AMBConfig(consensus=self.consensus,
                         gossip_rounds=self.gossip_rounds, graph=self.graph,
                         torus_shape=self.torus_shape, lazy=self.lazy,
                         beta=self.beta(global_batch), radius=self.radius,
                         seed=seed)
