"""Frozen, JSON-round-trippable configuration for the Session API
(counterpart of ``repro.api.specs``), with the fields the port has.

  * :class:`TrainSpec` — what trains: architecture, worker count, sizes,
    optimizer, AMB or FMB, seed, kernel routing.
  * :class:`ClockSpec` — the fixed-compute-time contract: straggler model,
    budget T (explicit, or Lemma 6 when ``None``; an explicit 0.0 is
    honoured), window T_c, measured or simulated timing.
  * :class:`ConsensusSpec` — how workers agree: strategy, gossip graph and
    rounds, the dual-averaging beta schedule.

Each spec round-trips through JSON (``to_json`` / ``from_json``) and
through argparse (``add_cli_args`` / ``from_args``, with the JAX CLI's
flag names, defaults and choices).  The JAX flags of modules the port has
not taken yet (coded redundancy, pipelined and async epochs, the
controller) are not registered.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Tuple

from ..core.dual_averaging import BetaSchedule
from ..core.stragglers import (Deterministic, ShiftedExponential,
                               StragglerModel)

OPTIMIZERS = ("dual_averaging", "adamw", "sgd")
MODES = ("amb", "fmb")
CLOCK_KINDS = ("measured", "simulated")
STRAGGLER_MODELS = ("shifted_exp", "deterministic")
GRAPHS = ("ring", "torus")
# the JAX CLI's --kernels choices, and what each means in the port's router
KERNEL_MODES = ("auto", "pallas", "ref", "pallas_interpret")
ROUTER_MODES = {"auto": "auto", "pallas": "kernel", "ref": "ref"}


class _Spec:
    """Shared JSON round-trip for the frozen spec dataclasses."""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "_Spec":
        kw = dict(d)
        for f in dataclasses.fields(cls):
            # JSON has no tuples; restore them (torus_shape)
            if f.name in kw and isinstance(kw[f.name], list):
                kw[f.name] = tuple(kw[f.name])
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "_Spec":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainSpec(_Spec):
    """Architecture, workers, optimizer: ``data`` workers on one device."""

    arch: str = "qwen2-1.5b"
    smoke: bool = False               # reduced config variant
    seq_len: int = 256
    batch_per_worker: int = 8         # b/n: target per-worker minibatch
    data: int = 1
    optimizer: str = "dual_averaging"
    mode: str = "amb"                 # amb | fmb
    seed: int = 0
    kernels: str = "auto"             # auto | pallas (the CUDA kernels) |
                                      # ref (the plain versions); see
                                      # router_mode

    def router_mode(self) -> str:
        """``kernels`` in the port's router: ``pallas`` is the CUDA
        kernels, ``ref`` their plain versions, ``auto`` by device."""
        if self.kernels == "pallas_interpret":
            raise ValueError("kernels='pallas_interpret' is the Pallas "
                             "interpreter, which the port does not have; "
                             "use auto, pallas (the CUDA kernels) or ref "
                             "(their plain versions)")
        if self.kernels not in ROUTER_MODES:
            raise ValueError(f"unknown kernels {self.kernels!r}; choose "
                             f"from {tuple(ROUTER_MODES)}")
        return ROUTER_MODES[self.kernels]

    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        ap.add_argument("--arch", default=TrainSpec.arch)
        ap.add_argument("--smoke", action="store_true",
                        help="use the reduced config (CPU-friendly)")
        ap.add_argument("--seq-len", type=int, default=TrainSpec.seq_len)
        ap.add_argument("--batch-per-worker", type=int,
                        default=TrainSpec.batch_per_worker)
        ap.add_argument("--data", type=int, default=TrainSpec.data)
        ap.add_argument("--optimizer", default=TrainSpec.optimizer,
                        choices=list(OPTIMIZERS))
        ap.add_argument("--mode", default=TrainSpec.mode,
                        choices=list(MODES))
        ap.add_argument("--seed", type=int, default=TrainSpec.seed)
        ap.add_argument("--kernels", default=TrainSpec.kernels,
                        choices=list(KERNEL_MODES),
                        help="kernel routing: auto runs the CUDA kernels "
                             "on the card and the plain versions on the "
                             "CPU; pallas forces the kernels, ref the "
                             "plain versions (pallas_interpret is "
                             "refused)")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "TrainSpec":
        return cls(arch=args.arch, smoke=args.smoke, seq_len=args.seq_len,
                   batch_per_worker=args.batch_per_worker, data=args.data,
                   optimizer=args.optimizer, mode=args.mode, seed=args.seed,
                   kernels=getattr(args, "kernels", TrainSpec.kernels))


@dataclasses.dataclass(frozen=True)
class ClockSpec(_Spec):
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

    def resolve_budget(self, derived: float) -> float:
        """Explicit T when set (0.0 included), else the derived budget."""
        return derived if self.compute_time is None else self.compute_time

    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        ap.add_argument("--clock", default=ClockSpec.kind,
                        choices=list(CLOCK_KINDS),
                        help="b_i(t) source: measured per-step wall time "
                             "or the simulated straggler clock (paper "
                             "evaluation)")
        ap.add_argument("--sim-clock", action="store_true",
                        help="alias for --clock simulated")
        ap.add_argument("--compute-time", type=float, default=None,
                        help="AMB budget T; default from Lemma 6 "
                             "(an explicit 0.0 is honoured)")
        ap.add_argument("--comm-time", type=float,
                        default=ClockSpec.comm_time)
        ap.add_argument("--straggler", default=ClockSpec.straggler,
                        choices=list(STRAGGLER_MODELS))
        ap.add_argument("--clock-ema", type=float, default=ClockSpec.ema,
                        help="measured-clock EMA smoothing factor")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ClockSpec":
        kind = "simulated" if getattr(args, "sim_clock", False) \
            else args.clock
        return cls(kind=kind, compute_time=args.compute_time,
                   comm_time=args.comm_time, straggler=args.straggler,
                   ema=getattr(args, "clock_ema", ClockSpec.ema))


@dataclasses.dataclass(frozen=True)
class ConsensusSpec(_Spec):
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

    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        from ..dist.consensus import CONSENSUS_CHOICES
        ap.add_argument("--consensus", default=ConsensusSpec.consensus,
                        choices=list(CONSENSUS_CHOICES),
                        help="exact weighted average, decentralized "
                             "gossip with per-worker dual replicas, or "
                             "8/4-bit quantized gossip (more rounds per "
                             "T_c)")
        ap.add_argument("--graph", default=ConsensusSpec.graph,
                        choices=list(GRAPHS),
                        help="worker gossip graph")
        ap.add_argument("--gossip-rounds", type=int,
                        default=ConsensusSpec.gossip_rounds)

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ConsensusSpec":
        return cls(consensus=args.consensus, graph=args.graph,
                   gossip_rounds=args.gossip_rounds)
