"""Frozen, JSON-round-trippable configuration for the Session API
(counterpart of ``repro.api.specs``), with the fields the port has.

  * :class:`TrainSpec` — what trains: architecture, worker count, sizes,
    optimizer, AMB or FMB, seed, kernel routing, coded redundancy.
  * :class:`ClockSpec` — the fixed-compute-time contract: straggler model,
    budget T (explicit, or Lemma 6 when ``None``; an explicit 0.0 is
    honoured), window T_c, measured or simulated timing.
  * :class:`ConsensusSpec` — how workers agree: strategy, gossip graph and
    rounds, the epoch driver (sequential, pipelined or async with
    staleness D), the dual-averaging beta schedule.
  * :class:`ControllerSpec` — the online controller of budget T,
    staleness D and batch target (:mod:`repro_torch.control`).

Each spec round-trips through JSON (``to_json`` / ``from_json``) and
through argparse (``add_cli_args`` / ``from_args``, with the JAX CLI's
flag names, defaults and choices).
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
    """Architecture, workers, optimizer.

    The mesh extents are JAX's: ``pod * data`` workers, in one process
    (the workers a loop on one device) or one process per worker over an
    initialised ``torch.distributed`` group (:mod:`repro_torch.launch.
    mesh`).  ``model > 1``, tensor parallelism inside a worker, is
    refused (ROADMAP.md, module item 4a).
    """

    arch: str = "qwen2-1.5b"
    smoke: bool = False               # reduced config variant
    seq_len: int = 256
    batch_per_worker: int = 8         # b/n: target per-worker minibatch
    data: int = 1                     # mesh extents; workers = pod * data
    model: int = 1
    pod: int = 1
    optimizer: str = "dual_averaging"
    mode: str = "amb"                 # amb | fmb
    seed: int = 0
    kernels: str = "auto"             # auto | pallas (the CUDA kernels) |
                                      # ref (the plain versions); see
                                      # router_mode
    redundancy: int = 1               # rho: coded data replication (groups
                                      # of rho workers hold rotated copies
                                      # of one block; 1 = uncoded)

    def __post_init__(self):
        if self.model != 1:
            raise ValueError(
                f"model={self.model}: tensor parallelism inside a worker "
                f"is not ported yet (ROADMAP.md, module item 4a: live "
                f"FSDP x TP and model > 1); use model=1")

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
        ap.add_argument("--model", type=int, default=TrainSpec.model)
        ap.add_argument("--pod", type=int, default=TrainSpec.pod)
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
        ap.add_argument("--redundancy", type=int,
                        default=TrainSpec.redundancy,
                        help="coded data replication factor rho (must "
                             "divide the worker count): groups of rho "
                             "workers hold rotated copies of one data "
                             "block and decode-on-settle weights keep the "
                             "gradient estimate unbiased under worker "
                             "loss; 1 = uncoded")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "TrainSpec":
        return cls(arch=args.arch, smoke=args.smoke, seq_len=args.seq_len,
                   batch_per_worker=args.batch_per_worker, data=args.data,
                   model=args.model, pod=args.pod, optimizer=args.optimizer,
                   mode=args.mode, seed=args.seed,
                   kernels=getattr(args, "kernels", TrainSpec.kernels),
                   redundancy=getattr(args, "redundancy",
                                      TrainSpec.redundancy))


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
    """Consensus strategy, epoch driver and the dual-averaging beta schedule.

    ``pipeline`` is the staleness-1 overlap; ``async_epochs`` with
    ``staleness`` generalises it to AMB-DG (``staleness`` in-flight
    payloads).  The two drivers are mutually exclusive.
    """

    consensus: str = "exact"          # exact | gossip | gossip_q8 | gossip_q4
    graph: str = "ring"               # ring | torus
    gossip_rounds: int = 5
    torus_shape: Optional[Tuple[int, int]] = None
    lazy: float = 0.5
    pipeline: bool = False            # staleness-1 pipelined epochs
    async_epochs: bool = False        # AMB-DG bounded-staleness epochs
    staleness: int = 1                # D: in-flight consensus payloads
    radius: Optional[float] = None    # prox trust region (per leaf)
    beta_k: float = 50.0              # beta_mu=None defaults to the
    beta_mu: Optional[float] = None   # global batch b
    beta_scale: float = 200.0

    def beta(self, global_batch: int) -> BetaSchedule:
        mu = float(global_batch) if self.beta_mu is None else self.beta_mu
        return BetaSchedule(k=self.beta_k, mu=mu, scale=self.beta_scale)

    def to_amb_config(self, global_batch: int, seed: int = 0,
                      active: Optional[tuple] = None,
                      noise_stats: bool = False, redundancy: int = 1,
                      relayout: bool = True):
        """The dist layer's :class:`repro_torch.dist.amb.AMBConfig`."""
        from ..dist.amb import AMBConfig
        return AMBConfig(consensus=self.consensus,
                         gossip_rounds=self.gossip_rounds, graph=self.graph,
                         torus_shape=self.torus_shape, lazy=self.lazy,
                         beta=self.beta(global_batch), radius=self.radius,
                         seed=seed, active=active, noise_stats=noise_stats,
                         redundancy=redundancy, relayout=relayout)

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
        ap.add_argument("--pipeline", action="store_true",
                        help="staleness-1 pipelined epochs: overlap each "
                             "step's gossip with the next forward/backward")
        ap.add_argument("--async", dest="async_epochs", action="store_true",
                        help="AMB-DG delayed-gradient epochs: consensus "
                             "settles asynchronously with bounded "
                             "staleness (--staleness); generalizes "
                             "--pipeline beyond staleness 1")
        ap.add_argument("--staleness", type=int,
                        default=ConsensusSpec.staleness,
                        help="D: number of in-flight consensus payloads "
                             "under --async (1 = the pipelined schedule)")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ConsensusSpec":
        return cls(consensus=args.consensus, graph=args.graph,
                   gossip_rounds=args.gossip_rounds,
                   pipeline=args.pipeline,
                   async_epochs=args.async_epochs,
                   staleness=args.staleness)


@dataclasses.dataclass(frozen=True)
class ControllerSpec(_Spec):
    """Online self-tuning of budget T, staleness D and batch target b.

    When ``enabled``, :class:`repro_torch.api.AMBSession` feeds each
    epoch's telemetry (measured per-gradient times, T_c / T, the gradient
    noise scale) to a :class:`repro_torch.control.Controller`, which
    re-solves the Lemma-6 budget, retunes the AMB-DG staleness D (and
    gamma = 1/(2D)) and grows the batch target as gradient noise falls.
    Decisions are rate-limited (``max_step``), deadbanded (``deadband``),
    hysteretic (``hysteresis``), and made every ``interval`` epochs after
    ``warmup`` epochs of observation only.
    """

    enabled: bool = False
    interval: int = 5                 # epochs between decisions
    warmup: int = 5                   # observe-only epochs before deciding
    ema: float = 0.8                  # telemetry EMA smoothing
    budget: bool = True               # retune T (Lemma 6, online)
    staleness: bool = True            # retune D / gamma (async only)
    batch: bool = True                # grow the b target with the noise
    d_max: int = 8                    # staleness ceiling
    hysteresis: float = 0.25          # D-change hysteresis (T_c/T units)
    deadband: float = 0.1             # least relative budget change acted on
    max_step: float = 2.0             # most budget change factor a decision

    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        ap.add_argument("--controller", action="store_true",
                        help="enable the online self-tuning controller "
                             "(budget T, staleness D, batch target)")
        ap.add_argument("--controller-interval", type=int,
                        default=ControllerSpec.interval,
                        help="epochs between controller decisions")
        ap.add_argument("--controller-warmup", type=int,
                        default=ControllerSpec.warmup,
                        help="observe-only epochs before the first decision")
        ap.add_argument("--controller-dmax", type=int,
                        default=ControllerSpec.d_max,
                        help="staleness ceiling for the controller")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ControllerSpec":
        return cls(enabled=getattr(args, "controller", False),
                   interval=getattr(args, "controller_interval",
                                    ControllerSpec.interval),
                   warmup=getattr(args, "controller_warmup",
                                  ControllerSpec.warmup),
                   d_max=getattr(args, "controller_dmax",
                                 ControllerSpec.d_max))
