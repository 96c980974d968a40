"""AMB and FMB epoch engines (paper §3, App. A pseudocode) on one device.

Counterpart of ``repro.core.engine``.  The engine simulates ``n`` logical
workers (the paper's EC2/HPC nodes) on a simulated wall clock driven by a
:mod:`repro_torch.core.stragglers` model.  Where the JAX run is one
``lax.scan``, this one is a Python loop of epochs whose every tensor stays
on the device: each epoch's metrics are kept as device tensors and stacked
once at the end, so nothing in the loop waits for the card.

Static shapes, as in the JAX engine: each epoch has a per-node capacity
``b_max``; its data comes in ``b_max // chunk`` chunks of ``chunk``
samples per node, and sample s counts towards node i's gradient iff
``s < b_i(t)`` (eq. 3's variable minibatch).  AMB and FMB share the
consensus and dual-averaging machinery and differ only in fixed time
against fixed batch.  The eq.-7 prox runs through
:func:`repro_torch.core.dual_averaging.prox_step` (the CUDA prox kernel on
the card), the ball projection per node row.

``draws`` replaces the engine's own generator: ``draws(t)`` returns epoch
t's per-gradient times (n, b_max) and its list of data chunks, each the
objective's batch for (n, chunk) samples.  Tests pass JAX's threefry
draws through it.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import consensus as cns
from .dual_averaging import BetaSchedule, prox_step
from .stragglers import StragglerModel, amb_batch_sizes, fmb_finish_times


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shared AMB/FMB configuration."""

    n: int = 10                      # number of workers
    b_max: int = 1024                # per-node per-epoch microbatch capacity
    chunk: int = 128                 # data-generation chunk (memory knob)
    # --- AMB (fixed time) ---
    compute_time: float = 1.0        # T
    comm_time: float = 0.25          # T_c
    # --- FMB (fixed batch) ---
    fmb_batch_per_node: int = 64     # b/n
    # --- consensus ---
    graph: str = "paper"
    consensus_rounds: int = 5        # r
    consensus_mode: str = "gossip"   # "gossip" | "exact" (master-worker)
    lazy: float = 0.5
    # --- dual averaging ---
    beta: BetaSchedule = BetaSchedule()
    radius: Optional[float] = None

    def __post_init__(self):
        if self.b_max % self.chunk:
            raise ValueError("b_max must be divisible by chunk")

    def build_p(self) -> np.ndarray:
        adj = cns.build_graph(self.graph, self.n)
        lazy = cns.PAPER_GRAPH_LAZY if self.graph == "paper" else self.lazy
        return cns.metropolis_weights(adj, lazy=lazy)


@dataclasses.dataclass
class History:
    """Per-epoch traces ((epochs,) or (epochs, n) tensors on the device)."""

    wall_time: torch.Tensor          # cumulative seconds at end of epoch
    batch_sizes: torch.Tensor        # (epochs, n) b_i(t)
    global_batch: torch.Tensor       # (epochs,) b(t)
    eval_loss: torch.Tensor          # eval_fn at the node-averaged iterate
    train_loss: torch.Tensor         # mean per-sample loss, processed samples
    consensus_eps: torch.Tensor      # max_i ||z_i - z_exact|| (Lemma 1)
    regret: torch.Tensor             # cumulative sample-path regret (eq. 16)
    potential_samples: torch.Tensor  # (epochs,) c(t) = b(t) + undone a(t)


def _epoch_consensus(cfg: EngineConfig, p: torch.Tensor, z: torch.Tensor,
                     g: torch.Tensor, b: torch.Tensor) -> tuple:
    """Consensus phase: returns (z_new (n, d), eps).

    Messages are m_i = n b_i (z_i + g_i) with the scalar n b_i appended,
    so the normaliser b(t) is itself agreed by consensus (eq. 6).
    """
    n = cfg.n
    bw = b.to(z.dtype)
    msg = n * bw[:, None] * (z + g)
    msg = torch.cat([msg, n * bw[:, None]], dim=1)         # (n, d+1)
    exact = cns.exact_average(msg)
    out = exact if cfg.consensus_mode == "exact" \
        else cns.gossip(msg, p, cfg.consensus_rounds)

    def normalise(m):
        return m[:, :-1] / torch.clamp(m[:, -1:], min=1e-12)

    z_new = normalise(out)
    eps = torch.linalg.vector_norm(z_new - normalise(exact), dim=1).max()
    return z_new, eps


def _masked_grads(objective, w: torch.Tensor, b: torch.Tensor,
                  cfg: EngineConfig, chunks) -> tuple:
    """Per-node masked gradient means and per-sample loss sums.

    ``chunks`` yields the epoch's data chunk by chunk, so the peak memory
    is one (n, chunk, dim) chunk whatever b_max is.  Returns (g (n, d),
    loss_sum (n,)).
    """
    n = w.shape[0]
    gsum = torch.zeros_like(w)
    lsum = torch.zeros((n,), dtype=w.dtype, device=w.device)
    for c, batch in enumerate(chunks):
        idx = c * cfg.chunk + torch.arange(cfg.chunk, device=w.device)
        mask = (idx[None, :] < b[:, None]).to(w.dtype)     # (n, chunk)
        gs, ls = objective.masked_sums(w, batch, mask)
        gsum = gsum + gs
        lsum = lsum + ls
    denom = torch.clamp(b.to(w.dtype), min=1.0)
    return gsum / denom[:, None], lsum


def _prox_rows(z: torch.Tensor, beta: float,
               radius: Optional[float]) -> torch.Tensor:
    """Each node's prox; the ball projection per row, as JAX vmaps it."""
    w = prox_step(z, beta)
    if radius is not None:
        nrm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        w = w * torch.clamp(radius / torch.clamp(nrm, min=1e-30), max=1.0)
    return w


def _common_epoch(cfg: EngineConfig, objective, p, w, z, t: int, b, chunks,
                  f_star: float, a) -> tuple:
    """Gradient + consensus + update shared by AMB and FMB.

    ``a`` is the per-node count of *additional* gradients the node could
    have computed during the communication phase (the paper's a_i(t)); the
    regret estimate charges those at the node's mean per-sample loss.
    """
    g, lsum = _masked_grads(objective, w, b, cfg, chunks)
    z_new, eps = _epoch_consensus(cfg, p, z, g, b)
    w_new = _prox_rows(z_new, cfg.beta(t + 1), cfg.radius)

    bf = b.to(w.dtype)
    mean_loss = lsum / torch.clamp(bf, min=1.0)
    c = bf + a.to(w.dtype)
    metrics = dict(
        batch_sizes=b,
        global_batch=b.sum().to(torch.int32),
        train_loss=lsum.sum() / torch.clamp(bf.sum(), min=1.0),
        consensus_eps=eps,
        regret_inc=torch.sum(lsum + a * mean_loss - c * f_star),
        potential=c.sum(),
    )
    return w_new, z_new, metrics


def _to(batch, device):
    return tuple(torch.as_tensor(x, device=device) for x in batch)


def _setup(cfg: EngineConfig, objective, generator, draws, device) -> tuple:
    """(device, generator, P, the zero (n, d) iterate) of a run: a given
    generator's device is the run's; without draws the default generator
    is seeded 0 on ``device``."""
    if generator is not None:
        device = generator.device
    device = resolve_device(device)
    if generator is None and draws is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    p = torch.tensor(cfg.build_p(), dtype=torch.float32, device=device)
    d = objective.init_w().shape[0]
    zeros = torch.zeros((cfg.n, d), dtype=torch.float32, device=device)
    return device, generator, p, zeros


def _chunks(objective, generator, cfg: EngineConfig, sample_args):
    """An epoch's data drawn from ``generator``, chunk by chunk."""
    return (objective.sample(generator, (cfg.n, cfg.chunk), *sample_args)
            for _ in range(cfg.b_max // cfg.chunk))


def _eval(eval_fn, w: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    return zero if eval_fn is None \
        else torch.as_tensor(eval_fn(w.mean(0)), device=w.device)


def _history(trace: list) -> History:
    """Stack the epochs' metric dicts into a :class:`History`."""
    def stacked(key):
        return torch.stack([m[key] for m in trace])

    return History(
        wall_time=stacked("wall_time"),
        batch_sizes=stacked("batch_sizes"),
        global_batch=stacked("global_batch"),
        eval_loss=stacked("eval_loss"),
        train_loss=stacked("train_loss"),
        consensus_eps=stacked("consensus_eps"),
        regret=torch.cumsum(stacked("regret_inc"), dim=0),
        potential_samples=stacked("potential"),
    )


def run(objective, model: StragglerModel, cfg: EngineConfig, *, mode: str,
        epochs: int, generator: Optional[torch.Generator] = None,
        sample_args=(), eval_fn: Optional[Callable] = None,
        f_star: float = 0.0, draws: Optional[Callable] = None,
        device="cuda") -> History:
    """Run AMB (``mode="amb"``) or FMB (``mode="fmb"``) for ``epochs``
    epochs.

    Draws come from ``generator`` (default: seeded 0 on ``device``; a
    given generator's device is the run's) or, when given, from
    ``draws(t)`` for t = 1..epochs (see the module docstring).
    """
    if mode not in ("amb", "fmb"):
        raise ValueError(mode)
    device, generator, p, zeros = _setup(cfg, objective, generator, draws,
                                         device)
    n = cfg.n
    w, z = zeros, zeros                                            # eq. 2
    clock = torch.zeros((), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    trace = []
    for t in range(1, epochs + 1):
        if draws is not None:
            times, data = draws(t)
            times = torch.as_tensor(times, device=device)
            chunks = (_to(batch, device) for batch in data)
        else:
            times = model.per_gradient_times(generator, n, cfg.b_max)
            chunks = _chunks(objective, generator, cfg, sample_args)

        if mode == "amb":
            b = amb_batch_sizes(times, cfg.compute_time)
            # a_i(t): extra gradients that fit inside the comm window T_c
            a = amb_batch_sizes(times, cfg.compute_time + cfg.comm_time) - b
            epoch_time = cfg.compute_time + cfg.comm_time
        else:
            b = torch.full((n,), cfg.fmb_batch_per_node, dtype=torch.int32,
                           device=device)
            finish = fmb_finish_times(times, cfg.fmb_batch_per_node)
            a = torch.zeros((n,), dtype=torch.int32, device=device)
            epoch_time = finish.max() + cfg.comm_time

        w, z, m = _common_epoch(cfg, objective, p, w, z, t, b, chunks,
                                f_star, a)
        clock = clock + epoch_time
        m["wall_time"] = clock
        m["eval_loss"] = _eval(eval_fn, w, zero)
        trace.append(m)
    return _history(trace)


run_amb = partial(run, mode="amb")
run_fmb = partial(run, mode="fmb")
