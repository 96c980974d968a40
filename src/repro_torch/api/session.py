"""``AMBSession``: the programmatic surface over the AMB epoch
(counterpart of ``repro.api.session``).

    session = AMBSession(TrainSpec(arch="qwen2-1.5b", data=4),
                         ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip"))
    source = SyntheticSource(session.cfg.vocab_size, 256, 4, 8)
    metrics = session.run(3, source)      # source defaults to batch_source()
    session.flush()
    w = session.params                    # current primal iterate

The session runs on the card unless ``device`` says otherwise, and raises
if there is none.  Each epoch the clock draws per-gradient times from a
``torch.Generator`` seeded from (seed, epoch), the deadline T decides
b_i(t), and the protocol takes one step; with ``metrics_path`` each epoch
is appended to a JSONL file.  Elastic membership, the controller,
save/restore and the prefetching data plane are not ported yet, and
:meth:`AMBSession.batch_source` is the on-device
:class:`~repro_torch.data.SyntheticSource` (the JAX session streams
``LMTokenStream`` shards, whose vocab x vocab transition matrix is 92 GB
at qwen2-1.5b width).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core.stragglers import amb_batch_sizes
from ..data import SyntheticSource
from ..device import resolve_device
from ..metrics import MetricsLogger
from ..models import DenseLM, init_params
from ..optim import DualAveragingOpt
from .clock import make_clock
from .protocol import build_protocol
from .specs import ClockSpec, ConsensusSpec, TrainSpec


class AMBSession:
    """One AMB training session on one device.

    Args:
      train, clock, consensus: the spec triple (defaults as in JAX).
      cfg: an explicit architecture config (e.g. a depth-cut one).
      params: initial parameters, a :class:`DenseLM` or a dict of tensors
        in its layout; default: random from ``train.seed``.
      device: where the session runs ("cuda" unless told otherwise).
      draw_source: ``(seed, epoch) -> draws(k, out)``, the quantized
        gossip's rounding draws; default a ``torch.Generator`` on the
        device per round (:func:`repro_torch.dist.consensus.epoch_draws`).
      metrics_path: optional JSONL path; every epoch's metrics are
        appended through :class:`repro_torch.metrics.MetricsLogger`.

    Exact consensus runs dual averaging with the spec's beta schedule and
    no trust region, as the JAX session builds it (``ConsensusSpec.radius``
    is not passed to it).
    """

    def __init__(self, train: TrainSpec, clock: Optional[ClockSpec] = None,
                 consensus: Optional[ConsensusSpec] = None, *, cfg=None,
                 params=None, device="cuda", draw_source=None,
                 metrics_path=None):
        self.device = resolve_device(device)
        self.train = train
        self.clock_spec = clock if clock is not None else ClockSpec()
        self.consensus_spec = consensus if consensus is not None \
            else ConsensusSpec()
        self.cfg = cfg if cfg is not None else (
            smoke_config(train.arch) if train.smoke
            else get_config(train.arch))
        self.n_workers = train.data
        self.global_batch = self.n_workers * train.batch_per_worker
        self.clock = make_clock(self.clock_spec, self.n_workers,
                                train.batch_per_worker)
        optimizer = None
        if self.consensus_spec.consensus == "exact":
            optimizer = DualAveragingOpt(
                beta=self.consensus_spec.beta(self.global_batch))
        self.protocol = build_protocol(
            self.cfg, self.n_workers,
            self.consensus_spec.to_amb_config(self.global_batch, train.seed),
            optimizer=optimizer, draw_source=draw_source)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(train.seed)
            params = init_params(self.cfg, gen)
        if isinstance(params, dict):
            params = DenseLM(self.cfg, params)
        self.model = params.to(self.device)
        self.state = self.protocol.init(self.model.params())
        self.steps_done = 0
        self.sim_wall = 0.0
        self.metrics = MetricsLogger(metrics_path) if metrics_path \
            else None

    def epoch_sizes(self, times: torch.Tensor, budget: float) -> torch.Tensor:
        """b_i(t) for one epoch: the deadline cut."""
        return amb_batch_sizes(times, budget)

    def step(self, batch: dict, b=None) -> dict:
        """Run one AMB epoch on a global batch; returns its metrics.

        ``b`` overrides the clock-derived (n_workers,) minibatch sizes.
        """
        gen = torch.Generator()
        gen.manual_seed(self.train.seed * 1_000_003 + 10_000
                        + self.steps_done)
        times, budget = self.clock.epoch(gen)
        if b is None:
            b = self.epoch_sizes(times, budget)
        self.sim_wall += float(budget) + self.clock_spec.comm_time
        t0 = time.perf_counter()
        self.state, m = self.protocol.step(self.state, batch, b)
        loss = float(m["loss"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_s = time.perf_counter() - t0
        global_b = float(m["global_batch"])
        self.clock.update(step_s, global_b)
        self.steps_done += 1
        out = {"loss": loss, "global_batch": global_b,
               "budget_s": float(budget), "step_s": step_s,
               "sim_wall_s": self.sim_wall,
               # JAX writes consensus_spec.staleness (default 1); the port
               # has no staleness field yet, and its epochs are not
               # pipelined, so it writes that default
               "staleness": 1,
               "b": np.asarray(torch.as_tensor(b).cpu())}
        if self.metrics is not None:
            self.metrics.log(self.steps_done,
                             **{k: v for k, v in out.items() if k != "b"})
        return out

    def batch_source(self) -> SyntheticSource:
        """The session's default input: uniform random tokens on the
        session's device, ``n_workers`` blocks of ``batch_per_worker``
        sequences of ``seq_len``, deterministic in (seed, epoch)."""
        return SyntheticSource(self.cfg.vocab_size, self.train.seq_len,
                               self.n_workers, self.train.batch_per_worker,
                               seed=self.train.seed, device=self.device)

    def run(self, steps: int, source=None, *,
            on_step=None) -> Optional[dict]:
        """Run ``steps`` epochs on ``source.batch(epoch)`` (absolute epoch
        indices from ``steps_done``; default source :meth:`batch_source`);
        returns the last epoch's metrics (None at 0 steps).
        ``on_step(epoch, metrics)`` is called after every epoch with the
        0-based absolute index of the epoch that just ran."""
        if steps <= 0:
            return None
        if source is None:
            source = self.batch_source()
        out = None
        for epoch in range(self.steps_done, self.steps_done + steps):
            out = self.step(source.batch(epoch))
            if on_step is not None:
                on_step(self.steps_done - 1, out)
        return out

    def flush(self) -> None:
        """Settle in-flight consensus (a no-op for the ported protocols)."""
        self.state = self.protocol.flush(self.state)

    def close(self) -> None:
        """Release the metrics logger (idempotent)."""
        if self.metrics is not None:
            self.metrics.close()
            self.metrics = None

    @property
    def params(self) -> dict:
        """The current primal iterate (gossip: the node-averaged prox)."""
        return self.protocol.primal(self.state)
