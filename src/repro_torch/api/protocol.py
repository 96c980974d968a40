"""One ``TrainProtocol`` surface over the exact, gossip, pipelined and
async steps (counterpart of ``repro.api.protocol``).

    ``init(params) -> state``                     the mode's TrainState
    ``step(state, batch, b) -> (state, metrics)`` one AMB epoch
    ``flush(state) -> state``                     settle in-flight consensus
    ``primal(state) -> params``                   the current primal iterate

  * :class:`ExactProtocol` — ``{"params", "opt", "t"}``.
  * :class:`GossipProtocol` — ``{"z", "w0", "t"}``.
  * :class:`PipelinedProtocol` — the gossip state and ``"pending"``.
  * :class:`AsyncProtocol` — the gossip state, ``"queue"`` and, for
    staleness > 1, ``"snaps"``.

Steps update the state's tensors in place and return the same dict.
With a :class:`~repro_torch.dist.group.WorkerGroup` (one process per
worker) the exact and gossip protocols run this process's worker; the
pipelined and async drivers are not ported over a group yet (ROADMAP.md,
module item 4b) and are refused.
"""
from __future__ import annotations

from ..dist.amb import (AMBConfig, gossip_primal, make_gossip_train_step,
                        make_train_step)
from ..dist.async_epochs import make_async_gossip_train_step
from ..dist.consensus import OVER_GROUP_TODO
from ..dist.pipeline import make_pipelined_gossip_train_step
from ..optim import DualAveragingOpt


class TrainProtocol:
    mode: str = "base"

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    def step(self, state: dict, batch: dict, b) -> tuple:
        raise NotImplementedError

    def flush(self, state: dict) -> dict:
        """Settle in-flight consensus; identity for unpipelined modes."""
        return state

    def primal(self, state: dict) -> dict:
        raise NotImplementedError


class ExactProtocol(TrainProtocol):
    """eps = 0 exact consensus under dual averaging.  State: params/opt/t."""

    mode = "exact"

    def __init__(self, cfg, n: int, optimizer: DualAveragingOpt,
                 amb: AMBConfig = AMBConfig(), group=None):
        self.amb = amb
        self.optimizer = optimizer
        self._step = make_train_step(cfg, optimizer, n, amb, group)

    def init(self, params):
        return {"params": params, "opt": self.optimizer.init(params), "t": 0}

    def step(self, state, batch, b):
        _, _, metrics = self._step(state["params"], state["opt"], batch, b)
        state["t"] += 1
        return state, metrics

    def primal(self, state):
        return state["params"]


class GossipProtocol(TrainProtocol):
    """Decentralised consensus, per-worker duals.  State: z/w0/t."""

    mode = "gossip"

    def __init__(self, cfg, n: int, amb: AMBConfig, draw_source=None,
                 group=None):
        self.amb = amb
        self.group = group
        self.init, self.step = make_gossip_train_step(cfg, n, amb,
                                                      draw_source, group)

    def primal(self, state):
        return gossip_primal(state, self.amb, self.group)


class PipelinedProtocol(TrainProtocol):
    """Staleness-1 pipelined epochs.  State: z/w0/t/pending."""

    mode = "pipelined"

    def __init__(self, cfg, n: int, amb: AMBConfig, draw_source=None):
        self.amb = amb
        self.init, self.step, self.flush = make_pipelined_gossip_train_step(
            cfg, n, amb, draw_source)

    def primal(self, state):
        return gossip_primal(state, self.amb)


class AsyncProtocol(TrainProtocol):
    """AMB-DG bounded-staleness epochs.  State: z/w0/t/queue (and snaps).

    ``queue`` holds ``staleness`` in-flight payloads, oldest first; each
    step settles the due head, takes delayed gradients at the last settled
    dual and enqueues at the tail; ``flush`` drains the whole queue.
    """

    mode = "async"

    def __init__(self, cfg, n: int, amb: AMBConfig, staleness: int = 1,
                 draw_source=None):
        self.amb = amb
        self.staleness = staleness
        self.init, self.step, self.flush = make_async_gossip_train_step(
            cfg, n, amb, staleness, draw_source)

    def primal(self, state):
        return gossip_primal(state, self.amb)


def build_protocol(cfg, n: int, amb: AMBConfig, *, optimizer=None,
                   pipeline: bool = False, async_epochs: bool = False,
                   staleness: int = 1, draw_source=None,
                   group=None) -> TrainProtocol:
    """The protocol for (consensus, driver, optimizer), by JAX's rules.

    ``pipeline``, ``async_epochs`` or a non-exact consensus selects the
    decentralised dual-averaging family (per-worker duals; quantized
    gossip takes its rounding draws from ``draw_source``, see
    :func:`~repro_torch.dist.amb.make_gossip_train_step`); exact consensus
    without either driver runs the weighted step under ``optimizer``
    (default dual averaging with ``amb``'s beta).  ``async_epochs``
    generalises ``pipeline`` to ``staleness`` in-flight payloads; the two
    are mutually exclusive.  Elastic membership rides on ``amb.active``.
    ``group`` runs the exact or gossip protocol one process per worker.
    """
    if pipeline and async_epochs:
        raise ValueError("--pipeline is the hardcoded staleness-1 driver; "
                         "--async generalizes it — choose one (async with "
                         "staleness 1 is the pipelined schedule)")
    if staleness != 1 and not async_epochs:
        raise ValueError(f"staleness={staleness} is the async driver's "
                         "knob; pass --async (async_epochs=True) — "
                         "without it the staleness would be silently "
                         "ignored")
    decentralized = pipeline or async_epochs or amb.consensus != "exact"
    if decentralized and optimizer is not None and \
            not isinstance(optimizer, DualAveragingOpt):
        raise ValueError("gossip / pipelined / async modes run the paper's "
                         "dual-averaging protocol; use the dual_averaging "
                         "optimizer")
    if group is not None and (pipeline or async_epochs):
        raise NotImplementedError(
            f"the {'async' if async_epochs else 'pipelined'} driver over a "
            f"process group is not ported yet ({OVER_GROUP_TODO})")
    if async_epochs:
        return AsyncProtocol(cfg, n, amb, staleness, draw_source)
    if pipeline:
        return PipelinedProtocol(cfg, n, amb, draw_source)
    if amb.consensus != "exact":
        return GossipProtocol(cfg, n, amb, draw_source, group)
    if optimizer is None:
        optimizer = DualAveragingOpt(beta=amb.beta, radius=amb.radius)
    return ExactProtocol(cfg, n, optimizer, amb, group)
