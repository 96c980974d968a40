"""One ``TrainProtocol`` surface over the exact and gossip steps
(counterpart of ``repro.api.protocol``, unpipelined drivers only).

    ``init(params) -> state``                     the mode's TrainState
    ``step(state, batch, b) -> (state, metrics)`` one AMB epoch
    ``flush(state) -> state``                     settle in-flight consensus
    ``primal(state) -> params``                   the current primal iterate

  * :class:`ExactProtocol` — ``{"params", "opt", "t"}``.
  * :class:`GossipProtocol` — ``{"z", "w0", "t"}``.

Steps update the state's tensors in place and return the same dict.
"""
from __future__ import annotations

from ..dist.amb import (AMBConfig, gossip_primal, make_gossip_train_step,
                        make_train_step)
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

    def __init__(self, cfg, n: int, optimizer: DualAveragingOpt):
        self.optimizer = optimizer
        self._step = make_train_step(cfg, optimizer, n)

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

    def __init__(self, cfg, n: int, amb: AMBConfig, draw_source=None):
        self.amb = amb
        self.init, self.step = make_gossip_train_step(cfg, n, amb,
                                                      draw_source)

    def primal(self, state):
        return gossip_primal(state, self.amb)


def build_protocol(cfg, n: int, amb: AMBConfig, *, optimizer=None,
                   draw_source=None) -> TrainProtocol:
    """Exact consensus runs the weighted step under ``optimizer`` (default
    dual averaging with ``amb``'s beta); any other consensus runs the
    decentralised dual-averaging protocol, whose quantized gossip takes
    its rounding draws from ``draw_source`` (see
    :func:`~repro_torch.dist.amb.make_gossip_train_step`)."""
    if amb.consensus != "exact":
        if optimizer is not None:
            raise ValueError("the gossip protocol runs the paper's dual "
                             "averaging; pass no optimizer")
        return GossipProtocol(cfg, n, amb, draw_source)
    if optimizer is None:
        optimizer = DualAveragingOpt(beta=amb.beta, radius=amb.radius)
    return ExactProtocol(cfg, n, optimizer)
