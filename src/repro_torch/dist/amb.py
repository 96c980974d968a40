"""The AMB train steps with the worker dim on one device (paper §3).

Counterpart of ``repro.dist.amb``:

  * :func:`make_train_step` — *exact consensus* (eps = 0): one weighted
    loss over the global batch, whose gradient is exactly
    ``sum_i b_i g_i / sum_i b_i``, then the optimizer's update.
  * :func:`make_gossip_train_step` — *decentralised consensus*: worker i
    keeps its own dual ``z_i``, takes its masked gradient at its own primal
    ``w_i = prox(z_i)``, packs ``n b_i (z_i + g_i)`` with the scalar
    ``n b_i`` appended (eq. 6), and the stack goes through the consensus
    strategy (exact, fp32 gossip, or quantized gossip with the epoch's
    rounding draws from ``(seed, t)``).

The pipelined and async drivers (:mod:`repro_torch.dist.pipeline`,
:mod:`repro_torch.dist.async_epochs`) share this module's per-worker
gradient, its row-wise settle and its gradient-noise statistics.
``AMBConfig.active`` masks workers out of the gossip operator (elastic
membership; the session also zeroes their b_i), and :func:`gossip_primal`
then averages only the active duals.  ``AMBConfig.redundancy`` > 1 is
coded placement (:mod:`repro_torch.dist.redundancy`): the eq.-3 0/1
weights become ``1/copies`` decode weights and b(t) counts distinct
samples.  ``AMBConfig.noise_stats`` adds ``grad_sq_norm`` and
``grad_var`` to the decentralised steps' metrics (:class:`NoiseStats`).

The workers are the leading dim of each state tensor.  Where the JAX step
vmaps the workers' gradients, a Python loop takes them one at a time and
writes each worker's message row as soon as its gradient exists, so one
worker's activations and gradient are live at a time.  The gossip rounds
reuse the message stack (fp32 gossip: as one of two round buffers;
quantized gossip: as the round's output), and the dual is updated in
place.

One process per worker: given a :class:`~repro_torch.dist.group.
WorkerGroup` (``group=``), each step runs this process's worker only, on
its rows of the global batch (rows ``[r*per, (r+1)*per)`` of worker r).
The exact step backpropagates the worker's share of the weighted loss,
whose denominator is the global one (summed across the workers before
the backward), sums the gradients across the workers in flat fp32
buckets and runs the optimizer identically on every rank, so the
parameters stay equal.  The gossip step holds only the worker's dual
row (each ``z`` leaf is (1, *param)) and runs the strategy's
:meth:`~repro_torch.dist.consensus.ConsensusStrategy.combine_rank`.
The losses and :func:`gossip_primal` sum across the workers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.dual_averaging import BetaSchedule
from ..kernels import ops as kops
from ..models import lm_loss
from .consensus import OVER_GROUP_TODO, epoch_draws, make_strategy
from .redundancy import (CodedAssignment, epoch_weights,  # noqa: F401
                         seq_weights_from_b)


@dataclasses.dataclass(frozen=True)
class AMBConfig:
    """Static AMB step configuration (consensus + dual-averaging knobs)."""

    consensus: str = "exact"          # exact | gossip | gossip_q8 | gossip_q4
    gossip_rounds: int = 5
    graph: str = "ring"
    torus_shape: Optional[tuple] = None
    lazy: float = 0.5
    beta: BetaSchedule = BetaSchedule()   # gossip-path dual averaging
    radius: Optional[float] = None
    seed: int = 0                     # quantized-gossip rounding draws
    active: Optional[tuple] = None    # elastic worker mask (None = all)
    noise_stats: bool = False         # grad_sq_norm / grad_var metrics for
                                      # the controller's telemetry (opt-in:
                                      # an epoch without it is unchanged)
    redundancy: int = 1               # rho: coded data replication (1 =
                                      # uncoded, the eq.-3 weights)
    relayout: bool = True             # survivors on a fresh ring/torus
                                      # (taps) instead of the dense masked
                                      # P @ m


def strategy_from_config(amb: AMBConfig, n: int):
    """The configured consensus strategy for ``n`` workers."""
    return make_strategy(amb.consensus, n, rounds=amb.gossip_rounds,
                         graph=amb.graph, lazy=amb.lazy,
                         torus_shape=amb.torus_shape, active=amb.active,
                         relayout=amb.relayout)


def assignment_from_config(amb: AMBConfig,
                           n: int) -> Optional[CodedAssignment]:
    """The coded data placement, or None for the uncoded path."""
    if amb.redundancy <= 1:
        return None
    return CodedAssignment(n, amb.redundancy)


def _as_b(b, device) -> torch.Tensor:
    return torch.as_tensor(b, dtype=torch.int32).to(device)


def _grads(total: torch.Tensor, params: dict) -> tuple:
    """d total / d each leaf, zeros for a leaf the loss does not read (a
    batch of ``"embeds"`` does not read the embedding), as JAX's."""
    return torch.autograd.grad(total, list(params.values()),
                               allow_unused=True, materialize_grads=True)


def first_leaf(batch: dict) -> torch.Tensor:
    """The batch's first leaf in JAX's order (sorted keys): its size and
    device are the batch's, whatever its keys (``{"embeds", "labels"}``
    carries no tokens)."""
    return batch[min(batch)]


# ---------------------------------------------------------------------------
# Message pack / unpack
# ---------------------------------------------------------------------------

def _pack_row(row: torch.Tensor, z_leaves, g_leaves, nb_i) -> None:
    """Write ``nb_i (z + g)`` leaf after leaf, then ``nb_i``, into ``row``."""
    off = 0
    for zl, gl in zip(z_leaves, g_leaves):
        size = zl.numel()
        row[off:off + size] = (nb_i * (zl + gl.float())).reshape(-1)
        off += size
    row[off] = nb_i


def msg_width(z: dict, n: int) -> int:
    """The payload's width: every dual element of a worker, plus one."""
    return sum(zl.numel() // n for zl in z.values()) + 1


def pack_messages(z: dict, grads: dict, nb: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(n, D+1) fp32 rows ``n b_i (z_i + g_i)`` with ``n b_i`` appended.

    z / grads: dicts of (n, *param) leaves; nb: (n,).
    """
    msg = torch.empty((n, msg_width(z, n)), dtype=torch.float32,
                      device=nb.device)
    for i in range(n):
        _pack_row(msg[i], [zl[i] for zl in z.values()],
                  [grads[k][i] for k in z], nb[i])
    return msg


def flatten_dual(z: dict, n: int) -> torch.Tensor:
    """(n, W) row stack of a dual dict: the message layout without the
    weight column."""
    return torch.cat([zl.reshape(n, -1) for zl in z.values()], dim=1)


def unflatten_dual(flat: torch.Tensor, z: dict, n: int) -> dict:
    """Invert :func:`flatten_dual` onto the keys and shapes of ``z``."""
    out, off = {}, 0
    for k, zl in z.items():
        size = zl.numel() // n
        out[k] = flat[:, off:off + size].reshape(zl.shape)
        off += size
    return out


@torch.no_grad()
def settle_row(agreed: torch.Tensor, z: dict, i: int,
               snapshot: Optional[torch.Tensor] = None,
               gamma: float = 1.0) -> None:
    """Fold row i of a consensus output into worker i's dual, in place.

    Without ``snapshot`` it is :func:`unpack_duals` on one row (the
    replacement); with the (W,) ``snapshot`` the row was packed on, the
    async increment ``z_i + (agreed_i - gamma snapshot_i)``.  A row whose
    neighbourhood processed no samples (weight column <= 1e-6) leaves z_i
    as it is in both forms.
    """
    col = agreed[-1:]
    keep = col > 1e-6
    denom = torch.clamp(col, min=1e-12)
    off = 0
    for zl in z.values():
        flat = zl[i].view(-1)
        size = flat.numel()
        got = agreed[off:off + size] / denom
        if snapshot is None:
            flat.copy_(torch.where(keep, got, flat))
        else:
            flat.copy_(flat + torch.where(
                keep, got - gamma * snapshot[off:off + size], 0.0))
        off += size


@torch.no_grad()
def unpack_duals(out: torch.Tensor, z: dict, n: int) -> dict:
    """Invert :func:`pack_messages` on a consensus output, into ``z`` in
    place (returned).  Rows are divided by the agreed scalar column; a
    worker whose neighbourhood processed no samples (column <= 1e-6) keeps
    its dual, as a zero gradient leaves z alone on the exact path."""
    col = out[:, -1:]
    keep = col > 1e-6
    denom = torch.clamp(col, min=1e-12)
    off = 0
    for zl in z.values():
        flat = zl.view(n, -1)
        size = flat.shape[1]
        flat.copy_(torch.where(keep, out[:, off:off + size] / denom, flat))
        off += size
    return z


# ---------------------------------------------------------------------------
# Exact-consensus train step (eps = 0)
# ---------------------------------------------------------------------------

def _refuse_over_group(amb: AMBConfig, cfg=None) -> None:
    """What one process per worker does not run yet."""
    if amb.consensus in ("gossip_q8", "gossip_q4"):
        raise NotImplementedError(
            f"{amb.consensus} over a process group is not ported yet: its "
            f"wire must pack the levels before a send ({OVER_GROUP_TODO})")
    if amb.redundancy > 1:
        raise NotImplementedError(f"coded redundancy over a process group "
                                  f"is not ported yet ({OVER_GROUP_TODO})")
    if amb.noise_stats:
        raise NotImplementedError(f"the controller's noise statistics over "
                                  f"a process group are not ported yet "
                                  f"({OVER_GROUP_TODO})")
    if cfg is not None and cfg.is_moe:
        raise NotImplementedError(
            f"the MoE exact step over a process group is not ported yet: "
            f"its aux is taken over the global routing statistics "
            f"({OVER_GROUP_TODO})")


def _rank_train_step(cfg, opt, n: int, group):
    """The exact step of one process per worker (see the module note)."""
    r = group.worker

    def step(params, opt_state, batch, b):
        lead = first_leaf(batch)
        per = lead.shape[0]
        b = _as_b(b, lead.device)
        sw = seq_weights_from_b(b, per * n, n)[r * per:(r + 1) * per]
        gbatch = torch.clamp(b, max=per).sum()
        mask = (batch["labels"] >= 0).float()
        denom = torch.clamp(group.sum_scalar((mask * sw[:, None]).sum()),
                            min=1.0)
        with torch.enable_grad():
            total, m = lm_loss(params, cfg, batch, sw, denom=denom)
            grads = _grads(total, params)
        group.all_reduce_(grads)
        opt_state = opt.apply(dict(zip(params, grads)), opt_state, params)
        metrics = {"loss": group.sum_scalar(m["loss"]),
                   "aux": m["aux"].detach(), "ntok": denom,
                   "global_batch": gbatch}
        return params, opt_state, metrics

    return step


def make_train_step(cfg, opt, n: int, amb: AMBConfig = AMBConfig(),
                    group=None):
    """step(params, opt_state, batch, b) -> (params, opt_state, metrics).

    ``params`` is a dict of tensors that require grad (a
    :class:`repro_torch.models.DenseLM`'s ``params()``); ``batch`` the
    global batch in n contiguous worker blocks (with ``group``, this
    worker's block); ``b`` the (n,) minibatch sizes of this epoch.
    ``opt`` updates params and its state in place.  Under coded
    redundancy (``amb.redundancy > 1``) the weights are the ``1/copies``
    decode weights and ``global_batch`` counts distinct covered samples.
    """
    if group is not None:
        _refuse_over_group(amb, cfg)
        return _rank_train_step(cfg, opt, n, group)
    assignment = assignment_from_config(amb, n)

    def step(params, opt_state, batch, b):
        lead = first_leaf(batch)
        gb = lead.shape[0]
        per = gb // n
        b = _as_b(b, lead.device)
        if assignment is None:
            sw = seq_weights_from_b(b, gb, n)
            gbatch = torch.clamp(b, max=per).sum()
        else:
            sw2, bw = epoch_weights(b, n, per, assignment)
            sw, gbatch = sw2.reshape(gb), bw.sum()
        with torch.enable_grad():
            total, m = lm_loss(params, cfg, batch, sw)
            grads = _grads(total, params)
        opt_state = opt.apply(dict(zip(params, grads)), opt_state, params)
        metrics = {"loss": m["loss"].detach(), "aux": m["aux"].detach(),
                   "ntok": m["ntok"], "global_batch": gbatch}
        return params, opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# Decentralised gossip train step (per-worker dual replicas)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _prox_leaf(z_leaf, w0_leaf, beta_t: float, radius: Optional[float]):
    """Eq.-7 prox with h(w) = ||w - w0||^2: fp32 math, w0's dtype out."""
    return kops.dual_update(z_leaf, w0_leaf, beta_t, radius).to(w0_leaf.dtype)


def local_grad(cfg, z: dict, w0: dict, batch: dict, sw: torch.Tensor,
               beta_t: float, radius: Optional[float], i: int,
               per: int) -> tuple:
    """Worker i's masked gradient at its own primal ``prox(z_i)``: (the
    gradient leaves in ``w0``'s order, the detached loss)."""
    p_i = {k: _prox_leaf(z[k][i], w, beta_t, radius).requires_grad_()
           for k, w in w0.items()}
    batch_i = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
    with torch.enable_grad():
        total, m = lm_loss(p_i, cfg, batch_i, sw[i])
        g_i = _grads(total, p_i)
    return g_i, m["loss"].detach()


class NoiseStats:
    """:func:`grad_noise_stats` in one pass over gradients given one
    worker at a time, so no two workers' gradients are ever held.

    ``w = bw / max(sum bw, 1)`` is known before the loop (it need not
    sum to 1: a worker of a coded group weighs 1/copies, and all of them
    may be 0).  A weighted running mean (West's update: one (W,) fp32
    buffer) gives ``mu = sum_i w_i g_i / S`` with ``S = sum_i w_i``, and
    a scalar ``M2 = sum_i w_i ||g_i - mu||^2`` accumulated in fp64 on the
    device.  With ``gbar = S mu``:

        ||gbar||^2                 = S^2 ||mu||^2
        sum_i w_i ||g_i - gbar||^2 = M2 + S (1 - S)^2 ||mu||^2

    JAX's definition exactly, without the cancelling form
    ``sum_i w_i ||g_i||^2 - ||gbar||^2``.
    """

    def __init__(self, bw: torch.Tensor, like: dict, n: int):
        w = bw.float() / torch.clamp(bw.float().sum(), min=1.0)
        self.w = [float(x) for x in w.tolist()]
        self.seen = 0.0
        device = bw.device
        self.sizes = [zl.numel() // n for zl in like.values()]
        self.mean = torch.zeros((sum(self.sizes),), dtype=torch.float32,
                                device=device)
        self.m2 = torch.zeros((), dtype=torch.float64, device=device)

    @torch.no_grad()
    def add(self, i: int, grads) -> None:
        """Fold worker i's gradient leaves (in the dual's order)."""
        wi = self.w[i]
        if wi <= 0.0:
            return
        before = self.seen
        self.seen += wi
        off = 0
        for size, g in zip(self.sizes, grads):
            mu = self.mean[off:off + size]
            delta = g.reshape(-1).float()
            delta.sub_(mu)
            self.m2 += (wi * before / self.seen) * torch.dot(
                delta, delta).double()
            mu.add_(delta, alpha=wi / self.seen)
            off += size
            del delta

    def result(self) -> dict:
        """``grad_sq_norm`` and ``grad_var`` (fp64 scalars on the device);
        the running mean is released."""
        s = self.seen
        mu2 = torch.dot(self.mean, self.mean).double()
        self.mean = None
        return {"grad_sq_norm": s * s * mu2,
                "grad_var": self.m2 + s * (1.0 - s) ** 2 * mu2}


def grad_noise_stats(grads: dict, bw: torch.Tensor) -> dict:
    """Gradient-noise signals from per-worker mean gradients (dict of (n,
    *param) leaves) and the (n,) effective sample counts, for
    :mod:`repro_torch.control.telemetry`:

      * ``grad_sq_norm`` — ``||gbar||^2`` of the eq.-6 weighted mean
        ``gbar = sum_i w_i g_i``, ``w = bw / max(sum bw, 1)``;
      * ``grad_var`` — ``sum_i w_i ||g_i - gbar||^2``, the between-worker
        dispersion, expectation ``tr(Sigma) (n-1)/B``.

    The steps fold each worker's gradient as it is made
    (:class:`NoiseStats`); this is the same pass over a stack."""
    n = bw.shape[0]
    stats = NoiseStats(bw, grads, n)
    for i in range(n):
        stats.add(i, [g[i] for g in grads.values()])
    return stats.result()


def epoch_metrics(bw: torch.Tensor, losses: list, beta, t: int,
                  stats: Optional[NoiseStats] = None) -> dict:
    """The decentralised step's metrics: the b-weighted loss, b(t), the
    next epoch's beta and, with ``stats``, the noise statistics (call it
    before the consensus: it releases the running mean)."""
    losses = torch.stack(losses)
    bsum = torch.clamp(bw.sum(), min=1.0)
    out = {"loss": (bw * losses).sum() / bsum, "global_batch": bw.sum(),
           "beta": beta(t + 2)}
    if stats is not None:
        out.update(stats.result())
    return out


def init_gossip_state(params: dict, n: int) -> dict:
    """Per-worker zero duals (fp32), the prox anchor and the epoch count."""
    return {"z": {k: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                                 device=p.device)
                  for k, p in params.items()},
            "w0": {k: p.detach() for k, p in params.items()},
            "t": 0}


def _rank_gossip_step(cfg, n: int, amb: AMBConfig, draw_source, group):
    """(init_state, step) of one process per worker (see the module note):
    the state holds this worker's dual row."""
    beta, radius = amb.beta, amb.radius
    strategy = strategy_from_config(amb, n)
    r = group.worker

    def init_state(params: dict) -> dict:
        return init_gossip_state(params, 1)

    def step(state, batch, b):
        lead = first_leaf(batch)
        device, per = lead.device, lead.shape[0]
        t = state["t"]
        beta_t = beta(t + 1)
        sw, bw = epoch_weights(_as_b(b, device), n, per)
        z, w0 = state["z"], state["w0"]
        g, loss = local_grad(cfg, z, w0, batch, sw[r:r + 1], beta_t, radius,
                             0, per)
        buf = strategy.rank_buffer(msg_width(z, 1), device)
        with torch.no_grad():
            _pack_row(buf[0], [zl[0] for zl in z.values()], g, n * bw[r])
        del g
        losses = torch.zeros((n,), dtype=torch.float32, device=device)
        losses[r] = loss
        group.all_reduce_([losses])
        metrics = epoch_metrics(bw, list(losses.unbind(0)), beta, t)
        out = strategy.combine_rank(buf, group,
                                    draws=(draw_source or epoch_draws)(
                                        amb.seed, t))
        del buf
        unpack_duals(out, z, 1)
        state["t"] = t + 1
        return state, metrics

    return init_state, step


def make_gossip_train_step(cfg, n: int, amb: AMBConfig,
                           draw_source: Optional[Callable] = None,
                           group=None):
    """Returns (init_state, step) for the decentralised AMB protocol.

    State: ``z`` — per-worker duals, each leaf (n, *param) fp32 (with
    ``group``, this worker's (1, *param) row); ``w0`` — the shared initial
    parameters (prox anchor, their own dtypes); ``t`` — the epoch count.
    step(state, batch, b) -> (state, metrics).  ``draw_source(seed, t)``
    gives epoch t's quantized-gossip rounding draws (default
    :func:`~repro_torch.dist.consensus.epoch_draws`).
    """
    if group is not None:
        _refuse_over_group(amb)
        return _rank_gossip_step(cfg, n, amb, draw_source, group)
    beta, radius = amb.beta, amb.radius
    draw_source = draw_source or epoch_draws
    strategy = strategy_from_config(amb, n)
    assignment = assignment_from_config(amb, n)

    def init_state(params: dict) -> dict:
        return init_gossip_state(params, n)

    def step(state, batch, b):
        lead = first_leaf(batch)
        device, per = lead.device, lead.shape[0] // n
        t = state["t"]
        beta_t = beta(t + 1)                 # beta used for w(t)
        sw, bw = epoch_weights(_as_b(b, device), n, per, assignment)
        nb = n * bw
        z, w0 = state["z"], state["w0"]
        stats = NoiseStats(bw, z, n) if amb.noise_stats else None
        msg = torch.empty((n, msg_width(z, n)), dtype=torch.float32,
                          device=device)
        losses = []
        for i in range(n):
            g_i, loss = local_grad(cfg, z, w0, batch, sw, beta_t, radius, i,
                                   per)
            with torch.no_grad():
                _pack_row(msg[i], [zl[i] for zl in z.values()], g_i, nb[i])
            if stats is not None:
                stats.add(i, g_i)
            losses.append(loss)
            del g_i
        metrics = epoch_metrics(bw, losses, beta, t, stats)
        del stats
        out = strategy.combine(msg, draws=draw_source(amb.seed, t))
        del msg
        unpack_duals(out, z, n)
        del out
        state["t"] = t + 1
        return state, metrics

    return init_state, step


def gossip_primal(state: dict, amb: AMBConfig, group=None) -> dict:
    """Node-averaged primal: the train step's prox on the worker-mean dual.

    Under an elastic ``amb.active`` mask only the active workers' duals
    are averaged: a departed worker's dual is frozen at its leave-time
    value and would bias the iterate away from the active set's.  With
    ``group`` the mean is a sum across the workers (every rank must call
    it), one leaf at a time."""
    beta_t = amb.beta(state["t"] + 1)
    if group is not None:
        def zbar(zl):
            total = zl[0].clone()
            group.all_reduce_([total])
            return total.div_(float(group.n))
    elif amb.active is None:
        def zbar(zl):
            return zl.mean(dim=0)
    else:
        w = np.asarray(amb.active, np.float32)
        w = w / w.sum()

        def zbar(zl):
            return torch.tensordot(torch.as_tensor(w, device=zl.device), zl,
                                   dims=([0], [0]))
    return {k: _prox_leaf(zbar(state["z"][k]), w, beta_t, amb.radius)
            for k, w in state["w0"].items()}
