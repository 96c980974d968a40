"""Bounded-staleness delayed-gradient AMB epochs (AMB-DG; counterpart of
``repro.dist.async_epochs``).

:mod:`repro_torch.dist.pipeline` keeps one consensus in flight.  The
AMB-DG follow-up ("Anytime Minibatch with Delayed Gradients", Al-Lawati
& Draper; see PAPERS.md) shows dual averaging tolerates D-epoch-stale
gradients, so a consensus that needs D compute windows can still be
hidden.  One step of epoch t with a FIFO of D payloads:

  1. **settle** the due payload, enqueued at epoch ``t - D``, under the
     rounding draws of that epoch (``draw_source(seed, t - D)``; negative
     for the first D zero payloads, which settle as no-ops);
  2. take the gradients at the last settled dual (staleness D);
  3. **enqueue** this epoch's payload at the tail.

**The settle is an increment, with damped mixing.**  A payload was packed
on the dual of its enqueue epoch, and the D - 1 settles while it was in
flight have moved the dual since, so replacing the dual would split it
into D interleaved chains.  The payload carries a damped dual term,
``n b_i (gamma z_i + g_i)`` with ``gamma = 1 / (2 D)``, each slot keeps a
snapshot of the dual it was packed on, and the settle is

    z_i  <-  z_i + (agreed_i - gamma snapshot_i).

At D = 1, gamma = 1 and the settle is the plain replacement through the
same code as the pipelined driver, so the two agree bit for bit.

The queue is D preallocated payload slots (and, for D > 1, D snapshot
slots) kept oldest first; a step rotates the list of slots, not their
contents.  As in the pipelined driver the due payload's consensus output
becomes the new tail: worker i's agreed row is settled right after worker
i's gradient and then overwritten with its new payload, and the snapshot
slot just consumed takes the fresh dual.  ``flush`` settles every slot
oldest first, each under its own enqueue epoch's draws, zeroes the slots
in place, and does not advance ``t``.

One process per worker (``group=``): the queue's slots are this worker's
(1, W+1) payload rows and the snapshots its (1, W) dual rows; each settle
is :meth:`~repro_torch.dist.consensus.ConsensusStrategy.combine_rank`
under the enqueue epoch's draws, and the agreed row becomes the new tail.
Over a model axis (``tp``) the slots and snapshots hold this rank's
blocks of its worker's rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .amb import (AMBConfig, NoiseStats, RankEpoch, _as_b, _pack_row,
                  assignment_from_config, epoch_metrics, epoch_weights,
                  first_leaf, init_gossip_state, local_grad, msg_width,
                  rank_losses, settle_row, strategy_from_config)
from .consensus import epoch_draws


def _init_queue(state: dict, rows: int, staleness: int) -> dict:
    """The D zero payload slots (and, for D > 1, the D zero snapshots)
    of ``rows`` rows each."""
    w = msg_width(state["z"], rows)
    device = next(iter(state["z"].values())).device

    def zero(width):
        return torch.zeros((rows, width), dtype=torch.float32, device=device)
    state["queue"] = [zero(w) for _ in range(staleness)]
    if staleness > 1:
        state["snaps"] = [zero(w - 1) for _ in range(staleness)]
    return state


def _rank_async(cfg, n: int, amb: AMBConfig, staleness: int, draw_source,
                group, tp=None):
    """(init_state, step, flush) of one process per worker, or of a worker
    spread over a model axis (``tp``; see the module note)."""
    beta = amb.beta
    ep = RankEpoch(cfg, n, amb, draw_source, group, tp)
    r = group.worker
    D = staleness
    gamma = 1.0 if D == 1 else 1.0 / (2.0 * D)

    def init_state(params: dict) -> dict:
        return _init_queue(init_gossip_state(params, 1), 1, D)

    def step(state, batch, b):
        lead = first_leaf(batch)
        device, per = lead.device, lead.shape[0]
        t = state["t"]
        sw, bw, stats = ep.weights(b, device, per)
        z, queue = state["z"], state["queue"]
        # (1) the due payload's consensus, under its enqueue epoch's draws
        agreed = ep.settle(queue.pop(0), t - D)
        snap = state["snaps"].pop(0) if D > 1 else None
        # (2) the gradient at the last settled primal (staleness D)
        g, loss = ep.grad(state, batch, sw, beta(t + 1), per, stats)
        # (3) settle the row, pack this epoch's payload over it, snapshot
        with torch.no_grad():
            if snap is None:
                settle_row(agreed[0], z, 0)
                dual = (zl[0] for zl in z.values())
            else:
                settle_row(agreed[0], z, 0, snap[0], gamma)
                dual = (gamma * zl[0] for zl in z.values())
            _pack_row(agreed[0], dual, g, n * bw[r])
            if snap is not None:
                torch.cat([zl[0].reshape(-1) for zl in z.values()],
                          out=snap[0])
        del g
        queue.append(agreed)
        if snap is not None:
            state["snaps"].append(snap)
        state["t"] = t + 1
        return state, epoch_metrics(bw, rank_losses(loss, group), beta, t,
                                    stats)

    @torch.no_grad()
    def flush(state):
        z, t, queue = state["z"], state["t"], state["queue"]
        for j in range(D):
            # oldest first; the settled slot goes back at the tail, so the
            # queue's order is kept and no slot is held during the rounds
            out = ep.settle(queue.pop(0), t - D + j)
            snap = state["snaps"][j] if D > 1 else None
            settle_row(out[0], z, 0, None if snap is None else snap[0],
                       gamma)
            if snap is not None:
                snap.zero_()
            queue.append(out.zero_())
        return state

    return init_state, step, flush


def make_async_gossip_train_step(cfg, n: int, amb: AMBConfig,
                                 staleness: int = 1,
                                 draw_source: Optional[Callable] = None,
                                 group=None, tp=None):
    """Returns (init_state, step, flush) for bounded-staleness AMB-DG.

    State extends the sequential gossip state with ``queue``, a list of
    ``staleness`` (n, W+1) fp32 payloads, oldest first (slot j of a state
    at epoch t was enqueued at epoch ``t - staleness + j``), and for
    ``staleness > 1`` ``snaps``, the matching (n, W) duals each payload
    was packed on (with ``group``, this worker's rows of both).
    step(state, batch, b) -> (state, metrics); flush(state) -> state.
    ``draw_source`` is as in
    :func:`repro_torch.dist.amb.make_gossip_train_step`; ``tp`` spreads
    each worker over a model axis (``w0``, the ``z`` row, the queue's
    slots and the snapshots hold this rank's blocks).
    """
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if group is not None:
        return _rank_async(cfg, n, amb, staleness, draw_source, group, tp)
    beta, radius = amb.beta, amb.radius
    draw_source = draw_source or epoch_draws
    strategy = strategy_from_config(amb, n)
    assignment = assignment_from_config(amb, n)
    D = staleness
    gamma = 1.0 if D == 1 else 1.0 / (2.0 * D)   # delayed-mixing damping

    def init_state(params: dict) -> dict:
        return _init_queue(init_gossip_state(params, n), n, D)

    def _consensus(payload, enqueue_epoch):
        # exact consensus returns a broadcast view: rows are written after
        return strategy.combine(
            payload, draws=draw_source(amb.seed, enqueue_epoch)).contiguous()

    def step(state, batch, b):
        lead = first_leaf(batch)
        device, per = lead.device, lead.shape[0] // n
        t = state["t"]
        beta_t = beta(t + 1)
        sw, bw = epoch_weights(_as_b(b, device), n, per, assignment)
        nb = n * bw
        z, w0 = state["z"], state["w0"]
        stats = NoiseStats(bw, z, n) if amb.noise_stats else None
        queue = state["queue"]
        # (1) the due payload's consensus, under its enqueue epoch's draws
        payload = queue.pop(0)
        agreed = _consensus(payload, t - D)
        del payload
        snap = state["snaps"].pop(0) if D > 1 else None
        losses = []
        for i in range(n):
            # (2) the gradient at the last settled primal (staleness D)
            g_i, loss = local_grad(cfg, z, w0, batch, sw, beta_t, radius, i,
                                   per)
            # (3) settle row i, then pack this epoch's payload over it and
            # snapshot the dual it was packed on
            with torch.no_grad():
                if snap is None:
                    settle_row(agreed[i], z, i)
                    dual = (zl[i] for zl in z.values())
                else:
                    settle_row(agreed[i], z, i, snap[i], gamma)
                    dual = (gamma * zl[i] for zl in z.values())
                _pack_row(agreed[i], dual, g_i, nb[i])
                if snap is not None:
                    torch.cat([zl[i].reshape(-1) for zl in z.values()],
                              out=snap[i])
            if stats is not None:
                stats.add(i, g_i)
            losses.append(loss)
            del g_i
        queue.append(agreed)
        if snap is not None:
            state["snaps"].append(snap)
        state["t"] = t + 1
        return state, epoch_metrics(bw, losses, beta, t, stats)

    @torch.no_grad()
    def flush(state):
        """Settle every in-flight payload, oldest first; ``t`` is not
        advanced.  A partly warm queue settles its zero slots as no-ops."""
        z, t, queue = state["z"], state["t"], state["queue"]
        for j in range(D):
            out = _consensus(queue[j], t - D + j)
            snap = state["snaps"][j] if D > 1 else None
            for i in range(n):
                settle_row(out[i], z, i, None if snap is None else snap[i],
                           gamma)
            if snap is not None:
                snap.zero_()
            queue[j] = out.zero_()
        return state

    return init_state, step, flush
