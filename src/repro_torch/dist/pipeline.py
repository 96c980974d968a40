"""Staleness-1 pipelined AMB epochs (counterpart of ``repro.dist.pipeline``).

The paper's protocol leaves the links idle during the compute window T and
the compute idle during the consensus window T_c.  The staleness-1
overlap (:func:`repro_torch.core.extensions.run_amb_pipelined`) runs the
consensus of epoch t's payload beside the gradients of epoch t+1.  One
step of epoch t:

  1. settles the **pending** payload, enqueued by epoch t-1: its
     consensus, with the rounding draws of its *enqueue* epoch
     (``draw_source(seed, t - 1)``), so each payload settles with exactly
     the draws the sequential step would have used;
  2. takes each worker's masked gradient at the *stale* primal
     ``prox(z_i(t-1))``, the iterate a worker holds while the previous
     consensus is in flight;
  3. folds the agreed rows into the dual and packs this epoch's payload
     ``n b_i (z_i(t) + g_i)`` on the fresh dual.

On one device the three run in order on one stream, and the payload is
packed into the consensus output's own buffer: worker i's agreed row is
folded into z_i right after worker i's gradient (the gradient still reads
the stale z_i), and that row is then overwritten with worker i's new
payload.  So one (n, W+1) stack is live through the backward, as in the
sequential step, and one between steps.

``flush`` settles the last pending payload without new gradients and does
not advance ``t``: after k steps and a flush the state holds the dual
through payload k, the sequential chain's state at t = k.

One process per worker (``group=``): ``pending`` is this worker's (1,
W+1) payload row, each settle its
:meth:`~repro_torch.dist.consensus.ConsensusStrategy.combine_rank` under
the enqueue epoch's draws, and the agreed row becomes the next payload,
as on one device.  A worker spread over a model axis (``tp``, a
:class:`~repro_torch.dist.tp.TensorParallel`): ``pending`` is this rank's
(1, d_block) block of its worker's payload row, gossiped with the ranks
at its model coordinate, as the sequential step gossips its block.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .amb import (AMBConfig, NoiseStats, RankEpoch, _as_b, _pack_row,
                  assignment_from_config, epoch_metrics, epoch_weights,
                  first_leaf, init_gossip_state, local_grad, msg_width,
                  rank_losses, settle_row, strategy_from_config,
                  unpack_duals)
from .consensus import epoch_draws


def _rank_pipelined(cfg, n: int, amb: AMBConfig, draw_source, group,
                    tp=None):
    """(init_state, step, flush) of one process per worker, or of a worker
    spread over a model axis (``tp``; see the module note)."""
    beta = amb.beta
    ep = RankEpoch(cfg, n, amb, draw_source, group, tp)
    r = group.worker

    def init_state(params: dict) -> dict:
        state = init_gossip_state(params, 1)
        state["pending"] = torch.zeros(
            (1, msg_width(state["z"], 1)), dtype=torch.float32,
            device=next(iter(state["z"].values())).device)
        return state

    def step(state, batch, b):
        lead = first_leaf(batch)
        device, per = lead.device, lead.shape[0]
        t = state["t"]
        sw, bw, stats = ep.weights(b, device, per)
        z = state["z"]
        # (1) the consensus of epoch t-1's payload, under its draws
        agreed = ep.settle(state.pop("pending"), t - 1)
        # (2) the gradient at the stale primal prox(z(t-1))
        g, loss = ep.grad(state, batch, sw, beta(t + 1), per, stats)
        # (3) z takes its agreed row; the row takes the new payload
        settle_row(agreed[0], z, 0)
        with torch.no_grad():
            _pack_row(agreed[0], [zl[0] for zl in z.values()], g, n * bw[r])
        del g
        state["pending"] = agreed
        state["t"] = t + 1
        return state, epoch_metrics(bw, rank_losses(loss, group), beta, t,
                                    stats)

    @torch.no_grad()
    def flush(state):
        out = ep.settle(state.pop("pending"), state["t"] - 1)
        unpack_duals(out, state["z"], 1)
        state["pending"] = out.zero_()
        return state

    return init_state, step, flush


def make_pipelined_gossip_train_step(cfg, n: int, amb: AMBConfig,
                                     draw_source: Optional[Callable] = None,
                                     group=None, tp=None):
    """Returns (init_state, step, flush) for the pipelined AMB protocol.

    State extends the sequential gossip state with ``pending``, the (n,
    W+1) fp32 payload of the previous epoch, still in flight (zeros at
    the start and after a flush: a zero weight column settles as a no-op;
    with ``group``, this worker's (1, W+1) row).  step(state, batch, b)
    -> (state, metrics); flush(state) -> state.  ``draw_source`` is as in
    :func:`repro_torch.dist.amb.make_gossip_train_step`; ``tp`` spreads
    each worker over a model axis (``w0``, the ``z`` row and ``pending``
    hold this rank's blocks).
    """
    if group is not None:
        return _rank_pipelined(cfg, n, amb, draw_source, group, tp)
    beta, radius = amb.beta, amb.radius
    draw_source = draw_source or epoch_draws
    strategy = strategy_from_config(amb, n)
    assignment = assignment_from_config(amb, n)

    def init_state(params: dict) -> dict:
        state = init_gossip_state(params, n)
        state["pending"] = torch.zeros(
            (n, msg_width(state["z"], n)), dtype=torch.float32,
            device=next(iter(state["z"].values())).device)
        return state

    def step(state, batch, b):
        lead = first_leaf(batch)
        device, per = lead.device, lead.shape[0] // n
        t = state["t"]
        beta_t = beta(t + 1)
        sw, bw = epoch_weights(_as_b(b, device), n, per, assignment)
        nb = n * bw
        z, w0 = state["z"], state["w0"]
        stats = NoiseStats(bw, z, n) if amb.noise_stats else None
        # (1) the consensus of epoch t-1's payload, under its draws
        pending = state.pop("pending")
        # exact consensus returns a broadcast view: rows are written below
        agreed = strategy.combine(
            pending, draws=draw_source(amb.seed, t - 1)).contiguous()
        del pending
        losses = []
        for i in range(n):
            # (2) the gradient at the stale primal prox(z_i(t-1))
            g_i, loss = local_grad(cfg, z, w0, batch, sw, beta_t, radius, i,
                                   per)
            # (3) z_i takes its agreed row; the row takes the new payload
            settle_row(agreed[i], z, i)
            with torch.no_grad():
                _pack_row(agreed[i], [zl[i] for zl in z.values()], g_i,
                          nb[i])
            if stats is not None:
                stats.add(i, g_i)
            losses.append(loss)
            del g_i
        state["pending"] = agreed
        state["t"] = t + 1
        return state, epoch_metrics(bw, losses, beta, t, stats)

    @torch.no_grad()
    def flush(state):
        """Settle the in-flight payload; ``t`` is not advanced."""
        pending = state.pop("pending")
        out = strategy.combine(
            pending, draws=draw_source(amb.seed, state["t"] - 1)).contiguous()
        del pending
        unpack_duals(out, state["z"], n)
        state["pending"] = out.zero_()
        return state

    return init_state, step, flush
