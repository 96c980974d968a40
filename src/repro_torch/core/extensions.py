"""Beyond-paper AMB extensions on the simulator (counterpart of
``repro.core.extensions``).

1. **Pipelined AMB** (:func:`run_amb_pipelined`): the gradients a node
   could compute during the consensus window T_c, which the paper counts
   as undone work a_i(t), are harvested at the current iterate and join
   the next epoch's consensus as one-step-stale gradients (Dekel et al.
   2012 §4).  :func:`run_amb_delayed` generalises the overlap to bounded
   staleness D (AMB-DG): a FIFO of D in-flight payloads, gradients at the
   last settled iterate, an epoch of max(T, T_c / D): the single-device
   oracle of :func:`repro_torch.dist.async_epochs.
   make_async_gossip_train_step`.
2. **Quantized gossip** (:func:`quantize_unbiased`,
   :func:`gossip_quantized`, :func:`run_amb_quantized`): stochastic
   uniform quantization to ``bits`` bits buys (32/bits)x the rounds in
   the same T_c; the dense operator is what
   :class:`repro_torch.dist.consensus.QuantizedGossipConsensus` falls
   back to and is tested against.
3. **Adaptive compute budget** (:func:`run_amb_adaptive`): the online
   Lemma 6 of :class:`repro_torch.control.BudgetPolicy` (alias
   :data:`AdaptiveBudget`) re-solves T every epoch from the observed
   b_i(t), under a straggler model that may change with the epoch.

The uniform draws come from the caller: JAX's threefry stream cannot be
reproduced, so a test hands both packages the same draws.  The runs take
the engine's seams (see :func:`repro_torch.core.engine.run`): a
``torch.Generator``, or ``draws(t)`` whose tuple each function states.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..control.policies import BudgetPolicy
from . import consensus as cns
from .engine import (EngineConfig, History, _chunks, _eval, _history,
                     _masked_grads, _prox_rows, _setup, _to)
from .stragglers import StragglerModel, amb_batch_sizes


def quantize_unbiased(x: torch.Tensor, bits: int, rnd: torch.Tensor,
                      bounds: Optional[tuple] = None) -> torch.Tensor:
    """Stochastic uniform quantization on per-row grids, E[q(x)] = x.

    x: (n, D); rnd: U[0, 1) draws of x's shape; ``2^bits - 1`` levels.
    ``bounds``: each row's (lo, hi), (n, 1) each, taken from outside (the
    rows of a worker spread over a model axis are blocks of its row, and
    the grid is the whole row's); default the min and max of x's rows.
    """
    levels = float(2 ** bits - 1)
    if bounds is None:
        lo = x.amin(dim=-1, keepdim=True)
        hi = x.amax(dim=-1, keepdim=True)
    else:
        lo, hi = bounds
    # a tensor divisor: CUDA turns a division by a host scalar into a
    # product with its reciprocal, which can move the grid by an ulp
    scale = torch.clamp(hi - lo, min=1e-12) / torch.full_like(lo, levels)
    u = (x - lo) / scale
    fl = torch.floor(u)
    up = (rnd < (u - fl)).to(x.dtype)
    # the row max can round to u = levels + eps: cap the up-round there
    return lo + torch.clamp(fl + up, max=levels) * scale


def gossip_quantized(messages: torch.Tensor, p, rounds: int, bits: int,
                     draws: Callable) -> torch.Tensor:
    """``rounds`` of delta-compressed gossip on (n, ...) messages.

    Each round quantizes ``m - h`` against the public replicas h (zero at
    the start), adds the result to h and mixes ``m <- diag(P) m +
    offdiag(P) h``: the self term stays exact and the injected noise
    decays with the deltas.  ``draws(k, out)`` fills ``out`` with round
    k's U[0, 1) draws.
    """
    p = torch.as_tensor(p, dtype=messages.dtype, device=messages.device)
    m = messages.reshape(messages.shape[0], -1)
    diag = torch.diagonal(p)[:, None]
    off = p - torch.diag(torch.diagonal(p))
    h = torch.zeros_like(m)
    rnd = torch.empty_like(m)
    for k in range(rounds):
        draws(k, rnd)
        h = h + quantize_unbiased(m - h, bits, rnd)
        m = diag * m + off @ h
    return m.reshape(messages.shape)


def _normalise(m: torch.Tensor) -> torch.Tensor:
    return m[:, :-1] / torch.clamp(m[:, -1:], min=1e-12)


# ---------------------------------------------------------------------------
# 1. Pipelined AMB: harvest the consensus-window gradients
# ---------------------------------------------------------------------------

def run_amb_pipelined(objective, model: StragglerModel, cfg: EngineConfig, *,
                      epochs: int, generator: Optional[torch.Generator] = None,
                      sample_args=(), eval_fn: Optional[Callable] = None,
                      f_star: float = 0.0, draws: Optional[Callable] = None,
                      device="cuda") -> History:
    """AMB with compute/communication overlap (staleness-1 gradients).

    Node i's epoch-t message is ``n (b_i(t) + a_i(t-1)) [z_i(t) + g_i(t)]``,
    g_i the mean of b_i(t) fresh gradients at w_i(t) and a_i(t-1) stale
    ones taken at w_i(t-1) in the previous consensus window.  An epoch
    still takes T + T_c: only idle cycles are reclaimed.  ``draws(t)``
    returns (times, fresh chunks, stale chunks).
    """
    device, generator, p, zeros = _setup(cfg, objective, generator, draws,
                                         device)
    n = cfg.n
    w, z, stale_gsum = zeros, zeros, zeros
    stale_b = torch.zeros((n,), dtype=torch.int32, device=device)
    clock = torch.zeros((), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    trace = []
    for t in range(1, epochs + 1):
        if draws is not None:
            times, fresh, stale = draws(t)
            times = torch.as_tensor(times, device=device)
            fresh = (_to(c, device) for c in fresh)
            stale = (_to(c, device) for c in stale)
        else:
            times = model.per_gradient_times(generator, n, cfg.b_max)
            fresh = _chunks(objective, generator, cfg, sample_args)
            stale = _chunks(objective, generator, cfg, sample_args)
        b = amb_batch_sizes(times, cfg.compute_time)
        a = amb_batch_sizes(times, cfg.compute_time + cfg.comm_time) - b

        g_fresh, lsum = _masked_grads(objective, w, b, cfg, fresh)
        bf = b.to(w.dtype)
        tot_b = bf + stale_b.to(w.dtype)
        g_comb = (g_fresh * bf[:, None] + stale_gsum) \
            / torch.clamp(tot_b, min=1.0)[:, None]
        msg = torch.cat([n * tot_b[:, None] * (z + g_comb),
                         n * tot_b[:, None]], dim=1)
        exact = cns.exact_average(msg)
        out = exact if cfg.consensus_mode == "exact" \
            else cns.gossip(msg, p, cfg.consensus_rounds)
        z_new = _normalise(out)
        eps = torch.linalg.vector_norm(z_new - _normalise(exact),
                                       dim=1).max()
        w_new = _prox_rows(z_new, cfg.beta(t + 1), cfg.radius)

        # the next epoch's stale gradients: a_i samples at the current w,
        # the iterate a node holds through this epoch's consensus window
        g_stale, _ = _masked_grads(objective, w, a, cfg, stale)
        af = a.to(w.dtype)
        mean_loss = lsum / torch.clamp(bf, min=1.0)
        clock = clock + cfg.compute_time + cfg.comm_time
        trace.append(dict(
            wall_time=clock, batch_sizes=b + stale_b,
            global_batch=(b + stale_b).sum().to(torch.int32),
            eval_loss=_eval(eval_fn, w_new, zero),
            train_loss=lsum.sum() / torch.clamp(bf.sum(), min=1.0),
            consensus_eps=eps,
            regret_inc=torch.sum(lsum + af * mean_loss - tot_b * f_star),
            potential=tot_b.sum()))
        w, z, stale_gsum, stale_b = w_new, z_new, g_stale * af[:, None], a
    return _history(trace)


# ---------------------------------------------------------------------------
# 1b. Delayed-gradient AMB (AMB-DG): bounded staleness D
# ---------------------------------------------------------------------------

def run_amb_delayed(objective, model: StragglerModel, cfg: EngineConfig, *,
                    staleness: int, epochs: int,
                    generator: Optional[torch.Generator] = None,
                    sample_args=(), eval_fn: Optional[Callable] = None,
                    f_star: float = 0.0, draws: Optional[Callable] = None,
                    device="cuda") -> History:
    """AMB with bounded-staleness delayed gradients (the AMB-DG oracle).

    A FIFO of ``staleness`` = D in-flight payloads: epoch t settles the
    payload enqueued at epoch t - D as the increment ``z + (agreed - gamma
    snapshot)`` (gamma = 1/(2D), 1 at D = 1), takes gradients at the last
    settled iterate, and enqueues ``n b (gamma z + g)`` on the settled
    dual; an epoch takes max(T, T_c / D).  ``draws(t)`` returns (times,
    chunks), as for :func:`repro_torch.core.engine.run`.
    """
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    device, generator, p, zeros = _setup(cfg, objective, generator, draws,
                                         device)
    n, d = zeros.shape
    D = staleness
    gamma = 1.0 if D == 1 else 1.0 / (2.0 * D)   # delayed-mixing damping
    w, z = zeros, zeros
    queue = [torch.zeros((n, d + 1), dtype=torch.float32, device=device)
             for _ in range(D)]
    snaps = [zeros] * D
    clock = torch.zeros((), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def settle(z, payload, snapshot):
        out = cns.exact_average(payload) if cfg.consensus_mode == "exact" \
            else cns.gossip(payload, p, cfg.consensus_rounds)
        z_new = z + torch.where(out[:, -1:] > 1e-6,
                                _normalise(out) - gamma * snapshot, 0.0)
        exact = cns.exact_average(payload)
        z_ex = z + torch.where(exact[:, -1:] > 1e-6,
                               _normalise(exact) - gamma * snapshot, 0.0)
        return z_new, torch.linalg.vector_norm(z_new - z_ex, dim=1).max()

    trace = []
    for t in range(1, epochs + 1):
        if draws is not None:
            times, data = draws(t)
            times = torch.as_tensor(times, device=device)
            chunks = (_to(c, device) for c in data)
        else:
            times = model.per_gradient_times(generator, n, cfg.b_max)
            chunks = _chunks(objective, generator, cfg, sample_args)
        b = amb_batch_sizes(times, cfg.compute_time)
        g, lsum = _masked_grads(objective, w, b, cfg, chunks)
        z_new, eps = settle(z, queue.pop(0), snaps.pop(0))
        bw = b.to(w.dtype)
        queue.append(torch.cat([n * bw[:, None] * (gamma * z_new + g),
                                n * bw[:, None]], dim=1))
        snaps.append(z_new)
        w_new = _prox_rows(z_new, cfg.beta(t + 1), cfg.radius)
        clock = clock + max(cfg.compute_time, cfg.comm_time / D)
        trace.append(dict(
            wall_time=clock, batch_sizes=b,
            global_batch=b.sum().to(torch.int32),
            eval_loss=_eval(eval_fn, w_new, zero),
            train_loss=lsum.sum() / torch.clamp(bw.sum(), min=1.0),
            consensus_eps=eps, regret_inc=torch.sum(lsum - bw * f_star),
            potential=b.sum().to(torch.int32)))
        w, z = w_new, z_new
    return _history(trace)


# ---------------------------------------------------------------------------
# 2b. Quantized gossip: more rounds per byte budget
# ---------------------------------------------------------------------------

def run_amb_quantized(objective, model: StragglerModel, cfg: EngineConfig, *,
                      bits: int = 8, epochs: int,
                      generator: Optional[torch.Generator] = None,
                      sample_args=(), eval_fn: Optional[Callable] = None,
                      f_star: float = 0.0, draws: Optional[Callable] = None,
                      device="cuda") -> History:
    """AMB whose fixed T_c buys (32/bits)x the rounds by quantization.

    The payload ``n b_i (z_i + g_i)`` goes through
    :func:`gossip_quantized`; the weight ``n b_i`` through plain gossip
    (one exact scalar a round).  ``draws(t)`` returns (times, chunks,
    q) with ``q(k, out)`` filling round k's U[0, 1) rounding draws.
    """
    rounds = int(cfg.consensus_rounds * 32 / bits)
    device, generator, p, zeros = _setup(cfg, objective, generator, draws,
                                         device)
    n = cfg.n
    w, z = zeros, zeros
    clock = torch.zeros((), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    trace = []
    for t in range(1, epochs + 1):
        if draws is not None:
            times, data, qdraws = draws(t)
            times = torch.as_tensor(times, device=device)
            chunks = (_to(c, device) for c in data)
        else:
            times = model.per_gradient_times(generator, n, cfg.b_max)
            chunks = _chunks(objective, generator, cfg, sample_args)

            def qdraws(k, out, gen=generator):
                return out.uniform_(generator=gen)
        b = amb_batch_sizes(times, cfg.compute_time)
        g, lsum = _masked_grads(objective, w, b, cfg, chunks)
        bw = b.to(w.dtype)
        payload = n * bw[:, None] * (z + g)
        weight = n * bw[:, None]      # the exact scalar, gossiped apart
        out_p = gossip_quantized(payload, p, rounds, bits, qdraws)
        out_w = cns.gossip(weight, p, rounds)
        z_new = out_p / torch.clamp(out_w, min=1e-12)
        exact = cns.exact_average(torch.cat([payload, weight], dim=1))
        eps = torch.linalg.vector_norm(z_new - _normalise(exact),
                                       dim=1).max()
        w_new = _prox_rows(z_new, cfg.beta(t + 1), cfg.radius)
        clock = clock + cfg.compute_time + cfg.comm_time
        trace.append(dict(
            wall_time=clock, batch_sizes=b,
            global_batch=b.sum().to(torch.int32),
            eval_loss=_eval(eval_fn, w_new, zero),
            train_loss=lsum.sum() / torch.clamp(bw.sum(), min=1.0),
            consensus_eps=eps, regret_inc=torch.sum(lsum - bw * f_star),
            potential=b.sum().to(torch.int32)))
        w, z = w_new, z_new
    return _history(trace)


# ---------------------------------------------------------------------------
# 3. Adaptive compute budget: online Lemma 6
# ---------------------------------------------------------------------------

# the online Lemma-6 controller is repro_torch.control.BudgetPolicy, one
# of the three policies behind repro_torch.control.Controller; this name
# is JAX's, kept for its callers
AdaptiveBudget = BudgetPolicy


def run_amb_adaptive(objective, model_fn: Callable, cfg: EngineConfig, *,
                     controller: BudgetPolicy, epochs: int,
                     generator: Optional[torch.Generator] = None,
                     sample_args=(), eval_fn: Optional[Callable] = None,
                     f_star: float = 0.0, draws: Optional[Callable] = None,
                     device="cuda") -> History:
    """AMB whose budget T follows ``controller`` (online Lemma 6).

    ``model_fn(t)`` is epoch t's straggler model, so the cluster may
    change under the run (the case a fixed T cannot follow).  Epoch t
    cuts at the budget in force, then ``controller.update`` re-solves it
    from b(t); the epoch takes that T plus T_c.  Every tensor stays on
    the device: the wall clock and the regret add up in fp64 there (as
    JAX adds host floats), and the History is built once at the end.
    ``draws(t)`` returns (times, chunks), as for
    :func:`repro_torch.core.engine.run`.
    """
    device, generator, p, zeros = _setup(cfg, objective, generator, draws,
                                         device)
    n = cfg.n
    w, z = zeros, zeros
    ctrl = controller.init(cfg.compute_time, device=device)
    clock = torch.zeros((), dtype=torch.float64, device=device)
    regret = torch.zeros((), dtype=torch.float64, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    trace = []
    for t in range(1, epochs + 1):
        if draws is not None:
            times, data = draws(t)
            times = torch.as_tensor(times, device=device)
            chunks = (_to(c, device) for c in data)
        else:
            times = model_fn(t).per_gradient_times(generator, n, cfg.b_max)
            chunks = _chunks(objective, generator, cfg, sample_args)
        t_budget = ctrl["t_budget"]
        b = amb_batch_sizes(times, t_budget)
        g, lsum = _masked_grads(objective, w, b, cfg, chunks)
        bw = b.to(w.dtype)
        msg = torch.cat([n * bw[:, None] * (z + g), n * bw[:, None]], dim=1)
        exact = cns.exact_average(msg)
        out = exact if cfg.consensus_mode == "exact" \
            else cns.gossip(msg, p, cfg.consensus_rounds)
        z_new = _normalise(out)
        eps = torch.linalg.vector_norm(z_new - _normalise(exact),
                                       dim=1).max()
        w_new = _prox_rows(z_new, cfg.beta(t + 1), cfg.radius)
        ctrl = controller.update({"t_budget": t_budget, "tau": ctrl["tau"]},
                                 b)
        clock = clock + (t_budget + cfg.comm_time).double()
        regret = regret + torch.sum(lsum - bw * f_star).double()
        w, z = w_new, z_new
        gsum = b.sum().to(torch.float32)
        trace.append(dict(
            wall_time=clock, batch_sizes=b, global_batch=gsum,
            eval_loss=_eval(eval_fn, w, zero).to(torch.float32),
            train_loss=lsum.sum() / torch.clamp(bw.sum(), min=1.0),
            consensus_eps=eps, regret=regret, potential=gsum))

    def stacked(key):
        return torch.stack([m[key] for m in trace])

    return History(
        wall_time=stacked("wall_time").to(torch.float32),
        batch_sizes=stacked("batch_sizes"),
        global_batch=stacked("global_batch"),
        eval_loss=stacked("eval_loss"),
        train_loss=stacked("train_loss"),
        consensus_eps=stacked("consensus_eps"),
        regret=stacked("regret").to(torch.float32),
        potential_samples=stacked("potential"))
