"""Scheduler: decode rounds + background AMB fine-tuning on one budget
(counterpart of ``repro.serve.scheduler``).

This is the paper's fixed-time contract transplanted to serving.  AMB
gives every node a wall-clock budget T and takes whatever gradients fit
(b_i(t) varies, the deadline does not).  Here every *round* gets a
fixed budget ``round_budget_s``; decode consumes it first (requests
contribute whatever tokens fit), and whatever is left over is absorbed
by AMB fine-tune epochs through an :class:`repro_torch.api.AMBSession`:
idle slot time becomes training progress instead of waste.  Under load
the leftover shrinks to zero and training backs off; the budget
arithmetic is the policy.

Timekeeping is pluggable: :class:`WallClock` for real serving,
:class:`SyntheticClock` (deterministic per-op costs) so tests can assert
budget accounting and SLO values exactly.

Over a process group (an engine with a ``group``, and a fine-tune session
over the same ranks) every rank runs the same loop: a clock other than
the synthetic one is read through :class:`RankClock` (rank 0's reading on
every rank), so every admission, round budget and fine-tune decision is
the same on every rank, and after each absorbed epoch the engine takes
the session's primal blocks in the serving layout
(``AMBSession.serving_params``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models import decode_step, prefill
from .metrics import ServeMetrics
from .request import Request, RequestQueue
from .sampling import SamplingSpec
from .slots import SlotEngine, _finish, _Sampler, prompt_batch


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------

class ServeClock:
    """Time source + cost model: ``now()``, ``charge(kind, n)``,
    ``wait_until(t)``.  ``charge`` advances synthetic time by the
    configured per-op cost (a no-op on the wall clock, where ops take
    real time)."""

    def now(self) -> float:
        raise NotImplementedError

    def charge(self, kind: str, n: int = 1) -> None:
        raise NotImplementedError

    def wait_until(self, t: float) -> None:
        raise NotImplementedError


class WallClock(ServeClock):
    """Monotonic wall time from construction; ``wait_until`` sleeps."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def charge(self, kind: str, n: int = 1) -> None:
        pass

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class RankClock(ServeClock):
    """``clock`` read on global rank 0 and broadcast to every rank of
    ``group`` at each ``now()`` (``WorkerGroup.lead_float``); ``charge``
    and ``wait_until`` act on each rank's own clock."""

    def __init__(self, clock: ServeClock, group):
        self.clock, self.group = clock, group

    def now(self) -> float:
        return self.group.lead_float(self.clock.now())

    def charge(self, kind: str, n: int = 1) -> None:
        self.clock.charge(kind, n)

    def wait_until(self, t: float) -> None:
        self.clock.wait_until(t)


class SyntheticClock(ServeClock):
    """Deterministic clock: ops cost exactly what the test configures.

    ``prefill`` is charged per prompt token, ``decode`` per round,
    ``train`` per fine-tune epoch.  Every scheduler timestamp becomes
    an exact arithmetic consequence of these three numbers.
    """

    def __init__(self, *, prefill_tok_s: float = 0.0,
                 decode_round_s: float = 0.0, train_epoch_s: float = 0.0):
        self.t = 0.0
        self.costs = {"prefill": prefill_tok_s, "decode": decode_round_s,
                      "train": train_epoch_s}

    def now(self) -> float:
        return self.t

    def charge(self, kind: str, n: int = 1) -> None:
        self.t += self.costs.get(kind, 0.0) * n

    def wait_until(self, t: float) -> None:
        if t > self.t:
            self.t = t


# ---------------------------------------------------------------------------
# Continuous-batching scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeReport:
    summary: dict
    requests: list[Request]
    rounds: int
    train_epochs: int


class ServeScheduler:
    """Round loop: admit -> decode under budget -> absorb leftover with
    AMB fine-tune epochs -> idle-wait to the next arrival.

    Admission is continuous: a slot freed mid-round is refilled in the
    same round (the engine never waits for a batch boundary).  The
    fine-tune cost estimate is the *minimum observed* epoch time (an
    unknown cost counts as zero, so the first epoch always runs and
    teaches the estimate; the first epoch carries one-time set-up, so
    min, not mean, tracks the steady state); an epoch is started only
    if the estimate fits the remaining budget, which is what makes
    training back off under serving load.

    Serving decodes against the *live* fine-tuned primal: after every
    absorbed epoch the engine's params are re-fetched from the session
    (the gossip protocols form a new primal each epoch).  Over a process
    group every rank runs the loop on rank 0's clock (see the module
    note).
    """

    def __init__(self, engine: SlotEngine, queue: RequestQueue, *,
                 round_budget_s: float, clock: Optional[ServeClock] = None,
                 session=None, train_epochs: int = 0,
                 metrics: Optional[ServeMetrics] = None):
        self.engine = engine
        self.queue = queue
        self.round_budget_s = round_budget_s
        self.clock = clock if clock is not None else WallClock()
        group = getattr(engine, "group", None)
        if group is not None and not isinstance(self.clock, SyntheticClock):
            self.clock = RankClock(self.clock, group)
        self.session = session
        self.train_epochs = train_epochs if session is not None else 0
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._train_source = session.batch_source() \
            if session is not None and train_epochs > 0 else None
        self._train_cost: Optional[float] = None
        self.trained = 0
        self.rounds = 0
        self.finished: list[Request] = []

    # -- pieces ------------------------------------------------------------

    def _admit_ready(self) -> int:
        n = 0
        while self.engine.has_free:
            req = self.queue.pop_ready(self.clock.now())
            if req is None:
                break
            req.admit_s = self.clock.now()
            self.engine.insert(req)
            self.clock.charge("prefill", req.prompt_len)
            req.first_token_s = self.clock.now()
            if req.done:                     # max_new_tokens == 1 / EOS
                req.finish_s = self.clock.now()
                self.metrics.complete(req)
                self.finished.append(req)
            n += 1
        return n

    def _ready_now(self) -> bool:
        nxt = self.queue.next_arrival_s()
        return (nxt is not None and nxt <= self.clock.now()
                and self.engine.has_free)

    def _train_once(self, deadline: float) -> bool:
        est = self._train_cost if self._train_cost is not None else 0.0
        now = self.clock.now()
        if now >= deadline or now + est > deadline:
            return False
        m = self.session.step(
            self._train_source.batch(self.session.steps_done))
        # decode against the primal this epoch produced: the serving
        # layout's blocks where the session has them (an AMBSession),
        # else the session's whole ``params`` (the scheduler's contract)
        serving = getattr(self.session, "serving_params", None)
        self.engine.load_params(serving() if serving is not None
                                else self.session.params)
        self.clock.charge("train")
        dt = self.clock.now() - now
        self._train_cost = dt if self._train_cost is None \
            else min(self._train_cost, dt)
        self.metrics.train_step(self.session.steps_done - 1, m["loss"])
        self.trained += 1
        return True

    # -- the loop ----------------------------------------------------------

    def run(self, max_rounds: int = 1_000_000) -> ServeReport:
        clock = self.clock
        while len(self.queue) or self.engine.active_count:
            if self.rounds >= max_rounds:
                raise RuntimeError("serve scheduler exceeded max_rounds")
            self.rounds += 1
            end = clock.now() + self.round_budget_s
            self._admit_ready()
            while self.engine.active_count and clock.now() < end:
                finished = self.engine.decode_round()
                clock.charge("decode")
                now = clock.now()
                for f in finished:
                    f.finish_s = now
                    self.metrics.complete(f)
                    self.finished.append(f)
                if finished:
                    self._admit_ready()      # continuous refill
            # leftover budget -> background AMB fine-tuning
            while (self._train_source is not None
                   and self.trained < self.train_epochs
                   and not self._ready_now()):
                if not self._train_once(end):
                    break
            # idle: jump to the next arrival (bounded by the round end)
            if not self.engine.active_count and len(self.queue):
                nxt = self.queue.next_arrival_s()
                clock.wait_until(min(nxt, end))
        return ServeReport(self.metrics.summary(), list(self.finished),
                           self.rounds, self.trained)


# ---------------------------------------------------------------------------
# Static rebatching baseline (the thing continuous batching beats)
# ---------------------------------------------------------------------------

def serve_static(params, cfg, requests: list[Request], *, batch: int,
                 cache_len: int, sampling: Optional[SamplingSpec] = None,
                 eos_id: Optional[int] = None,
                 clock: Optional[ServeClock] = None,
                 metrics: Optional[ServeMetrics] = None) -> ServeReport:
    """Timed static rebatching: groups of ``batch`` in arrival order.

    Each group barriers on its last arrival, pads every prompt to the
    group max, prefills together, and decodes until the *slowest*
    member finishes (retired rows burn rounds).  Early arrivals pay the
    barrier in TTFT; short generations pay the group tail in latency:
    the two costs the slot engine's continuous admission removes.
    Padding to the group max is sound for the dense family only: other
    families raise, as in JAX.
    """
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError("serve_static pads to the group max "
                                  "prompt length; dense/vlm only")
    clock = clock if clock is not None else WallClock()
    metrics = metrics if metrics is not None else ServeMetrics()
    device = next(iter(params.values())).device
    sample = _Sampler(sampling or SamplingSpec(), device)

    def take(group, toks):
        now = clock.now()
        for r, t in zip(group, toks):
            if not r.done and _finish(r, t, eos_id):
                r.finish_s = now
                metrics.complete(r)

    ordered = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    rounds = 0
    for g0 in range(0, len(ordered), batch):
        group = ordered[g0:g0 + batch]
        clock.wait_until(max(r.arrival_s for r in group))
        now = clock.now()
        for r in group:
            r.admit_s = now
        maxlen = max(r.prompt_len for r in group)
        toks = torch.tensor([r.prompt + [0] * (maxlen - r.prompt_len)
                             for r in group], dtype=torch.long,
                            device=device)
        last_pos = torch.tensor([r.prompt_len - 1 for r in group],
                                dtype=torch.long, device=device)
        logits, state = prefill(params, cfg, prompt_batch(params, cfg, toks),
                                extra_capacity=cache_len - maxlen,
                                last_pos=last_pos)
        tok = sample(logits)
        clock.charge("prefill", maxlen * len(group))
        now = clock.now()
        for r in group:
            r.first_token_s = now
        take(group, tok.tolist())
        while any(not r.done for r in group):
            logits, state = decode_step(params, cfg, state, tok)
            tok = sample(logits)
            clock.charge("decode")
            rounds += 1
            take(group, tok.tolist())
    return ServeReport(metrics.summary(), ordered, rounds, 0)
