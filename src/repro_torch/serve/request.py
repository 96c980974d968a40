"""Request layer: arrivals, the admission queue, synthetic workloads
(a copy of ``repro.serve.request``: the same prompts for the same seed).

Requests arrive staggered in time with heterogeneous prompt lengths —
the workload shape that breaks a static batch
(everyone starts together, one shared length).  The queue orders by
arrival time; :class:`AdmissionPolicy` rejects requests that can never
fit a slot (prompt + generation exceeds the slot's KV capacity) and
bounds queue depth so overload sheds load instead of growing latency
without bound.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Optional


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle timestamps.

    ``arrival_s`` is set by the workload; the scheduler stamps
    ``admit_s`` (slot granted), ``first_token_s`` (prefill's sampled
    token — the TTFT endpoint) and ``finish_s`` (retirement).  All
    stamps share one :class:`~repro_torch.serve.scheduler.ServeClock` so
    SLO metrics are exact on a synthetic clock and honest on a wall clock.
    """
    rid: int
    prompt: list[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    # -- runtime (filled by the engine/scheduler) --
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    finish_reason: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Static admissibility: capacity fit + bounded queue depth.

    ``cache_len`` is the per-slot KV capacity; a request whose prompt
    plus generation budget cannot fit is rejected outright (it would
    otherwise occupy a slot forever).  ``max_queue = 0`` means
    unbounded.
    """
    cache_len: int
    max_queue: int = 0

    def admit(self, req: Request, queued: int) -> bool:
        if req.prompt_len < 1:
            return False
        if req.prompt_len + req.max_new_tokens > self.cache_len:
            return False
        if self.max_queue and queued >= self.max_queue:
            return False
        return True


class RequestQueue:
    """Arrival-ordered queue: requests become *ready* at ``arrival_s``.

    ``pop_ready(now)`` yields the earliest-arrived ready request (FIFO
    among ready; ties broken by rid), or None.  ``next_arrival_s``
    tells the scheduler when to wake an idle round.
    """

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy
        self._heap: list[tuple[float, int, Request]] = []
        self.rejected: list[Request] = []

    def push(self, req: Request) -> bool:
        if self.policy is not None and not self.policy.admit(
                req, len(self._heap)):
            req.finish_reason = "rejected"
            self.rejected.append(req)
            return False
        heapq.heappush(self._heap, (req.arrival_s, req.rid, req))
        return True

    def pop_ready(self, now: float) -> Optional[Request]:
        if self._heap and self._heap[0][0] <= now:
            return heapq.heappop(self._heap)[2]
        return None

    def next_arrival_s(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


def synthetic_requests(n: int, *, vocab_size: int, prompt_len: int = 32,
                       prompt_jitter: int = 0, max_new_tokens: int = 16,
                       arrival_gap_s: float = 0.0, seed: int = 0
                       ) -> list[Request]:
    """Deterministic staggered workload: ``n`` requests, prompts of
    ``prompt_len ± prompt_jitter`` random tokens, arrivals spaced
    ``arrival_gap_s`` apart (request i arrives at ``i * gap``).
    """
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        lo = max(1, prompt_len - prompt_jitter)
        hi = prompt_len + prompt_jitter
        plen = rng.randint(lo, hi)
        prompt = [rng.randrange(vocab_size) for _ in range(plen)]
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=max_new_tokens,
                            arrival_s=i * arrival_gap_s))
    return reqs
