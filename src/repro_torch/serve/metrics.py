"""SLO metrics plane: TTFT, TPOT, latency, throughput, train loss
(counterpart of ``repro.serve.metrics``).

Per-request records are derived purely from the scheduler's clock
stamps on :class:`~repro_torch.serve.request.Request`, so on a
:class:`~repro_torch.serve.scheduler.SyntheticClock` every metric is an
exact arithmetic consequence of the configured op costs, while a
:class:`~repro_torch.serve.scheduler.WallClock` gives wall-time SLOs.
Records stream through :class:`repro_torch.metrics.MetricsLogger` JSONL
when a path is given.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..metrics import MetricsLogger
from .request import Request


def request_record(req: Request) -> dict:
    """SLO record for a finished request.

    TTFT is arrival -> first sampled token (queueing + prefill); TPOT
    is the mean inter-token time over the remaining tokens; latency is
    arrival -> retirement.
    """
    n = len(req.out_tokens)
    ttft = req.first_token_s - req.arrival_s
    tpot = ((req.finish_s - req.first_token_s) / (n - 1)) if n > 1 else 0.0
    return {
        "rid": req.rid,
        "prompt_len": req.prompt_len,
        "out_tokens": n,
        "ttft_s": ttft,
        "tpot_s": tpot,
        "latency_s": req.finish_s - req.arrival_s,
        "queue_s": req.admit_s - req.arrival_s,
        "finish_reason": req.finish_reason,
    }


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class ServeMetrics:
    """Accumulates per-request SLO records and per-round train metrics."""

    def __init__(self, logger: Optional[MetricsLogger] = None):
        self.logger = logger
        self.requests: list[dict] = []
        self.train_losses: list[float] = []
        self._first_arrival: Optional[float] = None
        self._last_finish: Optional[float] = None

    def complete(self, req: Request) -> dict:
        rec = request_record(req)
        self.requests.append(rec)
        a, f = req.arrival_s, req.finish_s
        self._first_arrival = a if self._first_arrival is None \
            else min(self._first_arrival, a)
        self._last_finish = f if self._last_finish is None \
            else max(self._last_finish, f)
        if self.logger is not None:
            self.logger.log(req.rid, kind="request", **{
                k: v for k, v in rec.items() if k != "rid"})
        return rec

    def train_step(self, epoch: int, loss: float, **extra: Any) -> None:
        self.train_losses.append(float(loss))
        if self.logger is not None:
            self.logger.log(epoch, kind="train", loss=float(loss), **extra)

    def summary(self) -> dict:
        """p50/p99 SLOs + aggregate throughput over the serving span."""
        ttft = [r["ttft_s"] for r in self.requests]
        tpot = [r["tpot_s"] for r in self.requests]
        lat = [r["latency_s"] for r in self.requests]
        toks = sum(r["out_tokens"] for r in self.requests)
        span = 0.0
        if self._first_arrival is not None:
            span = max(self._last_finish - self._first_arrival, 1e-9)
        out = {
            "n_requests": len(self.requests),
            "total_tokens": toks,
            "span_s": span,
            "tokens_per_s": toks / span if span else 0.0,
            "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
            "tpot_p50_s": _pct(tpot, 50), "tpot_p99_s": _pct(tpot, 99),
            "latency_p50_s": _pct(lat, 50), "latency_p99_s": _pct(lat, 99),
            "train_epochs": len(self.train_losses),
        }
        if self.train_losses:
            out["train_loss_first"] = self.train_losses[0]
            out["train_loss_last"] = self.train_losses[-1]
        return out
