"""JSONL run metrics (counterpart of ``repro.metrics``)."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricsLogger:
    """Append-only JSONL logger with wall-clock stamps."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()
        self._fh = self.path.open("a")

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "elapsed_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "item") or isinstance(
                v, (int, float)) else v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def read_metrics(path: str | Path) -> list[dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]
