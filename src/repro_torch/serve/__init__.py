"""``repro_torch.serve``: continuous-batching serving tier with background
AMB fine-tuning under the anytime budget (counterpart of ``repro.serve``).

  * :mod:`.request`: ``Request`` lifecycle, the arrival queue,
    ``AdmissionPolicy`` and ``synthetic_requests`` workloads.
  * :mod:`.slots`: ``SlotEngine``, continuous batching over a fixed-shape
    slot array (bucketed batch-1 prefill through the flash kernel, insert,
    decode, evict), and the ``static_generate`` parity reference.
  * :mod:`.scheduler`: ``ServeScheduler`` runs decode rounds and
    background :class:`repro_torch.api.AMBSession` fine-tune epochs under
    one fixed ``round_budget_s``; ``serve_static`` is the timed rebatching
    baseline; ``WallClock`` / ``SyntheticClock`` are the time sources.
  * :mod:`.metrics`: ``ServeMetrics``, TTFT / TPOT / latency p50-p99,
    tokens/s and the train-loss trajectory, streamed through
    :class:`repro_torch.metrics.MetricsLogger`.

``repro_torch.launch.serve`` is a thin CLI over this package.
"""
from .metrics import ServeMetrics, request_record            # noqa: F401
from .request import AdmissionPolicy, Request, RequestQueue  # noqa: F401
from .request import synthetic_requests                      # noqa: F401
from .sampling import SamplingSpec, sample_token             # noqa: F401
from .scheduler import ServeClock, ServeReport, ServeScheduler  # noqa: F401
from .scheduler import SyntheticClock, WallClock, serve_static  # noqa: F401
from .slots import SlotEngine, bucket_len, static_generate   # noqa: F401

__all__ = [
    "AdmissionPolicy", "Request", "RequestQueue", "SamplingSpec",
    "ServeClock", "ServeMetrics", "ServeReport", "ServeScheduler",
    "SlotEngine", "SyntheticClock", "WallClock", "bucket_len",
    "request_record", "sample_token", "serve_static", "static_generate",
    "synthetic_requests",
]
