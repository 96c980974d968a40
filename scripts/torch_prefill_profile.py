#!/usr/bin/env python3
"""Where the time of one serve prefill goes on the card: the batch-1
prefill that ``SlotEngine.insert`` runs for a request of
``chip_smoke.py``'s serve runs, at full width (bf16, random weights from a
seed), for two models:

  * qwen2-1.5b (28 layers): a 2048-token prompt at its 2048 bucket, into a
    slot sized as the serve CLI sizes it;
  * rwkv6-3b (32 layers): a 2048-token prompt at its exact length, as the
    slot engine prefills the RWKV6 family (32 ``rwkv6_scan`` launches).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_prefill_profile.py

For qwen2-1.5b, for each flash-attention kernel body in turn (the
prefill's attention held to it: tensor core, CUDA core, CUDA core, tensor
core, so that a drift falls on both alike), and then for rwkv6-3b once, it
prints the host-clock median of ``REPS`` prefills (each ends in a device
sync, as the engine's first-token read does), then traces one with
``torch.profiler``: the card's busy time (the sum of kernel times), its
idle share of the wall time, the ``TOP`` kernels that take the most device
time, with their calls and microseconds per call, and (rwkv6-3b) the
device time of the scan's kernels over its calls.
"""
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.kernels import ops, router  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ARCH = "qwen2-1.5b"
RWKV_ARCH = "rwkv6-3b"
PROMPT = int(cs.SERVE_ARGV[cs.SERVE_ARGV.index("--prompt-len") + 1])
SEQ = PROMPT                 # a power of two: the prompt's own bucket
# the slot of launch/serve.py: prompt + its jitter + the new tokens
CACHE_LEN = PROMPT + min(PROMPT - 1, PROMPT // 4) + cs.SERVE_NEW
BODIES = ("tensor_core", "cuda_core", "cuda_core", "tensor_core")
REPS, TOP = 5, 12


def profile(one, label: str, scan: bool = False) -> None:
    """Host-clock median of ``REPS`` calls of ``one``, then one traced:
    busy time, idle share, kernel launches (all, and the repo's by
    counter) and the ``TOP`` kernels; with ``scan``, also the device time
    of the kernels whose name holds ``rwkv6``."""
    for _ in range(2):
        one()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    print(f"{label}: median {statistics.median(times) * 1e3:.2f} ms "
          f"over {REPS} (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f})", flush=True)
    router.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    print(f"traced {label}: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{sum(e.count for e in events)} kernel launches; launches "
          f"{router.launches()}", flush=True)
    if scan:
        mine = [e for e in events if "rwkv6" in e.key]
        print(f"traced {label}: rwkv6_scan device time "
              f"{sum(e.device_time_total for e in mine) / 1e3:.3f} ms over "
              f"{router.launches().get('rwkv6_scan', 0)} calls ("
              + ", ".join(f"{e.key[e.key.find('rwkv6'):].split('(')[0]} "
                          f"{e.count} x "
                          f"{e.device_time_total / max(e.count, 1):.1f} us"
                          for e in mine) + ")", flush=True)
    events.sort(key=lambda e: -e.device_time_total)
    for e in events[:TOP]:
        print(f"  {e.device_time_total / 1e3:8.3f} ms  {e.count:5d} calls "
              f"{e.device_time_total / max(e.count, 1):9.1f} us/call  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_prefill_profile: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    cfg = configs.get_config(ARCH)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, SEQ), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))

    def one():
        with torch.no_grad():
            logits, _ = models.prefill(params, cfg, {"tokens": toks},
                                       extra_capacity=CACHE_LEN - SEQ,
                                       last_pos=SEQ - 1)
        return int(logits.argmax())          # the first token's sync

    for which in BODIES:
        # the prefill's attention held to one body
        ops.flash_attention_cuda = (
            lambda q, k, v, _b=which, **kw: fa.flash_attention_cuda(
                q, k, v, force_body=_b, **kw))
        profile(one, f"prefill {cfg.name} S={SEQ} flash body {which}")

    # the RWKV6 family: exact length, the scan kernel on every layer
    del params
    torch.cuda.empty_cache()
    rcfg = configs.get_config(RWKV_ARCH)
    rparams = models.init_params(
        rcfg, torch.Generator(device="cuda").manual_seed(0))
    rtoks = torch.randint(0, rcfg.vocab_size, (1, PROMPT), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))

    def rwkv_one():
        with torch.no_grad():
            logits, _ = models.prefill(rparams, rcfg, {"tokens": rtoks})
        return int(logits.argmax())

    profile(rwkv_one, f"prefill {rcfg.name} S={PROMPT} exact length",
            scan=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
