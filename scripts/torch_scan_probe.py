#!/usr/bin/env python3
"""The RWKV6 scan kernel alone at the rwkv6-3b prefill shapes (B 1, H 40,
hd 64, S 2048 and 2560, r/k/v bf16 and decay fp32 in the model's layout):
its time per call for segments of 4, 8 and 16 chunks, and the device time
of each of its three launches (segments, carry, outputs).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_scan_probe.py

Times are ``chip_smoke.time_ms`` (many calls queued between one pair of
CUDA events), taken in turns (L = 8, 4, 16, 16, 4, 8) so that a drift of
the card's clocks falls on all alike; the launches' device times come from
``torch.profiler`` over ``REPS`` calls at the wrapper's own L.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import rwkv6_scan as scan  # noqa: E402

SEQS = cs.RWKV_SEQS
ORDER = (8, 4, 16, 16, 4, 8)
CALLS, REPS = 200, 20


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, h, hd = (cs.RWKV_MAIN[x] for x in ("b", "h", "hd"))
    for s in SEQS:
        ins = cs.rwkv_inputs(torch, gen, b, s, h, hd, torch.bfloat16,
                             "model")
        times: dict = {}
        for seg in ORDER:
            times.setdefault(seg, []).append(cs.time_ms(
                torch, lambda: scan._scan(*ins, seg), CALLS, f"L={seg}"))
        for seg, ts in sorted(times.items()):
            print(f"S={s} L={seg} segments="
                  f"{scan.launch_plan(b, h, s, hd, seg)['segments']} ms "
                  + " ".join(f"{t:.4f}" for t in ts), flush=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                scan.rwkv6_scan_cuda(*ins)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0:
                print(f"S={s} L={scan.SEGMENT_CHUNKS} "
                      f"{e.device_time_total / e.count:.2f} us a call, "
                      f"{e.count} calls: {e.key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
