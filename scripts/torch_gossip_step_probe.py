#!/usr/bin/env python3
"""Step time of ``chip_smoke.py``'s ring-gossip session, to compare two
checkouts on one card.

    python3 scripts/torch_gossip_step_probe.py [--root DIR] [--epochs N]

``--root`` names the checkout whose ``src/repro_torch`` runs (default:
the one this script sits in), so one copy of the script drives an older
checkout too.  The session is ``chip_smoke.run_session``'s gossip one:
qwen2-1.5b at its published widths cut to 8 layers, 4 workers of 8
sequences of 256 tokens, ring gossip at r = 5, the simulated clock,
``SyntheticSource`` batches from seed 0 (the same b_i(t) in every
checkout).  One warm-up epoch (it builds the kernels), then ``N`` epochs
on the host clock (each ends in the step's device sync), then one epoch
traced with ``torch.profiler``: the card's busy time (the sum of kernel
times), its idle share of the step, and the kernels that take the most
device time.  Prints the card's name and power limit first.
"""
import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_WORKERS, PER_WORKER, SEQ = 4, 8, 256
LAYERS, ROUNDS, TOP = 8, 5, 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--epochs", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch
    from repro_torch import api, configs, data

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; root {args.root}", flush=True)
    cfg = dataclasses.replace(configs.get_config("qwen2-1.5b"),
                              num_layers=LAYERS)
    session = api.AMBSession(
        api.TrainSpec(data=N_WORKERS, batch_per_worker=PER_WORKER,
                      seq_len=SEQ),
        api.ClockSpec(kind="simulated"),
        api.ConsensusSpec(consensus="gossip", graph="ring",
                          gossip_rounds=ROUNDS),
        cfg=cfg, device="cuda")
    source = data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                  PER_WORKER, seed=0, device="cuda")
    session.step(source.batch(0))
    times = []
    for epoch in range(1, args.epochs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = session.step(source.batch(epoch))
        times.append(time.perf_counter() - t0)
        print(f"  epoch {epoch}: b={m['b'].tolist()} host_ms="
              f"{times[-1] * 1e3:.1f} step_ms={m['step_s'] * 1e3:.1f}",
              flush=True)
    print(f"gossip step host ms: median {statistics.median(times) * 1e3:.1f}"
          f" min {min(times) * 1e3:.1f} max {max(times) * 1e3:.1f} over "
          f"{len(times)}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    epoch = args.epochs + 1
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.step(source.batch(epoch))
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    print(f"traced epoch {epoch}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}",
          flush=True)
    events.sort(key=lambda e: -e.device_time_total)
    for e in events[:TOP]:
        print(f"  {e.device_time_total / 1e3:8.2f} ms {e.count:5d} calls  "
              f"{e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
