#!/usr/bin/env python3
"""Where the train CLI's LM batches cost time on one NVIDIA GPU: the
build of one 4 x 8 x 256 batch of ``LMTokenStream`` at qwen2-1.5b's vocab
of 151,936, and what it does to the exact training step behind a
prefetcher.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_data_plane_probe.py

Three ways to walk the chain, the same tokens each:
  * ``per_worker``: one eager walk per worker (a ``batch`` call each);
  * ``together``: one eager walk over every worker's rows;
  * ``graphed``: one CUDA graph replay of that walk (the source's own).
For each it prints the host milliseconds of a synced build (the first
includes the kernels' load and, graphed, the capture).  Then six
full-width exact epochs (28 layers, bf16, simulated clock) through
``AMBSession.run`` with ``prefetch`` 0 and 2, for ``per_worker`` and
``graphed`` builds and for ``per_worker`` built on the consumer's stream
(no side stream): the run's host seconds and each step's (host clock
around the synced step, as ``AMBSession.step`` reports it).
"""
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import api, configs, data  # noqa: E402
from repro_torch.data import loader  # noqa: E402

EPOCHS = 6


def per_worker(self, epoch):
    """StreamSource.batch as one ``batch`` call per worker."""
    shards = [self.stream.batch(i, epoch, self.per_worker)
              for i in range(self.n_workers)]
    return loader._tree_map(lambda *xs: torch.cat(xs, dim=0), *shards)


def on_consumer_stream(self, epoch):
    """Prefetcher._build without the side stream or the event."""
    return self.source.batch(epoch), None


def patched(builds: str, side_stream: bool = True):
    """(owner, name, replacement) triples for one way of building."""
    eager = (data.LMTokenStream, "_graphed_walk",
             data.LMTokenStream._walk)
    out = {"per_worker": [eager, (data.StreamSource, "batch", per_worker)],
           "together": [eager], "graphed": []}[builds]
    if not side_stream:
        out.append((loader.Prefetcher, "_build", on_consumer_stream))
    return out


def with_patches(patches, fn):
    originals = [(o, n, getattr(o, n)) for o, n, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        return fn()
    finally:
        for owner, name, old in originals:
            setattr(owner, name, old)


def build_ms(source) -> list:
    out = []
    for epoch in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        source.batch(epoch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def session_run(cfg, prefetch: int) -> tuple:
    gc.collect()
    torch.cuda.empty_cache()
    session = api.AMBSession(
        api.TrainSpec(data=cs.N_WORKERS, batch_per_worker=cs.PER_WORKER,
                      seq_len=cs.SEQ), api.ClockSpec(kind="simulated"),
        cfg=cfg, device="cuda")
    session.step(session.batch_source().batch(100))      # warm up
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.run(EPOCHS, prefetch=prefetch,
                on_step=lambda e, m: steps.append(m["step_s"]))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, steps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_data_plane_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    cfg = configs.get_config("qwen2-1.5b")
    tokens = {}
    for builds in ("per_worker", "together", "graphed"):
        source = data.StreamSource(data.LMTokenStream(
            cfg.vocab_size, cs.SEQ, seed=0, device="cuda"), cs.N_WORKERS,
            cs.PER_WORKER)
        times = with_patches(patched(builds), lambda: build_ms(source))
        tokens[builds] = with_patches(
            patched(builds), lambda: source.batch(2)["tokens"])
        print(f"build {builds}: ms {', '.join(f'{t:.1f}' for t in times)}",
              flush=True)
    same = all(torch.equal(t, tokens["graphed"]) for t in tokens.values())
    print(f"the three builds give the same tokens: {same}", flush=True)
    for builds, side in (("per_worker", True), ("graphed", True),
                         ("per_worker", False)):
        for prefetch in (0, 2):
            run_s, steps = with_patches(
                patched(builds, side), lambda: session_run(cfg, prefetch))
            print(f"run {builds}{'' if side else ' (consumer stream)'} "
                  f"prefetch {prefetch}: {EPOCHS} epochs in {run_s:.3f} s, "
                  f"step_s {', '.join(f'{t:.4f}' for t in steps)}",
                  flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
