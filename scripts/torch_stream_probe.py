#!/usr/bin/env python3
"""Device-memory rate of the quantized-gossip kernels beside PyTorch's own
elementwise kernels, on the stacks of the 4-layer qwen2-1.5b gossip
session (n = 4 workers, D = 653,940,225 fp32 elements per row).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_stream_probe.py

For each placement of the operands (no offset, 1 MiB steps, odd element
offsets) it prints the time per launch (five launches queued between one
pair of CUDA events, ``chip_smoke.time_ms``) and the
rate in TB/s, counting each input read once and each output written once.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.dist.consensus import GossipConsensus, row_grids  # noqa
from repro_torch.kernels import ops  # noqa: E402

N_ROWS, D = 4, 653940225
N = N_ROWS * D
OFFSETS = ((0, 0, 0, 0, 0), (0, 1 << 18, 2 << 18, 3 << 18, 4 << 18),
           (0, 12345, 217291, 99991, 77777))


def stack(off: int, dtype=torch.float32, k: int = 1) -> torch.Tensor:
    """A contiguous (k, n, D) or (n, D) view ``off`` elements into a buffer."""
    buf = torch.empty(k * N + off, dtype=dtype, device="cuda")
    view = buf[off:off + k * N]
    return view.view(k, N_ROWS, D) if k > 1 else view.view(N_ROWS, D)


def run(tag: str, fn, nbytes: int) -> None:
    ms = cs.time_ms(torch, fn, 5, tag)
    print(f"  {tag}: {ms:.3f} ms  {nbytes / ms / 1e9:.3f} TB/s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stream_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    strat = GossipConsensus(N_ROWS, 1, "ring")
    src, w = strat.source_rows("cuda"), strat.taps.weights
    for offs in OFFSETS:
        print(f"offsets (elements) {offs}", flush=True)
        m = stack(offs[0]).normal_()
        h = stack(offs[1]).normal_()
        rnd = stack(offs[2]).uniform_()
        lvl = stack(offs[3], torch.uint8)
        out = stack(offs[4])
        lo, scale = row_grids(m, h, 255.0)
        run("torch.add(m, h, out=)", lambda: torch.add(m, h, out=out),
            12 * N)
        run("torch.addcmul(m, h, rnd, out=)",
            lambda: torch.addcmul(m, h, rnd, out=out), 16 * N)
        run("out.copy_(m)", lambda: out.copy_(m), 8 * N)
        run("stochastic_quantize into out", lambda: ops.stochastic_quantize(
            m, h, rnd, lo, scale, 255.0, out=(lvl, out)), 17 * N)
        run("stochastic_quantize over h", lambda: ops.stochastic_quantize(
            m, h, rnd, lo, scale, 255.0, out=(lvl, h)), 17 * N)
        del rnd, out
        torch.cuda.empty_cache()
        hnbr = stack(offs[2], k=2).normal_()
        run("quantized_combine in place", lambda: ops.quantized_combine(
            m, hnbr, lvl, lo, scale, src, w, out=(m, hnbr)), 25 * N)
        del m, h, lvl, hnbr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
