#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone on one card: the hybrid family
(zamba2-1.2b) over a model axis, without the twenty minutes of the
phases before it.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_phase21_probe.py

It builds every kernel (one ``nvcc`` a source, all at once), times the
phase-3 entry at the ranks' shape (flash at zamba2's shared block on a
rank of model 2, H 16, KV 16, hd 64, S 2048, causal, beside SDPA), then
launches four gloo ranks of itself under torchrun, computes phase 21's
references in the parent while they start (``chip_smoke.
axis21_references``: the serving twin against the plain engine, the
exact and fp32 gossip twins, the one-process archive), has the ranks run
phase 21's turn (``chip_smoke.rank_axis21``) and checks their archive
(``chip_smoke.axis21_after``).  It prints what those print and exits
non-zero where any check fails.
"""
import concurrent.futures
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import chip_smoke as C  # noqa: E402

PHASE = "p21"


def rank_fn(torch, rt, dist, work):
    C.wait_parent(work, dist.get_rank(), 21)
    C.rank_axis21(torch, rt, dist, work)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_phase21_probe: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch as rt
    import repro_torch.api  # noqa: F401
    import repro_torch.dist.tp  # noqa: F401
    import repro_torch.kernels.flash_attention  # noqa: F401
    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.launch.train  # noqa: F401
    import repro_torch.ckpt  # noqa: F401
    import repro_torch.serve  # noqa: F401
    from repro_torch.kernels import build, ops
    print("card:", C.card_line(), flush=True)
    t0 = time.perf_counter()
    names = build.sources()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.library, names))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(C.check_flash_rank(torch, ops, rt.kernels.flash_attention,
                             C.FLASH_ZAMBA_RANK, C.FLASH21_SEQS,
                             "zamba2-1.2b's shared block over (data 2, "
                             "model 2)"))
    C.release(torch)
    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="p21-", dir=REPO / "build"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", str(Path(__file__)), "--rank-phase",
           PHASE, "--work", str(work)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CHIP_SMOKE_LAUNCHED_AT=repr(time.time()))
    proc = subprocess.Popen(cmd, env=env, cwd=str(REPO),
                            start_new_session=True)
    t1 = time.perf_counter()
    try:
        C.axis21_references(torch, rt, work)
        print(f"references {time.perf_counter() - t1:.1f} s", flush=True)
        C.parent_ready(work, 21)
    except BaseException:
        C.stop_ranks("gloo", proc)
        raise
    C.wait_ranks("gloo", proc, t1, 4)
    C.axis21_after(torch, rt, work)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    if "--rank-phase" in sys.argv:
        C.RANK_PHASES[PHASE] = rank_fn
        raise SystemExit(C.rank_main(sys.argv))
    raise SystemExit(main())
