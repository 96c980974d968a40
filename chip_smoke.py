#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. a CUDA card is present; print its name and power limit (nvidia-smi);
  2. build every CUDA kernel from src/repro_torch/kernels/csrc (one nvcc
     per source, started together) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card, at
     small shapes and at the shapes the main path gives it; print the
     error, the kernel's, the plain version's and one library call's
     median time (CUDA events), and the least time the card could take;
  4. a small reference check: the smoke-size session on the card (CUDA
     kernels) against the same session on the CPU (plain versions);
  5. the main path: AMBSession on qwen2-1.5b at full width, exact
     consensus, all 28 layers, 3 epochs; then ring gossip (r = 5), cut to
     8 layers, 3 epochs; launch counts are reset just before each and
     read just after;
  6. print the kernels' JSON line, the card line, and the final ok line.
"""
import concurrent.futures
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
N_WORKERS, PER_WORKER, SEQ = 4, 8, 256      # the TrainSpec defaults, n = 4
EPOCHS = 3
GOSSIP_LAYERS = 8              # depth cut for the gossip session (memory)
DUAL_TOL = 2e-6    # multiply by 0.5/beta vs divide by 2 beta: one rounding
COMBINE_TOL = 1e-6  # same products and sums in the same order: expect 0
SESSION_TOL = 1e-4  # fp32 smoke session, card vs CPU (summation order)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median ms of ``reps`` launches, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def max_abs_err(torch, a, b) -> float:
    """max |a - b| in fp32, in chunks (the operands may be 13 GB each)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 27
    err = 0.0
    for i in range(0, a.numel(), step):
        d = (a[i:i + step].float() - b[i:i + step].float()).abs().max()
        err = max(err, float(d.detach()))
    return err


def bound(nbytes: float, flops: float):
    """Least time (ms) on the card: bytes over HBM rate vs flops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_param_count(cfg) -> int:
    """P of the dense LM from its config (the 15 leaves' sizes)."""
    d, hd, ff = cfg.d_model, cfg.hd, cfg.d_ff
    h, kv = cfg.num_heads, cfg.num_kv_heads
    per_layer = (2 * d + d * h * hd + 2 * d * kv * hd + h * hd * d
                 + 3 * d * ff + (h * hd + 2 * kv * hd) * cfg.qkv_bias)
    return 2 * cfg.vocab_size * d + d + cfg.num_layers * per_layer


def check_dual_update(torch, ops, ref, full_shape, beta: float):
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, full = 0.0, {}
    for shape in [(1,), (127,), (2 ** 20 + 3,), full_shape]:
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(shape, generator=gen, device="cuda")
            w0 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = ops.dual_update(z, w0, beta, force="kernel")
            torch.cuda.synchronize()
            err = max_abs_err(torch, got, ref.dual_update_ref(z, w0, beta))
            worst = max(worst, err)
            line = (f"dual_update shape={shape} w0={dtype} "
                    f"max_abs_err={err:.3g}")
            if err > DUAL_TOL:
                fail(f"{line} > {DUAL_TOL}")
            if shape == full_shape:
                n = z.numel()
                k_ms = time_ms(torch, lambda: ops.dual_update(
                    z, w0, beta, force="kernel"), 20)
                p_ms = time_ms(torch, lambda: ops.dual_update(
                    z, w0, beta, force="ref"), 10)
                l_ms = time_ms(torch, lambda: torch.add(
                    w0, z, alpha=-0.5 / beta), 20)
                b_ms, b_by = bound(n * (4 + w0.element_size() + 4), 2 * n)
                full[dtype] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   shape=f"{tuple(shape)} w0 {dtype}")
                line += (f" ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                         f"library_ms={l_ms:.4f} bound_ms={b_ms:.4f}")
            print(line, flush=True)
            del z, w0, got
    return worst, full


def check_gossip_combine(torch, ops, GossipConsensus, d_full: int):
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, full = 0.0, None
    for graph in ("ring", "torus"):
        strat = GossipConsensus(N_WORKERS, 5, graph)
        src, w = strat.source_rows("cuda"), strat.taps.weights
        k = len(w)
        for d in (129, d_full):
            m = torch.randn((N_WORKERS, d), generator=gen, device="cuda")
            got = ops.gossip_combine(m, src, w, force="kernel")
            torch.cuda.synchronize()
            want = ops.gossip_combine(m, src, w, force="ref")
            err = max_abs_err(torch, got, want)
            del want
            worst = max(worst, err)
            line = (f"gossip_combine {graph} n={N_WORKERS} K={k} D={d} "
                    f"max_abs_err={err:.3g}")
            if err > COMBINE_TOL:
                fail(f"{line} > {COMBINE_TOL}")
            if graph == "ring" and d == d_full:
                # into a buffer kept across rounds, as the main path calls it
                k_ms = time_ms(torch, lambda: ops.gossip_combine(
                    m, src, w, out=got, force="kernel"), 5)
                del got
                p_ms = time_ms(torch, lambda: ops.gossip_combine(
                    m, src, w, force="ref"), 3)
                # the stacked neighbour rows, (n, K, D), and one batched
                # (1, K) x (K, D) product per worker (one bmm: a plain
                # (1, K) x (K, n D) product is past cuBLAS's 2^31 limit)
                stacked = m[src.t().contiguous().long()]
                wt = torch.tensor(w, device="cuda").view(1, 1, k).expand(
                    N_WORKERS, 1, k)
                l_ms = time_ms(torch, lambda: torch.bmm(wt, stacked), 3)
                del stacked
                b_ms, b_by = bound(2 * 4 * m.numel(), 2 * k * m.numel())
                full = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            shape=f"ring n={N_WORKERS} K={k} D={d}")
                line += (f" ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                         f"library_ms={l_ms:.4f} bound_ms={b_ms:.4f}")
            print(line, flush=True)
            del m
            gc.collect()
            torch.cuda.empty_cache()
    return worst, full


def reference_check(torch, rt) -> None:
    """Smoke-size fp32 sessions: card (kernels) vs CPU (plain versions)."""
    cfg = dataclasses.replace(rt.configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    b = [2, 1, 0, 2]
    for consensus in ("exact", "gossip"):
        results = []
        for device in ("cpu", "cuda"):
            gen = torch.Generator().manual_seed(0)
            params = {k: v.to(device) for k, v in
                      rt.models.init_params(cfg, gen).items()}
            s = rt.api.AMBSession(
                rt.api.TrainSpec(smoke=True, data=N_WORKERS,
                                 batch_per_worker=2, seq_len=16),
                rt.api.ClockSpec(kind="simulated"),
                rt.api.ConsensusSpec(consensus=consensus), cfg=cfg,
                params=params, device=device)
            src = rt.data.SyntheticSource(cfg.vocab_size, 16, N_WORKERS, 2,
                                          device="cpu")
            losses = [s.step({k: v.to(device) for k, v in
                              src.batch(e).items()}, b)["loss"]
                      for e in range(2)]
            results.append((losses, {k: v.cpu() for k, v in
                                     s.params.items()}))
        (l_cpu, p_cpu), (l_gpu, p_gpu) = results
        err = max([abs(x - y) for x, y in zip(l_cpu, l_gpu)]
                  + [max_abs_err(torch, p_cpu[k], p_gpu[k]) for k in p_cpu])
        print(f"reference {consensus}: card vs CPU losses {l_gpu} vs "
              f"{l_cpu}, max_abs_err={err:.3g}", flush=True)
        if not err <= SESSION_TOL:
            fail(f"reference {consensus} max_abs_err {err} > {SESSION_TOL}")


def run_session(torch, rt, cfg, consensus: str) -> dict:
    """The main path: AMBSession.step on SyntheticSource batches, EPOCHS
    epochs; returns the launch counts of exactly that run."""
    session = rt.api.AMBSession(
        rt.api.TrainSpec(data=N_WORKERS, batch_per_worker=PER_WORKER,
                         seq_len=SEQ),
        rt.api.ClockSpec(kind="simulated"),
        rt.api.ConsensusSpec(consensus=consensus, graph="ring",
                             gossip_rounds=5),
        cfg=cfg, device="cuda")
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    p = rt.models.param_count(session.model.params())
    print(f"session {consensus}: {cfg.name} layers={cfg.num_layers} "
          f"P={p} workers={N_WORKERS} batch/worker={PER_WORKER} seq={SEQ}",
          flush=True)
    if p != dense_param_count(cfg):
        fail(f"parameter count {p} != {dense_param_count(cfg)}")
    rt.kernels.router.reset_launches()
    for epoch in range(EPOCHS):
        torch.cuda.reset_peak_memory_stats()
        m = session.step(source.batch(epoch))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  epoch {epoch}: loss={m['loss']:.6f} b={m['b'].tolist()} "
              f"global_batch={m['global_batch']} step_ms="
              f"{m['step_s'] * 1e3:.1f} peak_GiB={peak:.2f}", flush=True)
        if not math.isfinite(m["loss"]):
            fail(f"{consensus} epoch {epoch}: loss {m['loss']}")
        if epoch == 0 and abs(m["loss"] - math.log(cfg.vocab_size)) > 3.0:
            fail(f"{consensus}: first loss {m['loss']} is far from "
                 f"ln(vocab) = {math.log(cfg.vocab_size):.3f}")
    launches = rt.kernels.router.launches()
    print(f"  launches: {launches}", flush=True)
    for name, leaf in session.params.items():
        if not bool(torch.isfinite(leaf).all()):
            fail(f"{consensus}: parameter {name} is not finite")
    del session, source
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.api
    import repro_torch.configs
    import repro_torch.data
    import repro_torch.models
    from repro_torch.dist.consensus import GossipConsensus
    from repro_torch.kernels import build, ops, ref, router
    import repro_torch as rt

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    names = build.sources()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.library, names))
    print(f"build: {len(names)} kernels in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(names)})", flush=True)

    full = rt.configs.get_config("qwen2-1.5b")
    gossip_cfg = dataclasses.replace(full, num_layers=GOSSIP_LAYERS)
    beta = rt.core.BetaSchedule(50.0, float(N_WORKERS * PER_WORKER),
                                200.0)(2)
    du_err, du = check_dual_update(
        torch, ops, ref, (full.vocab_size, full.d_model), beta)
    gc_err, gcomb = check_gossip_combine(
        torch, ops, GossipConsensus, dense_param_count(gossip_cfg) + 1)

    reference_check(torch, rt)

    exact = run_session(torch, rt, full, "exact")
    gossip = run_session(torch, rt, gossip_cfg, "gossip")
    if exact.get("dual_update", 0) < 1:
        fail("the exact session never launched dual_update")
    if gossip.get("dual_update", 0) < 1:
        fail("the gossip session never launched dual_update")
    if gossip.get("gossip_combine", 0) != 5 * EPOCHS:
        fail(f"gossip_combine launched {gossip.get('gossip_combine', 0)} "
             f"times, expected {5 * EPOCHS}")

    def per_epoch(name):
        return {s: c[name] / EPOCHS for s, c in
                (("exact", exact), ("gossip", gossip)) if name in c}

    du_row = du[torch.float32]
    kernels = [
        dict(name="dual_update", route="cuda",
             source="src/repro_torch/kernels/csrc/dual_update.cu",
             replaces="src/repro/kernels/dual_update.py:55",
             launches=exact["dual_update"] + gossip["dual_update"],
             launches_per_epoch=per_epoch("dual_update"),
             max_abs_err=du_err, **du_row),
        dict(name="gossip_combine", route="cuda",
             source="src/repro_torch/kernels/csrc/gossip_combine.cu",
             replaces="src/repro/kernels/gossip_combine.py:65",
             launches=gossip["gossip_combine"],
             launches_per_epoch=per_epoch("gossip_combine"),
             max_abs_err=gc_err, **gcomb),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
