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
     for the quantized round, also the time of its two plain-torch steps
     (row grids and draws);
  4. a small reference check: the quantized gossip strategy on a
     smoke-width message stack, and the smoke-size sessions (exact, gossip,
     gossip_q8), on the card (CUDA kernels) against the CPU (plain
     versions), the quantized ones with rounding draws made on the CPU;
  5. the main path: AMBSession on qwen2-1.5b at full width, exact
     consensus, all 28 layers, 3 epochs; ring gossip (r = 5), cut to 8
     layers; ring gossip_q8 (20 rounds) and gossip_q4 (40 rounds), cut to
     4 layers; 3 epochs each; launch counts are reset just before each
     session and read just after;
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
QUANT_LAYERS = 4               # depth cut for the quantized sessions
GOSSIP_ROUNDS = 5              # x 32/bits for the quantized strategies
DUAL_TOL = 2e-6    # multiply by 0.5/beta vs divide by 2 beta: one rounding
COMBINE_TOL = 1e-6  # same products and sums in the same order: expect 0
SESSION_TOL = 1e-4  # fp32 smoke session, card vs CPU (summation order)
CHUNK = 1 << 24    # columns per slice for the plain versions at full shape


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


def in_chunks(fn, d: int) -> None:
    """``fn(a, b)`` on the column slices [a, b) of an (n, d) stack: at the
    main path's shape the plain versions' temporaries do not fit beside
    their inputs in one piece, and they are elementwise per column."""
    for a in range(0, d, CHUNK):
        fn(a, min(a + CHUNK, d))


def check_stochastic_quantize(torch, ops, ref, consensus, d_full: int):
    """Levels and the new replica bit for bit against the plain version;
    at the main path's shape, also the time of the round's two plain-torch
    steps (the row grids and the draws)."""
    row_grids = consensus.row_grids
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, full = 0.0, None
    for d in (1001, 129, d_full):
        m = torch.randn((N_WORKERS, d), generator=gen, device="cuda")
        h = torch.randn((N_WORKERS, d), generator=gen, device="cuda") * 0.3
        rnd = torch.rand((N_WORKERS, d), generator=gen, device="cuda")
        for levels in (255.0, 15.0):
            lo, scale = row_grids(m, h, levels)
            lvl, h_new = ops.stochastic_quantize(m, h, rnd, lo, scale, levels,
                                                 force="kernel")
            torch.cuda.synchronize()
            flips, err = 0, 0.0

            def compare(a, b):
                nonlocal flips, err
                want_l, want_h = ref.stochastic_quantize_ref(
                    m[:, a:b], h[:, a:b], rnd[:, a:b], lo, scale, levels)
                flips += int((want_l != lvl[:, a:b]).sum())
                err = max(err, max_abs_err(torch, want_h, h_new[:, a:b]))

            in_chunks(compare, d)
            worst = max(worst, err, float(flips))
            line = (f"stochastic_quantize n={N_WORKERS} D={d} "
                    f"levels={levels:g} level_mismatches={flips} "
                    f"h_new_max_abs_err={err:.3g}")
            if flips or err:
                fail(f"{line}: levels and h_new must match bit for bit")
            print(line, flush=True)
        if d == d_full:
            # in place over h and into a kept plane, as the main path calls it
            k_ms = time_ms(torch, lambda: ops.stochastic_quantize(
                m, h, rnd, lo, scale, 15.0, out=(lvl, h), force="kernel"), 5)
            p_ms = time_ms(torch, lambda: in_chunks(
                lambda a, b: ref.stochastic_quantize_ref(
                    m[:, a:b], h[:, a:b], rnd[:, a:b], lo, scale, 15.0),
                d), 3)
            n_el = m.numel()
            b_ms, b_by = bound(17 * n_el, 8 * n_el)
            full = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"n={N_WORKERS} D={d}, in place over h")
            print(f"stochastic_quantize n={N_WORKERS} D={d} ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} (column slices of {CHUNK}) "
                  f"library_ms=none bound_ms={b_ms:.4f}", flush=True)
            g_ms = time_ms(torch, lambda: row_grids(m, h, 255.0), 3)
            draws = consensus.epoch_draws(0, 0)
            r_ms = time_ms(torch, lambda: draws(0, rnd), 3)
            print(f"quantized round, plain torch steps at n={N_WORKERS} "
                  f"D={d}: row_grids ms={g_ms:.4f} draws ms={r_ms:.4f}",
                  flush=True)
        del m, h, rnd, lvl, h_new
        gc.collect()
        torch.cuda.empty_cache()
    return worst, full


def check_quantized_combine(torch, ops, ref, GossipConsensus, d_full: int):
    """Output and neighbour replicas against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, full = 0.0, None
    for graph, d in (("ring", 1001), ("torus", 129), ("ring", d_full)):
        strat = GossipConsensus(N_WORKERS, 1, graph)
        src, w = strat.source_rows("cuda"), strat.taps.weights
        k = len(w)
        m = torch.randn((N_WORKERS, d), generator=gen, device="cuda")
        hnbr = torch.randn((k - 1, N_WORKERS, d), generator=gen,
                           device="cuda")
        lo = torch.randn((N_WORKERS, 1), generator=gen, device="cuda")
        scale = torch.rand((N_WORKERS, 1), generator=gen,
                           device="cuda") * 0.01
        for levels in (255, 15):
            lvl = torch.randint(0, levels + 1, (N_WORKERS, d), generator=gen,
                                device="cuda", dtype=torch.uint8)
            out, hnbr_new = ops.quantized_combine(m, hnbr, lvl, lo, scale,
                                                  src, w, force="kernel")
            torch.cuda.synchronize()
            err = 0.0

            def compare(a, b):
                nonlocal err
                want_o, want_h = ref.quantized_combine_ref(
                    m[:, a:b], hnbr[:, :, a:b], lvl[:, a:b], lo, scale, src,
                    w)
                err = max(err, max_abs_err(torch, want_o, out[:, a:b]),
                          max_abs_err(torch, want_h, hnbr_new[:, :, a:b]))

            in_chunks(compare, d)
            del out, hnbr_new
            worst = max(worst, err)
            line = (f"quantized_combine {graph} n={N_WORKERS} K={k} D={d} "
                    f"levels={levels} max_abs_err={err:.3g}")
            if err > COMBINE_TOL:
                fail(f"{line} > {COMBINE_TOL}")
            print(line, flush=True)
        if d == d_full:
            # in place over m and hnbr, as the main path calls it
            k_ms = time_ms(torch, lambda: ops.quantized_combine(
                m, hnbr, lvl, lo, scale, src, w, out=(m, hnbr),
                force="kernel"), 5)
            p_ms = time_ms(torch, lambda: in_chunks(
                lambda a, b: ref.quantized_combine_ref(
                    m[:, a:b], hnbr[:, :, a:b], lvl[:, a:b], lo, scale, src,
                    w), d), 3)
            n_el = m.numel()
            b_ms, b_by = bound(n_el * (4 + 1 + 4 + 8 * (k - 1)),
                               n_el * 4 * k)
            full = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"ring n={N_WORKERS} K={k} D={d}, in place")
            print(f"quantized_combine ring n={N_WORKERS} K={k} D={d} "
                  f"ms={k_ms:.4f} plain_ms={p_ms:.4f} (column slices of "
                  f"{CHUNK}) library_ms=none bound_ms={b_ms:.4f}",
                  flush=True)
        del m, hnbr, lvl
        gc.collect()
        torch.cuda.empty_cache()
    return worst, full


def cpu_draws(torch, rt):
    """A draw source whose draws come from a CPU generator, moved to the
    card: card and CPU runs then round with the same numbers."""
    def source(seed, epoch):
        on_cpu = rt.dist.consensus.epoch_draws(seed, epoch)

        def draws(k, out):
            return out.copy_(on_cpu(k, torch.empty(out.shape)))
        return draws
    return source


def check_quantized_strategy(torch, rt, d: int) -> None:
    """gossip_q8 and gossip_q4 on one smoke-width message stack: the card
    (kernels) against the CPU (plain versions), same draws: expect 0."""
    msg = torch.randn((N_WORKERS, d), generator=torch.Generator().manual_seed(
        5)) * 3.0
    draws = cpu_draws(torch, rt)(0, 0)
    for name in ("gossip_q8", "gossip_q4"):
        strat = rt.dist.consensus.make_strategy(name, N_WORKERS,
                                                rounds=GOSSIP_ROUNDS)
        want = strat.combine(msg.clone(), draws)
        got = strat.combine(msg.cuda(), draws).cpu()
        err = max_abs_err(torch, got, want)
        print(f"reference {name} strategy: n={N_WORKERS} D={d} "
              f"rounds={strat.rounds} card vs CPU max_abs_err={err:.3g}",
              flush=True)
        if err != 0.0:
            fail(f"{name} strategy: card vs CPU differ by {err}")


def reference_check(torch, rt) -> None:
    """Smoke-size fp32 sessions: card (kernels) vs CPU (plain versions)."""
    cfg = dataclasses.replace(rt.configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    b = [2, 1, 0, 2]
    for consensus in ("exact", "gossip", "gossip_q8"):
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
                params=params, device=device,
                draw_source=cpu_draws(torch, rt))
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
                             gossip_rounds=GOSSIP_ROUNDS),
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
    import repro_torch.dist
    import repro_torch.models
    from repro_torch.dist import consensus
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
    quant_cfg = dataclasses.replace(full, num_layers=QUANT_LAYERS)
    d_quant = dense_param_count(quant_cfg) + 1
    beta = rt.core.BetaSchedule(50.0, float(N_WORKERS * PER_WORKER),
                                200.0)(2)
    du_err, du = check_dual_update(
        torch, ops, ref, (full.vocab_size, full.d_model), beta)
    gc_err, gcomb = check_gossip_combine(
        torch, ops, GossipConsensus, dense_param_count(gossip_cfg) + 1)
    sq_err, squant = check_stochastic_quantize(torch, ops, ref, consensus,
                                               d_quant)
    qc_err, qcomb = check_quantized_combine(torch, ops, ref, GossipConsensus,
                                            d_quant)

    smoke = rt.configs.smoke_config("qwen2-1.5b")
    check_quantized_strategy(torch, rt, dense_param_count(smoke) + 1)
    reference_check(torch, rt)

    runs = {"exact": run_session(torch, rt, full, "exact"),
            "gossip": run_session(torch, rt, gossip_cfg, "gossip"),
            "gossip_q8": run_session(torch, rt, quant_cfg, "gossip_q8"),
            "gossip_q4": run_session(torch, rt, quant_cfg, "gossip_q4")}
    for name, counts in runs.items():
        if counts.get("dual_update", 0) < 1:
            fail(f"the {name} session never launched dual_update")
    if runs["gossip"].get("gossip_combine", 0) != GOSSIP_ROUNDS * EPOCHS:
        fail(f"gossip_combine launched "
             f"{runs['gossip'].get('gossip_combine', 0)} times, expected "
             f"{GOSSIP_ROUNDS * EPOCHS}")
    for name, bits in (("gossip_q8", 8), ("gossip_q4", 4)):
        want = {"dual_update": 15 * N_WORKERS * EPOCHS,
                "stochastic_quantize": GOSSIP_ROUNDS * 32 // bits * EPOCHS,
                "quantized_combine": GOSSIP_ROUNDS * 32 // bits * EPOCHS}
        if runs[name] != want:
            fail(f"{name} launched {runs[name]}, expected {want}")

    def launches(name):
        return sum(c.get(name, 0) for c in runs.values())

    def per_epoch(name):
        return {s: c[name] / EPOCHS for s, c in runs.items() if name in c}

    def row(name, replaces, err, timing):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{name}.cu",
                    replaces=replaces, launches=launches(name),
                    launches_per_epoch=per_epoch(name), max_abs_err=err,
                    **timing)

    kernels = [
        row("dual_update", "src/repro/kernels/dual_update.py:55", du_err,
            du[torch.float32]),
        row("gossip_combine", "src/repro/kernels/gossip_combine.py:65",
            gc_err, gcomb),
        row("stochastic_quantize", "src/repro/kernels/gossip_combine.py:131",
            sq_err, squant),
        row("quantized_combine", "src/repro/kernels/gossip_combine.py:194",
            qc_err, qcomb),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
