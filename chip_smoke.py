#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. a CUDA card is present; print its name and power limit (nvidia-smi);
  2. build every CUDA kernel from src/repro_torch/kernels/csrc (one nvcc
     per source, started together) and print the build seconds; print the
     ptxas report (registers, shared memory, spills) of the tensor-core
     flash-attention body, the prox kernel and the scan, none may spill,
     and count the flash body's HGMMA and the scan's HMMA instructions in
     their SASS (cuobjdump), none may be zero;
  3. hold each kernel against its plain PyTorch version on the card, at
     small shapes and at the shapes the main path gives it; print the
     error, the kernel's, the plain version's and one library call's time
     per call (many calls queued between one pair of CUDA events, see
     ``time_ms``), and the least time the card could take; the prox also
     on views offset by 1 and 3 elements with odd lengths;
     for the quantized round, also the time of its two plain-torch steps
     (row grids and draws); flash attention over a sweep of small odd
     shapes (GQA groups 1, 2, 6; causal or not; windows; query offsets,
     rows with no valid key among them; hd 32, 64, 128; fp32 and bf16;
     aligned and unaligned rows; each case names the body that took it,
     and both bodies must have run), then at the prefill shapes of the
     serve run (2048, and the 2592 bucket), the tensor-core body timed
     beside the CUDA-core body; the RWKV6 wkv scan, y and the final
     state, over a sweep of small odd shapes (S not a multiple of the
     chunk and S around the 128-token segment boundaries up to five
     segments, BH 1 to 7, hd 32 and 64, fp32 and bf16, contiguous, the
     model's strided layout and unaligned rows, random u, decays in [0.2,
     1]), in the clip regime against the plain chunked scan at the
     kernel's chunk (within a segment and across three), then at the
     rwkv6-3b prefill shapes (40 heads of 64, S 2048 and 2560) through the
     model's layout, with the segment plan (L, segments, scratch bytes);
  4. a small reference check: the quantized gossip strategy on a
     smoke-width message stack, the smoke-size sessions (exact, gossip,
     gossip_q8), and smoke-size serving of qwen2-1.5b and rwkv6-3b
     (prefill logits and caches or states, slot-engine greedy tokens), on
     the card (CUDA kernels) against the CPU (plain versions), the
     quantized ones with rounding draws made on the CPU;
  5. the main path: AMBSession on qwen2-1.5b at full width, exact
     consensus, all 28 layers, 3 epochs; ring gossip (r = 5), cut to 8
     layers; ring gossip_q8 (20 rounds) and gossip_q4 (40 rounds), cut to
     4 layers; 3 epochs each; launch counts are reset just before each
     run and read just after;
  6. the paper's §6 simulator (``repro_torch.core.engine``) on the card at
     the paper's sizes (see ``SIM_*``): §6.1 linear regression (d =
     100,000) and §6.2 logistic regression (784 x 10), AMB and FMB, one
     prox launch an epoch; checks tests/test_engine.py's criteria, AMB's
     epoch of exactly T + T_c, AMB ahead of FMB at paper_figs' target,
     and a run with the plain prox (identical b(t), losses within
     SIM_TOL); prints epochs/s and each time to target;
  7. the train CLI (``repro_torch.launch.train``) at qwen2-1.5b full
     width on the simulated clock: the LM stream's batch (tokens, labels,
     build time, card tokens equal to the CPU's), then AMB under dual
     averaging (6 epochs), FMB under dual averaging and AMB under AdamW (3
     epochs each), and AMB with ``--prefetch 0`` (6 epochs);
     checks the JSONL keys, b(t) and the simulated wall clock of each, the
     prox launches, and equal losses with and without the prefetcher;
     launch counts are reset just before each run and read just after;
  8. the serve CLI (``repro_torch.launch.serve``) at full width, all 28
     layers, bf16: 16 requests of 2048 +- 512 prompt tokens and 32 new
     tokens over 8 slots, with background exact fine-tune epochs, every
     prefill's attention on the tensor-core body; the same serve run for
     rwkv6-3b at full width, all 32 layers, bf16; launch counts are reset
     just before each run and read just after;
  9. print the kernels' JSON line, the card line, and the final ok line.
"""
import concurrent.futures
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 dense, tensor cores
N_WORKERS, PER_WORKER, SEQ = 4, 8, 256      # the TrainSpec defaults, n = 4
EPOCHS = 3
GOSSIP_LAYERS = 8              # depth cut for the gossip session (memory)
QUANT_LAYERS = 4               # depth cut for the quantized sessions
GOSSIP_ROUNDS = 5              # x 32/bits for the quantized strategies
DUAL_TOL = 2e-6    # multiply by 0.5/beta vs divide by 2 beta: one rounding
COMBINE_TOL = 1e-6  # same products and sums in the same order: expect 0
SESSION_TOL = 1e-4  # fp32 smoke session, card vs CPU (summation order)
CHUNK = 1 << 24    # columns per slice for the plain versions at full shape
FLASH_F32_TOL = 1e-5   # x max(1, max|out|): fp32, another summation order
SERVE_TOL = 1e-4   # fp32 smoke prefill logits, card vs CPU
# the serve CLI runs: prompt 2048 with jitter 512 and 32 new tokens give
# slots of 2592 tokens; qwen2-1.5b prompts pad to the 2048 or the 2592
# bucket, rwkv6-3b prompts prefill at their exact length.  Decode rounds
# are host-bound and read 44 to 90 ms between calls on the same code, so a
# qwen2-1.5b request takes 1.4 to 3 s and arrivals 2 s apart leave idle
# time between requests in most calls; an rwkv6-3b request took up to 3 s
# and its epoch 0.7 to 1.3 s, so its arrivals are 4 s apart.  A fine-tune
# epoch is required where the run left idle time (see ``idle_gaps``)
SERVE_REQUESTS, SERVE_NEW = 16, 32
SERVE_ARGV = ["--arch", "qwen2-1.5b", "--batch", "8",
              "--requests", str(SERVE_REQUESTS), "--prompt-len", "2048",
              "--new-tokens", str(SERVE_NEW), "--arrival-gap", "2.0",
              "--round-budget", "0.25", "--finetune", "2"]
SERVE_RWKV_ARGV = ["--arch", "rwkv6-3b"] + SERVE_ARGV[2:]
SERVE_RWKV_ARGV[SERVE_RWKV_ARGV.index("--arrival-gap") + 1] = "4.0"
# an idle time shorter than this may fall between two rounds unseen
IDLE_MIN_S = 0.01
FLASH_MAIN = dict(b=1, h=12, kv=2, hd=128)     # qwen2-1.5b, batch-1 prefill
FLASH_SEQS = (2048, 2592)
# x max|want|: JAX's own tolerance for the Pallas scan against the
# sequential oracle (tests/test_kernels.py), fp32 with another order
RWKV_TOL = 2e-5
RWKV_MAIN = dict(b=1, h=40, hd=64)    # rwkv6-3b, batch-1 prefill
RWKV_SEQS = (2048, 2560)              # the prompt's mean and its top
RWKV_CHUNK = 16                       # the kernel's (and Pallas's) chunk
SLEEP_CYCLES_PER_S = 2e9   # torch.cuda._sleep's clock, at most ~1.98 GHz
HOLD_S_MAX = 1.0           # the longest device-side hold time_ms queues
# the kernels redesigned for Hopper's tensor cores and memory rate: their
# ptxas reports are printed at set-up (no spills), and the tensor-core
# ones must show their tensor-core instruction in the SASS
REPORTED_KERNELS = ("flash_attention_sm90", "dual_update", "rwkv6_scan")
TENSOR_CORE_SASS = {"flash_attention_sm90": "HGMMA", "rwkv6_scan": "HMMA"}
# the scan's sweep: odd lengths, and those around the segment boundaries
# (segments of 8 chunks of 16 tokens: 128) up to five segments
RWKV_SWEEP_SEQS = (1, 15, 17, 40, 128, 129, 255, 256, 257, 549)
# the paper's §6 simulator (repro_torch.core.engine) at its sizes: §6.1
# linear regression at d = 100,000, n = 10, the paper graph, r = 5, b =
# 600 (b_max 240, chunks of 60), shifted-exponential stragglers (lam 2/3,
# zeta 1, b_ref 600), the Lemma-6 T and T_c = 0.3 T; §6.2 logistic
# regression on LogRegStream's 784 dims and 10 classes, b = 8,000.  At d =
# 100,000 a step of 1/(2 beta) with beta's k = 1 diverges: the minibatch
# Hessian's second moment is (1 + (d+1)/b) I, so least squares takes at
# most 2 / (1 + d/b) and contracts fastest at k = (1 + d/b) / 2, about
# 1 - b/(d+b) an epoch; and b(t) samples an epoch cannot pin d = 100,000
# unknowns before about d / b = 167 epochs.  Reaching 5% of the first
# epoch's loss so takes about 600 epochs (the loss falls about
# exp(-t / 168)), not the 100 of §6.2.
SIM_D, SIM_N = 100_000, 10
SIM_LINREG = dict(b_global=600, epochs=600, k=(1 + 100_000 / 600) / 2)
SIM_LOGREG = dict(b_global=8_000, epochs=100, k=1.0)
SIM_TOL = 1e-4     # kernel prox vs plain prox over the run, relative loss
SIM_TARGET = 0.05  # benchmarks/paper_figs.py: 5% of the gap to the final
# the train CLI at full width (qwen2-1.5b, 28 layers, bf16) on the
# simulated clock: FMB under dual averaging and AMB under AdamW, 3 epochs;
# AMB under dual averaging with the prefetcher and synchronously
# (--prefetch 0), 6 epochs each: the first batch is built before the
# first step in both, so the prefetcher has the other builds to hide
TRAIN_CLI_ARGV = ["--arch", "qwen2-1.5b", "--data", str(N_WORKERS),
                  "--batch-per-worker", str(PER_WORKER), "--seq-len",
                  str(SEQ), "--sim-clock"]
PREFETCH_EPOCHS = 6
# the keys of a JSONL line of the JAX session (its step's out dict less b,
# plus the logger's step and elapsed_s); tests/test_torch_train.py holds
# the port's to JAX's source
JSONL_KEYS = {"step", "elapsed_s", "loss", "global_batch", "budget_s",
              "step_s", "sim_wall_s", "staleness"}
COMM_TIME = 0.5                        # ClockSpec's default T_c


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, what: str) -> float:
    """ms per call of ``fn`` on the card: warm up, then queue ``reps``
    calls between one pair of CUDA events and divide the elapsed time by
    ``reps``.  A device-side sleep queued first holds the stream until the
    host has queued every call, so the host's own work per call (argument
    checks, allocation, the launch itself) overlaps the card's instead of
    adding to it.  A call that synchronises inside (a host-scalar copy)
    still waits for the card; the line says so when the host fell behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(HOLD_S_MAX, reps * (time.perf_counter() - t0) + 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    behind = start.query()
    end.synchronize()
    if behind:
        print(f"time_ms {what}: the host fell behind the card; the time "
              f"includes host time", flush=True)
    return start.elapsed_time(end) / reps


def time_pair(torch, kernel, library, reps: int, what: str) -> tuple:
    """(kernel ms, library ms), each the mean of two ``time_ms`` readings
    taken in turns (library, kernel, kernel, library), so that a drift of
    the card's clocks over the four windows falls on both alike."""
    lib_a = time_ms(torch, library, reps, f"{what} library")
    ker_a = time_ms(torch, kernel, reps, what)
    ker_b = time_ms(torch, kernel, reps, what)
    lib_b = time_ms(torch, library, reps, f"{what} library")
    print(f"time_pair {what}: kernel {ker_a:.4f} {ker_b:.4f} library "
          f"{lib_a:.4f} {lib_b:.4f} ms", flush=True)
    return (ker_a + ker_b) / 2, (lib_a + lib_b) / 2


def max_abs_err(torch, a, b) -> float:
    """max |a - b| in fp32, in chunks (the operands may be 13 GB each)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 27
    err = 0.0
    for i in range(0, a.numel(), step):
        d = (a[i:i + step].float() - b[i:i + step].float()).abs().max()
        err = max(err, float(d.detach()))
    return err


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """Least time (ms) on the card: bytes over HBM rate vs flops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_param_count(cfg) -> int:
    """P of the dense LM from its config (the 15 leaves' sizes)."""
    d, hd, ff = cfg.d_model, cfg.hd, cfg.d_ff
    h, kv = cfg.num_heads, cfg.num_kv_heads
    per_layer = (2 * d + d * h * hd + 2 * d * kv * hd + h * hd * d
                 + 3 * d * ff + (h * hd + 2 * kv * hd) * cfg.qkv_bias)
    return 2 * cfg.vocab_size * d + d + cfg.num_layers * per_layer


def check_dual_update(torch, ops, ref, full_shape, beta: float):
    """The prox against its plain version: whole tensors, views whose
    start is offset by (z, w0) elements with odd lengths (4: 16-byte
    aligned, the vectors and a scalar tail; 1 and 3: the scalar loop),
    then the embed leaf, timed."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, full = 0.0, {}
    cases = [((1,), (0, 0)), ((127,), (0, 0)), ((2 ** 20 + 3,), (0, 0)),
             ((1001,), (1, 1)), ((1001,), (3, 3)), ((1001,), (4, 4)),
             ((2 ** 20 + 3,), (1, 1)), ((2 ** 20 + 3,), (3, 3)),
             ((2 ** 20 + 1,), (1, 3)), ((2 ** 20 + 1,), (4, 4)),
             ((3,), (1, 1)), (full_shape, (0, 0))]
    for shape, (oz, ow) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            n = math.prod(shape)
            z = torch.randn(n + oz, generator=gen, device="cuda")[oz:]
            w0 = torch.randn(n + ow, generator=gen,
                             device="cuda").to(dtype)[ow:]
            z, w0 = z.view(shape), w0.view(shape)
            got = ops.dual_update(z, w0, beta, force="kernel")
            torch.cuda.synchronize()
            err = max_abs_err(torch, got, ref.dual_update_ref(z, w0, beta))
            worst = max(worst, err)
            line = (f"dual_update shape={shape} offsets z={oz} w0={ow} "
                    f"w0={dtype} max_abs_err={err:.3g}")
            if err > DUAL_TOL:
                fail(f"{line} > {DUAL_TOL}")
            if shape == full_shape:
                k_ms, l_ms = time_pair(
                    torch, lambda: ops.dual_update(z, w0, beta,
                                                   force="kernel"),
                    lambda: torch.add(w0, z, alpha=-0.5 / beta), 50,
                    f"dual_update w0 {dtype}")
                p_ms = time_ms(torch, lambda: ops.dual_update(
                    z, w0, beta, force="ref"), 10, "dual_update plain")
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
                # into a buffer kept across rounds, as the main path calls
                # it; timed alone (the library call's stacked rows do not
                # fit beside that buffer)
                k_ms = time_ms(torch, lambda: ops.gossip_combine(
                    m, src, w, out=got, force="kernel"), 5, "gossip_combine")
                del got
                p_ms = time_ms(torch, lambda: ops.gossip_combine(
                    m, src, w, force="ref"), 3, "gossip_combine plain")
                # the stacked neighbour rows, (n, K, D), and one batched
                # (1, K) x (K, D) product per worker (one bmm: a plain
                # (1, K) x (K, n D) product is past cuBLAS's 2^31 limit)
                stacked = m[src.t().contiguous().long()]
                wt = torch.tensor(w, device="cuda").view(1, 1, k).expand(
                    N_WORKERS, 1, k)
                l_ms = time_ms(torch, lambda: torch.bmm(wt, stacked), 3,
                               "torch.bmm")
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


def model_layout(torch, gen, b, sq, skv, h, kv, hd, dtype, aligned=True):
    """q (B, H, Sq, hd), k, v (B, KV, Skv, hd) as the prefill passes them:
    (B, S, heads, hd) storage seen through a transpose.  Unaligned: the
    first hd of hd + 1 columns, so rows do not start 16-byte aligned and
    the kernel takes its element-wise load path."""
    pad = 0 if aligned else 1

    def make(s, heads):
        return torch.randn((b, s, heads, hd + pad), generator=gen,
                           device="cuda").to(dtype)[..., :hd].transpose(1, 2)
    return make(sq, h), make(skv, kv), make(skv, kv)


def flash_tol(torch, want) -> float:
    """fp32: FLASH_F32_TOL x max(1, max|out|); bf16: one bf16 ulp of
    max|out| (kernel and plain version round one fp32 result each)."""
    top = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return FLASH_F32_TOL * max(1.0, top)
    return 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def ulp_stats(torch, got, want) -> str:
    """bf16 outputs against the plain version, element by element, in
    bf16 ulps of each wanted value's own binade: how many differ, how many
    by exactly one ulp, how many of those in the top binade of max|want|
    (the flips the tolerance sees), and the largest distance in ulps below
    the top binade."""
    got, want = got.float().reshape(-1), want.float().reshape(-1)
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    ulps = (got - want).abs() / ulp
    top = ulp == ulp.max()
    below = ulps[~top]
    return (f"{int((ulps > 0).sum())} of {ulps.numel()} differ, "
            f"{int((ulps == 1).sum())} by one ulp, "
            f"{int(((ulps > 0) & top).sum())} in the top binade; max "
            f"{float(below.max()) if below.numel() else 0.0:.3g} ulps "
            f"below it")


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal mask keeps at q_offset 0."""
    n = min(sq, skv)
    return n * (n + 1) // 2 + max(0, sq - skv) * skv


def check_flash_attention(torch, ops, router, flash):
    """The kernel against its plain version: a sweep of small odd shapes,
    each case on the body ``flash.body`` gives it (both bodies must run,
    and the per-body launch counts must agree), then the serve run's
    prefill shapes on the tensor-core body, timed beside the CUDA-core
    body.  Returns the main shape's timing and worst error."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0
    bodies = dict.fromkeys(flash.BODIES, 0)
    worst_ratio = dict.fromkeys(flash.BODIES, 0.0)
    router.reset_launches()
    for h, kv in ((2, 2), (4, 2), (6, 1)):                 # G = 1, 2, 6
        for hd in (32, 64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                worst = 0.0
                group = dict.fromkeys(flash.BODIES, 0)
                for sq in (1, 63, 257):
                    for skv in (1, 63, 257):
                        # Sq = 63: unaligned rows, element-wise loads
                        q, k, v = model_layout(torch, gen, 2, sq, skv, h, kv,
                                               hd, dtype, aligned=sq != 63)
                        which = flash.body(q, k, v)
                        for causal in (True, False):
                            for window in (0, 17):
                                offsets = {0}
                                if sq < skv:
                                    offsets.add(skv - sq)
                                if window:       # rows with no valid key
                                    offsets.add(skv + window)
                                for q_offset in sorted(offsets):
                                    mask = dict(causal=causal, window=window,
                                                q_offset=q_offset)
                                    got = ops.flash_attention(
                                        q, k, v, force="kernel", **mask)
                                    torch.cuda.synchronize()
                                    want = ops.flash_attention(
                                        q, k, v, force="ref", **mask)
                                    err = max_abs_err(torch, got, want)
                                    tol = flash_tol(torch, want)
                                    if not err <= tol:
                                        fail(f"flash_attention {which} H={h}"
                                             f" KV={kv} hd={hd} {dtype} "
                                             f"Sq={sq} Skv={skv} {mask}: "
                                             f"max_abs_err {err} > {tol}")
                                    worst = max(worst, err)
                                    worst_ratio[which] = max(
                                        worst_ratio[which], err / tol)
                                    group[which] += 1
                                    cases += 1
                for name, n in group.items():
                    bodies[name] += n
                print(f"flash_attention sweep H={h} KV={kv} hd={hd} {dtype}:"
                      f" max_abs_err={worst:.3g}; cases per body {group}",
                      flush=True)
    counted = {b: router.launches().get(f"flash_attention.{b}", 0)
               for b in flash.BODIES}
    ratios = ", ".join(f"{b} {r:.3f}" for b, r in worst_ratio.items())
    print(f"flash_attention sweep: {cases} cases, worst error per body "
          f"({ratios}) of its tolerance; cases per body {bodies}",
          flush=True)
    if counted != bodies:
        fail(f"flash_attention sweep: launches per body {counted}, expected "
             f"{bodies}")
    if not all(bodies.values()):
        fail(f"flash_attention sweep: a body never ran: {bodies}")
    main = None
    for s in FLASH_SEQS:
        b, h, kv, hd = (FLASH_MAIN[x] for x in ("b", "h", "kv", "hd"))
        q, k, v = model_layout(torch, gen, b, s, s, h, kv, hd,
                               torch.bfloat16)
        if flash.body(q, k, v) != "tensor_core":
            fail(f"flash_attention S={s}: the model's layout took the "
                 f"{flash.body(q, k, v)} body")
        got = ops.flash_attention(q, k, v, force="kernel")
        torch.cuda.synchronize()
        want = ops.flash_attention(q, k, v, force="ref")
        err, tol = max_abs_err(torch, got, want), flash_tol(torch, want)
        old = flash.flash_attention_cuda(q, k, v, force_body="cuda_core")
        torch.cuda.synchronize()
        err_old = max_abs_err(torch, old, want)
        line = (f"flash_attention B={b} H={h} KV={kv} hd={hd} S={s} bf16 "
                f"causal max_abs_err={err:.3g} (tensor_core), "
                f"{err_old:.3g} (cuda_core) (tol {tol:.3g})")
        if not (err <= tol and err_old <= tol):
            fail(line)
        print(f"flash_attention S={s} bf16 ulps: tensor_core "
              f"{ulp_stats(torch, got, want)}; cuda_core "
              f"{ulp_stats(torch, old, want)}", flush=True)
        k_ms, l_ms = time_pair(
            torch, lambda: ops.flash_attention(q, k, v, force="kernel"),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 200,
            f"flash_attention tensor_core S={s}")
        c_ms = time_ms(torch, lambda: flash.flash_attention_cuda(
            q, k, v, force_body="cuda_core"), 50,
            "flash_attention cuda_core")
        p_ms = time_ms(torch, lambda: ops.flash_attention(
            q, k, v, force="ref"), 10, "flash_attention plain")
        flops = 4 * b * h * hd * causal_pairs(s, s)
        nbytes = 2 * b * hd * s * (2 * h + 2 * kv)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        print(f"{line} ms={k_ms:.4f} cuda_core_ms={c_ms:.4f} plain_ms="
              f"{p_ms:.4f} library_ms={l_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; "
              f"tensor_core {flops / k_ms / 1e9:.1f} TFLOP/s)", flush=True)
        if main is None:
            main = dict(ms=k_ms, cuda_core_ms=c_ms, plain_ms=p_ms,
                        library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                        max_abs_err=err,
                        shape=f"B={b} H={h} KV={kv} hd={hd} "
                              f"Sq=Skv={s} bf16 causal, tensor_core body")
        del q, k, v, got, want, old
    return main


def rwkv_inputs(torch, gen, b, s, h, hd, dtype, layout, lo=0.2, hi=1.0):
    """r, k, v in ``dtype`` and decay in [lo, hi] as (B, H, S, hd), u (H,
    hd) ~ N(0, 1).  Layout "model": (B, S, H, hd) storage seen through a
    transpose, as prefill passes it (decay fp32); "unaligned": the first hd
    of hd + 1 columns of such storage, so rows are not 16-byte aligned and
    the kernel loads element-wise (decay fp32); "flat": contiguous (B, H,
    S, hd), decay in ``dtype``."""
    pad = 1 if layout == "unaligned" else 0

    def view(t, dt):
        t = t.to(dt)[..., :hd].transpose(1, 2)
        return t.contiguous() if layout == "flat" else t
    shape = (b, s, h, hd + pad)
    r, k, v = (view(torch.randn(shape, generator=gen, device="cuda"), dtype)
               for _ in range(3))
    d_dtype = dtype if layout == "flat" else torch.float32
    decay = view(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                             device="cuda"), d_dtype)
    return r, k, v, decay, torch.randn((h, hd), generator=gen, device="cuda")


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want| (the tolerance JAX states)."""
    return max_abs_err(torch, got, want) / max(
        float(want.float().abs().max()), 1e-30)


def check_rwkv6_scan(torch, ops, ssm, scan):
    """The scan kernel against its plain version (y and the final state):
    a sweep of small odd shapes, the clip regime against the plain chunked
    scan at the kernel's chunk (within one segment and across three),
    then the rwkv6-3b prefill shapes, timed, with the segment plan.
    Returns the worst error and the main shape's timing."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases, worst = 0, 0.0
    for hd in (32, 64):
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("flat", "model", "unaligned"):
                for b, h in ((1, 1), (1, 3), (2, 2), (1, 7)):
                    for s in RWKV_SWEEP_SEQS:
                        ins = rwkv_inputs(torch, gen, b, s, h, hd, dtype,
                                          layout)
                        got = ops.rwkv6_scan(*ins, force="kernel")
                        torch.cuda.synchronize()
                        want = ops.rwkv6_scan(*ins, force="ref")
                        err = max(rel_err(torch, g, w)
                                  for g, w in zip(got, want))
                        if not err <= RWKV_TOL:
                            fail(f"rwkv6_scan B={b} H={h} S={s} hd={hd} "
                                 f"{dtype} {layout}: error {err} of max|y|"
                                 f" or max|state| > {RWKV_TOL}")
                        worst = max(worst, err)
                        cases += 1
            print(f"rwkv6_scan sweep hd={hd} {dtype}: worst error "
                  f"{worst:.3g} of max|out|", flush=True)
    print(f"rwkv6_scan sweep: {cases} cases, y and state within "
          f"{RWKV_TOL} of max|out|", flush=True)
    # the last two span three segments
    for b, h, s, hd in ((1, 3, 100, 64), (2, 2, 37, 32), (1, 3, 300, 64),
                        (2, 2, 270, 32)):
        ins = rwkv_inputs(torch, gen, b, s, h, hd, torch.float32, "model",
                          lo=1e-6, hi=0.05)
        got = ops.rwkv6_scan(*ins, force="kernel")
        torch.cuda.synchronize()
        r, k, v, d, u = ins
        y, st = ssm.rwkv6_chunked_scan(
            *(t.transpose(1, 2).float() for t in (r, k, v, d)), u,
            RWKV_CHUNK)
        err = max(rel_err(torch, got[0], y.transpose(1, 2)),
                  rel_err(torch, got[1], st))
        seq_gap = rel_err(torch, ops.rwkv6_scan(*ins, force="ref")[0],
                          y.transpose(1, 2))
        print(f"rwkv6_scan clip regime B={b} H={h} S={s} hd={hd} decays in"
              f" [1e-6, 0.05]: vs chunked scan at C={RWKV_CHUNK} error "
              f"{err:.3g}; the sequential oracle is {seq_gap:.3g} away",
              flush=True)
        if not err <= RWKV_TOL:
            fail(f"rwkv6_scan clip regime error {err} > {RWKV_TOL}")
        worst = max(worst, err)
    main = None
    b, h, hd = (RWKV_MAIN[x] for x in ("b", "h", "hd"))
    for s in RWKV_SEQS:
        ins = rwkv_inputs(torch, gen, b, s, h, hd, torch.bfloat16, "model")
        got = ops.rwkv6_scan(*ins, force="kernel")
        torch.cuda.synchronize()
        want = ops.rwkv6_scan(*ins, force="ref")
        err = max(rel_err(torch, g, w) for g, w in zip(got, want))
        plan = scan.launch_plan(b, h, s, hd)
        line = (f"rwkv6_scan B={b} H={h} hd={hd} S={s} r/k/v bf16 decay "
                f"fp32, model layout, L={plan['seg_chunks']} "
                f"segments={plan['segments']} blocks="
                f"{plan['segments'] * h * b} scratch_bytes="
                f"{plan['scratch_floats'] * 4}: error {err:.3g} of "
                f"max|out|")
        if not err <= RWKV_TOL:
            fail(f"{line} > {RWKV_TOL}")
        k_ms = time_ms(torch, lambda: ops.rwkv6_scan(*ins, force="kernel"),
                       100, "rwkv6_scan")
        p_ms = time_ms(torch, lambda: ops.rwkv6_scan(*ins, force="ref"), 3,
                       "rwkv6_scan plain")
        n = b * h * s * hd
        nbytes = 3 * 2 * n + 4 * n + 4 * n + 4 * b * h * hd * hd + 4 * h * hd
        # per token and head: the inter-chunk term r.state and the state
        # update k^T v (2 hd^2 each), the causal part of the chunk's tile
        # (rd.kd^T and att.v over the C - 1 earlier tokens of a chunk on
        # average half: 2 (C - 1) hd) and the bonus (r u.k, then times v:
        # 5 hd), as the flash row counts causal pairs only
        flops = b * h * s * (4 * hd * hd + 2 * (RWKV_CHUNK - 1) * hd
                             + 5 * hd)
        b_ms, b_by = bound(nbytes, flops)
        print(f"{line} ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms=none "
              f"bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
        if main is None:
            main = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"B={b} H={h} hd={hd} S={s}, r/k/v bf16, "
                              f"decay fp32, model layout")
        worst = max(worst, err)
        del ins, got, want
    return worst, main


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
                m, h, rnd, lo, scale, 15.0, out=(lvl, h), force="kernel"), 5,
                "stochastic_quantize")
            p_ms = time_ms(torch, lambda: in_chunks(
                lambda a, b: ref.stochastic_quantize_ref(
                    m[:, a:b], h[:, a:b], rnd[:, a:b], lo, scale, 15.0),
                d), 3, "stochastic_quantize plain")
            n_el = m.numel()
            b_ms, b_by = bound(17 * n_el, 8 * n_el)
            full = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"n={N_WORKERS} D={d}, in place over h")
            print(f"stochastic_quantize n={N_WORKERS} D={d} ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} (column slices of {CHUNK}) "
                  f"library_ms=none bound_ms={b_ms:.4f}", flush=True)
            g_ms = time_ms(torch, lambda: row_grids(m, h, 255.0), 3,
                           "row_grids")
            draws = consensus.epoch_draws(0, 0)
            r_ms = time_ms(torch, lambda: draws(0, rnd), 3, "draws")
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
                force="kernel"), 5, "quantized_combine")
            p_ms = time_ms(torch, lambda: in_chunks(
                lambda a, b: ref.quantized_combine_ref(
                    m[:, a:b], hnbr[:, :, a:b], lvl[:, a:b], lo, scale, src,
                    w), d), 3, "quantized_combine plain")
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


def drain(engine, reqs) -> None:
    """Serve ``reqs`` clock-free: insert as slots free up, decode rounds."""
    pending = list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()


def serve_reference_check(torch, rt, arch: str) -> None:
    """Smoke-size fp32 serving, card (kernels) vs CPU (plain versions):
    prefill logits and caches (dense: the K cache, with right-padded rows;
    ssm: the wkv states, exact lengths) within SERVE_TOL, slot-engine
    greedy tokens equal."""
    cfg = dataclasses.replace(rt.configs.smoke_config(arch), dtype="float32")
    kernel = "rwkv6_scan" if cfg.family == "ssm" else "flash_attention"
    params = rt.models.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen)
    last = None if cfg.family == "ssm" else torch.tensor([39, 17, 26])
    out, tokens = {}, {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device) for k, v in params.items()}
        rt.kernels.router.reset_launches()
        logits, state = rt.models.prefill(
            p, cfg, {"tokens": toks.to(device)}, extra_capacity=8,
            last_pos=None if last is None else last.to(device))
        engine = rt.serve.SlotEngine(p, cfg, slots=2, cache_len=64)
        reqs = rt.serve.synthetic_requests(
            5, vocab_size=cfg.vocab_size, prompt_len=24, prompt_jitter=8,
            max_new_tokens=8, seed=3)
        drain(engine, reqs)
        launches = rt.kernels.router.launches().get(kernel, 0)
        if (device == "cuda") != (launches > 0):
            fail(f"serve reference {arch} on {device}: {launches} {kernel} "
                 f"launches")
        caches = (state.caches["tmix"].s if cfg.family == "ssm"
                  else state.caches.k)
        out[device] = (logits.cpu(), caches.cpu())
        tokens[device] = [r.out_tokens for r in reqs]
    err = max(max_abs_err(torch, a, b) for a, b in zip(out["cpu"],
                                                       out["cuda"]))
    print(f"reference serve {arch}: prefill logits and "
          f"{'states' if cfg.family == 'ssm' else 'caches'} card vs CPU "
          f"max_abs_err={err:.3g}; slot-engine tokens equal: "
          f"{tokens['cpu'] == tokens['cuda']}", flush=True)
    if not err <= SERVE_TOL:
        fail(f"serve reference max_abs_err {err} > {SERVE_TOL}")
    if tokens["cpu"] != tokens["cuda"]:
        fail(f"greedy tokens differ: card {tokens['cuda']} vs CPU "
             f"{tokens['cpu']}")


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


def idle_gaps(requests) -> list:
    """Seconds in which no request was in the engine and the next had not
    arrived, one entry for each such stretch between two requests.  The
    scheduler spends idle time on fine-tune epochs: its first epoch runs in
    the first such stretch whatever it costs (an unknown cost counts as
    zero), so a run with one must absorb an epoch."""
    gaps, busy_until = [], None
    for r in sorted(requests, key=lambda r: r.arrival_s):
        if busy_until is not None and r.arrival_s > busy_until:
            gaps.append(r.arrival_s - busy_until)
        busy_until = max(busy_until or r.finish_s, r.finish_s)
    return gaps


def timed(table: dict, key: str, fn):
    """``fn`` with the host seconds of each call appended to table[key]
    (each of the wrapped calls ends in a device sync: a token read back,
    or the session step's synchronize)."""
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        table.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return wrapper


def run_serve(torch, rt, argv) -> dict:
    """The serve CLI at full width (``argv``: SERVE_ARGV or its rwkv6-3b
    form): returns the launch counts of exactly that run.  The engine's
    sampler is wrapped to see every logits tensor it draws from, and the
    engine's insert (a prefill) and decode round and the session's step
    are timed.  Each request's prefill launches its attention kernel
    (dense) or its scan kernel (ssm) once a layer, and each exact fine-tune
    epoch the prox kernel once a parameter leaf."""
    from repro_torch.api import AMBSession
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve import slots
    sample, seen = slots.sample_token, []
    wrapped = [(slots.SlotEngine, "insert"), (slots.SlotEngine,
                                              "decode_round"),
               (AMBSession, "step")]
    originals = [getattr(owner, name) for owner, name in wrapped]
    split: dict = {}

    def checked(logits, *args, **kw):
        seen.append(int((~torch.isfinite(logits)).sum()))
        return sample(logits, *args, **kw)

    slots.sample_token = checked
    for (owner, name), fn in zip(wrapped, originals):
        setattr(owner, name, timed(split, name, fn))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt.kernels.router.reset_launches()
    t0 = time.perf_counter()
    try:
        report = serve_main(argv)
    finally:
        slots.sample_token = sample
        for (owner, name), fn in zip(wrapped, originals):
            setattr(owner, name, fn)
    wall = time.perf_counter() - t0
    launches = rt.kernels.router.launches()
    arch = argv[argv.index("--arch") + 1]
    cfg = rt.configs.get_config(arch)
    leaves = len(rt.models.init_params(rt.configs.smoke_config(arch),
                                       torch.Generator()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = report.summary
    print(f"serve: {cfg.name} layers={cfg.num_layers} {cfg.dtype} "
          f"requests={s['n_requests']} rounds={report.rounds} "
          f"fine-tune epochs={report.train_epochs} wall_s={wall:.1f} "
          f"peak_GiB={peak:.2f}", flush=True)
    print(f"  ttft_s p50={s['ttft_p50_s']:.4f} p99={s['ttft_p99_s']:.4f} "
          f"tpot_s p50={s['tpot_p50_s']:.4f} p99={s['tpot_p99_s']:.4f} "
          f"latency_s p50={s['latency_p50_s']:.4f} "
          f"p99={s['latency_p99_s']:.4f} tokens_per_s="
          f"{s['tokens_per_s']:.2f} train_loss={s.get('train_loss_first')}"
          f"..{s.get('train_loss_last')}", flush=True)
    for name, label in (("insert", "prefill (insert)"),
                        ("decode_round", "decode round"),
                        ("step", "fine-tune epoch")):
        ts = sorted(split.get(name, []))
        if ts:
            print(f"  {label}: n={len(ts)} total_s={sum(ts):.3f} median_s="
                  f"{ts[len(ts) // 2]:.4f} min_s={ts[0]:.4f} max_s="
                  f"{ts[-1]:.4f}", flush=True)
    print(f"  launches: {launches}", flush=True)
    gaps = [g for g in idle_gaps(report.requests) if g > IDLE_MIN_S]
    print(f"  idle between requests: {len(gaps)} stretches, {sum(gaps):.3f}"
          f" s in all; fine-tune epochs absorbed {report.train_epochs}",
          flush=True)
    done = [r for r in report.requests
            if len(r.out_tokens) == SERVE_NEW and r.finish_reason == "length"]
    if len(done) != SERVE_REQUESTS:
        fail(f"serve: {len(done)} of {SERVE_REQUESTS} requests finished "
             f"with {SERVE_NEW} tokens")
    prefill_kernel, other = (("rwkv6_scan", "flash_attention")
                             if cfg.family == "ssm"
                             else ("flash_attention", "rwkv6_scan"))
    want = {prefill_kernel: cfg.num_layers * SERVE_REQUESTS, other: 0,
            "dual_update": leaves * report.train_epochs}
    if cfg.family != "ssm":     # every prefill on the tensor cores
        want["flash_attention.tensor_core"] = want["flash_attention"]
        want["flash_attention.cuda_core"] = 0
    for name, n in want.items():
        if launches.get(name, 0) != n:
            fail(f"serve {cfg.name}: {name} launched "
                 f"{launches.get(name, 0)} times, expected {n} "
                 f"({report.train_epochs} exact epochs of {leaves} leaves)")
    if gaps and report.train_epochs < 1:
        fail(f"serve: {len(gaps)} idle stretches absorbed no fine-tune "
             f"epoch")
    if report.train_epochs:
        losses = [s["train_loss_first"], s["train_loss_last"]]
        if not all(math.isfinite(x) for x in losses):
            fail(f"serve: fine-tune losses {losses}")
    if any(seen) or len(seen) < SERVE_REQUESTS:
        fail(f"serve: {sum(seen)} non-finite logits over {len(seen)} draws")
    return launches


def time_to(history, target: float) -> float:
    """First simulated wall time at which the eval loss is <= target
    (``benchmarks/paper_figs.py``'s ``_time_to_error``)."""
    loss = history.eval_loss.cpu().numpy()
    hit = [i for i, x in enumerate(loss) if x <= target]
    return float(history.wall_time[hit[0]]) if hit else float("inf")


def sim_run(torch, rt, label, objective, model, cfg, mode, epochs, **kw):
    """One engine run on the card from generator seed 0; prints its rate."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = rt.core.engine.run(objective, model, cfg, mode=mode, epochs=epochs,
                           generator=gen, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    loss = h.eval_loss.cpu().numpy()
    print(f"  {label} {mode}: {epochs} epochs in {dt:.3f} s "
          f"({epochs / dt:.1f} epochs/s), eval loss {loss[0]:.6g} -> "
          f"{loss[-1]:.6g} ({loss[-1] / loss[0]:.4g} of the first), mean "
          f"b(t) {float(h.global_batch.float().mean()):.2f}, wall "
          f"{float(h.wall_time[-1]):.2f} s", flush=True)
    for name in ("eval_loss", "train_loss", "consensus_eps", "regret"):
        if not bool(torch.isfinite(getattr(h, name)).all()):
            fail(f"simulator {label} {mode}: {name} is not finite")
    return h, dt


def run_simulator(torch, rt) -> dict:
    """The §6 simulator at the paper's sizes (see SIM_*): AMB and FMB on
    linear and logistic regression, launch counts reset just before and
    read just after; then the linear AMB run again with the plain prox.
    Checks tests/test_engine.py's criteria, AMB's epoch of exactly T +
    T_c, AMB ahead of FMB at paper_figs' target, and the kernel prox
    against the plain one (b(t) identical, losses within SIM_TOL)."""
    import numpy as np
    core, data, router = rt.core, rt.data, rt.kernels.router
    beta = core.dual_averaging.BetaSchedule
    out = {"launches": {}, "rows": {}}
    lin = core.objectives.LinearRegression(dim=SIM_D)
    w_star = data.LinRegStream(dim=SIM_D, seed=42, device="cuda").w_star()
    stream = data.LogRegStream(seed=3, device="cuda")
    log = core.objectives.LogisticRegression(dim=stream.dim,
                                             num_classes=stream.num_classes)
    means = stream.class_means()
    eval_batch = log.sample(torch.Generator(device="cuda").manual_seed(9),
                            (2048,), means)
    cases = (("linreg", lin, SIM_LINREG, dict(
        sample_args=(w_star,), f_star=0.5 * lin.noise_var,
        eval_fn=lambda w: lin.population_loss(w, w_star))),
        ("logreg", log, SIM_LOGREG, dict(
            sample_args=(means,),
            eval_fn=lambda w: log.loss(w, eval_batch))))
    for label, objective, size, kw in cases:
        b_global, epochs = size["b_global"], size["epochs"]
        per = b_global // SIM_N
        model = core.ShiftedExponential(lam=2 / 3, zeta=1.0, b_ref=b_global)
        t_budget = core.amb_budget_from_fmb(model, SIM_N, b_global)
        cfg = core.EngineConfig(
            n=SIM_N, b_max=4 * per, chunk=per, compute_time=t_budget,
            comm_time=0.3 * t_budget, fmb_batch_per_node=per, graph="paper",
            consensus_rounds=5,
            beta=beta(k=size["k"], mu=float(b_global)))
        print(f"simulator {label}: d={objective.init_w().shape[0]} "
              f"n={SIM_N} b={b_global} b_max={cfg.b_max} chunk={cfg.chunk} "
              f"graph=paper r=5 T={t_budget:.6f} T_c={cfg.comm_time:.6f} "
              f"beta k={size['k']:.4f}", flush=True)
        router.reset_launches()
        h_amb, s_amb = sim_run(torch, rt, label, objective, model, cfg, "amb",
                               epochs, **kw)
        h_fmb, s_fmb = sim_run(torch, rt, label, objective, model, cfg, "fmb",
                               epochs, **kw)
        launches = router.launches()
        out["launches"][label] = launches
        print(f"  launches (AMB and FMB): {launches}", flush=True)
        if launches.get("dual_update", 0) != 2 * epochs:
            fail(f"simulator {label}: dual_update launched "
                 f"{launches.get('dual_update', 0)} times, expected "
                 f"{2 * epochs} (one prox per epoch)")
        la, lf = (h.eval_loss.cpu().numpy() for h in (h_amb, h_fmb))
        lmin = max(la[-1], lf[-1])
        target = lmin + SIM_TARGET * (la[0] - lmin)
        t_amb, t_fmb = time_to(h_amb, target), time_to(h_fmb, target)
        print(f"  time to target {target:.6g}: AMB {t_amb:.3f} s, FMB "
              f"{t_fmb:.3f} s, FMB / AMB {t_fmb / t_amb:.4f}", flush=True)
        if not t_amb < t_fmb:
            fail(f"simulator {label}: AMB reached the target at {t_amb} s, "
                 f"FMB at {t_fmb} s")
        if label == "linreg":
            if not la[-1] < 0.05 * la[0]:
                fail(f"simulator linreg: AMB eval loss {la[-1]} is not "
                     f"below 5% of {la[0]}")
            if not la[-1] < 3 * lf[-1]:
                fail(f"simulator linreg: AMB {la[-1]} vs FMB {lf[-1]}")
        elif not la[-1] < 0.6 * la[0]:
            fail(f"simulator logreg: AMB eval loss {la[-1]} is not below "
                 f"60% of {la[0]}")
        clock, want = np.float32(0.0), []
        for _ in range(epochs):
            clock = np.float32(clock + np.float32(cfg.compute_time
                                                  + cfg.comm_time))
            want.append(clock)
        if not np.array_equal(h_amb.wall_time.cpu().numpy(), want):
            fail(f"simulator {label}: AMB's epochs are not T + T_c")
        out["rows"][label] = dict(epochs_per_s=(epochs / s_amb,
                                                epochs / s_fmb),
                                  t_amb=t_amb, t_fmb=t_fmb)
        if label != "linreg":
            continue
        router.reset_launches()
        router.set_mode("ref")
        try:
            h_ref, _ = sim_run(torch, rt, "linreg plain prox", objective,
                               model, cfg, "amb", epochs, **kw)
        finally:
            router.set_mode(None)
        if router.launches().get("dual_update", 0):
            fail("simulator: the plain-prox run launched the kernel")
        same_b = torch.equal(h_ref.batch_sizes, h_amb.batch_sizes)
        errs = {name: float(((getattr(h_ref, name) - getattr(h_amb, name))
                             .abs() / getattr(h_ref, name).abs()
                             .clamp(min=1e-30)).max())
                for name in ("eval_loss", "train_loss")}
        print(f"  kernel prox vs plain prox: b(t) identical {same_b}; "
              f"relative loss differences {errs} (tolerance {SIM_TOL})",
              flush=True)
        if not same_b or max(errs.values()) > SIM_TOL:
            fail(f"simulator: kernel prox vs plain prox {same_b} {errs}")
        out["prox_err"] = max(errs.values())
    return out


def check_lm_stream(torch, rt, vocab: int) -> float:
    """The CLI's LM batch (4 x 8 x 256 at the full vocab) from the
    session's source: tokens in [0, V), labels shifted with -1 last; the
    card's tokens equal the CPU's on a short sequence; returns the build
    time of one batch (ms, host clock around a synced build)."""
    stream = rt.data.LMTokenStream(vocab, SEQ, seed=0, device="cuda")
    src = rt.data.StreamSource(stream, N_WORKERS, PER_WORKER)
    times = []
    for epoch in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = src.batch(epoch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    toks, labels = batch["tokens"], batch["labels"]
    if tuple(toks.shape) != (N_WORKERS * PER_WORKER, SEQ):
        fail(f"LM batch shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= vocab:
        fail(f"LM tokens outside [0, {vocab})")
    if not (torch.equal(labels[:, :-1], toks[:, 1:])
            and bool((labels[:, -1] == -1).all())):
        fail("LM labels are not the tokens shifted, -1 last")
    short = [rt.data.LMTokenStream(vocab, 16, seed=1, device=d).batch(
        2, 3, 2)["tokens"].cpu() for d in ("cuda", "cpu")]
    if not torch.equal(*short):
        fail("the LM stream's card tokens differ from the CPU's")
    print(f"LM stream: V={vocab} batch {N_WORKERS} x {PER_WORKER} x {SEQ}"
          f" build ms {', '.join(f'{t:.1f}' for t in times)} (the first "
          f"warms up); card tokens equal the CPU's", flush=True)
    return min(times[1:])


def run_train_cli(torch, rt, extra, label: str, steps: int) -> dict:
    """``repro_torch.launch.train.main`` at full width (TRAIN_CLI_ARGV plus
    ``extra``, ``steps`` epochs); launch counts reset just before and read
    just after.
    Returns the JSONL lines, the loss, the counts, the peak memory and
    the host seconds of ``AMBSession.run`` and of each step."""
    from repro_torch.api import AMBSession
    from repro_torch.launch.train import main as train_main
    split: dict = {}
    originals = {name: getattr(AMBSession, name) for name in ("run",
                                                              "step")}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "train.jsonl"
        for name, fn in originals.items():
            setattr(AMBSession, name, timed(split, name, fn))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rt.kernels.router.reset_launches()
        try:
            loss = train_main(TRAIN_CLI_ARGV + extra + [
                "--steps", str(steps), "--metrics", str(path)])
        finally:
            for name, fn in originals.items():
                setattr(AMBSession, name, fn)
        launches = rt.kernels.router.launches()
        lines = rt.metrics.read_metrics(path)
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_times = split.get("step", [])
    print(f"train CLI {label}: losses {[ln['loss'] for ln in lines]} b(t) "
          f"{[ln['global_batch'] for ln in lines]} step_s "
          f"{[round(t, 4) for t in step_times]} run_s {split['run'][0]:.3f} "
          f"peak_GiB={peak:.2f} launches {launches}", flush=True)
    if len(lines) != steps or not all(math.isfinite(ln["loss"])
                                       for ln in lines):
        fail(f"train CLI {label}: lines {lines}")
    if any(set(ln) != JSONL_KEYS for ln in lines):
        fail(f"train CLI {label}: JSONL keys {sorted(lines[0])}")
    if loss != lines[-1]["loss"]:
        fail(f"train CLI {label}: returned {loss}, logged {lines[-1]}")
    return dict(lines=lines, launches=launches, peak=peak,
                run_s=split["run"][0], step_times=step_times)


def check_train_cli(torch, rt, full) -> dict:
    """The train CLI phase: the LM stream, then AMB, FMB, AdamW AMB and a
    synchronous AMB at full width (see TRAIN_CLI_ARGV)."""
    build_ms = check_lm_stream(torch, rt, full.vocab_size)
    runs = {"amb": run_train_cli(torch, rt, ["--mode", "amb"], "amb",
                                 PREFETCH_EPOCHS),
            "fmb": run_train_cli(torch, rt, ["--mode", "fmb"], "fmb",
                                 EPOCHS),
            "adamw": run_train_cli(torch, rt, ["--mode", "amb",
                                               "--optimizer", "adamw"],
                                   "adamw amb", EPOCHS),
            "sync": run_train_cli(torch, rt, ["--mode", "amb",
                                              "--prefetch", "0"],
                                  "amb --prefetch 0", PREFETCH_EPOCHS)}
    leaves = len(rt.models.init_params(rt.configs.smoke_config(
        "qwen2-1.5b"), torch.Generator()))
    for name in ("amb", "fmb", "sync"):
        got = runs[name]["launches"].get("dual_update", 0)
        want = leaves * len(runs[name]["lines"])
        if got != want:
            fail(f"train CLI {name}: dual_update launched {got} times, "
                 f"expected {want}")
    if runs["adamw"]["launches"]:
        fail(f"train CLI adamw: launched {runs['adamw']['launches']}")
    # the simulated clock: AMB adds T + T_c an epoch, FMB the slowest
    # worker's batch_per_worker gradients, then T_c (the session's clock
    # draws, replayed)
    for name in ("amb", "adamw", "sync"):
        wall = 0.0
        for ln in runs[name]["lines"]:
            wall += ln["budget_s"] + COMM_TIME
            if ln["sim_wall_s"] != wall:
                fail(f"train CLI {name}: sim_wall_s {ln['sim_wall_s']} != "
                     f"{wall}")
    twin = rt.api.clock.make_clock(rt.api.ClockSpec(kind="simulated"),
                                   N_WORKERS, PER_WORKER)
    wall = 0.0
    for epoch, ln in enumerate(runs["fmb"]["lines"]):
        times, _ = twin.epoch(torch.Generator().manual_seed(
            10_000 + epoch))
        wall += float(rt.core.fmb_finish_times(times, PER_WORKER).max()) \
            + COMM_TIME
        if ln["global_batch"] != N_WORKERS * PER_WORKER \
                or ln["sim_wall_s"] != wall:
            fail(f"train CLI fmb: line {ln}, expected b(t) "
                 f"{N_WORKERS * PER_WORKER} and sim_wall_s {wall}")
    same = [a["loss"] for a in runs["amb"]["lines"]] == \
        [b["loss"] for b in runs["sync"]["lines"]]
    # the first batch is built before the first step in both runs: the
    # other PREFETCH_EPOCHS - 1 builds are what a prefetcher can overlap
    # (a synchronous step also waits for its batch's graph replay, queued
    # on the same stream)
    hidden_ms = (runs["sync"]["run_s"] - runs["amb"]["run_s"]) * 1e3
    could_ms = (PREFETCH_EPOCHS - 1) * build_ms
    print(f"train CLI: prefetch 2 and 0 give identical losses: {same}; "
          f"run_s prefetch 2 {runs['amb']['run_s']:.4f}, prefetch 0 "
          f"{runs['sync']['run_s']:.4f} ({PREFETCH_EPOCHS} epochs); stream "
          f"build {build_ms:.1f} ms a batch; the prefetcher hid "
          f"{hidden_ms:.1f} ms of the {could_ms:.1f} ms of builds it could "
          f"overlap ({hidden_ms / could_ms:.2f})", flush=True)
    if not same:
        fail("train CLI: --prefetch 2 and --prefetch 0 losses differ")
    return dict(runs=runs, build_ms=build_ms)


def report_kernels(build) -> None:
    """Set-up output: the ptxas report of each redesigned kernel (it must
    not spill), the tensor-core flash body's dynamic shared memory, and
    the count of each tensor-core kernel's tensor-core instructions in its
    SASS (HGMMA for the flash body's wgmma, HMMA for the scan's
    mma.sync), which must not be zero."""
    for name in REPORTED_KERNELS:
        lines = build.ptxas_report(name)
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
        spills = [x for x in lines if any(
            int(n) for n in re.findall(r"(\d+) bytes spill", x))]
        if spills:
            fail(f"{name} spills registers: {spills}")
    smem = build.library(
        "flash_attention_sm90").flash_attention_sm90_smem_bytes
    print("dynamic shared memory flash_attention_sm90: " + ", ".join(
        f"hd {hd}: {smem(hd)} bytes" for hd in (32, 64, 128))
        + " a CTA (of 232,448)", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, op in TENSOR_CORE_SASS.items():
        sass = subprocess.run(
            [tool, "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        count = sum(op in line for line in sass.splitlines())
        print(f"sass {name}: {count} {op} instructions", flush=True)
        if not count:
            fail(f"{name} has no {op} instruction in its SASS")


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
    import repro_torch.serve
    from repro_torch.dist import consensus
    from repro_torch.dist.consensus import GossipConsensus
    from repro_torch.kernels import build, ops, ref, router
    import repro_torch.kernels.flash_attention
    import repro_torch.kernels.rwkv6_scan
    import repro_torch as rt

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    names = build.sources()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.library, names))
    print(f"build: {len(names)} kernels in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(names)})", flush=True)
    report_kernels(build)

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
    flash = check_flash_attention(torch, ops, router,
                                  rt.kernels.flash_attention)
    rwkv_err, rwkv = check_rwkv6_scan(torch, ops, rt.models.ssm,
                                      rt.kernels.rwkv6_scan)

    smoke = rt.configs.smoke_config("qwen2-1.5b")
    check_quantized_strategy(torch, rt, dense_param_count(smoke) + 1)
    reference_check(torch, rt)
    serve_reference_check(torch, rt, "qwen2-1.5b")
    serve_reference_check(torch, rt, "rwkv6-3b")

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
    sim = run_simulator(torch, rt)
    cli = check_train_cli(torch, rt, full)
    served = {"qwen2-1.5b": run_serve(torch, rt, SERVE_ARGV),
              "rwkv6-3b": run_serve(torch, rt, SERVE_RWKV_ARGV)}
    cli_launches = {k: r["launches"] for k, r in cli["runs"].items()}

    def launches(name):
        return sum(c.get(name, 0) for group in (
            runs, served, sim["launches"], cli_launches)
            for c in group.values())

    def per_epoch(name):
        return {s: c[name] / EPOCHS for s, c in runs.items() if name in c}

    def row(name, replaces, err, timing, source=None):
        return dict(name=name, route="cuda",
                    source=source or f"src/repro_torch/kernels/csrc/{name}.cu",
                    replaces=replaces, launches=launches(name),
                    launches_per_epoch=per_epoch(name),
                    launches_serve={a: c.get(name, 0)
                                    for a, c in served.items()},
                    launches_simulator={a: c.get(name, 0) for a, c in
                                        sim["launches"].items()},
                    launches_train_cli={a: c.get(name, 0) for a, c in
                                        cli_launches.items()},
                    max_abs_err=err,
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
        row("flash_attention", "src/repro/kernels/flash_attention.py:98",
            flash.pop("max_abs_err"), flash,
            "src/repro_torch/kernels/csrc/flash_attention_sm90.cu")
        | {"launches_by_body": {b: launches(f"flash_attention.{b}")
                                for b in rt.kernels.flash_attention.BODIES},
           "cuda_core_source":
               "src/repro_torch/kernels/csrc/flash_attention.cu"},
        row("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:84", rwkv_err,
            rwkv),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
