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
     flash attention at the new models' prefill shapes: qwen3-moe's GQA
     group 8 (S 2048 and 2560, causal), qwen3-8b's window 4096 at S 8192
     (library: SDPA with the windowed mask) and 32,768 (its last 512 rows
     against the plain version through ``q_offset``), and the long_500k
     prompt (524,288 tokens) in the model's query chunks; and zamba2's
     shared block (MHA, group 1, hd 64, S 2048 and 2560, causal;
     library: SDPA); whisper's encoder (1500 x 1500 frames) and
     cross-attention (224 x 1500), both with no causal mask (MHA, hd 64;
     library: SDPA, ``is_causal=False``), and internvl2's prefill (GQA
     group 8, hd 128, S 2048 and 2560, causal);
  4. a small reference check: the quantized gossip strategy on a
     smoke-width message stack, the smoke-size sessions (exact, gossip,
     gossip_q8), and smoke-size serving of qwen2-1.5b and rwkv6-3b
     (prefill logits and caches or states, slot-engine greedy tokens), on
     the card (CUDA kernels) against the CPU (plain versions), the
     quantized ones with rounding draws made on the CPU; then qwen3-8b with
     window 8 (ring caches, prefill and 6 decode steps) and qwen3-moe
     (prefill and slot-engine tokens; tokens routed to other experts on
     the card than on the CPU are counted and left out); and zamba2
     (prefill logits, Mamba2 states and shared caches, 6 decode steps,
     slot-engine tokens, a 3-epoch exact session's duals); whisper
     (prefill logits, K and V caches and the encoder's cross K and V, 6
     decode steps, a 3-epoch exact session's duals on batches that carry
     frames) and internvl2 (slot-engine tokens on embeddings prompts);
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
  8. the epoch drivers and the session's state at qwen2-1.5b width:
     pipelined ring gossip (8 layers, 3 epochs and a flush: 5
     gossip_combine launches a settle, the first epoch's zero payload
     included; the simulated wall clock adds max(T, T_c) an epoch; one
     pipelined step and a flush equal one sequential step bit for bit);
     async gossip with D = 2 (4 layers, 3 epochs and a flush; max(T,
     T_c / D) an epoch; D = 1 equals the pipelined driver bit for bit over
     2 epochs and a flush); elastic membership on the 8-layer gossip
     session (everyone, worker 1 out for two epochs on a ring of 3
     survivors, then back: its b is 0 and its dual rows stay bit for bit,
     an all-inactive mask raises and touches nothing); and checkpoints
     (an exact session at full width cut to 2 layers, a pipelined and an
     async D = 2 session at the smoke config, and the pipelined session
     of this phase at 8 layers, 34 GB on disk: saved after 2 epochs,
     restored on the card, the state bit for bit and the next epoch bit
     for bit, the restore holding no second copy of the state on the
     card; save seconds, and the restore's seconds split into the
     session's construction and the state's read and landing, with GB/s);
     the bit-for-bit epochs under deterministic algorithms;
  9. coded placement, faults and the controller at qwen2-1.5b width:
     the coded exact step (28 layers, rho 2) under four b that each cover
     every distinct slot once in total weight (b(t) 16 and the duals
     equal within CODED_TOL); Poisson churn with rho 2 through the
     prefetcher (8 layers: JAX's six masks, 5 gossip_combine launches an
     epoch on survivor tables of 3 and 2, down workers' dual rows bit for
     bit, the LM stream's coded and uncoded builds); the controller
     through the train CLI (8 layers, budget 40 toward Lemma 6's T, the
     noise statistics on every epoch, the peak); a staleness retune D 1
     -> 2 on the async driver (4 layers: the drain before the rebuild,
     the staleness metric, the peak); run_amb_adaptive on §6.1 across a
     3x slow-down (T within ADAPT_TOL of each regime's Lemma-6 T; epochs/s
     beside run_amb's); a restore mid-churn (2 layers, bit for bit under
     deterministic algorithms); launch counts reset before each and read
     after;
 10. the serve CLI (``repro_torch.launch.serve``) at full width, all 28
     layers, bf16: 16 requests of 2048 +- 512 prompt tokens and 32 new
     tokens over 8 slots, with background exact fine-tune epochs, every
     prefill's attention on the tensor-core body; the same serve run for
     rwkv6-3b at full width, all 32 layers, bf16; launch counts are reset
     just before each run and read just after;
 11. the rest of the zoo's dense branch at full width, bf16: qwen3-moe-30b-a3b
     served through the slot engine and scheduler with no session (48
     layers, 8 slots, 16 requests of 2048 +- 512 tokens at exact length,
     32 new tokens, arrivals 2.0 s apart: TTFT, TPOT, the decode round's
     median, the peak; 48 tensor-core flash launches a request); the
     serve CLI on it cut to 4 layers with 2 fine-tune epochs; an exact
     AMBSession on it at 4 layers, 4 x 8 x 256, 3 epochs (loss and aux
     each epoch, 15 prox launches an epoch, the peak); qwen3-8b at
     long_500k (window 4096, 36 layers): a 32,768-token prefill, 64 ring
     decode steps held against a linear cache masked to the window (and
     each layer's attention in fp32 on the same keys), then the
     524,288-token prefill and 16 decode steps past it (seconds,
     tokens/s, the peak); launch counts reset before each and read after;
 12. the Mamba2 hybrid at full width, bf16: zamba2-1.2b (38 Mamba2
     layers, the shared dense block after every 6th, 6 applications)
     through the serve CLI (SERVE_ARGV's workload with up to 2 fine-tune
     epochs; an epoch outlasts the round budget, so a run absorbs one: 6
     tensor-core flash launches a request, 20 prox launches an absorbed
     epoch; TTFT, TPOT, tokens/s, the peak), then an exact AMBSession,
     4 x 8 x 256, 3 epochs (every gradient and dual finite after each, 60
     prox launches, step ms and the peak; the prox held at the Mamba2
     w_in leaf); launch counts reset before each and read after;
 13. the encoder-decoder and the embeddings-in path, bf16: whisper-base at
     full width (6 + 6 layers) served through the model-level functions
     (the slot engine refuses audio, as JAX's does): 16 requests, each
     with its own 1500 frames and a prompt of 4 to 224 tokens, in two
     waves of 8 slots, each prefilled alone and inserted, 128 greedy
     tokens at per-slot positions, the rows evicted between the waves
     (18 tensor-core flash launches a request; the prefill's and the
     decode round's medians, tokens/s, the peak); an exact AMBSession on
     it, 4 x 8 x 256 tokens with their frames, 3 epochs (27 prox launches
     an epoch, step ms, the peak); internvl2-76b cut to 32 of 80 layers
     through the slot engine and scheduler with no session (8 requests of
     2048 +- 512 tokens as embeddings, 1.0 s apart, 16 new tokens; 32
     tensor-core flash launches a request; TTFT, TPOT, the peak); launch
     counts reset before each and read after;
 14. one process per worker (``torch.distributed``), ranks started by
     ``python -m torch.distributed.run --standalone`` on this script
     (``--rank-phase``), each under a time limit, after the parent has
     built every kernel and released its card memory; the ranks only load
     the built libraries.  First the one-process references (exact at 8
     layers, ring gossip r 5 at 4, qwen2-1.5b width, 4 x 8 x 256, 2
     epochs, simulated clock, deterministic algorithms); then one NCCL
     rank: ``make_host_mesh(1, 1)`` and an exact session at 28 layers
     through the process-group path, parameters and losses bit for bit
     the one-process ``data=1`` session's; then four gloo ranks sharing
     the card (compute on the card, the gossip rows through pinned host
     buffers): exact (losses within MESH_LOSS_TOL, every rank's
     parameters equal, rank 0's within MESH_PARAM_TOL of the reference)
     and ring gossip (each rank's shard and dual row equal by digest to
     its row of the one-process session), each rank's peak, epoch
     seconds, bytes sent and staged a round, ``gossip_combine`` (r an
     epoch) and ``dual_update`` (15 an epoch) launches, the peaks' sum
     under MESH_PEAK_SUM_GIB; then the train CLI under torchrun, gloo,
     ``--pod 2 --data 2 --graph torus`` at the smoke config, its losses
     equal to the one-process ``--data 4`` CLI's; then the dry-run
     (``repro_torch.launch.dryrun``) of qwen2-1.5b train_4k on (16, 16)
     and of the exact ranks' own configuration on (4, 1), whose per-rank
     argument bytes must not pass the ranks' measured peak.  The
     per-rank ``gossip_combine`` round (3 received rows into one) is held
     bit for bit against the stacked round's row in phase 3;
 15. print the kernels' JSON line, the card line, and the final ok line.
"""
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
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
# the pipelined, async, elastic and checkpoint phases: worker 1 leaves
# the ring (3 survivors re-laid onto a ring), async keeps D = 2 payloads
# in flight (at QUANT_LAYERS: one queued payload and two dual snapshots
# stay live through the backward), the exact checkpoint is cut to 2 layers
# and the full-width pipelined one runs at GOSSIP_LAYERS: a chip call may
# write 45 GiB to its disk, deletions included, and the async session's
# checkpoint at QUANT_LAYERS is 57 GB
MASK = (True, False, True, True)
STALENESS = 2
CKPT_LAYERS = 2
# coded placement, faults and the controller (qwen2-1.5b width, 4 x 8 x
# 256, ring r 5): the coded exact step at the exact session's depth under
# rho = 2 from one initial state with b that each cover every distinct
# slot with total weight 1.  A full b (8 = per) covers a block whatever
# its rotation; the complementary halves (4, 4, 4, 4) are what test that
# the rolls and the decode weights share one index map.  The gradients
# are bf16 (the model's dtype; the embedding's sums each token's rows),
# so the duals may differ by a few bf16 roundings of a gradient element:
# CODED_TOL of each leaf's largest |z|, four bf16 ulps (a wrong index map
# weighs other samples, an error of the order of |z| itself)
CODED_RHO = 2
CODED_BS = ((8, 0, 8, 0), (0, 8, 0, 8), (8, 8, 8, 8), (4, 4, 4, 4))
CODED_TOL = 2.0 ** -5
# PoissonChurn(0.25, 0.5, seed=1) over 4 workers: the masks of epochs 0
# to 5 (the first and five changes; a 2-survivor ring, workers 0 and 3, at
# epoch 3); the gossip cut, and the restore mid-churn at RESTORE_LAYERS
CHURN = dict(leave_rate=0.25, rejoin_rate=0.5, seed=1)
CHURN_MASKS = ("1111", "1110", "1011", "1001", "1111", "1101")
RESTORE_LAYERS = 2
# the controller through the train CLI (as scripts/controller_smoke.py
# drives JAX's), at GOSSIP_LAYERS: a 16x mistuned budget, r = 2
CONTROLLER_ARGV = ["--sim-clock", "--compute-time", "40.0", "--comm-time",
                   "0.5", "--consensus", "gossip", "--gossip-rounds", "2",
                   "--controller", "--controller-interval", "1",
                   "--controller-warmup", "2"]
CONTROLLER_STEPS = 5
# the staleness retune on the async driver at QUANT_LAYERS: T_c = 5.0
# over the Lemma-6 T of 2.8125 is 1.78 > 1 + hysteresis, so D goes 1 -> 2;
# d_max 2 keeps it there (D = 3 would not fit the card at this depth)
RETUNE_COMM = 5.0
RETUNE_EPOCHS = 5
# run_amb_adaptive on §6.1 (SIM_*): a 3x mistuned T, the cluster 3x
# slower from epoch ADAPT_SHIFT on; T within ADAPT_TOL of each regime's
# Lemma-6 T over the last ADAPT_TAIL epochs before the shift and the end
ADAPT_EPOCHS = 300
ADAPT_SHIFT = 150
ADAPT_TAIL = 50
ADAPT_TOL = 0.10
# the bit-for-bit comparisons on the card (a restored or pipelined epoch
# against the uninterrupted or sequential one) run under
# torch.use_deterministic_algorithms, which needs cuBLAS's workspace
# fixed before CUDA starts: the loss's gather backward adds with atomics
CUBLAS_WORKSPACE = ":4096:8"


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


def hold_dual_update(torch, ops, ref, z, w0, beta: float, what: str):
    """max |kernel - plain| of the prox on (z, w0); fails past DUAL_TOL."""
    got = ops.dual_update(z, w0, beta, force="kernel")
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, ref.dual_update_ref(z, w0, beta))
    if err > DUAL_TOL:
        fail(f"dual_update {what} w0 {w0.dtype}: max_abs_err {err} > "
             f"{DUAL_TOL}")
    return err


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
            err = hold_dual_update(torch, ops, ref, z, w0, beta,
                                   f"shape={shape} offsets z={oz} w0={ow}")
            worst = max(worst, err)
            line = (f"dual_update shape={shape} offsets z={oz} w0={ow} "
                    f"w0={dtype} max_abs_err={err:.3g}")
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
            del z, w0
    return worst, full


def check_gossip_combine(torch, ops, GossipConsensus, d_full: int):
    """The combine against its plain version on the ring's and the torus's
    tables, and on a survivor table (worker 1 out: a ring of 3 re-laid
    over rows 0, 2, 3, whose rows are not a rotation of arange(n))."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, full = 0.0, None
    for graph, active in (("ring", None), ("torus", None), ("ring", MASK)):
        strat = GossipConsensus(N_WORKERS, 5, graph, active=active)
        src, w = strat.source_rows("cuda"), strat.taps.weights
        k = len(w)
        if active is not None:
            table = src.cpu().numpy()
            live = [i for i, a in enumerate(active) if a]
            rotations = [[(i + o) % N_WORKERS for i in range(N_WORKERS)]
                         for o in range(N_WORKERS)]
            print(f"gossip_combine survivor table (worker 1 out): "
                  f"{table.tolist()}", flush=True)
            if not (set(table[:, live].ravel()) <= set(live) and all(
                    row.tolist() not in rotations for row in table[1:])):
                fail(f"survivor table {table.tolist()}")
            graph = "ring survivors"
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

        def cuda_core(got, want, tol):
            """The CUDA-core body at the same shape: held, its bf16 ulps
            printed beside the tensor-core body's, timed."""
            old = flash.flash_attention_cuda(q, k, v, force_body="cuda_core")
            torch.cuda.synchronize()
            err_old = max_abs_err(torch, old, want)
            if not err_old <= tol:
                fail(f"flash_attention S={s} cuda_core: max_abs_err "
                     f"{err_old} > {tol}")
            print(f"flash_attention S={s} bf16 ulps: tensor_core "
                  f"{ulp_stats(torch, got, want)}; cuda_core "
                  f"{ulp_stats(torch, old, want)}", flush=True)
            del old
            c_ms = time_ms(torch, lambda: flash.flash_attention_cuda(
                q, k, v, force_body="cuda_core"), 50,
                "flash_attention cuda_core")
            return dict(cuda_core_ms=c_ms, cuda_core_max_abs_err=err_old)

        entry = flash_entry(
            torch, ops, q, k, v, 0,
            f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal, tensor_core "
            f"body", lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=200,
            extra=cuda_core)
        main = main or entry
        del q, k, v
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
    session = session_for(rt, cfg, consensus=consensus)
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


def session_for(rt, cfg, *, train=None, clock=None, controller=None,
                **spec):
    """A full-width session spec (TrainSpec defaults, n = 4) on the card
    with the simulated clock and ring gossip at GOSSIP_ROUNDS; ``train``
    and ``clock`` add fields to those specs, ``controller`` is a
    ControllerSpec's fields."""
    return rt.api.AMBSession(
        rt.api.TrainSpec(data=N_WORKERS, batch_per_worker=PER_WORKER,
                         seq_len=SEQ, **(train or {})),
        rt.api.ClockSpec(kind="simulated", **(clock or {})),
        rt.api.ConsensusSpec(graph="ring", gossip_rounds=GOSSIP_ROUNDS,
                             **spec),
        None if controller is None
        else rt.api.ControllerSpec(enabled=True, **controller),
        cfg=cfg, device="cuda")


def release(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms for a bit-for-bit comparison of two runs
    on the card (see CUBLAS_WORKSPACE)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def same_tree(torch, a, b) -> bool:
    """Two states (dicts, lists, tensors, numbers) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(torch, a[k], b[k])
                                             for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_tree(torch, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def drive(torch, rt, session, source, epochs: int, label: str, wall_rule,
          start: int = 0) -> tuple:
    """``epochs`` session steps on ``source``; checks each epoch's loss and
    that the simulated wall clock adds ``wall_rule(T)`` an epoch.  Returns
    (the last metrics, the peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    wall = session.sim_wall
    for epoch in range(start, start + epochs):
        m = session.step(source.batch(epoch))
        wall += wall_rule(m["budget_s"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  {label} epoch {epoch}: loss={m['loss']:.6f} "
              f"b={m['b'].tolist()} step_ms={m['step_s'] * 1e3:.1f} "
              f"sim_wall_s={m['sim_wall_s']!r} peak_GiB={peak:.2f}",
              flush=True)
        if not math.isfinite(m["loss"]):
            fail(f"{label} epoch {epoch}: loss {m['loss']}")
        if m["sim_wall_s"] != wall:
            fail(f"{label} epoch {epoch}: sim_wall_s {m['sim_wall_s']!r} "
                 f"!= {wall!r}")
    return m, torch.cuda.max_memory_allocated() / 2 ** 30


def expect(label: str, launches: dict, want: dict) -> None:
    for name, n in want.items():
        if launches.get(name, 0) != n:
            fail(f"{label}: {name} launched {launches.get(name, 0)} times, "
                 f"expected {n}")


def run_pipelined(torch, rt, cfg) -> dict:
    """Pipelined ring gossip (r = 5) at ``cfg`` (GOSSIP_LAYERS): EPOCHS
    epochs and a flush, launch counts reset just before and read after
    the flush.  A settle is GOSSIP_ROUNDS gossip_combine launches, the
    first epoch's zero payload included (as JAX settles it), so EPOCHS + 1
    settles; the prox runs for each worker's 15 leaves an epoch."""
    session = session_for(rt, cfg, consensus="gossip", pipeline=True)
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    print(f"pipelined gossip: {cfg.name} layers={cfg.num_layers} ring "
          f"r={GOSSIP_ROUNDS} epochs={EPOCHS} and a flush", flush=True)
    release(torch)
    rt.kernels.router.reset_launches()
    _, peak = drive(torch, rt, session, source, EPOCHS, "pipelined",
                    lambda t: max(t, COMM_TIME))
    session.flush()
    launches = rt.kernels.router.launches()
    print(f"  launches (3 epochs and a flush): {launches}; peak_GiB="
          f"{peak:.2f}", flush=True)
    expect("pipelined", launches, {
        "gossip_combine": GOSSIP_ROUNDS * (EPOCHS + 1),
        "dual_update": 15 * N_WORKERS * EPOCHS})
    if bool(session.state["pending"].any()):
        fail("pipelined: the flush left a payload in flight")
    for name, leaf in session.params.items():
        if not bool(torch.isfinite(leaf).all()):
            fail(f"pipelined: parameter {name} is not finite")
    del session
    release(torch)
    # one pipelined step and a flush against one sequential step, same
    # batch and b, under deterministic algorithms
    batch, b = source.batch(EPOCHS), [PER_WORKER, 5, 0, PER_WORKER]
    with deterministic(torch):
        seq = session_for(rt, cfg, consensus="gossip")
        seq.step(batch, b)
        want = seq.state["z"]
        del seq
        release(torch)
        pipe = session_for(rt, cfg, consensus="gossip", pipeline=True)
        pipe.step(batch, b)
        pipe.flush()
        same = same_tree(torch, pipe.state["z"], want)
    print(f"  one pipelined step and a flush equal one sequential step bit "
          f"for bit: {same}", flush=True)
    if not same:
        fail("pipelined step + flush differs from the sequential step")
    del pipe, want
    release(torch)
    return launches


def run_async(torch, rt, cfg) -> dict:
    """Async gossip with D = STALENESS at ``cfg`` (QUANT_LAYERS): EPOCHS
    epochs and a flush (EPOCHS + D settles of GOSSIP_ROUNDS launches: the
    first D epochs settle zero payloads, the flush D slots); then D = 1
    against the pipelined driver, 2 epochs and a flush, bit for bit."""
    session = session_for(rt, cfg, consensus="gossip", async_epochs=True,
                          staleness=STALENESS)
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    print(f"async gossip: {cfg.name} layers={cfg.num_layers} ring "
          f"r={GOSSIP_ROUNDS} D={STALENESS} epochs={EPOCHS} and a flush",
          flush=True)
    release(torch)
    rt.kernels.router.reset_launches()
    _, peak = drive(torch, rt, session, source, EPOCHS, "async",
                    lambda t: max(t, COMM_TIME / STALENESS))
    session.flush()
    launches = rt.kernels.router.launches()
    print(f"  launches (3 epochs and a flush): {launches}; peak_GiB="
          f"{peak:.2f}", flush=True)
    expect("async", launches, {
        "gossip_combine": GOSSIP_ROUNDS * (EPOCHS + STALENESS),
        "dual_update": 15 * N_WORKERS * EPOCHS})
    del session
    release(torch)
    bs = ([PER_WORKER, 3, PER_WORKER, 0], [1, PER_WORKER, PER_WORKER, 6])
    zs = []
    with deterministic(torch):
        for spec in (dict(async_epochs=True, staleness=1),
                     dict(pipeline=True)):
            s = session_for(rt, cfg, consensus="gossip", **spec)
            for epoch, b in enumerate(bs):
                s.step(source.batch(epoch), b)
            s.flush()
            zs.append(s.state["z"])
            del s
            release(torch)
        same = same_tree(torch, *zs)
    print(f"  async D=1 equals the pipelined driver bit for bit over 2 "
          f"epochs and a flush: {same}", flush=True)
    if not same:
        fail("async D=1 differs from the pipelined driver")
    del zs
    release(torch)
    return launches


def run_elastic(torch, rt, cfg) -> dict:
    """Elastic membership on the ring gossip session at ``cfg``
    (GOSSIP_LAYERS): one epoch with everyone, worker 1 out for two (a ring
    of 3 survivors through the survivor table), then back for one; every
    epoch GOSSIP_ROUNDS gossip_combine launches."""
    session = session_for(rt, cfg, consensus="gossip")
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    print(f"elastic gossip: {cfg.name} layers={cfg.num_layers} mask "
          f"{list(MASK)} for epochs 1-2", flush=True)
    release(torch)
    rt.kernels.router.reset_launches()

    def step(epoch, label):
        return drive(torch, rt, session, source, 1, label,
                     lambda t: t + COMM_TIME, start=epoch)

    _, peak = step(0, "all")
    session.set_active(MASK)
    kept = {k: v[1].clone() for k, v in session.state["z"].items()}
    for epoch in (1, 2):
        m, p = step(epoch, "worker 1 out")
        peak = max(peak, p)
        if m["b"][1] != 0:
            fail(f"elastic: worker 1 took b = {m['b'][1]} while out")
    if not all(torch.equal(session.state["z"][k][1], v)
               for k, v in kept.items()):
        fail("elastic: worker 1's dual rows changed while it was out")
    del kept
    release(torch)
    before = {k: v.clone() for k, v in session.state["z"].items()}
    try:
        session.set_active([False] * N_WORKERS)
        fail("elastic: an all-inactive mask was accepted")
    except ValueError as e:
        print(f"  an all-inactive mask raises: {e}", flush=True)
    untouched = session.active.tolist() == list(MASK) and same_tree(
        torch, session.state["z"], before)
    del before
    release(torch)
    if not untouched:
        fail("elastic: the rejected mask changed the session")
    session.set_active([True] * N_WORKERS)
    _, p = step(3, "rejoined")
    launches = rt.kernels.router.launches()
    print(f"  worker 1's dual rows unchanged bit for bit while out; the "
          f"rejected mask left the state untouched; launches (4 epochs): "
          f"{launches}; peak_GiB={max(peak, p):.2f}", flush=True)
    expect("elastic", launches, {
        "gossip_combine": GOSSIP_ROUNDS * 4,
        "dual_update": 15 * N_WORKERS * 4})
    del session
    release(torch)
    return launches


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def tensors(torch, tree):
    """The tensor leaves of a state (dicts in key order, lists)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensors(torch, tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(torch, v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def digest(torch, tree) -> list:
    """Exact checksums of a state's bits, for a state too large to keep a
    second copy of: for each tensor leaf its dtype, its shape, and the sum
    and the position-weighted sum of its words as int64 (mod 2**64, so
    the reduction order cannot change them; any one changed word changes
    the first); each number as it is."""
    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            flat = x.detach().contiguous().view(-1).view(
                words[x.element_size()])
            s = torch.zeros((), dtype=torch.int64, device=x.device)
            w = torch.zeros_like(s)
            for lo in range(0, flat.numel(), CHUNK):
                c = flat[lo:lo + CHUNK].to(torch.int64)
                s += c.sum()
                w += (c * torch.arange(lo + 1, lo + 1 + c.numel(),
                                       device=x.device)).sum()
            out.append((str(x.dtype), tuple(x.shape), int(s), int(w)))
        else:
            out.append(x)

    walk(tree)
    return out


@contextlib.contextmanager
def time_calls(torch, module, name: str, spent: list):
    """Replace ``module.name`` for the block by a wrapper that appends the
    host seconds of each call, from a device sync to a device sync."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield spent
    finally:
        setattr(module, name, fn)


def check_checkpoints(torch, rt, full, smoke) -> dict:
    """Save after 2 epochs, restore on the card, then one more epoch on
    both: an exact session at full width cut to CKPT_LAYERS, a pipelined
    and an async (D = STALENESS) session at the smoke config, and the
    pipelined session at full width cut to GOSSIP_LAYERS.  That one has
    the card to itself: the uninterrupted session takes its next epoch and
    goes before the restore, the two are held to each other by
    ``digest`` (the others also tensor by tensor), and the restore's peak
    must stay below the restored session's footprint plus half its state:
    a restore that landed a second copy of the state before copying it in
    would hold all of it twice.  The restored state, step count, wall
    clock and mask equal the saved ones and the next epoch the
    uninterrupted one's, bit for bit (under deterministic algorithms).
    The restore's time is split into the state's read and landing
    (``load_checkpoint_into``, timed inside the call) and the rest, the
    session's construction.  The checkpoints go to a directory under the
    git-ignored build/ that the phase deletes."""
    cases = (("exact", dataclasses.replace(full, num_layers=CKPT_LAYERS),
              dict(consensus="exact"), False),
             ("pipelined", smoke, dict(consensus="gossip", pipeline=True),
              False),
             ("async", smoke, dict(consensus="gossip", async_epochs=True,
                                   staleness=STALENESS), False),
             ("pipelined full width",
              dataclasses.replace(full, num_layers=GOSSIP_LAYERS),
              dict(consensus="gossip", pipeline=True), True))
    session_mod = sys.modules["repro_torch.api.session"]
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for label, cfg, spec, alone in cases:
        source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                         PER_WORKER, seed=0, device="cuda")
        tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="ckpt_"))
        try:
            with deterministic(torch):
                a = session_for(rt, cfg, **spec)
                for epoch in range(2):
                    a.step(source.batch(epoch))
                saved = digest(torch, a.state)
                meta = (a.steps_done, a.sim_wall, a.active.tolist())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.save(tmp)
                save_s = time.perf_counter() - t0
                size = dir_bytes(tmp)
                state_size = dir_bytes(tmp / "session_state")
                if alone:
                    ma = a.step(source.batch(2))
                    want = digest(torch, a.state)
                    del a
                    release(torch)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with time_calls(torch, session_mod, "load_checkpoint_into",
                                []) as spent:
                    b = rt.api.AMBSession.restore(tmp, cfg=cfg,
                                                  device="cuda")
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                read_s = sum(spent)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                live = torch.cuda.memory_allocated() / 2 ** 30
                state_gib = sum(t.numel() * t.element_size()
                                for t in tensors(torch, b.state)) / 2 ** 30
                same_state = digest(torch, b.state) == saved
                same_meta = (b.steps_done, b.sim_wall,
                             b.active.tolist()) == meta
                if not alone:
                    same_state &= same_tree(torch, b.state, a.state)
                    ma = a.step(source.batch(2))
                mb = b.step(source.batch(2))
                if alone:
                    same_next = digest(torch, b.state) == want
                else:
                    same_next = same_tree(torch, b.state, a.state)
                same_next &= ma["loss"] == mb["loss"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"checkpoint {label}: {cfg.name} layers={cfg.num_layers} "
              f"{size / 1e9:.3f} GB on disk ({state_size / 1e9:.3f} GB of "
              f"state); save {save_s:.3f} s ({size / 1e9 / save_s:.3f} "
              f"GB/s); restore {load_s:.3f} s: construction "
              f"{load_s - read_s:.3f} s, the state's read and landing "
              f"{read_s:.3f} s ({state_size / 1e9 / read_s:.3f} GB/s); "
              f"restore peak_GiB={peak:.2f} over the restored session's "
              f"{live:.2f} ({state_gib:.2f} of state); state equal bit for bit "
              f"{same_state}; steps, wall clock and mask equal {same_meta}; "
              f"the next epoch equal bit for bit {same_next} (loss "
              f"{ma['loss']!r})", flush=True)
        if not (same_state and same_meta and same_next):
            fail(f"checkpoint {label}: state {same_state}, counters "
                 f"{same_meta}, next epoch {same_next}")
        if alone and peak >= live + state_gib / 2:
            fail(f"checkpoint {label}: the restore peaked at {peak:.2f} GiB "
                 f"for a session of {live:.2f}: a second copy of its "
                 f"{state_gib:.2f} GiB state")
        out[label] = dict(bytes=size, save_s=save_s, load_s=load_s,
                          read_s=read_s, peak_gib=peak)
        if not alone:
            del a
        del b
        release(torch)
    return out


def run_coded_exact(torch, rt, cfg) -> dict:
    """The coded exact step at ``cfg`` (all 28 layers), rho = CODED_RHO:
    one epoch from the same initial state under each b of CODED_BS, on
    the session's coded LM source (each group's block, rolled per
    member).  Each b covers every distinct slot with total weight 1, so
    b(t) is 16 in each and the duals z after the step agree within
    CODED_TOL of each leaf's largest |z|.  Launch counts are reset
    before the epochs and read after."""
    print(f"coded exact: {cfg.name} layers={cfg.num_layers} rho="
          f"{CODED_RHO} b={[list(b) for b in CODED_BS]}", flush=True)
    rt.kernels.router.reset_launches()
    first, errs, times = None, [], []
    for b in CODED_BS:
        session = session_for(rt, cfg, train=dict(redundancy=CODED_RHO),
                              consensus="exact")
        batch = session.batch_source().batch(0)
        torch.cuda.reset_peak_memory_stats()
        m = session.step(batch, list(b))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times.append(m["step_s"])
        z = session.state["opt"]["z"]
        if first is None:
            first = {k: v.clone() for k, v in z.items()}
            err = 0.0
        else:
            err = max(max_abs_err(torch, z[k], first[k])
                      / float(first[k].abs().max().clamp(min=1e-30))
                      for k in first)
            errs.append(err)
        print(f"  b={list(b)}: loss={m['loss']:.6f} global_batch="
              f"{m['global_batch']} step_ms={m['step_s'] * 1e3:.1f} "
              f"peak_GiB={peak:.2f} max |z - z_first| / max |z_first| = "
              f"{err:.3e} (tolerance {CODED_TOL:.3e})", flush=True)
        if m["global_batch"] != N_WORKERS * PER_WORKER / CODED_RHO:
            fail(f"coded exact b={b}: global_batch {m['global_batch']}")
        if not math.isfinite(m["loss"]) or err > CODED_TOL:
            fail(f"coded exact b={b}: loss {m['loss']}, error {err}")
        del session, batch, z
        release(torch)
    launches = rt.kernels.router.launches()
    print(f"  launches ({len(CODED_BS)} epochs): {launches}", flush=True)
    expect("coded exact", launches, {"dual_update": 15 * len(CODED_BS)})
    del first
    release(torch)
    return dict(launches=launches, err=max(errs), step_s=times)


def lm_build_ms(torch, rt, vocab: int, assignment) -> float:
    """One LM batch's build (ms, host clock around a synced build; the
    least of two after a warm-up) under ``assignment``."""
    src = rt.data.StreamSource(
        rt.data.LMTokenStream(vocab, SEQ, seed=0, device="cuda"),
        N_WORKERS, PER_WORKER, assignment=assignment)
    times = []
    for epoch in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src.batch(epoch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times[1:])


def worker_rows(torch, session, i: int) -> list:
    return digest(torch, {k: v[i] for k, v in session.state["z"].items()})


def run_churn(torch, rt, cfg) -> dict:
    """``AMBSession.run(6, faults=PoissonChurn(**CHURN))`` with rho =
    CODED_RHO on the ring gossip session at ``cfg`` (GOSSIP_LAYERS),
    through the prefetcher and the coded LM source.  Requires JAX's masks
    (CHURN_MASKS: the first and five changes), a down worker's b 0 and
    its dual rows unchanged bit for bit over its down epochs (a digest
    before and after each), GOSSIP_ROUNDS gossip_combine launches every
    epoch (survivor tables of 3 and 2 workers, the 2-survivor ring on the
    kernel's table, never the dense operator), finite losses.  Launch
    counts are reset before the run and read after; then the LM stream's
    build, coded (n / rho blocks) and uncoded."""
    model = rt.faults.PoissonChurn(**CHURN)
    pair = rt.dist.make_strategy("gossip", N_WORKERS, rounds=GOSSIP_ROUNDS,
                                 active=(True, False, False, True))
    if not isinstance(pair.taps, rt.dist.SurvivorTaps):
        fail("churn: the 2-survivor ring has no survivor table")
    print(f"churn: {cfg.name} layers={cfg.num_layers} rho={CODED_RHO} "
          f"PoissonChurn{tuple(CHURN.values())} masks {list(CHURN_MASKS)};"
          f" the 2-survivor table {pair.taps.source_rows().tolist()}",
          flush=True)
    session = session_for(rt, cfg, train=dict(redundancy=CODED_RHO),
                          consensus="gossip")
    injector = rt.faults.FaultInjector(model)
    held, rows, bad = {}, [], []
    last = {"launches": {}}

    def down(epoch):
        return [i for i, c in enumerate(CHURN_MASKS[epoch]) if c == "0"]

    def on_step(epoch, m):
        counts = rt.kernels.router.launches()
        delta = {k: v - last["launches"].get(k, 0) for k, v in counts.items()}
        last["launches"] = counts
        mask = "".join(str(int(a)) for a in session.active)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i in down(epoch):
            if worker_rows(torch, session, i) != held.pop(i):
                bad.append((epoch, i))
        if epoch + 1 < len(CHURN_MASKS):
            for i in down(epoch + 1):
                held[i] = worker_rows(torch, session, i)
        rows.append(dict(epoch=epoch, mask=mask, b=m["b"].tolist(),
                         loss=m["loss"], step_s=m["step_s"], launches=delta,
                         global_batch=m["global_batch"]))
        print(f"  churn epoch {epoch}: mask {mask} b={m['b'].tolist()} "
              f"global_batch={m['global_batch']} loss={m['loss']:.6f} "
              f"step_ms={m['step_s'] * 1e3:.1f} launches {delta} "
              f"peak_GiB={peak:.2f}", flush=True)

    release(torch)
    torch.cuda.reset_peak_memory_stats()
    rt.kernels.router.reset_launches()
    session.run(len(CHURN_MASKS), faults=injector, on_step=on_step)
    launches = rt.kernels.router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = ["".join(str(a) for a in e["active"]) for e in injector.events]
    print(f"  events {events} ({injector.membership_changes} applied); "
          f"launches ({len(CHURN_MASKS)} epochs): {launches}; peak_GiB="
          f"{peak:.2f}; down workers' dual rows unchanged: {not bad}",
          flush=True)
    if events != list(CHURN_MASKS):
        fail(f"churn: events {events}, expected {list(CHURN_MASKS)}")
    for r in rows:
        if r["mask"] != CHURN_MASKS[r["epoch"]] \
                or not math.isfinite(r["loss"]) \
                or any(r["b"][i] for i in down(r["epoch"])) \
                or r["launches"].get("gossip_combine", 0) != GOSSIP_ROUNDS:
            fail(f"churn epoch {r['epoch']}: {r}")
    if bad:
        fail(f"churn: dual rows of down workers changed: {bad}")
    expect("churn", launches, {
        "gossip_combine": GOSSIP_ROUNDS * len(CHURN_MASKS),
        "dual_update": 15 * N_WORKERS * len(CHURN_MASKS)})
    del session
    release(torch)
    coded = lm_build_ms(torch, rt, cfg.vocab_size,
                        rt.dist.CodedAssignment(N_WORKERS, CODED_RHO))
    plain = lm_build_ms(torch, rt, cfg.vocab_size, None)
    print(f"  LM stream build: coded ({N_WORKERS // CODED_RHO} blocks) "
          f"{coded:.1f} ms, uncoded ({N_WORKERS} blocks) {plain:.1f} ms",
          flush=True)
    return dict(launches=launches, peak=peak, rows=rows, build_ms=(coded,
                                                                  plain))


def check_restore_mid_churn(torch, rt, cfg) -> dict:
    """At ``cfg`` (RESTORE_LAYERS), rho = CODED_RHO, ring gossip: 6
    churned epochs uninterrupted, against 3, ``save``, ``restore`` and 3
    more under a fresh FaultInjector over the same model; losses and the
    state equal bit for bit (digests), under deterministic algorithms.
    The checkpoint goes under the git-ignored build/ and is deleted."""
    model = rt.faults.PoissonChurn(**CHURN)
    half = len(CHURN_MASKS) // 2
    release(torch)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="churn_"))
    try:
        with deterministic(torch):
            ref = session_for(rt, cfg, train=dict(redundancy=CODED_RHO),
                              consensus="gossip")
            want = []
            ref.run(len(CHURN_MASKS), faults=model,
                    on_step=lambda e, m: want.append(m["loss"]))
            want_state = digest(torch, ref.state)
            del ref
            release(torch)
            a = session_for(rt, cfg, train=dict(redundancy=CODED_RHO),
                            consensus="gossip")
            got = []
            a.run(half, faults=rt.faults.FaultInjector(model),
                  on_step=lambda e, m: got.append(m["loss"]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.save(tmp)
            save_s = time.perf_counter() - t0
            size = dir_bytes(tmp)
            del a
            release(torch)
            t0 = time.perf_counter()
            b = rt.api.AMBSession.restore(tmp, cfg=cfg, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            b.run(len(CHURN_MASKS) - half,
                  faults=rt.faults.FaultInjector(model),
                  on_step=lambda e, m: got.append(m["loss"]))
            same = got == want and digest(torch, b.state) == want_state
            del b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    release(torch)
    print(f"restore mid-churn: {cfg.name} layers={cfg.num_layers} rho="
          f"{CODED_RHO}; {half} epochs, save ({size / 1e9:.3f} GB, "
          f"{save_s:.3f} s), restore ({load_s:.3f} s), {half} more under a "
          f"fresh injector: losses {got} equal the uninterrupted run's and "
          f"the state bit for bit: {same}", flush=True)
    if not same:
        fail(f"restore mid-churn: {got} against {want}")
    return dict(bytes=size, save_s=save_s, load_s=load_s)


def run_controller_cli(torch, rt, cfg) -> dict:
    """The controller through the train CLI (CONTROLLER_ARGV, at
    ``cfg``: the CLI has no depth flag, so the phase hands the session
    this config), CONTROLLER_STEPS steps.  Requires a budget action, the
    budget moving from 40 toward Lemma 6's T, finite non-negative noise
    statistics on every epoch (read where the session's control hook
    takes them), and the peak within the gossip session's plus the
    running mean's (W fp32) and one fp32 copy of the largest leaf."""
    session_mod = sys.modules["repro_torch.api.session"]
    real_config, real_control = session_mod.get_config, \
        rt.api.AMBSession._control
    noise = []

    def control(self, m, out, times):
        noise.append((float(m["grad_sq_norm"]), float(m["grad_var"])))
        return real_control(self, m, out, times)

    session_mod.get_config = lambda arch: cfg
    rt.api.AMBSession._control = control
    try:
        res = run_train_cli(torch, rt, CONTROLLER_ARGV, "controller",
                            CONTROLLER_STEPS)
    finally:
        session_mod.get_config = real_config
        rt.api.AMBSession._control = real_control
    model = rt.api.ClockSpec().make_model(PER_WORKER)
    lemma6 = rt.core.amb_budget_from_fmb(model, N_WORKERS,
                                         N_WORKERS * PER_WORKER)
    budgets = [ln["budget_s"] for ln in res["lines"]]
    acts = [ln["action"] for ln in res["lines"] if "action" in ln]
    # the 8-layer gossip session's peak, the running mean (W fp32), one
    # fp32 copy of the largest leaf, and 1 GiB for the data plane's graph
    # and batches
    w = dense_param_count(cfg)
    allowed = 39.23 + (w + cfg.vocab_size * cfg.d_model) * 4 / 2 ** 30 + 1.0
    print(f"  controller: budgets {budgets} (Lemma 6's T {lemma6!r}); "
          f"actions {[a['reason'] for a in acts]}; noise (grad_sq_norm, "
          f"grad_var) {noise}; peak_GiB={res['peak']:.2f} (allowed "
          f"{allowed:.2f})", flush=True)
    if not acts or acts[0]["budget"] is None \
            or not abs(budgets[-1] - lemma6) < abs(budgets[0] - lemma6):
        fail(f"controller: actions {acts}, budgets {budgets}")
    if len(noise) != CONTROLLER_STEPS or not all(
            math.isfinite(x) and x >= 0.0 for pair in noise for x in pair):
        fail(f"controller: noise statistics {noise}")
    if res["peak"] > allowed:
        fail(f"controller: peak {res['peak']:.2f} GiB > {allowed:.2f}")
    expect("controller", res["launches"], {
        "dual_update": 15 * N_WORKERS * CONTROLLER_STEPS,
        "gossip_combine": 2 * CONTROLLER_STEPS})
    return dict(launches=res["launches"], peak=res["peak"],
                budgets=budgets, noise=noise, lemma6=lemma6,
                step_s=res["step_times"])


def run_staleness_retune(torch, rt, cfg) -> dict:
    """Async gossip from D = 1 at ``cfg`` (QUANT_LAYERS) with the
    controller (interval 1, warm-up 2, d_max 2) and T_c = RETUNE_COMM:
    RETUNE_EPOCHS epochs and a flush.  Requires a D 1 -> 2 action with
    gamma 1/4, the drain (flush) before the rebuild, the ``staleness``
    metric following it, a queue of 2 after it, and the peak."""
    session = session_for(rt, cfg, clock=dict(comm_time=RETUNE_COMM),
                          controller=dict(interval=1, warmup=2, d_max=2),
                          consensus="gossip", async_epochs=True,
                          staleness=1)
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    order = []
    real_flush, real_build = session.flush, session._build_protocol

    def flush():
        order.append(("flush", len(session.state.get("queue", []))))
        return real_flush()

    def build(*args):
        order.append(("build", session.consensus_spec.staleness))
        return real_build(*args)

    session.flush, session._build_protocol = flush, build
    rows = []

    def on_step(epoch, m):
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows.append(dict(epoch=epoch, staleness=m["staleness"],
                         action=m.get("action"), step_s=m["step_s"],
                         budget=m["budget_s"], loss=m["loss"], peak=peak))
        print(f"  retune epoch {epoch}: staleness={m['staleness']} "
              f"T={m['budget_s']!r} loss={m['loss']:.6f} step_ms="
              f"{m['step_s'] * 1e3:.1f} action={m.get('action')} "
              f"peak_GiB={peak:.2f}", flush=True)

    print(f"staleness retune: {cfg.name} layers={cfg.num_layers} async "
          f"D=1, T_c={RETUNE_COMM}, controller interval 1 warm-up 2 "
          f"d_max 2", flush=True)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    rt.kernels.router.reset_launches()
    session.run(RETUNE_EPOCHS, source=source, on_step=on_step)
    session.flush()
    # the wrappers hold the session: drop them, or the session lives on
    # in a reference cycle until the next collection
    del session.flush, session._build_protocol, flush, build
    del real_flush, real_build
    launches = rt.kernels.router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    acts = [r for r in rows if r["action"] and r["action"]["staleness"]]
    print(f"  flush / rebuild order {order}; launches: {launches}; "
          f"peak_GiB={peak:.2f}", flush=True)
    if len(acts) != 1 or acts[0]["action"]["staleness"] != 2 \
            or acts[0]["action"]["gamma"] != 0.25:
        fail(f"retune: staleness actions {[r['action'] for r in acts]}")
    at = acts[0]["epoch"]
    if [r["staleness"] for r in rows] != [1] * (at + 1) + [2] * (
            RETUNE_EPOCHS - at - 1):
        fail(f"retune: staleness metric {[r['staleness'] for r in rows]}")
    if order[:2] != [("flush", 1), ("build", 2)] \
            or len(session.state["queue"]) != 2:
        fail(f"retune: drain and rebuild {order}, queue "
             f"{len(session.state['queue'])}")
    # a settle an epoch, the retune's drain of 1 slot, the final flush's 2
    expect("retune", launches, {
        "gossip_combine": GOSSIP_ROUNDS * (RETUNE_EPOCHS + 1 + 2),
        "dual_update": 15 * N_WORKERS * RETUNE_EPOCHS})
    del session, source
    release(torch)
    return dict(launches=launches, peak=peak, rows=rows)


def run_adaptive(torch, rt) -> dict:
    """``run_amb_adaptive`` on §6.1 (SIM_D, SIM_N, the paper graph, b
    600): a 3x mistuned T, the cluster 3x slower (lam 2/9, zeta 3) from
    epoch ADAPT_SHIFT.  Requires T (each epoch's wall-clock step less
    T_c) within ADAPT_TOL of each regime's Lemma-6 T on average over the
    last ADAPT_TAIL epochs of the regime, finite losses, one prox launch
    an epoch; then ``run_amb`` on the first regime for its epochs/s."""
    import numpy as np
    core = rt.core
    size = SIM_LINREG
    b_global = size["b_global"]
    per = b_global // SIM_N
    lin = core.objectives.LinearRegression(dim=SIM_D)
    w_star = rt.data.LinRegStream(dim=SIM_D, seed=42,
                                  device="cuda").w_star()
    fast = core.ShiftedExponential(lam=2 / 3, zeta=1.0, b_ref=b_global)
    slow = core.ShiftedExponential(lam=2 / 9, zeta=3.0, b_ref=b_global)
    lemma6 = [core.amb_budget_from_fmb(m, SIM_N, b_global)
              for m in (fast, slow)]
    cfg = core.EngineConfig(
        n=SIM_N, b_max=4 * per, chunk=per, compute_time=3.0 * lemma6[0],
        comm_time=0.3 * lemma6[0], graph="paper", consensus_rounds=5,
        beta=core.BetaSchedule(k=size["k"], mu=float(b_global)))
    kw = dict(sample_args=(w_star,), f_star=0.5 * lin.noise_var,
              eval_fn=lambda w: lin.population_loss(w, w_star))
    print(f"adaptive budget: §6.1 d={SIM_D} n={SIM_N} b={b_global} "
          f"b_max={cfg.b_max} T0={cfg.compute_time:.6f} T_c="
          f"{cfg.comm_time:.6f}; Lemma 6's T {lemma6[0]:.6f}, then "
          f"{lemma6[1]:.6f} from epoch {ADAPT_SHIFT}", flush=True)
    rt.kernels.router.reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = core.run_amb_adaptive(
        lin, lambda t: fast if t < ADAPT_SHIFT else slow, cfg,
        controller=core.AdaptiveBudget(b_target=b_global),
        epochs=ADAPT_EPOCHS, generator=gen, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = rt.kernels.router.launches()
    wall = h.wall_time.double().cpu().numpy()
    budget = np.diff(np.concatenate([[0.0], wall])) - cfg.comm_time
    tails = [budget[ADAPT_SHIFT - 1 - ADAPT_TAIL:ADAPT_SHIFT - 1],
             budget[-ADAPT_TAIL:]]
    errs = [abs(float(t.mean()) / t6 - 1.0) for t, t6 in zip(tails,
                                                             lemma6)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core.run_amb(lin, fast, dataclasses.replace(
        cfg, compute_time=lemma6[0]), epochs=ADAPT_EPOCHS, generator=gen,
        **kw)
    torch.cuda.synchronize()
    dt_amb = time.perf_counter() - t0
    loss = h.eval_loss.cpu().numpy()
    print(f"  T: epoch 1 {budget[0]:.6f}, mean of the last {ADAPT_TAIL} "
          f"before the shift {tails[0].mean():.6f} ({errs[0]:.4f} off "
          f"Lemma 6), of the last {ADAPT_TAIL} {tails[1].mean():.6f} "
          f"({errs[1]:.4f} off; tolerance {ADAPT_TOL}); eval loss "
          f"{loss[0]:.6g} -> {loss[-1]:.6g}; {ADAPT_EPOCHS / dt:.1f} "
          f"epochs/s, run_amb {ADAPT_EPOCHS / dt_amb:.1f}; launches "
          f"{launches}", flush=True)
    if max(errs) > ADAPT_TOL:
        fail(f"adaptive: T off Lemma 6 by {errs}")
    if not bool(torch.isfinite(h.eval_loss).all()):
        fail("adaptive: eval loss is not finite")
    expect("adaptive", launches, {"dual_update": ADAPT_EPOCHS})
    return dict(launches=launches, errs=errs,
                epochs_per_s=(ADAPT_EPOCHS / dt, ADAPT_EPOCHS / dt_amb))


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


def run_serve(torch, rt, argv, cfg=None) -> dict:
    """The serve CLI at full width (``argv``: SERVE_ARGV or its rwkv6-3b,
    qwen3-moe or zamba2 form; ``cfg`` a depth-cut config the CLI's session gets
    in place of the registry's, as the CLI has no depth flag): returns the
    launch counts of exactly that run.  The engine's
    sampler is wrapped to see every logits tensor it draws from, and the
    engine's insert (a prefill) and decode round and the session's step
    are timed.  Each request's prefill launches its attention kernel
    (dense) or its scan kernel (ssm) once a layer, or its attention kernel
    once an application of the shared block (hybrid), and each exact
    fine-tune epoch the prox kernel once a parameter leaf."""
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

    session_mod = sys.modules["repro_torch.api.session"]
    real_config = session_mod.get_config
    arch = argv[argv.index("--arch") + 1]
    if cfg is None:
        cfg = rt.configs.get_config(arch)
    slots.sample_token = checked
    session_mod.get_config = lambda name: cfg
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
        session_mod.get_config = real_config
        for (owner, name), fn in zip(wrapped, originals):
            setattr(owner, name, fn)
    wall = time.perf_counter() - t0
    launches = rt.kernels.router.launches()
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
    rates = [len(r.out_tokens) / (r.finish_s - r.arrival_s)
             for r in report.requests]
    pct = sys.modules["repro_torch.serve.metrics"]._pct
    print(f"  per-request tokens_per_s p50={pct(rates, 50):.2f} "
          f"p99={pct(rates, 99):.2f}", flush=True)
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
    # hybrid: one flash call for each application of the shared block
    calls = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
             else cfg.num_layers)
    want = {prefill_kernel: calls * SERVE_REQUESTS, other: 0,
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
    if any(set(ln) - {"action"} != JSONL_KEYS for ln in lines):
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


# ---------------------------------------------------------------------------
# the rest of the zoo's dense branch: qwen3-moe-30b-a3b (GQA group 8, 128
# experts top-8) and qwen3-8b at long_500k (sliding window 4096, ring caches)
# ---------------------------------------------------------------------------

MOE_ARCH, LONG_ARCH = "qwen3-moe-30b-a3b", "qwen3-8b"
FLASH_MOE = dict(b=1, h=32, kv=4, hd=128)      # qwen3-moe, batch-1 prefill
FLASH_MOE_SEQS = (2048, 2560)
FLASH_LONG = dict(b=1, h=32, kv=8, hd=128)     # qwen3-8b
FLASH_LONG_SEQS = (8192, 32768)    # 8192: the plain version and the
                                   # library take it whole
FLASH_ROWS = 512        # query rows held against the plain version where
                        # its whole scores do not fit (137 GB at 32,768)
MOE_LAYERS = 4          # depth cut of the MoE session and serve CLI (memory)
MOE_SERVE_ARGV = ["--arch", MOE_ARCH] + SERVE_ARGV[2:]
MOE_SERVE_ARGV[MOE_SERVE_ARGV.index("--arrival-gap") + 1] = "1.0"
LONG_WINDOW = 4096      # repro_torch.configs.SWA_WINDOW, long_500k's
LONG_SEQ = 524288       # repro_torch.configs.SHAPES["long_500k"].seq_len
LONG_PREFIX = 32768     # eight windows
LONG_DECODE = 64        # ring decode steps held against a linear cache
LONG_TAIL = 16          # decode steps after the long_500k prompt
# ring vs linear decode, bf16, 36 layers: max |a - b| / max |a| of a step.
# The two sum the softmax over 4096 and over 32,832 rows, and a bf16
# rounding flip grows through the layers: two linear caches that differ
# only in capacity (the same keys) differ by up to 0.027 (an H100 80GB
# HBM3 at 700 W), above JAX's 0.02 for this identity at 2 layers.  So
# the ring must stay within LONG_NOISE x that control, measured in the
# same run; the layouts themselves are held in fp32, layer by layer, on
# the same keys
LONG_NOISE = 2.0
LONG_LAYER_TOL = 1e-5   # x max |out|: fp32, sums over 4096 vs 32,833 rows
MOE_AUX = (0.9, 1.5)    # aux per layer at init (balanced routing gives 1)
MOE_PROMPT = 64         # smoke prefill prompts: one dispatch group each
MOE_HELD_PROMPTS = 2    # of 3: prompts routed alike card vs CPU, at least
MOE_FLIPS = 2           # token rows routed differently card vs CPU (fp32
                        # near-ties of the router), at most


def window_pairs(s: int, w: int) -> int:
    """(query, key) pairs a causal mask of window ``w`` keeps over S."""
    n = min(s, w)
    return n * (n + 1) // 2 + (s - n) * w


def flash_entry(torch, ops, q, k, v, window, what, library, *, reps,
                plain=True, run=None, got=None, held=None, extra=None,
                causal=True):
    """One flash shape on the tensor-core body, q (B, H, Sq, hd), k, v (B,
    KV, Skv, hd), causal (Sq = Skv) unless ``causal`` is off: the
    kernel's output (``got``, else one call of ``run``, else of the
    kernel) against the plain version, whole (``plain``) or, causal, in
    blocks of FLASH_ROWS query rows from each start in ``held`` (default:
    the last block) through ``q_offset``; then the ms of ``run`` (or the
    kernel), of the plain version (``plain``) and of ``library`` (None:
    no time), and the bound.  ``extra(got, want, tol)`` makes its own
    checks and returns keys for the entry."""
    b, h, s, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if run is None:
        run = lambda: ops.flash_attention(  # noqa: E731
            q, k, v, force="kernel", causal=causal, window=window)
    if got is None:
        got = run()
        torch.cuda.synchronize()
    if plain:
        blocks = [(got, ops.flash_attention(q, k, v, force="ref",
                                            causal=causal, window=window))]
    else:
        blocks = []
        for r0 in held or (s - FLASH_ROWS,):
            r1 = r0 + FLASH_ROWS
            k0 = max(0, r0 - window + 1) if window else 0
            blocks.append((got[:, :, r0:r1], ops.flash_attention(
                q[:, :, r0:r1], k[:, :, k0:r1], v[:, :, k0:r1], force="ref",
                window=window, q_offset=r0 - k0)))
    err = max(max_abs_err(torch, g, w) for g, w in blocks)
    tol = max(flash_tol(torch, w) for _, w in blocks)
    if not err <= tol:
        fail(f"flash_attention {what}: max_abs_err {err} > {tol}")
    more = extra(got, blocks[0][1], tol) if extra else {}
    del got, blocks
    if library is None:
        k_ms, l_ms = time_ms(torch, run, reps, what), None
    else:
        k_ms, l_ms = time_pair(torch, run, library, reps, what)
    p_ms = time_ms(torch, lambda: ops.flash_attention(
        q, k, v, force="ref", causal=causal, window=window), 5,
        f"{what} plain") if plain else None
    if not causal:
        pairs = s * skv
    else:
        pairs = window_pairs(s, window) if window else causal_pairs(s, s)
    flops = 4 * b * h * hd * pairs
    nbytes = 2 * b * hd * (2 * h * s + 2 * kvh * skv)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    rows = s if plain else FLASH_ROWS * len(held or (0,))
    entry = dict(shape=what, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                 checked_rows=rows, **more)
    print(f"flash_attention {what}: max_abs_err={err:.3g} (tol {tol:.3g}, "
          f"{rows} rows) ms={k_ms:.4f} plain_ms={p_ms} library_ms={l_ms} "
          f"bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB; {flops / k_ms / 1e9:.1f} TFLOP/s)"
          + "".join(f" {k}={x}" for k, x in more.items()), flush=True)
    return entry


def check_flash_zoo(torch, ops, router, flash, attn) -> list:
    """The flash kernel at the new models' prefill shapes: qwen3-moe's GQA
    group 8 (causal; library: SDPA with ``is_causal`` and ``enable_gqa``),
    qwen3-8b's window 4096 at S 8192 (library: SDPA with the windowed mask
    given explicitly) and 32,768 (the last FLASH_ROWS rows against the
    plain version through ``q_offset``), and the long_500k prompt through
    ``attn.flash_prefill``: query chunks of ``attn.PREFILL_ROWS`` rows,
    each with its keys from ``window - 1`` before it (its first and last
    FLASH_ROWS rows held against the plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entries = []
    for s in FLASH_MOE_SEQS:
        b, h, kv, hd = (FLASH_MOE[x] for x in ("b", "h", "kv", "hd"))
        q, k, v = model_layout(torch, gen, b, s, s, h, kv, hd,
                               torch.bfloat16)
        if flash.body(q, k, v) != "tensor_core":
            fail(f"flash_attention {MOE_ARCH} S={s}: not the tensor cores")
        entries.append(flash_entry(
            torch, ops, q, k, v, 0,
            f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal ({MOE_ARCH})",
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            reps=200))
        del q, k, v
    w = LONG_WINDOW
    for s in FLASH_LONG_SEQS:
        b, h, kv, hd = (FLASH_LONG[x] for x in ("b", "h", "kv", "hd"))
        q, k, v = model_layout(torch, gen, b, s, s, h, kv, hd,
                               torch.bfloat16)
        library = None
        if s == FLASH_LONG_SEQS[0]:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[:, None] - pos[None, :] < w)
            library = lambda: sdpa(q, k, v, attn_mask=mask,  # noqa: E731
                                   enable_gqa=True)
        entries.append(flash_entry(
            torch, ops, q, k, v, w,
            f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal window {w} "
            f"({LONG_ARCH})", library, plain=s == FLASH_LONG_SEQS[0],
            reps=20))
        del q, k, v, library
        release(torch)
    # the long_500k prompt, chunked as the model's prefill calls it
    b, h, kv, hd = (FLASH_LONG[x] for x in ("b", "h", "kv", "hd"))
    s = LONG_SEQ
    q = torch.randn((b, s, kv, h // kv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((b, s, kv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((b, s, kv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    calls = -(-s // attn.PREFILL_ROWS)
    router.reset_launches()
    out = attn.flash_prefill(q, k, v, w).reshape(b, s, h, hd)
    torch.cuda.synchronize()
    n = router.launches().get("flash_attention.tensor_core", 0)
    if n != calls:
        fail(f"flash_prefill S={s}: {n} tensor-core launches, expected "
             f"{calls}")
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, h, s, hd)
    entries.append(flash_entry(
        torch, ops, qh, k.transpose(1, 2), v.transpose(1, 2), w,
        f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal window {w} "
        f"({LONG_ARCH} long_500k), {calls} calls of {attn.PREFILL_ROWS} "
        f"query rows", None, reps=3, plain=False,
        run=lambda: attn.flash_prefill(q, k, v, w),
        got=out.transpose(1, 2), held=(0, s - FLASH_ROWS)))
    del q, k, v, qh, out
    release(torch)
    return entries


class RoutingLog:
    """Records each ``moe_forward`` call's expert picks (idx of its top-k)
    while installed on the model module, so that two runs can be compared
    call by call."""

    def __init__(self, torch, model_mod):
        self.torch, self.mod, self.calls = torch, model_mod, []

    def __enter__(self):
        real = self.real = self.mod.moe.moe_forward
        torch = self.torch

        def logged(p, x, cfg):
            probs = torch.softmax(torch.einsum(
                "bsd,de->bse", x.float(), p["router"]), dim=-1)
            idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
            self.calls.append(idx.sort(-1).values.cpu())
            return real(p, x, cfg)

        self.mod.moe.moe_forward = logged
        return self

    def __exit__(self, *exc):
        self.mod.moe.moe_forward = self.real


def routing_diff(a: list, b: list) -> list:
    """Per call, the token rows whose picks differ between two logs."""
    if len(a) != len(b):
        fail(f"routing logs of {len(a)} and {len(b)} calls")
    return [int((x != y).any(-1).sum()) for x, y in zip(a, b)]


def zoo_reference_check(torch, rt) -> None:
    """Smoke-size fp32 card (kernels) vs CPU (plain versions) for the new
    models: qwen3-8b with window 8, a 20-token prompt (ring caches of 8
    rows) and 6 greedy decode steps; qwen3-moe-30b-a3b prefill (3 prompts
    of MOE_PROMPT tokens, right-padded) and the slot engine's greedy
    tokens.  Where the MoE routes a token to other experts on the card
    than on the CPU, the differing rows are counted (at most MOE_FLIPS)
    and the rest held: the prompts routed alike in every layer (at least
    MOE_HELD_PROMPTS) within SERVE_TOL, and each request's greedy tokens
    equal, and the logits they came from within SERVE_TOL, up to the
    first engine call that served it with a row routed differently (at
    least half of all tokens held)."""
    cfg = dataclasses.replace(rt.configs.smoke_config(LONG_ARCH),
                              dtype="float32", sliding_window=8)
    params = rt.models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device) for k, v in params.items()}
        rt.kernels.router.reset_launches()
        logits, st = rt.models.prefill(p, cfg, {"tokens": toks.to(device)})
        seq = [logits.cpu()]
        tok = logits.argmax(-1)
        for _ in range(6):
            logits, st = rt.models.decode_step(p, cfg, st, tok)
            seq.append(logits.cpu())
            tok = logits.argmax(-1)
        if (device == "cuda") != (rt.kernels.router.launches().get(
                "flash_attention", 0) == cfg.num_layers):
            fail(f"reference {LONG_ARCH} window: flash launches "
                 f"{rt.kernels.router.launches()}")
        out[device] = (torch.stack(seq), st.caches.k.cpu(),
                       st.caches.v.cpu())
    err = max(max_abs_err(torch, a, b) for a, b in zip(out["cpu"],
                                                       out["cuda"]))
    print(f"reference {LONG_ARCH} window 8: prefill and 6 decode steps' "
          f"logits and ring caches card vs CPU max_abs_err={err:.3g}",
          flush=True)
    if not err <= SERVE_TOL:
        fail(f"reference {LONG_ARCH} window: max_abs_err {err} > "
             f"{SERVE_TOL}")

    cfg = dataclasses.replace(rt.configs.smoke_config(MOE_ARCH),
                              dtype="float32")
    params = rt.models.init_params(cfg, torch.Generator().manual_seed(0))
    # prompts of MOE_PROMPT tokens: each its own dispatch group (JAX's
    # rule), so a token routed differently can only change its own
    # prompt's capacity drops
    toks = torch.randint(0, cfg.vocab_size, (3, MOE_PROMPT),
                         generator=torch.Generator().manual_seed(1))
    if rt.models.moe.num_groups(3, MOE_PROMPT) != 3:
        fail(f"reference {MOE_ARCH}: prompts share a dispatch group")
    last = torch.tensor([MOE_PROMPT - 1, 17, 40])
    model_mod = sys.modules["repro_torch.models.model"]
    res = {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device) for k, v in params.items()}
        with RoutingLog(torch, model_mod) as pre:
            logits, st = rt.models.prefill(
                p, cfg, {"tokens": toks.to(device)}, extra_capacity=8,
                last_pos=last.to(device))
        engine = rt.serve.SlotEngine(p, cfg, slots=2, cache_len=64)
        reqs = rt.serve.synthetic_requests(
            5, vocab_size=cfg.vocab_size, prompt_len=24, prompt_jitter=8,
            max_new_tokens=8, seed=3)
        with RoutingLog(torch, model_mod) as eng:
            calls = engine_calls(engine, eng)
            drain(engine, reqs)
        res[device] = dict(logits=logits.cpu(), k=st.caches.k.cpu(),
                           v=st.caches.v.cpu(), pre=pre.calls,
                           eng=eng.calls, calls=calls,
                           rids=[r.rid for r in reqs],
                           tokens=[r.out_tokens for r in reqs])
    cpu, gpu = res["cpu"], res["cuda"]
    # a prompt with a row routed differently in any layer is left out
    rows_off = torch.zeros(3, dtype=torch.bool)
    for x, y in zip(cpu["pre"], gpu["pre"]):
        rows_off |= (x != y).any(-1).any(-1)
    keep = ~rows_off
    held = int(keep.sum())
    err = max(max_abs_err(torch, cpu[n][:, keep] if n != "logits"
                          else cpu[n][keep],
                          gpu[n][:, keep] if n != "logits"
                          else gpu[n][keep])
              for n in ("logits", "k", "v")) if held else float("inf")
    pre_diff = routing_diff(cpu["pre"], gpu["pre"])
    eng_diff = routing_diff(cpu["eng"], gpu["eng"])
    lim, eng_err = held_tokens(cpu["calls"], gpu["calls"], cpu["eng"],
                               gpu["eng"])
    upto = [lim.get(r, len(t)) for r, t in zip(gpu["rids"], gpu["tokens"])]
    got = sum(len(t) for t in gpu["tokens"])
    same = sum(len(t[:n]) for t, n in zip(gpu["tokens"], upto))
    print(f"reference {MOE_ARCH}: prefill token rows routed differently "
          f"per call {pre_diff}; prompts held {held} of 3, logits and "
          f"caches card vs CPU max_abs_err={err:.3g}; slot engine rows "
          f"routed differently {sum(eng_diff)} over {len(eng_diff)} calls, "
          f"greedy tokens held {same} of {got} (per request {upto}), "
          f"their logits max_abs_err={eng_err:.3g}", flush=True)
    if held < MOE_HELD_PROMPTS or sum(pre_diff) + sum(eng_diff) > MOE_FLIPS:
        fail(f"reference {MOE_ARCH}: {held} of 3 prompts routed alike, "
             f"{sum(pre_diff) + sum(eng_diff)} rows routed differently "
             f"(at most {MOE_FLIPS})")
    if not max(err, eng_err) <= SERVE_TOL:
        fail(f"reference {MOE_ARCH}: max_abs_err {err} (prefill), "
             f"{eng_err} (slot engine) > {SERVE_TOL}")
    if 2 * same < got:
        fail(f"reference {MOE_ARCH}: {same} of {got} greedy tokens came "
             f"before a call routed differently")
    for t_cpu, t_gpu, n in zip(cpu["tokens"], gpu["tokens"], upto):
        if t_cpu[:n] != t_gpu[:n]:
            fail(f"reference {MOE_ARCH}: greedy tokens differ before any "
                 f"call routed differently: card {t_gpu[:n]} vs CPU "
                 f"{t_cpu[:n]}")


def engine_calls(engine, log) -> list:
    """Wraps ``engine``'s insert, decode_round and sampler: each call made
    records (the slice of ``log.calls`` it made, for every request it
    served the tokens that request held before it and its row of the
    logits, and the logits it sampled from)."""
    calls, seen, sample = [], [], engine._sample

    def sampled(logits):
        seen.append(logits.float().cpu())
        return sample(logits)

    def wrap(fn, served, row):
        def call(*args):
            before = {r.rid: (len(r.out_tokens), row(r))
                      for r in served(*args)}
            n0, s0 = len(log.calls), len(seen)
            out = fn(*args)
            calls.append((slice(n0, len(log.calls)), before, seen[s0:]))
            return out
        return call

    engine._sample = sampled
    engine.insert = wrap(engine.insert, lambda req: [req], lambda r: 0)
    engine.decode_round = wrap(
        engine.decode_round,
        lambda: [r for r in engine.active if r is not None],
        lambda r: r.slot)
    return calls


def held_tokens(calls_a, calls_b, log_a, log_b) -> tuple:
    """Holds runs a and b of the slot engine request by request up to the
    first call that served it with any token routed differently (a decode
    round's rows share one dispatch group, so one row routed differently
    may change every row's drops).  Returns (rid -> the greedy tokens it
    made before that call, absent where there was none; the max abs
    difference of the logits it sampled from before it).  Fails if the
    two runs' schedules differ."""
    if [c[1] for c in calls_a] != [c[1] for c in calls_b]:
        fail("reference: the slot engine's schedules differ")
    upto, err = {}, 0.0
    for (sa, served, la), (sb, _, lb) in zip(calls_a, calls_b):
        routed = any(bool((x != y).any()) for x, y in zip(log_a[sa],
                                                           log_b[sb]))
        for rid, (n, row) in served.items():
            if rid in upto:
                continue
            if routed:
                upto[rid] = n
            else:
                err = max(err, float((la[0][row] - lb[0][row]).abs().max()))
    return upto, err


def init_on_card(torch, rt, cfg) -> tuple:
    """(parameters from seed 0 on the card, seconds), printed with the
    parameter count and bytes."""
    t0 = time.perf_counter()
    params = rt.models.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    print(f"{cfg.name}: layers={cfg.num_layers} "
          f"P={rt.models.param_count(params)} weights_GB={nbytes / 1e9:.2f} "
          f"init_s={dt:.1f}", flush=True)
    return params, dt


def run_engine_serve(torch, rt, cfg, requests: int, new: int,
                     gap_s: float, seed: int) -> dict:
    """``cfg`` at full width, bf16, through ``SlotEngine`` and
    ``ServeScheduler`` with no session (an AMBSession's fp32 z and w0
    would add 244 GB at qwen3-moe's 48 layers): 8 slots, ``requests``
    prompts of 2048 +- 512 tokens (MoE: at their exact lengths; vlm: as
    their embedding rows, padded to their buckets), ``new`` greedy
    tokens, arrivals ``gap_s`` apart, round budget 0.25 s.  Requires
    every request to finish, finite logits, and one tensor-core flash
    launch a layer a request; prints TTFT, TPOT, the prefill's and the
    decode round's times and the peak; returns the launch counts of the
    run."""
    from repro_torch.serve import slots
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    params, _ = init_on_card(torch, rt, cfg)
    cache_len = 2048 + 512 + new
    reqs = rt.serve.synthetic_requests(
        requests, vocab_size=cfg.vocab_size, prompt_len=2048,
        prompt_jitter=512, max_new_tokens=new, arrival_gap_s=gap_s,
        seed=seed)
    queue = rt.serve.RequestQueue(rt.serve.AdmissionPolicy(
        cache_len=cache_len))
    for r in reqs:
        queue.push(r)
    engine = rt.serve.SlotEngine(params, cfg, slots=8, cache_len=cache_len)
    split: dict = {}
    engine.insert = timed(split, "insert", engine.insert)
    engine.decode_round = timed(split, "decode_round", engine.decode_round)
    sample, seen = slots.sample_token, []

    def checked(logits, *args, **kw):
        seen.append(int((~torch.isfinite(logits)).sum()))
        return sample(logits, *args, **kw)

    slots.sample_token = checked
    rt.kernels.router.reset_launches()
    t0 = time.perf_counter()
    try:
        report = rt.serve.ServeScheduler(engine, queue,
                                         round_budget_s=0.25).run()
    finally:
        slots.sample_token = sample
    wall = time.perf_counter() - t0
    launches = rt.kernels.router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = report.summary
    print(f"serve {cfg.name}: layers={cfg.num_layers} bf16 slots=8 "
          f"requests={s['n_requests']} buckets={sorted(engine.buckets)} "
          f"rounds={report.rounds} wall_s={wall:.1f} peak_GiB={peak:.2f}",
          flush=True)
    print(f"  ttft_s p50={s['ttft_p50_s']:.4f} p99={s['ttft_p99_s']:.4f} "
          f"tpot_s p50={s['tpot_p50_s']:.4f} p99={s['tpot_p99_s']:.4f} "
          f"latency_s p50={s['latency_p50_s']:.4f} "
          f"p99={s['latency_p99_s']:.4f} tokens_per_s="
          f"{s['tokens_per_s']:.2f}", flush=True)
    for name, label in (("insert", "prefill (insert)"),
                        ("decode_round", "decode round")):
        ts = sorted(split.get(name, []))
        print(f"  {label}: n={len(ts)} total_s={sum(ts):.3f} median_s="
              f"{ts[len(ts) // 2]:.4f} min_s={ts[0]:.4f} max_s="
              f"{ts[-1]:.4f}", flush=True)
    print(f"  launches: {launches}", flush=True)
    done = [r for r in report.requests
            if len(r.out_tokens) == new and r.finish_reason == "length"]
    if len(done) != requests:
        fail(f"serve {cfg.name}: {len(done)} of {requests} requests "
             f"finished with {new} tokens")
    want = cfg.num_layers * requests
    expect(f"serve {cfg.name}", launches, {
        "flash_attention": want, "flash_attention.tensor_core": want,
        "flash_attention.cuda_core": 0, "dual_update": 0})
    if any(seen) or len(seen) < requests:
        fail(f"serve {cfg.name}: {sum(seen)} non-finite logits over "
             f"{len(seen)} draws")
    del engine, params, report
    release(torch)
    return launches


def run_moe_session(torch, rt, cfg, beta: float) -> tuple:
    """AMBSession exact on qwen3-moe-30b-a3b at full width cut to
    MOE_LAYERS layers, N_WORKERS x PER_WORKER x SEQ, EPOCHS epochs: loss
    and aux finite each epoch (aux read where the exact step takes its
    loss), aux per layer within MOE_AUX at init, one prox launch a leaf an
    epoch; prints each epoch's peak.  Then the prox at the leaves only
    this path gives it, held against its plain version on the session's
    own z and fp32 w0 buffers after the last epoch, z redrawn from N(0, 1)
    (three epochs leave most experts' z near 0, where a wrong prox would
    still agree): the fp32 router (L, d, E) and the three expert leaves
    (L, E, d, ff) and (L, E, ff, d), the first also with its w0 in bf16.
    Returns (the launch counts, the prox's worst error)."""
    amb_mod = sys.modules["repro_torch.dist.amb"]
    real, auxes = amb_mod.lm_loss, []

    def loss(*args, **kw):
        total, m = real(*args, **kw)
        auxes.append(float(m["aux"].detach()))
        return total, m

    release(torch)
    session = session_for(rt, cfg, consensus="exact")
    leaves = len(session.params)
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    print(f"session exact {cfg.name}: layers={cfg.num_layers} "
          f"P={rt.models.param_count(session.params)} leaves={leaves} "
          f"workers={N_WORKERS} batch/worker={PER_WORKER} seq={SEQ}",
          flush=True)
    amb_mod.lm_loss = loss
    rt.kernels.router.reset_launches()
    try:
        for epoch in range(EPOCHS):
            torch.cuda.reset_peak_memory_stats()
            m = session.step(source.batch(epoch))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"  epoch {epoch}: loss={m['loss']:.6f} aux="
                  f"{auxes[-1]:.6f} (per layer "
                  f"{auxes[-1] / cfg.num_layers:.4f}) b={m['b'].tolist()} "
                  f"step_ms={m['step_s'] * 1e3:.1f} peak_GiB={peak:.2f}",
                  flush=True)
            if not (math.isfinite(m["loss"]) and math.isfinite(auxes[-1])):
                fail(f"MoE session epoch {epoch}: loss {m['loss']} aux "
                     f"{auxes[-1]}")
    finally:
        amb_mod.lm_loss = real
    launches = rt.kernels.router.launches()
    print(f"  launches: {launches}", flush=True)
    lo, hi = MOE_AUX
    if not lo <= auxes[0] / cfg.num_layers <= hi:
        fail(f"MoE session: aux per layer at init {auxes[0]} / "
             f"{cfg.num_layers} outside {MOE_AUX}")
    expect("MoE session", launches, {"dual_update": leaves * EPOCHS})
    if leaves != 15:
        fail(f"MoE session: {leaves} leaves, expected 15")
    del source
    release(torch)
    opt, worst = session.state["opt"], 0.0
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name in ("router", "w_gate", "w_up", "w_down"):
        key = f"blocks.moe.{name}"
        z = opt["z"][key].normal_(generator=gen)
        for w0 in (opt["w0"][key], opt["w0"][key].bfloat16()) \
                if name == "w_gate" else (opt["w0"][key],):
            what = f"{key} {tuple(z.shape)}"
            err = hold_dual_update(torch, rt.kernels.ops, rt.kernels.ref, z,
                                   w0, beta, what)
            ms = time_ms(torch, lambda: rt.kernels.ops.dual_update(
                z, w0, beta, force="kernel"), 5, f"dual_update {key}")
            b_ms, _ = bound(z.numel() * (4 + w0.element_size() + 4),
                            2 * z.numel())
            print(f"  dual_update {what} z fp32 N(0, 1) w0 {w0.dtype}: "
                  f"max_abs_err={err:.3g} (tol {DUAL_TOL}) ms={ms:.4f} "
                  f"bound_ms={b_ms:.4f}; launches in the epochs "
                  f"{launches['dual_update']}", flush=True)
            worst = max(worst, err)
            del w0
    del session, opt, z
    release(torch)
    return launches, worst


def linear_from_ring(torch, rt, state, s: int, extra: int):
    """The linear cache (rows 0..s+extra-1) holding what a ring state after
    an s-token prompt holds: position p at row p, positions before the
    ring's reach zero (the window masks them)."""
    rk, rv = state.caches.k, state.caches.v
    cap = rk.shape[2]
    shape = rk.shape[:2] + (s + extra,) + rk.shape[3:]
    lk, lv = rk.new_zeros(shape), rv.new_zeros(shape)
    pos = torch.arange(s - cap, s, device=rk.device)
    lk[:, :, pos] = rk[:, :, pos % cap]
    lv[:, :, pos] = rv[:, :, pos % cap]
    return rt.models.DecodeState(rt.models.KVCache(lk, lv, False),
                                 state.pos.clone())


def ring_layers_fp32(torch, rt, params, cfg, ring) -> float:
    """Each layer's decode attention in fp32 at the ring's position, over
    its ring cache and over a linear cache holding the same keys (built
    from it): the worst max |ring - linear| / max |out|."""
    pos = int(ring.pos)
    linear = linear_from_ring(torch, rt, ring, pos, 1)
    c32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for layer, lp in enumerate(rt.models.model._layers(params, cfg)):
        p32 = {k: v.float() for k, v in lp["attn"].items()}
        x = torch.randn((1, 1, cfg.d_model), generator=gen, device="cuda")
        outs = []
        for st, is_ring in ((ring, True), (linear, False)):
            cache = rt.models.KVCache(st.caches.k[layer].float(),
                                      st.caches.v[layer].float(), is_ring)
            outs.append(rt.models.decode_attend(
                p32, x, st.pos, cache, c32, window=cfg.sliding_window)[0])
        worst = max(worst, float((outs[0] - outs[1]).abs().max()
                                 / outs[0].abs().max()))
    del linear
    return worst


def run_long_context(torch, rt) -> dict:
    """qwen3-8b at ``get_config(shape="long_500k")`` (window 4096), full
    width, all 36 layers, bf16, batch 1: a LONG_PREFIX-token prefill
    through the kernel (ring caches of 4096 rows), LONG_DECODE greedy
    decode steps on the ring held step by step against the same steps on
    a linear cache masked to the window (within LONG_NOISE x the gap
    between two linear caches that differ only in capacity), and each
    layer's attention in fp32 on the same keys in both layouts; then a
    prefill
    at the shape's own length (524,288 tokens: query chunks of
    ``PREFILL_ROWS`` rows) and LONG_TAIL decode steps past it.  Returns
    the launch counts of the two prefills and their decodes."""
    cfg = rt.configs.get_config(LONG_ARCH, shape="long_500k")
    seq = rt.configs.SHAPES["long_500k"].seq_len
    if (cfg.sliding_window, seq) != (LONG_WINDOW, LONG_SEQ):
        fail(f"{LONG_ARCH} long_500k: window {cfg.sliding_window}, "
             f"{seq} tokens")
    rows = rt.models.attention.PREFILL_ROWS
    release(torch)
    params, _ = init_on_card(torch, rt, cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                         device="cuda")
    rt.kernels.router.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, ring = rt.models.prefill(params, cfg,
                                     {"tokens": toks[:, :LONG_PREFIX]})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    if not (ring.caches.ring and ring.caches.k.shape[2] == cfg.sliding_window):
        fail(f"{LONG_ARCH} long: prefill gave no ring cache of "
             f"{cfg.sliding_window} rows")
    linear = linear_from_ring(torch, rt, ring, LONG_PREFIX, LONG_DECODE)
    control = linear_from_ring(torch, rt, ring, LONG_PREFIX,
                               LONG_DECODE + LONG_WINDOW)
    worst, noise, agree = 0.0, 0.0, 0
    tok = logits.argmax(-1)
    t0 = time.perf_counter()
    for _ in range(LONG_DECODE):
        a, ring = rt.models.decode_step(params, cfg, ring, tok)
        b, linear = rt.models.decode_step(params, cfg, linear, tok)
        c, control = rt.models.decode_step(params, cfg, control, tok)
        af, bf, cf = a.float(), b.float(), c.float()
        top = af.abs().max()
        worst = max(worst, float((af - bf).abs().max() / top))
        noise = max(noise, float((bf - cf).abs().max() / top))
        agree += int(torch.equal(a.argmax(-1), b.argmax(-1)))
        if not bool(torch.isfinite(af).all()):
            fail(f"{LONG_ARCH} long: non-finite decode logits")
        tok = a.argmax(-1)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    layer_err = ring_layers_fp32(torch, rt, params, cfg, ring)
    print(f"long {LONG_ARCH} window {cfg.sliding_window}: prefill "
          f"{LONG_PREFIX} tokens in {pre_s:.2f} s "
          f"({LONG_PREFIX / pre_s:.0f} tokens/s); {LONG_DECODE} decode "
          f"steps ring vs linear cache: worst rel err {worst:.3g} (two "
          f"linear caches of other capacities: {noise:.3g}; tol "
          f"{LONG_NOISE} x that), greedy tokens agree {agree}/"
          f"{LONG_DECODE}, {steps_s / LONG_DECODE * 1e3:.1f} ms a step "
          f"triple; fp32 attention on the same keys, ring vs linear, worst "
          f"layer {layer_err:.3g} of max |out| (tol {LONG_LAYER_TOL}); "
          f"peak_GiB={peak_a:.2f}", flush=True)
    if not (worst <= LONG_NOISE * noise and layer_err <= LONG_LAYER_TOL):
        fail(f"{LONG_ARCH} long: ring vs linear decode rel err {worst} "
             f"(control {noise}), fp32 layers {layer_err}")
    if int(ring.pos) != LONG_PREFIX + LONG_DECODE:
        fail(f"{LONG_ARCH} long: ring position {int(ring.pos)}")
    del ring, linear, control, logits, a, b, c
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, st = rt.models.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    peak_p = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    tok = logits.argmax(-1)
    t0 = time.perf_counter()
    for _ in range(LONG_TAIL):
        logits, st = rt.models.decode_step(params, cfg, st, tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    peak_d = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = rt.kernels.router.launches()
    print(f"long {LONG_ARCH} long_500k: prefill {seq} tokens in "
          f"{pre_s:.2f} s ({seq / pre_s:.0f} tokens/s; {-(-seq // rows)} "
          f"flash calls a layer) peak_GiB={peak_p:.2f}; {LONG_TAIL} decode "
          f"steps past it in {dec_s:.3f} s ({dec_s / LONG_TAIL * 1e3:.1f} "
          f"ms a token) peak_GiB={peak_d:.2f}; launches {launches}",
          flush=True)
    if not bool(torch.isfinite(logits.float()).all()) \
            or int(st.pos) != seq + LONG_TAIL:
        fail(f"{LONG_ARCH} long_500k: logits or position {int(st.pos)}")
    calls = cfg.num_layers * (1 + -(-seq // rows))
    expect(f"{LONG_ARCH} long", launches, {
        "flash_attention": calls, "flash_attention.tensor_core": calls})
    del params, st, logits, toks
    release(torch)
    return dict(launches=launches, prefill_s=pre_s, seq=seq,
                peak_prefill_gib=peak_p)


# ---------------------------------------------------------------------------
# the Mamba2 hybrid: zamba2-1.2b (38 Mamba2 layers, one shared dense block
# applied after every 6th layer: MHA, GQA group 1, hd 64)
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-1.2b"
FLASH_ZAMBA = dict(b=1, h=32, kv=32, hd=64)    # the shared block's prefill
FLASH_ZAMBA_SEQS = (2048, 2560)
ZAMBA_LEAVES, ZAMBA_P = 20, 1_170_313_344      # JAX's init_params, full
ZAMBA_DECODE = 6        # smoke decode steps held card vs CPU
# the serve CLI at full width (see SERVE_*): a zamba2 request took 2.04 s
# at the median (a 0.21 to 0.44 s prefill, 32 decode rounds of 39 to 90
# ms), so arrivals 2.0 s apart leave idle time between requests (8
# stretches, 1.3 s); a fine-tune epoch (0.85 s) is past the round's
# budget, so a run absorbs one
SERVE_ZAMBA_ARGV = ["--arch", ZAMBA_ARCH] + SERVE_ARGV[2:]


def check_flash_zamba(torch, ops, flash) -> list:
    """The flash kernel at the shared block's prefill shapes (MHA: GQA
    group 1, hd 64; causal; S 2048 and 2560), on the tensor-core body;
    library: SDPA with ``is_causal``."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, kv, hd = (FLASH_ZAMBA[x] for x in ("b", "h", "kv", "hd"))
    entries = []
    for s in FLASH_ZAMBA_SEQS:
        q, k, v = model_layout(torch, gen, b, s, s, h, kv, hd,
                               torch.bfloat16)
        if flash.body(q, k, v) != "tensor_core":
            fail(f"flash_attention {ZAMBA_ARCH} S={s}: not the tensor cores")
        entries.append(flash_entry(
            torch, ops, q, k, v, 0,
            f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal ({ZAMBA_ARCH})",
            lambda: sdpa(q, k, v, is_causal=True), reps=200))
        del q, k, v
    release(torch)
    return entries


def zamba_reference_check(torch, rt) -> None:
    """Smoke-size fp32 zamba2, card (kernels) vs CPU (plain versions): a
    40-token prefill of 2 rows with 8 free cache rows (logits, every
    layer's Mamba2 h and conv tail, the shared block's K and V) and
    ZAMBA_DECODE greedy decode steps, within SERVE_TOL of each tensor's
    largest value; the slot engine's greedy tokens equal; and a 3-epoch
    exact session's losses and duals (SESSION_TOL of each leaf's largest
    |z|).  One flash launch a prefill on the card, none on the CPU."""
    cfg = dataclasses.replace(rt.configs.smoke_config(ZAMBA_ARCH),
                              dtype="float32")
    params = rt.models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    apps = cfg.num_layers // cfg.attn_every
    out, tokens, duals = {}, {}, {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device) for k, v in params.items()}
        rt.kernels.router.reset_launches()
        logits, st = rt.models.prefill(p, cfg, {"tokens": toks.to(device)},
                                       extra_capacity=8)
        # copies: decode updates the caches in place, and on the CPU
        # .cpu() would return the tensor itself
        snap = rt.models.model._cache_tensors(st.caches)
        seq = [t.to("cpu", copy=True) for t in [logits] + snap]
        tok = logits.argmax(-1)
        for _ in range(ZAMBA_DECODE):
            logits, st = rt.models.decode_step(p, cfg, st, tok)
            seq.append(logits.to("cpu", copy=True))
            tok = logits.argmax(-1)
        seq += [t.to("cpu", copy=True) for t in snap]
        engine = rt.serve.SlotEngine(p, cfg, slots=2, cache_len=64)
        reqs = rt.serve.synthetic_requests(
            5, vocab_size=cfg.vocab_size, prompt_len=24, prompt_jitter=8,
            max_new_tokens=8, seed=3)
        drain(engine, reqs)
        n = rt.kernels.router.launches().get("flash_attention", 0)
        if n != (apps * (1 + len(reqs)) if device == "cuda" else 0):
            fail(f"reference {ZAMBA_ARCH} on {device}: {n} flash launches")
        out[device] = seq
        tokens[device] = [r.out_tokens for r in reqs]
        s = rt.api.AMBSession(
            rt.api.TrainSpec(arch=ZAMBA_ARCH, smoke=True, data=N_WORKERS,
                             batch_per_worker=2, seq_len=16),
            rt.api.ClockSpec(kind="simulated"),
            rt.api.ConsensusSpec(consensus="exact"), cfg=cfg,
            params={k: v.clone() for k, v in p.items()}, device=device)
        src = rt.data.SyntheticSource(cfg.vocab_size, 16, N_WORKERS, 2,
                                      device="cpu")
        losses = [s.step({k: v.to(device) for k, v in src.batch(e).items()},
                         [2, 1, 0, 2])["loss"] for e in range(EPOCHS)]
        duals[device] = (losses, {k: v.cpu() for k, v in
                                  s.state["opt"]["z"].items()})
    errs = [max_abs_err(torch, a, b) / max(float(a.abs().max()), 1e-30)
            for a, b in zip(out["cpu"], out["cuda"])]
    err = max(errs)
    (l_cpu, z_cpu), (l_gpu, z_gpu) = duals["cpu"], duals["cuda"]
    z_err = max(max_abs_err(torch, z_cpu[k], z_gpu[k])
                / max(float(z_cpu[k].abs().max()), 1e-30) for k in z_cpu)
    l_err = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    print(f"reference {ZAMBA_ARCH}: prefill logits, Mamba2 h and conv, "
          f"shared K and V, {ZAMBA_DECODE} decode steps card vs CPU worst "
          f"rel err {err:.3g} (each: {', '.join(f'{e:.2g}' for e in errs)}"
          f"); slot-engine tokens equal: "
          f"{tokens['cpu'] == tokens['cuda']}; exact session {EPOCHS} "
          f"epochs losses {l_gpu} vs {l_cpu}, {len(z_cpu)} duals worst rel "
          f"err {z_err:.3g}", flush=True)
    if not (err <= SERVE_TOL and z_err <= SESSION_TOL
            and l_err <= SESSION_TOL):
        fail(f"reference {ZAMBA_ARCH}: rel err {err} (serving), {z_err} "
             f"(duals), {l_err} (losses)")
    if tokens["cpu"] != tokens["cuda"]:
        fail(f"reference {ZAMBA_ARCH}: greedy tokens differ: card "
             f"{tokens['cuda']} vs CPU {tokens['cpu']}")
    if len(z_cpu) != ZAMBA_LEAVES:
        fail(f"reference {ZAMBA_ARCH}: {len(z_cpu)} duals")


def all_finite(torch, tree: dict, what: str) -> None:
    for name, t in tree.items():
        if not bool(torch.isfinite(t).all()):
            fail(f"{what} {name} is not finite")


def run_zamba_session(torch, rt, beta: float) -> tuple:
    """AMBSession exact on zamba2-1.2b at full width, all 38 layers, bf16,
    N_WORKERS x PER_WORKER x SEQ (256 tokens: one full Mamba2 chunk),
    EPOCHS epochs: the loss finite, and every gradient leaf (seen where
    the optimizer takes it) and every dual finite after each epoch; step
    ms and the peak each epoch; one prox launch a leaf an epoch.  Then the
    prox at the Mamba2 input projection ``blocks.mamba.w_in`` (38, 2048,
    8384), held against its plain version on the session's own z (redrawn
    N(0, 1)) and fp32 w0, and on w0 in bf16.  Returns (the launch counts,
    the prox's worst error)."""
    cfg = rt.configs.get_config(ZAMBA_ARCH)
    release(torch)
    session = session_for(rt, cfg, consensus="exact")
    leaves, p = len(session.params), rt.models.param_count(session.params)
    print(f"session exact {cfg.name}: layers={cfg.num_layers} P={p} "
          f"leaves={leaves} workers={N_WORKERS} batch/worker={PER_WORKER} "
          f"seq={SEQ} chunk={cfg.ssm_chunk}", flush=True)
    if (leaves, p) != (ZAMBA_LEAVES, ZAMBA_P):
        fail(f"zamba2 session: {leaves} leaves, P={p}; expected "
             f"{ZAMBA_LEAVES}, {ZAMBA_P}")
    opt_cls = type(session._optimizer)
    real, seen = opt_cls.apply, []

    def apply(self, grads, state, params):
        all_finite(torch, grads, "zamba2 session gradient")
        seen.append(len(grads))
        return real(self, grads, state, params)

    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    opt_cls.apply = apply
    rt.kernels.router.reset_launches()
    try:
        for epoch in range(EPOCHS):
            torch.cuda.reset_peak_memory_stats()
            m = session.step(source.batch(epoch))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"  epoch {epoch}: loss={m['loss']:.6f} b="
                  f"{m['b'].tolist()} step_ms={m['step_s'] * 1e3:.1f} "
                  f"peak_GiB={peak:.2f}", flush=True)
            if not math.isfinite(m["loss"]):
                fail(f"zamba2 session epoch {epoch}: loss {m['loss']}")
            if epoch == 0 and abs(m["loss"] - math.log(cfg.vocab_size)) > 3:
                fail(f"zamba2 session: first loss {m['loss']} is far from "
                     f"ln(vocab)")
            all_finite(torch, session.state["opt"]["z"], "zamba2 dual")
            all_finite(torch, session.params, "zamba2 parameter")
    finally:
        opt_cls.apply = real
    launches = rt.kernels.router.launches()
    print(f"  launches: {launches}; gradient trees checked {len(seen)} "
          f"of {leaves} leaves each", flush=True)
    if seen != [leaves] * EPOCHS:
        fail(f"zamba2 session: gradients seen {seen}")
    expect("zamba2 session", launches, {"dual_update": leaves * EPOCHS,
                                        "flash_attention": 0})
    del source
    release(torch)
    key = "blocks.mamba.w_in"
    z = session.state["opt"]["z"][key].normal_(
        generator=torch.Generator(device="cuda").manual_seed(2))
    w0 = session.state["opt"]["w0"][key]
    worst = 0.0
    for w in (w0, w0.bfloat16()):
        what = f"{key} {tuple(z.shape)}"
        err = hold_dual_update(torch, rt.kernels.ops, rt.kernels.ref, z, w,
                               beta, what)
        ms = time_ms(torch, lambda: rt.kernels.ops.dual_update(
            z, w, beta, force="kernel"), 5, f"dual_update {key}")
        b_ms, _ = bound(z.numel() * (4 + w.element_size() + 4),
                        2 * z.numel())
        print(f"  dual_update {what} z fp32 N(0, 1) w0 {w.dtype}: "
              f"max_abs_err={err:.3g} (tol {DUAL_TOL}) ms={ms:.4f} "
              f"bound_ms={b_ms:.4f}", flush=True)
        worst = max(worst, err)
        del w
    del session, z, w0
    release(torch)
    return launches, worst


WHISPER_ARCH, VLM_ARCH = "whisper-base", "internvl2-76b"
FLASH_WHISPER = dict(b=1, h=8, kv=8, hd=64)     # MHA, group 1
WHISPER_FRAMES = 1500   # the encoder's frames: one 30 s audio window
WHISPER_PROMPT = (4, 224)   # the start-of-transcript tokens, up to the
                            # 224-token prompt limit (previous text)
FLASH_VLM = dict(b=1, h=64, kv=8, hd=128)       # internvl2's prefill
FLASH_VLM_SEQS = (2048, 2560)
WHISPER_LEAVES, WHISPER_P = 27, 109_854_720     # JAX's init_params, full
WHISPER_SLOTS, WHISPER_NEW = 8, 128     # two waves of 8 requests
WHISPER_DECODE = 6      # smoke decode steps held card vs CPU
# internvl2-76b at 32 of its 80 layers: 70,553,706,496 parameters (141 GB
# in bf16) do not fit one 80 GB card; 32 layers are 29.48 B (58.96 GB)
VLM_LAYERS = 32
VLM_REQUESTS, VLM_NEW, VLM_GAP_S = 8, 16, 1.0


def check_flash_whisper(torch, ops, flash) -> list:
    """The flash kernel at the new models' prefill shapes, each on the
    tensor-core body against its plain version: whisper's encoder (MHA,
    hd 64, 1500 x 1500 frames, no causal mask) and its cross-attention
    (224 prompt rows against the 1500 frames, no mask), library SDPA with
    ``is_causal=False``; internvl2's prefill (GQA group 8, hd 128, causal,
    S 2048 and 2560), library SDPA with ``is_causal`` and
    ``enable_gqa``."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, kv, hd = (FLASH_WHISPER[x] for x in ("b", "h", "kv", "hd"))
    entries = []
    for sq, what in ((WHISPER_FRAMES, "encoder"),
                     (WHISPER_PROMPT[1], "cross-attention")):
        q, k, v = model_layout(torch, gen, b, sq, WHISPER_FRAMES, h, kv, hd,
                               torch.bfloat16)
        if flash.body(q, k, v) != "tensor_core":
            fail(f"flash_attention {WHISPER_ARCH} {what}: not the tensor "
                 f"cores")
        entries.append(flash_entry(
            torch, ops, q, k, v, 0,
            f"B={b} H={h} KV={kv} hd={hd} Sq={sq} Skv={WHISPER_FRAMES} bf16 "
            f"non-causal ({WHISPER_ARCH} {what})",
            lambda: sdpa(q, k, v, is_causal=False), reps=200, causal=False))
        del q, k, v
    b, h, kv, hd = (FLASH_VLM[x] for x in ("b", "h", "kv", "hd"))
    for s in FLASH_VLM_SEQS:
        q, k, v = model_layout(torch, gen, b, s, s, h, kv, hd,
                               torch.bfloat16)
        if flash.body(q, k, v) != "tensor_core":
            fail(f"flash_attention {VLM_ARCH} S={s}: not the tensor cores")
        entries.append(flash_entry(
            torch, ops, q, k, v, 0,
            f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal ({VLM_ARCH})",
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            reps=50))
        del q, k, v
    release(torch)
    return entries


def whisper_batch(torch, cfg, rows: int, seq: int, gen, device) -> dict:
    """Seeded whisper inputs: ``rows`` prompts of ``seq`` tokens and their
    frames (``cfg.encoder_seq`` of them, N(0, 1), in the model's dtype),
    drawn with ``gen`` on its device and moved to ``device``."""
    dev = gen.device
    return {"tokens": torch.randint(0, cfg.vocab_size, (rows, seq),
                                    generator=gen, device=dev).to(device),
            "enc_embeds": torch.randn(
                (rows, cfg.encoder_seq, cfg.d_model), generator=gen,
                device=dev).to(device=device, dtype=cfg.torch_dtype)}


def encdec_reference_check(torch, rt) -> None:
    """Smoke-size fp32, card (kernels) vs CPU (plain versions): whisper's
    prefill (logits, the decoder's K and V caches, ``enc_kv``) of 2 rows
    of 40 tokens with their frames and 8 free cache rows, then
    WHISPER_DECODE greedy decode steps, each within SERVE_TOL of its
    largest value, one flash launch a layer and an encoder layer, and
    the cross-attention's, on the card (6); a 3-epoch exact session on
    batches that carry ``enc_embeds`` (losses and the 27 duals within
    SESSION_TOL); internvl2's slot engine on embeddings prompts (greedy
    tokens equal)."""
    cfg = dataclasses.replace(rt.configs.smoke_config(WHISPER_ARCH),
                              dtype="float32")
    params = rt.models.init_params(cfg, torch.Generator().manual_seed(0))
    batch = whisper_batch(torch, cfg, 2, 40, torch.Generator().manual_seed(1),
                          "cpu")
    src = rt.data.SyntheticSource(cfg.vocab_size, 16, N_WORKERS, 2,
                                  device="cpu")
    fgen = torch.Generator().manual_seed(2)
    frames = [torch.randn((N_WORKERS * 2, cfg.encoder_seq, cfg.d_model),
                          generator=fgen) for _ in range(EPOCHS)]
    out, duals = {}, {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device) for k, v in params.items()}
        rt.kernels.router.reset_launches()
        logits, st = rt.models.prefill(
            p, cfg, {k: v.to(device) for k, v in batch.items()},
            extra_capacity=8)
        n = rt.kernels.router.launches().get("flash_attention", 0)
        want = cfg.encoder_layers + 2 * cfg.num_layers
        if n != (want if device == "cuda" else 0):
            fail(f"reference {WHISPER_ARCH} on {device}: {n} flash launches")
        # copies: decode updates the caches in place, and on the CPU
        # .cpu() would return the tensor itself
        seq = [t.to("cpu", copy=True) for t in [logits] + (
            rt.models.model._cache_tensors((st.caches, st.enc_kv)))]
        tok = logits.argmax(-1)
        for _ in range(WHISPER_DECODE):
            logits, st = rt.models.decode_step(p, cfg, st, tok)
            seq.append(logits.to("cpu", copy=True))
            tok = logits.argmax(-1)
        seq += [t.to("cpu", copy=True) for t in (st.caches.k, st.caches.v)]
        out[device] = seq
        s = rt.api.AMBSession(
            rt.api.TrainSpec(arch=WHISPER_ARCH, smoke=True, data=N_WORKERS,
                             batch_per_worker=2, seq_len=16),
            rt.api.ClockSpec(kind="simulated"),
            rt.api.ConsensusSpec(consensus="exact"), cfg=cfg,
            params={k: v.clone() for k, v in p.items()}, device=device)
        losses = [s.step({k: v.to(device) for k, v in (
            src.batch(e) | {"enc_embeds": frames[e]}).items()},
            [2, 1, 0, 2])["loss"] for e in range(EPOCHS)]
        duals[device] = (losses, {k: v.cpu() for k, v in
                                  s.state["opt"]["z"].items()})
    errs = [max_abs_err(torch, a, b) / max(float(a.abs().max()), 1e-30)
            for a, b in zip(out["cpu"], out["cuda"])]
    err = max(errs)
    (l_cpu, z_cpu), (l_gpu, z_gpu) = duals["cpu"], duals["cuda"]
    z_err = max(max_abs_err(torch, z_cpu[k], z_gpu[k])
                / max(float(z_cpu[k].abs().max()), 1e-30) for k in z_cpu)
    l_err = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    print(f"reference {WHISPER_ARCH}: prefill logits, K and V caches, "
          f"enc_kv, {WHISPER_DECODE} decode steps card vs CPU worst rel "
          f"err {err:.3g} (each: {', '.join(f'{e:.2g}' for e in errs)}); "
          f"exact session {EPOCHS} epochs losses {l_gpu} vs {l_cpu}, "
          f"{len(z_cpu)} duals worst rel err {z_err:.3g}", flush=True)
    if not (err <= SERVE_TOL and z_err <= SESSION_TOL
            and l_err <= SESSION_TOL):
        fail(f"reference {WHISPER_ARCH}: rel err {err} (serving), {z_err} "
             f"(duals), {l_err} (losses)")
    if len(z_cpu) != WHISPER_LEAVES:
        fail(f"reference {WHISPER_ARCH}: {len(z_cpu)} duals")
    cfg = dataclasses.replace(rt.configs.smoke_config(VLM_ARCH),
                              dtype="float32")
    params = rt.models.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device) for k, v in params.items()}
        engine = rt.serve.SlotEngine(p, cfg, slots=2, cache_len=64)
        reqs = rt.serve.synthetic_requests(
            5, vocab_size=cfg.vocab_size, prompt_len=24, prompt_jitter=8,
            max_new_tokens=8, seed=3)
        rt.kernels.router.reset_launches()
        drain(engine, reqs)
        n = rt.kernels.router.launches().get("flash_attention", 0)
        if n != (cfg.num_layers * len(reqs) if device == "cuda" else 0):
            fail(f"reference {VLM_ARCH} on {device}: {n} flash launches")
        tokens[device] = [r.out_tokens for r in reqs]
    print(f"reference {VLM_ARCH}: slot-engine tokens on embeddings prompts "
          f"equal card vs CPU: {tokens['cpu'] == tokens['cuda']}", flush=True)
    if tokens["cpu"] != tokens["cuda"]:
        fail(f"reference {VLM_ARCH}: greedy tokens differ: card "
             f"{tokens['cuda']} vs CPU {tokens['cpu']}")


def run_whisper_serve(torch, rt) -> dict:
    """whisper-base at full width (6 + 6 layers), bf16, through the
    model-level serving functions (the slot engine refuses audio, as
    JAX's does): SERVE_REQUESTS requests, each its own seeded 1500 frames
    and a prompt of WHISPER_PROMPT tokens, in two waves of WHISPER_SLOTS;
    each request prefilled alone (batch 1, its own length, the rest of
    the cache as ``extra_capacity``) and inserted into a slot row, then
    WHISPER_NEW - 1 greedy decode rounds at per-slot positions, and every
    row evicted between the waves (its caches and ``enc_kv`` zero).
    Requires 18 tensor-core flash launches a request (6 encoder, 6 self,
    6 cross), finite logits and no token id at or past the vocabulary;
    prints the prefill's and the decode round's medians, tokens/s and the
    peak; returns the launch counts."""
    cfg = rt.configs.get_config(WHISPER_ARCH)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    params, _ = init_on_card(torch, rt, cfg)
    p = rt.models.param_count(params)
    if (len(params), p) != (WHISPER_LEAVES, WHISPER_P):
        fail(f"{WHISPER_ARCH}: {len(params)} leaves, P={p}; expected "
             f"{WHISPER_LEAVES}, {WHISPER_P}")
    models = rt.models
    cache_len = WHISPER_PROMPT[1] + WHISPER_NEW
    gen = torch.Generator(device="cuda").manual_seed(4)
    lens = torch.randint(WHISPER_PROMPT[0], WHISPER_PROMPT[1] + 1,
                         (SERVE_REQUESTS,),
                         generator=torch.Generator().manual_seed(5)).tolist()
    lens[0], lens[-1] = WHISPER_PROMPT      # both ends of the range
    state = models.init_decode_state(cfg, WHISPER_SLOTS, cache_len,
                                     per_slot_pos=True, device="cuda")
    prefill_s, round_s, outs = [], [], []
    bad = torch.zeros((), dtype=torch.long, device="cuda")
    rt.kernels.router.reset_launches()
    t0 = time.perf_counter()
    for wave in range(SERVE_REQUESTS // WHISPER_SLOTS):
        last = torch.zeros((WHISPER_SLOTS,), dtype=torch.long, device="cuda")
        for slot in range(WHISPER_SLOTS):
            plen = lens[wave * WHISPER_SLOTS + slot]
            batch = whisper_batch(torch, cfg, 1, plen, gen, "cuda")
            t = time.perf_counter()
            logits, one = models.prefill(params, cfg, batch,
                                         extra_capacity=cache_len - plen)
            models.insert_decode_state(state, one, slot)
            last[slot] = logits.argmax(-1)[0]
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
            bad += (~torch.isfinite(logits)).sum()
            del one, logits
        toks = [last]
        for _ in range(WHISPER_NEW - 1):
            t = time.perf_counter()
            logits, state = models.decode_step(params, cfg, state, toks[-1])
            toks.append(logits.argmax(-1))
            bad += (~torch.isfinite(logits)).sum()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t)
        outs.append(torch.stack(toks, 1))
        for slot in range(WHISPER_SLOTS):
            models.evict_decode_state(state, slot)
        left = [t for t in models.model._cache_tensors(
            (state.caches, state.enc_kv)) if t.any()]
        if left or state.pos.any():
            fail(f"serve {WHISPER_ARCH}: the evicted slots are not zero")
    wall = time.perf_counter() - t0
    launches = rt.kernels.router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    outs = torch.cat(outs)
    ntok = outs.numel()
    prefill_s.sort()
    round_s.sort()
    print(f"serve {WHISPER_ARCH}: layers={cfg.num_layers}+"
          f"{cfg.encoder_layers} bf16 slots={WHISPER_SLOTS} requests="
          f"{SERVE_REQUESTS} frames={cfg.encoder_seq} prompts "
          f"{min(lens)}..{max(lens)} new={WHISPER_NEW} rounds={len(round_s)} "
          f"wall_s={wall:.2f} tokens_per_s={ntok / wall:.1f} "
          f"peak_GiB={peak:.2f}", flush=True)
    print(f"  prefill (batch 1, encoder + decoder, insert): median_s="
          f"{prefill_s[len(prefill_s) // 2]:.4f} min_s={prefill_s[0]:.4f} "
          f"max_s={prefill_s[-1]:.4f}; decode round of {WHISPER_SLOTS}: "
          f"median_ms={round_s[len(round_s) // 2] * 1e3:.2f} min_ms="
          f"{round_s[0] * 1e3:.2f} max_ms={round_s[-1] * 1e3:.2f}",
          flush=True)
    print(f"  launches: {launches}", flush=True)
    if int(bad):
        fail(f"serve {WHISPER_ARCH}: {int(bad)} non-finite logits")
    if int(outs.max()) >= cfg.vocab_size or int(outs.min()) < 0:
        fail(f"serve {WHISPER_ARCH}: token ids {int(outs.min())}.."
             f"{int(outs.max())} outside the vocabulary of "
             f"{cfg.vocab_size}")
    want = (cfg.encoder_layers + 2 * cfg.num_layers) * SERVE_REQUESTS
    expect(f"serve {WHISPER_ARCH}", launches, {
        "flash_attention": want, "flash_attention.tensor_core": want,
        "flash_attention.cuda_core": 0, "dual_update": 0})
    del params, state, outs
    release(torch)
    return launches


def run_whisper_session(torch, rt) -> dict:
    """AMBSession exact on whisper-base at full width (6 + 6 layers),
    bf16, N_WORKERS x PER_WORKER x SEQ tokens, each sequence with its own
    seeded 1500 frames, EPOCHS epochs: the loss finite (the first near
    ln(vocab)), every dual and parameter finite after each epoch, one
    prox launch a leaf an epoch (27), no flash launch (training runs the
    plain masked softmax); step ms and the peak each epoch.  Returns the
    launch counts."""
    cfg = rt.configs.get_config(WHISPER_ARCH)
    release(torch)
    session = session_for(rt, cfg, consensus="exact")
    leaves, p = len(session.params), rt.models.param_count(session.params)
    print(f"session exact {cfg.name}: layers={cfg.num_layers}+"
          f"{cfg.encoder_layers} P={p} leaves={leaves} workers={N_WORKERS} "
          f"batch/worker={PER_WORKER} seq={SEQ} frames={cfg.encoder_seq}",
          flush=True)
    if (leaves, p) != (WHISPER_LEAVES, WHISPER_P):
        fail(f"whisper session: {leaves} leaves, P={p}")
    source = rt.data.SyntheticSource(cfg.vocab_size, SEQ, N_WORKERS,
                                     PER_WORKER, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    rt.kernels.router.reset_launches()
    for epoch in range(EPOCHS):
        batch = source.batch(epoch)
        batch["enc_embeds"] = torch.randn(
            (N_WORKERS * PER_WORKER, cfg.encoder_seq, cfg.d_model),
            generator=gen, device="cuda", dtype=cfg.torch_dtype)
        torch.cuda.reset_peak_memory_stats()
        m = session.step(batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  epoch {epoch}: loss={m['loss']:.6f} b={m['b'].tolist()} "
              f"step_ms={m['step_s'] * 1e3:.1f} peak_GiB={peak:.2f}",
              flush=True)
        if not math.isfinite(m["loss"]):
            fail(f"whisper session epoch {epoch}: loss {m['loss']}")
        if epoch == 0 and abs(m["loss"] - math.log(cfg.vocab_size)) > 3:
            fail(f"whisper session: first loss {m['loss']} is far from "
                 f"ln(vocab)")
        all_finite(torch, session.state["opt"]["z"], "whisper dual")
        all_finite(torch, session.params, "whisper parameter")
        del batch
    launches = rt.kernels.router.launches()
    print(f"  launches: {launches}", flush=True)
    expect("whisper session", launches, {"dual_update": leaves * EPOCHS,
                                         "flash_attention": 0})
    del session, source
    release(torch)
    return launches


# ---------------------------------------------------------------------------
# One process per worker (phase 14): torch.distributed ranks on the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4                 # gloo ranks sharing the one card
MESH_EXACT_LAYERS = 8          # depth cuts: the four ranks' peaks must sum
MESH_GOSSIP_LAYERS = 4         # under MESH_PEAK_SUM_GIB (the two embedding
MESH_PEAK_SUM_GIB = 70.0       # tables, 467 M parameters, dominate)
MESH_EPOCHS = 2
MESH_TIMEOUT_S = {"nccl1": 300, "gloo4": 480, "cli": 240}
MESH_PG_TIMEOUT_S = 300        # a collective waiting longer fails its rank
# exact over four ranks: each rank's bf16 gradient is rounded before the
# fp32 sum across ranks and rounded again after it (five roundings of
# 2^-9 against one backward's one), and a sum that cancels magnifies them
# against its result; the biases start at 0, so a bias leaf is its update
# alone (blocks.attn.bk read 0.0097 of its largest value in a first run):
# 2^-5 of each leaf's largest magnitude; the losses move by the rounding
# of the bf16 logits of 8 rows against 32
MESH_PARAM_TOL = 2.0 ** -5
MESH_LOSS_TOL = 1e-3
MESH_CLI_ARGV = ["--smoke", "--sim-clock", "--consensus", "gossip",
                 "--graph", "torus", "--steps", str(MESH_EPOCHS)]


def check_gossip_combine_rank(torch, ops, ref, GossipConsensus, own_row,
                              d_full: int):
    """The per-rank round: the K rows a worker receives, in tap order,
    through a (K, 1) table into one row, against the stacked round's row
    of that worker, kernel and plain version, bit for bit (ring, n = 4,
    at the D of the MESH_GOSSIP_LAYERS-layer message); timed."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    strat = GossipConsensus(N_WORKERS, GOSSIP_ROUNDS, "ring")
    src, w = strat.source_rows("cuda"), strat.taps.weights
    k = strat.taps.k
    table = own_row(k, "cuda")
    timing = None
    for d in (129, d_full):
        m = torch.randn((N_WORKERS, d), generator=gen, device="cuda")
        stacked = ops.gossip_combine(m, src, w, force="kernel")
        buf = torch.empty((k, d), device="cuda")
        out = torch.empty((1, d), device="cuda")
        for r in range(N_WORKERS):
            buf[0] = m[r]
            for tap, s, _ in strat.rank_plan(r):
                buf[tap] = m[s]
            ops.gossip_combine(buf, table, w, out=out, force="kernel")
            torch.cuda.synchronize()
            if not torch.equal(out[0], stacked[r]):
                fail(f"gossip_combine per-rank row {r} D={d} differs from "
                     f"the stacked round's")
            err = max_abs_err(torch, out, ops.gossip_combine(
                buf, table, w, force="ref"))
            if err:
                fail(f"gossip_combine per-rank row {r} D={d}: kernel vs "
                     f"plain {err}")
        del stacked, m
        line = (f"gossip_combine per-rank K={k} rows -> 1 D={d}: bit for "
                f"bit the stacked round's row (4 workers) and the plain "
                f"version's")
        if d == d_full:
            wt = torch.tensor(w, device="cuda").view(1, k)
            k_ms, l_ms = time_pair(
                torch, lambda: ops.gossip_combine(buf, table, w, out=out,
                                                  force="kernel"),
                lambda: torch.mm(wt, buf), 10, "gossip_combine per-rank")
            p_ms = time_ms(torch, lambda: ops.gossip_combine(
                buf, table, w, force="ref"), 3, "gossip_combine per-rank "
                "plain")
            b_ms, b_by = bound(4 * (k + 1) * d, 2 * k * d)
            timing = dict(shape=f"K={k} received rows -> 1, D={d}",
                          ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                          bound_ms=b_ms, bound_by=b_by)
            line += (f" ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms="
                     f"{l_ms:.4f} (torch.mm of the (1, K) weights) "
                     f"bound_ms={b_ms:.4f} ({b_by})")
        print(line, flush=True)
        del buf, out
        release(torch)
    return timing


def mesh_session(rt, cfg, consensus: str, mesh, data: int = N_WORKERS,
                 pod: int = 1):
    """A session of the mesh phases: TrainSpec's defaults, the simulated
    clock, ring gossip at GOSSIP_ROUNDS, on the card; ``mesh`` None is
    every worker in one process."""
    return rt.api.AMBSession(
        rt.api.TrainSpec(data=data, pod=pod, batch_per_worker=PER_WORKER,
                         seq_len=SEQ),
        rt.api.ClockSpec(kind="simulated"),
        rt.api.ConsensusSpec(consensus=consensus, graph="ring",
                             gossip_rounds=GOSSIP_ROUNDS),
        cfg=cfg, device="cuda", mesh=mesh)


def as_json(x):
    """``x`` as it reads back from JSON (tuples become lists), to compare
    a digest with one another process wrote."""
    return json.loads(json.dumps(x))


def batch_digests(torch, session, n: int, epochs: int) -> list:
    """Per epoch, per worker: the digest of that worker's rows of the
    session's own batch (the whole batch in one process; the rank's shard
    over a group)."""
    source = session.batch_source()
    out = []
    for epoch in range(epochs):
        batch = source.batch(epoch)
        per = batch[min(batch)].shape[0] // n
        out.append([digest(torch, {k: v[i * per:(i + 1) * per]
                                   for k, v in batch.items()})
                    for i in range(n)])
    return out


def mesh_epochs(torch, rt, session, label: str) -> dict:
    """MESH_EPOCHS epochs through ``run`` (the session's own source, no
    prefetcher); per epoch the loss, b, the host seconds from a sync to a
    sync, the peak; the launch counts of exactly these epochs."""
    rt.kernels.router.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for epoch in range(MESH_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = session.run(1, prefetch=0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        if not math.isfinite(m["loss"]):
            fail(f"{label} epoch {epoch}: loss {m['loss']}")
    return {"losses": losses, "epoch_s": secs,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": rt.kernels.router.launches()}


def mesh_references(torch, rt, full, work: Path) -> dict:
    """The one-process sessions the ranks are held against, run before
    any rank starts: exact at MESH_EXACT_LAYERS (losses; the parameters
    saved leaf by leaf for rank 0) and ring gossip at MESH_GOSSIP_LAYERS
    (losses, each worker's dual row's digest, each worker's batch rows'
    digests), MESH_EPOCHS epochs each, under deterministic algorithms."""
    refs = {}
    with deterministic(torch):
        cfg = dataclasses.replace(full, num_layers=MESH_EXACT_LAYERS)
        session = mesh_session(rt, cfg, "exact", None)
        res = mesh_epochs(torch, rt, session, "exact reference")
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "exact_params.pt")
        refs["exact"] = {"losses": res["losses"]}
        print(f"mesh reference exact ({MESH_EXACT_LAYERS} layers, one "
              f"process, {N_WORKERS} workers): losses {res['losses']} "
              f"epoch_s {[round(x, 4) for x in res['epoch_s']]} peak_GiB "
              f"{res['peak_gib']:.2f} [{card_line()}]", flush=True)
        del session
        release(torch)
        cfg = dataclasses.replace(full, num_layers=MESH_GOSSIP_LAYERS)
        session = mesh_session(rt, cfg, "gossip", None)
        refs["gossip_batches"] = batch_digests(torch, session, N_WORKERS,
                                               MESH_EPOCHS)
        res = mesh_epochs(torch, rt, session, "gossip reference")
        z = session.state["z"]
        refs["gossip"] = {"losses": res["losses"], "rows": [
            digest(torch, {k: v[r] for k, v in z.items()})
            for r in range(N_WORKERS)]}
        print(f"mesh reference gossip ({MESH_GOSSIP_LAYERS} layers, one "
              f"process, {N_WORKERS} workers): losses {res['losses']} "
              f"epoch_s {[round(x, 4) for x in res['epoch_s']]} peak_GiB "
              f"{res['peak_gib']:.2f} [{card_line()}]", flush=True)
        del session, z
    release(torch)
    (work / "reference.json").write_text(json.dumps(refs))
    return refs


def launch_ranks(phase: str, work: Path, n: int, extra_env=None) -> None:
    """``python -m torch.distributed.run --standalone --nproc-per-node n
    chip_smoke.py --rank-phase phase --work work`` in its own process
    group, killed whole past MESH_TIMEOUT_S[phase]; a rank that fails or
    runs out of time fails the run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
           "--rank-phase", phase, "--work", str(work)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               **(extra_env or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                            start_new_session=True)
    try:
        code = proc.wait(timeout=MESH_TIMEOUT_S[phase])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        fail(f"rank phase {phase}: still running after "
             f"{MESH_TIMEOUT_S[phase]} s; killed")
    if code:
        fail(f"rank phase {phase}: exit code {code}")
    print(f"rank phase {phase}: {n} ranks done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def rank_report(label: str, rank: int, res: dict, group, rounds: int):
    per_round = (f"sent_bytes_per_round={group.sent_bytes // rounds} "
                 f"staged_bytes_per_round={group.staged_bytes // rounds}"
                 if rounds else f"sent_bytes={group.sent_bytes} "
                 f"staged_bytes={group.staged_bytes}")
    print(f"  rank {rank} {label}: peak_GiB={res['peak_gib']:.2f} epoch_s="
          f"{[round(x, 4) for x in res['epoch_s']]} {per_round} "
          f"launches={res['launches']} losses={res['losses']} "
          f"[{card_line()}]", flush=True)


def rank_nccl1(torch, rt, dist, work: Path) -> None:
    """One NCCL rank: make_host_mesh(1, 1) and an exact session at full
    width through the process-group path, against the one-process data=1
    session, parameters bit for bit, under deterministic algorithms."""
    full = rt.configs.get_config("qwen2-1.5b")
    mesh = rt.launch.mesh.make_host_mesh(1, 1, device="cuda")
    out = {}
    with deterministic(torch):
        for label, m in (("mesh", mesh), ("one process", None)):
            session = mesh_session(rt, full, "exact", m, data=1)
            if (session.group is None) != (m is None):
                fail(f"nccl1 {label}: the session's group is "
                     f"{session.group}")
            res = mesh_epochs(torch, rt, session, f"nccl1 {label}")
            res["digest"] = digest(torch, session.params)
            out[label] = res
            print(f"  rank 0 nccl1 {label} (28 layers, data=1): losses "
                  f"{res['losses']} epoch_s "
                  f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
                  f"{res['peak_gib']:.2f} launches {res['launches']} "
                  f"[{card_line()}]", flush=True)
            del session
            release(torch)
    if out["mesh"]["digest"] != out["one process"]["digest"] \
            or out["mesh"]["losses"] != out["one process"]["losses"]:
        fail("nccl1: the one-rank process-group session's parameters or "
             "losses differ from the one-process session's")
    print("  nccl1: parameters and losses bit for bit the one-process "
          "session's", flush=True)
    (work / "nccl1.json").write_text(json.dumps(
        {k: {"launches": v["launches"], "peak_gib": v["peak_gib"],
             "epoch_s": v["epoch_s"]} for k, v in out.items()}))


def rank_gloo4(torch, rt, dist, work: Path) -> None:
    """Four gloo ranks on the one card: exact (MESH_EXACT_LAYERS) and
    ring gossip (MESH_GOSSIP_LAYERS), MESH_EPOCHS epochs each, under
    deterministic algorithms, held against the parent's one-process
    references: gossip dual rows and batch rows by digest, bit for bit;
    exact losses and (rank 0) parameters within MESH_PARAM_TOL, every
    rank's parameters equal."""
    rank = dist.get_rank()
    refs = json.loads((work / "reference.json").read_text())
    full = rt.configs.get_config("qwen2-1.5b")
    mesh = rt.launch.mesh.make_host_mesh(MESH_RANKS, 1, device="cuda")
    out = {}
    with deterministic(torch):
        cfg = dataclasses.replace(full, num_layers=MESH_EXACT_LAYERS)
        session = mesh_session(rt, cfg, "exact", mesh)
        res = mesh_epochs(torch, rt, session, "gloo4 exact")
        rank_report("exact", rank, res, session.group, 0)
        expect(f"gloo4 exact rank {rank}", res["launches"],
               {"dual_update": 15 * MESH_EPOCHS})
        for got, want in zip(res["losses"], refs["exact"]["losses"]):
            if abs(got - want) > MESH_LOSS_TOL * abs(want):
                fail(f"gloo4 exact rank {rank}: loss {got} vs {want}")
        mine = digest(torch, session.params)
        every = [None] * MESH_RANKS
        dist.all_gather_object(every, mine)
        if any(d != every[0] for d in every):
            fail("gloo4 exact: the ranks' parameters differ")
        if rank == 0:
            want = torch.load(work / "exact_params.pt", mmap=True)
            errs = {}
            for k, p in session.params.items():
                ref_leaf = want[k].to("cuda")
                scale = float(ref_leaf.float().abs().max())
                errs[k] = max_abs_err(torch, p, ref_leaf) / max(scale, 1e-30)
            print(f"  gloo4 exact: each leaf's max |rank - one process| "
                  f"over its largest value: " + ", ".join(
                      f"{k} {e:.3g}" for k, e in errs.items()), flush=True)
            worst = max(errs, key=errs.get)
            if errs[worst] > MESH_PARAM_TOL:
                fail(f"gloo4 exact {worst}: {errs[worst]} of its largest "
                     f"value > {MESH_PARAM_TOL}")
            print(f"  gloo4 exact: parameters within {errs[worst]:.3g} "
                  f"({worst}) of the one-process session's (tol "
                  f"{MESH_PARAM_TOL}); losses within {MESH_LOSS_TOL} "
                  f"relative; all ranks equal", flush=True)
        out["exact"] = {k: res[k] for k in ("launches", "peak_gib",
                                            "epoch_s", "losses")}
        out["exact"]["sent_bytes"] = session.group.sent_bytes
        del session
        release(torch)
        cfg = dataclasses.replace(full, num_layers=MESH_GOSSIP_LAYERS)
        session = mesh_session(rt, cfg, "gossip", mesh)
        batches = batch_digests(torch, session, 1, MESH_EPOCHS)
        for epoch, rows in enumerate(as_json(batches)):
            if rows[0] != refs["gossip_batches"][epoch][rank]:
                fail(f"gloo4 rank {rank} epoch {epoch}: its shard differs "
                     f"from its rows of the one-process batch")
        res = mesh_epochs(torch, rt, session, "gloo4 gossip")
        rounds = MESH_EPOCHS * GOSSIP_ROUNDS
        rank_report("gossip", rank, res, session.group, rounds)
        row = as_json(digest(torch, {k: v[0] for k, v in
                                     session.state["z"].items()}))
        if row != refs["gossip"]["rows"][rank]:
            fail(f"gloo4 gossip rank {rank}: its dual row differs from the "
                 f"one-process session's row {rank}")
        if res["losses"] != refs["gossip"]["losses"]:
            fail(f"gloo4 gossip rank {rank}: losses {res['losses']} vs "
                 f"{refs['gossip']['losses']}")
        expect(f"gloo4 gossip rank {rank}", res["launches"],
               {"gossip_combine": rounds, "dual_update": 15 * MESH_EPOCHS})
        print(f"  gloo4 gossip rank {rank}: dual row and shards bit for bit "
              f"the one-process session's row {rank}", flush=True)
        out["gossip"] = {k: res[k] for k in ("launches", "peak_gib",
                                             "epoch_s", "losses")}
        out["gossip"].update(sent_bytes=session.group.sent_bytes,
                             staged_bytes=session.group.staged_bytes,
                             rounds=rounds)
        del session
    release(torch)
    (work / f"gloo4_rank{rank}.json").write_text(json.dumps(out))


def rank_cli(torch, rt, dist, work: Path) -> None:
    """The train CLI's ``main`` under torchrun (it initialises nothing:
    torchrun's group is up), under deterministic algorithms."""
    with deterministic(torch):
        rt.launch.train.main(MESH_CLI_ARGV + [
            "--pod", "2", "--data", "2", "--dist-backend", "gloo",
            "--metrics", str(work / "cli_ranks.jsonl")])


RANK_PHASES = {"nccl1": rank_nccl1, "gloo4": rank_gloo4, "cli": rank_cli}


def rank_main(argv) -> int:
    """A rank of a mesh phase, started by ``launch_ranks`` under torchrun:
    ``--rank-phase NAME --work DIR``.  Loads the kernels the parent built;
    builds none."""
    phase, work = argv[argv.index("--rank-phase") + 1], \
        Path(argv[argv.index("--work") + 1])
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    import datetime

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch as rt
    import repro_torch.api
    import repro_torch.launch.mesh
    import repro_torch.launch.train
    torch.cuda.set_device(0)
    if phase == "cli":
        RANK_PHASES[phase](torch, rt, dist, work)
        return 0
    backend = "nccl" if phase == "nccl1" else "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=(
        datetime.timedelta(seconds=MESH_PG_TIMEOUT_S)))
    try:
        if dist.get_rank() == 0:
            print(f"rank phase {phase}: backend {backend}, world "
                  f"{dist.get_world_size()} [{card_line()}]", flush=True)
        RANK_PHASES[phase](torch, rt, dist, work)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_cli(torch, rt, work: Path) -> dict:
    """The train CLI under torchrun, gloo, four ranks (``--pod 2 --data
    2``, a (2, 2) torus) against the one-process CLI (``--data 4``: the
    most-square torus, (2, 2)), both under deterministic algorithms:
    losses equal."""
    with deterministic(torch):
        rt.launch.train.main(MESH_CLI_ARGV + [
            "--data", "4", "--metrics", str(work / "cli_one.jsonl")])
    release(torch)
    launch_ranks("cli", work, MESH_RANKS)
    one, ranks = ([json.loads(x)["loss"] for x in
                   (work / name).read_text().splitlines()]
                  for name in ("cli_one.jsonl", "cli_ranks.jsonl"))
    print(f"mesh train CLI (smoke, gossip, torus): one process {one}, four "
          f"ranks (pod 2 x data 2) {ranks}", flush=True)
    if len(one) != MESH_EPOCHS or ranks != one:
        fail(f"the train CLI over four ranks lost {ranks}, one process "
             f"{one}")
    return {"one": one, "ranks": ranks}


def run_mesh(torch, rt, full) -> dict:
    """Phase 14: the references, then the NCCL rank, the four gloo ranks,
    the CLI under torchrun and the dry-run; returns the ranks' launch
    counts and numbers."""
    release(torch)
    work = Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        mesh_references(torch, rt, full, work)
        release(torch)
        launch_ranks("nccl1", work, 1)
        launch_ranks("gloo4", work, MESH_RANKS)
        ranks = [json.loads((work / f"gloo4_rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
        nccl1 = json.loads((work / "nccl1.json").read_text())
        for kind, layers in (("exact", MESH_EXACT_LAYERS),
                             ("gossip", MESH_GOSSIP_LAYERS)):
            peaks = [r[kind]["peak_gib"] for r in ranks]
            print(f"gloo4 {kind} ({layers} layers): peaks GiB {peaks}, sum "
                  f"{sum(peaks):.2f} (limit {MESH_PEAK_SUM_GIB}) "
                  f"[{card_line()}]", flush=True)
            if sum(peaks) > MESH_PEAK_SUM_GIB:
                fail(f"gloo4 {kind}: the ranks' peaks sum to "
                     f"{sum(peaks):.2f} GiB")
        cli = run_mesh_cli(torch, rt, work)
        dry = run_mesh_dryrun(rt, full, work, max(
            r["exact"]["peak_gib"] for r in ranks))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 14 (one process per worker): {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    launches = {"nccl1 mesh": nccl1["mesh"]["launches"],
                "nccl1 one process": nccl1["one process"]["launches"]}
    for r, res in enumerate(ranks):
        launches[f"gloo4 exact rank {r}"] = res["exact"]["launches"]
        launches[f"gloo4 gossip rank {r}"] = res["gossip"]["launches"]
    return {"launches": launches, "ranks": ranks, "cli": cli, "dry": dry}


def run_mesh_dryrun(rt, full, work: Path, peak_gib: float) -> dict:
    """The dry-run on this machine (no JAX): qwen2-1.5b train_4k on the
    (16, 16) mesh, and the gloo exact phase's own configuration on a (4,
    1) mesh, whose per-rank argument bytes (a lower bound) must not pass
    the phase's measured per-rank peak."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract
    t0 = time.perf_counter()
    rec = dryrun.run_one("qwen2-1.5b", "train_4k", False, work / "dry")
    print(f"dryrun qwen2-1.5b train_4k 16x16: flops/rank "
          f"{rec['flops']:.4e} bytes/rank {rec['bytes']:.4e} (upper bound) "
          f"collective traffic {rec['collectives']['traffic_bytes']:.4e} B "
          f"args {rec['argument_size_in_bytes']} B; compute "
          f"{rec['compute_s_roofline']:.4f} s memory "
          f"{rec['memory_s_roofline']:.4f} s collective "
          f"{rec['collective_s_roofline']:.4f} s, dominant "
          f"{rec['dominant_term']}, useful {rec['useful_flops_frac']:.3f}; "
          f"counted in {rec['count_s']} s", flush=True)
    shape = rt.configs.InputShape("mesh_exact", SEQ, N_WORKERS * PER_WORKER,
                                  "train")
    own = dryrun.run_one(
        "qwen2-1.5b", "mesh_exact", False, work / "dry",
        cfg=dataclasses.replace(full, num_layers=MESH_EXACT_LAYERS),
        shape=shape, mesh=abstract((MESH_RANKS, 1), ("data", "model")))
    args_gib = own["argument_size_in_bytes"] / 2 ** 30
    print(f"dryrun gloo4 exact ({MESH_EXACT_LAYERS} layers, 4x1): "
          f"argument bytes per rank {own['argument_size_in_bytes']} "
          f"({args_gib:.2f} GiB) vs the measured per-rank peak "
          f"{peak_gib:.2f} GiB [{card_line()}]; {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    if args_gib > peak_gib:
        fail(f"dryrun: argument bytes {args_gib:.2f} GiB pass the measured "
             f"peak {peak_gib:.2f} GiB")
    return {"train_4k": {k: rec[k] for k in (
        "flops", "bytes", "dominant_term", "useful_flops_frac",
        "argument_size_in_bytes")}, "own_args_gib": args_gib,
        "peak_gib": peak_gib}


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
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.api
    import repro_torch.configs
    import repro_torch.control
    import repro_torch.faults
    import repro_torch.data
    import repro_torch.dist
    import repro_torch.models
    import repro_torch.serve
    from repro_torch.dist import consensus
    from repro_torch.dist.consensus import GossipConsensus
    from repro_torch.kernels import build, ops, ref, router
    import repro_torch.kernels.flash_attention
    import repro_torch.kernels.gossip_combine
    import repro_torch.kernels.rwkv6_scan
    import repro_torch.launch.mesh
    import repro_torch.launch.train
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
    flash_zoo = check_flash_zoo(torch, ops, router,
                                rt.kernels.flash_attention,
                                rt.models.attention)
    flash_zoo += check_flash_zamba(torch, ops, rt.kernels.flash_attention)
    flash_zoo += check_flash_whisper(torch, ops, rt.kernels.flash_attention)
    gcomb["per_rank"] = check_gossip_combine_rank(
        torch, ops, ref, GossipConsensus,
        rt.kernels.gossip_combine.own_row_table, dense_param_count(
            dataclasses.replace(full, num_layers=MESH_GOSSIP_LAYERS)) + 1)

    smoke = rt.configs.smoke_config("qwen2-1.5b")
    check_quantized_strategy(torch, rt, dense_param_count(smoke) + 1)
    reference_check(torch, rt)
    serve_reference_check(torch, rt, "qwen2-1.5b")
    serve_reference_check(torch, rt, "rwkv6-3b")
    zoo_reference_check(torch, rt)
    zamba_reference_check(torch, rt)
    encdec_reference_check(torch, rt)

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
    drivers = {"pipelined": run_pipelined(torch, rt, gossip_cfg),
               "async": run_async(torch, rt, quant_cfg),
               "elastic": run_elastic(torch, rt, gossip_cfg)}
    check_checkpoints(torch, rt, full, smoke)
    coded = {"coded exact": run_coded_exact(torch, rt, full),
             "churn": run_churn(torch, rt, gossip_cfg),
             "controller": run_controller_cli(torch, rt, gossip_cfg),
             "retune": run_staleness_retune(torch, rt, quant_cfg),
             "adaptive": run_adaptive(torch, rt)}
    check_restore_mid_churn(torch, rt, dataclasses.replace(
        full, num_layers=RESTORE_LAYERS))
    coded_launches = {k: r["launches"] for k, r in coded.items()}
    served = {"qwen2-1.5b": run_serve(torch, rt, SERVE_ARGV),
              "rwkv6-3b": run_serve(torch, rt, SERVE_RWKV_ARGV)}
    cli_launches = {k: r["launches"] for k, r in cli["runs"].items()}
    moe_cut = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                                  num_layers=MOE_LAYERS)
    zoo = {"serve qwen3-moe": run_engine_serve(
        torch, rt, rt.configs.get_config(MOE_ARCH), SERVE_REQUESTS,
        SERVE_NEW, 2.0, 1),
           "serve cli qwen3-moe": run_serve(torch, rt, MOE_SERVE_ARGV,
                                            cfg=moe_cut)}
    zoo["session qwen3-moe"], moe_du_err = run_moe_session(
        torch, rt, moe_cut, beta)
    du_err = max(du_err, moe_du_err)
    zoo["qwen3-8b long_500k"] = run_long_context(torch, rt)["launches"]
    zoo[f"serve cli {ZAMBA_ARCH}"] = run_serve(torch, rt, SERVE_ZAMBA_ARGV)
    zoo[f"session {ZAMBA_ARCH}"], zamba_du_err = run_zamba_session(
        torch, rt, beta)
    du_err = max(du_err, zamba_du_err)
    zoo[f"serve {WHISPER_ARCH}"] = run_whisper_serve(torch, rt)
    zoo[f"session {WHISPER_ARCH}"] = run_whisper_session(torch, rt)
    zoo[f"serve {VLM_ARCH} {VLM_LAYERS} layers"] = run_engine_serve(
        torch, rt, dataclasses.replace(rt.configs.get_config(VLM_ARCH),
                                       num_layers=VLM_LAYERS),
        VLM_REQUESTS, VLM_NEW, VLM_GAP_S, 2)
    mesh = run_mesh(torch, rt, full)

    def launches(name):
        return sum(c.get(name, 0) for group in (
            runs, served, sim["launches"], cli_launches, drivers,
            coded_launches, zoo, mesh["launches"]) for c in group.values())

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
                    launches_drivers={a: c.get(name, 0) for a, c in
                                      drivers.items()},
                    launches_faults_control={a: c.get(name, 0) for a, c in
                                             coded_launches.items()},
                    launches_zoo={a: c.get(name, 0) for a, c in
                                  zoo.items()},
                    launches_mesh={a: c.get(name, 0) for a, c in
                                   mesh["launches"].items()},
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
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "zoo_shapes": flash_zoo},
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
    raise SystemExit(rank_main(sys.argv) if "--rank-phase" in sys.argv
                     else main())
