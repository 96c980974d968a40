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
     async D = 2 session at the smoke config, and a pipelined session at
     full width cut to 2 layers, 19 GB on disk: saved after 2 epochs,
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
     just before each run and read just after.  The qwen2-1.5b run goes
     beside phases 17 and 18's gloo ranks (after phase 18's references),
     where the card has room and the parent would wait, so its serving
     numbers share the host with them;
 11. the rest of the zoo's dense branch at full width, bf16: qwen3-moe-30b-a3b
     served through the slot engine and scheduler with no session (24
     of 48 layers, 8 slots, 16 requests of 2048 +- 512 tokens at exact
     length, 32 new tokens, arrivals 2.0 s apart: TTFT, TPOT, the decode
     round's median, the peak; 24 tensor-core flash launches a request);
     the serve CLI on it cut to 4 layers with 2 fine-tune epochs; an exact
     AMBSession on it at 4 layers, 4 x 8 x 256, 3 epochs (loss and aux
     each epoch, 15 prox launches an epoch, the peak); qwen3-8b at
     long_500k (window 4096, 18 of 36 layers): a 32,768-token prefill, 64 ring
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
     w_in leaf); launch counts reset before each and read after.  The
     serve CLI goes beside phases 17 and 18's gloo ranks, after
     qwen2-1.5b's, so its numbers share the host with them;
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
     counts reset before each and read after.  Whisper goes beside phase
     14's gloo ranks (after phase 17's references), so its numbers share
     the host and the card with them;
 14. one process per worker (``torch.distributed``), ranks started by
     ``python -m torch.distributed.run --standalone`` on this script
     (``--rank-phase``), each under a time limit, after the parent has
     built every kernel and released its card memory; the ranks only load
     the built libraries.  First the one-process references (exact at 8
     layers, ring gossip r 5 at 4, qwen2-1.5b width, 4 x 8 x 256, 2
     epochs, simulated clock, deterministic algorithms); then one NCCL
     rank, in this process through a file store (``run_nccl1``):
     ``make_host_mesh(1, 1)`` and an exact session at 28 layers
     through the process-group path, parameters and losses bit for bit
     the one-process ``data=1`` session's; then four gloo ranks sharing
     the card (compute on the card, the gossip rows through pinned host
     buffers): exact (losses within MESH_LOSS_TOL, every rank's
     parameters equal, rank 0's within MESH_PARAM_TOL of the reference)
     and ring gossip (each rank's shard and dual row equal by digest to
     its row of the one-process session), each rank's peak, epoch
     seconds, bytes sent and staged a round, ``gossip_combine`` (r an
     epoch) and ``dual_update`` (15 an epoch) launches, the peaks' sum
     under MESH_PEAK_SUM_GIB; then, on the same ranks, the train CLI,
     gloo, ``--pod 2 --data 2 --graph torus`` at the smoke config, its
     losses equal to the one-process ``--data 4`` CLI's; then the dry-run
     (``repro_torch.launch.dryrun``) of qwen2-1.5b train_4k on (16, 16)
     and of the exact ranks' own configuration on (4, 1), whose per-rank
     argument bytes must not pass the ranks' measured peak.  The
     per-rank ``gossip_combine`` round (3 received rows into one) is held
     bit for bit against the stacked round's row in phase 3, and so are
     the per-rank ``stochastic_quantize`` (one (1, D) row) and
     ``quantized_combine`` (one row, the K level rows it holds, a (K, 1)
     table), each timed beside the stacked call at the D of phase 15;
 15. the drivers one process per worker: the parent runs, in one process
     on the card, the sessions the ranks will run (qwen2-1.5b width cut
     to DRIVER_LAYERS, 4 x 8 x 256, DRIVER_EPOCHS epochs and a flush,
     simulated clock, deterministic algorithms: gossip_q8 and gossip_q4
     on a ring at DRIVER_ROUNDS, pipelined, async D = 2, a controlled
     gossip session) and writes their digests, and a smoke-size pipelined
     session saves a checkpoint; then four gloo ranks on the card (the
     same ranks as phase 14's: phases 14, 15 and 16 take turns in one
     launch, ``--rank-phase gloo``, every parent step before the ranks
     first): rank 0 first runs the one-process twins
     held to a tolerance (coded exact, churn, the MoE exact step at
     qwen3-moe-30b-a3b width cut to DRIVER_MOE_LAYERS, under SGD) while
     the others wait; every rank's dual row bit for bit its one-process row, q8 and
     q4 ``sent_bytes`` exactly ``wire_bytes_per_round`` a round, one
     ``stochastic_quantize`` and one ``quantized_combine`` a round, the
     noise statistics within DRIVER_NOISE_RTOL and the controller's
     actions equal everywhere; churn (worker 1 out, then 2 survivors,
     then all back) bit for bit and the fp32 primal with worker 1 out
     within DRIVER_PRIMAL_TOL of the active mean (the all-worker mean
     told apart); coded exact and the MoE step within MESH_PARAM_TOL, aux
     within DRIVER_AUX_RTOL; the ranks save a checkpoint and restore the
     parent's, and after them one process restores theirs: the next epoch
     bit for bit both ways; each rank's peak, epoch seconds, bytes sent
     and staged, the peaks' sum under MESH_PEAK_SUM_GIB;
 16. a worker over a model axis: the one-process ``--data 2`` train CLI
     at the smoke config (exact, gossip and gossip_q8); then four gloo
     ranks as (data 2, model 2) (the launch's third turn): rank 0 first
     runs, while the others wait, the one-process data=2 references at
     qwen2-1.5b width
     cut to MODEL_LAYERS, 2 x 8 x 256, MESH_EPOCHS epochs (exact and ring
     gossip r 5, simulated clock, deterministic algorithms; kept in host
     memory), and both again with their row-parallel products (wo,
     w_down) summed in two halves, as the model ranks sum them: how far
     that moves each leaf sets its limit (``order_limits``); then every
     rank runs through AMBSession exact (FSDP x TP:
     the losses within MESH_LOSS_TOL, each gathered parameter leaf within
     its limit of the reference, the replicated leaves equal on
     every rank bit for bit, each rank's parameter blocks and fp32 z and
     w0 blocks equal to the dry-run's per-rank bytes) and ring gossip
     (TP: each worker's dual gathered over its model ranks, each leaf
     within its limit, the replicated leaves equal on a worker's model
     ranks), each rank's peak, epoch seconds, bytes sent and staged a
     round, bytes gathered and reduce-scattered an epoch, ``dual_update``
     (15 an epoch) and ``gossip_combine`` (r an epoch) launches; then
     quantized gossip (the consensus alone on a fixed stack, q8 and q4,
     and a gossip_q8 session, each rank's blocks bit for bit rank 1's
     one-process twin under ``tp_sums``); then every other driver and
     option at DRIVER_LAYERS in fp32 (``run_model_drivers``: pipelined
     gossip, async gossip_q8 at D = 2 with the controller, churn through
     a fault model, each rank's dual blocks bit for bit rank 1's
     one-process twin under ``tp_sums``, the wire exactly 4 d_block or
     ``wire_bytes_per_round(d_block)`` a round, the out worker's blocks
     unchanged, the noise statistics and actions equal on every rank;
     coded exact within its leaves' ``order_limits``); then the train CLI
     ``--data 2 --model 2`` (exact, gossip and gossip_q8) on the same
     ranks, its losses within MESH_LOSS_TOL of the one-process CLI's; the
     peaks beside phase 14's data=4 exact ranks'; and the prox and the
     quantized kernels timed at the ranks' blocks;
 17. serving over a (data, model) group and checkpoints at model > 1:
     while the gloo ranks run phases 14 to 16 the parent writes the
     references (``serve_references``: at qwen2-1.5b's full width, 28
     layers, bf16, 8 requests of 2048 +- 512 tokens and 32 new ones into
     8 slots, the plain one-process engine's greedy tokens and
     first-token logits, the prefills again under ``split_sums`` for each
     request's limit, and the ranks' one-process twin under
     ``rank_twin`` (each worker's rows a round alone); then the smoke-size
     one-process checkpoints, exact and async gossip at D 2); then, the
     launch's fourth turn (``rank_serve``): the slot engine alone over
     (data 2, model 2) through the scheduler (greedy tokens equal to the
     twin's, first-token logits within their limits, 28 tensor-core flash
     launches a request on its worker's ranks, per rank the prefill
     seconds, the decode round's ms and bytes summed over "model", TTFT,
     TPOT and the peak), the serve CLI with ``--finetune 2`` under exact and
     gossip (after each absorbed epoch the engine's blocks bit for bit
     the session's; the launches on the blocks), and the checkpoints (the
     one-process archive restored into the ranks, saved, read back bit for
     bit, one epoch on); after the launch (``serve_after``) the ranks'
     saves equal the one-process archives leaf for leaf, and one process
     restores them and holds the ranks' next epoch (async bit for bit
     under ``tp_sums``, exact within ``order_limits``).  The flash kernel
     at a model rank's prefill shape (H 6, KV 1) runs in phase 3;
 18. the MoE family over a model axis and more model ranks than KV heads:
     once the ranks have ended phase 16, the parent writes the references
     (``axis18_references``: qwen3-moe-30b-a3b at DRIVER_MOE_LAYERS, one
     exact epoch of the one-process data=2 session and its twin in the
     model ranks' summation order, ``tp_sums`` with ``moe_twin``, whose
     move sets each leaf's limit; the plain 8-slot engine at MOE18_LAYERS
     and its twin over (data 2, model 2), ``rank_twin``; qwen2-1.5b's
     8-slot engine at full depth, its twin over (data 1, model 4) and
     each KV head's caches' digest after the first decode round; one
     exact epoch of qwen2-1.5b at MODEL_LAYERS, plain and under
     ``tp_sums`` over its four model ranks, the KV heads' columns put
     together as the ranks gather them); then the launch's fifth turn
     (``rank_axis18``):
     qwen3-moe exact over (data 2, model 2) at full width (64 experts a
     rank, the bytes gathered and reduce-scattered over "data" and the
     blocks the dry-run's to the byte, 15 ``dual_update`` launches, the
     loss and aux against the twin's, each leaf within its limit), its
     engine (4 requests of 2048 +- 512 tokens into 8 slots, 16 new
     tokens, greedy: the tokens equal to the twin's, the differing count
     against the plain engine, 2 tensor-core flash launches a request at
     (B 1, H 16, KV 2, hd 128), the decode round's ms and bytes); then,
     over a second mesh on the same ranks, qwen2-1.5b at (data 1, model
     4), two ranks to a KV head: its engine at 28 layers on phase 17's 8
     requests (the twin's tokens, each rank's caches its head's of the
     twin by digest, 28 flash launches a request at (H 3, KV 1)) and one
     exact epoch at MODEL_LAYERS (the KV gather's backward; the loss
     and each leaf against the twin's, within its ``order_limits``).
     The flash kernel at both rank shapes runs in phase 3;
 19. the vlm and ssm families over a model axis: after the serve CLIs
     beside phases 17 and 18's ranks, the parent writes the references
     (``axis19_references``: rwkv6-3b at full width, the RWKV6 constants
     drawn (``ssm19_redraw``), through the plain 8-slot engine and its
     twin over (data 2, model 2), ``ssm_twin``: the tokens, each
     request's first token that differs, the twin's prefill and first
     round logits within SSM19_LOGIT_TOL of the plain engine's, and each
     rank's share of the states' digests; its exact
     epoch at SSM19_EXACT_LAYERS from ``ssm19_params``, plain and under
     ``tp_sums``, whose move sets each leaf's limit; its fp32 gossip
     epoch at SSM19_GOSSIP_LAYERS under ``tp_sums``: each rank's block's
     digest; internvl2-76b at VLM19_LAYERS through the 8-slot engine's
     twin on embeddings prompts); then the launch's sixth turn
     (``rank_axis19``): rwkv6-3b's engine over (data 2, model 2) at all
     32 layers (8 requests of 2048 +- 512 tokens into 8 slots, 32 new;
     the twin's tokens, the count that differ from the plain engine's,
     each rank's states its share of the twin's by digest, 32
     ``rwkv6_scan`` launches a request on its worker's ranks at (B 1, H
     20, hd 64), the decode round's ms, bytes and collectives), its exact
     epoch (20 heads a rank; the bytes over "data" and "model" exactly
     the dry-run's ``rank_fsdp_bytes`` and ``rank_model_bytes``, each
     leaf within its limit of the twin's), its fp32 gossip epoch (each
     rank's dual block bit for bit the twin's, ``wire_bytes_per_round
     (d_block)`` a round), and internvl2-76b's engine (the twin's tokens,
     VLM19_LAYERS flash launches a request at (H 32, KV 4)).  The scan at
     a rank's (H 20) and flash at internvl2's rank shape run in phase 3;
 20. the audio family over a model axis: after phase 19's references the
     parent writes phase 20's (``axis20_references``: whisper-base at
     full width, bf16, through the model-level serving functions, each
     worker's 4 requests alone, plain and as its model ranks compute it,
     ``audio_twin``: the twin's tokens, each rank's heads of ``enc_kv``
     and the caches by digest, the twin's logits within
     AUDIO20_LOGIT_TOL of the plain model's; one exact epoch at full
     depth, plain and under ``tp_sums``, whose move sets each leaf's
     limit, the plain session saved for the ranks to restore; one fp32
     gossip epoch at full depth under ``tp_sums``: each rank's block's
     digest); then the launch's seventh turn (``rank_axis20``): whisper
     over (data 2, model 2), 4 heads a rank: 8 requests of 4 to 224
     tokens and their 1500 frames, 4 a worker in 4 slot rows, 32 greedy
     tokens each through ``prefill(tp=)``, ``insert_decode_state``,
     ``decode_step(tp=)`` and ``evict_decode_state`` (the twin's tokens,
     the count that differ from the plain model's, ``enc_kv`` and the
     caches its heads of the twin's by digest, 18 tensor-core flash
     launches a request at (B 1, H 4, KV 4, hd 64), the decode round's
     ms, bytes and collectives), its exact epoch (the bytes over "data"
     and "model" exactly the dry-run's, the loss and each leaf against
     the twin's, the replicated leaves equal), its fp32 gossip epoch
     (each rank's dual block bit for bit the twin's,
     ``wire_bytes_per_round(d_block)`` a round) and a checkpoint at
     model 2 (the one-process archive restored, saved and read back bit
     for bit; after the launch the ranks' save is that archive, leaf for
     leaf).  Flash at whisper's rank shapes runs in phase 3;
 21. the hybrid family over a model axis: after phase 20's references
     (beside phase 20's ranks) the parent writes phase 21's
     (``axis21_references``: zamba2-1.2b at full width through the plain
     8-slot engine and its twin over (data 2, model 2), ``hybrid_twin``:
     the tokens, the twin's prefill and first-round logits within
     HYBRID21_LOGIT_TOL of the plain engine's, each rank's share of the
     Mamba2 states, conv tails and KV caches by digest; one exact epoch
     at HYBRID21_EXACT_LAYERS (two shared applications), plain and under
     ``tp_sums`` (its Mamba2 twin block), whose move sets each leaf's
     limit; one fp32 gossip epoch at HYBRID21_GOSSIP_LAYERS under
     ``tp_sums``: each rank's block's digest; an exact session at
     HYBRID21_CKPT_LAYERS saved for the ranks to restore); then the
     launch's eighth turn (``rank_axis21``): zamba2's engine over (data
     2, model 2) at all 38 layers, 32 Mamba2 heads and 16 attention heads
     a rank, JAX's packed ``w_in`` and ``conv_w`` blocks gathered and cut
     once (8 requests of 2048 +- 512 tokens into 8 slots, 32 new; the
     twin's tokens, the count that differ from the plain engine's, each
     rank's states and caches its share of the twin's by digest, 6
     tensor-core flash launches a request at (B 1, H 16, KV 16, hd 64),
     the decode round's ms, bytes and collectives), its exact epoch (the
     bytes over "data" and "model" exactly the dry-run's, 20
     ``dual_update`` launches, the loss and each leaf against the
     twin's), its fp32 gossip epoch (each rank's dual block bit for bit
     the twin's, ``wire_bytes_per_round(d_block)`` a round) and a
     checkpoint at model 2 (restored, saved and read back bit for bit;
     after the launch the ranks' save is the one-process archive, leaf
     for leaf).  Flash at zamba2's rank shape runs in phase 3;
 22. print the kernels' JSON line, the card line, and the final ok line.
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
import signal
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
# stay live through the backward), the exact checkpoint and the
# full-width pipelined one are cut to CKPT_LAYERS and CKPT_FULL_LAYERS: a
# chip call may write 45 GiB to its disk, deletions included, and the
# async session's checkpoint at QUANT_LAYERS is 57 GB.  They ran at 2 and
# 8 layers (the pipelined one 30.3 GB, about 100 s of save and restore)
# until phase 17 needed the time: H100 calls at 700 W read 1,195.4 and
# 1,203.7 s of the 1,200
MASK = (True, False, True, True)
STALENESS = 2
CKPT_LAYERS = 1
CKPT_FULL_LAYERS = 1
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
RESTORE_LAYERS = 1          # 2 until phase 17 needed the time
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
    err, entries = time_rwkv6(torch, ops, scan, RWKV_MAIN, "rwkv6-3b")
    entries[0].pop("max_abs_err")
    return max(worst, err), entries[0]


def time_rwkv6(torch, ops, scan, shape: dict, what: str) -> tuple:
    """The scan kernel at a prefill ``shape`` (B, H, hd) of ``what``, S in
    RWKV_SEQS, through the model's strided layout (r, k, v bf16, the decay
    fp32): y and the final state against the plain version, the segment
    plan, the kernel's, the plain version's and the bound's ms.  Returns
    (the worst error, an entry per S)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst, entries = 0.0, []
    b, h, hd = (shape[x] for x in ("b", "h", "hd"))
    for s in RWKV_SEQS:
        ins = rwkv_inputs(torch, gen, b, s, h, hd, torch.bfloat16, "model")
        got = ops.rwkv6_scan(*ins, force="kernel")
        torch.cuda.synchronize()
        want = ops.rwkv6_scan(*ins, force="ref")
        err = max(rel_err(torch, g, w) for g, w in zip(got, want))
        plan = scan.launch_plan(b, h, s, hd)
        line = (f"rwkv6_scan B={b} H={h} hd={hd} S={s} ({what}) r/k/v bf16 "
                f"decay fp32, model layout, L={plan['seg_chunks']} "
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
        entries.append(dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                            shape=f"B={b} H={h} hd={hd} S={s} ({what}), "
                                  f"r/k/v bf16, decay fp32, model layout"))
        worst = max(worst, err)
        del ins, got, want
    return worst, entries


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


def stamps(label: str, rank: int = 0):
    """``lap(what)``: on rank 0 (the parent has rank 0), a line saying
    when step ``what`` of a phase ended, in seconds since this call, so
    that a phase's time reads step by step."""
    t0 = time.perf_counter()

    def lap(what: str) -> None:
        if rank == 0:
            print(f"  {label}: {what} at {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return lap


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
    pipelined session at full width cut to CKPT_FULL_LAYERS.  That one has
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
              dataclasses.replace(full, num_layers=CKPT_FULL_LAYERS),
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
MOE_ENGINE_LAYERS = 24  # depth cut of the MoE slot engine run, 24 of 48
                        # (time: the command must end within 1,200 s)
MOE_SERVE_ARGV = ["--arch", MOE_ARCH] + SERVE_ARGV[2:]
MOE_SERVE_ARGV[MOE_SERVE_ARGV.index("--arrival-gap") + 1] = "1.0"
LONG_WINDOW = 4096      # repro_torch.configs.SWA_WINDOW, long_500k's
LONG_SEQ = 524288       # repro_torch.configs.SHAPES["long_500k"].seq_len
LONG_PREFIX = 32768     # eight windows
LONG_DECODE = 64        # ring decode steps held against a linear cache
LONG_TAIL = 16          # decode steps after the long_500k prompt
# qwen3-8b cut to 18 of its 36 layers for time since PR 28 (the command
# read 1,203.7 s of its 1,200 on a slow H100 call at 700 W)
LONG_LAYERS = 18
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

        def logged(p, x, cfg, *rest):
            probs = torch.softmax(torch.einsum(
                "bsd,de->bse", x.float(), p["router"]), dim=-1)
            idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
            self.calls.append(idx.sort(-1).values.cpu())
            return real(p, x, cfg, *rest)

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
    width cut to LONG_LAYERS, bf16, batch 1: a LONG_PREFIX-token prefill
    through the kernel (ring caches of 4096 rows), LONG_DECODE greedy
    decode steps on the ring held step by step against the same steps on
    a linear cache masked to the window (within LONG_NOISE x the gap
    between two linear caches that differ only in capacity), and each
    layer's attention in fp32 on the same keys in both layouts; then a
    prefill
    at the shape's own length (524,288 tokens: query chunks of
    ``PREFILL_ROWS`` rows) and LONG_TAIL decode steps past it.  Returns
    the launch counts of the two prefills and their decodes."""
    cfg = dataclasses.replace(
        rt.configs.get_config(LONG_ARCH, shape="long_500k"),
        num_layers=LONG_LAYERS)
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


def check_flash_whisper(torch, ops, flash, shape=FLASH_WHISPER,
                        where: str = "") -> list:
    """The flash kernel at the new models' prefill shapes, each on the
    tensor-core body against its plain version: whisper's encoder (MHA,
    hd 64, 1500 x 1500 frames, no causal mask) and its cross-attention
    (224 prompt rows against the 1500 frames, no mask), library SDPA with
    ``is_causal=False``; internvl2's prefill (GQA group 8, hd 128, causal,
    S 2048 and 2560), library SDPA with ``is_causal`` and
    ``enable_gqa``.  With ``shape`` (a model rank's heads, ``where``
    saying whose): whisper's two at that shape only."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, kv, hd = (shape[x] for x in ("b", "h", "kv", "hd"))
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
            f"non-causal ({WHISPER_ARCH} {what}{where})",
            lambda: sdpa(q, k, v, is_causal=False), reps=200, causal=False))
        del q, k, v
    if shape is not FLASH_WHISPER:
        release(torch)
        return entries
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
# depth cuts: the four ranks' peaks must sum under MESH_PEAK_SUM_GIB (the
# two embedding tables, 467 M parameters, dominate), and the command must
# end in 1,200 s: with phase 16's quantized gossip an H100 call at 700 W
# read 1,326.9 s with these at 8 and 4 layers (phase 14 252.9 s); with
# phase 17, 1,203.7 s at 4 and 2
MESH_EXACT_LAYERS = 2
MESH_GOSSIP_LAYERS = 1
MESH_PEAK_SUM_GIB = 70.0
MESH_EPOCHS = 2
# phases 14 to 18's gloo ranks run in one launch (``rank_gloo``, about 410
# s on an H100 call); the NCCL rank runs in the parent (``run_nccl1``)
MESH_TIMEOUT_S = {"gloo": 900}
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
                 pod: int = 1, model: int = 1,
                 rounds: int = GOSSIP_ROUNDS, params=None):
    """A session of the mesh phases: TrainSpec's defaults, the simulated
    clock, ring gossip at ``rounds`` (GOSSIP_ROUNDS), on the card;
    ``mesh`` None is every worker in one process; ``params`` (whole
    leaves) or the seed's."""
    return rt.api.AMBSession(
        rt.api.TrainSpec(data=data, pod=pod, model=model,
                         batch_per_worker=PER_WORKER, seq_len=SEQ),
        rt.api.ClockSpec(kind="simulated"),
        rt.api.ConsensusSpec(consensus=consensus, graph="ring",
                             gossip_rounds=rounds),
        cfg=cfg, device="cuda", mesh=mesh, params=params)


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


def mesh_epochs(torch, rt, session, label: str,
                epochs: int = MESH_EPOCHS) -> dict:
    """``epochs`` epochs through ``run`` (the session's own source, no
    prefetcher); per epoch the loss, b, the host seconds from a sync to a
    sync, the peak; the launch counts of exactly these epochs."""
    rt.kernels.router.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for epoch in range(epochs):
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
    lap = stamps("mesh references")
    with deterministic(torch):
        cfg = dataclasses.replace(full, num_layers=MESH_EXACT_LAYERS)
        session = mesh_session(rt, cfg, "exact", None)
        lap("the exact session built")
        res = mesh_epochs(torch, rt, session, "exact reference")
        lap("the exact epochs done")
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "exact_params.pt")
        refs["exact"] = {"losses": res["losses"]}
        print(f"mesh reference exact ({MESH_EXACT_LAYERS} layers, one "
              f"process, {N_WORKERS} workers): losses {res['losses']} "
              f"epoch_s {[round(x, 4) for x in res['epoch_s']]} peak_GiB "
              f"{res['peak_gib']:.2f} [{card_line()}]", flush=True)
        del session
        release(torch)
        lap("the exact parameters saved")
        cfg = dataclasses.replace(full, num_layers=MESH_GOSSIP_LAYERS)
        session = mesh_session(rt, cfg, "gossip", None)
        refs["gossip_batches"] = batch_digests(torch, session, N_WORKERS,
                                               MESH_EPOCHS)
        lap("the gossip session built, its batches digested")
        res = mesh_epochs(torch, rt, session, "gossip reference")
        lap("the gossip epochs done")
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


def start_ranks(phase: str, work: Path, n: int):
    """Start ``python -m torch.distributed.run --standalone
    --nproc-per-node n chip_smoke.py --rank-phase phase --work work`` in
    its own process group; returns (the process, its start time).  The
    ranks wait for ``work/ready<phase>`` (``parent_ready``) before each
    phase, so the parent's steps before them run while they come up, and
    the parent's references of a later phase while they run an earlier
    one."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
           "--rank-phase", phase, "--work", str(work)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CHIP_SMOKE_LAUNCHED_AT=repr(time.time()))
    return subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                            start_new_session=True), time.perf_counter()


def parent_ready(work: Path, phase: int) -> None:
    """Tell the started ranks that the parent's steps before their
    ``phase`` (the references they read) are done."""
    (work / f"ready{phase}").write_text("1")


def wait_parent(work: Path, rank: int, phase) -> None:
    """A rank: wait for the parent's ``parent_ready(work, phase)`` (at
    most MESH_TIMEOUT_S["gloo"]); rank 0 prints how long it waited.  The
    parent waits so for the ranks' ``done<phase>`` file (``phase`` its
    name)."""
    t0 = time.perf_counter()
    what = (f"the ranks' {phase}" if isinstance(phase, str)
            else f"the parent's steps before phase {phase}")
    name = phase if isinstance(phase, str) else f"ready{phase}"
    while not (work / name).exists():
        if time.perf_counter() - t0 > MESH_TIMEOUT_S["gloo"]:
            fail(f"{what}: never ended")
        time.sleep(0.1)
    if rank == 0:
        print(f"waited {time.perf_counter() - t0:.1f} s for {what}",
              flush=True)


def stop_ranks(phase: str, proc) -> None:
    """Stop a started launch (a parent step before its ranks failed):
    SIGTERM to the launcher's process group, on which the launcher stops
    its ranks (each runs in a session of its own, which a signal to the
    launcher's group does not reach), then SIGKILL to what is left of the
    group."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        print(f"rank phase {phase}: killed", flush=True)


def wait_ranks(phase: str, proc, t0: float, n: int) -> None:
    """Wait for a started launch, killed whole past MESH_TIMEOUT_S[phase];
    a rank that fails or runs out of time fails the run."""
    try:
        code = proc.wait(timeout=MESH_TIMEOUT_S[phase])
    except subprocess.TimeoutExpired:
        stop_ranks(phase, proc)
        fail(f"rank phase {phase}: still running after "
             f"{MESH_TIMEOUT_S[phase]} s; killed")
    if code:
        fail(f"rank phase {phase}: exit code {code}")
    print(f"rank phase {phase}: {n} ranks done in "
          f"{time.perf_counter() - t0:.1f} s of the launch", flush=True)


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
    lap = stamps("nccl1 rank 0")
    mesh = rt.launch.mesh.make_host_mesh(1, 1, device="cuda")
    out = {}
    with deterministic(torch):
        for label, m in (("mesh", mesh), ("one process", None)):
            session = mesh_session(rt, full, "exact", m, data=1)
            lap(f"the {label} session built")
            if (session.group is None) != (m is None):
                fail(f"nccl1 {label}: the session's group is "
                     f"{session.group}")
            res = mesh_epochs(torch, rt, session, f"nccl1 {label}")
            lap(f"the {label} epochs done")
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
    rank's parameters equal; then the train CLI's ``main`` (``--pod 2
    --data 2``), which the parent holds against its one-process CLI."""
    rank = dist.get_rank()
    lap = stamps("gloo4 rank 0", rank)
    refs = json.loads((work / "reference.json").read_text())
    full = rt.configs.get_config("qwen2-1.5b")
    mesh = rt.launch.mesh.make_host_mesh(MESH_RANKS, 1, device="cuda")
    out = {}
    with deterministic(torch):
        cfg = dataclasses.replace(full, num_layers=MESH_EXACT_LAYERS)
        session = mesh_session(rt, cfg, "exact", mesh)
        lap("the exact session built")
        res = mesh_epochs(torch, rt, session, "gloo4 exact")
        lap("the exact epochs done")
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
        lap("the exact checks done")
        cfg = dataclasses.replace(full, num_layers=MESH_GOSSIP_LAYERS)
        session = mesh_session(rt, cfg, "gossip", mesh)
        lap("the gossip session built")
        batches = batch_digests(torch, session, 1, MESH_EPOCHS)
        for epoch, rows in enumerate(as_json(batches)):
            if rows[0] != refs["gossip_batches"][epoch][rank]:
                fail(f"gloo4 rank {rank} epoch {epoch}: its shard differs "
                     f"from its rows of the one-process batch")
        res = mesh_epochs(torch, rt, session, "gloo4 gossip")
        lap("the gossip epochs done")
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
    lap("the gossip checks done")
    # the train CLI's main inside the same launch (it initialises nothing:
    # the ranks' group is up), as phase 16 runs its CLIs
    with deterministic(torch):
        rt.launch.train.main(MESH_CLI_ARGV + [
            "--pod", "2", "--data", "2", "--dist-backend", "gloo",
            "--metrics", str(work / "cli_ranks.jsonl")])
    release(torch)
    lap("the train CLI done")
    (work / f"gloo4_rank{rank}.json").write_text(json.dumps(out))


def run_nccl1(torch, rt, work: Path) -> None:
    """``rank_nccl1`` in this process, no launch: a one-rank NCCL group
    through a file store in ``work`` (a torchrun launch spends 15 to 20 s
    before its rank is up), destroyed after it."""
    import datetime

    import torch.distributed as dist
    dist.init_process_group(
        "nccl", init_method=f"file://{work / 'nccl1_store'}", rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT_S))
    try:
        rank_nccl1(torch, rt, dist, work)
    finally:
        dist.destroy_process_group()
    release(torch)


def rank_main(argv) -> int:
    """A rank of a mesh phase, started by ``start_ranks`` under torchrun:
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
    import repro_torch.launch.serve
    import repro_torch.launch.train
    import repro_torch.serve
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", timeout=(
        datetime.timedelta(seconds=MESH_PG_TIMEOUT_S)))
    try:
        if dist.get_rank() == 0:
            up = time.time() - float(os.environ.get(
                "CHIP_SMOKE_LAUNCHED_AT", time.time()))
            print(f"rank phase {phase}: backend gloo, world "
                  f"{dist.get_world_size()}, rank 0 up {up:.1f} s after the "
                  f"launch [{card_line()}]", flush=True)
        RANK_PHASES[phase](torch, rt, dist, work)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_cli_reference(torch, rt, work: Path) -> None:
    """The one-process train CLI (``--data 4``: the most-square torus, (2,
    2)) under deterministic algorithms, before the gloo ranks run theirs
    (``--pod 2 --data 2``, a (2, 2) torus) in their launch."""
    with deterministic(torch):
        rt.launch.train.main(MESH_CLI_ARGV + [
            "--data", "4", "--metrics", str(work / "cli_one.jsonl")])
    release(torch)


def check_mesh_cli(work: Path) -> dict:
    """The gloo ranks' train CLI against the one-process CLI: losses
    equal."""
    one, ranks = ([json.loads(x)["loss"] for x in
                   (work / name).read_text().splitlines()]
                  for name in ("cli_one.jsonl", "cli_ranks.jsonl"))
    print(f"mesh train CLI (smoke, gossip, torus): one process {one}, four "
          f"ranks (pod 2 x data 2) {ranks}", flush=True)
    if len(one) != MESH_EPOCHS or ranks != one:
        fail(f"the train CLI over four ranks lost {ranks}, one process "
             f"{one}")
    return {"one": one, "ranks": ranks}


def mesh_before(torch, rt, full, work: Path) -> None:
    """Phase 14 before the gloo ranks: the references (the one-process
    CLI's too), then the NCCL rank."""
    lap = stamps("phase 14")
    mesh_references(torch, rt, full, work)
    mesh_cli_reference(torch, rt, work)
    release(torch)
    lap("the references done")
    run_nccl1(torch, rt, work)
    lap("the NCCL rank done")


def mesh_after(rt, full, work: Path) -> dict:
    """Phase 14 after the gloo ranks: their peaks, the CLI's losses and
    the dry-run; returns the ranks' launch counts and numbers."""
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
    cli = check_mesh_cli(work)
    dry = run_mesh_dryrun(rt, full, work, max(
        r["exact"]["peak_gib"] for r in ranks))
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


# ---------------------------------------------------------------------------
# The drivers one process per worker (phase 15): every driver and option of
# AMBSession over four gloo ranks on the card
# ---------------------------------------------------------------------------

DRIVER_LAYERS = 1              # qwen2-1.5b depth cut: four ranks share the
                               # card (a q8 rank about 15 GiB at 1 layer)
DRIVER_MOE_LAYERS = 1          # qwen3-moe-30b-a3b depth cut of the MoE step
# the MoE step's optimizer: dual averaging's fp32 z and w0 (10 GB at 1
# layer) put a rank at 18.3 GiB, and four such ranks past the card
DRIVER_MOE_CASE = dict(consensus="exact", optimizer="sgd")
DRIVER_EPOCHS = 2
DRIVER_ROUNDS = {"exact": 1, "gossip": 1, "gossip_q8": 2, "gossip_q4": 2}
DRIVER_MASKS = ((True, False, True, True), (True, False, True, False))
DRIVER_CASES = {
    "q8": dict(consensus="gossip_q8"),
    "q4": dict(consensus="gossip_q4"),
    "pipelined": dict(consensus="gossip", pipeline=True),
    "async": dict(consensus="gossip", async_epochs=True, staleness=2),
    "controller": dict(consensus="gossip", controller=True),
}
DRIVER_NOISE_RTOL = 1e-5       # JAX's per-leaf form vs a one-pass fp64 M2
DRIVER_PRIMAL_TOL = 1e-6       # an all-reduce's sum order vs a tensordot
DRIVER_AUX_RTOL = 1e-5         # the ranks' shares summed vs one aux


def check_quantized_rank(torch, ops, ref, consensus, own_row, d_full: int):
    """The per-rank quantized round's two kernels: ``stochastic_quantize``
    on one (1, D) row and ``quantized_combine`` on one row, the K level
    rows it holds and a (K, 1) table, each bit for bit its plain version
    (in column slices at the full D) and the stacked round's row (ring,
    n = 4, every row at small D, row 1 at the full D of the
    DRIVER_LAYERS-layer message); timed beside the stacked call.  Returns
    the per-rank entries of the two kernel rows."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    strat = consensus.GossipConsensus(N_WORKERS, 1, "ring")
    src, w, k = strat.source_rows("cuda"), strat.taps.weights, strat.taps.k
    table = own_row(k, "cuda")
    row_grids = consensus.row_grids
    timing = {}
    for d in (1001, 129, d_full):
        rows = (1,) if d == d_full else range(N_WORKERS)
        m = torch.randn((N_WORKERS, d), generator=gen, device="cuda")
        h = torch.randn((N_WORKERS, d), generator=gen, device="cuda") * 0.3
        rnd = torch.rand((N_WORKERS, d), generator=gen, device="cuda")
        lo, scale = row_grids(m, h, 255.0)
        lvl, h_new = ops.stochastic_quantize(m, h, rnd, lo, scale, 255.0,
                                             force="kernel")
        for r in rows:
            one = [x[r:r + 1] for x in (m, h, rnd, lo, scale)]
            got_l, got_h = ops.stochastic_quantize(*one, 255.0,
                                                   force="kernel")
            torch.cuda.synchronize()
            if not (torch.equal(got_l[0], lvl[r])
                    and torch.equal(got_h[0], h_new[r])):
                fail(f"stochastic_quantize per-rank row {r} D={d} differs "
                     f"from the stacked round's")
            bad = []

            def compare(a, b):
                want_l, want_h = ref.stochastic_quantize_ref(
                    *[x[:, a:b] for x in one[:3]], one[3], one[4], 255.0)
                if not (torch.equal(want_l, got_l[:, a:b])
                        and torch.equal(want_h, got_h[:, a:b])):
                    bad.append(a)

            in_chunks(compare, d)
            if bad:
                fail(f"stochastic_quantize per-rank row {r} D={d}: kernel "
                     f"vs plain differ in the slices from {bad}")
        if d == d_full:
            one = [x[1:2].clone() for x in (m, h, rnd, lo, scale)]
            lvl1 = torch.empty_like(one[0], dtype=torch.uint8)
            s_ms, st_ms = time_pair(
                torch, lambda: ops.stochastic_quantize(
                    *one, 255.0, out=(lvl1, one[1]), force="kernel"),
                lambda: ops.stochastic_quantize(
                    m, h, rnd, lo, scale, 255.0, out=(lvl, h),
                    force="kernel"), 5, "stochastic_quantize per-rank "
                "(beside: the stacked call)")
            sp_ms = time_ms(torch, lambda: in_chunks(
                lambda a, b: ref.stochastic_quantize_ref(
                    *[x[:, a:b] for x in one[:3]], one[3], one[4], 255.0),
                d), 3, "stochastic_quantize per-rank plain")
            b_ms, b_by = bound(17 * d, 8 * d)
            timing["stochastic_quantize"] = dict(
                shape=f"one row (1, D), D={d}", ms=s_ms, plain_ms=sp_ms,
                stacked_ms=st_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)
            print(f"stochastic_quantize per-rank (1, D) D={d}: bit for bit "
                  f"the stacked round's row and the plain version's; "
                  f"ms={s_ms:.4f} plain_ms={sp_ms:.4f} stacked (n={N_WORKERS})"
                  f" ms={st_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"[{card_line()}]", flush=True)
            del one, lvl1
        del h, rnd, h_new
        release(torch)
        hnbr = torch.randn((k - 1, N_WORKERS, d), generator=gen,
                           device="cuda")
        for r in rows:
            need = [r] + [s for _, s, _ in strat.rank_plan(r)]
            args = (m[r:r + 1].clone(), hnbr[:, r:r + 1].contiguous(),
                    lvl[need].contiguous(), lo[need, 0].contiguous(),
                    scale[need, 0].contiguous())
            got_o, got_h = ops.quantized_combine(*args, table, w,
                                                 force="kernel")
            torch.cuda.synchronize()
            bad = []

            def compare(a, b):
                want_o, want_h = ref.quantized_combine_ref(
                    args[0][:, a:b], args[1][:, :, a:b], args[2][:, a:b],
                    args[3], args[4], table, w)
                if not (torch.equal(want_o, got_o[:, a:b])
                        and torch.equal(want_h, got_h[:, :, a:b])):
                    bad.append(a)

            in_chunks(compare, d)
            if bad:
                fail(f"quantized_combine per-rank row {r} D={d}: kernel vs "
                     f"plain differ in the slices from {bad}")
            # the stacked round (in place at the full D, where two stacks
            # of replicas would not fit beside the row's own)
            dest = (m, hnbr) if d == d_full else None
            want_o, want_h = ops.quantized_combine(
                m, hnbr, lvl, lo, scale, src, w, out=dest, force="kernel")
            if not (torch.equal(got_o[0], want_o[r])
                    and torch.equal(got_h[:, 0], want_h[:, r])):
                fail(f"quantized_combine per-rank row {r} D={d} differs "
                     f"from the stacked round's")
            del want_o, want_h
            if d == d_full:
                q_ms, qs_ms = time_pair(
                    torch, lambda: ops.quantized_combine(
                        *args, table, w, out=(got_o, got_h),
                        force="kernel"),
                    lambda: ops.quantized_combine(
                        m, hnbr, lvl, lo, scale, src, w, out=(m, hnbr),
                        force="kernel"), 5, "quantized_combine per-rank "
                    "(beside: the stacked call)")
                qp_ms = time_ms(torch, lambda: in_chunks(
                    lambda a, b: ref.quantized_combine_ref(
                        args[0][:, a:b], args[1][:, :, a:b],
                        args[2][:, a:b], args[3], args[4], table, w), d), 3,
                    "quantized_combine per-rank plain")
                b_ms, b_by = bound(d * (4 + (k - 1) + 8 * (k - 1) + 4),
                                   4 * k * d)
                timing["quantized_combine"] = dict(
                    shape=f"one row, K={k} level rows, a ({k}, 1) table, "
                    f"D={d}", ms=q_ms, plain_ms=qp_ms, stacked_ms=qs_ms,
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)
            del args, got_o, got_h
            release(torch)
        line = (f"quantized_combine per-rank K={k} level rows -> 1 (a "
                f"({k}, 1) table) D={d}: bit for bit the stacked round's "
                f"row and the plain version's")
        if d == d_full:
            t = timing["quantized_combine"]
            line += (f"; ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                     f"stacked (n={N_WORKERS}) ms={t['stacked_ms']:.4f} "
                     f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
                     f"[{card_line()}]")
        print(line, flush=True)
        del m, hnbr, lvl, lo, scale
        release(torch)
    return timing


def driver_session(rt, cfg, case: dict, mesh, data: int = N_WORKERS,
                   model: int = 1):
    """A session of phase 15 (and of phase 16's drivers at ``data`` x
    ``model``): TrainSpec's defaults, the simulated clock, ring gossip at
    DRIVER_ROUNDS; ``mesh`` None is every worker in one process (False:
    also when a process group is initialised)."""
    consensus = case["consensus"]
    return rt.api.AMBSession(
        rt.api.TrainSpec(data=data, model=model, batch_per_worker=PER_WORKER,
                         seq_len=SEQ, redundancy=case.get("redundancy", 1),
                         optimizer=case.get("optimizer", "dual_averaging")),
        rt.api.ClockSpec(kind="simulated"),
        rt.api.ConsensusSpec(consensus=consensus, graph="ring",
                             gossip_rounds=DRIVER_ROUNDS[consensus],
                             pipeline=case.get("pipeline", False),
                             async_epochs=case.get("async_epochs", False),
                             staleness=case.get("staleness", 1)),
        rt.api.ControllerSpec(enabled=True, warmup=case.get("warmup", 1),
                              interval=1)
        if case.get("controller") else None,
        cfg=cfg, device="cuda", mesh=mesh)


def driver_rows(torch, session) -> list:
    """The digest of each worker's dual row the session holds (every row
    in one process, its own over a group)."""
    z = session.state["z"]
    n = next(iter(z.values())).shape[0]
    return as_json([digest(torch, {k: v[i] for k, v in z.items()})
                    for i in range(n)])


def driver_run(torch, rt, session, label: str, epochs: int = DRIVER_EPOCHS,
               before=None, faults=None) -> dict:
    """``epochs`` epochs through ``run`` (no prefetcher; ``faults``, a
    fault injector, applied before each), then a flush; per epoch the
    loss, b(t), the host seconds, the noise statistics (a controlled
    session) and the controller's action; the peak and the launch counts
    of exactly these epochs and the flush.  ``before(i)`` runs before
    epoch i."""
    noise, step = [], session.protocol.step
    if session.controller is not None:
        def spy(state, batch, b):
            state, m = step(state, batch, b)
            noise.append([float(m["grad_sq_norm"]), float(m["grad_var"])])
            return state, m
        session.protocol.step = spy
    rt.kernels.router.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "batch": [], "actions": [], "epoch_s": []}
    for i in range(epochs):
        if before is not None:
            before(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = session.run(1, prefetch=0, faults=faults)
        torch.cuda.synchronize()
        out["epoch_s"].append(time.perf_counter() - t0)
        if not math.isfinite(m["loss"]):
            fail(f"{label} epoch {i}: loss {m['loss']}")
        out["losses"].append(m["loss"])
        out["batch"].append(m["global_batch"])
        out["actions"].append(m.get("action"))
    session.flush()
    session.protocol.step = step
    out.update(noise=noise, launches=rt.kernels.router.launches(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return as_json(out)


def fp32_primal(rt, session, active=True):
    """``gossip_primal`` on the session's duals against a zero fp32 anchor,
    one leaf at a time: ``-zbar / (2 beta)`` in fp32, where the bf16 primal
    would round a departed worker's weight away; ``active=False`` averages
    every worker, as the group path did before the active mask.  Yields
    (name, leaf); every rank must walk it."""
    import torch
    amb = session.protocol.amb
    if not active:
        amb = dataclasses.replace(amb, active=None)
    z = session.state["z"]
    for k, zl in z.items():
        state = {"z": {k: zl}, "t": session.state["t"],
                 "w0": {k: torch.zeros(zl.shape[1:], dtype=torch.float32,
                                       device=zl.device)}}
        yield k, rt.dist.amb.gossip_primal(state, amb, session.group)[k]


def churn_before(session):
    """Worker 1 out for the first epoch, then a table of 2 survivors, then
    every worker back."""
    masks = DRIVER_MASKS + ((True,) * N_WORKERS,)

    def before(i):
        session.set_active(masks[i])
    return before


def driver_references(torch, rt, full, work: Path) -> dict:
    """The parent's one-process sessions of phase 15, under deterministic
    algorithms, before any rank starts: each DRIVER_CASES session (losses,
    b(t), each worker's dual row's digest, noise statistics, actions) and
    the smoke-size checkpoint (one epoch, a save the ranks restore, one
    more epoch: each row's digest).  Written to ``drivers.json``."""
    cfg = dataclasses.replace(full, num_layers=DRIVER_LAYERS)
    refs = {}
    lap = stamps("drivers references")
    with deterministic(torch):
        for name, case in DRIVER_CASES.items():
            session = driver_session(rt, cfg, case, None)
            res = driver_run(torch, rt, session, f"drivers reference {name}")
            res["rows"] = driver_rows(torch, session)
            refs[name] = res
            lap(f"{name} done")
            print(f"drivers reference {name} ({DRIVER_LAYERS} layer, one "
                  f"process): losses {res['losses']} epoch_s "
                  f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
                  f"{res['peak_gib']:.2f} launches {res['launches']} "
                  f"[{card_line()}]", flush=True)
            del session
            release(torch)
        smoke = rt.configs.smoke_config("qwen2-1.5b")
        session = driver_session(rt, smoke, dict(consensus="gossip",
                                                 pipeline=True), None)
        session.run(1, prefetch=0)
        session.save(work / "ckpt_one")
        session.run(1, prefetch=0)
        session.flush()
        refs["ckpt"] = {"rows": driver_rows(torch, session)}
        del session
    release(torch)
    lap("the checkpoint reference done")
    (work / "drivers.json").write_text(json.dumps(refs))
    return refs


def driver_tensor_references(torch, rt, full) -> dict:
    """Rank 0's one-process twins, run while the other ranks wait, whose
    results are held to a tolerance and so are kept as host tensors:
    coded exact (the parameters), churn (the fp32 primal with worker 1
    out, the duals' digests) and the MoE exact step (the parameters, aux
    each epoch)."""
    cfg = dataclasses.replace(full, num_layers=DRIVER_LAYERS)
    out = {}
    lap = stamps("drivers tensor references")
    session = driver_session(rt, cfg, dict(consensus="exact",
                                            redundancy=2), False)
    res = driver_run(torch, rt, session, "coded reference")
    lap("coded exact done")
    out["coded"] = {"batch": res["batch"], "losses": res["losses"],
                    "params": {k: v.detach().cpu()
                               for k, v in session.params.items()}}
    del session
    release(torch)
    session = driver_session(rt, cfg, dict(consensus="gossip"), False)
    before = churn_before(session)
    primal = {}

    def masked(i):
        if i == 1:        # after the epoch with worker 1 out
            primal.update({k: v.cpu() for k, v in fp32_primal(rt, session)})
        before(i)
    res = driver_run(torch, rt, session, "churn reference", 3, masked)
    out["churn"] = {"losses": res["losses"], "primal": primal,
                    "rows": driver_rows(torch, session)}
    del session
    release(torch)
    lap("churn done")
    moe = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                              num_layers=DRIVER_MOE_LAYERS)
    session = driver_session(rt, moe, DRIVER_MOE_CASE, False)
    res = driver_moe_run(torch, rt, session, "moe reference")
    out["moe"] = {"aux": res["aux"], "losses": res["losses"],
                  "params": {k: v.detach().cpu()
                             for k, v in session.params.items()}}
    del session
    release(torch)
    lap("the MoE step done")
    print(f"  rank 0 drivers tensor references: coded losses "
          f"{out['coded']['losses']}, churn losses {out['churn']['losses']}, "
          f"moe aux {out['moe']['aux']} [{card_line()}]", flush=True)
    return out


def driver_moe_run(torch, rt, session, label: str) -> dict:
    """The MoE exact session's epochs, with each epoch's aux as the exact
    step reports it."""
    auxes, step = [], session.protocol._step

    def spied(params, opt_state, batch, b):
        out = step(params, opt_state, batch, b)
        auxes.append(float(out[2]["aux"]))
        return out
    session.protocol._step = spied
    res = driver_run(torch, rt, session, label)
    session.protocol._step = step
    res["aux"] = auxes
    return res


def within(torch, got: dict, want: dict, tol: float, what: str) -> float:
    """The worst leaf's max |got - want| over its largest magnitude; fails
    past ``tol``."""
    worst, at = 0.0, None
    for k, ref_leaf in want.items():
        ref_leaf = ref_leaf.to("cuda")
        scale = float(ref_leaf.float().abs().max())
        err = max_abs_err(torch, got[k], ref_leaf) / max(scale, 1e-30)
        if err >= worst:
            worst, at = err, k
    if worst > tol:
        fail(f"{what}: {at} within {worst} of its largest value > {tol}")
    return worst


def same_on_every_rank(dist, x, what: str) -> None:
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, x)
    if any(e != every[0] for e in every):
        fail(f"drivers {what}: the ranks differ: {every}")


def driver_report(label: str, rank: int, res: dict, group) -> None:
    print(f"  rank {rank} drivers {label}: peak_GiB={res['peak_gib']:.2f} "
          f"epoch_s={[round(x, 4) for x in res['epoch_s']]} sent_bytes="
          f"{group.sent_bytes} staged_bytes={group.staged_bytes} launches="
          f"{res['launches']} losses={res['losses']} [{card_line()}]",
          flush=True)


def rank_drivers(torch, rt, dist, work: Path) -> None:
    """Phase 15 on four gloo ranks sharing the card, under deterministic
    algorithms: rank 0's tensor references first (the others wait), then
    every case against the parent's and rank 0's references; results to
    ``drivers_rank<r>.json``."""
    rank = dist.get_rank()
    lap = stamps("drivers rank 0", rank)
    refs = json.loads((work / "drivers.json").read_text())
    full = rt.configs.get_config("qwen2-1.5b")
    cfg = dataclasses.replace(full, num_layers=DRIVER_LAYERS)
    mesh = rt.launch.mesh.make_host_mesh(MESH_RANKS, 1, device="cuda")
    out = {}
    with deterministic(torch):
        tref = driver_tensor_references(torch, rt, full) if rank == 0 \
            else None
        release(torch)
        dist.barrier()
        lap("the tensor references done")
        d = dense_param_count(cfg) + 1
        for name, case in DRIVER_CASES.items():
            session = driver_session(rt, cfg, case, mesh)
            lap(f"the {name} session built")
            res = driver_run(torch, rt, session, f"drivers {name}")
            lap(f"the {name} epochs done")
            driver_report(name, rank, res, session.group)
            want = refs[name]
            if driver_rows(torch, session)[0] != want["rows"][rank]:
                fail(f"drivers {name} rank {rank}: its dual row differs "
                     f"from the one-process session's row {rank}")
            if res["losses"] != want["losses"] \
                    or res["batch"] != want["batch"]:
                fail(f"drivers {name} rank {rank}: losses {res['losses']} "
                     f"b(t) {res['batch']} vs {want['losses']} "
                     f"{want['batch']}")
            strat = rt.dist.amb.strategy_from_config(session.protocol.amb,
                                                     N_WORKERS)
            settles = DRIVER_EPOCHS + case.get("staleness", 1) \
                if case.get("pipeline") or case.get("async_epochs") \
                else DRIVER_EPOCHS
            rounds = settles * strat.rounds
            count = {"dual_update": 15 * DRIVER_EPOCHS}
            if name in ("q8", "q4"):
                per_round = strat.wire_bytes_per_round(d)
                got = session.group.sent_bytes
                if got != rounds * per_round:
                    fail(f"drivers {name} rank {rank}: sent {got} bytes, "
                         f"{got / rounds} a round, wire_bytes_per_round "
                         f"{per_round}")
                print(f"  rank {rank} drivers {name}: {got // rounds} bytes "
                      f"a round = wire_bytes_per_round(D={d}) (fp32 would "
                      f"send {4 * d * 2})", flush=True)
                count.update(stochastic_quantize=rounds,
                             quantized_combine=rounds)
            else:
                count["gossip_combine"] = rounds
            expect(f"drivers {name} rank {rank}", res["launches"], count)
            if name == "controller":
                for g, w in zip(res["noise"], want["noise"]):
                    for a, b in zip(g, w):
                        if abs(a - b) > DRIVER_NOISE_RTOL * abs(b):
                            fail(f"drivers controller rank {rank}: noise "
                                 f"{res['noise']} vs {want['noise']}")
                if res["actions"] != want["actions"] \
                        or not any(res["actions"]):
                    fail(f"drivers controller rank {rank}: actions "
                         f"{res['actions']} vs {want['actions']}")
                same_on_every_rank(dist, res["actions"], "actions")
            out[name] = {k: res[k] for k in ("launches", "peak_gib",
                                             "epoch_s")}
            out[name]["sent_bytes"] = session.group.sent_bytes
            out[name]["staged_bytes"] = session.group.staged_bytes
            out[name]["rounds"] = rounds
            del session, strat
            release(torch)
            lap(f"the {name} checks done")
        print(f"  rank {rank} drivers: q8, q4, pipelined, async D=2 and the "
              f"controlled session bit for bit the one-process rows",
              flush=True)
        # churn: worker 1 out, then 2 survivors, then all back
        session = driver_session(rt, cfg, dict(consensus="gossip"), mesh)
        before = churn_before(session)
        checked = {}

        def masked(i):
            if i == 1:      # after the epoch with worker 1 out
                rep, unrep = 0.0, math.inf
                for (k, got), (_, old) in zip(
                        fp32_primal(rt, session),
                        fp32_primal(rt, session, active=False)):
                    if rank == 0:
                        want = tref["churn"]["primal"][k].to("cuda")
                        scale = max(float(want.abs().max()), 1e-30)
                        rep = max(rep, max_abs_err(torch, got, want) / scale)
                        unrep = min(unrep, max_abs_err(torch, old, want)
                                    / scale)
                    del got, old
                if rank == 0:
                    checked.update(repaired=rep, unrepaired=unrep)
                    if rep > DRIVER_PRIMAL_TOL:
                        fail(f"drivers churn: the primal with worker 1 out "
                             f"is {rep} from the one-process primal")
                    if unrep <= 100 * DRIVER_PRIMAL_TOL:
                        fail("drivers churn: the all-worker mean is not "
                             "told apart from the active mean")
                release(torch)
            before(i)
        res = driver_run(torch, rt, session, "drivers churn", 3, masked)
        driver_report("churn", rank, res, session.group)
        rows = driver_rows(torch, session)[0]
        every = [None] * MESH_RANKS
        dist.all_gather_object(every, rows)
        if rank == 0:
            if every != tref["churn"]["rows"] \
                    or res["losses"] != tref["churn"]["losses"]:
                fail("drivers churn: the ranks' dual rows or losses differ "
                     "from the one-process session's")
            print(f"  drivers churn: dual rows bit for bit (3 and 2 "
                  f"survivors, then all back); the fp32 primal with worker "
                  f"1 out within {checked['repaired']:.3g} of the "
                  f"one-process primal (tol {DRIVER_PRIMAL_TOL}); the "
                  f"all-worker mean would be {checked['unrepaired']:.3g} "
                  f"away", flush=True)
        # 15 prox launches an epoch, and 15 for each of the two fp32
        # primals; a round only while this worker is a survivor
        masks = DRIVER_MASKS + ((True,) * N_WORKERS,)
        expect(f"drivers churn rank {rank}", res["launches"],
               {"dual_update": 75,
                "gossip_combine": sum(m[rank] for m in masks)})
        out["churn"] = {k: res[k] for k in ("launches", "peak_gib",
                                            "epoch_s")}
        del session
        release(torch)
        lap("churn done")
        # coded exact
        session = driver_session(rt, cfg, dict(consensus="exact",
                                               redundancy=2), mesh)
        res = driver_run(torch, rt, session, "drivers coded exact")
        driver_report("coded exact", rank, res, session.group)
        same_on_every_rank(dist, digest(torch, session.params),
                           "coded exact parameters")
        if rank == 0:
            ref = tref["coded"]
            if res["batch"] != ref["batch"]:
                fail(f"drivers coded exact: b(t) {res['batch']} vs "
                     f"{ref['batch']}")
            worst = within(torch, session.params, ref["params"],
                           MESH_PARAM_TOL, "drivers coded exact")
            print(f"  drivers coded exact (rho 2): global_batch "
                  f"{res['batch']} equal; parameters within {worst:.3g} of "
                  f"the one-process session's (tol {MESH_PARAM_TOL}); all "
                  f"ranks equal", flush=True)
        out["coded"] = {k: res[k] for k in ("launches", "peak_gib",
                                            "epoch_s")}
        del session
        release(torch)
        lap("coded exact done")
        # checkpoints at the smoke config: ranks save, then restore the
        # parent's save
        smoke = rt.configs.smoke_config("qwen2-1.5b")
        case = dict(consensus="gossip", pipeline=True)
        session = driver_session(rt, smoke, case, mesh)
        session.run(1, prefetch=0)
        session.save(work / "ckpt_ranks")
        session.run(1, prefetch=0)
        session.flush()
        if driver_rows(torch, session)[0] != refs["ckpt"]["rows"][rank]:
            fail(f"drivers checkpoint rank {rank}: the saving session's "
                 f"next epoch differs from the one-process session's")
        del session
        back = rt.api.AMBSession.restore(work / "ckpt_one", device="cuda",
                                         cfg=smoke)
        back.run(1, prefetch=0)
        back.flush()
        if back.group is None or \
                driver_rows(torch, back)[0] != refs["ckpt"]["rows"][rank]:
            fail(f"drivers checkpoint rank {rank}: the one-process save "
                 f"restored over the ranks does not continue bit for bit")
        del back
        release(torch)
        lap("the checkpoints done")
        # the MoE exact step
        moe = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                                  num_layers=DRIVER_MOE_LAYERS)
        session = driver_session(rt, moe, DRIVER_MOE_CASE, mesh)
        res = driver_moe_run(torch, rt, session, "drivers moe")
        driver_report("moe exact", rank, res, session.group)
        same_on_every_rank(dist, digest(torch, session.params),
                           "moe parameters")
        if rank == 0:
            ref = tref["moe"]
            for a, b in zip(res["aux"], ref["aux"]):
                if abs(a - b) > DRIVER_AUX_RTOL * abs(b):
                    fail(f"drivers moe: aux {res['aux']} vs {ref['aux']}")
            worst = within(torch, session.params, ref["params"],
                           MESH_PARAM_TOL, "drivers moe exact")
            print(f"  drivers moe exact ({MOE_ARCH}, {DRIVER_MOE_LAYERS} "
                  f"layer): aux {res['aux']} vs one process {ref['aux']} "
                  f"(rtol {DRIVER_AUX_RTOL}); parameters within {worst:.3g} "
                  f"(tol {MESH_PARAM_TOL}); all ranks equal", flush=True)
        out["moe"] = {k: res[k] for k in ("launches", "peak_gib", "epoch_s")}
        del session
    release(torch)
    lap("the MoE step done")
    (work / f"drivers_rank{rank}.json").write_text(json.dumps(out))


def drivers_after(torch, rt, work: Path, refs: dict) -> dict:
    """Phase 15 after the gloo ranks: one process restores the ranks'
    checkpoint and continues bit for bit; the ranks' peaks.  Returns the
    ranks' launch counts and numbers."""
    ranks = [json.loads((work / f"drivers_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    with deterministic(torch):
        smoke = rt.configs.smoke_config("qwen2-1.5b")
        back = rt.api.AMBSession.restore(work / "ckpt_ranks",
                                         device="cuda", cfg=smoke)
        back.run(1, prefetch=0)
        back.flush()
        if driver_rows(torch, back) != refs["ckpt"]["rows"]:
            fail("drivers checkpoint: the ranks' save restored in one "
                 "process does not continue bit for bit")
        del back
    print("drivers checkpoint (smoke config, pipelined): ranks save and "
          "one process restores, one process saves and the ranks "
          "restore; the next epoch bit for bit both ways", flush=True)
    for name in ranks[0]:
        peaks = [r[name]["peak_gib"] for r in ranks]
        print(f"drivers {name}: peaks GiB {[round(p, 2) for p in peaks]}"
              f", sum {sum(peaks):.2f} (limit {MESH_PEAK_SUM_GIB}) "
              f"[{card_line()}]", flush=True)
        if sum(peaks) > MESH_PEAK_SUM_GIB:
            fail(f"drivers {name}: the ranks' peaks sum to "
                 f"{sum(peaks):.2f} GiB")
    launches = {f"drivers {name} rank {r}": res[name]["launches"]
                for r, res in enumerate(ranks) for name in res}
    return {"launches": launches, "ranks": ranks}


# ---------------------------------------------------------------------------
# A worker over a model axis (phase 16): FSDP x TP over four gloo ranks
# ---------------------------------------------------------------------------

MODEL_AXIS = (2, 2)            # (data, model): two workers of two ranks
# qwen2-1.5b width cut to 1 layer: at 8 the command took 1,168.8 s of
# its 1,200 on an H100 at 700 W, before the quantized gossip checks; at 4
# 1,195.4 s with phase 17; at 2 1,054.5 s with phase 20, before phase 21's
# ranks added about 54 s after the parent's steps
MODEL_LAYERS = 1
MODEL_CLI_ARGV = ["--smoke", "--sim-clock", "--steps", str(MESH_EPOCHS),
                  "--data", str(MODEL_AXIS[0])]
MODEL_CLI = ("exact", "gossip", "gossip_q8")
# quantized gossip over the model axis: the consensus alone on a fixed
# (2, W + 1) stack (row i from seed MODEL_STACK_SEED + i), under the draws
# of epoch_draws(MODEL_STACK_SEED, 0), q8 and q4 at DRIVER_ROUNDS
MODEL_Q = ("gossip_q8", "gossip_q4")
MODEL_STACK_SEED = 16
# the q8 session's dual, each worker's gathered over its model ranks,
# against the one-process session's as one stack: ||ranks - one|| over
# ||one|| within MODEL_Q_FACTOR times the one-process session's own move
# under the model ranks' summation order (``tp_sums``) and never above
# MODEL_Q_TOL (a flipped stochastic rounding moves one element by a grid
# step; tests/test_torch_quantized.py holds the port against JAX so, at
# 1e-2).  ``split_sums`` alone is too narrow here: on an H100 at 4 layers
# in fp32 the reference moved 0.00204 under it and the ranks sat 0.00625
# away, since the model ranks also sum the column-parallel products'
# input gradients and the vocabulary's halves
MODEL_Q_FACTOR = 2.0
MODEL_Q_TOL = 1e-2
# the gossip_q8 session runs in fp32: with bf16 gradients an order change
# moves each payload element by a bf16 unit, and each of the 8 rounds an
# epoch then flips that share of the stochastic roundings (a grid step
# each): on the CPU rehearsal at the smoke config the bf16 reference's
# dual stack moved 0.14 of its norm under ``split_sums``, where MODEL_Q_TOL
# cannot tell a fault from the order; the train CLI checks gossip_q8 in bf16
MODEL_Q_DTYPE = "float32"
# each leaf's limit, as a share of its largest value: ORDER_FACTOR times
# how far the one-process reference moves under ``split_sums`` (a change
# of summation order), no less than ORDER_FLOOR (one bf16 unit in the
# last place at the leaf's largest value: the parameters and the
# gradients the duals sum are bf16, so an order change moves them by
# whole bf16 units) and no more than MESH_PARAM_TOL
ORDER_FACTOR = 2.0
ORDER_FLOOR = 2.0 ** -8
# every driver and option over the model axis: phase 15's cases as twins
# at (data 2, model 2), DRIVER_LAYERS, in MODEL_Q_DTYPE, DRIVER_EPOCHS, each
# held against rank 1's one-process data=2 twin under ``tp_sums``, dual
# blocks bit for bit (coded exact: its plain twin within order_limits).
# The async session runs gossip_q8 with the controller on, so one session
# holds the queue, the noise statistics and the quantized kernels on a
# block row. It runs MODEL_ASYNC_EPOCHS epochs and the controller waits
# as many (``warmup``), so D = 2 holds while epochs 0 and 1's payloads
# settle from the queue (with their snapshots) at steps 2 and 3; then it
# lowers D to 1 (T_c is 0), and the retune drains the rest. Churn takes
# worker 1 out for one epoch through a fault model: with two workers the
# survivor is alone, so that epoch's consensus is the identity (a ring of
# survivors over blocks runs in tests/test_torch_tp_drivers.py only)
MODEL_ASYNC_EPOCHS = 4
MODEL_DRIVERS = {
    "pipelined": dict(consensus="gossip", pipeline=True),
    "async_controller": dict(consensus="gossip_q8", async_epochs=True,
                             staleness=2, controller=True,
                             epochs=MODEL_ASYNC_EPOCHS,
                             warmup=MODEL_ASYNC_EPOCHS),
    "churn": dict(consensus="gossip"),
}
MODEL_CHURN = dict(workers=(1,), at=1, until=2)      # a FailStop
MODEL_CHURN_EPOCHS = DRIVER_EPOCHS + 1
MODEL_CODED = dict(consensus="exact", redundancy=2)
MODEL_KINDS = ("exact", "gossip", "gossip_q8", *MODEL_DRIVERS, "coded")


def _half_sums(torch, x, w):
    """``x @ w`` as two ranks of "model" sum it: two half-width products,
    each rounded to the model's dtype, added in fp32 and rounded once."""
    c = x.shape[-1] // 2
    out = (x[..., :c] @ w[:c]).float() + (x[..., c:] @ w[c:]).float()
    return out.to(x.dtype)


@contextlib.contextmanager
def split_sums(torch, rt):
    """The dense block's row-parallel products (attention's wo, the MLP's
    w_down) summed as the model ranks sum them (``_half_sums``): a change
    of summation order only."""
    model, attn = rt.models.model, rt.models.attention
    plain_mlp, plain_attention = model.swiglu, attn.masked_attention

    def mlp(x, w_gate, w_up, w_down):
        h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
        return _half_sums(torch, h, w_down)

    class Heads(torch.Tensor):
        """The attention's output, whose product with wo is split."""

        def __matmul__(self, w):
            return _half_sums(torch, self.as_subclass(torch.Tensor), w)

    def attention(*args, **kwargs):
        return plain_attention(*args, **kwargs).as_subclass(Heads)

    model.swiglu, attn.masked_attention = mlp, attention
    try:
        yield
    finally:
        model.swiglu, attn.masked_attention = plain_mlp, plain_attention


def _fan(torch, m: int):
    """``x`` -> m views of it, one for each model rank's use; the
    backward sums their gradients in fp32 in rank order and rounds once,
    as ``dist.tp.ordered_sum`` sums a column-parallel input's gradient
    over the ranks."""

    class Fan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return tuple(x.view_as(x) for _ in range(m))

        @staticmethod
        def backward(ctx, *grads):
            out = grads[0].float()
            for g in grads[1:]:
                out = out + g.float()
            return out.to(grads[0].dtype)

    return Fan.apply


def _parts_nll(torch, m: int):
    """The vocab-parallel cross-entropy of ``dist.tp`` over m column
    blocks of the logits in one process, its arithmetic step for step:
    the row max and the sum of exponentials across the blocks (the sum
    in rank order), the gold logit from its owner, and a backward of
    ``softmax - onehot`` on each block."""

    class PartsNLL(torch.autograd.Function):
        @staticmethod
        def forward(ctx, labels, valid, *xs):
            xs = list(xs)
            for r, x in enumerate(xs):
                if valid[r] < x.shape[-1]:
                    col = torch.arange(x.shape[-1], device=x.device)
                    xs[r] = x.masked_fill(col >= valid[r], float("-inf"))
            c = xs[0].shape[-1]
            mx = xs[0].amax(dim=-1)
            for x in xs[1:]:
                mx = torch.maximum(mx, x.amax(dim=-1))
            s = torch.exp(xs[0] - mx[..., None]).sum(dim=-1)
            for x in xs[1:]:
                s = s + torch.exp(x - mx[..., None]).sum(dim=-1)
            gold, saved = 0.0, []
            for r, x in enumerate(xs):
                local = labels.long() - r * c
                own = (local >= 0) & (local < valid[r])
                local = local.clamp(0, c - 1)
                gold = gold + torch.where(
                    own, torch.gather(x, -1, local[..., None])[..., 0], 0.0)
                saved += [x, local, own]
            lse = mx + torch.log(s)
            ctx.save_for_backward(lse, *saved)
            return lse - gold

        @staticmethod
        def backward(ctx, g):
            lse, *saved = ctx.saved_tensors
            grads = []
            for r in range(m):
                x, local, own = saved[3 * r:3 * r + 3]
                p = torch.exp(x - lse[..., None])
                idx = local[..., None]
                p.scatter_(-1, idx, p.gather(-1, idx)
                           - own[..., None].to(p.dtype))
                grads.append(p.mul_(g[..., None]))
            return (None, None, *grads)

    return PartsNLL


class _PartsTP:
    """The hooks of :class:`repro_torch.dist.tp.TensorParallel` for a
    worker of m model ranks, in one process on whole leaves (under
    ``tp_sums``): the block, the lookup and the MLP pass through (the
    patched products split them), and the cross-entropy is the
    vocab-parallel one over m column blocks (``_parts_nll``), each
    block's logits from its own view of the hidden state."""

    def __init__(self, torch, m: int):
        self.torch, self.m = torch, m
        self.nll, self.fan = _parts_nll(torch, m), _fan(torch, m)

    def block(self, p, prefix=None):
        return p

    def embed(self, weight, tokens):
        return self.torch.nn.functional.embedding(tokens, weight)

    def mlp(self, fn, x, prefix=None):
        return fn(x)

    def token_nll(self, hidden, unembed, labels, vocab_size):
        c = unembed.shape[1] // self.m
        xs = [(h @ unembed[:, r * c:(r + 1) * c]).float()
              for r, h in enumerate(self.fan(hidden))]
        valid = [max(0, min((r + 1) * c, vocab_size) - r * c)
                 for r in range(self.m)]
        return self.nll.apply(labels, valid, *xs)


@contextlib.contextmanager
def tp_sums(torch, rt, m: int = 2):
    """A worker's m model ranks' summation order in one process: the
    attention's query heads, its KV heads (or, with more ranks than KV
    heads, each head's columns: the ranks that share a head project
    their columns and put them together, as ``TensorParallel.gather_kv``
    gathers them) and the MLP's ffn columns in m blocks, each from its
    own view of the block's input (``_fan``: the input's gradient sums
    each rank's parts first, then the ranks' in fp32 in rank order, as a
    rank's backward and the column-parallel sum over "model" do), each
    block's row-parallel product summed in fp32 in rank order and rounded
    once, and the vocab-parallel cross-entropy (``_PartsTP``); an RWKV6
    block as ``_twin_rwkv_block``, a Mamba2 block as ``_twin_mamba_block``
    (the hybrid's shared block is a dense block).  Whisper's
    cross-attention projects
    each rank's k and v columns from its own view of the encoder's output
    (``kv_input``, fanned per layer as the ranks copy it per layer), with
    no rope.  Wider than ``split_sums``, which splits the forward
    row-parallel sums only."""
    model, attn, amb = rt.models.model, rt.models.attention, rt.dist.amb
    plain = (model.swiglu, attn.attend_train, amb.lm_loss, model._rwkv_block,
             model._mamba_block)
    parts = _PartsTP(torch, m)
    fan = parts.fan

    def mlp(x, w_gate, w_up, w_down):
        c = w_gate.shape[-1] // m
        out = 0.0
        for r, xr in enumerate(fan(x)):
            cols = slice(r * c, (r + 1) * c)
            h = torch.nn.functional.silu(xr @ w_gate[:, cols]) \
                * (xr @ w_up[:, cols])
            out = out + (h @ w_down[cols]).float()
        return out.to(x.dtype)

    def attend(p, x, positions, cfg, *, causal=True, window=None,
               kv_input=None, rope=True, return_kv=False, tp=None,
               prefix=None):
        if return_kv:
            raise ValueError("tp_sums: the twin's attention returns no k, v")
        b, s, _ = x.shape
        hd = cfg.hd
        hq, w = cfg.num_heads * hd // m, cfg.num_kv_heads * hd // m
        share = max(1, m // cfg.num_kv_heads)
        window = cfg.sliding_window if window is None else window
        norms = {k: fan(p[k]) for k in ("q_norm", "k_norm") if k in p}
        xs = fan(x)
        kvs = xs if kv_input is None else fan(kv_input)
        skv = kvs[0].shape[1]
        proj = []
        for r, (xr, kr) in enumerate(zip(xs, kvs)):   # each rank's
            q, k_, v = (xr @ p["wq"][:, r * hq:(r + 1) * hq],  # columns
                        kr @ p["wk"][:, r * w:(r + 1) * w],
                        kr @ p["wv"][:, r * w:(r + 1) * w])
            if "bq" in p:
                q, k_, v = (q + p["bq"][r * hq:(r + 1) * hq],
                            k_ + p["bk"][r * w:(r + 1) * w],
                            v + p["bv"][r * w:(r + 1) * w])
            proj.append((q, k_, v))
        out = 0.0
        for r, (q, _, _) in enumerate(proj):
            group = proj[r // share * share:(r // share + 1) * share]
            k_ = torch.cat([g[1] for g in group], dim=-1)
            v = torch.cat([g[2] for g in group], dim=-1)
            kvh = k_.shape[-1] // hd
            q, k_ = q.reshape(b, s, kvh, -1, hd), k_.reshape(b, skv, kvh, hd)
            if norms:
                q = rt.models.common.rms_norm(q, norms["q_norm"][r])
                k_ = rt.models.common.rms_norm(k_, norms["k_norm"][r])
            v = v.reshape(b, skv, kvh, hd)
            if rope:
                kv_pos = positions if kv_input is None else torch.arange(
                    skv, device=x.device)
                q = rt.models.common.apply_rope(
                    q.reshape(b, s, -1, hd), positions,
                    cfg.rope_theta).reshape(q.shape)
                k_ = rt.models.common.apply_rope(k_, kv_pos, cfg.rope_theta)
            heads = attn.masked_attention(q, k_, v, window, causal=causal)
            out = out + (heads.reshape(b, s, -1)
                         @ p["wo"][r * hq:(r + 1) * hq]).float()
        return out.to(x.dtype)

    def loss(params, cfg, batch, *args, tp=None, **kwargs):
        return plain[2](params, cfg, batch, *args, tp=parts, **kwargs)

    (model.swiglu, attn.attend_train, amb.lm_loss, model._rwkv_block,
     model._mamba_block) = (mlp, attend, loss, _twin_rwkv_block(torch, rt, m),
                            _twin_mamba_block(torch, rt, m))
    try:
        yield
    finally:
        (model.swiglu, attn.attend_train, amb.lm_loss, model._rwkv_block,
         model._mamba_block) = plain


def order_limits(moves: dict) -> dict:
    """Each leaf's limit from its move under ``split_sums``."""
    return {k: min(MESH_PARAM_TOL, max(ORDER_FLOOR, ORDER_FACTOR * m))
            for k, m in moves.items()}


def check_order(label: str, moves: dict) -> dict:
    """The limits of ``moves``, printed; fails where a move reaches
    MESH_PARAM_TOL (no limit could then tell a fault from the order)."""
    limits = order_limits(moves)
    print(f"model-axis reference {label} under split row-parallel sums: "
          f"each leaf's move over its largest value, and its limit: "
          + ", ".join(f"{k} {m:.3g} ({limits[k]:.3g})"
                      for k, m in moves.items()), flush=True)
    worst = max(moves, key=moves.get)
    if moves[worst] >= MESH_PARAM_TOL:
        fail(f"model axis: the {label} reference's {worst} moves by "
             f"{moves[worst]} under a change of summation order; "
             f"MESH_PARAM_TOL {MESH_PARAM_TOL} cannot tell a fault from it")
    return limits


def check_leaves(label: str, errs: dict, limits: dict) -> float:
    """Fails where a leaf's error (``errs`` by leaf, or by (worker, leaf))
    is above its limit; returns the largest share of its limit."""
    share = {key: e / limits[key[1] if isinstance(key, tuple) else key]
             for key, e in errs.items()}
    print(f"  model-axis {label}: each leaf's max |ranks - one process| "
          f"over its largest value (its share of its limit): " + ", ".join(
              f"{key} {e:.3g} ({share[key]:.3g})"
              for key, e in errs.items()), flush=True)
    bad = [key for key, x in share.items() if x > 1.0]
    if bad:
        fail(f"model-axis {label}: {bad} above their limits")
    return max(share.values())


def leaf_errs(torch, got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over max |want|."""
    out = {}
    for k, w in want.items():
        w = w.to(got[k].device)
        scale = float(w.float().abs().max())
        out[k] = max_abs_err(torch, got[k], w) / max(scale, 1e-30)
    return out


def model_references(torch, rt, cfg, lap) -> dict:
    """Rank 0, before the model-axis sessions, while the other ranks wait
    (rank 1 runs ``model_q8_references`` meanwhile): the one-process
    data=2 sessions (exact, ring gossip r 5) on the card under
    deterministic algorithms, kept in host memory (the parameters, each
    worker's dual), and each again under ``split_sums``: how far each leaf
    moves under a change of summation order sets its limit
    (``order_limits``; a worker's dual leaf: the larger worker's move)."""
    data = MODEL_AXIS[0]
    refs = {}
    session = mesh_session(rt, cfg, "exact", False, data=data)
    res = mesh_epochs(torch, rt, session, "model-axis exact reference")
    refs["exact"] = {"losses": res["losses"], "params": {
        k: v.detach().cpu() for k, v in session.params.items()}}
    print(f"model-axis reference exact ({MODEL_LAYERS} layers, one process, "
          f"{data} workers): losses {res['losses']} epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} [{card_line()}]", flush=True)
    del session
    release(torch)
    with split_sums(torch, rt):
        session = mesh_session(rt, cfg, "exact", False, data=data)
        mesh_epochs(torch, rt, session, "model-axis exact, split sums")
    moves = leaf_errs(torch, session.params, refs["exact"]["params"])
    refs["exact"].update(moves=moves, limits=check_order("exact", moves))
    del session
    release(torch)
    lap("the exact references done")
    session = mesh_session(rt, cfg, "gossip", False, data=data)
    res = mesh_epochs(torch, rt, session, "model-axis gossip reference")
    z = {k: v.detach().clone() for k, v in session.state["z"].items()}
    refs["gossip"] = {"losses": res["losses"]}
    print(f"model-axis reference gossip ({MODEL_LAYERS} layers, one process, "
          f"{data} workers): losses {res['losses']} epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} [{card_line()}]", flush=True)
    del session
    release(torch)
    with split_sums(torch, rt):
        session = mesh_session(rt, cfg, "gossip", False, data=data)
        mesh_epochs(torch, rt, session, "model-axis gossip, split sums")
    moves = {k: max(leaf_errs(torch, {k: v[i]}, {k: z[k][i]})[k]
                    for i in range(data))
             for k, v in session.state["z"].items()}
    del session
    refs["gossip"].update(z={k: v.cpu() for k, v in z.items()},
                          moves=moves, limits=check_order("gossip", moves))
    del z
    release(torch)
    lap("the gossip references done")
    return refs


def model_q8_references(torch, rt, cfg, lap) -> dict:
    """Rank 1, while rank 0 runs ``model_references``: the one-process
    data=2 gossip_q8 session (ring, DRIVER_ROUNDS, MODEL_Q_DTYPE) on the
    card under deterministic algorithms, then again under ``tp_sums``
    (the model ranks' summation order); kept on the card.  Returns the
    losses, how far the dual stack moves between the two (``stack_rel``)
    and the limit that sets, and the digest of each rank's block of the
    ``tp_sums`` session's duals (its worker's row cut by
    ``dist.params.shard_leaf`` on the (2, 2) layout)."""
    data = MODEL_AXIS[0]
    rounds = DRIVER_ROUNDS["gossip_q8"]
    cfg = dataclasses.replace(cfg, dtype=MODEL_Q_DTYPE)
    session = mesh_session(rt, cfg, "gossip_q8", False, data=data,
                           rounds=rounds)
    res = mesh_epochs(torch, rt, session, "model-axis gossip_q8 reference")
    z = session.state["z"]
    print(f"model-axis reference gossip_q8 ({MODEL_LAYERS} layers, "
          f"{MODEL_Q_DTYPE}, one process, {data} workers, ring r {rounds}): "
          f"losses {res['losses']} epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} [{card_line()}]", flush=True)
    del session
    lap("the gossip_q8 reference done")
    with tp_sums(torch, rt):
        session = mesh_session(rt, cfg, "gossip_q8", False, data=data,
                               rounds=rounds)
        mesh_epochs(torch, rt, session, "model-axis gossip_q8, TP's sums")
    z_tp = session.state["z"]
    del session
    move = stack_rel(torch, z_tp, z)
    del z
    release(torch)
    digests = block_digests(torch, rt, z_tp)
    del z_tp
    release(torch)
    limit = min(MODEL_Q_TOL, MODEL_Q_FACTOR * move)
    print(f"model-axis reference gossip_q8 under the model ranks' "
          f"summation order (tp_sums): the dual stack moves {move:.4g} of "
          f"its norm; the ranks' limit {limit:.4g}", flush=True)
    if move >= MODEL_Q_TOL:
        fail(f"model axis: the gossip_q8 reference's dual moves by {move} "
             f"under a change of summation order; MODEL_Q_TOL "
             f"{MODEL_Q_TOL} cannot tell a fault from it")
    lap("the gossip_q8 reference under tp_sums done")
    return {"losses": res["losses"], "move": move, "limit": limit,
            "digests": digests}


def block_digests(torch, rt, z: dict) -> list:
    """Per rank of the (data 2, model 2) layout, the digest of its block
    of its worker's row of the one-process duals ``z`` (each leaf cut by
    ``dist.params.shard_leaf``, in sorted leaf order): what the rank's
    ``digest`` of its own (1, ...) blocks must read."""
    data, model = MODEL_AXIS
    mesh = rt.launch.mesh.abstract(MODEL_AXIS, ("data", "model"))
    out = []
    for r in range(data * model):
        coord = (r // model, r % model)
        rows = []
        for k in sorted(z):
            leaf = z[k][coord[0]]
            spec = rt.dist.params.param_spec(k, leaf.shape, mesh, None)
            rows += digest(torch, {k: rt.dist.params.shard_leaf(
                leaf, spec, mesh, coord)})
        out.append(as_json(rows))
    return out


def stack_rel(torch, got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every leaf of two (n, ...) dual
    stacks on the card, in fp64, in chunks."""
    num = den = 0.0
    step = 1 << 27
    for k, w in want.items():
        a, b = got[k].reshape(-1), w.reshape(-1)
        for i in range(0, b.numel(), step):
            x, y = a[i:i + step].double(), b[i:i + step].double()
            num += float(torch.sum((x - y) ** 2))
            den += float(torch.sum(y ** 2))
    return math.sqrt(num / max(den, 1e-300))


def model_report(label: str, rank: int, res: dict, session,
                 rounds: int) -> dict:
    g, tp = session.group, session.tp
    epochs = len(res["epoch_s"])
    row = {"peak_gib": res["peak_gib"], "epoch_s": res["epoch_s"],
           "losses": res["losses"], "launches": res["launches"],
           "sent_bytes_per_round": g.sent_bytes // rounds if rounds else 0,
           "staged_bytes_per_round": g.staged_bytes // rounds if rounds
           else 0,
           "gathered_bytes_per_epoch": tp.gathered_bytes // epochs,
           "scattered_bytes_per_epoch": tp.scattered_bytes // epochs}
    print(f"  rank {rank} (worker {g.worker}, model {g.m}) {label}: "
          + " ".join(f"{k}={v}" for k, v in row.items())
          + f" [{card_line()}]", flush=True)
    return row


def rank_model(torch, rt, dist, work: Path) -> None:
    """Four gloo ranks as (data 2, model 2), each worker spread over two
    ranks: ranks 0 and 1 run the one-process references first; then exact
    (FSDP x TP) and ring gossip (TP) through AMBSession, MESH_EPOCHS epochs
    each under deterministic algorithms; then quantized gossip: the
    consensus alone on a fixed stack (q8 and q4) and a gossip_q8 session;
    then every driver and option (``run_model_drivers``); then the train
    CLI (``--model 2``, exact, gossip and gossip_q8, at the smoke
    config)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract
    rank = dist.get_rank()
    data, model = MODEL_AXIS
    cfg = dataclasses.replace(rt.configs.get_config("qwen2-1.5b"),
                              num_layers=MODEL_LAYERS)
    out = {}
    lap = stamps("model-axis rank 0", rank)

    with deterministic(torch):
        refs = model_references(torch, rt, cfg, lap) if rank == 0 else None
        q8, coded = [None], None
        if rank == 1:
            lap1 = stamps("model-axis rank 1")
            q8[0] = model_q8_references(torch, rt, cfg, lap1)
            q8[0]["drivers"], coded = model_driver_references(torch, rt,
                                                              cfg, lap1)
        got = [None if refs is None else
               {k: refs[k]["losses"] for k in ("exact", "gossip")}]
        dist.broadcast_object_list(got, src=0)
        dist.broadcast_object_list(q8, src=1)
        lap("the references done")
        losses, q8 = dict(got[0], gossip_q8=q8[0]["losses"]), q8[0]
        mesh = rt.launch.mesh.make_host_mesh(data, model, device="cuda")

        session = mesh_session(rt, cfg, "exact", mesh, data, model=model)
        lap("the exact session built")
        res = mesh_epochs(torch, rt, session, "model-axis exact")
        lap("the exact epochs done")
        expect(f"model-axis exact rank {rank}", res["launches"],
               {"dual_update": 15 * MESH_EPOCHS})
        out["exact"] = model_report("exact", rank, res, session, 0)
        check_losses("model-axis exact", rank, res["losses"],
                     losses["exact"])
        lay = dryrun._layout(cfg, rt.configs.InputShape(
            "model_exact", SEQ, data * PER_WORKER, "train"),
            abstract(MODEL_AXIS, ("data", "model")))
        state = session.state
        held = {"param_bytes_per_rank": nbytes(state["params"]),
                "opt_state_bytes_per_rank": nbytes(state["opt"]["z"])
                + nbytes(state["opt"]["w0"])}
        for key, n in held.items():
            if n != lay[key]:
                fail(f"model-axis exact rank {rank}: {key} {n}, the "
                     f"dry-run's {lay[key]}")
        out["exact"].update(held)
        print(f"  rank {rank} exact: blocks {held['param_bytes_per_rank']} "
              f"B, fp32 z and w0 {held['opt_state_bytes_per_rank']} B: the "
              f"dry-run's per-rank figures to the byte", flush=True)
        same_replicated(torch, dist, session, state["params"], "exact")
        whole = session.params
        if rank == 0:
            ref = refs["exact"]
            errs = leaf_errs(torch, whole, ref["params"])
            out["exact"].update(param_errs=errs, moves=ref["moves"],
                                limits=ref["limits"],
                                limit_share=check_leaves(
                                    "exact", errs, ref["limits"]))
        del session, state, whole
        release(torch)
        lap("the exact checks done")

        session = mesh_session(rt, cfg, "gossip", mesh, data, model=model)
        lap("the gossip session built")
        res = mesh_epochs(torch, rt, session, "model-axis gossip")
        lap("the gossip epochs done")
        rounds = MESH_EPOCHS * GOSSIP_ROUNDS
        expect(f"model-axis gossip rank {rank}", res["launches"],
               {"gossip_combine": rounds, "dual_update": 15 * MESH_EPOCHS})
        out["gossip"] = model_report("gossip", rank, res, session, rounds)
        check_losses("model-axis gossip", rank, res["losses"],
                     losses["gossip"])
        z = session.state["z"]
        same_replicated(torch, dist, session, {k: v[0] for k, v in z.items()},
                        "gossip")
        errs = gossip_duals(torch, dist, session,
                            None if refs is None else refs["gossip"]["z"])
        if rank == 0:
            ref = refs["gossip"]
            share = check_leaves("gossip (each worker's dual, gathered "
                                 "over its model ranks)", errs,
                                 ref["limits"])
            out["gossip"].update(
                dual_errs={f"worker {i} {k}": e
                           for (i, k), e in errs.items()},
                moves=ref["moves"], limits=ref["limits"],
                limit_share=share)
        del session, z
        release(torch)
        lap("the gossip checks done")

        out["consensus"] = model_consensus_rank(torch, rt, dist, mesh, cfg,
                                                work)
        lap("the quantized consensus checks done")
        out["gossip_q8"] = run_model_q8(torch, rt, dist, mesh, cfg, losses,
                                        q8, lap)
        out.update(run_model_drivers(torch, rt, dist, mesh, cfg,
                                     q8["drivers"], coded, lap))
        del refs, coded
    release(torch)
    with deterministic(torch):
        for consensus in MODEL_CLI:
            rt.launch.train.main(MODEL_CLI_ARGV + [
                "--model", str(model), "--consensus", consensus,
                "--dist-backend", "gloo", "--metrics",
                str(work / f"cli_tp_{consensus}.jsonl")])
    lap("the train CLI done")
    (work / f"model_rank{rank}.json").write_text(json.dumps(out))


def run_model_q8(torch, rt, dist, mesh, cfg, losses: dict, ref, lap) -> dict:
    """The gossip_q8 session over (data 2, model 2), ring, DRIVER_ROUNDS,
    MESH_EPOCHS epochs, in MODEL_Q_DTYPE: the launches, one grid reduction
    and ``wire_bytes_per_round`` of the block a round, the losses within
    MESH_LOSS_TOL of the one-process session's, the replicated leaves
    equal on a worker's model ranks, each rank's dual block bit for bit
    its block of the one-process session under ``tp_sums`` (``ref``'s
    digests), and so the dual stack at the reference's own move from the
    plain one-process session's, within its limit."""
    rank = dist.get_rank()
    data, model = MODEL_AXIS
    session = mesh_session(rt, dataclasses.replace(cfg, dtype=MODEL_Q_DTYPE),
                           "gossip_q8", mesh, data, model=model,
                           rounds=DRIVER_ROUNDS["gossip_q8"])
    lap("the gossip_q8 session built")
    g = session.group
    res = mesh_epochs(torch, rt, session, "model-axis gossip_q8")
    lap("the gossip_q8 epochs done")
    strat = rt.dist.amb.strategy_from_config(session.protocol.amb, data)
    rounds = MESH_EPOCHS * strat.rounds
    width = session.tp.row_block().block_width
    wire = strat.wire_bytes_per_round(width)
    expect(f"model-axis gossip_q8 rank {rank}", res["launches"],
           {"stochastic_quantize": rounds, "quantized_combine": rounds,
            "dual_update": 15 * MESH_EPOCHS})
    row = model_report("gossip_q8", rank, res, session, rounds)
    row.update(block_width=width, wire_bytes_per_round=wire,
               grid_reductions=g.grid_reductions, rounds=rounds)
    if g.sent_bytes != rounds * wire or g.grid_reductions != rounds:
        fail(f"model-axis gossip_q8 rank {rank}: sent {g.sent_bytes} bytes "
             f"and {g.grid_reductions} grid reductions in {rounds} rounds; "
             f"wire_bytes_per_round({width}) {wire}")
    print(f"  rank {rank} model-axis gossip_q8: {g.sent_bytes // rounds} "
          f"bytes a round = wire_bytes_per_round(d_block {width}), one grid "
          f"reduction a round (fp32 would send {4 * width})", flush=True)
    check_losses("model-axis gossip_q8", rank, res["losses"],
                 losses["gossip_q8"])
    z = session.state["z"]
    same_replicated(torch, dist, session, {k: v[0] for k, v in z.items()},
                    "gossip_q8")
    if as_json(digest(torch, {k: v[0] for k, v in z.items()})) \
            != ref["digests"][rank]:
        fail(f"model-axis gossip_q8 rank {rank}: its dual block differs from "
             f"its block of the one-process session under tp_sums")
    # bit for bit the tp_sums session's, so the ranks' dual stack sits at
    # that session's distance from the plain one: the move itself
    err = ref["move"]
    row.update(stack_err=err, move=ref["move"], limit=ref["limit"])
    if rank == 0:
        print(f"  model-axis gossip_q8: every rank's dual block bit for bit "
              f"its block of the one-process session in the model ranks' "
              f"summation order (tp_sums); so the dual stack sits {err:.4g} "
              f"of its norm from the plain one-process session's; limit "
              f"{ref['limit']:.4g} ({MODEL_Q_FACTOR} x the reference's move, "
              f"at most {MODEL_Q_TOL}) [{card_line()}]", flush=True)
    if err > ref["limit"]:
        fail(f"model-axis gossip_q8: the dual stack is {err} from the "
             f"one-process session's, above its limit {ref['limit']}")
    del session, z
    release(torch)
    lap("the gossip_q8 checks done")
    return row


def model_driver_run(torch, rt, session, name: str, label: str) -> tuple:
    """One of MODEL_DRIVERS through ``driver_run``; for churn under the
    FailStop MODEL_CHURN, with the digest of this process's duals before
    the out epoch and after it.  Returns (the run, those digests)."""
    held, before, faults = {}, None, None
    epochs = MODEL_DRIVERS[name].get("epochs", DRIVER_EPOCHS)
    if name == "churn":
        epochs = MODEL_CHURN_EPOCHS
        faults = rt.faults.FaultInjector(rt.faults.FailStop(**MODEL_CHURN))

        def before(i):
            if i in (MODEL_CHURN["at"], MODEL_CHURN["until"]):
                held[i] = as_json(digest(torch, session.state["z"]))
    res = driver_run(torch, rt, session, label, epochs, before, faults)
    return res, held


def model_driver_references(torch, rt, cfg, lap) -> tuple:
    """Rank 1, after ``model_q8_references``, while rank 0 runs
    ``model_references``: the one-process data=2 twins of the model-axis
    drivers at DRIVER_LAYERS in MODEL_Q_DTYPE, under deterministic
    algorithms and ``tp_sums`` (the model ranks' summation order): each
    one's losses, b(t), launches, noise statistics and actions, and the
    digest of each rank's block of its duals; then coded exact, plain and
    under ``split_sums``: each leaf's limit (``order_limits``).  Returns
    (what the ranks read, coded exact's whole parameters in host memory,
    kept on rank 1)."""
    data = MODEL_AXIS[0]
    cfg = dataclasses.replace(cfg, num_layers=DRIVER_LAYERS,
                              dtype=MODEL_Q_DTYPE)
    refs = {}
    for name, case in MODEL_DRIVERS.items():
        with tp_sums(torch, rt):
            session = driver_session(rt, cfg, case, False, data=data)
            res, _ = model_driver_run(torch, rt, session, name,
                                      f"model-axis {name} reference")
        res["digests"] = block_digests(torch, rt, session.state["z"])
        refs[name] = res
        print(f"model-axis reference {name} ({DRIVER_LAYERS} layer, "
              f"{MODEL_Q_DTYPE}, one process, {data} workers, tp_sums): "
              f"losses {res['losses']} b(t) {res['batch']} epoch_s "
              f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
              f"{res['peak_gib']:.2f} launches {res['launches']} noise "
              f"{res['noise']} actions {res['actions']} [{card_line()}]",
              flush=True)
        del session
        release(torch)
        lap(f"the {name} reference done")
    session = driver_session(rt, cfg, MODEL_CODED, False, data=data)
    res = driver_run(torch, rt, session, "model-axis coded reference")
    coded = {"batch": res["batch"], "losses": res["losses"], "params": {
        k: v.detach().cpu() for k, v in session.params.items()}}
    del session
    release(torch)
    with split_sums(torch, rt):
        session = driver_session(rt, cfg, MODEL_CODED, False, data=data)
        driver_run(torch, rt, session, "model-axis coded, split sums")
    moves = leaf_errs(torch, session.params, coded["params"])
    coded["limits"] = check_order("coded exact", moves)
    del session
    release(torch)
    lap("the coded exact references done")
    refs["coded"] = {"batch": coded["batch"], "losses": coded["losses"]}
    return refs, coded


def model_driver_checks(torch, rt, dist, name, session, res, held,
                        want) -> dict:
    """A model-axis driver session's checks against its reference: the
    dual blocks bit for bit, b(t) equal and the losses within
    MESH_LOSS_TOL, the launches, the bytes a round (fp32: 4 d_block;
    gossip_q8: ``wire_bytes_per_round(d_block)`` and one grid reduction),
    churn's out worker's blocks unchanged, the controller's noise
    statistics and actions alike on every rank and the reference's.
    Returns the rank's row."""
    rank, g = dist.get_rank(), session.group
    label = f"model-axis {name} rank {rank}"
    width = session.tp.row_block().block_width
    strat = rt.dist.amb.strategy_from_config(
        dataclasses.replace(session.protocol.amb, active=None),
        MODEL_AXIS[0])
    count = {"dual_update": 15 * len(res["losses"])}
    if MODEL_DRIVERS[name]["consensus"] == "gossip_q8":
        rounds = want["launches"].get("stochastic_quantize", 0)
        count.update(stochastic_quantize=rounds, quantized_combine=rounds)
    else:
        rounds = res["launches"].get("gossip_combine", 0)
        settles = len(res["losses"]) + 1 if name == "pipelined" \
            else len(res["losses"]) - (name == "churn")
        count["gossip_combine"] = settles * strat.rounds
    expect(label, res["launches"], count)
    if not rounds:
        fail(f"{label}: no consensus round")
    wire = strat.wire_bytes_per_round(width)
    row = model_report(name, rank, res, session, rounds)
    row.update(block_width=width, wire_bytes_per_round=wire, rounds=rounds,
               grid_reductions=g.grid_reductions)
    if g.sent_bytes != rounds * wire:
        fail(f"{label}: sent {g.sent_bytes} bytes in {rounds} rounds; "
             f"wire_bytes_per_round({width}) {wire}")
    if "q8" not in MODEL_DRIVERS[name]["consensus"] and wire != 4 * width:
        fail(f"{label}: fp32 gossip's wire {wire} is not 4 x d_block")
    if g.grid_reductions != (rounds if "q8" in MODEL_DRIVERS[name][
            "consensus"] else 0):
        fail(f"{label}: {g.grid_reductions} grid reductions in {rounds} "
             f"rounds")
    if res["batch"] != want["batch"]:
        fail(f"{label}: b(t) {res['batch']} vs {want['batch']}")
    check_losses(f"model-axis {name}", rank, res["losses"], want["losses"])
    z = {k: v[0] for k, v in session.state["z"].items()}
    same_replicated(torch, dist, session, z, name)
    if as_json(digest(torch, z)) != want["digests"][rank]:
        fail(f"{label}: its dual block differs from its block of the "
             f"one-process session under tp_sums")
    if name == "churn":
        kept = held[MODEL_CHURN["at"]] == held[MODEL_CHURN["until"]]
        if kept != (g.worker in MODEL_CHURN["workers"]):
            fail(f"{label}: worker {g.worker}'s blocks "
                 f"{'stayed' if kept else 'moved'} in the epoch worker "
                 f"{MODEL_CHURN['workers']} was out")
        row["out_worker_blocks_unchanged"] = kept
    if MODEL_DRIVERS[name].get("controller"):
        same_on_every_rank(dist, res["noise"], f"{name} noise")
        same_on_every_rank(dist, res["actions"], f"{name} actions")
        for got, ref in zip(res["noise"], want["noise"]):
            for a, b in zip(got, ref):
                if abs(a - b) > DRIVER_NOISE_RTOL * abs(b):
                    fail(f"{label}: noise {res['noise']} vs the one-process "
                         f"{want['noise']}")
        if res["actions"] != want["actions"] or not any(res["actions"]):
            fail(f"{label}: actions {res['actions']} vs {want['actions']}")
        if any(res["actions"][:-1]) \
                or (res["actions"][-1] or {}).get("staleness") != 1:
            fail(f"{label}: actions {res['actions']}: D = 2 must hold "
                 f"through the last epoch, then fall to 1")
        row.update(noise=res["noise"], actions=res["actions"])
    print(f"  {label}: dual blocks bit for bit its blocks of the "
          f"one-process session under tp_sums; "
          f"{g.sent_bytes // rounds} bytes a round = wire_bytes_per_round("
          f"d_block {width})" + (f"; worker {g.worker}'s blocks kept in the "
                                 f"out epoch: {row['out_worker_blocks_unchanged']}"
                                 if name == "churn" else ""), flush=True)
    return row


def run_model_drivers(torch, rt, dist, mesh, cfg, refs, coded, lap) -> dict:
    """Every driver and option over (data 2, model 2) at DRIVER_LAYERS in
    MODEL_Q_DTYPE: the pipelined driver, the async driver at D = 2 on
    gossip_q8 with the controller, churn through a fault model (each
    against rank 1's twin under ``tp_sums``, ``model_driver_checks``),
    and coded exact (rank 1 holds the ranks' whole parameters against its
    plain twin within ``order_limits``; every rank's equal)."""
    rank = dist.get_rank()
    data, model = MODEL_AXIS
    cfg = dataclasses.replace(cfg, num_layers=DRIVER_LAYERS,
                              dtype=MODEL_Q_DTYPE)
    out = {}
    for name, case in MODEL_DRIVERS.items():
        session = driver_session(rt, cfg, case, mesh, data, model)
        lap(f"the {name} session built")
        res, held = model_driver_run(torch, rt, session, name,
                                     f"model-axis {name}")
        lap(f"the {name} epochs done")
        out[name] = model_driver_checks(torch, rt, dist, name, session, res,
                                        held, refs[name])
        del session
        release(torch)
        lap(f"the {name} checks done")
    session = driver_session(rt, cfg, MODEL_CODED, mesh, data, model)
    res = driver_run(torch, rt, session, "model-axis coded exact")
    lap("the coded exact epochs done")
    expect(f"model-axis coded exact rank {rank}", res["launches"],
           {"dual_update": 15 * DRIVER_EPOCHS})
    out["coded"] = model_report("coded exact", rank, res, session, 0)
    if res["batch"] != refs["coded"]["batch"]:
        fail(f"model-axis coded exact rank {rank}: b(t) {res['batch']} vs "
             f"{refs['coded']['batch']}")
    check_losses("model-axis coded exact", rank, res["losses"],
                 refs["coded"]["losses"])
    same_replicated(torch, dist, session, session.state["params"], "exact")
    whole = session.params
    same_on_every_rank(dist, digest(torch, whole), "coded exact parameters")
    if rank == 1:
        errs = leaf_errs(torch, whole, coded["params"])
        share = check_leaves("coded exact (rho 2)", errs, coded["limits"])
        out["coded"].update(param_errs=errs, limits=coded["limits"],
                            limit_share=share)
    del session, whole
    release(torch)
    lap("the coded exact checks done")
    return out


def nbytes(tree: dict) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


def check_losses(label: str, rank: int, got: list, want: list) -> None:
    for g, w in zip(got, want):
        if abs(g - w) > MESH_LOSS_TOL * abs(w):
            fail(f"{label} rank {rank}: loss {g} vs the one-process {w}")


def same_replicated(torch, dist, session, blocks: dict, label: str) -> None:
    """The replicated leaves (norms, biases) equal bit for bit on the
    model ranks of each worker (exact: on every rank)."""
    specs = session.tp.specs
    mine = digest(torch, {k: v for k, v in blocks.items()
                          if specs[k] == ()})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    g = session.group
    peers = range(len(every)) if label == "exact" else range(
        g.worker * g.model, (g.worker + 1) * g.model)
    if any(every[r] != mine for r in peers):
        fail(f"model-axis {label}: replicated leaves differ across ranks")


def gossip_duals(torch, dist, session, ref_z) -> dict:
    """Each worker's dual gathered over its model ranks, one leaf at a
    time; the workers' model-0 ranks send theirs to rank 0, which returns
    by (worker, leaf) max |got - ref| over max |ref| (others: {})."""
    g, tp = session.group, session.tp
    errs = {}
    for k, zl in session.state["z"].items():
        row = tp.whole({k: zl[0]})[k]
        if g.m == 0 and g.worker > 0:
            dist.send(row.cpu(), dst=0)
        if dist.get_rank() != 0:
            continue
        for i in range(g.n):
            if i:
                buf = torch.empty(row.shape, dtype=row.dtype)
                dist.recv(buf, src=g.rank_of(i) - g.m)
                row = buf.to(zl.device)
            errs[(i, k)] = leaf_errs(torch, {k: row},
                                     {k: ref_z[k][i]})[k]
        del row
    return errs


def model_stack_row(torch, worker: int, width: int):
    """Worker ``worker``'s (1, W + 1) row of the fixed message stack of
    phase 16's consensus check: N(0, 9) fp32 from its own generator on
    the card, so that a rank makes its worker's row alone."""
    gen = torch.Generator(device="cuda").manual_seed(MODEL_STACK_SEED
                                                     + worker)
    return torch.randn((1, width), generator=gen, device="cuda").mul_(3.0)


def model_shapes(rt, cfg) -> dict:
    """Every leaf's whole shape at ``cfg`` (nothing is allocated)."""
    from repro_torch.models.common import MetaGenerator
    return {k: tuple(v.shape) for k, v in
            rt.models.init_params(cfg, MetaGenerator()).items()}


def model_consensus_digests(torch, rt, cfg, work: Path) -> dict:
    """The parent, before the ranks: the stacked ``QuantizedGossipConsensus
    .combine`` of the fixed (2, W + 1) stack on a ring of 2 workers, q8 and
    q4 at DRIVER_ROUNDS under ``epoch_draws(MODEL_STACK_SEED, 0)`` on the
    card, and the digest of each rank's block of the result (its block
    of its worker's row, cut by ``dist.tp.row_block`` on the (2, 2)
    layout).  Written to ``model_consensus.json``."""
    data, model = MODEL_AXIS
    mesh = rt.launch.mesh.abstract(MODEL_AXIS, ("data", "model"))
    shapes = model_shapes(rt, cfg)
    blocks = [rt.dist.tp.row_block(shapes, mesh, (r // model, r % model))
              for r in range(data * model)]
    width = blocks[0].width
    out = {}
    for name in MODEL_Q:
        strat = rt.dist.consensus.make_strategy(name, data,
                                                rounds=DRIVER_ROUNDS[name])
        stack = torch.cat([model_stack_row(torch, i, width)
                           for i in range(data)])
        t0 = time.perf_counter()
        agreed = strat.combine(stack, rt.dist.consensus.epoch_draws(
            MODEL_STACK_SEED, 0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rows = []
        for r, blk in enumerate(blocks):
            row = torch.empty((blk.block_width,), device="cuda")
            rows.append(digest(torch, blk.take(agreed[r // model], row)))
            del row
        out[name] = {"digests": rows, "rounds": strat.rounds,
                     "block_widths": [b.block_width for b in blocks]}
        print(f"model-axis consensus reference {name}: the stacked combine "
              f"on (2, {width}), ring, {strat.rounds} rounds, "
              f"{secs:.3f} s; each rank's block of it digested (block "
              f"rows {out[name]['block_widths']}) [{card_line()}]",
              flush=True)
        del stack, agreed
        release(torch)
    (work / "model_consensus.json").write_text(json.dumps(out))
    return out


def model_consensus_rank(torch, rt, dist, mesh, cfg, work: Path) -> dict:
    """A rank's ``combine_rank`` of its block of the fixed stack over
    (data 2, model 2), q8 and q4: its rows' digest equal to the parent's
    digest of its block of the stacked combine, ``wire_bytes_per_round``
    of the block sent a round, and per round one ``stochastic_quantize``
    launch, one ``quantized_combine`` launch and one grid reduction."""
    rank = dist.get_rank()
    want = json.loads((work / "model_consensus.json").read_text())
    group = rt.dist.group.WorkerGroup(mesh, mesh.device_type)
    tp = rt.dist.tp.TensorParallel(group, model_shapes(rt, cfg), None, cfg)
    block = tp.row_block()
    whole = model_stack_row(torch, group.worker, block.width)
    mine = torch.empty((1, block.block_width), device="cuda")
    block.take(whole[0], mine[0])
    del whole
    out = {}
    for name in MODEL_Q:
        strat = rt.dist.consensus.make_strategy(name, MODEL_AXIS[0],
                                                rounds=DRIVER_ROUNDS[name])
        buf = mine.clone()
        sent, staged = group.sent_bytes, group.staged_bytes
        grids = group.grid_reductions
        rt.kernels.router.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = strat.combine_rank(buf, group, draws=rt.dist.consensus.
                                 epoch_draws(MODEL_STACK_SEED, 0),
                                 block=block)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = rt.kernels.router.launches()
        rounds = strat.rounds
        row = {"seconds": secs, "rounds": rounds, "launches": launches,
               "block_width": block.block_width,
               "sent_bytes_per_round": (group.sent_bytes - sent) // rounds,
               "staged_bytes_per_round":
                   (group.staged_bytes - staged) // rounds,
               "wire_bytes_per_round":
                   strat.wire_bytes_per_round(block.block_width),
               "grid_reductions": group.grid_reductions - grids,
               "digest": as_json(digest(torch, got[0]))}
        print(f"  rank {rank} (worker {group.worker}, model {group.m}) "
              f"model-axis consensus {name}: " + " ".join(
                  f"{k}={v}" for k, v in row.items())
              + f"; the parent's digest of this block "
              f"{want[name]['digests'][rank]} [{card_line()}]", flush=True)
        if row["digest"] != want[name]["digests"][rank]:
            fail(f"model-axis consensus {name} rank {rank}: its rows differ "
                 f"from its block of the stacked combine")
        if group.sent_bytes - sent != rounds * row["wire_bytes_per_round"]:
            fail(f"model-axis consensus {name} rank {rank}: sent "
                 f"{group.sent_bytes - sent} bytes in {rounds} rounds, "
                 f"wire_bytes_per_round {row['wire_bytes_per_round']}")
        if row["grid_reductions"] != rounds:
            fail(f"model-axis consensus {name} rank {rank}: "
                 f"{row['grid_reductions']} grid reductions in {rounds} "
                 f"rounds")
        expect(f"model-axis consensus {name} rank {rank}", launches,
               {"stochastic_quantize": rounds, "quantized_combine": rounds})
        out[name] = row
        del buf, got
        release(torch)
    del mine
    release(torch)
    print(f"  rank {rank} model-axis consensus: q8 and q4 rows bit for bit "
          f"its block of the stacked combine's", flush=True)
    return out


def time_dual_update_shard(torch, ops, full, beta: float) -> dict:
    """The prox at an exact rank's largest block on (2, 2) (the embed's,
    (V/2, d/2)) beside the whole leaf, fp32 z and w0 (dual averaging's
    state), in one call."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for label, shape in (("whole", (full.vocab_size, full.d_model)),
                         ("block", (full.vocab_size // MODEL_AXIS[1],
                                    full.d_model // MODEL_AXIS[0]))):
        n = math.prod(shape)
        z = torch.randn(shape, generator=gen, device="cuda")
        w0 = torch.randn(shape, generator=gen, device="cuda")
        k_ms = time_ms(torch, lambda: ops.dual_update(z, w0, beta,
                                                      force="kernel"),
                       50, f"dual_update {label}")
        p_ms = time_ms(torch, lambda: ops.dual_update(z, w0, beta,
                                                      force="ref"),
                       10, f"dual_update {label} plain")
        b_ms, b_by = bound(12 * n, 2 * n)
        out[label] = dict(shape=f"{shape} fp32", ms=k_ms, plain_ms=p_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"dual_update at the model-axis {label} {shape} fp32: ms="
              f"{k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}) [{card_line()}]", flush=True)
        del z, w0
    release(torch)
    return out


def model_before(torch, rt, full, work: Path) -> dict:
    """Phase 16 before the gloo ranks: the one-process CLIs and the
    consensus references (``model_consensus_digests``)."""
    lap = stamps("phase 16")
    cfg = dataclasses.replace(full, num_layers=MODEL_LAYERS)
    with deterministic(torch):
        for consensus in MODEL_CLI:
            rt.launch.train.main(MODEL_CLI_ARGV + [
                "--consensus", consensus, "--metrics",
                str(work / f"cli_one_{consensus}.jsonl")])
        lap("the one-process CLIs done")
        digests = model_consensus_digests(torch, rt, cfg, work)
    release(torch)
    lap("the consensus references done")
    return digests


def model_after(torch, rt, ops, full, beta: float, work: Path,
                digests: dict, phase14: dict) -> dict:
    """Phase 16 after the gloo ranks (``rank_model``, as (data 2, model
    2)): the CLI's losses held, the ranks' peaks beside phase 14's data=4
    ranks' (``phase14``: by kind, whole parameters), and the prox and the
    quantized kernels at the ranks' blocks.  Returns the ranks' launch
    counts and numbers."""
    lap = stamps("phase 16")
    ranks = [json.loads((work / f"model_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    cli = {}
    for consensus in MODEL_CLI:
        one, tp = ([json.loads(x)["loss"] for x in
                    (work / f"cli_{kind}_{consensus}.jsonl")
                    .read_text().splitlines()]
                   for kind in ("one", "tp"))
        print(f"model-axis train CLI (smoke, {consensus}): one process "
              f"--data 2 {one}, four ranks --data 2 --model 2 {tp}",
              flush=True)
        if len(one) != MESH_EPOCHS or len(tp) != MESH_EPOCHS or any(
                abs(a - b) > MESH_LOSS_TOL * abs(b)
                for a, b in zip(tp, one)):
            fail(f"model-axis train CLI {consensus}: {tp} vs {one}")
        cli[consensus] = {"one": one, "ranks": tp}
    for kind in MODEL_KINDS:
        peaks = [r[kind]["peak_gib"] for r in ranks]
        layers = MODEL_LAYERS if kind in ("exact", "gossip", "gossip_q8") \
            else DRIVER_LAYERS
        print(f"model-axis {kind} ({layers} layers, (data 2, "
              f"model 2)): peaks GiB {[round(p, 2) for p in peaks]}, "
              f"sum {sum(peaks):.2f}; phase 14's data=4 ranks (whole "
              f"parameters): exact at {MESH_EXACT_LAYERS} layers "
              f"{[round(p, 2) for p in phase14['exact']]}, gossip at "
              f"{MESH_GOSSIP_LAYERS} "
              f"{[round(p, 2) for p in phase14['gossip']]} "
              f"[{card_line()}]", flush=True)
        if sum(peaks) > MESH_PEAK_SUM_GIB:
            fail(f"model-axis {kind}: the ranks' peaks sum to "
                 f"{sum(peaks):.2f} GiB")
    shard = time_dual_update_shard(torch, ops, full, beta)
    block = time_quantized_block(
        torch, rt, ops, max(digests["gossip_q8"]["block_widths"]))
    lap("the kernels timed at the blocks")
    launches = {f"model-axis {kind} rank {r}": res[kind]["launches"]
                for r, res in enumerate(ranks) for kind in MODEL_KINDS}
    return {"launches": launches, "ranks": ranks, "cli": cli,
            "dual_update": shard, **block}


# ---------------------------------------------------------------------------
# Serving over a (data, model) group, checkpoints at model > 1 (phase 17)
# ---------------------------------------------------------------------------

# the slot engine over (data 2, model 2) at qwen2-1.5b's full width and
# depth (28 layers, bf16), serve only and greedy: 8 requests of 2048 +-
# 512 prompt tokens and 32 new ones, all arriving at once, into 8 slots,
# so each worker prefills 4 (a request's 28 flash calls on its ranks at
# B 1, H 6, KV 1, hd 128) and decodes its 4 rows
SERVE17 = dict(requests=8, new=32, slots=8, prompt=2048, jitter=512,
               seed=17, budget=0.25)
SERVE17_CACHE = SERVE17["prompt"] + SERVE17["jitter"] + SERVE17["new"]
FLASH_RANK = dict(b=1, h=6, kv=1, hd=128)      # a model rank's prefill heads
FLASH_RANK_SEQS = (2048, 2560)
# the serve CLI under the launch, with a fine-tune session over the same
# ranks: qwen2-1.5b width cut to SERVE17_CLI_LAYERS (the CLI has no depth
# flag: its session gets the cut config), two requests 2 s apart, so that
# the idle time after the first absorbs a fine-tune epoch (an epoch took
# 3.2 to 8.1 s on an H100, past the second arrival, so one is absorbed
# where three requests 4 s apart absorbed two, 15 s more of the command
# for both runs), and a round budget that holds two
SERVE17_CLI_LAYERS = 1
SERVE17_CLI_ARGV = ["--arch", "qwen2-1.5b", "--data", "2", "--model", "2",
                    "--batch", "4", "--requests", "2", "--prompt-len", "512",
                    "--new-tokens", "8", "--arrival-gap", "2.0",
                    "--round-budget", "30", "--finetune", "2",
                    "--dist-backend", "gloo"]
SERVE17_CLI = ("exact", "gossip")
# checkpoints at model 2, at the smoke config in MODEL_Q_DTYPE (the next
# epoch is held bit for bit under tp_sums, as phase 16's drivers are):
# exact (FSDP x TP blocks of the parameters, z and w0) and async gossip at
# D 2 (dual rows, the queue's in-flight payloads and their snapshots)
SERVE17_CKPT = {"exact": dict(consensus="exact"),
                "async": dict(consensus="gossip", async_epochs=True,
                              staleness=2)}


def check_flash_rank(torch, ops, flash, shape=FLASH_RANK,
                     seqs=FLASH_RANK_SEQS,
                     what="qwen2-1.5b over (data 2, model 2)") -> list:
    """The flash kernel at a model rank's prefill shape (default over
    (data 2, model 2): qwen2-1.5b's 12 query and 2 KV heads split in two,
    so one KV head, GQA group 6, hd 128; causal; S 2048 and 2560), on the
    tensor-core body; library: SDPA with ``is_causal`` and
    ``enable_gqa``."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, kv, hd = (shape[x] for x in ("b", "h", "kv", "hd"))
    entries = []
    for s in seqs:
        q, k, v = model_layout(torch, gen, b, s, s, h, kv, hd,
                               torch.bfloat16)
        if flash.body(q, k, v) != "tensor_core":
            fail(f"flash_attention a model rank's S={s}: not the tensor "
                 f"cores")
        entries.append(flash_entry(
            torch, ops, q, k, v, 0,
            f"B={b} H={h} KV={kv} hd={hd} S={s} bf16 causal (a model rank "
            f"of {what})",
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            reps=200))
        del q, k, v
    release(torch)
    return entries


def serve17_requests(rt, cfg) -> list:
    return rt.serve.synthetic_requests(
        SERVE17["requests"], vocab_size=cfg.vocab_size,
        prompt_len=SERVE17["prompt"], prompt_jitter=SERVE17["jitter"],
        max_new_tokens=SERVE17["new"], seed=SERVE17["seed"])


def first_logits(torch, rt, params, cfg, reqs) -> list:
    """Each request's first-token logits: its bucketed batch-1 prefill, as
    the slot engine runs it (host fp32)."""
    out = []
    for r in reqs:
        bucket = rt.serve.bucket_len(r.prompt_len, SERVE17_CACHE,
                                     exact=False)
        toks = torch.tensor([r.prompt + [0] * (bucket - r.prompt_len)],
                            dtype=torch.long, device="cuda")
        logits, _ = rt.models.prefill(params, cfg, {"tokens": toks},
                                      extra_capacity=SERVE17_CACHE - bucket,
                                      last_pos=r.prompt_len - 1)
        out.append(logits.float().cpu())
        del logits
    return out


def serve_references(torch, rt, full, work: Path) -> dict:
    """Phase 17's references, in the parent while the gloo ranks run
    phases 14 to 16: at qwen2-1.5b's full width from SERVE17's seed, the
    plain one-process slot engine (8 slots: the greedy tokens, each
    request's first-token logits), the prefills again under
    ``split_sums`` (each request's move sets its limit,
    ``order_limits``), and the one-process twin of the ranks under
    ``rank_twin`` (the tokens the ranks must give); then the one-process
    checkpoints the ranks restore (SERVE17_CKPT, one epoch each, saved).
    Writes them for the ranks."""
    lap = stamps("phase 17 references")
    data = MODEL_AXIS[0]
    gen = torch.Generator(device="cuda").manual_seed(SERVE17["seed"])
    params = rt.models.init_params(full, gen)
    reqs = serve17_requests(rt, full)
    engine = rt.serve.SlotEngine(params, full, slots=SERVE17["slots"],
                                 cache_len=SERVE17_CACHE)
    drain(engine, reqs)
    plain_tokens = [r.out_tokens for r in reqs]
    del engine
    release(torch)
    plain = first_logits(torch, rt, params, full, reqs)
    with split_sums(torch, rt):
        split = first_logits(torch, rt, params, full, reqs)
    moves = {r.rid: leaf_errs(torch, {"x": s}, {"x": p})["x"]
             for r, s, p in zip(reqs, split, plain)}
    limits = order_limits(moves)
    print("phase 17 reference: each request's first-token logits under "
          "split row-parallel sums, their move over max |logits| (its "
          "limit): " + ", ".join(f"{k} {m:.3g} ({limits[k]:.3g})"
                                 for k, m in moves.items()), flush=True)
    lap("the plain engine and the split prefills done")
    twin = serve17_requests(rt, full)
    with rank_twin(torch, rt, full, MODEL_AXIS[1], data):
        engine = rt.serve.SlotEngine(params, full, slots=SERVE17["slots"],
                                     cache_len=SERVE17_CACHE)
        drain(engine, twin)
        del engine
    twin_tokens = [r.out_tokens for r in twin]
    differ = sum(a != b for x, y in zip(twin_tokens, plain_tokens)
                 for a, b in zip(x, y))
    print(f"phase 17 reference: the ranks' one-process twin (rank_twin, "
          f"each worker's rows a round alone) differs from the plain engine in "
          f"{differ} of {sum(map(len, plain_tokens))} greedy tokens",
          flush=True)
    del params
    release(torch)
    lap("the twin done")
    cfg = dataclasses.replace(rt.configs.smoke_config("qwen2-1.5b"),
                              dtype=MODEL_Q_DTYPE)
    with deterministic(torch):
        for kind, case in SERVE17_CKPT.items():
            session = driver_session(rt, cfg, case, False, data=data,
                                     model=MODEL_AXIS[1])
            session.run(1, prefetch=0)
            session.save(work / f"ck_one_{kind}")
            del session
    release(torch)
    lap("the one-process checkpoints saved")
    refs = {"plain_tokens": plain_tokens, "plain_first": plain,
            "moves": moves, "limits": limits, "twin_tokens": twin_tokens}
    torch.save(refs, work / "serve_refs.pt")
    return refs


class EngineProbe:
    """Instruments a slot engine over a group (phases 17 and 18): per
    request the flash launches by body and, on its owner, the prefill
    seconds (``current`` is the request being inserted); per decode round
    its ms and the growth of each of ``counters()``'s byte counters;
    while ``watch()`` is open, the (B, H, KV, hd) of every flash call and
    the launch counts from zero."""

    def __init__(self, torch, rt, engine, counters):
        self.router, self.kops = rt.kernels.router, rt.models.attention.kops
        self.engine, self.counters = engine, counters
        self.current, self.prefill_s, self.flashes = None, [], {}
        self.round_ms, self.moved, self.shapes = [], [], set()
        insert, decode = engine.insert, engine.decode_round

        def timed_insert(req):
            self.current = req.rid
            before = self.router.launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = insert(req)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = self.router.launches()
            self.flashes[req.rid] = {k: after.get(k, 0) - before.get(k, 0)
                                     for k in ("flash_attention.tensor_core",
                                               "flash_attention.cuda_core")}
            if engine._mine(req.slot):
                self.prefill_s.append(dt)
            self.current = None
            return out

        def timed_round():
            c0 = counters()
            t0 = time.perf_counter()
            out = decode()
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
            self.moved.append([b - a for a, b in zip(c0, counters())])
            return out

        engine.insert, engine.decode_round = timed_insert, timed_round

    @contextlib.contextmanager
    def watch(self):
        flash = self.kops.flash_attention

        def seen(q, k, v, **kw):
            self.shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[3]))
            return flash(q, k, v, **kw)

        self.kops.flash_attention = seen
        self.router.reset_launches()
        try:
            yield
        finally:
            self.kops.flash_attention = flash

    def check_flash(self, label: str, reqs, per_req: int, shape: dict,
                    launches: dict) -> int:
        """Each request's ``per_req`` tensor-core flash launches on its
        owner's ranks (none elsewhere), all at the rank's ``shape``;
        returns the requests this rank's worker owns."""
        mine = self.engine._mine
        for r in reqs:
            want = per_req if mine(r.slot) else 0
            if self.flashes[r.rid] != {"flash_attention.tensor_core": want,
                                       "flash_attention.cuda_core": 0}:
                fail(f"{label}: request {r.rid} (slot {r.slot}) launched "
                     f"{self.flashes[r.rid]}, expected {want} on the "
                     f"tensor cores")
        owned = sum(mine(r.slot) for r in reqs)
        expect(label, launches, {"flash_attention": per_req * owned,
                                 "flash_attention.tensor_core":
                                 per_req * owned})
        rank_shape = tuple(shape[x] for x in ("b", "h", "kv", "hd"))
        if owned and self.shapes != {rank_shape}:
            fail(f"{label}: flash called at (B, H, KV, hd) {self.shapes}, "
                 f"expected {rank_shape}")
        return owned

    def rounds(self) -> dict:
        """The decode round's ms (p50, p99) and each counter's median
        growth a round."""
        ms = sorted(self.round_ms)
        pct = sys.modules["repro_torch.serve.metrics"]._pct
        mid = [sorted(c)[len(c) // 2] for c in zip(*self.moved)]
        return {"decode_rounds": len(ms), "round_ms_p50": pct(ms, 50),
                "round_ms_p99": pct(ms, 99), "bytes_per_round": mid}


def rank_serve_only(torch, rt, dist, full, refs, lap) -> dict:
    """The slot engine alone over (data 2, model 2) at full width (through
    the scheduler on rank 0's wall clock, no session): each rank's blocks
    from SERVE17's seed (``init_shards``, the serving layout), the greedy
    tokens equal to the twin's, each first-token logits within its
    limit of the plain engine's, 28 tensor-core flash launches a request
    on its worker's ranks and none elsewhere; per rank the prefill
    seconds, the decode round's ms and bytes summed over "model", the
    peak."""
    rank = dist.get_rank()
    router = rt.kernels.router
    mesh = rt.launch.mesh.make_host_mesh(*MODEL_AXIS, device="cuda")
    group = rt.dist.group.WorkerGroup(mesh, "cuda")
    shapes = {k: v.shape for k, v in rt.models.init_params(
        full, rt.models.common.MetaGenerator()).items()}
    tp = rt.dist.tp.TensorParallel(group, shapes, None, full)
    gen = torch.Generator(device="cuda").manual_seed(SERVE17["seed"])
    params = rt.dist.params.init_shards(full, gen, mesh,
                                        mesh.get_coordinate(), None)
    lap("the serving blocks drawn")
    torch.cuda.reset_peak_memory_stats()
    engine = rt.serve.SlotEngine(params, full, slots=SERVE17["slots"],
                                 cache_len=SERVE17_CACHE, group=group, tp=tp)
    probe = EngineProbe(torch, rt, engine, lambda: (tp.reduced_bytes,))
    firsts, sample = {}, engine._sample

    def spy(logits):
        if probe.current is not None:
            firsts[probe.current] = logits.float().cpu()
        return sample(logits)

    engine._sample = spy
    reqs = serve17_requests(rt, full)
    queue = rt.serve.RequestQueue(rt.serve.AdmissionPolicy(
        cache_len=SERVE17_CACHE))
    for r in reqs:
        queue.push(r)
    with probe.watch():
        report = rt.serve.ServeScheduler(
            engine, queue, round_budget_s=SERVE17["budget"]).run()
    launches = router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap("the requests served")
    label = f"phase 17 serve rank {rank}"
    tokens = [r.out_tokens for r in reqs]
    if tokens != refs["twin_tokens"]:
        fail(f"{label}: greedy tokens differ from the one-process twin's "
             f"(rank_twin): {tokens} vs {refs['twin_tokens']}")
    if any(len(t) != SERVE17["new"] for t in tokens):
        fail(f"{label}: {[len(t) for t in tokens]} tokens a request")
    errs = {r.rid: leaf_errs(torch, {"x": firsts[r.rid]},
                             {"x": refs["plain_first"][r.rid]})["x"]
            for r in reqs}
    share = check_leaves(f"serve rank {rank}, each request's first-token "
                         f"logits", errs, refs["limits"])
    differ = sum(a != b for x, y in zip(tokens, refs["plain_tokens"])
                 for a, b in zip(x, y))
    per_req = full.num_layers
    owned = probe.check_flash(label, reqs, per_req, FLASH_RANK, launches)
    rank_shape = tuple(FLASH_RANK[x] for x in ("b", "h", "kv", "hd"))
    rounds = probe.rounds()
    s = report.summary
    row = {"owned": owned, "flash_per_request": per_req,
           "prefill_s": probe.prefill_s,
           "decode_rounds": rounds["decode_rounds"],
           "round_ms_p50": rounds["round_ms_p50"],
           "round_ms_p99": rounds["round_ms_p99"],
           "reduced_bytes_per_round": rounds["bytes_per_round"][0],
           "peak_gib": peak, "ttft_p50_s": s["ttft_p50_s"],
           "ttft_p99_s": s["ttft_p99_s"], "tpot_p50_s": s["tpot_p50_s"],
           "tpot_p99_s": s["tpot_p99_s"], "tokens_per_s": s["tokens_per_s"],
           "tokens_differing_from_plain": differ, "limit_share": share,
           "launches": launches}
    print(f"  {label} (worker {group.worker}, model {group.m}): greedy "
          f"tokens equal to the twin's; {differ} of "
          f"{sum(map(len, tokens))} differ from the plain engine's; "
          f"flash {per_req} a request on the tensor cores at (B, H, KV, "
          f"hd) {rank_shape} x {owned} requests; prefill_s "
          f"{[round(x, 4) for x in probe.prefill_s]}; decode "
          f"rounds {row['decode_rounds']}, ms p50 {row['round_ms_p50']:.2f} p99 "
          f"{row['round_ms_p99']:.2f}; {row['reduced_bytes_per_round']} "
          f"bytes summed over \"model\" a round; TTFT p50 "
          f"{s['ttft_p50_s']:.4f} p99 "
          f"{s['ttft_p99_s']:.4f} s, TPOT p50 {s['tpot_p50_s']:.4f} p99 "
          f"{s['tpot_p99_s']:.4f} s; peak_GiB {peak:.2f} [{card_line()}]",
          flush=True)
    del engine, params
    return row


def rank_serve_cli(torch, rt, dist, consensus: str, lap) -> dict:
    """The serve CLI under the launch with ``--finetune 2``
    (SERVE17_CLI_ARGV, its session at qwen2-1.5b width cut to
    SERVE17_CLI_LAYERS): after each absorbed epoch the engine's
    parameters bit for bit this rank's blocks of ``session.params``;
    every idle stretch absorbs an epoch; the launches on this rank's
    blocks (exact: ``dual_update`` 15 an epoch; gossip: 15 for the
    engine's first primal and 45 an epoch, the step's, the engine's
    primal and the check's; ``gossip_combine`` r an epoch on a (2, 1)
    table; flash, the cut depth a request its worker owns)."""
    from repro_torch.launch import serve as serve_cli
    rank = dist.get_rank()
    router = rt.kernels.router
    sched_mod = sys.modules["repro_torch.serve.scheduler"]
    session_mod = sys.modules["repro_torch.api.session"]
    cut = dataclasses.replace(rt.configs.get_config("qwen2-1.5b"),
                              num_layers=SERVE17_CLI_LAYERS)
    real_config, train = session_mod.get_config, \
        sched_mod.ServeScheduler._train_once
    held, epoch_s = [], []

    def checked(self, deadline):
        t0 = time.perf_counter()
        ran = train(self, deadline)
        if ran:
            epoch_s.append(time.perf_counter() - t0)
            mesh = self.session.mesh
            want = rt.dist.params.shard_tree(
                self.session.params, mesh, mesh.get_coordinate(), None)
            held.append(all(torch.equal(self.engine.params[k], v)
                            for k, v in want.items()))
        return ran

    session_mod.get_config = lambda name: cut
    sched_mod.ServeScheduler._train_once = checked
    router.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        report = serve_cli.main(SERVE17_CLI_ARGV
                                + ["--consensus", consensus])
    finally:
        session_mod.get_config = real_config
        sched_mod.ServeScheduler._train_once = train
    wall = time.perf_counter() - t0
    launches = router.launches()
    label = f"phase 17 serve CLI {consensus} rank {rank}"
    epochs = report.train_epochs
    gaps = [g for g in idle_gaps(report.requests) if g > IDLE_MIN_S]
    if gaps and epochs < 1:
        fail(f"{label}: {len(gaps)} idle stretches absorbed no epoch")
    if held != [True] * epochs:
        fail(f"{label}: after the absorbed epochs the engine's parameters "
             f"were its blocks of session.params: {held}")
    per = int(SERVE17_CLI_ARGV[SERVE17_CLI_ARGV.index("--batch") + 1]) \
        // MODEL_AXIS[0]
    worker = rank // MODEL_AXIS[1]
    owned = sum(r.slot // per == worker for r in report.requests)
    want = {"flash_attention.tensor_core": SERVE17_CLI_LAYERS * owned,
            "flash_attention.cuda_core": 0}
    if consensus == "exact":
        want["dual_update"] = 15 * epochs
    else:
        want["dual_update"] = 15 * (1 + 3 * epochs)
        want["gossip_combine"] = GOSSIP_ROUNDS * epochs
    expect(label, launches, want)
    if any(len(r.out_tokens) != 8 for r in report.requests):
        fail(f"{label}: {[len(r.out_tokens) for r in report.requests]} "
             f"tokens a request")
    row = {"epochs": epochs, "held": held, "epoch_s": epoch_s,
           "wall_s": wall, "idle_stretches": len(gaps),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    print(f"  {label}: fine-tune epochs absorbed {epochs} (engine blocks bit "
          f"for bit the session's after each: {held}), epoch_s "
          f"{[round(x, 3) for x in epoch_s]}, idle stretches {len(gaps)}, "
          f"wall_s {wall:.1f}, launches {launches}, peak_GiB "
          f"{row['peak_gib']:.2f} [{card_line()}]", flush=True)
    lap(f"the serve CLI ({consensus}) done")
    return row


def rank_serve_ckpt(torch, rt, dist, work: Path, lap) -> dict:
    """Checkpoints at model 2 (SERVE17_CKPT, the smoke config): each rank
    restores the parent's one-process archive, saves it (``ck_back``),
    restores its own save (the state read back bit for bit, block for
    block), then takes one epoch and a flush under deterministic
    algorithms; the parent holds that epoch (``serve_after``).  Save and
    restore GB/s of the archive."""
    rank = dist.get_rank()
    cfg = dataclasses.replace(rt.configs.smoke_config("qwen2-1.5b"),
                              dtype=MODEL_Q_DTYPE)
    out = {}
    for kind in SERVE17_CKPT:
        label = f"phase 17 checkpoint {kind} rank {rank}"
        session = rt.api.AMBSession.restore(work / f"ck_one_{kind}", cfg=cfg,
                                            device="cuda")
        before = as_json(digest(torch, session.state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.save(work / f"ck_back_{kind}")
        save_s = time.perf_counter() - t0
        del session
        release(torch)
        t0 = time.perf_counter()
        back = rt.api.AMBSession.restore(work / f"ck_back_{kind}", cfg=cfg,
                                         device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if as_json(digest(torch, back.state)) != before:
            fail(f"{label}: the state read back is not the state saved")
        nbytes = dir_bytes(work / f"ck_back_{kind}")
        with deterministic(torch):
            m = back.run(1, prefetch=0)
            back.flush()
        row = {"loss": m["loss"], "bytes": nbytes, "save_s": save_s,
               "restore_s": restore_s, "steps": back.steps_done}
        if kind == "exact":
            whole = back.params
            if rank == 0:
                torch.save({k: v.detach().cpu() for k, v in whole.items()},
                           work / "ck_exact_params.pt")
            del whole
        else:
            row["digest"] = as_json(digest(torch, {
                k: v[0] for k, v in back.state["z"].items()}))
        print(f"  {label}: the state read back bit for bit, block for "
              f"block; {nbytes} B, save {save_s:.3f} s "
              f"({nbytes / save_s / 1e9:.3f} GB/s), restore "
              f"{restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s), "
              f"the next epoch's loss {m['loss']:.6f}", flush=True)
        out[kind] = row
        del back
        release(torch)
    lap("the checkpoints done")
    return out


def rank_serve(torch, rt, dist, work: Path) -> None:
    """Phase 17's turn of the gloo launch, as (data 2, model 2), once the
    parent's references are written: the slot engine alone at full width,
    the serve CLI with a fine-tune session (exact and gossip), and the
    checkpoints at model 2; each rank's results to
    ``serve17_rank<r>.json``."""
    rank = dist.get_rank()
    lap = stamps("phase 17 rank 0", rank)
    full = rt.configs.get_config("qwen2-1.5b")
    refs = torch.load(work / "serve_refs.pt")
    out = {"serve": rank_serve_only(torch, rt, dist, full, refs, lap)}
    release(torch)
    for consensus in SERVE17_CLI:
        out[f"cli {consensus}"] = rank_serve_cli(torch, rt, dist, consensus,
                                                 lap)
        release(torch)
    out["ckpt"] = rank_serve_ckpt(torch, rt, dist, work, lap)
    (work / f"serve17_rank{rank}.json").write_text(json.dumps(out))


def serve_after(torch, rt, work: Path) -> dict:
    """Phase 17 after the gloo ranks: the ranks' saves of the parent's
    archives leaf for leaf the archives; each restored in one process
    (ranks -> one process) and taken one epoch on: async gossip under
    ``tp_sums`` (each rank's dual block bit for bit its block of it),
    exact plain and under ``split_sums`` (each gathered leaf within its
    ``order_limits``).  Returns the ranks' launch counts and rows."""
    lap = stamps("phase 17")
    ranks = [json.loads((work / f"serve17_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    ckpt = rt.ckpt.checkpoint
    cfg = dataclasses.replace(rt.configs.smoke_config("qwen2-1.5b"),
                              dtype=MODEL_Q_DTYPE)
    for kind in SERVE17_CKPT:
        for sub in ("", "session_state"):
            a = ckpt._Reader(work / f"ck_one_{kind}" / sub, 1)
            b = ckpt._Reader(work / f"ck_back_{kind}" / sub, 1)
            if a.manifest != b.manifest or any(
                    not (a.data[k].dtype == b.data[k].dtype
                         and (a.data[k] == b.data[k]).all())
                    for k in a.data.files):
                fail(f"phase 17 checkpoint {kind}: the ranks' save of the "
                     f"restored archive is not the one-process archive "
                     f"({sub or 'primal'})")
        losses = [r["ckpt"][kind]["loss"] for r in ranks]
        with deterministic(torch):
            if kind == "exact":
                runs = {}
                for how in ("plain", "split"):
                    with (split_sums(torch, rt) if how == "split"
                          else contextlib.nullcontext()):
                        one = rt.api.AMBSession.restore(
                            work / f"ck_back_{kind}", cfg=cfg,
                            device="cuda")
                        m = one.run(1, prefetch=0)
                    runs[how] = {k: v.detach().cpu()
                                 for k, v in one.params.items()}
                    if how == "plain":
                        loss = m["loss"]
                    del one
                moves = leaf_errs(torch, runs["split"], runs["plain"])
                limits = check_order("phase 17 checkpoint exact", moves)
                got = torch.load(work / "ck_exact_params.pt")
                check_leaves("phase 17 checkpoint exact (the ranks' next "
                             "epoch after the restore)",
                             leaf_errs(torch, got, runs["plain"]), limits)
            else:
                with tp_sums(torch, rt):
                    one = rt.api.AMBSession.restore(
                        work / f"ck_back_{kind}", cfg=cfg, device="cuda")
                    m = one.run(1, prefetch=0)
                    one.flush()
                loss = m["loss"]
                want = block_digests(torch, rt, one.state["z"])
                del one
                for r, res in enumerate(ranks):
                    if res["ckpt"][kind]["digest"] != want[r]:
                        fail(f"phase 17 checkpoint {kind} rank {r}: its "
                             f"dual block after the restored epoch differs "
                             f"from its block of the one-process session "
                             f"under tp_sums")
        check_losses(f"phase 17 checkpoint {kind}", 0, losses,
                     [loss] * len(losses))
        held = ("each leaf within its limit" if kind == "exact"
                else "bit for bit under tp_sums")
        print(f"phase 17 checkpoint {kind}: the ranks' save is the "
              f"one-process archive leaf for leaf; their next epoch "
              f"after the restore held ({held}); "
              f"losses {losses} vs the one-process {loss} "
              f"[{card_line()}]", flush=True)
        release(torch)
    lap("the checkpoints held")
    launches = {f"serve group {run} rank {r}": res[run]["launches"]
                for r, res in enumerate(ranks)
                for run in ("serve", *(f"cli {c}" for c in SERVE17_CLI))}
    return {"launches": launches, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 18: the MoE family over a model axis, and more model ranks than KV
# heads
# ---------------------------------------------------------------------------

MOE_AXIS = (2, 2)              # (data, model): qwen3-moe's experts on "model"
KV_AXIS = (1, 4)               # qwen2-1.5b: 2 KV heads, two ranks to each
# qwen3-moe-30b-a3b at full width over (data 2, model 2): the exact epoch
# at DRIVER_MOE_LAYERS (phase 15's cut), the engine at MOE18_LAYERS, 4
# requests into 8 slots (the first four, worker 0's rows; worker 1's rows
# decode garbage, as JAX's inactive rows do, and take part in every
# round's dispatch)
MOE18_LAYERS = 2
MOE18_SERVE = dict(requests=4, new=16, slots=8, prompt=2048, jitter=512,
                   seed=29)
# the exact ranks' aux against the twin's: both sum the routing counts and
# probabilities of the same bf16 forward, the ranks over the workers'
# rows, the twin over the global batch
MOE18_AUX_RTOL = 1e-3
FLASH_MOE_RANK = dict(b=1, h=16, kv=2, hd=128)  # qwen3-moe, a rank of model 2
FLASH_KV_RANK = dict(b=1, h=3, kv=1, hd=128)    # qwen2-1.5b, a rank of model 4
FLASH18_SEQS = (2048,)


class _RankMoE:
    """What ``moe_forward`` asks of a TensorParallel, for model rank ``r``
    of ``m`` in one process (``moe_twin``): its experts, the router's
    logits whole (its own columns, and each other rank's from that rank's
    contiguous router columns), and no sums (the twin adds the passes)."""

    def __init__(self, torch, r: int, m: int, x, router):
        self.torch, self.r, self.m, self.x, self.router = (torch, r, m, x,
                                                           router)

    def experts_split(self) -> bool:
        return True

    def expert_range(self, cfg) -> tuple:
        per = cfg.num_experts // self.m
        return self.r * per, (self.r + 1) * per

    def copy(self, x):
        return x.view_as(x)

    def router_logits(self, local):
        c = self.router.shape[-1] // self.m
        return self.torch.cat([
            local if j == self.r else self.torch.einsum(
                "bsd,de->bse", self.x.float(),
                self.router[:, j * c:(j + 1) * c].contiguous())
            for j in range(self.m)], dim=-1)

    def reduce(self, y):
        return y


@contextlib.contextmanager
def moe_twin(torch, rt, m: int):
    """The MoE layer as ``m`` model ranks compute it, in one process: pass
    r runs ``moe_forward`` on rank r's router columns and experts
    (contiguous, as a rank holds them) from its own view of the input,
    the routing over all E from every rank's logit columns, and the
    passes' partial outputs are added in fp32 in rank order and rounded
    once (``dist.tp.ordered_sum``), their aux shares added."""
    mod = rt.models.moe
    plain = mod.moe_forward

    def twin(p, x, cfg, group=None, tp=None):
        per = cfg.num_experts // m
        c = p["router"].shape[-1] // m
        out = aux = 0.0
        for r in range(m):
            pr = {"router": p["router"][:, r * c:(r + 1) * c].contiguous()}
            pr.update({k: p[k][r * per:(r + 1) * per]
                       for k in ("w_gate", "w_up", "w_down")})
            xr = x.view_as(x)
            o, a = plain(pr, xr, cfg, group,
                         _RankMoE(torch, r, m, xr, p["router"]))
            out, aux = out + o.float(), aux + a
        return out.to(x.dtype), aux

    mod.moe_forward = twin
    try:
        yield
    finally:
        mod.moe_forward = plain


@contextlib.contextmanager
def rank_twin(torch, rt, cfg, m: int, workers: int):
    """A one-process slot engine as ``workers`` workers of ``m`` model
    ranks serve (phases 17 and 18; any m, more model ranks than KV heads,
    the MoE family): the serving counterpart of ``tp_sums``.  Each rank's
    query, key and value columns are projected from its contiguous
    columns of wq, wk and wv (its qk-norm and rope on its own heads; the
    ranks that share a KV head put its columns together first), its
    flash call (prefill) and cache read
    (decode) take its own heads, the row-parallel wo and MLP products and
    the experts (``moe_twin``) are summed in fp32 in rank order and
    rounded once, and each rank's logit columns come from its contiguous
    columns of the unembedding.  A decode round runs each worker's rows
    alone (the embedding, the attention, the final norm and the logits at
    the worker's batch, which sets cuBLAS's and the reductions' choices),
    and the MoE layer over every slot, as the ranks gather them.  The
    RWKV6 family's is ``ssm_twin``."""
    if cfg.family == "ssm":
        with ssm_twin(torch, rt, cfg, m, workers):
            yield
        return
    model, attn, common = rt.models.model, rt.models.attention, \
        rt.models.common
    slots_mod = sys.modules["repro_torch.serve.slots"]
    plain = (attn.qkv_rope, attn.flash_prefill, attn._softmax_read,
             model.swiglu, model.logits_fn, slots_mod.decode_step)
    flash_prefill, softmax_read = plain[1:3]
    hd, kvh = cfg.hd, cfg.num_kv_heads
    share = m // kvh if m > kvh else 1
    kv_r = 1 if share > 1 else kvh // m          # a rank's KV heads

    class Heads(torch.Tensor):
        """The heads' output, whose product with wo is split by rank."""

        def __matmul__(self, w):
            x = self.as_subclass(torch.Tensor)
            c = x.shape[-1] // m
            out = 0.0
            for r in range(m):
                out = out + (x[..., r * c:(r + 1) * c].contiguous()
                             @ w[r * c:(r + 1) * c]).float()
            return out.to(x.dtype)

    def cols(w, r):
        c = w.shape[-1] // m
        return w[..., r * c:(r + 1) * c]

    def proj(p, x, k, r):
        y = x @ cols(p["w" + k], r).contiguous()
        return y + cols(p["b" + k], r) if "b" + k in p else y

    def rope(t, positions):
        return common.apply_rope(t, positions, cfg.rope_theta)

    def qkv(p, x, positions, cfg_, tp=None):
        b, s, _ = x.shape
        qs = []
        for r in range(m):
            q = proj(p, x, "q", r).reshape(b, s, kv_r, -1, hd)
            if "q_norm" in p:
                q = common.rms_norm(q, p["q_norm"])
            qs.append(rope(q.reshape(b, s, -1, hd), positions)
                      .reshape(q.shape))
        ks = [proj(p, x, "k", r) for r in range(m)]
        vs = [proj(p, x, "v", r) for r in range(m)]
        if share > 1:                    # a head's columns put together
            ks = [torch.cat(ks[h * share:(h + 1) * share], dim=-1)
                  for h in range(kvh)]
            vs = [torch.cat(vs[h * share:(h + 1) * share], dim=-1)
                  for h in range(kvh)]
            qs = [torch.cat(qs[h * share:(h + 1) * share], dim=3)
                  for h in range(kvh)]
        ks = [k.reshape(b, s, -1, hd) for k in ks]
        if "k_norm" in p:
            ks = [common.rms_norm(k, p["k_norm"]) for k in ks]
        ks = [rope(k, positions) for k in ks]
        return (torch.cat(qs, dim=2), torch.cat(ks, dim=2),
                torch.cat([v.reshape(b, s, -1, hd) for v in vs], dim=2))

    def own(q, k, v, r):
        """Rank r's query heads and its KV head(s), contiguous."""
        if share > 1:
            h, j = divmod(r, share)
            g = q.shape[3] // share
            return (q[:, :, h:h + 1, j * g:(j + 1) * g].contiguous(),
                    k[:, :, h:h + 1].contiguous(),
                    v[:, :, h:h + 1].contiguous())
        a = slice(r * kv_r, (r + 1) * kv_r)
        return (q[:, :, a].contiguous(), k[:, :, a].contiguous(),
                v[:, :, a].contiguous())

    def flash(q, k, v, window, *, causal=True):
        return torch.cat([flash_prefill(*own(q, k, v, r), window,
                                        causal=causal)
                          for r in range(m)], dim=-1).as_subclass(Heads)

    def read(q, k, v, valid):
        return torch.cat([softmax_read(*own(q, k, v, r), valid)
                          for r in range(m)], dim=-1).as_subclass(Heads)

    def mlp(x, w_gate, w_up, w_down):
        c = w_gate.shape[-1] // m
        out = 0.0
        for r in range(m):
            h = torch.nn.functional.silu(x @ cols(w_gate, r).contiguous()) \
                * (x @ cols(w_up, r).contiguous())
            out = out + (h @ w_down[r * c:(r + 1) * c]).float()
        return out.to(x.dtype)

    def logits(params, cfg_, hidden, tp=None):
        u = params["unembed"]
        return model._vocab(cfg, torch.cat(
            [hidden @ cols(u, r).contiguous() for r in range(m)], dim=-1))

    def decode(params, cfg_, state, token, tp=None, group=None):
        rows = token.shape[0] // workers
        parts = [slice(w * rows, (w + 1) * rows) for w in range(workers)]
        caches, pos = state.caches, state.pos
        x = torch.nn.functional.embedding(token.long(),
                                          params["embed"])[:, None, :]
        for layer, lp in enumerate(model._layers(params, cfg)):
            hs = []
            for a in parts:
                cache = attn.KVCache(caches.k[layer][a], caches.v[layer][a],
                                     caches.ring)
                hs.append(attn.decode_attend(
                    lp["attn"], common.rms_norm(x[a], lp["ln1"]), pos[a],
                    cache, cfg, window=cfg.sliding_window)[0])
            x = x + torch.cat(hs)
            if cfg.is_moe:                  # every slot, one dispatch
                x = x + model._ffn(x, lp, cfg)[0]
            else:
                x = x + torch.cat([model._ffn(x[a], lp, cfg)[0]
                                   for a in parts])
        out = torch.cat([logits(params, cfg, common.rms_norm(
            x[a], params["final_norm"])) for a in parts])[:, 0]
        return out, model.DecodeState(caches, pos + 1, state.enc_kv)

    (attn.qkv_rope, attn.flash_prefill, attn._softmax_read, model.swiglu,
     model.logits_fn, slots_mod.decode_step) = (qkv, flash, read, mlp,
                                                logits, decode)
    try:
        with (moe_twin(torch, rt, m) if cfg.is_moe
              else contextlib.nullcontext()):
            yield
    finally:
        (attn.qkv_rope, attn.flash_prefill, attn._softmax_read,
         model.swiglu, model.logits_fn, slots_mod.decode_step) = plain


def aux_epochs(torch, rt, session, label: str, epochs: int = 1) -> dict:
    """``mesh_epochs``, with each epoch's aux (the whole model's load-
    balance loss, from the protocol's metrics)."""
    seen, step = [], session.protocol.step

    def spy(state, batch, b):
        state, m = step(state, batch, b)
        seen.append(float(m["aux"]))
        return state, m

    session.protocol.step = spy
    try:
        res = mesh_epochs(torch, rt, session, label, epochs)
    finally:
        session.protocol.step = step
    res["aux"] = seen
    return res


def serve_spec(rt, cfg, spec: dict) -> tuple:
    """A serving spec's (SERVE17, MOE18_SERVE, phase 19's) requests, its
    slots, its cache length (the longest prompt and its new tokens) and
    its seed."""
    reqs = rt.serve.synthetic_requests(
        spec["requests"], vocab_size=cfg.vocab_size,
        prompt_len=spec["prompt"], prompt_jitter=spec["jitter"],
        max_new_tokens=spec["new"], seed=spec["seed"])
    return reqs, spec["slots"], spec["prompt"] + spec["jitter"] \
        + spec["new"], spec["seed"]


def serve18(rt, cfg, which: str) -> tuple:
    """Phase 18's ``serve_spec``: ``moe`` (MOE18_SERVE) or ``kv`` (phase
    17's SERVE17)."""
    return serve_spec(rt, cfg, MOE18_SERVE if which == "moe" else SERVE17)


def drain_first(engine, reqs, take):
    """``drain``, and ``take(engine.state.caches)`` after the first decode
    round (what it returns)."""
    pending, taken = list(reqs), None
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()
        if taken is None:
            taken = take(engine.state.caches)
    return taken


def kv_digests(torch, heads=None):
    """A ``drain_first`` take: the digest of each KV head's caches
    (``heads``), else of the whole caches."""
    def take(caches):
        k, v = caches.k, caches.v
        if not heads:
            return digest(torch, {"k": k, "v": v})
        return [digest(torch, {"k": k[..., h:h + 1, :],
                               "v": v[..., h:h + 1, :]})
                for h in range(heads)]
    return take


def axis18_references(torch, rt, full, work: Path) -> None:
    """Phase 18's references, in the parent while the gloo ranks run phase
    17 (they start once the ranks have ended phase 16: phase 15's and
    16's ranks leave no room on the card), written for the ranks:
      * qwen3-moe-30b-a3b at DRIVER_MOE_LAYERS, bf16, one exact epoch of
        the one-process data=2 session, then its twin (``tp_sums`` and
        ``moe_twin``): each leaf's move sets its limit, the twin's
        parameters, losses and aux are what the ranks are held to;
      * qwen3-moe-30b-a3b at MOE18_LAYERS through the plain 8-slot engine
        and its twin over (data 2, model 2) (``rank_twin``): the greedy
        tokens;
      * qwen2-1.5b through the 8-slot engine's twin over (data 1, model 4)
        at full depth: the tokens, and each KV head's caches' digest
        after the first decode round;
      * qwen2-1.5b at MODEL_LAYERS, one exact epoch at data 1, plain and
        under ``tp_sums`` over the four model ranks (two to a KV head):
        each leaf's move sets its limit, the twin's parameters and losses
        are what the ranks are held to."""
    lap = stamps("phase 18 references")
    refs = {}
    moe = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                              num_layers=DRIVER_MOE_LAYERS)
    with deterministic(torch):
        session = mesh_session(rt, moe, "exact", False, data=MOE_AXIS[0])
        res = aux_epochs(torch, rt, session, "phase 18 moe exact reference")
        plain = {k: v.detach() for k, v in session.params.items()}
        del session
        release(torch)
        with tp_sums(torch, rt), moe_twin(torch, rt, MOE_AXIS[1]):
            session = mesh_session(rt, moe, "exact", False,
                                   data=MOE_AXIS[0])
            twin = aux_epochs(torch, rt, session,
                              "phase 18 moe exact twin")
        moves = leaf_errs(torch, session.params, plain)
        refs["moe_exact"] = {"losses": twin["losses"], "aux": twin["aux"],
                             "plain_losses": res["losses"],
                             "plain_aux": res["aux"], "moves": moves,
                             "limits": check_order("phase 18 moe exact",
                                                   moves)}
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "moe18_twin.pt")
        print(f"phase 18 reference moe exact ({DRIVER_MOE_LAYERS} layer, "
              f"one process, {MOE_AXIS[0]} workers): losses "
              f"{res['losses']} aux {res['aux']}; the twin's "
              f"{twin['losses']} aux {twin['aux']}; peak_GiB "
              f"{twin['peak_gib']:.2f} [{card_line()}]", flush=True)
        del session, plain
        release(torch)
    lap("the MoE exact references done")
    cut = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                              num_layers=MOE18_LAYERS)
    for which, cfg, axis in (("moe", cut, MOE_AXIS), ("kv", full, KV_AXIS)):
        reqs, slots, cache, seed = serve18(rt, cfg, which)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = rt.models.init_params(cfg, gen)
        out = {}
        if which == "moe":
            engine = rt.serve.SlotEngine(params, cfg, slots=slots,
                                         cache_len=cache)
            drain(engine, reqs)
            out["plain_tokens"] = [r.out_tokens for r in reqs]
            del engine
            reqs = serve18(rt, cfg, which)[0]
        with rank_twin(torch, rt, cfg, axis[1], axis[0]):
            engine = rt.serve.SlotEngine(params, cfg, slots=slots,
                                         cache_len=cache)
            out["cache_digests"] = drain_first(engine, reqs, kv_digests(
                torch, cfg.num_kv_heads if which == "kv" else None))
        out["twin_tokens"] = [r.out_tokens for r in reqs]
        refs[f"{which}_serve"] = out
        del engine, params
        release(torch)
        lap(f"the {which} serve twin done")
    kv = dataclasses.replace(full, num_layers=MODEL_LAYERS)
    with deterministic(torch):
        session = mesh_session(rt, kv, "exact", False, data=KV_AXIS[0])
        res = mesh_epochs(torch, rt, session, "phase 18 kv exact reference",
                          1)
        plain = {k: v.detach() for k, v in session.params.items()}
        del session
        release(torch)
        with tp_sums(torch, rt, KV_AXIS[1]):
            session = mesh_session(rt, kv, "exact", False, data=KV_AXIS[0])
            twin = mesh_epochs(torch, rt, session, "phase 18 kv exact twin",
                               1)
        moves = leaf_errs(torch, session.params, plain)
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "kv18_twin.pt")
        del session, plain
        release(torch)
    refs["kv_exact"] = {"losses": twin["losses"],
                        "plain_losses": res["losses"], "moves": moves,
                        "limits": check_order("phase 18 kv exact", moves)}
    print(f"phase 18 reference kv exact ({MODEL_LAYERS} layers, one "
          f"process): losses {res['losses']}; the twin's over "
          f"{KV_AXIS[1]} model ranks {twin['losses']} [{card_line()}]",
          flush=True)
    torch.save(refs, work / "axis18_refs.pt")
    lap("the kv exact references done")


def rank_moe_exact(torch, rt, dist, refs: dict, work: Path, lap) -> dict:
    """qwen3-moe-30b-a3b at DRIVER_MOE_LAYERS over (data 2, model 2), one
    exact epoch (FSDP x TP, the experts on "model") under deterministic
    algorithms: 64 experts a rank; the bytes gathered and reduce-scattered
    over "data" and the parameter and z / w0 blocks the dry-run's to the
    byte; 15 ``dual_update`` launches on the blocks; the loss within
    MESH_LOSS_TOL and aux within MOE18_AUX_RTOL of the twin's; each
    gathered leaf within its limit of the twin's (rank 0)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract
    rank = dist.get_rank()
    label = f"phase 18 moe exact rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                              num_layers=DRIVER_MOE_LAYERS)
    mesh = rt.launch.mesh.make_host_mesh(*MOE_AXIS, device="cuda")
    ref = refs["moe_exact"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", mesh, MOE_AXIS[0],
                               model=MOE_AXIS[1])
        lap("the MoE exact session built")
        res = aux_epochs(torch, rt, session, label)
    lap("the MoE exact epoch done")
    tp, g = session.tp, session.group
    expect(label, res["launches"], {"dual_update": 15})
    e0, e1 = tp.expert_range(cfg)
    if e1 - e0 != cfg.num_experts // MOE_AXIS[1]:
        fail(f"{label}: holds experts [{e0}, {e1})")
    check_losses("phase 18 moe exact", rank, res["losses"], ref["losses"])
    if abs(res["aux"][0] - ref["aux"][0]) > MOE18_AUX_RTOL * ref["aux"][0]:
        fail(f"{label}: aux {res['aux']} vs the twin's {ref['aux']}")
    amesh = abstract(MOE_AXIS, ("data", "model"))
    moved = dryrun.rank_fsdp_bytes(cfg, amesh)
    lay = dryrun._layout(cfg, rt.configs.InputShape(
        "moe18", SEQ, MOE_AXIS[0] * PER_WORKER, "train"), amesh)
    state = session.state
    held = {"gathered_bytes": tp.gathered_bytes,
            "scattered_bytes": tp.scattered_bytes,
            "param_bytes_per_rank": nbytes(state["params"]),
            "opt_state_bytes_per_rank": nbytes(state["opt"]["z"])
            + nbytes(state["opt"]["w0"])}
    want = dict(moved, **{k: lay[k] for k in ("param_bytes_per_rank",
                                              "opt_state_bytes_per_rank")})
    if held != want:
        fail(f"{label}: {held}, the dry-run's {want}")
    row = {"experts": [e0, e1], "epoch_s": res["epoch_s"],
           "peak_gib": res["peak_gib"], "losses": res["losses"],
           "aux": res["aux"], "launches": res["launches"],
           "model_gathered_bytes": tp.model_gathered_bytes,
           "reduced_bytes": tp.reduced_bytes, **held}
    print(f"  {label} (worker {g.worker}, model {g.m}): experts [{e0}, "
          f"{e1}); gathered {held['gathered_bytes']} B and "
          f"reduce-scattered {held['scattered_bytes']} B over \"data\" (the "
          f"dry-run's), blocks {held['param_bytes_per_rank']} B and fp32 z "
          f"and w0 {held['opt_state_bytes_per_rank']} B (the dry-run's); "
          f"router logits gathered {tp.model_gathered_bytes} B; epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} aux {res['aux']} "
          f"(the twin's {ref['losses']}, {ref['aux']}); dual_update "
          f"{res['launches'].get('dual_update', 0)} [{card_line()}]",
          flush=True)
    whole = session.params
    if rank == 0:
        twin = torch.load(work / "moe18_twin.pt")
        row["limit_share"] = check_leaves(
            "phase 18 moe exact (the ranks against the twin)",
            leaf_errs(torch, whole, twin), ref["limits"])
        del twin
    del session, state, whole
    release(torch)
    lap("the MoE exact checks done")
    return row


def rank_serve18(torch, rt, dist, refs: dict, which: str, lap) -> dict:
    """The slot engine alone over a group, clock-free (``drain``): ``moe``
    is qwen3-moe-30b-a3b at MOE18_LAYERS over (data 2, model 2), ``kv``
    qwen2-1.5b at full depth over (data 1, model 4).  Each rank's blocks
    from the seed (``init_shards``, the serving layout); the greedy tokens
    equal to the twin's (``rank_twin``); ``kv``: each rank's caches after
    the first decode round equal, by digest, its KV head's of the twin
    (so the two ranks of a head hold equal caches); the flash launches a
    request on its worker's ranks, all on the tensor cores at the rank's
    shape; per rank the prefill seconds, the decode round's ms (p50,
    p99) and the bytes it summed over "model" and gathered (the
    router's logits and the slot rows over "data"; a KV head's columns)."""
    rank = dist.get_rank()
    router = rt.kernels.router
    label = f"phase 18 {which} serve rank {rank}"
    if which == "moe":
        cfg = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                                  num_layers=MOE18_LAYERS)
        axis, shape = MOE_AXIS, FLASH_MOE_RANK
    else:
        cfg, axis, shape = rt.configs.get_config("qwen2-1.5b"), KV_AXIS, \
            FLASH_KV_RANK
    ref = refs[f"{which}_serve"]
    reqs, slots, cache, seed = serve18(rt, cfg, which)
    mesh = rt.launch.mesh.make_host_mesh(*axis, device="cuda")
    group = rt.dist.group.WorkerGroup(mesh, "cuda")
    shapes = {k: v.shape for k, v in rt.models.init_params(
        cfg, rt.models.common.MetaGenerator()).items()}
    tp = rt.dist.tp.TensorParallel(group, shapes, None, cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = rt.dist.params.init_shards(cfg, gen, mesh,
                                        mesh.get_coordinate(), None)
    lap(f"the {which} serving blocks drawn")
    torch.cuda.reset_peak_memory_stats()
    engine = rt.serve.SlotEngine(params, cfg, slots=slots, cache_len=cache,
                                 group=group, tp=tp)
    probe = EngineProbe(torch, rt, engine, lambda: (
        tp.reduced_bytes, tp.model_gathered_bytes
        + group.rows_gathered_bytes))
    with probe.watch():
        digests = drain_first(engine, reqs, kv_digests(
            torch, 1 if which == "kv" else None))
    launches = router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap(f"the {which} requests served")
    tokens = [r.out_tokens for r in reqs]
    if tokens != ref["twin_tokens"]:
        fail(f"{label}: greedy tokens differ from the one-process twin's "
             f"(rank_twin): {tokens} vs {ref['twin_tokens']}")
    if which == "kv":
        h = group.m // tp.kv_share
        if as_json(digests[0]) != as_json(ref["cache_digests"][h]):
            fail(f"{label}: its caches after the first round differ from "
                 f"KV head {h}'s of the twin")
    differ = None
    if "plain_tokens" in ref:
        differ = sum(a != b for x, y in zip(tokens, ref["plain_tokens"])
                     for a, b in zip(x, y))
    per_req = cfg.num_layers
    owned = probe.check_flash(label, reqs, per_req, shape, launches)
    rank_shape = tuple(shape[x] for x in ("b", "h", "kv", "hd"))
    rounds = probe.rounds()
    row = {"owned": owned, "flash_per_request": per_req,
           "prefill_s": probe.prefill_s,
           "decode_rounds": rounds["decode_rounds"],
           "round_ms_p50": rounds["round_ms_p50"],
           "round_ms_p99": rounds["round_ms_p99"],
           "reduced_bytes_per_round": rounds["bytes_per_round"][0],
           "gathered_bytes_per_round": rounds["bytes_per_round"][1],
           "peak_gib": peak, "tokens_differing_from_plain": differ,
           "launches": launches}
    print(f"  {label} (worker {group.worker}, model {group.m}): greedy "
          f"tokens equal to the twin's"
          + (f"; {differ} of {sum(map(len, tokens))} differ from the plain "
             f"engine's" if differ is not None else
             f"; caches equal to KV head {group.m // tp.kv_share}'s of the "
             f"twin")
          + f"; flash {per_req} a request on the tensor cores at (B, H, KV, "
          f"hd) {rank_shape} x {owned} requests; prefill_s "
          f"{[round(x, 4) for x in probe.prefill_s]}; decode rounds "
          f"{row['decode_rounds']}, "
          f"ms p50 {row['round_ms_p50']:.2f} p99 {row['round_ms_p99']:.2f}; "
          f"{row['reduced_bytes_per_round']} B summed over \"model\" and "
          f"{row['gathered_bytes_per_round']} B gathered a round; peak_GiB "
          f"{peak:.2f} [{card_line()}]", flush=True)
    del engine, params
    release(torch)
    return row


def rank_kv_exact(torch, rt, dist, refs: dict, work: Path, lap) -> dict:
    """qwen2-1.5b at MODEL_LAYERS over (data 1, model 4), one exact epoch
    under deterministic algorithms (the KV gather's backward: the two
    ranks of a head sum their gradients of its columns): 15
    ``dual_update`` launches on the blocks, the loss within
    MESH_LOSS_TOL of the twin's (``tp_sums`` over four model ranks) and
    each gathered leaf within its ``order_limits`` of the twin's (rank
    0)."""
    rank = dist.get_rank()
    label = f"phase 18 kv exact rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config("qwen2-1.5b"),
                              num_layers=MODEL_LAYERS)
    mesh = rt.launch.mesh.make_host_mesh(*KV_AXIS, device="cuda")
    ref = refs["kv_exact"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", mesh, KV_AXIS[0],
                               model=KV_AXIS[1])
        res = mesh_epochs(torch, rt, session, label, 1)
    lap("the kv exact epoch done")
    tp = session.tp
    expect(label, res["launches"], {"dual_update": 15})
    check_losses("phase 18 kv exact", rank, res["losses"], ref["losses"])
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "kv_share": tp.kv_share,
           "model_gathered_bytes": tp.model_gathered_bytes,
           "reduced_bytes": tp.reduced_bytes}
    print(f"  {label} (model {session.group.m}, KV head "
          f"{session.group.m // tp.kv_share} of {tp.kv_share} ranks): "
          f"epoch_s {[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} (the twin's "
          f"{ref['losses']}); KV columns gathered {tp.model_gathered_bytes} "
          f"B, {tp.reduced_bytes} B summed over \"model\"; dual_update "
          f"{res['launches'].get('dual_update', 0)} [{card_line()}]",
          flush=True)
    whole = session.params
    if rank == 0:
        twin = torch.load(work / "kv18_twin.pt")
        row["limit_share"] = check_leaves(
            "phase 18 kv exact (the ranks against the twin)",
            leaf_errs(torch, whole, twin), ref["limits"])
        del twin
    del session, whole
    release(torch)
    return row


def rank_axis18(torch, rt, dist, work: Path) -> None:
    """Phase 18's turn of the gloo launch, once the parent's references
    are written: the MoE exact epoch and the MoE engine over (data 2,
    model 2), then over a second mesh on the same ranks, (data 1, model
    4), qwen2-1.5b's engine at full depth and an exact epoch; each rank's
    results to ``axis18_rank<r>.json``."""
    rank = dist.get_rank()
    lap = stamps("phase 18 rank 0", rank)
    refs = torch.load(work / "axis18_refs.pt")
    out = {"moe exact": rank_moe_exact(torch, rt, dist, refs, work, lap)}
    for which in ("moe", "kv"):
        out[f"{which} serve"] = rank_serve18(torch, rt, dist, refs, which,
                                             lap)
    out["kv exact"] = rank_kv_exact(torch, rt, dist, refs, work, lap)
    (work / f"axis18_rank{rank}.json").write_text(json.dumps(out))


def axis18_after(work: Path) -> dict:
    """Phase 18 after the gloo ranks: their rows and launch counts."""
    ranks = [json.loads((work / f"axis18_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    launches = {f"{run} rank {r}": res[run]["launches"]
                for r, res in enumerate(ranks) for run in res}
    print(f"phase 18: every rank's checks held; launches "
          f"{json.dumps(launches)} [{card_line()}]", flush=True)
    return {"launches": launches, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 19: the vlm and ssm families over a model axis
# ---------------------------------------------------------------------------

SSM_ARCH = "rwkv6-3b"
SSM_AXIS = (2, 2)              # (data, model): 20 of rwkv6-3b's 40 heads a rank
# rwkv6-3b at full width over (data 2, model 2): the engine at all 32
# layers (8 requests of 2048 +- 512 tokens into 8 slots, 32 new tokens:
# each worker owns 4 slots and prefills its 4 requests), an exact epoch at
# SSM19_EXACT_LAYERS (bf16) and an fp32 gossip epoch at
# SSM19_GOSSIP_LAYERS with SSM19_ROUNDS rounds
SSM19_SERVE = dict(requests=8, new=32, slots=8, prompt=2048, jitter=512,
                   seed=30)
SSM19_EXACT_LAYERS = 2
SSM19_GOSSIP_LAYERS = 1
SSM19_ROUNDS = 2
# internvl2-76b over (data 2, model 2): the engine at VLM19_LAYERS of 80 on
# embeddings prompts (its exact and gossip epochs are the dense blocks',
# held on the CPU in tests/test_torch_tp_ssm.py: one layer of FSDP x TP
# needs about 12 to 14 GB a rank of fp32 z, w0 and vocab-parallel logits)
VLM19_LAYERS = 4
VLM19_SERVE = dict(requests=8, new=16, slots=8, prompt=2048, jitter=512,
                   seed=31)
# the exact epoch starts from the seed's parameters with the RWKV6 leaves
# that init makes constant (the token-shift mixes 0.5, the bonus 0, the
# decay bias -6, ln_x 1) drawn from SSM19_REDRAW_SEED, as real checkpoints
# hold them: at u = 0 every layer's first token has y = 0 in the per-head
# norm's eps regime, and the bonus's first update is so rounding-bound
# that the one-process epoch moved it 0.417 of its largest value under the
# ranks' summation order alone (an H100 at 700 W; 0.09 on the CPU at the
# same shapes), past any limit that could tell a fault from the order;
# drawn, a misplaced block of any of these leaves shows at its full size
SSM19_REDRAW_SEED = 19
SSM19_REDRAWN = (("blocks.tmix.mu", 0.0, 1.0), ("blocks.cmix.mu", 0.0, 1.0),
                 ("blocks.tmix.u_bonus", -0.5, 0.5),
                 ("blocks.tmix.decay_bias", -7.0, -4.0),
                 ("blocks.tmix.ln_x", 0.5, 1.5))
# the engine's twin against the plain engine (the same parameters, the
# same prompts): each prefill's logits, and the first round's on the rows
# whose first token agrees, within SSM19_LOGIT_TOL of the plain logits'
# largest magnitude.  The twin differs from the plain engine by summation
# order only (the row-parallel w_out in two bf16 partials, the channel
# mix's products by column blocks, a decode round by worker rows): about
# one bf16 unit (2 ** -8) of the residual a layer, at most 32 of them
# over rwkv6-3b's layers; a misplaced head, channel or leaf block moves
# random-weight logits by about their own size
SSM19_LOGIT_TOL = 32 * 2.0 ** -8
# and the same comparison in fp32 at SSM19_FP32_LAYERS (full width, two
# requests, two new tokens each), where summation order moves the logits
# by fp32 rounding only: within SSM19_FP32_TOL, so a fault that the bf16
# limit could hide shows there
SSM19_FP32_LAYERS = 4
SSM19_FP32_TOL = 1e-4
FLASH_VLM_RANK = dict(b=1, h=32, kv=4, hd=128)  # internvl2, a rank of model 2
FLASH19_SEQS = (2048,)
RWKV_RANK = dict(b=1, h=20, hd=64)   # rwkv6-3b, a rank of model 2


def ssm19_redraw(torch, params: dict, shapes=None) -> dict:
    """The RWKV6 leaves that init makes constant (SSM19_REDRAWN), whole
    on the card, drawn from SSM19_REDRAW_SEED (see there) in the dtypes
    of ``params``' leaves of the same names (``shapes``: their whole
    shapes, where ``params`` holds a rank's blocks): the same on every
    rank."""
    gen = torch.Generator(device="cuda").manual_seed(SSM19_REDRAW_SEED)
    out = {}
    for name, lo, hi in SSM19_REDRAWN:
        shape = shapes[name] if shapes else params[name].shape
        draw = torch.rand(shape, generator=gen, device="cuda")
        out[name] = (lo + (hi - lo) * draw).to(params[name].dtype)
    return out


def ssm19_params(torch, rt, cfg, seed: int = 0) -> dict:
    """rwkv6-3b's whole parameters at ``cfg`` on the card from ``seed``
    (``init_params``), the constant RWKV6 leaves drawn
    (``ssm19_redraw``)."""
    params = rt.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed))
    params.update(ssm19_redraw(torch, params))
    return params


class _SsmRank:
    """What the RWKV6 blocks ask of a TensorParallel, for model rank ``r``
    of ``m`` in one process on whole leaves (``ssm_twin``, ``tp_sums``):
    ``ssm_leaves`` gives a layer's leaves as rank r reads them (its
    contiguous columns of the projections, its rows of ``w_out``; the
    small leaves whole and cut by the same views as the rank's; in
    training each of those from ``views``, its own view of the leaf
    through ``_fan``), and no collectives (the twin sums the passes)."""

    def __init__(self, r: int, m: int, views=None):
        self.r, self.m, self.views = r, m, views or {}

    def ssm_leaves(self, p: dict, prefix: str) -> dict:
        r, m = self.r, self.m
        out = {}
        for k, v in p.items():
            if k in self.views:
                v = self.views[k][r]
            if k in ("mu", "decay_a"):
                out[k] = v
            elif k == "u_bonus":
                h = v.shape[0] // m
                out[k] = v.narrow(0, r * h, h)
            elif k in ("decay_b", "decay_bias", "ln_x"):
                c = v.shape[-1] // m
                out[k] = v.narrow(-1, r * c, c)
            elif k == "w_out":
                c = v.shape[0] // m
                out[k] = v[r * c:(r + 1) * c]
            else:
                c = v.shape[-1] // m
                out[k] = v[:, r * c:(r + 1) * c].contiguous()
        return out

    def copy(self, x):
        return x.view_as(x)

    def reduce(self, x):
        return x


def _rank_sum(torch, parts: list, dtype):
    """Partials added in fp32 in rank order and rounded once (``dist.tp.
    ordered_sum``)."""
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return out.to(dtype)


def _twin_cmix(torch, m: int, x, xns: list, xps: list, cm: dict, fan=None):
    """The channel mix as ``m`` model ranks run it (``models.model._cmix``
    with ``tp``), in one process: rank r's squared-ReLU key columns from
    its own view of the input (``xns[r]``, ``xps[r]``), the keys put
    together, each rank's output channels from its columns of w_r and
    w_v, the channels put together.  ``fan`` (training): the mixes and
    the gathered key through ``_fan``, each rank's use its own view."""
    mus = fan(cm["mu"]) if fan else [cm["mu"]] * m

    def cols(w, r):
        c = w.shape[-1] // m
        return w[:, r * c:(r + 1) * c].contiguous()

    k_ins = [xns[r] * mus[r][0] + xps[r] * (1 - mus[r][0]) for r in range(m)]
    r_ins = [xns[r] * mus[r][1] + xps[r] * (1 - mus[r][1]) for r in range(m)]
    act = torch.cat([torch.square(torch.relu(k_ins[r] @ cols(cm["w_k"], r)))
                     for r in range(m)], dim=-1)
    acts = fan(act) if fan else [act] * m
    return x + torch.cat([torch.sigmoid(r_ins[r] @ cols(cm["w_r"], r))
                          * (acts[r] @ cols(cm["w_v"], r))
                          for r in range(m)], dim=-1)


def _twin_rwkv_block(torch, rt, m: int):
    """``models.model._rwkv_block`` as a worker's ``m`` model ranks run it
    under autograd (``tp_sums``): the time mix once per rank on its heads
    from its own view of the normed input and of each small leaf
    (``_fan``: their gradients summed in fp32 in rank order, as the
    ranks' ``tp.copy`` and the leaves' gathers sum them), the partial
    outputs summed in rank order; the channel mix by ``_twin_cmix``."""
    ssm, common = rt.models.ssm, rt.models.common
    fan = _fan(torch, m)
    small = ("mu", "decay_a", "decay_b", "u_bonus", "decay_bias", "ln_x")

    def block(x, positions, cfg, p, tp=None):
        tm = p["tmix"]
        views = {k: fan(tm[k]) for k in small}
        xn = common.rms_norm(x, p["ln1"])
        hs = [ssm.rwkv6_forward(tm, xr, cfg, tp=_SsmRank(r, m, views))
              for r, xr in enumerate(fan(xn))]
        x = x + _rank_sum(torch, hs, x.dtype)
        xns = fan(common.rms_norm(x, p["ln2"]))
        xps = [torch.nn.functional.pad(v, (0, 0, 1, 0))[:, :-1] for v in xns]
        return _twin_cmix(torch, m, x, list(xns), xps, p["cmix"], fan), None

    return block


def _twin_mamba_block(torch, rt, m: int):
    """``models.model._mamba_block`` as a worker's ``m`` model ranks run it
    under autograd (``tp_sums``): rank r's inner pass from its own view
    of the normed input and of each packed or partly read leaf (``_fan``:
    their gradients summed in fp32 in rank order, as ``tp.copy`` and the
    whole-leaf gathers sum them), cut to its heads by the port's own
    ``mamba2_rank_leaves``; the ranks' sums of squares put together and
    viewed once a rank (``_fan``, as their gather sums its gradient); each
    rank's output from its rows of ``w_out``, summed in fp32 in rank
    order."""
    ssm, common = rt.models.ssm, rt.models.common
    fan = _fan(torch, m)
    fanned = ("w_in", "conv_w", "a_log", "dt_bias", "d_skip", "norm_z")

    def block(x, positions, cfg, p, tp=None):
        mp = p["mamba"]
        d_in = mp["norm_z"].shape[-1]
        c = d_in // m
        views = {k: fan(mp[k]) for k in fanned}
        xs = fan(common.rms_norm(x, p["ln1"]))
        leaves, ys, zs = [], [], []
        for r in range(m):
            pr = ssm.mamba2_rank_leaves(
                dict(mp, **{k: views[k][r] for k in fanned}), r, m)
            pr["w_out"] = mp["w_out"][r * c:(r + 1) * c]
            y, z, _ = ssm.mamba2_inner(pr, xs[r], cfg)
            leaves.append(pr)
            ys.append(y)
            zs.append(z)
        squares = fan(torch.cat([(y * y).sum(dim=-1, keepdim=True)
                                 for y in ys], dim=-1))
        outs = [ssm.mamba2_norm_out(leaves[r], ys[r], zs[r], xs[r], d_in,
                                    list(squares[r].split(1, dim=-1)))
                for r in range(m)]
        return x + _rank_sum(torch, outs, x.dtype), None

    return block


@contextlib.contextmanager
def ssm_twin(torch, rt, cfg, m: int, workers: int):
    """``rank_twin`` for the RWKV6 family: a one-process slot engine as
    ``workers`` workers of ``m`` model ranks serve.  Each rank's time mix
    runs on its heads (the scan kernel at H / m) from its contiguous
    columns and rows (``_SsmRank``), the partial outputs summed in fp32
    in rank order and rounded once; the channel mix is ``_twin_cmix``;
    each rank's logit columns come from its contiguous unembedding
    columns.  The states keep the native heads (rank r's are heads r H /
    m to (r + 1) H / m), and a decode round runs each worker's rows
    alone."""
    model, ssm, common = rt.models.model, rt.models.ssm, rt.models.common
    slots_mod = sys.modules["repro_torch.serve.slots"]
    plain = (model._prefill_ssm, slots_mod.decode_step, model.logits_fn,
             ssm.rwkv6_state_heads)
    heads = cfg.d_model // ssm.RWKV_HD
    per = heads // m

    def own(r):
        return slice(r * per, (r + 1) * per)

    def logits(params, cfg_, hidden, tp=None):
        u = params["unembed"]
        c = u.shape[-1] // m
        return model._vocab(cfg, torch.cat(
            [hidden @ u[:, r * c:(r + 1) * c].contiguous()
             for r in range(m)], dim=-1))

    def prefill_ssm(params, cfg_, x, tp=None):
        caches = model._ssm_caches(cfg, x.shape[0], x.device)
        tmix = caches["tmix"]
        for layer, lp in enumerate(model._layers(params, cfg)):
            xn = common.rms_norm(x, lp["ln1"])
            hs = []
            for r in range(m):
                h, st = ssm.rwkv6_forward(lp["tmix"], xn, cfg,
                                          return_state=True,
                                          tp=_SsmRank(r, m))
                tmix.s[layer][:, own(r)] = st.s
                hs.append(h)
            tmix.x_prev[layer] = st.x_prev
            x = x + _rank_sum(torch, hs, x.dtype)
            xn = common.rms_norm(x, lp["ln2"])
            xp = torch.nn.functional.pad(xn, (0, 0, 1, 0))[:, :-1]
            x = _twin_cmix(torch, m, x, [xn] * m, [xp] * m, lp["cmix"])
            caches["cmix_prev"][layer] = xn[:, -1]
        return x, caches

    def decode(params, cfg_, state, token, tp=None, group=None):
        rows = token.shape[0] // workers
        caches = state.caches
        tmix = caches["tmix"]
        out = []
        for w in range(workers):
            a = slice(w * rows, (w + 1) * rows)
            x = torch.nn.functional.embedding(token[a].long(),
                                              params["embed"])[:, None, :]
            for layer, lp in enumerate(model._layers(params, cfg)):
                xn = common.rms_norm(x, lp["ln1"])
                hs = []
                for r in range(m):
                    st = ssm.RWKVState(tmix.s[layer][a, own(r)],
                                       tmix.x_prev[layer][a])
                    h, new = ssm.rwkv6_decode(lp["tmix"], xn, st, cfg,
                                              _SsmRank(r, m))
                    tmix.s[layer][a, own(r)] = new.s
                    hs.append(h)
                tmix.x_prev[layer][a] = new.x_prev
                x = x + _rank_sum(torch, hs, x.dtype)
                xn = common.rms_norm(x, lp["ln2"])
                xp = caches["cmix_prev"][layer][a][:, None]
                x = _twin_cmix(torch, m, x, [xn] * m, [xp] * m, lp["cmix"])
                caches["cmix_prev"][layer][a] = xn[:, 0]
            out.append(logits(params, cfg, common.rms_norm(
                x, params["final_norm"])))
        return (torch.cat(out)[:, 0],
                model.DecodeState(caches, state.pos + 1, state.enc_kv))

    (model._prefill_ssm, slots_mod.decode_step, model.logits_fn,
     ssm.rwkv6_state_heads) = (prefill_ssm, decode, logits,
                               lambda cfg_: heads)
    try:
        yield
    finally:
        (model._prefill_ssm, slots_mod.decode_step, model.logits_fn,
         ssm.rwkv6_state_heads) = plain


def sampled_logits(engine, count: int) -> list:
    """The first ``count`` logits tensors ``engine``'s sampler draws from
    (host fp32), filled as it serves: with every slot filled before the
    first round, each request's prefill in insertion order, then the
    first round's (slots, vocab)."""
    seen, sample = [], engine._sample

    def spy(logits):
        if len(seen) < count:
            seen.append(logits.float().cpu())
        return sample(logits)

    engine._sample = spy
    return seen


def check_ssm19_twin(torch, plain: list, twin: list, plain_tokens: list,
                     twin_tokens: list, tol: float, what: str,
                     label: str = "phase 19 reference: the rwkv6") -> None:
    """The rwkv6 engine's twin against the plain engine (``label``: phase
    20's whisper twin against the plain model the same way): each
    request's first greedy token that differs (None: none), and each
    prefill's logits and the first round's rows whose first token agrees
    (request i in slot i) within ``tol`` of the plain logits' largest
    magnitude; fails past it."""
    n = len(plain_tokens)

    def err(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    prefill = [err(t, p) for t, p in zip(twin[:n], plain[:n])]
    rows = [i for i in range(n) if twin_tokens[i][0] == plain_tokens[i][0]]
    first_round = err(twin[n][rows], plain[n][rows]) if rows else None
    diverge = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                    None) for x, y in zip(twin_tokens, plain_tokens)]
    differ = sum(a != b for x, y in zip(twin_tokens, plain_tokens)
                 for a, b in zip(x, y))
    print(f"{label} twin against the plain engine "
          f"({what}): {differ} of {sum(map(len, plain_tokens))} greedy tokens differ; "
          f"each request's first that differs {diverge}; max |twin - "
          f"plain| over max |plain| of each prefill's logits "
          f"{[float(f'{e:.4g}') for e in prefill]}, of the first round's on "
          f"the {len(rows)} rows whose first token agrees "
          f"{first_round if first_round is None else f'{first_round:.4g}'} "
          f"(limit {tol:.4g}) [{card_line()}]", flush=True)
    worst = max(prefill + ([first_round] if rows else []))
    if not worst <= tol:
        fail(f"{label} twin's {what} logits are "
             f"{worst:.4g} of the plain engine's largest from them, past "
             f"{tol}: more than summation order")


def ssm19_fp32_twin(torch, rt, full) -> None:
    """``check_ssm19_twin`` in fp32 at SSM19_FP32_LAYERS, full width:
    the first two of phase 19's requests, two new tokens each, through
    the plain 2-slot engine and its twin over SSM_AXIS, within
    SSM19_FP32_TOL."""
    data, m = SSM_AXIS
    cfg = dataclasses.replace(full, num_layers=SSM19_FP32_LAYERS,
                              dtype="float32")
    reqs, _, cache, seed = serve_spec(rt, cfg, SSM19_SERVE)
    params = ssm19_params(torch, rt, cfg, seed)
    seen, tokens = [], []
    for twin in (False, True):
        reqs = serve_spec(rt, cfg, SSM19_SERVE)[0][:data]
        for r in reqs:
            r.max_new_tokens = 2
        with (ssm_twin(torch, rt, cfg, m, data) if twin
              else contextlib.nullcontext()):
            engine = rt.serve.SlotEngine(params, cfg, slots=data,
                                         cache_len=cache)
            seen.append(sampled_logits(engine, data + 1))
            drain(engine, reqs)
        tokens.append([r.out_tokens for r in reqs])
        del engine
    del params
    release(torch)
    check_ssm19_twin(torch, seen[0], seen[1], tokens[0], tokens[1],
                     SSM19_FP32_TOL, f"fp32, {SSM19_FP32_LAYERS} layers")


def ssm_state_digests(torch, caches, rows: slice, heads: slice) -> list:
    """The digest of slot rows ``rows`` of RWKV6 decode caches: the wkv
    states of ``heads``, the two mixes' token shifts."""
    tmix = caches["tmix"]
    return as_json(digest(torch, {"s": tmix.s[:, rows, heads],
                                  "x_prev": tmix.x_prev[:, rows],
                                  "cmix_prev": caches["cmix_prev"][:, rows]}))


def axis19_references(torch, rt, work: Path) -> None:
    """Phase 19's references, in the parent while the gloo ranks run
    phases 17 and 18, written for the ranks:
      * rwkv6-3b at full width, the RWKV6 constants drawn
        (``ssm19_params``), through the plain 8-slot engine and its twin
        over (data 2, model 2) (``ssm_twin``): the greedy tokens, the
        twin held to the plain engine (``check_ssm19_twin``), and after
        the first decode round the digest of each rank's share of the
        twin's states (its worker's rows, its 20 heads);
      * rwkv6-3b at SSM19_EXACT_LAYERS from ``ssm19_params``, one exact
        epoch of the one-process data=2 session, plain and under
        ``tp_sums`` (its RWKV6 twin block):
        each leaf's move sets its limit; the twin's parameters and losses
        are what the ranks are held to;
      * rwkv6-3b at SSM19_GOSSIP_LAYERS in fp32, one gossip epoch of the
        one-process data=2 session under ``tp_sums``: the digest of each
        rank's block of its worker's dual (``block_digests``);
      * internvl2-76b at VLM19_LAYERS through the 8-slot engine's twin
        over (data 2, model 2) on embeddings prompts (``rank_twin``): the
        greedy tokens."""
    lap = stamps("phase 19 references")
    refs = {}
    data, m = SSM_AXIS
    full = rt.configs.get_config(SSM_ARCH)
    reqs, slots, cache, seed = serve_spec(rt, full, SSM19_SERVE)
    params = ssm19_params(torch, rt, full, seed)
    engine = rt.serve.SlotEngine(params, full, slots=slots, cache_len=cache)
    plain_seen = sampled_logits(engine, len(reqs) + 1)
    drain(engine, reqs)
    plain_tokens = [r.out_tokens for r in reqs]
    del engine
    release(torch)
    reqs = serve_spec(rt, full, SSM19_SERVE)[0]
    per, heads = slots // data, full.d_model // 64 // m
    cuts = [(slice(w * per, (w + 1) * per), slice(r * heads, (r + 1) * heads))
            for w in range(data) for r in range(m)]
    with ssm_twin(torch, rt, full, m, data):
        engine = rt.serve.SlotEngine(params, full, slots=slots,
                                     cache_len=cache)
        twin_seen = sampled_logits(engine, len(reqs) + 1)
        digests = drain_first(engine, reqs, lambda c: [
            ssm_state_digests(torch, c, *cut) for cut in cuts])
    twin_tokens = [r.out_tokens for r in reqs]
    refs["ssm_serve"] = {"plain_tokens": plain_tokens,
                         "twin_tokens": twin_tokens,
                         "state_digests": digests}
    del engine, params
    release(torch)
    check_ssm19_twin(torch, plain_seen, twin_seen, plain_tokens, twin_tokens,
                     SSM19_LOGIT_TOL, "bf16")
    ssm19_fp32_twin(torch, rt, full)
    lap("the rwkv6 serve twin done")
    cfg = dataclasses.replace(full, num_layers=SSM19_EXACT_LAYERS)
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", False, data=data,
                               params=ssm19_params(torch, rt, cfg))
        res = mesh_epochs(torch, rt, session, "phase 19 ssm exact reference",
                          1)
        plain = {k: v.detach() for k, v in session.params.items()}
        del session
        release(torch)
        with tp_sums(torch, rt, m):
            session = mesh_session(rt, cfg, "exact", False, data=data,
                                   params=ssm19_params(torch, rt, cfg))
            twin = mesh_epochs(torch, rt, session, "phase 19 ssm exact twin",
                               1)
        moves = leaf_errs(torch, session.params, plain)
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "ssm19_twin.pt")
        del session, plain
        release(torch)
    refs["ssm_exact"] = {"losses": twin["losses"],
                         "plain_losses": res["losses"], "moves": moves,
                         "limits": check_order("phase 19 ssm exact", moves)}
    print(f"phase 19 reference ssm exact ({SSM19_EXACT_LAYERS} layers, one "
          f"process, {data} workers): losses {res['losses']}; the twin's "
          f"over {m} model ranks {twin['losses']} [{card_line()}]",
          flush=True)
    lap("the rwkv6 exact references done")
    cfg = dataclasses.replace(full, num_layers=SSM19_GOSSIP_LAYERS,
                              dtype="float32")
    with deterministic(torch), tp_sums(torch, rt, m):
        session = mesh_session(rt, cfg, "gossip", False, data=data,
                               rounds=SSM19_ROUNDS)
        res = mesh_epochs(torch, rt, session, "phase 19 ssm gossip twin", 1)
        refs["ssm_gossip"] = {"losses": res["losses"],
                              "digests": block_digests(torch, rt,
                                                       session.state["z"])}
        del session
        release(torch)
    print(f"phase 19 reference ssm gossip ({SSM19_GOSSIP_LAYERS} layer, "
          f"fp32, one process, {data} workers, tp_sums): losses "
          f"{res['losses']} [{card_line()}]", flush=True)
    lap("the rwkv6 gossip twin done")
    vlm = dataclasses.replace(rt.configs.get_config(VLM_ARCH),
                              num_layers=VLM19_LAYERS)
    reqs, slots, cache, seed = serve_spec(rt, vlm, VLM19_SERVE)
    params = rt.models.init_params(
        vlm, torch.Generator(device="cuda").manual_seed(seed))
    with rank_twin(torch, rt, vlm, m, data):
        engine = rt.serve.SlotEngine(params, vlm, slots=slots,
                                     cache_len=cache)
        drain(engine, reqs)
    refs["vlm_serve"] = {"twin_tokens": [r.out_tokens for r in reqs]}
    del engine, params
    release(torch)
    lap("the internvl2 serve twin done")
    torch.save(refs, work / "axis19_refs.pt")


@contextlib.contextmanager
def count_collectives(dist):
    """Count this process's calls of the collectives the port's model and
    engine make (``counts``: by name) while open."""
    names = ("all_gather", "all_gather_into_tensor", "all_reduce",
             "broadcast")
    plain = {n: getattr(dist, n) for n in names}
    counts = {n: 0 for n in names}

    def counted(n):
        def call(*args, **kwargs):
            counts[n] += 1
            return plain[n](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counted(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, plain[n])


def rank_engine(torch, rt, cfg, seed: int, slots: int, cache: int,
                drawn, redraw: bool = False) -> tuple:
    """A slot engine over (data 2, model 2) (SSM_AXIS) on this rank's
    serving blocks of ``cfg`` from ``seed`` (``init_shards``; ``redraw``:
    its blocks of ``ssm19_redraw``'s leaves in their place); calls
    ``drawn()`` once they are, then resets the peak.  Returns (the
    engine, its group, its TensorParallel)."""
    mesh = rt.launch.mesh.make_host_mesh(*SSM_AXIS, device="cuda")
    group = rt.dist.group.WorkerGroup(mesh, "cuda")
    shapes = {k: v.shape for k, v in rt.models.init_params(
        cfg, rt.models.common.MetaGenerator()).items()}
    tp = rt.dist.tp.TensorParallel(group, shapes, None, cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = rt.dist.params.init_shards(cfg, gen, mesh,
                                        mesh.get_coordinate(), None)
    if redraw:
        params.update(rt.dist.params.shard_tree(
            ssm19_redraw(torch, params, shapes), mesh, mesh.get_coordinate(),
            None))
    drawn()
    torch.cuda.reset_peak_memory_stats()
    return (rt.serve.SlotEngine(params, cfg, slots=slots, cache_len=cache,
                                group=group, tp=tp), group, tp)


def rank_ssm_serve(torch, rt, dist, refs: dict, lap) -> dict:
    """rwkv6-3b at full width, bf16, through the slot engine over (data 2,
    model 2), clock-free (``drain_first``): each rank's blocks from the seed
    (``init_shards``, the serving layout; the RWKV6 constants drawn,
    ``ssm19_redraw``); the greedy tokens equal to the
    twin's (``ssm_twin``) and the count that differ from the plain
    engine's; each rank's states after the first decode round its share
    of the twin's by digest; 32 ``rwkv6_scan`` launches a request on its
    worker's ranks at (B 1, H 20, hd 64), no flash; per rank the prefill
    seconds, the decode round's ms (p50, p99), the bytes summed and
    gathered over "model" and the collectives a round."""
    rank = dist.get_rank()
    router = rt.kernels.router
    label = f"phase 19 ssm serve rank {rank}"
    cfg = rt.configs.get_config(SSM_ARCH)
    ref = refs["ssm_serve"]
    reqs, slots, cache, seed = serve_spec(rt, cfg, SSM19_SERVE)
    engine, group, tp = rank_engine(torch, rt, cfg, seed, slots, cache,
                                    lambda: lap("the rwkv6 serving blocks "
                                                "drawn"), redraw=True)
    scans, shapes_seen = {}, set()
    kops = rt.models.ssm.kops
    scan, insert = kops.rwkv6_scan, engine.insert

    def seen(r, *args, **kw):
        shapes_seen.add(tuple(r.shape[:2]) + (r.shape[3],))
        return scan(r, *args, **kw)

    def counted_insert(req):
        before = router.launches().get("rwkv6_scan", 0)
        out = insert(req)
        scans[req.rid] = router.launches().get("rwkv6_scan", 0) - before
        return out

    engine.insert = counted_insert
    kops.rwkv6_scan = seen
    try:
        with count_collectives(dist) as calls:
            probe = EngineProbe(torch, rt, engine, lambda: (
                tp.reduced_bytes, tp.model_gathered_bytes,
                sum(calls.values())))
            with probe.watch():
                digest_all = drain_first(engine, reqs, lambda c: (
                    ssm_state_digests(torch, c, slice(None), slice(None))))
    finally:
        kops.rwkv6_scan = scan
    rounds = probe.rounds()
    per_round = rounds["bytes_per_round"][2]
    launches = router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap("the rwkv6 requests served")
    tokens = [r.out_tokens for r in reqs]
    if tokens != ref["twin_tokens"]:
        fail(f"{label}: greedy tokens differ from the one-process twin's "
             f"(ssm_twin): {tokens} vs {ref['twin_tokens']}")
    if digest_all != ref["state_digests"][rank]:
        fail(f"{label}: its states after the first round differ from its "
             f"share of the twin's (worker {group.worker}'s rows, heads "
             f"of model rank {group.m})")
    differ = sum(a != b for x, y in zip(tokens, ref["plain_tokens"])
                 for a, b in zip(x, y))
    owned = sum(engine._mine(r.slot) for r in reqs)
    for r in reqs:
        want = cfg.num_layers if engine._mine(r.slot) else 0
        if scans[r.rid] != want:
            fail(f"{label}: request {r.rid} launched rwkv6_scan "
                 f"{scans[r.rid]} times, expected {want}")
    expect(label, launches, {"rwkv6_scan": cfg.num_layers * owned,
                             "flash_attention": 0})
    rank_shape = tuple(RWKV_RANK[x] for x in ("b", "h", "hd"))
    if shapes_seen != {rank_shape}:
        fail(f"{label}: the scan ran at (B, H, hd) {shapes_seen}, expected "
             f"{rank_shape}")
    row = {"owned": owned, "scan_per_request": cfg.num_layers,
           "prefill_s": probe.prefill_s,
           "decode_rounds": rounds["decode_rounds"],
           "round_ms_p50": rounds["round_ms_p50"],
           "round_ms_p99": rounds["round_ms_p99"],
           "reduced_bytes_per_round": rounds["bytes_per_round"][0],
           "gathered_bytes_per_round": rounds["bytes_per_round"][1],
           "collectives_per_round": per_round, "peak_gib": peak,
           "tokens_differing_from_plain": differ, "launches": launches}
    print(f"  {label} (worker {group.worker}, model {group.m}): greedy "
          f"tokens equal to the twin's; {differ} of "
          f"{sum(map(len, tokens))} differ from the plain engine's; states "
          f"equal to its share of the twin's; rwkv6_scan {cfg.num_layers} "
          f"a request at (B, H, hd) {rank_shape} x {owned} requests; "
          f"prefill_s {[round(x, 4) for x in probe.prefill_s]}; decode "
          f"rounds {row['decode_rounds']}, ms p50 "
          f"{row['round_ms_p50']:.2f} p99 {row['round_ms_p99']:.2f}; "
          f"{row['reduced_bytes_per_round']} B summed over \"model\" and "
          f"{row['gathered_bytes_per_round']} B gathered a round; "
          f"{per_round} collectives a round (one token a slot); peak_GiB "
          f"{peak:.2f} [{card_line()}]", flush=True)
    del engine
    release(torch)
    return row


def rank_ssm_exact(torch, rt, dist, refs: dict, work: Path, lap) -> dict:
    """rwkv6-3b at SSM19_EXACT_LAYERS over (data 2, model 2), one exact
    epoch (FSDP x TP, 20 heads a rank) under deterministic algorithms: 20
    ``dual_update`` launches on the blocks; the bytes over "data" the
    dry-run's ``rank_fsdp_bytes`` and over "model" its
    ``rank_model_bytes``, to the byte; the loss within MESH_LOSS_TOL of
    the twin's (``tp_sums``) and each gathered leaf within its
    ``order_limits`` of the twin's (rank 0)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract
    rank = dist.get_rank()
    label = f"phase 19 ssm exact rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(SSM_ARCH),
                              num_layers=SSM19_EXACT_LAYERS)
    mesh = rt.launch.mesh.make_host_mesh(*SSM_AXIS, device="cuda")
    ref = refs["ssm_exact"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", mesh, SSM_AXIS[0],
                               model=SSM_AXIS[1],
                               params=ssm19_params(torch, rt, cfg))
        release(torch)
        res = mesh_epochs(torch, rt, session, label, 1)
    lap("the rwkv6 exact epoch done")
    tp = session.tp
    expect(label, res["launches"], {"dual_update": 20})
    check_losses("phase 19 ssm exact", rank, res["losses"], ref["losses"])
    amesh = abstract(SSM_AXIS, ("data", "model"))
    held = {k: getattr(tp, k) for k in ("gathered_bytes", "scattered_bytes",
                                        "model_gathered_bytes",
                                        "reduced_bytes")}
    want = dict(dryrun.rank_fsdp_bytes(cfg, amesh),
                **dryrun.rank_model_bytes(cfg, amesh, PER_WORKER * SEQ))
    if held != want:
        fail(f"{label}: {held}, the dry-run's {want}")
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "heads": tp.ssm_heads(cfg), **held}
    print(f"  {label} (worker {session.group.worker}, model "
          f"{session.group.m}): {tp.ssm_heads(cfg)} heads; over \"data\" "
          f"gathered {held['gathered_bytes']} B, reduce-scattered "
          f"{held['scattered_bytes']} B; over \"model\" gathered "
          f"{held['model_gathered_bytes']} B, summed "
          f"{held['reduced_bytes']} B (all the dry-run's); epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} (the twin's "
          f"{ref['losses']}); dual_update "
          f"{res['launches'].get('dual_update', 0)} [{card_line()}]",
          flush=True)
    whole = session.params
    if rank == 0:
        twin = torch.load(work / "ssm19_twin.pt")
        row["limit_share"] = check_leaves(
            "phase 19 ssm exact (the ranks against the twin)",
            leaf_errs(torch, whole, twin), ref["limits"])
        del twin
    del session, whole
    release(torch)
    return row


def rank_ssm_gossip(torch, rt, dist, refs: dict, lap) -> dict:
    """rwkv6-3b at SSM19_GOSSIP_LAYERS in fp32 over (data 2, model 2), one
    ring gossip epoch (TP) of SSM19_ROUNDS rounds under deterministic
    algorithms: each rank's dual block bit for bit its block of the
    one-process twin's (``tp_sums``), the wire exactly
    ``wire_bytes_per_round(d_block)`` a round, 20 ``dual_update`` and
    SSM19_ROUNDS ``gossip_combine`` launches."""
    rank = dist.get_rank()
    label = f"phase 19 ssm gossip rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(SSM_ARCH),
                              num_layers=SSM19_GOSSIP_LAYERS,
                              dtype="float32")
    mesh = rt.launch.mesh.make_host_mesh(*SSM_AXIS, device="cuda")
    ref = refs["ssm_gossip"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "gossip", mesh, SSM_AXIS[0],
                               model=SSM_AXIS[1], rounds=SSM19_ROUNDS)
        res = mesh_epochs(torch, rt, session, label, 1)
    lap("the rwkv6 gossip epoch done")
    g = session.group
    expect(label, res["launches"], {"dual_update": 20,
                                    "gossip_combine": SSM19_ROUNDS})
    check_losses("phase 19 ssm gossip", rank, res["losses"], ref["losses"])
    width = session.tp.row_block().block_width
    strat = rt.dist.amb.strategy_from_config(
        dataclasses.replace(session.protocol.amb, active=None), SSM_AXIS[0])
    wire = strat.wire_bytes_per_round(width)
    if g.sent_bytes != SSM19_ROUNDS * wire:
        fail(f"{label}: sent {g.sent_bytes} bytes in {SSM19_ROUNDS} rounds; "
             f"wire_bytes_per_round({width}) {wire}")
    z = {k: v[0] for k, v in session.state["z"].items()}
    if as_json(digest(torch, z)) != ref["digests"][rank]:
        fail(f"{label}: its dual block differs from its block of the "
             f"one-process session under tp_sums")
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "block_width": width, "wire_bytes_per_round": wire}
    print(f"  {label} (worker {g.worker}, model {g.m}): dual block bit for "
          f"bit its block of the one-process session under tp_sums; "
          f"{g.sent_bytes // SSM19_ROUNDS} bytes a round = "
          f"wire_bytes_per_round(d_block {width}); epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} [{card_line()}]",
          flush=True)
    del session, z
    release(torch)
    return row


def rank_vlm_serve(torch, rt, dist, refs: dict, lap) -> dict:
    """internvl2-76b at VLM19_LAYERS over (data 2, model 2) through the
    slot engine on embeddings prompts (each rank's rows of the vocabulary:
    the vocab-parallel lookup), clock-free: the greedy tokens equal to the
    twin's (``rank_twin``); VLM19_LAYERS tensor-core flash launches a
    request on its worker's ranks at (B 1, H 32, KV 4, hd 128); per rank
    the prefill seconds, the decode round's ms and bytes."""
    rank = dist.get_rank()
    router = rt.kernels.router
    label = f"phase 19 vlm serve rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(VLM_ARCH),
                              num_layers=VLM19_LAYERS)
    ref = refs["vlm_serve"]
    reqs, slots, cache, seed = serve_spec(rt, cfg, VLM19_SERVE)
    engine, group, tp = rank_engine(torch, rt, cfg, seed, slots, cache,
                                    lambda: lap("the internvl2 serving "
                                                "blocks drawn"))
    probe = EngineProbe(torch, rt, engine, lambda: (
        tp.reduced_bytes, tp.model_gathered_bytes))
    with probe.watch():
        drain(engine, reqs)
    launches = router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap("the internvl2 requests served")
    tokens = [r.out_tokens for r in reqs]
    if tokens != ref["twin_tokens"]:
        fail(f"{label}: greedy tokens differ from the one-process twin's "
             f"(rank_twin): {tokens} vs {ref['twin_tokens']}")
    owned = probe.check_flash(label, reqs, cfg.num_layers, FLASH_VLM_RANK,
                              launches)
    rank_shape = tuple(FLASH_VLM_RANK[x] for x in ("b", "h", "kv", "hd"))
    rounds = probe.rounds()
    row = {"owned": owned, "flash_per_request": cfg.num_layers,
           "prefill_s": probe.prefill_s,
           "decode_rounds": rounds["decode_rounds"],
           "round_ms_p50": rounds["round_ms_p50"],
           "round_ms_p99": rounds["round_ms_p99"],
           "reduced_bytes_per_round": rounds["bytes_per_round"][0],
           "peak_gib": peak, "launches": launches}
    print(f"  {label} (worker {group.worker}, model {group.m}): greedy "
          f"tokens equal to the twin's; flash {cfg.num_layers} a request "
          f"on the tensor cores at (B, H, KV, hd) {rank_shape} x {owned} "
          f"requests; prefill_s {[round(x, 4) for x in probe.prefill_s]}; "
          f"decode rounds {row['decode_rounds']}, ms p50 "
          f"{row['round_ms_p50']:.2f} p99 {row['round_ms_p99']:.2f}; "
          f"{row['reduced_bytes_per_round']} B summed over \"model\" a "
          f"round; peak_GiB {peak:.2f} [{card_line()}]", flush=True)
    del engine
    release(torch)
    return row


def rank_axis19(torch, rt, dist, work: Path) -> None:
    """Phase 19's turn of the gloo launch, once the parent's references
    are written: rwkv6-3b's engine at full width, its exact epoch and its
    fp32 gossip epoch over (data 2, model 2), then internvl2-76b's engine
    on the same mesh; each rank's results to ``axis19_rank<r>.json``."""
    rank = dist.get_rank()
    lap = stamps("phase 19 rank 0", rank)
    refs = torch.load(work / "axis19_refs.pt")
    out = {"ssm serve": rank_ssm_serve(torch, rt, dist, refs, lap),
           "ssm exact": rank_ssm_exact(torch, rt, dist, refs, work, lap),
           "ssm gossip": rank_ssm_gossip(torch, rt, dist, refs, lap),
           "vlm serve": rank_vlm_serve(torch, rt, dist, refs, lap)}
    (work / f"axis19_rank{rank}.json").write_text(json.dumps(out))


def axis19_after(work: Path) -> dict:
    """Phase 19 after the gloo ranks: their rows and launch counts."""
    ranks = [json.loads((work / f"axis19_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    launches = {f"{run} rank {r}": res[run]["launches"]
                for r, res in enumerate(ranks) for run in res}
    print(f"phase 19: every rank's checks held; launches "
          f"{json.dumps(launches)} [{card_line()}]", flush=True)
    return {"launches": launches, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 20: the audio family over a model axis
# ---------------------------------------------------------------------------

AUDIO_AXIS = (2, 2)            # (data, model): 4 of whisper's 8 heads a rank
# whisper-base at full width and depth (6 + 6 layers) over (data 2, model
# 2), bf16: 8 requests, each its own seeded 1500 frames and a prompt of
# WHISPER_PROMPT tokens (the range's two ends among them), each worker its
# 4 in 4 slot rows, AUDIO20_SERVE["new"] greedy tokens a request (the
# prefill's, then a decode round each), served through the model-level
# functions (the slot engine refuses audio, as JAX's does); an exact epoch
# and an fp32 gossip epoch of AUDIO20_ROUNDS rounds at full depth, 2
# workers x PER_WORKER x SEQ tokens with their frames
AUDIO20_SERVE = dict(requests=8, new=32, seed=40)
AUDIO20_BATCH_SEED = 41
AUDIO20_ROUNDS = 2
# the twin against the plain model (the same parameters, the same
# requests, each worker's rows alone): each prefill's logits, and the
# first round's on the rows whose first token agrees, within
# AUDIO20_LOGIT_TOL of the plain logits' largest magnitude.  The twin
# differs from the plain model by summation order only: about one bf16
# unit (2 ** -8) of the residual for each row-parallel sum on a request's
# path, 30 of them (two in each of 6 encoder layers, three in each of 6
# decoder layers), rounded up to 32; a misplaced head or block moves
# random-weight logits by about their own size
AUDIO20_LOGIT_TOL = 32 * 2.0 ** -8
FLASH_WHISPER_RANK = dict(b=1, h=4, kv=4, hd=64)  # whisper, a rank of model 2


def audio20_requests(torch, cfg) -> list:
    """Phase 20's requests, on the card: (prompt ids (1, S), frames (1,
    frames, d) in the model's dtype), from AUDIO20_SERVE's seed; the
    prompt lengths drawn from WHISPER_PROMPT's range, the first and the
    last its two ends."""
    n, seed = AUDIO20_SERVE["requests"], AUDIO20_SERVE["seed"]
    lens = torch.randint(WHISPER_PROMPT[0], WHISPER_PROMPT[1] + 1, (n,),
                         generator=torch.Generator().manual_seed(seed)
                         ).tolist()
    lens[0], lens[-1] = WHISPER_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device="cuda"),
             torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda", dtype=cfg.torch_dtype))
            for s in lens]


def audio20_batch(torch, cfg) -> dict:
    """Phase 20's training batch, on the card: 2 workers x PER_WORKER
    sequences of SEQ tokens from AUDIO20_BATCH_SEED, their next-token
    labels (-1 after the last), and each sequence's frames."""
    gen = torch.Generator(device="cuda").manual_seed(AUDIO20_BATCH_SEED)
    rows = AUDIO_AXIS[0] * PER_WORKER
    tokens = torch.randint(0, cfg.vocab_size, (rows, SEQ), generator=gen,
                           device="cuda")
    labels = torch.cat([tokens[:, 1:], torch.full((rows, 1), -1,
                                                  device="cuda")], 1)
    return {"tokens": tokens, "labels": labels,
            "enc_embeds": torch.randn((rows, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device="cuda",
                                      dtype=cfg.torch_dtype)}


def audio20_serve(torch, rt, params, cfg, reqs, tp=None, heads=None,
                  counters=None) -> dict:
    """``reqs`` through the model-level functions, one slot row each: a
    batch-1 prefill inserted into its row (``prefill``,
    ``insert_decode_state``), then greedy decode rounds of every row at
    its own position (``decode_step``), then every row evicted (its
    caches, ``enc_kv`` and position zero, checked).  With ``tp`` this
    rank's blocks, its heads, and the logits gathered over "model" and
    cut to the vocabulary (``TensorParallel.vocab_logits``).  Returns
    the tokens, the logits of each prefill and of the first round (host
    fp32), the digest of ``enc_kv`` and the self-attention caches after
    the prefills for each of ``heads`` (KV head slices; default all),
    each prefill's seconds and flash launches by body, each round's ms
    and the growth of ``counters()`` in it."""
    models, router = rt.models, rt.kernels.router
    cache = WHISPER_PROMPT[1] + AUDIO20_SERVE["new"]   # the longest prompt's
    state = models.init_decode_state(cfg, len(reqs), cache,
                                     per_slot_pos=True, device="cuda",
                                     tp=tp)

    def whole(logits):
        return logits if tp is None else tp.vocab_logits(logits,
                                                         cfg.vocab_size)

    def flashes():
        got = router.launches()
        return [got.get(f"flash_attention.{b}", 0)
                for b in ("tensor_core", "cuda_core")]

    seen, first, prefill_s, per_flash = [], [], [], []
    bad = torch.zeros((), dtype=torch.long, device="cuda")
    for slot, (ids, frames) in enumerate(reqs):
        f0 = flashes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, one = models.prefill(
            params, cfg, {"tokens": ids, "enc_embeds": frames},
            extra_capacity=cache - ids.shape[1], tp=tp)
        models.insert_decode_state(state, one, slot)
        logits = whole(logits)
        first.append(logits.argmax(-1))
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        per_flash.append([b - a for a, b in zip(f0, flashes())])
        bad += (~torch.isfinite(logits)).sum()
        seen.append(logits.float().cpu())
        del one, logits
    ek, ev = state.enc_kv
    digests = [as_json(digest(torch, {
        "enc_k": ek[..., h, :], "enc_v": ev[..., h, :],
        "k": state.caches.k[..., h, :], "v": state.caches.v[..., h, :]}))
        for h in (heads or [slice(None)])]
    tok = torch.cat(first)
    toks, round_ms, moved = [tok], [], []
    for i in range(AUDIO20_SERVE["new"] - 1):
        c0 = counters() if counters else ()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = models.decode_step(params, cfg, state, tok, tp=tp)
        logits = whole(logits)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        moved.append([b - a for a, b in zip(c0, counters() if counters
                                            else ())])
        bad += (~torch.isfinite(logits)).sum()
        if i == 0:
            seen.append(logits.float().cpu())
        toks.append(tok)
        del logits
    tokens = torch.stack(toks, 1).tolist()
    for slot in range(len(reqs)):
        models.evict_decode_state(state, slot)
    if any(t.any() for t in models.model._cache_tensors(
            (state.caches, state.enc_kv))) or state.pos.any():
        fail(f"phase 20 {WHISPER_ARCH}: the evicted slot rows are not zero")
    if int(bad):
        fail(f"phase 20 {WHISPER_ARCH}: {int(bad)} non-finite logits")
    if max(max(t) for t in tokens) >= cfg.vocab_size:
        fail(f"phase 20 {WHISPER_ARCH}: a token id at or past the "
             f"vocabulary's {cfg.vocab_size} (a padded row)")
    del state
    return {"tokens": tokens, "seen": seen, "digests": digests,
            "prefill_s": prefill_s, "flashes": per_flash,
            "round_ms": round_ms, "moved": moved}


@contextlib.contextmanager
def audio_twin(torch, rt, cfg, m: int):
    """Whisper's serving as ``m`` model ranks compute it, in one process
    (phase 20; ``rank_twin`` for its self-attention, flash calls, cache
    reads, MLP and logits): the cross-attention's q, k and v besides,
    each rank's from its contiguous columns of ``wq``, ``wk`` and ``wv``
    (k and v of the encoder's output), at a prefill (``_project_qkv``) and
    at a decode step (``decode_attend`` with ``cross_kv``: each rank's q
    against its heads of ``enc_kv``), their ``wo`` products summed by
    rank.  A worker's rows are served alone (call it once a worker)."""
    attn = rt.models.attention
    hd, kv_r = cfg.hd, cfg.num_kv_heads // m
    plain_project, plain_decode = attn._project_qkv, attn.decode_attend

    def cols(w, r):
        c = w.shape[-1] // m
        return w[..., r * c:(r + 1) * c].contiguous()

    def project(p, x, cfg_, kv_input=None, tp=None):
        if "bq" in p or "q_norm" in p:
            raise ValueError("audio_twin: the cross-attention has no QKV "
                             "bias and no qk-norm")
        b, s, _ = x.shape
        xkv = x if kv_input is None else kv_input
        skv = xkv.shape[1]
        return (torch.cat([(x @ cols(p["wq"], r)).reshape(b, s, kv_r, -1, hd)
                           for r in range(m)], dim=2),
                torch.cat([(xkv @ cols(p["wk"], r)).reshape(b, skv, kv_r, hd)
                           for r in range(m)], dim=2),
                torch.cat([(xkv @ cols(p["wv"], r)).reshape(b, skv, kv_r, hd)
                           for r in range(m)], dim=2))

    def decode(p, x, pos, cache, cfg_, *, window=0, cross_kv=None,
               cross_len=0, tp=None):
        if cross_kv is None:
            return plain_decode(p, x, pos, cache, cfg_, window=window, tp=tp)
        b = x.shape[0]
        q = torch.cat([(x @ cols(p["wq"], r)).reshape(b, 1, kv_r, -1, hd)
                       for r in range(m)], dim=2)
        out = attn._softmax_read(q, *cross_kv, None).to(x.dtype)
        return out @ p["wo"], cache

    with rank_twin(torch, rt, cfg, m, 1):
        attn._project_qkv, attn.decode_attend = project, decode
        try:
            yield
        finally:
            attn._project_qkv, attn.decode_attend = plain_project, \
                plain_decode


def audio_epoch(torch, rt, session, batch: dict, label: str) -> dict:
    """One epoch of ``session`` on ``batch`` (over a group, its worker's
    rows), b from the session's clock, as ``mesh_epochs`` reports one."""
    if session.group is not None:
        w = session.group.worker
        batch = {k: v[w * PER_WORKER:(w + 1) * PER_WORKER]
                 for k, v in batch.items()}
    rt.kernels.router.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = session.step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not math.isfinite(m["loss"]):
        fail(f"{label}: loss {m['loss']}")
    return {"losses": [m["loss"]], "epoch_s": [secs],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": rt.kernels.router.launches()}


def axis20_references(torch, rt, work: Path) -> None:
    """Phase 20's references, in the parent after phase 19's, written for
    the ranks:
      * whisper-base at full width, bf16, from AUDIO20_SERVE's seed,
        through the model-level serving functions, each worker's 4
        requests alone: plain, and as its 2 model ranks compute it
        (``audio_twin``): the twin's tokens, each rank's heads of its
        ``enc_kv`` and caches after the prefills by digest, and the twin
        held to the plain model (``check_ssm19_twin``);
      * one exact epoch at full depth of the one-process data=2 session
        on ``audio20_batch``, plain and under ``tp_sums``: each leaf's
        move sets its limit; the twin's parameters and loss are what the
        ranks are held to; the plain session saved (``ck20_one``, model
        2 in its TrainSpec), the archive the ranks restore;
      * one fp32 gossip epoch at full depth, AUDIO20_ROUNDS rounds, under
        ``tp_sums``: the digest of each rank's block of its worker's dual
        (``block_digests``)."""
    lap = stamps("phase 20 references")
    refs = {}
    data, m = AUDIO_AXIS
    full = rt.configs.get_config(WHISPER_ARCH)
    params = rt.models.init_params(
        full, torch.Generator(device="cuda").manual_seed(
            AUDIO20_SERVE["seed"]))
    reqs = audio20_requests(torch, full)
    per, h = len(reqs) // data, full.num_kv_heads // m
    parts = [reqs[w * per:(w + 1) * per] for w in range(data)]
    plain = [audio20_serve(torch, rt, params, full, part) for part in parts]
    with audio_twin(torch, rt, full, m):
        twin = [audio20_serve(torch, rt, params, full, part, heads=[
            slice(r * h, (r + 1) * h) for r in range(m)]) for part in parts]

    def seen(runs):
        return ([x for run in runs for x in run["seen"][:per]]
                + [torch.cat([run["seen"][per] for run in runs])])

    plain_tokens = [t for run in plain for t in run["tokens"]]
    twin_tokens = [t for run in twin for t in run["tokens"]]
    check_ssm19_twin(torch, seen(plain), seen(twin), plain_tokens,
                     twin_tokens, AUDIO20_LOGIT_TOL, "bf16",
                     "phase 20 reference: the whisper")
    refs["serve"] = {"plain_tokens": plain_tokens,
                     "twin_tokens": [run["tokens"] for run in twin],
                     "digests": [d for run in twin for d in run["digests"]]}
    del params, plain, twin
    release(torch)
    lap("the whisper serve twin done")
    batch = audio20_batch(torch, full)
    with deterministic(torch):
        session = mesh_session(rt, full, "exact", False, data=data, model=m)
        res = audio_epoch(torch, rt, session, batch,
                          "phase 20 audio exact reference")
        plain = {k: v.detach() for k, v in session.params.items()}
        session.save(work / "ck20_one")
        del session
        release(torch)
        with tp_sums(torch, rt, m):
            session = mesh_session(rt, full, "exact", False, data=data,
                                   model=m)
            twin = audio_epoch(torch, rt, session, batch,
                               "phase 20 audio exact twin")
        moves = leaf_errs(torch, session.params, plain)
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "audio20_twin.pt")
        del session, plain
        release(torch)
    refs["exact"] = {"losses": twin["losses"],
                     "plain_losses": res["losses"], "moves": moves,
                     "limits": check_order("phase 20 audio exact", moves)}
    print(f"phase 20 reference audio exact ({full.num_layers} + "
          f"{full.encoder_layers} layers, one process, {data} workers): "
          f"losses {res['losses']} epoch_s {res['epoch_s']} peak_GiB "
          f"{res['peak_gib']:.2f}; the twin's over {m} model ranks "
          f"{twin['losses']} [{card_line()}]", flush=True)
    lap("the whisper exact references done")
    cfg = dataclasses.replace(full, dtype="float32")
    with deterministic(torch), tp_sums(torch, rt, m):
        session = mesh_session(rt, cfg, "gossip", False, data=data,
                               rounds=AUDIO20_ROUNDS)
        res = audio_epoch(torch, rt, session, batch,
                          "phase 20 audio gossip twin")
        refs["gossip"] = {"losses": res["losses"],
                          "digests": block_digests(torch, rt,
                                                   session.state["z"])}
        del session
        release(torch)
    print(f"phase 20 reference audio gossip (fp32, one process, {data} "
          f"workers, r {AUDIO20_ROUNDS}, tp_sums): losses {res['losses']} "
          f"epoch_s {res['epoch_s']} peak_GiB {res['peak_gib']:.2f} "
          f"[{card_line()}]", flush=True)
    lap("the whisper gossip twin done")
    torch.save(refs, work / "axis20_refs.pt")


def rank_audio_serve(torch, rt, dist, refs: dict, lap) -> dict:
    """whisper-base at full width, bf16, over (data 2, model 2) through
    the model-level functions (``audio20_serve``): each rank's serving
    blocks from the seed (``init_shards``, the serving layout), its
    worker's 4 requests in 4 slot rows: the greedy tokens equal to the
    twin's (``audio_twin``) and the count that differ from the plain
    model's; its ``enc_kv`` and caches after the prefills its heads of
    the twin's by digest; 18 tensor-core flash launches a request (6
    encoder, 6 self, 6 cross) at (B 1, H 4, KV 4, hd 64); per rank the
    prefill seconds, the decode round's ms (p50, p99), the bytes summed
    over "model" and the collectives a round, the peak."""
    rank = dist.get_rank()
    router = rt.kernels.router
    label = f"phase 20 audio serve rank {rank}"
    cfg = rt.configs.get_config(WHISPER_ARCH)
    mesh = rt.launch.mesh.make_host_mesh(*AUDIO_AXIS, device="cuda")
    group = rt.dist.group.WorkerGroup(mesh, "cuda")
    tp = rt.dist.tp.TensorParallel(group, model_shapes(rt, cfg), None, cfg)
    params = rt.dist.params.init_shards(
        cfg, torch.Generator(device="cuda").manual_seed(
            AUDIO20_SERVE["seed"]), mesh, mesh.get_coordinate(), None)
    reqs = audio20_requests(torch, cfg)
    per = len(reqs) // AUDIO_AXIS[0]
    mine = reqs[group.worker * per:(group.worker + 1) * per]
    lap("the whisper serving blocks drawn")
    kops = rt.models.attention.kops
    flash, shapes = kops.flash_attention, set()

    def seen(q, k, v, **kw):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[3]))
        return flash(q, k, v, **kw)

    torch.cuda.reset_peak_memory_stats()
    router.reset_launches()
    kops.flash_attention = seen
    try:
        with count_collectives(dist) as calls:
            res = audio20_serve(torch, rt, params, cfg, mine, tp,
                                counters=lambda: (tp.reduced_bytes,
                                                  sum(calls.values())))
    finally:
        kops.flash_attention = flash
    launches = router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap("the whisper requests served")
    ref = refs["serve"]
    if res["tokens"] != ref["twin_tokens"][group.worker]:
        fail(f"{label}: greedy tokens differ from the one-process twin's "
             f"(audio_twin): {res['tokens']} vs "
             f"{ref['twin_tokens'][group.worker]}")
    if res["digests"][0] != ref["digests"][rank]:
        fail(f"{label}: its enc_kv and caches after the prefills differ "
             f"from its heads of the twin's (worker {group.worker}'s rows, "
             f"model rank {group.m})")
    per_req = cfg.encoder_layers + 2 * cfg.num_layers
    for i, got in enumerate(res["flashes"]):
        if got != [per_req, 0]:
            fail(f"{label}: request {i} launched flash {got} (tensor "
                 f"cores, CUDA cores), expected [{per_req}, 0]")
    expect(label, launches, {"flash_attention": per_req * per,
                             "flash_attention.tensor_core": per_req * per,
                             "dual_update": 0})
    rank_shape = tuple(FLASH_WHISPER_RANK[x] for x in ("b", "h", "kv", "hd"))
    if shapes != {rank_shape}:
        fail(f"{label}: flash called at (B, H, KV, hd) {shapes}, expected "
             f"{rank_shape}")
    lo = group.worker * per
    differ = sum(a != b for x, y in zip(res["tokens"],
                                        ref["plain_tokens"][lo:lo + per])
                 for a, b in zip(x, y))
    ms = sorted(res["round_ms"])
    pct = sys.modules["repro_torch.serve.metrics"]._pct
    moved = [sorted(c)[len(c) // 2] for c in zip(*res["moved"])]
    row = {"owned": per, "flash_per_request": per_req,
           "prefill_s": res["prefill_s"], "decode_rounds": len(ms),
           "round_ms_p50": pct(ms, 50), "round_ms_p99": pct(ms, 99),
           "reduced_bytes_per_round": moved[0],
           "collectives_per_round": moved[1], "peak_gib": peak,
           "tokens_differing_from_plain": differ, "launches": launches}
    print(f"  {label} (worker {group.worker}, model {group.m}): greedy "
          f"tokens equal to the twin's; {differ} of "
          f"{sum(map(len, res['tokens']))} differ from the plain model's; "
          f"enc_kv and caches its heads of the twin's; flash {per_req} a "
          f"request on the tensor cores at (B, H, KV, hd) {rank_shape} x "
          f"{per} requests; prefill_s "
          f"{[round(x, 4) for x in res['prefill_s']]}; decode rounds "
          f"{len(ms)}, ms p50 {row['round_ms_p50']:.2f} p99 "
          f"{row['round_ms_p99']:.2f}; {moved[0]} B summed over \"model\" "
          f"and {moved[1]} collectives a round; peak_GiB {peak:.2f} "
          f"[{card_line()}]", flush=True)
    del params
    release(torch)
    return row


def rank_audio_exact(torch, rt, dist, refs: dict, work: Path, lap) -> dict:
    """whisper-base at full depth over (data 2, model 2), one exact epoch
    (FSDP x TP, 4 heads a rank) on ``audio20_batch`` under deterministic
    algorithms: 27 ``dual_update`` launches on the blocks; the bytes over
    "data" the dry-run's ``rank_fsdp_bytes`` and over "model" its
    ``rank_model_bytes``, to the byte; the loss within MESH_LOSS_TOL of
    the twin's (``tp_sums``), the replicated leaves equal on every rank,
    and each gathered leaf within its ``order_limits`` of the twin's
    (rank 0)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract
    rank = dist.get_rank()
    label = f"phase 20 audio exact rank {rank}"
    cfg = rt.configs.get_config(WHISPER_ARCH)
    mesh = rt.launch.mesh.make_host_mesh(*AUDIO_AXIS, device="cuda")
    ref = refs["exact"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", mesh, AUDIO_AXIS[0],
                               model=AUDIO_AXIS[1])
        res = audio_epoch(torch, rt, session, audio20_batch(torch, cfg),
                          label)
    lap("the whisper exact epoch done")
    tp = session.tp
    leaves = len(session.state["params"])
    expect(label, res["launches"], {"dual_update": leaves})
    check_losses("phase 20 audio exact", rank, res["losses"], ref["losses"])
    same_replicated(torch, dist, session, session.state["params"], "exact")
    amesh = abstract(AUDIO_AXIS, ("data", "model"))
    held = {k: getattr(tp, k) for k in ("gathered_bytes", "scattered_bytes",
                                        "model_gathered_bytes",
                                        "reduced_bytes")}
    want = dict(dryrun.rank_fsdp_bytes(cfg, amesh),
                **dryrun.rank_model_bytes(cfg, amesh, PER_WORKER * SEQ,
                                          frames=PER_WORKER
                                          * cfg.encoder_seq))
    if held != want:
        fail(f"{label}: {held}, the dry-run's {want}")
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "heads": tp.q_heads(cfg), **held}
    print(f"  {label} (worker {session.group.worker}, model "
          f"{session.group.m}): {tp.q_heads(cfg)} heads; over \"data\" "
          f"gathered {held['gathered_bytes']} B, reduce-scattered "
          f"{held['scattered_bytes']} B; over \"model\" summed "
          f"{held['reduced_bytes']} B (all the dry-run's); the replicated "
          f"leaves equal on every rank; epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} (the twin's "
          f"{ref['losses']}); dual_update "
          f"{res['launches'].get('dual_update', 0)} [{card_line()}]",
          flush=True)
    whole = session.params
    if rank == 0:
        twin = torch.load(work / "audio20_twin.pt")
        row["limit_share"] = check_leaves(
            "phase 20 audio exact (the ranks against the twin)",
            leaf_errs(torch, whole, twin), ref["limits"])
        del twin
    del session, whole
    release(torch)
    return row


def rank_audio_gossip(torch, rt, dist, refs: dict, lap) -> dict:
    """whisper-base at full depth in fp32 over (data 2, model 2), one ring
    gossip epoch (TP) of AUDIO20_ROUNDS rounds on ``audio20_batch`` under
    deterministic algorithms: each rank's dual block bit for bit its
    block of the one-process twin's (``tp_sums``), the wire exactly
    ``wire_bytes_per_round(d_block)`` a round, 27 ``dual_update`` and
    AUDIO20_ROUNDS ``gossip_combine`` launches."""
    rank = dist.get_rank()
    label = f"phase 20 audio gossip rank {rank}"
    full = rt.configs.get_config(WHISPER_ARCH)
    cfg = dataclasses.replace(full, dtype="float32")
    mesh = rt.launch.mesh.make_host_mesh(*AUDIO_AXIS, device="cuda")
    ref = refs["gossip"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "gossip", mesh, AUDIO_AXIS[0],
                               model=AUDIO_AXIS[1], rounds=AUDIO20_ROUNDS)
        # the bf16 batch the references take (the model casts the frames)
        res = audio_epoch(torch, rt, session, audio20_batch(torch, full),
                          label)
    lap("the whisper gossip epoch done")
    g = session.group
    leaves = len(session.state["z"])
    expect(label, res["launches"], {"dual_update": leaves,
                                    "gossip_combine": AUDIO20_ROUNDS})
    check_losses("phase 20 audio gossip", rank, res["losses"], ref["losses"])
    width = session.tp.row_block().block_width
    strat = rt.dist.amb.strategy_from_config(
        dataclasses.replace(session.protocol.amb, active=None),
        AUDIO_AXIS[0])
    wire = strat.wire_bytes_per_round(width)
    if g.sent_bytes != AUDIO20_ROUNDS * wire:
        fail(f"{label}: sent {g.sent_bytes} bytes in {AUDIO20_ROUNDS} "
             f"rounds; wire_bytes_per_round({width}) {wire}")
    z = {k: v[0] for k, v in session.state["z"].items()}
    if as_json(digest(torch, z)) != ref["digests"][rank]:
        fail(f"{label}: its dual block differs from its block of the "
             f"one-process session under tp_sums")
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "block_width": width, "wire_bytes_per_round": wire}
    print(f"  {label} (worker {g.worker}, model {g.m}): dual block bit for "
          f"bit its block of the one-process session under tp_sums; "
          f"{g.sent_bytes // AUDIO20_ROUNDS} bytes a round = "
          f"wire_bytes_per_round(d_block {width}); epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} [{card_line()}]",
          flush=True)
    del session, z
    release(torch)
    return row


def rank_audio_ckpt(torch, rt, dist, work: Path, lap) -> dict:
    """A whisper checkpoint at model 2: each rank restores the parent's
    one-process exact archive (``ck20_one``), saves it (``ck20_back``),
    and restores its own save: the state read back bit for bit, block
    for block; the archive's bytes, save and restore seconds."""
    rank = dist.get_rank()
    label = f"phase 20 audio checkpoint rank {rank}"
    cfg = rt.configs.get_config(WHISPER_ARCH)
    session = rt.api.AMBSession.restore(work / "ck20_one", cfg=cfg,
                                        device="cuda")
    if session.tp is None or session.group.model != AUDIO_AXIS[1]:
        fail(f"{label}: the restore is not over (data 2, model 2)")
    before = as_json(digest(torch, session.state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.save(work / "ck20_back")
    save_s = time.perf_counter() - t0
    del session
    release(torch)
    t0 = time.perf_counter()
    back = rt.api.AMBSession.restore(work / "ck20_back", cfg=cfg,
                                     device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if as_json(digest(torch, back.state)) != before:
        fail(f"{label}: the state read back is not the state saved")
    nbytes = dir_bytes(work / "ck20_back")
    print(f"  {label}: the state read back bit for bit, block for block; "
          f"{nbytes} B, save {save_s:.3f} s "
          f"({nbytes / save_s / 1e9:.3f} GB/s), restore {restore_s:.3f} s "
          f"({nbytes / restore_s / 1e9:.3f} GB/s)", flush=True)
    del back
    release(torch)
    lap("the whisper checkpoint done")
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s}


def rank_axis20(torch, rt, dist, work: Path) -> None:
    """Phase 20's turn of the gloo launch, once the parent's references
    are written: whisper-base's serving, its exact and fp32 gossip epochs
    and a checkpoint over (data 2, model 2); each rank's results to
    ``axis20_rank<r>.json``."""
    rank = dist.get_rank()
    lap = stamps("phase 20 rank 0", rank)
    refs = torch.load(work / "axis20_refs.pt")
    out = {"audio serve": rank_audio_serve(torch, rt, dist, refs, lap),
           "audio exact": rank_audio_exact(torch, rt, dist, refs, work, lap),
           "audio gossip": rank_audio_gossip(torch, rt, dist, refs, lap),
           "audio ckpt": rank_audio_ckpt(torch, rt, dist, work, lap)}
    (work / f"axis20_rank{rank}.json").write_text(json.dumps(out))


def axis20_after(torch, rt, work: Path) -> dict:
    """Phase 20 after the gloo ranks: the ranks' save of the one-process
    archive leaf for leaf that archive (the encoder's and the
    cross-attention's leaves among them); their rows and launch
    counts."""
    ranks = [json.loads((work / f"axis20_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    ckpt = rt.ckpt.checkpoint
    for sub in ("", "session_state"):
        a = ckpt._Reader(work / "ck20_one" / sub, 1)
        b = ckpt._Reader(work / "ck20_back" / sub, 1)
        if not any("encoder/blocks" in k for k in a.data.files) or not any(
                "xattn" in k for k in a.data.files):
            fail(f"phase 20 checkpoint: the archive lacks the encoder's or "
                 f"the cross-attention's leaves ({sub or 'primal'})")
        if a.manifest != b.manifest or any(
                not (a.data[k].dtype == b.data[k].dtype
                     and (a.data[k] == b.data[k]).all())
                for k in a.data.files):
            fail(f"phase 20 checkpoint: the ranks' save of the restored "
                 f"archive is not the one-process archive "
                 f"({sub or 'primal'})")
    launches = {f"{run} rank {r}": res[run]["launches"]
                for r, res in enumerate(ranks) for run in res
                if "launches" in res[run]}
    print(f"phase 20: every rank's checks held; the ranks' save of the "
          f"one-process whisper archive is that archive, leaf for leaf; "
          f"launches {json.dumps(launches)} [{card_line()}]", flush=True)
    return {"launches": launches, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 21: the hybrid family over a model axis
# ---------------------------------------------------------------------------

HYBRID_AXIS = (2, 2)           # (data, model): 32 of zamba2's 64 Mamba2
# heads and 16 of its shared block's 32 attention heads a rank.
# zamba2-1.2b at full width over (data 2, model 2), bf16: the slot engine
# at all 38 layers (8 requests of 2048 +- 512 tokens into 8 slots, 32 new
# tokens: each worker owns 4 slots and prefills its 4 requests), an exact
# epoch at HYBRID21_EXACT_LAYERS (the shared block applied twice, so its
# gradient accumulates over two applications before the reduce-scatter),
# an fp32 gossip epoch at HYBRID21_GOSSIP_LAYERS (one application) with
# HYBRID21_ROUNDS rounds, and a checkpoint at model 2 of an exact session
# at HYBRID21_CKPT_LAYERS (its archive 2.5 GB: the embedding, the
# unembedding and the shared block are most of it at any depth)
HYBRID21_SERVE = dict(requests=8, new=32, slots=8, prompt=2048, jitter=512,
                      seed=50)
HYBRID21_EXACT_LAYERS = 12
HYBRID21_GOSSIP_LAYERS = 6
HYBRID21_ROUNDS = 2
HYBRID21_CKPT_LAYERS = 2
# the exact epoch starts from the seed's parameters with the two Mamba2
# leaves that init makes zero drawn as Mamba2's own init draws them
# (HYBRID21_REDRAW_SEED: A uniform in [1, 16], a_log = log A; dt
# log-uniform in [0.001, 0.1], dt_bias its inverse softplus), as real
# checkpoints hold them: from JAX's zeros the first exact step's a_log and
# dt_bias are their rounding-bound updates alone, which the ranks'
# summation order moved by 0.0925 and 0.0452 of their largest values (an
# H100 at 700 W), past MESH_PARAM_TOL, where no limit could tell a fault
# from the order
HYBRID21_REDRAW_SEED = 21
# the engine's twin against the plain engine (the same parameters, the
# same prompts): each prefill's logits, and the first round's on the rows
# whose first token agrees, within HYBRID21_LOGIT_TOL of the plain logits'
# largest magnitude.  The twin differs from the plain engine by summation
# order only: about one bf16 unit (2 ** -8) of the residual for each
# row-parallel sum on a request's path, 50 of them (each of 38 Mamba2
# layers' w_out, two in each of 6 shared applications), and the packed
# projection and the scan at a rank's width, rounded up to 64; a
# misplaced head, channel or leaf block moves random-weight logits by
# about their own size
HYBRID21_LOGIT_TOL = 64 * 2.0 ** -8
FLASH_ZAMBA_RANK = dict(b=1, h=16, kv=16, hd=64)  # zamba2, a rank of model 2
FLASH21_SEQS = (2048,)


def hybrid21_params(torch, rt, cfg) -> dict:
    """zamba2-1.2b's whole parameters at ``cfg`` on the card from seed 0
    (``init_params``), ``a_log`` and ``dt_bias`` drawn from
    HYBRID21_REDRAW_SEED (see there): the same on every rank."""
    params = rt.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(HYBRID21_REDRAW_SEED)
    shape = params["blocks.mamba.a_log"].shape
    a = 1.0 + 15.0 * torch.rand(shape, generator=gen, device="cuda")
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                               device="cuda"))
    params["blocks.mamba.a_log"] = torch.log(a)
    params["blocks.mamba.dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    return params


def _rank_channels(torch, cfg, r: int, m: int):
    """Rank r of m's channels of the hybrid's whole conv tail: its heads'
    x channels, then B and C."""
    d_in, ns = 2 * cfg.d_model, cfg.ssm_state
    c = d_in // m
    return torch.cat([torch.arange(r * c, (r + 1) * c),
                      torch.arange(d_in, d_in + 2 * ns)])


@contextlib.contextmanager
def hybrid_twin(torch, rt, cfg, m: int, workers: int):
    """``rank_twin`` for the hybrid family: a one-process slot engine as
    ``workers`` workers of ``m`` model ranks serve.  The shared block's
    attention, MLP and the logits are ``rank_twin``'s; each Mamba2 layer
    runs once a rank on the port's own cut of the whole leaves
    (``mamba2_rank_leaves``: its heads' x, z and dt columns and B, C
    whole; its rows of ``w_out``), from the same normed input, each
    rank's sum of squares put together in rank order, the ranks' outputs
    summed in fp32 in rank order and rounded once.  The states keep the
    whole layout (rank r's are heads r H / m to (r + 1) H / m, its conv
    channels ``_rank_channels``), and a decode round runs each worker's
    rows alone."""
    model, ssm, common = rt.models.model, rt.models.ssm, rt.models.common
    attn = rt.models.attention
    slots_mod = sys.modules["repro_torch.serve.slots"]
    d_in, heads, _ = ssm.mamba2_dims(cfg)
    c, h = d_in // m, heads // m
    chans = [_rank_channels(torch, cfg, r, m) for r in range(m)]

    def mamba(lp, xn, states=None):
        """One Mamba2 layer as the ranks run it: (its output, each rank's
        state after it); ``states``: each rank's before a decode step
        (None: a prefill)."""
        leaves, ys, zs, news = [], [], [], []
        for r in range(m):
            pr = ssm.mamba2_rank_leaves(lp, r, m)
            pr["w_out"] = lp["w_out"][r * c:(r + 1) * c]
            if states is None:
                y, z, st = ssm.mamba2_inner(pr, xn, cfg)
            else:
                y, z, st = ssm.mamba2_step(pr, xn, states[r], cfg)
            leaves.append(pr)
            ys.append(y)
            zs.append(z)
            news.append(st)
        squares = [(y * y).sum(dim=-1, keepdim=True) for y in ys]
        outs = [ssm.mamba2_norm_out(leaves[r], ys[r], zs[r], xn, d_in,
                                    squares) for r in range(m)]
        return _rank_sum(torch, outs, xn.dtype), news

    def prefill_hybrid(params, cfg_, x, cap, tp=None):
        caches = model._hybrid_caches(cfg, x.shape[0], cap, x.device)
        shared, app = model._shared(params), 0
        for layer, lp in enumerate(model._layers(params, cfg)):
            out, news = mamba(lp["mamba"], common.rms_norm(x, lp["ln1"]))
            x.add_(out)
            for r, st in enumerate(news):
                caches["mamba"].h[layer][:, r * h:(r + 1) * h] = st.h
                caches["mamba"].conv[layer][..., chans[r]] = st.conv
            if model._applies_shared(cfg, layer):
                model._prefill_dense_block(shared, cfg, x, caches["attn"],
                                           app)
                app += 1
        return x, caches

    def decode(params, cfg_, state, token, tp=None, group=None):
        rows = token.shape[0] // workers
        caches, pos = state.caches, state.pos
        mc, kv = caches["mamba"], caches["attn"]
        shared = model._shared(params)
        out = []
        for w in range(workers):
            a = slice(w * rows, (w + 1) * rows)
            x = torch.nn.functional.embedding(token[a].long(),
                                              params["embed"])[:, None, :]
            app = 0
            for layer, lp in enumerate(model._layers(params, cfg)):
                states = [ssm.MambaState(mc.h[layer][a, r * h:(r + 1) * h],
                                         mc.conv[layer][a][..., chans[r]])
                          for r in range(m)]
                o, news = mamba(lp["mamba"], common.rms_norm(x, lp["ln1"]),
                                states)
                for r, st in enumerate(news):
                    mc.h[layer][a, r * h:(r + 1) * h] = st.h
                    mc.conv[layer][a, :, chans[r]] = st.conv
                x = x + o
                if model._applies_shared(cfg, layer):
                    cache = attn.KVCache(kv.k[app][a], kv.v[app][a], kv.ring)
                    o, _ = attn.decode_attend(
                        shared["attn"], common.rms_norm(x, shared["ln1"]),
                        pos[a], cache, cfg, window=cfg.sliding_window)
                    x = x + o
                    x = x + model._ffn(x, shared, cfg)[0]
                    app += 1
            out.append(model.logits_fn(params, cfg, common.rms_norm(
                x, params["final_norm"])))
        return (torch.cat(out)[:, 0],
                model.DecodeState(caches, pos + 1, state.enc_kv))

    with rank_twin(torch, rt, cfg, m, workers):
        plain = (model._prefill_hybrid, slots_mod.decode_step)
        model._prefill_hybrid, slots_mod.decode_step = prefill_hybrid, decode
        try:
            yield
        finally:
            model._prefill_hybrid, slots_mod.decode_step = plain


def hybrid_state_digests(torch, cfg, caches, rows: slice, r: int,
                         m: int) -> list:
    """The digest of slot rows ``rows`` of hybrid decode caches as model
    rank ``r`` of ``m`` holds them (``m`` 1: as they are): its heads' h,
    its conv channels (``_rank_channels``), its KV heads of the shared
    block's caches."""
    mc, kv = caches["mamba"], caches["attn"]
    if m == 1:
        tree = {"h": mc.h[:, rows], "conv": mc.conv[:, rows],
                "k": kv.k[:, rows], "v": kv.v[:, rows]}
    else:
        h = mc.h.shape[2] // m
        g = kv.k.shape[3] // m
        tree = {"h": mc.h[:, rows, r * h:(r + 1) * h],
                "conv": mc.conv[:, rows][..., _rank_channels(torch, cfg, r,
                                                             m)],
                "k": kv.k[:, rows, :, r * g:(r + 1) * g],
                "v": kv.v[:, rows, :, r * g:(r + 1) * g]}
    return as_json(digest(torch, tree))


def axis21_references(torch, rt, work: Path) -> None:
    """Phase 21's references, in the parent after phase 20's (beside
    phase 20's ranks), written for the ranks:
      * zamba2-1.2b at full width through the plain 8-slot engine and its
        twin over (data 2, model 2) (``hybrid_twin``): the greedy tokens,
        the twin held to the plain engine (``check_ssm19_twin``), and
        after the first decode round the digest of each rank's share of
        the twin's states and caches (its worker's rows, its heads);
      * one exact epoch at HYBRID21_EXACT_LAYERS of the one-process
        data=2 session from ``hybrid21_params``, plain and under
        ``tp_sums`` (its Mamba2 twin block): each leaf's move sets its
        limit; the twin's parameters and loss are what the ranks are
        held to;
      * one fp32 gossip epoch at HYBRID21_GOSSIP_LAYERS, HYBRID21_ROUNDS
        rounds, under ``tp_sums``: the digest of each rank's block of its
        worker's dual (``block_digests``);
      * one exact epoch at HYBRID21_CKPT_LAYERS of the one-process data=2
        session (model 2 in its TrainSpec), saved (``ck21_one``): the
        archive the ranks restore."""
    lap = stamps("phase 21 references")
    refs = {}
    data, m = HYBRID_AXIS
    full = rt.configs.get_config(ZAMBA_ARCH)
    reqs, slots, cache, seed = serve_spec(rt, full, HYBRID21_SERVE)
    params = rt.models.init_params(
        full, torch.Generator(device="cuda").manual_seed(seed))
    engine = rt.serve.SlotEngine(params, full, slots=slots, cache_len=cache)
    plain_seen = sampled_logits(engine, len(reqs) + 1)
    drain(engine, reqs)
    plain_tokens = [r.out_tokens for r in reqs]
    del engine
    release(torch)
    reqs = serve_spec(rt, full, HYBRID21_SERVE)[0]
    per = slots // data
    with hybrid_twin(torch, rt, full, m, data):
        engine = rt.serve.SlotEngine(params, full, slots=slots,
                                     cache_len=cache)
        twin_seen = sampled_logits(engine, len(reqs) + 1)
        digests = drain_first(engine, reqs, lambda caches: [
            hybrid_state_digests(torch, full, caches,
                                 slice(w * per, (w + 1) * per), r, m)
            for w in range(data) for r in range(m)])
    twin_tokens = [r.out_tokens for r in reqs]
    refs["serve"] = {"plain_tokens": plain_tokens, "twin_tokens": twin_tokens,
                     "digests": digests}
    del engine, params
    release(torch)
    check_ssm19_twin(torch, plain_seen, twin_seen, plain_tokens, twin_tokens,
                     HYBRID21_LOGIT_TOL, "bf16",
                     "phase 21 reference: the zamba2")
    lap("the zamba2 serve twin done")
    cfg = dataclasses.replace(full, num_layers=HYBRID21_EXACT_LAYERS)
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", False, data=data,
                               params=hybrid21_params(torch, rt, cfg))
        res = mesh_epochs(torch, rt, session, "phase 21 hybrid exact "
                          "reference", 1)
        plain = {k: v.detach() for k, v in session.params.items()}
        del session
        release(torch)
        with tp_sums(torch, rt, m):
            session = mesh_session(rt, cfg, "exact", False, data=data,
                                   params=hybrid21_params(torch, rt, cfg))
            twin = mesh_epochs(torch, rt, session, "phase 21 hybrid exact "
                               "twin", 1)
        moves = leaf_errs(torch, session.params, plain)
        torch.save({k: v.detach().cpu() for k, v in session.params.items()},
                   work / "hybrid21_twin.pt")
        del session, plain
        release(torch)
    refs["exact"] = {"losses": twin["losses"],
                     "plain_losses": res["losses"], "moves": moves,
                     "limits": check_order("phase 21 hybrid exact", moves)}
    print(f"phase 21 reference hybrid exact ({HYBRID21_EXACT_LAYERS} layers, "
          f"one process, {data} workers): losses {res['losses']} epoch_s "
          f"{res['epoch_s']} peak_GiB {res['peak_gib']:.2f}; the twin's over "
          f"{m} model ranks {twin['losses']} [{card_line()}]", flush=True)
    lap("the zamba2 exact references done")
    cfg = dataclasses.replace(full, num_layers=HYBRID21_GOSSIP_LAYERS,
                              dtype="float32")
    with deterministic(torch), tp_sums(torch, rt, m):
        session = mesh_session(rt, cfg, "gossip", False, data=data,
                               rounds=HYBRID21_ROUNDS)
        res = mesh_epochs(torch, rt, session, "phase 21 hybrid gossip twin",
                          1)
        refs["gossip"] = {"losses": res["losses"],
                          "digests": block_digests(torch, rt,
                                                   session.state["z"])}
        del session
        release(torch)
    print(f"phase 21 reference hybrid gossip ({HYBRID21_GOSSIP_LAYERS} "
          f"layers, fp32, one process, {data} workers, r {HYBRID21_ROUNDS}, "
          f"tp_sums): losses {res['losses']} epoch_s {res['epoch_s']} "
          f"peak_GiB {res['peak_gib']:.2f} [{card_line()}]", flush=True)
    lap("the zamba2 gossip twin done")
    cfg = dataclasses.replace(full, num_layers=HYBRID21_CKPT_LAYERS)
    session = mesh_session(rt, cfg, "exact", False, data=data, model=m)
    mesh_epochs(torch, rt, session, "phase 21 hybrid checkpoint session", 1)
    session.save(work / "ck21_one")
    del session
    release(torch)
    lap("the zamba2 archive saved")
    torch.save(refs, work / "axis21_refs.pt")


def rank_hybrid_serve(torch, rt, dist, refs: dict, lap) -> dict:
    """zamba2-1.2b at full width and depth, bf16, through the slot engine
    over (data 2, model 2), clock-free (``drain_first``): each rank's
    serving blocks from the seed (``init_shards``, the serving layout;
    ``w_in`` and ``conv_w`` gathered and cut to its heads once, when the
    engine loads them); the greedy tokens equal to the twin's
    (``hybrid_twin``) and the count that differ from the plain engine's;
    each rank's Mamba2 states, conv tails and KV caches after the first
    decode round its share of the twin's by digest; 6 tensor-core flash
    launches a request on its worker's ranks at (B 1, H 16, KV 16, hd
    64); per rank the prefill seconds, the decode round's ms (p50, p99),
    the bytes summed and gathered over "model" and the collectives a
    round, the peak."""
    rank = dist.get_rank()
    router = rt.kernels.router
    label = f"phase 21 hybrid serve rank {rank}"
    cfg = rt.configs.get_config(ZAMBA_ARCH)
    ref = refs["serve"]
    reqs, slots, cache, seed = serve_spec(rt, cfg, HYBRID21_SERVE)
    engine, group, tp = rank_engine(torch, rt, cfg, seed, slots, cache,
                                    lambda: lap("the zamba2 serving blocks "
                                                "drawn"))
    with count_collectives(dist) as calls:
        probe = EngineProbe(torch, rt, engine, lambda: (
            tp.reduced_bytes, tp.model_gathered_bytes, sum(calls.values())))
        with probe.watch():
            got = drain_first(engine, reqs, lambda caches: (
                hybrid_state_digests(torch, cfg, caches, slice(None), 0, 1)))
    launches = router.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap("the zamba2 requests served")
    tokens = [r.out_tokens for r in reqs]
    if tokens != ref["twin_tokens"]:
        fail(f"{label}: greedy tokens differ from the one-process twin's "
             f"(hybrid_twin): {tokens} vs {ref['twin_tokens']}")
    if got != ref["digests"][rank]:
        fail(f"{label}: its Mamba2 states, conv tails and KV caches after "
             f"the first round differ from its share of the twin's (worker "
             f"{group.worker}'s rows, model rank {group.m}'s heads)")
    apps = cfg.num_layers // cfg.attn_every
    owned = probe.check_flash(label, reqs, apps, FLASH_ZAMBA_RANK, launches)
    expect(label, launches, {"dual_update": 0})
    rank_shape = tuple(FLASH_ZAMBA_RANK[x] for x in ("b", "h", "kv", "hd"))
    differ = sum(a != b for x, y in zip(tokens, ref["plain_tokens"])
                 for a, b in zip(x, y))
    rounds = probe.rounds()
    per_round = rounds["bytes_per_round"][2]
    row = {"owned": owned, "flash_per_request": apps,
           "heads": tp.mamba_heads(cfg), "prefill_s": probe.prefill_s,
           "decode_rounds": rounds["decode_rounds"],
           "round_ms_p50": rounds["round_ms_p50"],
           "round_ms_p99": rounds["round_ms_p99"],
           "reduced_bytes_per_round": rounds["bytes_per_round"][0],
           "gathered_bytes_per_round": rounds["bytes_per_round"][1],
           "collectives_per_round": per_round, "peak_gib": peak,
           "tokens_differing_from_plain": differ, "launches": launches}
    print(f"  {label} (worker {group.worker}, model {group.m}): "
          f"{tp.mamba_heads(cfg)} Mamba2 heads; greedy tokens equal to the "
          f"twin's; {differ} of {sum(map(len, tokens))} differ from the "
          f"plain engine's; states, conv tails and KV caches its share of "
          f"the twin's; flash {apps} a request on the tensor cores at (B, "
          f"H, KV, hd) {rank_shape} x {owned} requests; prefill_s "
          f"{[round(x, 4) for x in probe.prefill_s]}; decode rounds "
          f"{row['decode_rounds']}, ms p50 {row['round_ms_p50']:.2f} p99 "
          f"{row['round_ms_p99']:.2f}; {row['reduced_bytes_per_round']} B "
          f"summed over \"model\" and {row['gathered_bytes_per_round']} B "
          f"gathered a round; {per_round} collectives a round (one token a "
          f"slot); peak_GiB {peak:.2f} [{card_line()}]", flush=True)
    del engine
    release(torch)
    return row


def rank_hybrid_exact(torch, rt, dist, refs: dict, work: Path, lap) -> dict:
    """zamba2-1.2b at HYBRID21_EXACT_LAYERS over (data 2, model 2) from
    ``hybrid21_params``, one exact epoch (FSDP x TP, 32 Mamba2 heads and
    16 attention heads a rank; the shared block applied twice) under
    deterministic algorithms:
    20 ``dual_update`` launches on the blocks; the bytes over "data" the
    dry-run's ``rank_fsdp_bytes`` and over "model" its
    ``rank_model_bytes``, to the byte; the loss within MESH_LOSS_TOL of
    the twin's (``tp_sums``), the replicated leaves equal on every rank,
    and each gathered leaf within its ``order_limits`` of the twin's
    (rank 0)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract
    rank = dist.get_rank()
    label = f"phase 21 hybrid exact rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(ZAMBA_ARCH),
                              num_layers=HYBRID21_EXACT_LAYERS)
    mesh = rt.launch.mesh.make_host_mesh(*HYBRID_AXIS, device="cuda")
    ref = refs["exact"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "exact", mesh, HYBRID_AXIS[0],
                               model=HYBRID_AXIS[1],
                               params=hybrid21_params(torch, rt, cfg))
        release(torch)
        res = mesh_epochs(torch, rt, session, label, 1)
    lap("the zamba2 exact epoch done")
    tp = session.tp
    leaves = len(session.state["params"])
    expect(label, res["launches"], {"dual_update": leaves})
    check_losses("phase 21 hybrid exact", rank, res["losses"],
                 ref["losses"])
    same_replicated(torch, dist, session, session.state["params"], "exact")
    amesh = abstract(HYBRID_AXIS, ("data", "model"))
    held = {k: getattr(tp, k) for k in ("gathered_bytes", "scattered_bytes",
                                        "model_gathered_bytes",
                                        "reduced_bytes")}
    want = dict(dryrun.rank_fsdp_bytes(cfg, amesh),
                **dryrun.rank_model_bytes(cfg, amesh, PER_WORKER * SEQ))
    if held != want:
        fail(f"{label}: {held}, the dry-run's {want}")
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "heads": tp.mamba_heads(cfg), **held}
    print(f"  {label} (worker {session.group.worker}, model "
          f"{session.group.m}): {tp.mamba_heads(cfg)} Mamba2 heads; over "
          f"\"data\" gathered {held['gathered_bytes']} B, reduce-scattered "
          f"{held['scattered_bytes']} B; over \"model\" gathered "
          f"{held['model_gathered_bytes']} B, summed "
          f"{held['reduced_bytes']} B (all the dry-run's); the replicated "
          f"leaves equal on every rank; epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} (the twin's "
          f"{ref['losses']}); dual_update "
          f"{res['launches'].get('dual_update', 0)} [{card_line()}]",
          flush=True)
    whole = session.params
    if rank == 0:
        twin = torch.load(work / "hybrid21_twin.pt")
        row["limit_share"] = check_leaves(
            "phase 21 hybrid exact (the ranks against the twin)",
            leaf_errs(torch, whole, twin), ref["limits"])
        del twin
    del session, whole
    release(torch)
    return row


def rank_hybrid_gossip(torch, rt, dist, refs: dict, lap) -> dict:
    """zamba2-1.2b at HYBRID21_GOSSIP_LAYERS in fp32 over (data 2, model
    2), one ring gossip epoch (TP) of HYBRID21_ROUNDS rounds under
    deterministic algorithms: each rank's dual block bit for bit its
    block of the one-process twin's (``tp_sums``), the wire exactly
    ``wire_bytes_per_round(d_block)`` a round, 20 ``dual_update`` and
    HYBRID21_ROUNDS ``gossip_combine`` launches."""
    rank = dist.get_rank()
    label = f"phase 21 hybrid gossip rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(ZAMBA_ARCH),
                              num_layers=HYBRID21_GOSSIP_LAYERS,
                              dtype="float32")
    mesh = rt.launch.mesh.make_host_mesh(*HYBRID_AXIS, device="cuda")
    ref = refs["gossip"]
    with deterministic(torch):
        session = mesh_session(rt, cfg, "gossip", mesh, HYBRID_AXIS[0],
                               model=HYBRID_AXIS[1], rounds=HYBRID21_ROUNDS)
        res = mesh_epochs(torch, rt, session, label, 1)
    lap("the zamba2 gossip epoch done")
    g = session.group
    leaves = len(session.state["z"])
    expect(label, res["launches"], {"dual_update": leaves,
                                    "gossip_combine": HYBRID21_ROUNDS})
    check_losses("phase 21 hybrid gossip", rank, res["losses"],
                 ref["losses"])
    width = session.tp.row_block().block_width
    strat = rt.dist.amb.strategy_from_config(
        dataclasses.replace(session.protocol.amb, active=None),
        HYBRID_AXIS[0])
    wire = strat.wire_bytes_per_round(width)
    if g.sent_bytes != HYBRID21_ROUNDS * wire:
        fail(f"{label}: sent {g.sent_bytes} bytes in {HYBRID21_ROUNDS} "
             f"rounds; wire_bytes_per_round({width}) {wire}")
    z = {k: v[0] for k, v in session.state["z"].items()}
    if as_json(digest(torch, z)) != ref["digests"][rank]:
        fail(f"{label}: its dual block differs from its block of the "
             f"one-process session under tp_sums")
    row = {"epoch_s": res["epoch_s"], "peak_gib": res["peak_gib"],
           "losses": res["losses"], "launches": res["launches"],
           "block_width": width, "wire_bytes_per_round": wire}
    print(f"  {label} (worker {g.worker}, model {g.m}): dual block bit for "
          f"bit its block of the one-process session under tp_sums; "
          f"{g.sent_bytes // HYBRID21_ROUNDS} bytes a round = "
          f"wire_bytes_per_round(d_block {width}); epoch_s "
          f"{[round(x, 4) for x in res['epoch_s']]} peak_GiB "
          f"{res['peak_gib']:.2f} losses {res['losses']} [{card_line()}]",
          flush=True)
    del session, z
    release(torch)
    return row


def rank_hybrid_ckpt(torch, rt, dist, work: Path, lap) -> dict:
    """A zamba2 checkpoint at model 2: each rank restores the parent's
    one-process exact archive (``ck21_one``, HYBRID21_CKPT_LAYERS),
    saves it (``ck21_back``), and restores its own save: the state read
    back bit for bit, block for block; the archive's bytes, save and
    restore seconds."""
    rank = dist.get_rank()
    label = f"phase 21 hybrid checkpoint rank {rank}"
    cfg = dataclasses.replace(rt.configs.get_config(ZAMBA_ARCH),
                              num_layers=HYBRID21_CKPT_LAYERS)
    session = rt.api.AMBSession.restore(work / "ck21_one", cfg=cfg,
                                        device="cuda")
    if session.tp is None or session.group.model != HYBRID_AXIS[1]:
        fail(f"{label}: the restore is not over (data 2, model 2)")
    before = as_json(digest(torch, session.state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.save(work / "ck21_back")
    save_s = time.perf_counter() - t0
    del session
    release(torch)
    t0 = time.perf_counter()
    back = rt.api.AMBSession.restore(work / "ck21_back", cfg=cfg,
                                     device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if as_json(digest(torch, back.state)) != before:
        fail(f"{label}: the state read back is not the state saved")
    nbytes = dir_bytes(work / "ck21_back")
    print(f"  {label}: the state read back bit for bit, block for block; "
          f"{nbytes} B, save {save_s:.3f} s "
          f"({nbytes / save_s / 1e9:.3f} GB/s), restore {restore_s:.3f} s "
          f"({nbytes / restore_s / 1e9:.3f} GB/s)", flush=True)
    del back
    release(torch)
    lap("the zamba2 checkpoint done")
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s}


def rank_axis21(torch, rt, dist, work: Path) -> None:
    """Phase 21's turn of the gloo launch, once the parent's references
    are written: zamba2-1.2b's slot engine, its exact and fp32 gossip
    epochs and a checkpoint over (data 2, model 2); each rank's results
    to ``axis21_rank<r>.json``."""
    rank = dist.get_rank()
    lap = stamps("phase 21 rank 0", rank)
    refs = torch.load(work / "axis21_refs.pt")
    out = {"hybrid serve": rank_hybrid_serve(torch, rt, dist, refs, lap),
           "hybrid exact": rank_hybrid_exact(torch, rt, dist, refs, work,
                                             lap),
           "hybrid gossip": rank_hybrid_gossip(torch, rt, dist, refs, lap),
           "hybrid ckpt": rank_hybrid_ckpt(torch, rt, dist, work, lap)}
    (work / f"axis21_rank{rank}.json").write_text(json.dumps(out))


def axis21_after(torch, rt, work: Path) -> dict:
    """Phase 21 after the gloo ranks: the ranks' save of the one-process
    archive leaf for leaf that archive (the packed Mamba2 leaves and the
    shared block's among them); their rows and launch counts."""
    ranks = [json.loads((work / f"axis21_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    ckpt = rt.ckpt.checkpoint
    for sub in ("", "session_state"):
        a = ckpt._Reader(work / "ck21_one" / sub, 1)
        b = ckpt._Reader(work / "ck21_back" / sub, 1)
        if not any("mamba/w_in" in k for k in a.data.files) or not any(
                "shared_attn" in k for k in a.data.files):
            fail(f"phase 21 checkpoint: the archive lacks the Mamba2 or the "
                 f"shared block's leaves ({sub or 'primal'})")
        if a.manifest != b.manifest or any(
                not (a.data[k].dtype == b.data[k].dtype
                     and (a.data[k] == b.data[k]).all())
                for k in a.data.files):
            fail(f"phase 21 checkpoint: the ranks' save of the restored "
                 f"archive is not the one-process archive "
                 f"({sub or 'primal'})")
    launches = {f"{run} rank {r}": res[run]["launches"]
                for r, res in enumerate(ranks) for run in res
                if "launches" in res[run]}
    print(f"phase 21: every rank's checks held; the ranks' save of the "
          f"one-process zamba2 archive is that archive, leaf for leaf; "
          f"launches {json.dumps(launches)} [{card_line()}]", flush=True)
    return {"launches": launches, "ranks": ranks}


def rank_gloo(torch, rt, dist, work: Path) -> None:
    """The four gloo ranks of phases 14 to 21 in one launch, each phase's
    sessions building their meshes over the one group: ``rank_gloo4``,
    ``rank_drivers``, ``rank_model``, ``rank_serve``, ``rank_axis18``,
    ``rank_axis19``, ``rank_axis20`` and ``rank_axis21`` in turn, each once
    the parent's steps before it are done
    (``wait_parent``), a barrier after each; rank 0 prints when each
    ended and writes ``done<phase>`` (the parent's phase-18 references
    wait for phase 16's)."""
    t0 = time.perf_counter()
    for phase, fn in ((14, rank_gloo4), (15, rank_drivers),
                      (16, rank_model), (17, rank_serve),
                      (18, rank_axis18), (19, rank_axis19),
                      (20, rank_axis20), (21, rank_axis21)):
        wait_parent(work, dist.get_rank(), phase)
        fn(torch, rt, dist, work)
        release(torch)
        dist.barrier()
        if dist.get_rank() == 0:
            (work / f"done{phase}").write_text("1")
            print(f"rank phase gloo: phase {phase}'s ranks done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


RANK_PHASES = {"gloo": rank_gloo}


def run_rank_phases(torch, rt, ops, full, beta: float, stamp,
                    beside14, beside17) -> tuple:
    """Phases 14 to 21 around one launch of four gloo ranks
    (``rank_gloo``), started first: phases 14 to 16's parent steps before
    the ranks (the references, the NCCL rank) run while the ranks come
    up; phase 17's references and ``beside14()`` (a part of an earlier
    phase that fits beside phase 14's ranks on the card) while the ranks
    run phase 14; phase 18's references once the ranks have ended phase
    16, then ``beside17()`` (other parts) while they run phases 17 and
    18 (each phase's ranks start once ``parent_ready`` says its steps are
    done), and after it phase 19's, phase 20's and phase 21's references;
    then each phase's parent steps after them, ``stamp(phase)`` as each
    ends.  Returns (phase 14's, 15's, 16's, 17's, 18's, 19's, 20's and
    21's results)."""
    release(torch)
    work = Path(tempfile.mkdtemp(prefix="ranks-", dir=ROOT / "build"))
    t0 = time.perf_counter()
    proc, t_launch = start_ranks("gloo", work, MESH_RANKS)
    try:
        try:
            mesh_before(torch, rt, full, work)
            t14 = time.perf_counter()
            refs15 = driver_references(torch, rt, full, work)
            t15 = time.perf_counter()
            digests = model_before(torch, rt, full, work)
            t16 = time.perf_counter()
            # phase 14's ranks hold near 58 GiB together: phase 17's
            # references (about 5 GiB) and ``beside14`` (under 12 GiB) run
            # beside them; phase 15's ranks (peaks near 70 GiB) start
            # after those, and phase 15's references (near 50 GiB) ran
            # before
            parent_ready(work, 14)
            serve_references(torch, rt, full, work)
            parent_ready(work, 17)
            t17 = time.perf_counter()
            beside14()
            release(torch)
            for phase in (15, 16):
                parent_ready(work, phase)
            t17b = time.perf_counter()
            wait_parent(work, 0, "done16")
            t17c = time.perf_counter()
            axis18_references(torch, rt, full, work)
            parent_ready(work, 18)
            t18 = time.perf_counter()
            # phases 17 and 18's ranks peak under 30 GiB together
            # (``beside17``: under 25 GiB; phase 19's references, under 15
            # GiB, after it)
            beside17()
            release(torch)
            t18b = time.perf_counter()
            axis19_references(torch, rt, work)
            parent_ready(work, 19)
            release(torch)
            t19 = time.perf_counter()
            # phase 20's references (near 11 GiB) beside phase 19's ranks
            # (under 6 GiB each)
            axis20_references(torch, rt, work)
            parent_ready(work, 20)
            release(torch)
            t20 = time.perf_counter()
            # phase 21's references (near 20 GiB) beside phase 20's ranks
            # (under 2.3 GiB each)
            axis21_references(torch, rt, work)
            parent_ready(work, 21)
            release(torch)
            t21 = time.perf_counter()
        except BaseException:
            stop_ranks("gloo", proc)
            raise
        wait_ranks("gloo", proc, t_launch, MESH_RANKS)
        t_ranks = time.perf_counter()
        mesh = mesh_after(rt, full, work)
        stamp(14)
        ranks15 = drivers_after(torch, rt, work, refs15)
        stamp(15)
        model_axis = model_after(
            torch, rt, ops, full, beta, work, digests,
            {kind: [r[kind]["peak_gib"] for r in mesh["ranks"]]
             for kind in ("exact", "gossip")})
        stamp(16)
        served = serve_after(torch, rt, work)
        stamp(17)
        axis18 = axis18_after(work)
        stamp(18)
        axis19 = axis19_after(work)
        stamp(19)
        axis20 = axis20_after(torch, rt, work)
        stamp(20)
        axis21 = axis21_after(torch, rt, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t_end = time.perf_counter()
    print(f"phases 14 to 21 (one process per worker, the drivers, a model "
          f"axis, serving over it, the MoE family and more model ranks "
          f"than KV heads, the vlm, ssm, audio and hybrid families): "
          f"{t_end - t0:.1f} s; the parent before "
          f"the gloo ranks {t14 - t0:.1f} s (phase 14, the NCCL rank "
          f"included), {t15 - t14:.1f} (15), {t16 - t15:.1f} (16), the "
          f"ranks coming up meanwhile; while the ranks ran, phase 17's "
          f"references {t17 - t16:.1f} and the phase beside phase 14's "
          f"ranks {t17b - t17:.1f}, then phase 18's references "
          f"{t18 - t17c:.1f} (after waiting {t17c - t17b:.1f} for phase "
          f"16's ranks) and the phase beside phases 17 and 18's ranks "
          f"{t18b - t18:.1f}, then phase 19's references {t19 - t18b:.1f}, "
          f"phase 20's {t20 - t19:.1f} and phase 21's {t21 - t20:.1f}; the "
          f"ranks after the parent's steps {t_ranks - t21:.1f}; the parent "
          f"after them {t_end - t_ranks:.1f}", flush=True)
    return (mesh, ranks15, model_axis, served, axis18, axis19, axis20,
            axis21)


def time_quantized_block(torch, rt, ops, d: int) -> dict:
    """The quantized round's two kernels at a model-axis rank's block row
    (D = ``d``, a ring of 2 workers: K = 2 level rows and a (2, 1)
    table), each bit for bit its plain version (in column slices) and
    timed beside it and its bound.  Returns their entries by kernel."""
    ref = rt.kernels.ref
    gen = torch.Generator(device="cuda").manual_seed(17)
    m = torch.randn((1, d), generator=gen, device="cuda")
    h = torch.randn((1, d), generator=gen, device="cuda") * 0.3
    rnd = torch.rand((1, d), generator=gen, device="cuda")
    lo, scale = rt.dist.consensus.row_grids(m, h, 255.0)
    lvl, h_new = ops.stochastic_quantize(m, h, rnd, lo, scale, 255.0,
                                         force="kernel")
    bad = []

    def compare_sq(a, b):
        want_l, want_h = ref.stochastic_quantize_ref(
            m[:, a:b], h[:, a:b], rnd[:, a:b], lo, scale, 255.0)
        if not (torch.equal(want_l, lvl[:, a:b])
                and torch.equal(want_h, h_new[:, a:b])):
            bad.append(a)

    in_chunks(compare_sq, d)
    if bad:
        fail(f"stochastic_quantize at the model-axis block D={d}: kernel vs "
             f"plain differ in the slices from {bad}")
    lvl1, h1 = torch.empty_like(lvl), h.clone()
    s_ms = time_ms(torch, lambda: ops.stochastic_quantize(
        m, h1, rnd, lo, scale, 255.0, out=(lvl1, h1), force="kernel"), 10,
        "stochastic_quantize model-axis block")
    sp_ms = time_ms(torch, lambda: in_chunks(
        lambda a, b: ref.stochastic_quantize_ref(
            m[:, a:b], h[:, a:b], rnd[:, a:b], lo, scale, 255.0), d), 3,
        "stochastic_quantize model-axis block plain")
    sb_ms, sb_by = bound(17 * d, 8 * d)
    del lvl1, h1, h_new, rnd
    release(torch)
    strat = rt.dist.consensus.GossipConsensus(MODEL_AXIS[0], 1, "ring")
    k, w = strat.taps.k, strat.taps.weights
    table = rt.kernels.gossip_combine.own_row_table(k, m.device)
    levels = torch.cat([lvl, lvl.roll(1, dims=1)])
    los = torch.cat([lo[:, 0], lo[:, 0] - 0.5])
    scales = torch.cat([scale[:, 0], scale[:, 0] * 1.5])
    hnbr = torch.randn((k - 1, 1, d), generator=gen, device="cuda")
    got_o, got_h = ops.quantized_combine(m, hnbr, levels, los, scales,
                                         table, w, force="kernel")
    bad = []

    def compare_qc(a, b):
        want_o, want_h = ref.quantized_combine_ref(
            m[:, a:b], hnbr[:, :, a:b], levels[:, a:b], los, scales, table,
            w)
        if not (torch.equal(want_o, got_o[:, a:b])
                and torch.equal(want_h, got_h[:, :, a:b])):
            bad.append(a)

    in_chunks(compare_qc, d)
    if bad:
        fail(f"quantized_combine at the model-axis block D={d}: kernel vs "
             f"plain differ in the slices from {bad}")
    q_ms = time_ms(torch, lambda: ops.quantized_combine(
        m, hnbr, levels, los, scales, table, w, out=(got_o, got_h),
        force="kernel"), 10, "quantized_combine model-axis block")
    qp_ms = time_ms(torch, lambda: in_chunks(
        lambda a, b: ref.quantized_combine_ref(
            m[:, a:b], hnbr[:, :, a:b], levels[:, a:b], los, scales, table,
            w), d), 3, "quantized_combine model-axis block plain")
    qb_ms, qb_by = bound(d * (4 + (k - 1) + 8 * (k - 1) + 4), 4 * k * d)
    out = {"stochastic_quantize": dict(
        shape=f"a model-axis rank's block row (1, D), D={d}", ms=s_ms,
        plain_ms=sp_ms, bound_ms=sb_ms, bound_by=sb_by, library_ms=None),
        "quantized_combine": dict(
        shape=f"a model-axis rank's block row, K={k} level rows, a ({k}, "
        f"1) table, D={d}", ms=q_ms, plain_ms=qp_ms, bound_ms=qb_ms,
        bound_by=qb_by, library_ms=None)}
    for name, t in out.items():
        print(f"{name} at the model-axis block D={d}: bit for bit the plain "
              f"version; ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
              f"[{card_line()}]", flush=True)
    del m, h, lvl, levels, hnbr, got_o, got_h
    release(torch)
    return out


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
    t_start = time.perf_counter()

    def stamp(phase: int, what: str = "") -> None:
        print(f"phase {phase}{what} ended at "
              f"{time.perf_counter() - t_start:.1f} s of the command",
              flush=True)

    t0 = time.perf_counter()
    names = build.sources()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.library, names))
    print(f"build: {len(names)} kernels in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(names)})", flush=True)
    report_kernels(build)
    stamp(2)

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
    flash_zoo += check_flash_rank(torch, ops, rt.kernels.flash_attention)
    flash_zoo += check_flash_rank(torch, ops, rt.kernels.flash_attention,
                                  FLASH_MOE_RANK, FLASH18_SEQS,
                                  "qwen3-moe-30b-a3b over (data 2, model 2)")
    flash_zoo += check_flash_rank(torch, ops, rt.kernels.flash_attention,
                                  FLASH_KV_RANK, FLASH18_SEQS,
                                  "qwen2-1.5b over (data 1, model 4)")
    flash_zoo += check_flash_rank(torch, ops, rt.kernels.flash_attention,
                                  FLASH_VLM_RANK, FLASH19_SEQS,
                                  "internvl2-76b over (data 2, model 2)")
    flash_zoo += check_flash_whisper(
        torch, ops, rt.kernels.flash_attention, FLASH_WHISPER_RANK,
        ", a model rank over (data 2, model 2)")
    flash_zoo += check_flash_rank(torch, ops, rt.kernels.flash_attention,
                                  FLASH_ZAMBA_RANK, FLASH21_SEQS,
                                  "zamba2-1.2b's shared block over (data 2, "
                                  "model 2)")
    rank_err, rwkv["rank_shapes"] = time_rwkv6(
        torch, ops, rt.kernels.rwkv6_scan, RWKV_RANK,
        "a rank of rwkv6-3b over (data 2, model 2)")
    rwkv_err = max(rwkv_err, rank_err)
    gcomb["per_rank"] = check_gossip_combine_rank(
        torch, ops, ref, GossipConsensus,
        rt.kernels.gossip_combine.own_row_table, dense_param_count(
            dataclasses.replace(full, num_layers=MESH_GOSSIP_LAYERS)) + 1)
    qrank = check_quantized_rank(
        torch, ops, ref, consensus, rt.kernels.gossip_combine.own_row_table,
        dense_param_count(dataclasses.replace(
            full, num_layers=DRIVER_LAYERS)) + 1)
    squant["per_rank"] = qrank["stochastic_quantize"]
    qcomb["per_rank"] = qrank["quantized_combine"]
    stamp(3)

    smoke = rt.configs.smoke_config("qwen2-1.5b")
    check_quantized_strategy(torch, rt, dense_param_count(smoke) + 1)
    reference_check(torch, rt)
    serve_reference_check(torch, rt, "qwen2-1.5b")
    serve_reference_check(torch, rt, "rwkv6-3b")
    zoo_reference_check(torch, rt)
    zamba_reference_check(torch, rt)
    encdec_reference_check(torch, rt)
    stamp(4)

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
    stamp(5)
    sim = run_simulator(torch, rt)
    stamp(6)
    cli = check_train_cli(torch, rt, full)
    stamp(7)
    drivers = {"pipelined": run_pipelined(torch, rt, gossip_cfg),
               "async": run_async(torch, rt, quant_cfg),
               "elastic": run_elastic(torch, rt, gossip_cfg)}
    check_checkpoints(torch, rt, full, smoke)
    stamp(8)
    coded = {"coded exact": run_coded_exact(torch, rt, full),
             "churn": run_churn(torch, rt, gossip_cfg),
             "controller": run_controller_cli(torch, rt, gossip_cfg),
             "retune": run_staleness_retune(torch, rt, quant_cfg),
             "adaptive": run_adaptive(torch, rt)}
    check_restore_mid_churn(torch, rt, dataclasses.replace(
        full, num_layers=RESTORE_LAYERS))
    coded_launches = {k: r["launches"] for k, r in coded.items()}
    stamp(9)
    # whisper (phase 13), qwen2-1.5b's serve CLI (phase 10) and zamba2's
    # (phase 12) run beside the gloo ranks (``run_rank_phases``), where
    # the card has room and the parent would wait: whisper (11 GiB) beside
    # phase 14's ranks (near 58 GiB in use, and busy on the card: a serve
    # CLI there left no idle time to absorb a fine-tune epoch in), the two
    # serve CLIs (22 and 13 GiB) beside phases 17 and 18's (under 40 GiB,
    # bound by gloo's host round trips); the rest of those phases
    # (rwkv6-3b's 37 GiB serve CLI, zamba2's session and its prox timing,
    # internvl2's 59 GiB engine) in turn here
    served = {"rwkv6-3b": run_serve(torch, rt, SERVE_RWKV_ARGV)}
    stamp(10)
    cli_launches = {k: r["launches"] for k, r in cli["runs"].items()}
    moe_cut = dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                                  num_layers=MOE_LAYERS)
    zoo = {"serve qwen3-moe": run_engine_serve(
        torch, rt, dataclasses.replace(rt.configs.get_config(MOE_ARCH),
                                       num_layers=MOE_ENGINE_LAYERS),
        SERVE_REQUESTS, SERVE_NEW, 2.0, 1),
           "serve cli qwen3-moe": run_serve(torch, rt, MOE_SERVE_ARGV,
                                            cfg=moe_cut)}
    zoo["session qwen3-moe"], moe_du_err = run_moe_session(
        torch, rt, moe_cut, beta)
    du_err = max(du_err, moe_du_err)
    zoo["qwen3-8b long_500k"] = run_long_context(torch, rt)["launches"]
    stamp(11)
    zoo[f"session {ZAMBA_ARCH}"], zamba_du_err = run_zamba_session(
        torch, rt, beta)
    du_err = max(du_err, zamba_du_err)
    stamp(12)
    zoo[f"serve {VLM_ARCH} {VLM_LAYERS} layers"] = run_engine_serve(
        torch, rt, dataclasses.replace(rt.configs.get_config(VLM_ARCH),
                                       num_layers=VLM_LAYERS),
        VLM_REQUESTS, VLM_NEW, VLM_GAP_S, 2)
    stamp(13)

    def beside14() -> None:
        zoo[f"serve {WHISPER_ARCH}"] = run_whisper_serve(torch, rt)
        zoo[f"session {WHISPER_ARCH}"] = run_whisper_session(torch, rt)
        stamp(13, ": whisper beside phase 14's ranks")

    def beside17() -> None:
        served["qwen2-1.5b"] = run_serve(torch, rt, SERVE_ARGV)
        stamp(10, ": qwen2-1.5b's serve CLI beside phases 17 and 18's "
                  "ranks")
        release(torch)
        zoo[f"serve cli {ZAMBA_ARCH}"] = run_serve(torch, rt,
                                                   SERVE_ZAMBA_ARGV)
        stamp(12, ": zamba2's serve CLI beside phases 17 and 18's ranks")

    (mesh, ranks15, model_axis, served17, axis18, axis19, axis20,
     axis21) = run_rank_phases(torch, rt, ops, full, beta, stamp, beside14,
                               beside17)
    stamp(21)
    du[torch.float32]["model_axis"] = model_axis["dual_update"]
    squant["model_axis"] = model_axis["stochastic_quantize"]
    qcomb["model_axis"] = model_axis["quantized_combine"]

    def launches(name):
        return sum(c.get(name, 0) for group in (
            runs, served, sim["launches"], cli_launches, drivers,
            coded_launches, zoo, mesh["launches"], ranks15["launches"],
            model_axis["launches"], served17["launches"],
            axis18["launches"], axis19["launches"], axis20["launches"],
            axis21["launches"])
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
                    launches_drivers={a: c.get(name, 0) for a, c in
                                      drivers.items()},
                    launches_faults_control={a: c.get(name, 0) for a, c in
                                             coded_launches.items()},
                    launches_zoo={a: c.get(name, 0) for a, c in
                                  zoo.items()},
                    launches_mesh={a: c.get(name, 0) for a, c in
                                   mesh["launches"].items()},
                    launches_drivers_ranks={
                        a: c.get(name, 0)
                        for a, c in ranks15["launches"].items()},
                    launches_model_axis={
                        a: c.get(name, 0)
                        for a, c in model_axis["launches"].items()},
                    launches_serve_group={
                        a: c.get(name, 0)
                        for a, c in served17["launches"].items()},
                    launches_moe_kv_axis={
                        a: c.get(name, 0)
                        for a, c in axis18["launches"].items()},
                    launches_vlm_ssm_axis={
                        a: c.get(name, 0)
                        for a, c in axis19["launches"].items()},
                    launches_audio_axis={
                        a: c.get(name, 0)
                        for a, c in axis20["launches"].items()},
                    launches_hybrid_axis={
                        a: c.get(name, 0)
                        for a, c in axis21["launches"].items()},
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
