"""Serving driver: thin CLI over :mod:`repro_torch.serve` (counterpart of
``repro.launch.serve``, with the same flags and defaults).

Continuous batching over a fixed slot array with background AMB
fine-tuning absorbed into the round budget: each round has a fixed
wall-clock budget; requests contribute whatever tokens fit, and leftover
budget goes to training instead of idling.  Prefill attention runs the
hand-written flash kernel on the card.

``--requests N`` synthesizes a staggered workload (``--arrival-gap``
seconds between arrivals, prompt lengths jittered around
``--prompt-len``); ``--batch`` sets the slot count; ``--finetune N``
caps the background AMB epochs the scheduler may absorb.  The session
owns the parameters, clock and consensus as in training;
``session.serving_params()`` hands the primal to the slot engine.  SLO
metrics (TTFT / TPOT / latency p50-p99, tokens/s) and per-epoch train
loss stream to ``--metrics`` as JSONL.

In one process ``--data`` and ``--model`` are mesh extents that change
nothing.  Under ``torchrun`` (``WORLD_SIZE`` = data x model) the CLI
initialises the process group as the train CLI does
(``--dist-backend``, ``--device``), the session spreads each worker over
``--model`` ranks, and the slot engine runs over the same ranks: each
worker owns ``--batch / --data`` slot rows, each of its model ranks its
heads of them (the TP-only layout; the MoE family its experts, each
decode round dispatched over every worker's rows as one group; a KV
head split over M / KV ranks where ``--model`` exceeds the KV heads;
RWKV6 its heads' states; the hybrid its Mamba2 heads' states and its
shared block's KV heads; the vlm's prompts go in as embedding rows
from the vocab-parallel lookup);
every rank reads rank 0's clock, and only rank 0 prints the report.

Example (on the card; ``main(argv, device="cpu")`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --batch 4 --requests 12 --prompt-len 64 --new-tokens 32 \\
      --finetune 8 --round-budget 0.25
Four ranks on one card, two workers of two model ranks each:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --data 2 --model 2 --batch 8 --requests 8 --prompt-len 2048 \\
      --new-tokens 32 --finetune 2 --dist-backend gloo
(``--arch qwen3-moe-30b-a3b``, ``--arch rwkv6-3b``, ``--arch
zamba2-1.2b`` and ``--arch internvl2-76b`` the same; ``--arch
qwen2-1.5b --data 1 --model 4`` two ranks to each of its KV heads.)
"""
from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from ..api import AMBSession, ClockSpec, ConsensusSpec, TrainSpec
from ..dist.consensus import CONSENSUS_CHOICES
from ..serve import (AdmissionPolicy, RequestQueue, SamplingSpec,
                     ServeMetrics, ServeScheduler, SlotEngine,
                     synthetic_requests)
from .train import DIST_BACKENDS, init_group


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--requests", type=int, default=0, metavar="N",
                    help="requests to serve (0 = one per slot)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--arrival-gap", type=float, default=0.0, metavar="S",
                    help="seconds between staggered arrivals")
    ap.add_argument("--round-budget", type=float, default=0.25, metavar="S",
                    help="fixed time budget per decode round (the AMB "
                         "contract: budget fixed, work variable)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best tokens (0 = all)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true",
                    help="force greedy decode (same as --temperature 0)")
    ap.add_argument("--finetune", type=int, default=0, metavar="STEPS",
                    help="cap on background AMB fine-tune epochs absorbed "
                         "into idle round budget (0 = serve only)")
    ap.add_argument("--finetune-seq-len", type=int, default=64)
    ap.add_argument("--finetune-batch-per-worker", type=int, default=2)
    ap.add_argument("--consensus", default="exact",
                    choices=list(CONSENSUS_CHOICES),
                    help="consensus strategy for --finetune")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="JSONL path for SLO + fine-tune metrics")
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="process-group backend under torchrun "
                         "(WORLD_SIZE > 1): default nccl on the card, gloo "
                         "on the CPU; gloo may put several ranks on one "
                         "card")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the ranks run (default: the card)")
    args = ap.parse_args(argv)
    device, owned = init_group(args.dist_backend, args.device or device)
    try:
        return _serve(args, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _serve(args, device):
    train = TrainSpec(arch=args.arch, smoke=args.smoke,
                      seq_len=args.finetune_seq_len,
                      batch_per_worker=args.finetune_batch_per_worker,
                      data=args.data, model=args.model, seed=args.seed)
    try:
        session = AMBSession(train, ClockSpec(),
                             ConsensusSpec(consensus=args.consensus),
                             device=device, metrics_path=args.metrics)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    cfg = session.cfg

    temperature = 0.0 if args.greedy else args.temperature
    sampling = SamplingSpec(temperature=temperature, top_k=args.top_k,
                            seed=args.seed)
    jitter = min(args.prompt_len - 1, args.prompt_len // 4)
    cache_len = args.prompt_len + jitter + args.new_tokens
    n_req = args.requests or args.batch
    reqs = synthetic_requests(
        n_req, vocab_size=cfg.vocab_size, prompt_len=args.prompt_len,
        prompt_jitter=jitter, max_new_tokens=args.new_tokens,
        arrival_gap_s=args.arrival_gap, seed=args.seed + 1)
    queue = RequestQueue(AdmissionPolicy(cache_len=cache_len))
    for r in reqs:
        queue.push(r)

    try:
        engine = SlotEngine(session.serving_params(), cfg, slots=args.batch,
                            cache_len=cache_len, sampling=sampling,
                            group=session.group, tp=session.serving_tp)
        sched = ServeScheduler(engine, queue,
                               round_budget_s=args.round_budget,
                               session=session if args.finetune else None,
                               train_epochs=args.finetune,
                               metrics=ServeMetrics(session.metrics))
        report = sched.run()
        session.flush()
        if not session.lead:
            return report
        print(json.dumps(report.summary, indent=2, sort_keys=True))
        if report.requests:
            r0 = min(report.requests, key=lambda r: r.rid)
            print(f"request {r0.rid} tokens:", r0.out_tokens[:16],
                  "..." if len(r0.out_tokens) > 16 else "")
        return report
    finally:
        session.close()      # idempotent; flushes SLO + train JSONL


if __name__ == "__main__":
    main()
