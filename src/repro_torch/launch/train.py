"""AMB training driver: a thin CLI over :class:`repro_torch.api.AMBSession`
(counterpart of ``repro.launch.train``, with its flags for every field the
port has).

Every flag maps onto one of the session specs (:class:`TrainSpec`,
:class:`ClockSpec`, :class:`ConsensusSpec`, :class:`ControllerSpec`);
the session owns the clock (measured by default, ``--sim-clock`` for the
paper's simulated clock), the consensus strategy and the optimizer
(``--optimizer``; gossip runs dual averaging only), AMB or FMB epochs
(``--mode``), and the prefetched data plane: per-worker shards of the
arch's LM token stream, built on a side CUDA stream ``--prefetch``
batches ahead.  Per-epoch metrics go to
``--metrics`` or ``artifacts/train_<arch>_<mode>.jsonl``.  ``--pod`` and
``--data`` are JAX's mesh extents (``pod * data`` workers; ``--model``
must be 1).  In one process the workers share the device; under
``torchrun`` (``WORLD_SIZE`` > 1 in the environment) the CLI initialises
the process group from the environment with ``--dist-backend`` (default
NCCL on the card, gloo on the CPU; printed) and each rank runs the worker
at its (pod, data) coordinate: the train CLI's one process per worker.
NCCL takes one card per rank; gloo may put several ranks on one card,
keeps the compute there and sends the gossip rows through pinned host
buffers (the bytes are printed per rank at the end).  Only rank 0 prints
the steps and writes the metrics.  ``--pipeline`` runs
staleness-1 pipelined epochs, ``--async --staleness D`` the AMB-DG
queue of D payloads.  The run flushes in-flight consensus at its end;
``--ckpt-dir`` then saves the session, and ``--restore DIR`` resumes a
saved one (its specs override the spec flags), continuing the data order
and the logged step.  ``--controller`` runs the online controller over
the budget T, the async staleness D and the batch target (an action
prints a ``controller:`` line).  ``--churn RATE`` drives the run through
a :class:`repro_torch.faults.PoissonChurn` model (each unpinned worker
leaves at RATE an epoch and rejoins at ``--churn-rejoin``; worker 0
stays up), whose membership changes go through the session's
``set_active``; ``--redundancy RHO`` keeps the gradient estimate unbiased
while replica holders are down.

Example (on the card; ``main(argv, device="cpu")`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --data 4 --consensus gossip --async \\
      --staleness 2 --sim-clock --ckpt-dir ckpt/
Four processes, one worker each, on a (pod 2 x data 2) torus:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --smoke --pod 2 \\
      --data 2 --consensus gossip --graph torus --sim-clock \\
      --dist-backend gloo
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..api import (AMBSession, ClockSpec, ConsensusSpec, ControllerSpec,
                   TrainSpec)
from ..faults import PoissonChurn
from ..metrics import MetricsLogger


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    TrainSpec.add_cli_args(ap)
    ClockSpec.add_cli_args(ap)
    ConsensusSpec.add_cli_args(ap)
    ControllerSpec.add_cli_args(ap)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="data-plane prefetch depth (batches built ahead "
                         "of the step; 0 = synchronous)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="resume from an AMBSession.save directory "
                         "(params, opt/dual state, and step counter; the "
                         "saved specs override the spec flags)")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--churn", type=float, default=0.0, metavar="RATE",
                    help="Poisson churn: per-epoch leave rate for each "
                         "unpinned worker (0 = off); membership changes "
                         "rebuild consensus over the survivors")
    ap.add_argument("--churn-rejoin", type=float, default=0.5,
                    help="per-epoch rejoin rate for downed workers")
    ap.add_argument("--churn-seed", type=int, default=0,
                    help="fault-trajectory seed (independent of --seed)")
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="process-group backend under torchrun "
                         "(WORLD_SIZE > 1): default nccl on the card, gloo "
                         "on the CPU; gloo may put several ranks on one "
                         "card")
    args = ap.parse_args(argv)
    device, owned = _init_group(args.dist_backend, device)
    try:
        return _run(args, device)
    finally:
        if owned:
            dist.destroy_process_group()


DIST_BACKENDS = ("nccl", "gloo")


def _init_group(backend, device) -> tuple:
    """Initialise the process group from torchrun's environment when it
    holds more than one rank; returns (this rank's device, whether the
    group was started here)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return device, False
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise SystemExit("--dist-backend nccl takes CUDA devices; use gloo "
                         "on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise SystemExit(f"--dist-backend nccl: {world} ranks but "
                             f"{cards} card(s); NCCL takes one rank per "
                             f"card (use gloo to share a card)")
        device = f"cuda:{local % cards}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method="env://")
    print(f"rank {dist.get_rank()}/{world}: backend {backend}, device "
          f"{device}", flush=True)
    return device, True


def _run(args, device):
    faults = None
    if args.churn > 0.0:
        faults = PoissonChurn(leave_rate=args.churn,
                              rejoin_rate=args.churn_rejoin,
                              seed=args.churn_seed)

    try:
        if args.restore:
            session = AMBSession.restore(args.restore, device=device,
                                         metrics_path=args.metrics)
            if session.metrics is None:     # the arch-derived default
                session.metrics = MetricsLogger(
                    f"artifacts/train_{session.train.arch}_"
                    f"{session.train.mode}.jsonl")
        else:
            train = TrainSpec.from_args(args)
            session = AMBSession(
                train, ClockSpec.from_args(args),
                ConsensusSpec.from_args(args),
                ControllerSpec.from_args(args), device=device,
                metrics_path=args.metrics
                or f"artifacts/train_{train.arch}_{train.mode}.jsonl")
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    # run draws epochs at the session's own count, so a restored run
    # continues the data order and the logged step where the saved one
    # stopped
    last = session.steps_done + args.steps - 1

    def on_step(step, m):
        if session.rank != 0:
            return
        if "action" in m:
            print(f"step {step:4d} controller: {m['action']['reason']}",
                  flush=True)
        if step % 10 == 0 or step == last:
            print(f"step {step:4d} loss {m['loss']:.4f} "
                  f"b(t)={m['global_batch']:.0f} "
                  f"T={m['budget_s']:.3f}s "
                  f"sim_wall={m['sim_wall_s']:.1f}s", flush=True)

    try:
        m = session.run(args.steps, prefetch=args.prefetch, on_step=on_step,
                        faults=faults)
        session.flush()      # settle in-flight gossip (pipelined, async)
        if args.ckpt_dir:
            session.save(args.ckpt_dir)
            print(f"checkpoint saved to {args.ckpt_dir}", flush=True)
        if session.group is not None:
            g = session.group
            print(f"rank {g.worker}: sent {g.sent_bytes} bytes, staged "
                  f"{g.staged_bytes} bytes ({g.backend})", flush=True)
    finally:
        session.close()
    return None if m is None else m["loss"]


if __name__ == "__main__":
    main()
