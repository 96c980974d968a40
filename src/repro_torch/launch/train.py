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
``--metrics`` or ``artifacts/train_<arch>_<mode>.jsonl``.  The port runs
on one device: ``--model`` and ``--pod`` must be 1.  ``--pipeline`` runs
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
"""
from __future__ import annotations

import argparse

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
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=1)
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
    args = ap.parse_args(argv)
    for flag in ("model", "pod"):
        if getattr(args, flag) != 1:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: the port "
                             f"runs on one device, so there is no {flag} "
                             f"axis; use --{flag} 1")
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
    except ValueError as e:
        raise SystemExit(str(e))
    # run draws epochs at the session's own count, so a restored run
    # continues the data order and the logged step where the saved one
    # stopped
    last = session.steps_done + args.steps - 1

    def on_step(step, m):
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
    finally:
        session.close()
    return None if m is None else m["loss"]


if __name__ == "__main__":
    main()
