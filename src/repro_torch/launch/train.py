"""AMB training driver: a thin CLI over :class:`repro_torch.api.AMBSession`
(counterpart of ``repro.launch.train``, with its flags for every field the
port has).

Every flag maps onto one of the session specs (:class:`TrainSpec`,
:class:`ClockSpec`, :class:`ConsensusSpec`); the session owns the clock
(measured by default, ``--sim-clock`` for the paper's simulated clock),
the consensus strategy and the optimizer (``--optimizer``; gossip runs
dual averaging only), AMB or FMB epochs (``--mode``), and the prefetched
data plane: per-worker shards of the arch's LM token stream, built on a
side CUDA stream ``--prefetch`` batches ahead.  Per-epoch metrics go to
``--metrics`` or ``artifacts/train_<arch>_<mode>.jsonl``.  The port runs
on one device: ``--model`` and ``--pod`` must be 1.  Checkpoints, the
controller, coded redundancy, churn and pipelined or async epochs are not
ported, so their flags are not registered.

Example (on the card; ``main(argv, device="cpu")`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --data 4 --consensus gossip --sim-clock
"""
from __future__ import annotations

import argparse

from ..api import AMBSession, ClockSpec, ConsensusSpec, TrainSpec


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    TrainSpec.add_cli_args(ap)
    ClockSpec.add_cli_args(ap)
    ConsensusSpec.add_cli_args(ap)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="data-plane prefetch depth (batches built ahead "
                         "of the step; 0 = synchronous)")
    ap.add_argument("--metrics", default=None)
    args = ap.parse_args(argv)
    for flag in ("model", "pod"):
        if getattr(args, flag) != 1:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: the port "
                             f"runs on one device, so there is no {flag} "
                             f"axis; use --{flag} 1")

    train = TrainSpec.from_args(args)
    try:
        session = AMBSession(
            train, ClockSpec.from_args(args), ConsensusSpec.from_args(args),
            device=device, metrics_path=args.metrics
            or f"artifacts/train_{train.arch}_{train.mode}.jsonl")
    except ValueError as e:
        raise SystemExit(str(e))
    last = session.steps_done + args.steps - 1

    def on_step(step, m):
        if step % 10 == 0 or step == last:
            print(f"step {step:4d} loss {m['loss']:.4f} "
                  f"b(t)={m['global_batch']:.0f} "
                  f"T={m['budget_s']:.3f}s "
                  f"sim_wall={m['sim_wall_s']:.1f}s", flush=True)

    try:
        m = session.run(args.steps, prefetch=args.prefetch, on_step=on_step)
        session.flush()
    finally:
        session.close()
    return None if m is None else m["loss"]


if __name__ == "__main__":
    main()
