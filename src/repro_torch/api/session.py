"""``AMBSession``: the programmatic surface over the AMB epoch
(counterpart of ``repro.api.session``).

    session = AMBSession(TrainSpec(arch="qwen2-1.5b", data=4),
                         ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip"))
    metrics = session.run(3)              # prefetched data plane
    session.flush()                       # settle in-flight consensus
    session.save("ckpt/")                 # primal + full state
    w = session.params                    # current primal iterate

The session runs on the card unless ``device`` says otherwise, and raises
if there is none.  Each epoch the clock draws per-gradient times from a
``torch.Generator`` seeded from (seed, epoch); under ``mode="amb"`` the
deadline T decides b_i(t), under ``mode="fmb"`` every worker takes
``batch_per_worker`` samples and the simulated wall clock waits for the
slowest.  The protocol takes one step; with ``metrics_path`` each epoch is
appended to a JSONL file.  ``run`` feeds the session from an input source
(default :meth:`AMBSession.batch_source`: per-worker shards of the arch's
:class:`~repro_torch.data.LMTokenStream`, generated on the session's
device) through a :class:`~repro_torch.data.Prefetcher`, which builds the
next batches on a side CUDA stream while the current epoch steps.

The epoch driver is sequential, pipelined (``ConsensusSpec.pipeline``) or
async with D in-flight payloads (``async_epochs``, ``staleness``); the
simulated wall clock adds T + T_c, max(T, T_c) or max(T, T_c / D) an
epoch.  Elastic membership: ``set_active(mask)`` forces a masked worker's
b_i(t) to 0 and rebuilds the gossip operator over the survivors (a ring or
torus re-laid onto a smaller one, :func:`repro_torch.dist.consensus.
survivor_taps`), after draining any in-flight consensus; the state carries
over, so a rejoining worker resumes from its stale dual.
``set_slowdown`` scales workers' clock draws before the deadline cut.
``run(..., faults=)`` drives a :mod:`repro_torch.faults` model through
both before each epoch.  ``TrainSpec.redundancy`` > 1 is coded placement
(:mod:`repro_torch.dist.redundancy`): the default source places rotated
copies of each group's block, and the steps weigh them by their decode
weights.  With an enabled :class:`ControllerSpec` each epoch feeds a
:class:`repro_torch.control.Controller`, whose actions move the budget
(into the clock) and the async driver's staleness (drain and rebuild).
``save`` / ``restore`` write and read JAX's checkpoint layout, the
controller's state included, and resume exactly.

One process per worker: with ``mesh=`` (a :func:`repro_torch.launch.
mesh.make_host_mesh` mesh), or whenever a process group of more than one
rank is initialised (the session then builds ``make_host_mesh(data,
model, pod=pod)``), each rank runs the worker at its (pod, data)
coordinate on its own shard of the stream, and the steps sum across the
ranks (:mod:`repro_torch.dist.amb`).  b_i(t) is the same on every rank:
the simulated clock draws from (seed, epoch), and the measured clock
takes the slowest rank's step seconds.  Only rank 0 writes the metrics
file.  Every driver and option runs over a group: each rank holds its
worker's rows of the per-worker state, the controller sees the same
record on every rank (the losses and noise statistics are summed across
the ranks, the step seconds are the slowest rank's) and so takes the same
action there, ``set_active`` drains and rebuilds on every rank, and
``save`` / ``restore`` keep JAX's layout: rank 0 writes the archive,
gathering each per-worker leaf a row at a time, and each rank reads back
only its own row.

A model axis (``TrainSpec.model`` M > 1 over a process group of pod x
data x M ranks) spreads each worker over M ranks (:mod:`repro_torch.dist.
tp`): each rank initialises its blocks of JAX's layout one leaf at a time
(or cuts them from the ``params`` it is given), the exact epoch runs FSDP
x TP and the gossip epochs (fp32, ``gossip_q8``, ``gossip_q4``) TP, and
``params`` gathers the whole primal on every rank.  A quantized round
there quantizes each rank's block of its worker's row on the whole row's
grid (reduced over "model") with the block's positions of the whole row's
draws.  Every driver and option runs so for the dense family (and the
vlm, MoE and ssm families, whose blocks the drivers treat alike): the
pipelined and async drivers (their in-flight payloads and snapshots are
this rank's blocks), the staleness retune, the controller (the noise
statistics are the whole leaves'), coded redundancy (a worker's M ranks
read the same shard) and elastic membership and churn (the survivor
relayout gossips the blocks; an out worker's blocks stay as they were).
``save`` and ``restore`` keep JAX's archive of whole leaves there too:
rank 0 writes each leaf gathered whole over "data" and "model" (one leaf
at a time), and each rank cuts its blocks from what it reads back
(:class:`repro_torch.dist.tp.CheckpointBlocks`), so a checkpoint carries
between one process and ranks at any (data, model).  Serving reads the
primal as ``serving_params()`` under ``serving_tp``, the TP-only layout
(``fsdp_axis=None``).  The MoE family runs the exact and gossip epochs,
serving and checkpoints so, its experts on "model"
(:func:`repro_torch.models.moe.moe_forward`), and so do the vlm family
(the dense blocks behind an embeddings input) and the RWKV6 ssm family,
each rank on its ``d_model / 64 / M`` heads
(:meth:`repro_torch.dist.tp.TensorParallel.ssm_leaves`), and the audio
family (whisper: the encoder's blocks and the decoder's self- and
cross-attention on each rank's heads; a worker's rows of
``batch["enc_embeds"]`` go with its rows of tokens, as every key of a
batch is cut by its first dim).  More model ranks than KV heads run too:
the ranks that share a head hold its columns and gather them
(:meth:`repro_torch.dist.tp.TensorParallel.gather_kv`), and so does the
hybrid family (zamba2: each rank's Mamba2 heads cut from JAX's blocks of
the packed ``w_in`` and ``conv_w``, :meth:`repro_torch.dist.tp.
TensorParallel.mamba_leaves`, and its shared block's heads).  A model
extent that does not divide the heads raises, naming ROADMAP.md's module
item 4a.5.3.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ckpt import load_checkpoint_into, save_checkpoint
from ..configs import get_config, smoke_config
from ..control import Controller, EpochRecord
from ..core.stragglers import amb_batch_sizes, fmb_finish_times
from ..data import LMTokenStream, Prefetcher, StreamSource
from ..device import resolve_device
from ..dist.consensus import torus_shape_for_mesh
from ..dist.group import WorkerGroup, num_workers
from ..dist.params import init_shards, shard_tree
from ..dist.redundancy import CodedAssignment
from ..dist.tp import TensorParallel, check_supported
from ..faults import FaultInjector
from ..kernels import router
from ..metrics import MetricsLogger
from ..models import DenseLM, init_params
from ..models.common import MetaGenerator
from ..optim import make_optimizer
from .clock import make_clock
from .protocol import build_protocol
from .specs import (MODES, ClockSpec, ConsensusSpec, ControllerSpec,
                    TrainSpec)


def not_ported(what: str, model: int) -> ValueError:
    """The refusal of what a worker spread over ``model`` ranks does not
    run yet."""
    return ValueError(f"{what} at model > 1 (a worker spread over {model} "
                      f"ranks) is not ported yet (ROADMAP.md, module item "
                      f"4a.5); every driver and option of every family "
                      f"runs")


class AMBSession:
    """One AMB training session: every worker on one device, or this
    process's worker of a process group (``mesh``).

    Args:
      train, clock, consensus: the spec triple (defaults as in JAX).
      controller: a :class:`ControllerSpec`; when ``enabled`` every step
        feeds a telemetry record to a :class:`repro_torch.control.
        Controller` and applies its actions in place: the budget into
        the clock, the staleness by :meth:`_apply_staleness`.  The
        decentralised steps then emit the gradient-noise statistics.
      cfg: an explicit architecture config (e.g. a depth-cut one).
      params: initial parameters, a :class:`DenseLM` or a dict of tensors
        in its layout; default: random from ``train.seed``.
      device: where the session runs ("cuda" unless told otherwise).
      draw_source: ``(seed, epoch) -> draws(k, out)``, the quantized
        gossip's rounding draws; default a ``torch.Generator`` on the
        device per round and worker (:func:`repro_torch.dist.consensus.
        epoch_draws`).  Over a process group it is called ``draws(k, out,
        rows=(worker,))`` for this worker's row.
      metrics_path: optional JSONL path; every epoch's metrics are
        appended through :class:`repro_torch.metrics.MetricsLogger` (by
        rank 0 alone over a process group).
      mesh: a mesh over the initialised process group: one process per
        worker (see the module note).  Default: none in a single process,
        ``make_host_mesh(data, model, pod=pod)`` when more than one rank
        is initialised; ``False`` keeps every worker in this process even
        then (a one-process twin run beside the ranks).

    Exact consensus runs ``train.optimizer``: dual averaging with the
    spec's beta schedule and no trust region, as the JAX session builds it
    (``ConsensusSpec.radius`` is not passed to it), or AdamW or SGD with
    their defaults.  Gossip consensus and the pipelined and async drivers
    run the paper's dual averaging only.  ``train.kernels`` other than
    ``auto`` pins the kernel routing for the process, as in JAX.
    """

    def __init__(self, train: TrainSpec, clock: Optional[ClockSpec] = None,
                 consensus: Optional[ConsensusSpec] = None,
                 controller: Optional[ControllerSpec] = None, *, cfg=None,
                 params=None, device="cuda", draw_source=None,
                 metrics_path=None, mesh=None):
        self.device = resolve_device(device)
        self.train = train
        if train.mode not in MODES:
            raise ValueError(f"unknown mode {train.mode!r}; choose from "
                             f"{MODES}")
        if train.kernels != "auto":
            router.set_mode(train.router_mode())
        self.clock_spec = clock if clock is not None else ClockSpec()
        self.consensus_spec = consensus if consensus is not None \
            else ConsensusSpec()
        self.cfg = cfg if cfg is not None else (
            smoke_config(train.arch) if train.smoke
            else get_config(train.arch))
        if mesh is None and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            from ..launch.mesh import make_host_mesh
            mesh = make_host_mesh(train.data, train.model, pod=train.pod,
                                  device=self.device.type)
        self.mesh = mesh = mesh or None
        self.group = None if mesh is None \
            else WorkerGroup(mesh, self.device)
        self.n_workers = train.pod * train.data if mesh is None \
            else num_workers(mesh)
        self.global_batch = self.n_workers * train.batch_per_worker
        # coded redundancy, checked here: one CodedAssignment drives the
        # data placement (batch_source) and the decode weights (the steps)
        self._assignment = None
        if train.redundancy > 1:
            self._assignment = CodedAssignment(self.n_workers,
                                               train.redundancy)
        self.clock = make_clock(self.clock_spec, self.n_workers,
                                train.batch_per_worker)
        self._decentralized = (self.consensus_spec.pipeline
                               or self.consensus_spec.async_epochs
                               or self.consensus_spec.consensus != "exact")
        self._optimizer = None
        if not self._decentralized:
            if train.optimizer == "dual_averaging":
                self._optimizer = make_optimizer(
                    "dual_averaging",
                    beta=self.consensus_spec.beta(self.global_batch))
            else:
                self._optimizer = make_optimizer(train.optimizer)
        elif train.optimizer != "dual_averaging":
            raise ValueError("gossip / pipelined / async modes run the "
                             "paper's dual-averaging protocol; use "
                             "optimizer='dual_averaging'")
        self.controller_spec = controller if controller is not None \
            else ControllerSpec()
        self.controller: Optional[Controller] = None
        if self.controller_spec.enabled:
            self.controller = Controller(
                self.controller_spec, n_workers=self.n_workers,
                comm_time=self.clock_spec.comm_time,
                b_target=self.global_batch, b_cap=self.global_batch,
                staleness=self.consensus_spec.staleness,
                async_mode=self.consensus_spec.async_epochs)
        self._draw_source = draw_source
        self._slow: Optional[np.ndarray] = None   # per-worker slowdowns
        self._active: Optional[tuple] = None
        self._protocols: dict = {}       # (mask, staleness) -> protocol
        self.tp = None
        self._serving_tp = None
        if self.group is not None and self.group.model > 1:
            self._check_model_axis()
            params = self._blocks(params)
        self._build_protocol()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(train.seed)
            params = init_params(self.cfg, gen)
        if isinstance(params, dict):
            params = DenseLM(self.cfg, params)
        self.model = params.to(self.device)
        self.state = self.protocol.init(self.model.params())
        self.steps_done = 0
        self.sim_wall = 0.0
        self.metrics = MetricsLogger(metrics_path) if metrics_path \
            and self.lead else None

    # -- construction ------------------------------------------------------

    @property
    def rank(self) -> int:
        """This process's worker (0 when every worker shares the
        process)."""
        return 0 if self.group is None else self.group.worker

    @property
    def lead(self) -> bool:
        """Whether this process writes the records (the metrics, the
        CLI's lines): the one process, or global rank 0."""
        return self.group is None or self.group.worker * self.group.model \
            + self.group.m == 0

    def _blocks(self, params) -> dict:
        """This rank's blocks of the parameters (``params``: a dict, a
        :class:`DenseLM`, or None to initialise them from the seed, one
        leaf at a time); builds ``self.tp``."""
        if isinstance(params, DenseLM):
            params = params.params()
        shapes = params if params is not None \
            else init_params(self.cfg, MetaGenerator())
        self.tp = TensorParallel(
            self.group, {k: v.shape for k, v in shapes.items()},
            None if self._decentralized else "data", self.cfg)
        coord = self.mesh.get_coordinate()
        if params is not None:
            return shard_tree(params, self.mesh, coord, self.tp.fsdp_axis)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.train.seed)
        return init_shards(self.cfg, gen, self.mesh, coord,
                           self.tp.fsdp_axis)

    def _check_model_axis(self) -> None:
        """Refuse what a worker spread over a model axis cannot run yet."""
        spec = self.consensus_spec
        check_supported(self.cfg, self.group.model)
        if spec.consensus not in ("exact", "gossip", "gossip_q8",
                                  "gossip_q4"):
            raise not_ported(f"{spec.consensus} consensus", self.group.model)

    def _build_protocol(self, active: Optional[tuple] = None) -> None:
        """(Re)build the epoch driver: at init, on ``set_active`` and on a
        staleness retune.  Exact consensus ignores ``active`` (a masked
        worker's b_i = 0 already drops it out of the eq.-6 average); the
        gossip family is cached by ``(mask, staleness)``, so a rejoin
        reuses the built protocol and its device source tables."""
        mask = active if self._decentralized else None
        key = (mask, self.consensus_spec.staleness) \
            if self._decentralized else None
        if key not in self._protocols:
            spec = self.consensus_spec
            amb = spec.to_amb_config(self.global_batch, self.train.seed,
                                     active=mask,
                                     noise_stats=self.controller is not None,
                                     redundancy=self.train.redundancy)
            if amb.torus_shape is None:
                # JAX's default torus: the (pod, data) extents
                amb = dataclasses.replace(amb, torus_shape=(
                    torus_shape_for_mesh(self.mesh) if self.mesh is not None
                    else (self.train.pod, self.train.data)
                    if self.train.pod > 1 else None))
            self._protocols[key] = build_protocol(
                self.cfg, self.n_workers, amb,
                optimizer=self._optimizer, pipeline=spec.pipeline,
                async_epochs=spec.async_epochs, staleness=spec.staleness,
                draw_source=self._draw_source, group=self.group,
                tp=self.tp)
        self.protocol = self._protocols[key]

    # -- elastic membership ------------------------------------------------

    @property
    def active(self) -> np.ndarray:
        """Bool (n_workers,) membership mask (all True when fully manned)."""
        if self._active is None:
            return np.ones(self.n_workers, dtype=bool)
        return np.asarray(self._active, dtype=bool)

    def set_active(self, mask) -> None:
        """Elastic worker join/leave: re-mask b_i(t), rebuild gossip taps.

        A False worker takes b_i(t) = 0 every epoch and is cut out of the
        gossip graph: a ring or torus re-lays the survivors onto a smaller
        one, other graphs take dense Metropolis weights on the induced
        subgraph.  One survivor is the identity; an all-inactive mask
        raises before anything is touched.  The state carries over, so a
        re-admitted worker resumes from its stale dual.  In-flight
        consensus (pipelined, async) is drained first, under the operator
        it was packed for; the protocol is built before the mask is
        committed, so a rejected mask leaves the session as it was, apart
        from that drain, which is always a valid state transition.
        """
        mask = np.asarray(mask, dtype=bool).reshape(-1)
        if mask.shape[0] != self.n_workers:
            raise ValueError(f"mask has {mask.shape[0]} entries for "
                             f"{self.n_workers} workers")
        if not mask.any():
            raise ValueError("at least one worker must stay active")
        active = None if mask.all() else tuple(bool(m) for m in mask)
        if active != self._active:
            self.flush()     # drain in-flight rounds under the old operator
        self._build_protocol(active)
        self._active = active

    def set_slowdown(self, slow) -> None:
        """Per-worker multipliers on the clock's per-gradient times (None
        clears them): each epoch's draws are scaled before the deadline
        cut, so a slow worker's b_i(t) shrinks through the paper's own
        variable-minibatch rule."""
        if slow is None:
            self._slow = None
            return
        slow = np.asarray(slow, dtype=np.float64).reshape(-1)
        if slow.shape[0] != self.n_workers:
            raise ValueError(f"slowdown has {slow.shape[0]} entries for "
                             f"{self.n_workers} workers")
        if (slow <= 0).any():
            raise ValueError("slowdown multipliers must be positive")
        self._slow = None if np.all(slow == 1.0) else slow

    # -- the epoch ---------------------------------------------------------

    def epoch_sizes(self, times: torch.Tensor, budget: float) -> torch.Tensor:
        """b_i(t) for one epoch: the deadline cut (AMB), or every worker's
        ``batch_per_worker`` (FMB); 0 for the workers masked out."""
        if self.train.mode == "amb":
            b = amb_batch_sizes(times, budget)
        else:
            b = torch.full((self.n_workers,), self.train.batch_per_worker,
                           dtype=torch.int32)
        if self._active is not None:
            b = torch.where(torch.as_tensor(self.active), b, 0)
        return b

    def step(self, batch: dict, b=None) -> dict:
        """Run one AMB epoch on a global batch; returns its metrics.

        ``b`` overrides the clock-derived (n_workers,) minibatch sizes.
        """
        gen = torch.Generator()
        gen.manual_seed(self.train.seed * 1_000_003 + 10_000
                        + self.steps_done)
        times, budget = self.clock.epoch(gen)
        if self._slow is not None:
            # scale each worker's per-gradient times: the deadline cut
            # below turns a slowdown into a smaller b_i(t)
            times = times * torch.as_tensor(self._slow,
                                            dtype=times.dtype)[:, None]
        if b is None:
            b = self.epoch_sizes(times, budget)
        # simulated wall clock: pipelined epochs hide T_c under the next
        # epoch's compute; async epochs give each consensus D compute
        # windows, so only T_c / D must fit an epoch; FMB waits for the
        # slowest worker's batch_per_worker gradients, then T_c
        spec = self.consensus_spec
        if self.train.mode == "amb":
            if spec.async_epochs:
                self.sim_wall += max(float(budget),
                                     self.clock_spec.comm_time
                                     / spec.staleness)
            elif spec.pipeline:
                self.sim_wall += max(float(budget),
                                     self.clock_spec.comm_time)
            else:
                self.sim_wall += float(budget) + self.clock_spec.comm_time
        else:
            self.sim_wall += float(fmb_finish_times(
                times, self.train.batch_per_worker).max()) \
                + self.clock_spec.comm_time
        t0 = time.perf_counter()
        self.state, m = self.protocol.step(self.state, batch, b)
        loss = float(m["loss"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_s = time.perf_counter() - t0
        if self.group is not None:
            # every rank feeds the clock the slowest worker's seconds, so
            # the measured budget (and b_i(t)) stays equal across ranks
            step_s = self.group.max_float(step_s)
        global_b = float(m["global_batch"])
        self.clock.update(step_s, global_b)
        self.steps_done += 1
        out = {"loss": loss, "global_batch": global_b,
               "budget_s": float(budget), "step_s": step_s,
               "sim_wall_s": self.sim_wall,
               "staleness": spec.staleness,
               "b": np.asarray(torch.as_tensor(b).cpu())}
        if self.controller is not None:
            action = self._control(m, out, times)
            if action is not None:
                out["action"] = action.to_dict()
        if self.metrics is not None:
            self.metrics.log(self.steps_done,
                             **{k: v for k, v in out.items() if k != "b"})
        return out

    def batch_source(self) -> StreamSource:
        """The session's default input: per-worker shards of the arch's LM
        token stream on the session's device (worker i draws stream node
        i: distinct i.i.d. shards, deterministic in (seed, node, epoch));
        under coded redundancy, rotated copies of each group's block from
        the group's node.  Over a process group: this rank's shard only."""
        return StreamSource(
            LMTokenStream(vocab_size=self.cfg.vocab_size,
                          seq_len=self.train.seq_len, seed=self.train.seed,
                          device=str(self.device)),
            self.n_workers, self.train.batch_per_worker,
            assignment=self._assignment,
            rank=None if self.group is None else self.group.worker)

    def run(self, steps: int, source=None, *, prefetch: int = 2,
            on_step=None, faults=None) -> Optional[dict]:
        """Run ``steps`` epochs on ``source.batch(epoch)`` at absolute epoch
        indices from ``steps_done`` (default source :meth:`batch_source`);
        returns the last epoch's metrics (None at 0 steps).

        With ``prefetch >= 1`` a :class:`~repro_torch.data.Prefetcher`
        builds that many batches ahead on a side CUDA stream (a thread on
        the CPU); ``prefetch=0`` builds each batch, then steps on it.
        ``on_step(epoch, metrics)`` is called after every epoch with the
        0-based absolute index of the epoch that just ran.

        ``faults`` is a :class:`repro_torch.faults.FaultModel` (or a
        :class:`~repro_torch.faults.FaultInjector`) applied before each
        epoch: membership through :meth:`set_active`, slowdowns through
        :meth:`set_slowdown`.  The trajectory is a pure function of the
        epoch, so a restored session under the same model replays it.  The
        data plane still fills every worker's slots: a down worker's
        samples weigh 0 (or, under coded placement, its group's members
        cover them)."""
        if steps <= 0:
            return None
        if source is None:
            source = self.batch_source()
        injector = None
        if faults is not None:
            injector = faults if isinstance(faults, FaultInjector) \
                else FaultInjector(faults)
        out = None
        if prefetch < 1:
            for epoch in range(self.steps_done, self.steps_done + steps):
                if injector is not None:
                    injector.apply(self, epoch)
                out = self.step(source.batch(epoch))
                if on_step is not None:
                    on_step(self.steps_done - 1, out)
            return out
        pf = Prefetcher(source, depth=prefetch, start_epoch=self.steps_done,
                        steps=steps, device=self.device)
        try:
            for batch in pf:
                # the prefetcher yields epochs in order from steps_done,
                # so the batch's epoch is the session's count
                if injector is not None:
                    injector.apply(self, self.steps_done)
                out = self.step(batch)
                if on_step is not None:
                    on_step(self.steps_done - 1, out)
        finally:
            pf.close()
        return out

    def _control(self, m: dict, out: dict, times: torch.Tensor):
        """Feed the epoch to the controller; apply any action in place."""
        # the measured mean seconds per gradient, from the time each node
        # spent on the gradients it finished: exact even when b_i reaches
        # the data cap and the node idles out the window (T / b_i would
        # over-bill those nodes and the Lemma-6 re-solve would feed back)
        tnp, bnp = times.cpu().numpy(), out["b"]
        eff = np.minimum(bnp, tnp.shape[1])
        done = eff >= 1
        tau_s = None
        if done.any():
            elapsed = np.cumsum(tnp, axis=1)[np.arange(tnp.shape[0]),
                                             np.maximum(eff, 1) - 1]
            tau_s = float(np.mean(elapsed[done] / eff[done]))
        rec = EpochRecord(
            t=self.steps_done, budget_s=out["budget_s"],
            comm_time_s=self.clock_spec.comm_time, step_s=out["step_s"],
            loss=out["loss"], b=bnp, tau_s=tau_s,
            global_batch=out["global_batch"],
            staleness=self.consensus_spec.staleness
            if self.consensus_spec.async_epochs else 1,
            grad_sq_norm=(float(m["grad_sq_norm"])
                          if "grad_sq_norm" in m else None),
            grad_var=float(m["grad_var"]) if "grad_var" in m else None)
        action = self.controller.observe(rec)
        if action is None:
            return None
        if action.budget is not None:
            self.clock.set_budget(action.budget)
        if action.staleness is not None:
            self._apply_staleness(action.staleness)
        # a b_target move needs no actuation: it feeds the next Lemma-6
        # re-solve, so the batch moves through the deadline T
        return action

    def flush(self) -> None:
        """Settle in-flight consensus (pipelined, async); no-op otherwise."""
        self.state = self.protocol.flush(self.state)

    def _apply_staleness(self, staleness: int) -> None:
        """Retune the async driver's D mid-run: drain, rebuild, migrate.

        The queue is drained first (a ``flush``): every payload was packed
        with the old D's damping and settles under it.  The new driver
        starts from an empty queue; the settled dual ``z``, ``w0`` and the
        epoch count ``t`` carry over.  Rebuilds go through the ``(mask,
        staleness)`` protocol cache, as in :meth:`set_active`.
        """
        if staleness == self.consensus_spec.staleness:
            return
        if not self.consensus_spec.async_epochs:
            raise ValueError("staleness is the async driver's knob; this "
                             f"session runs {self.protocol.mode!r}")
        self.flush()    # settle the queue under the D it was packed for
        self.consensus_spec = self.consensus_spec.replace(
            staleness=int(staleness))
        self._build_protocol(self._active)
        old = self.state
        for key in ("queue", "snaps"):
            old.pop(key, None)          # the drained slots of the old D
        fresh = self.protocol.init(old["w0"])
        fresh.update(z=old["z"], w0=old["w0"], t=old["t"])
        self.state = fresh

    def close(self) -> None:
        """Release the metrics logger (idempotent)."""
        if self.metrics is not None:
            self.metrics.close()
            self.metrics = None

    @property
    def params(self) -> dict:
        """The current primal iterate (gossip: the node-averaged prox of the
        active workers' duals).  Pipelined and async sessions should
        ``flush()`` first so the in-flight payloads are folded in.  At
        model > 1 every rank calls it and gets the whole iterate (for
        comparisons; it is not a checkpoint)."""
        primal = self.protocol.primal(self.state)
        return primal if self.tp is None else self.tp.whole(primal)

    @property
    def serving_tp(self) -> Optional[TensorParallel]:
        """The serving layout over this session's ranks at model > 1: a
        :class:`TensorParallel` with ``fsdp_axis=None`` (the gossip
        epochs' own; an exact session's is built once); None at model
        1."""
        if self.tp is None or self.tp.fsdp_axis is None:
            return self.tp
        if self._serving_tp is None:
            self._serving_tp = TensorParallel(self.group, self.tp.shapes,
                                              None, self.cfg)
        return self._serving_tp

    def serving_params(self) -> dict:
        """The current primal as the slot engine reads it: :attr:`params`
        at model 1; at model > 1 this rank's blocks under
        :attr:`serving_tp` (a gossip session's primal blocks as they are,
        an exact session's FSDP x TP blocks all-gathered over "data").
        Every rank calls it."""
        if self.tp is None:
            return self.params
        return self.tp.unshard_data(self.protocol.primal(self.state))

    def save(self, directory) -> None:
        """Checkpoint the primal and the full state at the current step.

        JAX's layout: ``<dir>/step_<n>/`` holds the primal (what serving
        reads), ``<dir>/session_state/step_<n>/`` the protocol's state
        (optimizer or per-worker duals, any in-flight queue, the epoch
        count), and ``session.json``, written per step and at the root
        (the latest step), the spec triple and the session's counters.
        Over a process group every rank calls it: rank 0 writes, the
        per-worker leaves gathered to it a row at a time; at model > 1
        each leaf (and row) is first gathered whole from the ranks'
        blocks, one at a time.
        """
        directory = Path(directory)
        blocks = None if self.tp is None else self.tp.checkpoint_blocks()
        if blocks is None:
            params = self.params      # a sum across the ranks: every rank
            if self.lead:
                save_checkpoint(directory, self.steps_done, params)
            del params
        else:
            save_checkpoint(directory, self.steps_done,
                            self.protocol.primal(self.state),
                            group=self.group, blocks=blocks)
        state_dir = save_checkpoint(directory / "session_state",
                                    self.steps_done, self.state,
                                    group=self.group,
                                    row_keys=self.protocol.row_keys,
                                    blocks=blocks)
        if not self.lead:
            self.group.barrier()      # until rank 0 has written it all
            return
        meta = {
            "step": self.steps_done,
            "sim_wall_s": self.sim_wall,
            "train": self.train.to_dict(),
            "clock": self.clock_spec.to_dict(),
            # the current spec: its staleness shapes the saved queue
            "consensus": self.consensus_spec.to_dict(),
            "active": None if self._active is None else list(self._active),
            "sec_per_grad": getattr(self.clock, "sec_per_grad", None),
            # the budget in force
            "clock_budget": getattr(
                self.clock, "budget_t",
                getattr(self.clock, "compute_time", None)),
            "controller": None if self.controller is None else {
                "spec": self.controller_spec.to_dict(),
                "state": self.controller.to_state()},
        }
        blob = json.dumps(meta, sort_keys=True, indent=1)
        # the per-step copy first: restore(step=) reads the counters and
        # the mask of the state it lands
        (state_dir / "session.json").write_text(blob)
        (directory / "session.json").write_text(blob)
        if self.group is not None:
            self.group.barrier()

    @classmethod
    def restore(cls, directory, *, step: Optional[int] = None, cfg=None,
                device="cuda", metrics_path=None) -> "AMBSession":
        """Rebuild a session from a :meth:`save` directory, resuming exactly.

        The specs come from ``session.json``, the controller's too; then
        the membership mask (applied before the state lands, so its drain
        touches nothing restored), the full state, the step count, the
        simulated wall clock, the measured clock's seconds per gradient,
        the budget in force and the controller's state.  The clock's draws
        are seeded from the step count, so they resume too.  ``step``
        picks a checkpoint (default the latest), and its own
        ``session.json`` copy; ``cfg`` is required when the saved session
        had a custom config.  Under an initialised process group of more
        than one rank every rank calls it and reads only its own row of
        each per-worker leaf (at model > 1, and only its block of each
        leaf and row); a checkpoint written by one process restores into
        ranks and back.
        """
        directory = Path(directory)
        meta = json.loads((directory / "session.json").read_text())
        step_sel = meta["step"] if step is None else step
        per_step = (directory / "session_state" / f"step_{step_sel:08d}"
                    / "session.json")
        if per_step.exists():
            meta = json.loads(per_step.read_text())
        ctl = meta.get("controller")
        session = cls(TrainSpec.from_dict(meta["train"]),
                      ClockSpec.from_dict(meta["clock"]),
                      ConsensusSpec.from_dict(meta["consensus"]),
                      None if ctl is None
                      else ControllerSpec.from_dict(ctl["spec"]), cfg=cfg,
                      device=device, metrics_path=metrics_path)
        if meta.get("active") is not None:
            session.set_active(meta["active"])
        # into the fresh state in place, leaf by leaf: the card never
        # holds the state twice
        load_checkpoint_into(directory / "session_state", step_sel,
                             session.state, row=None if session.group is None
                             else session.group.worker,
                             row_keys=session.protocol.row_keys,
                             blocks=None if session.tp is None
                             else session.tp.checkpoint_blocks())
        session.steps_done = step_sel
        session.sim_wall = float(meta.get("sim_wall_s", 0.0))
        if meta.get("sec_per_grad") is not None \
                and hasattr(session.clock, "sec_per_grad"):
            session.clock.sec_per_grad = float(meta["sec_per_grad"])
        if meta.get("clock_budget") is not None:
            session.clock.set_budget(float(meta["clock_budget"]))
        if ctl is not None and session.controller is not None:
            session.controller.load_state(ctl["state"])
        return session

