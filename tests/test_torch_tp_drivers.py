"""Every AMB driver and option over a model axis: eight gloo ranks as
(data 4, model 2) on the CPU, JAX's own test mesh, each worker spread over
two ranks, against the one-process ``data=4`` port session and JAX.

Eight ranks start as subprocesses of this file (``python
tests/test_torch_tp_drivers.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run at the fp32 smoke config on JAX's initial parameters
(``models.from_jax_params``), each session on its own data plane (the
simulated clock's b(t), the stream's shards):

  * the pipelined driver and the async driver at staleness 1, fp32 gossip
    and ``gossip_q8`` (on JAX's draws, which the parent makes and hands
    the ranks through ``draws.npz``): the async ranks' dual blocks bit for
    bit the pipelined ranks' (``tests/test_async.py``'s anchor); both
    against JAX's ``make_pipelined_gossip_train_step`` /
    ``make_async_gossip_train_step`` on a stand-in mesh of 4 workers with
    a hand-built state (the losses within 1e-5, the gathered dual stack
    at ``tests/test_torch_pipeline.py``'s fp32 tolerance or within
    STACK_RTOL) and against the one-process port session;
  * the async driver at D = 2 and D = 3: the duals stay 0 through step
    D - 1, the two split at step 3, and a flush drains the queue with
    ``t`` kept;
  * ``set_active`` with worker 2 out: under exact consensus the epoch
    equals one at b_2 = 0; under gossip worker 2's blocks stay as they
    were bit for bit, the survivors (a ring of three) match the
    one-process session and the primal averages the active workers;
    ``run(faults=PoissonChurn(...))`` takes the same trajectory on every
    rank;
  * coded exact at ``redundancy=2`` against the one-process session and
    JAX's ``make_train_step``;
  * the controller on async gossip raising D mid-run with the same
    action on every rank; the noise statistics within NOISE_RTOL of the
    one-process session's and of JAX's ``grad_noise_stats`` on whole
    leaves;
  * the train CLI with ``--model 2`` and ``--pipeline``, ``--async
    --staleness 2``, ``--redundancy 2 --controller`` and ``--churn``
    against the one-process ``--data 4`` CLI.

The spawn has a join deadline (``JOIN_S``) and the process group a
timeout (``PG_TIMEOUT_S``).
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N, M, PER, SEQ, EPOCHS = 4, 2, 2, 16, 2
BETA = (50.0, float(N * PER), 200.0)     # the session's schedule
SEED = 3                                 # TrainSpec.seed: the draws' key
ROUNDS = 1                               # gossip_q8: 4 rounds a settle
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: TP and FSDP sum in another order
NOISE_RTOL = 1e-5       # whole-leaf sums in another order, fp64
STACK_RTOL = 1e-2       # q8: a flipped stochastic rounding moves a grid step
CLI_RTOL = 1e-3         # the bf16 smoke config: partial products rounded
MASK = (True, True, False, True)
CHURN = dict(leave_rate=0.5, rejoin_rate=0.5, seed=3)
CHURN_EPOCHS = 4
STALE_EPOCHS = 4        # D = 2 and D = 3 split at step 3
RADIUS = 2e-3           # binds on six matrix leaves (tests/test_torch_tp.py)
CONTROL = dict(comm_time=12.0, warmup=2, epochs=6)   # tests/test_control.py
DRIVERS = {
    "pipelined_gossip": dict(consensus="gossip", pipeline=True),
    "async1_gossip": dict(consensus="gossip", async_epochs=True),
    "pipelined_q8": dict(consensus="gossip_q8", pipeline=True),
    "async1_q8": dict(consensus="gossip_q8", async_epochs=True),
}
CODED = dict(consensus="exact", redundancy=2)
CLI_ARGV = ["--smoke", "--batch-per-worker", str(PER), "--seq-len",
            str(SEQ), "--sim-clock", "--steps", "3", "--prefetch", "0",
            "--consensus", "gossip", "--data", str(N)]
LANE_SIZES = (1, 3, 5, 4099)    # elements of a staged chunk, some < lanes
CLIS = {"pipeline": ["--pipeline"], "async": ["--async", "--staleness", "2"],
        "coded_controller": ["--redundancy", "2", "--controller",
                             "--controller-warmup", "1",
                             "--controller-interval", "1"],
        "churn": ["--churn", "0.5"]}


def _cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                               dtype="float32")


def stored_source(table: dict):
    """The draw seam over stored stacks: ``table[(seed, epoch, k)]`` is
    round k's (n, W + 1) draws; ``rows`` picks a worker's row of them."""
    def source(seed, epoch):
        def draws(k, out, rows=None):
            full = torch.from_numpy(table[(seed, epoch, k)])
            return out.copy_(full if rows is None else full[list(rows)])
        return draws
    return source


def _session(case: dict, params, mesh=None, draws=None, clock=None,
             controller=None):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    return AMBSession(
        TrainSpec(smoke=True, data=N, model=1 if mesh is None else M,
                  batch_per_worker=PER, seq_len=SEQ, seed=SEED,
                  redundancy=case.get("redundancy", 1)),
        clock or ClockSpec(kind="simulated"),
        ConsensusSpec(consensus=case["consensus"], graph="ring",
                      gossip_rounds=ROUNDS,
                      pipeline=case.get("pipeline", False),
                      async_epochs=case.get("async_epochs", False),
                      staleness=case.get("staleness", 1),
                      radius=case.get("radius")),
        controller, cfg=_cfg(),
        params={k: v.clone() for k, v in params.items()}, device="cpu",
        mesh=mesh, draw_source=draws)


def _tree(session) -> dict:
    state = session.state
    tree = state["z"] if "z" in state else state["params"]
    return {k: v.detach().clone() for k, v in tree.items()}


def _epoch(session, faults=None) -> dict:
    """One epoch through ``run`` (no prefetcher), with the protocol
    step's noise statistics when it reports them."""
    proto, step, got = session.protocol, session.protocol.step, {}

    def spy(state, batch, b):
        state, m = step(state, batch, b)
        if "grad_sq_norm" in m:
            got["noise"] = [float(m["grad_sq_norm"]), float(m["grad_var"])]
        return state, m
    proto.step = spy
    try:
        m = session.run(1, prefetch=0, faults=faults)
    finally:
        proto.step = step       # a retune may have rebuilt the protocol
    return {"loss": m["loss"], "b": [int(x) for x in m["b"]],
            "active": [bool(x) for x in session.active],
            "staleness": m["staleness"], "action": m.get("action"),
            "noise": got.get("noise")}


def _record(session, epochs: list) -> dict:
    out = {k: [e[k] for e in epochs] for k in epochs[0]}
    out["tree"] = _tree(session)
    if session.group is not None:
        out.update(sent=session.group.sent_bytes,
                   worker=session.group.worker, m=session.group.m)
    return out


def run_driver(name, params, draws, mesh=None) -> dict:
    session = _session(DRIVERS[name], params, mesh, draws)
    epochs = [_epoch(session) for _ in range(EPOCHS)]
    session.flush()
    return _record(session, epochs)


def run_radius(params, mesh=None) -> dict:
    """The pipelined driver under a trust region that binds: its primal
    after a flush (the prox's norm is the whole leaf's)."""
    session = _session(dict(consensus="gossip", pipeline=True,
                            radius=RADIUS), params, mesh)
    epochs = [_epoch(session) for _ in range(EPOCHS)]
    session.flush()
    out = _record(session, epochs)
    out["whole"] = session.params
    return out


def run_stale(staleness: int, params, mesh=None) -> dict:
    """D = ``staleness``: each step's largest |z| (of this rank's blocks),
    then a flush: the queue's largest |slot| and ``t``."""
    session = _session(dict(consensus="gossip", async_epochs=True,
                            staleness=staleness), params, mesh)
    epochs = []
    for _ in range(STALE_EPOCHS):
        e = _epoch(session)
        e["z_mag"] = max(float(v.abs().max())
                         for v in session.state["z"].values())
        epochs.append(e)
    session.flush()
    out = _record(session, epochs)
    out["queue_mag"] = max(float(s.abs().max()) for key in ("queue", "snaps")
                           for s in session.state.get(key, []))
    out["t"] = session.state["t"]
    return out


def run_active(params, mesh=None) -> dict:
    """Gossip: one epoch with every worker, one with worker 2 out (its
    blocks before and after it), the primal then, and one more with
    every worker back."""
    session = _session(dict(consensus="gossip"), params, mesh)
    epochs = [_epoch(session)]
    session.set_active(MASK)
    before = _tree(session)
    epochs.append(_epoch(session))
    out = {"out_before": before, "out_after": _tree(session),
           "primal_out": {k: v.clone() for k, v in session.params.items()}}
    session.set_active([True] * N)
    epochs.append(_epoch(session))
    out.update(_record(session, epochs))
    return out


def run_exact_active(params, mesh) -> dict:
    """Exact consensus: ``set_active`` with worker 2 out against the same
    epoch at the b it drew with b_2 forced to 0."""
    masked = _session(dict(consensus="exact"), params, mesh)
    masked.set_active(MASK)
    ma = masked.run(1, prefetch=0)
    forced = _session(dict(consensus="exact"), params, mesh)
    mb = forced.step(forced.batch_source().batch(0),
                     b=torch.as_tensor(ma["b"]))
    return {"b": [int(x) for x in ma["b"]], "loss": [ma["loss"], mb["loss"]],
            "masked": masked.params, "forced": forced.params}


def run_faults(params, mesh=None) -> dict:
    from repro_torch.faults import PoissonChurn
    session = _session(dict(consensus="gossip"), params, mesh)
    model = PoissonChurn(**CHURN)
    epochs = [_epoch(session, model) for _ in range(CHURN_EPOCHS)]
    session.flush()
    return _record(session, epochs)


def run_coded(params, mesh=None) -> dict:
    session = _session(CODED, params, mesh)
    epochs = [_epoch(session) for _ in range(EPOCHS)]
    out = _record(session, epochs)
    out["whole"] = {k: v.detach() for k, v in session.params.items()}
    return out


def run_controller(params, mesh=None) -> dict:
    from repro_torch.api import ClockSpec, ControllerSpec
    session = _session(
        dict(consensus="gossip", async_epochs=True), params, mesh,
        clock=ClockSpec(kind="simulated", comm_time=CONTROL["comm_time"]),
        controller=ControllerSpec(enabled=True, interval=1,
                                  warmup=CONTROL["warmup"]))
    epochs = [_epoch(session) for _ in range(CONTROL["epochs"])]
    out = _record(session, epochs)
    out["final_staleness"] = session.consensus_spec.staleness
    return out


def run_all(params, table, mesh=None) -> dict:
    draws = stored_source(table)
    out = {name: run_driver(name, params, draws, mesh) for name in DRIVERS}
    for d in (2, 3):
        out[f"async{d}"] = run_stale(d, params, mesh)
    out["radius"] = run_radius(params, mesh)
    out["active"] = run_active(params, mesh)
    out["faults"] = run_faults(params, mesh)
    out["coded"] = run_coded(params, mesh)
    out["controller"] = run_controller(params, mesh)
    return out


def _lane_row(sender: int, n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32) + 1000.0 * sender + 0.5 * n


def run_lanes(rank: int, world: int) -> dict:
    """``WorkerGroup._lanes_p2p`` over the wire lanes: each rank sends a
    chunk of each of LANE_SIZES elements to the next rank of a ring and
    receives the previous rank's into a buffer (fewer elements than
    lanes included); returns what arrived."""
    from repro_torch.dist import group as G
    lanes = types.SimpleNamespace(_lanes=G.wire_lanes())
    out = {}
    for n in LANE_SIZES:
        got = torch.full((n,), -1.0)
        G.WorkerGroup._lanes_p2p(lanes, _lane_row(rank, n),
                                 [((rank + 1) % world, 7)],
                                 [((rank - 1) % world, 7, got)])
        out[n] = got
    return out


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: the wire lanes, every driver and option, then the CLIs;
    results to ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)
    try:
        lanes = run_lanes(rank, world)
        params = torch.load(outdir / "params.pt")
        table = np.load(outdir / "draws.npz", allow_pickle=True)[
            "table"].item()
        mesh = make_host_mesh(N, M, device="cpu")
        out = run_all(params, table, mesh)
        out["lanes"] = lanes
        out["coord"] = tuple(int(c) for c in mesh.get_coordinate())
        out["exact_active"] = run_exact_active(params, mesh)
        out["cli"] = {name: train.main(
            CLI_ARGV + extra + ["--model", str(M), "--metrics",
                                str(outdir / f"cli_{name}.jsonl")],
            device="cpu") for name, extra in CLIS.items()}
        torch.save(out, outdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(tmp_path: Path, world: int = N * M) -> list:
    """Start ``world`` ranks of this file, wait at most JOIN_S for all of
    them (then kill every one and fail), and return their results."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(store), str(r), str(world),
         str(tmp_path)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(0.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = "\n".join((tmp_path / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))
    if hung:
        pytest.fail(f"ranks {hung} still running after {JOIN_S} s; "
                    f"killed\n{text}")
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        pytest.fail(f"ranks {bad} failed\n{text}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The ranks run one intra-op thread each: so does the reference."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_uniform(key, shape) -> np.ndarray:
    import jax
    with jax.threefry_partitionable(True):
        return np.array(jax.random.uniform(key, shape))


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters of the fp32 smoke config and the port's
    copy, and JAX's draws of every q8 settle the drivers take (the
    enqueue epochs -1 to EPOCHS - 1, 4 rounds each)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro_torch import models
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    params = {k: v.detach() for k, v in models.from_jax_params(
        jax.tree.map(np.asarray, jparams), _cfg(), device="cpu")
        .params().items()}
    width = sum(v.numel() for v in params.values()) + 1
    table = {}
    for t in range(-1, EPOCHS):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED),
                                 jnp.asarray(t, jnp.int32))
        for k in range(4 * ROUNDS):
            table[(SEED, t, k)] = _jax_uniform(jax.random.fold_in(key, k),
                                               (N, width))
    return jcfg, jparams, params, table


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    outdir = tmp_path_factory.mktemp("ranks_tp_drivers")
    *_, params, table = inputs
    torch.save(params, outdir / "params.pt")
    np.savez(outdir / "draws.npz", table=np.array(table, dtype=object))
    return spawn(outdir), outdir


@pytest.fixture
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_process(inputs):
    """The same sessions with the four workers in one process (one
    thread), and each session's global batches."""
    *_, params, table = inputs
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = run_all(params, table)
        for name, case in (("pipelined_gossip", DRIVERS["pipelined_gossip"]),
                           ("coded", CODED)):
            source = _session(case, params).batch_source()
            out[name]["batches"] = [
                {k: v.numpy().astype(np.int32)
                 for k, v in source.batch(t).items()}
                for t in range(CONTROL["epochs"])]
        return out
    finally:
        torch.set_num_threads(before)


def _mesh():
    from repro_torch.launch.mesh import abstract
    return abstract((N, M), ("data", "model"))


def _shapes(params) -> dict:
    return {k: tuple(v.shape) for k, v in params.items()}


def _dual_stack(ranks, name, shapes: dict, key="tree") -> np.ndarray:
    """Each worker's dual gathered over its model ranks, as an (N, W)
    stack in sorted leaf order."""
    from repro_torch.dist import params as P
    rows = []
    for i in range(N):
        blocks = {g["coord"]: {k: v[0] for k, v in g[name][key].items()}
                  for g in ranks if g["coord"][0] == i}
        rows.append(P.gather_tree(blocks, _mesh(), shapes, None))
    return np.stack([np.concatenate([row[k].numpy().ravel()
                                     for k in sorted(row)]) for row in rows])


def _stack(z: dict) -> np.ndarray:
    return np.concatenate([np.asarray(z[k], np.float32).reshape(N, -1)
                           for k in sorted(z)], 1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _close(got: np.ndarray, want: np.ndarray, consensus: str) -> None:
    """``tests/test_torch_pipeline.py``'s tolerance for fp32 gossip duals,
    STACK_RTOL of the stack's norm for q8."""
    if consensus == "gossip":
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale)
    else:
        assert np.linalg.norm(got - want) <= STACK_RTOL * np.linalg.norm(want)


def _jax_batches(one_process, name, epochs) -> list:
    import jax.numpy as jnp
    return [{k: jnp.asarray(v) for k, v in b.items()}
            for b in one_process[name]["batches"][:epochs]]


# ---------------------------------------------------------------------------
# The pipelined and async drivers at staleness 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("consensus", ["gossip", "q8"])
def test_async_staleness_one_is_pipelined_bit_for_bit_on_every_rank(
        ranks, consensus):
    for g in ranks:
        pipe, asyn = g[f"pipelined_{consensus}"], g[f"async1_{consensus}"]
        assert asyn["loss"] == pipe["loss"]
        assert asyn["sent"] == pipe["sent"]
        for k, v in pipe["tree"].items():
            assert torch.equal(asyn["tree"][k], v), (g["coord"], k)


@pytest.mark.parametrize("name", list(DRIVERS))
def test_drivers_match_jax(ranks, inputs, one_process, name):
    """JAX's driver over the same 4 workers (a stand-in mesh, the state
    built by hand), on the same parameters, batches, b(t) and draws: the
    losses within 1e-5 on every rank, the dual stack gathered from the
    blocks at the pipeline test's tolerance (q8: STACK_RTOL)."""
    import jax
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.dist import async_epochs as jasync
    from repro.dist import pipeline as jpipe
    jcfg, jparams, params, _ = inputs
    case = DRIVERS[name]
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    jamb_cfg = jamb.AMBConfig(consensus=case["consensus"],
                              gossip_rounds=ROUNDS, graph="ring",
                              beta=JBeta(*BETA), seed=SEED)
    width = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    zero = jnp.zeros((N, width + 1), jnp.float32)
    if case.get("pipeline"):
        _, step, flush = jpipe.make_pipelined_gossip_train_step(
            jcfg, standin, jamb_cfg)
        state["pending"] = zero
    else:
        _, step, flush = jasync.make_async_gossip_train_step(
            jcfg, standin, jamb_cfg, 1)
        state["queue"] = (zero,)
    step, flush = jax.jit(step), jax.jit(flush)
    want = one_process["pipelined_gossip"]
    losses = []
    for t, batch in enumerate(_jax_batches(one_process, "pipelined_gossip",
                                           EPOCHS)):
        state, m = step(state, batch, jnp.asarray(want["b"][t], jnp.int32))
        losses.append(float(m["loss"]))
    state = flush(state)
    got = _dual_stack(ranks, name, _shapes(params))
    for g in ranks:
        assert g[name]["b"] == want["b"]
        np.testing.assert_allclose(g[name]["loss"], losses, rtol=1e-5)
    _close(got, _stack(_flat(state["z"])), case["consensus"])


@pytest.mark.parametrize("name", list(DRIVERS))
def test_drivers_match_the_one_process_session(ranks, one_process, inputs,
                                               name):
    want = one_process[name]
    got = _dual_stack(ranks, name, _shapes(inputs[2]))
    for g in ranks:
        np.testing.assert_allclose(g[name]["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
    _close(got, _stack({k: v.numpy() for k, v in want["tree"].items()}),
           DRIVERS[name]["consensus"])


@pytest.mark.parametrize("name", ["pipelined_gossip", "pipelined_q8"])
def test_each_rank_sends_its_block_wire(ranks, inputs, name):
    """Three settles (two epochs and the flush) of ROUNDS fp32 rounds, or
    of 4 ROUNDS q8 rounds, each ``wire_bytes_per_round`` of the rank's
    block row (to the two neighbours of a ring of 4)."""
    from repro_torch.dist.amb import AMBConfig, strategy_from_config
    from repro_torch.dist.tp import row_block
    consensus = DRIVERS[name]["consensus"]
    strat = strategy_from_config(AMBConfig(consensus=consensus,
                                           gossip_rounds=ROUNDS), N)
    for g in ranks:
        width = row_block(_shapes(inputs[2]), _mesh(), g["coord"]
                          ).block_width
        assert g[name]["sent"] == (EPOCHS + 1) * strat.rounds \
            * strat.wire_bytes_per_round(width)


def test_pipelined_primal_takes_the_whole_leafs_trust_region(ranks,
                                                            one_process):
    """The pipelined protocol's primal prox over a model axis: projected
    by the whole leaf's norm, so equal to the one-process primal (a
    block clamped to its own ball would sit inside it)."""
    want = one_process["radius"]["whole"]
    for g in ranks:
        np.testing.assert_allclose(g["radius"]["loss"],
                                   one_process["radius"]["loss"],
                                   rtol=EXACT_RTOL)
        for k, w in want.items():
            scale = max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(
                g["radius"]["whole"][k].numpy(), w.numpy(), rtol=1e-3,
                atol=1e-5 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# The async driver at D = 2 and 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("staleness", [2, 3])
def test_async_staleness_mesh_behaviour(ranks, one_process, staleness):
    """The payload of epoch k settles at epoch k + D: the duals stay 0
    through step D - 1 and move at step D; a flush drains the queue and
    keeps ``t``; the losses are the one-process session's."""
    name = f"async{staleness}"
    mags = np.max([g[name]["z_mag"] for g in ranks], axis=0)
    assert (mags[:staleness] == 0.0).all(), mags
    assert (mags[staleness:] > 0.0).all(), mags
    for g in ranks:
        assert g[name]["queue_mag"] == 0.0
        assert g[name]["t"] == STALE_EPOCHS
        np.testing.assert_allclose(g[name]["loss"],
                                   one_process[name]["loss"],
                                   rtol=EXACT_RTOL)


def test_deeper_staleness_splits_at_step_three(ranks):
    """D = 2 and D = 3 see no settled payload through step 2 (equal
    losses) and split at step 3, where D = 2 sees epoch 0's."""
    for g in ranks:
        l2, l3 = g["async2"]["loss"], g["async3"]["loss"]
        assert l2[:3] == l3[:3]
        assert l2[3] != l3[3]


# ---------------------------------------------------------------------------
# Elastic membership and churn
# ---------------------------------------------------------------------------

def test_set_active_equals_b_zero_under_exact_consensus(ranks):
    for g in ranks:
        rec = g["exact_active"]
        assert rec["b"][2] == 0 and sum(rec["b"]) > 0
        assert rec["loss"][0] == rec["loss"][1]
        for k, v in rec["masked"].items():
            assert torch.equal(v, rec["forced"][k]), (g["coord"], k)


def test_an_out_workers_blocks_stay_bit_for_bit(ranks):
    for g in ranks:
        rec = g["active"]
        out = g["coord"][0] == 2
        assert rec["b"][1][2] == 0
        same = [torch.equal(rec["out_after"][k], v)
                for k, v in rec["out_before"].items()]
        assert all(same) if out else not all(same), g["coord"]


def test_survivors_match_the_one_process_session(ranks, one_process, inputs):
    """Three survivors on a fresh ring, then every worker back: the dual
    stack, the losses and the primal with worker 2 out (the active
    mean)."""
    want = one_process["active"]
    got = _dual_stack(ranks, "active", _shapes(inputs[2]))
    _close(got, _stack({k: v.numpy() for k, v in want["tree"].items()}),
           "gossip")
    for g in ranks:
        np.testing.assert_allclose(g["active"]["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
        assert g["active"]["b"] == want["b"]
        for k, w in want["primal_out"].items():
            scale = max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(
                g["active"]["primal_out"][k].numpy(), w.numpy(), rtol=1e-3,
                atol=1e-5 * scale, err_msg=k)


def test_fault_model_takes_the_same_trajectory_on_every_rank(ranks,
                                                             one_process,
                                                             inputs):
    want = one_process["faults"]
    assert any(0 in b for b in want["b"])      # someone left
    for g in ranks:
        assert g["faults"]["b"] == want["b"]
        np.testing.assert_allclose(g["faults"]["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
    _close(_dual_stack(ranks, "faults", _shapes(inputs[2])),
           _stack({k: v.numpy() for k, v in want["tree"].items()}), "gossip")


def _jax_gossip(inputs, one_process, name: str) -> tuple:
    """JAX's sequential gossip step over the same 4 workers (a stand-in
    mesh, the state built by hand) replaying the one-process session
    ``name``'s epochs: its batches, b(t) and each epoch's mask as
    ``AMBConfig.active`` (None with every worker in).  Returns the
    losses, the final state and, after each epoch, ``gossip_primal``
    under that epoch's mask."""
    import jax
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    jcfg, jparams, *_ = inputs
    want = one_process[name]
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    steps = {}
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    losses, primals = [], []
    batches = _jax_batches(one_process, "pipelined_gossip", len(want["b"]))
    for t, batch in enumerate(batches):
        mask = None if all(want["active"][t]) else tuple(want["active"][t])
        if mask not in steps:
            amb = jamb.AMBConfig(consensus="gossip", gossip_rounds=ROUNDS,
                                 graph="ring", beta=JBeta(*BETA), seed=SEED,
                                 active=mask)
            steps[mask] = (jax.jit(jamb.make_gossip_train_step(
                jcfg, standin, amb)[1]), amb)
        step, amb = steps[mask]
        state, m = step(state, batch, jnp.asarray(want["b"][t], jnp.int32))
        losses.append(float(m["loss"]))
        primals.append(jamb.gossip_primal(state, amb))
    return losses, state, primals


@pytest.mark.parametrize("name", ["active", "faults"])
def test_membership_matches_jax(ranks, inputs, one_process, name):
    """``set_active`` with worker 2 out (a ring of three survivors over
    blocks, then every worker back) and ``PoissonChurn``'s recorded b(t)
    and masks, replayed through JAX's gossip step with ``active``: the
    losses within 1e-5 on every rank, the dual stack gathered from the
    blocks at the pipeline test's fp32 tolerance, and (``set_active``)
    the primal with worker 2 out, JAX's active-worker mean."""
    import jax

    from repro_torch import models
    want = one_process[name]
    assert any(not all(a) for a in want["active"])
    losses, state, primals = _jax_gossip(inputs, one_process, name)
    for g in ranks:
        assert g[name]["active"] == want["active"]
        assert g[name]["b"] == want["b"]
        np.testing.assert_allclose(g[name]["loss"], losses, rtol=1e-5)
    _close(_dual_stack(ranks, name, _shapes(inputs[2])),
           _stack(_flat(state["z"])), "gossip")
    if name == "active":
        jprimal = models.from_jax_params(
            jax.tree.map(np.asarray, primals[1]), _cfg(),
            device="cpu").params()
        for g in ranks:
            for k, w in jprimal.items():
                w = w.detach()
                scale = max(1.0, float(w.abs().max()))
                np.testing.assert_allclose(
                    g["active"]["primal_out"][k].numpy(), w.numpy(),
                    rtol=1e-3, atol=1e-5 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# Coded redundancy
# ---------------------------------------------------------------------------

def test_coded_exact_matches_the_one_process_session_and_jax(
        ranks, one_process, inputs):
    import jax
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.optim import DualAveragingOpt as JDualAveraging
    from repro_torch import models
    jcfg, jparams, *_ = inputs
    want = one_process["coded"]
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    jopt = JDualAveraging(beta=JBeta(*BETA))
    step = jax.jit(jamb.make_train_step(
        jcfg, jopt, standin, jamb.AMBConfig(redundancy=CODED["redundancy"])))
    state, losses = (jparams, jopt.init(jparams)), []
    for t, batch in enumerate(_jax_batches(one_process, "coded", EPOCHS)):
        p, o, m = step(*state, batch, jnp.asarray(want["b"][t], jnp.int32))
        state = (p, o)
        losses.append(float(m["loss"]))
    jwhole = {k: v.detach() for k, v in models.from_jax_params(
        jax.tree.map(np.asarray, state[0]), _cfg(), device="cpu")
        .params().items()}
    for g in ranks:
        rec = g["coded"]
        assert rec["b"] == want["b"]
        np.testing.assert_allclose(rec["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
        np.testing.assert_allclose(rec["loss"], losses, rtol=1e-5)
        for k, w in want["whole"].items():
            err = float((rec["whole"][k] - w).abs().max())
            assert err <= EXACT_RTOL * max(1.0, float(w.abs().max())), k
            np.testing.assert_allclose(
                rec["whole"][k].numpy(), jwhole[k].numpy(), rtol=1e-5,
                atol=1e-6 * max(1.0, float(jwhole[k].abs().max())),
                err_msg=k)


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

def test_controller_raises_d_alike_on_every_rank(ranks, one_process):
    want = one_process["controller"]
    assert want["final_staleness"] > 1
    assert any(a is not None for a in want["action"])
    for g in ranks:
        rec = g["controller"]
        assert rec["action"] == want["action"]
        assert rec["staleness"] == want["staleness"]
        assert rec["final_staleness"] == want["final_staleness"]
        np.testing.assert_allclose(rec["noise"], want["noise"],
                                   rtol=NOISE_RTOL)


def test_noise_statistics_are_jaxs_whole_leaf_numbers(ranks, inputs,
                                                      one_process):
    """JAX's async driver with ``noise_stats`` on, over the epochs the
    controlled session ran at its first D: ``grad_noise_stats`` of the
    whole leaves within NOISE_RTOL on every rank."""
    import jax
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.dist import async_epochs as jasync
    jcfg, jparams, *_ = inputs
    want = one_process["controller"]
    d = want["staleness"]
    first = next((i for i, x in enumerate(d) if x != d[0]), len(d))
    assert first >= 2
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    _, step, _ = jasync.make_async_gossip_train_step(
        jcfg, standin, jamb.AMBConfig(consensus="gossip",
                                      gossip_rounds=ROUNDS, graph="ring",
                                      beta=JBeta(*BETA), seed=SEED,
                                      noise_stats=True), 1)
    step = jax.jit(step)
    width = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32),
        "queue": (jnp.zeros((N, width + 1), jnp.float32),)}
    noise = []
    for t, batch in enumerate(_jax_batches(one_process, "pipelined_gossip",
                                           first)):
        state, m = step(state, batch, jnp.asarray(want["b"][t], jnp.int32))
        noise.append([float(m["grad_sq_norm"]), float(m["grad_var"])])
    for g in ranks:
        np.testing.assert_allclose(g["controller"]["noise"][:first], noise,
                                   rtol=NOISE_RTOL)


# ---------------------------------------------------------------------------
# The wire lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", LANE_SIZES)
def test_wire_lanes_carry_each_chunk_whole(ranks, n):
    """A chunk split across the wire lanes arrives whole and in order at
    the next rank of the ring, also with fewer elements than lanes."""
    for r, g in enumerate(ranks):
        torch.testing.assert_close(g["lanes"][n],
                                   _lane_row((r - 1) % len(ranks), n),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

def _losses(path: Path) -> list:
    return [json.loads(x)["loss"] for x in path.read_text().splitlines()]


@pytest.mark.parametrize("name", list(CLIS))
def test_train_cli_with_a_model_axis_matches_the_one_process_cli(
        spawned, tmp_path, name):
    """``--data 4 --model 2`` over eight ranks against ``--data 4`` in one
    process (the smoke config's bf16: within CLI_RTOL); rank 0 alone
    wrote the metrics."""
    from repro_torch.launch.train import main
    ranks, outdir = spawned
    want = main(CLI_ARGV + CLIS[name] + [
        "--metrics", str(tmp_path / "one.jsonl")], device="cpu")
    for got in ranks:
        assert got["cli"][name] == pytest.approx(want, rel=CLI_RTOL)
    one = _losses(tmp_path / "one.jsonl")
    assert len(one) == 3
    np.testing.assert_allclose(_losses(outdir / f"cli_{name}.jsonl"), one,
                               rtol=CLI_RTOL)


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
