"""One process per worker, every driver and option: four gloo ranks on the
CPU against the one-process port session (and JAX where stated).

Four ranks start as subprocesses of this file (``python
tests/test_torch_ranks_drivers.py STORE RANK WORLD OUTDIR``), meet through
a ``file://`` store in the test's temporary directory, each on one
intra-op thread, and run every case at smoke size on the simulated clock;
each saves what it read.  The tests hold them against the same sessions
run in one process (the workers a loop on one device), also on one
thread:

  * quantized gossip (q8 and q4, a ring and a (2, 2) torus), the
    pipelined driver, the async driver (D = 1 and D = 2), churn (3 and 2
    survivors, by ``set_active`` and by a fault model) and coded gossip:
    each rank's dual row bit for bit the one-process row, and q8 / q4
    ``sent_bytes`` exactly ``wire_bytes_per_round`` a round;
  * the node-averaged primal with a worker out (``gossip_primal``'s
    active mask over the ranks) within ``PRIMAL_TOL``;
  * coded exact within ``EXACT_RTOL``, and ``global_batch`` equal;
  * the controller's noise statistics within ``NOISE_RTOL`` and its
    actions equal on every rank and to the one-process session's;
  * checkpoints across ranks and one process in both directions, the
    next epoch bit for bit, and JAX's ``load_checkpoint`` reading the
    ranks' archive;
  * the MoE exact step's aux and gradient against JAX's global-batch step
    and the one-process port step;
  * the train CLI with the quantized async driver, coded placement, the
    controller, ``--ckpt-dir`` and ``--restore``: the losses.

The per-rank ``quantized_combine`` (a (K, 1) table over the K level rows
a rank holds) is held against JAX's stacked kernel in interpret mode, and
the q4 wire's pack against its unpack on odd and even widths.  The spawn
has a join deadline (``JOIN_S``) and the process group a timeout
(``PG_TIMEOUT_S``).
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N, PER, SEQ, EPOCHS = 4, 2, 16, 2
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: four summed backwards vs one, then the prox
PRIMAL_TOL = 1e-6       # an all-reduce's sum order against a tensordot
NOISE_RTOL = 1e-5       # JAX's per-leaf form against a one-pass fp64 M2
QTOL = dict(rtol=1e-6, atol=1e-6)   # the Pallas kernel's fused rounding
MOE_SEQ = 64            # the MoE dispatch groups are sequences from 64 on
MOE_BS = (2, 1, 2, 0)
MASK3 = (True, False, True, True)
MASK2 = (True, False, True, False)
CASES = {
    "q8_ring": dict(consensus="gossip_q8", graph="ring", pod=1, data=4),
    "q4_ring": dict(consensus="gossip_q4", graph="ring", pod=1, data=4),
    "q8_torus": dict(consensus="gossip_q8", graph="torus", pod=2, data=2),
    "q4_torus": dict(consensus="gossip_q4", graph="torus", pod=2, data=2),
    "pipelined": dict(consensus="gossip", pipeline=True),
    "async1": dict(consensus="gossip", async_epochs=True, staleness=1),
    "async2": dict(consensus="gossip_q8", async_epochs=True, staleness=2),
    "coded_exact": dict(consensus="exact", redundancy=2),
    "coded_gossip": dict(consensus="gossip", redundancy=2),
}
CHURN = {"churn3": dict(consensus="gossip", mask=MASK3),
         "churn2": dict(consensus="gossip_q8", pipeline=True, mask=MASK2)}
FAULTS = dict(consensus="gossip", leave_rate=0.5, rejoin_rate=0.5, seed=3,
              epochs=4)
CONTROLLER = dict(consensus="gossip", epochs=4)
CKPT = dict(consensus="gossip", pipeline=True)
CLI_ARGV = ["--smoke", "--data", str(N), "--batch-per-worker", str(PER),
            "--seq-len", str(SEQ), "--sim-clock", "--consensus", "gossip_q4",
            "--gossip-rounds", "1", "--async", "--staleness", "2",
            "--redundancy", "2", "--controller", "--controller-warmup", "1",
            "--controller-interval", "1", "--steps", str(EPOCHS),
            "--prefetch", "0"]


def _cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                               dtype="float32")


def _session(case: dict, mesh=None, controller=None):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    pod, data = case.get("pod", 1), case.get("data", N)
    train = TrainSpec(smoke=True, pod=pod, data=data, batch_per_worker=PER,
                      seq_len=SEQ, redundancy=case.get("redundancy", 1))
    spec = ConsensusSpec(consensus=case["consensus"],
                         graph=case.get("graph", "ring"), gossip_rounds=1,
                         pipeline=case.get("pipeline", False),
                         async_epochs=case.get("async_epochs", False),
                         staleness=case.get("staleness", 1))
    return AMBSession(train, ClockSpec(kind="simulated"), spec, controller,
                      cfg=_cfg(), device="cpu", mesh=mesh)


def _tree(session) -> dict:
    state = session.state
    tree = state["z"] if "z" in state else state["params"]
    return {k: v.detach().clone() for k, v in tree.items()}


def _epochs(session, epochs: int = EPOCHS, faults=None) -> list:
    out = [session.run(1, prefetch=0, faults=faults) for _ in range(epochs)]
    session.flush()
    return out


def _controller_spec():
    from repro_torch.api import ControllerSpec
    return ControllerSpec(enabled=True, warmup=1, interval=1)


def _spy(session) -> list:
    """The protocol step's noise statistics, epoch by epoch."""
    got, step = [], session.protocol.step

    def spy(state, batch, b):
        state, m = step(state, batch, b)
        got.append([float(m["grad_sq_norm"]), float(m["grad_var"])])
        return state, m
    session.protocol.step = spy
    return got


def run_case(name: str, mesh_for) -> dict:
    """One case, in one process (``mesh_for`` None) or on a rank."""
    if name in CASES:
        case = CASES[name]
        session = _session(case, mesh_for(case))
        ms = _epochs(session)
        rec = {"losses": [m["loss"] for m in ms],
               "batch": [m["global_batch"] for m in ms]}
    elif name in CHURN:
        case = CHURN[name]
        session = _session(case, mesh_for(case))
        rec = {"losses": [session.run(1, prefetch=0)["loss"]]}
        session.set_active(case["mask"])
        rec["losses"].append(session.run(1, prefetch=0)["loss"])
        session.flush()
        rec["primal_out"] = {k: v.clone() for k, v in session.params.items()}
        session.set_active([True] * N)
        rec["losses"].append(session.run(1, prefetch=0)["loss"])
        session.flush()
    elif name == "faults":
        from repro_torch.faults import PoissonChurn
        session = _session(FAULTS, mesh_for(FAULTS))
        model = PoissonChurn(leave_rate=FAULTS["leave_rate"],
                             rejoin_rate=FAULTS["rejoin_rate"],
                             seed=FAULTS["seed"])
        ms = _epochs(session, FAULTS["epochs"], model)
        rec = {"losses": [m["loss"] for m in ms],
               "masks": [int(m["b"].astype(bool).sum()) for m in ms]}
    elif name == "controller":
        session = _session(CONTROLLER, mesh_for(CONTROLLER),
                           _controller_spec())
        noise = _spy(session)
        ms = _epochs(session, CONTROLLER["epochs"])
        rec = {"losses": [m["loss"] for m in ms], "noise": noise,
               "actions": [m.get("action") for m in ms],
               "budget": session.clock.budget_t
               if hasattr(session.clock, "budget_t") else None}
    else:
        raise KeyError(name)
    rec["tree"] = _tree(session)
    if session.group is not None:
        rec.update(sent=session.group.sent_bytes,
                   staged=session.group.staged_bytes,
                   worker=session.group.worker)
    return rec


def ckpt_one(outdir: Path) -> None:
    """The one-process side written before the ranks start: one epoch,
    then a save the ranks restore."""
    session = _session(CKPT)
    session.run(1, prefetch=0)
    session.save(outdir / "ckpt_one")


def rank_ckpt(outdir: Path, mesh) -> dict:
    """The ranks save after one epoch and run one more; then they restore
    the one-process save and run one epoch from it."""
    from repro_torch.api import AMBSession
    session = _session(CKPT, mesh)
    session.run(1, prefetch=0)
    session.save(outdir / "ckpt_ranks")
    saved = _tree(session)
    session.run(1, prefetch=0)
    session.flush()
    out = {"saved": saved, "next": _tree(session)}
    back = AMBSession.restore(outdir / "ckpt_one", device="cpu", cfg=_cfg())
    assert back.group is not None and back.steps_done == 1
    back.run(1, prefetch=0)
    back.flush()
    out["restored_next"] = _tree(back)
    return out


def run_cli(workdir: Path) -> list:
    """The train CLI (bf16 smoke config) with the quantized async driver,
    coded placement and the controller, saved; then resumed from the save
    for one more step.  Returns the two runs' last losses."""
    from repro_torch.launch import train
    first = train.main(CLI_ARGV + ["--ckpt-dir", str(workdir / "cli_ckpt"),
                                   "--metrics", str(workdir / "cli.jsonl")],
                       device="cpu")
    again = train.main(["--restore", str(workdir / "cli_ckpt"), "--steps",
                        "1", "--prefetch", "0", "--metrics",
                        str(workdir / "cli_restored.jsonl")], device="cpu")
    return [first, again]


def moe_inputs():
    """The MoE case's fp32 smoke config, its global batch of N * PER
    sequences of MOE_SEQ tokens (numpy, seed 11) and b."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (N * PER, MOE_SEQ))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return cfg, {"tokens": tokens.astype(np.int32),
                 "labels": labels.astype(np.int32)}


def moe_step(params: dict, group=None) -> dict:
    """One exact dual-averaging step of the MoE model on MOE_BS: with
    ``group`` this rank's rows only."""
    from repro_torch.core import BetaSchedule
    from repro_torch.dist import amb
    from repro_torch.optim import DualAveragingOpt
    cfg, batch = moe_inputs()
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if group is not None:
        r = group.worker
        batch = {k: v[r * PER:(r + 1) * PER] for k, v in batch.items()}
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    opt = DualAveragingOpt(beta=BetaSchedule(50.0, float(N * PER), 200.0))
    state = opt.init(params)
    step = amb.make_train_step(cfg, opt, N, group=group)
    _, state, m = step(params, state, batch, list(MOE_BS))
    return {"z": {k: v.detach().clone() for k, v in state["z"].items()},
            "aux": float(m["aux"]), "loss": float(m["loss"]),
            "global_batch": float(m["global_batch"])}


def dense_q8(group=None) -> torch.Tensor:
    """gossip_q8 on a star (no taps: the dense fallback) over rows drawn
    from a seed, under ``epoch_draws(0, 0)``: with ``group`` this rank's
    row, else the stack."""
    from repro_torch.dist import consensus
    rows = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (N, 33)).astype(np.float32))
    strat = consensus.QuantizedGossipConsensus(N, 3, 8, "star")
    assert strat.taps is None
    draws = consensus.epoch_draws(0, 0)
    if group is None:
        return strat.combine(rows.clone(), draws)
    buf = strat.rank_buffer(rows.shape[1], "cpu", group.worker)
    buf[0] = rows[group.worker]
    return strat.combine_rank(buf, group, draws)[0].clone()


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: every case, the checkpoints and the MoE step; results to
    ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist.group import WorkerGroup
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)
    try:
        def mesh_for(case):
            return make_host_mesh(case.get("data", N), 1,
                                  pod=case.get("pod", 1), device="cpu")
        out = {name: run_case(name, mesh_for) for name in
               [*CASES, *CHURN, "faults", "controller"]}
        world_mesh = make_host_mesh(N, 1, device="cpu")
        out["ckpt"] = rank_ckpt(outdir, world_mesh)
        out["cli"] = run_cli(outdir)
        group = WorkerGroup(world_mesh, "cpu")
        params = torch.load(outdir / "moe_params.pt")
        out["moe"] = moe_step(params, group)
        out["dense_q8"] = dense_q8(group)
        torch.save(out, outdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(tmp_path: Path, world: int = N) -> list:
    """Start ``world`` ranks of this file, wait at most JOIN_S for all of
    them (then kill every one and fail), and return their results."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(store), str(r), str(world),
         str(tmp_path)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
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
    """The ranks run one intra-op thread each: so does the reference (a
    CPU product's rounding may depend on the thread count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_moe():
    """JAX's initial MoE parameters and its global-batch exact step."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.optim import DualAveragingOpt as JDualAveraging
    import types
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen3-moe-30b-a3b"),
                               dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(4), jcfg)
    _, batch = moe_inputs()
    jopt = JDualAveraging(beta=JBeta(50.0, float(N * PER), 200.0))
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    step = jax.jit(jamb.make_train_step(jcfg, jopt, standin))
    _, jstate, jm = step(jparams, jopt.init(jparams),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(MOE_BS, jnp.int32))
    return jparams, jstate, jm


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_moe):
    from repro_torch import models
    import jax
    outdir = tmp_path_factory.mktemp("ranks_drivers")
    cfg, _ = moe_inputs()
    params = models.from_jax_params(jax.tree.map(np.asarray, jax_moe[0]),
                                    cfg, device="cpu").params()
    torch.save({k: v.detach() for k, v in params.items()},
               outdir / "moe_params.pt")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ckpt_one(outdir)
    finally:
        torch.set_num_threads(before)
    return spawn(outdir), outdir


@pytest.fixture(scope="module")
def one_process(spawned):
    """Every case in one process, once for the module (one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: run_case(name, lambda case: None) for name in
                [*CASES, *CHURN, "faults", "controller"]}
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def ranks(spawned):
    return spawned[0]


def _rows_equal(ranks, want: dict, name: str) -> None:
    for r, got in enumerate(ranks):
        assert got[name]["worker"] == r
        for k, zl in want.items():
            row = got[name]["tree"][k]
            assert row.shape == (1,) + zl.shape[1:], (name, k)
            assert torch.equal(row[0], zl[r]), (name, r, k)


@pytest.mark.parametrize("name", [n for n in CASES if n != "coded_exact"]
                         + [*CHURN, "faults", "controller"])
def test_rank_duals_equal_the_one_process_rows_bit_for_bit(ranks,
                                                           one_process,
                                                           name):
    want = one_process[name]
    _rows_equal(ranks, want["tree"], name)
    for got in ranks:
        assert got[name]["losses"] == want["losses"], name


@pytest.mark.parametrize("name", ["q8_ring", "q4_ring", "q8_torus",
                                  "q4_torus"])
def test_quantized_ranks_send_the_packed_wire(ranks, name):
    """A q8 rank sends (D + 8) (K - 1) bytes a round and a q4 rank
    (ceil(D/2) + 8) (K - 1): the level plane and the fp32 grid, never the
    fp32 row; nothing is staged on the CPU."""
    from repro_torch.dist.amb import strategy_from_config
    session = _session(CASES[name])
    d = sum(v.numel() for v in session.params.values()) + 1
    strat = strategy_from_config(session.protocol.amb, N)
    bits = int(name[1])
    per_round = ((-(-d // 2) if bits == 4 else d) + 8) * (strat.taps.k - 1)
    assert strat.wire_bytes_per_round(d) == per_round
    for got in ranks:
        assert got[name]["sent"] == EPOCHS * strat.rounds * per_round
        assert got[name]["staged"] == 0


@pytest.mark.parametrize("name", list(CHURN))
def test_primal_with_a_worker_out_is_the_active_mean(ranks, one_process,
                                                     name):
    """``gossip_primal`` over the ranks weighs an inactive rank's dual by
    0 and divides by the active count: the one-process primal, which
    averages only the active workers (within the all-reduce's sum order),
    and not the all-worker mean."""
    want = one_process[name]["primal_out"]
    for got in ranks:
        for k, w in want.items():
            torch.testing.assert_close(got[name]["primal_out"][k], w,
                                       rtol=PRIMAL_TOL, atol=PRIMAL_TOL)
    # the departed worker's dual row differs, so an unweighted mean would
    # have moved the primal
    z1 = ranks[1][name]["tree"]
    assert any(not torch.equal(z1[k][0], ranks[0][name]["tree"][k][0])
               for k in z1)


def test_fault_model_runs_the_same_trajectory_on_every_rank(ranks,
                                                            one_process):
    masks = one_process["faults"]["masks"]
    assert min(masks) < N                 # someone left in these epochs
    for got in ranks:
        assert got["faults"]["masks"] == masks


def test_coded_exact_ranks_agree_with_one_process(ranks, one_process):
    want = one_process["coded_exact"]
    first = ranks[0]["coded_exact"]["tree"]
    for got in ranks:
        assert got["coded_exact"]["batch"] == want["batch"]
        for k, p in got["coded_exact"]["tree"].items():
            assert torch.equal(p, first[k]), k      # the ranks stay equal
        np.testing.assert_allclose(got["coded_exact"]["losses"],
                                   want["losses"], rtol=EXACT_RTOL)
    for k, p in want["tree"].items():
        err = float((first[k] - p).abs().max())
        assert err <= EXACT_RTOL * float(p.abs().max()), (k, err)
    assert want["batch"] == ranks[0]["coded_gossip"]["batch"]


def test_controller_sees_the_same_noise_and_acts_alike(ranks, one_process):
    want = one_process["controller"]
    assert any(a is not None for a in want["actions"])
    for got in ranks:
        rec = got["controller"]
        np.testing.assert_allclose(rec["noise"], want["noise"],
                                   rtol=NOISE_RTOL)
        assert rec["actions"] == ranks[0]["controller"]["actions"]
        assert rec["actions"] == want["actions"]
        assert rec["budget"] == want["budget"]


def test_checkpoints_cross_between_ranks_and_one_process(ranks, spawned):
    """Ranks save and one process restores; one process saves and the
    ranks restore: the saved state and the next epoch bit for bit both
    ways (the pipelined driver: the in-flight payload rides along)."""
    from repro_torch.api import AMBSession
    outdir = spawned[1]
    back = AMBSession.restore(outdir / "ckpt_ranks", device="cpu",
                              cfg=_cfg())
    assert back.group is None and back.steps_done == 1
    pending = back.state["pending"]
    assert pending.shape[0] == N and float(pending[:, -1].abs().sum()) > 0
    _rows_equal([{"x": {"tree": g["ckpt"]["saved"], "worker": r}}
                 for r, g in enumerate(ranks)], back.state["z"], "x")
    back.run(1, prefetch=0)
    back.flush()
    _rows_equal([{"x": {"tree": g["ckpt"]["next"], "worker": r}}
                 for r, g in enumerate(ranks)], back.state["z"], "x")
    one = _session(CKPT)
    one.run(2, prefetch=0)
    one.flush()
    _rows_equal([{"x": {"tree": g["ckpt"]["restored_next"], "worker": r}}
                 for r, g in enumerate(ranks)], one.state["z"], "x")


def test_train_cli_runs_every_option_over_ranks(ranks, tmp_path):
    """``--consensus gossip_q4 --async --staleness 2 --redundancy 2
    --controller --ckpt-dir``, then ``--restore``, over four ranks: the
    last losses equal the one-process CLI's, on every rank."""
    want = run_cli(tmp_path)
    assert all(np.isfinite(want))
    for got in ranks:
        assert got["cli"] == want


def _nested(flat: dict, leaf) -> dict:
    """A dotted flat dict as JAX's nested tree, each value ``leaf(v)``."""
    out: dict = {}
    for key, v in flat.items():
        *path, last = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf(v)
    return out


def test_jax_reads_the_ranks_checkpoint(ranks, spawned):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.ckpt import checkpoint as jckpt
    from repro_torch.api import AMBSession
    outdir = spawned[1]
    back = AMBSession.restore(outdir / "ckpt_ranks", device="cpu",
                              cfg=_cfg())
    def zeros(v):
        return jnp.zeros(tuple(v.shape), jnp.float32)
    state = back.state
    got = jckpt.load_checkpoint(
        outdir / "ckpt_ranks" / "session_state", 1,
        {"z": _nested(state["z"], zeros), "pending": zeros(state["pending"]),
         "t": jnp.int32(0)})
    assert int(got["t"]) == 1
    np.testing.assert_array_equal(np.asarray(got["pending"]),
                                  state["pending"].numpy())
    for k, zl in state["z"].items():
        node = got["z"]
        for part in k.split("."):
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), zl.numpy())
    params = back.params
    primal = jckpt.load_checkpoint(outdir / "ckpt_ranks", 1,
                                   _nested(params, zeros))
    for k, w in params.items():
        node = primal
        for part in k.split("."):
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), w.numpy())
    del jax


def test_moe_exact_step_over_ranks_matches_jax_and_one_process(ranks,
                                                              spawned,
                                                              jax_moe):
    """aux is the sum of the ranks' shares of JAX's global-batch aux, and
    the summed gradient (dual averaging's z after one step) is JAX's."""
    _, jstate, jm = jax_moe
    params = torch.load(spawned[1] / "moe_params.pt")
    one = moe_step(params)
    for got in ranks:
        moe = got["moe"]
        assert moe["global_batch"] == float(jm["global_batch"])
        np.testing.assert_allclose(moe["aux"], float(jm["aux"]), rtol=1e-5)
        np.testing.assert_allclose(moe["aux"], one["aux"], rtol=1e-5)
        np.testing.assert_allclose(moe["loss"], float(jm["loss"]),
                                   rtol=1e-5)
        for k, z in one["z"].items():
            scale = float(z.abs().max())
            err = float((moe["z"][k] - z).abs().max())
            assert err <= EXACT_RTOL * max(scale, 1e-30), (k, err, scale)
    from repro_torch import models
    import jax
    jz = models.from_jax_params(jax.tree.map(np.asarray, jstate["z"]),
                                moe_inputs()[0], device="cpu").params()
    for k, z in ranks[0]["moe"]["z"].items():
        want = jz[k].detach().float()
        scale = float(want.abs().max())
        err = float((z - want).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (k, err, scale)


def test_dense_quantized_fallback_over_ranks(ranks):
    """A graph without taps (a star): each rank quantizes its own delta
    and all-gathers the quantized deltas; its row of ``diag(P) m +
    offdiag(P) h`` against the stacked one's (one row of a product
    against the product: fp32 rounding)."""
    want = dense_q8()
    for r, got in enumerate(ranks):
        torch.testing.assert_close(got["dense_q8"], want[r], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("graph,d", [("ring", 1001), ("torus", 129)])
def test_per_rank_quantized_combine_is_jax_stacked_row(bits, graph, d):
    """The plain per-rank ``quantized_combine``: a row, its K level rows
    (its own, then the neighbours' in tap order) and a (K, 1) table, bit
    for bit each row of JAX's stacked plain version, and within
    ``QTOL`` of its stacked Pallas kernel (interpret mode), as
    ``tests/test_torch_kernels.py`` holds the stacked call."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.dist import consensus as jcons
    from repro.kernels import ref as jref
    from repro.kernels.gossip_combine import quantized_combine_pallas
    from repro_torch.dist.consensus import GossipConsensus
    from repro_torch.kernels import ops
    from repro_torch.kernels.gossip_combine import own_row_table
    n = 4
    levels = 2 ** bits - 1
    jtaps = jcons.GossipConsensus(n, 1, graph).taps
    strat = GossipConsensus(n, 1, graph)
    rng = np.random.default_rng(bits * 7 + d)
    k = jtaps.k
    m = rng.standard_normal((n, d)).astype(np.float32)
    hnbr = rng.standard_normal((k - 1, n, d)).astype(np.float32)
    lvl = rng.integers(0, levels + 1, (n, d)).astype(np.uint8)
    lo = rng.standard_normal((n, 1)).astype(np.float32)
    scale = (rng.random((n, 1)) * 0.01).astype(np.float32)
    roll = lambda x: jnp.stack([jtaps.take(jnp.asarray(x), j)   # noqa
                                for j in range(1, k)])
    jargs = (jnp.asarray(m), jnp.asarray(hnbr), roll(lvl), roll(lo),
             roll(scale), jnp.asarray(jtaps.weights))
    want_o, want_h = jref.quantized_combine_ref(*jargs)
    pal_o, pal_h = quantized_combine_pallas(*jargs, interpret=True,
                                            block_rows=8)
    table = own_row_table(k, "cpu")
    for r in range(n):
        rows = [r] + [s for _, s, _ in strat.rank_plan(r)]
        got_o, got_h = ops.quantized_combine(
            torch.from_numpy(m[r:r + 1]),
            torch.from_numpy(hnbr[:, r:r + 1].copy()),
            torch.from_numpy(lvl[rows]), torch.from_numpy(lo[rows, 0]),
            torch.from_numpy(scale[rows, 0]), table, strat.taps.weights)
        np.testing.assert_array_equal(got_o.numpy()[0],
                                      np.asarray(want_o)[r])
        np.testing.assert_array_equal(got_h.numpy()[:, 0],
                                      np.asarray(want_h)[:, r])
        np.testing.assert_allclose(got_o.numpy()[0], np.asarray(pal_o)[r],
                                   **QTOL)
        np.testing.assert_allclose(got_h.numpy()[:, 0],
                                   np.asarray(pal_h)[:, r], **QTOL)
    del jax


@pytest.mark.parametrize("d", [1, 2, 7, 8, 33, 1000, 1001])
def test_q4_wire_packs_and_unpacks_one_row(d):
    """The per-rank pack of one level row is :meth:`_pack`'s row (one
    pad nibble when D is odd) and unpacks to the row, on odd and even
    D."""
    from repro_torch.dist.consensus import QuantizedGossipConsensus
    q = QuantizedGossipConsensus(N, 1, 4)
    lvl = torch.from_numpy(np.random.default_rng(d).integers(
        0, 16, (1, d)).astype(np.uint8))
    packed = torch.empty((q.wire_width(d),), dtype=torch.uint8)
    q._pack_row(lvl[0], packed)
    assert torch.equal(packed, q._pack(lvl)[0])
    assert torch.equal(q._unpack(packed[None], d)[:, :d], lvl)
    out = torch.empty((d,), dtype=torch.uint8)
    q._unpack_row(packed, out)
    assert torch.equal(out, lvl[0])


def test_rank_draws_are_the_stacked_rows():
    """``epoch_draws`` fills a stack row by row from per-worker generators:
    a rank's (1, D) draws are its row of the stack, and a two-argument
    call fills every row."""
    from repro_torch.dist.consensus import epoch_draws
    draws = epoch_draws(5, -1)
    stack = draws(3, torch.empty((N, 17)))
    for r in range(N):
        row = draws(3, torch.empty((1, 17)), rows=(r,))
        assert torch.equal(row[0], stack[r])
    assert not torch.equal(stack[0], stack[1])


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
