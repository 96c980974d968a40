"""One process per worker: four gloo ranks on the CPU against the
one-process port session.

Four ranks start as subprocesses of this file (``python
tests/test_torch_ranks.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory (never a TCP port, so
concurrent test workers cannot collide), each pinned to one intra-op
thread, and run every case of ``CASES`` at smoke size for ``EPOCHS``
epochs on the simulated clock; each saves its state and metrics.  The
tests hold them against the same sessions run in one process (the workers
a loop on one device), also on one thread:

  * gossip (ring, and a (pod 2 x data 2) torus): each rank's dual row
    equal bit for bit to the one-process session's row, and the losses;
  * exact: every rank's parameters equal to each other, and within
    ``EXACT_RTOL`` of the one-process session's (the gradient is a sum of
    four backward passes there, one backward over the batch here);
  * the train CLI (``main``) on the torus, its losses equal;
  * what a group does not run yet (the MoE family at a model axis > 1)
    raises, naming its ROADMAP item.

Every spawn has a join deadline (``JOIN_S``), past which the ranks are
killed and the test fails, and the process group a timeout
(``PG_TIMEOUT_S``), so a hung rank cannot hold the suite.
"""
import dataclasses
import datetime
import json
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
CASES = {
    "gossip_ring": dict(consensus="gossip", graph="ring", pod=1, data=4),
    "gossip_torus": dict(consensus="gossip", graph="torus", pod=2, data=2),
    "exact_ring": dict(consensus="exact", graph="ring", pod=1, data=4),
    "exact_torus": dict(consensus="exact", graph="torus", pod=2, data=2),
}
CLI_ARGV = ["--smoke", "--pod", "2", "--data", "2", "--batch-per-worker",
            str(PER), "--seq-len", str(SEQ), "--sim-clock", "--consensus",
            "gossip", "--graph", "torus", "--steps", str(EPOCHS),
            "--prefetch", "0"]
CLI_ONE = ["--smoke", "--data", "4", "--batch-per-worker", str(PER),
           "--seq-len", str(SEQ), "--sim-clock", "--consensus", "gossip",
           "--graph", "torus", "--steps", str(EPOCHS), "--prefetch", "0"]


def _session(case: dict, mesh=None, cfg=None, **consensus):
    from repro_torch import configs
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    cfg = cfg or dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                                     dtype="float32")
    train = TrainSpec(smoke=True, pod=case["pod"], data=case["data"],
                      model=case.get("model", 1), batch_per_worker=PER,
                      seq_len=SEQ)
    spec = ConsensusSpec(consensus=case["consensus"], graph=case["graph"],
                         **consensus)
    return AMBSession(train, ClockSpec(kind="simulated"), spec, cfg=cfg,
                      device="cpu", mesh=mesh)


def _record(session, losses: list) -> dict:
    state = session.state
    tree = state["z"] if "z" in state else state["params"]
    return {"losses": losses, "tree": {k: v.detach().clone()
                                       for k, v in tree.items()}}


def _run(session) -> dict:
    losses = [session.run(1, prefetch=0)["loss"] for _ in range(EPOCHS)]
    return _record(session, losses)


def _refusals() -> dict:
    """The message of each combination a group still refuses: what a
    model axis > 1 does not run yet (module item 4a.5.3 on a (2, 2) mesh:
    a hybrid with 3 Mamba2 heads and whisper with 3 heads, which model 2
    does not divide; both families run where it divides them)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch import configs

    def refused(arch, **kw):
        cfg = dataclasses.replace(configs.smoke_config(arch),
                                  dtype="float32", **kw)
        return lambda: _session(dict(CASES["exact_ring"], data=2, model=2),
                                make_host_mesh(2, 2, device="cpu"), cfg=cfg)
    tries = {"model_audio": refused("whisper-base", num_heads=3,
                                    num_kv_heads=3),
             "model_hybrid": refused("zamba2-1.2b", d_model=96)}
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError, SystemExit) as e:
            out[name] = str(e)
    return out


def _strategies(group) -> dict:
    """Each rank's row of a strategy's rounds over the group, on rows
    drawn from a seed: ring gossip (taps), a star (no taps: the dense
    fallback all-gathers) and exact consensus (an all-reduce mean)."""
    from repro_torch.dist import consensus
    rows = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (N, 33)).astype(np.float32))
    out = {}
    for name, strat in (("ring", consensus.GossipConsensus(N, 3, "ring")),
                        ("star", consensus.GossipConsensus(N, 3, "star")),
                        ("exact", consensus.ExactConsensus(N))):
        buf = strat.rank_buffer(rows.shape[1], "cpu")
        buf[0] = rows[group.worker]
        out[name] = strat.combine_rank(buf, group)[0].clone()
    out["rows"] = rows
    return out


def _constrain(mesh) -> dict:
    """``constrain`` on a replicated DTensor under the mesh: the batch
    axis goes onto "data", an axis "data" does not divide stays whole,
    and off the mesh the DTensor is returned as it is."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import sharding
    x = distribute_tensor(torch.arange(24.0).reshape(8, 3), mesh,
                          [Replicate(), Replicate()])
    with sharding.use_sharding(mesh):
        y = sharding.constrain(x, "batch", None)
        odd = sharding.constrain(x[:6].redistribute(
            mesh, [Replicate(), Replicate()]), None, "batch")
    return {"batch": tuple(y.placements) == (Shard(0), Replicate()),
            "local": tuple(y.to_local().shape),
            "full": torch.equal(y.full_tensor(), x.full_tensor()),
            "odd": tuple(odd.placements) == (Replicate(), Replicate()),
            "off": sharding.constrain(x, "batch", None) is x}


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: every case, the CLI and the refusals; results to
    ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = {}
        for name, case in CASES.items():
            # the torus cases build their mesh inside the session
            mesh = None if case["pod"] > 1 else make_host_mesh(
                case["data"], 1, pod=case["pod"], device="cpu")
            session = _session(case, mesh)
            out[name] = _run(session)
            out[name]["sent"] = session.group.sent_bytes
            out[name]["staged"] = session.group.staged_bytes
            out[name]["worker"] = session.group.worker
            if case["consensus"] == "gossip":
                out[name]["primal"] = {k: v.clone() for k, v in
                                       session.params.items()}
        metrics = Path(outdir) / "cli.jsonl"
        out["cli"] = train.main(CLI_ARGV + ["--metrics", str(metrics)],
                                device="cpu")
        world_mesh = make_host_mesh(N, 1, device="cpu")
        out["refusals"] = _refusals()
        out["constrain"] = _constrain(world_mesh)
        from repro_torch.dist.group import WorkerGroup
        out["strategies"] = _strategies(WorkerGroup(world_mesh, "cpu"))
        torch.save(out, Path(outdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(tmp_path: Path, world: int = N, deadline_s: float = JOIN_S,
          argv_extra=()) -> list:
    """Start ``world`` ranks of this file, wait at most ``deadline_s`` for
    all of them (then kill every one and fail), and return their
    results."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(store), str(r), str(world),
         str(tmp_path), *argv_extra], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    end = time.monotonic() + deadline_s
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
        pytest.fail(f"ranks {hung} still running after {deadline_s} s; "
                    f"killed\n{text}")
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        pytest.fail(f"ranks {bad} failed\n{text}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("ranks")
    return spawn(outdir), outdir


@pytest.fixture
def ranks(spawned):
    return spawned[0]


@pytest.fixture(autouse=True)
def _one_thread():
    """The ranks run one intra-op thread each: so does the reference (a
    CPU product's rounding may depend on the thread count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["gossip_ring", "gossip_torus"])
def test_gossip_rank_duals_equal_the_one_process_rows_bit_for_bit(ranks,
                                                                  name):
    want = _run(_session(CASES[name]))
    for r, got in enumerate(ranks):
        assert got[name]["worker"] == r
        assert got[name]["losses"] == want["losses"]
        for k, zl in want["tree"].items():
            assert got[name]["tree"][k].shape == (1,) + zl.shape[1:]
            assert torch.equal(got[name]["tree"][k][0], zl[r]), (name, r, k)


@pytest.mark.parametrize("name", ["gossip_ring", "gossip_torus"])
def test_gossip_rank_wire_bytes_and_primal(ranks, name):
    """Each round sends the fp32 row (plus its weight column) to K - 1 = 2
    neighbours; nothing is staged on the CPU; the node-averaged primal is
    the one-process session's."""
    session = _session(CASES[name])
    _run(session)
    width = sum(v.numel() for v in session.params.values()) + 1
    rounds = session.consensus_spec.gossip_rounds
    want = session.params
    for got in ranks:
        assert got[name]["sent"] == EPOCHS * rounds * 2 * 4 * width
        assert got[name]["staged"] == 0
        for k, w in want.items():
            torch.testing.assert_close(got[name]["primal"][k], w, rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("name", ["exact_ring", "exact_torus"])
def test_exact_rank_params_agree_with_one_process(ranks, name):
    want = _run(_session(CASES[name]))
    first = ranks[0][name]
    for got in ranks:
        for k, p in got[name]["tree"].items():
            assert torch.equal(p, first["tree"][k]), k   # ranks stay equal
        np.testing.assert_allclose(got[name]["losses"], want["losses"],
                                   rtol=EXACT_RTOL)
    for k, p in want["tree"].items():
        scale = float(p.abs().max())
        err = float((first["tree"][k] - p).abs().max())
        assert err <= EXACT_RTOL * scale, (k, err, scale)


def _losses(path: Path) -> list:
    return [json.loads(x)["loss"] for x in path.read_text().splitlines()]


def test_train_cli_over_ranks_matches_the_one_process_cli(spawned, tmp_path):
    """``--pod 2 --data 2 --graph torus`` over four ranks against ``--data
    4 --graph torus`` in one process: the torus is (2, 2) either way, the
    losses are equal, and only rank 0 wrote the metrics."""
    from repro_torch.launch.train import main
    ranks, outdir = spawned
    want = main(CLI_ONE + ["--metrics", str(tmp_path / "one.jsonl")],
                device="cpu")
    assert [got["cli"] for got in ranks] == [want] * N
    one = _losses(tmp_path / "one.jsonl")
    assert len(one) == EPOCHS
    assert _losses(outdir / "cli.jsonl") == one


def test_group_refusals_name_their_roadmap_item(ranks):
    """What a group still refuses names its item: what a model axis > 1
    does not run yet is module item 4a.5.3 (a hybrid and an audio model
    whose heads model 2 does not divide; the rest in
    ``tests/test_torch_tp.py``; the audio and hybrid families run where
    model divides their heads, ``tests/test_torch_tp_audio.py`` and
    ``tests/test_torch_tp_hybrid.py``; the MoE family runs,
    ``tests/test_torch_tp_moe.py``, and the vlm and ssm families,
    ``tests/test_torch_tp_ssm.py``; quantized gossip and every driver run,
    ``tests/test_torch_tp_quantized.py`` and
    ``tests/test_torch_tp_drivers.py``, and checkpoints and serving over
    the ranks, ``tests/test_torch_tp_serve.py``); every driver and option
    runs over ranks at model 1 (``tests/test_torch_ranks_drivers.py``)."""
    for got in ranks:
        assert sorted(got["refusals"]) == ["model_audio", "model_hybrid"]
        for what, msg in got["refusals"].items():
            assert msg is not None, what
            assert "ROADMAP.md, module item 4a.5.3" in msg, (what, msg)


def test_strategy_rounds_over_the_group_match_the_stacked_ones(ranks):
    """Ring taps bit for bit; the dense fallback (a star) and the exact
    mean within fp32 rounding (one row of a product against the
    product, an all-reduce's sum order against ``mean``)."""
    from repro_torch.dist import consensus
    rows = ranks[0]["strategies"]["rows"]
    want = {"ring": consensus.GossipConsensus(N, 3, "ring").combine(
                rows.clone()),
            "star": consensus.GossipConsensus(N, 3, "star").combine(
                rows.clone()),
            "exact": consensus.ExactConsensus(N).combine(rows.clone())}
    assert consensus.GossipConsensus(N, 3, "star").taps is None
    for r, got in enumerate(ranks):
        assert torch.equal(got["strategies"]["ring"], want["ring"][r])
        for name in ("star", "exact"):
            torch.testing.assert_close(got["strategies"][name],
                                       want[name][r], rtol=1e-6, atol=1e-6)


def test_constrain_redistributes_a_dtensor_on_the_mesh(ranks):
    for got in ranks:
        assert got["constrain"] == {"batch": True, "local": (2, 3),
                                    "full": True, "odd": True, "off": True}


def test_a_hung_rank_is_killed_at_the_deadline(tmp_path):
    """Two ranks of a world of three: they wait at the store for a rank
    that never comes; the spawn kills them at its deadline and fails."""
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="still running"):
        spawn(tmp_path, world=2, deadline_s=3.0, argv_extra=("3",))
    assert time.monotonic() - t0 < 30.0


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    if len(sys.argv) > 5:          # the hung-rank test: a larger world
        world_ = sys.argv[5]
    rank_main(store_, int(rank_), int(world_), outdir_)
