"""Quantized gossip (``gossip_q8`` / ``gossip_q4``) over a model axis: four
gloo ranks as (data 2, model 2) on the CPU, each worker spread over two
ranks, against the stacked port combine, the one-process ``data=2`` port
session and JAX.

Each rank holds a block of its worker's message row.  A round quantizes
the block on the whole row's grid (its bounds reduced over "model") with
the block's positions of the whole row's draws, so a rank's rows are its
block of the stacked round's rows bit for bit.  The draws are JAX's
(``uniform(fold_in(key, k), (n, W + 1))`` under ``threefry_partitionable``,
the whole stack's), made by the parent and handed to every rank through
the draw seam, which each rank asks for its worker's whole row.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp_quantized.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and save what they read:

  * ``combine_rank`` on a fixed (2, W + 1) stack, q8 and q4 on leaves
    whose block rows are even, and q4 on an odd block row: equal to the
    stacked port combine's rows, sliced, bit for bit (and so to JAX's
    combine run op by op; to its jitted combine within the tolerance of
    ``tests/test_torch_quantized.py``), with ``wire_bytes_per_round`` of
    the block sent and one grid reduction a round; the dense fallback on
    the same blocks, equal to the dense operator's rows;
  * a rank's draws: its block's positions of the stacked round's draws;
  * q8 and q4 ``AMBSession`` epochs at the fp32 smoke config against
    JAX's ``make_gossip_train_step`` on a stand-in mesh of 2 workers and
    against the one-process port session on the same draws (the losses to
    1e-5, the dual stack within ``STACK_RTOL``); the replicated leaves
    equal on a worker's model ranks; the bytes sent and the grid
    reductions per round;
  * the train CLI with ``--model 2 --consensus gossip_q8`` against the
    one-process ``--data 2`` CLI.

The spawn has a join deadline (``JOIN_S``) and the process group a
timeout (``PG_TIMEOUT_S``).
"""
import dataclasses
import datetime
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
N, M, PER, SEQ, EPOCHS = 2, 2, 2, 16, 2
BS = ([2, 1], [1, 2])
BETA = (50.0, float(N * PER), 200.0)     # the session's schedule
SEED = 3                                 # TrainSpec.seed: the draws' key
GOSSIP_ROUNDS = 1                        # q8: 4 rounds an epoch, q4: 8
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # the losses: fp32, TP sums in another order
# the dual stack: TP's fp32 order flips a few stochastic roundings, each
# moving one element by one grid step (tests/test_torch_quantized.py)
STACK_RTOL = 1e-2
STRATEGY_TOL = dict(rtol=2e-4, atol=1e-3)   # JAX's jitted combine
CLI_RTOL = 1e-3         # the bf16 smoke config: partial products rounded
CLI_ARGV = ["--smoke", "--batch-per-worker", str(PER), "--seq-len",
            str(SEQ), "--sim-clock", "--steps", str(EPOCHS), "--prefetch",
            "0", "--consensus", "gossip_q8"]
SESSIONS = ("gossip_q8", "gossip_q4")
# the consensus alone: leaves by name and whole shape; on (2, 2) the
# embed and wq split over "model", the bias and the norm are replicated
CROUNDS = 3
_LEAVES = {"blocks.attn.bq": (2, 8), "blocks.attn.wq": (2, 6, 8),
           "blocks.mlp.w_down": (2, 10, 6), "embed": (16, 6)}
CONSENSUS = {   # name: (bits, leaves); block rows of 180, 180, 179
    "q8": (8, {**_LEAVES, "final_norm": (7,)}),
    "q4": (4, {**_LEAVES, "final_norm": (7,)}),
    "q4_odd": (4, {**_LEAVES, "final_norm": (6,)}),
}
CKEY = 11


def _cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                               dtype="float32")


def _width(shapes: dict) -> int:
    return sum(int(np.prod(s)) for s in shapes.values()) + 1


def stored_source(table: dict):
    """The draw seam over stored stacks: ``table[(tag, epoch, k)]`` is
    round k's (n, W + 1) draws; ``rows`` picks a worker's row of them."""
    def source(tag, epoch):
        def draws(k, out, rows=None):
            full = torch.from_numpy(table[(tag, epoch, k)])
            return out.copy_(full if rows is None else full[list(rows)])
        return draws
    return source


def _session(consensus, params, draws, mesh=None, model=M):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    return AMBSession(
        TrainSpec(smoke=True, data=N, model=model, batch_per_worker=PER,
                  seq_len=SEQ, seed=SEED),
        ClockSpec(kind="simulated"),
        ConsensusSpec(consensus=consensus, graph="ring",
                      gossip_rounds=GOSSIP_ROUNDS),
        cfg=_cfg(), params={k: v.clone() for k, v in params.items()},
        device="cpu", mesh=mesh, draw_source=draws)


def _epochs(session, batches, worker=None) -> list:
    out = []
    for t in range(EPOCHS):
        batch = batches[t]
        if worker is not None:
            batch = {k: v[worker * PER:(worker + 1) * PER]
                     for k, v in batch.items()}
        out.append(float(session.step(batch, BS[t])["loss"]))
    return out


def _consensus_rank(name, group, stack, draws) -> dict:
    """One rank's q8 / q4 combine on its block of a fixed stack, and the
    dense fallback on the same block."""
    from repro_torch.dist.consensus import QuantizedGossipConsensus
    from repro_torch.dist.tp import TensorParallel
    bits, shapes = CONSENSUS[name]
    tp = TensorParallel(group, shapes, None, _cfg())
    block = tp.row_block(list(shapes))
    buf = torch.empty((1, block.block_width))
    block.take(stack[group.worker], buf[0])
    q = QuantizedGossipConsensus(N, CROUNDS, bits, "ring")
    sent, grids = group.sent_bytes, group.grid_reductions
    got = q.combine_rank(buf.clone(), group, draws=draws, block=block)
    out = {"row": got.clone(), "sent": group.sent_bytes - sent,
           "grids": group.grid_reductions - grids,
           "wire": q.wire_bytes_per_round(block.block_width),
           "width": block.width, "block_width": block.block_width}
    out["dense"] = q._dense_rank(buf.clone(), group, draws, block).clone()
    return out


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: the consensus cases, the draws, the sessions and the
    CLI; results to ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist.amb import msg_width
    from repro_torch.dist.consensus import (epoch_draws, make_strategy,
                                            rank_draws)
    from repro_torch.dist.group import WorkerGroup
    from repro_torch.dist.tp import TensorParallel
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)
    try:
        params = torch.load(outdir / "params.pt")
        batches = torch.load(outdir / "batches.pt")
        stacks = torch.load(outdir / "stacks.pt")
        source = stored_source(np.load(outdir / "draws.npz",
                                       allow_pickle=True)["table"].item())
        mesh = make_host_mesh(N, M, device="cpu")
        group = WorkerGroup(mesh, "cpu")
        out = {"coord": tuple(int(c) for c in mesh.get_coordinate()),
               "worker": group.worker, "m": group.m}
        for name in CONSENSUS:
            out[name] = _consensus_rank(name, group, stacks[name],
                                        source("c", name))
        shapes = CONSENSUS["q4_odd"][1]
        block = TensorParallel(group, shapes, None,
                               _cfg()).row_block(list(shapes))
        out["draws"] = rank_draws(epoch_draws(5, 1), 2,
                                  torch.empty((1, block.block_width)),
                                  group.worker, block)
        for consensus in SESSIONS:
            session = _session(consensus, params, source, mesh)
            g = session.group
            losses = _epochs(session, batches, g.worker)
            z = session.state["z"]
            strat = make_strategy(consensus, N, rounds=GOSSIP_ROUNDS)
            width = session.tp.row_block().block_width
            out[consensus] = {
                "losses": losses, "sent": g.sent_bytes,
                "grids": g.grid_reductions, "rounds": strat.rounds,
                "wire": strat.wire_bytes_per_round(width),
                "block_width": width, "msg_width": msg_width(z, 1),
                "blocks": {k: v[0].clone() for k, v in z.items()}}
        out["cli"] = train.main(
            CLI_ARGV + ["--data", str(N), "--model", str(M), "--metrics",
                        str(outdir / "cli.jsonl")], device="cpu")
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
    copy, the batches, the consensus stacks (numpy, from a seed), and
    JAX's draws: every round of every epoch of the sessions, and the
    consensus rounds."""
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
    rng = np.random.default_rng(0)
    jbatches, batches = [], []
    for _ in range(EPOCHS):
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        jbatches.append({"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(labels)})
        batches.append({"tokens": torch.from_numpy(toks).long(),
                        "labels": torch.from_numpy(labels).long()})
    stacks = {name: torch.from_numpy((rng.standard_normal(
        (N, _width(shapes))) * 3.0).astype(np.float32))
        for name, (_, shapes) in CONSENSUS.items()}
    table = {}
    width = sum(v.numel() for v in params.values()) + 1
    rounds = max(GOSSIP_ROUNDS * 32 // int(c[-1]) for c in SESSIONS)
    for t in range(EPOCHS):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
        for k in range(rounds):
            table[(SEED, t, k)] = _jax_uniform(jax.random.fold_in(key, k),
                                               (N, width))
    for name, (_, shapes) in CONSENSUS.items():
        for k in range(CROUNDS):
            table[("c", name, k)] = _jax_uniform(
                jax.random.fold_in(jax.random.PRNGKey(CKEY), k),
                (N, _width(shapes)))
    return jcfg, jparams, params, jbatches, batches, stacks, table


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    outdir = tmp_path_factory.mktemp("ranks_tp_q")
    _, _, params, _, batches, stacks, table = inputs
    torch.save(params, outdir / "params.pt")
    torch.save(batches, outdir / "batches.pt")
    torch.save(stacks, outdir / "stacks.pt")
    np.savez(outdir / "draws.npz", table=np.array(table, dtype=object))
    return spawn(outdir), outdir


@pytest.fixture
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process data=2 port sessions on the same draws (one
    thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, params, _, batches, _, table = inputs
        out = {}
        for consensus in SESSIONS:
            session = _session(consensus, params, stored_source(table),
                               model=1)
            out[consensus] = {"losses": _epochs(session, batches),
                              "z": session.state["z"]}
        return out
    finally:
        torch.set_num_threads(before)


def _mesh():
    from repro_torch.launch.mesh import abstract
    return abstract((N, M), ("data", "model"))


def _block_of(row: torch.Tensor, shapes: dict, coord) -> torch.Tensor:
    """The block row of ``coord`` cut from a whole (W + 1,) row through
    ``dist.params.shard_tree`` (not the rank's ``RowBlock``)."""
    from repro_torch.dist import params as P
    leaves, a = {}, 0
    for k, shape in shapes.items():
        n = int(np.prod(shape))
        leaves[k] = row[a:a + n].reshape(shape)
        a += n
    blocks = P.shard_tree(leaves, _mesh(), coord, None)
    return torch.cat([v.reshape(-1) for v in blocks.values()]
                     + [row[a:]])


def _gather_stack(ranks, rows: dict, shapes: dict) -> torch.Tensor:
    """The whole (N, W + 1) stack from the ranks' block rows (``rows``:
    rank -> (block_width,)); the replicated leaves and the count taken
    from the model-0 rank of each worker."""
    from repro_torch.dist import params as P
    out = []
    for i in range(N):
        trees = {}
        for r, got in enumerate(ranks):
            if got["worker"] != i:
                continue
            tree, b = {}, 0
            for k, shape in shapes.items():
                spec = P.param_spec(k, shape, _mesh(), None)
                size = tuple(n for _, n in P.block_slices(
                    spec, shape, _mesh(), got["coord"]))
                n = int(np.prod(size))
                tree[k] = rows[r][b:b + n].reshape(size)
                b += n
            trees[got["coord"]] = tree
            if got["m"] == 0:
                count = rows[r][b:]
        whole = P.gather_tree(trees, _mesh(), shapes, None)
        out.append(torch.cat([v.reshape(-1) for v in whole.values()]
                             + [count]))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# The consensus alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONSENSUS))
def test_combine_rank_is_the_stacked_combine_bit_for_bit(ranks, inputs,
                                                         name):
    """Each rank's rows, q8 and q4 (an odd block row too), against its
    block of the stacked port combine on JAX's draws, bit for bit; the
    ranks' rows gathered against JAX's combine; one grid reduction and
    ``wire_bytes_per_round`` of the block a round."""
    import jax
    import jax.numpy as jnp

    from repro.dist import consensus as jcons
    from repro_torch.dist.consensus import QuantizedGossipConsensus
    *_, stacks, table = inputs
    bits, shapes = CONSENSUS[name]
    stack = stacks[name]
    draws = stored_source(table)("c", name)
    want = QuantizedGossipConsensus(N, CROUNDS, bits, "ring").combine(
        stack.clone(), draws)
    for got in ranks:
        res = got[name]
        assert res["width"] == stack.shape[1]
        assert res["block_width"] % 2 == (name == "q4_odd")
        assert torch.equal(res["row"][0],
                           _block_of(want[got["worker"]], shapes,
                                     got["coord"])), (name, got["coord"])
        assert res["grids"] == CROUNDS
        assert res["sent"] == CROUNDS * res["wire"]
        assert res["wire"] == ((res["block_width"] + 1) // 2 if bits == 4
                               else res["block_width"]) + 8
    whole = _gather_stack(ranks, {r: g[name]["row"][0]
                                  for r, g in enumerate(ranks)}, shapes)
    jq = jcons.QuantizedGossipConsensus(N, CROUNDS, bits, "ring")
    key = jax.random.PRNGKey(CKEY)
    with jax.disable_jit():
        eager = np.asarray(jq.combine(jnp.asarray(stack.numpy()), key))
    np.testing.assert_array_equal(whole.numpy(), eager)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jq.combine(jnp.asarray(stack.numpy()),
                                             key)), **STRATEGY_TOL)


@pytest.mark.parametrize("name", ["q8", "q4_odd"])
def test_the_dense_fallback_runs_over_a_model_axis(ranks, inputs, name):
    """``_dense_rank`` on the same blocks: the dense operator's rows
    (``gossip_quantized`` on the stack), sliced, bit for bit."""
    from repro_torch.core.extensions import gossip_quantized
    from repro_torch.dist.consensus import QuantizedGossipConsensus
    *_, stacks, table = inputs
    bits, shapes = CONSENSUS[name]
    q = QuantizedGossipConsensus(N, CROUNDS, bits, "ring")
    want = gossip_quantized(stacks[name].clone(), q.p, CROUNDS, bits,
                            stored_source(table)("c", name))
    for got in ranks:
        assert torch.equal(got[name]["dense"][0],
                           _block_of(want[got["worker"]], shapes,
                                     got["coord"])), got["coord"]


def test_rank_draws_are_the_blocks_of_the_stacked_draws(ranks):
    from repro_torch.dist.consensus import epoch_draws
    shapes = CONSENSUS["q4_odd"][1]
    stack = epoch_draws(5, 1)(2, torch.empty((N, _width(shapes))))
    for got in ranks:
        assert torch.equal(got["draws"][0],
                           _block_of(stack[got["worker"]], shapes,
                                     got["coord"]))
    first = [g["draws"] for g in ranks if g["m"] == 0]
    assert not torch.equal(first[0], first[1])


# ---------------------------------------------------------------------------
# The sessions
# ---------------------------------------------------------------------------

def _dual_stack(ranks, consensus, params) -> np.ndarray:
    """Each worker's dual gathered over its model ranks, as an (N, W)
    stack in sorted leaf order (``params``: the whole leaves' shapes)."""
    from repro_torch.dist import params as P
    shapes = {k: v.shape for k, v in params.items()}
    rows = [P.gather_tree({g["coord"]: g[consensus]["blocks"] for g in ranks
                           if g["worker"] == i}, _mesh(), shapes, None)
            for i in range(N)]
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


@pytest.mark.parametrize("consensus", SESSIONS)
def test_quantized_sessions_match_jax(ranks, inputs, consensus):
    """JAX's unsharded gossip step over the same 2 workers (a stand-in
    mesh), on the same parameters, batches and seed: the losses to 1e-5
    on every rank, the dual stack gathered from the blocks within
    STACK_RTOL."""
    import jax
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    jcfg, jparams, params, jbatches, *_ = inputs
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    jcfg_amb = jamb.AMBConfig(consensus=consensus,
                              gossip_rounds=GOSSIP_ROUNDS, graph="ring",
                              beta=JBeta(*BETA), seed=SEED)
    step = jax.jit(jamb.make_gossip_train_step(jcfg, standin, jcfg_amb)[1])
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    losses = []
    for t in range(EPOCHS):
        state, m = step(state, jbatches[t], jnp.asarray(BS[t], jnp.int32))
        losses.append(float(m["loss"]))
    want = _stack(_flat(state["z"]))
    got = _dual_stack(ranks, consensus, params)
    for g in ranks:
        np.testing.assert_allclose(g[consensus]["losses"], losses,
                                   rtol=1e-5)
    assert np.linalg.norm(got - want) <= STACK_RTOL * np.linalg.norm(want)


@pytest.mark.parametrize("consensus", SESSIONS)
def test_quantized_sessions_match_the_one_process_session(ranks,
                                                          one_process,
                                                          inputs, consensus):
    want = one_process[consensus]
    for g in ranks:
        np.testing.assert_allclose(g[consensus]["losses"], want["losses"],
                                   rtol=EXACT_RTOL)
    w = _stack({k: v.numpy() for k, v in want["z"].items()})
    got = _dual_stack(ranks, consensus, inputs[2])
    assert got.shape == w.shape
    assert np.linalg.norm(got - w) <= STACK_RTOL * np.linalg.norm(w)


@pytest.mark.parametrize("consensus", SESSIONS)
def test_replicated_leaves_are_equal_on_a_workers_model_ranks(ranks,
                                                              inputs,
                                                              consensus):
    """Norms and biases take the same positions of the whole row's draws
    on every model rank, so their levels, and duals, are equal bit for
    bit."""
    from repro_torch.dist import params as P
    params = inputs[2]
    first = {}
    for g in ranks:
        for k, v in g[consensus]["blocks"].items():
            if P.param_spec(k, params[k].shape, _mesh(), None) != ():
                continue
            key = (g["worker"], k)
            if key in first:
                assert torch.equal(v, first[key]), key
            else:
                first[key] = v
    assert len(first) == 12


@pytest.mark.parametrize("consensus", SESSIONS)
def test_each_rank_sends_the_block_wire_with_one_grid_reduction_a_round(
        ranks, consensus):
    for g in ranks:
        res = g[consensus]
        rounds = EPOCHS * res["rounds"]
        assert res["rounds"] == GOSSIP_ROUNDS * 32 // int(consensus[-1])
        assert res["block_width"] == res["msg_width"]
        assert res["grids"] == rounds
        assert res["sent"] == rounds * res["wire"]


def _losses(path: Path) -> list:
    import json
    return [json.loads(x)["loss"] for x in path.read_text().splitlines()]


def test_train_cli_gossip_q8_with_a_model_axis_matches_the_one_process_cli(
        spawned, tmp_path):
    """``--data 2 --model 2 --consensus gossip_q8`` over four ranks against
    ``--data 2`` in one process (the smoke config's bf16: within
    CLI_RTOL); rank 0 alone wrote the metrics."""
    from repro_torch.launch.train import main
    ranks, outdir = spawned
    want = main(CLI_ARGV + ["--data", str(N), "--metrics",
                            str(tmp_path / "one.jsonl")], device="cpu")
    for got in ranks:
        assert got["cli"] == pytest.approx(want, rel=CLI_RTOL)
    one = _losses(tmp_path / "one.jsonl")
    assert len(one) == EPOCHS
    np.testing.assert_allclose(_losses(outdir / "cli.jsonl"), one,
                               rtol=CLI_RTOL)


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
