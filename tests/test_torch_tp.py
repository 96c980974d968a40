"""A worker spread over a model axis: four gloo ranks as (data 2, model 2)
on the CPU against the one-process ``data=2`` port session and JAX.

The layout cases need no group: ``shard_tree`` then ``gather_tree`` is the
identity on the qwen2-1.5b smoke tree on (2, 2) and (pod 2, data 2, model
2), ``init_shards`` gives slices of ``init_params`` bit for bit, and a
leaf the mesh does not divide (whisper's vocabulary) is replicated.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run at the fp32 smoke config on the parent's parameters and
batches, ``EPOCHS`` epochs at the minibatch sizes ``BS``:

  * exact (FSDP x TP) and ring gossip (TP): the gathered parameters, duals
    and losses against the one-process ``data=2`` session (``EXACT_RTOL``)
    and against JAX's ``make_train_step`` / ``make_gossip_train_step`` on
    a stand-in mesh of 2 workers (the tolerances of
    ``tests/test_torch_dist.py``); the blocks the ranks hold gather to the
    session's ``params``, the replicated leaves are equal on every model
    rank bit for bit, and the exact ranks' bytes are the dry-run's;
  * a trust region that binds (the gossip session's ``radius``, and dual
    averaging's through the exact protocol), equal to the one-process one:
    the norm is the whole leaf's;
  * the train CLI with ``--model 2``, exact and gossip, against the
    one-process ``--data 2`` CLI;
  * what is still refused at model > 1 (a model extent that does not
    divide the heads: an audio model's, a hybrid's Mamba2 heads, a dense
    model's query heads) raising with its item, 4a.5.3 (the MoE family
    and more model ranks than KV heads:
    ``tests/test_torch_tp_moe.py``; quantized gossip runs:
    ``tests/test_torch_tp_quantized.py``; every other driver and option:
    ``tests/test_torch_tp_drivers.py``; checkpoints and serving:
    ``tests/test_torch_tp_serve.py``).

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
RADIUS = 2e-3           # binds on six matrix leaves (they move 0.0027 to
                        # 0.0054 in two epochs without it), not on the rest
ROUNDS = 5
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: TP and FSDP sum in another order
CLI_RTOL = 1e-3         # the bf16 smoke config: partial products rounded
CLI_ARGV = ["--smoke", "--batch-per-worker", str(PER), "--seq-len",
            str(SEQ), "--sim-clock", "--steps", str(EPOCHS), "--prefetch",
            "0"]
# name: (consensus, radius, odd); an odd case runs a config whose
# vocabulary and ffn width model 2 does not divide (param_spec drops the
# axis: the lookup, the logits and the MLP run whole on each model rank),
# initialised from the seed on the ranks
CASES = {"exact": ("exact", None, False), "gossip": ("gossip", None, False),
         "gossip_radius": ("gossip", RADIUS, False),
         "odd_exact": ("exact", None, True)}
ODD = dict(vocab_size=511, d_ff=255)
REFUSED = ("audio", "hybrid", "heads")
# layout: (arch, (data, model), seq_len) of an exact session initialised
# from the seed on the ranks, one epoch, beside the qwen2-1.5b "exact"
# case: the MoE family's experts on "model" (its exact step dispatches by
# sequence, 64 tokens or more) and more model ranks than KV heads
LAYOUTS = {"moe": ("qwen3-moe-30b-a3b", (N, M), 64),
           "kv_split": ("qwen2-1.5b", (1, 4), SEQ)}


def _cfg(arch="qwen2-1.5b", **kw):
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config(arch), dtype="float32",
                               **kw)


def _odd(batches: list) -> list:
    """The batches with ids inside the odd vocabulary."""
    v = ODD["vocab_size"]
    return [{"tokens": b["tokens"] % v,
             "labels": torch.where(b["labels"] >= 0, b["labels"] % v, -1)}
            for b in batches]


def _case(name, params, batches, mesh=None):
    """(the case's session, its batches)."""
    consensus, radius, odd = CASES[name]
    if odd:
        return (_session(consensus, None, mesh, cfg=_cfg(**ODD)),
                _odd(batches))
    return _session(consensus, params, mesh, radius=radius), batches


def _session(consensus="exact", params=None, mesh=None, cfg=None,
             radius=None, train=None, **spec):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    train = train or TrainSpec(smoke=True, data=N, model=M,
                               batch_per_worker=PER, seq_len=SEQ)
    if params is not None:
        params = {k: v.clone() for k, v in params.items()}
    return AMBSession(train, ClockSpec(kind="simulated"),
                      ConsensusSpec(consensus=consensus, graph="ring",
                                    gossip_rounds=ROUNDS, radius=radius,
                                    **spec),
                      cfg=cfg or _cfg(), params=params, device="cpu",
                      mesh=mesh)


def _exact_radius(params, group=None, tp=None):
    """The exact protocol under dual averaging with a trust region."""
    from repro_torch.api.protocol import build_protocol
    from repro_torch.core.dual_averaging import BetaSchedule
    from repro_torch.dist.amb import AMBConfig
    from repro_torch.optim import DualAveragingOpt
    opt = DualAveragingOpt(beta=BetaSchedule(*BETA), radius=RADIUS)
    return build_protocol(_cfg(), N, AMBConfig(beta=BetaSchedule(*BETA)),
                          optimizer=opt, group=group, tp=tp)


def _epochs(step, batches, worker=None) -> list:
    """``step(batch, b)`` each epoch on the global batch, or on
    ``worker``'s rows of it; the losses."""
    out = []
    for t in range(EPOCHS):
        batch = batches[t]
        if worker is not None:
            batch = {k: v[worker * PER:(worker + 1) * PER]
                     for k, v in batch.items()}
        out.append(float(step(batch, BS[t])["loss"]))
    return out


def _record(session, losses) -> dict:
    state = session.state
    tree = state["z"] if "z" in state else state["params"]
    out = {"losses": losses,
           "blocks": {k: v.detach().clone() for k, v in tree.items()},
           "whole": session.params}
    if "opt" in state:
        out["opt_bytes"] = sum(v.numel() * v.element_size()
                               for key in ("z", "w0")
                               for v in state["opt"][key].values())
    return out


def _refusals(params, mesh, mesh14) -> dict:
    from repro_torch.api import TrainSpec
    tries = {
        # model 2 does not divide 3 heads (whisper-base-smoke's 4 run:
        # tests/test_torch_tp_audio.py)
        "audio": lambda: _session("exact", None, mesh,
                                  cfg=_cfg("whisper-base", num_heads=3,
                                           num_kv_heads=3)),
        # model 2 does not divide 3 Mamba2 heads (d_in 192; the smoke
        # config's 4 run: tests/test_torch_tp_hybrid.py)
        "hybrid": lambda: _session("exact", None, mesh,
                                   cfg=_cfg("zamba2-1.2b", d_model=96)),
        # model 4 does not divide 6 query heads
        "heads": lambda: _session("exact", None, mesh14,
                                  cfg=_cfg(num_heads=6, head_dim=32),
                                  train=TrainSpec(smoke=True, data=1,
                                                  model=4)),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _layouts() -> dict:
    """Each LAYOUTS session's blocks and fp32 z / w0 bytes and the bytes
    its one epoch moved over "data"."""
    from repro_torch.api import TrainSpec
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for name, (arch, shape, seq) in LAYOUTS.items():
        session = _session("exact", None, make_host_mesh(*shape,
                                                         device="cpu"),
                           cfg=_cfg(arch), train=TrainSpec(
                               smoke=True, data=shape[0], model=shape[1],
                               batch_per_worker=PER, seq_len=seq))
        gen = torch.Generator().manual_seed(9)
        toks = torch.randint(0, session.cfg.vocab_size, (PER, seq),
                             generator=gen)
        session.step({"tokens": toks, "labels": toks.roll(-1, 1)},
                     [PER] * shape[0])
        state = session.state
        out[name] = {"param_bytes": sum(v.numel() * v.element_size()
                                        for v in state["params"].values()),
                     "opt_bytes": sum(v.numel() * v.element_size()
                                      for key in ("z", "w0")
                                      for v in state["opt"][key].values()),
                     "tp_bytes": (session.tp.gathered_bytes,
                                  session.tp.scattered_bytes)}
    return out


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
    outdir = Path(outdir)
    try:
        params = torch.load(outdir / "params.pt")
        batches = torch.load(outdir / "batches.pt")
        mesh = make_host_mesh(N, M, device="cpu")
        out = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
        for name in CASES:
            session, data = _case(name, params, batches, mesh)
            w = session.group.worker
            losses = _epochs(session.step, data, w)
            out[name] = _record(session, losses)
            out[name]["worker"] = w
            out[name]["tp_bytes"] = (session.tp.gathered_bytes,
                                     session.tp.scattered_bytes)
        session = _session("exact", params, mesh)
        proto = _exact_radius(None, session.group, session.tp)
        state = proto.init(session.model.params())
        losses = _epochs(lambda b, n: proto.step(state, b, n)[1], batches,
                         session.group.worker)
        out["exact_radius"] = {"losses": losses,
                               "whole": session.tp.whole(state["params"])}
        for consensus in ("exact", "gossip"):
            out[f"cli_{consensus}"] = train.main(
                CLI_ARGV + ["--data", str(N), "--model", str(M),
                            "--consensus", consensus, "--metrics",
                            str(outdir / f"cli_{consensus}.jsonl")],
                device="cpu")
        out["refusals"] = _refusals(params, mesh,
                                    make_host_mesh(1, 4, device="cpu"))
        out["layouts"] = _layouts()
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


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters of the fp32 smoke config, the port's copy
    of them, and the batches (numpy, from a seed)."""
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
    return jcfg, jparams, params, jbatches, batches


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    outdir = tmp_path_factory.mktemp("ranks_tp")
    _, _, params, _, batches = inputs
    torch.save(params, outdir / "params.pt")
    torch.save(batches, outdir / "batches.pt")
    return spawn(outdir), outdir


@pytest.fixture
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process data=2 port sessions (one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, params, _, batches = inputs
        out = {}
        for name in CASES:
            session, data = _case(name, params, batches)
            out[name] = _record(session, _epochs(session.step, data))
        proto = _exact_radius(None)
        state = proto.init({k: v.clone().requires_grad_()
                            for k, v in params.items()})
        out["exact_radius"] = {
            "losses": _epochs(lambda b, n: proto.step(state, b, n)[1],
                              batches),
            "whole": {k: v.detach() for k, v in state["params"].items()}}
        return out
    finally:
        torch.set_num_threads(before)


def _mesh(shape):
    from repro_torch.launch.mesh import abstract
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return abstract(shape, names)


def _coords(mesh):
    from repro_torch.launch.mesh import axis_names, mesh_shape
    shape = mesh_shape(mesh)
    return list(np.ndindex(*(shape[a] for a in axis_names(mesh))))


def _within(got: dict, want: dict, rtol: float, what: str) -> None:
    """Leafwise: max |got - want| <= rtol * max |want| (at least rtol)."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = w.detach().float()
        err = float((got[k].detach().float() - w).abs().max())
        assert err <= rtol * max(1.0, float(w.abs().max())), (what, k, err)


# ---------------------------------------------------------------------------
# The layout, no group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("fsdp", ["data", None])
def test_shard_then_gather_is_the_identity(shape, fsdp):
    from repro_torch import configs, models
    from repro_torch.dist import params as P
    cfg = configs.smoke_config("qwen2-1.5b")
    tree = models.init_params(cfg, torch.Generator().manual_seed(1))
    mesh = _mesh(shape)
    shards = {c: P.shard_tree(tree, mesh, c, fsdp) for c in _coords(mesh)}
    back = P.gather_tree(shards, mesh, {k: v.shape for k, v in tree.items()},
                         fsdp)
    assert list(back) == list(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # every rank holds 1 / (the extents its spec names) of each leaf
    for c, blocks in shards.items():
        for k, v in blocks.items():
            ways = P.shard_extent(P.param_spec(k, tree[k].shape, mesh, fsdp),
                                  mesh)
            assert v.numel() * ways == tree[k].numel(), (c, k)


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_init_shards_are_slices_of_init_params_bit_for_bit(shape):
    from repro_torch import configs, models
    from repro_torch.dist import params as P
    cfg = configs.smoke_config("qwen2-1.5b")
    tree = models.init_params(cfg, torch.Generator().manual_seed(5))
    mesh = _mesh(shape)
    for c in _coords(mesh):
        got = P.init_shards(cfg, torch.Generator().manual_seed(5), mesh, c)
        want = P.shard_tree(tree, mesh, c)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (c, k)


def test_an_indivisible_leaf_is_replicated():
    """Whisper's 51,865-row vocabulary on model 2: the "model" axis drops
    from the embed and unembed, which stay split over "data" only."""
    from repro_torch.dist import params as P
    gen = torch.Generator().manual_seed(2)
    tree = {"embed": torch.randn((51865, 4), generator=gen),
            "unembed": torch.randn((4, 51865), generator=gen),
            "blocks.mlp.w_up": torch.randn((2, 4, 6), generator=gen)}
    mesh = _mesh((2, 2))
    assert P.param_spec("embed", (51865, 4), mesh) == (None, "data")
    shards = {c: P.shard_tree(tree, mesh, c) for c in _coords(mesh)}
    for d in range(2):
        for k in ("embed", "unembed"):
            assert torch.equal(shards[(d, 0)][k], shards[(d, 1)][k])
        assert not torch.equal(shards[(d, 0)]["blocks.mlp.w_up"],
                               shards[(d, 1)]["blocks.mlp.w_up"])
    back = P.gather_tree(shards, mesh, {k: v.shape for k, v in tree.items()})
    assert all(torch.equal(back[k], v) for k, v in tree.items())


# ---------------------------------------------------------------------------
# Four ranks against one process and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*CASES, "exact_radius"])
def test_ranks_match_the_one_process_session(ranks, one_process, name):
    """Losses and the gathered primal within EXACT_RTOL on every rank; the
    gossip duals of each worker, its model ranks' blocks gathered."""
    from repro_torch.dist import params as P
    want = one_process[name]
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], want["losses"],
                                   rtol=EXACT_RTOL)
        _within(got[name]["whole"], want["whole"], EXACT_RTOL, name)
    if not name.startswith("gossip"):
        return
    mesh = _mesh((N, M))
    shapes = {k: v.shape[1:] for k, v in want["blocks"].items()}
    for i in range(N):
        rows = {got["coord"]: {k: v[0] for k, v in got[name]["blocks"].items()}
                for got in ranks if got[name]["worker"] == i}
        assert len(rows) == M
        z = P.gather_tree(rows, mesh, shapes, None)
        _within(z, {k: v[i] for k, v in want["blocks"].items()}, EXACT_RTOL,
                f"{name} z worker {i}")


def test_the_trust_region_binds_on_the_whole_leaf(ranks, one_process,
                                                  inputs):
    """With the radius no leaf moves past it from w0, and the leaves that
    the run without it moves past it end on the sphere of the whole leaf
    (||w - w0|| = RADIUS, not a rank's block's)."""
    w0 = inputs[2]
    norm = lambda w, k: float(torch.linalg.vector_norm(w.detach() - w0[k]))
    for name, free in (("exact_radius", "exact"),
                       ("gossip_radius", "gossip")):
        got, unbound = ranks[0][name]["whole"], one_process[free]["whole"]
        bound = [k for k, w in unbound.items() if norm(w, k) > RADIUS]
        for k, w in got.items():
            assert norm(w, k) <= RADIUS * (1 + 1e-4), (name, k)
        for k in bound:
            assert abs(norm(got[k], k) - RADIUS) <= 1e-4 * RADIUS, (name, k)
        assert len(bound) >= 3, (name, bound)


def test_replicated_leaves_are_equal_on_every_model_rank(ranks):
    """Norms and biases: bit for bit across the two model ranks of each
    worker (and, exact, across the workers)."""
    from repro_torch.dist import params as P
    mesh = _mesh((N, M))
    for name in ("exact", "gossip"):
        first = {}
        for got in ranks:
            for k, v in got[name]["blocks"].items():
                shape = v.shape[1:] if name == "gossip" else v.shape
                if P.param_spec(k, shape, mesh) != ():
                    continue
                key = k if name == "exact" else (got[name]["worker"], k)
                if key in first:
                    assert torch.equal(v, first[key]), (name, key)
                else:
                    first[key] = v
        assert len(first) == (6 if name == "exact" else 12)


def test_rank_blocks_gather_to_the_session_params(ranks):
    from repro_torch.dist import params as P
    mesh = _mesh((N, M))
    whole = ranks[0]["exact"]["whole"]
    got = P.gather_tree({r["coord"]: r["exact"]["blocks"] for r in ranks},
                        mesh, {k: v.shape for k, v in whole.items()})
    for k, v in whole.items():
        assert torch.equal(got[k], v), k
    for r in ranks[1:]:
        assert all(torch.equal(r["exact"]["whole"][k], v)
                   for k, v in whole.items())


@pytest.mark.parametrize("layout", ["dense", *LAYOUTS])
def test_exact_rank_bytes_equal_the_dry_run_layout(ranks, layout):
    """Each exact rank's parameter blocks and fp32 z / w0 blocks are the
    dry-run's per-rank bytes for its configuration and mesh, to the byte,
    and so are the bytes an epoch's all-gathers and reduce-scatters
    moved over "data" (``dryrun.rank_fsdp_bytes``): qwen2-1.5b on (2, 2),
    the MoE family with its experts on "model", and qwen2-1.5b on (1, 4),
    two ranks to a KV head."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    arch, shape, seq = LAYOUTS.get(layout, ("qwen2-1.5b", (N, M), SEQ))
    mesh = _mesh(shape)
    lay = dryrun._layout(_cfg(arch), InputShape("tp", seq, shape[0] * PER,
                                                "train"), mesh)
    moved = dryrun.rank_fsdp_bytes(_cfg(arch), mesh)
    moved = (moved["gathered_bytes"], moved["scattered_bytes"])
    for got in ranks:
        if layout == "dense":
            res = got["exact"]
            params = sum(v.numel() * v.element_size()
                         for v in res["blocks"].values())
            tp_bytes = tuple(b // EPOCHS for b in res["tp_bytes"])
            assert got["gossip"]["tp_bytes"] == (0, 0)  # TP only, no FSDP
        else:
            res = got["layouts"][layout]
            params, tp_bytes = res["param_bytes"], res["tp_bytes"]
        assert params == lay["param_bytes_per_rank"]
        assert res["opt_bytes"] == lay["opt_state_bytes_per_rank"]
        assert tp_bytes == moved
        assert min(moved) > 0 or shape[0] == 1


@pytest.mark.parametrize("name", ["exact", "gossip"])
def test_ranks_match_jax(ranks, inputs, name):
    """JAX's unsharded step over the same 2 workers (a stand-in mesh), on
    the same parameters and batches: the tolerances of
    ``tests/test_torch_dist.py``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.optim import DualAveragingOpt as JDualAveraging
    from repro_torch import models
    jcfg, jparams, _, jbatches, _ = inputs
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    if name == "exact":
        jopt = JDualAveraging(beta=JBeta(*BETA))
        step = jax.jit(jamb.make_train_step(jcfg, jopt, standin))
        state = (jparams, jopt.init(jparams))
    else:
        jamb_cfg = jamb.AMBConfig(consensus="gossip", gossip_rounds=ROUNDS,
                                  graph="ring", beta=JBeta(*BETA))
        _, gstep = jamb.make_gossip_train_step(jcfg, standin, jamb_cfg)
        gstep = jax.jit(gstep)
        state = {"z": jax.tree.map(
            lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
            "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    losses = []
    for t in range(EPOCHS):
        b = jnp.asarray(BS[t], jnp.int32)
        if name == "exact":
            p, o, m = step(*state, jbatches[t], b)
            state = (p, o)
        else:
            state, m = gstep(state, jbatches[t], b)
        losses.append(float(m["loss"]))

    def flat(tree):
        return {k: v.detach() for k, v in models.from_jax_params(
            jax.tree.map(np.asarray, tree), _cfg(), device="cpu")
            .params().items()}

    if name == "exact":
        want = flat(state[0])
        atol = 1e-6
    else:
        want = flat(jamb.gossip_primal(state, jamb_cfg))
        atol = 1e-6
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], losses, rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(
                got[name]["whole"][k].numpy(), w.numpy(), rtol=1e-5,
                atol=atol * max(1.0, float(w.abs().max())), err_msg=k)
    if name == "gossip":
        mesh = _mesh((N, M))
        from repro_torch.dist import params as P
        for i in range(N):
            zi = flat(jax.tree.map(lambda v: v[i], state["z"]))
            rows = {r["coord"]: {k: v[0] for k, v in
                                 r[name]["blocks"].items()}
                    for r in ranks if r[name]["worker"] == i}
            z = P.gather_tree(rows, mesh, {k: v.shape for k, v in
                                           zi.items()}, None)
            for k, w in zi.items():
                np.testing.assert_allclose(
                    z[k].numpy(), w.numpy(), rtol=1e-3,
                    atol=1e-5 * max(1.0, float(w.abs().max())), err_msg=k)


def _losses(path: Path) -> list:
    import json
    return [json.loads(x)["loss"] for x in path.read_text().splitlines()]


@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_train_cli_with_a_model_axis_matches_the_one_process_cli(
        spawned, tmp_path, consensus):
    """``--data 2 --model 2`` over four ranks against ``--data 2`` in one
    process (the smoke config's bf16: within CLI_RTOL); rank 0 alone
    wrote the metrics."""
    from repro_torch.launch.train import main
    ranks, outdir = spawned
    want = main(CLI_ARGV + ["--data", str(N), "--consensus", consensus,
                            "--metrics", str(tmp_path / "one.jsonl")],
                device="cpu")
    for got in ranks:
        assert got[f"cli_{consensus}"] == pytest.approx(want, rel=CLI_RTOL)
    one = _losses(tmp_path / "one.jsonl")
    assert len(one) == EPOCHS
    np.testing.assert_allclose(_losses(outdir / f"cli_{consensus}.jsonl"),
                               one, rtol=CLI_RTOL)


def test_what_model_gt_1_still_refuses_names_item_4a(ranks):
    """A model extent that does not divide the heads (an audio model's 3
    heads at model 2, a hybrid's 3 Mamba2 heads at model 2, 6 query heads
    at model 4) names item 4a.5.3 (the MoE family and more model ranks
    than KV heads run since: tests/test_torch_tp_moe.py; the vlm and ssm
    families: tests/test_torch_tp_ssm.py; the audio family where model
    divides its heads: tests/test_torch_tp_audio.py; the hybrid family
    where it divides them: tests/test_torch_tp_hybrid.py)."""
    for got in ranks:
        assert sorted(got["refusals"]) == sorted(REFUSED)
        for what, msg in got["refusals"].items():
            assert msg is not None, what
            assert "ROADMAP.md, module item 4a.5.3" in msg, (what, msg)


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
