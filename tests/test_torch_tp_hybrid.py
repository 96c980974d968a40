"""The hybrid family (zamba2) over a model axis: four gloo ranks on the CPU
against the one-process port and JAX.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp_hybrid.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run fp32 zamba2-1.2b-smoke (2 Mamba2 layers, the shared block
applied once) and a 4-layer variant of it (``HYB4``: the shared block
applied twice, so its gradient accumulates over two applications) on
JAX's ``init_params`` carried across through numpy.  Both layouts below
split the packed Mamba2 ``w_in`` (548 columns: x 256, z 256, B and C 16
each, dt 4) and ``conv_w`` (288 channels) off the head boundaries, as
JAX's ``param_spec`` lays them out:

  * (data 2, model 2), two Mamba2 heads and two attention heads a rank:
      - the exact epoch (FSDP x TP) of both configs against JAX's
        global-batch step and the one-process ``data=2`` session, each
        rank's bytes over "data" ``dryrun.rank_fsdp_bytes`` and over
        "model" ``dryrun.rank_model_bytes``;
      - the fp32 gossip epoch of ``HYB4`` against JAX's gossip step and the
        one-process session, each worker's dual gathered from its ranks'
        blocks;
      - the slot engine over the group (``SlotEngine(group=, tp=)``) on
        ``HYB4``: every logits tensor its sampler draws from within
        ``LOGIT_TOL`` of JAX's engine's and of one process's, the tokens
        equal, and each rank's Mamba2 states (h by its heads, the conv
        tail its x channels and B, C) and shared-block KV caches after
        the first decode round its cut of JAX's;
      - a save at model 2 of a restored one-process archive: the same
        archive, leaf for leaf, read by JAX's loader;
      - the serve CLI with a fine-tune session over the ranks;
  * (data 1, model 4), one Mamba2 head and one attention head a rank: the
    exact epoch of both configs against JAX's step (and its bytes the
    dry-run's), and the engine against JAX's.

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
N, M, PER, SEQ = 2, 2, 2, 16
B = [2, 1]                         # the epoch's minibatch sizes
BETA = (50.0, float(N * PER), 200.0)     # the session's schedule
ROUNDS = 1                         # gossip rounds an epoch
HYB, HYB4 = "zamba2-1.2b", "zamba2-4l"
HYB4_KW = dict(name="zamba2-4l-smoke", num_layers=4)
SLOTS, CACHE = 4, 24
# (prompt length, new tokens): six requests over four slots, so that slots
# retire and refill; two lengths (the hybrid prefills at exact length, and
# JAX's engine compiles a prefill for each)
PROMPTS = ((5, 4), (12, 3), (5, 5), (12, 2), (5, 4), (12, 3))
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: TP and FSDP sum in another order
LOGIT_TOL = 1e-5
# name: (arch, consensus) of a (data 2, model 2) session
SESSIONS = {"exact": (HYB, "exact"), "exact4": (HYB4, "exact"),
            "gossip4": (HYB4, "gossip")}
ARCHS = (HYB, HYB4)                # the exact epochs at both layouts
SERVE_ARGV = ["--arch", HYB, "--smoke", "--data", str(N), "--model",
              str(M), "--batch", "4", "--requests", "4", "--prompt-len",
              "12", "--new-tokens", "4", "--finetune", "1",
              "--round-budget", "0.5", "--consensus", "exact",
              "--finetune-seq-len", "16"]


def _variant(configs, arch: str):
    """The fp32 zamba2-1.2b-smoke of either package's ``configs`` (HYB4:
    at 4 layers)."""
    kw = HYB4_KW if arch == HYB4 else {}
    return dataclasses.replace(configs.smoke_config(HYB), dtype="float32",
                               **kw)


def _cfg(arch=HYB):
    from repro_torch import configs
    return _variant(configs, arch)


def _jcfg(arch=HYB):
    from repro import configs as jconfigs
    return _variant(jconfigs, arch)


def _batch(cfg, rows: int, seed: int) -> dict:
    """Tokens and next-token labels, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": np.concatenate(
        [toks[:, 1:], np.full((rows, 1), -1, np.int32)], 1)}


def _torch_batch(batch: dict, rows=None) -> dict:
    out = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if rows is not None:
        out = {k: v[rows] for k, v in out.items()}
    return out


def _session(name, params, mesh=None, model=M, data=N, per=PER):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    arch, consensus = SESSIONS.get(name, (name, "exact"))
    if params is not None:
        params = {k: v.clone() for k, v in params.items()}
    return AMBSession(TrainSpec(smoke=True, data=data, model=model,
                                batch_per_worker=per, seq_len=SEQ),
                      ClockSpec(kind="simulated"),
                      ConsensusSpec(consensus=consensus, graph="ring",
                                    gossip_rounds=ROUNDS),
                      cfg=_cfg(arch), params=params, device="cpu",
                      mesh=mesh)


def _epoch(session, batch: dict, rows=None) -> dict:
    session.state, m = session.protocol.step(
        session.state, _torch_batch(batch, rows), B[:session.n_workers])
    state = session.state
    tree = state["z"] if "z" in state else state["params"]
    out = {"loss": float(m["loss"]),
           "blocks": {k: v.detach().clone() for k, v in tree.items()},
           "whole": session.params}
    if session.tp is not None:
        tp = session.tp
        out["bytes"] = {"gathered_bytes": tp.gathered_bytes,
                        "scattered_bytes": tp.scattered_bytes,
                        "reduced_bytes": tp.reduced_bytes,
                        "model_gathered_bytes": tp.model_gathered_bytes}
    return out


def _requests(vocab: int, pkg=None) -> list:
    """The requests, as ``pkg``'s (default the port's) ``Request``."""
    if pkg is None:
        from repro_torch import serve as pkg
    rng = np.random.default_rng(3)
    return [pkg.Request(rid=i, prompt=[int(t) for t in
                                       rng.integers(0, vocab, plen)],
                        max_new_tokens=new)
            for i, (plen, new) in enumerate(PROMPTS)]


def _caches(caches) -> list:
    """The hybrid's decode caches (the Mamba2 states h and conv tails, the
    shared block's K and V), as numpy copies."""
    return [np.array(t, np.float32) for t in (
        caches["mamba"].h, caches["mamba"].conv, caches["attn"].k,
        caches["attn"].v)]


def _drive(engine, reqs) -> dict:
    """Every request through a slot engine (the port's, or JAX's, whose
    sampler also takes a key): every logits tensor it samples from, the
    tokens, and the caches after the first decode round."""
    seen, sample = [], engine._sample

    def spy(logits, *key):
        seen.append(np.array(logits, np.float32))
        return sample(logits, *key)

    engine._sample = spy
    caches, pending = None, list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()
        if caches is None:
            caches = _caches(engine.state.caches)
    return {"logits": seen, "tokens": [r.out_tokens for r in reqs],
            "caches": caches}


def _engine(params, cfg, mesh=None, coord=None, group=None):
    """A slot engine on ``params`` (whole), or over ``group``: this rank's
    serving blocks."""
    from repro_torch.dist.params import shard_tree
    from repro_torch.dist.tp import TensorParallel
    from repro_torch.serve import SlotEngine
    tp = None
    if group is not None:
        tp = TensorParallel(group, {k: v.shape for k, v in params.items()},
                            None, cfg)
        params = shard_tree(params, mesh, coord, None)
    return SlotEngine(params, cfg, slots=SLOTS, cache_len=CACHE,
                      group=group, tp=tp)


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: the (2, 2) cases, then the (1, 4) cases; results to
    ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import AMBSession
    from repro_torch.dist.group import WorkerGroup
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)
    try:
        ins, batches = torch.load(outdir / "inputs.pt", weights_only=False)
        mesh = make_host_mesh(N, M, device="cpu")
        coord = mesh.get_coordinate()
        group = WorkerGroup(mesh, "cpu")
        w = group.worker
        rows = slice(w * PER, (w + 1) * PER)
        out = {"coord": tuple(int(c) for c in coord), "worker": w,
               "m": group.m}
        for name, (arch, _) in SESSIONS.items():
            out[name] = _epoch(_session(name, ins[arch], mesh),
                               batches[arch], rows)
        out["engine"] = _drive(_engine(ins[HYB4], _cfg(HYB4), mesh, coord,
                                       group), _requests(_cfg().vocab_size))
        session = AMBSession.restore(outdir / "one_exact", cfg=_cfg(HYB4),
                                     device="cpu")
        session.save(outdir / "ranks_exact")
        report = serve.main(SERVE_ARGV, device="cpu")
        out["cli"] = [r.out_tokens for r in report.requests]

        # (data 1, model 4)
        mesh = make_host_mesh(1, 4, device="cpu")
        coord = mesh.get_coordinate()
        group = WorkerGroup(mesh, "cpu")
        out["m4"] = group.m
        for arch in ARCHS:
            out[f"wide_exact_{arch}"] = _epoch(
                _session(arch, ins[arch], mesh, model=4, data=1,
                         per=N * PER), batches[arch])
        out["wide_engine"] = _drive(_engine(ins[HYB4], _cfg(HYB4), mesh,
                                            coord, group),
                                    _requests(_cfg().vocab_size))
        torch.save(out, outdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(tmp_path: Path, world: int = N * M) -> tuple:
    """Start ``world`` ranks of this file; returns (their processes, their
    logs)."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(store), str(r), str(world),
         str(tmp_path)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs, logs


def join(tmp_path: Path, procs: list, logs: list, end: float) -> list:
    """Wait until ``end`` (monotonic) for every rank (then kill every one
    and fail), and return their results."""
    world = len(procs)
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


def _port(jax, jparams, cfg) -> dict:
    from repro_torch import models
    return {k: v.detach() for k, v in models.from_jax_params(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        .params().items()}


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters of both configs, the port's copies of
    them, and a global batch of each."""
    jax = pytest.importorskip("jax")
    from repro import models as jmodels
    jparams, params, batches = {}, {}, {}
    init = jax.jit(jmodels.init_params, static_argnums=1)
    for i, arch in enumerate(ARCHS):
        jparams[arch] = init(jax.random.PRNGKey(8 + i), _jcfg(arch))
        params[arch] = _port(jax, jparams[arch], _cfg(arch))
        batches[arch] = _batch(_cfg(arch), N * PER, 31 + i)
    return jparams, params, batches


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """The ranks, started after the one-process exact session they
    restore (one epoch, saved)."""
    outdir = tmp_path_factory.mktemp("ranks_tp_hybrid")
    _, params, batches = inputs
    torch.save((params, batches), outdir / "inputs.pt")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    session = _session("exact4", params[HYB4])
    session.step(_torch_batch(batches[HYB4]), B)
    session.save(outdir / "one_exact")
    torch.set_num_threads(before)
    procs, logs = start(outdir)
    return procs, logs, outdir, time.monotonic() + JOIN_S


@pytest.fixture(scope="module")
def one_process(inputs, spawned):
    """The one-process port sessions (``data=2``) and engine, while the
    ranks run (one thread)."""
    _, params, batches = inputs
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {name: _epoch(_session(name, params[arch]), batches[arch])
               for name, (arch, _) in SESSIONS.items()}
        out["engine"] = _drive(_engine(params[HYB4], _cfg(HYB4)),
                               _requests(_cfg().vocab_size))
        return out
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_refs(inputs, spawned):
    """JAX's exact and gossip steps and its slot engine on the same
    parameters, batches and requests, while the ranks run."""
    jax = pytest.importorskip("jax")
    from repro import serve as jserve
    jparams, _, batches = inputs
    out = {}
    for arch in ARCHS:
        for w in (N, 1):
            out[arch, "exact", w] = _jax_exact(jax, arch, jparams[arch],
                                               batches[arch], w)
    out[HYB4, "gossip", N] = _jax_gossip(jax, HYB4, jparams[HYB4],
                                         batches[HYB4], N)
    engine = jserve.SlotEngine(jparams[HYB4], _jcfg(HYB4), slots=SLOTS,
                               cache_len=CACHE)
    out["engine"] = _drive(engine, _requests(_cfg().vocab_size, jserve))
    return out


@pytest.fixture(scope="module")
def ranks(spawned, one_process, jax_refs):
    procs, logs, outdir, end = spawned
    return join(outdir, procs, logs, end)


def _within(got: dict, want: dict, rtol: float, what: str) -> None:
    """Leafwise: max |got - want| <= rtol * max |want| (at least rtol)."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = w.detach().float()
        err = float((got[k].detach().float() - w).abs().max())
        assert err <= rtol * max(1.0, float(w.abs().max())), (what, k, err)


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(want).max())), (what,
                                                                     err)


def _mesh(shape=(N, M)):
    from repro_torch.launch.mesh import abstract
    return abstract(shape, ("data", "model"))


def _standin(data: int):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": data, "model": 1})


def _jax_exact(jax, arch, jparams, batch, workers=N) -> tuple:
    """JAX's global-batch exact step: (loss, the port's parameters)."""
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.optim import DualAveragingOpt as JDualAveraging
    jopt = JDualAveraging(beta=JBeta(*BETA))
    step = jax.jit(jamb.make_train_step(_jcfg(arch), jopt, _standin(workers)))
    p, _, m = step(jparams, jopt.init(jparams),
                   {k: jnp.asarray(v) for k, v in batch.items()},
                   jnp.asarray(B[:workers], jnp.int32))
    return float(m["loss"]), _port(jax, p, _cfg(arch))


def _jax_gossip(jax, arch, jparams, batch, workers=N) -> tuple:
    """JAX's gossip step (ring, ROUNDS rounds): (loss, the port's primal,
    each worker's dual)."""
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    cfg = jamb.AMBConfig(consensus="gossip", gossip_rounds=ROUNDS,
                         graph="ring", beta=JBeta(*BETA))
    _, gstep = jamb.make_gossip_train_step(_jcfg(arch), _standin(workers),
                                           cfg)
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((workers,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    state, m = jax.jit(gstep)(state,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(B[:workers], jnp.int32))
    duals = [_port(jax, jax.tree.map(lambda v: v[i], state["z"]), _cfg(arch))
             for i in range(workers)]
    return (float(m["loss"]), _port(jax, jamb.gossip_primal(state, cfg),
                                    _cfg(arch)), duals)


def _worker_dual(ranks, name: str, worker: int, shapes: dict,
                 mesh) -> dict:
    """A worker's dual gathered from its model ranks' blocks."""
    from repro_torch.dist import params as P
    rows = {got["coord"]: {k: v[0] for k, v in got[name]["blocks"].items()}
            for got in ranks if got["worker"] == worker}
    assert len(rows) == mesh.shape["model"]
    return P.gather_tree(rows, mesh, shapes, None)


def _engine_matches(got: dict, want: dict, what: str) -> None:
    """Tokens equal; every logits tensor the sampler drew from within
    LOGIT_TOL."""
    assert got["tokens"] == want["tokens"], what
    assert len(got["logits"]) == len(want["logits"]), what
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, f"{what} draw {i}")


def _rank_cut(want: list, rows: slice, m: int, model: int) -> list:
    """JAX's hybrid caches (h, conv, k, v) cut to slot rows ``rows`` and
    model rank ``m`` of ``model``: its Mamba2 heads of h, its heads' x
    channels and B, C of the conv tail (JAX's state lays the 288 channels
    out contiguously), its KV heads of the shared block's caches."""
    cfg = _cfg(HYB4)
    h, conv, k, v = (w[:, rows] for w in want)
    d_in, ns = 2 * cfg.d_model, cfg.ssm_state
    per_h, per_c = h.shape[2] // model, d_in // model
    per_kv = k.shape[3] // model
    return [h[:, :, m * per_h:(m + 1) * per_h],
            np.concatenate([conv[..., m * per_c:(m + 1) * per_c],
                            conv[..., d_in:d_in + 2 * ns]], -1),
            k[:, :, :, m * per_kv:(m + 1) * per_kv],
            v[:, :, :, m * per_kv:(m + 1) * per_kv]]


# ---------------------------------------------------------------------------
# without ranks: the plan, the layout, the dry-run
# ---------------------------------------------------------------------------

def test_hybrid_plan_draws_init_params_and_names_every_leaf():
    """``param_plan`` covers the hybrid: its 20 leaves in ``init_params``'
    order of draws (the head, ``ln1``, the Mamba2 leaves, the shared block
    drawn as a one-layer dense block and cut to its layer)."""
    from repro_torch import models
    from repro_torch.models.model import param_plan
    cfg = _cfg()
    gen = torch.Generator().manual_seed(9)
    plan = {k: make(gen) for k, make in param_plan(cfg)}
    tree = models.init_params(cfg, torch.Generator().manual_seed(9))
    assert sorted(plan) == sorted(tree) and len(tree) == 20
    for k, v in tree.items():
        assert torch.equal(plan[k], v), k
    assert plan["shared_attn.attn.wq"].dim() == 2
    assert plan["blocks.mamba.w_in"].shape == (cfg.num_layers, 128, 548)


@pytest.mark.parametrize("model", [2, 4])
def test_mamba_leaves_cut_a_rank_s_heads_off_jax_s_column_blocks(model):
    """JAX's blocks of ``w_in`` and ``conv_w`` do not follow the heads
    (at model 2 rank 0's 274 columns of ``w_in`` are x's 256 and 18 of
    z); a rank's cut of the whole leaves is its x, z and dt columns and B,
    C whole, and ``conv_w``'s its x channels and B, C."""
    from repro_torch import models
    from repro_torch.dist import params as P
    from repro_torch.models.ssm import mamba2_rank_leaves
    cfg = _cfg()
    tree = models.init_params(cfg, torch.Generator().manual_seed(5))
    mesh = _mesh((1, model))
    w_in = tree["blocks.mamba.w_in"]
    assert P.param_spec("blocks.mamba.w_in", w_in.shape, mesh) == (
        None, None, "model")
    assert (w_in.shape[-1] // model) % 64       # off the head boundaries
    layer = {k[len("blocks.mamba."):]: v[0] for k, v in tree.items()
             if k.startswith("blocks.mamba.")}
    c, h = 256 // model, 4 // model
    for r in range(model):
        cut = mamba2_rank_leaves(layer, r, model)
        w, cw = layer["w_in"], layer["conv_w"]
        assert torch.equal(cut["w_in"], torch.cat([
            w[:, r * c:(r + 1) * c], w[:, 256 + r * c:256 + (r + 1) * c],
            w[:, 512:544], w[:, 544 + r * h:544 + (r + 1) * h]], -1))
        assert torch.equal(cut["conv_w"], torch.cat(
            [cw[:, r * c:(r + 1) * c], cw[:, 256:]], -1))
        assert torch.equal(cut["norm_z"], layer["norm_z"][r * c:(r + 1) * c])
        assert torch.equal(cut["a_log"], layer["a_log"][r * h:(r + 1) * h])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_counts_the_hybrid_model_collectives(kind):
    """The dry-run's "model" collectives for the hybrid are the port's: a
    Mamba2 layer's w_out sum and its norm's gathered sums of squares
    (training: the gather again in the recompute, which stops before the
    sum), a training step's gathers of the packed leaves (twice a layer)
    and the backward's sums (the packed leaves', the four small leaves',
    the input's and the squares'); each shared application a dense
    block's two sums (training: five); the lookup once, and in training
    the logits' input.  None at model 1."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    cfg = _cfg(HYB4)
    seq = 1 if kind == "decode" else SEQ
    train = kind == "train"
    coll = dryrun._layout(cfg, InputShape("t", seq, PER, kind),
                          _mesh((1, M)))["collectives"]
    layers, apps = cfg.num_layers, cfg.num_layers // cfg.attn_every
    sums = layers * (1 + train * 8) + apps * (2 + train * 3) + 1 + train
    assert coll["all-reduce"]["count"] == sums
    fwd = 1 + train
    assert coll["all-gather"]["count"] == layers * fwd * (1 + 2 * train)
    # one call's bytes of each distinct gather: the sums of squares', and
    # in training a layer's fp32 w_in and conv_w
    tokens = PER * seq
    assert coll["all-gather"]["bytes"] == 4 * tokens * M + train * 4 * (
        128 * 548 + 4 * 288)
    assert dryrun._layout(cfg, InputShape("t", seq, PER, kind),
                          _mesh((1, 1)))["collectives"]["all-reduce"][
                              "count"] == 0


# ---------------------------------------------------------------------------
# (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["exact", "exact4"])
def test_exact_epoch_matches_jax(ranks, jax_refs, name):
    """JAX's global-batch exact step over the same 2 workers (a stand-in
    mesh): the loss and the parameters within EXACT_RTOL on every rank;
    the 4-layer variant's shared block applied twice."""
    arch = SESSIONS[name][0]
    loss, want = jax_refs[arch, "exact", N]
    for got in ranks:
        np.testing.assert_allclose(got[name]["loss"], loss, rtol=EXACT_RTOL)
        _within(got[name]["whole"], want, EXACT_RTOL, f"{name} against jax")


def test_gossip_epoch_matches_jax(ranks, jax_refs):
    """JAX's gossip step over the same 2 workers: the loss, the primal and
    each worker's dual (gathered from its model ranks' blocks) within
    EXACT_RTOL."""
    loss, primal, duals = jax_refs[HYB4, "gossip", N]
    for got in ranks:
        np.testing.assert_allclose(got["gossip4"]["loss"], loss,
                                   rtol=EXACT_RTOL)
        _within(got["gossip4"]["whole"], primal, EXACT_RTOL, "primal")
    shapes = {k: v.shape for k, v in duals[0].items()}
    for i in range(N):
        _within(_worker_dual(ranks, "gossip4", i, shapes, _mesh()),
                duals[i], EXACT_RTOL, f"z worker {i}")


@pytest.mark.parametrize("name", list(SESSIONS))
def test_sessions_match_the_one_process_session(ranks, one_process, name):
    """The loss and the primal within EXACT_RTOL of the one-process
    ``data=2`` session; the exact epochs' bytes over "data" and "model"
    the dry-run's, the gossip epoch's none over "data"; each gossip
    worker's dual within EXACT_RTOL of its row."""
    from repro_torch.launch import dryrun
    want = one_process[name]
    arch, consensus = SESSIONS[name]
    held = dict(dryrun.rank_fsdp_bytes(_cfg(arch), _mesh()),
                **dryrun.rank_model_bytes(_cfg(arch), _mesh(), PER * SEQ))
    for got in ranks:
        res = got[name]
        np.testing.assert_allclose(res["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
        _within(res["whole"], want["whole"], EXACT_RTOL, name)
        if consensus == "exact":
            assert res["bytes"] == held, (res["bytes"], held)
        else:
            assert res["bytes"]["gathered_bytes"] == 0
            assert res["bytes"]["scattered_bytes"] == 0
    if consensus == "gossip":
        shapes = {k: v.shape[1:] for k, v in want["blocks"].items()}
        for i in range(N):
            _within(_worker_dual(ranks, name, i, shapes, _mesh()),
                    {k: v[i] for k, v in want["blocks"].items()},
                    EXACT_RTOL, f"{name} z worker {i}")


@pytest.mark.parametrize("against", ["port", "jax"])
def test_engine_matches_one_process(ranks, one_process, jax_refs, against):
    """The slot engine over (data 2, model 2), each worker prefilling the
    requests of its slots: every logits tensor the sampler draws from
    within LOGIT_TOL of JAX's engine's and of the one-process engine's,
    the greedy tokens equal."""
    want = jax_refs["engine"] if against == "jax" else one_process["engine"]
    for got in ranks:
        _engine_matches(got["engine"], want,
                        f"rank {got['coord']} against {against}")


def test_each_rank_holds_its_heads_states(ranks, jax_refs):
    """After the first decode round each rank's Mamba2 states are its cut
    of JAX's for its worker's slot rows: h its heads, the conv tail its
    heads' x channels and B, C; and the shared block's K and V its KV
    heads; within LOGIT_TOL."""
    want = jax_refs["engine"]["caches"]
    per = SLOTS // N
    for got in ranks:
        rows = slice(got["worker"] * per, (got["worker"] + 1) * per)
        cut = _rank_cut(want, rows, got["m"], M)
        for i, (g, w) in enumerate(zip(got["engine"]["caches"], cut)):
            _close(g, w, f"cache {i} rank {got['coord']}")


def test_a_hybrid_save_at_model_2_is_the_one_process_archive(ranks,
                                                             spawned):
    """The one-process archive restored into the ranks and saved again:
    JAX's loader reads the same whole leaves from both, bit for bit (the
    packed Mamba2 leaves and the shared block's among them)."""
    jax = pytest.importorskip("jax")
    from repro.ckpt import checkpoint as jckpt
    outdir = spawned[2]
    for sub in ("", "session_state"):
        one, again = outdir / "one_exact" / sub, outdir / "ranks_exact" / sub
        data = np.load(one / "step_00000001" / "arrays.npz")
        tree: dict = {}
        for key in data.files:
            *parts, leaf = key.split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = np.zeros(data[key].shape, np.float32)
        assert any("mamba/w_in" in k for k in data.files)
        assert any("shared_attn/attn/wq" in k for k in data.files)
        a = jckpt.load_checkpoint(one, 1, tree)
        b = jckpt.load_checkpoint(again, 1, tree)
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(path))


def test_the_serve_cli_serves_zamba2_over_the_ranks(ranks):
    """``--arch zamba2-1.2b --smoke --data 2 --model 2`` with a fine-tune
    session: every request served its new tokens, the same on every
    rank."""
    new = int(SERVE_ARGV[SERVE_ARGV.index("--new-tokens") + 1])
    cli = ranks[0]["cli"]
    assert len(cli) == 4 and all(len(t) == new for t in cli)
    assert all(got["cli"] == cli for got in ranks)


# ---------------------------------------------------------------------------
# (data 1, model 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_wide_exact_epoch_matches_jax(ranks, jax_refs, arch):
    """JAX's exact step at data 1 on the same parameters and batch, one
    Mamba2 head and one attention head a rank (w_in's 137 columns a
    block): the loss and the parameters within EXACT_RTOL on every rank,
    its bytes over "model" the dry-run's."""
    from repro_torch.launch import dryrun
    loss, want = jax_refs[arch, "exact", 1]
    held = dryrun.rank_model_bytes(_cfg(arch), _mesh((1, 4)),
                                   N * PER * SEQ)
    for got in ranks:
        res = got[f"wide_exact_{arch}"]
        np.testing.assert_allclose(res["loss"], loss, rtol=EXACT_RTOL)
        _within(res["whole"], want, EXACT_RTOL, f"{arch} wide exact")
        assert {k: res["bytes"][k] for k in held} == held
        assert res["bytes"]["gathered_bytes"] == 0


def test_wide_engine_matches_jax(ranks, jax_refs):
    """The engine over four model ranks, one Mamba2 head each: every
    logits tensor within LOGIT_TOL of JAX's, the tokens equal, each
    rank's states its cut of JAX's."""
    want = jax_refs["engine"]
    for got in ranks:
        assert got["m4"] in range(4)
        res = got["wide_engine"]
        _engine_matches(res, want, f"wide rank {got['m4']}")
        for i, (g, w) in enumerate(zip(res["caches"], _rank_cut(
                want["caches"], slice(0, SLOTS), got["m4"], 4))):
            _close(g, w, f"wide cache {i} rank {got['m4']}")


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
