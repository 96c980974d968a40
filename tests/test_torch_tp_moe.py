"""The MoE family over a model axis, and more model ranks than KV heads:
four gloo ranks on the CPU against the one-process port and JAX.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp_moe.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run at the fp32 smoke configs on the parent's parameters
(JAX's ``init_params``, carried across through numpy):

  * (data 2, model 2), qwen3-moe-30b-a3b-smoke (E 4, top 2, seq 64), the
    experts on "model" (two a rank):
      - one ``moe_forward`` layer and its gradient on each rank's blocks,
        for both MoE configs (phi3.5-moe too), at a capacity that drops
        assignments: the output, the load-balance loss and every gradient
        block within ``EXACT_RTOL`` of one process;
      - the exact epoch (FSDP x TP): loss, aux and parameters within
        ``EXACT_RTOL`` of JAX's global-batch step and of the one-process
        ``data=2`` session;
      - the gossip epoch (TP) against JAX's gossip step: loss, primal
        and each worker's dual within ``EXACT_RTOL``;
      - the gossip, gossip_q8 and gossip_q4 epochs (TP) against the
        one-process session on the same draws (losses to ``EXACT_RTOL``;
        fp32 duals within it, quantized dual stacks within
        ``STACK_RTOL``), and phi3.5-moe's exact and gossip_q4 epochs;
      - the slot engine at capacity factor 0.5, so that a decode round's
        experts (capacity 1 over the four slots) drop assignments: every
        logits tensor it samples from within ``LOGIT_TOL`` of JAX's
        ``SlotEngine`` and of the one-process engine, the greedy tokens
        equal (a decode round's MoE input is gathered over "data" and
        dispatched as one group);
      - checkpoints (exact, gossip): a one-process save restored into the
        ranks and saved again is the same archive, leaf for leaf, read by
        JAX's loader, and restores in one process bit for bit;
  * (data 1, model 4), qwen2-1.5b-smoke (H 4, KV 2): each rank one query
    head and half of a KV head's columns, gathered over the two ranks
    that share it:
      - the exact epoch against JAX's step;
      - the slot engine against JAX's and the one-process engine; the two
        ranks that share a KV head hold equal caches, each within
        ``LOGIT_TOL`` of that head of the one-process cache.

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
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N, M, PER, SEQ = 2, 2, 2, 64
B = [2, 1]                         # the epoch's minibatch sizes
BETA = (50.0, float(N * PER), 200.0)     # the session's schedule
ROUNDS = 1                         # gossip rounds an epoch
SLOTS, CACHE = 4, 24
PROMPTS = ((5, 4), (9, 3), (12, 5), (7, 2), (14, 4), (3, 3))
DROP_CF = 0.5           # capacity factor: a decode round's capacity is 1
MOE = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
KV_PER, KV_SEQ = 4, 16             # the (data 1, model 4) exact batch
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: TP and FSDP sum in another order
LOGIT_TOL = 1e-5
STACK_RTOL = 1e-2       # a quantized dual stack (tests/test_torch_tp_quantized)
SESSIONS = ("exact", "gossip", "gossip_q8", "gossip_q4", "phi_exact",
            "phi_gossip_q4")


def _cfg(arch=MOE[0], **kw):
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config(arch), dtype="float32",
                               **kw)


def _jcfg(arch=MOE[0], **kw):
    from repro import configs as jconfigs
    return dataclasses.replace(jconfigs.smoke_config(arch), dtype="float32",
                               **kw)


def _batch(vocab: int, rows: int, seq: int, seed: int) -> dict:
    """Tokens and next-token labels (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int32)],
                            1)
    return {"tokens": toks, "labels": labels}


def _torch_batch(batch: dict, rows=None) -> dict:
    out = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if rows is not None:
        out = {k: v[rows] for k, v in out.items()}
    return out


def draw_source(tag, epoch):
    """Rounding draws from a seed: round k's (N, W + 1) stack, or its
    ``rows``; the same on every rank and in one process."""
    def draws(k, out, rows=None):
        rng = np.random.default_rng([zlib.crc32(str(tag).encode()),
                                     int(epoch), int(k)])
        full = torch.from_numpy(rng.random((N, out.shape[1]),
                                           dtype=np.float32))
        return out.copy_(full if rows is None else full[list(rows)])
    return draws


def _session(consensus, params, mesh=None, cfg=None, model=M, data=N,
             per=PER, seq=SEQ):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    if params is not None:
        params = {k: v.clone() for k, v in params.items()}
    return AMBSession(TrainSpec(smoke=True, data=data, model=model,
                                batch_per_worker=per, seq_len=seq),
                      ClockSpec(kind="simulated"),
                      ConsensusSpec(consensus=consensus, graph="ring",
                                    gossip_rounds=ROUNDS),
                      cfg=cfg or _cfg(), params=params, device="cpu",
                      mesh=mesh, draw_source=draw_source)


def _which(name: str) -> tuple:
    """A SESSIONS case's (arch, consensus): ``phi_`` names phi3.5-moe."""
    if name.startswith("phi_"):
        return MOE[1], name[len("phi_"):]
    return MOE[0], name


def _epoch(session, batch: dict, rows=None) -> dict:
    """One epoch through the protocol (its metrics carry ``aux``)."""
    session.state, m = session.protocol.step(
        session.state, _torch_batch(batch, rows), B[:session.n_workers])
    state = session.state
    tree = state["z"] if "z" in state else state["params"]
    return {"loss": float(m["loss"]),
            "aux": float(m["aux"]) if "aux" in m else None,
            "blocks": {k: v.detach().clone() for k, v in tree.items()},
            "whole": session.params}


def _requests(vocab: int) -> list:
    from repro_torch.serve import Request
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                                 plen)],
                    max_new_tokens=new)
            for i, (plen, new) in enumerate(PROMPTS)]


def _drive(engine, reqs) -> dict:
    """Every request through the engine: every logits tensor it samples
    from, the tokens, and the caches after the first decode round."""
    seen, sample = [], engine._sample

    def spy(logits):
        seen.append(logits.detach().clone())
        return sample(logits)

    engine._sample = spy
    caches, pending = None, list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()
        if caches is None:
            caches = (engine.state.caches.k.clone(),
                      engine.state.caches.v.clone())
    return {"logits": seen, "tokens": [r.out_tokens for r in reqs],
            "caches": caches}


def _layer(cfg, params: dict, x, ct, tp=None) -> dict:
    """One ``moe_forward`` on layer 0 of ``params`` (this rank's blocks
    with ``tp``): the output, aux, and the gradients of x and of the
    MoE leaves under ``sum(out * ct) + 3 aux``."""
    from repro_torch.models.moe import moe_forward
    leaves = {k.split(".")[-1]: v[0].clone().requires_grad_()
              for k, v in params.items() if ".moe." in k}
    x = x.clone().requires_grad_()
    out, aux = moe_forward(leaves, x, cfg, tp=tp)
    (out * ct).sum().add(3 * aux).backward()
    return {"out": out.detach(), "aux": float(aux.detach()), "dx": x.grad,
            "grads": {k: v.grad for k, v in leaves.items()}}


def _layer_inputs(cfg):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model),
                                             dtype=np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model),
                                              dtype=np.float32))
    return x, ct


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: the (2, 2) MoE cases, then the (1, 4) cases; results to
    ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import AMBSession
    from repro_torch.dist.group import WorkerGroup
    from repro_torch.dist.params import shard_tree
    from repro_torch.dist.tp import TensorParallel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import SlotEngine
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)
    try:
        ins = torch.load(outdir / "inputs.pt")
        batch = np.load(outdir / "batch.npz")
        batch = {k: batch[k] for k in batch.files}
        mesh = make_host_mesh(N, M, device="cpu")
        coord = mesh.get_coordinate()
        group = WorkerGroup(mesh, "cpu")
        w = group.worker
        rows = slice(w * PER, (w + 1) * PER)
        out = {"coord": tuple(int(c) for c in coord), "worker": w}

        # one layer and its gradient, both MoE configs
        for arch in MOE:
            cfg = _cfg(arch, capacity_factor=DROP_CF)
            params = ins[arch]
            tp = TensorParallel(group, {k: v.shape for k, v in
                                        params.items()}, None, cfg)
            x, ct = _layer_inputs(cfg)
            res = _layer(cfg, shard_tree(params, mesh, coord, None), x, ct,
                         tp)
            res["experts"] = tp.expert_range(cfg)
            out[f"layer_{arch}"] = res

        # the sessions
        for name in SESSIONS:
            arch, consensus = _which(name)
            session = _session(consensus, ins[arch], mesh, cfg=_cfg(arch))
            res = _epoch(session, batch, rows)
            res["tp_bytes"] = (session.tp.gathered_bytes,
                               session.tp.scattered_bytes)
            res["experts"] = session.tp.expert_range(session.cfg)
            out[name] = res

        # the slot engine, at a capacity that drops
        cfg = _cfg(capacity_factor=DROP_CF)
        tp = TensorParallel(group, {k: v.shape for k, v in
                                    ins[MOE[0]].items()}, None, cfg)
        engine = SlotEngine(shard_tree(ins[MOE[0]], mesh, coord, None), cfg,
                            slots=SLOTS, cache_len=CACHE, group=group, tp=tp)
        out["engine"] = _drive(engine, _requests(cfg.vocab_size))

        # checkpoints: the one-process archive into the ranks and back
        for kind in ("exact", "gossip"):
            session = AMBSession.restore(outdir / f"one_{kind}", cfg=_cfg(),
                                         device="cpu")
            session.save(outdir / f"ranks_{kind}")

        # (data 1, model 4): a KV head over two ranks
        mesh = make_host_mesh(1, 4, device="cpu")
        coord = mesh.get_coordinate()
        dense = _cfg("qwen2-1.5b")
        kvb = _batch(dense.vocab_size, KV_PER, KV_SEQ, 12)
        session = _session("exact", ins["qwen2-1.5b"], mesh, cfg=dense,
                           model=4, data=1, per=KV_PER, seq=KV_SEQ)
        out["kv_exact"] = _epoch(session, kvb)
        out["kv_exact"]["kv_share"] = session.tp.kv_share
        group = WorkerGroup(mesh, "cpu")
        tp = TensorParallel(group, {k: v.shape for k, v in
                                    ins["qwen2-1.5b"].items()}, None, dense)
        engine = SlotEngine(shard_tree(ins["qwen2-1.5b"], mesh, coord,
                                       None), dense, slots=SLOTS,
                            cache_len=CACHE, group=group, tp=tp)
        out["kv_engine"] = _drive(engine, _requests(dense.vocab_size))
        out["kv_engine"]["gathered"] = tp.model_gathered_bytes
        out["kv_m"] = group.m
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


def _port(jax, jparams, cfg) -> dict:
    from repro_torch import models
    return {k: v.detach() for k, v in models.from_jax_params(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        .params().items()}


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters of each fp32 smoke config and the port's
    copies of them; the MoE batch."""
    jax = pytest.importorskip("jax")
    from repro import models as jmodels
    jparams, params = {}, {}
    for i, arch in enumerate(MOE + ("qwen2-1.5b",)):
        jparams[arch] = jmodels.init_params(jax.random.PRNGKey(4 + i),
                                            _jcfg(arch))
        params[arch] = _port(jax, jparams[arch], _cfg(arch))
    return jparams, params, _batch(_cfg().vocab_size, N * PER, SEQ, 11)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """The one-process sessions the ranks restore (one epoch each, saved),
    then the ranks."""
    outdir = tmp_path_factory.mktemp("ranks_tp_moe")
    _, params, batch = inputs
    torch.save(params, outdir / "inputs.pt")
    np.savez(outdir / "batch.npz", **batch)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kind in ("exact", "gossip"):
            session = _session(kind, params[MOE[0]])
            session.step(_torch_batch(batch), B)
            session.save(outdir / f"one_{kind}")
    finally:
        torch.set_num_threads(before)
    return spawn(outdir), outdir


@pytest.fixture
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process ``data=2`` port sessions (one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, params, batch = inputs
        out = {}
        for name in SESSIONS:
            arch, consensus = _which(name)
            out[name] = _epoch(_session(consensus, params[arch],
                                        cfg=_cfg(arch)), batch)
        return out
    finally:
        torch.set_num_threads(before)


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


# ---------------------------------------------------------------------------
# (data 2, model 2): the experts on "model"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, shape, per_token", [
    (MOE[0], (1, 2), lambda cfg: cfg.num_experts * 4),
    ("qwen2-1.5b", (1, 4), lambda cfg: 2 * cfg.hd * 2)])
def test_dry_run_counts_the_router_and_kv_gathers(arch, shape, per_token):
    """At data 1 no leaf lies on "data", so a training step's all-gathers
    are the model axis's own, two a layer (the forward and the
    checkpointed block's recompute): the router's fp32 logits over E, or
    a shared KV head's bf16 k and v columns; one fp32 all-reduce a layer
    each for the backward (the dry-run's record keeps one call's result
    bytes beside the count of calls).  At model 1 there are none."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    cfg = configs_smoke(arch)
    step = InputShape("t", 16, 2, "train")
    tokens = 2 * 16
    coll = dryrun._layout(cfg, step, _mesh(shape))["collectives"]
    assert coll["all-gather"]["count"] == 2 * cfg.num_layers
    assert coll["all-gather"]["bytes"] == tokens * per_token(cfg)
    assert coll["reduce-scatter"]["count"] == 0
    assert dryrun._layout(cfg, step, _mesh((1, 1)))["collectives"][
        "all-gather"]["count"] == 0


def configs_smoke(arch):
    from repro_torch import configs
    return configs.smoke_config(arch)


@pytest.mark.parametrize("fsdp", ["data", None])
@pytest.mark.parametrize("arch", MOE)
def test_moe_init_shards_are_slices_of_init_params_bit_for_bit(arch, fsdp):
    """Each coordinate's blocks (an expert leaf kept a layer at a time as
    it is drawn) equal its slices of ``init_params`` bit for bit, the
    experts split over "model" (the router by its columns)."""
    from repro_torch import configs, models
    from repro_torch.dist import params as P
    cfg = configs.smoke_config(arch)
    tree = models.init_params(cfg, torch.Generator().manual_seed(5))
    mesh = _mesh()
    assert P.param_spec("blocks.moe.w_gate", tree["blocks.moe.w_gate"].shape,
                        mesh, fsdp) == (None, "model", fsdp, None)
    assert P.param_spec("blocks.moe.router", tree["blocks.moe.router"].shape,
                        mesh, fsdp) == (None, fsdp, "model")
    for c in np.ndindex(N, M):
        got = P.init_shards(cfg, torch.Generator().manual_seed(5), mesh, c,
                            fsdp)
        want = P.shard_tree(tree, mesh, c, fsdp)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (c, k)


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_over_ranks_matches_one_process(ranks, inputs, arch):
    """Each rank's output, aux and gradient blocks (x whole; the router's
    columns and the experts of its range) within EXACT_RTOL of one
    process, at a capacity that drops assignments."""
    from repro_torch.dist import params as P
    from repro_torch.models.moe import capacity
    cfg = _cfg(arch, capacity_factor=DROP_CF)
    params = inputs[1][arch]
    x, ct = _layer_inputs(cfg)
    want = _layer(cfg, params, x, ct)
    assert capacity(cfg, SEQ) * cfg.num_experts < SEQ * \
        cfg.experts_per_token                         # drops happen
    mesh = _mesh()
    for got in ranks:
        res = got[f"layer_{arch}"]
        e = cfg.num_experts // M
        assert res["experts"] == (got["coord"][1] * e,
                                  (got["coord"][1] + 1) * e)
        np.testing.assert_allclose(res["aux"], want["aux"], rtol=EXACT_RTOL)
        _within({"out": res["out"], "dx": res["dx"]},
                {"out": want["out"], "dx": want["dx"]}, EXACT_RTOL, arch)
        for k, g in want["grads"].items():
            name = f"blocks.moe.{k}"
            shape = (1,) + tuple(g.shape)
            spec = P.param_spec(name, shape, mesh, None)
            block = P.shard_leaf(g[None], spec, mesh, got["coord"])[0]
            _within({k: res["grads"][k]}, {k: block}, EXACT_RTOL, arch)


def test_moe_exact_epoch_matches_jax(ranks, inputs):
    """JAX's global-batch exact step over the same 2 workers (a stand-in
    mesh): the loss, aux and parameters within EXACT_RTOL on every
    rank."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.optim import DualAveragingOpt as JDualAveraging
    jparams, _, batch = inputs
    jopt = JDualAveraging(beta=JBeta(*BETA))
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    step = jax.jit(jamb.make_train_step(_jcfg(), jopt, standin))
    p, _, m = step(jparams[MOE[0]], jopt.init(jparams[MOE[0]]),
                   {k: jnp.asarray(v) for k, v in batch.items()},
                   jnp.asarray(B, jnp.int32))
    want = _port(jax, p, _cfg())
    for got in ranks:
        res = got["exact"]
        np.testing.assert_allclose(res["loss"], float(m["loss"]),
                                   rtol=EXACT_RTOL)
        np.testing.assert_allclose(res["aux"], float(m["aux"]),
                                   rtol=EXACT_RTOL)
        _within(res["whole"], want, EXACT_RTOL, "exact vs jax")


def test_moe_gossip_epoch_matches_jax(ranks, inputs):
    """JAX's gossip step (ring, ROUNDS rounds, ``loss + 0.01 aux`` at each
    worker's primal) over the same 2 workers on the same batch: the loss,
    the primal and each worker's dual (gathered from its model ranks'
    blocks) within EXACT_RTOL on every rank."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro_torch.dist import params as P
    jparams, _, batch = inputs
    jp = jparams[MOE[0]]
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": N, "model": 1})
    jamb_cfg = jamb.AMBConfig(consensus="gossip", gossip_rounds=ROUNDS,
                              graph="ring", beta=JBeta(*BETA))
    _, gstep = jamb.make_gossip_train_step(_jcfg(), standin, jamb_cfg)
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jp),
        "w0": jp, "t": jnp.zeros((), jnp.int32)}
    state, m = jax.jit(gstep)(state,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(B, jnp.int32))
    want = _port(jax, jamb.gossip_primal(state, jamb_cfg), _cfg())
    for got in ranks:
        np.testing.assert_allclose(got["gossip"]["loss"], float(m["loss"]),
                                   rtol=EXACT_RTOL)
        _within(got["gossip"]["whole"], want, EXACT_RTOL,
                "gossip primal vs jax")
    mesh = _mesh()
    for i in range(N):
        zi = _port(jax, jax.tree.map(lambda v: v[i], state["z"]), _cfg())
        rows = {got["coord"]: {k: v[0] for k, v in
                               got["gossip"]["blocks"].items()}
                for got in ranks if got["worker"] == i}
        assert len(rows) == M
        z = P.gather_tree(rows, mesh, {k: v.shape for k, v in zi.items()},
                          None)
        _within(z, zi, EXACT_RTOL, f"gossip z worker {i} vs jax")


@pytest.mark.parametrize("name", SESSIONS)
def test_moe_sessions_match_the_one_process_session(ranks, one_process,
                                                    name):
    """The loss (and exact aux) within EXACT_RTOL on every rank; the
    primal within EXACT_RTOL (quantized: each worker's dual, gathered
    from its model ranks' blocks, within STACK_RTOL of the stack)."""
    from repro_torch.dist import params as P
    want = one_process[name]
    for got in ranks:
        res = got[name]
        np.testing.assert_allclose(res["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
        if want["aux"] is not None:
            np.testing.assert_allclose(res["aux"], want["aux"],
                                       rtol=EXACT_RTOL)
        assert res["experts"][1] - res["experts"][0] == \
            _cfg(_which(name)[0]).num_experts // M
        if "gossip_q" not in name:
            _within(res["whole"], want["whole"], EXACT_RTOL, name)
        assert res["tp_bytes"][0] > 0 if "exact" in name \
            else res["tp_bytes"] == (0, 0)
    if "gossip" not in name:
        return
    mesh = _mesh()
    shapes = {k: v.shape[1:] for k, v in want["blocks"].items()}
    num = den = 0.0
    for i in range(N):
        rows = {got["coord"]: {k: v[0] for k, v in got[name]["blocks"]
                               .items()}
                for got in ranks if got["worker"] == i}
        assert len(rows) == M
        z = P.gather_tree(rows, mesh, shapes, None)
        zi = {k: v[i] for k, v in want["blocks"].items()}
        if "gossip_q" not in name:
            _within(z, zi, EXACT_RTOL, f"{name} z worker {i}")
        for k, v in zi.items():
            num += float(((z[k] - v) ** 2).sum())
            den += float((v ** 2).sum())
    assert num <= STACK_RTOL ** 2 * den, (name, num, den)


@pytest.fixture(scope="module")
def engines(inputs):
    """JAX's one-process ``SlotEngine`` and the port's, at DROP_CF: every
    logits array their samplers draw from, and the tokens."""
    from repro import serve as jserve
    from repro_torch.serve import SlotEngine
    jparams, params, _ = inputs
    out = {}
    for arch in (MOE[0], "qwen2-1.5b"):
        kw = {} if arch == "qwen2-1.5b" else {"capacity_factor": DROP_CF}
        port = SlotEngine(params[arch], _cfg(arch, **kw), slots=SLOTS,
                          cache_len=CACHE)
        one = _drive(port, _requests(_cfg(arch).vocab_size))
        engine = jserve.SlotEngine(jparams[arch], _jcfg(arch, **kw),
                                   slots=SLOTS, cache_len=CACHE)
        seen, sample = [], engine._sample

        def spy(logits, key, seen=seen, sample=sample):
            seen.append(np.asarray(logits))
            return sample(logits, key)

        engine._sample = spy
        reqs = [jserve.Request(rid=r.rid, prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens)
                for r in _requests(_cfg(arch).vocab_size)]
        pending = list(reqs)
        while pending or engine.active_count:
            while pending and engine.has_free:
                engine.insert(pending.pop(0))
            engine.decode_round()
        out[arch] = {"port": one,
                     "jax": {"logits": seen,
                             "tokens": [r.out_tokens for r in reqs]}}
    return out


def _engine_matches(got: dict, want: dict, what: str) -> None:
    assert got["tokens"] == want["tokens"], what
    assert len(got["logits"]) == len(want["logits"]), what
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g.numpy(), w, f"{what} draw {i}")


@pytest.mark.parametrize("against", ["port", "jax"])
def test_moe_engine_matches_one_process_with_drops(ranks, engines,
                                                   against):
    """Every prefill's logits and every decode round's whole (slots,
    vocab) logits within LOGIT_TOL on every rank, the greedy tokens
    equal; a decode round dispatches the four slots as one group at
    capacity 1, so assignments drop."""
    from repro_torch.models.moe import capacity, num_groups
    cfg = _cfg(capacity_factor=DROP_CF)
    assert num_groups(SLOTS, 1) == 1 and capacity(cfg, SLOTS) == 1
    for got in ranks:
        _engine_matches(got["engine"], engines[MOE[0]][against],
                        f"moe {against}")


@pytest.mark.parametrize("kind", ["exact", "gossip"])
def test_a_moe_save_at_model_2_is_the_one_process_archive(spawned, kind):
    """The one-process archive restored into the ranks and saved again:
    JAX's loader reads the same whole leaves (the 3-D expert leaves and
    their fp32 rows among them) from both, bit for bit; restored in one
    process it is the one-process state bit for bit."""
    jax = pytest.importorskip("jax")
    from repro.ckpt import checkpoint as jckpt
    from repro_torch.api import AMBSession
    from repro_torch.ckpt.checkpoint import _leaves
    _, outdir = spawned
    for sub in ("", "session_state"):
        one, again = outdir / f"one_{kind}" / sub, \
            outdir / f"ranks_{kind}" / sub
        data = np.load(one / "step_00000001" / "arrays.npz")
        tree: dict = {}
        for key in data.files:
            *parts, leaf = key.split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = np.zeros(data[key].shape, np.float32)
        assert any(np.ndim(data[k]) >= 4 and "moe" in k
                   for k in data.files)
        a = jckpt.load_checkpoint(one, 1, tree)
        b = jckpt.load_checkpoint(again, 1, tree)
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(path))
    states = [list(_leaves(AMBSession.restore(outdir / f"{w}_{kind}",
                                              cfg=_cfg(), device="cpu")
                           .state)) for w in ("one", "ranks")]
    assert [k for k, _ in states[0]] == [k for k, _ in states[1]]
    for (key, x), (_, y) in zip(*states):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert x == y, key


# ---------------------------------------------------------------------------
# (data 1, model 4): more model ranks than KV heads
# ---------------------------------------------------------------------------

def test_kv_head_split_exact_epoch_matches_jax(ranks, inputs):
    """JAX's exact step at data 1 on the same parameters and batch: the
    loss and the parameters within EXACT_RTOL on every rank."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.dual_averaging import BetaSchedule as JBeta
    from repro.dist import amb as jamb
    from repro.optim import DualAveragingOpt as JDualAveraging
    jparams = inputs[0]["qwen2-1.5b"]
    cfg = _cfg("qwen2-1.5b")
    batch = _batch(cfg.vocab_size, KV_PER, KV_SEQ, 12)
    jopt = JDualAveraging(beta=JBeta(50.0, float(KV_PER), 200.0))
    standin = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 1, "model": 1})
    step = jax.jit(jamb.make_train_step(_jcfg("qwen2-1.5b"), jopt,
                                        standin))
    p, _, m = step(jparams, jopt.init(jparams),
                   {k: jnp.asarray(v) for k, v in batch.items()},
                   jnp.asarray(B[:1], jnp.int32))
    want = _port(jax, p, cfg)
    for got in ranks:
        res = got["kv_exact"]
        assert res["kv_share"] == 4 // cfg.num_kv_heads
        np.testing.assert_allclose(res["loss"], float(m["loss"]),
                                   rtol=EXACT_RTOL)
        _within(res["whole"], want, EXACT_RTOL, "kv exact vs jax")


@pytest.mark.parametrize("against", ["port", "jax"])
def test_kv_head_split_engine_matches_one_process(ranks, engines, against):
    """Every logits tensor within LOGIT_TOL of the one-process engine's
    and JAX's, the greedy tokens equal, the KV columns gathered."""
    for got in ranks:
        _engine_matches(got["kv_engine"], engines["qwen2-1.5b"][against],
                        f"kv {against}")
        assert got["kv_engine"]["gathered"] > 0


def test_ranks_that_share_a_kv_head_hold_its_cache(ranks, engines):
    """After the first decode round each rank's (L, slots, cap, 1, hd)
    caches are its KV head's of the one-process engine (within
    LOGIT_TOL), and the two ranks that share the head hold equal caches
    bit for bit."""
    share = 4 // _cfg("qwen2-1.5b").num_kv_heads
    want = engines["qwen2-1.5b"]["port"]["caches"]
    for got in ranks:
        m = got["kv_m"]
        h = m // share
        for g, w in zip(got["kv_engine"]["caches"], want):
            assert g.shape[3] == 1
            _close(g.numpy(), w[:, :, :, h:h + 1].numpy(), f"cache {m}")
        twin = ranks[h * share + (m + 1) % share]["kv_engine"]["caches"]
        for g, t in zip(got["kv_engine"]["caches"], twin):
            assert torch.equal(g, t), m


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
