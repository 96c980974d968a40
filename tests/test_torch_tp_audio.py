"""The audio family (whisper) over a model axis: four gloo ranks on the CPU
against the one-process port and JAX.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp_audio.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run fp32 whisper-base-smoke (4 heads, 2 encoder and 2
decoder layers, 32 frames) on JAX's ``init_params`` carried across through
numpy, and a variant of it whose vocabulary (509 rows padded to 512) puts
padding in the last model rank's block (``PAD``, made with
``dataclasses.replace`` in both packages):

  * (data 2, model 2), two heads a rank:
      - the exact epoch (FSDP x TP) of both configs against JAX's
        global-batch step and the one-process ``data=2`` session, each
        rank's bytes over "data" ``dryrun.rank_fsdp_bytes`` and over
        "model" ``dryrun.rank_model_bytes`` (the padded variant's labels
        hold each block boundary and the last real row);
      - the gossip epoch against JAX's gossip step and the one-process
        session, each worker's dual gathered from its ranks' blocks;
      - serving through the model-level functions (``prefill(tp=)``,
        ``insert_decode_state``, ``decode_step(tp=)``,
        ``evict_decode_state``): each worker's two requests in its two slot
        rows, every logits tensor (gathered over "model" and cut to the
        vocabulary: ``TensorParallel.vocab_logits``) within ``LOGIT_TOL``
        of JAX's and of one process's, the greedy tokens equal, each rank's
        ``enc_kv`` and caches its heads of JAX's;
      - a save at model 2 of a restored one-process archive: the same
        archive, leaf for leaf, read by JAX's loader;
  * (data 1, model 4), one head a rank: the exact epoch of both configs
    against JAX's step, and the serving of all four requests against
    JAX's.

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
WHISPER, PAD = "whisper-base", "whisper-pad"
PAD_KW = dict(name="whisper-pad-smoke", vocab_size=509, vocab_pad_to=512)
# labels the padded variant's batch holds: each model rank's first and
# last row at model 2 and 4, and the last real row
EDGES = (127, 128, 255, 256, 383, 384, 508)
# (prompt length, new tokens) of the four requests; worker w serves
# requests 2w and 2w + 1 in its two slot rows (at model 4, one worker
# serves all four)
REQS = ((5, 4), (9, 4), (9, 4), (5, 4))
CACHE = 16
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: TP and FSDP sum in another order
LOGIT_TOL = 1e-5
# name: (arch, consensus) of a (data 2, model 2) session
SESSIONS = {"exact": (WHISPER, "exact"), "gossip": (WHISPER, "gossip"),
            "pad_exact": (PAD, "exact")}
WIDE = (WHISPER, PAD)              # the (data 1, model 4) exact epochs


def _variant(configs, arch: str):
    """The fp32 whisper-base-smoke of either package's ``configs`` (PAD:
    its vocabulary 509 rows, padded to 512)."""
    kw = PAD_KW if arch == PAD else {}
    return dataclasses.replace(configs.smoke_config(WHISPER),
                               dtype="float32", **kw)


def _cfg(arch=WHISPER):
    from repro_torch import configs
    return _variant(configs, arch)


def _jcfg(arch=WHISPER):
    from repro import configs as jconfigs
    return _variant(jconfigs, arch)


def _batch(cfg, rows: int, seed: int) -> dict:
    """Tokens, next-token labels and the frames' embeddings, numpy, from a
    seed; the padded variant's labels hold ``EDGES``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int32)],
                            1)
    if cfg.padded_vocab != cfg.vocab_size:
        labels[:, :len(EDGES)] = EDGES
    return {"tokens": toks, "labels": labels,
            "enc_embeds": rng.standard_normal(
                (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _torch_batch(batch: dict, rows=None) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {k: v.long() if v.dtype == torch.int32 else v
           for k, v in out.items()}
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


def _requests(cfg) -> list:
    """(prompt ids, the request's frames) of each request, numpy."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, cfg.vocab_size, plen).astype(np.int64),
             rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(
                 np.float32)) for plen, _ in REQS]


def _serve(params: dict, cfg, which: list, tp=None) -> dict:
    """Requests ``which`` through the model-level functions into one slot
    row each: a batch-1 prefill inserted into its row, then greedy decode
    rounds of every row at its own position, then every row evicted.
    Returns each prefill's and each round's logits (whole: over "model"
    gathered and cut to the vocabulary), the tokens, and ``enc_kv`` and
    the caches after the prefills."""
    from repro_torch import models
    reqs = [_requests(cfg)[i] for i in which]
    state = models.init_decode_state(cfg, len(reqs), CACHE,
                                     per_slot_pos=True, device="cpu", tp=tp)

    def whole(logits):
        return logits if tp is None else tp.vocab_logits(logits,
                                                         cfg.vocab_size)
    prefills, tok = [], []
    for slot, (ids, frames) in enumerate(reqs):
        logits, one = models.prefill(
            params, cfg, {"tokens": torch.from_numpy(ids)[None],
                          "enc_embeds": torch.from_numpy(frames)[None]},
            extra_capacity=CACHE - len(ids), tp=tp)
        models.insert_decode_state(state, one, slot)
        prefills.append(whole(logits))
        tok.append(int(prefills[-1].argmax(-1)[0]))
    held = {"enc_kv": [t.clone() for t in state.enc_kv],
            "caches": [state.caches.k.clone(), state.caches.v.clone()]}
    tokens, rounds = [[t] for t in tok], []
    for _ in range(REQS[0][1] - 1):
        logits, state = models.decode_step(params, cfg, state,
                                           torch.tensor(tok), tp=tp)
        rounds.append(whole(logits))
        tok = [int(t) for t in rounds[-1].argmax(-1)]
        for row, t in zip(tokens, tok):
            row.append(t)
    for slot in range(len(reqs)):
        models.evict_decode_state(state, slot)
    assert not any(t.any() for t in models.model._cache_tensors(
        (state.caches, state.enc_kv)))
    return {"prefills": prefills, "rounds": rounds, "tokens": tokens,
            **held}


def _jax_serve(jparams, arch: str) -> dict:
    """JAX's model-level serving of the four requests in four slot rows,
    as :func:`_serve` (the logits cut to the vocabulary by JAX)."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    cfg = _jcfg(arch)
    reqs = _requests(_cfg(arch))
    prefill = jax.jit(jm.prefill, static_argnums=(1, 3))
    decode = jax.jit(jm.decode_step, static_argnums=1)
    state = jm.init_decode_state(cfg, len(reqs), CACHE, per_slot_pos=True)
    prefills, tok = [], []
    for slot, (ids, frames) in enumerate(reqs):
        logits, one = prefill(
            jparams, cfg, {"tokens": jnp.asarray(ids[None], jnp.int32),
                           "enc_embeds": jnp.asarray(frames[None])},
            CACHE - len(ids))
        state = jm.insert_decode_state(state, one, slot)
        prefills.append(np.asarray(logits))
        tok.append(int(prefills[-1].argmax(-1)[0]))
    held = {"enc_kv": [np.asarray(t) for t in state.enc_kv],
            "caches": [np.asarray(state.caches.k),
                       np.asarray(state.caches.v)]}
    tokens, rounds = [[t] for t in tok], []
    for _ in range(REQS[0][1] - 1):
        logits, state = decode(jparams, cfg, state,
                               jnp.asarray(tok, jnp.int32))
        rounds.append(np.asarray(logits))
        tok = [int(t) for t in rounds[-1].argmax(-1)]
        for row, t in zip(tokens, tok):
            row.append(t)
    return {"prefills": prefills, "rounds": rounds, "tokens": tokens,
            **held}


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: the (2, 2) cases, then the (1, 4) cases; results to
    ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import AMBSession
    from repro_torch.dist.group import WorkerGroup
    from repro_torch.dist.params import shard_tree
    from repro_torch.dist.tp import TensorParallel
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)

    def served(arch, mesh, group, which):
        cfg = _cfg(arch)
        tp = TensorParallel(group, {k: v.shape for k, v in ins[arch].items()},
                            None, cfg)
        blocks = shard_tree(ins[arch], mesh, mesh.get_coordinate(), None)
        return _serve(blocks, cfg, which, tp)

    try:
        ins, batches = torch.load(outdir / "inputs.pt", weights_only=False)
        mesh = make_host_mesh(N, M, device="cpu")
        group = WorkerGroup(mesh, "cpu")
        w = group.worker
        rows = slice(w * PER, (w + 1) * PER)
        out = {"coord": tuple(int(c) for c in mesh.get_coordinate()),
               "worker": w, "m": group.m}
        for name, (arch, _) in SESSIONS.items():
            out[name] = _epoch(_session(name, ins[arch], mesh),
                               batches[arch], rows)
        for arch in (WHISPER, PAD):
            out[f"serve_{arch}"] = served(arch, mesh, group,
                                          [2 * w, 2 * w + 1])
        session = AMBSession.restore(outdir / "one_exact", cfg=_cfg(),
                                     device="cpu")
        session.save(outdir / "ranks_exact")

        # (data 1, model 4)
        mesh = make_host_mesh(1, 4, device="cpu")
        group = WorkerGroup(mesh, "cpu")
        out["m4"] = group.m
        for arch in WIDE:
            out[f"wide_exact_{arch}"] = _epoch(
                _session(arch, ins[arch], mesh, model=4, data=1,
                         per=N * PER), batches[arch])
        out["wide_serve"] = served(WHISPER, mesh, group, [0, 1, 2, 3])
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
    for i, arch in enumerate((WHISPER, PAD)):
        jparams[arch] = init(jax.random.PRNGKey(6 + i), _jcfg(arch))
        params[arch] = _port(jax, jparams[arch], _cfg(arch))
        batches[arch] = _batch(_cfg(arch), N * PER, 21 + i)
    return jparams, params, batches


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """The ranks, started after the one-process exact session they
    restore (one epoch, saved)."""
    outdir = tmp_path_factory.mktemp("ranks_tp_audio")
    _, params, batches = inputs
    torch.save((params, batches), outdir / "inputs.pt")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    session = _session("exact", params[WHISPER])
    session.step(_torch_batch(batches[WHISPER]), B)
    session.save(outdir / "one_exact")
    torch.set_num_threads(before)
    procs, logs = start(outdir)
    return procs, logs, outdir, time.monotonic() + JOIN_S


@pytest.fixture(scope="module")
def one_process(inputs, spawned):
    """The one-process port sessions (``data=2``) and serving, while the
    ranks run (one thread)."""
    _, params, batches = inputs
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {name: _epoch(_session(name, params[arch]), batches[arch])
               for name, (arch, _) in SESSIONS.items()}
        for arch in (WHISPER, PAD):
            out[f"serve_{arch}"] = _serve(params[arch], _cfg(arch),
                                          list(range(len(REQS))))
        return out
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_refs(inputs, spawned):
    """JAX's exact and gossip steps and its model-level serving on the
    same parameters, batches and requests, while the ranks run."""
    jax = pytest.importorskip("jax")
    jparams, _, batches = inputs
    out = {}
    for arch, w in ((WHISPER, N), (PAD, N), (WHISPER, 1), (PAD, 1)):
        out[arch, "exact", w] = _jax_exact(jax, arch, jparams[arch],
                                           batches[arch], w)
    out[WHISPER, "gossip", N] = _jax_gossip(jax, WHISPER, jparams[WHISPER],
                                            batches[WHISPER], N)
    for arch in (WHISPER, PAD):
        out[arch, "serve"] = _jax_serve(jparams[arch], arch)
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


def _served_matches(got: dict, want: dict, rows: slice, what: str) -> None:
    """Tokens equal, every prefill's and round's logits within LOGIT_TOL,
    for the slot rows ``rows`` of ``want``."""
    assert got["tokens"] == want["tokens"][rows], what
    for i, g in enumerate(got["prefills"]):
        _close(g, want["prefills"][rows.start + i], f"{what} prefill {i}")
    assert len(got["rounds"]) == len(want["rounds"]), what
    for i, (g, w) in enumerate(zip(got["rounds"], want["rounds"])):
        _close(g, np.asarray(w)[rows], f"{what} round {i}")


# ---------------------------------------------------------------------------
# without ranks: the plan, the dry-run
# ---------------------------------------------------------------------------

def test_audio_plan_draws_init_params_and_names_every_leaf():
    """``param_plan`` covers whisper: its leaves in ``init_params``' order
    of draws, all 27, the encoder's and the cross-attention's among
    them."""
    from repro_torch import models
    from repro_torch.models.model import param_plan
    cfg = _cfg()
    gen = torch.Generator().manual_seed(9)
    plan = {k: make(gen) for k, make in param_plan(cfg)}
    tree = models.init_params(cfg, torch.Generator().manual_seed(9))
    assert sorted(plan) == sorted(tree) and len(tree) == 27
    for k, v in tree.items():
        assert torch.equal(plan[k], v), k
    assert {"encoder.final_norm", "blocks.ln_x", "blocks.xattn.wk",
            "encoder.blocks.attn.wq"} <= set(plan)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_counts_the_audio_model_collectives(kind):
    """The dry-run's "model" sums for whisper are the port's: a decoder
    layer's three (self-attention's and cross-attention's ``wo``, the
    MLP), of the tokens; an encoder layer's two, of the frames, none in a
    decode step; a training step's backward each again and its
    checkpointed recompute the attention's again (it stops before the
    MLP's), the encoder output's gradient once a decoder layer; the
    lookup once, and in training the logits' input.  None at model 1, and
    no all-gather."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    cfg = _cfg()
    seq = 1 if kind == "decode" else SEQ
    coll = dryrun._layout(cfg, InputShape("t", seq, PER, kind),
                          _mesh((1, M)))["collectives"]
    train, enc = kind == "train", kind != "decode"
    dec = cfg.num_layers * (8 if train else 3) + 1 + train
    encoder = enc * (cfg.encoder_layers * (5 if train else 2)
                     + train * cfg.num_layers)
    assert coll["all-reduce"]["count"] == dec + encoder
    e, d = 4, cfg.d_model                        # fp32
    tokens, frames = PER * seq, PER * cfg.encoder_seq
    # one call's bytes of each distinct sum: the decoder's, the lookup's
    # (and the logits' input), the encoder's (and its output's)
    want = (1 + 1 + train) * tokens * d * e + enc * (1 + train) * frames \
        * d * e
    assert coll["all-reduce"]["bytes"] == want
    assert coll["all-gather"]["count"] == 0
    assert dryrun._layout(cfg, InputShape("t", seq, PER, kind),
                          _mesh((1, 1)))["collectives"]["all-reduce"][
                              "count"] == 0


# ---------------------------------------------------------------------------
# (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["exact", "pad_exact"])
def test_exact_epoch_matches_jax(ranks, jax_refs, name):
    """JAX's global-batch exact step over the same 2 workers (a stand-in
    mesh): the loss and the parameters within EXACT_RTOL on every rank;
    the padded variant's labels on each block boundary and the last real
    row."""
    arch = SESSIONS[name][0]
    loss, want = jax_refs[arch, "exact", N]
    for got in ranks:
        np.testing.assert_allclose(got[name]["loss"], loss, rtol=EXACT_RTOL)
        _within(got[name]["whole"], want, EXACT_RTOL, f"{name} against jax")


def test_gossip_epoch_matches_jax(ranks, jax_refs):
    """JAX's gossip step over the same 2 workers: the loss, the primal and
    each worker's dual (gathered from its model ranks' blocks) within
    EXACT_RTOL."""
    loss, primal, duals = jax_refs[WHISPER, "gossip", N]
    for got in ranks:
        np.testing.assert_allclose(got["gossip"]["loss"], loss,
                                   rtol=EXACT_RTOL)
        _within(got["gossip"]["whole"], primal, EXACT_RTOL, "primal")
    shapes = {k: v.shape for k, v in duals[0].items()}
    for i in range(N):
        _within(_worker_dual(ranks, "gossip", i, shapes, _mesh()), duals[i],
                EXACT_RTOL, f"z worker {i}")


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
                **dryrun.rank_model_bytes(_cfg(arch), _mesh(), PER * SEQ,
                                          frames=PER * _cfg().encoder_seq))
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
@pytest.mark.parametrize("arch", [WHISPER, PAD])
def test_serving_matches_one_process(ranks, one_process, jax_refs, arch,
                                     against):
    """Each worker's two requests through ``prefill(tp=)``,
    ``insert_decode_state``, ``decode_step(tp=)`` and
    ``evict_decode_state``: every prefill's and decode round's logits
    (gathered and cut to the vocabulary) within LOGIT_TOL of JAX's and of
    one process's, the greedy tokens equal (the padded variant's never a
    padded row)."""
    want = jax_refs[arch, "serve"] if against == "jax" else \
        one_process[f"serve_{arch}"]
    vocab = _cfg(arch).vocab_size
    for got in ranks:
        res = got[f"serve_{arch}"]
        w = got["worker"]
        assert all(g.shape[-1] == vocab for g in res["prefills"])
        assert all(t < vocab for row in res["tokens"] for t in row)
        _served_matches(res, want, slice(2 * w, 2 * w + 2),
                        f"{arch} rank {got['coord']} against {against}")


@pytest.mark.parametrize("arch", [WHISPER, PAD])
def test_each_rank_holds_its_heads_of_enc_kv(ranks, jax_refs, arch):
    """After the prefills each rank's ``enc_kv`` (L, 2, frames, KV / M, hd)
    and self-attention caches are its heads of JAX's, for its worker's
    slot rows, within LOGIT_TOL."""
    want = jax_refs[arch, "serve"]
    kv = _cfg(arch).num_kv_heads
    h = kv // M
    for got in ranks:
        res = got[f"serve_{arch}"]
        rows = slice(2 * got["worker"], 2 * got["worker"] + 2)
        heads = slice(got["m"] * h, (got["m"] + 1) * h)
        for what in ("enc_kv", "caches"):
            for g, w in zip(res[what], want[what]):
                assert g.shape[3] == h, (what, g.shape)
                _close(g.numpy(), w[:, rows, :, heads],
                       f"{what} rank {got['coord']}")


def test_a_whisper_save_at_model_2_is_the_one_process_archive(ranks,
                                                              spawned):
    """The one-process archive restored into the ranks and saved again:
    JAX's loader reads the same whole leaves from both, bit for bit (the
    encoder's and the cross-attention's among them)."""
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
        assert any("encoder/blocks/attn/wq" in k for k in data.files)
        assert any("xattn/wk" in k for k in data.files)
        a = jckpt.load_checkpoint(one, 1, tree)
        b = jckpt.load_checkpoint(again, 1, tree)
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(path))


# ---------------------------------------------------------------------------
# (data 1, model 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", WIDE)
def test_wide_exact_epoch_matches_jax(ranks, jax_refs, arch):
    """JAX's exact step at data 1 on the same parameters and batch, one
    head a rank: the loss and the parameters within EXACT_RTOL on every
    rank (the padded variant's last block 125 real rows of 128)."""
    loss, want = jax_refs[arch, "exact", 1]
    for got in ranks:
        res = got[f"wide_exact_{arch}"]
        np.testing.assert_allclose(res["loss"], loss, rtol=EXACT_RTOL)
        _within(res["whole"], want, EXACT_RTOL, f"{arch} wide exact")


def test_wide_serving_matches_jax(ranks, jax_refs):
    """The four requests in four slot rows over four model ranks, one head
    each: every logits tensor within LOGIT_TOL of JAX's, the tokens equal,
    each rank's ``enc_kv`` its head of JAX's."""
    want = jax_refs[WHISPER, "serve"]
    for got in ranks:
        assert got["m4"] in range(4)
        res = got["wide_serve"]
        _served_matches(res, want, slice(0, 4), f"wide rank {got['m4']}")
        for g, w in zip(res["enc_kv"], want["enc_kv"]):
            assert g.shape[3] == 1
            _close(g.numpy(), w[:, :, :, got["m4"]:got["m4"] + 1],
                   f"wide enc_kv rank {got['m4']}")


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
