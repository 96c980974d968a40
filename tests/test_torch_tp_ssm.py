"""The vlm and ssm families over a model axis: four gloo ranks on the CPU
against the one-process port and JAX.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp_ssm.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run at fp32 smoke configs on the parent's parameters (JAX's
``init_params``, with the RWKV6 token-shift mixes, bonus, decay bias and
``ln_x`` redrawn from a seed so that a misplaced block shows, carried
across through numpy):

  * (data 2, model 2), rwkv6-3b-smoke (2 heads, one a rank; chunk 8):
      - one RWKV6 block and its gradient on each rank's blocks: the
        output, the input's gradient and every gradient block within
        ``EXACT_RTOL`` of one process;
      - the exact epoch (FSDP x TP) against JAX's global-batch step and
        the one-process ``data=2`` session, each rank's bytes over "data"
        ``dryrun.rank_fsdp_bytes`` and over "model"
        ``dryrun.rank_model_bytes``;
      - the gossip epoch against JAX's gossip step; gossip_q8 and
        gossip_q4 against the one-process session on the same draws
        (quantized dual stacks within ``STACK_RTOL``); the pipelined
        driver once, against the one-process pipelined session;
      - the slot engine on a variant whose decode state pads its heads
        (``head_pad_to`` 4): every logits tensor it samples from within
        ``LOGIT_TOL`` of JAX's ``SlotEngine`` and of the one-process
        engine, the tokens equal, and each rank's states (its one head,
        not padded) its head of JAX's padded state cut to the native
        heads;
      - checkpoints (exact, gossip): a one-process save restored into the
        ranks and saved again is the same archive, leaf for leaf, read by
        JAX's loader;
      - the serve CLI with ``--arch rwkv6-3b --smoke --data 2 --model 2``
        and a fine-tune session;
  * internvl2-76b-smoke (embeddings in) at (data 2, model 2): the exact
    and gossip epochs against JAX, and the engine on embeddings prompts
    (the vocab-parallel lookup of ``serve.slots.prompt_batch``) against
    JAX's and the one-process engine;
  * (data 1, model 4): a 4-head RWKV6 variant (d_model 256, one head a
    rank; its engine's decode state padded to ``PAD4`` heads) and
    internvl2-76b-smoke (H 4, KV 2: two ranks to a KV head), each the
    exact epoch against JAX's step and the one-process port's, and the
    engine against JAX's ``SlotEngine`` and the one-process port's (each
    RWKV6 rank's states its head of JAX's padded state); internvl2's
    gossip epoch (one worker) against JAX's.

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
N, M, PER, SEQ = 2, 2, 2, 16
B = [2, 1]                         # the epoch's minibatch sizes
BETA = (50.0, float(N * PER), 200.0)     # the session's schedule
ROUNDS = 1                         # gossip rounds an epoch
CHUNK = 8                          # the RWKV6 scans' chunk: two a sequence
SLOTS, CACHE = 4, 24
# (prompt length, new tokens): six requests over four slots, so that slots
# retire and refill; two lengths (the ssm prefills at exact length, and
# JAX's engine compiles a prefill for each)
PROMPTS = ((5, 4), (12, 3), (5, 5), (12, 2), (5, 4), (12, 3))
RWKV, VLM = "rwkv6-3b", "internvl2-76b"
RWKV4 = "rwkv6-4h"                 # 4 heads (d_model 256): model 4 splits them
PAD = 4                            # the engine variant's padded state heads
PAD4 = 8                           # and RWKV4's
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
EXACT_RTOL = 1e-5       # fp32: TP and FSDP sum in another order
LOGIT_TOL = 1e-5
STACK_RTOL = 1e-2       # a quantized dual stack (tests/test_torch_tp_quantized)
# name: (arch, consensus, pipelined) of a (data 2, model 2) session
SESSIONS = {"exact": (RWKV, "exact", False),
            "gossip": (RWKV, "gossip", False),
            "gossip_q8": (RWKV, "gossip_q8", False),
            "gossip_q4": (RWKV, "gossip_q4", False),
            "pipelined": (RWKV, "gossip", True),
            "vlm_exact": (VLM, "exact", False),
            "vlm_gossip": (VLM, "gossip", False)}
WIDE = (RWKV4, VLM)                # the (data 1, model 4) configs
# each engine's config keywords: the RWKV6 variants pad their decode state
ENGINE_KW = {RWKV: {"head_pad_to": PAD}, RWKV4: {"head_pad_to": PAD4},
             VLM: {}}
SERVE_ARGV = ["--arch", RWKV, "--smoke", "--data", str(N), "--model",
              str(M), "--batch", "4", "--requests", "4", "--prompt-len",
              "12", "--new-tokens", "4", "--finetune", "1",
              "--round-budget", "0.5", "--consensus", "exact",
              "--finetune-seq-len", "16"]


def _variant(configs, arch: str, **kw):
    """The smoke config of ``arch`` in fp32 (RWKV4: rwkv6-3b-smoke at
    d_model 256, 4 heads), from either package's ``configs``."""
    base = configs.smoke_config(RWKV if arch == RWKV4 else arch)
    if arch == RWKV4:
        kw = dict(name="rwkv6-4h-smoke", d_model=256, num_heads=4,
                  num_kv_heads=4, **kw)
    if base.family == "ssm":
        kw.setdefault("ssm_chunk", CHUNK)
    return dataclasses.replace(base, dtype="float32", **kw)


def _cfg(arch=RWKV, **kw):
    from repro_torch import configs
    return _variant(configs, arch, **kw)


def _jcfg(arch=RWKV, **kw):
    from repro import configs as jconfigs
    return _variant(jconfigs, arch, **kw)


def _batch(cfg, rows: int, seq: int, seed: int) -> dict:
    """Tokens (vlm: embeddings) and next-token labels, numpy, from a
    seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    out = {"labels": np.concatenate(
        [toks[:, 1:], np.full((rows, 1), -1, np.int32)], 1)}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((rows, seq, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = toks
    return out


def _torch_batch(batch: dict, rows=None) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {k: v.long() if v.dtype == torch.int32 else v
           for k, v in out.items()}
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


def _session(name, params, mesh=None, model=M, data=N, per=PER):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    arch, consensus, pipelined = SESSIONS.get(name, (name, "exact", False))
    if params is not None:
        params = {k: v.clone() for k, v in params.items()}
    return AMBSession(TrainSpec(smoke=True, data=data, model=model,
                                batch_per_worker=per, seq_len=SEQ),
                      ClockSpec(kind="simulated"),
                      ConsensusSpec(consensus=consensus, graph="ring",
                                    gossip_rounds=ROUNDS, pipeline=pipelined),
                      cfg=_cfg(arch), params=params, device="cpu",
                      mesh=mesh, draw_source=draw_source)


def _epoch(session, batch: dict, rows=None) -> dict:
    """One epoch through the protocol (the pipelined driver: and its
    flush)."""
    session.state, m = session.protocol.step(
        session.state, _torch_batch(batch, rows), B[:session.n_workers])
    session.flush()
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


def _requests(vocab: int) -> list:
    from repro_torch.serve import Request
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                                 plen)],
                    max_new_tokens=new)
            for i, (plen, new) in enumerate(PROMPTS)]


def _caches(state) -> list:
    """The engine's cache tensors (ssm: the wkv states, the token shifts
    of both mixes; else K and V), cloned."""
    c = state.caches
    if isinstance(c, dict):
        return [c["tmix"].s.clone(), c["tmix"].x_prev.clone(),
                c["cmix_prev"].clone()]
    return [c.k.clone(), c.v.clone()]


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
            caches = _caches(engine.state)
    return {"logits": seen, "tokens": [r.out_tokens for r in reqs],
            "caches": caches}


def _layer(cfg, params: dict, x, ct, tp=None) -> dict:
    """One RWKV6 block on layer 0 of ``params`` (this rank's blocks with
    ``tp``): the output and the gradients of x and of every block leaf
    under ``sum(out * ct)``."""
    from repro_torch.models.model import _nest, _rwkv_block
    leaves = {k[len("blocks."):]: v[0].clone().requires_grad_()
              for k, v in params.items() if k.startswith("blocks.")}
    x = x.clone().requires_grad_()
    positions = torch.arange(x.shape[1])[None, :]
    out, _ = _rwkv_block(x, positions, cfg, _nest(leaves), tp)
    (out * ct).sum().backward()
    return {"out": out.detach(), "dx": x.grad,
            "grads": {k: v.grad for k, v in leaves.items()}}


def _layer_inputs(cfg):
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(rng.standard_normal(
        (2, SEQ, cfg.d_model), dtype=np.float32)) for _ in range(2))


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
    from repro_torch.dist.params import shard_tree
    from repro_torch.dist.tp import TensorParallel
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

        # one RWKV6 block and its gradient
        cfg = _cfg()
        tp = TensorParallel(group, {k: v.shape for k, v in ins[RWKV].items()},
                            None, cfg)
        x, ct = _layer_inputs(cfg)
        out["layer"] = _layer(cfg, shard_tree(ins[RWKV], mesh, coord, None),
                              x, ct, tp)

        # the sessions
        for name, (arch, _, _) in SESSIONS.items():
            session = _session(name, ins[arch], mesh)
            out[name] = _epoch(session, batches[arch], rows)

        # the slot engines
        out["engine"] = _drive(_engine(ins[RWKV], _cfg(**ENGINE_KW[RWKV]),
                                       mesh, coord, group),
                               _requests(cfg.vocab_size))
        out["vlm_engine"] = _drive(_engine(ins[VLM], _cfg(VLM), mesh, coord,
                                           group),
                                   _requests(_cfg(VLM).vocab_size))

        # checkpoints: the one-process archive into the ranks and back
        for kind in ("exact", "gossip"):
            session = AMBSession.restore(outdir / f"one_{kind}", cfg=_cfg(),
                                         device="cpu")
            session.save(outdir / f"ranks_{kind}")

        # the serve CLI with a fine-tune session
        report = serve.main(SERVE_ARGV, device="cpu")
        out["cli"] = [r.out_tokens for r in report.requests]

        # (data 1, model 4)
        mesh = make_host_mesh(1, 4, device="cpu")
        coord = mesh.get_coordinate()
        group = WorkerGroup(mesh, "cpu")
        out["m4"] = group.m
        for arch in WIDE:
            session = _session(arch, ins[arch], mesh, model=4, data=1,
                               per=N * PER)
            out[f"wide_exact_{arch}"] = _epoch(session, batches[arch])
            if arch == VLM:
                session = _session("vlm_gossip", ins[arch], mesh, model=4,
                                   data=1, per=N * PER)
                out["wide_gossip"] = _epoch(session, batches[arch])
            out[f"wide_engine_{arch}"] = _drive(
                _engine(ins[arch], _cfg(arch, **ENGINE_KW[arch]), mesh,
                        coord, group),
                _requests(_cfg(arch).vocab_size))
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


def _redraw(jax, jparams, seed: int):
    """JAX's parameters with the RWKV6 leaves that init makes constant
    (the token-shift mixes, the bonus, the decay bias and ``ln_x``) drawn
    from a seed, so that each rank's block of them is its own."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jparams)
    blocks = tree["blocks"]
    for sub, k, lo, hi in (("tmix", "mu", 0.0, 1.0), ("cmix", "mu", 0.0, 1.0),
                           ("tmix", "u_bonus", -0.5, 0.5),
                           ("tmix", "decay_bias", -7.0, -4.0),
                           ("tmix", "ln_x", 0.5, 1.5)):
        leaf = blocks[sub][k]
        blocks[sub][k] = rng.uniform(lo, hi, leaf.shape).astype(leaf.dtype)
    return tree


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters of each fp32 smoke config (the RWKV6
    constants redrawn) and the port's copies of them; a global batch of
    each."""
    jax = pytest.importorskip("jax")
    from repro import models as jmodels
    jparams, params, batches = {}, {}, {}
    init = jax.jit(jmodels.init_params, static_argnums=1)
    for i, arch in enumerate((RWKV, VLM, RWKV4)):
        jp = init(jax.random.PRNGKey(4 + i), _jcfg(arch))
        if _cfg(arch).family == "ssm":
            jp = _redraw(jax, jp, 40 + i)
        jparams[arch] = jp
        params[arch] = _port(jax, jp, _cfg(arch))
        batches[arch] = _batch(_cfg(arch), N * PER, SEQ, 11 + i)
    return jparams, params, batches


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """The ranks, started first; while they run, the one-process sessions
    they restore (one epoch each, saved)."""
    outdir = tmp_path_factory.mktemp("ranks_tp_ssm")
    _, params, batches = inputs
    torch.save((params, batches), outdir / "inputs.pt")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for kind in ("exact", "gossip"):
        session = _session(kind, params[RWKV])
        session.step(_torch_batch(batches[RWKV]), B)
        session.save(outdir / f"one_{kind}")
    torch.set_num_threads(before)
    procs, logs = start(outdir)
    return procs, logs, outdir, time.monotonic() + JOIN_S


@pytest.fixture(scope="module")
def one_process(inputs, spawned):
    """The one-process port sessions (``data=2``; WIDE: ``data=1``) and
    engines, while the ranks run (one thread)."""
    jparams, params, batches = inputs
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {name: _epoch(_session(name, params[arch]), batches[arch])
               for name, (arch, _, _) in SESSIONS.items()}
        out["wide_exact"] = _epoch(_session(RWKV4, params[RWKV4], data=1,
                                            per=N * PER), batches[RWKV4])
        out["engine"] = _drive(_engine(params[RWKV],
                                       _cfg(**ENGINE_KW[RWKV])),
                               _requests(_cfg().vocab_size))
        for arch in (VLM, RWKV4):
            out[f"engine_{arch}"] = _drive(
                _engine(params[arch], _cfg(arch, **ENGINE_KW[arch])),
                _requests(_cfg(arch).vocab_size))
        return out
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_steps(inputs, spawned):
    """JAX's exact and gossip steps on the same parameters and batches,
    while the ranks run: ``(arch, consensus, workers)`` -> (loss, the
    port's parameters or primal, each worker's dual or None)."""
    jax = pytest.importorskip("jax")
    jparams, _, batches = inputs
    out = {}
    for arch, w in ((RWKV, N), (VLM, N), (VLM, 1), (RWKV4, 1)):
        out[arch, "exact", w] = _jax_exact(jax, arch, jparams[arch],
                                           batches[arch], w) + (None,)
    for arch, w in ((RWKV, N), (VLM, N), (VLM, 1)):
        out[arch, "gossip", w] = _jax_gossip(jax, arch, jparams[arch],
                                             batches[arch], w)
    return out


@pytest.fixture(scope="module")
def engines(inputs, spawned):
    """JAX's one-process ``SlotEngine`` on each engine config
    (``_jax_engine``, ``ENGINE_KW``), while the ranks run."""
    pytest.importorskip("jax")
    return {arch: _jax_engine(inputs[0][arch], arch, kw)
            for arch, kw in ENGINE_KW.items()}


@pytest.fixture(scope="module")
def ranks(spawned, one_process, jax_steps, engines):
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


def _jax_engine(jparams, arch: str, kw: dict) -> dict:
    """JAX's one-process ``SlotEngine`` on ``arch``'s smoke config (with
    ``kw``): every logits array its sampler draws from, the tokens, and
    (ssm) the wkv states after the first decode round."""
    from repro import serve as jserve
    engine = jserve.SlotEngine(jparams, _jcfg(arch, **kw), slots=SLOTS,
                               cache_len=CACHE)
    seen, sample = [], engine._sample

    def spy(logits, key):
        seen.append(np.asarray(logits))
        return sample(logits, key)

    engine._sample = spy
    reqs = [jserve.Request(rid=r.rid, prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens)
            for r in _requests(_cfg(arch).vocab_size)]
    pending, caches = list(reqs), None
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()
        if caches is None:
            c = engine.state.caches
            caches = [np.asarray(c["tmix"].s)] \
                if isinstance(c, dict) else None
    return {"logits": seen, "tokens": [r.out_tokens for r in reqs],
            "caches": caches}


def _engine_matches(got: dict, want: dict, what: str) -> None:
    assert got["tokens"] == want["tokens"], what
    assert len(got["logits"]) == len(want["logits"]), what
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(np.asarray(g), w, f"{what} draw {i}")


# ---------------------------------------------------------------------------
# without ranks: the layout, the refusals, the dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", ["data", None])
@pytest.mark.parametrize("arch", [RWKV, VLM, "whisper-base", "zamba2-1.2b"])
def test_init_shards_are_slices_of_init_params_bit_for_bit(arch, fsdp):
    """Each coordinate's blocks, drawn a whole leaf at a time in
    ``init_params``' order, equal its slices of ``init_params`` bit for
    bit; RWKV6's layout is JAX's ``param_spec`` (the LoRA's rank, the
    bonus's head dim and the mixes' d_model on "model", ``cmix.w_v`` by
    its d_model columns); whisper's encoder and cross-attention leaves
    take a dense block's rules; the hybrid's packed Mamba2 leaves put
    "model" on their columns (``conv_w`` "data" on its 4 taps) and its
    shared block's leaves have no layer dim."""
    from repro_torch import models
    from repro_torch.dist import params as P
    cfg = _cfg(arch)
    tree = models.init_params(cfg, torch.Generator().manual_seed(5))
    mesh = _mesh()
    if arch == RWKV:
        for name, spec in (("blocks.tmix.decay_a", (None, fsdp, "model")),
                           ("blocks.tmix.decay_b", (None, "model", fsdp)),
                           ("blocks.tmix.u_bonus", (None, fsdp, "model")),
                           ("blocks.tmix.mu", (None, fsdp, "model")),
                           ("blocks.cmix.w_v", (None, fsdp, "model")),
                           ("blocks.tmix.ln_x", ())):
            assert P.param_spec(name, tree[name].shape, mesh, fsdp) == spec
    if cfg.family == "hybrid":
        for name, spec in (("blocks.mamba.w_in", (None, fsdp, "model")),
                           ("blocks.mamba.conv_w", (None, fsdp, "model")),
                           ("blocks.mamba.w_out", (None, "model", fsdp)),
                           ("blocks.mamba.norm_z", ()),
                           ("shared_attn.attn.wq", (fsdp, "model")),
                           ("shared_attn.mlp.w_down", ("model", fsdp)),
                           ("shared_attn.ln1", ())):
            assert P.param_spec(name, tree[name].shape, mesh, fsdp) == spec
    if cfg.family == "audio":
        for name, spec in (("encoder.blocks.attn.wq", (None, fsdp, "model")),
                           ("encoder.blocks.mlp.w_down",
                            (None, "model", fsdp)),
                           ("blocks.xattn.wk", (None, fsdp, "model")),
                           ("blocks.xattn.wo", (None, "model", fsdp)),
                           ("blocks.ln_x", ()), ("encoder.final_norm", ())):
            assert P.param_spec(name, tree[name].shape, mesh, fsdp) == spec
    for c in np.ndindex(N, M):
        got = P.init_shards(cfg, torch.Generator().manual_seed(5), mesh, c,
                            fsdp)
        want = P.shard_tree(tree, mesh, c, fsdp)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (c, k)


# the configs that still refuse: a hybrid whose 3 Mamba2 heads (d_model 96)
# model 2 does not divide
REFUSED_KW = {"zamba2-1.2b": dict(d_model=96)}


@pytest.mark.parametrize("arch, model", [(RWKV, 4), ("whisper-base", 16),
                                         ("zamba2-1.2b", 2)])
def test_what_still_refuses_names_item_4a(arch, model):
    """A model extent that does not divide the heads (the RWKV6 smoke
    config's 2 at 4, whisper-base-smoke's 4 at 16, a hybrid's 3 Mamba2
    heads at 2) raises, naming module item 4a.5.3; rwkv6-3b at 2 and 4,
    whisper-base at 2, 4 and 8 (its 8 heads; tests/test_torch_tp_audio.py
    runs it), zamba2-1.2b and its smoke config at 2 and 4
    (tests/test_torch_tp_hybrid.py runs them) and the vlm pass."""
    from repro_torch import configs
    from repro_torch.dist.tp import check_supported
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              **REFUSED_KW.get(arch, {}))
    with pytest.raises(ValueError, match=r"ROADMAP.md, module item 4a.5.3"):
        check_supported(cfg, model)
    for name, m in ((RWKV, 2), (VLM, 4)):
        check_supported(_cfg(name), m)
    for m in (2, 4):
        check_supported(configs.get_config(RWKV), m)
        check_supported(configs.get_config("zamba2-1.2b"), m)
        check_supported(configs.smoke_config("zamba2-1.2b"), m)
    for m in (2, 4, 8):
        check_supported(configs.get_config("whisper-base"), m)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_run_counts_the_ssm_model_collectives(kind):
    """The dry-run's "model" collectives for RWKV6 are the slice's: a
    training step's per-layer all-gathers (the small leaves and the ffn
    key twice, the forward and the checkpointed recompute; the
    channel-mix output once, since the recompute stops before it) and
    sums; a decode step's two gathers a layer (the leaves
    were gathered once) and one sum; none at model 1.  At data 1 no leaf
    lies on "data", so the all-gathers are the model axis's own."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    cfg = _cfg()
    shape = InputShape("t", SEQ if kind == "train" else 1, PER, kind)
    coll = dryrun._layout(cfg, shape, _mesh((1, M)))["collectives"]
    gathers = 2 * 6 + 1 if kind == "train" else 2
    # training: w_out twice, the five leaves' and the key's gradients, the
    # decay bias and ln_x, the two mixes' inputs
    sums = 2 + 6 + 2 + 2 if kind == "train" else 1
    assert coll["all-gather"]["count"] == gathers * cfg.num_layers
    assert coll["all-reduce"]["count"] == sums * cfg.num_layers + (
        2 if kind == "train" else 1)
    assert dryrun._layout(cfg, shape, _mesh((1, 1)))["collectives"][
        "all-gather"]["count"] == 0


# ---------------------------------------------------------------------------
# (data 2, model 2)
# ---------------------------------------------------------------------------

def test_rwkv6_block_over_ranks_matches_one_process(ranks, inputs):
    """Each rank's output, input gradient and gradient blocks (the
    replicated leaves whole) within EXACT_RTOL of one process."""
    from repro_torch.dist import params as P
    cfg = _cfg()
    x, ct = _layer_inputs(cfg)
    want = _layer(cfg, inputs[1][RWKV], x, ct)
    mesh = _mesh()
    for got in ranks:
        res = got["layer"]
        _within({"out": res["out"], "dx": res["dx"]},
                {"out": want["out"], "dx": want["dx"]}, EXACT_RTOL, "block")
        assert sorted(res["grads"]) == sorted(want["grads"])
        for k, g in want["grads"].items():
            spec = P.param_spec(f"blocks.{k}", (1,) + tuple(g.shape), mesh,
                                None)
            block = P.shard_leaf(g[None], spec, mesh, got["coord"])[0]
            assert res["grads"][k].shape == block.shape, k
            _within({k: res["grads"][k]}, {k: block}, EXACT_RTOL, "grad")


@pytest.mark.parametrize("arch", [RWKV, VLM])
def test_exact_epoch_matches_jax(ranks, jax_steps, arch):
    """JAX's global-batch exact step over the same 2 workers (a stand-in
    mesh): the loss and the parameters within EXACT_RTOL on every rank."""
    loss, want, _ = jax_steps[arch, "exact", N]
    name = "exact" if arch == RWKV else "vlm_exact"
    for got in ranks:
        np.testing.assert_allclose(got[name]["loss"], loss, rtol=EXACT_RTOL)
        _within(got[name]["whole"], want, EXACT_RTOL, f"{arch} exact")


@pytest.mark.parametrize("arch", [RWKV, VLM])
def test_gossip_epoch_matches_jax(ranks, jax_steps, arch):
    """JAX's gossip step over the same 2 workers on the same batch: the
    loss, the primal and each worker's dual (gathered from its model
    ranks' blocks) within EXACT_RTOL."""
    loss, primal, duals = jax_steps[arch, "gossip", N]
    name = "gossip" if arch == RWKV else "vlm_gossip"
    for got in ranks:
        np.testing.assert_allclose(got[name]["loss"], loss, rtol=EXACT_RTOL)
        _within(got[name]["whole"], primal, EXACT_RTOL, f"{arch} primal")
    shapes = {k: v.shape for k, v in duals[0].items()}
    for i in range(N):
        z = _worker_dual(ranks, name, i, shapes, _mesh())
        _within(z, duals[i], EXACT_RTOL, f"{arch} z worker {i}")


@pytest.mark.parametrize("name", list(SESSIONS))
def test_sessions_match_the_one_process_session(ranks, one_process, name):
    """The loss within EXACT_RTOL on every rank; the primal within
    EXACT_RTOL (quantized: each worker's dual, gathered from its model
    ranks' blocks, within STACK_RTOL of the stack); the exact epoch's
    bytes over "data" and "model" the dry-run's, the gossip epochs' none
    over "data"."""
    from repro_torch.launch import dryrun
    want = one_process[name]
    arch = SESSIONS[name][0]
    for got in ranks:
        res = got[name]
        np.testing.assert_allclose(res["loss"], want["loss"],
                                   rtol=EXACT_RTOL)
        if "gossip_q" not in name:
            _within(res["whole"], want["whole"], EXACT_RTOL, name)
        if "exact" not in name:
            assert res["bytes"]["gathered_bytes"] == 0
            assert res["bytes"]["scattered_bytes"] == 0
        elif arch == RWKV:
            held = dict(dryrun.rank_fsdp_bytes(_cfg(), _mesh()),
                        **dryrun.rank_model_bytes(_cfg(), _mesh(),
                                                  PER * SEQ))
            assert res["bytes"] == held, (res["bytes"], held)
    if "gossip" not in name and name != "pipelined":
        return
    shapes = {k: v.shape[1:] for k, v in want["blocks"].items()}
    num = den = 0.0
    for i in range(N):
        z = _worker_dual(ranks, name, i, shapes, _mesh())
        zi = {k: v[i] for k, v in want["blocks"].items()}
        if "gossip_q" not in name:
            _within(z, zi, EXACT_RTOL, f"{name} z worker {i}")
        for k, v in zi.items():
            num += float(((z[k] - v) ** 2).sum())
            den += float((v ** 2).sum())
    assert num <= STACK_RTOL ** 2 * den, (name, num, den)


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("arch", [RWKV, VLM])
def test_engine_matches_one_process(ranks, one_process, engines, arch,
                                    against):
    """Every prefill's logits and every decode round's whole (slots,
    vocab) logits within LOGIT_TOL on every rank, the greedy tokens equal
    (vlm: the prompts' embedding rows from the vocab-parallel lookup)."""
    key = "engine" if arch == RWKV else "vlm_engine"
    want = engines[arch] if against == "jax" else \
        one_process["engine" if arch == RWKV else f"engine_{arch}"]
    for got in ranks:
        _engine_matches(got[key], {**want, "logits": [
            np.asarray(w) for w in want["logits"]]}, f"{arch} {against}")


def test_each_rank_holds_its_heads_states(ranks, engines):
    """After the first decode round each rank's wkv states are its head
    of JAX's state (padded to PAD heads, cut to the native 2) for its
    worker's slot rows, within LOGIT_TOL; the token shifts are d-wide,
    equal on a worker's two ranks."""
    want = engines[RWKV]["caches"][0]
    heads = _cfg().d_model // 64
    assert want.shape[2] == PAD
    per = SLOTS // N
    for got in ranks:
        s = got["engine"]["caches"][0]
        h = heads // M
        assert s.shape[2] == h
        rows = slice(got["worker"] * per, (got["worker"] + 1) * per)
        _close(s.numpy(), want[:, rows, :heads][:, :, got["m"] * h:
                                                (got["m"] + 1) * h],
               f"states rank {got['coord']}")
        twin = next(r for r in ranks if r["worker"] == got["worker"]
                    and r["m"] != got["m"])
        for a, b in zip(got["engine"]["caches"][1:],
                        twin["engine"]["caches"][1:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["exact", "gossip"])
def test_an_rwkv6_save_at_model_2_is_the_one_process_archive(ranks,
                                                             spawned, kind):
    """The one-process archive restored into the ranks and saved again:
    JAX's loader reads the same whole leaves from both, bit for bit (the
    LoRA, the bonus and the mixes among them)."""
    jax = pytest.importorskip("jax")
    from repro.ckpt import checkpoint as jckpt
    outdir = spawned[2]
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
        assert any("u_bonus" in k for k in data.files)
        a = jckpt.load_checkpoint(one, 1, tree)
        b = jckpt.load_checkpoint(again, 1, tree)
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(path))


def test_the_serve_cli_serves_rwkv6_over_the_ranks(ranks):
    """``--arch rwkv6-3b --smoke --data 2 --model 2`` with a fine-tune
    session: every request served its new tokens, the same on every
    rank."""
    new = int(SERVE_ARGV[SERVE_ARGV.index("--new-tokens") + 1])
    cli = ranks[0]["cli"]
    assert len(cli) == 4 and all(len(t) == new for t in cli)
    assert all(got["cli"] == cli for got in ranks)


# ---------------------------------------------------------------------------
# (data 1, model 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", WIDE)
def test_wide_exact_epoch_matches_jax(ranks, jax_steps, one_process, arch):
    """JAX's exact step at data 1 on the same parameters and batch: the
    loss and the parameters within EXACT_RTOL on every rank (the vlm, two
    ranks to a KV head; RWKV4, one head, a quarter of the LoRA's rank and
    of the ffn a rank); RWKV4's also within EXACT_RTOL of the one-process
    session's."""
    wants = [jax_steps[arch, "exact", 1][:2]]
    if arch == RWKV4:
        wants.append(tuple(one_process["wide_exact"][k]
                           for k in ("loss", "whole")))
    for (loss, want), against in zip(wants, ("jax", "port")):
        for got in ranks:
            res = got[f"wide_exact_{arch}"]
            np.testing.assert_allclose(res["loss"], loss, rtol=EXACT_RTOL)
            _within(res["whole"], want, EXACT_RTOL,
                    f"{arch} wide exact against {against}")


def test_wide_vlm_gossip_epoch_matches_jax(ranks, jax_steps):
    """JAX's gossip step with one worker (its consensus the identity) on
    the same parameters and batch: internvl2's loss, primal and dual over
    four model ranks, two to a KV head, within EXACT_RTOL."""
    loss, primal, duals = jax_steps[VLM, "gossip", 1]
    shapes = {k: v.shape for k, v in duals[0].items()}
    for got in ranks:
        np.testing.assert_allclose(got["wide_gossip"]["loss"], loss,
                                   rtol=EXACT_RTOL)
        _within(got["wide_gossip"]["whole"], primal, EXACT_RTOL,
                "vlm wide primal")
    from repro_torch.dist import params as P
    rows = {(0, got["m4"]): {k: v[0] for k, v in
                             got["wide_gossip"]["blocks"].items()}
            for got in ranks}
    z = P.gather_tree(rows, _mesh((1, 4)), shapes, None)
    _within(z, duals[0], EXACT_RTOL, "vlm wide z")


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("arch", WIDE)
def test_wide_engine_matches_one_process(ranks, one_process, engines, arch,
                                         against):
    """Every logits tensor within LOGIT_TOL of the one-process engine's
    and of JAX's ``SlotEngine``, the greedy tokens equal; an RWKV6 rank's
    states (its one head, not padded) its head of either engine's state
    (padded to PAD4 heads, cut to the native 4)."""
    want = engines[arch] if against == "jax" else \
        one_process[f"engine_{arch}"]
    heads = _cfg(arch).d_model // 64
    for got in ranks:
        assert got["m4"] in range(4)
        _engine_matches(got[f"wide_engine_{arch}"], {**want, "logits": [
            np.asarray(w) for w in want["logits"]]}, f"{arch} {against}")
        if arch == RWKV4:
            s = got[f"wide_engine_{arch}"]["caches"][0]
            m = got["m4"]
            whole = np.asarray(want["caches"][0])
            assert s.shape[2] == 1 and whole.shape[2] == PAD4
            _close(s.numpy(), whole[:, :, :heads][:, :, m:m + 1],
                   f"wide states rank {m} against {against}")


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
