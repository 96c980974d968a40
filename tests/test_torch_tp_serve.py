"""Serving and checkpoints over a model axis: four gloo ranks as (data 2,
model 2) on the CPU against the one-process port and JAX.

Four ranks start as subprocesses of this file (``python
tests/test_torch_tp_serve.py STORE RANK WORLD OUTDIR``), meet through a
``file://`` store in the test's temporary directory, each on one intra-op
thread, and run at the fp32 smoke config on the parent's parameters
(JAX's ``init_params``, carried across through numpy):

  * the slot engine over the group (each worker owns half of the slot
    rows, each model rank its heads and its columns of the vocabulary):
    every logits tensor it samples from (each request's prefill, each
    decode round's whole (slots, vocab) array) within ``LOGIT_TOL`` of
    the one-process port engine's and of JAX's ``SlotEngine``, and the
    greedy tokens equal;
  * the scheduler on a ``SyntheticClock`` with a fine-tune session over
    the same ranks, exact (FSDP x TP) and gossip (TP): the rounds, the
    admissions, the epochs absorbed and the tokens of the one-process
    scheduler, the primal within ``EXACT_RTOL``, and after each absorbed
    epoch the engine's parameters bit for bit this rank's blocks of the
    session's;
  * checkpoints at model 2 (exact, pipelined gossip, async gossip at D 2:
    the parameters and optimizer state, the dual rows, an in-flight
    payload, the queue's slots and snapshots): a one-process save restored
    into the ranks and saved again is the same archive, leaf for leaf,
    read by JAX's ``repro.ckpt`` loader; restored in one process it is
    the one-process state bit for bit; and the ranks' next epoch after the
    restore matches the one-process session's;
  * the train CLI with ``--ckpt-dir`` and ``--restore`` at ``--model 2``
    against the one-process ``--data 2`` CLI.

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
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N, M, PER, SEQ = 2, 2, 2, 16
SLOTS, CACHE = 4, 24
# (prompt length, new tokens): six requests over four slots, so that slots
# retire and refill; prompts pad to the 8 and 16 buckets
PROMPTS = ((5, 4), (9, 3), (12, 5), (7, 2), (14, 4), (3, 3))
JOIN_S = 240.0          # the whole spawn's deadline
PG_TIMEOUT_S = 120      # a collective that waits longer fails the rank
LOGIT_TOL = 1e-5        # fp32: TP sums each head group and half of the ffn
EXACT_RTOL = 1e-5       # the primal after fine-tune epochs (as test_torch_tp)
CLI_RTOL = 1e-3         # the bf16 smoke config: partial products rounded
ROUNDS = 5
# the scheduler's synthetic costs: arrivals 0.5 s apart leave idle time
# for the fine-tune epochs between requests
COSTS = dict(prefill_tok_s=0.001, decode_round_s=0.01, train_epoch_s=0.05)
GAP_S, BUDGET_S, EPOCHS = 0.5, 0.2, 2
CKPT = {"exact": dict(consensus="exact"),
        "pipelined": dict(consensus="gossip", pipeline=True),
        "async": dict(consensus="gossip", async_epochs=True, staleness=2)}
CLI_ARGV = ["--smoke", "--batch-per-worker", str(PER), "--seq-len",
            str(SEQ), "--sim-clock", "--prefetch", "0", "--data", str(N)]


def _cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                               dtype="float32")


def _requests(vocab: int, arrivals: bool = False) -> list:
    from repro_torch.serve import Request
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                                 plen)],
                    max_new_tokens=new,
                    arrival_s=GAP_S * i if arrivals else 0.0)
            for i, (plen, new) in enumerate(PROMPTS)]


def _drain(engine, reqs) -> None:
    pending = list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()


def _recording(engine) -> list:
    """Every logits tensor the engine samples from, in order."""
    seen, sample = [], engine._sample

    def spy(logits):
        seen.append(logits.detach().clone())
        return sample(logits)

    engine._sample = spy
    return seen


def _session(consensus="exact", params=None, mesh=None, **spec):
    from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,
                                 TrainSpec)
    if params is not None:
        params = {k: v.clone() for k, v in params.items()}
    return AMBSession(TrainSpec(smoke=True, data=N, model=M,
                                batch_per_worker=PER, seq_len=SEQ),
                      ClockSpec(kind="simulated"),
                      ConsensusSpec(consensus=consensus, graph="ring",
                                    gossip_rounds=ROUNDS, **spec),
                      cfg=_cfg(), params=params, device="cpu", mesh=mesh)


def _schedule(session, group=None, tp=None, check=None) -> dict:
    """The scheduler on the synthetic clock over ``session`` (EPOCHS
    fine-tune epochs at most); ``check()`` after each absorbed one."""
    from repro_torch.serve import (AdmissionPolicy, RequestQueue,
                                   ServeScheduler, SlotEngine,
                                   SyntheticClock)
    cfg = session.cfg
    reqs = _requests(cfg.vocab_size, arrivals=True)
    queue = RequestQueue(AdmissionPolicy(cache_len=CACHE))
    for r in reqs:
        queue.push(r)
    engine = SlotEngine(session.serving_params(), cfg, slots=SLOTS,
                        cache_len=CACHE, group=group, tp=tp)
    sched = ServeScheduler(engine, queue, round_budget_s=BUDGET_S,
                           clock=SyntheticClock(**COSTS), session=session,
                           train_epochs=EPOCHS)
    if check is not None:
        train = sched._train_once

        def checked(deadline):
            ran = train(deadline)
            if ran:
                check(engine)
            return ran

        sched._train_once = checked
    report = sched.run()
    return {"rounds": report.rounds, "epochs": report.train_epochs,
            "tokens": [r.out_tokens for r in reqs],
            "stamps": [(r.admit_s, r.first_token_s, r.finish_s)
                       for r in reqs],
            "whole": {k: v.detach().clone()
                      for k, v in session.params.items()}}


def _state(session) -> list:
    """(path, tensor or number) of every leaf of the session's state."""
    from repro_torch.ckpt.checkpoint import _leaves
    return [(k, v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in _leaves(session.state)]


def rank_main(store: str, rank: int, world: int, outdir: str) -> None:
    """One rank: the engine, the scheduler, the checkpoints and the CLI;
    results to ``outdir``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import AMBSession
    from repro_torch.dist.group import WorkerGroup
    from repro_torch.dist.params import shard_tree
    from repro_torch.dist.tp import TensorParallel
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import SlotEngine
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    outdir = Path(outdir)
    try:
        params = torch.load(outdir / "params.pt")
        cfg = _cfg()
        mesh = make_host_mesh(N, M, device="cpu")
        coord = mesh.get_coordinate()
        out = {"coord": tuple(int(c) for c in coord)}

        # the slot engine alone
        group = WorkerGroup(mesh, "cpu")
        tp = TensorParallel(group, {k: v.shape for k, v in params.items()},
                            None, cfg)
        engine = SlotEngine(shard_tree(params, mesh, coord, None), cfg,
                            slots=SLOTS, cache_len=CACHE, group=group, tp=tp)
        seen = _recording(engine)
        reqs = _requests(cfg.vocab_size)
        _drain(engine, reqs)
        out["engine"] = {"logits": seen,
                         "tokens": [r.out_tokens for r in reqs],
                         "rows": (engine.r0, engine.r1),
                         "kv_heads": engine.state.caches.k.shape[3]}

        # the scheduler with a fine-tune session over the same ranks
        for consensus in ("exact", "gossip"):
            session = _session(consensus, params, mesh)
            held = []

            def check(engine, session=session, held=held):
                want = shard_tree(session.params, mesh, coord, None)
                held.append(all(torch.equal(engine.params[k], v)
                                for k, v in want.items()))

            res = _schedule(session, session.group, session.serving_tp,
                            check)
            res["held"] = held
            out[f"sched_{consensus}"] = res

        # checkpoints: the one-process archive into the ranks and back
        for kind, spec in CKPT.items():
            session = AMBSession.restore(outdir / f"one_{kind}", cfg=cfg,
                                         device="cpu")
            session.save(outdir / f"ranks_{kind}")
            m = session.run(1, prefetch=0)
            session.flush()
            out[f"ckpt_{kind}"] = {"loss": m["loss"],
                                   "whole": session.params,
                                   "steps": session.steps_done}
            session.save(outdir / f"ranks2_{kind}")
            back = AMBSession.restore(outdir / f"ranks2_{kind}", cfg=cfg,
                                      device="cpu")
            out[f"ckpt_{kind}"]["again"] = all(
                a == b and (not isinstance(x, torch.Tensor)
                            or torch.equal(x, y))
                for (a, x), (b, y) in zip(_state(session), _state(back)))

        # the train CLI, saving and resuming at model 2
        for consensus in ("exact", "gossip"):
            ck = outdir / f"cli_ck_{consensus}"
            train.main(CLI_ARGV + ["--model", str(M), "--consensus",
                                   consensus, "--steps", "2",
                                   "--ckpt-dir", str(ck), "--metrics",
                                   str(outdir / f"cli_a_{consensus}.jsonl")],
                       device="cpu")
            out[f"cli_{consensus}"] = train.main(
                ["--restore", str(ck), "--steps", "1", "--prefetch", "0",
                 "--metrics", str(outdir / f"cli_b_{consensus}.jsonl")],
                device="cpu")
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
    """JAX's initial parameters of the fp32 smoke config and the port's
    copy of them."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro_torch import models
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    params = {k: v.detach() for k, v in models.from_jax_params(
        jax.tree.map(np.asarray, jparams), _cfg(), device="cpu")
        .params().items()}
    return jcfg, jparams, params


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """The one-process sessions the ranks restore (one epoch each, saved),
    then the ranks."""
    outdir = tmp_path_factory.mktemp("ranks_tp_serve")
    params = inputs[2]
    torch.save(params, outdir / "params.pt")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states = {}
        for kind, spec in CKPT.items():
            session = _session(params=params, **spec)
            session.run(1, prefetch=0)
            session.save(outdir / f"one_{kind}")
            states[kind] = _state(session)
    finally:
        torch.set_num_threads(before)
    return spawn(outdir), outdir, states


@pytest.fixture
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_engine(inputs):
    """The one-process port engine on the same requests."""
    from repro_torch.serve import SlotEngine
    cfg = _cfg()
    engine = SlotEngine(inputs[2], cfg, slots=SLOTS, cache_len=CACHE)
    seen = _recording(engine)
    reqs = _requests(cfg.vocab_size)
    _drain(engine, reqs)
    return {"logits": seen, "tokens": [r.out_tokens for r in reqs]}


@pytest.fixture(scope="module")
def jax_engine(inputs):
    """JAX's one-process ``SlotEngine`` on the same requests, every
    logits array its sampler draws from."""
    from repro import serve as jserve
    jcfg, jparams, _ = inputs
    engine = jserve.SlotEngine(jparams, jcfg, slots=SLOTS, cache_len=CACHE)
    seen, sample = [], engine._sample

    def spy(logits, key):
        seen.append(np.asarray(logits))
        return sample(logits, key)

    engine._sample = spy
    reqs = [jserve.Request(rid=r.rid, prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens)
            for r in _requests(_cfg().vocab_size)]
    _drain(engine, reqs)
    return {"logits": seen, "tokens": [r.out_tokens for r in reqs]}


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(want).max())), (what,
                                                                     err)


# ---------------------------------------------------------------------------
# The slot engine over (data 2, model 2)
# ---------------------------------------------------------------------------

def test_each_worker_holds_its_rows_and_each_rank_its_kv_heads(ranks):
    for got in ranks:
        w = got["coord"][0]
        assert got["engine"]["rows"] == (w * SLOTS // N,
                                         (w + 1) * SLOTS // N)
        assert got["engine"]["kv_heads"] == _cfg().num_kv_heads // M


@pytest.mark.parametrize("against", ["port", "jax"])
def test_engine_logits_and_greedy_tokens_match_one_process(
        ranks, one_engine, jax_engine, against):
    """Each prefill's logits and each decode round's whole (slots, vocab)
    logits within LOGIT_TOL on every rank; the greedy tokens equal."""
    want = one_engine if against == "port" else jax_engine
    for got in ranks:
        assert got["engine"]["tokens"] == want["tokens"]
        assert len(got["engine"]["logits"]) == len(want["logits"])
        for i, (g, w) in enumerate(zip(got["engine"]["logits"],
                                       want["logits"])):
            _close(g.numpy(), w, f"{against} draw {i}")


# ---------------------------------------------------------------------------
# The scheduler with a fine-tune session over the same ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_scheduler_with_fine_tune_matches_one_process(ranks, inputs,
                                                      consensus):
    """The rounds, admissions, epochs absorbed and tokens of the
    one-process scheduler; the primal within EXACT_RTOL; the engine's
    parameters bit for bit the session's blocks after every epoch."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _schedule(_session(consensus, inputs[2]))
    finally:
        torch.set_num_threads(before)
    assert want["epochs"] == EPOCHS
    for got in ranks:
        res = got[f"sched_{consensus}"]
        assert res["held"] == [True] * EPOCHS
        for key in ("rounds", "epochs", "tokens", "stamps"):
            assert res[key] == want[key], key
        for k, w in want["whole"].items():
            err = float((res["whole"][k] - w).abs().max())
            assert err <= EXACT_RTOL * max(1.0, float(w.abs().max())), k


# ---------------------------------------------------------------------------
# Checkpoints at model 2
# ---------------------------------------------------------------------------

def _like(path: Path) -> dict:
    """A nested tree of numpy arrays shaped as the archive's leaves."""
    data = np.load(path / "arrays.npz")
    tree: dict = {}
    for key in data.files:
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(data[key].shape, np.float32)
    return tree


@pytest.mark.parametrize("kind", list(CKPT))
def test_a_save_at_model_2_is_the_one_process_archive(spawned, kind):
    """The one-process archive restored into the ranks and saved again:
    JAX's loader reads the same whole leaves from both, bit for bit (the
    primal and the state)."""
    jax = pytest.importorskip("jax")
    from repro.ckpt import checkpoint as jckpt
    _, outdir, _ = spawned
    for sub in ("", "session_state"):
        one, again = outdir / f"one_{kind}" / sub, \
            outdir / f"ranks_{kind}" / sub
        like = _like(one / "step_00000001")
        a = jckpt.load_checkpoint(one, 1, like)
        b = jckpt.load_checkpoint(again, 1, like)
        leaves = jax.tree_util.tree_leaves_with_path(a)
        assert leaves
        for (path, x), y in zip(leaves, jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(path))


@pytest.mark.parametrize("kind", list(CKPT))
def test_one_process_to_ranks_to_one_process_is_bit_for_bit(spawned, kind):
    """The ranks' save of a restored one-process state, restored in one
    process: every leaf of the state bit for bit the one-process
    session's; and the ranks' own save read back by the ranks is what
    they saved."""
    from repro_torch.api import AMBSession
    ranks, outdir, states = spawned
    back = AMBSession.restore(outdir / f"ranks_{kind}", cfg=_cfg(),
                              device="cpu")
    got = _state(back)
    assert [k for k, _ in got] == [k for k, _ in states[kind]]
    for (key, x), (_, y) in zip(got, states[kind]):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert x == y, key
    assert all(r[f"ckpt_{kind}"]["again"] for r in ranks)


@pytest.mark.parametrize("kind", list(CKPT))
def test_the_restored_ranks_take_the_one_process_epoch(spawned, kind):
    """After the restore the ranks' epoch is the one-process session's:
    the step count, the loss and the primal within EXACT_RTOL."""
    from repro_torch.api import AMBSession
    ranks, outdir, _ = spawned
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = AMBSession.restore(outdir / f"one_{kind}", cfg=_cfg(),
                                 device="cpu")
        m = one.run(1, prefetch=0)
        one.flush()
        want = one.params
    finally:
        torch.set_num_threads(before)
    for got in ranks:
        res = got[f"ckpt_{kind}"]
        assert res["steps"] == one.steps_done == 2
        assert res["loss"] == pytest.approx(m["loss"], rel=EXACT_RTOL)
        for k, w in want.items():
            w = w.detach()
            err = float((res["whole"][k] - w).abs().max())
            assert err <= EXACT_RTOL * max(1.0, float(w.abs().max())), k


def _losses(path: Path) -> list:
    return [json.loads(x)["loss"] for x in path.read_text().splitlines()]


@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_train_cli_saves_and_resumes_at_model_2(spawned, tmp_path,
                                                consensus):
    """``--ckpt-dir`` then ``--restore`` over four ranks at ``--model 2``
    against the same in one process at ``--data 2`` (the smoke config's
    bf16: within CLI_RTOL); rank 0 alone wrote the metrics."""
    from repro_torch.launch.train import main
    ranks, outdir, _ = spawned
    ck = tmp_path / "ck"
    main(CLI_ARGV + ["--consensus", consensus, "--steps", "2",
                     "--ckpt-dir", str(ck), "--metrics",
                     str(tmp_path / "a.jsonl")], device="cpu")
    want = main(["--restore", str(ck), "--steps", "1", "--prefetch", "0",
                 "--metrics", str(tmp_path / "b.jsonl")], device="cpu")
    for got in ranks:
        assert got[f"cli_{consensus}"] == pytest.approx(want, rel=CLI_RTOL)
    for part in ("a", "b"):
        np.testing.assert_allclose(
            _losses(outdir / f"cli_{part}_{consensus}.jsonl"),
            _losses(tmp_path / f"{part}.jsonl"), rtol=CLI_RTOL)


if __name__ == "__main__":
    store_, rank_, world_, outdir_ = sys.argv[1:5]
    rank_main(store_, int(rank_), int(world_), outdir_)
