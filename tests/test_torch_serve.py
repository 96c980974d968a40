"""The port's serving tier against ``repro.serve`` and ``repro.models``.

Weights come from the JAX ``init_params`` through the numpy bridge, in
fp32, so both sides compute the same function: logits and caches agree to
fp32 summation order (rtol 1e-4, atol 1e-5, as ``test_torch_models.py``),
and greedy tokens, which follow from the logits, are equal.  Scheduler
tests run on the synthetic clock, where every timestamp is exact
arithmetic over the configured op costs: the port's summaries equal
JAX's.  The fine-tune leg uses one stub session with the scheduler's
contract on both sides, and once a real ``AMBSession`` on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models.common import ArchConfig as JArchConfig  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.kernels import router  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.metrics import MetricsLogger, read_metrics  # noqa: E402
from repro_torch.models.common import ArchConfig  # noqa: E402
from repro_torch.serve import (AdmissionPolicy, Request,  # noqa: E402
                               RequestQueue, SamplingSpec, ServeMetrics,
                               ServeScheduler, SlotEngine, SyntheticClock,
                               bucket_len, request_record, sample_token,
                               serve_static, static_generate,
                               synthetic_requests)
from repro_torch.serve.sampling import sample_generator  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
            dtype="float32")
JCFG = JArchConfig(**TINY, q_chunk=64, kv_chunk=64, mxu_f32_accum=False)
CFG = ArchConfig(**TINY)
_CACHE: dict = {}


def _params(jcfg=JCFG, cfg=CFG, seed=0):
    """(JAX params, the port's parameter dict) with the same weights."""
    key = (jcfg.name, seed)
    if key not in _CACHE:
        jp = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
        model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu")
        _CACHE[key] = (jp, model.params())
    return _CACHE[key]


def _smoke():
    return (dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                                dtype="float32"),
            dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                                dtype="float32"))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _requests(prompts, new, arrivals=None):
    arrivals = arrivals or [0.0] * len(prompts)
    return [Request(rid=i, prompt=list(p), max_new_tokens=n, arrival_s=a)
            for i, (p, n, a) in enumerate(zip(prompts, new, arrivals))]


def _jrequests(reqs):
    return [jserve.Request(rid=r.rid, prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens,
                           arrival_s=r.arrival_s) for r in reqs]


def _drain(engine, reqs):
    pending = list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()


# ---------------------------------------------------------------------------
# prefill + decode against repro.models
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_jax():
    jcfg, cfg = _smoke()
    jp, tp = _params(jcfg, cfg, seed=1)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    last = np.array([11, 5, 8], np.int32)
    jlog, jst = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                extra_capacity=6, last_pos=jnp.asarray(last))
    router.reset_launches()
    log, st = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                             extra_capacity=6,
                             last_pos=torch.from_numpy(last))
    assert router.launches() == {}             # the plain version on CPU
    assert st.caches.k.shape == (cfg.num_layers, 3, 18, cfg.num_kv_heads,
                                 cfg.hd)
    _close(log, jlog)
    for step in range(4):
        _close(st.caches.k, jst.caches.k)
        _close(st.caches.v, jst.caches.v)
        np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        jlog, jst = jmodels.decode_step(jp, jcfg, jst, jnp.asarray(tok))
        log, st = models.decode_step(tp, cfg, st, torch.from_numpy(tok))
        _close(log, jlog)


def test_prefill_scalar_position_and_unservable_configs():
    jcfg, cfg = _smoke()
    jp, tp = _params(jcfg, cfg, seed=1)
    toks = np.arange(10, dtype=np.int32)[None, :] * 7 % cfg.vocab_size
    jlog, jst = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    log, st = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(log, jlog)
    assert st.pos.dim() == 0 and int(st.pos) == int(jst.pos) == 10
    _, ring = models.prefill(tp, dataclasses.replace(cfg, sliding_window=8),
                             {"tokens": torch.from_numpy(toks)})
    assert ring.caches.ring and ring.caches.k.shape[2] == 8
    # the audio family is served since whisper's port: JAX's state, a
    # zero enc_kv of encoder_seq (unset here: 1500) frames beside the
    # caches
    audio = models.init_decode_state(dataclasses.replace(cfg, family="audio"),
                                     2, 16, device="cpu")
    want = (cfg.num_layers, 2, 1500, cfg.num_kv_heads, cfg.hd)
    assert [tuple(t.shape) for t in audio.enc_kv] == [want, want]
    assert not any(t.any() for t in audio.enc_kv)
    assert audio.caches.k.shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                                    cfg.hd)


def test_insert_evict_state_helpers_match_jax():
    jp, tp = _params()
    cache_len, plen = 32, 6
    toks = np.array([[1, 2, 3, 4, 5, 6]], np.int32)
    _, jone = jmodels.prefill(jp, JCFG, {"tokens": jnp.asarray(toks)},
                              extra_capacity=cache_len - plen)
    jbig = jmodels.insert_decode_state(
        jmodels.init_decode_state(JCFG, 3, cache_len, per_slot_pos=True),
        jone, 1)
    big = models.init_decode_state(CFG, 3, cache_len, per_slot_pos=True,
                                   device="cpu")
    assert big.pos.shape == (3,)
    _, one = models.prefill(tp, CFG, {"tokens": torch.from_numpy(toks)},
                            extra_capacity=cache_len - plen)
    assert models.insert_decode_state(big, one, 1) is big
    assert big.pos.tolist() == np.asarray(jbig.pos).tolist() == [0, plen, 0]
    _close(big.caches.k, jbig.caches.k)
    _close(big.caches.v, jbig.caches.v)
    assert torch.equal(big.caches.k[:, 1], one.caches.k[:, 0])
    models.evict_decode_state(big, 1)
    assert int(big.pos[1]) == 0
    assert not big.caches.k[:, 1].any() and not big.caches.v[:, 1].any()


# ---------------------------------------------------------------------------
# buckets + request layer (a copy of repro.serve.request)
# ---------------------------------------------------------------------------

def test_bucket_len():
    for plen, cap in [(3, 64), (8, 64), (9, 64), (33, 64), (100, 64),
                      (1536, 2592), (2049, 2592)]:
        assert bucket_len(plen, cap, exact=False) == jserve.bucket_len(
            plen, cap, exact=False)
    assert bucket_len(2049, 2592, exact=False) == 2592
    assert bucket_len(13, 64, exact=True) == 13


def test_synthetic_requests_match_jax():
    kw = dict(vocab_size=151936, prompt_len=64, prompt_jitter=16,
              max_new_tokens=8, arrival_gap_s=0.25, seed=11)
    ours, theirs = synthetic_requests(6, **kw), jserve.synthetic_requests(
        6, **kw)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival_s) for r in ours] \
        == [(r.rid, r.prompt, r.max_new_tokens, r.arrival_s) for r in theirs]


def test_admission_and_queue_ordering():
    q = RequestQueue(AdmissionPolicy(cache_len=16, max_queue=2))
    assert q.push(Request(rid=0, prompt=[1] * 8, max_new_tokens=8))
    too_big = Request(rid=1, prompt=[1] * 8, max_new_tokens=9)
    assert not q.push(too_big) and too_big.finish_reason == "rejected"
    assert q.push(Request(rid=2, prompt=[1] * 4, max_new_tokens=4))
    overflow = Request(rid=3, prompt=[1] * 4, max_new_tokens=4)
    assert not q.push(overflow)                      # max_queue=2 bound
    assert len(q) == 2 and q.rejected == [too_big, overflow]
    q = RequestQueue()
    for rid, t in [(0, 2.0), (1, 0.5), (2, 1.0)]:
        q.push(Request(rid=rid, prompt=[1], max_new_tokens=1, arrival_s=t))
    assert q.next_arrival_s() == 0.5 and q.pop_ready(0.0) is None
    assert [q.pop_ready(1.5).rid, q.pop_ready(1.5).rid] == [1, 2]
    assert q.pop_ready(1.5) is None and q.pop_ready(2.0).rid == 0


# ---------------------------------------------------------------------------
# slot engine: parity with static batching and with the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8, 2, 4], [11, 13], [6] * 9,
           [40, 41, 42, 43, 44]]
NEW = [4, 6, 3, 5, 4]


def test_slot_engine_matches_static_and_jax_engine():
    jp, tp = _params()
    cont = _requests(PROMPTS, NEW)
    engine = SlotEngine(tp, CFG, slots=2, cache_len=32)
    _drain(engine, cont)
    assert engine.buckets == {8, 16}
    stat = static_generate(tp, CFG, _requests(PROMPTS, NEW), cache_len=32)
    jreqs = _jrequests(cont)
    _drain(jserve.SlotEngine(jp, JCFG, slots=2, cache_len=32), jreqs)
    for c, s, j in zip(cont, stat, jreqs):
        assert c.out_tokens == j.out_tokens, (c.rid, c.out_tokens,
                                              j.out_tokens)
        assert s.out_tokens == j.out_tokens
        assert c.finish_reason == s.finish_reason == "length"


def test_slot_insert_retire_reuse():
    _, tp = _params()
    engine = SlotEngine(tp, CFG, slots=2, cache_len=32)
    r0, r1 = _requests([[3, 4, 5], [6, 7]], [2, 4])
    engine.insert(r0)
    engine.insert(r1)
    assert not engine.has_free and {r0.slot, r1.slot} == {0, 1}
    assert engine.decode_round() == [r0] and r0.finish_reason == "length"
    assert engine.has_free and engine.active_count == 1
    r2 = Request(rid=2, prompt=[9, 10, 11, 12], max_new_tokens=2)
    engine.insert(r2)
    assert r2.slot == r0.slot
    while engine.active_count:
        engine.decode_round()
    assert [len(r.out_tokens) for r in (r0, r1, r2)] == [2, 4, 2]
    assert sorted(engine.free_slots) == [0, 1]


def test_slot_engine_rejects_unservable():
    _, tp = _params()
    with pytest.raises(NotImplementedError, match="sliding-window"):
        SlotEngine(tp, dataclasses.replace(CFG, sliding_window=8), slots=1,
                   cache_len=16)
    engine = SlotEngine(tp, CFG, slots=1, cache_len=16)
    with pytest.raises(ValueError, match="exceed cache_len"):
        engine.insert(Request(rid=0, prompt=[1] * 10, max_new_tokens=8))


# ---------------------------------------------------------------------------
# scheduler on the synthetic clock, against repro.serve
# ---------------------------------------------------------------------------

class _StubSource:
    def batch(self, i):
        return i


class _StubSession:
    """The scheduler's session contract (the JAX tests' stub)."""

    def __init__(self, params):
        self.params = params
        self.steps_done = 0

    def batch_source(self):
        return _StubSource()

    def step(self, batch):
        self.steps_done += 1
        return {"loss": 1.0 / self.steps_done}


def _lane(pkg, params, cfg, reqs, *, slots, budget, costs, train=0,
          known_cost=None):
    queue = pkg.RequestQueue(pkg.AdmissionPolicy(cache_len=32))
    for r in reqs:
        queue.push(r)
    stub = _StubSession(params)
    sched = pkg.ServeScheduler(
        pkg.SlotEngine(params, cfg, slots=slots, cache_len=32), queue,
        round_budget_s=budget, clock=pkg.SyntheticClock(**costs),
        session=stub if train else None, train_epochs=train)
    if known_cost is not None:
        sched._train_cost = known_cost
    return sched, sched.run()


@pytest.mark.parametrize("lane", ["staggered", "budget_and_train"])
def test_scheduler_matches_jax_on_synthetic_clock(lane):
    jp, tp = _params()
    if lane == "staggered":
        reqs = synthetic_requests(5, vocab_size=CFG.vocab_size, prompt_len=6,
                                  prompt_jitter=2, max_new_tokens=3,
                                  arrival_gap_s=0.2, seed=2)
        kw = dict(slots=2, budget=0.1,
                  costs=dict(prefill_tok_s=0.001, decode_round_s=0.01))
    else:
        reqs = _requests([[1] * 8, [2] * 5], [3, 4], [0.0, 0.9])
        kw = dict(slots=2, budget=1.0, train=3,
                  costs=dict(prefill_tok_s=0.01, decode_round_s=0.1,
                             train_epoch_s=0.3))
    jreqs = _jrequests(reqs)
    sched, ours = _lane(tserve, tp, CFG,
                        reqs, **kw)
    jsched, theirs = _lane(jserve, jp, JCFG, jreqs, **kw)
    assert ours.rounds == theirs.rounds
    assert ours.train_epochs == theirs.train_epochs
    assert sched.metrics.train_losses == jsched.metrics.train_losses
    assert ours.summary.keys() == theirs.summary.keys()
    for k, v in theirs.summary.items():
        assert ours.summary[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    for r, j in zip(reqs, jreqs):
        assert r.out_tokens == j.out_tokens
        for stamp in ("admit_s", "first_token_s", "finish_s"):
            assert getattr(r, stamp) == pytest.approx(getattr(j, stamp))
    if lane == "budget_and_train":
        assert ours.train_epochs == 3 and sched.engine.params is tp


def test_scheduler_train_backs_off_under_load():
    _, tp = _params()

    def epochs(budget):
        reqs = _requests([[2] * 8] * 3, [3] * 3, [0.0, 0.1, 0.2])
        return _lane(tserve, tp, CFG, reqs,
                     slots=1, budget=budget, train=4, known_cost=0.5,
                     costs=dict(prefill_tok_s=0.01,
                                decode_round_s=0.1))[1].train_epochs

    assert epochs(0.3) == 0
    assert epochs(5.0) == 4


def test_serve_static_matches_jax():
    jp, tp = _params()
    reqs = _requests([[3] * 4, [5] * 6, [7] * 2, [9] * 5], [2, 3, 2, 1],
                     [0.0, 0.5, 1.0, 1.5])
    jreqs = _jrequests(reqs)
    costs = dict(prefill_tok_s=0.01, decode_round_s=0.1)
    ours = serve_static(tp, CFG, reqs, batch=2, cache_len=16,
                        clock=SyntheticClock(**costs))
    theirs = jserve.serve_static(jp, JCFG, jreqs, batch=2, cache_len=16,
                                 clock=jserve.SyntheticClock(**costs))
    assert ours.rounds == theirs.rounds
    for k, v in theirs.summary.items():
        assert ours.summary[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert reqs[0].first_token_s == pytest.approx(0.5 + 0.12)


# ---------------------------------------------------------------------------
# sampling and metrics
# ---------------------------------------------------------------------------

def test_sampling_top_k_and_seeded_determinism():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32))
    greedy = sample_token(logits)
    assert torch.equal(greedy, logits.argmax(-1))
    gen = sample_generator(0, 1, "cpu")
    assert torch.equal(sample_token(logits, gen, temperature=1.5, top_k=1),
                       greedy)
    with pytest.raises(ValueError):
        sample_token(logits, temperature=0.7)
    top5 = logits.topk(5, dim=-1).indices
    for i in range(20):
        got = sample_token(logits, sample_generator(0, i, "cpu"),
                           temperature=1.0, top_k=5)
        assert all(got[r] in top5[r] for r in range(3))
    assert SamplingSpec().greedy and not SamplingSpec(temperature=0.7).greedy
    _, tp = _params()

    def run(seed):
        engine = SlotEngine(tp, CFG, slots=2, cache_len=32,
                            sampling=SamplingSpec(temperature=0.9, top_k=8,
                                                  seed=seed))
        reqs = _requests([[7, 8, 9 + i] for i in range(3)], [6] * 3)
        _drain(engine, reqs)
        return [r.out_tokens for r in reqs]

    assert run(5) == run(5)
    assert len({tuple(map(tuple, run(s))) for s in (5, 6, 7)}) > 1


def test_serve_metrics_jsonl_round_trip(tmp_path):
    path = tmp_path / "serve.jsonl"
    metrics = ServeMetrics(MetricsLogger(str(path)))
    kw = dict(rid=0, prompt=[1, 2], max_new_tokens=3, arrival_s=1.0,
              admit_s=1.5, first_token_s=2.0, finish_s=4.0,
              out_tokens=[3, 4, 5], finish_reason="length")
    rec = metrics.complete(Request(**kw))
    assert rec == jserve.request_record(jserve.Request(**kw))
    assert rec == request_record(Request(**kw))
    metrics.train_step(0, 2.5)
    lines = read_metrics(path)
    assert [ln["kind"] for ln in lines] == ["request", "train"]
    assert lines[0]["ttft_s"] == pytest.approx(1.0)
    assert lines[0]["finish_reason"] == "length" and lines[1]["loss"] == 2.5
    assert json.loads(path.read_text().splitlines()[0])["step"] == 0
    s = metrics.summary()
    assert s["n_requests"] == 1 and s["total_tokens"] == 3
    assert s["span_s"] == pytest.approx(3.0)
    metrics.logger.close()
    metrics.logger.close()


# ---------------------------------------------------------------------------
# a real session in the loop, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_scheduler_fine_tunes_a_real_session(consensus):
    """Two epochs fill the first idle round (0.3 s each of a 1.0 s budget;
    the requests arrive at 2.0 s), then the engine serves with the primal
    the last epoch produced: its params are the session's, and its tokens
    are static batching's on those params."""
    _, cfg = _smoke()
    session = AMBSession(TrainSpec(smoke=True, data=2, batch_per_worker=2,
                                   seq_len=16),
                         ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus=consensus), cfg=cfg,
                         device="cpu")
    before = {k: v.detach().clone() for k, v in session.params.items()}
    engine = SlotEngine(session.params, cfg, slots=2, cache_len=32)
    prompts, new = [[5, 9, 2, 7], [1, 2, 3, 4, 5, 6]], [3, 4]
    queue = RequestQueue(AdmissionPolicy(cache_len=32))
    for r in _requests(prompts, new, [2.0, 2.0]):
        queue.push(r)
    sched = ServeScheduler(engine, queue, round_budget_s=1.0,
                           clock=SyntheticClock(prefill_tok_s=0.001,
                                                decode_round_s=0.01,
                                                train_epoch_s=0.3),
                           session=session, train_epochs=2)
    report = sched.run()
    assert report.train_epochs == 2 and session.steps_done == 2
    assert len(sched.metrics.train_losses) == 2
    assert all(np.isfinite(sched.metrics.train_losses))
    now = session.params
    assert any(not torch.equal(now[k], before[k]) for k in now)
    for k in now:
        assert torch.equal(engine.params[k], now[k]), k
    want = static_generate(now, cfg, _requests(prompts, new), cache_len=32)
    got = sorted(report.requests, key=lambda r: r.rid)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def test_serve_cli_runs_on_cpu(tmp_path, capsys):
    path = tmp_path / "serve.jsonl"
    report = serve_main(["--arch", "qwen2-1.5b", "--smoke", "--batch", "2",
                         "--requests", "3", "--prompt-len", "8",
                         "--new-tokens", "3", "--finetune", "1",
                         "--metrics", str(path)], device="cpu")
    out = capsys.readouterr().out
    assert json.loads(out[:out.rindex("}") + 1])["n_requests"] == 3
    assert "request 0 tokens:" in out
    assert len(report.requests) == 3
    assert all(len(r.out_tokens) == 3 and r.finish_reason == "length"
               for r in report.requests)
    kinds = [ln["kind"] for ln in read_metrics(path) if "kind" in ln]
    assert kinds.count("request") == 3
    # in one process --model is a mesh extent that changes nothing (over
    # ranks it spreads each worker: tests/test_torch_tp_serve.py)
    again = serve_main(["--arch", "qwen2-1.5b", "--smoke", "--batch", "2",
                        "--requests", "3", "--prompt-len", "8",
                        "--new-tokens", "3", "--model", "2"], device="cpu")
    assert [r.out_tokens for r in again.requests] \
        == [r.out_tokens for r in report.requests]
