"""The pipelined epochs in the port against ``repro``: the drivers
(``make_pipelined_gossip_train_step``, and
``make_async_gossip_train_step`` at D = 1), their protocols and the
session's wall-clock rules; ``tests/test_torch_async.py`` holds D > 1, the
staleness retune and the simulator's oracles, with these helpers.

JAX steps run on the stand-in 4-worker mesh with a hand-built state
(zeros for ``z``, ``pending``, ``queue`` and ``snaps``).  Tolerances:
losses rtol 1e-5 and b(t) equal; fp32 gossip duals as
``tests/test_torch_dist.py`` holds them (rtol 1e-3, atol 1e-5 of the
leaf's scale); quantized gossip on JAX's draws within 1e-2 of the dual
stack's norm (``tests/test_torch_quantized.py``: a gradient's last bit
can flip a rounding).  Port against port: bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import async_epochs as jasync  # noqa: E402
from repro.dist import pipeline as jpipe  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, AsyncProtocol, ClockSpec,  # noqa
                             ConsensusSpec, PipelinedProtocol, TrainSpec,
                             build_protocol)
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb, async_epochs, pipeline  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)       # the session's schedule
BS = [[2, 1, 0, 2], [2, 2, 2, 2], [0, 1, 2, 1], [1, 2, 2, 0]]
TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ)
Q_RTOL = 1e-2
ROUNDS = 2        # the drivers' gossip rounds: each settle mixes, and the
                  # JAX draws of 8 q8 rounds a settle cost less than 20


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs several worker
    processes on shared cores, where torch's thread pool oversubscribes
    them (these tests' small ops ran up to 40x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_draws(key):
    def draws(k, out):
        with jax.threefry_partitionable(True):
            r = jax.random.uniform(jax.random.fold_in(key, k),
                                   tuple(out.shape))
        return out.copy_(torch.from_numpy(np.array(r)))
    return draws


def jax_source(seed, t):
    """Epoch t's draws as the jitted JAX step derives them: ``fold_in`` of
    an int32 epoch (negative for the first zero payloads)."""
    return _jax_draws(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         jnp.asarray(t, jnp.int32)))


def _models():
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in BS:
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        out.append(({"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)},
                    {"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labels).long()}))
    return out


def _jstack(z) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).reshape(N, -1)
                           for v in jax.tree.leaves(z)], 1)


def _close_duals(z: dict, jz, consensus: str):
    got, want = amb.flatten_dual(z, N).numpy(), _jstack(jz)
    if consensus == "gossip":
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale)
    else:
        assert np.linalg.norm(got - want) <= Q_RTOL * np.linalg.norm(want)


def _drivers(kind, consensus, staleness=1):
    """(port (init, step, flush), JAX (state, step, flush)) for one driver;
    r = ROUNDS (gossip_q8: 4 r rounds a settle)."""
    jcfg, cfg, jparams, model = _models()
    jamb_cfg = jamb.AMBConfig(consensus=consensus, gossip_rounds=ROUNDS,
                              beta=JBeta(*BETA), seed=3)
    mine = amb.AMBConfig(consensus=consensus, gossip_rounds=ROUNDS,
                         beta=BetaSchedule(*BETA), seed=3)
    width = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    jstate = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}

    def zeros(w, count):
        return tuple(jnp.zeros((N, w), jnp.float32) for _ in range(count))

    if kind == "pipelined":
        _, jstep, jflush = jpipe.make_pipelined_gossip_train_step(
            jcfg, STANDIN, jamb_cfg)
        jstate["pending"] = zeros(width + 1, 1)[0]
        port = pipeline.make_pipelined_gossip_train_step(
            cfg, N, mine, draw_source=jax_source)
    else:
        _, jstep, jflush = jasync.make_async_gossip_train_step(
            jcfg, STANDIN, jamb_cfg, staleness)
        jstate["queue"] = zeros(width + 1, staleness)
        if staleness > 1:
            jstate["snaps"] = zeros(width, staleness)
        port = async_epochs.make_async_gossip_train_step(
            cfg, N, mine, staleness, draw_source=jax_source)
    return model, port, (jstate, jax.jit(jstep), jax.jit(jflush))


def check_driver(kind, staleness, consensus):
    """The port's driver against JAX's over 4 epochs and a flush."""
    model, (init, step, flush), (jstate, jstep, jflush) = _drivers(
        kind, consensus, staleness)
    state = init(model.params())
    for t, ((jbatch, batch), b) in enumerate(zip(_batches(), BS)):
        jstate, jm = jstep(jstate, jbatch, jnp.asarray(b, jnp.int32))
        state, m = step(state, batch, b)
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["beta"], float(jm["beta"]), rtol=0)
        _close_duals(state["z"], jstate["z"], consensus)
        assert state["t"] == int(jstate["t"]) == t + 1
    jstate = jflush(jstate)
    state = flush(state)
    _close_duals(state["z"], jstate["z"], consensus)
    assert state["t"] == int(jstate["t"]) == len(BS)
    slots = [state["pending"]] if kind == "pipelined" else \
        state["queue"] + state.get("snaps", [])
    assert all(not s.any() for s in slots)


@pytest.mark.parametrize("consensus", ["gossip", "gossip_q8"])
@pytest.mark.parametrize("kind", ["pipelined", "async"])
def test_driver_matches_jax_over_four_epochs_and_a_flush(kind, consensus):
    """The pipelined driver, and the async one at D = 1 (D = 2 and 3:
    ``tests/test_torch_async.py``)."""
    check_driver(kind, 1, consensus)


def test_async_at_staleness_one_is_the_pipelined_driver_bit_for_bit():
    jcfg, cfg, jparams, model = _models()
    amb_cfg = amb.AMBConfig(consensus="gossip_q8", gossip_rounds=ROUNDS,
                            beta=BetaSchedule(*BETA), seed=1)
    runs = []
    for make in (pipeline.make_pipelined_gossip_train_step,
                 lambda *a, **k: async_epochs.make_async_gossip_train_step(
                     *a, staleness=1, **k)):
        init, step, flush = make(cfg, N, amb_cfg, draw_source=jax_source)
        state = init({k: v.detach().clone()
                      for k, v in model.params().items()})
        losses = [float(step(state, batch, b)[1]["loss"])
                  for (_, batch), b in zip(_batches(2), BS)]
        inflight = amb.flatten_dual(state["z"], N).clone()
        runs.append((losses, inflight, flush(state)["z"]))
    (la, ia, za), (lb, ib, zb) = runs
    assert la == lb
    torch.testing.assert_close(ia, ib, rtol=0, atol=0)
    for k in za:
        torch.testing.assert_close(za[k], zb[k], rtol=0, atol=0)


@pytest.mark.parametrize("consensus", ["gossip", "gossip_q4"])
def test_one_pipelined_step_and_a_flush_is_the_sequential_step(consensus):
    jcfg, cfg, jparams, model = _models()
    amb_cfg = amb.AMBConfig(consensus=consensus, beta=BetaSchedule(*BETA))
    (_, batch), b = _batches(3)[0], BS[0]
    init, seq = amb.make_gossip_train_step(cfg, N, amb_cfg)
    want, wm = seq(init(model.params()), batch, b)
    init, step, flush = pipeline.make_pipelined_gossip_train_step(
        cfg, N, amb_cfg)
    state, m = step(init(model.params()), batch, b)
    state = flush(state)
    assert float(m["loss"]) == float(wm["loss"]) and state["t"] == 1
    for k in want["z"]:
        torch.testing.assert_close(state["z"][k], want["z"][k], rtol=0,
                                   atol=0)


def test_build_protocol_dispatch_and_errors_match_jax():
    """JAX's rules and messages (``tests/test_async.py``)."""
    from repro.api import protocol as jproto
    from repro.optim import AdamW as JAdamW
    from repro_torch.optim import AdamW, DualAveragingOpt
    jcfg, cfg, _, _ = _models()
    gossip = amb.AMBConfig(consensus="gossip")
    jgossip = jamb.AMBConfig(consensus="gossip")
    cases = [dict(pipeline=True, async_epochs=True),
             dict(staleness=2), dict(pipeline=True, staleness=3)]
    for kw in cases:
        with pytest.raises(ValueError) as mine:
            build_protocol(cfg, N, gossip, **kw)
        with pytest.raises(ValueError) as ref:
            jproto.build_protocol(jcfg, STANDIN, jgossip, **kw)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError) as mine:
        build_protocol(cfg, N, amb.AMBConfig(), pipeline=True,
                       optimizer=AdamW())
    with pytest.raises(ValueError) as ref:
        jproto.build_protocol(jcfg, STANDIN, jamb.AMBConfig(), pipeline=True,
                              optimizer=JAdamW())
    assert str(mine.value) == str(ref.value)
    assert isinstance(build_protocol(cfg, N, amb.AMBConfig(), pipeline=True),
                      PipelinedProtocol)
    p = build_protocol(cfg, N, gossip, async_epochs=True, staleness=3,
                       optimizer=DualAveragingOpt(beta=BetaSchedule()))
    assert isinstance(p, AsyncProtocol) and p.staleness == 3
    assert (p.mode, build_protocol(cfg, N, gossip).mode) == ("async",
                                                            "gossip")


@pytest.mark.parametrize("spec,rule", [
    (dict(consensus="gossip"), lambda t, c, d: t + c),
    (dict(consensus="gossip", pipeline=True), lambda t, c, d: max(t, c)),
    (dict(consensus="exact", pipeline=True), lambda t, c, d: max(t, c)),
    (dict(consensus="gossip_q8", async_epochs=True, staleness=2),
     lambda t, c, d: max(t, c / d))])
def test_session_sim_wall_rules_and_staleness_metric(spec, rule):
    for budget in (0.25, 2.0):
        s = AMBSession(TRAIN, ClockSpec(kind="simulated",
                                        compute_time=budget),
                       ConsensusSpec(**spec), device="cpu")
        source = s.batch_source()
        want = 0.0
        for e in range(3):
            m = s.step(source.batch(e))
            want += rule(budget, 0.5, s.consensus_spec.staleness)
            assert m["sim_wall_s"] == pytest.approx(want, rel=1e-12)
            assert m["staleness"] == spec.get("staleness", 1)
        assert s._decentralized
        s.flush()
        assert np.isfinite(m["loss"])
