"""The port's quantized gossip (``gossip_q8`` / ``gossip_q4``) against
``repro``'s, on the same inputs and the same rounding draws.

JAX's threefry draws cannot be made by torch, so the port's draw seam
(``draws(k, out)``) is handed a callable that copies in JAX's own draws,
``uniform(fold_in(key, k), shape)`` under ``threefry_partitionable``, as
``repro.dist.consensus`` draws them.  The JAX steps run on the stand-in
4-worker mesh of ``tests/test_torch_dist.py``.
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
from repro.core import consensus as jcns  # noqa: E402
from repro.core import extensions as jext  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import consensus as jcons  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.core import extensions  # noqa: E402
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb, consensus  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BS = [[2, 1, 0, 2], [2, 2, 2, 2], [1, 0, 2, 2]]
BETA = (50.0, float(N * PER), 200.0)       # the session's schedule
STRATEGY_TOL = dict(rtol=2e-4, atol=1e-3)  # as tests/test_dist_strategies
# Port vs JAX step: the gradients agree to fp32 rounding, not bit for bit,
# so a few stochastic roundings flip between the two; each moves one
# element by one grid step (its row's range over 255).  Held on the whole
# dual stack: ||z - z_jax|| <= 1e-2 ||z_jax|| (measured 7.6e-4 to 2.6e-3
# over three epochs), and the losses to 1e-5.
STACK_RTOL = 1e-2


def jax_draws(key):
    """The draw seam filled from JAX: round k's draws of ``out``'s shape."""
    def draws(k, out):
        with jax.threefry_partitionable(True):
            r = jax.random.uniform(jax.random.fold_in(key, k),
                                   tuple(out.shape))
        return out.copy_(torch.from_numpy(np.array(r)))
    return draws


def jax_source(seed, t):
    """The step's draw source: epoch t's key is ``fold_in(PRNGKey(seed),
    t)``, as in ``repro.dist.amb.make_gossip_train_step``."""
    return jax_draws(jax.random.fold_in(jax.random.PRNGKey(seed), t))


def _messages(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 3.0).astype(np.float32)


CASES = [("ring", None, 8), ("ring", None, 4), ("torus", (2, 3), 8),
         ("torus", (2, 3), 4), ("star", None, 8)]


@pytest.mark.parametrize("graph,shape,bits", CASES)
def test_quantized_strategy_matches_jax(graph, shape, bits):
    """Same draws: bit for bit against JAX run op by op (``disable_jit``),
    and within the JAX suite's tolerance against the jitted strategy,
    whose fused replica sums may round their last bit differently and so
    flip a rounding.  ``star`` takes the dense fallback on both sides."""
    n, rounds = 6, 8
    key = jax.random.PRNGKey(11)
    m = _messages(n, 257, 1)
    jq = jcons.QuantizedGossipConsensus(n, rounds, bits, graph,
                                        torus_shape=shape)
    want = np.asarray(jq.combine(jnp.asarray(m), key))
    with jax.disable_jit():
        eager = np.asarray(jq.combine(jnp.asarray(m), key))
    q = consensus.QuantizedGossipConsensus(n, rounds, bits, graph,
                                           torus_shape=shape)
    assert q.name == jq.name == f"gossip_q{bits}"
    assert (q.taps is None) == (jq.taps is None) == (graph == "star")
    msg = torch.from_numpy(m.copy())
    got = q.combine(msg, jax_draws(key))
    if q.taps is not None:
        assert got.data_ptr() == msg.data_ptr()    # the round runs in place
    np.testing.assert_array_equal(got.numpy(), eager)
    np.testing.assert_allclose(got.numpy(), want, **STRATEGY_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_operators_match_jax(bits):
    """``quantize_unbiased`` and ``gossip_quantized`` on JAX's draws."""
    key = jax.random.PRNGKey(7)
    x = _messages(5, 129, 2)
    with jax.threefry_partitionable(True):
        rnd = np.array(jax.random.uniform(key, x.shape))
    want = jext.quantize_unbiased(jnp.asarray(x), bits, key)
    got = extensions.quantize_unbiased(torch.from_numpy(x), bits,
                                       torch.from_numpy(rnd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = jcns.metropolis_weights(jcns.build_graph("paper", 10), lazy=0.3)
    m = _messages(10, 65, 3)
    with jax.disable_jit():
        want = jext.gossip_quantized(jnp.asarray(m), jnp.asarray(
            p, jnp.float32), 6, bits, key)
    got = extensions.gossip_quantized(torch.from_numpy(m), p, 6, bits,
                                      jax_draws(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name,rounds", [("exact", 5), ("gossip", 5),
                                         ("gossip_q8", 20),
                                         ("gossip_q4", 40)])
@pytest.mark.parametrize("graph", ["ring", "torus", "star"])
def test_make_strategy_rounds_names_and_wire_bytes(name, rounds, graph):
    want = jcons.make_strategy(name, 8, rounds=5, graph=graph)
    got = consensus.make_strategy(name, 8, rounds=5, graph=graph)
    assert got.name == want.name == name
    assert getattr(got, "rounds", rounds) == rounds
    for d in (1, 257, 1 << 20):
        assert got.wire_bytes_per_round(d) == want.wire_bytes_per_round(d)
    assert name in consensus.CONSENSUS_CHOICES
    with pytest.raises(ValueError, match="unknown consensus"):
        consensus.make_strategy("psum", 4)


@pytest.mark.parametrize("bits,d", [(4, 257), (4, 256), (8, 33)])
def test_pack_unpack_round_trip(bits, d):
    rng = np.random.default_rng(4)
    lvl = rng.integers(0, 2 ** bits, (6, d)).astype(np.uint8)
    jq = jcons.QuantizedGossipConsensus(6, 1, bits, "ring")
    q = consensus.QuantizedGossipConsensus(6, 1, bits, "ring")
    packed = q._pack(torch.from_numpy(lvl))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq._pack(jnp.asarray(lvl))))
    assert packed.shape[1] == (-(-d // 2) if bits == 4 else d)
    np.testing.assert_array_equal(q._unpack(packed, d).numpy(), lvl)


def test_port_draws_unbiased_and_8bit_less_noisy():
    """The default draws (``epoch_draws``): the mean over draws is the fp32
    gossip, and 4-bit levels are noisier than 8-bit (as in
    tests/test_dist_strategies.py)."""
    n, rounds, d = 6, 6, 96
    m = torch.from_numpy(_messages(n, d, 5) * 4.0 / 3.0)
    exact = consensus.GossipConsensus(n, rounds, "ring").combine(m.clone())

    def runs(bits, reps=24):
        q = consensus.QuantizedGossipConsensus(n, rounds, bits, "ring")
        return torch.stack([q.combine(m.clone(),
                                      consensus.epoch_draws(0, i))
                            for i in range(reps)])

    out8, out4 = runs(8), runs(4)
    spread = float(m.max() - m.min())
    assert float((out8.mean(0) - exact).abs().max()) < 0.02 * spread
    assert float(out8.var(0).mean()) < float(out4.var(0).mean())
    a = torch.empty(n, d)
    b = torch.empty(n, d)
    consensus.epoch_draws(3, 1)(2, a)
    consensus.epoch_draws(3, 1)(2, b)
    assert torch.equal(a, b) and 0.0 <= float(a.min()) < float(a.max()) < 1
    consensus.epoch_draws(3, 2)(2, b)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="draw source"):
        consensus.QuantizedGossipConsensus(n, 1, 8).combine(m.clone())


def _models():
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


def _batches(seed):
    rng = np.random.default_rng(seed)
    for b in BS:
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        yield b, ({"tokens": jnp.asarray(toks),
                   "labels": jnp.asarray(labels)},
                  {"tokens": torch.from_numpy(toks).long(),
                   "labels": torch.from_numpy(labels).long()})


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


def _close_stack(got: dict, want: dict):
    g = _stack({k: v.detach().cpu().numpy() for k, v in got.items()})
    w = _stack(_flat(want))
    assert np.linalg.norm(g - w) <= STACK_RTOL * np.linalg.norm(w)


def _jax_step(jcfg, jparams):
    jamb_cfg = jamb.AMBConfig(consensus="gossip_q8", gossip_rounds=5,
                              graph="ring", beta=JBeta(*BETA), seed=3)
    jstep = jax.jit(jamb.make_gossip_train_step(jcfg, STANDIN, jamb_cfg)[1])
    jstate = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    return jamb_cfg, jstep, jstate


@pytest.mark.parametrize("steps", [1, 3])
def test_gossip_q8_train_step_matches_jax(steps):
    jcfg, cfg, jparams, model = _models()
    jamb_cfg, jstep, jstate = _jax_step(jcfg, jparams)
    init, step = amb.make_gossip_train_step(
        cfg, N, amb.AMBConfig(consensus="gossip_q8", gossip_rounds=5,
                              graph="ring", beta=BetaSchedule(*BETA),
                              seed=3), draw_source=jax_source)
    state = init(model.params())
    for t, (b, (jbatch, batch)) in enumerate(list(_batches(0))[:steps]):
        jstate, jm = jstep(jstate, jbatch, jnp.asarray(b, jnp.int32))
        state, m = step(state, batch, b)
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _close_stack(state["z"], jstate["z"])
        assert state["t"] == int(jstate["t"]) == t + 1


@pytest.mark.parametrize("epochs", [1, 3])
def test_gossip_q8_session_matches_jax(epochs):
    """``AMBSession`` with ``ConsensusSpec(consensus="gossip_q8")`` passes
    ``train.seed`` to the step: JAX's draws for seed 3 reach it."""
    jcfg, cfg, jparams, model = _models()
    jamb_cfg, jstep, jstate = _jax_step(jcfg, jparams)
    session = AMBSession(
        TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ,
                  seed=3),
        ClockSpec(kind="simulated"), ConsensusSpec(consensus="gossip_q8"),
        cfg=cfg, params=model, device="cpu", draw_source=jax_source)
    assert session.protocol.amb.seed == 3
    for b, (jbatch, batch) in list(_batches(4))[:epochs]:
        jstate, jm = jstep(jstate, jbatch, jnp.asarray(b, jnp.int32))
        m = session.step(batch, b)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    _close_stack(session.state["z"], jstate["z"])
    got = session.params
    want = _flat(jamb.gossip_primal(jstate, jamb_cfg))
    g = np.concatenate([got[k].detach().numpy().ravel() for k in sorted(want)])
    w = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
    w0 = np.concatenate([np.asarray(_flat(jparams)[k]).ravel()
                         for k in sorted(want)])
    # the primal's step from w0 carries the dual's tolerance
    assert np.linalg.norm(g - w) <= STACK_RTOL * np.linalg.norm(w - w0)
    assert session.steps_done == epochs


def test_session_quantized_default_draws_run_and_are_seeded():
    """Without a draw source the session draws from ``epoch_draws``: two
    sessions with one seed agree, and another seed (same weights) differs."""
    cfg = configs.smoke_config("qwen2-1.5b")
    params = models.init_params(cfg, torch.Generator().manual_seed(0))

    def run(seed):
        s = AMBSession(TrainSpec(smoke=True, data=N, batch_per_worker=PER,
                                 seq_len=SEQ, seed=seed),
                       ClockSpec(kind="simulated"),
                       ConsensusSpec(consensus="gossip_q4",
                                     gossip_rounds=1),
                       params={k: v.clone() for k, v in params.items()},
                       device="cpu")
        batch = {"tokens": torch.arange(N * PER * SEQ).reshape(
            N * PER, SEQ) % 512}
        batch["labels"] = batch["tokens"].roll(-1, 1)
        m = s.step(batch, [2, 2, 1, 2])
        assert np.isfinite(m["loss"])
        return _stack({k: v.numpy() for k, v in s.state["z"].items()})

    a, b = run(0), run(0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, run(1))
