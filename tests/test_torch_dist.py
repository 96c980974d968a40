"""``repro_torch.dist`` against ``repro.dist`` on the same inputs.

The JAX steps run on the single CPU device through a stand-in mesh of 4
workers (the step factories only read the mesh's worker extent, and
``constrain`` is a no-op outside ``use_sharding``).  Models use the fp32
copy of the qwen2-1.5b smoke config; weights cross via the numpy bridge.
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
from repro.dist import consensus as jcons  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb, consensus  # noqa: E402
from repro_torch.optim import DualAveragingOpt  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BS = [[2, 1, 0, 2], [2, 2, 2, 2], [0, 1, 2, 1]]
BETA = (50.0, float(N * PER), 200.0)       # the session's schedule


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _close(got: dict, want: dict, rtol, atol_scale):
    """Leafwise: |got - want| <= rtol |want| + atol_scale * max|want|."""
    assert list(got) == sorted(want, key=lambda k: tuple(k.split(".")))
    for k, w in want.items():
        g = got[k].detach().float().cpu().numpy()
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_scale * max(1.0, float(
                np.abs(w).max())), err_msg=k)


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


def _models():
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


@pytest.mark.parametrize("b", [[2, 1, 0, 2], [0, 0, 0, 0], [5, 2, 2, 9]])
def test_seq_weights_from_b(b):
    want = jamb.seq_weights_from_b(jnp.asarray(b), 8, N)
    got = amb.seq_weights_from_b(torch.tensor(b, dtype=torch.int32), 8, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sw, bw = amb.epoch_weights(torch.tensor(b, dtype=torch.int32), N, 2)
    np.testing.assert_array_equal(sw.reshape(-1).numpy(), np.asarray(want))
    np.testing.assert_array_equal(bw.numpy(), np.minimum(b, 2))


def _duals(seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b.c": (7,), "b.d": (2, 2, 3)}
    z = {k: rng.standard_normal((N,) + s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rng.standard_normal((N,) + s).astype(np.float32)
         for k, s in shapes.items()}
    nest = lambda d: {"a": jnp.asarray(d["a"]),
                      "b": {"c": jnp.asarray(d["b.c"]),
                            "d": jnp.asarray(d["b.d"])}}
    tz = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    return nest(z), nest(g), tz(z), tz(g)


@pytest.mark.parametrize("graph", [None, "ring", "torus"])
def test_pack_consensus_unpack_with_an_idle_worker(graph):
    """Worker 2 has b_i = 0; with identity consensus it keeps its dual."""
    jz, jg, z, g = _duals()
    nb = N * np.minimum(np.asarray(BS[0]), PER).astype(np.float32)
    jmsg = jamb.pack_messages(jz, jg, jnp.asarray(nb), N)
    msg = amb.pack_messages(z, g, torch.from_numpy(nb), N)
    np.testing.assert_allclose(msg.numpy(), np.asarray(jmsg), rtol=1e-6)
    np.testing.assert_allclose(amb.flatten_dual(z, N).numpy(),
                               np.asarray(jamb.flatten_dual(jz, N)))
    back = amb.unflatten_dual(amb.flatten_dual(z, N), z, N)
    assert all(torch.equal(back[k], z[k]) for k in z)
    if graph is not None:
        jmsg = jcons.GossipConsensus(N, 3, graph).combine(jmsg)
        msg = consensus.GossipConsensus(N, 3, graph).combine(msg)
        np.testing.assert_allclose(msg.numpy(), np.asarray(jmsg),
                                   rtol=1e-5, atol=1e-5)
    want = _flat(jamb.unpack_duals(jmsg, jz, N))
    got = amb.unpack_duals(msg, z, N)
    _close(got, want, 1e-5, 1e-6)
    if graph is None:
        np.testing.assert_array_equal(got["a"][2].numpy(),
                                      np.asarray(jz["a"][2]))


@pytest.mark.parametrize("name,graph", [("gossip", "ring"),
                                        ("gossip", "torus"),
                                        ("gossip", "star"),
                                        ("exact", "ring")])
def test_consensus_strategies_match(name, graph):
    rng = np.random.default_rng(2)
    m = rng.standard_normal((N, 33)).astype(np.float32)
    want = jcons.make_strategy(name, N, rounds=5, graph=graph).combine(
        jnp.asarray(m))
    strat = consensus.make_strategy(name, N, rounds=5, graph=graph)
    if graph == "star":
        assert strat.taps is None             # the dense P @ m fallback
    got = strat.combine(torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_gossip_rounds_reuse_the_message_stack(rounds):
    """The rounds ping-pong between the stack handed in and one spare
    buffer: an even count ends in the stack itself.  Tolerance as above."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((N, 33)).astype(np.float32)
    want = jcons.GossipConsensus(N, rounds, "ring").combine(jnp.asarray(m))
    msg = torch.from_numpy(m.copy())
    got = consensus.GossipConsensus(N, rounds, "ring").combine(msg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (got.data_ptr() == msg.data_ptr()) == (rounds % 2 == 0)


@pytest.mark.parametrize("steps", [1, 3])
def test_exact_train_step_matches_jax(steps):
    jcfg, cfg, jparams, model = _models()
    jopt = JDualAveraging(beta=JBeta(*BETA))
    jstate = jopt.init(jparams)
    jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
    opt = DualAveragingOpt(beta=BetaSchedule(*BETA))
    params = model.params()
    state = opt.init(params)
    step = amb.make_train_step(cfg, opt, N)
    for t, (jbatch, batch) in enumerate(_batches()[:steps]):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch,
                                    jnp.asarray(BS[t], jnp.int32))
        params, state, m = step(params, state, batch, BS[t])
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _close(state["z"], _flat(jstate["z"]), 1e-3, 1e-5)
        _close(params, _flat(jparams), 1e-5, 1e-6)
        assert state["t"] == int(jstate["t"]) == t + 1


@pytest.mark.parametrize("graph,steps", [("ring", 1), ("ring", 3),
                                         ("torus", 3)])
def test_gossip_train_step_matches_jax(graph, steps):
    jcfg, cfg, jparams, model = _models()
    jcfg_amb = jamb.AMBConfig(consensus="gossip", gossip_rounds=5,
                              graph=graph, beta=JBeta(*BETA))
    _, jstep = jamb.make_gossip_train_step(jcfg, STANDIN, jcfg_amb)
    jstep = jax.jit(jstep)
    jstate = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    init, step = amb.make_gossip_train_step(
        cfg, N, amb.AMBConfig(consensus="gossip", gossip_rounds=5,
                              graph=graph, beta=BetaSchedule(*BETA)))
    state = init(model.params())
    for t, (jbatch, batch) in enumerate(_batches()[:steps]):
        jstate, jm = jstep(jstate, jbatch, jnp.asarray(BS[t], jnp.int32))
        state, m = step(state, batch, BS[t])
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["beta"], float(jm["beta"]), rtol=0)
        _close(state["z"], _flat(jstate["z"]), 1e-3, 1e-5)
        assert state["t"] == int(jstate["t"]) == t + 1
    amb_cfg = amb.AMBConfig(beta=BetaSchedule(*BETA))
    _close(amb.gossip_primal(state, amb_cfg),
           _flat(jamb.gossip_primal(jstate, jcfg_amb)), 1e-5, 1e-6)
