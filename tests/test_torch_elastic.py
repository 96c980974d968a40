"""Elastic membership in the port against ``repro``: the masked and
survivor operators, the masked strategies, a session that loses and
regains a worker, the masked primal, ``set_slowdown`` and rejected masks.

JAX steps run on the stand-in 4-worker mesh with a hand-built state.
Tolerances: operators and source tables exact; the fp32 gossip combine
rtol 1e-5 / atol 1e-6 (another summation order); the quantized combine
bit for bit against JAX run op by op (``disable_jit``) on JAX's draws;
session losses rtol 1e-5 and duals as ``tests/test_torch_dist.py`` holds
them; inactive workers' duals unchanged bit for bit.
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
from repro.core import stragglers as jstr  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import consensus as jcons  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb, consensus  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)       # the session's schedule
TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ)
MASK = (True, False, True, True)
# (n, graph, torus shape, mask): survivors on a ring, a torus that
# re-lays onto a 2-D torus or a ring, non-adjacent and adjacent losses
CASES = [(4, "ring", None, (True, False, True, True)),
         (4, "ring", None, (False, True, False, True)),
         (6, "ring", None, (True, True, False, True, False, True)),
         (6, "torus", (2, 3), (True, False, True, True, True, True)),
         (8, "torus", (2, 4), (True, True, False, True, True, False, True,
                               True)),
         (8, "torus", (2, 4), (True,) * 6 + (False, False))]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs several worker
    processes on shared cores, where torch's thread pool oversubscribes
    them (these tests' small ops ran up to 40x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_table(taps) -> np.ndarray:
    """JAX's survivor taps as a (K, n) table over the active rows (-1 on
    the inactive rows, whose taps read zeros)."""
    src = np.full((taps.k, taps.n), -1, np.int64)
    src[0, taps.active] = np.nonzero(taps.active)[0]
    for i, hop in enumerate(taps.hops[1:], start=1):
        for delta, mask in hop:
            rows = np.nonzero(mask)[0]
            src[i, rows] = (rows + delta) % taps.n
    return src


@pytest.mark.parametrize("n,graph,shape,mask", CASES)
def test_survivor_taps_and_masked_metropolis_equal_jax(n, graph, shape,
                                                       mask):
    mine, ref = consensus.survivor_taps(mask, graph), \
        jcons.survivor_taps(mask, graph)
    assert (mine.offsets, mine.shape, mine.n) == (ref.offsets, ref.shape,
                                                  ref.n)
    np.testing.assert_array_equal(mine.weights, ref.weights)
    np.testing.assert_array_equal(mine.dense(), ref.dense())
    assert [[(d, m.tolist()) for d, m in hop] for hop in mine.hops] == \
        [[(d, m.tolist()) for d, m in hop] for hop in ref.hops]
    table, want = mine.source_rows(), _jax_table(ref)
    act = np.asarray(mask)
    np.testing.assert_array_equal(table[:, act], want[:, act])
    assert (table[:, ~act] == np.nonzero(~act)[0]).all()   # self rows
    assert set(table[:, act].ravel()) <= set(np.nonzero(act)[0])
    adj = jcns.torus_graph(*shape) if graph == "torus" \
        else jcns.build_graph(graph, n)

    def dense(fn):           # the operator, or the rejection's message
        try:
            return fn(adj, mask, 0.5)
        except ValueError as e:
            return str(e)

    got, want = dense(consensus.masked_metropolis), \
        dense(jcons.masked_metropolis)
    if isinstance(want, str):                # a disconnected survivor set
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def test_survivor_table_reads_jax_taps_and_rejected_operators():
    """Gathering the rows the table names gives JAX's tap views (its
    masked rolls) on every active row."""
    mask = (True, True, False, True, False, True)
    x = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    table = consensus.survivor_taps(mask).source_rows()
    ref = jcons.survivor_taps(mask)
    for i in range(ref.k):
        np.testing.assert_array_equal(x[table[i]][list(mask)], np.asarray(
            ref.take(jnp.asarray(x), i))[list(mask)])
    assert consensus.survivor_taps((True, False, False, False)) is None
    assert consensus.survivor_taps((True, True, False), "star") is None
    with pytest.raises(ValueError, match="disconnected"):
        consensus.masked_metropolis(cns.ring_graph(4),
                                    (True, False, True, False), 0.5)
    with pytest.raises(ValueError, match="at least one worker"):
        consensus.GossipConsensus(4, 5, active=(False,) * 4)
    with pytest.raises(ValueError, match="active mask has 3 entries"):
        consensus.GossipConsensus(4, 5, active=(True, False, True))
    with pytest.raises(ValueError, match="disconnected"):
        consensus.GossipConsensus(4, 5, active=(True, False, True, False),
                                  relayout=False)


def _msg(n, d=37, seed=1):
    return (np.random.default_rng(seed).standard_normal((n, d))
            * 3.0).astype(np.float32)


@pytest.mark.parametrize("relayout", [True, False])
@pytest.mark.parametrize("n,graph,shape,mask", CASES[:4])
def test_masked_gossip_combine_matches_jax(n, graph, shape, mask, relayout):
    """Relayout (kernel table) and dense (masked Metropolis) operators;
    inactive rows come back as the input rows, bit for bit."""
    m = _msg(n)
    try:
        ref = jcons.GossipConsensus(n, 5, graph, torus_shape=shape,
                                    active=mask, relayout=relayout)
    except ValueError:           # a disconnected dense survivor graph
        with pytest.raises(ValueError, match="disconnected"):
            consensus.GossipConsensus(n, 5, graph, torus_shape=shape,
                                      active=mask, relayout=relayout)
        return
    strat = consensus.GossipConsensus(n, 5, graph, torus_shape=shape,
                                      active=mask, relayout=relayout)
    assert (strat.taps is None) == (ref.taps is None) == (not relayout)
    np.testing.assert_allclose(strat.p, ref.p, rtol=0, atol=0)
    msg = torch.from_numpy(m.copy())
    got = strat.combine(msg).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.combine(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-6)
    inact = ~np.asarray(mask)
    np.testing.assert_array_equal(got[inact], m[inact])


def _jax_draws(key):
    def draws(k, out):
        with jax.threefry_partitionable(True):
            r = jax.random.uniform(jax.random.fold_in(key, k),
                                   tuple(out.shape))
        return out.copy_(torch.from_numpy(np.array(r)))
    return draws


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,graph,shape,mask", CASES[::2])
def test_masked_quantized_combine_matches_jax(n, graph, shape, mask, bits):
    """Survivor relayout on JAX's draws: bit for bit against JAX op by op."""
    m = _msg(n, 129, 2)
    key = jax.random.PRNGKey(7)
    ref = jcons.QuantizedGossipConsensus(n, 6, bits, graph,
                                         torus_shape=shape, active=mask)
    with jax.disable_jit():
        want = np.asarray(ref.combine(jnp.asarray(m), key))
    strat = consensus.QuantizedGossipConsensus(n, 6, bits, graph,
                                               torus_shape=shape,
                                               active=mask)
    assert isinstance(strat.taps, consensus.SurvivorTaps)
    got = strat.combine(torch.from_numpy(m.copy()), _jax_draws(key))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[~np.asarray(mask)],
                                  m[~np.asarray(mask)])


@pytest.mark.parametrize("name", ["gossip", "gossip_q8"])
def test_one_survivor_is_the_identity(name):
    m = _msg(4)
    strat = consensus.make_strategy(name, 4, active=(False, False, True,
                                                     False))
    assert strat.identity and strat.taps is None
    got = strat.combine(torch.from_numpy(m.copy()), _jax_draws(
        jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(got.numpy(), m)


def _models():
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _close(got: dict, want: dict, rtol, atol_scale):
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].detach().float().cpu().numpy(), w, rtol=rtol,
            atol=atol_scale * max(1.0, float(np.abs(w).max())), err_msg=k)


def _batch(rng):
    toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((N * PER, 1), -1,
                                                  np.int32)], 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


@pytest.mark.parametrize("consensus_name", ["gossip", "gossip_q8"])
def test_session_leave_and_rejoin_matches_jax(consensus_name):
    """Epoch 0 with everyone, epoch 1 with worker 1 out (b_1 = 0, a ring of
    3 survivors), epoch 2 with it back, against JAX's masked
    ``make_gossip_train_step`` (``AMBConfig(active=...)``, r = 2); q8 on
    JAX's draws, with its dual tolerance (``tests/test_torch_quantized.
    py``)."""
    jcfg, cfg, jparams, model = _models()
    plan = [(None, [2, 1, 2, 2]), (MASK, [2, 0, 1, 2]), (None, [1, 2, 2, 2])]
    jsteps = {}
    for mask, _ in plan:
        cfg_amb = jamb.AMBConfig(consensus=consensus_name, gossip_rounds=2,
                                 beta=JBeta(*BETA), seed=3, active=mask)
        jsteps[mask] = (cfg_amb, jax.jit(jamb.make_gossip_train_step(
            jcfg, STANDIN, cfg_amb)[1]))
    jstate = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}

    def jax_source(seed, t):
        return _jax_draws(jax.random.fold_in(jax.random.PRNGKey(seed), t))

    session = AMBSession(
        dataclasses.replace(TRAIN, seed=3), ClockSpec(kind="simulated"),
        ConsensusSpec(consensus=consensus_name, gossip_rounds=2), cfg=cfg,
        params=model, device="cpu", draw_source=jax_source)
    rng = np.random.default_rng(8)
    for mask, b in plan:
        session.set_active(MASK if mask else [True] * N)
        assert session.active.tolist() == list(mask or [True] * N)
        before = {k: v[1].clone() for k, v in session.state["z"].items()}
        jbatch, batch = _batch(rng)
        jstate, jm = jsteps[mask][1](jstate, jbatch,
                                     jnp.asarray(b, jnp.int32))
        m = session.step(batch, b)
        assert m["global_batch"] == float(jm["global_batch"])
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        if mask:
            for k, v in session.state["z"].items():
                torch.testing.assert_close(v[1], before[k], rtol=0, atol=0)
        if consensus_name == "gossip":
            _close(session.state["z"], _flat(jstate["z"]), 1e-3, 1e-5)
        else:
            g = amb.flatten_dual(session.state["z"], N).numpy()
            w = np.concatenate([np.asarray(v).reshape(N, -1) for v in
                                jax.tree.leaves(jstate["z"])], 1)
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
    # the rejoin reuses the full-fleet protocol built at the start
    assert len(session._protocols) == 2


def test_masked_gossip_primal_matches_jax():
    rng = np.random.default_rng(4)
    jcfg, cfg, jparams, model = _models()
    z = {k: rng.standard_normal((N,) + tuple(v.shape)).astype(np.float32)
         for k, v in model.params().items()}
    state = {"z": {k: torch.from_numpy(v) for k, v in z.items()},
             "w0": model.params(), "t": 2}
    jstate = {"z": models.model._nest({k: jnp.asarray(v)
                                       for k, v in z.items()}),
              "w0": jparams, "t": jnp.asarray(2, jnp.int32)}
    for mask in (None, MASK, (False, False, True, False)):
        got = amb.gossip_primal(state, amb.AMBConfig(
            beta=BetaSchedule(*BETA), active=mask))
        want = jamb.gossip_primal(jstate, jamb.AMBConfig(
            beta=JBeta(*BETA), active=mask))
        _close(got, _flat(want), 1e-5, 1e-6)
    one = amb.gossip_primal(state, amb.AMBConfig(
        beta=BetaSchedule(*BETA), active=(False, False, True, False)))
    solo = {k: v[2:3].clone() for k, v in state["z"].items()}
    ref = amb.gossip_primal({"z": solo, "w0": state["w0"], "t": 2},
                            amb.AMBConfig(beta=BetaSchedule(*BETA)))
    for k in one:
        torch.testing.assert_close(one[k], ref[k], rtol=0, atol=0)


def test_set_slowdown_scales_the_times_before_the_cut():
    """b_i(t) of a slowed session is JAX's deadline cut of the scaled
    times (the clock's draws for that epoch, times the multipliers)."""
    slow = [1.0, 4.0, 1.0, 0.5]
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"), device="cpu")
    ref = AMBSession(TRAIN, ClockSpec(kind="simulated"), device="cpu")
    session.set_slowdown(slow)
    source = session.batch_source()
    for epoch in range(3):
        gen = torch.Generator()
        gen.manual_seed(TRAIN.seed * 1_000_003 + 10_000 + epoch)
        times, budget = session.clock.epoch(gen)
        scaled = times.numpy() * np.asarray(slow, np.float32)[:, None]
        want = np.asarray(jstr.amb_batch_sizes(jnp.asarray(scaled), budget))
        batch = source.batch(epoch)
        got = session.step(batch)["b"]
        np.testing.assert_array_equal(got, want)
        # the same draws unscaled: the 4x slower worker gets no more, the
        # 2x faster one no fewer
        plain = ref.step(batch)["b"]
        assert got[1] <= plain[1] and got[3] >= plain[3]
    session.set_slowdown([1.0] * N)
    assert session._slow is None
    for bad, msg in (([1.0] * 3, "3 entries"), ([1.0, 0.0, 1.0, 1.0],
                                                "positive")):
        with pytest.raises(ValueError, match=msg):
            session.set_slowdown(bad)


@pytest.mark.parametrize("mode", [dict(), dict(pipeline=True),
                                  dict(async_epochs=True, staleness=2)])
def test_rejected_masks_leave_the_session_unchanged(mode):
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip", **mode),
                         device="cpu")
    source = session.batch_source()
    session.step(source.batch(0))
    session.set_active(MASK)

    def snapshot(tree):
        if isinstance(tree, torch.Tensor):
            return tree.clone()
        if isinstance(tree, dict):
            return {k: snapshot(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [snapshot(v) for v in tree]
        return tree

    before = snapshot(session.state)
    proto = session.protocol
    for bad, msg in (([False] * N, "at least one worker"),
                     ([True] * 3, "3 entries")):
        with pytest.raises(ValueError, match=msg):
            session.set_active(bad)
        assert session.active.tolist() == list(MASK)
        assert session.protocol is proto
        torch.testing.assert_close(session.state, before, rtol=0, atol=0)
    assert session.epoch_sizes(torch.full((N, PER), 0.1), 1.0).tolist() == \
        [PER, 0, PER, PER]
