"""Fault injection and coded redundancy in the port against ``repro``:
the fault models, the injector, the coded placement and its decode
weights, the coded source, the coded exact and gossip steps, and a
session churned under coded placement.

JAX steps run on the stand-in 4-worker mesh with a hand-built state (a
JAX session's steps need a device mesh this CPU's jax does not build).
Tolerances: fault models, injector calls, placement, decode weights and
source structure exact; the coded steps as ``tests/test_torch_dist.py``
holds the uncoded ones (losses rtol 1e-5, duals rtol 1e-3 with atol
1e-5 of the leaf's largest element, parameters rtol 1e-5 / atol 1e-6);
restored runs bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import redundancy as jred  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, faults, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.data import LMTokenStream, StreamSource  # noqa: E402
from repro_torch.dist import amb, consensus, redundancy  # noqa: E402
from repro_torch.optim import DualAveragingOpt  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)       # the session's schedule
CHURN = dict(leave_rate=0.25, rejoin_rate=0.5, seed=1)
# PoissonChurn(0.25, 0.5, seed=1) over 4 workers, epochs 0 to 5
CHURN_MASKS = ["1111", "1110", "1011", "1001", "1111", "1101"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (several worker processes share the
    cores, where torch's thread pool oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# fault models and the injector
# ---------------------------------------------------------------------------

def _model_pairs():
    """(port model, JAX model) pairs over every model and a Compose."""
    cases = [
        ("FailStop", dict(workers=(1, 3), at=4, until=9)),
        ("FailStop", dict(workers=(2,), at=0)),
        ("FailSlow", dict(workers=(0, 2), factor=3.5, start=2, stop=11)),
        ("FailSlow", dict(workers=(1,))),
        ("PoissonChurn", dict(leave_rate=0.25, rejoin_rate=0.5, seed=1)),
        ("PoissonChurn", dict(leave_rate=0.4, rejoin_rate=0.6, seed=5)),
        ("PoissonChurn", dict(leave_rate=0.1, rejoin_rate=0.3, seed=11,
                              pin=2)),
        ("PoissonChurn", dict(leave_rate=0.7, rejoin_rate=0.2, seed=0,
                              pin=0)),
        ("CorrelatedOutage", dict(group=(2, 3), period=5, duration=2,
                                  start=1)),
    ]
    pairs = [(getattr(faults, name)(**kw), getattr(jfaults, name)(**kw))
             for name, kw in cases]
    pairs.append((faults.Compose(tuple(p for p, _ in pairs[3:6])),
                  jfaults.Compose(tuple(j for _, j in pairs[3:6]))))
    pairs.append((faults.Compose(tuple(p for p, _ in pairs[::3])),
                  jfaults.Compose(tuple(j for _, j in pairs[::3]))))
    return pairs


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("idx", range(11))
def test_fault_models_equal_jax(idx, n):
    """``fleet(e, n)`` for epochs 0 to 40: masks, slowdowns, ``healthy``."""
    mine, ref = _model_pairs()[idx]
    for e in range(41):
        got, want = mine.fleet(e, n), ref.fleet(e, n)
        np.testing.assert_array_equal(got.active, want.active)
        np.testing.assert_array_equal(got.slow, want.slow)
        assert got.active.dtype == want.active.dtype
        assert got.slow.dtype == want.slow.dtype
        assert got.healthy == want.healthy


def test_churn_masks_of_the_chip_phase():
    model = faults.PoissonChurn(**CHURN)
    got = ["".join(str(int(a)) for a in model.fleet(e, N).active)
           for e in range(6)]
    assert got == CHURN_MASKS


class _Recorder:
    """A stub session that records what an injector actuates."""

    def __init__(self, n):
        self.n_workers = n
        self.calls = []

    def set_active(self, mask):
        self.calls.append(("set_active", np.asarray(mask).tolist()))

    def set_slowdown(self, slow):
        self.calls.append(("set_slowdown", None if slow is None
                           else np.asarray(slow).tolist()))


@pytest.mark.parametrize("idx", [0, 2, 4, 6, 7, 8, 9, 10])
def test_injector_actuates_like_jax(idx):
    """The same set_active / set_slowdown calls, events, change counts and
    returned fleet states, over epochs 0 to 30 (the all-down epochs of
    the unpinned churn exercise the quorum guard)."""
    mine, ref = _model_pairs()[idx]
    a, b = faults.FaultInjector(mine), jfaults.FaultInjector(ref)
    ra, rb = _Recorder(N), _Recorder(N)
    for e in range(31):
        sa, sb = a.apply(ra, e), b.apply(rb, e)
        np.testing.assert_array_equal(sa.active, sb.active)
        np.testing.assert_array_equal(sa.slow, sb.slow)
    assert ra.calls == rb.calls
    assert a.events == b.events
    assert a.membership_changes == b.membership_changes


# ---------------------------------------------------------------------------
# coded placement and decode weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,rho", [(8, 3), (8, 0), (4, -1), (6, 4)])
def test_coded_assignment_validation_equals_jax(n, rho):
    with pytest.raises(ValueError) as want:
        jred.CodedAssignment(n, rho)
    with pytest.raises(ValueError) as got:
        redundancy.CodedAssignment(n, rho)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="assignment covers 8 workers"):
        redundancy.epoch_weights(torch.zeros(4, dtype=torch.int32), 4, 2,
                                 redundancy.CodedAssignment(8, 2))


@pytest.mark.parametrize("n,rho", [(4, 1), (4, 2), (4, 4), (8, 1), (8, 2),
                                   (8, 4)])
def test_assignment_layout_equals_jax(n, rho):
    mine, ref = redundancy.CodedAssignment(n, rho), \
        jred.CodedAssignment(n, rho)
    assert mine.groups == ref.groups
    assert [mine.group(i) for i in range(n)] == \
        [ref.group(i) for i in range(n)]
    np.testing.assert_array_equal(mine.data_nodes(), ref.data_nodes())
    for per in (1, 2, 5, 8):
        np.testing.assert_array_equal(mine.shifts(per), ref.shifts(per))


@pytest.mark.parametrize("per", [2, 5, 8])
@pytest.mark.parametrize("n,rho", [(4, 1), (4, 2), (4, 4), (8, 1), (8, 2),
                                   (8, 4)])
def test_decode_weights_equal_jax_bit_for_bit(n, rho, per):
    """Random b with zeros and b > per, and the all-zero, all-full and
    one-survivor-per-group cases; with and without an assignment at
    rho 1."""
    rng = np.random.default_rng(n * 100 + rho * 10 + per)
    bs = [rng.integers(0, per + 3, size=n) for _ in range(12)]
    bs += [np.zeros(n, int), np.full(n, per), np.full(n, per + 4),
           np.tile([per] + [0] * (rho - 1), n // rho)]
    assigns = [(redundancy.CodedAssignment(n, rho),
                jred.CodedAssignment(n, rho))]
    if rho == 1:
        assigns.append((None, None))
    for b in bs:
        for mine, ref in assigns:
            sw, bw = redundancy.epoch_weights(
                torch.tensor(b, dtype=torch.int32), n, per, mine)
            jsw, jbw = jred.epoch_weights(jnp.asarray(b, jnp.int32), n,
                                          per, ref)
            assert sw.dtype == torch.float32 and bw.dtype == torch.float32
            np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
            np.testing.assert_array_equal(bw.numpy(), np.asarray(jbw))


@pytest.mark.parametrize("b", [[2, 1, 0, 2], [0, 0, 0, 0], [5, 2, 2, 9]])
def test_rho_one_is_seq_weights_from_b(b):
    bt = torch.tensor(b, dtype=torch.int32)
    ref = amb.seq_weights_from_b(bt, N * PER, N).reshape(N, PER)
    for a in (None, redundancy.CodedAssignment(N, 1)):
        sw, bw = redundancy.epoch_weights(bt, N, PER, a)
        assert torch.equal(sw, ref)
        assert torch.equal(bw, torch.clamp(bt, max=PER).float())
    # the old names stay importable from the step module
    assert amb.epoch_weights is redundancy.epoch_weights
    assert amb.seq_weights_from_b is redundancy.seq_weights_from_b


@pytest.mark.parametrize("n,rho,per", [(4, 2, 2), (4, 2, 8), (8, 4, 4),
                                       (4, 1, 3)])
def test_coded_source_places_rotated_copies(n, rho, per):
    """Member m's shard is its group's block rolled by -shift_m: slot s
    holds block slot (s + shift_m) % per, with JAX's data nodes and
    shifts; the blocks are the stream's group nodes (built in one
    ``batch_nodes`` call).  The tokens differ from JAX's by design."""
    a = redundancy.CodedAssignment(n, rho)
    ref = jred.CodedAssignment(n, rho)
    stream = LMTokenStream(vocab_size=97, seq_len=SEQ, seed=3,
                           device="cpu")
    calls = []
    real = stream.batch_nodes

    def spy(nodes, epoch, size):
        calls.append(list(nodes))
        return real(nodes, epoch, size)

    object.__setattr__(stream, "batch_nodes", spy)
    src = StreamSource(stream, n, per, assignment=a)
    out = src.batch(4)
    assert calls == [list(range(n // rho if rho > 1 else n))]
    toks = out["tokens"].reshape(n, per, SEQ)
    labels = out["labels"].reshape(n, per, SEQ)
    shifts, nodes = ref.shifts(per), ref.data_nodes()
    for i in range(n):
        block = real([int(nodes[i])], 4, per)
        for s in range(per):
            u = (s + int(shifts[i])) % per
            assert torch.equal(toks[i, s], block["tokens"][u])
            assert torch.equal(labels[i, s], block["labels"][u])
    with pytest.raises(ValueError, match="assignment covers"):
        StreamSource(stream, n + 1, per, assignment=a)


def test_coded_source_jax_structure_on_a_shared_stream():
    """JAX's coded source on a stream that is the same in both packages
    (rows that name their node, epoch and slot): equal batches."""

    class TaggedTorch:
        def batch(self, node, epoch, size):
            rows = torch.arange(size)[:, None] + 1000 * node + 100 * epoch
            x = rows.repeat(1, 3).to(torch.int32)
            return {"tokens": x, "labels": -x}

    class TaggedJax:
        def batch(self, node, epoch, size):
            rows = jnp.arange(size)[:, None] + 1000 * node + 100 * epoch
            x = jnp.tile(rows, (1, 3)).astype(jnp.int32)
            return {"tokens": x, "labels": -x}

    for rho in (1, 2, 4):
        got = StreamSource(TaggedTorch(), N, 4, assignment=(
            redundancy.CodedAssignment(N, rho))).batch(2)
        want = jloader.StreamSource(TaggedJax(), N, 4, assignment=(
            jred.CodedAssignment(N, rho))).batch(2)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the coded steps against JAX's
# ---------------------------------------------------------------------------

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


def _models():
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


def _coded_batch(rng):
    """A coded global batch: each group's block rolled per member."""
    a = redundancy.CodedAssignment(N, 2)
    blocks = rng.integers(0, 512, (a.groups, PER, SEQ)).astype(np.int32)
    toks = np.concatenate([np.roll(blocks[a.data_nodes()[i]],
                                   -int(a.shifts(PER)[i]), axis=0)
                           for i in range(N)])
    labels = np.concatenate([toks[:, 1:], np.full((N * PER, 1), -1,
                                                  np.int32)], 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


CODED_BS = [[2, 0, 1, 2], [2, 2, 2, 2], [0, 1, 0, 0], [1, 1, 3, 0]]


def test_coded_exact_step_matches_jax():
    jcfg, cfg, jparams, model = _models()
    jamb_cfg = jamb.AMBConfig(redundancy=2, beta=JBeta(*BETA))
    jopt = JDualAveraging(beta=JBeta(*BETA))
    jstate = jopt.init(jparams)
    jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN, jamb_cfg))
    opt = DualAveragingOpt(beta=BetaSchedule(*BETA))
    params = model.params()
    state = opt.init(params)
    step = amb.make_train_step(cfg, opt, N, amb.AMBConfig(
        redundancy=2, beta=BetaSchedule(*BETA)))
    rng = np.random.default_rng(3)
    for b in CODED_BS:
        jbatch, batch = _coded_batch(rng)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch,
                                    jnp.asarray(b, jnp.int32))
        params, state, m = step(params, state, batch, b)
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _close(state["z"], _flat(jstate["z"]), 1e-3, 1e-5)
        _close(params, _flat(jparams), 1e-5, 1e-6)
    # b(t) counts distinct covered samples: (1, 1) are the complementary
    # halves of group 0's block, and b_2 = 3 covers group 1's two slots
    assert [float(redundancy.epoch_weights(
        torch.tensor(b, dtype=torch.int32), N, PER,
        redundancy.CodedAssignment(N, 2))[1].sum()) for b in CODED_BS] == \
        [4.0, 4.0, 1.0, 4.0]


@pytest.mark.parametrize("driver", ["gossip", "pipelined", "async2"])
def test_coded_gossip_drivers_match_jax(driver):
    """rho = 2 through the sequential, pipelined and async D = 2 drivers
    (r = 2), three epochs and a flush."""
    from repro.dist import async_epochs as jasync
    from repro.dist import pipeline as jpipe
    from repro_torch.dist import async_epochs, pipeline
    jcfg, cfg, jparams, model = _models()
    kw = dict(consensus="gossip", gossip_rounds=2, redundancy=2)
    jamb_cfg = jamb.AMBConfig(beta=JBeta(*BETA), **kw)
    mine = amb.AMBConfig(beta=BetaSchedule(*BETA), **kw)
    jflush = flush = None
    if driver == "gossip":
        jinit, jstep = jamb.make_gossip_train_step(jcfg, STANDIN, jamb_cfg)
        init, step = amb.make_gossip_train_step(cfg, N, mine)
    elif driver == "pipelined":
        jinit, jstep, jflush = jpipe.make_pipelined_gossip_train_step(
            jcfg, STANDIN, jamb_cfg)
        init, step, flush = pipeline.make_pipelined_gossip_train_step(
            cfg, N, mine)
    else:
        jinit, jstep, jflush = jasync.make_async_gossip_train_step(
            jcfg, STANDIN, jamb_cfg, staleness=2)
        init, step, flush = async_epochs.make_async_gossip_train_step(
            cfg, N, mine, staleness=2)
    jstate = _jax_state(jparams, driver)
    state = init(model.params())
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(5)
    for b in CODED_BS[:3]:
        jbatch, batch = _coded_batch(rng)
        jstate, jm = jstep(jstate, jbatch, jnp.asarray(b, jnp.int32))
        state, m = step(state, batch, b)
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert "grad_var" not in m and "grad_var" not in jm
    if flush is not None:
        jstate, state = jflush(jstate), flush(state)
    _close(state["z"], _flat(jstate["z"]), 1e-3, 1e-5)


def _jax_state(jparams, driver):
    """JAX's driver state built by hand (its init shards on a mesh)."""
    width = sum(int(np.prod(p.shape)) for p in
                jax.tree.leaves(jparams)) + 1
    state = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    if driver == "pipelined":
        state["pending"] = jnp.zeros((N, width), jnp.float32)
    elif driver == "async2":
        state["queue"] = tuple(jnp.zeros((N, width), jnp.float32)
                               for _ in range(2))
        state["snaps"] = tuple(jnp.zeros((N, width - 1), jnp.float32)
                               for _ in range(2))
    return state


# ---------------------------------------------------------------------------
# sessions under churn with coded placement
# ---------------------------------------------------------------------------

TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ,
                  redundancy=2)


def test_session_validates_the_coded_layout():
    with pytest.raises(ValueError, match="must divide the 4 workers"):
        AMBSession(dataclasses.replace(TRAIN, redundancy=3),
                   ClockSpec(kind="simulated"), device="cpu")
    s = AMBSession(TRAIN, ClockSpec(kind="simulated"), device="cpu")
    src = s.batch_source()
    assert src.assignment == redundancy.CodedAssignment(N, 2)
    assert s.protocol.amb.redundancy == 2
    assert s.protocol.amb.noise_stats is False


def _events(model):
    """JAX's injector's events over 6 epochs (a stub session)."""
    inj = jfaults.FaultInjector(model)
    for e in range(6):
        inj.apply(_Recorder(N), e)
    return inj.events


@pytest.mark.parametrize("mode", [dict(), dict(pipeline=True)])
def test_run_under_churn_replays_jax_events_and_restores(mode, tmp_path):
    """``run(6, faults=PoissonChurn(0.25, 0.5, seed=1))`` with rho = 2
    through the prefetcher: JAX's events (the initial mask and five
    changes); a down worker's b is 0 and its duals stay bit for bit over
    its down epochs; the 2-survivor ring (workers 0 and 3) runs on the
    survivor table; 3 epochs, save, restore and 3 more under a fresh
    injector equal the uninterrupted run bit for bit."""
    cons = ConsensusSpec(consensus="gossip", gossip_rounds=2, **mode)

    def fresh():
        return AMBSession(TRAIN, ClockSpec(kind="simulated"), cons,
                          device="cpu")

    model = faults.PoissonChurn(**CHURN)
    ref = fresh()
    inj = faults.FaultInjector(model)
    losses, seen = [], []
    held = {}

    def watch(epoch, m):
        losses.append(m["loss"])
        seen.append(m["b"].tolist())
        mask = [c == "1" for c in CHURN_MASKS[epoch]]
        assert ref.active.tolist() == mask
        if not ref._decentralized or "pending" in ref.state:
            return
        for i, up in enumerate(mask):
            if not up:
                rows = {k: v[i] for k, v in ref.state["z"].items()}
                if i in held:
                    for k, v in rows.items():
                        assert torch.equal(v, held[i][k])
                held[i] = {k: v.clone() for k, v in rows.items()}
            else:
                held.pop(i, None)

    ref.run(6, faults=inj, on_step=watch)
    assert inj.events == _events(jfaults.PoissonChurn(**CHURN))
    assert ["".join(str(a) for a in e["active"]) for e in inj.events] == \
        CHURN_MASKS
    assert inj.membership_changes == 6 and np.isfinite(losses).all()
    for epoch, b in enumerate(seen):
        assert all(bi == 0 for bi, c in zip(b, CHURN_MASKS[epoch])
                   if c == "0")
    strat = consensus.make_strategy("gossip", N, rounds=2,
                                    active=(True, False, False, True))
    assert isinstance(strat.taps, consensus.SurvivorTaps)
    assert strat.taps.source_rows().shape[1] == N

    sess = fresh()
    sess.run(3, faults=faults.FaultInjector(model), prefetch=0)
    sess.save(tmp_path)
    resumed = AMBSession.restore(tmp_path, device="cpu")
    assert resumed.active.tolist() == sess.active.tolist()
    got = []
    resumed.run(3, faults=faults.FaultInjector(model),
                on_step=lambda e, m: got.append(m["loss"]))
    assert got == losses[3:]
    for k, v in ref.state["z"].items():
        assert torch.equal(resumed.state["z"][k], v)
