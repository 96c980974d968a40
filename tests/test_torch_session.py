"""The port's ``AMBSession`` against the JAX steps it drives.

Batches and per-worker minibatch sizes b are injected, so both sides see
the same epochs; the session's beta schedule is
``ConsensusSpec.beta(global_batch)`` (k 50, mu = global batch, scale 200).
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
from repro.api import clock as jclock  # noqa: E402
from repro.api.specs import ClockSpec as JClockSpec  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec, clock)
from repro_torch.data import (LMTokenStream, StreamSource,  # noqa: E402
                              SyntheticSource)

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BS = [[2, 1, 0, 2], [2, 2, 2, 2], [1, 0, 2, 2]]
TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _setup(consensus, radius=None):
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(3), jcfg)
    session = AMBSession(
        TRAIN, ClockSpec(kind="simulated"),
        ConsensusSpec(consensus=consensus, radius=radius), cfg=cfg,
        params=models.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu"),
        device="cpu")
    return jcfg, jparams, session


@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_session_steps_match_jax_for_three_epochs(consensus):
    jcfg, jparams, session = _setup(consensus)
    beta = JBeta(50.0, float(N * PER), 200.0)
    if consensus == "exact":
        jopt = JDualAveraging(beta=beta)
        jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
        jstate = (jparams, jopt.init(jparams))
    else:
        amb_cfg = jamb.AMBConfig(consensus="gossip", beta=beta)
        jstep = jax.jit(jamb.make_gossip_train_step(jcfg, STANDIN,
                                                    amb_cfg)[1])
        jstate = {"z": jax.tree.map(
            lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
            "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    rng = np.random.default_rng(4)
    for t, b in enumerate(BS):
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        jb = jnp.asarray(b, jnp.int32)
        if consensus == "exact":
            p, o, jm = jstep(*jstate, jbatch, jb)
            jstate = (p, o)
        else:
            jstate, jm = jstep(jstate, jbatch, jb)
        m = session.step({"tokens": torch.from_numpy(toks).long(),
                          "labels": torch.from_numpy(labels).long()}, b)
        assert m["global_batch"] == float(jm["global_batch"])
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(m["b"], b)
    want = _flat(jstate[0] if consensus == "exact"
                 else jamb.gossip_primal(jstate, amb_cfg))
    session.flush()
    got = session.params
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert session.steps_done == 3


def test_exact_session_leaves_the_radius_out_of_its_optimizer():
    """The JAX session builds its exact optimizer as
    ``make_optimizer("dual_averaging", beta=...)``: no trust region, whatever
    ``ConsensusSpec.radius`` says.  With a radius this small a projected
    step would stay within 1e-4 of the start in each leaf."""
    jcfg, jparams, session = _setup("exact", radius=1e-4)
    jopt = JDualAveraging(beta=JBeta(50.0, float(N * PER), 200.0))
    jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
    jstate = (jparams, jopt.init(jparams))
    rng = np.random.default_rng(6)
    for b in BS[:2]:
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        p, o, _ = jstep(*jstate, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)},
                        jnp.asarray(b, jnp.int32))
        jstate = (p, o)
        session.step({"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()}, b)
    want, start = _flat(jstate[0]), _flat(jparams)
    moved = max(float(np.linalg.norm(want[k] - start[k])) for k in want)
    assert moved > 1e-3
    for k, w in want.items():
        np.testing.assert_allclose(session.params[k].detach().numpy(), w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert session.protocol.optimizer.radius is None


def test_session_logs_each_epoch_and_serves_its_batch_source(tmp_path):
    from repro_torch.metrics import read_metrics
    path = tmp_path / "train.jsonl"
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"), device="cpu",
                         metrics_path=str(path))
    source = session.batch_source()
    assert isinstance(source, StreamSource)
    assert isinstance(source.stream, LMTokenStream)
    assert (source.stream.vocab_size, source.stream.seq_len,
            source.n_workers, source.per_worker, source.stream.seed) == (
                512, SEQ, N, PER, 0)
    assert torch.device(source.stream.device) == session.device
    outs = [session.step(source.batch(e)) for e in range(2)]
    session.close()
    session.close()
    lines = read_metrics(path)
    assert [ln["step"] for ln in lines] == [1, 2]
    for ln, out in zip(lines, outs):
        assert ln.keys() == {"step", "elapsed_s", "loss", "global_batch",
                             "budget_s", "step_s", "sim_wall_s",
                             "staleness"}
        assert ln["loss"] == pytest.approx(out["loss"])


def test_session_clock_draws_b_and_run_drives_a_source():
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip"), device="cpu")
    source = SyntheticSource(session.cfg.vocab_size, SEQ, N, PER, seed=1,
                             device="cpu")
    out = session.run(2, source)
    budget = (1.0 + N / (N * PER)) * (1.0 + 1.5)        # Lemma 6
    assert out["budget_s"] == pytest.approx(budget)
    assert out["sim_wall_s"] == pytest.approx(2 * (budget + 0.5))
    assert session.steps_done == 2 and np.isfinite(out["loss"])
    assert out["global_batch"] == float(np.minimum(out["b"], PER).sum())
    assert ((0 <= out["b"]) & (out["b"] <= PER)).all()
    np.testing.assert_array_equal(
        session.epoch_sizes(torch.full((N, PER), 1.0), 1.5).numpy(),
        [1] * N)


def _jax_step_keys() -> set:
    """The keys of the metrics dict that ``repro.api.session.AMBSession.
    step`` returns, read from its source (``out = {...}``): the JAX session
    needs a device mesh whose steps do not run on this CPU, so the test
    reads the keys rather than a run's output."""
    import ast
    import inspect
    from repro.api.session import AMBSession as JAMBSession
    tree = ast.parse(inspect.cleandoc("\n" + inspect.getsource(
        JAMBSession.step)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets] == ["out"]:
            return {k.value for k in node.value.keys}
    raise AssertionError("no `out = {...}` in the JAX session's step")


def test_run_defaults_to_the_batch_source():
    """``run(2)`` with no source equals ``run(2, batch_source())``, epoch
    for epoch (the simulated clock draws the same b from (seed, epoch))."""
    runs = []
    for explicit in (False, True):
        session = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                             ConsensusSpec(consensus="gossip"), device="cpu")
        seen = []
        args = (session.batch_source(),) if explicit else ()
        last = session.run(2, *args, on_step=lambda e, m: seen.append(m))
        assert last is seen[-1] and session.steps_done == 2
        runs.append((seen, session.params))
    (a, pa), (b, pb) = runs
    for ma, mb in zip(a, b):
        assert ma["loss"] == mb["loss"]
        assert ma["global_batch"] == mb["global_batch"]
        np.testing.assert_array_equal(ma["b"], mb["b"])
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


def test_on_step_gets_jax_epoch_indices():
    """``on_step(epoch, metrics)`` gets the 0-based absolute index of the
    epoch just run (JAX's session passes ``steps_done - 1``, as
    ``tests/test_api.py`` holds it), also after an earlier ``step``;
    ``run(0)`` runs nothing and returns None."""
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"), device="cpu")
    seen = []
    assert session.run(0, on_step=lambda e, m: seen.append(e)) is None
    assert seen == [] and session.steps_done == 0
    session.step(session.batch_source().batch(0))
    session.run(2, on_step=lambda e, m: seen.append((e, session.steps_done)))
    assert seen == [(1, 2), (2, 3)]


def test_step_output_and_metrics_lines_carry_staleness(tmp_path):
    """Every step output and JSONL line has ``staleness`` 1, with JAX's
    key set: the step output's keys are those of JAX's ``out`` dict
    (``src/repro/api/session.py``), a line's are those less ``b`` plus the
    logger's ``step`` and ``elapsed_s``."""
    from repro_torch.metrics import read_metrics
    jax_keys = _jax_step_keys()
    assert "staleness" in jax_keys
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"), device="cpu",
                         metrics_path=str(tmp_path / "train.jsonl"))
    outs = []
    session.step(session.batch_source().batch(0))
    session.run(2, on_step=lambda e, m: outs.append(m))
    session.close()
    lines = read_metrics(tmp_path / "train.jsonl")
    assert len(outs) == 2 and len(lines) == 3
    for out in outs:
        assert out.keys() == jax_keys and out["staleness"] == 1
    for ln in lines:
        assert ln.keys() == (jax_keys - {"b"}) | {"step", "elapsed_s"}
        assert ln["staleness"] == 1


@pytest.mark.parametrize("compute_time", [None, 0.0, 2.5])
@pytest.mark.parametrize("straggler", ["shifted_exp", "deterministic"])
def test_measured_clock_matches_jax(straggler, compute_time):
    """The session's default clock against JAX's: the same update sequence
    gives the same EMA and budget and, on the same relative draws, the
    same epoch times (fp32 times, rtol 1e-6; fp64 scalars, rel 1e-12)."""
    jc = jclock.make_clock(JClockSpec(straggler=straggler,
                                      compute_time=compute_time), N, PER)
    tc = clock.make_clock(ClockSpec(straggler=straggler,
                                    compute_time=compute_time), N, PER)
    assert isinstance(tc, clock.MeasuredClock)
    assert tc.model_unit == pytest.approx(jc.model_unit, rel=1e-12)
    for t, (step_s, gb) in enumerate([(0.8, 8.0), (0.3, 5.0), (1.2, 0.0),
                                      (0.5, 7.0)]):
        key = jax.random.PRNGKey(t)
        jtimes, jbudget = jc.epoch(key)
        draws = torch.tensor(np.asarray(
            jc.model.per_gradient_times(key, N, PER)))
        tc.model = types.SimpleNamespace(
            per_gradient_times=lambda gen, n, b, d=draws: d)
        times, budget = tc.epoch(torch.Generator().manual_seed(t))
        assert budget == pytest.approx(jbudget, rel=1e-12)
        np.testing.assert_allclose(times.numpy(), np.asarray(jtimes),
                                   rtol=1e-6)
        jc.update(step_s, gb)
        tc.update(step_s, gb)
        assert tc.sec_per_grad == pytest.approx(jc.sec_per_grad, rel=1e-12)


def test_session_default_clock_is_measured_and_fed_each_step():
    session = AMBSession(TRAIN, device="cpu")
    assert isinstance(session.clock, clock.MeasuredClock)
    source = SyntheticSource(session.cfg.vocab_size, SEQ, N, PER, seed=2,
                             device="cpu")
    first = session.step(source.batch(0))
    unit = first["step_s"] / max(first["global_batch"], 1.0)
    assert session.clock.sec_per_grad == pytest.approx(unit, rel=1e-12)
    second = session.step(source.batch(1))
    assert second["budget_s"] == pytest.approx(
        (1.0 + N / (N * PER)) * unit * PER, rel=1e-12)      # Lemma 6


def test_synthetic_source_is_deterministic_per_epoch():
    src = SyntheticSource(512, SEQ, N, PER, seed=5, device="cpu")
    a, b = src.batch(3), src.batch(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], src.batch(4)["tokens"])
    assert a["tokens"].shape == (N * PER, SEQ)
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    assert int(a["tokens"].max()) < 512 and int(a["tokens"].min()) >= 0


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AMBSession(TRAIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticSource(512, SEQ, N, PER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.from_jax_params({}, configs.smoke_config("qwen2-1.5b"))
