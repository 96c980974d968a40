"""Bounded-staleness async epochs (D > 1) in the port against
``repro``: the driver against JAX's, the session's staleness retune, and
the simulator's oracles (``run_amb_pipelined``, ``run_amb_delayed``,
``run_amb_quantized``) against JAX's ``History`` on JAX's draws.

Tolerances: the drivers as ``tests/test_torch_pipeline.py`` states; the
oracles as ``tests/test_torch_engine.py`` holds ``run`` (rtol 1e-4,
integer fields and the wall clock equal), except that the quantized
oracle's float fields are held within 1e-2 of each field's norm: there
too a gradient's last bit can flip a stochastic rounding (measured: a
flip moves the final eval loss by 1.5% at a loss of 0.009, its field by
2e-5 of the norm), and its consensus_eps, the norm of the rounding noise
itself, within 5e-2 (measured 1.4e-2 at 4 bits).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import dual_averaging as jda  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import extensions as jext  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import stragglers as jstr  # noqa: E402
from repro_torch.api import AMBSession, ClockSpec, ConsensusSpec  # noqa
from repro_torch.core import dual_averaging as da  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import extensions as ext  # noqa: E402
from repro_torch.core import objectives as obj  # noqa: E402
from repro_torch.core import stragglers as stg  # noqa: E402
from repro_torch.dist import amb, async_epochs  # noqa: E402
from test_torch_pipeline import (N, Q_RTOL, TRAIN, _jax_draws,  # noqa: E402
                                 check_driver)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs several worker
    processes on shared cores, where torch's thread pool oversubscribes
    them (these tests' small ops ran up to 40x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("consensus", ["gossip", "gossip_q8"])
@pytest.mark.parametrize("staleness", [2, 3])
def test_async_driver_matches_jax_over_four_epochs_and_a_flush(staleness,
                                                               consensus):
    check_driver("async", staleness, consensus)


def test_apply_staleness_drains_rebuilds_and_carries_the_dual():
    s = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                   ConsensusSpec(consensus="gossip", async_epochs=True,
                                 staleness=2), device="cpu")
    source = s.batch_source()
    for e in range(3):
        s.step(source.batch(e))
    proto2 = s.protocol
    drained = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip", async_epochs=True,
                                       staleness=2), device="cpu")
    for e in range(3):
        drained.step(source.batch(e))
    drained.flush()
    s._apply_staleness(3)
    assert s.consensus_spec.staleness == 3 and s.protocol.staleness == 3
    assert len(s.state["queue"]) == len(s.state["snaps"]) == 3
    assert not any(q.any() for q in s.state["queue"] + s.state["snaps"])
    assert s.state["t"] == 3
    for k, v in drained.state["z"].items():
        torch.testing.assert_close(s.state["z"][k], v, rtol=0, atol=0)
    s._apply_staleness(3)                      # the same D: a no-op
    s.step(source.batch(3))
    s._apply_staleness(2)
    assert s.protocol is proto2                # the cache holds D = 2
    assert len(s.state["queue"]) == 2
    with pytest.raises(ValueError, match="async driver's knob"):
        AMBSession(TRAIN, ClockSpec(kind="simulated"),
                   ConsensusSpec(consensus="gossip"),
                   device="cpu")._apply_staleness(2)


# ---------------------------------------------------------------------------
# the simulator's oracles, against JAX's History on JAX's draws
# ---------------------------------------------------------------------------

FIELDS = ("wall_time", "batch_sizes", "global_batch", "eval_loss",
          "train_loss", "consensus_eps", "regret", "potential_samples")
EXACT_FIELDS = ("wall_time", "batch_sizes", "global_batch")


def _t(x):
    return torch.from_numpy(np.array(x))


def _chunks(jo, key, cfg, sample_args):
    return [tuple(np.array(x) for x in jo.sample(
        jax.random.fold_in(key, c), (cfg.n, cfg.chunk), *sample_args))
        for c in range(cfg.b_max // cfg.chunk)]


def _oracle_draws(kind, jo, model, cfg, key, sample_args):
    """JAX's epoch draws as each oracle derives them from ``key``."""
    def draws(t):
        key_t = jax.random.fold_in(key, t)
        if kind == "quantized":
            ktime, kgrad, kq = jax.random.split(key_t, 3)
        else:
            ktime, kgrad = jax.random.split(key_t)
        times = np.array(model.per_gradient_times(ktime, cfg.n, cfg.b_max))
        fresh = _chunks(jo, kgrad, cfg, sample_args)
        if kind == "pipelined":
            return times, fresh, _chunks(jo, jax.random.fold_in(kgrad, 1),
                                         cfg, sample_args)
        if kind == "quantized":
            return times, fresh, _jax_draws(kq)
        return times, fresh
    return draws


@pytest.mark.parametrize("kind,extra", [
    ("pipelined", {}), ("delayed", dict(staleness=1)),
    ("delayed", dict(staleness=3)), ("quantized", dict(bits=8)),
    ("quantized", dict(bits=4))])
@pytest.mark.parametrize("consensus_mode", ["gossip", "exact"])
def test_oracles_match_jax_history_on_jax_draws(kind, extra,
                                                consensus_mode):
    """Linear regression at d 64, n 10 on the paper graph, b_max 64, chunk
    16, 12 epochs."""
    mine, ref = obj.LinearRegression(dim=64), jobj.LinearRegression(dim=64)
    ws = jax.random.normal(jax.random.PRNGKey(7), (64,))
    model = jstr.ShiftedExponential(lam=2 / 3, zeta=1.0, b_ref=32)
    kw = dict(n=10, b_max=64, chunk=16, comm_time=0.5,
              compute_time=jstr.amb_budget_from_fmb(model, 10, 320),
              consensus_rounds=5, consensus_mode=consensus_mode)
    jcfg = jeng.EngineConfig(beta=jda.BetaSchedule(k=1.0, mu=320.0), **kw)
    cfg = eng.EngineConfig(beta=da.BetaSchedule(k=1.0, mu=320.0), **kw)
    key = jax.random.PRNGKey(0)
    jrun = getattr(jext, f"run_amb_{kind}")
    run = getattr(ext, f"run_amb_{kind}")
    want = jrun(ref, model, jcfg, epochs=12, key=key, sample_args=(ws,),
                eval_fn=lambda w: ref.population_loss(w, ws),
                f_star=0.5 * ref.noise_var, **extra)
    tws = _t(ws)
    got = run(mine, None, cfg, epochs=12, sample_args=(tws,),
              eval_fn=lambda w: mine.population_loss(w, tws),
              f_star=0.5 * ref.noise_var, device="cpu",
              draws=_oracle_draws(kind, ref, model, jcfg, key, (ws,)),
              **extra)
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif kind == "quantized":
            tol = 5e-2 if f == "consensus_eps" else Q_RTOL
            assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), f
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=f)


def test_oracles_run_on_their_own_draws_and_reject_staleness_zero():
    mine = obj.LinearRegression(dim=16)
    ws = torch.randn(16, generator=torch.Generator().manual_seed(1))
    cfg = eng.EngineConfig(n=6, b_max=32, chunk=16, graph="ring",
                           compute_time=30.0, comm_time=4.0)
    sm = stg.ShiftedExponential(b_ref=16)
    for run, kw in ((ext.run_amb_pipelined, {}),
                    (ext.run_amb_delayed, dict(staleness=2)),
                    (ext.run_amb_quantized, dict(bits=4))):
        gen = torch.Generator().manual_seed(0)
        h = run(mine, sm, cfg, epochs=5, generator=gen, sample_args=(ws,),
                eval_fn=lambda w: mine.population_loss(w, ws), **kw)
        assert h.wall_time.shape == (5,) and torch.isfinite(
            h.eval_loss).all()
        step = max(30.0, 4.0 / 2) if kw.get("staleness") else 34.0
        np.testing.assert_allclose(h.wall_time.numpy(),
                                   np.arange(1, 6) * step, rtol=1e-6)
    with pytest.raises(ValueError, match="staleness must be >= 1"):
        ext.run_amb_delayed(mine, sm, cfg, staleness=0, epochs=1,
                            device="cpu")
    with pytest.raises(ValueError, match="staleness must be >= 1"):
        async_epochs.make_async_gossip_train_step(None, N, amb.AMBConfig(),
                                                  staleness=0)
