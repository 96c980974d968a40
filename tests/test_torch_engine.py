"""The port's §6 simulator (``repro_torch.core``: stragglers, consensus,
dual averaging, objectives, regret, the AMB / FMB engine) against
``repro.core`` on the same inputs.

Tolerances: fp32 results computed in another order, rtol 1e-4 (measured
at most 1.1e-5 over 20 epochs); integer results (b_i(t), b(t), potential
samples) and the wall clock under AMB are equal; numpy and Python-float
helpers are equal.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import consensus as jcns  # noqa: E402
from repro.core import dual_averaging as jda  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import regret as jreg  # noqa: E402
from repro.core import stragglers as jstr  # noqa: E402
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core import dual_averaging as da  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import objectives as obj  # noqa: E402
from repro_torch.core import regret as reg  # noqa: E402
from repro_torch.core import stragglers as stg  # noqa: E402

RTOL = 1e-4
FIELDS = ("wall_time", "batch_sizes", "global_batch", "eval_loss",
          "train_loss", "consensus_eps", "regret", "potential_samples")
EXACT_FIELDS = ("batch_sizes", "global_batch", "potential_samples")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_per_node", [1, 7, 16])
def test_fmb_finish_times_match(b_per_node):
    times = np.random.default_rng(2).random((6, 16)).astype(np.float32)
    want = jstr.fmb_finish_times(jnp.asarray(times), b_per_node)
    got = stg.fmb_finish_times(_t(times), b_per_node)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for bad in (0, 17):
        with pytest.raises(ValueError):
            stg.fmb_finish_times(_t(times), bad)


@pytest.mark.parametrize("model", [
    ("ShiftedExponential", {}), ("Deterministic", dict(grad_time=0.3,
                                                      b_ref=4)),
    ("InducedGroups", {}), ("PauseModel", {}),
    ("InducedGroups", dict(group_sizes=(2, 2), zetas=(1.0, 3.0),
                           lams=(2.0, 0.5), b_ref=50))])
@pytest.mark.parametrize("n,b_global", [(10, 600), (50, 500)])
def test_budgets_and_moments_match(model, n, b_global):
    name, kw = model
    mine, ref = getattr(stg, name)(**kw), getattr(jstr, name)(**kw)
    assert mine.mean_batch_time() == ref.mean_batch_time()
    assert mine.std_batch_time() == ref.std_batch_time()
    assert stg.amb_budget_from_fmb(mine, n, b_global) == \
        jstr.amb_budget_from_fmb(ref, n, b_global)
    mu, sg = ref.mean_batch_time(), ref.std_batch_time()
    assert stg.bertsimas_max_bound(mu, sg, n) == \
        jstr.bertsimas_max_bound(mu, sg, n)


def test_expected_max_batch_time_matches():
    mine, ref = stg.ShiftedExponential(), jstr.ShiftedExponential()
    for n in (1, 2, 10, 50):
        assert mine.expected_max_batch_time(n) == \
            ref.expected_max_batch_time(n)


@pytest.mark.parametrize("model,n,b_global", [
    ("ShiftedExponential", 10, 600), ("InducedGroups", 10, 585),
    ("PauseModel", 50, 500)])
def test_amb_budget_calibrated_on_jax_times(model, n, b_global):
    """Given JAX's 64 epochs of drawn times, the device bisection lands
    where JAX's host bisection does: both bisect in float64 against
    float32 cumulative sums, which XLA and torch associate differently
    (they differ in two thirds of the elements, by a few float32 ulps),
    so the threshold they find may move by as much (rel 1e-6)."""
    ref = getattr(jstr, model)()
    key, b_max = jax.random.PRNGKey(0), max(4 * b_global // n, 16)
    want = jstr.amb_budget_calibrated(ref, n, b_global, key=key)
    draws = iter([np.array(ref.per_gradient_times(
        jax.random.fold_in(key, e), n, b_max)) for e in range(64)])
    stand_in = types.SimpleNamespace(
        per_gradient_times=lambda gen, n_, b_: _t(next(draws)))
    got = stg.amb_budget_calibrated(stand_in, n, b_global,
                                    torch.Generator())
    assert got == pytest.approx(want, rel=1e-6)


def test_amb_budget_calibrated_hits_its_target_on_own_draws():
    """E[b(T)] at the calibrated T is b_global within 2% (fresh draws)."""
    model = stg.PauseModel()
    t = stg.amb_budget_calibrated(model, 50, 500, device="cpu")
    gen = torch.Generator().manual_seed(9)
    b = torch.stack([stg.amb_batch_sizes(
        model.per_gradient_times(gen, 50, 40), t).sum()
        for _ in range(200)]).float().mean()
    assert abs(float(b) - 500) < 10


def test_induced_groups_moments():
    """Per-group sample means of T = b_ref * per-gradient time over 4000
    epochs: zeta_g + 1/lam_g within 4 standard errors (1/lam_g /
    sqrt(epochs * size_g)); linear progress within a row."""
    model = stg.InducedGroups()
    gen = torch.Generator().manual_seed(0)
    times = torch.stack([model.per_gradient_times(gen, 10, 3)
                         for _ in range(4000)])
    assert times.dtype == torch.float32
    assert torch.equal(times[..., 0], times[..., 2])
    t_batch = times[..., 0].double() * model.b_ref
    start = 0
    for size, zeta, lam in zip(model.group_sizes, model.zetas, model.lams):
        grp = t_batch[:, start:start + size]
        se = (1.0 / lam) / np.sqrt(grp.numel())
        assert abs(float(grp.mean()) - (zeta + 1.0 / lam)) < 4 * se
        assert float(grp.min()) >= zeta * (1 - 1e-6)
        start += size
    with pytest.raises(ValueError):
        model.per_gradient_times(gen, 9, 3)


def test_pause_model_moments():
    """Per group, the mean per-gradient time is base + E[max(0, N(mu,
    g^2))] (= base + mu to 1e-6 here) in seconds, within 4 standard
    errors; pauses are never negative."""
    model = stg.PauseModel()
    gen = torch.Generator().manual_seed(1)
    times = model.per_gradient_times(gen, 50, 2000).double() * 1000.0
    start = 0
    for g, (size, mu) in enumerate(zip(model.group_sizes, model.mus_ms)):
        grp = times[start:start + size]
        se = (g + 1) / np.sqrt(grp.numel())
        assert abs(float(grp.mean()) - (model.base_ms + mu)) < 4 * se
        assert abs(float(grp.std()) - (g + 1)) < 0.05 * (g + 1)
        start += size
    assert float(times.min()) >= model.base_ms - 1e-9


# ---------------------------------------------------------------------------
# consensus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p,seed", [(10, 0.4, 0), (12, 0.3, 5),
                                      (30, 0.15, 2)])
def test_erdos_renyi_graph_is_jax_bit_for_bit(n, p, seed):
    adj = cns.erdos_renyi_graph(n, p, seed)
    np.testing.assert_array_equal(adj, jcns.erdos_renyi_graph(n, p, seed))
    np.testing.assert_array_equal(
        cns.build_graph("erdos_renyi", n, p=p, seed=seed),
        jcns.build_graph("erdos_renyi", n, p=p, seed=seed))
    assert cns.is_connected(adj)


@pytest.mark.parametrize("name,n", [("paper", 10), ("ring", 8),
                                    ("complete", 5), ("star", 6),
                                    ("torus", 12), ("erdos_renyi", 10)])
def test_spectral_helpers_and_lemma1_match(name, n):
    assert cns.PAPER_GRAPH_LAZY == jcns.PAPER_GRAPH_LAZY
    for lazy in (0.3, 0.5):
        p = cns.metropolis_weights(cns.build_graph(name, n), lazy)
        assert cns.lambda2(p) == jcns.lambda2(p)
        assert cns.spectral_gap(p) == jcns.spectral_gap(p)
        for lip, eps in ((1.0, 0.1), (10.0, 1e-3)):
            assert cns.lemma1_rounds(n, lip, eps, p) == \
                jcns.lemma1_rounds(n, lip, eps, p)
    with pytest.raises(ValueError):
        cns.lemma1_rounds(n, 1.0, 0.0, p)


def test_paper_graph_gap_and_consensus_spec():
    p = cns.metropolis_weights(cns.paper_graph(), cns.PAPER_GRAPH_LAZY)
    assert cns.lambda2(p) == pytest.approx(0.888, abs=1e-3)
    spec = cns.ConsensusSpec(p=p, rounds=5)
    assert spec.rounds == 5
    with pytest.raises(ValueError, match="doubly stochastic"):
        cns.ConsensusSpec(p=p * 1.1, rounds=5)
    bad = np.array([[1.5, -0.5], [-0.5, 1.5]])
    with pytest.raises(ValueError, match="non-negative"):
        cns.ConsensusSpec(p=bad, rounds=1)
    with pytest.raises(ValueError):
        jcns.ConsensusSpec(p=bad, rounds=1)


def test_consensus_error_matches():
    m = np.random.default_rng(3).standard_normal((7, 4, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        float(cns.consensus_error(_t(m))),
        float(jcns.consensus_error(jnp.asarray(m))), rtol=1e-6)


# ---------------------------------------------------------------------------
# regret
# ---------------------------------------------------------------------------

def test_regret_bounds_match_exactly():
    kw = dict(lip_l=2.0, smooth_k=1.5, sigma=0.7, diameter=3.0)
    mine, ref = reg.ProblemConstants(**kw), jreg.ProblemConstants(**kw)
    t2 = dict(f_gap0=1.2, beta_tau=3.0, h_wstar=0.5, eps=0.01, c_max=640.0,
              mu=600.0, m=60000.0)
    assert reg.theorem2_bound(mine, **t2) == jreg.theorem2_bound(ref, **t2)
    t4 = dict(f_gap0=1.2, beta_tau=3.0, h_wstar=0.5, eps=0.01, c_bar=620.0,
              b_hat=580.0, m_bar=50000.0)
    assert reg.theorem4_bound(mine, **t4) == jreg.theorem4_bound(ref, **t4)
    for n in (1, 10, 100):
        assert reg.theorem7_ratio(2.5, 1.5, n) == \
            jreg.theorem7_ratio(2.5, 1.5, n)
        assert reg.shifted_exp_ratio(2 / 3, 1.0, n, 600.0) == \
            jreg.shifted_exp_ratio(2 / 3, 1.0, n, 600.0)
        assert reg.shifted_exp_asymptotic_ratio(2 / 3, 1.0, n) == \
            jreg.shifted_exp_asymptotic_ratio(2 / 3, 1.0, n)


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def _problems():
    rng = np.random.default_rng(4)
    lin = (obj.LinearRegression(dim=12), jobj.LinearRegression(dim=12),
           rng.standard_normal(12).astype(np.float32),
           (rng.standard_normal((9, 12)).astype(np.float32),
            rng.standard_normal(9).astype(np.float32)),
           (rng.standard_normal((3, 9, 12)).astype(np.float32),
            rng.standard_normal((3, 9)).astype(np.float32)))
    lo, lj = obj.LogisticRegression(dim=6, num_classes=4), \
        jobj.LogisticRegression(dim=6, num_classes=4)
    log = (lo, lj, rng.standard_normal(lo.param_dim).astype(np.float32),
           (rng.standard_normal((9, 6)).astype(np.float32),
            rng.integers(0, 4, 9).astype(np.int32)),
           (rng.standard_normal((3, 9, 6)).astype(np.float32),
            rng.integers(0, 4, (3, 9)).astype(np.int32)))
    return {"linreg": lin, "logreg": log}


@pytest.mark.parametrize("kind", ["linreg", "logreg"])
def test_objective_loss_grad_and_masked_sums_match(kind):
    mine, ref, w, batch, nbatch = _problems()[kind]
    tb, jb = tuple(_t(x) for x in batch), tuple(jnp.asarray(x)
                                                for x in batch)
    tw, jw = _t(w), jnp.asarray(w)
    mask = (np.arange(9) < 6).astype(np.float32)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

    close(mine.loss(tw, tb), ref.loss(jw, jb))
    close(mine.grad(tw, tb), ref.grad(jw, jb))
    close(mine.masked_grad(tw, tb, _t(mask)),
          ref.masked_grad(jw, jb, jnp.asarray(mask)))
    for got, want in zip(mine.masked_sums(tw, tb, _t(mask)),
                         ref.masked_sums(jw, jb, jnp.asarray(mask))):
        close(got, want)
    # with a leading node dim, as the engine stacks its nodes (JAX vmaps)
    wn = np.stack([w, 0.5 * w, -w])
    nmask = (np.arange(9)[None] < np.array([[0], [4], [9]])).astype(
        np.float32)
    got = mine.masked_sums(_t(wn), tuple(_t(x) for x in nbatch),
                           _t(nmask))
    want = jax.vmap(lambda wi, xi, yi, mi: ref.masked_sums(
        wi, (xi, yi), mi))(jnp.asarray(wn), *map(jnp.asarray, nbatch),
                           jnp.asarray(nmask))
    for g, wnt in zip(got, want):
        close(g, wnt)
    assert mine.init_w().shape == ref.init_w().shape


def test_linreg_population_loss_and_samplers():
    mine, ref = obj.LinearRegression(dim=8), jobj.LinearRegression(dim=8)
    rng = np.random.default_rng(5)
    w, ws = rng.standard_normal((2, 8)).astype(np.float32)
    np.testing.assert_allclose(
        float(mine.population_loss(_t(w), _t(ws))),
        float(ref.population_loss(jnp.asarray(w), jnp.asarray(ws))),
        rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    x, y = mine.sample(gen, (4, 5000), _t(ws))
    assert x.shape == (4, 5000, 8) and y.shape == (4, 5000)
    resid = (y - x @ _t(ws)).double()
    assert abs(float(resid.var()) - mine.noise_var) < 0.1 * mine.noise_var
    assert abs(float(x.double().std()) - 1.0) < 0.01
    lg = obj.LogisticRegression(dim=16, num_classes=5)
    means = lg.make_class_means(gen)
    assert means.shape == (5, 16)
    x, y = lg.sample(gen, (20000,), means)
    counts = torch.bincount(y, minlength=5).double() / 20000
    assert float((counts - 0.2).abs().max()) < 0.02
    assert abs(float((x - means[y]).double().std()) - 1.0) < 0.01


# ---------------------------------------------------------------------------
# dual averaging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [None, 0.5, 100.0])
def test_prox_step_tree_and_dual_averaging_match(radius):
    rng = np.random.default_rng(6)
    z = rng.standard_normal((5, 7)).astype(np.float32)
    beta = da.BetaSchedule(k=1.0, mu=3.0)(4)
    np.testing.assert_allclose(
        da.prox_step(_t(z), beta, radius).numpy(),
        np.asarray(jda.prox_step(jnp.asarray(z), jnp.float32(beta),
                                 radius)), rtol=1e-6, atol=1e-7)
    tree = {"a": z, "b": z[0] * 3.0}
    got = da.prox_step_tree({k: _t(v) for k, v in tree.items()}, beta,
                            radius)
    want = jda.prox_step_tree({k: jnp.asarray(v) for k, v in tree.items()},
                              jnp.float32(beta), radius)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    mine = da.DualAveraging(da.BetaSchedule(k=2.0, mu=5.0), radius)
    ref = jda.DualAveraging(jda.BetaSchedule(k=2.0, mu=5.0), radius)
    tz, jz = mine.init_dual(_t(z)), ref.init_dual(jnp.asarray(z))
    assert float(mine.init_primal(_t(z)).abs().max()) == 0.0
    for t in range(1, 5):
        g = rng.standard_normal(z.shape).astype(np.float32)
        tz, tw = mine.update(tz, _t(g), t)
        jz, jw = ref.update(jz, jnp.asarray(g), t)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the engine, against JAX's draws
# ---------------------------------------------------------------------------

def _jax_draws(jo, model, cfg, key, sample_args):
    """JAX's epoch draws, as its ``run`` derives them from ``key``."""
    def draws(t):
        ktime, kgrad = jax.random.split(jax.random.fold_in(key, t))
        times = model.per_gradient_times(ktime, cfg.n, cfg.b_max)
        kdata, = jax.random.split(kgrad, 1)
        chunks = [tuple(np.array(x) for x in jo.sample(
            jax.random.fold_in(kdata, c), (cfg.n, cfg.chunk), *sample_args))
            for c in range(cfg.b_max // cfg.chunk)]
        return np.array(times), chunks
    return draws


def _engine_problem(kind):
    if kind == "linreg":
        mine, ref = obj.LinearRegression(dim=64), jobj.LinearRegression(
            dim=64)
        ws = jax.random.normal(jax.random.PRNGKey(7), (64,))
        tws = _t(ws)
        return (mine, ref, (ws,), (tws,),
                lambda w: ref.population_loss(w, ws),
                lambda w: mine.population_loss(w, tws), 0.5 * ref.noise_var)
    mine, ref = obj.LogisticRegression(dim=16, num_classes=4), \
        jobj.LogisticRegression(dim=16, num_classes=4)
    means = ref.make_class_means(jax.random.PRNGKey(11))
    eb = ref.sample(jax.random.PRNGKey(5), (256,), means)
    teb = tuple(_t(x) for x in eb)
    return (mine, ref, (means,), (_t(means),), lambda w: ref.loss(w, eb),
            lambda w: mine.loss(w, teb), 0.0)


@pytest.mark.parametrize("kind,mode,radius", [
    ("linreg", "amb", None), ("linreg", "fmb", None),
    ("linreg", "amb", 3.0), ("logreg", "amb", None),
    ("logreg", "fmb", None)])
def test_run_matches_jax_history_on_jax_draws(kind, mode, radius):
    """n 10, the paper graph, b_max 64, chunk 16, 20 epochs: every History
    field; b_i(t), b(t) and c(t) equal, the AMB wall clock equal."""
    mine, ref, jargs, targs, jeval, teval, f_star = _engine_problem(kind)
    model = jstr.ShiftedExponential(lam=2 / 3, zeta=1.0, b_ref=32)
    kw = dict(n=10, b_max=64, chunk=16, comm_time=0.5,
              compute_time=jstr.amb_budget_from_fmb(model, 10, 320),
              fmb_batch_per_node=32, consensus_rounds=5, radius=radius)
    jcfg = jeng.EngineConfig(beta=jda.BetaSchedule(k=1.0, mu=320.0), **kw)
    cfg = eng.EngineConfig(beta=da.BetaSchedule(k=1.0, mu=320.0), **kw)
    key = jax.random.PRNGKey(0)
    want = jeng.run(ref, model, jcfg, mode=mode, epochs=20, key=key,
                    sample_args=jargs, eval_fn=jeval, f_star=f_star)
    got = eng.run(mine, None, cfg, mode=mode, epochs=20, sample_args=targs,
                  eval_fn=teval, f_star=f_star, device="cpu",
                  draws=_jax_draws(ref, model, jcfg, key, jargs))
    exact = EXACT_FIELDS + (("wall_time",) if mode == "amb" else ())
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in exact:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6,
                                       err_msg=f)
    if mode == "fmb":
        assert (got.batch_sizes == 32).all()


def test_engine_config_checks_and_build_p():
    with pytest.raises(ValueError):
        eng.EngineConfig(b_max=100, chunk=64)
    for graph in ("paper", "ring", "star"):
        cfg = eng.EngineConfig(graph=graph, n=10)
        np.testing.assert_array_equal(
            cfg.build_p(), jeng.EngineConfig(graph=graph, n=10).build_p())
    with pytest.raises(ValueError):
        eng.run(obj.LinearRegression(dim=4), stg.Deterministic(),
                eng.EngineConfig(), mode="sgd", epochs=1, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_engine.py's claims on the port's own draws
# ---------------------------------------------------------------------------

def _linreg_setup(d=24, n=10, b_global=200):
    o = obj.LinearRegression(dim=d)
    w_star = torch.randn(d, generator=torch.Generator().manual_seed(7))
    model = stg.ShiftedExponential(lam=2 / 3, zeta=1.0, b_ref=b_global // n)
    cfg = eng.EngineConfig(
        n=n, b_max=128, chunk=64,
        compute_time=stg.amb_budget_from_fmb(model, n, b_global),
        comm_time=0.5, fmb_batch_per_node=b_global // n, consensus_rounds=5,
        beta=da.BetaSchedule(k=1.0, mu=float(b_global)))
    return o, w_star, model, cfg, lambda w: o.population_loss(w, w_star)


def _run(mode, cfg, seed, epochs, f_star=0.0):
    o, w_star, model, _, eval_fn = _linreg_setup()
    return eng.run(o, model, cfg, mode=mode, epochs=epochs,
                   generator=torch.Generator().manual_seed(seed),
                   sample_args=(w_star,), eval_fn=eval_fn, f_star=f_star)


def test_amb_converges_and_beats_fmb_in_wall_time():
    o, _, _, cfg, _ = _linreg_setup()
    h_amb = _run("amb", cfg, 0, 80, 0.5 * o.noise_var)
    h_fmb = _run("fmb", cfg, 0, 80, 0.5 * o.noise_var)
    for h in (h_amb, h_fmb):
        assert float(h.eval_loss[-1]) < 0.05 * float(h.eval_loss[0])
        assert not bool(torch.isnan(h.eval_loss).any())
    assert float(h_amb.eval_loss[-1]) < 3 * float(h_fmb.eval_loss[-1])
    assert float(h_amb.wall_time[-1]) < float(h_fmb.wall_time[-1])
    # the AMB epoch takes exactly T + T_c: the float32 clock's own sums
    clock, want = np.float32(0.0), []
    for _ in range(80):
        clock = np.float32(clock + np.float32(cfg.compute_time
                                              + cfg.comm_time))
        want.append(clock)
    np.testing.assert_array_equal(h_amb.wall_time.numpy(), want)


def test_lemma6_in_engine():
    _, _, _, cfg, _ = _linreg_setup()
    h = _run("amb", cfg, 3, 150)
    assert float(h.global_batch.float().mean()) >= 200 * 0.95


def test_consensus_error_decreases_with_rounds():
    _, _, _, cfg, _ = _linreg_setup()
    errs = [float(_run("amb", dataclasses.replace(
        cfg, consensus_rounds=r), 0, 30).consensus_eps[5:].mean())
        for r in (1, 3, 9)]
    assert errs[0] > errs[1] > errs[2]


def test_exact_consensus_is_gossip_limit():
    _, _, _, cfg, _ = _linreg_setup()
    h_exact = _run("amb", dataclasses.replace(cfg, consensus_mode="exact"),
                   1, 25)
    h_gossip = _run("amb", dataclasses.replace(cfg, consensus_rounds=60),
                    1, 25)
    assert float(h_exact.consensus_eps.max()) < 1e-4
    np.testing.assert_allclose(h_gossip.eval_loss[-5:].numpy(),
                               h_exact.eval_loss[-5:].numpy(), rtol=0.05,
                               atol=1e-4)


def test_regret_sublinear():
    """Cor. 3: R(tau) = O(sqrt(m)); the fitted exponent stays below 0.75."""
    o, _, _, cfg, _ = _linreg_setup()
    h = _run("amb", cfg, 2, 200, 0.5 * o.noise_var)
    m = np.cumsum(h.potential_samples.numpy())
    r = h.regret.numpy()
    lo = len(m) // 2
    a = np.polyfit(np.log(m[lo:]), np.log(np.maximum(r[lo:], 1e-6)), 1)[0]
    assert a < 0.75, f"regret growth exponent {a:.2f} not sublinear-ish"


def test_logreg_amb_learns():
    o = obj.LogisticRegression(dim=16, num_classes=4)
    gen = torch.Generator().manual_seed(11)
    means = o.make_class_means(gen)
    eval_batch = o.sample(gen, (512,), means)
    cfg = eng.EngineConfig(n=5, b_max=64, chunk=32, compute_time=1.2,
                           comm_time=0.3, fmb_batch_per_node=40,
                           graph="ring", consensus_rounds=5,
                           beta=da.BetaSchedule(k=1.0, mu=200.0))
    h = eng.run_amb(o, stg.ShiftedExponential(lam=2 / 3, zeta=1.0,
                                              b_ref=40), cfg, epochs=60,
                    generator=torch.Generator().manual_seed(0),
                    sample_args=(means,),
                    eval_fn=lambda w: o.loss(w, eval_batch))
    assert float(h.eval_loss[-1]) < 0.6 * float(h.eval_loss[0])


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.run_amb(obj.LinearRegression(dim=4), stg.Deterministic(),
                    eng.EngineConfig(b_max=4, chunk=4), epochs=1)
