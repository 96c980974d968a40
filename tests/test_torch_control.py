"""The online controller in the port against ``repro.control``: the
telemetry, the three policies, the controller's decisions and state, the
gradient-noise statistics of the steps, the session's control hook, the
simulator's adaptive-budget run, and save / restore through a staleness
retune.

JAX steps run on the stand-in 4-worker mesh with a hand-built state; a
JAX session's steps need a device mesh this CPU's jax does not build, so
its control hook runs on a stand-in session (as ``tests/
test_torch_train.py`` runs its ``epoch_sizes``).  Tolerances: telemetry,
policies, decisions, states, b_i(t) and restored runs exact; the tensor
budget update rtol 1e-6 (a mean of n float32 values in another order);
the one-pass noise statistics against JAX's two-pass function on the
same gradients rtol 1e-5 (fp64 against fp32 sums), and through the steps
rtol 1e-4 (the gradients themselves agree to rtol 1e-5); the adaptive
run's History as ``tests/test_torch_engine.py`` holds ``run`` (b_i(t),
b(t), c(t) equal, the rest rtol 1e-4).
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import control as jcontrol  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.api import clock as jclock  # noqa: E402
from repro.api import specs as jspecs  # noqa: E402
from repro.api.session import AMBSession as JAMBSession  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import extensions as jext  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import stragglers as jstr  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import async_epochs as jasync  # noqa: E402
from repro.dist import pipeline as jpipe  # noqa: E402
from repro_torch import configs, control, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             ControllerSpec, TrainSpec)
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import extensions as ext  # noqa: E402
from repro_torch.core import objectives as obj  # noqa: E402
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb, async_epochs, pipeline  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)       # the session's schedule
TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (several worker processes share the
    cores, where torch's thread pool oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# telemetry, policies, controller
# ---------------------------------------------------------------------------

def _records(seed: int, epochs: int = 24, n: int = N, noise: bool = True,
             comm: float = 0.5):
    """A record stream both packages take: drifting budgets and times,
    cap-saturated and zero b_i, noise stats on most epochs."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(1, epochs + 1):
        b = rng.integers(0, 9, size=n)
        if t % 5 == 0:
            b[:] = 0
        budget = float(rng.uniform(0.5, 4.0)) if t % 7 else 0.0
        kw = {}
        if noise and t % 4:
            kw = dict(grad_sq_norm=float(rng.uniform(0.01, 3.0)),
                      grad_var=float(rng.uniform(0.0, 5.0)))
        out.append(dict(
            t=t, budget_s=budget, comm_time_s=comm, step_s=0.1,
            loss=float(rng.uniform(1, 6)), b=b,
            global_batch=float(np.minimum(b, 8).sum()),
            tau_s=None if t % 3 == 0 else float(rng.uniform(0.05, 0.5)),
            **kw))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_equals_jax(seed):
    mine, ref = control.Telemetry(ema=0.7), jcontrol.Telemetry(ema=0.7)
    for rec in _records(seed):
        mine.update(control.EpochRecord(**rec))
        ref.update(jcontrol.EpochRecord(**rec))
        assert mine.to_state() == ref.to_state()
        assert mine.noise_scale == ref.noise_scale
    back = control.Telemetry.from_state(mine.to_state())
    assert back.to_state() == mine.to_state()


def test_policies_equal_jax():
    for cls in ("StalenessPolicy", "BatchDampingPolicy", "BudgetPolicy"):
        assert [f.name for f in dataclasses.fields(getattr(control, cls))] \
            == [f.name for f in dataclasses.fields(getattr(jcontrol, cls))]
    for d_max, hyst in ((8, 0.25), (2, 0.25), (5, 0.5)):
        mine = control.StalenessPolicy(d_max=d_max, hysteresis=hyst)
        ref = jcontrol.StalenessPolicy(d_max=d_max, hysteresis=hyst)
        for r in np.linspace(0.0, 10.0, 201):
            assert mine.target(r) == ref.target(r)
            for d in range(1, d_max + 1):
                assert mine.propose(d, r) == ref.propose(d, r)
    for d in range(1, 9):
        assert control.StalenessPolicy.gamma(d) == \
            jcontrol.StalenessPolicy.gamma(d)
    mine = control.BatchDampingPolicy(b_floor=64, b_cap=512)
    ref = jcontrol.BatchDampingPolicy(b_floor=64, b_cap=512)
    for b in (64, 80, 200, 512, 600):
        for ns in (None, 0.0, 30.0, 100.0, 170.0, 999.0, 5e4):
            assert mine.propose(b, ns) == ref.propose(b, ns)
    mine, ref = control.BudgetPolicy(b_target=600), \
        jcontrol.BudgetPolicy(b_target=600)
    for tau in (1e-9, 0.02, 0.3, 7.0, 1e9):
        for n in (1, 4, 10):
            for bt in (None, 300, 1200):
                assert mine.solve(tau, n, bt) == ref.solve(tau, n, bt)


@pytest.mark.parametrize("ema", [0.9, 0.5])
def test_budget_policy_tensor_form_equals_jnp(ema):
    """``init`` / ``update`` on torch against jnp over 30 epochs of drawn
    b(t), from a badly mistuned T."""
    mine = control.BudgetPolicy(b_target=600, ema=ema)
    ref = jcontrol.BudgetPolicy(b_target=600, ema=ema)
    s, js = mine.init(7.5, device="cpu"), ref.init(7.5)
    assert s["t_budget"].dtype == torch.float32
    assert float(s["t_budget"]) == float(js["t_budget"])
    assert float(s["tau"]) == float(js["tau"]) == -1.0
    rng = np.random.default_rng(3)
    for t in range(30):
        b = rng.integers(0, 120, size=10).astype(np.int32)
        s = mine.update(s, torch.from_numpy(b))
        js = ref.update(js, jnp.asarray(b))
        for k in ("t_budget", "tau"):
            np.testing.assert_allclose(float(s[k]), float(js[k]),
                                       rtol=1e-6)


SPECS = [dict(), dict(interval=1, warmup=2), dict(interval=3, warmup=4,
                                                  batch=False),
         dict(interval=1, warmup=1, d_max=2, staleness=True),
         dict(interval=2, warmup=0, budget=False, ema=0.5)]


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("spec_kw", SPECS)
def test_controller_decisions_equal_jax(spec_kw, async_mode):
    """The same records through both controllers: identical actions
    (epochs, knobs, reasons), decision counts and ``to_state``; and a
    controller rebuilt from the spec and ``load_state`` mid-stream makes
    the same later decisions."""
    spec = ControllerSpec(enabled=True, **spec_kw)
    jspec = jspecs.ControllerSpec(enabled=True, **spec_kw)
    kw = dict(n_workers=N, comm_time=3.0, b_target=16, b_cap=64,
              staleness=1, async_mode=async_mode)
    mine, ref = control.Controller(spec, **kw), \
        jcontrol.Controller(jspec, **kw)
    acts = []
    recs = _records(7, epochs=30, comm=3.0)
    for j, rec in enumerate(recs):
        a = mine.observe(control.EpochRecord(**rec))
        w = ref.observe(jcontrol.EpochRecord(**rec))
        assert (a is None) == (w is None)
        if a is not None:
            assert a.to_dict() == w.to_dict()
            assert a.nontrivial
            acts.append(a.to_dict())
        assert mine.to_state() == ref.to_state()
        if j == 14:
            half = mine.to_state()
    assert mine.decisions == ref.decisions == len(acts)
    again = control.Controller(ControllerSpec.from_dict(spec.to_dict()),
                               **kw)
    again.load_state(half)
    later = [again.observe(control.EpochRecord(**rec)) for rec in recs[15:]]
    assert [a.to_dict() for a in later if a is not None] == \
        [a for a in acts if a["epoch"] > recs[14]["t"]]
    assert again.to_state() == mine.to_state()


def test_controller_spec_and_action_equal_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(
        ControllerSpec)] == [(f.name, f.default) for f in dataclasses.fields(
            jspecs.ControllerSpec)]
    spec = ControllerSpec(enabled=True, interval=2, d_max=3, batch=False)
    assert spec.to_dict() == jspecs.ControllerSpec(
        enabled=True, interval=2, d_max=3, batch=False).to_dict()
    assert ControllerSpec.from_json(spec.to_json()) == spec
    a = control.ControlAction(epoch=3, budget=1.5)
    assert a.to_dict() == jcontrol.ControlAction(epoch=3,
                                                 budget=1.5).to_dict()
    assert a.nontrivial and not control.ControlAction(epoch=1).nontrivial


# ---------------------------------------------------------------------------
# gradient-noise statistics
# ---------------------------------------------------------------------------

BWS = [[2.0, 1.0, 0.0, 2.0], [0.0, 0.0, 0.0, 0.0], [0.5, 0.0, 0.0, 0.0],
       [0.5, 0.25, 0.0, 0.0], [8.0, 8.0, 8.0, 8.0], [0.0, 0.0, 3.0, 0.0],
       [1.5, 0.5, 1.0, 2.0]]


@pytest.mark.parametrize("bw", BWS)
def test_one_pass_noise_stats_equal_jax_two_pass(bw):
    """The same per-worker gradients and weights, including all-zero b
    and sum bw < 1 (the weights then sum to less than one)."""
    rng = np.random.default_rng(int(sum(bw) * 8) + len(bw))
    shapes = {"a": (3, 5), "b.c": (7,), "b.d": (2, 2, 3)}
    g = {k: (rng.standard_normal((N,) + s) * 2.0 + 1.5).astype(np.float32)
         for k, s in shapes.items()}
    nest = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b.c"]),
                                            "d": jnp.asarray(g["b.d"])}}
    want = jamb.grad_noise_stats(nest, jnp.asarray(bw, jnp.float32))
    got = amb.grad_noise_stats({k: torch.from_numpy(v) for k, v in
                                g.items()}, torch.tensor(bw))
    for k in ("grad_sq_norm", "grad_var"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    if not any(bw):
        assert float(got["grad_sq_norm"]) == float(got["grad_var"]) == 0.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
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


@pytest.mark.parametrize("driver,rho", [("gossip", 1), ("gossip", 2),
                                        ("pipelined", 1), ("async2", 2)])
def test_step_noise_stats_match_jax(driver, rho):
    """``noise_stats=True`` through the drivers: the port folds each
    worker's gradient as it is made, JAX takes the vmapped stack."""
    jcfg, cfg, jparams, model = _models()
    kw = dict(consensus="gossip", gossip_rounds=2, redundancy=rho,
              noise_stats=True)
    jcfg_amb = jamb.AMBConfig(beta=JBeta(*BETA), **kw)
    mine = amb.AMBConfig(beta=BetaSchedule(*BETA), **kw)
    width = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams)) + 1
    jstate = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        "w0": jparams, "t": jnp.zeros((), jnp.int32)}
    if driver == "gossip":
        jstep = jamb.make_gossip_train_step(jcfg, STANDIN, jcfg_amb)[1]
        init, step = amb.make_gossip_train_step(cfg, N, mine)
    elif driver == "pipelined":
        jstep = jpipe.make_pipelined_gossip_train_step(jcfg, STANDIN,
                                                       jcfg_amb)[1]
        init, step, _ = pipeline.make_pipelined_gossip_train_step(cfg, N,
                                                                  mine)
        jstate["pending"] = jnp.zeros((N, width), jnp.float32)
    else:
        jstep = jasync.make_async_gossip_train_step(jcfg, STANDIN, jcfg_amb,
                                                    staleness=2)[1]
        init, step, _ = async_epochs.make_async_gossip_train_step(
            cfg, N, mine, staleness=2)
        jstate["queue"] = tuple(jnp.zeros((N, width), jnp.float32)
                                for _ in range(2))
        jstate["snaps"] = tuple(jnp.zeros((N, width - 1), jnp.float32)
                                for _ in range(2))
    jstep = jax.jit(jstep)
    state = init(model.params())
    rng = np.random.default_rng(9)
    for b in ([2, 1, 0, 2], [0, 0, 0, 0], [2, 2, 1, 2], [1, 0, 0, 0]):
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)},
                           jnp.asarray(b, jnp.int32))
        state, m = step(state, {"tokens": torch.from_numpy(toks).long(),
                                "labels": torch.from_numpy(labels).long()},
                        b)
        for k in ("grad_sq_norm", "grad_var"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-12, err_msg=(k, b))
            assert float(m[k]) >= 0.0


# ---------------------------------------------------------------------------
# the session's control hook
# ---------------------------------------------------------------------------

class _JaxDraws:
    """A session clock whose per-gradient times are JAX's clock draws for
    the session's epoch (its key, its threefry stream)."""

    def __init__(self, session, spec: jspecs.ClockSpec):
        self.session = session
        self.inner = session.clock
        self.jax = jclock.make_clock(spec, N, PER)

    def epoch(self, generator):
        key = jax.random.fold_in(jax.random.PRNGKey(
            self.session.train.seed), 10_000 + self.session.steps_done)
        times, budget = self.jax.epoch(key)
        assert budget == self.inner.budget_t
        return torch.from_numpy(np.array(times)), budget

    def update(self, step_s, global_b):
        self.inner.update(step_s, global_b)

    def set_budget(self, budget):
        self.inner.set_budget(budget)
        self.jax.set_budget(budget)


@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_session_control_hook_matches_jax_on_jax_draws(consensus):
    """The JAX session's ``_control`` (on a stand-in session) and the
    port's take the same epochs (JAX's clock draws) and metrics, and give
    the same actions at the same epochs; both clocks end on the same
    budget."""
    clock = dict(kind="simulated", compute_time=40.0, comm_time=0.5)
    spec = dict(enabled=True, interval=1, warmup=2)
    session = AMBSession(TRAIN, ClockSpec(**clock),
                         ConsensusSpec(consensus=consensus,
                                       gossip_rounds=2),
                         ControllerSpec(**spec), device="cpu")
    assert session.protocol.amb.noise_stats is True
    draws = _JaxDraws(session, jspecs.ClockSpec(**clock))
    session.clock = draws
    captured = {}
    protocol = session.protocol
    real_step = protocol.step

    def capture(*args):
        state, m = real_step(*args)
        captured["m"] = m
        return state, m

    protocol.step = capture
    jself = types.SimpleNamespace(
        controller=jcontrol.Controller(
            jspecs.ControllerSpec(**spec), n_workers=N, comm_time=0.5,
            b_target=N * PER, b_cap=N * PER, staleness=1,
            async_mode=False),
        clock=draws.jax, clock_spec=jspecs.ClockSpec(**clock),
        consensus_spec=jspecs.ConsensusSpec(consensus=consensus),
        steps_done=0, train=jspecs.TrainSpec(data=N, batch_per_worker=PER),
        n_workers=N, _active=None)
    source = session.batch_source()
    got, want = [], []
    for epoch in range(8):
        key = jax.random.fold_in(jax.random.PRNGKey(0), 10_000 + epoch)
        jtimes, jbudget = draws.jax.epoch(key)
        jb = JAMBSession.epoch_sizes(jself, jtimes, jbudget)
        out = session.step(source.batch(epoch))
        np.testing.assert_array_equal(out["b"], np.asarray(jb))
        assert out["budget_s"] == jbudget
        m = {k: float(v) for k, v in captured["m"].items()
             if k in ("grad_sq_norm", "grad_var")}
        if consensus == "exact":
            assert not m
        jself.steps_done = epoch + 1
        action = JAMBSession._control(jself, m, out, jb, jtimes)
        got.append(out.get("action"))
        want.append(None if action is None else action.to_dict())
    assert got == want
    assert any(a is not None and a["budget"] is not None for a in got)
    assert draws.inner.budget_t == draws.jax.budget_t
    assert session.controller.to_state() == jself.controller.to_state()


def test_session_without_controller_is_unchanged():
    session = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip"), device="cpu")
    assert session.controller is None
    assert session.protocol.amb.noise_stats is False
    m = session.step(session.batch_source().batch(0))
    assert "action" not in m


@pytest.mark.parametrize("mode", ["gossip", "async"])
def test_restore_through_a_staleness_retune_resumes_bit_for_bit(mode,
                                                                tmp_path):
    """T_c = 12 against a Lemma-6 T of 3.75: the controller raises D on
    the async driver (the drain comes before the rebuild, and the
    ``staleness`` metric follows it); sequential gossip takes only budget
    actions.  ``save`` writes the controller's spec and state under JAX's
    keys, and ``restore`` resumes losses, state and decisions bit for
    bit."""
    cons = ConsensusSpec(consensus="gossip", gossip_rounds=2,
                         async_epochs=mode == "async", staleness=1)
    clock = ClockSpec(kind="simulated", comm_time=12.0)
    ctl = ControllerSpec(enabled=True, interval=1, warmup=2)
    s = AMBSession(TRAIN, clock, cons, ctl, device="cpu")
    order = []
    real_flush, real_build = s.flush, s._build_protocol
    s.flush = lambda: (order.append("flush"), real_flush())[1]
    s._build_protocol = lambda *a: (order.append("build"),
                                    real_build(*a))[1]
    source = s.batch_source()
    seen = []
    for i in range(6):
        m = s.step(source.batch(i))
        seen.append((m.get("action"), m["staleness"]))
    if mode == "async":
        raised = [j for j, (a, _) in enumerate(seen)
                  if a and a["staleness"]]
        assert raised and seen[raised[0]][0]["gamma"] == \
            1.0 / (2 * seen[raised[0]][0]["staleness"])
        assert order[:2] == ["flush", "build"]
        assert seen[-1][1] == s.consensus_spec.staleness > 1
        assert all(st == 1 for _, st in seen[:raised[0] + 1])
        assert len(s.state["queue"]) == s.consensus_spec.staleness
    else:
        assert all(a is None or a["staleness"] is None for a, _ in seen)
        assert order == []
    del s.flush, s._build_protocol
    s.save(tmp_path)
    saved = s.consensus_spec
    import json
    meta = json.loads((tmp_path / "session.json").read_text())
    assert set(meta["controller"]) == {"spec", "state"}
    assert meta["controller"]["spec"] == ctl.to_dict()
    assert set(meta["controller"]["state"]) == set(
        jcontrol.Controller(jspecs.ControllerSpec(), n_workers=N,
                            comm_time=1.0, b_target=8, b_cap=8).to_state())
    want = [s.step(source.batch(i)) for i in range(6, 10)]
    r = AMBSession.restore(tmp_path, device="cpu")
    assert r.controller_spec == ctl
    assert r.consensus_spec == saved
    got = [r.step(source.batch(i)) for i in range(6, 10)]
    assert r.consensus_spec == s.consensus_spec
    assert [m["loss"] for m in got] == [m["loss"] for m in want]
    assert [m.get("action") for m in got] == [m.get("action") for m in want]
    assert r.controller.to_state() == s.controller.to_state()
    for k, v in s.state["z"].items():
        assert torch.equal(r.state["z"][k], v)


# ---------------------------------------------------------------------------
# the simulator's adaptive-budget run
# ---------------------------------------------------------------------------

RTOL = 1e-4
FIELDS = ("wall_time", "batch_sizes", "global_batch", "eval_loss",
          "train_loss", "consensus_eps", "regret", "potential_samples")
EXACT_FIELDS = ("batch_sizes", "global_batch", "potential_samples")


def test_adaptive_budget_alias():
    assert ext.AdaptiveBudget is control.BudgetPolicy
    assert jext.AdaptiveBudget is jcontrol.BudgetPolicy


@pytest.mark.parametrize("mode", ["gossip", "exact"])
def test_run_amb_adaptive_matches_jax_history(mode):
    """Linear regression (d 64), n 10, the paper graph, b_max 64, chunk
    16, 24 epochs from a mistuned T; the cluster slows 3x at epoch 12.
    The port on JAX's draws (its key's split, its models)."""
    mine, ref = obj.LinearRegression(dim=64), jobj.LinearRegression(dim=64)
    ws = jax.random.normal(jax.random.PRNGKey(7), (64,))
    fast = jstr.ShiftedExponential(lam=2 / 3, zeta=1.0, b_ref=32)
    slow = jstr.ShiftedExponential(lam=2 / 9, zeta=3.0, b_ref=32)

    def model_fn(t):
        return fast if t < 12 else slow

    kw = dict(n=10, b_max=64, chunk=16, comm_time=0.5, compute_time=9.0,
              consensus_rounds=5, consensus_mode=mode)
    jcfg = jeng.EngineConfig(beta=JBeta(k=1.0, mu=320.0), **kw)
    cfg = eng.EngineConfig(beta=BetaSchedule(k=1.0, mu=320.0), **kw)
    key = jax.random.PRNGKey(2)
    want = jext.run_amb_adaptive(
        ref, model_fn, jcfg, controller=jcontrol.BudgetPolicy(b_target=320),
        epochs=24, key=key, sample_args=(ws,),
        eval_fn=lambda w: ref.population_loss(w, ws), f_star=0.5)

    def draws(t):
        ktime, kgrad = jax.random.split(jax.random.fold_in(key, t))
        times = model_fn(t).per_gradient_times(ktime, 10, 64)
        chunks = [tuple(np.array(x) for x in ref.sample(
            jax.random.fold_in(kgrad, c), (10, 16), ws)) for c in range(4)]
        return np.array(times), chunks

    tws = torch.from_numpy(np.array(ws))
    got = ext.run_amb_adaptive(
        mine, None, cfg, controller=control.BudgetPolicy(b_target=320),
        epochs=24, sample_args=(tws,), draws=draws, device="cpu",
        eval_fn=lambda w: mine.population_loss(w, tws), f_star=0.5)
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6,
                                       err_msg=f)
    # the budget moved: the epochs are not all T + T_c of the initial T
    steps = np.diff(np.concatenate([[0.0], got.wall_time.numpy()]))
    assert steps[0] == pytest.approx(9.5) and abs(steps[-1] - 9.5) > 0.5
