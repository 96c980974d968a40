"""The rest of the model zoo's dense branch in the port (qk-norm, MoE,
sliding-window ring caches) against ``repro.models`` with the same
weights: qwen3-8b, qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b, internlm2-20b
and command-r-plus-104b at their smoke configs, in fp32.

Weights come from JAX's ``init_params`` through the numpy bridge, tokens
from a numpy seed.  In fp32 the two compute the same function and differ
in summation order only (JAX takes the softmax blockwise over 64-token
chunks, the port in one pass; the MoE routes the same picks): hidden,
logits and caches at rtol 1e-4, atol 1e-5 (as ``test_torch_models.py``),
losses at rtol 1e-5, gradients at rtol 1e-3 with atol 1e-5 of each leaf's
largest value.  The AMB steps and sessions run on the stand-in 4-worker
mesh of ``test_torch_session.py``.
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
from repro import serve as jserve  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import DualAveragingOpt  # noqa: E402
from repro_torch.serve import (Request, SlotEngine, serve_static,  # noqa
                               static_generate)

ARCHS = ["qwen3-8b", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
         "internlm2-20b", "command-r-plus-104b"]
MOE = "qwen3-moe-30b-a3b"
TOL = dict(rtol=1e-4, atol=1e-5)
N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)
BS = [[2, 1, 0, 2], [2, 2, 2, 2], [1, 0, 2, 2]]
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (several xdist workers share the
    cores; torch's pool oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.smoke_config(arch), **kw),
            dataclasses.replace(configs.smoke_config(arch), **kw))


def _setup(arch, seed=0, **kw):
    """(jcfg, cfg, JAX params, the port's DenseLM) with the same weights."""
    key = (arch, seed, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, cfg = _cfgs(arch, **kw)
        jp = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
        model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu")
        _CACHE[key] = (jcfg, cfg, jp, model)
    return _CACHE[key]


def _tokens(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batch(cfg, b=3, s=24, seed=1):
    toks = _tokens(cfg, b, s, seed)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, :3] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------------
# the five architectures: forward, loss and gradients, serving, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_lm_loss_with_gradients_match_jax(arch):
    jcfg, cfg, jp, model = _setup(arch)
    jbatch, batch = _batch(cfg)
    jh, jaux = jmodels.forward(jp, jcfg, jbatch)
    with torch.no_grad():
        h, aux = models.forward_aux(model.params(), cfg, batch["tokens"])
    _close(h, jh)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == cfg.is_moe
    sw = [1.0, 0.0, 1.0]

    def jloss(p):
        return jmodels.lm_loss(p, jcfg, jbatch, jnp.asarray(sw))

    (jtotal, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    params = model.params()
    total, m = models.lm_loss(params, cfg, batch, torch.tensor(sw))
    assert m.keys() == jm.keys() == {"loss", "aux", "ntok"}
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for k in ("loss", "aux", "ntok"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    grads = torch.autograd.grad(total, list(params.values()))
    jflat = _flat(jgrads)
    assert list(params) == sorted(jflat, key=lambda k: tuple(k.split(".")))
    for name, g in zip(params, grads):
        want = jflat[name]
        _close(g, want, rtol=1e-3,
               atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_lm_loss_keys_and_zero_aux_of_the_earlier_families(arch):
    """The families ported before the MoE return JAX's dict too: aux is
    0.0, and the total equals the loss."""
    jcfg, cfg, jp, model = _setup(arch)
    jbatch, batch = _batch(cfg)
    jtotal, jm = jmodels.lm_loss(jp, jcfg, jbatch)
    with torch.no_grad():
        total, m = models.lm_loss(model.params(), cfg, batch)
    assert m.keys() == jm.keys() == {"loss", "aux", "ntok"}
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert float(total) == float(m["loss"])
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["ntok"]), float(jm["ntok"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """A 12-token prefill with 4 free cache rows, then 4 decode steps:
    logits and both caches after each."""
    jcfg, cfg, jp, model = _setup(arch)
    tp = model.params()
    toks = _tokens(cfg, 2, 12)
    jlog, jst = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                extra_capacity=4)
    log, st = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                             extra_capacity=4)
    _close(log, jlog)
    assert not st.caches.ring and st.caches.k.shape[2] == 16
    _close(st.caches.k, jst.caches.k)
    _close(st.caches.v, jst.caches.v)
    tok = np.array(jnp.argmax(jlog, -1), np.int32)
    for _ in range(4):
        jlog, jst = jmodels.decode_step(jp, jcfg, jst, jnp.asarray(tok))
        log, st = models.decode_step(tp, cfg, st, torch.from_numpy(tok))
        _close(log, jlog)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
    assert int(st.pos) == int(jst.pos) == 16
    _close(st.caches.k, jst.caches.k)
    _close(st.caches.v, jst.caches.v)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_round_trip_layout_and_init(arch):
    """JAX's tree -> the port -> JAX's tree bit for bit (bf16); the port's
    ``init_params`` gives the same names, shapes and dtypes."""
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    jp = jmodels.init_params(jax.random.PRNGKey(2), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    back = models.to_jax_params(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, jp)
    assert models.param_count(model.params()) == jmodels.param_count(jp)
    mine = models.init_params(cfg, torch.Generator().manual_seed(0))
    flat = tmodel._flatten_tree(jax.tree.map(np.asarray, jp))
    assert list(mine) == list(model.params()) == sorted(
        flat, key=lambda k: tuple(k.split(".")))
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    assert ("blocks.attn.q_norm" in mine) == cfg.qk_norm
    assert ("blocks.moe.router" in mine) == cfg.is_moe


def test_registry_matches_jax():
    """Every ported name's full and smoke configs carry JAX's values (the
    port has no chunking fields), and ``get_config(shape="long_500k")``
    gives attention families the 4096 window, ssm none, as in
    ``tests/test_models.py``."""
    assert set(configs.ARCH_NAMES) <= set(jconfigs.ARCH_NAMES)
    assert set(configs.ARCH_NAMES) >= set(ARCHS) | {"qwen2-1.5b",
                                                    "rwkv6-3b"}
    fields = [f.name for f in dataclasses.fields(models.ArchConfig)]
    for name in configs.ARCH_NAMES:
        for shape in (None, "long_500k"):
            mine = configs.get_config(name, shape=shape)
            want = jconfigs.get_config(name, shape=shape)
            for f in fields:
                if f == "head_pad_to" and name == "rwkv6-3b":
                    continue      # the port keeps rwkv6's layout
                assert getattr(mine, f) == getattr(want, f), (name, f)
        smoke, jsmoke = configs.smoke_config(name), jconfigs.smoke_config(
            name)
        for f in fields:
            assert getattr(smoke, f) == getattr(jsmoke, f), (name, f)
    assert configs.get_config("qwen3-8b", shape="long_500k"
                              ).sliding_window == configs.SWA_WINDOW == 4096
    assert configs.get_config("rwkv6-3b", shape="long_500k"
                              ).sliding_window == 0
    assert configs.get_config("qwen3-8b").sliding_window == 0
    assert configs.SHAPES == {k: configs.InputShape(*dataclasses.astuple(v))
                              for k, v in jconfigs.SHAPES.items()}


# ---------------------------------------------------------------------------
# sliding windows and ring caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,cap", [(5, 8), (8, 8), (20, 8), (13, 4)])
def test_ring_from_linear_matches_jax(s, cap):
    rng = np.random.default_rng(s)
    k = rng.standard_normal((2, s, 3, 4)).astype(np.float32)
    want = jmodel._ring_from_linear(jnp.asarray(k), cap)
    got = tmodel._ring_from_linear(torch.from_numpy(k), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_windowed_prefill_and_ring_decode_match_jax():
    """qwen3-8b smoke with window 8: a 20-token prefill (ring caches of 8
    rows) and 6 decode steps, logits and caches against JAX's."""
    jcfg, cfg, jp, model = _setup("qwen3-8b", sliding_window=8)
    tp = model.params()
    toks = _tokens(cfg, 2, 20, seed=3)
    jlog, jst = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    log, st = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert st.caches.ring and jst.caches.ring
    assert st.caches.k.shape[2] == 8
    _close(log, jlog)
    _close(st.caches.k, jst.caches.k)
    _close(st.caches.v, jst.caches.v)
    tok = np.array(jnp.argmax(jlog, -1), np.int32)
    for _ in range(6):
        jlog, jst = jmodels.decode_step(jp, jcfg, jst, jnp.asarray(tok))
        log, st = models.decode_step(tp, cfg, st, torch.from_numpy(tok))
        _close(log, jlog)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
    _close(st.caches.k, jst.caches.k)
    _close(st.caches.v, jst.caches.v)


def test_windowed_training_forward_matches_jax():
    jcfg, cfg, jp, model = _setup("qwen3-8b", sliding_window=8)
    jbatch, batch = _batch(cfg, b=2, s=30)
    jh, _ = jmodels.forward(jp, jcfg, jbatch)
    with torch.no_grad():
        _close(models.forward(model.params(), cfg, batch["tokens"]), jh)


@pytest.mark.parametrize("per_slot", [False, True])
def test_ring_decode_equals_linear_cache_with_window_mask(per_slot):
    """The identity of ``tests/test_models.py``: 24 decode steps on a ring
    cache of 8 rows equal the same steps on a linear cache of 24 rows
    masked to the window (fp32, the same sums over the same keys in
    another row order), and the windowed training forward's logits."""
    _, cfg, _, model = _setup("qwen3-8b", sliding_window=8)
    tp = model.params()
    toks = torch.from_numpy(_tokens(cfg, 2, 24, seed=4)).long()
    ring = models.init_decode_state(cfg, 2, 16, per_slot_pos=per_slot,
                                    device="cpu")
    linear = models.init_decode_state(
        dataclasses.replace(cfg, sliding_window=0), 2, 24,
        per_slot_pos=per_slot, device="cpu")
    assert ring.caches.ring and ring.caches.k.shape[2] == 8
    assert not linear.caches.ring
    outs = []
    for t in range(24):
        a, ring = models.decode_step(tp, cfg, ring, toks[:, t])
        b, linear = models.decode_step(tp, cfg, linear, toks[:, t])
        _close(a, b.numpy(), rtol=1e-5, atol=1e-5)
        outs.append(a)
    with torch.no_grad():
        want = models.logits_fn(tp, cfg, models.forward(tp, cfg, toks))
    _close(torch.stack(outs, 1), want.numpy())


def test_chunked_prefill_attention_equals_one_call(monkeypatch):
    """Prefill in query chunks (each with its keys from ``window - 1``
    before it and its ``q_offset``) equals one call over the prompt: the
    chunk size is cut to 8 rows here, the 524,288-token prompt's case."""
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 30, 2, 2, 32)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 30, 2, 32)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 30, 2, 32)).astype(
        np.float32))
    for window in (0, 5, 8, 40):
        whole = attn.flash_prefill(q, k, v, window)
        with monkeypatch.context() as m:
            m.setattr(attn, "PREFILL_ROWS", 8)
            chunked = attn.flash_prefill(q, k, v, window)
        torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
        want = attn.masked_attention(q, k, v, window).reshape(1, 30, -1)
        torch.testing.assert_close(whole, want, rtol=1e-5, atol=1e-5)


def test_chunked_prefill_of_a_model_equals_one_chunk(monkeypatch):
    """The model's prefill with its token-wise work and attention in
    chunks of 8 rows equals the one-chunk prefill (windowed qwen3-8b and
    the MoE, whose feed-forward takes the whole prompt)."""
    from repro_torch.models import attention as attn
    for arch, kw in (("qwen3-8b", {"sliding_window": 8}), (MOE, {})):
        _, cfg, _, model = _setup(arch, **kw)
        tp = model.params()
        toks = torch.from_numpy(_tokens(cfg, 2, 21, seed=6))
        log, st = models.prefill(tp, cfg, {"tokens": toks}, extra_capacity=3)
        with monkeypatch.context() as m:
            m.setattr(attn, "PREFILL_ROWS", 8)
            log8, st8 = models.prefill(tp, cfg, {"tokens": toks},
                                       extra_capacity=3)
        torch.testing.assert_close(log8, log, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st8.caches.k, st.caches.k, rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the AMB step and the session on the MoE
# ---------------------------------------------------------------------------

def _step_batches(cfg, steps, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (N * PER, SEQ)).astype(
            np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        out.append(({"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)},
                    {"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labels).long()}))
    return out


@pytest.mark.parametrize("arch", [MOE, "qwen2-1.5b"])
def test_exact_step_metrics_and_duals_match_jax(arch):
    """Three exact AMB steps: JAX's metric keys (``aux`` among them: the
    load-balance loss on the MoE, 0 on qwen2), the loss, aux, the dual z
    and the primal."""
    jcfg, cfg, jp, model = _setup(arch, seed=3)
    jopt = JDualAveraging(beta=JBeta(*BETA))
    jstate = jopt.init(jp)
    jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
    opt = DualAveragingOpt(beta=BetaSchedule(*BETA))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in model.params().items()}
    state = opt.init(params)
    step = amb.make_train_step(cfg, opt, N)
    for t, (jbatch, batch) in enumerate(_step_batches(cfg, 3)):
        jp, jstate, jm = jstep(jp, jstate, jbatch, jnp.asarray(BS[t]))
        params, state, m = step(params, state, batch, BS[t])
        assert m.keys() == jm.keys()
        for k in ("loss", "aux", "global_batch"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert (float(m["aux"]) > 0) == cfg.is_moe
        want = _flat(jstate["z"])
        for k, z in state["z"].items():
            _close(z, want[k], rtol=1e-3,
                   atol=1e-5 * max(1.0, float(np.abs(want[k]).max())))
    want = _flat(jp)
    for k, p in params.items():
        _close(p, want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("consensus", ["exact", "gossip"])
def test_moe_session_matches_jax_for_three_epochs(consensus):
    """``AMBSession`` on the MoE smoke config against JAX's steps (the
    gossip step differentiates ``loss + 0.01 aux`` at each worker's
    primal), losses each epoch and the primal after the flush."""
    jcfg, cfg, jp, model = _setup(MOE, seed=3)
    session = AMBSession(
        TrainSpec(arch=MOE, smoke=True, data=N, batch_per_worker=PER,
                  seq_len=SEQ),
        ClockSpec(kind="simulated"), ConsensusSpec(consensus=consensus),
        cfg=cfg, params=models.from_jax_params(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"),
        device="cpu")
    beta = JBeta(*BETA)
    if consensus == "exact":
        jopt = JDualAveraging(beta=beta)
        jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
        jstate = (jp, jopt.init(jp))
    else:
        amb_cfg = jamb.AMBConfig(consensus="gossip", beta=beta)
        jstep = jax.jit(jamb.make_gossip_train_step(jcfg, STANDIN,
                                                    amb_cfg)[1])
        jstate = {"z": jax.tree.map(
            lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jp),
            "w0": jp, "t": jnp.zeros((), jnp.int32)}
    for t, (jbatch, batch) in enumerate(_step_batches(cfg, 3, seed=4)):
        jb = jnp.asarray(BS[t], jnp.int32)
        if consensus == "exact":
            p, o, jm = jstep(*jstate, jbatch, jb)
            jstate = (p, o)
        else:
            jstate, jm = jstep(jstate, jbatch, jb)
        m = session.step(batch, BS[t])
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    want = _flat(jstate[0] if consensus == "exact"
                 else jamb.gossip_primal(jstate, amb_cfg))
    session.flush()
    for k, w in want.items():
        np.testing.assert_allclose(session.params[k].detach().numpy(), w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_moe_session_checkpoint_round_trips_in_jax_layout(tmp_path):
    """A MoE session saved after 2 epochs restores to the same state and
    continues bit for bit; its primal loads into JAX's parameter tree."""
    train = TrainSpec(arch=MOE, smoke=True, data=N, batch_per_worker=PER,
                      seq_len=SEQ)
    a = AMBSession(train, ClockSpec(kind="simulated"), device="cpu")
    a.run(2, prefetch=0)
    a.save(tmp_path)
    b = AMBSession.restore(tmp_path, device="cpu")
    assert b.cfg == a.cfg and b.steps_done == 2
    for k, v in a.params.items():
        torch.testing.assert_close(b.params[k], v, rtol=0, atol=0)
    ma, mb = a.run(1, prefetch=0), b.run(1, prefetch=0)
    assert ma["loss"] == mb["loss"]
    for k, v in a.params.items():
        torch.testing.assert_close(b.params[k], v, rtol=0, atol=0)
    jlike = jmodels.init_params(jax.random.PRNGKey(0),
                                jconfigs.smoke_config(MOE))
    back = jckpt.load_checkpoint(tmp_path, 2, jlike)
    assert "moe" in back["blocks"] and "q_norm" in back["blocks"]["attn"]
    flat = _flat(back)
    a2 = AMBSession.restore(tmp_path, step=2, device="cpu")
    for k, v in a2.params.items():
        np.testing.assert_array_equal(v.detach().float().numpy(), flat[k])


# ---------------------------------------------------------------------------
# serving the MoE
# ---------------------------------------------------------------------------

def _requests(cfg, lens, new):
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n
                                               ).tolist(),
                    max_new_tokens=m) for i, (n, m) in enumerate(zip(lens,
                                                                     new))]


def test_moe_slot_engine_greedy_tokens_match_jax_engine():
    """Prompts of 5, 11 and 7 tokens prefill at their exact lengths (no
    bucket), through 2 slots, greedy: the same tokens as JAX's engine."""
    jcfg, cfg, jp, model = _setup(MOE)
    outs = []
    for pkg, params, c in ((jserve, jp, jcfg),
                           (None, model.params(), cfg)):
        reqs = _requests(cfg, (5, 11, 7), (4, 3, 5))
        if pkg is jserve:
            engine = jserve.SlotEngine(params, c, slots=2, cache_len=24)
        else:
            engine = SlotEngine(params, c, slots=2, cache_len=24)
        pending = list(reqs)
        while pending or engine.active_count:
            while pending and engine.has_free:
                engine.insert(pending.pop(0))
            engine.decode_round()
        outs.append([r.out_tokens for r in reqs])
        if pkg is None:
            assert engine.buckets == {5, 11, 7}
    assert outs[0] == outs[1]


def test_slot_engine_and_static_paths_refuse_what_jax_refuses():
    _, cfg, _, model = _setup(MOE)
    tp = model.params()
    for bad, match in ((dataclasses.replace(cfg, sliding_window=8),
                        "sliding-window"),
                       (dataclasses.replace(cfg, family="audio"), "audio")):
        with pytest.raises(NotImplementedError, match=match):
            SlotEngine(tp, bad, slots=1, cache_len=16)
    reqs = _requests(cfg, (5, 7), (2, 2))
    with pytest.raises(NotImplementedError, match="dense/vlm"):
        static_generate(tp, cfg, reqs, cache_len=16)
    with pytest.raises(NotImplementedError, match="dense/vlm"):
        serve_static(tp, cfg, reqs, batch=2, cache_len=16)
    # init_decode_state takes the audio family since whisper's port, as
    # JAX's: an enc_kv of (L, B, encoder_seq or 1500, KV, hd) each
    audio = models.init_decode_state(dataclasses.replace(cfg, family="audio"),
                                     1, 8, device="cpu")
    assert [tuple(t.shape) for t in audio.enc_kv] == [
        (cfg.num_layers, 1, 1500, cfg.num_kv_heads, cfg.hd)] * 2
