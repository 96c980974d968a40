"""Mamba2 and the zamba2 hybrid in the port against ``repro.models``.

Weights come from JAX's ``init_params`` (or ``mamba2_params``) through the
numpy bridge, inputs from a numpy seed, at the zamba2 smoke config.  In
fp32 (``dtype="float32"``) the two compute the same function and differ
in summation order only: values within 1e-5 of their largest magnitude,
gradients within 1e-4; in bf16 2e-2 (``tests/test_models.py``'s
tolerance).  The exception is pinned here too: at a full chunk of 256
tokens JAX's Mamba2 gradient is not finite (``repro/models/ssm.py``
exponentiates the intra-chunk decay before masking it), while the port
masks before the exponent and matches autograd through the sequential
oracle.  The AMB steps run on the stand-in 4-worker mesh of
``test_torch_session.py``.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.kernels import ref, router  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serve import (Request, SlotEngine, serve_static,  # noqa
                               static_generate)

ARCH = "zamba2-1.2b"
VALUE_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)
BS = [[2, 1, 0, 2], [2, 2, 1, 2]]
# JAX init_params under eval_shape at the full config
FULL_LEAVES, FULL_P = 20, 1_170_313_344
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (several xdist workers share the
    cores; torch's pool oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.smoke_config(ARCH), **kw),
            dataclasses.replace(configs.smoke_config(ARCH), **kw))


def _setup(seed=0, **kw):
    """(jcfg, cfg, JAX params, the port's parameter dict), same weights."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, cfg = _cfgs(**kw)
        jp = jax.jit(jmodels.init_params, static_argnums=1)(
            jax.random.PRNGKey(seed), jcfg)
        model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu")
        _CACHE[key] = (jcfg, cfg, jp, model.params())
    return _CACHE[key]


def _close(got, want, tol):
    """|got - want| within ``tol`` of max |want|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _flat(tree):
    return tmodel._flatten_tree(jax.tree.map(np.asarray, tree))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _mamba_layer(seed=0, **kw):
    """(jcfg, cfg, one layer's JAX Mamba2 params, the port's)."""
    jcfg, cfg = _cfgs(**kw)
    jp = jssm.mamba2_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, {k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in jp.items()}


def _x(cfg, b, s, seed=2):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 0), (300, 64)])
def test_mamba2_forward_and_state_match_jax(s, chunk):
    """The block's output and the MambaState after the sequence: one chunk
    (S 16 at the default 256), and S 300 at chunk 64 (four full chunks and
    a padded tail)."""
    jcfg, cfg, jp, tp = _mamba_layer()
    jx, x = _x(cfg, 2, s)
    jout, jst = jax.jit(lambda p, x: jssm.mamba2_forward(
        p, x, jcfg, chunk=chunk, return_state=True))(jp, jx)
    with torch.no_grad():
        out, st = ssm.mamba2_forward(tp, x, cfg, chunk=chunk,
                                     return_state=True)
    _close(out, jout, VALUE_TOL)
    _close(st.h, jst.h, VALUE_TOL)
    _close(st.conv, jst.conv, VALUE_TOL)
    assert st.conv.shape == (2, cfg.conv_width - 1,
                             2 * cfg.d_model + 2 * cfg.ssm_state)


@pytest.mark.parametrize("s,chunk", [(37, 8), (300, 64), (64, 256)])
def test_chunked_scan_matches_the_sequential_oracle(s, chunk):
    """The chunked SSD scan's y and final state against the port's
    sequential oracle, whose y is JAX's ``mamba2_chunk_ref``'s, on decays
    in [0.5, 1]."""
    rng = np.random.default_rng(s)
    b, h, hd, ns = 2, 3, 8, 5
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    bm = rng.standard_normal((b, s, ns)).astype(np.float32)
    cm = rng.standard_normal((b, s, ns)).astype(np.float32)
    dc = rng.uniform(0.5, 1.0, (b, s, h)).astype(np.float32)
    args = [torch.from_numpy(t) for t in (x, bm, cm, dc)]
    y_ref, st_ref = ref.mamba2_chunk_ref(*args)
    _close(y_ref, jref.mamba2_chunk_ref(*map(jnp.asarray, (x, bm, cm, dc))),
           VALUE_TOL)
    y, st = ssm.ssd_chunked_scan(*args, chunk)
    _close(y, y_ref.numpy(), VALUE_TOL)
    _close(st, st_ref.numpy(), VALUE_TOL)


def test_mamba2_decode_matches_jax_for_eight_steps():
    """A 5-token prefix's state, then 8 one-token steps: each output and
    the state after them."""
    jcfg, cfg, jp, tp = _mamba_layer(seed=1)
    jx, x = _x(cfg, 2, 13, seed=3)
    _, jst = jssm.mamba2_forward(jp, jx[:, :5], jcfg, return_state=True)
    jdecode = jax.jit(lambda p, x, st: jssm.mamba2_decode(p, x, st, jcfg))
    with torch.no_grad():
        _, st = ssm.mamba2_forward(tp, x[:, :5], cfg, return_state=True)
        for t in range(5, 13):
            jout, jst = jdecode(jp, jx[:, t:t + 1], jst)
            out, st = ssm.mamba2_decode(tp, x[:, t:t + 1], st, cfg)
            _close(out, jout, VALUE_TOL)
    _close(st.h, jst.h, VALUE_TOL)
    _close(st.conv, jst.conv, VALUE_TOL)


def _sum_sq(fwd, p, x, cfg, chunk):
    return (fwd(p, x, cfg, chunk=chunk) ** 2).sum()


def test_full_chunk_gradient_is_finite_and_equals_the_sequential_oracle(
        monkeypatch):
    """At S 256 with chunk 256 (the session's length and chunk), the
    gradient of sum(out^2) is finite and equals autograd through the
    sequential oracle; JAX's is not finite there (its t < u decay
    exponents pass 88 and overflow before the mask)."""
    jcfg, cfg, jp, tp = _mamba_layer(seed=2)
    jx, x = _x(cfg, 2, 256, seed=4)
    jg = jax.jit(jax.grad(lambda p: _sum_sq(jssm.mamba2_forward, p, jx,
                                            jcfg, 256)))(jp)
    assert not all(bool(jnp.isfinite(jg[k]).all())
                   for k in ("a_log", "dt_bias", "w_in"))
    assert bool(jnp.isfinite(jax.jit(lambda p: jssm.mamba2_forward(
        p, jx, jcfg))(jp)).all())
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    grads = torch.autograd.grad(
        _sum_sq(ssm.mamba2_forward, params, x, cfg, 256),
        list(params.values()))
    with monkeypatch.context() as m:
        m.setattr(ssm, "ssd_chunked_scan",
                  lambda x, b, c, d, chunk: ref.mamba2_chunk_ref(x, b, c, d))
        want = torch.autograd.grad(
            _sum_sq(ssm.mamba2_forward, params, x, cfg, 256),
            list(params.values()))
    for name, g, w in zip(params, grads, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g, w.numpy(), GRAD_TOL)


# ---------------------------------------------------------------------------
# the hybrid model: forward, loss, gradients, weights
# ---------------------------------------------------------------------------

def _batch(cfg, b=3, s=24, seed=1):
    toks = _tokens(cfg, b, s, seed)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, :3] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


@pytest.mark.parametrize("dtype,tol", [("float32", VALUE_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_forward_and_lm_loss_match_jax(dtype, tol):
    """Hidden states, the loss and its dict (aux is 0: no experts)."""
    jcfg, cfg, jp, tp = _setup(dtype=dtype)
    jbatch, batch = _batch(cfg)
    (jh, jaux), (jtotal, jm) = jax.jit(lambda p: (
        jmodels.forward(p, jcfg, jbatch), jmodels.lm_loss(p, jcfg, jbatch)))(
            jp)
    with torch.no_grad():
        h, aux = models.forward_aux(tp, cfg, batch["tokens"])
        total, m = models.lm_loss(tp, cfg, batch)
    _close(h, jh, tol)
    assert float(aux) == float(jaux) == 0.0
    assert m.keys() == jm.keys() == {"loss", "aux", "ntok"}
    assert float(m["aux"]) == 0.0 and float(total) == float(m["loss"])
    np.testing.assert_allclose(float(total), float(jtotal), rtol=tol)
    np.testing.assert_allclose(float(m["ntok"]), float(jm["ntok"]))


def test_gradients_match_jax_at_s64():
    """Every leaf's gradient of the weighted loss at S 64 (one partial
    chunk), the shared block's included."""
    jcfg, cfg, jp, tp = _setup()
    jbatch, batch = _batch(cfg, b=2, s=64, seed=2)
    sw = [1.0, 0.5]
    jgrads = jax.jit(jax.grad(lambda p: jmodels.lm_loss(
        p, jcfg, jbatch, jnp.asarray(sw))[0]))(jp)
    params = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    total, _ = models.lm_loss(params, cfg, batch, torch.tensor(sw))
    grads = torch.autograd.grad(total, list(params.values()))
    want = _flat(jgrads)
    assert list(params) == list(want) or set(params) == set(want)
    for name, g in zip(params, grads):
        _close(g, want[name], GRAD_TOL)


def test_weight_round_trip_and_the_twenty_leaves(monkeypatch):
    """JAX's tree -> the port -> JAX's tree bit for bit (bf16); the port's
    ``init_params`` gives JAX's 20 names, shapes and dtypes (no ln2 in a
    hybrid block, the shared block unstacked), and at the full config
    (linears on the meta device: shapes only) JAX's shapes, 1,170,313,344
    parameters."""
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    jp = jax.jit(jmodels.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    back = models.to_jax_params(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, jp)
    mine = models.init_params(cfg, torch.Generator().manual_seed(0))
    flat = _flat(jp)
    assert list(mine) == list(model.params()) == sorted(
        flat, key=lambda k: tuple(k.split(".")))
    assert len(mine) == FULL_LEAVES and "blocks.ln2" not in mine
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    full = jax.eval_shape(lambda: jmodels.init_params(
        jax.random.PRNGKey(0), jconfigs.get_config(ARCH)))
    jfull = {k: v.shape for k, v in tmodel._flatten_tree(full).items()}
    assert sum(int(np.prod(s)) for s in jfull.values()) == FULL_P
    for mod in (tmodel, tmodel.attn, ssm):
        monkeypatch.setattr(mod, "init_linear", lambda shape, dtype, *a, **k:
                            torch.empty(shape, dtype=dtype, device="meta"))
    full_params = models.init_params(configs.get_config(ARCH),
                                     torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in full_params.items()} == jfull
    assert models.param_count(full_params) == FULL_P
    assert len(full_params) == FULL_LEAVES


def test_registry_and_long_500k_window():
    """The full and smoke configs carry JAX's values; long_500k gives the
    shared block JAX's 4096 window."""
    fields = [f.name for f in dataclasses.fields(models.ArchConfig)]
    for shape in (None, "long_500k"):
        mine = configs.get_config(ARCH, shape=shape)
        want = jconfigs.get_config(ARCH, shape=shape)
        assert all(getattr(mine, f) == getattr(want, f) for f in fields)
    assert configs.get_config(ARCH, shape="long_500k").sliding_window == 4096
    assert ssm.mamba2_dims(configs.get_config(ARCH)) == (4096, 64, 64)


# ---------------------------------------------------------------------------
# serving: prefill, decode, the slot engine, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_after_it_match_jax(window):
    """A 20-token prefill with 4 free cache rows (window 8: ring caches of
    8 rows), then 6 decode steps: logits, the Mamba2 h and conv tails of
    every layer and the shared block's caches, after the prefill and
    after the steps."""
    jcfg, cfg, jp, tp = _setup(sliding_window=window)
    toks = _tokens(cfg, 2, 20, seed=5)
    extra = 0 if window else 4
    jlog, jst = jax.jit(lambda p, t: jmodels.prefill(
        p, jcfg, {"tokens": t}, extra_capacity=extra))(jp, jnp.asarray(toks))
    log, st = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                             extra_capacity=extra)
    jdecode = jax.jit(lambda p, st, t: jmodels.decode_step(p, jcfg, st, t))

    def same_state():
        _close(st.caches["mamba"].h, jst.caches["mamba"].h, VALUE_TOL)
        _close(st.caches["mamba"].conv, jst.caches["mamba"].conv, VALUE_TOL)
        _close(st.caches["attn"].k, jst.caches["attn"].k, VALUE_TOL)
        _close(st.caches["attn"].v, jst.caches["attn"].v, VALUE_TOL)
        assert st.caches["attn"].ring == jst.caches["attn"].ring == (
            window > 0)

    _close(log, jlog, VALUE_TOL)
    same_state()
    assert st.caches["attn"].k.shape == (1, 2, 8 if window else 24, 4, 32)
    tok = np.array(jnp.argmax(jlog, -1), np.int32)
    for _ in range(6):
        jlog, jst = jdecode(jp, jst, jnp.asarray(tok))
        log, st = models.decode_step(tp, cfg, st, torch.from_numpy(tok))
        _close(log, jlog, VALUE_TOL)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
    assert int(st.pos) == int(jst.pos) == 26
    same_state()


def test_insert_evict_on_the_hybrid_state_tree_match_jax():
    jcfg, cfg, jp, tp = _setup()
    toks = np.array([[1, 2, 3, 4, 5, 6, 7]], np.int32)
    jbig = jax.jit(lambda p, t: jmodels.insert_decode_state(
        jmodels.init_decode_state(jcfg, 3, 16, per_slot_pos=True),
        jmodels.prefill(p, jcfg, {"tokens": t}, extra_capacity=9)[1], 1))(
            jp, jnp.asarray(toks))
    big = models.init_decode_state(cfg, 3, 16, per_slot_pos=True,
                                   device="cpu")
    _, one = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                            extra_capacity=9)
    assert models.insert_decode_state(big, one, 1) is big
    assert big.pos.tolist() == np.asarray(jbig.pos).tolist() == [0, 7, 0]
    leaves = tmodel._cache_tensors(big.caches)
    jleaves = [jbig.caches["attn"].k, jbig.caches["attn"].v,
               jbig.caches["mamba"].h, jbig.caches["mamba"].conv]
    assert len(leaves) == 4
    for got, want in zip(leaves, jleaves):
        _close(got, want, VALUE_TOL)
        assert got[:, 1].any() and not got[:, 0].any()
    models.evict_decode_state(big, 1)
    assert int(big.pos[1]) == 0
    assert not any(t[:, 1].any() for t in leaves)


PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8, 2, 4], [11, 13, 17]]
NEW = [4, 6, 3]


def _requests(pkg):
    return [pkg.Request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, NEW))]


def _drain(engine, reqs):
    pending = list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()


def test_slot_engine_greedy_tokens_match_jax_and_static_paths_refuse():
    """Prompts prefill at their exact lengths through 2 slots, greedy: the
    same tokens as JAX's engine.  The static paths refuse the hybrid, as
    JAX's do."""
    jcfg, cfg, jp, tp = _setup()
    ours = _requests(types.SimpleNamespace(Request=Request))
    engine = SlotEngine(tp, cfg, slots=2, cache_len=32)
    _drain(engine, ours)
    assert engine.buckets == {len(p) for p in PROMPTS}
    theirs = _requests(jserve)
    _drain(jserve.SlotEngine(jp, jcfg, slots=2, cache_len=32), theirs)
    for o, t in zip(ours, theirs):
        assert o.out_tokens == t.out_tokens, (o.rid, o.out_tokens,
                                              t.out_tokens)
        assert o.finish_reason == "length"
    with pytest.raises(NotImplementedError, match="dense/vlm"):
        static_generate(tp, cfg, _requests(types.SimpleNamespace(
            Request=Request)), cache_len=32)
    with pytest.raises(NotImplementedError, match="dense/vlm"):
        serve_static(tp, cfg, _requests(types.SimpleNamespace(
            Request=Request)), batch=2, cache_len=32)


def test_serve_cli_serves_zamba2_with_finetune_on_cpu(capsys):
    """``--arch zamba2-1.2b --smoke``: every request finishes and one
    exact fine-tune epoch is absorbed; on the CPU no kernel launches."""
    router.reset_launches()
    report = serve_main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--requests", "3", "--prompt-len", "8",
                         "--new-tokens", "3", "--finetune", "1",
                         "--round-budget", "5.0"], device="cpu")
    out = capsys.readouterr().out
    assert json.loads(out[:out.rindex("}") + 1])["n_requests"] == 3
    assert all(len(r.out_tokens) == 3 and r.finish_reason == "length"
               for r in report.requests)
    assert report.train_epochs == 1
    assert router.launches() == {}


# ---------------------------------------------------------------------------
# AMB sessions
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


def test_exact_session_duals_match_jax_for_two_epochs():
    """``AMBSession`` exact on the hybrid against JAX's exact step: the
    loss each epoch, the 20 duals z after each, and the primal."""
    jcfg, cfg, jp, tp = _setup()
    session = AMBSession(
        TrainSpec(arch=ARCH, smoke=True, data=N, batch_per_worker=PER,
                  seq_len=SEQ), ClockSpec(kind="simulated"),
        ConsensusSpec(consensus="exact"), cfg=cfg,
        params={k: v.detach().clone() for k, v in tp.items()},
        device="cpu")
    jopt = JDualAveraging(beta=JBeta(*BETA))
    jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
    jstate = jopt.init(jp)
    for t, (jbatch, batch) in enumerate(_step_batches(cfg, 2)):
        jp, jstate, jm = jstep(jp, jstate, jbatch,
                               jnp.asarray(BS[t], jnp.int32))
        m = session.step(batch, BS[t])
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        want = _flat(jstate["z"])
        z = session.state["opt"]["z"]
        assert len(z) == len(want) == FULL_LEAVES
        for k, w in want.items():
            _close(z[k], w, GRAD_TOL)
    for k, w in _flat(jp).items():
        np.testing.assert_allclose(session.params[k].detach().numpy(), w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_gossip_session_matches_jax_for_two_epochs():
    """``AMBSession`` ring gossip on the hybrid against JAX's gossip step:
    the loss each epoch and the node-averaged primal after the flush."""
    jcfg, cfg, jp, tp = _setup()
    session = AMBSession(
        TrainSpec(arch=ARCH, smoke=True, data=N, batch_per_worker=PER,
                  seq_len=SEQ), ClockSpec(kind="simulated"),
        ConsensusSpec(consensus="gossip"), cfg=cfg,
        params={k: v.detach().clone() for k, v in tp.items()},
        device="cpu")
    amb_cfg = jamb.AMBConfig(consensus="gossip", beta=JBeta(*BETA))
    jstep = jax.jit(jamb.make_gossip_train_step(jcfg, STANDIN, amb_cfg)[1])
    jstate = {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jp),
        "w0": jp, "t": jnp.zeros((), jnp.int32)}
    for t, (jbatch, batch) in enumerate(_step_batches(cfg, 2, seed=1)):
        jstate, jm = jstep(jstate, jbatch, jnp.asarray(BS[t], jnp.int32))
        m = session.step(batch, BS[t])
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    session.flush()
    for k, w in _flat(jamb.gossip_primal(jstate, amb_cfg)).items():
        np.testing.assert_allclose(session.params[k].detach().numpy(), w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
