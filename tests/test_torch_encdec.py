"""Whisper's encoder-decoder (``"audio"``) and the embeddings-in VLM path
(``"vlm"``) in the port against ``repro.models``.

Weights come from JAX's ``init_params`` through the numpy bridge
(``from_jax_params``), inputs from a numpy seed, at the smoke configs in
fp32 (``dtype="float32"``), where the two packages compute the same
function and differ in summation order only: values within 1e-5 of their
largest magnitude, gradients and the duals they accumulate within 1e-4.
Whisper's batches carry ``"enc_embeds"`` (the stubbed mel front end's
frame embeddings); the VLM's carry ``"embeds"`` and no ``"tokens"``.  The
AMB steps run on the stand-in 4-worker mesh of ``test_torch_hybrid.py``.
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
from repro.core.dual_averaging import BetaSchedule as JBeta  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import async_epochs as jasync  # noqa: E402
from repro.dist import pipeline as jpipe  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402
from repro_torch.dist import amb, async_epochs, pipeline  # noqa: E402
from repro_torch.kernels import ops, router  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import DualAveragingOpt  # noqa: E402
from repro_torch.serve import (Request, SlotEngine, serve_static,  # noqa
                               static_generate)

WHISPER, VLM = "whisper-base", "internvl2-76b"
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
BETA = (50.0, float(N * PER), 200.0)
BS = [[2, 1, 0, 2], [2, 2, 1, 2]]
# JAX init_params under eval_shape at the full whisper config
FULL_LEAVES, FULL_P = 27, 109_854_720
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
    """(jcfg, cfg, JAX params, the port's parameter dict), same weights."""
    key = (arch, seed, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, cfg = _cfgs(arch, **kw)
        jp = jax.jit(jmodels.init_params, static_argnums=1)(
            jax.random.PRNGKey(seed), jcfg)
        model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu")
        _CACHE[key] = (jcfg, cfg, jp, model.params())
    return _CACHE[key]


def _fresh(tp: dict) -> dict:
    return {k: v.detach().clone() for k, v in tp.items()}


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


def _batch(cfg, b, s, seed=1, labels=True):
    """(JAX batch, the port's): tokens (whisper, with its frames) or
    embeddings and no tokens (vlm); labels the tokens shifted left, the
    last and the first three of row 0 masked."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = toks
    if cfg.family == "audio":
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if labels:
        lab = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
        lab[0, :3] = -1
        out["labels"] = lab
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in out.items()}
    return {k: jnp.asarray(v) for k, v in out.items()}, tb


# ---------------------------------------------------------------------------
# attention: non-causal, Sq != Skv, cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(False, 0), (False, 5),
                                           (True, 0)])
def test_masked_attention_and_chunked_flash_prefill_match_jax(
        monkeypatch, causal, window):
    """Sq 19 against Skv 37 (Skv 19 when causal): the plain masked softmax
    against JAX's online softmax, and the flash route in query chunks of
    8 rows (``PREFILL_ROWS`` patched) against it."""
    rng = np.random.default_rng(3)
    sq, skv = 19, 19 if causal else 37
    q = rng.standard_normal((2, sq, 2, 3, 32)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 32)).astype(np.float32)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window, q_offset=0, q_chunk=8,
                                 kv_chunk=16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.masked_attention(tq, tk, tv, window, causal=causal)
    _close(got, want, VALUE_TOL)
    monkeypatch.setattr(attn, "PREFILL_ROWS", 8)
    flash = attn.flash_prefill(tq, tk, tv, window, causal=causal)
    _close(flash, np.asarray(want).reshape(2, sq, -1), VALUE_TOL)


def test_cross_decode_attend_matches_jax_and_leaves_the_cache():
    jcfg, cfg, jp, tp = _setup(WHISPER)
    jx = jp["blocks"]["xattn"]
    jxp = jax.tree.map(lambda t: t[1], jx)
    xp = {k[len("blocks.xattn."):]: v[1] for k, v in tp.items()
          if k.startswith("blocks.xattn.")}
    assert set(xp) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ek = rng.standard_normal((3, 32, 4, 32)).astype(np.float32)
    ev = rng.standard_normal((3, 32, 4, 32)).astype(np.float32)
    jcache = jattn.init_cache(jcfg, 3, 8, ring=False)
    jout, _ = jattn.decode_attend(jxp, jnp.asarray(x), jnp.asarray(5),
                                  jcache, jcfg,
                                  cross_kv=(jnp.asarray(ek), jnp.asarray(ev)))
    cache = attn.init_cache(cfg, 3, 8, ring=False, device="cpu")
    out, back = attn.decode_attend(xp, torch.from_numpy(x), 5, cache, cfg,
                                   cross_kv=(torch.from_numpy(ek),
                                             torch.from_numpy(ev)))
    _close(out, jout, VALUE_TOL)
    assert back is cache and not cache.k.any() and not cache.v.any()


# ---------------------------------------------------------------------------
# the models: forward, loss, gradients, the padded vocabulary, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_forward_and_lm_loss_match_jax(arch):
    """Hidden states and the loss dict; the VLM's batch has no tokens."""
    jcfg, cfg, jp, tp = _setup(arch)
    jbatch, batch = _batch(cfg, 3, 12)
    assert ("tokens" in batch) == (arch == WHISPER)
    (jh, _), (jtotal, jm) = jax.jit(lambda p, b: (
        jmodels.forward(p, jcfg, b), jmodels.lm_loss(p, jcfg, b)))(jp, jbatch)
    with torch.no_grad():
        h = models.forward(tp, cfg, batch)
        total, m = models.lm_loss(tp, cfg, batch)
    _close(h, jh, VALUE_TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(total), float(jtotal), rtol=VALUE_TOL)
    np.testing.assert_allclose(float(m["ntok"]), float(jm["ntok"]))


def test_whisper_gradients_match_jax():
    """Every one of the 27 leaves' gradient of the weighted loss, masked
    labels and ``seq_weights`` (the encoder's through the cross-attention,
    each block checkpointed)."""
    jcfg, cfg, jp, tp = _setup(WHISPER)
    jbatch, batch = _batch(cfg, 2, 10, seed=2)
    sw = [1.0, 0.5]
    jgrads = jax.jit(jax.grad(lambda p: jmodels.lm_loss(
        p, jcfg, jbatch, jnp.asarray(sw))[0]))(jp)
    params = {k: v.requires_grad_() for k, v in _fresh(tp).items()}
    total, _ = models.lm_loss(params, cfg, batch, torch.tensor(sw))
    grads = torch.autograd.grad(total, list(params.values()))
    want = _flat(jgrads)
    assert len(params) == len(want) == FULL_LEAVES
    for name, g in zip(params, grads):
        _close(g, want[name], GRAD_TOL)


def test_padded_vocab_slices_logits_and_loss_as_jax():
    """``vocab_pad_to`` 544 at the smoke width: embed and unembed take 544
    rows, the logits 512 columns (``logits_fn``, the prefill, decode), and
    the loss equals JAX's (its logsumexp sees no padded column)."""
    jcfg, cfg, jp, tp = _setup(WHISPER, vocab_pad_to=544)
    assert cfg.padded_vocab == jcfg.padded_vocab == 544
    assert tuple(tp["embed"].shape) == (544, cfg.d_model)
    assert tuple(tp["unembed"].shape) == (cfg.d_model, 544)
    jbatch, batch = _batch(cfg, 2, 9, seed=6)
    jtotal, _ = jax.jit(lambda p: jmodels.lm_loss(p, jcfg, jbatch))(jp)
    with torch.no_grad():
        total, _ = models.lm_loss(tp, cfg, batch)
        logits = models.logits_fn(tp, cfg, models.forward(tp, cfg, batch))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=VALUE_TOL)
    assert logits.shape == (2, 9, 512)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    jprompt = {k: v for k, v in jbatch.items() if k != "labels"}
    jlog, _ = jax.jit(lambda p: jmodels.prefill(p, jcfg, jprompt))(jp)
    log, st = models.prefill(tp, cfg, prompt)
    assert log.shape == (2, 512)
    _close(log, jlog, VALUE_TOL)
    log, _ = models.decode_step(tp, cfg, st, log.argmax(-1))
    assert log.shape == (2, 512)


def test_whisper_weights_and_the_full_config(monkeypatch):
    """The port's ``init_params`` gives JAX's 27 names, shapes and dtypes
    (``encoder.blocks.*``, ``blocks.xattn.*`` with no bias); the bridge
    round-trips bit for bit; at the full config (linears on the meta
    device: shapes only) JAX's shapes, 109,854,720 parameters."""
    jcfg, cfg = jconfigs.smoke_config(WHISPER), configs.smoke_config(WHISPER)
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
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    full = jax.eval_shape(lambda: jmodels.init_params(
        jax.random.PRNGKey(0), jconfigs.get_config(WHISPER)))
    jfull = {k: v.shape for k, v in tmodel._flatten_tree(full).items()}
    assert len(jfull) == FULL_LEAVES
    assert sum(int(np.prod(s)) for s in jfull.values()) == FULL_P
    for mod in (tmodel, tmodel.attn):
        monkeypatch.setattr(mod, "init_linear", lambda shape, dtype, *a, **k:
                            torch.empty(shape, dtype=dtype, device="meta"))
    full_params = models.init_params(configs.get_config(WHISPER),
                                     torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in full_params.items()} == jfull
    assert models.param_count(full_params) == FULL_P
    # JAX's approximate count leaves out the padding and the cross leaves
    assert configs.get_config(WHISPER).param_count() == 103_453_696


@pytest.mark.parametrize("name", list(jconfigs.ARCH_NAMES))
def test_registry_matches_jax(name):
    """The ten names in JAX's order; each full and smoke config's fields,
    ``param_count``, ``padded_vocab`` and ``is_encdec`` equal JAX's."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    fields = [f.name for f in dataclasses.fields(models.ArchConfig)]
    for mine, want in ((configs.get_config(name),
                        jconfigs.get_config(name)),
                       (configs.smoke_config(name),
                        jconfigs.smoke_config(name))):
        assert all(getattr(mine, f) == getattr(want, f) for f in fields)
        assert mine.param_count() == want.param_count()
        assert mine.padded_vocab == want.padded_vocab
        assert mine.is_encdec == want.is_encdec


# ---------------------------------------------------------------------------
# serving: prefill, slot rows, decode
# ---------------------------------------------------------------------------

def test_whisper_prefill_matches_jax():
    """A 9-token prefill of 2 rows with 4 free cache rows: the logits, the
    decoder's K and V caches and ``enc_kv`` (L, B, frames, KV, hd)."""
    jcfg, cfg, jp, tp = _setup(WHISPER)
    jbatch, batch = _batch(cfg, 2, 9, seed=5, labels=False)
    jlog, jst = jax.jit(lambda p, b: jmodels.prefill(
        p, jcfg, b, extra_capacity=4))(jp, jbatch)
    router.reset_launches()
    log, st = models.prefill(tp, cfg, batch, extra_capacity=4)
    assert router.launches() == {}
    _close(log, jlog, VALUE_TOL)
    _close(st.caches.k, jst.caches.k, VALUE_TOL)
    _close(st.caches.v, jst.caches.v, VALUE_TOL)
    assert st.caches.k.shape == (2, 2, 13, 4, 32)
    assert st.enc_kv[0].shape == (2, 2, cfg.encoder_seq, 4, 32)
    _close(st.enc_kv[0], jst.enc_kv[0], VALUE_TOL)
    _close(st.enc_kv[1], jst.enc_kv[1], VALUE_TOL)
    assert int(st.pos) == int(jst.pos) == 9


def test_whisper_slot_rows_decode_and_evict_match_jax():
    """Two batch-1 prefills of 5 and 9 tokens (each with its own frames),
    inserted into a 2-row state of 16 rows, then 6 decode steps at
    per-slot positions: logits each step, the caches and ``enc_kv``
    after; an evict zeroes row 0 of every cache and of ``enc_kv``."""
    jcfg, cfg, jp, tp = _setup(WHISPER)
    cap = 16
    jstate = jmodels.init_decode_state(jcfg, 2, cap, per_slot_pos=True)
    state = models.init_decode_state(cfg, 2, cap, per_slot_pos=True,
                                     device="cpu")
    assert state.enc_kv[0].shape == (2, 2, cfg.encoder_seq, 4, 32)
    jprefill = jax.jit(lambda p, b, extra: jmodels.prefill(
        p, jcfg, b, extra_capacity=extra), static_argnums=2)
    jtok, tok = [], []
    for slot, plen in enumerate((5, 9)):
        jbatch, batch = _batch(cfg, 1, plen, seed=10 + slot, labels=False)
        jlog, jone = jprefill(jp, jbatch, cap - plen)
        jstate = jmodels.insert_decode_state(jstate, jone, slot)
        log, one = models.prefill(tp, cfg, batch, extra_capacity=cap - plen)
        assert models.insert_decode_state(state, one, slot) is state
        _close(log, jlog, VALUE_TOL)
        jtok.append(int(jnp.argmax(jlog[0])))
    assert state.pos.tolist() == np.asarray(jstate.pos).tolist() == [5, 9]
    jdecode = jax.jit(lambda p, st, t: jmodels.decode_step(p, jcfg, st, t))
    tok = np.asarray(jtok, np.int32)
    for _ in range(6):
        jlog, jstate = jdecode(jp, jstate, jnp.asarray(tok))
        log, state = models.decode_step(tp, cfg, state,
                                         torch.from_numpy(tok.copy()))
        _close(log, jlog, VALUE_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    assert state.pos.tolist() == np.asarray(jstate.pos).tolist() == [11, 15]
    for got, want in zip(tmodel._cache_tensors((state.caches,
                                                state.enc_kv)),
                         (jstate.caches.k, jstate.caches.v,
                          jstate.enc_kv[0], jstate.enc_kv[1])):
        _close(got, want, VALUE_TOL)
    models.evict_decode_state(state, 0)
    assert state.pos.tolist() == [0, 15]
    for t in tmodel._cache_tensors((state.caches, state.enc_kv)):
        assert not t[:, 0].any() and t[:, 1].any()


PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8, 2, 4, 6, 10, 3], [11, 13, 17, 4, 4]]
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


def test_vlm_slot_engine_and_static_tokens_match_jax():
    """Prompts go in as their embedding rows (``input_mode="embeds"``),
    padded to their buckets, through 2 slots, greedy: the same tokens as
    JAX's engine; ``static_generate`` as JAX's."""
    jcfg, cfg, jp, tp = _setup(VLM)
    ours = _requests(types.SimpleNamespace(Request=Request))
    _drain(SlotEngine(tp, cfg, slots=2, cache_len=32), ours)
    theirs = _requests(jserve)
    _drain(jserve.SlotEngine(jp, jcfg, slots=2, cache_len=32), theirs)
    for o, t in zip(ours, theirs):
        assert o.out_tokens == t.out_tokens, (o.rid, o.out_tokens,
                                              t.out_tokens)
    ours = static_generate(tp, cfg, _requests(types.SimpleNamespace(
        Request=Request)), cache_len=32)
    theirs = jserve.static_generate(jp, jcfg, _requests(jserve),
                                    cache_len=32)
    assert [r.out_tokens for r in ours] == [r.out_tokens for r in theirs]


def test_whisper_is_refused_where_jax_refuses_it():
    """The slot engine and the static paths keep refusing audio, with
    JAX's messages."""
    _, cfg, _, tp = _setup(WHISPER)
    with pytest.raises(NotImplementedError, match="encoder features"):
        SlotEngine(tp, cfg, slots=2, cache_len=32)
    reqs = _requests(types.SimpleNamespace(Request=Request))
    with pytest.raises(NotImplementedError, match="dense/vlm"):
        static_generate(tp, cfg, reqs, cache_len=32)
    with pytest.raises(NotImplementedError, match="dense/vlm"):
        serve_static(tp, cfg, reqs, batch=2, cache_len=32)


# ---------------------------------------------------------------------------
# AMB steps on batches of frames and of embeddings
# ---------------------------------------------------------------------------

def _step_batches(cfg, seed):
    return [_batch(cfg, N * PER, SEQ, seed=seed + t) for t in range(len(BS))]


def _jax_gossip_state(jp):
    return {"z": jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jp),
        "w0": jp, "t": jnp.zeros((), jnp.int32)}


def _drivers(kind, jcfg, cfg, jp):
    """(JAX (state, step), the port's (init, step)) for one step kind,
    ring gossip at r 2 where it gossips."""
    if kind == "exact":
        jopt = JDualAveraging(beta=JBeta(*BETA))
        opt = DualAveragingOpt(beta=BetaSchedule(*BETA))
        jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
        step = amb.make_train_step(cfg, opt, N)
        return (jopt.init(jp), jstep), (opt, step)
    jamb_cfg = jamb.AMBConfig(consensus="gossip", gossip_rounds=2,
                              beta=JBeta(*BETA))
    mine = amb.AMBConfig(consensus="gossip", gossip_rounds=2,
                         beta=BetaSchedule(*BETA))
    jstate = _jax_gossip_state(jp)
    width = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jp))
    if kind == "gossip":
        jstep = jamb.make_gossip_train_step(jcfg, STANDIN, jamb_cfg)[1]
        init, step = amb.make_gossip_train_step(cfg, N, mine)
    elif kind == "pipelined":
        jstep = jpipe.make_pipelined_gossip_train_step(
            jcfg, STANDIN, jamb_cfg)[1]
        jstate["pending"] = jnp.zeros((N, width + 1), jnp.float32)
        init, step, _ = pipeline.make_pipelined_gossip_train_step(
            cfg, N, mine)
    else:
        jstep = jasync.make_async_gossip_train_step(
            jcfg, STANDIN, jamb_cfg, 1)[1]
        jstate["queue"] = (jnp.zeros((N, width + 1), jnp.float32),)
        init, step, _ = async_epochs.make_async_gossip_train_step(
            cfg, N, mine, 1)
    return (jstate, jax.jit(jstep)), (init, step)


@pytest.mark.parametrize("arch,kind", [
    (WHISPER, "exact"), (WHISPER, "gossip"), (VLM, "exact"),
    (VLM, "gossip"), (VLM, "pipelined"), (VLM, "async")])
def test_steps_on_frames_and_embeddings_match_jax(arch, kind):
    """Two epochs of each step: whisper's batches carry ``enc_embeds``,
    the VLM's ``{"embeds", "labels"}`` with no tokens (the batch's size
    is its first leaf's, as in JAX): the loss, b(t) and every dual (the
    exact step's primal too)."""
    jcfg, cfg, jp, tp = _setup(arch)
    (jstate, jstep), (init, step) = _drivers(kind, jcfg, cfg, jp)
    if kind == "exact":
        params = {k: v.requires_grad_() for k, v in _fresh(tp).items()}
        state = init.init(params)
    else:
        state = init(_fresh(tp))
    for t, (jbatch, batch) in enumerate(_step_batches(cfg, 20)):
        b = jnp.asarray(BS[t], jnp.int32)
        if kind == "exact":
            jp, jstate, jm = jstep(jp, jstate, jbatch, b)
            params, state, m = step(params, state, batch, BS[t])
        else:
            jstate, jm = jstep(jstate, jbatch, b)
            state, m = step(state, batch, BS[t])
        assert float(m["global_batch"]) == float(jm["global_batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=VALUE_TOL)
        want = _flat(jstate["z"])
        assert set(state["z"]) == set(want)
        for k, w in want.items():
            _close(state["z"][k], w, GRAD_TOL)
    if kind == "exact":
        for k, w in _flat(jp).items():
            _close(params[k], w, VALUE_TOL)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_noncausal_flash_kernel_at_whisper_shapes_on_card():
    """The kernel with no causal mask at whisper's encoder (1500 x 1500,
    H 8, hd 64) and cross-attention (Sq 4 and 224 against Skv 1500)
    shapes, bf16 on the tensor-core body, within one bf16 ulp of the
    plain version's largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    router.reset_launches()
    for sq in (1500, 4, 224):
        q = torch.randn((1, sq, 8, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((1, 1500, 8, 64), generator=gen, device="cuda",
                            dtype=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        got = ops.flash_attention(q, k, v, causal=False, force="kernel")
        want = ops.flash_attention(q, k, v, causal=False, force="ref")
        top = float(want.float().abs().max())
        tol = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert float((got.float() - want.float()).abs().max()) <= tol
    assert router.launches().get("flash_attention.tensor_core") == 3
