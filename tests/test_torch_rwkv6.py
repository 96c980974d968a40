"""The port's RWKV6 family against ``repro.models`` and ``repro.kernels``.

The scan's plain version is held against JAX's sequential oracle and the
interpreted Pallas kernel (max-normalised atol 2e-5, JAX's own tolerance
for the Pallas kernel in ``tests/test_kernels.py``); the final state is
read out of the JAX functions through probe tokens.  Model tests take
their weights from the JAX ``init_params`` through the numpy bridge, in
fp32, and hold logits, states and losses to rtol 1e-4, atol 1e-5 (fp32,
another summation order), as ``test_torch_serve.py`` does.
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
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import DualAveragingOpt as JDualAveraging  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.kernels import ops, router  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    CHUNK, SEGMENT_CHUNKS, check_inputs, launch_plan, rwkv6_scan_cuda)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serve import (Request, SlotEngine,  # noqa: E402
                               static_generate)

SCAN_TOL = 2e-5                        # x max|want|
TOL = dict(rtol=1e-4, atol=1e-5)
KERNEL_SHAPES = [(2, 64, 32, 16), (4, 100, 64, 16), (1, 17, 64, 8),
                 (3, 256, 64, 32)]     # tests/test_kernels.py's sweep
N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
_CACHE: dict = {}


def _scan_inputs(bh, s, hd, seed, lo=0.2, hi=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, hd)).astype(np.float32)
               for _ in range(3))
    d = (lo + (hi - lo) * rng.random((bh, s, hd))).astype(np.float32)
    u = rng.standard_normal((bh, hd)).astype(np.float32)
    return r, k, v, d, u


def _with_probes(r, k, v, d):
    """hd probe tokens after the sequence: r = e_i, k = v = 0, d = 1 leave
    the state alone and read row i of it as y, so a function that returns
    only y gives the state after the last real token."""
    bh, _, hd = r.shape
    eye = np.broadcast_to(np.eye(hd, dtype=np.float32), (bh, hd, hd))
    zero = np.zeros((bh, hd, hd), np.float32)
    cat = lambda a, b: np.concatenate([a, b], axis=1)
    return cat(r, eye), cat(k, zero), cat(v, zero), cat(d, zero + 1.0)


def _scan(r, k, v, d, u, **kw):
    """``ops.rwkv6_scan`` on JAX's flat (BH, S, hd) rows, u (BH, hd): the
    BH rows as the heads of one batch row."""
    y, state = ops.rwkv6_scan(*(t[None] for t in (r, k, v, d)), u, **kw)
    return y[0], state[0]


def _assert_scaled(got, want, tol=SCAN_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


# ---------------------------------------------------------------------------
# the scan: plain version against the JAX oracle and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,hd,chunk", KERNEL_SHAPES)
def test_scan_plain_version_matches_jax_ref_and_pallas(bh, s, hd, chunk):
    r, k, v, d, u = _scan_inputs(bh, s, hd, seed=s)
    y, state = _scan(*map(torch.from_numpy, (r, k, v, d, u)))
    assert y.shape == (bh, s, hd) and state.shape == (bh, hd, hd)
    assert y.dtype == state.dtype == torch.float32
    probed = [jnp.asarray(t) for t in _with_probes(r, k, v, d)]
    rows = lambda t: t.reshape(1, bh, s + hd, hd)     # BH rows as heads
    want = np.asarray(jref.rwkv6_chunk_ref(*map(rows, probed),
                                           jnp.asarray(u))).reshape(
        bh, s + hd, hd)
    pallas = np.asarray(rwkv6_scan_pallas(*probed, jnp.asarray(u),
                                          chunk=chunk, interpret=True))
    for oracle in (want, pallas):
        _assert_scaled(y.numpy(), oracle[:, :s])
        _assert_scaled(state.numpy(), oracle[:, s:])


def test_scan_takes_the_models_strided_layout_and_bf16():
    """(B, H, S, hd) views of (B, S, H, hd) storage, u (H, hd): the same as
    the flat call on each (batch, head) row; bf16 inputs are cast exactly."""
    b, s, h, hd = 2, 23, 3, 64
    rng = np.random.default_rng(1)
    store = [torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3)]
    decay = torch.from_numpy((0.2 + 0.8 * rng.random((b, s, h, hd))).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((h, hd)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (*store, decay)]
    y, state = ops.rwkv6_scan(*views, u)
    assert y.shape == (b, h, s, hd) and state.shape == (b, h, hd, hd)
    flat = [t.float().reshape(b * h, s, hd) for t in
            (t.contiguous() for t in views)]
    y2, st2 = _scan(*flat, u.repeat(b, 1))
    torch.testing.assert_close(y.reshape(b * h, s, hd), y2, rtol=0, atol=0)
    torch.testing.assert_close(state.reshape(b * h, hd, hd), st2, rtol=0,
                               atol=0)


def test_scan_clip_regime_matches_pallas_at_the_kernel_chunk():
    """Decays in [1e-6, 0.05]: a chunk's cumulative log decay passes -60,
    so the factored exponents clip.  The plain chunked scan at the
    kernel's chunk (16) computes what the Pallas kernel computes there;
    the sequential oracle, which never clips, is far from both."""
    bh, s, hd = 3, 100, 64
    r, k, v, d, u = _scan_inputs(bh, s, hd, seed=9, lo=1e-6, hi=0.05)
    probed = _with_probes(r, k, v, d)
    pallas = np.asarray(rwkv6_scan_pallas(
        *map(jnp.asarray, probed), jnp.asarray(u), chunk=16,
        interpret=True))
    heads = lambda a: torch.from_numpy(a).transpose(0, 1)[None]
    y, state = ssm.rwkv6_chunked_scan(*map(heads, (r, k, v, d)),
                                      torch.from_numpy(u), 16)
    _assert_scaled(y[0].transpose(0, 1).numpy(), pallas[:, :s])
    _assert_scaled(state[0].numpy(), pallas[:, s:])
    seq, _ = _scan(*map(torch.from_numpy, (r, k, v, d, u)))
    gap = np.abs(seq.numpy() - pallas[:, :s]).max() / np.abs(pallas).max()
    assert gap > 1e-2


@pytest.mark.parametrize("chunk", [16, 256])
def test_chunked_scan_matches_the_plain_version(chunk):
    """Typical decays never reach the clip: the chunked scan at any chunk
    equals the sequential recurrence (y and the final state)."""
    b, s, h, hd = 2, 70, 2, 64
    r, k, v, d, u = _scan_inputs(b * h, s, hd, seed=3)
    t = lambda a: torch.from_numpy(a).reshape(b, h, s, hd)
    y, state = ssm.rwkv6_chunked_scan(
        *(t(a).transpose(1, 2) for a in (r, k, v, d)),
        torch.from_numpy(u[:h]), chunk)
    want_y, want_s = ops.rwkv6_scan(*(t(a) for a in (r, k, v, d)),
                                    torch.from_numpy(u[:h]))
    _assert_scaled(y.transpose(1, 2).numpy(), want_y.numpy())
    _assert_scaled(state.numpy(), want_s.numpy())


# ---------------------------------------------------------------------------
# the kernel's segment decomposition, mirrored in plain torch
# ---------------------------------------------------------------------------

def _chunk_factors(r, k, d):
    """One chunk's factors, (..., C, hd): the function of the Pallas
    kernel at its chunk."""
    logd = torch.log(torch.clamp(d, min=1e-20))
    cums = torch.cumsum(logd, dim=-2)
    rd = r * torch.exp(torch.clamp(cums - logd, -60.0, 60.0))
    kd = k * torch.exp(torch.clamp(-cums, -60.0, 60.0))
    total = cums[..., -1, :]
    kw = k * torch.exp(total[..., None, :] - cums)
    return rd, kd, kw, total


def _segment_scan(r, k, v, d, u, seg_chunks=SEGMENT_CHUNKS):
    """The kernel's three passes in plain torch (a test helper, not the
    package's): r, k, v, d (B, H, S, hd) fp32, u (H, hd).  A: each
    segment's state from zero, chunk by chunk, and its decay row exp(sum
    logd); B: the carry S_start[j + 1] = diag(a_j) S_start[j] + dS_j; C:
    each segment's chunks from its start state.  Returns (y, final
    state) as the scan does."""
    b, h, s, hd = r.shape
    plan = launch_plan(b, h, s, hd, seg_chunks)
    nseg = plan["segments"]
    pad = nseg * seg_chunks * CHUNK - s
    pads = lambda t, fill=0.0: torch.nn.functional.pad(
        t, (0, 0, 0, pad), value=fill).reshape(b, h, nseg, seg_chunks,
                                               CHUNK, hd)
    r, k, v, d = pads(r), pads(k), pads(v), pads(d, 1.0)
    ds = torch.zeros((b, h, nseg, hd, hd))
    seg_log = torch.zeros((b, h, nseg, hd))
    for c in range(seg_chunks):                      # pass A
        _, _, kw, total = _chunk_factors(r[:, :, :, c], k[:, :, :, c],
                                         d[:, :, :, c])
        ds = torch.exp(total)[..., None] * ds + torch.einsum(
            "...ti,...te->...ie", kw, v[:, :, :, c])
        seg_log = seg_log + total
    starts, state = [], torch.zeros((b, h, hd, hd))
    for j in range(nseg):                            # pass B
        starts.append(state)
        state = torch.exp(seg_log[:, :, j])[..., None] * state + ds[:, :, j]
    st = torch.stack(starts, dim=2)
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool), -1)
    ys = []
    for c in range(seg_chunks):                      # pass C
        rc, kc, vc = r[:, :, :, c], k[:, :, :, c], v[:, :, :, c]
        rd, kd, kw, total = _chunk_factors(rc, kc, d[:, :, :, c])
        att = torch.where(tri, torch.einsum("...ti,...si->...ts", rd, kd),
                          0.0)
        bonus = torch.einsum("...ti,...ti->...t", rc,
                             u[None, :, None, None, :] * kc)
        ys.append(torch.einsum("...ti,...ie->...te", rd, st) + att @ vc
                  + bonus[..., None] * vc)
        st = torch.exp(total)[..., None] * st + torch.einsum(
            "...ti,...te->...ie", kw, vc)
    y = torch.stack(ys, dim=3).reshape(b, h, nseg * seg_chunks * CHUNK, hd)
    return y[:, :, :s], state


def _hold_segments(b, h, s, hd, seed, lo=0.2, hi=1.0):
    """The mirror against the interpreted Pallas kernel at chunk 16 (y)
    and the plain chunked scan at chunk 16 (the final state)."""
    r, k, v, d, u = _scan_inputs(b * h, s, hd, seed, lo, hi)
    u = u[:h]
    heads = lambda a: torch.from_numpy(a).reshape(b, h, s, hd)
    y, state = _segment_scan(*(heads(a) for a in (r, k, v, d)),
                             torch.from_numpy(u))
    pallas = np.asarray(rwkv6_scan_pallas(
        *map(jnp.asarray, (r, k, v, d)), jnp.asarray(np.tile(u, (b, 1))),
        chunk=16, interpret=True))
    _assert_scaled(y.reshape(b * h, s, hd).numpy(), pallas)
    _, want = ssm.rwkv6_chunked_scan(
        *(heads(a).transpose(1, 2) for a in (r, k, v, d)),
        torch.from_numpy(u), 16)
    _assert_scaled(state.numpy(), want.numpy())
    return y, state


# segment boundaries sit at multiples of SEGMENT_CHUNKS * 16 = 128 tokens
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s", [1, 16, 127, 128, 129, 255, 256, 257, 549])
def test_segment_decomposition_matches_pallas(s, hd):
    """The segments (passes A, B, C) compute the Pallas kernel's function:
    lengths around one and two segments, and 549 (five segments, the last
    short), B 2 and H 2 (u per head), within JAX's 2e-5 x max|out|."""
    _hold_segments(2, 2, s, hd, seed=s + hd)


def test_segment_decomposition_in_the_clip_regime():
    """Decays in [1e-6, 0.05] over three segments: the clip fires inside
    every chunk, and the carry across segments (unclipped) still gives
    the chunked function, not the sequential oracle's."""
    y, _ = _hold_segments(2, 1, 300, 64, seed=11, lo=1e-6, hi=0.05)
    r, k, v, d, u = _scan_inputs(2, 300, 64, seed=11, lo=1e-6, hi=0.05)
    seq, _ = _scan(*map(torch.from_numpy, (r, k, v, d, u[:1].repeat(2, 0))))
    got = y.reshape(2, 300, 64).numpy()
    assert np.abs(seq.numpy() - got).max() > 1e-2 * np.abs(got).max()


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("b,h,s", [(1, 40, 2048), (1, 40, 2560),
                                   (3, 5, 1), (2, 7, 129), (1, 3, 2047),
                                   (4, 1, 2049)])
def test_scan_launch_plan(b, h, s, hd):
    """The wrapper's plan, computed here from the shapes: chunks of 16,
    segments of SEGMENT_CHUNKS chunks that cover every chunk once and cut
    only at chunk boundaries, a block per (segment, head, batch row) of
    hd / 16 warps for passes A and C, a thread per state element for the
    carry, and the scratch (one transposed state and one decay row per
    segment)."""
    plan = launch_plan(b, h, s, hd)
    chunks = (s + 15) // 16
    segs = (chunks + SEGMENT_CHUNKS - 1) // SEGMENT_CHUNKS
    assert (plan["chunks"], plan["segments"]) == (chunks, segs)
    assert plan["seg_chunks"] == SEGMENT_CHUNKS
    owned = [c for j in range(segs)
             for c in range(j * SEGMENT_CHUNKS,
                            min((j + 1) * SEGMENT_CHUNKS, chunks))]
    assert owned == list(range(chunks))
    assert plan["segment_grid"] == (segs, h, b)
    assert plan["segment_threads"] == hd * 2 == 32 * (hd // 16)
    assert plan["carry_threads"] * plan["carry_grid"][0] >= b * h * hd * hd
    assert plan["scratch"] == {"states": (b, h, segs, hd, hd),
                               "decays": (b, h, segs, hd)}
    assert plan["scratch_floats"] == b * h * segs * (hd * hd + hd)
    if (b, h, s, hd) == (1, 40, 2048, 64):
        assert segs == 16 and segs * h * b == 640        # blocks of A, C
        assert plan["scratch_floats"] * 4 == 10_649_600  # bytes


def test_scan_input_checks():
    r, k, v, d, u = map(torch.from_numpy, _scan_inputs(2, 5, 64, seed=0))
    four = [t[None] for t in (r, k, v, d)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.rwkv6_scan(*four, u, force="kernel")
    with pytest.raises(ValueError, match="one CUDA device"):
        rwkv6_scan_cuda(*four, u)
    check_inputs(*four, u)
    with pytest.raises(ValueError, match="head dim 48"):
        check_inputs(*(t[..., :48] for t in four), u[:, :48])
    with pytest.raises(ValueError, match=r"u must be \(H, hd\)"):
        check_inputs(*four, u[:1])
    with pytest.raises(TypeError, match="share a float32 or bfloat16"):
        check_inputs(four[0].half(), *four[1:], u)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(*(t.transpose(-1, -2).contiguous().transpose(-1, -2)
                       for t in four), u)


@pytest.mark.gpu
def test_scan_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    shapes = KERNEL_SHAPES + [(3, s, hd, 0) for hd in (32, 64)
                              for s in (127, 128, 129, 255, 256, 257, 549)]
    for bh, s, hd, _ in shapes:
        ins = [torch.from_numpy(a).cuda()
               for a in _scan_inputs(bh, s, hd, seed=s)]
        router.reset_launches()
        got = _scan(*ins)
        assert router.launches() == {"rwkv6_scan": 1}
        want = _scan(*ins, force="ref")
        for g, w in zip(got, want):
            _assert_scaled(g.cpu().numpy(), w.cpu().numpy())
    ins[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        _scan(*ins)


# ---------------------------------------------------------------------------
# the time-mix against repro.models.ssm
# ---------------------------------------------------------------------------

def _tmix_cfgs(pad):
    jcfg = dataclasses.replace(jconfigs.smoke_config("rwkv6-3b"),
                               dtype="float32", mxu_f32_accum=False,
                               head_pad_to=pad)
    cfg = dataclasses.replace(configs.smoke_config("rwkv6-3b"),
                              dtype="float32", head_pad_to=pad)
    return jcfg, cfg


def _tmix_params(jcfg, seed):
    """JAX's time-mix leaves with the bonus and the decay bias drawn, so
    the path exercises both (at init they are 0 and -6)."""
    rng = np.random.default_rng(seed)
    jp = jssm.rwkv6_params(jax.random.PRNGKey(seed), jcfg)
    jp["u_bonus"] = jnp.asarray(rng.standard_normal(jp["u_bonus"].shape),
                                jnp.float32)
    jp["decay_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5,
                                               jp["decay_bias"].shape),
                                   jnp.float32)
    return jp, {k: torch.from_numpy(np.array(a, np.float32))
                for k, a in jp.items()}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("pad", [0, 4])
def test_rwkv6_forward_and_decode_match_jax(pad, grad):
    jcfg, cfg = _tmix_cfgs(pad)
    jp, tp = _tmix_params(jcfg, seed=pad + 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    jout, jst = jssm.rwkv6_forward(jp, jnp.asarray(x), jcfg,
                                   return_state=True)
    with torch.set_grad_enabled(grad):
        out, st = ssm.rwkv6_forward(tp, torch.from_numpy(x), cfg,
                                    return_state=True)
    heads = ssm.rwkv6_state_heads(cfg)
    assert st.s.shape == (2, heads, 64, 64) == jst.s.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st.s.detach().numpy(), np.asarray(jst.s),
                               **TOL)
    np.testing.assert_array_equal(st.x_prev.numpy(), np.asarray(jst.x_prev))
    if pad:
        assert not st.s[:, 2:].any()
    st = ssm.RWKVState(st.s.detach(), st.x_prev)
    for step in range(3):
        xt = np.random.default_rng(10 + step).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        jo, jst = jssm.rwkv6_decode(jp, jnp.asarray(xt), jst, jcfg)
        o, st = ssm.rwkv6_decode(tp, torch.from_numpy(xt), st, cfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(st.s.numpy(), np.asarray(jst.s), **TOL)
    if pad:
        assert not st.s[:, 2:].any()


# ---------------------------------------------------------------------------
# the RWKV6 LM against repro.models
# ---------------------------------------------------------------------------

def _lm_cfgs(pad=0, dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.smoke_config("rwkv6-3b"), dtype=dtype,
                               mxu_f32_accum=False, head_pad_to=pad)
    cfg = dataclasses.replace(configs.smoke_config("rwkv6-3b"), dtype=dtype,
                              head_pad_to=pad)
    return jcfg, cfg


def _lm(pad=0, seed=0, dtype="float32"):
    """(jcfg, cfg, JAX params, the port's parameter dict), same weights."""
    key = (pad, seed, dtype)
    if key not in _CACHE:
        jcfg, cfg = _lm_cfgs(pad, dtype)
        jp = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
        model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu")
        _CACHE[key] = (jcfg, cfg, jp, model.params())
    return _CACHE[key]


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, :3] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def test_forward_loss_and_gradient_match_jax():
    jcfg, cfg, jp, tp = _lm(seed=1)
    jbatch, batch = _batch(cfg, seed=1)
    jh, _ = jmodels.forward(jp, jcfg, jbatch)
    with torch.no_grad():
        h = models.forward(tp, cfg, batch["tokens"])
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodels.lm_loss(p, jcfg, jbatch), has_aux=True)(jp)
    loss, m = models.lm_loss(tp, cfg, batch)
    grads = torch.autograd.grad(loss, list(tp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    flat = models.model._flatten_tree(jax.tree.map(np.asarray, jg))
    for name, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), flat[name], rtol=1e-3,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("pad", [0, 4])
def test_prefill_and_decode_steps_match_jax(pad):
    jcfg, cfg, jp, tp = _lm(pad=pad, seed=2)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 19)).astype(np.int32)
    jlog, jst = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    router.reset_launches()
    log, st = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert router.launches() == {}             # the plain version on CPU
    heads = ssm.rwkv6_state_heads(cfg)
    assert st.caches["tmix"].s.shape == (cfg.num_layers, 3, heads, 64, 64)
    assert int(st.pos) == int(jst.pos) == 19
    for step in range(4):
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(st.caches["tmix"].s.numpy(),
                                   np.asarray(jst.caches["tmix"].s), **TOL)
        np.testing.assert_allclose(st.caches["cmix_prev"].numpy(),
                                   np.asarray(jst.caches["cmix_prev"]), **TOL)
        np.testing.assert_allclose(st.caches["tmix"].x_prev.numpy(),
                                   np.asarray(jst.caches["tmix"].x_prev),
                                   **TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        jlog, jst = jmodels.decode_step(jp, jcfg, jst, jnp.asarray(tok))
        log, st = models.decode_step(tp, cfg, st, torch.from_numpy(tok))


def test_weight_bridge_round_trip_of_the_twenty_leaves():
    jcfg, cfg = _lm_cfgs(dtype="bfloat16")
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = models.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    flat = model.params()
    assert len(flat) == 20
    assert list(flat) == sorted(flat, key=lambda k: tuple(k.split(".")))
    fp32 = {"final_norm", "blocks.ln1", "blocks.ln2", "blocks.tmix.ln_x",
            "blocks.tmix.decay_bias", "blocks.tmix.u_bonus"}
    for name, p in flat.items():
        assert p.dtype == (torch.float32 if name in fp32
                           else torch.bfloat16), name
    back = models.to_jax_params(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, jp)
    assert models.param_count(flat) == jmodels.param_count(jp)


def test_init_params_shapes_dtypes_and_statistics():
    cfg = configs.smoke_config("rwkv6-3b")
    jp = jmodels.init_params(jax.random.PRNGKey(0),
                             jconfigs.smoke_config("rwkv6-3b"))
    mine = models.init_params(cfg, torch.Generator().manual_seed(0))
    flat = models.model._flatten_tree(jax.tree.map(np.asarray, jp))
    assert list(mine) == sorted(flat, key=lambda k: tuple(k.split(".")))
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    assert (mine["blocks.tmix.mu"] == 0.5).all()
    assert (mine["blocks.cmix.mu"] == 0.5).all()
    assert (mine["blocks.tmix.decay_bias"] == -6.0).all()
    assert not mine["blocks.tmix.u_bonus"].any()
    for k in ("blocks.ln1", "blocks.ln2", "blocks.tmix.ln_x", "final_norm"):
        assert (mine[k] == 1.0).all()
    d = cfg.d_model
    for k, fan_in in (("blocks.tmix.w_r", d), ("blocks.tmix.decay_b", 64),
                      ("blocks.cmix.w_v", cfg.d_ff)):
        std = float(mine[k].float().std()) * fan_in ** 0.5
        assert abs(std - 0.88) < 0.05, k      # truncated N(0, 1)


def test_full_config_matches_jax():
    ours, theirs = configs.get_config("rwkv6-3b"), jconfigs.get_config(
        "rwkv6-3b")
    for f in dataclasses.fields(ours):
        if f.name != "name":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ssm.rwkv6_dims(ours) == (40, 64)
    assert ssm.rwkv6_state_heads(ours) == 48


def test_insert_evict_on_the_ssm_state_tree_match_jax():
    jcfg, cfg, jp, tp = _lm(pad=4, seed=3)
    toks = np.array([[1, 2, 3, 4, 5, 6, 7]], np.int32)
    _, jone = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    jbig = jmodels.insert_decode_state(
        jmodels.init_decode_state(jcfg, 3, 16, per_slot_pos=True), jone, 1)
    big = models.init_decode_state(cfg, 3, 16, per_slot_pos=True,
                                   device="cpu")
    _, one = models.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert models.insert_decode_state(big, one, 1) is big
    assert big.pos.tolist() == np.asarray(jbig.pos).tolist() == [0, 7, 0]
    leaves = [big.caches["cmix_prev"], big.caches["tmix"].s,
              big.caches["tmix"].x_prev]
    jleaves = [jbig.caches["cmix_prev"], jbig.caches["tmix"].s,
               jbig.caches["tmix"].x_prev]
    for got, want in zip(leaves, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert got[:, 1].any() and not got[:, 0].any()
    models.evict_decode_state(big, 1)
    assert int(big.pos[1]) == 0
    assert not any(t[:, 1].any() for t in leaves)


# ---------------------------------------------------------------------------
# serving: exact-length prefill, the CLI, one session step
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8, 2, 4], [11, 13], [6] * 9,
           [40, 41, 42, 43, 44]]
NEW = [4, 6, 3, 5, 4]


def _requests(prompts, new):
    return [Request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]


def _drain(engine, reqs):
    pending = list(reqs)
    while pending or engine.active_count:
        while pending and engine.has_free:
            engine.insert(pending.pop(0))
        engine.decode_round()


def test_slot_engine_prefills_exact_lengths_and_matches_jax():
    jcfg, cfg, jp, tp = _lm(pad=4, seed=4)
    ours = _requests(PROMPTS, NEW)
    engine = SlotEngine(tp, cfg, slots=2, cache_len=32)
    _drain(engine, ours)
    assert engine.buckets == {len(p) for p in PROMPTS}
    theirs = [jserve.Request(rid=r.rid, prompt=list(r.prompt),
                             max_new_tokens=r.max_new_tokens)
              for r in _requests(PROMPTS, NEW)]
    _drain(jserve.SlotEngine(jp, jcfg, slots=2, cache_len=32), theirs)
    for o, t in zip(ours, theirs):
        assert o.out_tokens == t.out_tokens, (o.rid, o.out_tokens,
                                              t.out_tokens)
        assert o.finish_reason == "length"


def test_static_generate_raises_for_ssm():
    _, cfg, _, tp = _lm()
    with pytest.raises(NotImplementedError, match="only sound for dense"):
        static_generate(tp, cfg, _requests(PROMPTS, NEW), cache_len=32)


def test_serve_cli_serves_rwkv6_with_finetune_on_cpu(capsys):
    router.reset_launches()
    report = serve_main(["--arch", "rwkv6-3b", "--smoke", "--batch", "2",
                         "--requests", "3", "--prompt-len", "8",
                         "--new-tokens", "3", "--finetune", "1",
                         "--round-budget", "5.0"], device="cpu")
    out = capsys.readouterr().out
    assert json.loads(out[:out.rindex("}") + 1])["n_requests"] == 3
    assert len(report.requests) == 3
    assert all(len(r.out_tokens) == 3 and r.finish_reason == "length"
               for r in report.requests)
    assert report.train_epochs == 1
    assert router.launches() == {}


def test_exact_session_step_matches_jax():
    jcfg, cfg, jp, tp = _lm(seed=5)
    session = AMBSession(
        TrainSpec(arch="rwkv6-3b", smoke=True, data=N, batch_per_worker=PER,
                  seq_len=SEQ), ClockSpec(kind="simulated"),
        ConsensusSpec(consensus="exact"), cfg=cfg,
        params={k: v.detach().clone() for k, v in tp.items()},
        device="cpu")
    jopt = JDualAveraging(beta=JBeta(50.0, float(N * PER), 200.0))
    jstep = jax.jit(jamb.make_train_step(jcfg, jopt, STANDIN))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (N * PER, SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((N * PER, 1), -1,
                                                  np.int32)], 1)
    b = [2, 1, 0, 2]
    jparams, _, jm = jstep(jp, jopt.init(jp),
                           {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)},
                           jnp.asarray(b, jnp.int32))
    router.reset_launches()
    m = session.step({"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()}, b)
    assert router.launches() == {}
    assert m["global_batch"] == float(jm["global_batch"]) == 5.0
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    want = models.model._flatten_tree(jax.tree.map(np.asarray, jparams))
    assert len(want) == len(session.params) == 20
    for k, w in want.items():
        np.testing.assert_allclose(session.params[k].detach().numpy(), w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
