"""The port's flash attention, prefill attention and decode attention
against the JAX package.

Inputs come from numpy with a seed and go to both frameworks.  The JAX
Pallas kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.
Tolerances: fp32 against JAX's plain softmax 1e-5 (the same math, other
summation orders); against the Pallas kernel 2e-4, as
``tests/test_kernels.py`` holds it to the same oracle; bf16 outputs one
bf16 ulp of the largest output (both round the same fp32 result once).
On the card the bf16 tensor-core body takes P as two bf16 parts (off by
at most 2^-17 of each weight), well inside that ulp.
"""
import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref, router  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    body, check_inputs, flash_attention_cuda, launch_args, softmax_scale,
    tma_args)
from repro_torch.models import attention as attn  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=2e-4)

CASES = [
    # (B, H, KV, Sq, Skv, hd, causal, window, q_offset): the sweep of
    # tests/test_kernels.py, then query offsets past 0 (Sq < Skv)
    (1, 4, 4, 64, 64, 32, True, 0, 0),
    (2, 4, 2, 100, 100, 64, True, 0, 0),
    (1, 8, 2, 128, 128, 64, True, 32, 0),
    (1, 2, 2, 64, 128, 32, False, 0, 0),
    (1, 4, 1, 257, 257, 64, True, 64, 0),
    (1, 6, 1, 63, 257, 128, True, 0, 194),
    (2, 4, 2, 1, 100, 32, True, 16, 99),
    (1, 12, 2, 65, 130, 128, True, 0, 65),
]


def _inputs(b, h, kv, sq, skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, hd), np.float32)
    k = rng.standard_normal((b, kv, skv, hd), np.float32)
    v = rng.standard_normal((b, kv, skv, hd), np.float32)
    return q, k, v


def _bf16_ulp(x: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


@pytest.mark.parametrize("b,h,kv,sq,skv,hd,causal,window,q_offset", CASES)
def test_flash_attention_matches_jax_ref_and_pallas(b, h, kv, sq, skv, hd,
                                                    causal, window,
                                                    q_offset):
    q, k, v = _inputs(b, h, kv, sq, skv, hd)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **mask))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=64, interpret=True, **mask))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = ref.flash_attention_ref(tq, tk, tv, **mask)
    routed = ops.flash_attention(tq, tk, tv, **mask)
    assert plain.dtype == routed.dtype == torch.float32
    assert plain.shape == (b, h, sq, hd)
    np.testing.assert_allclose(plain.numpy(), want, **F32)
    np.testing.assert_array_equal(routed.numpy(), plain.numpy())
    np.testing.assert_allclose(plain.numpy(), pallas, **PALLAS)


@pytest.mark.parametrize("case", [CASES[1], CASES[5]])
def test_flash_attention_bf16_matches_jax(case):
    b, h, kv, sq, skv, hd, causal, window, q_offset = case
    q, k, v = _inputs(b, h, kv, sq, skv, hd, seed=1)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, **mask)
                      .astype(jnp.bfloat16), np.float32)
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        **mask)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(want))


def test_rows_without_a_valid_key_average_v():
    """With window > 0 a query at q_pos >= Skv - 1 + window sees no key.
    The port (plain version and kernel alike) gives the mean of v over the
    Skv keys, as JAX's plain softmax does; the Pallas kernel averages over
    its zero-padded last block instead (Skv = 70 pads to 128)."""
    b, h, kv, sq, skv, hd = 1, 2, 1, 70, 70, 32
    q, k, v = _inputs(b, h, kv, sq, skv, hd, seed=2)
    mask = dict(causal=True, window=5, q_offset=70)
    empty = 70 + np.arange(sq) >= skv - 1 + 5          # rows 4.. of 70
    assert empty.sum() == 66
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              **mask).numpy()
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **mask))
    mean_v = np.repeat(v.mean(axis=2, keepdims=True), h // kv, axis=1)
    np.testing.assert_allclose(got[:, :, empty], want[:, :, empty], **F32)
    np.testing.assert_allclose(
        got[:, :, empty], np.broadcast_to(mean_v, got[:, :, empty].shape),
        **F32)
    np.testing.assert_allclose(got[:, :, ~empty], want[:, :, ~empty], **F32)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=64, interpret=True, **mask))
    np.testing.assert_allclose(pallas[:, :, empty],
                               np.broadcast_to(mean_v * skv / 128,
                                               got[:, :, empty].shape),
                               **F32)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_softmax_scale_rounds_alike(hd):
    """The kernel's scale (1/sqrt(hd) in double, rounded to fp32, as the
    Pallas kernel takes it) equals the training path's fp32 1/sqrt(hd)."""
    training = np.float32(1.0) / np.sqrt(np.float32(hd))
    assert softmax_scale(hd) == float(training)
    assert np.float32(softmax_scale(hd)) == np.float32(1.0 / hd ** 0.5)


def test_kernel_wrapper_checks():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="head dim 48"):
        check_inputs(torch.zeros((1, 4, 8, 48)), torch.zeros((1, 2, 8, 48)),
                     torch.zeros((1, 2, 8, 48)), 0, 0)
    with pytest.raises(TypeError):
        check_inputs(q, k.double(), v, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(torch.zeros((1, 4, 8, 64))[..., ::2], k, v, 0, 0)
    with pytest.raises(ValueError, match="q_offset"):
        check_inputs(q, k, v, 0, -1)
    with pytest.raises(ValueError, match="grouped-query"):
        check_inputs(q[:, :3], k, v, 0, 0)


def _model_views(b, s, kvh, g, hd, dtype=torch.float32):
    """q, k as the prefill passes them: permuted views of (B, S, KV, G,
    hd) and (B, S, KV, hd) storage."""
    q5 = torch.zeros((b, s, kvh, g, hd), dtype=dtype)
    k4 = torch.zeros((b, s, kvh, hd), dtype=dtype)
    q = q5.permute(0, 2, 3, 1, 4).reshape(b, -1, s, hd)
    assert q.data_ptr() == q5.data_ptr() and q.stride(-1) == 1
    return q, k4.transpose(1, 2)


def test_launch_args_read_the_model_layout_in_place():
    """The prefill passes permuted views of (B, S, KV, G, hd) q and
    (B, S, KV, hd) k, v: head h = kv G + g has stride hd, sequence stride
    H hd, and the output's (B, H, S, hd) view is (B, S, H, hd) storage.
    In fp32 the CUDA-core body reads them through its 12 element strides;
    in bf16 the tensor-core body reads the same strides, in bytes, through
    its tensor maps."""
    b, s, kvh, g, hd = 2, 5, 2, 3, 32
    q, k = _model_views(b, s, kvh, g, hd)
    out = torch.empty((b, s, kvh * g, hd)).transpose(1, 2)
    assert body(q, k, k) == "cuda_core"
    args = launch_args(q, k, k, out, True, 0, 3)
    assert args[:6] == (b, kvh * g, kvh, s, s, hd)
    assert list(args[6]) == [s * kvh * g * hd, hd, kvh * g * hd,
                             s * kvh * hd, hd, kvh * hd,
                             s * kvh * hd, hd, kvh * hd,
                             s * kvh * g * hd, hd, kvh * g * hd]
    assert args[7:] == (softmax_scale(hd), 1, 0, 3)
    qb, kb = _model_views(b, s, kvh, g, hd, torch.bfloat16)
    assert body(qb, kb, kb) == "tensor_core"
    maps = tma_args(qb, kb, kb)
    strides = [x for t in (qb, kb, kb) for x in reversed(t.stride()[:3])]
    assert maps[4:7] + maps[13:16] + maps[22:25] == [2 * x for x in strides]


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_tma_args_read_the_model_layout_in_place(hd):
    """One 4-D tensor map per operand: dims (hd, S, heads, B) innermost
    first, byte strides of S, heads and B (the model's layout: q's
    sequence stride H hd and head stride hd, k's and v's sequence stride
    KV hd), and a box of 128 rows by at most 64 columns (128 bytes, the
    widest swizzle: at hd 128 a tile is two boxes)."""
    b, sq, skv, kvh, g = 2, 7, 9, 2, 6
    q, _ = _model_views(b, sq, kvh, g, hd, torch.bfloat16)
    _, k = _model_views(b, skv, kvh, g, hd, torch.bfloat16)
    v = torch.zeros((b, skv, kvh, hd), dtype=torch.bfloat16).transpose(1, 2)
    h = kvh * g
    box = [min(hd, 64), 128]
    assert tma_args(q, k, v) == (
        [hd, sq, h, b, 2 * h * hd, 2 * hd, 2 * sq * h * hd] + box
        + [hd, skv, kvh, b, 2 * kvh * hd, 2 * hd, 2 * skv * kvh * hd] + box
        + [hd, skv, kvh, b, 2 * kvh * hd, 2 * hd, 2 * skv * kvh * hd] + box)


def _pitched(b, s, heads, hd, pad, offset, dtype):
    """(B, heads, S, hd) view of (B, S, heads, hd + pad) storage that starts
    ``offset`` elements into its buffer."""
    n = b * s * heads * (hd + pad)
    flat = torch.zeros(n + offset, dtype=dtype)[offset:]
    return flat.view(b, s, heads, hd + pad)[..., :hd].transpose(1, 2)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype,pad,offset,want", [
    (torch.bfloat16, 0, 0, "tensor_core"),   # the model's views
    (torch.float32, 0, 0, "cuda_core"),      # fp32 (the fp32 smoke prefill)
    (torch.bfloat16, 1, 0, "cuda_core"),     # a row pitch of hd + 1
    (torch.bfloat16, 0, 1, "cuda_core"),     # a base offset by one element
    (torch.bfloat16, 8, 8, "tensor_core"),   # pitch and base 16-byte aligned
])
def test_body_choice(hd, dtype, pad, offset, want):
    """The tensor-core body takes bf16 q, k, v whose base addresses and
    batch, head and sequence strides are multiples of 16 bytes; every
    other input takes the CUDA-core body."""
    q = _pitched(2, 9, 6, hd, pad, offset, dtype)
    k = _pitched(2, 11, 2, hd, pad, offset, dtype)
    check_inputs(q, k, k, 0, 0)
    assert body(q, k, k) == want
    assert body(q, k, _pitched(2, 11, 2, hd, 0, 1, dtype)) == "cuda_core"


def _smoke_cfgs():
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    return jcfg, cfg


def _attn_params(jcfg, seed=0):
    jp = jattn.attention_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # non-zero biases, so the bias path is exercised
    jp = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
              if k.startswith("b") else v) for k, v in jp.items()}
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_attend_train_prefill_matches_jax():
    jcfg, cfg = _smoke_cfgs()
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 80, cfg.d_model)).astype(np.float32)
    pos = np.arange(80)[None, :]
    jout, (jk, jv) = jattn.attend_train(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jcfg, return_kv=True)
    router.reset_launches()
    q, k, v = attn.qkv_rope(tp, torch.from_numpy(x), torch.from_numpy(pos),
                            cfg)
    out = attn.flash_prefill(q, k, v, cfg.sliding_window) @ tp["wo"]
    assert router.launches() == {}          # the plain version on the CPU
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32)
    train = attn.attend_train(tp, torch.from_numpy(x), torch.from_numpy(pos),
                              cfg)
    np.testing.assert_allclose(train.numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_attend_train_return_kv_matches_jax():
    """``return_kv=True``: the output and the roped k and v, JAX's on the
    same inputs (self-attention), and the unroped k and v of a
    ``kv_input`` (a cross-attention with no rope)."""
    jcfg, cfg = _smoke_cfgs()
    jp, tp = _attn_params(jcfg, seed=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None, :]
    for kw, jkw in (({}, {}),
                    (dict(kv_input=torch.from_numpy(enc), rope=False,
                          causal=False, window=0),
                     dict(kv_input=jnp.asarray(enc), rope=False,
                          causal=False, window=0))):
        jout, (jk, jv) = jattn.attend_train(
            jp, jnp.asarray(x), jnp.asarray(pos), jcfg, return_kv=True,
            **jkw)
        out, (k, v) = attn.attend_train(tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), cfg,
                                        return_kv=True, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32)
        assert torch.equal(out, attn.attend_train(
            tp, torch.from_numpy(x), torch.from_numpy(pos), cfg, **kw))


@pytest.mark.parametrize("cross_len", [0, 7, 20])
def test_decode_attend_takes_cross_len_and_ignores_it(cross_len):
    """``cross_len`` is taken and not read, as in JAX (its body never
    reads it): a cross-attention decode against a 20-row encoder K and V
    gives the same output at any ``cross_len``, JAX's, and leaves the
    cache untouched."""
    jcfg, cfg = _smoke_cfgs()
    jp, tp = _attn_params(jcfg, seed=3)
    jp = {k: v for k, v in jp.items() if not k.startswith("b")}
    tp = {k: v for k, v in tp.items() if not k.startswith("b")}
    rng = np.random.default_rng(6)
    b = 2
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ek = rng.standard_normal((b, 20, cfg.num_kv_heads, cfg.hd)).astype(
        np.float32)
    ev = rng.standard_normal(ek.shape).astype(np.float32)
    jcache = jattn.init_cache(jcfg, b, 4, ring=False)
    jout, _ = jattn.decode_attend(jp, jnp.asarray(x), jnp.asarray(3),
                                  jcache, jcfg,
                                  cross_kv=(jnp.asarray(ek), jnp.asarray(ev)),
                                  cross_len=cross_len)
    cache = attn.init_cache(cfg, b, 4, ring=False, device="cpu")
    kw = dict(cross_kv=(torch.from_numpy(ek), torch.from_numpy(ev)))
    out, same = attn.decode_attend(tp, torch.from_numpy(x), 3, cache, cfg,
                                   cross_len=cross_len, **kw)
    assert same is cache and not cache.k.any() and not cache.v.any()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(out, attn.decode_attend(
        tp, torch.from_numpy(x), 3, cache, cfg, **kw)[0])


@pytest.mark.parametrize("per_slot", [True, False])
def test_decode_attend_matches_jax(per_slot):
    jcfg, cfg = _smoke_cfgs()
    jp, tp = _attn_params(jcfg, seed=1)
    rng = np.random.default_rng(4)
    b, cap = 3, 24
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, cap, cfg.num_kv_heads, cfg.hd)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([0, 7, 23]) if per_slot else np.array(11)
    jout, jcache = jattn.decode_attend(
        jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
        jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv), False), jcfg)
    cache = attn.init_cache(cfg, b, cap, ring=False, device="cpu")
    assert cache.k.shape == (b, cap, cfg.num_kv_heads, cfg.hd)
    assert not cache.k.any() and not cache.ring
    cache.k.copy_(torch.from_numpy(ck))
    cache.v.copy_(torch.from_numpy(cv))
    out, same = attn.decode_attend(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), cache, cfg)
    assert same is cache
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **F32)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **F32)


@pytest.mark.gpu
def test_flash_kernel_matches_plain_version_on_card():
    """Both bodies against the plain version: fp32 and unaligned bf16 rows
    on the CUDA-core body, aligned bf16 on the tensor-core body and, forced,
    on the CUDA-core body too; launches are counted per body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    router.reset_launches()
    cases = CASES + [(1, 2, 1, 70, 70, 32, True, 5, 70)]
    for case in cases:
        b, h, kv, sq, skv, hd, causal, window, q_offset = case
        mask = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype, pad, which in ((torch.float32, 0, "cuda_core"),
                                  (torch.bfloat16, 0, "tensor_core"),
                                  (torch.bfloat16, 1, "cuda_core")):
            # pad 1: rows not 16-byte aligned (the element-wise loads)
            q, k, v = (torch.from_numpy(np.pad(
                x, [(0, 0)] * 3 + [(0, pad)])).to("cuda", dtype)[..., :hd]
                for x in _inputs(b, h, kv, sq, skv, hd))
            assert body(q, k, v) == which
            outs = [ops.flash_attention(q, k, v, **mask)]
            if which == "tensor_core":
                outs.append(flash_attention_cuda(
                    q, k, v, force_body="cuda_core", **mask))
            want = ops.flash_attention(q, k, v, force="ref", **mask)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                atol = 1e-5 * max(1.0, float(want.abs().max()))
            else:
                atol = _bf16_ulp(want.float().cpu().numpy())
            for got in outs:
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=atol)
    n = len(cases)
    assert router.launches() == {"flash_attention": 4 * n,
                                 "flash_attention.tensor_core": n,
                                 "flash_attention.cuda_core": 3 * n}
    with pytest.raises(ValueError, match="tensor-core body takes"):
        flash_attention_cuda(q.float(), k.float(), v.float(),
                             force_body="tensor_core")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
