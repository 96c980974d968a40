"""The port's flash attention, prefill attention and decode attention
against the JAX package.

Inputs come from numpy with a seed and go to both frameworks.  The JAX
Pallas kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.
Tolerances: fp32 against JAX's plain softmax 1e-5 (the same math, other
summation orders); against the Pallas kernel 2e-4, as
``tests/test_kernels.py`` holds it to the same oracle; bf16 outputs one
bf16 ulp of the largest output (both round the same fp32 result once).
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
    check_inputs, flash_attention_cuda, launch_args, softmax_scale)
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


def test_launch_args_read_the_model_layout_in_place():
    """The prefill passes permuted views of (B, S, KV, G, hd) q and
    (B, S, KV, hd) k, v: head h = kv G + g has stride hd, sequence stride
    H hd, and the output's (B, H, S, hd) view is (B, S, H, hd) storage."""
    b, s, kvh, g, hd = 2, 5, 2, 3, 32
    q5 = torch.zeros((b, s, kvh, g, hd))
    k4 = torch.zeros((b, s, kvh, hd))
    q = q5.permute(0, 2, 3, 1, 4).reshape(b, -1, s, hd)
    k = k4.transpose(1, 2)
    assert q.data_ptr() == q5.data_ptr() and q.stride(-1) == 1
    out = torch.empty((b, s, kvh * g, hd)).transpose(1, 2)
    args = launch_args(q, k, k, out, True, 0, 3)
    assert args[:6] == (b, kvh * g, kvh, s, s, hd)
    assert list(args[6]) == [s * kvh * g * hd, hd, kvh * g * hd,
                             s * kvh * hd, hd, kvh * hd,
                             s * kvh * hd, hd, kvh * hd,
                             s * kvh * g * hd, hd, kvh * g * hd]
    assert args[7:] == (softmax_scale(hd), 1, 0, 3)


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
    out, (k, v) = attn.attend_train(tp, torch.from_numpy(x),
                                    torch.from_numpy(pos), cfg,
                                    return_kv=True)
    assert router.launches() == {}          # the plain version on the CPU
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32)
    train = attn.attend_train(tp, torch.from_numpy(x), torch.from_numpy(pos),
                              cfg)
    np.testing.assert_allclose(train.numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-6)


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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    router.reset_launches()
    for case in CASES + [(1, 2, 1, 70, 70, 32, True, 5, 70)]:
        b, h, kv, sq, skv, hd, causal, window, q_offset = case
        mask = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype, pad in ((torch.float32, 0), (torch.bfloat16, 0),
                           (torch.bfloat16, 1)):
            # pad 1: rows not 16-byte aligned (the element-wise loads)
            q, k, v = (torch.from_numpy(np.pad(
                x, [(0, 0)] * 3 + [(0, pad)])).to("cuda", dtype)[..., :hd]
                for x in _inputs(b, h, kv, sq, skv, hd))
            got = ops.flash_attention(q, k, v, **mask)
            want = ops.flash_attention(q, k, v, force="ref", **mask)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                atol = 1e-5 * max(1.0, float(want.abs().max()))
            else:
                atol = _bf16_ulp(want.float().cpu().numpy())
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=atol)
    assert router.launches() == {"flash_attention": 3 * (len(CASES) + 1)}
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
