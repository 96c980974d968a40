"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` with the same weights and inputs.

Weights come from JAX's ``moe_params`` through numpy, inputs from a numpy
seed.  In fp32 both sides compute the same function: the router's top-k
picks agree (random inputs, no ties), the sort, ranks, drops and scatters
are integer work, and the products and sums differ only in summation
order: out and the gradients are held at rtol 1e-5 (atol 1e-6 times the
largest magnitude), aux at rtol 1e-6.  Regimes: drops at the default
capacity, no drops, two groups against one, and the decode grouping (S 1,
one group of every token).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
RTOL = 1e-5


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.smoke_config(ARCH), **kw),
            dataclasses.replace(configs.smoke_config(ARCH), **kw))


def _setup(shape, seed=0, shift=0.0, **kw):
    """``shift`` adds one random vector of that scale to every token, which
    skews the router toward some experts (so that some overflow)."""
    jcfg, cfg = _cfgs(**kw)
    jp = jmoe.moe_params(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, cfg.dtype) if k != "router" else torch.float32)
        for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    x += shift * rng.standard_normal(cfg.d_model).astype(np.float32)
    r = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return jcfg, cfg, jp, tp, x, r


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=rtol,
        atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _dropped(cfg, tp, x) -> int:
    """Assignments past their expert's capacity in the port's dispatch."""
    xt = torch.from_numpy(x)
    b, s, d = xt.shape
    probs = torch.softmax(xt.float() @ tp["router"], -1)
    idx = torch.topk(probs, cfg.experts_per_token, -1).indices
    g = moe.num_groups(b, s)
    tg = b * s // g
    _, meta = moe._dispatch_group(xt.reshape(g, tg, d),
                                  idx.reshape(g, tg, -1), cfg.num_experts,
                                  moe.capacity(cfg, tg))
    return int((~meta[3]).sum())


REGIMES = {
    # (shape, setup keywords, expected groups, drops?)
    "drops": ((2, 64), {"shift": 1.0}, 2, True),
    "no_drops": ((2, 64), {"capacity_factor": 8.0}, 2, False),
    "decode": ((8, 1), {"shift": 1.0}, 1, True),
    "one_sequence": ((1, 100), {"shift": 1.0}, 1, True),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_moe_forward_and_gradient_match_jax(regime):
    shape, kw, groups, drops = REGIMES[regime]
    jcfg, cfg, jp, tp, x, r = _setup(shape, **kw)
    assert moe.num_groups(*shape) == groups
    assert (_dropped(cfg, tp, x) > 0) == drops

    def jfn(p, xx):
        out, aux = jmoe.moe_forward(p, xx, jcfg)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_forward(tp, xt, cfg)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    _close(out, jout)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    total = (out * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(total, [xt] + list(tp.values()))
    _close(grads[0], jgx)
    for (name, _), g in zip(tp.items(), grads[1:]):
        _close(g, jgp[name])


def test_two_groups_equal_one_group_without_drops():
    """As ``tests/test_models.py``: (2, 64) dispatches in 2 groups, the
    same tokens as (1, 128) in one; with room for every assignment the
    two agree (fp32: to summation order), and so do their aux."""
    jcfg, cfg, _, tp, x, _ = _setup((2, 64), capacity_factor=8.0)
    xt = torch.from_numpy(x)
    grouped, aux2 = moe.moe_forward(tp, xt, cfg)
    single, aux1 = moe.moe_forward(tp, xt.reshape(1, 128, -1), cfg)
    assert moe.num_groups(2, 64) == 2 and moe.num_groups(1, 128) == 1
    _close(grouped.reshape(1, 128, -1), single.numpy())
    np.testing.assert_allclose(float(aux2), float(aux1), rtol=1e-6)


@pytest.mark.parametrize("b,s,want", [(8, 1, 1), (2, 64, 2), (32, 256, 32),
                                      (64, 8, 1), (128, 1, 1), (40, 4, 1),
                                      (32, 2, 1), (48, 4, 1), (64, 32, 32),
                                      (3, 100, 3)])
def test_group_rule_and_capacity_follow_jax(b, s, want):
    """The group count of ``moe_forward``'s rule, and the capacity under
    Python's round (2.5 rounds to 2)."""
    assert moe.num_groups(b, s) == want
    _, cfg = _cfgs()
    for tg in (1, 2, 4, 8, 64, 256):
        assert moe.capacity(cfg, tg) == int(max(1, round(
            1.25 * tg * 2 / 4)))
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=1.0),
                        5) == 2


def test_bf16_matches_jax_loosely():
    """bf16 weights and inputs with the expert products in bf16 (the
    smoke config's ``mxu_f32_accum=False``, as JAX runs it on the CPU): the
    two round at other places, so 2e-2 of the output's largest value."""
    jcfg, cfg, jp, tp, x, _ = _setup((2, 64), dtype="bfloat16")
    assert tp["w_gate"].dtype == torch.bfloat16
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    out, aux = moe.moe_forward(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)


def test_fp32_accumulation_of_bf16_products():
    """Under ``mxu_f32_accum`` the expert products of bf16 operands come
    back fp32 and equal the fp32 products of the same values (bf16
    products are exact in fp32); without it they stay bf16."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 4, 5, 16, generator=g).bfloat16()
    w = torch.randn(4, 16, 8, generator=g).bfloat16()
    got = moe._expert_mm(a, w, True)
    want = torch.einsum("gecd,edf->gecf", a.float(), w.float())
    assert got.dtype == torch.float32 and got.shape == (3, 4, 5, 8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert moe._expert_mm(a, w, False).dtype == torch.bfloat16
    _, cfg = _cfgs(dtype="bfloat16")
    assert not cfg.mxu_f32_accum
    assert configs.get_config(ARCH).mxu_f32_accum


def test_moe_params_layout_and_scale():
    """The stacked leaves' names, shapes and dtypes are JAX's (with a
    layer axis), drawn as truncated normals over 1/sqrt(fan_in)."""
    _, cfg = _cfgs(dtype="bfloat16")
    jp = jmoe.moe_params(jax.random.PRNGKey(0),
                         jconfigs.smoke_config(ARCH))
    mine = moe.moe_params(cfg, torch.Generator().manual_seed(0), 3)
    assert mine.keys() == jp.keys()
    for k, v in jp.items():
        assert tuple(mine[k].shape) == (3,) + v.shape
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype)
    assert mine["router"].dtype == torch.float32
    wg = mine["w_gate"].float()
    assert abs(float(wg.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05
    assert not torch.equal(mine["w_gate"][0], mine["w_gate"][1])
