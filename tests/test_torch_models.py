"""The port's dense LM against ``repro.models`` with the same weights.

Weights come from the JAX ``init_params`` through the numpy bridge.  The
fp32 copy of the smoke config is held tightly (the two differ only in
summation order: the JAX model takes the softmax blockwise over 64-token
chunks, the port in one pass); the bf16 smoke config once, loosely.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro_torch import configs, models  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-5)  # fp32, reordered sums over <= 256


def _cfgs(dtype):
    return (dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                                dtype=dtype),
            dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                                dtype=dtype))


def _setup(dtype="float32", b=3, s=80, seed=0):
    jcfg, cfg = _cfgs(dtype)
    jparams = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = models.from_jax_params(tree, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, :5] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    return jcfg, cfg, jparams, model, jbatch, batch


def test_weight_bridge_round_trip_and_layout():
    jcfg, cfg, jparams, model, _, _ = _setup("bfloat16")
    flat = model.params()
    assert len(flat) == 15
    assert list(flat) == sorted(flat, key=lambda k: tuple(k.split(".")))
    assert dict(model.named_parameters()).keys() == flat.keys()
    back = models.to_jax_params(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, jparams)
    for name, p in flat.items():
        assert p.dtype == torch.bfloat16 or name.endswith(
            ("ln1", "ln2", "final_norm"))
    assert models.param_count(flat) == jmodels.param_count(jparams)


def test_init_params_shapes_dtypes_and_scale():
    _, cfg = _cfgs("bfloat16")
    jcfg = jconfigs.smoke_config("qwen2-1.5b")
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    mine = models.init_params(cfg, torch.Generator().manual_seed(0))
    flat = models.model._flatten_tree(jax.tree.map(np.asarray, jparams))
    assert list(mine) == sorted(flat, key=lambda k: tuple(k.split(".")))
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype)
        got = mine[k].float()
        assert float(got.abs().max()) <= 2.0 * max(
            1.0, float(np.abs(np.asarray(v, np.float32)).max())) + 1e-6
    emb = mine["embed"].float()
    assert abs(float(emb.std()) - 0.88) < 0.05      # truncated N(0, 1)
    wq = mine["blocks.attn.wq"].float()
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05


def test_forward_matches_fp32():
    jcfg, cfg, jparams, model, jbatch, batch = _setup()
    want, _ = jmodels.forward(jparams, jcfg, jbatch)
    with torch.no_grad():
        got = model(batch["tokens"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 1.0]])
def test_lm_loss_and_gradient_match_fp32(weights):
    jcfg, cfg, jparams, model, jbatch, batch = _setup()
    jsw = None if weights is None else jnp.asarray(weights, jnp.float32)
    sw = None if weights is None else torch.tensor(weights)

    def jloss(p):
        total, m = jmodels.lm_loss(p, jcfg, jbatch, jsw)
        return total, m

    (jtotal, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = model.params()
    total, m = models.lm_loss(params, cfg, batch, sw)
    grads = torch.autograd.grad(total, list(params.values()))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["ntok"]), float(jm["ntok"]))
    jflat = models.model._flatten_tree(jax.tree.map(np.asarray, jgrads))
    for (name, g) in zip(params, grads):
        want = jflat[name]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)


def test_lm_loss_matches_bf16_loosely():
    """bf16 rounds at other places in the two frameworks: 2e-2 on the
    loss (about 6.5 here)."""
    jcfg, cfg, jparams, model, jbatch, batch = _setup("bfloat16")
    jtotal, _ = jmodels.lm_loss(jparams, jcfg, jbatch,
                                jnp.asarray([1.0, 1.0, 0.0]))
    total, _ = models.lm_loss(model.params(), cfg, batch,
                              torch.tensor([1.0, 1.0, 0.0]))
    assert abs(float(total) - float(jtotal)) < 2e-2
