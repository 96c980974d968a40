"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
Inputs come from numpy and pass to both frameworks.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.dist import consensus as jcons  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dual_update import dual_update_pallas  # noqa: E402
from repro.kernels.gossip_combine import (  # noqa: E402
    gossip_combine_pallas, quantized_combine_pallas,
    stochastic_quantize_pallas)
from repro_torch.dist.consensus import GossipConsensus  # noqa: E402
from repro_torch.kernels import build, ops, ref, router  # noqa: E402
from repro_torch.kernels.dual_update import dual_update_cuda  # noqa: E402
from repro_torch.kernels.gossip_combine import (  # noqa: E402
    gossip_combine_cuda)
from repro_torch.kernels.quantized_combine import (  # noqa: E402
    quantized_combine_cuda)
from repro_torch.kernels.stochastic_quantize import (  # noqa: E402
    stochastic_quantize_cuda)

TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 elementwise math on both sides


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


# (length, z offset, w0 offset): odd lengths, views that start 1, 3 or 4
# elements into their buffers, as per-worker dual views start where their
# leaf's offset puts them.  On the card a start 4 elements in (16 bytes)
# takes the kernel's vectors and scalar tail, one 1 or 3 in its scalar loop
VIEWS = [(1001, 1, 1), (1001, 3, 3), (1001, 4, 4), (4099, 1, 3), (3, 1, 1),
         (2 ** 16 + 5, 3, 1)]
SHAPES = [((7,), (0, 0)), ((128,), (0, 0)), ((1000, 37), (0, 0)),
          ((3, 5, 129), (0, 0))] + [((n,), (oz, ow)) for n, oz, ow in VIEWS]


def _views(n, oz, ow, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    z = _t(rng.standard_normal(n + oz)).to(device)[oz:]
    w0 = _t(rng.standard_normal(n + ow), dtype).to(device)[ow:]
    return z, w0


@pytest.mark.parametrize(
    "shape,offsets", SHAPES,
    ids=[f"shape{i}" for i in range(4)]
    + [f"view{n}-z{oz}-w{ow}" for n, oz, ow in VIEWS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_update_matches_pallas_and_ref(shape, offsets, dtype):
    """Whole tensors, and views that start ``offsets`` (z, w0) elements into
    their buffers: the prox reads them in place."""
    (n,), (oz, ow) = (math.prod(shape),), offsets
    z, w0 = _views(n, oz, ow, getattr(torch, dtype))
    z, w0 = z.view(shape), w0.view(shape)
    assert z.storage_offset() == oz and w0.storage_offset() == ow
    jz, jw0 = jnp.asarray(z.numpy()), jnp.asarray(w0.float().numpy(), dtype)
    beta = 1.7
    pallas = dual_update_pallas(jz, jw0, jnp.float32(beta), interpret=True,
                                block=2048)
    want = jref.dual_update_ref(jz, jw0, jnp.float32(beta))
    got = ops.dual_update(z, w0, beta)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ref.dual_update_ref(z, w0, beta).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("radius", [0.5, 1e3])
def test_dual_update_radius_projection(radius):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((16, 9)).astype(np.float32) * 30.0
    w0 = rng.standard_normal((16, 9)).astype(np.float32)
    want = jops.dual_update(jnp.asarray(z), jnp.asarray(w0),
                            jnp.float32(0.9), radius=radius, force="ref")
    got = ops.dual_update(_t(z), _t(w0), 0.9, radius=radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(torch.linalg.vector_norm(got - _t(w0))) <= radius * (1 + 1e-5)


@pytest.mark.parametrize("k,n", [(2, 100), (3, 4096), (5, 999)])
def test_gossip_combine_matches_pallas(k, n):
    rng = np.random.default_rng(2)
    msgs = rng.standard_normal((k, n)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    w /= w.sum()
    pallas = gossip_combine_pallas(jnp.asarray(msgs), jnp.asarray(w),
                                   interpret=True, block_rows=16)
    # one output row that reads source row k in tap k
    src = torch.arange(k, dtype=torch.int32)[:, None]
    got = ops.gossip_combine(_t(msgs), src, w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("n,graph", [(2, "ring"), (4, "ring"),
                                     (4, "torus")])
def test_gossip_combine_matches_rolled_taps(n, graph):
    """One round equals ``_roll_taps`` + the Pallas reference combine."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((n, 257)).astype(np.float32)
    jstrat = jcons.GossipConsensus(n, 1, graph)
    stacked = jcons._roll_taps(jnp.asarray(m), jstrat.taps)
    want = jref.gossip_combine_ref(stacked.reshape(jstrat.taps.k, -1),
                                   jnp.asarray(jstrat.taps.weights))
    strat = GossipConsensus(n, 1, graph)
    assert strat.taps.offsets == jstrat.taps.offsets
    np.testing.assert_array_equal(strat.taps.weights, jstrat.taps.weights)
    got = ops.gossip_combine(_t(m), strat.source_rows("cpu"),
                             strat.taps.weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(n, -1),
                               **TOL)


def test_router_picks_plain_version_on_cpu_and_refuses_kernel():
    x = torch.zeros(3)
    assert router.resolve(x) == "ref"
    assert router.resolve(x, force="ref") == "ref"
    with pytest.raises(ValueError):
        router.resolve(x, force="kernel")
    with pytest.raises(ValueError):
        router.resolve(x, force="pallas")
    with pytest.raises(ValueError):
        dual_update_cuda(x, x, 1.0)
    with pytest.raises(ValueError):
        gossip_combine_cuda(x[None], torch.zeros((1, 1), dtype=torch.int32),
                            [1.0])
    m = x[None]
    with pytest.raises(ValueError):
        stochastic_quantize_cuda(m, m, m, x[:1], x[:1], 255.0)
    with pytest.raises(ValueError):
        quantized_combine_cuda(m, m[None][:0], m.to(torch.uint8), x[:1],
                               x[:1], torch.zeros((1, 1), dtype=torch.int32),
                               [1.0])


def test_cpu_path_counts_no_launches():
    router.reset_launches()
    ops.dual_update(torch.ones(4), torch.ones(4), 2.0)
    src = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    ops.gossip_combine(torch.ones((2, 3)), src, [0.5, 0.5])
    m, grid = torch.ones((2, 3)), torch.ones((2, 1))
    lvl, _ = ops.stochastic_quantize(m, m, m, grid, grid, 15.0)
    ops.quantized_combine(m, m[None], lvl, grid, grid, src, [0.5, 0.5])
    assert router.launches() == {}


def test_gossip_combine_writes_into_out_apart_from_m():
    m = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    src = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    out = torch.empty_like(m)
    got = ops.gossip_combine(m, src, [0.25, 0.75], out=out)
    assert got is out
    torch.testing.assert_close(out, ops.gossip_combine(m, src, [0.25, 0.75]),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="overlap"):
        ops.gossip_combine(m, src, [0.25, 0.75], out=m)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.gossip_combine(m, src, [0.25, 0.75], out=torch.empty((2, 5)))


# ---------------------------------------------------------------------------
# Quantized gossip: the send half (stochastic quantize) and the receive half
# (quantized combine).  The port's plain versions repeat the JAX reference's
# ops one by one, so they match eager JAX bit for bit.  Under jit, XLA's CPU
# fusion may round the replica sum (h + lo) + lvl * scale differently in its
# last bit, so jitted and interpret-mode Pallas outputs are held at 1e-6
# relative; the levels themselves come out identical on these inputs.
# ---------------------------------------------------------------------------

QTOL = dict(rtol=1e-6, atol=1e-6)


def _row_grid(diff: np.ndarray, levels: float):
    lo = diff.min(-1, keepdims=True)
    scale = (np.maximum(diff.max(-1, keepdims=True) - lo, np.float32(1e-12))
             / np.float32(levels)).astype(np.float32)
    return lo, scale


def _quantize_inputs(n, d, levels, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((n, d)) * 2.0).astype(np.float32)
    h = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    rnd = rng.random((n, d), dtype=np.float32)
    return (m, h, rnd) + _row_grid(m - h, levels)


@pytest.mark.parametrize("levels", [255.0, 15.0])
@pytest.mark.parametrize("n,d", [(4, 1001), (6, 257), (3, 128)])
def test_stochastic_quantize_matches_pallas_and_ref(n, d, levels):
    args = _quantize_inputs(n, d, levels)
    jargs = [jnp.asarray(a) for a in args]
    want_l, want_h = jref.stochastic_quantize_ref(*jargs, levels)
    pal_l, pal_h = stochastic_quantize_pallas(*jargs, levels=levels,
                                              interpret=True, block_rows=4)
    got_l, got_h = ops.stochastic_quantize(*[_t(a) for a in args], levels)
    assert got_l.dtype == torch.uint8 and int(got_l.max()) <= levels
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(pal_l))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(pal_h), **QTOL)


def _combine_inputs(strat_taps, n, d, levels, seed=1):
    rng = np.random.default_rng(seed)
    km1 = strat_taps.k - 1
    m = rng.standard_normal((n, d)).astype(np.float32)
    hnbr = rng.standard_normal((km1, n, d)).astype(np.float32)
    lvl = rng.integers(0, int(levels) + 1, (n, d)).astype(np.uint8)
    lo = rng.standard_normal((n, 1)).astype(np.float32)
    scale = (rng.random((n, 1)) * 0.01).astype(np.float32)
    return m, hnbr, lvl, lo, scale


@pytest.mark.parametrize("levels", [255.0, 15.0])
@pytest.mark.parametrize("n,graph,d", [(4, "ring", 1001), (6, "ring", 257),
                                       (6, "torus", 129)])
def test_quantized_combine_matches_pallas_and_ref(n, graph, d, levels):
    """The port reads the unrolled level plane through the source-row
    table; the JAX side is fed the rolled (K-1, n, d) stacks of it."""
    jtaps = jcons.GossipConsensus(n, 1, graph).taps
    strat = GossipConsensus(n, 1, graph)
    m, hnbr, lvl, lo, scale = _combine_inputs(jtaps, n, d, levels)
    roll = lambda x: jnp.stack([jtaps.take(jnp.asarray(x), j)
                                for j in range(1, jtaps.k)])
    jargs = (jnp.asarray(m), jnp.asarray(hnbr), roll(lvl), roll(lo),
             roll(scale), jnp.asarray(jtaps.weights))
    want_o, want_h = jref.quantized_combine_ref(*jargs)
    pal_o, pal_h = quantized_combine_pallas(*jargs, interpret=True,
                                            block_rows=8)
    got_o, got_h = ops.quantized_combine(
        _t(m), _t(hnbr), torch.from_numpy(lvl), _t(lo), _t(scale),
        strat.source_rows("cpu"), strat.taps.weights)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(pal_o), **QTOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(pal_h), **QTOL)


def test_quantized_ops_write_in_place_and_refuse_overlaps():
    """A round runs in place: h_new over h, out over m, hnbr_new over
    hnbr; any other overlap is refused."""
    strat = GossipConsensus(4, 1, "ring")
    m, h, rnd, lo, scale = [_t(a) for a in _quantize_inputs(4, 33, 255.0)]
    want_l, want_h = ops.stochastic_quantize(m, h, rnd, lo, scale)
    lvl = torch.empty(m.shape, dtype=torch.uint8)
    got = ops.stochastic_quantize(m, h, rnd, lo, scale, out=(lvl, h))
    assert got[0] is lvl and got[1] is h
    assert torch.equal(lvl, want_l) and torch.equal(h, want_h)
    with pytest.raises(ValueError, match="overlaps"):
        ops.stochastic_quantize(m, h, rnd, lo, scale, out=(lvl, m))
    with pytest.raises(ValueError, match="uint8"):
        ops.stochastic_quantize(m, h, rnd, lo, scale, out=(h, h))
    src = strat.source_rows("cpu")
    hnbr = torch.stack([m * 0.5, m * 0.25])
    want_o, want_hn = ops.quantized_combine(m, hnbr, lvl, lo, scale, src,
                                            strat.taps.weights)
    got = ops.quantized_combine(m, hnbr, lvl, lo, scale, src,
                                strat.taps.weights, out=(m, hnbr))
    assert got[0] is m and got[1] is hnbr
    assert torch.equal(m, want_o) and torch.equal(hnbr, want_hn)
    with pytest.raises(ValueError, match="overlaps"):
        ops.quantized_combine(m, hnbr, lvl, lo, scale, src,
                              strat.taps.weights, out=(hnbr[0], hnbr))


def test_ptxas_report_keeps_registers_and_spills(tmp_path, monkeypatch):
    """The build keeps nvcc's output beside the library; the report is its
    per-kernel lines: entry, spills, registers."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="no build log"):
        build.ptxas_report("dual_update")
    log = build.library_path("dual_update").with_suffix(".log")
    assert log.parent == tmp_path and log.name.startswith("libdual_update-")
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 58 registers, used 0 barriers\n")
    assert build.ptxas_report("dual_update") == [
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 58 registers, used 0 barriers"]


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    router.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.randn(100003, generator=gen, device="cuda")
        w0 = torch.randn(100003, generator=gen, device="cuda").to(dtype)
        got = ops.dual_update(z, w0, 3.5)
        want = ops.dual_update(z, w0, 3.5, force="ref")
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    strat = GossipConsensus(4, 1, "torus")
    m = torch.randn((4, 1001), generator=gen, device="cuda")
    src = strat.source_rows("cuda")
    got = ops.gossip_combine(m, src, strat.taps.weights)
    want = ops.gossip_combine(m, src, strat.taps.weights, force="ref")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    out = torch.empty_like(m)
    assert ops.gossip_combine(m, src, strat.taps.weights, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    for levels in (255.0, 15.0):
        args = [_t(a).cuda() for a in _quantize_inputs(4, 1001, levels)]
        got = ops.stochastic_quantize(*args, levels)
        want = ops.stochastic_quantize(*args, levels, force="ref")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        q = [x.cuda() for x in (_t(m.cpu().numpy()), torch.zeros(
            (strat.taps.k - 1, 4, 1001)), got[0], args[3], args[4])]
        got = ops.quantized_combine(*q, src, strat.taps.weights)
        want = ops.quantized_combine(*q, src, strat.taps.weights,
                                     force="ref")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert router.launches() == {"dual_update": 2, "gossip_combine": 2,
                                 "stochastic_quantize": 2,
                                 "quantized_combine": 2}


@pytest.mark.gpu
def test_dual_update_on_offset_views_on_card():
    """The kernel on views offset by 1, 3 and 4 elements with odd lengths
    (its scalar loop, and its vectors with a scalar tail), against its
    plain version within DUAL_TOL (2e-6, chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    router.reset_launches()
    for n, oz, ow in VIEWS:
        for dtype in (torch.float32, torch.bfloat16):
            z, w0 = _views(n, oz, ow, dtype, device="cuda")
            got = ops.dual_update(z, w0, 3.5)
            want = ops.dual_update(z, w0, 3.5, force="ref")
            torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    assert router.launches() == {"dual_update": 2 * len(VIEWS)}
