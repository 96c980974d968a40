"""The port's data plane (``repro_torch.data``) against ``repro.data``.

The regression streams and the token stream draw from torch, not from
JAX's threefry keys, so they are held to JAX's by their statistics and
their determinism in (seed, node, epoch); the sources' layouts and the
prefetcher's contract are held exactly.
"""
import math
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.data import loader as jloader  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import (CostedSource, InputSource,  # noqa: E402
                              LinRegStream, LMTokenStream, LogRegStream,
                              Prefetcher, StreamSource, SyntheticSource,
                              make_source, make_stream)

CPU = dict(device="cpu")


def _same_block_share(tokens, vocab, blocks):
    t = np.asarray(tokens)
    blk = vocab // blocks
    return float(np.mean((t[:, :-1] // blk) == (t[:, 1:] // blk)))


# ---------------------------------------------------------------------------
# regression streams
# ---------------------------------------------------------------------------

def test_linreg_stream_statistics_and_determinism():
    """x ~ N(0, I): mean within 0.01 and std within 0.01 of 0 and 1 over
    40,000 draws (5 standard errors); y - x.w* has variance noise_var
    within 10%; w* ~ N(0, I) like JAX's."""
    s = LinRegStream(dim=20, seed=3, **CPU)
    x, y = s.batch(1, 2, 2000)
    assert x.shape == (2000, 20) and y.shape == (2000,)
    assert x.dtype == torch.float32 and y.dtype == torch.float32
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    resid = (y - x @ s.w_star()).double()
    assert abs(float(resid.var()) / s.noise_var - 1) < 0.1
    ws, jws = s.w_star(), np.asarray(jpipe.LinRegStream(dim=20).w_star())
    assert ws.shape == jws.shape and ws.dtype == torch.float32
    a = s.batch(1, 2, 50)
    torch.testing.assert_close(a, s.batch(1, 2, 50), rtol=0, atol=0)
    for other in (s.batch(0, 2, 50), s.batch(1, 3, 50),
                  LinRegStream(dim=20, seed=4, **CPU).batch(1, 2, 50)):
        assert not torch.equal(a[0], other[0])
    w = torch.ones(20)
    x2, y2 = s.batch(1, 2, 50, w_star=w)
    torch.testing.assert_close(x2, a[0], rtol=0, atol=0)
    torch.testing.assert_close(y2 - x2 @ w, a[1] - a[0] @ s.w_star(),
                               rtol=0, atol=1e-5)


def test_logreg_stream_statistics_and_determinism():
    """Classes uniform (each share within 0.02 of 0.1 over 20,000), x -
    mu_y ~ N(0, I) (std within 0.01), class means of norm ~ spread (JAX's
    scale: spread N(0, I) / sqrt(dim))."""
    s = LogRegStream(seed=1, **CPU)
    x, y = s.batch(0, 0, 20000)
    assert x.shape == (20000, 784) and y.shape == (20000,)
    share = torch.bincount(y, minlength=10).double() / 20000
    assert float((share - 0.1).abs().max()) < 0.02
    means = s.class_means()
    assert abs(float((x - means[y]).std()) - 1.0) < 0.01
    jmeans = np.asarray(jpipe.LogRegStream(seed=1).class_means())
    assert means.shape == jmeans.shape
    norms = torch.linalg.vector_norm(means, dim=1)
    jnorms = np.linalg.norm(jmeans, axis=1)
    assert abs(float(norms.mean()) - float(jnorms.mean())) < 0.2
    a = s.batch(2, 5, 30)
    torch.testing.assert_close(a, s.batch(2, 5, 30), rtol=0, atol=0)
    assert not torch.equal(a[0], s.batch(3, 5, 30)[0])
    assert not torch.equal(a[0], s.batch(2, 6, 30)[0])


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_stream_block_structure_matches_jax(seed):
    """V 256, 16 blocks, 64 sequences of 64: the share of transitions that
    stay in the current token's block is JAX's within 0.03, and both are
    within 0.03 of 16 e^2 / (16 e^2 + 240) = 0.330 (the lognormal noise
    cancels in expectation); about 4 standard errors of a share of 4,032
    transitions each."""
    want = _same_block_share(jpipe.LMTokenStream(256, 64, seed=seed).batch(
        0, 0, 64)["tokens"], 256, 16)
    got = _same_block_share(LMTokenStream(256, 64, seed=seed, **CPU).batch(
        0, 0, 64)["tokens"], 256, 16)
    expect = 16 * math.e ** 2 / (16 * math.e ** 2 + 240)
    assert abs(got - want) < 0.03
    assert abs(got - expect) < 0.03 and abs(want - expect) < 0.03


def test_lm_stream_is_deterministic_and_shifted():
    s = LMTokenStream(97, 12, seed=3, **CPU)
    a = s.batch(1, 4, 5)
    assert a["tokens"].shape == (5, 12) and a["tokens"].dtype == torch.int64
    torch.testing.assert_close(a, s.batch(1, 4, 5), rtol=0, atol=0)
    for other in (s.batch(0, 4, 5), s.batch(1, 5, 5),
                  LMTokenStream(97, 12, seed=4, **CPU).batch(1, 4, 5)):
        assert not torch.equal(a["tokens"], other["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 97
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    # a batch's first rows do not depend on how many rows were asked for
    torch.testing.assert_close(s.batch(1, 4, 3), {
        k: v[:3] for k, v in a.items()}, rtol=0, atol=0)


def test_lm_transition_logits_are_a_function_of_seed_and_token():
    """Row tok: 0.5 N(0, 1) noise plus 2.0 on tok's own block, the same
    wherever and with whichever other rows it is computed."""
    s = LMTokenStream(4096, 4, seed=5, **CPU)
    toks = torch.tensor([0, 17, 4095, 300, 17])
    rows = s.transition_logits(toks)
    assert rows.shape == (5, 4096) and rows.dtype == torch.float32
    torch.testing.assert_close(rows[1], rows[4], rtol=0, atol=0)
    torch.testing.assert_close(rows[2:3], s.transition_logits(
        torch.tensor([4095])), rtol=0, atol=0)
    assert not torch.equal(rows[1], LMTokenStream(
        4096, 4, seed=6, **CPU).transition_logits(torch.tensor([17]))[0])
    blk = s.block
    cols = torch.arange(4096)
    same = (toks[:, None] // blk) == (cols // blk)
    noise = rows - 2.0 * same
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 0.5) < 0.01


def test_lm_stream_never_builds_a_vocab_square():
    """Every tensor the batch creates has fewer than V elements per
    sequence and a handful of rows: no (V, V) transition matrix."""
    v, size = 2048, 4

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.most = max(Largest.most, t.numel())
            return out

    with Largest():
        LMTokenStream(v, 6, **CPU).batch(0, 0, size)
    assert 0 < Largest.most <= 2 * size * v < v * v


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lm", "linreg", "logreg"])
def test_stream_source_layout_matches_jax(kind):
    """Worker i's block is stream node i's batch, in worker order, with
    JAX's leaves, shapes and leading dim (tokens are int64 here, the
    index type of torch's embedding)."""
    kw = {"lm": dict(vocab_size=97, seq_len=8, seed=3),
          "linreg": dict(dim=6, seed=1), "logreg": dict(dim=6, seed=2)}[kind]
    stream = make_stream(kind, **kw, **CPU)
    src = StreamSource(stream, n_workers=4, per_worker=2)
    got = src.batch(5)
    want = jloader.StreamSource(jpipe.make_stream(kind, **kw), 4, 2).batch(5)
    got_leaves = list(got.values()) if kind == "lm" else list(got)
    want_leaves = list(want.values()) if kind == "lm" else list(want)
    if kind == "lm":
        assert got.keys() == want.keys()
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
    for i in range(4):
        shard = stream.batch(i, 5, 2)
        shard = list(shard.values()) if kind == "lm" else list(shard)
        for g, s in zip(got_leaves, shard):
            torch.testing.assert_close(g[2 * i:2 * i + 2], s, rtol=0, atol=0)
    assert not torch.equal(got_leaves[0][0:2], got_leaves[0][2:4])
    assert src.global_batch == 8
    # coded placement (tests/test_torch_faults.py holds it against JAX):
    # the members of a group of 2 hold node g's block, the second rolled
    from repro_torch.dist.redundancy import CodedAssignment
    with pytest.raises(ValueError, match="assignment covers 8 workers"):
        StreamSource(stream, 4, 2, assignment=CodedAssignment(8, 2))
    coded = StreamSource(stream, 4, 2, assignment=CodedAssignment(4, 2))
    got = coded.batch(5)
    got_leaves = list(got.values()) if kind == "lm" else list(got)
    for i in range(4):
        block = stream.batch(i // 2, 5, 2)
        block = list(block.values()) if kind == "lm" else list(block)
        for g, s in zip(got_leaves, block):
            torch.testing.assert_close(g[2 * i:2 * i + 2],
                                       torch.roll(s, -(i % 2), dims=0),
                                       rtol=0, atol=0)


def test_make_source_registry():
    s1 = make_source("lm", n_workers=2, per_worker=2, vocab_size=17,
                     seq_len=4, **CPU)
    assert isinstance(s1, StreamSource) and s1.global_batch == 4
    s2 = make_source("synthetic", n_workers=1, per_worker=2, vocab_size=17,
                     seq_len=4, **CPU)
    assert isinstance(s2, SyntheticSource)
    with pytest.raises(KeyError):
        make_source("nope", n_workers=1, per_worker=1)


def test_costed_source_adds_its_delay():
    inner = make_source("linreg", n_workers=2, per_worker=3, dim=4, **CPU)
    src = CostedSource(inner, 0.15)
    assert (src.n_workers, src.per_worker) == (2, 3)
    t0 = time.perf_counter()
    got = src.batch(1)
    assert time.perf_counter() - t0 >= 0.15
    torch.testing.assert_close(got, inner.batch(1), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

class _CountingSource(InputSource):
    n_workers, per_worker = 1, 1

    def __init__(self):
        self.built = []

    def batch(self, epoch):
        self.built.append(epoch)
        return {"e": torch.tensor([epoch])}


def test_prefetcher_yields_epochs_in_order_and_stops():
    pf = Prefetcher(_CountingSource(), steps=5, start_epoch=3)
    assert [int(b["e"][0]) for b in pf] == [3, 4, 5, 6, 7]
    pf.close()
    pf.close()                              # idempotent


def test_prefetcher_equals_the_synchronous_batches():
    src = make_source("lm", n_workers=2, per_worker=2, vocab_size=50,
                      seq_len=6, seed=2, **CPU)
    pf = Prefetcher(src, depth=2, start_epoch=4, steps=3, device="cpu")
    got = list(pf)
    pf.close()
    assert len(got) == 3
    for e, b in zip(range(4, 7), got):
        torch.testing.assert_close(b, src.batch(e), rtol=0, atol=0)


def test_prefetcher_backpressure_bounds_lead():
    """The thread builds at most depth + 1 epochs ahead of the consumer
    (depth parked in the queue, one in the blocked put)."""
    src = _CountingSource()
    pf = Prefetcher(src, steps=10, depth=2)
    consumed = max_lead = 0
    for _ in pf:
        consumed += 1
        time.sleep(0.02)
        max_lead = max(max_lead, len(src.built) - consumed)
    pf.close()
    assert consumed == 10 and max_lead <= 3, max_lead


def test_prefetcher_propagates_source_errors():
    class Boom(InputSource):
        def batch(self, epoch):
            if epoch == 2:
                raise RuntimeError("bad shard")
            return {"e": torch.tensor([epoch])}

    pf = Prefetcher(Boom(), steps=5)
    assert [int(next(pf)["e"][0]) for _ in range(2)] == [0, 1]
    with pytest.raises(RuntimeError, match="bad shard"):
        next(pf)
    pf.close()


def test_prefetcher_close_stops_the_thread():
    pf = Prefetcher(_CountingSource(), steps=100, depth=1)
    next(pf)
    pf.close()                              # the thread was mid-put
    assert not pf._thread.is_alive()
    assert not any(t.name == "amb-prefetcher" and t is pf._thread
                   for t in threading.enumerate())
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(ValueError):
        Prefetcher(_CountingSource(), depth=0)


def test_streams_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    for stream in (LinRegStream(dim=3), LogRegStream(),
                   LMTokenStream(17, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream.batch(0, 0, 2)


@pytest.mark.gpu
def test_lm_stream_on_the_card_equals_the_cpu():
    """The hashes are integer ops: the card's tokens (a CUDA graph's
    replay) are the CPU's (the eager walk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = LMTokenStream(4096, 16, seed=1, device="cuda").batch(2, 3, 4)
    b = LMTokenStream(4096, 16, seed=1, **CPU).batch(2, 3, 4)
    assert torch.equal(a["tokens"].cpu(), b["tokens"])
