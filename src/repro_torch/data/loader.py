"""The session's data plane: input sources and a background prefetcher
(counterpart of ``repro.data.loader``).

A source's ``batch(epoch)`` returns the epoch's over-provisioned global
batch: ``n_workers * per_worker`` samples in worker-contiguous blocks;
b_i(t) is decided only at step time, and the eq.-3 weights pick each
worker's first b_i(t) samples, so variable minibatches cost the data plane
nothing.

  * :class:`StreamSource` — per-worker shards of a deterministic stream
    (:mod:`repro_torch.data.pipeline`): worker i draws stream node i, or
    under coded placement its group's node, rotated.  With ``rank`` it
    builds only that worker's shard (one process per worker).
  * :func:`local_rows` — a worker's rows of a global batch (the
    counterpart of JAX's ``put_batch`` onto the worker axes).
  * :class:`SyntheticSource` — uniform random tokens drawn on the device.
  * :class:`CostedSource` — a source with a fixed host cost per batch.
  * :class:`Prefetcher` — a daemon thread that builds the next ``depth``
    batches ahead of the consumer.  On the card it builds on a side CUDA
    stream and hands each batch over with an event that the consumer's
    stream waits on, so epoch t's step overlaps epoch t+1's build.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Optional

import torch

from ..device import resolve_device


def _tree_map(fn, *trees):
    """Map over the leaves of dicts and tuples of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def local_rows(batch, rank: int, n: int):
    """Worker ``rank``'s block, rows ``[rank*per, (rank+1)*per)``, of every
    leaf of a global batch of ``n`` worker blocks."""
    def rows(x):
        per = x.shape[0] // n
        return x[rank * per:(rank + 1) * per]
    return _tree_map(rows, batch)


class InputSource:
    """Contract: ``batch(epoch)`` is deterministic in ``epoch`` and safe to
    call from a background thread."""

    n_workers: int = 1
    per_worker: int = 1

    @property
    def global_batch(self) -> int:
        return self.n_workers * self.per_worker

    def batch(self, epoch: int):
        raise NotImplementedError


class StreamSource(InputSource):
    """Per-worker shards of one deterministic stream.

    Worker i's block is ``stream.batch(node=i, epoch, per_worker)``, the
    blocks concatenated in worker order: distinct node indices give each
    worker its own i.i.d. shard (paper §3).

    An ``assignment`` (:class:`repro_torch.dist.redundancy.
    CodedAssignment`) with ``rho > 1`` is coded placement: each group of
    ``rho`` workers shares one block, drawn from the group's stream node,
    and member m's shard is that block rolled by ``-shift_m`` along the
    batch axis, so its slot s holds block slot ``(s + shift_m) % per``,
    the index map of the decode weights.  A stream with ``batch_nodes``
    builds the n / rho group blocks in one go.

    ``rank`` (one process per worker, uncoded) makes ``batch(epoch)`` the
    rank's block alone, built from its node only: rows ``[rank*per,
    (rank+1)*per)`` of the global batch, as :func:`local_rows` cuts them.
    """

    def __init__(self, stream, n_workers: int, per_worker: int,
                 assignment=None, rank: Optional[int] = None):
        self.stream = stream
        self.n_workers = int(n_workers)
        self.per_worker = int(per_worker)
        self.assignment = assignment
        self.rank = rank
        if assignment is not None and assignment.n != self.n_workers:
            raise ValueError(f"assignment covers {assignment.n} workers, "
                             f"source has {self.n_workers}")
        if rank is not None and assignment is not None \
                and assignment.rho > 1:
            raise ValueError("a rank's own shard under coded placement is "
                             "not ported yet (ROADMAP.md, module item 4b)")

    def _blocks(self, nodes, epoch: int) -> list:
        """One ``per_worker`` block per node, in node order."""
        per = self.per_worker
        if hasattr(self.stream, "batch_nodes"):     # all blocks in one go
            built = self.stream.batch_nodes(nodes, epoch, per)
            return [_tree_map(lambda x, j=j: x[j * per:(j + 1) * per],
                              built) for j in range(len(nodes))]
        return [self.stream.batch(i, epoch, per) for i in nodes]

    def batch(self, epoch: int):
        if self.rank is not None:
            return self._blocks([self.rank], epoch)[0]
        a = self.assignment
        if a is None or a.rho <= 1:
            nodes = range(self.n_workers)
            if hasattr(self.stream, "batch_nodes"):
                return self.stream.batch_nodes(nodes, epoch, self.per_worker)
            shards = self._blocks(nodes, epoch)
        else:
            blocks = self._blocks(range(a.groups), epoch)
            data_nodes = a.data_nodes()
            shifts = a.shifts(self.per_worker)
            shards = [_tree_map(
                lambda x, s=int(shifts[i]): torch.roll(x, -s, dims=0),
                blocks[int(data_nodes[i])]) for i in range(self.n_workers)]
        return _tree_map(lambda *xs: torch.cat(xs, dim=0), *shards)


class SyntheticSource(InputSource):
    """Uniform random tokens drawn on the device (LM batches).

    Epoch e draws from a ``torch.Generator`` on ``device`` seeded from
    ``(seed, e)``; labels are the tokens shifted left, the last one masked
    (-1).  The entry point runs on the card unless ``device`` says
    otherwise, and raises if there is no card.
    """

    def __init__(self, vocab_size: int, seq_len: int, n_workers: int,
                 per_worker: int, seed: int = 0, device="cuda"):
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.n_workers = int(n_workers)
        self.per_worker = int(per_worker)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def batch(self, epoch: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 1_000_003 + int(epoch))
        gb = self.global_batch
        toks = torch.randint(0, self.vocab_size, (gb, self.seq_len),
                             generator=gen, device=self.device)
        labels = torch.cat([toks[:, 1:], torch.full(
            (gb, 1), -1, dtype=toks.dtype, device=self.device)], dim=1)
        return {"tokens": toks, "labels": labels}


def _wait_built(batch) -> None:
    """Block until the batch's device work is done (the build itself, not
    just its launch)."""
    for dev in {x.device for x in _leaves(batch)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


class CostedSource(InputSource):
    """A source with a fixed host cost per batch (benchmarks, tests):
    ``cost_s`` seconds of ``time.sleep`` after the build model an I/O-bound
    input path.  Sleeping releases the GIL, so a prefetcher overlaps it
    with the step."""

    def __init__(self, inner: InputSource, cost_s: float):
        self.inner = inner
        self.cost_s = float(cost_s)
        self.n_workers = inner.n_workers
        self.per_worker = inner.per_worker

    def batch(self, epoch: int):
        b = self.inner.batch(epoch)
        _wait_built(b)
        if self.cost_s > 0.0:
            time.sleep(self.cost_s)
        return b


def make_source(kind: str, *, n_workers: int, per_worker: int,
                **kw) -> InputSource:
    """``lm`` / ``linreg`` / ``logreg`` stream shards, or the on-device
    ``synthetic`` source."""
    if kind == "synthetic":
        return SyntheticSource(n_workers=n_workers, per_worker=per_worker,
                               **kw)
    from .pipeline import make_stream
    return StreamSource(make_stream(kind, **kw), n_workers, per_worker)


class Prefetcher:
    """Background feeder: builds batches ``depth`` epochs ahead.

    A daemon thread walks epochs from ``start_epoch`` (``steps`` of them,
    or without end), calls ``source.batch(epoch)`` and parks the result in
    a queue of ``depth`` slots; the bounded queue is the backpressure.  On
    a CUDA ``device`` the thread builds on its own stream, records an
    event after each batch and waits for it before parking the batch;
    ``next`` makes the consumer's current stream wait on that event and
    marks the batch's tensors as used there.
    Iterate to consume, ``close()`` when done (it also stops a thread
    blocked on a full queue).  A source's exception is raised in the
    consumer by the ``next`` that would have returned its batch.
    """

    _STOP = object()

    def __init__(self, source: InputSource, *, depth: int = 2,
                 start_epoch: int = 0, steps: Optional[int] = None,
                 device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.depth = int(depth)
        self.device = None if device is None else torch.device(device)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device is not None
                      and self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._epochs = itertools.count(start_epoch) if steps is None \
            else iter(range(start_epoch, start_epoch + steps))
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="amb-prefetcher")
        self._thread.start()

    def _enqueue(self, item) -> None:
        """Park an item; a full queue is polled so ``close()`` always
        gets through."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _build(self, epoch: int):
        if self._side is None:
            return self.source.batch(epoch), None
        with torch.cuda.stream(self._side):
            batch = self.source.batch(epoch)
            ready = torch.cuda.Event()
            ready.record(self._side)
        # a build may only be queued on the card when the call returns (a
        # graph replay): wait for it, so that a parked batch is a built one
        # and at most one build runs beside the consumer's step
        ready.synchronize()
        return batch, ready

    def _fill(self) -> None:
        try:
            for epoch in self._epochs:
                if self._stop.is_set():
                    return
                self._enqueue((epoch, self._build(epoch)))
        except BaseException as e:                  # raised in next()
            self._enqueue((None, e))
            return
        self._enqueue((None, self._STOP))

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        epoch, item = self._q.get()
        if epoch is None:
            if item is self._STOP:
                raise StopIteration
            raise item
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for x in _leaves(batch):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    x.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the thread and drop any parked batches (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
