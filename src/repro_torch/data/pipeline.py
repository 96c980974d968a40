"""Streaming synthetic data sources (the paper's workloads are online).

Counterpart of ``repro.data.pipeline``.  Every stream is deterministic in
(seed, node, epoch): node i's samples of epoch t are the same however many
samples the other nodes took (i.i.d. from Q, paper §3).  Streams generate
on their ``device`` when asked; nothing is built up front.

  * :class:`LinRegStream` — §6.1: x ~ N(0, I_d), y = x.w* + N(0, 1e-3).
  * :class:`LogRegStream` — §6.2 stand-in: a 10-class Gaussian mixture in
    784 dims ("MNIST-like").
  * :class:`LMTokenStream` — token sequences from an order-1 Markov chain
    with a planted block structure, for the LM.

The regression streams draw from a ``torch.Generator`` seeded from (seed,
node, epoch).  The token stream has no transition matrix: JAX's is a
vocab x vocab fp32 tensor, 92 GB at qwen2-1.5b's vocab of 151,936.  The
logits row of token ``tok`` is a pure function of (seed, tok) computed on
demand from a counter-based hash, for the current tokens of the batch at
once, and the next token is a Gumbel-max draw from hashed uniforms keyed
by (seed, node, epoch, sequence, step).  Its planted structure is JAX's;
its draws are not.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

import torch

from ..device import resolve_device

_M32 = 0xFFFFFFFF
# stream tags, so the hashes of different uses never share a key
_TAG_SEED, _TAG_LOGITS, _TAG_FIRST, _TAG_STEP = 0x5EED, 0x70CE, 0xF125, 0x57E9


def _mix32(x):
    """A 32-bit avalanche mix (xor-shift-multiply, lowbias32's shifts) on
    Python ints or int64 tensors holding values in [0, 2^32).  Both
    multipliers are below 2^31, so no product reaches 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _key(*parts: int) -> int:
    """Hash a sequence of Python ints into one 32-bit key."""
    h = 0x9E3779B9
    for p in parts:
        h = _mix32(h ^ (int(p) & _M32))
    return h


def _seed(*parts: int) -> int:
    """A ``torch.Generator`` seed (63 bits) from a sequence of ints."""
    hi = _key(_TAG_SEED, *parts)
    return (hi << 31) | (_key(hi, *parts) >> 1)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """U(0, 1) from the top 24 bits of 32-bit hashes, never 0 or 1."""
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@dataclasses.dataclass(frozen=True)
class LinRegStream:
    dim: int
    seed: int = 0
    noise_var: float = 1e-3
    device: str = "cuda"

    def w_star(self) -> torch.Tensor:
        dev = resolve_device(self.device)
        return torch.randn((self.dim,), generator=_generator(
            dev, self.seed ^ 0x5757), dtype=torch.float32, device=dev)

    def batch(self, node: int, epoch: int, size: int,
              w_star: Optional[torch.Tensor] = None) -> tuple:
        dev = resolve_device(self.device)
        gen = _generator(dev, _seed(self.seed, node, epoch))
        x = torch.randn((size, self.dim), generator=gen, dtype=torch.float32,
                        device=dev)
        noise = torch.randn((size,), generator=gen, dtype=torch.float32,
                            device=dev)
        ws = self.w_star() if w_star is None else w_star
        return x, x @ ws + math.sqrt(self.noise_var) * noise


@dataclasses.dataclass(frozen=True)
class LogRegStream:
    dim: int = 784
    num_classes: int = 10
    seed: int = 0
    spread: float = 2.0
    device: str = "cuda"

    def class_means(self) -> torch.Tensor:
        dev = resolve_device(self.device)
        return self.spread * torch.randn(
            (self.num_classes, self.dim),
            generator=_generator(dev, self.seed ^ 0xC1A5),
            dtype=torch.float32, device=dev) / math.sqrt(self.dim)

    def batch(self, node: int, epoch: int, size: int) -> tuple:
        dev = resolve_device(self.device)
        gen = _generator(dev, _seed(self.seed, node, epoch))
        y = torch.randint(0, self.num_classes, (size,), generator=gen,
                          device=dev)
        x = self.class_means()[y] + torch.randn(
            (size, self.dim), generator=gen, dtype=torch.float32, device=dev)
        return x, y


@dataclasses.dataclass(frozen=True)
class LMTokenStream:
    """Synthetic token grammar: an order-1 Markov chain whose transition
    logits are ``0.5 N(0, 1)`` noise plus 2.0 on the current token's own
    block of ``vocab_size // num_blocks`` tokens (learnable, non-trivial
    entropy), as in JAX; rows are hashed on demand (module docstring)."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    num_blocks: int = 16
    device: str = "cuda"

    def __post_init__(self):
        # rows -> (graph, static inputs, static output), see _graphed_walk
        object.__setattr__(self, "_graphs", {})
        object.__setattr__(self, "_graph_lock", threading.Lock())

    @property
    def block(self) -> int:
        return self.vocab_size // self.num_blocks or 1

    def _tables(self, device) -> tuple:
        """(the logits rows' keys by token, the column keys, the columns'
        blocks), each (V,)."""
        cols = torch.arange(self.vocab_size, device=device)
        return (_mix32(_key(_TAG_LOGITS, self.seed) ^ cols), _mix32(cols),
                cols // self.block)

    def transition_logits(self, tokens: torch.Tensor,
                          tables: Optional[tuple] = None) -> torch.Tensor:
        """(size, V) fp32 logits rows of ``tokens`` (size,)."""
        row_keys, col_keys, col_block = tables if tables is not None \
            else self._tables(tokens.device)
        u = _uniform(_mix32(row_keys[tokens][:, None] ^ col_keys))
        same = (tokens // self.block)[:, None] == col_block
        return 0.5 * torch.special.ndtri(u) + 2.0 * same

    def batch(self, node: int, epoch: int, size: int) -> dict:
        return self.batch_nodes((node,), epoch, size)

    def batch_nodes(self, nodes, epoch: int, size: int) -> dict:
        """The batches of several nodes, concatenated in node order, built
        together: the same tokens as one :meth:`batch` call per node, in a
        quarter of the launches for four nodes.  On the card the walk is
        one CUDA graph replay (:meth:`_graphed_walk`)."""
        dev = resolve_device(self.device)
        seqs = torch.arange(size, device=dev)

        def per_row(tag):
            return torch.cat([_mix32(_key(tag, self.seed, node, epoch) ^ seqs)
                              for node in nodes])

        first = per_row(_TAG_FIRST) % self.vocab_size
        step_keys = _mix32(per_row(_TAG_STEP)[:, None]
                           ^ torch.arange(self.seq_len, device=dev))
        toks = self._graphed_walk(first, step_keys) if dev.type == "cuda" \
            else self._walk(first, step_keys)
        labels = torch.cat([toks[:, 1:], torch.full(
            (toks.shape[0], 1), -1, dtype=toks.dtype, device=dev)], dim=1)
        return {"tokens": toks, "labels": labels}

    def _walk(self, tok: torch.Tensor, step_keys: torch.Tensor):
        """(rows, S) tokens from the first tokens (rows,) and the Gumbel
        draws' per-(sequence, step) keys (rows, S): one Gumbel-max draw
        over the current tokens' logits rows a step."""
        tables = self._tables(tok.device)
        toks = [tok]
        for step in range(1, self.seq_len):
            u = _uniform(_mix32(step_keys[:, step, None] ^ tables[1]))
            tok = torch.argmax(self.transition_logits(tok, tables)
                               - torch.log(-torch.log(u)), dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def _graphed_walk(self, first: torch.Tensor,
                      step_keys: torch.Tensor) -> torch.Tensor:
        """:meth:`_walk` on the card as a CUDA graph, captured on first
        use for each row count and replayed on the current stream.

        The walk is dozens of small launches a step; from the
        prefetcher's thread those launches contend with the training
        step's for the host, and one replay removes them.  The capture is
        thread-local, so other threads keep launching meanwhile, and it
        calls ``capture_begin`` itself: ``torch.cuda.graph`` would also
        synchronise the device and empty the allocator's cache under the
        training step.
        """
        rows = first.shape[0]
        with self._graph_lock:
            if rows not in self._graphs:
                static = (first.clone(), step_keys.clone())
                side = torch.cuda.Stream(first.device)
                side.wait_stream(torch.cuda.current_stream(first.device))
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(side):
                    self._walk(*static)         # load the kernels first
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = self._walk(*static)
                    finally:
                        graph.capture_end()
                self._graphs[rows] = (graph, static, out)
            graph, (s_first, s_keys), out = self._graphs[rows]
            s_first.copy_(first)
            s_keys.copy_(step_keys)
            graph.replay()
            return out.clone()


def make_stream(kind: str, **kw):
    return {"linreg": LinRegStream, "logreg": LogRegStream,
            "lm": LMTokenStream}[kind](**kw)


def shard_batch(batch, mesh, batch_axes=("data",)):
    """JAX's deprecated alias for :func:`repro_torch.data.loader.
    put_batch`."""
    from .loader import put_batch
    return put_batch(batch, mesh, batch_axes)
