"""Consensus strategies on the per-worker message stack (paper §3).

Counterpart of ``repro.dist.consensus`` for the exact and fp32 gossip
strategies.  The worker dim is the leading dim of one tensor on one device.
A ring or torus gossip round decomposes into K neighbour taps (``Taps``):
on the TPU mesh each tap is a roll (a collective permute) and the rolled
copies are combined by a Pallas kernel; here the (K, n) table of source
rows (:meth:`Taps.source_rows`) drives one CUDA kernel that reads the
neighbour rows in place (:func:`repro_torch.kernels.ops.gossip_combine`).
Graphs that do not decompose fall back to the dense ``P @ m``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import consensus as cns
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class Taps:
    """``(P @ m)[i] = sum_k weights[k] * m[i + offsets[k]]`` over Z_shape.

    ``shape`` is the cyclic-group factorisation of the worker index:
    ``(n,)`` for a ring, ``(rows, cols)`` for a torus.
    """

    offsets: tuple            # tuple of int tuples, one per tap
    weights: np.ndarray       # (K,) float32, self tap first
    shape: tuple              # cyclic-group shape, prod(shape) == n

    @property
    def k(self) -> int:
        return len(self.offsets)

    def take(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The i-th tap's neighbour view: ``out[r] = x[r + offsets[i]]``."""
        return roll_by_offset(x, self, self.offsets[i])

    def source_rows(self) -> np.ndarray:
        """(K, n) int32: row ``r`` of tap k reads row ``src[k, r]``."""
        idx = torch.arange(int(np.prod(self.shape)))
        return np.stack([self.take(idx, i).numpy()
                         for i in range(self.k)]).astype(np.int32)


def group_taps(p: np.ndarray, shape: Sequence[int]) -> Optional[Taps]:
    """Decompose a group-circulant P into neighbour taps, or None.

    Valid iff ``P[i, j]`` depends only on ``coord(j) - coord(i)`` mod
    ``shape`` (Metropolis weights on a ring or torus).  Checked by
    rebuilding P; None on mismatch, so callers fall back to dense P @ m.
    """
    shape = tuple(int(s) for s in shape)
    n = p.shape[0]
    if int(np.prod(shape)) != n:
        return None
    offsets, weights = [], []
    for j in range(n):
        if p[0, j] != 0.0:
            offsets.append(np.unravel_index(j, shape))
            weights.append(float(p[0, j]))
    order = sorted(range(len(offsets)),
                   key=lambda i: (any(offsets[i]), offsets[i]))
    offsets = [offsets[i] for i in order]
    weights = [weights[i] for i in order]
    rebuilt = np.zeros_like(p)
    coords = np.stack(np.unravel_index(np.arange(n), shape), axis=1)
    for off, w in zip(offsets, weights):
        dest = np.ravel_multi_index(
            tuple((coords[:, a] + off[a]) % shape[a]
                  for a in range(len(shape))), shape)
        rebuilt[np.arange(n), dest] += w
    if not np.allclose(rebuilt, p, atol=1e-12):
        return None
    return Taps(offsets=tuple(tuple(int(o) for o in off) for off in offsets),
                weights=np.asarray(weights, np.float32), shape=shape)


def roll_by_offset(x: torch.Tensor, taps: Taps, off) -> torch.Tensor:
    """``out[i] = x[i + off]`` over the taps' cyclic group (one tap)."""
    full = x.reshape(taps.shape + tuple(x.shape[1:]))
    dims = tuple(range(len(taps.shape)))
    return torch.roll(full, tuple(-o for o in off), dims).reshape(x.shape)


class ConsensusStrategy:
    """Operator on the per-worker message stack: (n, D) -> (n, D)."""

    name: str = "base"

    def combine(self, msg: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ExactConsensus(ConsensusStrategy):
    """eps = 0: every worker holds the global mean."""

    n: int
    name: str = dataclasses.field(default="exact", init=False)

    def combine(self, msg):
        return cns.exact_average(msg.float())


class GossipConsensus(ConsensusStrategy):
    """r rounds of lazy-Metropolis gossip; tap-decomposed where possible.

    Numerically the same operator as ``repro.core.consensus.gossip(m, P,
    rounds)``; each ring/torus round is one
    :func:`repro_torch.kernels.ops.gossip_combine` launch.
    """

    name = "gossip"

    def __init__(self, n: int, rounds: int, graph: str = "ring",
                 lazy: float = 0.5, torus_shape: Optional[tuple] = None):
        self.n, self.rounds, self.graph = int(n), int(rounds), graph
        self.lazy = float(lazy)
        self._src: dict = {}         # device -> (K, n) int32 source rows
        if self.n < 2:
            self.p, self.taps = np.ones((1, 1)), None
            return
        if graph == "torus":
            rows, cols = torus_shape or cns.default_torus(self.n)
            if rows * cols != self.n:
                raise ValueError(f"torus {rows}x{cols} != {self.n} workers")
            adj, shape = cns.torus_graph(rows, cols), (rows, cols)
        else:
            adj, shape = cns.build_graph(graph, self.n), (self.n,)
        self.p = cns.metropolis_weights(adj, lazy=self.lazy)
        self.taps = group_taps(self.p, shape)

    def source_rows(self, device) -> torch.Tensor:
        """The taps' (K, n) source-row table on ``device`` (built once)."""
        device = torch.device(device)
        if device not in self._src:
            self._src[device] = torch.as_tensor(self.taps.source_rows(),
                                                device=device)
        return self._src[device]

    def combine(self, msg):
        """r rounds on the stack.  On the tap path an fp32 ``msg`` is one of
        the two round buffers and is overwritten, so two (n, D) stacks are
        live however many rounds run."""
        m = msg.float()
        if self.n < 2 or self.rounds < 1:
            return m
        if self.taps is None:        # dense fallback (non-circulant graph)
            return cns.gossip(m, self.p, self.rounds)
        src = self.source_rows(m.device)
        spare = torch.empty_like(m)
        for _ in range(self.rounds):
            m, spare = kops.gossip_combine(m, src, self.taps.weights,
                                           out=spare), m
        return m


CONSENSUS_CHOICES = ("exact", "gossip")


def make_strategy(name: str, n: int, *, rounds: int = 5, graph: str = "ring",
                  lazy: float = 0.5,
                  torus_shape: Optional[tuple] = None) -> ConsensusStrategy:
    """Build a strategy by name (the quantized ones are not ported yet)."""
    if name == "exact":
        return ExactConsensus(n)
    if name == "gossip":
        return GossipConsensus(n, rounds, graph, lazy, torus_shape)
    raise ValueError(f"unknown consensus strategy {name!r}; "
                     f"choose from {CONSENSUS_CHOICES}")
