"""Averaging consensus over a communication graph (paper §3, Lemma 1).

Counterpart of ``repro.core.consensus``: graph constructors (ring,
torus, complete, star, Erdos-Renyi and the paper's 10-node graph),
Metropolis weights, the spectral gap and Lemma 1's round count in numpy
(shared by every device); dense gossip, the exact average and the
consensus error in torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------


def ring_graph(n: int) -> np.ndarray:
    """Adjacency of an n-cycle."""
    if n < 2:
        raise ValueError("ring needs n >= 2")
    a = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = True
    a[(idx + 1) % n, idx] = True
    return a


def torus_graph(rows: int, cols: int) -> np.ndarray:
    """Adjacency of a rows x cols 2-D torus."""
    n = rows * cols
    a = np.zeros((n, n), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for (dr, dc) in ((0, 1), (1, 0)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if i != j:
                    a[i, j] = a[j, i] = True
    return a


def complete_graph(n: int) -> np.ndarray:
    a = np.ones((n, n), dtype=bool)
    np.fill_diagonal(a, False)
    return a


def star_graph(n: int) -> np.ndarray:
    """Hub-and-spoke: node 0 is the master (paper App. A)."""
    a = np.zeros((n, n), dtype=bool)
    a[0, 1:] = True
    a[1:, 0] = True
    return a


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> np.ndarray:
    """Connected Erdos-Renyi graph (retries until connected)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        u = rng.random((n, n))
        a = np.triu(u < p, k=1)
        a = a | a.T
        if is_connected(a):
            return a
    raise RuntimeError("could not sample a connected G(n,p); raise p")


PAPER_GRAPH_LAZY = 0.3


def paper_graph() -> np.ndarray:
    """The 10-node ring plus chords (0,4), (2,6): lazy-0.3 Metropolis
    weights give the paper's lambda_2 = 0.888 (App. I.1)."""
    a = ring_graph(10)
    for (i, j) in ((0, 4), (2, 6)):
        a[i, j] = a[j, i] = True
    return a


def is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


def default_torus(n: int) -> tuple:
    """The most-square (rows, cols) factorisation of n."""
    rows = int(np.sqrt(n))
    while n % rows:
        rows -= 1
    return rows, n // rows


def build_graph(name: str, n: int, **kw) -> np.ndarray:
    """By name: ``ring``, ``torus`` (``rows=``), ``complete``, ``star``,
    ``paper`` (n = 10) or ``erdos_renyi`` (``p=`` 0.4, ``seed=`` 0)."""
    if name == "ring":
        return ring_graph(n)
    if name == "torus":
        rows = kw.get("rows")
        rows = rows if rows is not None else default_torus(n)[0]
        return torus_graph(rows, n // rows)
    if name == "erdos_renyi":
        return erdos_renyi_graph(n, kw.get("p", 0.4), kw.get("seed", 0))
    if name == "complete":
        return complete_graph(n)
    if name == "star":
        return star_graph(n)
    if name == "paper":
        if n != 10:
            raise ValueError("paper graph is 10 nodes")
        return paper_graph()
    raise ValueError(f"unknown graph {name!r}")


def metropolis_weights(adj: np.ndarray, lazy: float = 0.5) -> np.ndarray:
    """Lazy Metropolis-Hastings weights: P_ij = 1/(1 + max(deg_i, deg_j))
    on edges, the diagonal soaks the rest, mixed with ``lazy`` * I (PSD)."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    deg = adj.sum(1)
    p = np.zeros((n, n), dtype=np.float64)
    ii, jj = np.nonzero(adj)
    p[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    np.fill_diagonal(p, 0.0)
    np.fill_diagonal(p, 1.0 - p.sum(1))
    if lazy > 0.0:
        p = lazy * np.eye(n) + (1.0 - lazy) * p
    return p


def lambda2(p: np.ndarray) -> float:
    """Second-largest eigenvalue magnitude of a symmetric stochastic matrix."""
    ev = np.linalg.eigvalsh(p)
    return float(np.sort(np.abs(ev))[-2])


def spectral_gap(p: np.ndarray) -> float:
    return 1.0 - lambda2(p)


def lemma1_rounds(n: int, lip_l: float, eps: float, p: np.ndarray) -> int:
    """Paper Lemma 1: rounds needed for additive consensus accuracy eps."""
    if eps <= 0:
        raise ValueError("eps must be positive")
    gap = spectral_gap(p)
    return int(np.ceil(np.log(2.0 * np.sqrt(n) * (1.0 + 2.0 * lip_l / eps))
                       / gap))


# ---------------------------------------------------------------------------
# Gossip execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConsensusSpec:
    """Static description of the consensus phase: a doubly-stochastic
    (n, n) ``p`` and the maximum round count."""

    p: np.ndarray
    rounds: int

    def __post_init__(self):
        p = np.asarray(self.p)
        if not np.allclose(p.sum(0), 1.0, atol=1e-8) or not np.allclose(
                p.sum(1), 1.0, atol=1e-8):
            raise ValueError("P must be doubly stochastic")
        if (p < -1e-12).any():
            raise ValueError("P must be non-negative")


def gossip(messages: torch.Tensor, p, rounds: int) -> torch.Tensor:
    """``rounds`` synchronous rounds of ``m <- P m`` over dim 0 of (n, ...)."""
    p = torch.as_tensor(p, dtype=messages.dtype, device=messages.device)
    flat = messages.reshape(messages.shape[0], -1)
    for _ in range(rounds):
        flat = p @ flat
    return flat.reshape(messages.shape)


def exact_average(messages: torch.Tensor) -> torch.Tensor:
    """The r -> infinity limit: every node holds the global mean."""
    return messages.mean(dim=0, keepdim=True).expand_as(messages)


def consensus_error(messages: torch.Tensor) -> torch.Tensor:
    """max_i ||m_i - mean||: the epsilon of Lemma 1 for these messages."""
    flat = messages.reshape(messages.shape[0], -1)
    mean = flat.mean(dim=0, keepdim=True)
    return torch.linalg.vector_norm(flat - mean, dim=-1).max()
