"""Consensus strategies on the per-worker message stack (paper §3).

Counterpart of ``repro.dist.consensus`` for the exact, fp32 gossip and
quantized gossip strategies.  The worker dim is the leading dim of one
tensor on one device.  A ring or torus gossip round decomposes into K
neighbour taps (``Taps``): on the TPU mesh each tap is a roll (a
collective permute) and the rolled copies are combined by a Pallas kernel;
here the (K, n) table of source rows (:meth:`Taps.source_rows`) drives
CUDA kernels that read the neighbour rows in place
(:func:`repro_torch.kernels.ops.gossip_combine`, and for quantized gossip
:func:`~repro_torch.kernels.ops.stochastic_quantize` with
:func:`~repro_torch.kernels.ops.quantized_combine`).  Graphs that do not
decompose fall back to the dense operators.

Elastic membership: an ``active`` mask re-lays the survivors of a ring or
torus onto a fresh ring or torus (:func:`survivor_taps`), whose (K, n)
table names only survivor rows and so drives the same kernels; inactive
rows end equal to the epoch's input rows.  One survivor is the identity;
other graphs, or ``relayout=False``, take the dense
:func:`masked_metropolis` operator.

One process per worker (:class:`repro_torch.dist.group.WorkerGroup`):
each rank holds only its own row.  :meth:`ConsensusStrategy.rank_buffer`
gives the (K, D) buffer whose row 0 the step packs, and
:meth:`ConsensusStrategy.combine_rank` runs the rounds: each round the
rank sends its row to the ranks the taps name and receives the K - 1 rows
it reads, in tap order, and one ``gossip_combine`` launch on a (K, 1)
table writes its row, bit for bit the stacked round's row.  The dense
fallback all-gathers the rows; exact consensus is an all-reduce mean.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import consensus as cns
from ..core.extensions import gossip_quantized
from ..kernels import ops as kops
from ..kernels.gossip_combine import own_row_table
from ..launch.mesh import axis_names, mesh_shape

# what one process per worker does not run yet (ROADMAP.md, module item 4b)
OVER_GROUP_TODO = "ROADMAP.md, module item 4b"


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


def masked_metropolis(adj: np.ndarray, active, lazy: float) -> np.ndarray:
    """Metropolis weights on the subgraph induced by the ``active`` mask.

    Edges touching an inactive worker go, the degrees are re-derived on
    the induced subgraph, and inactive workers become identity rows (their
    stale dual survives until they rejoin).  The active subgraph must stay
    connected: a partitioned fleet cannot reach consensus.  This is the
    dense membership operator (``P @ m`` per round), the fallback for
    non-circulant graphs and for ``relayout=False``.
    """
    active = np.asarray(active, dtype=bool)
    adj = np.asarray(adj, dtype=bool) & active[None, :] & active[:, None]
    n_act = int(active.sum())
    if n_act >= 2 and not cns.is_connected(adj[np.ix_(active, active)]):
        raise ValueError("active worker subgraph is disconnected; "
                         "consensus cannot mix across the partition")
    return cns.metropolis_weights(adj, lazy=lazy)


def roll_by_offset(x: torch.Tensor, taps: Taps, off) -> torch.Tensor:
    """``out[i] = x[i + off]`` over the taps' cyclic group (one tap)."""
    full = x.reshape(taps.shape + tuple(x.shape[1:]))
    dims = tuple(range(len(taps.shape)))
    return torch.roll(full, tuple(-o for o in off), dims).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class SurvivorTaps:
    """Tap decomposition of a survivor-relayout gossip operator.

    The ``n_act`` survivors (by physical index) are re-enumerated as ranks
    of a fresh ring or torus over ``Z_{n_act}``, whose operator is
    circulant again.  Rank r's tap-i neighbour sits ``delta = p_{r+o_i} -
    p_r (mod n)`` physical rows away.  ``offsets`` / ``weights`` /
    ``shape`` describe the small operator on survivor ranks (self tap
    first); ``hops[i]`` realises tap i as ``(delta, (n,) bool mask)`` pairs
    with disjoint masks; ``active`` is the membership mask, ``n`` the
    fleet size.  Inactive rows are identity rows: the strategies put the
    epoch's input rows back after the combine.
    """

    offsets: tuple            # survivor-rank offsets, self tap first
    weights: np.ndarray       # (K,) float32
    shape: tuple              # survivor group shape, prod == n_act
    hops: tuple               # per tap: ((delta, (n,) bool mask), ...)
    active: np.ndarray        # (n,) bool membership mask
    n: int                    # full fleet size

    @property
    def k(self) -> int:
        return len(self.offsets)

    def source_rows(self) -> np.ndarray:
        """(K, n) int32: active row p of tap k reads row ``src[k, p]``, a
        survivor; an inactive row names itself in every tap (its result is
        replaced by its input row after the rounds)."""
        src = np.tile(np.arange(self.n, dtype=np.int32), (self.k, 1))
        for i, hop in enumerate(self.hops):
            for delta, mask in hop:
                rows = np.nonzero(mask)[0]
                src[i, rows] = (rows + delta) % self.n
        return src

    def dense(self) -> np.ndarray:
        """The (n, n) operator this realises: the relayout P on the
        survivor block, identity rows elsewhere."""
        p = np.zeros((self.n, self.n))
        idx = np.arange(self.n)
        for w, hop in zip(self.weights, self.hops):
            for delta, mask in hop:
                rows = idx[mask]
                p[rows, (rows + delta) % self.n] += float(w)
        inact = ~np.asarray(self.active, bool)
        p[inact, idx[inact]] = 1.0
        return p


def survivor_taps(active, graph: str = "ring",
                  lazy: float = 0.5) -> Optional[SurvivorTaps]:
    """Relayout the active set onto a fresh ring or torus; None if the tap
    form is unavailable (fewer than 2 survivors, another graph, or a
    non-circulant relayout).

    A torus fleet whose survivor count factors into a true 2-D torus
    takes the most-square ``rows x cols`` torus, otherwise a ring.  The
    construction is checked by rebuilding the dense operator against the
    embedded small P.
    """
    act = np.asarray(active, dtype=bool)
    n = act.size
    surv = np.nonzero(act)[0]
    n_act = surv.size
    if n_act < 2:
        return None
    if graph == "torus":
        rows, cols = cns.default_torus(n_act)
        if rows >= 2 and cols >= 2:
            shape, adj = (rows, cols), cns.torus_graph(rows, cols)
        else:                       # prime or tiny survivor counts: ring
            shape, adj = (n_act,), cns.ring_graph(n_act)
    elif graph == "ring":
        shape, adj = (n_act,), cns.ring_graph(n_act)
    else:
        return None
    p_small = cns.metropolis_weights(adj, lazy=lazy)
    taps_small = group_taps(p_small, shape)
    if taps_small is None:
        return None
    coords = np.stack(np.unravel_index(np.arange(n_act), shape), axis=1)
    hops = []
    for off in taps_small.offsets:
        src_rank = np.ravel_multi_index(
            tuple((coords[:, a] + off[a]) % shape[a]
                  for a in range(len(shape))), shape)
        delta = (surv[src_rank] - surv) % n       # physical hop per rank
        tap_hops = []
        for d in sorted({int(x) for x in delta}):
            mask = np.zeros(n, dtype=bool)
            mask[surv[delta == d]] = True
            tap_hops.append((d, mask))
        hops.append(tuple(tap_hops))
    taps = SurvivorTaps(offsets=taps_small.offsets,
                        weights=taps_small.weights, shape=shape,
                        hops=tuple(hops), active=act.copy(), n=n)
    emb = np.eye(n)
    emb[np.ix_(surv, surv)] = p_small
    if not np.allclose(taps.dense(), emb, atol=1e-12):
        return None
    return taps


def _inactive_rows(m: torch.Tensor, taps) -> Optional[torch.Tensor]:
    """A copy of the inactive workers' rows of ``m``, taken before rounds
    that overwrite it (None for full-fleet taps)."""
    active = getattr(taps, "active", None)
    if active is None:
        return None
    rows = torch.as_tensor(np.nonzero(~np.asarray(active, bool))[0],
                           device=m.device)
    return m[rows]


def _mask_rows(out: torch.Tensor, kept: Optional[torch.Tensor],
               active) -> torch.Tensor:
    """Put the inactive workers' input rows ``kept`` (from
    :func:`_inactive_rows`) back into ``out`` in place after a survivor-tap
    combine; a no-op for full-fleet operators.  Per-tap weights that sum
    to 1 are not an exact identity in fp32, so the rows are copied back
    rather than left to self-pointing table rows."""
    if active is None:
        return out
    rows = torch.as_tensor(np.nonzero(~np.asarray(active, bool))[0],
                           device=out.device)
    out[rows] = kept
    return out


def epoch_draws(seed: int, epoch: int) -> Callable:
    """The default rounding draws of one epoch's quantized gossip.

    Returns ``draws(k_round, out)``, which fills ``out`` with U[0, 1) fp32
    from a ``torch.Generator`` on ``out``'s device seeded from (seed,
    epoch, k_round): the counterpart of ``fold_in(fold_in(PRNGKey(seed),
    epoch), k_round)`` in ``repro.dist``.  A CUDA and a CPU generator give
    different streams from one seed.  ``epoch`` may be negative: the
    pipelined and async drivers settle their first, zero payloads under
    the keys of epochs before 0.
    """
    def draws(k_round: int, out: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=out.device)
        gen.manual_seed(((seed * 1_000_003 + epoch) * 1_000_003 + k_round)
                        % (1 << 63))
        return out.uniform_(generator=gen)

    return draws


class ConsensusStrategy:
    """Operator on the per-worker message stack: (n, D) -> (n, D).

    ``draws`` is the rounding-draw source of quantized gossip (see
    :func:`epoch_draws`); the other strategies ignore it.
    """

    name: str = "base"

    def combine(self, msg: torch.Tensor,
                draws: Optional[Callable] = None) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes_per_round(self, d: int) -> int:
        """Bytes one worker sends per round for a D-element message."""
        raise NotImplementedError

    def rank_buffer(self, width: int, device) -> torch.Tensor:
        """The buffer of :meth:`combine_rank`: row 0 takes this worker's
        message, the other rows what it receives."""
        return torch.empty((1, width), dtype=torch.float32, device=device)

    def combine_rank(self, buf: torch.Tensor, group,
                     draws: Optional[Callable] = None) -> torch.Tensor:
        """One process per worker: this worker's (1, D) row of
        :meth:`combine` on the stack of every worker's row 0 of ``buf``."""
        raise NotImplementedError(
            f"{self.name} consensus over a process group is not ported yet "
            f"({OVER_GROUP_TODO})")


@dataclasses.dataclass(frozen=True)
class ExactConsensus(ConsensusStrategy):
    """eps = 0: every worker holds the global mean."""

    n: int
    name: str = dataclasses.field(default="exact", init=False)

    def combine(self, msg, draws=None):
        return cns.exact_average(msg.float())

    def combine_rank(self, buf, group, draws=None):
        """The all-reduce mean of every worker's row."""
        row = buf[:1]
        group.all_reduce_([row])
        return row.div_(float(self.n))

    def wire_bytes_per_round(self, d):
        return 4 * d          # fp32 all-reduce payload


class _TapGossip(ConsensusStrategy):
    """The Metropolis P of a ring, torus or other graph, and its taps.

    ``taps`` is None where P does not decompose (the dense fallback).
    Elastic membership: an ``active`` mask with at least 2 survivors on a
    ring or torus re-lays them out (:func:`survivor_taps`; ``relayout=False``
    forces the dense :func:`masked_metropolis`); one survivor is the
    identity; an all-inactive mask is rejected.
    """

    def __init__(self, n: int, rounds: int, graph: str = "ring",
                 lazy: float = 0.5, torus_shape: Optional[tuple] = None,
                 active: Optional[Sequence[bool]] = None,
                 relayout: bool = True):
        self.n, self.rounds, self.graph = int(n), int(rounds), graph
        self.lazy = float(lazy)
        self.relayout = bool(relayout)
        self.identity = False
        self.active = None if active is None or all(active) \
            else tuple(bool(a) for a in active)
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
        if self.active is None:
            self.p = cns.metropolis_weights(adj, lazy=self.lazy)
            self.taps = group_taps(self.p, shape)
            return
        if len(self.active) != self.n:
            raise ValueError(f"active mask has {len(self.active)} entries "
                             f"for {self.n} workers")
        n_act = sum(self.active)
        if n_act == 0:
            raise ValueError("at least one worker must stay active; an "
                             "all-inactive fleet has no consensus operator")
        if n_act == 1:
            # one survivor: consensus is the identity, the dual untouched
            self.identity = True
            self.p, self.taps = np.eye(self.n), None
            return
        if self.relayout:
            self.taps = survivor_taps(self.active, graph, self.lazy)
            if self.taps is not None:
                self.p = self.taps.dense()
                return
        self.p = masked_metropolis(adj, self.active, self.lazy)
        self.taps = None

    def source_rows(self, device) -> torch.Tensor:
        """The taps' (K, n) source-row table on ``device`` (built once)."""
        device = torch.device(device)
        if device not in self._src:
            self._src[device] = torch.as_tensor(self.taps.source_rows(),
                                                device=device)
        return self._src[device]

    def wire_bytes_per_round(self, d):
        k = self.taps.k if self.taps is not None else self.n
        return 4 * d * (k - 1)     # fp32 message to each neighbour

    def _identity(self) -> bool:
        return self.n < 2 or self.rounds < 1 or self.identity

    def rank_buffer(self, width, device):
        k = 1 if self._identity() or self.taps is None else self.taps.k
        return torch.empty((k, width), dtype=torch.float32, device=device)

    def rank_plan(self, worker: int) -> tuple:
        """For each tap k >= 1: (tap, the worker this one reads, the
        worker that reads this one) on the full-fleet taps."""
        src = self.taps.source_rows()
        return tuple((k, int(src[k, worker]),
                      int(np.flatnonzero(src[k] == worker)[0]))
                     for k in range(1, self.taps.k))


class GossipConsensus(_TapGossip):
    """r rounds of lazy-Metropolis gossip; tap-decomposed where possible.

    Numerically the same operator as ``repro.core.consensus.gossip(m, P,
    rounds)``; each ring/torus round is one
    :func:`repro_torch.kernels.ops.gossip_combine` launch.
    """

    name = "gossip"

    def combine(self, msg, draws=None):
        """r rounds on the stack.  On the tap path an fp32 ``msg`` is one of
        the two round buffers and is overwritten, so two (n, D) stacks are
        live however many rounds run (plus the inactive rows' copy under a
        survivor relayout)."""
        m = msg.float()
        if self.n < 2 or self.rounds < 1 or self.identity:
            return m
        if self.taps is None:        # dense fallback (non-circulant graph)
            return cns.gossip(m, self.p, self.rounds)
        kept = _inactive_rows(m, self.taps)
        src = self.source_rows(m.device)
        spare = torch.empty_like(m)
        for _ in range(self.rounds):
            m, spare = kops.gossip_combine(m, src, self.taps.weights,
                                           out=spare), m
        # survivor relayout: no active row reads an inactive one, so one
        # final select equals the dense masked operator's identity rows
        return _mask_rows(m, kept, getattr(self.taps, "active", None))

    def combine_rank(self, buf, group, draws=None):
        """r rounds with this worker's message in row 0 of the (K, D)
        ``buf`` (:meth:`rank_buffer`); returns its (1, D) row.  Each round
        exchanges rows with the taps' neighbours into rows 1..K-1, in tap
        order, and one :func:`~repro_torch.kernels.ops.gossip_combine`
        launch on the (K, 1) table sums them in the stacked round's order.
        The dense fallback all-gathers the rows each round and takes this
        worker's row of P; an ``active`` mask is not ported over a group.
        """
        if self.active is not None:
            raise NotImplementedError(
                f"elastic membership over a process group is not ported "
                f"yet ({OVER_GROUP_TODO})")
        if self._identity():
            return buf[:1]
        if self.taps is None:        # dense fallback (non-circulant graph)
            p = torch.as_tensor(self.p[group.worker][None],
                                dtype=torch.float32, device=buf.device)
            row = buf[:1]
            for _ in range(self.rounds):
                row = p @ group.all_gather(row[0])
            return row
        plan = self.rank_plan(group.worker)
        table = own_row_table(self.taps.k, buf.device)
        out = torch.empty_like(buf[:1])
        for r in range(self.rounds):
            group.exchange(buf[0], [(dst, k) for k, _, dst in plan],
                           [(src, k, buf[k]) for k, src, _ in plan])
            kops.gossip_combine(buf, table, self.taps.weights, out=out)
            if r + 1 < self.rounds:
                buf[0].copy_(out[0])
        return out


def row_grids(cur: torch.Tensor, h: torch.Tensor, levels: float,
               chunk: int = 1 << 26) -> tuple:
    """(lo, scale), each (n, 1): the min of each row of ``cur - h`` and
    its range over ``levels`` (at least 1e-12).  The difference is formed
    a chunk of one row at a time, never as an (n, D) temporary; min and
    max are exact in any order."""
    n, d = cur.shape
    lo = torch.empty((n, 1), dtype=torch.float32, device=cur.device)
    hi = torch.empty_like(lo)
    for i in range(n):
        parts = [torch.aminmax(cur[i, j:j + chunk] - h[i, j:j + chunk])
                 for j in range(0, d, chunk)]
        lo[i] = torch.stack([p.min for p in parts]).min()
        hi[i] = torch.stack([p.max for p in parts]).max()
    # a tensor divisor: CUDA turns a division by a host scalar into a
    # product with its reciprocal, which can move the grid by an ulp
    return lo, torch.clamp(hi - lo, min=1e-12) / torch.full_like(lo, levels)


class QuantizedGossipConsensus(_TapGossip):
    """Delta-compressed gossip (``repro_torch.core.extensions.
    gossip_quantized``) on the taps.

    Every worker keeps a public replica ``h`` of its own value and one
    replica per neighbour tap; each round it stochastically quantizes
    ``m - h`` onto a per-row uniform grid of ``bits`` bits, sends the
    uint8 level plane and two grid scalars, and combines ``m <- P_ii m +
    sum_k P_ik hnbr_k``.  Given the same per-round draws it is the dense
    operator.  The rounds budget is scaled by the caller ((32/bits)x per
    T_c, :func:`make_strategy`).
    """

    name = "gossip_q"

    def __init__(self, n: int, rounds: int, bits: int = 8,
                 graph: str = "ring", lazy: float = 0.5,
                 torus_shape: Optional[tuple] = None,
                 active: Optional[Sequence[bool]] = None,
                 relayout: bool = True):
        super().__init__(n, rounds, graph, lazy, torus_shape, active,
                         relayout)
        if bits not in (4, 8):
            raise ValueError("bits must be 4 or 8 (uint8 wire container)")
        self.bits = int(bits)
        self.name = f"gossip_q{bits}"

    def wire_bytes_per_round(self, d):
        # the level plane (two 4-bit levels per byte, as _pack sends it)
        # plus the two fp32 grid scalars, to each neighbour
        k = self.taps.k if self.taps is not None else self.n
        per_msg = (-(-d // 2) if self.bits == 4 else d) + 8
        return per_msg * (k - 1)

    def _pack(self, lvl: torch.Tensor) -> torch.Tensor:
        """4-bit wire format: two levels per byte (lossless)."""
        if self.bits != 4:
            return lvl
        if lvl.shape[1] % 2:
            lvl = torch.nn.functional.pad(lvl, (0, 1))
        return lvl[:, ::2] | (lvl[:, 1::2] << 4)

    def _unpack(self, packed: torch.Tensor, d: int) -> torch.Tensor:
        if self.bits != 4:
            return packed
        both = torch.stack([packed & 0xF, packed >> 4], dim=-1)
        return both.reshape(both.shape[0], -1)[:, :d]

    def combine(self, msg, draws=None):
        """r rounds on the stack; ``draws(k, out)`` fills round k's
        U[0, 1) draws.  On the tap path an fp32 ``msg`` is overwritten with
        the result, and the replicas, draws and levels are updated in
        place round after round: K + 1 fp32 and one uint8 (n, D) stacks
        are live beside the message.  On one card no byte crosses a link,
        so the rounds read the unpacked level plane."""
        if draws is None:
            raise ValueError("QuantizedGossipConsensus needs a draw source")
        m = msg.float()
        if self.n < 2 or self.rounds < 1 or self.identity:
            return m
        # the fused path needs the self tap first (w[0] multiplies m)
        if self.taps is None or any(self.taps.offsets[0]):
            return gossip_quantized(m, self.p, self.rounds, self.bits, draws)
        kept = _inactive_rows(m, self.taps)
        levels = float(2 ** self.bits - 1)
        src, w = self.source_rows(m.device), self.taps.weights
        h = torch.zeros_like(m)
        hnbr = torch.zeros((self.taps.k - 1,) + tuple(m.shape),
                           dtype=torch.float32, device=m.device)
        rnd = torch.empty_like(m)
        lvl = torch.empty(m.shape, dtype=torch.uint8, device=m.device)
        for k in range(self.rounds):
            lo, scale = row_grids(m, h, levels)
            draws(k, rnd)
            kops.stochastic_quantize(m, h, rnd, lo, scale, levels,
                                     out=(lvl, h))
            kops.quantized_combine(m, hnbr, lvl, lo, scale, src, w,
                                   out=(m, hnbr))
        # survivor relayout: no active row reads an inactive row's levels,
        # so putting the input rows back is exact
        return _mask_rows(m, kept, getattr(self.taps, "active", None))


def torus_shape_for_mesh(mesh) -> Optional[tuple]:
    """The physical worker-axis extents as the torus (rows, cols).

    A ("pod", "data", "model") mesh gossips over pod x data, so the
    natural torus is (pod_extent, data_extent); a single-worker-axis mesh
    falls back to the most-square factorisation (None).
    """
    waxes = [a for a in axis_names(mesh) if a != "model"]
    if len(waxes) == 2:
        shape = mesh_shape(mesh)
        return int(shape[waxes[0]]), int(shape[waxes[1]])
    return None


CONSENSUS_CHOICES = ("exact", "gossip", "gossip_q8", "gossip_q4")


def make_strategy(name: str, n: int, *, rounds: int = 5, graph: str = "ring",
                  lazy: float = 0.5, torus_shape: Optional[tuple] = None,
                  active: Optional[Sequence[bool]] = None,
                  relayout: bool = True) -> ConsensusStrategy:
    """Build a strategy by name.  Quantized strategies get (32/bits)x the
    rounds: the same byte budget per T_c.  An ``active`` mask rebuilds the
    gossip operator over the survivors (see :class:`_TapGossip`); exact
    consensus needs no rebuild, since a departed worker's b_i = 0 already
    drops it out of the eq.-6 average."""
    if name == "exact":
        return ExactConsensus(n)
    if name == "gossip":
        return GossipConsensus(n, rounds, graph, lazy, torus_shape, active,
                               relayout)
    if name in ("gossip_q8", "gossip_q4"):
        bits = int(name[-1])
        return QuantizedGossipConsensus(n, rounds * 32 // bits, bits, graph,
                                        lazy, torus_shape, active, relayout)
    raise ValueError(f"unknown consensus strategy {name!r}; "
                     f"choose from {CONSENSUS_CHOICES}")
