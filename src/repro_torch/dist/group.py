"""One rank's side of an AMB epoch run one process per worker, or one
worker spread over the ranks of a model axis.

The JAX package runs its workers as the ``("pod", "data")`` axes of one
SPMD program; here each worker is a process of a ``torch.distributed``
group laid out by :func:`repro_torch.launch.mesh.make_host_mesh` (or, with
a ``"model"`` extent M > 1, the M ranks at one (pod, data) coordinate:
ranks ``worker * M + m``, row-major), and :class:`WorkerGroup` is what the
steps need of it:

  * the worker's index (the row-major (pod, data) coordinate of its rank)
    and the worker count; with M > 1 also its model coordinate ``m`` and
    the process groups of the axes (:mod:`repro_torch.dist.tp` runs the
    tensor-parallel and FSDP collectives on them);
  * sums across workers (:meth:`WorkerGroup.all_reduce_`): the exact
    step's eq.-6 gradient, through flat fp32 buckets, and its scalars;
  * the gossip round's neighbour exchange (:meth:`WorkerGroup.exchange`):
    send this rank's row to the ranks that read it, receive the rows it
    reads, one ``batch_isend_irecv`` per round; a row of any dtype (the
    fp32 message, quantized gossip's uint8 level plane, its (2,) fp32
    grid);
  * :meth:`WorkerGroup.all_gather` for the dense fallback;
  * :meth:`WorkerGroup.grid_over_model`: quantized gossip's row grid
    over a worker's M model ranks, each holding a block of its row (one
    MIN all-reduce of ``(lo, -hi)`` on ``model_pg`` a round);
  * :meth:`WorkerGroup.gather_to_root`: every rank's row of one leaf to
    rank 0, one row at a time (the checkpoint streams them to disk);
  * serving over the group: :meth:`WorkerGroup.gather_ranks`, every
    rank's block of a decode round's logits (its worker's slot rows, its
    model coordinate's columns), :meth:`WorkerGroup.gather_rows`, every
    worker's slot rows of a decode round's MoE input, and
    :meth:`WorkerGroup.lead_float`, rank 0's clock reading on every rank;
  * :meth:`WorkerGroup.head_groups`: the subgroups of a worker's model
    ranks that share one KV head (more model ranks than KV heads).

With M > 1 the sums, the gathers and the wire run among the ranks at this
rank's model coordinate, one per worker: worker j's peer is rank ``j * M
+ m``, so the M model coordinates of every worker gossip their own
blocks side by side and each worker is counted once.

Backends.  NCCL takes CUDA tensors (one rank per card).  gloo takes CPU
tensors everywhere and CUDA tensors for its collectives, but not for
``send``/``recv``: with gloo on the card the compute stays on the card and
only the wire goes through pinned host buffers of the row's dtype,
``STAGE_BYTES`` at a time, each chunk split across ``WIRE_LANES`` gloo
groups over every rank (``wire_lanes``), whose transfers run side by
side: one gloo group moves a chunk through one connection a peer.  The
group counts the bytes it sends to other ranks (``sent_bytes``) and the
bytes it copies between card and host for the wire (``staged_bytes``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import axis_names, mesh_shape

BUCKET_ELEMS = 1 << 26       # fp32 elements an all-reduce bucket holds
STAGE_BYTES = 1 << 26        # bytes a pinned staging chunk holds
WIRE_LANES = 4               # gloo groups a staged chunk is split across
_LANES: dict = {}            # the default group -> its wire lanes


def worker_axes(mesh) -> tuple:
    """Mesh axes that enumerate AMB workers (everything but "model")."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def wire_lanes() -> list:
    """WIRE_LANES gloo groups over every rank of the default group, made
    once a process, on its first call after the group is initialised;
    every rank calls it at one point (building its first staged
    :class:`WorkerGroup`), as ``new_group`` requires."""
    world = dist.group.WORLD
    if world not in _LANES:
        _LANES.clear()
        _LANES[world] = [dist.new_group(backend="gloo")
                         for _ in range(WIRE_LANES)]
    return _LANES[world]


def num_workers(mesh) -> int:
    """Workers = product of the non-"model" axis extents (pod x data)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in worker_axes(mesh))


class WorkerGroup:
    """This process's worker in a mesh over the initialised process group.

    Worker j is the rank at (pod, data) coordinate j; with a "model"
    extent M each worker is M ranks, ``j * M`` to ``j * M + M - 1``, and
    this rank holds model coordinate ``m`` of it.  ``worker_pg`` spans the
    ranks at coordinate m (every worker once; the default group when M is
    1), ``model_pg`` the worker's M ranks, ``data_pg`` the ranks of this
    pod at coordinate m, and ``pod_pg`` (pod > 1) the ranks at this data
    and model coordinate.
    """

    def __init__(self, mesh, device):
        shape = mesh_shape(mesh)
        self.mesh = mesh
        self.n = num_workers(mesh)
        self.model = int(shape.get("model", 1))
        if self.n * self.model != dist.get_world_size():
            raise ValueError(f"the mesh has {self.n} workers of "
                             f"{self.model} ranks, the process group "
                             f"{dist.get_world_size()} ranks")
        coord = mesh.get_coordinate()
        waxes = worker_axes(mesh)
        names = axis_names(mesh)
        self.worker = int(np.ravel_multi_index(
            tuple(coord[names.index(a)] for a in waxes),
            tuple(shape[a] for a in waxes)))
        self.m = int(coord[names.index("model")]) if "model" in names \
            else 0
        if self.worker * self.model + self.m != dist.get_rank():
            raise ValueError(f"rank {dist.get_rank()} sits at worker "
                             f"{self.worker}, model coordinate {self.m}: "
                             f"the mesh must enumerate ranks row-major")
        self.worker_pg = self.model_pg = self.data_pg = self.pod_pg = None
        if self.model > 1:
            self.model_pg = mesh.get_group("model")
            self.data_pg = mesh.get_group("data")
            if "pod" in names and shape["pod"] > 1:
                self.pod_pg = mesh.get_group("pod")
                # (pod, data) at one model coordinate spans two mesh axes:
                # every rank builds every coordinate's group, in order
                for m in range(self.model):
                    pg = dist.new_group([j * self.model + m
                                         for j in range(self.n)])
                    if m == self.m:
                        self.worker_pg = pg
            else:
                self.worker_pg = self.data_pg
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._lanes = wire_lanes() if self.staged else None
        self.sent_bytes = 0
        self.staged_bytes = 0
        self.grid_reductions = 0
        self._pinned: dict = {}
        self._subgroups: dict = {}
        self.rows_gathered_bytes = 0

    def rank_of(self, worker: int) -> int:
        """The global rank of ``worker`` at this rank's model
        coordinate."""
        return worker * self.model + self.m

    # -- sums --------------------------------------------------------------

    def all_reduce_(self, tensors, op=dist.ReduceOp.SUM) -> None:
        """Reduce each tensor across the workers in place.

        Leaves are packed into flat fp32 buckets of ``BUCKET_ELEMS``, one
        ``all_reduce`` per bucket, and written back in their own dtype: a
        bf16 gradient pays one rounding, after the fp32 sum.
        """
        tensors = [t for t in tensors if t.numel()]
        if not tensors:
            return
        if len(tensors) == 1 and tensors[0].dtype == torch.float32 \
                and tensors[0].is_contiguous() \
                and tensors[0].numel() <= BUCKET_ELEMS:
            dist.all_reduce(tensors[0], op=op, group=self.worker_pg)
            return
        size = min(BUCKET_ELEMS, sum(t.numel() for t in tensors))
        bucket = torch.empty((size,), dtype=torch.float32,
                             device=tensors[0].device)
        pending: list = []            # (flat view, start, stop, offset)
        used = 0

        def flush():
            nonlocal used
            dist.all_reduce(bucket[:used], op=op, group=self.worker_pg)
            for flat, a, b, off in pending:
                flat[a:b].copy_(bucket[off:off + b - a])
            pending.clear()
            used = 0

        for t in tensors:
            flat = t.view(-1)
            a = 0
            while a < flat.numel():
                b = min(flat.numel(), a + size - used)
                bucket[used:used + b - a].copy_(flat[a:b])
                pending.append((flat, a, b, used))
                used += b - a
                a = b
                if used == size:
                    flush()
        if used:
            flush()

    def sum_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-d tensor summed across the workers (a fresh fp32 tensor)."""
        out = x.detach().float().reshape(1).clone()
        dist.all_reduce(out, group=self.worker_pg)
        return out[0]

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a tensor across the workers in place, in its own dtype (an
        fp64 accumulator keeps its precision); returns it."""
        dist.all_reduce(t, group=self.worker_pg)
        return t

    def barrier(self) -> None:
        """Wait for every rank (a one-element all-reduce)."""
        dist.all_reduce(torch.zeros((1,), device=self._coll_device()))

    def lead_float(self, x: float) -> float:
        """Global rank 0's ``x`` (a host number) on every rank: one
        broadcast, so that decisions taken on a clock agree."""
        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self._coll_device())
        dist.broadcast(t, src=0)
        return float(t.item())

    def max_float(self, x: float) -> float:
        """The largest of every rank's ``x`` (a host number)."""
        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self._coll_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def grid_over_model(self, lo: torch.Tensor,
                        hi: torch.Tensor) -> tuple:
        """``(lo, hi)``, each (n, 1) fp32, reduced to their MIN and MAX
        over this worker's model ranks: one MIN all-reduce of ``(lo,
        -hi)`` (negation is exact, so the MAX comes out bit for bit),
        through a pinned host buffer under gloo on the card.  Every model
        rank must call it in the same order; at model 1 it returns its
        arguments."""
        if self.model <= 1:
            return lo, hi
        pair = torch.cat([lo, -hi], dim=1)
        if self.staged:
            host = self._pin("grid", pair.numel(), pair.dtype)
            host.copy_(pair.view(-1))
            dist.all_reduce(host, op=dist.ReduceOp.MIN, group=self.model_pg)
            pair.view(-1).copy_(host)
            self.staged_bytes += 2 * 4 * pair.numel()
        else:
            dist.all_reduce(pair, op=dist.ReduceOp.MIN, group=self.model_pg)
        self.grid_reductions += 1
        return pair[:, :1], -pair[:, 1:]

    def _coll_device(self) -> torch.device:
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")

    # -- the gossip wire ---------------------------------------------------

    def _pin(self, key, n: int, dtype) -> torch.Tensor:
        buf = self._pinned.get((key, dtype))
        if buf is None or buf.numel() < n:
            buf = torch.empty((n,), dtype=dtype, pin_memory=True)
            self._pinned[(key, dtype)] = buf
        return buf[:n]

    def exchange(self, row: torch.Tensor, sends: list, recvs: list) -> None:
        """Send ``row`` (a contiguous (D,) tensor of any dtype) to each
        ``(rank, tag)`` of ``sends`` and receive a (D,) row of its dtype
        from each ``(rank, tag, out)`` of ``recvs`` into ``out``, all in one
        ``batch_isend_irecv`` (a send pairs with the receive of the same
        tag).  Peers are workers, each at this rank's model coordinate
        (:meth:`rank_of`).  With gloo on the card the rows go through
        pinned host buffers of the row's dtype, ``STAGE_BYTES`` at a
        time."""
        d, size = row.numel(), row.element_size()
        if not sends and not recvs:
            return
        sends = [(self.rank_of(j), tag) for j, tag in sends]
        recvs = [(self.rank_of(j), tag, out) for j, tag, out in recvs]
        if not self.staged:
            ops = [dist.P2POp(dist.isend, row, peer, tag=tag)
                   for peer, tag in sends]
            ops += [dist.P2POp(dist.irecv, out, peer, tag=tag)
                    for peer, tag, out in recvs]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.sent_bytes += size * d * len(sends)
            return
        step = max(1, STAGE_BYTES // size)
        for a in range(0, d, step):
            b = min(d, a + step)
            host = self._pin("send", b - a, row.dtype)
            if sends:
                host.copy_(row[a:b])
            got = [self._pin(("recv", j), b - a, row.dtype)
                   for j in range(len(recvs))]
            self._lanes_p2p(host, sends, [(peer, tag, buf) for
                                          (peer, tag, _), buf in
                                          zip(recvs, got)])
            for (_, _, out), buf in zip(recvs, got):
                out[a:b].copy_(buf)
            self.staged_bytes += size * (b - a) * (bool(sends) + len(recvs))
        self.sent_bytes += size * d * len(sends)

    def _lanes_p2p(self, host: torch.Tensor, sends: list,
                   recvs: list) -> None:
        """One staged chunk: ``host`` to each ``(rank, tag)`` of ``sends``
        and a chunk of its length into each ``(rank, tag, out)`` of
        ``recvs``, split evenly across the wire lanes (both ends cut a
        chunk alike, since their rows have one length and dtype), every
        lane's transfers in flight together."""
        n = host.numel()
        k = min(len(self._lanes), n)
        reqs = []
        for i, lane in enumerate(self._lanes[:k]):
            a, b = n * i // k, n * (i + 1) // k
            ops = [dist.P2POp(dist.isend, host[a:b], peer, group=lane,
                              tag=tag) for peer, tag in sends]
            ops += [dist.P2POp(dist.irecv, out[a:b], peer, group=lane,
                               tag=tag) for peer, tag, out in recvs]
            reqs += dist.batch_isend_irecv(ops)
        for req in reqs:
            req.wait()

    def gather_to_root(self, row: torch.Tensor, sink=None) -> None:
        """Rank 0 receives every worker's row of one leaf, in worker
        order, and hands each to ``sink(worker, row)`` (its own first, as
        it is); the other ranks send theirs.  One row is in flight at a
        time, so rank 0 never holds the (n, ...) leaf."""
        row = row.contiguous()
        if self.worker != 0:
            self.exchange(row.view(-1), [(0, self.worker)], [])
            return
        sink(0, row)
        got = torch.empty_like(row)
        for j in range(1, self.n):
            self.exchange(got.view(-1), [], [(j, j, got.view(-1))])
            sink(j, got)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's rows of ``x`` (one shape on each), concatenated
        along dim 0 in worker order, over the ranks at this model
        coordinate: a decode round's MoE input, which JAX dispatches as
        one group over every slot."""
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x.contiguous(), group=self.worker_pg)
        self.rows_gathered_bytes += x.numel() * x.element_size() \
            * (self.n - 1)
        return torch.cat(parts, dim=0)

    def head_groups(self, share: int):
        """The process group of the ``share`` model ranks of this worker
        that hold one KV head between them (model coordinates ``h share``
        to ``h share + share - 1``).  Made once per ``share``: every rank
        builds every worker's groups, in order, on its first call, which
        every rank makes at one point (building a tensor-parallel
        layout)."""
        key = ("heads", share)
        if key not in self._subgroups:
            mine = None
            for j in range(self.n):
                for h in range(self.model // share):
                    pg = dist.new_group([j * self.model + h * share + i
                                         for i in range(share)])
                    if j == self.worker and h == self.m // share:
                        mine = pg
            self._subgroups[key] = mine
        return self._subgroups[key]

    def gather_ranks(self, block: torch.Tensor) -> list:
        """Every rank's ``block`` (one shape and dtype on every rank), in
        global rank order: one ``all_gather`` over the default group (on
        the card under gloo as under NCCL)."""
        parts = [torch.empty_like(block)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, block.contiguous())
        return parts

    def all_gather(self, row: torch.Tensor) -> torch.Tensor:
        """(n, D): every worker's (D,) fp32 row, in worker order."""
        out = torch.empty((self.n, row.numel()), dtype=torch.float32,
                          device=row.device)
        if self.staged:
            host = row.detach().cpu()
            got = [torch.empty_like(host) for _ in range(self.n)]
            dist.all_gather(got, host, group=self.worker_pg)
            for i, g in enumerate(got):
                out[i].copy_(g)
            self.staged_bytes += 4 * row.numel() * (1 + self.n)
        else:
            dist.all_gather(list(out.unbind(0)), row.contiguous(),
                            group=self.worker_pg)
        self.sent_bytes += 4 * row.numel() * (self.n - 1)
        return out

