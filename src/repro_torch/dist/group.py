"""One rank's side of an AMB epoch run one process per worker.

The JAX package runs its workers as the ``("pod", "data")`` axes of one
SPMD program; here each worker is a process of a ``torch.distributed``
group laid out by :func:`repro_torch.launch.mesh.make_host_mesh`, and
:class:`WorkerGroup` is what the steps need of it:

  * the worker's index (the row-major (pod, data) coordinate of its rank)
    and the worker count;
  * sums across workers (:meth:`WorkerGroup.all_reduce_`): the exact
    step's eq.-6 gradient, through flat fp32 buckets, and its scalars;
  * the gossip round's neighbour exchange (:meth:`WorkerGroup.exchange`):
    send this rank's row to the ranks that read it, receive the rows it
    reads, one ``batch_isend_irecv`` per round;
  * :meth:`WorkerGroup.all_gather` for the dense fallback.

Backends.  NCCL takes CUDA tensors (one rank per card).  gloo takes CPU
tensors everywhere and CUDA tensors for its collectives, but not for
``send``/``recv``: with gloo on the card the compute stays on the card and
only the wire goes through pinned host buffers, ``STAGE_ELEMS`` elements
at a time.  The group counts the bytes it sends to other ranks
(``sent_bytes``) and the bytes it copies between card and host for the
wire (``staged_bytes``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import axis_names, mesh_shape

BUCKET_ELEMS = 1 << 26       # fp32 elements an all-reduce bucket holds
STAGE_ELEMS = 1 << 24        # fp32 elements a pinned staging chunk holds


def worker_axes(mesh) -> tuple:
    """Mesh axes that enumerate AMB workers (everything but "model")."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def num_workers(mesh) -> int:
    """Workers = product of the non-"model" axis extents (pod x data)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in worker_axes(mesh))


class WorkerGroup:
    """This process's worker in a mesh over the initialised process group.

    The mesh's "model" extent must be 1 (one process is one worker); its
    worker axes then span every rank, and worker j is the rank at (pod,
    data) coordinate j, which is rank j.
    """

    def __init__(self, mesh, device):
        shape = mesh_shape(mesh)
        if shape.get("model", 1) != 1:
            raise ValueError("a model axis > 1 (tensor parallelism inside a "
                             "worker) is not ported yet (ROADMAP.md, module "
                             "item 4a)")
        self.mesh = mesh
        self.n = num_workers(mesh)
        if self.n != dist.get_world_size():
            raise ValueError(f"the mesh has {self.n} workers, the process "
                             f"group {dist.get_world_size()} ranks")
        coord = mesh.get_coordinate()
        waxes = worker_axes(mesh)
        names = axis_names(mesh)
        self.worker = int(np.ravel_multi_index(
            tuple(coord[names.index(a)] for a in waxes),
            tuple(shape[a] for a in waxes)))
        if self.worker != dist.get_rank():
            raise ValueError(f"rank {dist.get_rank()} sits at worker "
                             f"{self.worker}: the mesh must enumerate ranks "
                             f"row-major")
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.sent_bytes = 0
        self.staged_bytes = 0
        self._pinned: dict = {}

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
            dist.all_reduce(tensors[0], op=op)
            return
        size = min(BUCKET_ELEMS, sum(t.numel() for t in tensors))
        bucket = torch.empty((size,), dtype=torch.float32,
                             device=tensors[0].device)
        pending: list = []            # (flat view, start, stop, offset)
        used = 0

        def flush():
            nonlocal used
            dist.all_reduce(bucket[:used], op=op)
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
        dist.all_reduce(out)
        return out[0]

    def max_float(self, x: float) -> float:
        """The largest of every worker's ``x`` (a host number)."""
        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self._coll_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def _coll_device(self) -> torch.device:
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")

    # -- the gossip wire ---------------------------------------------------

    def _pin(self, key, n: int) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty((n,), dtype=torch.float32, pin_memory=True)
            self._pinned[key] = buf
        return buf[:n]

    def exchange(self, row: torch.Tensor, sends: list, recvs: list) -> None:
        """Send ``row`` (a contiguous (D,) fp32 tensor) to each ``(rank,
        tag)`` of ``sends`` and receive a (D,) row from each ``(rank, tag,
        out)`` of ``recvs`` into ``out``, all in one ``batch_isend_irecv``
        (a send pairs with the receive of the same tag).  With gloo on the
        card the rows go through pinned host buffers, ``STAGE_ELEMS`` at a
        time."""
        d = row.numel()
        if not sends and not recvs:
            return
        if not self.staged:
            ops = [dist.P2POp(dist.isend, row, peer, tag=tag)
                   for peer, tag in sends]
            ops += [dist.P2POp(dist.irecv, out, peer, tag=tag)
                    for peer, tag, out in recvs]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.sent_bytes += 4 * d * len(sends)
            return
        for a in range(0, d, STAGE_ELEMS):
            b = min(d, a + STAGE_ELEMS)
            host = self._pin("send", b - a)
            host.copy_(row[a:b])
            got = [self._pin(("recv", j), b - a) for j in range(len(recvs))]
            ops = [dist.P2POp(dist.isend, host, peer, tag=tag)
                   for peer, tag in sends]
            ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag)
                    for (peer, tag, _), buf in zip(recvs, got)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for (_, _, out), buf in zip(recvs, got):
                out[a:b].copy_(buf)
            self.staged_bytes += 4 * (b - a) * (1 + len(recvs))
        self.sent_bytes += 4 * d * len(sends)

    def all_gather(self, row: torch.Tensor) -> torch.Tensor:
        """(n, D): every worker's (D,) fp32 row, in worker order."""
        out = torch.empty((self.n, row.numel()), dtype=torch.float32,
                          device=row.device)
        if self.staged:
            host = row.detach().cpu()
            got = [torch.empty_like(host) for _ in range(self.n)]
            dist.all_gather(got, host)
            for i, g in enumerate(got):
                out[i].copy_(g)
            self.staged_bytes += 4 * row.numel() * (1 + self.n)
        else:
            dist.all_gather(list(out.unbind(0)), row.contiguous())
        self.sent_bytes += 4 * row.numel() * (self.n - 1)
        return out

