"""A worker spread over the ranks of a ``"model"`` axis: tensor
parallelism inside it (Megatron's scheme) and, in the exact epoch, FSDP
over ``"data"``.

JAX lays each leaf out by :func:`repro_torch.dist.params.param_spec` and
lets GSPMD place the collectives.  Here every rank holds a plain tensor,
its block of each leaf under the same spec, and the model code asks
:class:`TensorParallel` for the collectives at the points Megatron puts
them, each an ``autograd.Function`` with the matching backward:

  * :meth:`TensorParallel.copy` — identity forward, sum over "model"
    backward: the input of a column-parallel product (``wq``,
    ``wk``, ``wv``, ``w_gate``, ``w_up``, the vocab-parallel ``unembed``),
    and the replicated leaves that each rank reads only in part (the QKV
    biases, sliced to its heads; the qk-norm scales);
  * :meth:`TensorParallel.reduce` — sum over "model" forward, identity
    backward: the output of a row-parallel product (``wo``,
    ``w_down``) and the vocab-parallel embedding lookup;
  * :meth:`TensorParallel.gather` — all-gather over "data" forward,
    reduce-scatter backward: a leaf's d_model side, inside the
    checkpointed block (``models.model._run``), so the recompute gathers
    again and one layer's gathered weights are live at a time;
  * :meth:`TensorParallel.token_nll` — the vocab-parallel cross-entropy:
    the row max and the sum of exponentials across "model", the gold
    logit from the rank that owns it, and a backward of ``softmax -
    onehot`` on this rank's columns.

Serving reads the same blocks under ``fsdp_axis=None`` (JAX's serving
layout, ``param_spec(..., fsdp_axis=None)``: the d_model side
replicated): the prefill and the decode step take :meth:`heads`,
:meth:`attention_out`, :meth:`mlp` and :meth:`embed` as the training
forward does, and give this rank's columns of the logits
(:meth:`all_gather_model` puts a prefill's back together).
:meth:`TensorParallel.unshard_data` turns an FSDP x TP tree into those
blocks (an exact session's primal, once per absorbed fine-tune epoch).

A checkpoint stays JAX's archive of whole leaves at model > 1:
:class:`CheckpointBlocks` (``TensorParallel.checkpoint_blocks``) gives
the checkpoint module each leaf whole (gathered over "data" where it
lies on it and over "model"), a per-worker row whole (a dual row's
blocks gathered over "model"; a message row, an in-flight payload or
snapshot, put together from every model rank's :class:`RowBlock`), and
cuts this rank's block back out of a whole leaf or row on restore.

Each rank holds ``H / M`` query heads and ``KV / M`` KV heads (one,
shared, where M > KV): JAX's GQA order (query head h reads KV head
``h // G``) keeps a rank's query heads on its own KV heads.  A leaf
whose wide side the mesh does not divide (``param_spec`` drops the
axis) runs whole on every model rank, with no
collective: the embedding and the logits without a vocab split, the MLP
without an ffn split.  The norms stay replicated; their gradient is
already equal on every model rank, since the column-parallel input's
backward sums over "model".

Quantized gossip over a model axis quantizes each rank's block of its
worker's row on the whole row's grid and draws: :meth:`TensorParallel.
row_block` maps the block row into the whole row (each leaf's offset in
the worker row and its block slices, as :mod:`repro_torch.dist.params`
shards a leaf), and the grid's bounds are reduced over "model" by
:meth:`repro_torch.dist.group.WorkerGroup.grid_over_model`.

The collectives run on CUDA tensors under NCCL and gloo alike (gloo
copies through the host itself).  A sum over "model" is an all-gather of
the ranks' partials in their own dtype, then their sum in fp32 in model
order, rounded once (:func:`ordered_sum`): every rank, and a one-process
twin, sums alike whatever the backend's reduction algorithm, at the cost
of gathering M partials where an all-reduce would move about two.

The MoE family puts its experts on "model" (E / M a rank, where the
layout splits E): :meth:`TensorParallel.router_logits` gathers the
router's logit columns, each rank runs its experts on the assignments
routed over all E, and the partial outputs are summed like a
row-parallel product (:func:`repro_torch.models.moe.moe_forward`).  With
more model ranks than KV heads the ``M / KV`` ranks that share a head
each hold ``hd / (M / KV)`` of its columns of ``wk`` and ``wv`` and
gather the head (:meth:`TensorParallel.gather_kv`, over a subgroup of
:meth:`repro_torch.dist.group.WorkerGroup.head_groups`); rank m's query
heads read KV head ``m // (M / KV)``.

The vlm family is the dense blocks behind an embeddings input.  The
audio family (whisper) is dense blocks twice over, under the same rules:
the encoder's (``encoder.blocks.*``, no causal mask, over the frames)
and the decoder's, whose cross-attention (``blocks.xattn.*``) takes this
rank's heads of q from the decoder and of k and v from the encoder's
output, which every model rank holds whole (the encoder's final norm is
replicated) and which enters each layer's cross-attention through
:meth:`copy`, as a column-parallel input; a decoder layer sums three
row-parallel products (both ``wo`` and ``w_down``).  Each method that
reads a leaf's spec takes the leaf's full path (``prefix``), and
:class:`CheckpointBlocks` names a leaf by its longest tail, so an
encoder leaf and its decoder namesake (one shape, one spec) are never
confused.  Whisper's vocabulary is padded (51,865 to 51,968 rows): the
last model rank's block of ``embed`` and ``unembed`` holds the padding,
which :meth:`token_nll` masks and :meth:`vocab_logits` cuts.  RWKV6
(the ssm family) keeps JAX's ``param_spec`` blocks, which are Megatron's
only in part: each rank computes its ``d_model / 64 / M`` heads from its
columns of ``w_r``, ``w_k``, ``w_v``, ``w_g`` and sums its rows of
``w_out`` over "model", as attention does; the token-shift mixes (their
d_model side on "model"), the decay's LoRA (its rank on "model") and the
bonus (its head dim on "model") are gathered whole, a few hundred
thousand parameters a layer against a per-token sum (:meth:`ssm_leaves`;
serving gathers them once, :meth:`serving_leaves`); the channel mix's
``w_v`` is split by its d_model columns, so each rank gathers the
squared-ReLU key's ``d_ff / M`` columns and makes its output channels,
which are gathered into the residual (:meth:`gather_model`).  Its input
enters through :meth:`copy`, so each gathered leaf's gradient is this
rank's share and the gather's backward sums it over "model"; the output
channels feed the replicated residual, whose gradient is whole on every
rank, so that gather's backward only cuts.

The hybrid (zamba2) keeps JAX's blocks too, and its Mamba2 heads split
over "model" at compute time only: JAX puts "model" on the packed columns
of ``w_in`` ([x | z | B C | dt]) and ``conv_w`` ([x | B C]), whose blocks
do not follow the heads, so each rank gathers the two leaves whole and
cuts its heads' x, z and dt columns and B, C whole (:meth:`mamba_leaves`;
serving gathers and cuts them once, :meth:`serving_leaves`); the gather's
backward sums the whole leaf's gradient over "model" (only B and C's
columns take a part from every rank), a layer's (d, 2 d_in + 2 ns +
heads) in fp32.  The gated norm's mean square spans every head: each
rank's sum of squares over its channels is gathered over "model" and
summed in model order (:func:`repro_torch.models.ssm.mamba2_squares`,
the backward summed), and ``w_out`` is row-parallel.  The shared
attention block is a dense block whose leaves have no layer dim
(``"shared_attn.*"``): its heads set the KV layout (``self.wq``), and
the training forward gathers it over "data" once a step, so its
gradient accumulates over its applications before the one
reduce-scatter.

``gathered_bytes`` and ``scattered_bytes`` count what this rank received
from the other ranks of "data" in the all-gathers and sent to them in the
reduce-scatters, ``model_gathered_bytes`` what it received in the
"model" all-gathers (the router's logits, a shared KV head, RWKV6's
leaves, key and output channels, Mamba2's packed leaves and its norm's
sums of squares), and ``reduced_bytes`` the fp32 bytes of its sums over
"model" (``launch.dryrun.rank_model_bytes`` counts an RWKV6, whisper or
hybrid step's).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd import Function

from ..kernels import ops as kops
from ..launch.mesh import axis_names, mesh_shape
from ..models.model import SHARED, ordered
from ..models.ssm import LORA, RWKV_HD, mamba2_dims, mamba2_rank_leaves
from .params import block_slices, param_spec, shard_leaf

# leaves that each rank reads in part: the gradient of its part must be
# summed over "model" so the replicated leaf stays equal on every rank
PARTIAL_REPLICATED = ("bq", "bk", "bv", "q_norm", "k_norm")
# RWKV6: the small leaves each rank gathers whole over "model", and the
# replicated ones it reads its channels of (``TensorParallel.ssm_leaves``)
SSM_WHOLE = ("mu", "decay_a", "decay_b", "u_bonus")
SSM_PARTIAL = ("decay_bias", "ln_x")
# Mamba2: the packed leaves each rank gathers whole over "model" and cuts
# to its heads (``TensorParallel.mamba_leaves``)
MAMBA = "blocks.mamba."
MAMBA_WHOLE = ("w_in", "conv_w")


class _Copy(Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum_model(g), None


class _Reduce(Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum_model(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather_data(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_scatter_data(g, ctx.dim), None, None


def ordered_sum(x: torch.Tensor, pg, n: int) -> torch.Tensor:
    """A fresh fp32 tensor: ``x`` summed over the ``n`` ranks of ``pg`` on
    every rank, in fp32 and in rank order: an all-gather of ``x`` in its
    own dtype, then ``((x_0 + x_1) + x_2) + ...`` in fp32, so that every
    rank, and a one-process twin, sums alike whatever the backend's
    reduction algorithm (at two ranks this is the fp32 all-reduce's
    value)."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    out = parts[0].to(torch.float32, copy=True)
    for part in parts[1:]:
        out.add_(part.float())
    return out


class _GatherParts(Function):
    """Every rank's ``x`` of a process group ``pg`` of ``n`` ranks (this
    one at ``i``), stacked on a new leading dim in rank order; backward:
    the gradient summed over the group (in fp32, rounded once), this
    rank's part kept.  With ``summed`` False the backward keeps this
    rank's part of its own gradient: where every rank's use of the
    gathered tensor is the same replicated computation, so that its
    gradient is already whole and equal on every rank."""

    @staticmethod
    def forward(ctx, x, tp, pg, n: int, i: int, summed: bool = True):
        ctx.tp, ctx.pg, ctx.i, ctx.summed = tp, pg, i, summed
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=pg)
        tp.model_gathered_bytes += x.numel() * x.element_size() * (n - 1)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        if not ctx.summed:
            return g[ctx.i], None, None, None, None, None
        y = ordered_sum(g, ctx.pg, g.shape[0])
        ctx.tp.reduced_bytes += y.numel() * 4
        return y[ctx.i].to(g.dtype), None, None, None, None, None


class _VocabNLL(Function):
    """Per-token ``logsumexp - gold`` over logits split by columns across
    "model": (B, S, V/M) fp32 on each rank -> (B, S) equal on every
    rank."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, valid: int, tp):
        x = logits
        if valid < x.shape[-1]:          # the padded vocabulary's columns
            col = torch.arange(x.shape[-1], device=x.device)
            x = x.masked_fill(col >= valid, float("-inf"))
        m = x.amax(dim=-1)
        tp.all_reduce_model(m, dist.ReduceOp.MAX)
        s = ordered_sum(torch.exp(x - m[..., None]).sum(dim=-1),
                        tp.group.model_pg, tp.M)
        local = labels.long() - v0
        own = (local >= 0) & (local < valid)
        local = local.clamp(0, x.shape[-1] - 1)
        gold = torch.where(own, torch.gather(x, -1, local[..., None])[..., 0],
                           0.0)
        tp.all_reduce_model(gold)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, lse, local, own)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, lse, local, own = ctx.saved_tensors
        p = torch.exp(x - lse[..., None])            # softmax - onehot
        idx = local[..., None]
        p.scatter_(-1, idx, p.gather(-1, idx) - own[..., None].to(p.dtype))
        return p.mul_(g[..., None]), None, None, None, None


class RowBlock:
    """A rank's block of its worker's (W + 1)-element message row: the
    leaves in row order, each whole in the worker row at its offset and
    cut to the rank's block, then the count element (the row's last,
    which every model rank holds).  ``width`` is the whole row's W + 1,
    ``block_width`` the block row's."""

    def __init__(self, leaves: list):
        self.leaves = leaves       # (whole shape, block slices) in row order
        self.width = sum(math.prod(shape) for shape, _ in leaves) + 1
        self.block_width = sum(math.prod(n for _, n in sl)
                               for _, sl in leaves) + 1

    def take(self, whole: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Copy the block's positions of the (W + 1,) ``whole`` row into
        the (block_width,) ``out``, leaf by leaf through the same
        ``narrow`` that cuts a leaf's block; returns ``out``."""
        a = b = 0
        for shape, slices in self.leaves:
            src = whole[a:a + math.prod(shape)].view(shape)
            for dim, (start, size) in enumerate(slices):
                if size != shape[dim]:
                    src = src.narrow(dim, start, size)
            n = src.numel()
            out[b:b + n].view(src.shape).copy_(src)
            a += math.prod(shape)
            b += n
        out[b:].copy_(whole[a:])
        return out

    def put(self, block: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`take`: write the block row's positions
        into the whole row ``whole`` (the count element too, which every
        model rank holds alike); returns ``whole``."""
        a = b = 0
        for shape, slices in self.leaves:
            dst = whole[a:a + math.prod(shape)].view(shape)
            for dim, (start, size) in enumerate(slices):
                if size != shape[dim]:
                    dst = dst.narrow(dim, start, size)
            n = dst.numel()
            dst.copy_(block[b:b + n].view(dst.shape))
            a += math.prod(shape)
            b += n
        whole[a:].copy_(block[b:])
        return whole


def row_block(shapes: dict, mesh, coord, fsdp_axis: Optional[str] = None,
              names=None) -> RowBlock:
    """The block of a worker's message row that the rank at mesh
    coordinate ``coord`` holds: leaves ``names`` (default every leaf of
    ``shapes``, in the JAX package's order) laid out whole in the row,
    each cut to the rank's block of it under :func:`~repro_torch.dist.
    params.param_spec` (a leaf replicated over "model" whole on every
    model rank), then the count element.  ``mesh`` may be abstract: the
    parent of a group's ranks cuts their blocks with it."""
    if names is None:
        names = list(ordered(shapes))
    leaves = []
    for k in names:
        shape = tuple(int(x) for x in shapes[k])
        spec = param_spec(k, shape, mesh, fsdp_axis)
        leaves.append((shape, block_slices(spec, shape, mesh, coord)))
    return RowBlock(leaves)


class TensorParallel:
    """This rank's place in a worker of M model ranks (``group``, a
    :class:`~repro_torch.dist.group.WorkerGroup` with ``model`` > 1): the
    spec of every leaf (``shapes``: each leaf's whole shape, by dotted
    name; ``fsdp_axis`` "data" for the exact epoch's FSDP x TP, None for
    the gossip epoch's TP only; ``cfg`` the model's config, whose heads
    set the KV layout) and the collectives the model runs."""

    def __init__(self, group, shapes: dict, fsdp_axis: Optional[str],
                 cfg):
        self.group = group
        self.fsdp_axis = fsdp_axis
        mesh = group.mesh
        self.shapes = {k: tuple(int(s) for s in v) for k, v in shapes.items()}
        self.specs = {k: param_spec(k, v, mesh, fsdp_axis)
                      for k, v in self.shapes.items()}
        extents = mesh_shape(mesh)
        self.M, self.m = group.model, group.m
        self.D = extents["data"] if fsdp_axis == "data" else 1
        self.d = 0
        if self.D > 1:
            self.d = dist.get_rank(group.data_pg)
        # the attention whose heads set the KV layout: the blocks', or the
        # hybrid's shared block's
        self.wq = next((k for k in ("blocks.attn.wq", SHARED + "attn.wq")
                        if k in self.shapes), "blocks.attn.wq")
        # the model ranks that share this rank's KV head (M > KV): their
        # group, their count and this rank's place among them
        self.kv_share, self.kv_pg, self.kv_i = 1, None, 0
        if self.split(self.wq) and self.M > cfg.num_kv_heads:
            check_heads(cfg, self.M)
            self.kv_share = self.M // cfg.num_kv_heads
            self.kv_pg = group.head_groups(self.kv_share)
            self.kv_i = self.m % self.kv_share
        self.gathered_bytes = 0
        self.scattered_bytes = 0
        self.reduced_bytes = 0
        self.model_gathered_bytes = 0
        # the leaves ssm_leaves takes as whole, and mamba_leaves as cut
        # (:meth:`holding_whole`)
        self.held_whole: frozenset = frozenset()

    # -- the layout --------------------------------------------------------

    def split(self, name: str) -> bool:
        """Whether leaf ``name`` (of the model's) has a side on
        "model"."""
        return "model" in self.specs.get(name, ())

    def data_dim(self, name: str) -> Optional[int]:
        """The dim of leaf ``name`` that lies on "data" (None if none)."""
        spec = self.specs[name]
        return spec.index("data") if "data" in spec else None

    def vocab_rows(self) -> tuple:
        """This rank's rows ``[v0, v1)`` of the (padded) vocabulary."""
        v = self.shapes["embed"][0]
        if not self.split("embed"):
            return 0, v
        per = v // self.M
        return self.m * per, (self.m + 1) * per

    def row_block(self, names=None) -> RowBlock:
        """This rank's :func:`row_block` of its worker's message row under
        the session's layout (``names`` default: every leaf, in the JAX
        package's order, as the duals are kept)."""
        return row_block(self.shapes, self.group.mesh,
                         self.group.mesh.get_coordinate(), self.fsdp_axis,
                         names)

    # -- collectives -------------------------------------------------------

    def all_reduce_model(self, x: torch.Tensor,
                         op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(x, op=op, group=self.group.model_pg)

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh tensor: ``x`` summed over "model" in model order
        (:func:`ordered_sum`; in fp32, rounded once to ``x``'s dtype);
        ``reduced_bytes`` counts the fp32 bytes."""
        y = ordered_sum(x, self.group.model_pg, self.M)
        self.reduced_bytes += y.numel() * 4
        return y.to(x.dtype)

    def all_gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's ``x`` (one shape on each), concatenated along
        ``dim`` in model order: a prefill's logits, each rank's columns
        of the vocabulary."""
        parts = [torch.empty_like(x) for _ in range(self.M)]
        dist.all_gather(parts, x.contiguous(), group=self.group.model_pg)
        return torch.cat(parts, dim=dim)

    def all_gather_data(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.D)]
        dist.all_gather(parts, x.contiguous(), group=self.group.data_pg)
        self.gathered_bytes += x.numel() * x.element_size() * (self.D - 1)
        return torch.cat(parts, dim=dim)

    def reduce_scatter_data(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of ``g`` summed over "data" (in
        fp32, rounded once to ``g``'s dtype)."""
        parts = [c.to(torch.float32).contiguous()
                 for c in g.chunk(self.D, dim=dim)]
        out = torch.empty_like(parts[self.d])
        dist.reduce_scatter(out, parts, group=self.group.data_pg)
        self.scattered_bytes += out.numel() * 4 * (self.D - 1)
        return out.to(g.dtype)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather(self, name: str, x: torch.Tensor,
               layered: bool = False) -> torch.Tensor:
        """Leaf ``name``'s block gathered over "data" (``layered``: one
        layer of a stacked leaf, its leading dim gone)."""
        dim = self.data_dim(name)
        if dim is None or self.D == 1:
            return x
        return _Gather.apply(x, self, dim - int(layered))

    def block(self, p: dict, prefix: str = "blocks.") -> dict:
        """One layer's nested block leaves, each gathered over "data" (a
        leaf outside ``blocks``, the hybrid's shared block, has no layer
        dim: JAX's spec leads with none)."""
        layered = "blocks" in prefix.split(".")
        return {k: self.block(v, f"{prefix}{k}.") if isinstance(v, dict)
                else self.gather(prefix + k, v, layered=layered)
                for k, v in p.items()}

    # -- the model's parallel regions --------------------------------------

    def attention(self, p: dict, x: torch.Tensor,
                  prefix: str = "blocks.attn.") -> tuple:
        """(the attention leaves as this rank's heads read them, the
        column-parallel input): :meth:`heads`, and ``x`` through
        :meth:`copy`."""
        if not self.split(prefix + "wq"):
            return p, x
        return self.heads(p, prefix), self.copy(x)

    def kv_heads(self, cfg) -> int:
        """The KV heads this rank holds (whole: with M > KV its ranks
        gather the head, :meth:`gather_kv`)."""
        kv = cfg.num_kv_heads
        if not self.split(self.wq):
            return kv
        return max(1, kv // self.M)

    def q_heads(self, cfg) -> int:
        """The query heads this rank computes."""
        h = cfg.num_heads
        return h // self.M if self.split(self.wq) else h

    def gather_kv(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """k and v (..., c) of this rank's columns of its KV head (M > KV:
        ``kv_share`` ranks hold one head, ``c = hd / kv_share`` columns
        each) -> the head's (..., hd) on each of them, all-gathered over
        those ranks in one collective; the backward sums the gradient
        over them and keeps this rank's columns.  Otherwise (k, v) as
        they are."""
        if self.kv_share == 1:
            return k, v
        c = k.shape[-1]
        parts = _GatherParts.apply(torch.cat([k, v], dim=-1), self,
                                   self.kv_pg, self.kv_share, self.kv_i)
        lead = parts.shape[1:-1]

        def whole(x):           # (n, ..., c) -> (..., n c)
            return x.movedim(0, -2).reshape(*lead, self.kv_share * c)
        return whole(parts[..., :c]), whole(parts[..., c:])

    # -- the experts ---------------------------------------------------------

    def experts_split(self) -> bool:
        """Whether the experts lie on "model" (E / M each; else every
        model rank runs them all, with no collective)."""
        return self.split("blocks.moe.w_gate")

    def expert_range(self, cfg) -> tuple:
        """This rank's experts ``[e0, e1)``."""
        e = cfg.num_experts
        if not self.experts_split():
            return 0, e
        per = e // self.M
        return self.m * per, (self.m + 1) * per

    def router_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """(..., E / M) logits of this rank's router columns -> (..., E),
        all-gathered over "model" in model order.  The routing after it
        is replicated, but a rank's gate gradients reach only its own
        experts' outputs (and its share of the load-balance loss): the
        backward sums the gradient over "model" and keeps this rank's
        columns, so each path counts once."""
        parts = _GatherParts.apply(logits, self, self.group.model_pg,
                                   self.M, self.m)
        return parts.movedim(0, -2).reshape(*logits.shape[:-1], -1)

    def heads(self, p: dict, prefix: str = "blocks.attn.") -> dict:
        """The attention leaves as this rank's heads read them: the QKV
        biases sliced to its heads and the qk-norm scales, each through
        :meth:`copy` (the blocks of ``wq``/``wk``/``wv``/``wo`` are its
        heads already)."""
        if not self.split(prefix + "wq"):
            return p
        p = dict(p)
        for k in PARTIAL_REPLICATED:
            if k not in p:
                continue
            leaf = self.copy(p[k])
            if k.startswith("b"):            # this rank's heads' columns
                per = leaf.shape[-1] // self.M
                leaf = leaf.narrow(-1, self.m * per, per)
            p[k] = leaf
        return p

    def attention_out(self, out: torch.Tensor,
                      prefix: str = "blocks.attn.") -> torch.Tensor:
        return self.reduce(out) if self.split(prefix + "wq") else out

    def mlp(self, fn, x: torch.Tensor,
            prefix: str = "blocks.mlp.") -> torch.Tensor:
        """``fn(x)`` column- then row-parallel over "model"."""
        if not self.split(prefix + "w_gate"):
            return fn(x)
        return self.reduce(fn(self.copy(x)))

    def embed(self, weight: torch.Tensor,
              tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup: ids outside this rank's rows are
        masked, then the rows are summed over "model"."""
        weight = self.gather("embed", weight)
        if not self.split("embed"):
            return torch.nn.functional.embedding(tokens, weight)
        v0, v1 = self.vocab_rows()
        own = (tokens >= v0) & (tokens < v1)
        rows = torch.nn.functional.embedding(
            torch.where(own, tokens - v0, 0), weight)
        return self.reduce(rows * own[..., None].to(rows.dtype))

    def vocab_logits(self, logits: torch.Tensor,
                     vocab_size: int) -> torch.Tensor:
        """This rank's columns of the logits (``models.logits_fn``) ->
        the whole ``vocab_size`` columns on every model rank: gathered over
        "model" in model order where the vocabulary is split, then cut
        before the padded rows, so no pick can take a padded column."""
        if self.split("unembed"):
            logits = self.all_gather_model(logits, -1)
        return logits[..., :vocab_size]

    def token_nll(self, hidden: torch.Tensor, unembed: torch.Tensor,
                  labels: torch.Tensor, vocab_size: int):
        """(B, S) ``logsumexp - gold`` of the logits ``hidden @ unembed``
        over the first ``vocab_size`` columns, or None when the vocabulary
        is not split (the caller then takes the whole logits)."""
        if not self.split("unembed"):
            return None
        v0, v1 = self.vocab_rows()
        logits = (self.copy(hidden) @ self.gather("unembed",
                                                  unembed)).float()
        valid = max(0, min(v1, vocab_size) - v0)
        return _VocabNLL.apply(logits, labels, v0, valid, self)

    # -- the RWKV6 blocks ---------------------------------------------------

    def gather_model(self, x: torch.Tensor, dim: int,
                     summed: bool) -> torch.Tensor:
        """Every model rank's ``x`` concatenated along ``dim`` in model
        order.  ``summed``: each rank's use of the result is its own, so
        the backward sums the gradient over "model" and keeps this rank's
        part; else its use is replicated and the backward keeps this
        rank's part of its own gradient (see :class:`_GatherParts`)."""
        parts = _GatherParts.apply(x, self, self.group.model_pg, self.M,
                                   self.m, summed)
        dim = dim % x.dim()
        return parts.movedim(0, dim).reshape(
            *x.shape[:dim], -1, *x.shape[dim + 1:])

    def ssm_heads(self, cfg) -> int:
        """The RWKV6 heads this rank holds: ``d_model / 64 / M``."""
        return cfg.d_model // RWKV_HD // self.M

    def _whole_leaf(self, name: str, x: torch.Tensor,
                    stacked: bool) -> torch.Tensor:
        """Leaf ``name``'s block ``x`` (``stacked``: over the layers; else
        one layer's, its leading dim gone) gathered whole over "model"
        (the backward summed: a rank reads the whole leaf for its own
        channels), unless it is held whole (:meth:`holding_whole`) or
        has no side on "model"."""
        if name in self.held_whole or not self.split(name):
            return x
        lead = 0 if stacked else 1
        return self.gather_model(x, self.specs[name].index("model") - lead,
                                 summed=True)

    def ssm_leaves(self, p: dict, prefix: str) -> dict:
        """One layer's time-mix (``prefix`` "blocks.tmix.") or channel-mix
        ("blocks.cmix.") leaves as this rank's heads read them: the
        token-shift mixes (their d_model side lies on "model"), the
        decay's LoRA (its rank on "model") and the bonus (its head dim on
        "model") gathered whole; the bonus then cut to this rank's heads,
        the LoRA's up-projection, the decay bias and ``ln_x`` (replicated)
        to its channels, the last two through :meth:`copy`.  The
        projections' blocks are its channels already."""
        p = dict(p)
        for k in SSM_WHOLE:
            if k in p:
                p[k] = self._whole_leaf(prefix + k, p[k], stacked=False)
        if "u_bonus" in p:                              # the time mix
            h = p["u_bonus"].shape[0] // self.M
            c = p["decay_b"].shape[-1] // self.M
            p["u_bonus"] = p["u_bonus"].narrow(0, self.m * h, h)
            p["decay_b"] = p["decay_b"].narrow(-1, self.m * c, c)
            for k in SSM_PARTIAL:
                p[k] = self.copy(p[k]).narrow(-1, self.m * c, c)
        return p

    def mamba_heads(self, cfg) -> int:
        """The Mamba2 heads this rank holds: ``d_in / 64 / M``."""
        return mamba2_dims(cfg)[1] // self.M

    def mamba_leaves(self, p: dict) -> dict:
        """One layer's Mamba2 leaves as this rank's heads read them: the
        packed ``w_in`` and ``conv_w`` gathered whole over "model" (JAX's
        column blocks do not follow the heads: at M 2 rank 0's block of
        ``w_in`` is all of x and the first columns of z) and cut to its x,
        z and dt columns and B, C whole; ``a_log``, ``dt_bias``, ``d_skip``
        and ``norm_z`` (replicated) read in part through :meth:`copy`
        (:func:`repro_torch.models.ssm.mamba2_rank_leaves`).  ``w_out``'s
        block is its rows already.  Under :meth:`holding_whole` of the two
        packed leaves (:meth:`serving_leaves`) they are the rank's
        already."""
        cut = MAMBA + "w_in" not in self.held_whole
        if cut:
            p = dict(p, **{k: self._whole_leaf(MAMBA + k, p[k],
                                               stacked=False)
                           for k in MAMBA_WHOLE})
        return mamba2_rank_leaves(p, self.m, self.M, self.copy, cut=cut)

    @torch.no_grad()
    def serving_leaves(self, params: dict) -> tuple:
        """(``params``, this rank's serving blocks, with the RWKV6 leaves
        that :meth:`ssm_leaves` reads whole gathered whole and Mamba2's
        packed leaves gathered and cut to this rank's heads
        (:meth:`mamba_leaves`), stacked over the layers; their names).  A
        prefill or decode step under :meth:`holding_whole` of those names
        gathers none of them; any other family's leaves stay as they are.
        Every rank calls it together (it runs the gathers)."""
        out, names = dict(params), []
        for prefix in ("blocks.tmix.", "blocks.cmix."):
            for k in SSM_WHOLE:
                name = prefix + k
                if name in out and self.split(name):
                    out[name] = self._whole_leaf(name, out[name], stacked=True)
                    names.append(name)
        if MAMBA + "w_in" in out:
            layers = {k[len(MAMBA):]: v for k, v in out.items()
                      if k.startswith(MAMBA)}
            for k in MAMBA_WHOLE:
                layers[k] = self._whole_leaf(MAMBA + k, layers[k],
                                             stacked=True)
            cut = mamba2_rank_leaves(layers, self.m, self.M)
            for k in MAMBA_WHOLE:
                out[MAMBA + k] = cut[k].contiguous()
                names.append(MAMBA + k)
        return out, frozenset(names)

    @contextlib.contextmanager
    def holding_whole(self, names: frozenset):
        """While open, :meth:`ssm_leaves` takes the leaves ``names`` as
        whole and :meth:`mamba_leaves` its packed leaves as cut
        (:meth:`serving_leaves`' result), and neither gathers them."""
        before, self.held_whole = self.held_whole, frozenset(names)
        try:
            yield
        finally:
            self.held_whole = before

    # -- what the steps need -----------------------------------------------

    def sum_grads(self, grads: dict) -> None:
        """Finish the eq.-6 sum over the workers in place: a leaf on
        "data" is already summed over it by the reduce-scatter, and over
        "pod" here; any other leaf over every worker."""
        rest = []
        for name, g in grads.items():
            if self.data_dim(name) is None or self.D == 1:
                rest.append(g)
            elif self.group.pod_pg is not None:
                y = g.to(torch.float32, copy=True)
                dist.all_reduce(y, group=self.group.pod_pg)
                g.copy_(y)
        self.group.all_reduce_(rest)

    def prox(self, name: str, z: torch.Tensor, w0: torch.Tensor,
             beta: float, radius: Optional[float] = None) -> torch.Tensor:
        """The eq.-7 prox (``ops.dual_update``) of this rank's block of leaf
        ``name``, projected onto ``||w - w0|| <= radius`` by the whole
        leaf's norm: the block's squared norm summed over the ranks that
        hold the leaf's other blocks."""
        spec = self.specs[name]
        on_data = "data" in spec and self.D > 1
        if radius is None or not (on_data or "model" in spec):
            return kops.dual_update(z, w0, beta, radius)
        w = kops.dual_update(z, w0, beta)
        w0f = w0.float()
        delta = w - w0f
        flat = delta.reshape(-1)
        sq = torch.dot(flat, flat).reshape(1)
        if on_data:
            dist.all_reduce(sq, group=self.group.data_pg)
        if "model" in spec:
            self.all_reduce_model(sq)
        nrm = torch.sqrt(sq[0])
        return w0f + delta * torch.clamp(radius / torch.clamp(nrm, min=1e-30),
                                         max=1.0)

    def unshard_data(self, tree: dict) -> dict:
        """Each leaf of a block dict gathered over "data" where its spec
        puts it there (an FSDP x TP tree -> the serving layout's blocks,
        ``fsdp_axis=None``); the other leaves as they are (detached)."""
        out = {}
        for name, x in tree.items():
            x, dim = x.detach(), self.data_dim(name)
            if dim is not None and self.D > 1:
                parts = [torch.empty_like(x) for _ in range(self.D)]
                dist.all_gather(parts, x.contiguous(),
                                group=self.group.data_pg)
                x = torch.cat(parts, dim=dim)
            out[name] = x
        return out

    def checkpoint_blocks(self) -> "CheckpointBlocks":
        """This rank's :class:`CheckpointBlocks` under the layout."""
        return CheckpointBlocks(self)

    def whole(self, tree: dict) -> dict:
        """Every leaf of a block dict gathered whole (over "data" and
        "model"), on every rank: the session's primal for comparisons,
        not a checkpoint."""
        out = {}
        for name, x in tree.items():
            spec = self.specs[name]
            x = x.detach()
            for axis, pg, k in (("data", self.group.data_pg, self.D),
                                ("model", self.group.model_pg, self.M)):
                if axis in spec and k > 1:
                    parts = [torch.empty_like(x) for _ in range(k)]
                    dist.all_gather(parts, x.contiguous(), group=pg)
                    x = torch.cat(parts, dim=spec.index(axis))
            out[name] = x
        return out


class CheckpointBlocks:
    """The whole leaves of a checkpoint and this rank's blocks of them,
    for a worker spread over a model axis (``tp``).

    A state leaf is named by its path (``opt/z/blocks/attn/wq``): the
    longest tail that names a parameter (``blocks.attn.wq``) gives its
    spec, which holds for the parameter, its duals, its optimizer moments
    and a dual row alike; a per-worker row that names none is a message
    row (a pipelined payload, an async queue slot: W + 1 elements; a
    snapshot: W), laid out by the model ranks' :class:`RowBlock`; any
    other leaf (the epoch counts) is the same on every rank.  Every rank
    calls :meth:`whole` and :meth:`whole_row` on the same leaves in the
    same order (they are collectives over "data" and "model")."""

    def __init__(self, tp: TensorParallel):
        self.tp = tp
        mesh = tp.group.mesh
        coord = list(mesh.get_coordinate())
        at = axis_names(mesh).index("model")
        self.rows = []                  # each model coordinate's RowBlock
        for m in range(tp.M):
            coord[at] = m
            self.rows.append(row_block(tp.shapes, mesh, tuple(coord),
                                       tp.fsdp_axis))

    def name(self, key: str) -> Optional[str]:
        """The parameter a leaf's path names, or None."""
        parts = key.split("/")
        for i in range(len(parts)):
            name = ".".join(parts[i:])
            if name in self.tp.specs:
                return name
        return None

    def whole(self, key: str, leaf):
        """Leaf ``key`` whole (a parameter-named tensor gathered over
        "data" and "model" where it lies on them; else as it is)."""
        name = self.name(key)
        if name is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return self.tp.whole({name: leaf})[name]

    def whole_row(self, key: str, row: torch.Tensor) -> torch.Tensor:
        """This worker's row of per-worker leaf ``key`` whole, from this
        rank's block of it (``row``, its leading row dim gone), on every
        model rank of the worker."""
        name = self.name(key)
        if name is not None:
            return self.tp.whole({name: row})[name]
        parts = [torch.empty_like(row) for _ in range(self.tp.M)]
        dist.all_gather(parts, row.contiguous(),
                        group=self.tp.group.model_pg)
        count = row.numel() == self.rows[0].block_width   # W + 1, or W
        out = row.new_empty(self.rows[0].width - (not count))
        for rb, part in zip(self.rows, parts):
            rb.put(part, out)
        return out

    def cut(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf (or of a whole parameter
        row) ``key``."""
        name = self.name(key)
        if name is None:
            return whole
        mesh = self.tp.group.mesh
        return shard_leaf(whole, self.tp.specs[name], mesh,
                          mesh.get_coordinate())

    def cut_row(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of its worker's whole row of per-worker leaf
        ``key``."""
        if self.name(key) is not None:
            return self.cut(key, whole)
        rb = self.rows[self.tp.m]
        count = whole.numel() == rb.width
        return rb.take(whole, whole.new_empty(rb.block_width - (not count)))


ITEM = "ROADMAP.md, module item 4a.5.3"


def check_heads(cfg, model: int) -> None:
    """Refuse a head layout a model axis of ``model`` ranks cannot split:
    M must divide the query heads, and divide the KV heads or be a
    multiple of them (then M / KV ranks share a head, each holding
    ``hd / (M / KV)`` of its columns); RWKV6 (the ssm family): M must
    divide its ``d_model / 64`` heads, the head dim, the decay's LoRA rank
    and the ffn width, so that each rank holds whole heads and its block
    of every leaf; the hybrid: M must divide its Mamba2 heads and the
    shared block's ffn width, and its shared block's heads as a dense
    block's."""
    if cfg.family == "ssm":
        if any(n % model for n in (cfg.d_model // RWKV_HD, RWKV_HD, LORA,
                                   cfg.d_ff)):
            raise ValueError(f"model={model} must divide the "
                             f"{cfg.d_model // RWKV_HD} RWKV6 heads, the "
                             f"head dim 64, the decay's LoRA rank 64 and "
                             f"d_ff {cfg.d_ff} ({ITEM})")
        return
    if cfg.family == "hybrid":
        heads = mamba2_dims(cfg)[1]
        if heads % model or cfg.d_ff % model:
            raise ValueError(f"model={model} must divide the {heads} "
                             f"Mamba2 heads and the shared block's d_ff "
                             f"{cfg.d_ff} ({ITEM})")
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h % model or (kv % model and model % kv) \
            or (model > kv and cfg.hd % (model // kv)):
        raise ValueError(f"model={model} must divide the {h} query heads "
                         f"and divide the {kv} KV heads or be a multiple "
                         f"of them ({ITEM})")


def check_supported(cfg, model: int) -> None:
    """Refuse what a model axis of ``model`` ranks cannot run yet: a head
    layout it cannot split (:func:`check_heads`); every family runs."""
    check_heads(cfg, model)
