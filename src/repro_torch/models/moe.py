"""Top-k mixture-of-experts layer with grouped, capacity-bounded dispatch
(counterpart of ``repro.models.moe``).

Tokens are dispatched locally per group (a sequence, or at decode one
group of every token): each group's (token, choice) assignments are
sorted by expert id (a stable sort, as ``jnp.argsort``), ranked within
their expert, and scattered into a per-group (E, C, d) buffer; an
assignment ranked at or past the capacity C is dropped (it adds zeros at
rank 0).  The experts run as three batched products over (group, expert);
the combine gathers each kept assignment's output, weights it by its gate
and adds the k choices of each token in the output's dtype.  The JAX
package computes all of it outside any Pallas kernel, so the port keeps
it plain torch: a vector of groups where JAX vmaps, ``scatter_reduce``
(amin) for each expert's first sorted index, and gathers and scatters
along one axis whose indices never collide (an accumulating
``index_put`` took 37% of a 48-layer prefill's device time).

Under ``cfg.mxu_f32_accum`` the three expert products take bf16 operands
and return fp32 (JAX's ``preferred_element_type``): ``torch.bmm(...,
out_dtype=torch.float32)`` on the card where no gradient is taken
(prefill, decode: no fp32 copy of the weights is read), else fp32 copies
of one layer's operands (PyTorch registers the fp32-output bmm for CUDA
only, and no derivative for it; the copies' backward gives the gradient
in fp32 rounded to bf16, as JAX's transpose does).  bf16 products are
exact in fp32, so both forms accumulate the same terms in fp32.

The router runs in fp32 and its load-balance loss, ``e * sum(me * ce)``
over the whole batch (Switch), joins the main loss as ``0.01 * aux``.

Over a model axis (``moe_forward``'s ``tp``) each rank holds E / M
experts and their router columns, as JAX's layout splits them: the
routing is over all E (the logits gathered), each rank dispatches and
runs only its own experts, and their outputs and load-balance shares are
summed over "model".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ArchConfig, init_linear


class Layered:
    """A stacked leaf drawn a layer at a time (an expert leaf: its fp32
    draw at full width would be 39 GB for 48 layers).  Calling it draws
    the (layers, ...) leaf whole; :meth:`layer` draws the next layer's
    slice, so a caller can keep a block of each layer and never hold the
    stack (``repro_torch.dist.params.init_shards``)."""

    def __init__(self, layers: int, shape: tuple, dtype):
        self.layers, self.shape, self.dtype = layers, shape, dtype

    def layer(self, generator: torch.Generator) -> torch.Tensor:
        return init_linear(self.shape, self.dtype, generator)

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        w = torch.empty((self.layers,) + self.shape, dtype=self.dtype,
                        device=generator.device)
        for layer in range(self.layers):
            w[layer] = self.layer(generator)
        return w


def moe_plan(cfg: ArchConfig, layers: int) -> list:
    """``(name, make(generator))`` of the stacked (layers, ...) MoE leaves
    in draw order, JAX names and layout: the fp32 router (d, E), then the
    experts' (E, d, ff), (E, d, ff), (E, ff, d), each a :class:`Layered`."""
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.torch_dtype
    return [("router", lambda g: init_linear((layers, d, e), torch.float32,
                                             g)),
            ("w_gate", Layered(layers, (e, d, ff), dt)),
            ("w_up", Layered(layers, (e, d, ff), dt)),
            ("w_down", Layered(layers, (e, ff, d), dt))]


def moe_params(cfg: ArchConfig, generator: torch.Generator,
               layers: int) -> dict:
    """Stacked (layers, ...) MoE leaves, JAX names and layout
    (:func:`moe_plan`)."""
    return {k: make(generator) for k, make in moe_plan(cfg, layers)}


def num_groups(b: int, s: int) -> int:
    """JAX's group rule: per sequence, coarsened (halving while even and
    above 16) to at least 64 tokens a group; one group below that (decode
    scale)."""
    tokens, groups = b * s, b
    while groups > 16 and tokens // groups < 64 and groups % 2 == 0:
        groups //= 2
    return 1 if tokens // groups < 64 else groups


def capacity(cfg: ArchConfig, group_tokens: int) -> int:
    """Per-expert slots in a group (Python's round, as JAX's)."""
    return int(max(1, round(cfg.capacity_factor * group_tokens
                            * cfg.experts_per_token / cfg.num_experts)))


def _dispatch_group(xg: torch.Tensor, idx: torch.Tensor, e: int,
                    cap: int, experts: tuple = None) -> tuple:
    """xg (G, S, d), idx (G, S, k) -> buf (G, e1 - e0, cap, d) in xg's
    dtype and the metadata of the combine: the assignments to experts
    ``[e0, e1)`` (``experts``; default all ``e``), ranked among every
    assignment of the group.

    A kept assignment owns its (expert, rank) slot, so the scatter needs
    no accumulation; a dropped one goes to a spare slot ``cap`` of its
    expert that is cut off (JAX adds its zeros at rank 0: the same
    buffer), one to another expert to a spare expert row cut off too.
    """
    g, s, k = idx.shape
    d = xg.shape[-1]
    dev = idx.device
    e0, e1 = experts or (0, e)
    flat_e = idx.reshape(g, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    arange = torch.arange(s * k, device=dev).expand(g, -1)
    seg_start = torch.full((g, e), s * k, dtype=torch.long,
                           device=dev).scatter_reduce(
        1, sorted_e, arange, reduce="amin")
    rank = arange - torch.gather(seg_start, 1, sorted_e)
    keep = rank < cap
    local = sorted_e - e0
    if (e0, e1) != (0, e):
        keep = keep & (sorted_e >= e0) & (sorted_e < e1)
        local = torch.where((sorted_e >= e0) & (sorted_e < e1), local,
                            e1 - e0)
    token_of = torch.div(order, k, rounding_mode="floor")
    rows = torch.gather(xg, 1, token_of[..., None].expand(-1, -1, d))
    slot = local * (cap + 1) + torch.where(keep, rank, cap)
    n = e1 - e0 + int((e0, e1) != (0, e))
    buf = xg.new_zeros((g, n * (cap + 1), d)).scatter(
        1, slot[..., None].expand(-1, -1, d), rows)
    return (buf.view(g, n, cap + 1, d)[:, :e1 - e0, :cap],
            (order, local, rank, keep, token_of))


def _combine_group(y: torch.Tensor, gate: torch.Tensor, meta,
                   s: int) -> torch.Tensor:
    """y (G, e, cap, d), gate (G, S, k) -> (G, S, d) in y's dtype.

    Each token's k gate-weighted outputs are added one at a time in y's
    dtype, in ascending expert id: the order in which JAX's scatter-add
    meets them (the assignments are sorted by expert).  An assignment
    that is not kept (dropped, or to an expert ``y`` does not hold) adds
    zeros."""
    order, sorted_e, rank, keep, token_of = meta
    g, e, cap, d = y.shape
    k = gate.shape[-1]
    src = torch.where(keep, sorted_e * cap + rank, 0)
    gathered = torch.gather(y.reshape(g, e * cap, d), 1,
                            src[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    w = torch.gather(gate.reshape(g, s * k), 1, order)[..., None]
    contrib = gathered * w.to(y.dtype)                   # (G, S k, d)
    # regroup by token; a stable sort keeps each token's picks in the
    # sorted (ascending expert) order
    by_token = torch.argsort(token_of, dim=-1, stable=True)
    parts = torch.gather(contrib, 1, by_token[..., None].expand(
        -1, -1, d)).view(g, s, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out


def _expert_mm(a: torch.Tensor, w: torch.Tensor, f32: bool) -> torch.Tensor:
    """(G, e, c, i) x (e, i, o) -> (G, e, c, o): one bmm over the experts;
    fp32 out under ``f32`` (see the module docstring)."""
    g, e, c, i = a.shape
    lhs = a.transpose(0, 1).reshape(e, g * c, i)
    grad = torch.is_grad_enabled() and (lhs.requires_grad or w.requires_grad)
    if not f32:
        out = torch.bmm(lhs, w)
    elif lhs.is_cuda and not grad:
        out = torch.bmm(lhs, w, out_dtype=torch.float32)
    else:
        out = torch.bmm(lhs.float(), w.float())
    return out.reshape(e, g, c, -1).transpose(0, 1)


def moe_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                group=None, tp=None) -> tuple:
    """x: (B, S, d) -> (out (B, S, d), the fp32 load-balance loss).

    With ``group`` (one process per worker, the exact step) x is this
    worker's rows of the global batch and the loss is this worker's share
    of the global one: the (e,) routing counts are summed across the
    workers (they carry no gradient), and ``me`` is this worker's
    probability sum over the global token count, so the workers' losses
    and gradients sum to those of ``e * sum(me * ce)`` over the global
    batch.  The dispatch groups are sequences wherever ``num_groups``
    keeps them so (64 tokens a sequence or more), on a worker's rows as
    on the global batch.

    With ``tp`` (a :class:`repro_torch.dist.tp.TensorParallel` whose
    layout puts the experts on "model") ``p`` holds this rank's router
    columns and experts ``[e0, e1)``: the logits are all-gathered over
    "model" and the routing (top-k, the stable sort, the ranks within an
    expert, the capacity) is over all E, as in one process, so the kept
    and dropped assignments are the same; this rank dispatches and runs
    only its experts, and the combined partial outputs are summed over
    "model" (in fp32, rounded once).  The loss is the sum over "model" of
    each rank's share ``e * sum_{its experts} me * ce``.  Experts the
    layout does not split run whole on every model rank, with no
    collective."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    split = tp is not None and tp.experts_split()
    e0, e1 = tp.expert_range(cfg) if split else (0, e)
    if split:
        x = tp.copy(x)

    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    if split:
        logits = tp.router_logits(logits)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    counts = torch.zeros((e,), dtype=torch.float32,
                         device=x.device).index_add(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    if group is None:
        me = probs.mean((0, 1))
        ce = counts / (b * s * k)
    else:
        if num_groups(b, s) != b:
            raise ValueError(f"the MoE exact step over a process group "
                             f"dispatches by sequence: seq_len {s} < 64 "
                             f"would pool the global batch's sequences")
        with torch.no_grad():
            group.all_reduce_([counts])
        me = probs.sum((0, 1)) / (b * s * group.n)
        ce = counts / (b * s * k * group.n)
    aux = e * torch.sum(me[e0:e1] * ce[e0:e1])
    if split:
        aux = tp.reduce(aux)

    groups = num_groups(b, s)
    tg = b * s // groups
    cap = capacity(cfg, tg)
    buf, meta = _dispatch_group(x.reshape(groups, tg, d),
                                idx.reshape(groups, tg, k), e, cap,
                                (e0, e1))
    f32 = cfg.mxu_f32_accum
    g = F.silu(_expert_mm(buf, p["w_gate"], f32))
    u = _expert_mm(buf, p["w_up"], f32)
    y = _expert_mm((g * u).to(buf.dtype), p["w_down"], f32).to(x.dtype)
    out = _combine_group(y, gate.reshape(groups, tg, k), meta,
                         tg).reshape(b, s, d)
    return (tp.reduce(out) if split else out), aux
