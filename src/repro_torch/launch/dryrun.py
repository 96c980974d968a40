"""The CUDA-side cost model: every (arch x shape x mesh) combination
counted per rank on abstract inputs (counterpart of
``repro.launch.dryrun``).

JAX lowers and compiles each combination for 256 or 512 placeholder
devices and reads XLA's cost analysis and partitioned HLO.  Here nothing
is compiled and nothing allocated: one worker's share of the step runs on
``meta`` tensors (:mod:`repro_torch.launch.specs`) and is counted.

  * **Flops.** ``torch.utils.flop_counter.FlopCounterMode`` counts the
    aten products; each hand-written kernel the step launches
    (``dual_update``, ``flash_attention``, ``rwkv6_scan``) is replaced by
    a stand-in that returns its outputs' shapes and adds its flops and
    bytes by the formula of ``PERF.md``'s Bound column.  Its plain
    version never runs on ``meta``.
  * **Bytes.**  The HBM traffic is the inputs and outputs of every
    dispatched op (views excepted) plus the kernels' own: an upper bound,
    since it assumes no fusion.  The argument bytes are the parameters
    and the optimizer state, each divided by the extents
    :func:`repro_torch.dist.params.param_spec` assigns, plus the
    worker's batch: a lower bound on what a rank holds.
  * **Collectives**, from the layout by formula, in JAX's convention
    (result bytes per chip; ``traffic_bytes`` weighs an all-reduce twice):
    the FSDP all-gathers of the "data"-sharded leaves (forward and
    backward) and their gradient reduce-scatter, the "model" activation
    all-reduces (two a layer a pass), and the exact all-reduce of the
    gradients the workers do not shard (and across pods).
  * Per rank: a worker spans its ``model`` extent of chips, and its flops
    and HBM bytes are divided evenly over them (tensor parallelism splits
    each product; elementwise work is counted as split too, an
    approximation).

The roofline constants are the H100's (NVIDIA data sheet, SXM, dense,
700 W): 989e12 bf16 FLOP/s and 3.35e12 B/s of HBM; the link is one
400 Gb/s NDR InfiniBand NIC per GPU, 50e9 B/s, as in a DGX H100 node
(eight GPUs, eight ConnectX-7 ports): each 16-wide mesh axis spans two
8-GPU nodes, so its collectives cross that NIC.  No TPU figure is used.
JAX's ``parse_collectives``, ``_depth_variant`` and ``extrapolated_costs``
read XLA's HLO or undo its scan undercount; a count on ``meta`` has
neither, so they have no counterpart.

A step that cannot run on ``meta`` (a ``.item()``, a branch on a
value) fails its record with the reason and the run exits 1, as JAX's
``[FAIL]`` does; every family's steps run there today, the MoE dispatch
included (it sorts and scatters without reading a value back).  The meshes are
:class:`repro_torch.launch.mesh.AbstractMesh`; ``REPRO_DRYRUN_MESH=d,m``
(or ``p,d,m``) replaces the production mesh, as in JAX.

  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_NAMES, SHAPES, InputShape, get_config
from ..dist.amb import make_train_step
from ..dist.params import param_spec, shard_extent
from ..kernels import ops as kops
from ..models import decode_step, prefill
from ..optim import DualAveragingOpt
from . import specs as S
from .mesh import AbstractMesh, abstract, mesh_shape, production_extents

# H100 SXM constants for the roofline (see the module note)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per chip, dense
HBM_BW = 3.35e12             # bytes/s per chip
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR NIC per GPU
RWKV_CHUNK = 16              # the scan kernel's chunk

_TRAFFIC_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                   "reduce-scatter": 1.0, "all-to-all": 1.0,
                   "collective-permute": 1.0}
_FREE = ("empty", "empty_strided", "empty_like", "detach", "lift_fresh",
         "alias")


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) training; 2*N*D for fwd-only."""
    n_params = cfg.param_count()
    if cfg.is_moe:
        d, ff, e, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
        moe_total = cfg.num_layers * e * 3 * d * ff
        moe_active = cfg.num_layers * k * 3 * d * ff
        n_params = n_params - moe_total + moe_active
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params * tokens


# ---------------------------------------------------------------------------
# Counting on meta
# ---------------------------------------------------------------------------

def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensors each dispatched op reads and writes
    (view ops and allocations move nothing and are left out)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not (func.is_view or name in _FREE):
            self.ops += 1
            self.bytes += sum(_nbytes(x) for x in tree_leaves(
                (args, kwargs or {}, out)))
        return out


def attention_pairs(sq: int, skv: int, causal: bool, window: int,
                    q_offset: int) -> int:
    """(query, key) pairs the flash kernel takes: query i sits at key
    position ``i + q_offset``; causal keeps keys at or before it, a
    window the last ``window`` of those."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo, 0).sum())


@dataclasses.dataclass
class _Kernels:
    """Stand-ins for the hand-written kernels: outputs on ``meta``, flops
    and bytes by formula, launches counted."""

    flops: float = 0.0
    bytes: float = 0.0
    launches: dict = dataclasses.field(default_factory=dict)

    def _add(self, name, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes
        self.launches[name] = self.launches.get(name, 0) + 1

    def dual_update(self, z, w0, beta, radius=None, force=None):
        n = z.numel()
        self._add("dual_update", 2 * n, n * (4 + w0.element_size() + 4))
        return torch.empty(z.shape, dtype=torch.float32, device=z.device)

    def flash_attention(self, q, k, v, *, causal=True, window=0, q_offset=0,
                        force=None):
        b, h, sq, hd = q.shape
        pairs = attention_pairs(sq, k.shape[2], causal, window, q_offset)
        self._add("flash_attention", 4 * b * h * hd * pairs,
                  2 * _nbytes(q) + _nbytes(k) + _nbytes(v))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def rwkv6_scan(self, r, k, v, decay, u, force=None):
        b, h, s, hd = r.shape
        n = b * h * s * hd
        flops = b * h * s * (4 * hd * hd + 2 * (RWKV_CHUNK - 1) * hd + 5 * hd)
        nbytes = (_nbytes(r) + _nbytes(k) + _nbytes(v) + _nbytes(decay)
                  + _nbytes(u) + 4 * n + 4 * b * h * hd * hd)
        self._add("rwkv6_scan", flops, nbytes)
        return (torch.empty((b, h, s, hd), dtype=torch.float32,
                            device=r.device),
                torch.empty((b, h, hd, hd), dtype=torch.float32,
                            device=r.device))


@contextlib.contextmanager
def _stand_ins(kernels: _Kernels):
    names = ("dual_update", "flash_attention", "rwkv6_scan")
    saved = {n: getattr(kops, n) for n in names}
    try:
        for n in names:
            setattr(kops, n, getattr(kernels, n))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kops, n, fn)


# ---------------------------------------------------------------------------
# One worker's step
# ---------------------------------------------------------------------------

def _workers(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in S.batch_axes(mesh))


def _local_rows(batch: int, mesh) -> int:
    """A worker's rows: the batch over the worker axes where they divide
    it (JAX's ``_bspec``), else the whole batch on every worker."""
    n = _workers(mesh)
    return batch // n if batch % n == 0 else batch


def _local(specs: dict, rows: int) -> dict:
    return {k: torch.empty((rows,) + tuple(v.value.shape[1:]),
                           dtype=v.value.dtype, device="meta")
            for k, v in specs.items()}


def _run_step(cfg, shape: InputShape, mesh, params: dict):
    """Run one worker's share of the (cfg, shape) step on ``meta``."""
    rows = _local_rows(shape.global_batch, mesh)
    if shape.kind == "train":
        for p in params.values():
            p.requires_grad_(True)
        opt = DualAveragingOpt()
        state = opt.init(params)
        batch = _local(S.train_input_specs(cfg, shape, mesh), rows)
        b = torch.full((1,), rows, dtype=torch.int32, device="meta")
        step = make_train_step(cfg, opt, 1)
        with torch.no_grad():
            step(params, state, batch, b)
        return
    with torch.no_grad():
        if shape.kind == "prefill":
            prefill(params, cfg, _local(
                S.prefill_input_specs(cfg, shape, mesh), rows))
            return
        local = dataclasses.replace(shape, global_batch=rows)
        st = S.abstract_decode_state(cfg, local)
        decode_step(params, cfg, st, torch.empty(
            (rows,), dtype=torch.int32, device="meta"))


def _count(cfg, shape: InputShape, mesh) -> dict:
    params = S.abstract_params(cfg)
    kernels = _Kernels()
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with _stand_ins(kernels), flops, counter:
        _run_step(cfg, shape, mesh, params)
    return {"aten_flops": float(flops.get_total_flops()),
            "aten_bytes": float(counter.bytes), "aten_ops": counter.ops,
            "kernel_flops": kernels.flops, "kernel_bytes": kernels.bytes,
            "kernel_launches": kernels.launches}


# ---------------------------------------------------------------------------
# Layout: argument bytes and collectives
# ---------------------------------------------------------------------------

def _layout(cfg, shape: InputShape, mesh) -> dict:
    """Per-rank argument and output bytes and the collectives' result
    bytes, from the parameter layout."""
    ms = mesh_shape(mesh)
    m = ms.get("model", 1)
    e = ms.get("data", 1)
    pods = ms.get("pod", 1)
    n = _workers(mesh)
    train = shape.kind == "train"
    fsdp = "data" if (train or cfg.is_moe) else None
    params = S.abstract_params(cfg)
    coll = {op: {"bytes": 0.0, "count": 0} for op in _TRAFFIC_FACTOR}

    def add(op, nbytes, count=1):
        coll[op]["bytes"] += float(nbytes)
        coll[op]["count"] += count

    param_bytes = state_bytes = 0.0
    for name, leaf in params.items():
        spec = param_spec(name, leaf.shape, mesh, fsdp)
        ways = shard_extent(spec, mesh)
        full = leaf.numel()
        param_bytes += full * leaf.element_size() / ways
        sharded = "data" in spec
        model_part = ways // (e if sharded else 1)
        if train:
            # dual averaging: fp32 z and fp32 w0 beside the parameter
            state_bytes += 8 * full / ways
        if sharded and (train or cfg.is_moe):
            # gather the d_model side before use (backward: again)
            add("all-gather", full * leaf.element_size() / model_part,
                2 if train else 1)
        if not train:
            continue
        if sharded:
            add("reduce-scatter", 4 * full / model_part / e)
            if pods > 1:
                add("all-reduce", 4 * full / model_part / e)
        elif n > 1:
            add("all-reduce", 4 * full / model_part)
    rows = _local_rows(shape.global_batch, mesh)
    tokens = rows * (shape.seq_len if shape.kind != "decode" else 1)
    if m > 1:
        passes = 4 if train else 2
        layers = cfg.num_layers + (cfg.encoder_layers or 0)
        add("all-reduce", tokens * cfg.d_model * 2, passes * layers)
    if shape.kind == "train":
        batch = sum(_nbytes(v.value) * rows // v.value.shape[0]
                    for v in S.train_input_specs(cfg, shape, mesh).values())
        args = param_bytes + state_bytes + batch
        outs = param_bytes + state_bytes
    elif shape.kind == "prefill":
        batch = sum(_nbytes(v.value) * rows // v.value.shape[0]
                    for v in S.prefill_input_specs(cfg, shape, mesh).values())
        local = dataclasses.replace(shape, global_batch=rows)
        cache = _state_bytes(cfg, local, mesh, rows)
        args = param_bytes + batch
        outs = cache + rows * cfg.vocab_size * 2 / m
    else:
        local = dataclasses.replace(shape, global_batch=rows)
        cache = _state_bytes(cfg, local, mesh, rows)
        args = param_bytes + cache + 4 * rows
        outs = cache + rows * cfg.vocab_size * 2 / m
    for v in coll.values():
        v["count"] = int(v["count"])
    coll["traffic_bytes"] = sum(coll[op]["bytes"] * _TRAFFIC_FACTOR[op]
                                for op in _TRAFFIC_FACTOR)
    return {"argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(outs),
            "param_bytes_per_rank": int(param_bytes),
            "opt_state_bytes_per_rank": int(state_bytes),
            "collectives": coll}


def _state_bytes(cfg, local: InputShape, mesh, rows: int) -> float:
    """A worker's decode state, its "model"-sharded dims divided out."""
    st = S.abstract_decode_state(cfg, local)
    total = 0.0
    for leaf, spec in S.decode_state_specs(st, mesh, rows):
        ways = shard_extent(tuple(a if a == "model" else None for a in spec),
                            mesh)
        total += _nbytes(leaf) / ways
    return total


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

def _mesh(multi_pod: bool) -> AbstractMesh:
    """Production mesh, or a reduced one via REPRO_DRYRUN_MESH=d,m."""
    override = os.environ.get("REPRO_DRYRUN_MESH")
    if override:
        dims = tuple(int(x) for x in override.split(","))
        return abstract(dims, ("pod", "data", "model")[-len(dims):])
    return abstract(*production_extents(multi_pod))


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: Path,
            consensus: str = "exact", *, cfg=None,
            shape: Optional[InputShape] = None,
            mesh: Optional[AbstractMesh] = None) -> dict:
    """Count one combination and write its record; ``cfg``, ``shape`` and
    ``mesh`` replace the registered ones (a depth-cut config, a session's
    own batch, a small mesh)."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch, shape=shape_name)
    mesh = mesh or _mesh(multi_pod)
    ms = mesh_shape(mesh)
    chips = math.prod(ms.values())
    mesh_name = "x".join(str(ms[a]) for a in mesh.axis_names)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "kind": shape.kind, "consensus": consensus,
           "workers": _workers(mesh),
           "rows_per_worker": _local_rows(shape.global_batch, mesh)}
    t0 = time.time()
    counted = _count(cfg, shape, mesh)
    rec["count_s"] = round(time.time() - t0, 2)
    m = ms.get("model", 1)
    rec.update(counted)
    rec["flops"] = (counted["aten_flops"] + counted["kernel_flops"]) / m
    rec["bytes"] = (counted["aten_bytes"] + counted["kernel_bytes"]) / m
    rec["bytes_is_upper_bound"] = True       # no fusion assumed
    rec.update(_layout(cfg, shape, mesh))
    rec["model_flops"] = model_flops(cfg, shape)
    rec["compute_s_roofline"] = rec["flops"] / PEAK_FLOPS
    rec["memory_s_roofline"] = rec["bytes"] / HBM_BW
    rec["collective_s_roofline"] = (
        rec["collectives"]["traffic_bytes"] / LINK_BW)
    terms = {"compute": rec["compute_s_roofline"],
             "memory": rec["memory_s_roofline"],
             "collective": rec["collective_s_roofline"]}
    rec["dominant_term"] = max(terms, key=terms.get)
    rec["useful_flops_frac"] = (
        rec["model_flops"] / (rec["flops"] * chips) if rec["flops"] else 0.0)
    rec["constants"] = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                        "link_bw": LINK_BW}
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / f"{arch}__{shape_name}__{mesh_name}.json"
    path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "x".join(
                    str(s) for s in (_mesh(mp).shape.values()))
                path = outdir / f"{arch}__{shape}__{mesh_name}.json"
                if args.skip_existing and path.exists():
                    print(f"[skip] {arch} {shape} {mesh_name}")
                    continue
                t0 = time.time()
                try:
                    rec = run_one(arch, shape, mp, outdir)
                    print(f"[ok]   {arch:22s} {shape:12s} {mesh_name:8s} "
                          f"flops={rec['flops']:.3e} "
                          f"dom={rec['dominant_term']:10s} "
                          f"({time.time()-t0:.0f}s)", flush=True)
                except Exception as e:
                    failures.append((arch, shape, mesh_name, str(e)))
                    print(f"[FAIL] {arch} {shape} {mesh_name}: {e}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
