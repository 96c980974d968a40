"""The port's mesh layer against the JAX package's: ``launch.mesh``,
``dist.sharding``, ``dist.params``, ``launch.specs``, the worker axes and
the torus of a mesh, a rank's shard of the stream, the per-rank gossip
round, and the ``TrainSpec`` mesh extents (``model``, ``pod``).

JAX's functions take duck-typed meshes (``axis_names`` and a ``shape``
dict), as the other port tests pass them; its parameter trees come from
``jax.eval_shape`` (no allocation), the port's from the ``meta`` device.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import specs as jspecs  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.dist import consensus as jconsensus  # noqa: E402
from repro.dist import params as jparams  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.launch import specs as jlspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import AMBSession, ClockSpec, TrainSpec  # noqa: E402
from repro_torch.data import (LMTokenStream, StreamSource,  # noqa: E402
                              local_rows)
from repro_torch.dist import consensus, group, params, sharding  # noqa
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.gossip_combine import own_row_table  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402


def _mesh(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
JNP_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float32): torch.float32}


def _jax_leaves(cfg_name: str) -> dict:
    tree = jlspecs.abstract_params(jconfigs.get_config(cfg_name))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jparams._path_name(path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def jax_trees():
    return {name: _jax_leaves(name) for name in jconfigs.ARCH_NAMES}


# ---------------------------------------------------------------------------
# TrainSpec: JAX's mesh extents
# ---------------------------------------------------------------------------

def test_trainspec_reads_a_spec_jax_wrote_with_model_and_pod():
    """The port's spec once lacked ``model`` and ``pod``: a spec JAX
    wrote raised ``TypeError``.  It now loads and gives back JAX's dict."""
    for spec in (jspecs.TrainSpec(data=4), jspecs.TrainSpec(data=2, pod=2),
                 jspecs.TrainSpec(arch="rwkv6-3b", smoke=True, seed=3)):
        mine = TrainSpec.from_json(spec.to_json())
        assert mine.to_dict() == spec.to_dict()


def test_session_json_with_model_and_pod_loads(tmp_path):
    """A ``session.json`` written through JAX's ``TrainSpec.to_dict``
    carries ``"model": 1, "pod": 1``; the session built from it is the
    one-process one with pod x data workers."""
    meta = {"train": jspecs.TrainSpec(smoke=True, data=2, pod=2,
                                      batch_per_worker=2,
                                      seq_len=8).to_dict()}
    (tmp_path / "session.json").write_text(json.dumps(meta))
    back = json.loads((tmp_path / "session.json").read_text())["train"]
    spec = TrainSpec.from_dict(back)
    assert spec.to_dict() == back
    session = AMBSession(spec, ClockSpec(kind="simulated"), device="cpu")
    assert session.n_workers == 4 and session.group is None


def test_restore_reads_a_session_json_with_model_and_pod(tmp_path):
    """``AMBSession.restore`` builds its spec from ``session.json``, which
    now carries JAX's ``"model": 1, "pod": 1`` (written through JAX's
    ``TrainSpec.to_dict`` here), and resumes the state."""
    from repro_torch.api import ConsensusSpec
    spec = TrainSpec(smoke=True, data=2, pod=2, batch_per_worker=1,
                     seq_len=4)
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              num_layers=1)
    session = AMBSession(spec, ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip"), cfg=cfg,
                         device="cpu")
    session.run(1, prefetch=0)
    session.save(tmp_path)
    copies = [tmp_path / "session.json",
              *(tmp_path / "session_state").glob("step_*/session.json")]
    assert len(copies) == 2
    for path in copies:               # the root copy and the step's
        meta = json.loads(path.read_text())
        meta["train"] = jspecs.TrainSpec(**meta["train"]).to_dict()
        assert (meta["train"]["model"], meta["train"]["pod"]) == (1, 2)
        path.write_text(json.dumps(meta))
    back = AMBSession.restore(tmp_path, step=None, cfg=cfg, device="cpu")
    assert back.train == spec and back.n_workers == 4
    for k, z in session.state["z"].items():
        assert torch.equal(back.state["z"][k], z)


def test_model_axis_is_refused_with_its_roadmap_item():
    with pytest.raises(ValueError, match="module item 4a"):
        TrainSpec(model=2)
    with pytest.raises(ValueError, match="module item 4a"):
        TrainSpec.from_json(jspecs.TrainSpec(model=2).to_json())


# ---------------------------------------------------------------------------
# Meshes, worker axes, the torus
# ---------------------------------------------------------------------------

def test_mesh_needs_an_initialised_group_of_the_right_size():
    with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
        tmesh.make_host_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        tmesh.make_production_mesh(device="cpu")
    assert tmesh.production_extents(True) == ((2, 16, 16),
                                              ("pod", "data", "model"))


@pytest.mark.parametrize("name", list(MESHES))
def test_worker_axes_count_and_torus_match_jax(name):
    m = _mesh(*MESHES[name])
    assert group.worker_axes(m) == jamb.worker_axes(m)
    assert group.num_workers(m) == jamb.num_workers(m)
    assert consensus.torus_shape_for_mesh(m) == \
        jconsensus.torus_shape_for_mesh(m)
    assert tmesh.mesh_shape(m) == m.shape
    assert tspecs.batch_axes(m) == jlspecs.batch_axes(m)


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", ["data", None])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_spec_equals_jax_for_every_leaf(jax_trees, arch, mesh_name,
                                              fsdp):
    m = _mesh(*MESHES[mesh_name])
    mine = tspecs.abstract_params(configs.get_config(arch))
    theirs = jax_trees[arch]
    assert {k.replace(".", "/") for k in mine} == set(theirs)
    for name, leaf in mine.items():
        want = jparams.param_spec(name.replace(".", "/"), leaf.shape, m,
                                  fsdp)
        assert params.param_spec(name, leaf.shape, m, fsdp) == \
            tuple(want), name
    specs = params.tree_specs({"z": mine, "t": 0}, m, fsdp)
    assert len(specs) == len(mine)
    assert specs["z.embed"] == params.param_spec("embed",
                                                 mine["embed"].shape, m, fsdp)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_abstract_params_shapes_and_dtypes_equal_jax(jax_trees, arch):
    mine = tspecs.abstract_params(configs.get_config(arch))
    for name, leaf in mine.items():
        want = jax_trees[arch][name.replace(".", "/")]
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want.shape), name
        assert leaf.dtype == JNP_DTYPES[jnp.dtype(want.dtype)], name


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh(*MESHES["2x2x2"])
    assert params.placements(("model", "data"), m) == (
        Replicate(), Shard(1), Shard(0))
    assert params.placements((("pod", "data"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert params.placements((), m) == (Replicate(),) * 3
    assert params.shard_extent((("pod", "data"), "model"), m) == 8
    tree = {"blocks.attn.wq": torch.empty((2, 8, 16), device="meta")}
    assert params.tree_shardings(tree, m) == {
        "blocks.attn.wq": (Replicate(), Shard(1), Shard(2))}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_equals_jax(mesh_name):
    m = _mesh(*MESHES[mesh_name])
    for logical in list(sharding.LOGICAL_AXES) + [None]:
        for dim in (1, 2, 3, 16, 32, 51865, 256):
            assert sharding._resolve(m, logical, dim) == \
                jsharding._resolve(m, logical, dim), (logical, dim)


def test_constrain_is_a_no_op_off_the_mesh_and_on_plain_tensors():
    x = torch.ones((4, 6))
    assert sharding.constrain(x, "batch", None) is x
    m = _mesh(*MESHES["4x2"])
    with sharding.use_sharding(m):
        assert sharding.active_mesh() is m
        assert sharding.constrain(x, "batch", "vocab") is x
    assert sharding.active_mesh() is None


# ---------------------------------------------------------------------------
# Abstract inputs and decode state
# ---------------------------------------------------------------------------

def _axes(entry):
    """A spec entry with a one-axis tuple written as the axis (JAX's
    PartitionSpec reads them alike)."""
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _spec_key(shape, spec):
    return tuple(int(s) for s in shape), tuple(_axes(e) for e in spec)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b", "zamba2-1.2b",
                                  "whisper-base", "qwen3-8b"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_decode_state_specs_equal_jax(arch, shape_name):
    shape = jconfigs.SHAPES[shape_name]
    m = _mesh(*MESHES["16x16"])
    jstate = jlspecs.abstract_decode_state(
        jconfigs.get_config(arch, shape=shape_name), shape)
    jspec = jlspecs.decode_state_specs(jstate, m, shape.global_batch)
    want = sorted(_spec_key(leaf.shape, sp) for leaf, sp in zip(
        jax.tree.leaves(jstate),
        jax.tree.leaves(jspec, is_leaf=lambda x: isinstance(x, P))))
    tstate = tspecs.abstract_decode_state(
        configs.get_config(arch, shape=shape_name),
        configs.SHAPES[shape_name])
    got = sorted(_spec_key(leaf.shape, sp) for leaf, sp in
                 tspecs.decode_state_specs(tstate, m, shape.global_batch))
    assert got == want


def test_input_specs_equal_jax():
    m = _mesh(*MESHES["2x16x16"])
    for arch in ("qwen2-1.5b", "whisper-base", "internvl2-76b"):
        for shape_name in ("train_4k", "prefill_32k"):
            jcfg = jconfigs.get_config(arch)
            shape = jconfigs.SHAPES[shape_name]
            fn = "train_input_specs" if shape.kind == "train" \
                else "prefill_input_specs"
            want = getattr(jlspecs, fn)(jcfg, shape, _JaxMesh(m))
            got = getattr(tspecs, fn)(configs.get_config(arch),
                                      configs.SHAPES[shape_name], m)
            assert set(got) == set(want)
            for k, sds in want.items():
                assert got[k].value.device.type == "meta"
                assert _spec_key(got[k].value.shape, got[k].spec) == \
                    _spec_key(sds.shape, sds.sharding.spec), (arch, k)
    assert tspecs.worker_batch_spec(m).spec == (("pod", "data"),)
    tok = tspecs.decode_token_spec(configs.SHAPES["decode_32k"], m)
    assert tuple(tok.value.shape) == (128,) and tok.spec == (
        ("pod", "data"),)


class _JaxMesh:
    """A duck mesh JAX's ``NamedSharding`` accepts in place of a Mesh:
    JAX builds the sharding without checking devices until it is used."""

    def __init__(self, m):
        self._m = jax.sharding.AbstractMesh(
            tuple(m.shape[a] for a in m.axis_names), tuple(m.axis_names))

    def __getattr__(self, name):
        return getattr(self._m, name)


# ---------------------------------------------------------------------------
# One process per worker: a rank's shard, a rank's gossip round
# ---------------------------------------------------------------------------

def test_a_ranks_shard_is_its_rows_of_the_global_batch():
    n, per = 4, 3
    stream = LMTokenStream(vocab_size=97, seq_len=8, seed=5, device="cpu")
    full = StreamSource(stream, n, per).batch(2)
    for r in range(n):
        mine = StreamSource(stream, n, per, rank=r).batch(2)
        rows = local_rows(full, r, n)
        for k in full:
            assert torch.equal(mine[k], rows[k])
            assert torch.equal(rows[k], full[k][r * per:(r + 1) * per])


@pytest.mark.parametrize("graph,n", [("ring", 4), ("ring", 5),
                                     ("torus", 4), ("torus", 6)])
def test_per_rank_gossip_round_equals_the_stacked_row_bit_for_bit(graph, n):
    """Each worker's K received rows in tap order through a (K, 1) table,
    against the stacked (n, D) round: the plain version and the CPU path
    of the kernel's wrapper, bit for bit, over three rounds."""
    rng = np.random.default_rng(n)
    m = torch.as_tensor(rng.standard_normal((n, 37)).astype(np.float32))
    strat = consensus.GossipConsensus(n, 3, graph)
    src = strat.source_rows("cpu")
    want = m.clone()
    for _ in range(3):
        want = ref.gossip_combine_ref(want, src, strat.taps.weights)
    rows = m.clone()
    for _ in range(3):
        nxt = torch.empty_like(rows)
        for r in range(n):
            plan = strat.rank_plan(r)
            buf = torch.stack([rows[r]] + [rows[s] for _, s, _ in plan])
            table = own_row_table(strat.taps.k, "cpu")
            out = torch.empty((1, m.shape[1]))
            ops.gossip_combine(buf, table, strat.taps.weights, out=out)
            assert torch.equal(out, ref.gossip_combine_ref(
                buf, table, strat.taps.weights))
            nxt[r] = out[0]
            for k, s, d in plan:     # who reads whom, both ways
                assert src[k, r] == s and src[k, d] == r
        rows = nxt
    assert torch.equal(rows, want)


def test_gossip_combine_takes_a_source_table_of_other_width():
    m = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    table = torch.tensor([[2, 0], [1, 1]], dtype=torch.int32)
    got = ops.gossip_combine(m, table, [0.5, 0.25])
    assert torch.equal(got, torch.stack([0.5 * m[2] + 0.25 * m[1],
                                         0.5 * m[0] + 0.25 * m[1]]))
    with pytest.raises(ValueError, match=r"\(2, 4\)"):
        ops.gossip_combine(m, table, [0.5, 0.25], out=torch.empty((3, 4)))


def test_session_torus_defaults_to_pod_by_data_in_one_process():
    spec = TrainSpec(smoke=True, pod=2, data=3, batch_per_worker=1,
                     seq_len=4)
    from repro_torch.api import ConsensusSpec
    session = AMBSession(spec, ClockSpec(kind="simulated"),
                         ConsensusSpec(consensus="gossip", graph="torus"),
                         cfg=dataclasses.replace(
                             configs.smoke_config("qwen2-1.5b"),
                             num_layers=1), device="cpu")
    assert session.n_workers == 6
    assert session.protocol.amb.torus_shape == (2, 3)
