"""Every public name of the JAX package is importable from its port.

One case per module of ``src/repro``: its ``__all__``, or without one
the functions and classes it defines, each an attribute of the port's
module of the same path under ``repro_torch``.  The listed exceptions are
names only XLA has (the dry-run's HLO parsing and depth extrapolation,
the scan-or-unroll switch of the compiled loops).  Beside them, one case
per module for each of:

  * its public module-level constants (every top-level assignment to a
    public name: ``GRAPHS``, the alias ``TrainState``), JAX's type
    aliases (``Array = jax.Array``, ``PyTree = Any`` or ``object``) and
    the Pallas tiles' constants excepted;
  * the public methods, class methods and properties of its public
    classes (``MeasuredClock.times``), the pytree hooks excepted;
  * each parameter of its public functions and classes (a class: its
    constructor), which the port's signature must name unless it takes
    ``**kwargs``: the listed exceptions are the arguments the port takes
    in its own form (ROADMAP.md §3: a ``key`` is a ``torch.Generator`` or
    a draws seam, a ``mesh`` and its batch placement a ``WorkerGroup``,
    ``gossip_combine``'s stack a source-row table, the online softmax's
    chunk sizes).

Beside the names: ``ring_p`` and ``ring_gossip`` against JAX's on one
(4, 33) stack, and ``models.attention.flash_attention`` against JAX's at
its own (B, S, KV, G, hd) layout, causal and windowed, in fp32.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; JAX's backend is started first here and the variable restored
after the imports, as ``tests/test_torch_dryrun.py`` does.
"""
import importlib
import inspect
import os
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.devices()                       # the backend, before the flags change
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_MODULES = sorted(
    "repro" + "".join(f".{p}" for p in path.relative_to(
        ROOT / "src" / "repro").with_suffix("").parts if p != "__init__")
    for path in (ROOT / "src" / "repro").rglob("*.py"))
# names only XLA has (ROADMAP.md §3): HLO collectives parsing and the
# depth extrapolation of compiled costs; the scan-or-unroll switch
XLA_ONLY = {
    "repro.launch.dryrun": {"parse_collectives", "extrapolated_costs"},
    "repro.models.common": {"scan_or_unroll", "unroll_active",
                            "unrolled_loops"},
}
F32 = dict(rtol=1e-5, atol=1e-5)     # as tests/test_torch_attention.py
# constants of the Pallas kernels' tiles (the TPU's lane width, a block)
TPU_ONLY = {"repro.kernels.dual_update": {"LANE", "DEFAULT_BLOCK"},
            "repro.kernels.gossip_combine": {"LANE"},
            "repro.kernels.flash_attention": {"NEG_INF"}}
# JAX's pytree registration hooks, and the JAX dtype (the port's is
# ``torch_dtype``)
XLA_METHODS = {"tree_flatten", "tree_unflatten", "jdtype"}
# arguments the port takes in its own form (ROADMAP.md §3): JAX's PRNG
# ``key`` (a torch.Generator or a draws seam), a ``mesh`` (a WorkerGroup)
# and the batch placement over it
ANY_KEYWORD = {"key", "mesh", "batch_axes", "put"}
OWN_FORM = {
    # a (K, n_out) source-row table over the rows: (m, src, weights)
    ("repro.kernels.ops", "gossip_combine"): {"msgs"},
    ("repro.kernels.ref", "gossip_combine_ref"): {"msgs"},
    # the chunk sizes of JAX's pure-jnp online softmax
    ("repro.models.common", "ArchConfig"): {"q_chunk", "kv_chunk"},
}


def _public(module) -> list:
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [k for k, v in vars(module).items()
            if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__]


def _import_jax(name: str):
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


def _constants(module) -> list:
    """The public names a module assigns at its top level, JAX's type
    aliases left out."""
    import ast
    import typing
    tree = ast.parse(inspect.getsource(module))
    out = []
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) \
            and node.value is not None else []
        for t in targets:
            if not isinstance(t, ast.Name) or t.id.startswith("_"):
                continue
            value = getattr(module, t.id)
            where = getattr(value, "__module__", None) or ""
            if value is typing.Any or value is object or where.split(
                    ".")[0] in ("jax", "jaxlib", "typing"):
                continue
            out.append(t.id)
    return out


def _classes(module) -> list:
    return [(n, v) for n, v in vars(module).items()
            if n in _public(module) and inspect.isclass(v)
            and v.__module__ == module.__name__]


def _signature_names(fn):
    """The parameter names of ``fn`` (a class: its constructor), or None
    where it has no signature or takes ``**kwargs``."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    kinds = {p.kind for p in sig.parameters.values()}
    if inspect.Parameter.VAR_KEYWORD in kinds:
        return None
    return {k for k, p in sig.parameters.items()
            if p.kind is not inspect.Parameter.VAR_POSITIONAL}


def test_every_jax_module_is_listed():
    assert len(JAX_MODULES) >= 50
    assert "repro.dist.amb" in JAX_MODULES and "repro.data" in JAX_MODULES
    assert set(XLA_ONLY) <= set(JAX_MODULES)


@pytest.mark.parametrize("name", JAX_MODULES)
def test_jax_public_names_are_in_the_port(name):
    jmod = _import_jax(name)
    port = importlib.import_module(name.replace("repro", "repro_torch", 1))
    names = _public(jmod)
    missing = sorted(n for n in names if not hasattr(port, n))
    assert missing == sorted(XLA_ONLY.get(name, ())), (name, missing)
    for n in names:
        if n in XLA_ONLY.get(name, ()):
            continue
        exec(f"from {port.__name__} import {n}", {})


@pytest.mark.parametrize("name", JAX_MODULES)
def test_jax_constants_are_in_the_port(name):
    """Each public module-level constant of the JAX module (``GRAPHS``,
    ``TrainState``) is an attribute of the port's module of the same
    kind: a dict a dict, a class the same class or a class."""
    jmod = _import_jax(name)
    port = importlib.import_module(name.replace("repro", "repro_torch", 1))
    consts = [c for c in _constants(jmod)
              if c not in TPU_ONLY.get(name, ())]
    missing = sorted(c for c in consts if not hasattr(port, c))
    assert missing == [], (name, missing)
    for c in consts:
        want, got = getattr(jmod, c), getattr(port, c)
        if isinstance(want, dict):
            assert isinstance(got, dict) and sorted(got) == sorted(want), c
        elif inspect.isclass(want):
            assert inspect.isclass(got), c


@pytest.mark.parametrize("name", JAX_MODULES)
def test_jax_class_methods_are_in_the_port(name):
    """Each public method, class method, static method and property of
    a public JAX class (``MeasuredClock.times``) is an attribute of the
    port's class of the same name."""
    jmod = _import_jax(name)
    port = importlib.import_module(name.replace("repro", "repro_torch", 1))
    missing = []
    for cname, cls in _classes(jmod):
        if cname in XLA_ONLY.get(name, ()):
            continue
        pcls = getattr(port, cname)
        for attr, v in vars(cls).items():
            if attr.startswith("_") or attr in XLA_METHODS:
                continue
            if (inspect.isfunction(v) or isinstance(
                    v, (staticmethod, classmethod, property))) \
                    and not hasattr(pcls, attr):
                missing.append(f"{cname}.{attr}")
    assert missing == [], (name, missing)


@pytest.mark.parametrize("name", JAX_MODULES)
def test_jax_keywords_are_in_the_port_signatures(name):
    """Each parameter of a public JAX function or class (its
    constructor) is named in the port's signature (``max_rounds`` of
    ``gossip``, ``return_kv`` of ``attend_train``, ``cross_len`` of
    ``decode_attend``), bar the arguments the port takes in its own
    form."""
    jmod = _import_jax(name)
    port = importlib.import_module(name.replace("repro", "repro_torch", 1))
    missing = []
    for n in _public(jmod):
        if n in XLA_ONLY.get(name, ()):
            continue
        want = getattr(jmod, n)
        if not (inspect.isfunction(want) or inspect.isclass(want)):
            continue
        jnames = _signature_names(want)
        pnames = _signature_names(getattr(port, n))
        if jnames is None or pnames is None:
            continue
        skip = ANY_KEYWORD | OWN_FORM.get((want.__module__, n), set())
        missing += [f"{n}({k}=)" for k in sorted(jnames - pnames - skip)]
    assert missing == [], (name, missing)


@pytest.mark.parametrize("rounds,lazy", [(1, 0.5), (3, 0.5), (4, 0.3)])
def test_ring_gossip_and_ring_p_match_jax(rounds, lazy):
    from repro.dist import amb as jamb
    from repro_torch.dist import amb
    for n in (1, 2, 4):
        np.testing.assert_array_equal(amb.ring_p(n, lazy),
                                      jamb.ring_p(n, lazy))
    m = np.random.default_rng(rounds).standard_normal((4, 33)).astype(
        np.float32)
    want = np.asarray(jamb.ring_gossip(jnp.asarray(m), rounds, lazy))
    got = amb.ring_gossip(torch.from_numpy(m.copy()), rounds, lazy)
    # the tolerance of tests/test_torch_dist.py's gossip cases
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# (B, Sq, Skv, KV, G, hd, causal, window, q_offset, with kv_valid)
FLASH_CASES = [
    (2, 37, 37, 2, 3, 16, True, 0, 0, False),
    (1, 64, 64, 1, 4, 32, True, 16, 0, False),
    (2, 9, 40, 2, 2, 16, True, 0, 31, False),
    (1, 5, 50, 2, 1, 32, True, 12, 45, True),
    (2, 33, 21, 1, 2, 16, False, 0, 0, True),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax(case):
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    b, sq, skv, kv, g, hd, causal, window, q_offset, masked = case
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((b, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, hd)).astype(np.float32)
    valid = None
    if masked:
        valid = rng.random((b, skv)) < 0.7
        valid[:, 0] = True           # every query row sees a key
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset,
        kv_valid=None if valid is None else jnp.asarray(valid),
        q_chunk=16, kv_chunk=16))
    got = attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset,
        kv_valid=None if valid is None else torch.from_numpy(valid))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)
