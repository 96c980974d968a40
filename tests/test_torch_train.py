"""The port's train path against the JAX package's: the optimizers, the
specs' JSON and CLI surface, FMB epochs in the session, the prefetched
data plane and the train CLI (``repro_torch.launch.train``).

Tolerances: the optimizers on the same grads, rtol 1e-6 (measured equal
on the CPU); session losses, rtol 1e-5 and parameters rtol 1e-5 / atol
1e-6 (fp32 smoke model, another summation order); simulated wall clocks,
rel 1e-6.
"""
import argparse
import dataclasses
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.api import specs as jspecs  # noqa: E402
from repro.api.session import AMBSession as JAMBSession  # noqa: E402
from repro.core import stragglers as jstr  # noqa: E402
from repro.dist import amb as jamb  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             ControllerSpec, TrainSpec, clock)
from repro_torch.data import LMTokenStream, StreamSource  # noqa: E402
from repro_torch.kernels import router  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.metrics import read_metrics  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402

N, PER, SEQ = 4, 2, 16
STANDIN = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": N, "model": 1})
TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ)
SMOKE = ["--smoke", "--data", str(N), "--batch-per-worker", str(PER),
         "--seq-len", str(SEQ), "--sim-clock"]
# JAX CLI flags of modules the port has not taken yet (none since coded
# redundancy, faults and the controller); --model and --pod are TrainSpec's
# mesh extents, as in JAX
UNPORTED_FLAGS: set = set()
# the port's own: the process-group backend of one process per worker
# (JAX runs its workers as one SPMD program and has no such flag), and the
# device a command-line run asks for (the port's entry points run on the
# card unless told otherwise)
PORT_FLAGS = {"--dist-backend", "--device"}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", dict(lr=1e-2, weight_decay=0.1, b2=0.999)),
    ("sgd", {}), ("sgd", dict(lr=0.1, momentum=0.9))])
def test_optimizers_match_jax_on_the_same_grads(name, kw):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    mine, ref = opt.make_optimizer(name, **kw), jopt.make_optimizer(name,
                                                                    **kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = mine.init(tp), ref.init(jp)
    for _ in range(6):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ts = mine.apply({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        jp, js = ref.apply({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    if name == "adamw":
        assert ts["t"] == int(js["t"]) == 6


def test_optimizer_defaults_and_bf16_params():
    for name in ("dual_averaging", "adamw", "sgd"):
        mine = opt.make_optimizer(name)
        ref = jopt.make_optimizer(name)
        assert type(mine).__name__ == type(ref).__name__
    with pytest.raises(KeyError):
        opt.make_optimizer("lion")
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    a = opt.AdamW(lr=0.5)
    st = a.init(p)
    assert st["m"]["w"].dtype == torch.float32
    a.apply({"w": torch.ones(4, dtype=torch.bfloat16)}, st, p)
    assert p["w"].dtype == torch.bfloat16 and float(p["w"][0]) == 0.5


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_spec_json_roundtrip():
    specs = [TrainSpec(arch="rwkv6-3b", smoke=True, data=4,
                       optimizer="adamw", mode="fmb", seed=7, kernels="ref",
                       redundancy=2),
             ControllerSpec(enabled=True, interval=2, warmup=1, d_max=3,
                            batch=False, max_step=1.5),
             ClockSpec(kind="simulated", compute_time=0.0, comm_time=1.5,
                       straggler="deterministic"),
             ConsensusSpec(consensus="gossip_q4", graph="torus",
                           torus_shape=(2, 4), gossip_rounds=9,
                           beta_mu=16.0)]
    for spec in specs:
        s = spec.to_json()
        back = type(spec).from_json(s)
        assert back == spec and back.to_json() == s
        assert type(spec).from_dict(spec.to_dict()) == spec
    assert ConsensusSpec.from_json(ConsensusSpec(
        torus_shape=(2, 4)).to_json()).torus_shape == (2, 4)
    assert specs[0].replace(seed=1).seed == 1
    assert ClockSpec(compute_time=0.0).resolve_budget(3.5) == 0.0
    assert ClockSpec().resolve_budget(3.5) == 3.5
    # the port's spec fields are JAX's, with JAX's defaults
    for mine, ref in ((TrainSpec, jspecs.TrainSpec),
                      (ClockSpec, jspecs.ClockSpec),
                      (ConsensusSpec, jspecs.ConsensusSpec),
                      (ControllerSpec, jspecs.ControllerSpec)):
        theirs = {f.name: f.default for f in dataclasses.fields(ref)}
        for f in dataclasses.fields(mine):
            assert theirs[f.name] == f.default, f.name


def _options(ap):
    return {s: a for a in ap._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


def test_cli_flags_names_defaults_and_choices_match_jax():
    mine, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    for spec in (TrainSpec, ClockSpec, ConsensusSpec, ControllerSpec):
        spec.add_cli_args(mine)
    for spec in (jspecs.TrainSpec, jspecs.ClockSpec, jspecs.ConsensusSpec,
                 jspecs.ControllerSpec):
        spec.add_cli_args(ref)
    got, want = _options(mine), _options(ref)
    assert set(got) == set(want)
    for flag, action in got.items():
        other = want[flag]
        assert action.dest == other.dest, flag
        assert action.default == other.default, flag
        assert action.choices == other.choices, flag
        assert type(action) is type(other), flag
    args = mine.parse_args([])
    assert TrainSpec.from_args(args) == TrainSpec()
    assert ClockSpec.from_args(args) == ClockSpec()
    assert ConsensusSpec.from_args(args) == ConsensusSpec()
    args = mine.parse_args([
        "--smoke", "--data", "4", "--batch-per-worker", "2", "--seq-len",
        "32", "--seed", "3", "--optimizer", "sgd", "--mode", "fmb",
        "--kernels", "ref", "--sim-clock", "--compute-time", "0.0",
        "--comm-time", "2.0", "--consensus", "gossip", "--graph", "torus",
        "--gossip-rounds", "7", "--async", "--staleness", "3"])
    assert TrainSpec.from_args(args) == TrainSpec(
        smoke=True, data=4, batch_per_worker=2, seq_len=32, seed=3,
        optimizer="sgd", mode="fmb", kernels="ref")
    assert ClockSpec.from_args(args) == ClockSpec(
        kind="simulated", compute_time=0.0, comm_time=2.0)
    assert ConsensusSpec.from_args(args) == ConsensusSpec(
        consensus="gossip", graph="torus", gossip_rounds=7,
        async_epochs=True, staleness=3)
    assert ConsensusSpec.from_args(mine.parse_args(["--pipeline"])) == \
        ConsensusSpec(pipeline=True)


def test_train_cli_flags_are_jax_less_the_unported(monkeypatch):
    """The train CLI's parser holds JAX's train flags, with their dests,
    defaults and choices, less the flags of modules not yet ported."""
    from repro.launch.train import main as jmain
    parsers = []

    def grab(self, *args, **kw):
        parsers.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for fn in (jmain, lambda argv: main(argv, device="cpu")):
        with pytest.raises(SystemExit):
            fn([])
    want, got = (_options(ap) for ap in parsers)
    assert set(want) - set(got) == UNPORTED_FLAGS
    assert set(got) - set(want) == PORT_FLAGS
    for flag, action in got.items():
        if flag in PORT_FLAGS:
            continue
        other = want[flag]
        assert (action.dest, action.default, action.choices) == (
            other.dest, other.default, other.choices), flag


NEW_FLAGS = ["--redundancy", "2", "--controller", "--controller-interval",
             "1", "--controller-warmup", "2", "--controller-dmax", "3",
             "--churn", "0.25", "--churn-rejoin", "0.4", "--churn-seed",
             "7"]


def test_new_train_flags_parse_to_jax_specs(monkeypatch):
    """Coded redundancy, the controller and churn: both CLIs parse the
    same argv to specs whose ``to_dict`` is JAX's (the mesh extents
    included) and to the same churn model."""
    from repro.launch.train import main as jmain
    parsers = []

    def grab(self, *args, **kw):
        parsers.append(self)
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for fn in (jmain, lambda argv: main(argv, device="cpu")):
        with pytest.raises(SystemExit):
            fn([])
    want, got = (real(ap, NEW_FLAGS) for ap in parsers)
    mine = TrainSpec.from_args(got).to_dict()
    theirs = jspecs.TrainSpec.from_args(want).to_dict()
    assert mine == theirs
    assert mine["redundancy"] == 2
    assert ControllerSpec.from_args(got).to_dict() == \
        jspecs.ControllerSpec.from_args(want).to_dict() == ControllerSpec(
            enabled=True, interval=1, warmup=2, d_max=3).to_dict()
    assert (got.churn, got.churn_rejoin, got.churn_seed) == \
        (want.churn, want.churn_rejoin, want.churn_seed) == (0.25, 0.4, 7)


def test_train_cli_churn_coded_and_controlled(tmp_path, capsys):
    """``--churn`` with ``--redundancy 2`` and ``--controller`` at smoke
    size: a down worker's b is 0 on its epochs, every line has finite
    loss and b(t), an action prints its ``controller:`` line and lands in
    the JSONL line of its epoch."""
    from repro_torch.faults import PoissonChurn
    path = tmp_path / "m.jsonl"
    loss = main(SMOKE + ["--steps", "6", "--consensus", "gossip",
                         "--gossip-rounds", "2", "--compute-time", "40.0",
                         "--redundancy", "2", "--churn", "0.25",
                         "--churn-seed", "1", "--controller",
                         "--controller-interval", "1",
                         "--controller-warmup", "2", "--metrics",
                         str(path)], device="cpu")
    out = capsys.readouterr().out
    lines = read_metrics(path)
    assert len(lines) == 6 and loss == lines[-1]["loss"]
    assert all(np.isfinite(ln["loss"]) for ln in lines)
    acts = [ln for ln in lines if "action" in ln]
    assert acts and acts[0]["action"]["budget"] < 40.0
    assert out.count("controller: T 40->") == 1
    assert out.count("controller:") == len(acts)
    churn = PoissonChurn(0.25, 0.5, seed=1)
    for epoch, ln in enumerate(lines):
        # a group of two covers its block whenever one member is up
        up = churn.fleet(epoch, N).active
        assert ln["global_batch"] <= PER * sum(
            up[g * 2:(g + 1) * 2].any() for g in range(N // 2))


def test_kernels_field_maps_onto_the_router():
    assert [TrainSpec(kernels=k).router_mode()
            for k in ("auto", "pallas", "ref")] == ["auto", "kernel", "ref"]
    with pytest.raises(ValueError, match="Pallas interpreter"):
        TrainSpec(kernels="pallas_interpret").router_mode()
    try:
        AMBSession(dataclasses.replace(TRAIN, kernels="ref"),
                   ClockSpec(kind="simulated"), device="cpu")
        assert router.mode() == "ref"
        router.set_mode("kernel")
        with pytest.raises(ValueError, match="CUDA tensors only"):
            router.resolve(torch.zeros(1))
    finally:
        router.set_mode(None)
    assert router.mode() == "auto"
    with pytest.raises(ValueError, match="Pallas interpreter"):
        AMBSession(dataclasses.replace(TRAIN, kernels="pallas_interpret"),
                   device="cpu")


# ---------------------------------------------------------------------------
# the session: optimizers, FMB, the data plane
# ---------------------------------------------------------------------------

def _session_pair(optimizer):
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2-1.5b"),
                               dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(3), jcfg)
    session = AMBSession(
        dataclasses.replace(TRAIN, optimizer=optimizer),
        ClockSpec(kind="simulated"), cfg=cfg, device="cpu",
        params=models.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu"))
    return jcfg, jparams, session


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_exact_session_with_baseline_optimizer_matches_jax(optimizer):
    """Exact consensus under AdamW or SGD (defaults), 3 epochs with the
    same batches and b: losses and parameters against JAX's step.  AdamW
    divides each gradient element by its own running magnitude, so where
    a gradient is small (the attention key bias's is zero up to rounding:
    softmax ignores a shift that a row's scores share) its fp32
    reordering error reaches the step at the scale of lr.  Under AdamW
    every element is held within 2 lr a step, and all but 1e-4 of each
    leaf's elements within the tolerance of the other optimizers."""
    jcfg, jparams, session = _session_pair(optimizer)
    ref = jopt.make_optimizer(optimizer)
    jstep = jax.jit(jamb.make_train_step(jcfg, ref, STANDIN))
    jstate = (jparams, ref.init(jparams))
    rng = np.random.default_rng(8)
    for b in ([2, 1, 0, 2], [2, 2, 2, 2], [1, 0, 2, 2]):
        toks = rng.integers(0, 512, (N * PER, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((N * PER, 1), -1, np.int32)], 1)
        p, o, jm = jstep(*jstate, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)},
                         jnp.asarray(b, jnp.int32))
        jstate = (p, o)
        m = session.step({"tokens": torch.from_numpy(toks).long(),
                          "labels": torch.from_numpy(labels).long()}, b)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    want = jax.tree_util.tree_leaves_with_path(jstate[0])
    got = session.params
    for path, w in want:
        k = ".".join(str(getattr(p, "key", p)) for p in path)
        g, w = got[k].detach().numpy(), np.asarray(w)
        if optimizer == "adamw":
            np.testing.assert_allclose(g, w, rtol=0, atol=6 * ref.lr,
                                       err_msg=k)
            off = ~np.isclose(g, w, rtol=1e-5, atol=1e-6)
            if not k.endswith("attn.bk"):
                assert off.mean() <= 1e-4, (k, off.sum())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_gossip_refuses_other_optimizers_with_jax_message():
    msg = "run the paper's dual-averaging protocol"
    with pytest.raises(ValueError, match=msg):
        AMBSession(dataclasses.replace(TRAIN, optimizer="adamw"),
                   ClockSpec(kind="simulated"),
                   ConsensusSpec(consensus="gossip"), device="cpu")
    with pytest.raises(SystemExit, match=msg):
        main(SMOKE + ["--steps", "1", "--optimizer", "sgd", "--consensus",
                      "gossip_q8"], device="cpu")


@pytest.mark.parametrize("mode", ["amb", "fmb"])
def test_session_epoch_sizes_and_sim_wall_match_jax(mode):
    """Given the same drawn times, b and the simulated wall clock follow
    JAX's session rules: FMB takes batch_per_worker everywhere and adds
    max(finish) + T_c, AMB cuts at T and adds T + T_c."""
    session = AMBSession(dataclasses.replace(TRAIN, mode=mode),
                         ClockSpec(kind="simulated"), device="cpu")
    twin = clock.make_clock(ClockSpec(kind="simulated"), N, PER)
    jself = types.SimpleNamespace(
        train=jspecs.TrainSpec(mode=mode, data=N, batch_per_worker=PER),
        n_workers=N, _active=None)
    want_wall = 0.0
    for e in range(3):
        times, budget = twin.epoch(torch.Generator().manual_seed(
            TRAIN.seed * 1_000_003 + 10_000 + e))
        jt = jnp.asarray(times.numpy())
        want_b = np.asarray(JAMBSession.epoch_sizes(jself, jt, budget))
        want_wall += (float(budget) if mode == "amb" else float(jnp.max(
            jstr.fmb_finish_times(jt, PER)))) + 0.5
        m = session.step(session.batch_source().batch(e))
        np.testing.assert_array_equal(m["b"], want_b)
        assert m["sim_wall_s"] == pytest.approx(want_wall, rel=1e-6)
    if mode == "fmb":
        assert m["global_batch"] == N * PER


def test_batch_source_is_the_lm_stream_and_prefetch_changes_nothing():
    runs = []
    for prefetch in (2, 0):
        session = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                             device="cpu")
        src = session.batch_source()
        assert isinstance(src, StreamSource)
        assert isinstance(src.stream, LMTokenStream)
        assert (src.stream.vocab_size, src.stream.seq_len, src.stream.seed,
                src.n_workers, src.per_worker) == (512, SEQ, 0, N, PER)
        seen = []
        session.run(3, prefetch=prefetch,
                    on_step=lambda e, m: seen.append((e, m["loss"])))
        runs.append((seen, session.params))
    (a, pa), (b, pb) = runs
    assert a == b and [e for e, _ in a] == [0, 1, 2]
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _jax_step_keys() -> set:
    """The keys of JAX's ``AMBSession.step`` metrics, read from its source
    (``out = {...}``): a JAX session's steps need a device mesh that does
    not run on this CPU's jax."""
    import ast
    import inspect
    tree = ast.parse(inspect.cleandoc("\n" + inspect.getsource(
        JAMBSession.step)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets] == ["out"]:
            return {k.value for k in node.value.keys}
    raise AssertionError("no `out = {...}` in the JAX session's step")


@pytest.mark.parametrize("mode", ["amb", "fmb"])
def test_train_cli_writes_jax_jsonl(mode, tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    loss = main(SMOKE + ["--steps", "2", "--mode", mode, "--metrics",
                         str(path)], device="cpu")
    lines = read_metrics(path)
    keys = (_jax_step_keys() - {"b"}) | {"step", "elapsed_s"}
    assert [ln["step"] for ln in lines] == [1, 2]
    for ln in lines:
        assert ln.keys() == keys
        if mode == "fmb":
            assert ln["global_batch"] == N * PER
    assert loss == pytest.approx(lines[-1]["loss"]) and np.isfinite(loss)
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out] == [["step", "0"], ["step", "1"]]
    assert "b(t)=" in out[0] and "sim_wall=" in out[0]


def test_train_cli_default_metrics_path_and_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(SMOKE + ["--steps", "0", "--mode", "fmb"],
                device="cpu") is None
    assert (tmp_path / "artifacts" / "train_qwen2-1.5b_fmb.jsonl").exists()
    # --model spreads a worker over ranks; in one process it changes
    # nothing (tests/test_torch_tp.py runs it over ranks)
    assert main(SMOKE + ["--steps", "0", "--model", "2"],
                device="cpu") is None
    # --pod is a worker axis: pod x data workers in one process
    assert main(SMOKE + ["--steps", "0", "--pod", "2"],
                device="cpu") is None
    with pytest.raises(SystemExit, match="Pallas interpreter"):
        main(SMOKE + ["--kernels", "pallas_interpret"], device="cpu")
    assert router.mode() == "auto"
    line = json.dumps(TrainSpec(mode="fmb").to_dict())
    assert TrainSpec.from_json(line).mode == "fmb"


def test_train_cli_checkpoints_and_a_restored_run_continues(tmp_path,
                                                           capsys):
    """``--ckpt-dir`` after 2 epochs, then ``--restore`` for 2 more: the
    logged steps run on (3, 4) and the epochs are the uninterrupted 4-epoch
    run's, bit for bit (the data order and the clock's draws resume from
    the step count); the restored specs override the spec flags."""
    ckpt = tmp_path / "ckpt"
    gossip = SMOKE + ["--consensus", "gossip", "--prefetch", "0"]
    main(gossip + ["--steps", "2", "--ckpt-dir", str(ckpt), "--metrics",
                   str(tmp_path / "a.jsonl")], device="cpu")
    assert "checkpoint saved to" in capsys.readouterr().out
    assert (ckpt / "step_00000002" / "arrays.npz").exists()
    assert (ckpt / "session_state" / "step_00000002" / "session.json"
            ).exists()
    loss = main(["--restore", str(ckpt), "--steps", "2", "--consensus",
                 "exact", "--metrics", str(tmp_path / "b.jsonl")],
                device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out] == [["step", "3"]]
    main(gossip + ["--steps", "4", "--metrics", str(tmp_path / "c.jsonl")],
         device="cpu")
    resumed = read_metrics(tmp_path / "b.jsonl")
    whole = read_metrics(tmp_path / "c.jsonl")
    assert [ln["step"] for ln in resumed] == [3, 4]
    for a, b in zip(resumed, whole[2:]):
        for k in ("loss", "global_batch", "budget_s", "sim_wall_s"):
            assert a[k] == b[k], k
    assert loss == resumed[-1]["loss"]
