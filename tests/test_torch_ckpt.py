"""The port's checkpoints (``repro_torch.ckpt``) and ``AMBSession.save`` /
``restore`` against ``repro.ckpt`` and against the uninterrupted session.

A tree round-trips bit for bit (bf16, fp32 and int leaves, tuple and list
slots, Python numbers); a tree JAX wrote loads through the port to the
same values and the reverse, in one on-disk layout; a restored session
continues the saved one bit for bit on the CPU (exact, gossip, pipelined,
async D = 2, and a masked session).
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.api import (AMBSession, ClockSpec, ConsensusSpec,  # noqa
                             TrainSpec)
from repro_torch.ckpt import (latest_step, load_checkpoint,  # noqa: E402
                              load_checkpoint_into, save_checkpoint)

N, PER, SEQ = 4, 2, 16
TRAIN = TrainSpec(smoke=True, data=N, batch_per_worker=PER, seq_len=SEQ)
MASK = (True, False, True, True)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs several worker
    processes on shared cores, where torch's thread pool oversubscribes
    them (these tests' small ops ran up to 40x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                  "b": torch.randn(7, generator=g)},
            "t": 4, "lr": 0.25,
            "queue": [torch.randn(2, 3, generator=g), torch.zeros(2, 3)],
            "pair": (torch.arange(6, dtype=torch.int32).reshape(2, 3),
                     torch.tensor(True)),
            "none": None}


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.device == want.device
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        assert got == want


def test_round_trip_is_bit_for_bit(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 7, tree)
    assert path == tmp_path / "step_00000007"
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 7
    assert manifest["leaves"]["a/w"] == "bfloat16"
    assert set(manifest["leaves"]) == {"a/w", "a/b", "t", "lr", "queue/0",
                                       "queue/1", "pair/0", "pair/1"}
    assert not list(tmp_path.glob(".tmp_ckpt_*"))
    like = _tree(seed=1)
    _assert_same(load_checkpoint(tmp_path, 7, like), tree)
    save_checkpoint(tmp_path, 9, _tree(2))
    assert latest_step(tmp_path) == 9 and latest_step(tmp_path / "x") is None
    save_checkpoint(tmp_path, 7, like)          # overwrite a step
    _assert_same(load_checkpoint(tmp_path, 7, tree), like)
    like["a"]["b"] = torch.zeros(8)
    with pytest.raises(ValueError, match="a/b: shape"):
        load_checkpoint(tmp_path, 7, like)


def test_load_lands_on_the_like_leaves_dtype(tmp_path):
    save_checkpoint(tmp_path, 0, {"x": torch.arange(4.0)})
    got = load_checkpoint(tmp_path, 0,
                          {"x": torch.zeros(4, dtype=torch.float64)})
    assert got["x"].dtype == torch.float64
    assert got["x"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_load_into_lands_in_place_leaf_by_leaf(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 2, tree)
    live = _tree(seed=1)
    ids = {k: id(v) for k, v in
           (("a/w", live["a"]["w"]), ("queue/0", live["queue"][0]),
            ("pair/0", live["pair"][0]))}
    assert load_checkpoint_into(tmp_path, 2, live) is live
    _assert_same(live, tree)
    # tensors keep their identity (a session's parameters are its model's)
    assert ids == {"a/w": id(live["a"]["w"]),
                   "queue/0": id(live["queue"][0]),
                   "pair/0": id(live["pair"][0])}
    live["queue"][1] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="queue/1: shape"):
        load_checkpoint_into(tmp_path, 2, live)
    # the archive is np.savez's: numpy reads every leaf by its path
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as data:
        assert sorted(data.files) == sorted(
            json.loads((tmp_path / "step_00000002" / "manifest.json")
                       .read_text())["leaves"])
        np.testing.assert_array_equal(data["a/b"], tree["a"]["b"].numpy())


def test_parameters_carry_across_the_two_packages_on_disk(tmp_path):
    """qwen2-1.5b smoke parameters in bf16: JAX's nested tree written by
    ``repro.ckpt`` loads into the port's flat dotted dict, and the port's
    dict written by ``repro_torch.ckpt`` loads into JAX's tree, each to
    the same bits; both packages write the same keys and dtypes."""
    jcfg = jconfigs.smoke_config("qwen2-1.5b")
    cfg = configs.smoke_config("qwen2-1.5b")
    assert jcfg.dtype == cfg.dtype == "bfloat16"
    jparams = jmodels.init_params(jax.random.PRNGKey(5), jcfg)
    jckpt.save_checkpoint(tmp_path / "jax", 3, {"params": jparams,
                                                "t": jnp.int32(3)})
    port = models.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu").params()
    like = {"params": {k: torch.zeros_like(v) for k, v in port.items()},
            "t": 0}
    got = load_checkpoint(tmp_path / "jax", 3, like)
    assert got["t"] == 3
    for k, v in port.items():
        torch.testing.assert_close(got["params"][k], v.detach(), rtol=0,
                                   atol=0)
    save_checkpoint(tmp_path / "port", 3, {"params": port, "t": 3})
    back = jckpt.load_checkpoint(tmp_path / "port", 3, {
        "params": jparams, "t": jnp.int32(0)})
    assert int(back["t"]) == 3
    for a, b in zip(jax.tree.leaves(back["params"]),
                    jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    man = [json.loads((tmp_path / side / "step_00000003" / "manifest.json"
                       ).read_text())["leaves"] for side in ("jax", "port")]
    assert man[0].keys() == man[1].keys()
    assert {k: v for k, v in man[0].items() if k != "t"} == \
        {k: v for k, v in man[1].items() if k != "t"}


def _state_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _state_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _state_equal(a, b)
    elif isinstance(want, torch.Tensor):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        assert got == want


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


SESSIONS = {
    "exact": ConsensusSpec(),
    "gossip": ConsensusSpec(consensus="gossip"),
    "pipelined": ConsensusSpec(consensus="gossip", pipeline=True),
    "async2": ConsensusSpec(consensus="gossip", async_epochs=True,
                            staleness=2),
    "masked": ConsensusSpec(consensus="gossip", pipeline=True),
}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_restored_session_continues_bit_for_bit(name, tmp_path):
    """Save after 2 epochs; the restored state equals the saved one, and
    its next epoch the uninterrupted session's, bit for bit."""
    spec = SESSIONS[name]
    a = AMBSession(TRAIN, ClockSpec(kind="simulated"), spec, device="cpu")
    a.run(1, prefetch=0)
    if name == "masked":
        a.set_active(MASK)
    a.run(1, prefetch=0)
    a.save(tmp_path)
    saved = _clone(a.state)
    b = AMBSession.restore(tmp_path, device="cpu")
    _state_equal(b.state, saved)
    assert (b.steps_done, b.sim_wall) == (a.steps_done, a.sim_wall)
    assert b.active.tolist() == a.active.tolist()
    assert b.consensus_spec == a.consensus_spec
    if name == "exact":     # the optimizer still updates the parameters
        assert all(p.requires_grad for p in b.state["params"].values())
        assert b.state["params"]["embed"] is dict(
            b.model.named_parameters())["embed"]
    ma, mb = a.run(1, prefetch=0), b.run(1, prefetch=0)
    for k in ("loss", "global_batch", "budget_s", "sim_wall_s",
              "staleness"):
        assert ma[k] == mb[k], k
    np.testing.assert_array_equal(ma["b"], mb["b"])
    _state_equal(b.state, a.state)
    a.flush()
    b.flush()
    pa, pb = a.params, b.params
    for k in pa:
        torch.testing.assert_close(pb[k], pa[k], rtol=0, atol=0)


def test_restore_an_older_step_and_the_layout(tmp_path):
    s = AMBSession(TRAIN, ClockSpec(kind="simulated"),
                   ConsensusSpec(consensus="gossip", async_epochs=True,
                                 staleness=2), device="cpu")
    s.run(1, prefetch=0)
    s.save(tmp_path)
    first = _clone(s.state)
    wall = s.sim_wall
    s.set_active(MASK)
    s.run(2, prefetch=0)
    s.save(tmp_path)
    root = json.loads((tmp_path / "session.json").read_text())
    assert root["step"] == 3 and root["active"] == list(MASK)
    assert root["controller"] is None
    assert root["consensus"]["staleness"] == 2
    assert (tmp_path / "step_00000001" / "arrays.npz").exists()
    assert (tmp_path / "session_state" / "step_00000003" / "session.json"
            ).exists()
    old = AMBSession.restore(tmp_path, step=1, device="cpu")
    assert (old.steps_done, old.sim_wall) == (1, wall)
    assert old.active.all()               # the mask of step 1
    _state_equal(old.state, first)
    new = AMBSession.restore(tmp_path, device="cpu")
    assert new.steps_done == 3 and new.active.tolist() == list(MASK)
    _state_equal(new.state, s.state)


def test_zero_step_save_and_measured_clock_restore(tmp_path):
    s = AMBSession(TRAIN, ClockSpec(), ConsensusSpec(consensus="gossip"),
                   device="cpu")
    s.save(tmp_path)
    assert (tmp_path / "step_00000000").is_dir()
    r = AMBSession.restore(tmp_path, device="cpu")
    assert r.steps_done == 0 and r.sim_wall == 0.0
    _state_equal(r.state, s.state)
    assert r.clock.sec_per_grad is None and r.clock.compute_time is None
    s.run(2, prefetch=0)
    s.save(tmp_path)
    r = AMBSession.restore(tmp_path, device="cpu")
    assert r.clock.sec_per_grad == s.clock.sec_per_grad is not None
    assert r.steps_done == 2
    s.clock.set_budget(1.5)
    s.save(tmp_path)
    meta = json.loads((tmp_path / "session.json").read_text())
    assert meta["clock_budget"] == 1.5
    assert AMBSession.restore(tmp_path, device="cpu").clock.compute_time \
        == 1.5


def test_restore_with_a_custom_config(tmp_path):
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              num_layers=1)
    s = AMBSession(TRAIN, ClockSpec(kind="simulated"), cfg=cfg,
                   device="cpu")
    s.run(1, prefetch=0)
    s.save(tmp_path)
    with pytest.raises(ValueError, match="shape"):
        AMBSession.restore(tmp_path, device="cpu")
    r = AMBSession.restore(tmp_path, cfg=cfg, device="cpu")
    _state_equal(r.state, s.state)
