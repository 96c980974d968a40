"""The port's dry-run (:mod:`repro_torch.launch.dryrun`) against the JAX
package's: ``model_flops`` for every config and shape, and records
counted on ``meta`` tensors at smoke size, held against a hand count of
the step's matrix products.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; JAX's backend is started first here and the variable restored
after the import, so neither this process nor what it spawns sees them.
"""
import dataclasses
import json
import os

import pytest

jax = pytest.importorskip("jax")
jax.devices()                       # the backend, before the flags change
_flags = os.environ.get("XLA_FLAGS")
from repro import configs as jconfigs  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro_torch import configs  # noqa: E402
from repro_torch.configs import InputShape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import abstract  # noqa: E402

SMOKE_MESH = abstract((4, 2), ("data", "model"))
SMOKE_TRAIN = InputShape("smoke_train", 32, 8, "train")
# a train step's products: forward and backward (3x the forward's), and
# the checkpointed blocks' forward again (at most a third more)
FLOP_FACTOR = (1.0, 4.0 / 3.0 + 0.01)
KEYS = ("model_flops", "compute_s_roofline", "memory_s_roofline",
        "collective_s_roofline", "dominant_term", "useful_flops_frac",
        "chips", "mesh", "flops", "bytes", "collectives",
        "argument_size_in_bytes", "output_size_in_bytes")


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_model_flops_equal_jax(arch, shape):
    want = jdryrun.model_flops(jconfigs.get_config(arch, shape=shape),
                               jconfigs.SHAPES[shape])
    got = dryrun.model_flops(configs.get_config(arch, shape=shape),
                             configs.SHAPES[shape])
    assert got == want


def _hand_forward_flops(cfg, rows: int, seq: int) -> float:
    """The forward's matrix products, counted by hand: the projections,
    the MLP, the attention's two products over every (query, key) pair
    (the training softmax masks, it does not skip), and the unembedding
    over the padded vocabulary."""
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    tokens = rows * seq
    proj = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * cfg.d_ff
    attn = 2 * seq * h * hd
    per_layer = 2 * tokens * proj + 2 * tokens * attn
    return cfg.num_layers * per_layer + 2 * tokens * d * cfg.padded_vocab


def test_smoke_train_record_counts_the_products(tmp_path):
    cfg = configs.smoke_config("qwen2-1.5b")
    rec = dryrun.run_one("qwen2-1.5b", "smoke_train", False, tmp_path,
                         cfg=cfg, shape=SMOKE_TRAIN, mesh=SMOKE_MESH)
    saved = json.loads((tmp_path / "qwen2-1.5b__smoke_train__4x2.json")
                       .read_text())
    assert saved["flops"] == rec["flops"]
    for k in KEYS:
        assert k in rec, k
    rows = SMOKE_TRAIN.global_batch // 4
    assert rec["rows_per_worker"] == rows and rec["workers"] == 4
    hand = 3 * _hand_forward_flops(cfg, rows, SMOKE_TRAIN.seq_len)
    ratio = rec["aten_flops"] / hand
    assert FLOP_FACTOR[0] <= ratio <= FLOP_FACTOR[1], ratio
    assert rec["flops"] == pytest.approx(
        (rec["aten_flops"] + rec["kernel_flops"]) / 2)
    assert rec["kernel_launches"] == {"dual_update": 15}
    assert rec["chips"] == 8 and rec["mesh"] == "4x2"
    assert rec["model_flops"] == dryrun.model_flops(cfg, SMOKE_TRAIN)
    assert rec["dominant_term"] in ("compute", "memory", "collective")
    coll = rec["collectives"]
    assert coll["all-gather"]["count"] > 0
    assert coll["reduce-scatter"]["count"] == coll["all-gather"]["count"] // 2
    assert coll["traffic_bytes"] > 0
    assert rec["argument_size_in_bytes"] > rec["param_bytes_per_rank"] > 0


def test_serving_records_count_the_kernels_by_formula(tmp_path):
    cfg = configs.smoke_config("qwen2-1.5b")
    pre = dryrun.run_one("qwen2-1.5b", "smoke_prefill", False, tmp_path,
                         cfg=cfg, shape=InputShape("smoke_prefill", 64, 8,
                                                   "prefill"),
                         mesh=SMOKE_MESH)
    assert pre["kernel_launches"] == {"flash_attention": cfg.num_layers}
    # 2 rows of 64 causal tokens a worker: 4 * B * H * hd * pairs
    pairs = 64 * 65 // 2
    assert pre["kernel_flops"] == cfg.num_layers * 4 * 2 * cfg.num_heads \
        * cfg.hd * pairs
    assert dryrun.attention_pairs(8, 8, True, 3, 0) == 1 + 2 + 3 * 6
    assert dryrun.attention_pairs(4, 10, False, 0, 0) == 40
    assert dryrun.attention_pairs(2, 6, True, 0, 4) == 5 + 6
    rw = dryrun.run_one("rwkv6-3b", "smoke_prefill", False, tmp_path,
                        cfg=configs.smoke_config("rwkv6-3b"),
                        shape=InputShape("smoke_prefill", 32, 4, "prefill"),
                        mesh=SMOKE_MESH)
    assert rw["kernel_launches"] == {
        "rwkv6_scan": configs.smoke_config("rwkv6-3b").num_layers}
    dec = dryrun.run_one("qwen2-1.5b", "smoke_decode", False, tmp_path,
                         cfg=cfg, shape=InputShape("smoke_decode", 64, 8,
                                                   "decode"),
                         mesh=SMOKE_MESH)
    assert dec["kernel_launches"] == {} and dec["flops"] > 0


def test_nothing_runs_a_plain_version_on_meta(tmp_path, monkeypatch):
    """The stand-ins replace the kernels' wrappers for the count, and put
    them back after it."""
    before = (ops.dual_update, ops.flash_attention, ops.rwkv6_scan)
    dryrun.run_one("whisper-base", "smoke_train", False, tmp_path,
                   cfg=configs.smoke_config("whisper-base"),
                   shape=SMOKE_TRAIN, mesh=SMOKE_MESH)
    assert (ops.dual_update, ops.flash_attention, ops.rwkv6_scan) == before


def test_main_writes_records_and_fails_with_the_reason(tmp_path, capsys,
                                                       monkeypatch):
    small = {"whisper-base": configs.smoke_config("whisper-base")}
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, shape=None: small[arch])
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "2,2")
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert (tmp_path / "whisper-base__decode_32k__2x2.json").exists()
    assert "[ok]" in capsys.readouterr().out
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--skip-existing"])
    assert "[skip]" in capsys.readouterr().out

    def broken(cfg, shape, mesh, params):
        raise RuntimeError("value-dependent branch on meta")

    monkeypatch.setattr(dryrun, "_run_step", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper-base", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] whisper-base train_4k 2x2: value-dependent" in out


def test_layout_bytes_shrink_with_the_mesh(tmp_path):
    """Argument bytes per rank fall as the FSDP x TP extents grow; with
    one worker and no model axis nothing is sharded or sent."""
    cfg = dataclasses.replace(configs.smoke_config("qwen2-1.5b"),
                              num_layers=1)
    one = dryrun._layout(cfg, SMOKE_TRAIN, abstract((1, 1),
                                                     ("data", "model")))
    four = dryrun._layout(cfg, SMOKE_TRAIN, SMOKE_MESH)
    assert one["collectives"]["traffic_bytes"] == 0.0
    assert four["param_bytes_per_rank"] < one["param_bytes_per_rank"]
    # dual averaging's fp32 z and fp32 w0: 8 bytes a parameter
    count = sum(p.numel() for p in dryrun.S.abstract_params(cfg).values())
    assert one["opt_state_bytes_per_rank"] == 8 * count
