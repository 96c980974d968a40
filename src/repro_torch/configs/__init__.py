"""Architecture and input-shape registry (counterpart of
``repro.configs``: the same ten architectures, in its order)."""
from __future__ import annotations

import dataclasses

from ..models.common import ArchConfig
from . import (command_r_plus_104b, internlm2_20b, internvl2_76b,
               phi3p5_moe_42b, qwen2_1p5b, qwen3_8b, qwen3_moe_30b_a3b,
               rwkv6_3b, whisper_base, zamba2_1p2b)

_MODULES = {
    "qwen3-8b": qwen3_8b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "command-r-plus-104b": command_r_plus_104b,
    "internlm2-20b": internlm2_20b,
    "zamba2-1.2b": zamba2_1p2b,
    "whisper-base": whisper_base,
    "rwkv6-3b": rwkv6_3b,
    "phi3.5-moe-42b-a6.6b": phi3p5_moe_42b,
    "qwen2-1.5b": qwen2_1p5b,
    "internvl2-76b": internvl2_76b,
}

ARCH_NAMES = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

SWA_WINDOW = 4096   # sliding-window width of the long-context variant


def get_config(name: str, *, shape: str | None = None) -> ArchConfig:
    """The published (full-width) configuration; with
    ``shape="long_500k"`` a family with attention (the hybrid's shared
    block too) gets the sliding-window variant (window ``SWA_WINDOW``;
    ssm is natively O(1) in context)."""
    cfg = _MODULES[name].FULL
    if shape == "long_500k" and cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, sliding_window=SWA_WINDOW)
    return cfg


def smoke_config(name: str) -> ArchConfig:
    """The reduced configuration the CPU tests run (fp32 accumulation of
    the expert products off, as in JAX)."""
    return dataclasses.replace(_MODULES[name].SMOKE, mxu_f32_accum=False)
