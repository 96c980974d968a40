"""Architecture registry (the architectures ported so far)."""
from __future__ import annotations

from ..models.common import ArchConfig
from . import qwen2_1p5b, rwkv6_3b

_MODULES = {"qwen2-1.5b": qwen2_1p5b, "rwkv6-3b": rwkv6_3b}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    """The published (full-width) configuration."""
    return _MODULES[name].FULL


def smoke_config(name: str) -> ArchConfig:
    """The reduced configuration the CPU tests run."""
    return _MODULES[name].SMOKE
