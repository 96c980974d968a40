"""Token sampling for the serving tier (counterpart of
``repro.serve.sampling``).

Greedy (argmax) by default; temperature + top-k when requested.  A
stochastic draw takes a ``torch.Generator`` on the logits' device; the
slot engine seeds one per draw from ``(spec.seed, sample index)``, so the
same (spec, request sequence) replays the same tokens on one device.
JAX's ``categorical`` bits are not reproduced.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """Frozen sampling configuration.

    ``temperature <= 0`` means greedy decode (``top_k`` ignored).
    ``top_k == 0`` means sample from the full distribution.  ``seed``
    seeds the engine's generators.
    """
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sample_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of draw ``index`` under sampling seed ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + index)
    return gen


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Sample next-token ids from ``logits`` (..., V) -> (...,) int64.

    ``temperature <= 0`` is greedy argmax and ignores ``generator``;
    otherwise ``generator`` is required and ``top_k > 0`` restricts the
    draw to the k highest logits (mask below the per-row k-th logit).
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    scaled = logits.float() / torch.tensor(temperature,
                                           device=logits.device)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, _NEG, scaled)
    probs = torch.softmax(scaled, dim=-1).reshape(-1, scaled.shape[-1])
    draws = torch.multinomial(probs, 1, generator=generator)
    return draws.reshape(scaled.shape[:-1])
