"""Quantized gossip on the whole stack (paper §3 under a byte budget).

Counterpart of ``quantize_unbiased`` and ``gossip_quantized`` in
``repro.core.extensions``: the dense operator that
:class:`repro_torch.dist.consensus.QuantizedGossipConsensus` falls back to
and is tested against.  The uniform rounding draws come from the caller:
JAX's threefry stream cannot be reproduced, so a test hands both packages
the same draws.
"""
from __future__ import annotations

from typing import Callable

import torch


def quantize_unbiased(x: torch.Tensor, bits: int,
                      rnd: torch.Tensor) -> torch.Tensor:
    """Stochastic uniform quantization on per-row grids, E[q(x)] = x.

    x: (n, D); rnd: U[0, 1) draws of x's shape; ``2^bits - 1`` levels.
    """
    levels = float(2 ** bits - 1)
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA turns a division by a host scalar into a
    # product with its reciprocal, which can move the grid by an ulp
    scale = torch.clamp(hi - lo, min=1e-12) / torch.full_like(lo, levels)
    u = (x - lo) / scale
    fl = torch.floor(u)
    up = (rnd < (u - fl)).to(x.dtype)
    # the row max can round to u = levels + eps: cap the up-round there
    return lo + torch.clamp(fl + up, max=levels) * scale


def gossip_quantized(messages: torch.Tensor, p, rounds: int, bits: int,
                     draws: Callable) -> torch.Tensor:
    """``rounds`` of delta-compressed gossip on (n, ...) messages.

    Each round quantizes ``m - h`` against the public replicas h (zero at
    the start), adds the result to h and mixes ``m <- diag(P) m +
    offdiag(P) h``: the self term stays exact and the injected noise
    decays with the deltas.  ``draws(k, out)`` fills ``out`` with round
    k's U[0, 1) draws.
    """
    p = torch.as_tensor(p, dtype=messages.dtype, device=messages.device)
    m = messages.reshape(messages.shape[0], -1)
    diag = torch.diagonal(p)[:, None]
    off = p - torch.diag(torch.diagonal(p))
    h = torch.zeros_like(m)
    rnd = torch.empty_like(m)
    for k in range(rounds):
        draws(k, rnd)
        h = h + quantize_unbiased(m - h, bits, rnd)
        m = diag * m + off @ h
    return m.reshape(messages.shape)
