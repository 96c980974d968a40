"""Plain PyTorch versions of the kernels (the correctness contract).

Counterpart of ``repro.kernels.ref``: each CUDA kernel in this package has
a function here that computes the same thing.  The CPU path and the tests
run these; ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch


def dual_update_ref(z: torch.Tensor, w0: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """Fused dual-averaging prox: w = w0 - z / (2 beta), fp32 math."""
    return w0.float() - z.float() / (2.0 * torch.tensor(
        beta, dtype=torch.float32, device=z.device))


def gossip_combine_ref(m: torch.Tensor, src: torch.Tensor,
                       weights) -> torch.Tensor:
    """One tap-gossip round: ``out[i] = sum_k weights[k] * m[src[k, i]]``.

    m: (n, D); src: (K, n) source rows per tap; weights: K floats.  The
    gathered rows of one tap at a time (``_roll_taps`` + the weighted sum
    of ``repro.kernels.ref.gossip_combine_ref``), summed in fp32 in tap
    order; one (n, D) gather is live at a time.
    """
    m = m.float()
    idx = src.long()
    out = torch.zeros_like(m)
    for k, w in enumerate(weights):
        out.add_(m[idx[k]].mul_(float(w)))
    return out
