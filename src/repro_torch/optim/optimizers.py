"""The paper's dual averaging as an optimizer over a parameter dict.

Counterpart of ``repro.optim.optimizers.DualAveragingOpt``.  With
``h(w) = ||w - w(1)||^2`` the eq.-7 prox is closed-form,

    w(t+1) = w(1) - z(t+1) / (2 beta(t+1)),

computed per leaf by :func:`repro_torch.kernels.ops.dual_update` (the CUDA
kernel on the card).  Where the JAX optimizer returns new trees, this one
updates the dual and the parameters in place: at full width a second copy
of the fp32 dual would cost 7 GB.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.dual_averaging import BetaSchedule
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class DualAveragingOpt:
    beta: BetaSchedule = BetaSchedule(k=100.0, mu=1.0, scale=100.0)
    radius: Optional[float] = None    # optional L2 ball around init, per leaf

    def init(self, params: dict) -> dict:
        """z = 0 (fp32), w0 = fp32 copy of the initial parameters, t = 0."""
        with torch.no_grad():
            return {
                "z": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "w0": {k: p.detach().float().clone()
                       for k, p in params.items()},
                "t": 0,
            }

    @torch.no_grad()
    def apply(self, grads: dict, state: dict, params: dict) -> dict:
        """z += g; params <- prox(z, w0, beta(t + 2)); returns the state."""
        t_new = state["t"] + 1
        beta = self.beta(t_new + 1)
        for k, p in params.items():
            z = state["z"][k]
            z.add_(grads[k].float())
            p.copy_(kops.dual_update(z, state["w0"][k], beta, self.radius))
        state["t"] = t_new
        return state
