"""Optimizers over a parameter dict: the paper's dual averaging, and the
AdamW and SGD baselines (counterpart of ``repro.optim.optimizers``).

With
``h(w) = ||w - w(1)||^2`` the eq.-7 prox is closed-form,

    w(t+1) = w(1) - z(t+1) / (2 beta(t+1)),

computed per leaf by :func:`repro_torch.kernels.ops.dual_update` (the CUDA
kernel on the card).  Where the JAX optimizer returns new trees, this one
updates the dual and the parameters in place: at full width a second copy
of the fp32 dual would cost 7 GB.  AdamW and SGD update their fp32 moments
and the parameters in place too, with JAX's hyper-parameters, defaults
and order of operations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.dual_averaging import BetaSchedule
from ..kernels import ops as kops


class Optimizer:
    """``init(params) -> state``; ``apply(grads, state, params) -> state``
    updates ``params`` (and the state's tensors) in place."""

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    def apply(self, grads: dict, state: dict, params: dict) -> dict:
        raise NotImplementedError


def _zeros_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class DualAveragingOpt(Optimizer):
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


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: dict) -> dict:
        with torch.no_grad():
            return {"m": _zeros_f32(params), "v": _zeros_f32(params), "t": 0}

    @torch.no_grad()
    def apply(self, grads: dict, state: dict, params: dict) -> dict:
        t = state["t"] + 1
        f = np.float32
        # bias corrections in float32, as JAX computes them on a float32 t
        c1 = float(f(1.0) - f(self.b1) ** f(t))
        c2 = float(f(1.0) - f(self.b2) ** f(t))
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            pf = p.float()
            p.copy_(pf - self.lr * (step + self.weight_decay * pf))
        state["t"] = t
        return state


@dataclasses.dataclass(frozen=True)
class Sgd(Optimizer):
    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params: dict) -> dict:
        if self.momentum:
            with torch.no_grad():
                return {"v": _zeros_f32(params)}
        return {}

    @torch.no_grad()
    def apply(self, grads: dict, state: dict, params: dict) -> dict:
        for k, p in params.items():
            g = grads[k].float()
            if self.momentum:
                g = state["v"][k].mul_(self.momentum).add_(g)
            p.copy_(p.float() - self.lr * g)
        return state


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"dual_averaging": DualAveragingOpt, "adamw": AdamW,
            "sgd": Sgd}[name](**kw)
