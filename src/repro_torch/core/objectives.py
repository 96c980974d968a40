"""Convex objectives from the paper's experiments (§6): linear and
logistic regression.

Counterpart of ``repro.core.objectives``.  Each objective exposes

    loss(w, batch)              the mean loss over the batch
    grad(w, batch)              the mean gradient (w's shape)
    masked_grad(w, batch, mask) the mean over samples with mask 1
    masked_sums(w, batch, mask) (gradient sum, per-sample loss sum) over
                                the masked samples

on tensors.  ``masked_sums`` also takes a leading node dim on all of w,
batch and mask (w (n, d), x (n, b, d), mask (n, b)), the engine's
stack of per-node iterates, where the JAX engine vmaps it.  ``sample``
draws from the ``torch.Generator`` it is given, on that generator's
device.
"""
from __future__ import annotations

import dataclasses
import math

import torch


# ---------------------------------------------------------------------------
# Linear regression (paper §6.1): y = x^T w* + eta, x ~ N(0, I)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinearRegression:
    dim: int
    noise_var: float = 1e-3

    def init_w(self) -> torch.Tensor:
        return torch.zeros((self.dim,), dtype=torch.float32)

    def sample(self, generator: torch.Generator, shape: tuple,
               w_star: torch.Tensor) -> tuple:
        """Draw (x, y): x ~ N(0, I_d), y = x.w* + N(0, noise_var)."""
        dev = generator.device
        x = torch.randn(tuple(shape) + (self.dim,), generator=generator,
                        dtype=torch.float32, device=dev)
        noise = math.sqrt(self.noise_var) * torch.randn(
            tuple(shape), generator=generator, dtype=torch.float32,
            device=dev)
        return x, x @ w_star + noise

    def loss(self, w, batch) -> torch.Tensor:
        x, y = batch
        resid = x @ w - y
        return 0.5 * torch.mean(resid * resid)

    def grad(self, w, batch) -> torch.Tensor:
        x, y = batch
        resid = x @ w - y                                     # (b,)
        return x.T @ resid / resid.shape[-1]

    def masked_grad(self, w, batch, mask) -> torch.Tensor:
        """Mean gradient over samples with mask == 1 (variable minibatch)."""
        x, y = batch
        resid = (x @ w - y) * mask
        return x.T @ resid / torch.clamp(mask.sum(), min=1.0)

    def masked_sums(self, w, batch, mask) -> tuple:
        """(grad sum, per-sample loss sum) over masked samples: the
        engine's chunked accumulation of variable minibatches."""
        x, y = batch
        resid = torch.matmul(x, w.unsqueeze(-1)).squeeze(-1) - y  # (..., b)
        gsum = torch.matmul((resid * mask).unsqueeze(-2), x).squeeze(-2)
        lsum = 0.5 * torch.sum(mask * resid * resid, dim=-1)
        return gsum, lsum

    def population_loss(self, w, w_star) -> torch.Tensor:
        """F(w) = 0.5 E[(x.(w-w*) - eta)^2] = 0.5(||w-w*||^2 + noise_var)."""
        d = w - w_star
        return 0.5 * (d @ d + self.noise_var)


# ---------------------------------------------------------------------------
# Multiclass logistic regression (paper §6.2) on a synthetic MNIST-like
# mixture
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    dim: int = 784
    num_classes: int = 10
    bias: bool = True

    @property
    def param_dim(self) -> int:
        return self.num_classes * (self.dim + int(self.bias))

    def init_w(self) -> torch.Tensor:
        return torch.zeros((self.param_dim,), dtype=torch.float32)

    def _unflatten(self, w):
        return w.reshape(w.shape[:-1] + (self.num_classes,
                                         self.dim + int(self.bias)))

    def make_class_means(self, generator: torch.Generator,
                         spread: float = 2.0) -> torch.Tensor:
        return spread * torch.randn(
            (self.num_classes, self.dim), generator=generator,
            dtype=torch.float32, device=generator.device) \
            / math.sqrt(self.dim)

    def sample(self, generator: torch.Generator, shape: tuple,
               class_means: torch.Tensor) -> tuple:
        """MNIST stand-in: x | y ~ N(mu_y, I); y uniform over classes."""
        dev = generator.device
        y = torch.randint(0, self.num_classes, tuple(shape),
                          generator=generator, device=dev)
        x = class_means[y] + torch.randn(
            tuple(shape) + (self.dim,), generator=generator,
            dtype=torch.float32, device=dev)
        return x, y

    def _logits(self, w, x):
        """(..., b, c) logits; w may carry the leading dims of x's."""
        wm = self._unflatten(w)
        wx = wm[..., :-1] if self.bias else wm
        logits = torch.matmul(x, wx.transpose(-1, -2))
        if self.bias:
            logits = logits + wm[..., -1].unsqueeze(-2)
        return logits

    def loss(self, w, batch) -> torch.Tensor:
        x, y = batch
        logp = torch.log_softmax(self._logits(w, x), dim=-1)
        return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))

    def grad(self, w, batch) -> torch.Tensor:
        return torch.func.grad(self.loss)(w, batch)

    def _onehot(self, y, like):
        # a comparison, not F.one_hot: that checks the class range on the
        # host, a sync each call
        classes = torch.arange(self.num_classes, device=y.device)
        return (y.long()[..., None] == classes).to(like.dtype)

    def _err_sums(self, err, x, denom=None):
        """Gradient (flattened like w) from the (..., b, c) errors."""
        gx = torch.matmul(err.transpose(-1, -2), x)           # (..., c, d)
        if self.bias:
            gx = torch.cat([gx, err.sum(-2).unsqueeze(-1)], dim=-1)
        g = gx.reshape(gx.shape[:-2] + (-1,))
        return g if denom is None else g / denom

    def masked_grad(self, w, batch, mask) -> torch.Tensor:
        x, y = batch
        p = torch.softmax(self._logits(w, x), dim=-1)
        onehot = self._onehot(y, p)
        err = (p - onehot) * mask[..., None]
        return self._err_sums(err, x, torch.clamp(mask.sum(), min=1.0))

    def masked_sums(self, w, batch, mask) -> tuple:
        """(grad sum, per-sample loss sum) over masked samples."""
        x, y = batch
        logp = torch.log_softmax(self._logits(w, x), dim=-1)
        lsum = -torch.sum(
            mask * torch.gather(logp, -1, y.long()[..., None])[..., 0],
            dim=-1)
        onehot = self._onehot(y, logp)
        err = (torch.exp(logp) - onehot) * mask[..., None]
        return self._err_sums(err, x), lsum
