"""Optimizers: the paper's dual averaging and the AdamW / SGD baselines."""
from .optimizers import AdamW, DualAveragingOpt, Optimizer, Sgd, make_optimizer

__all__ = ["AdamW", "DualAveragingOpt", "Optimizer", "Sgd", "make_optimizer"]
