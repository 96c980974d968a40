"""Optimizers (dual averaging so far)."""
from .optimizers import DualAveragingOpt

__all__ = ["DualAveragingOpt"]
