"""Checkpoints of tensor trees (counterpart of ``repro.ckpt``)."""
from .checkpoint import (latest_step, load_checkpoint, load_checkpoint_into,
                         save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "load_checkpoint_into",
           "save_checkpoint"]
