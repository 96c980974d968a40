"""The LM model zoo (dense family so far)."""
from .common import ArchConfig
from .model import (DenseLM, forward, from_jax_params, init_params,
                    lm_loss, logits_fn, param_count, to_jax_params)

__all__ = ["ArchConfig", "DenseLM", "forward", "from_jax_params",
           "init_params", "lm_loss", "logits_fn", "param_count",
           "to_jax_params"]
