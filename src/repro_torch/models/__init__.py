"""The LM model zoo (dense family so far)."""
from .attention import KVCache, decode_attend, init_cache
from .common import ArchConfig
from .model import (DecodeState, DenseLM, decode_step, evict_decode_state,
                    forward, from_jax_params, init_decode_state, init_params,
                    insert_decode_state, lm_loss, logits_fn, param_count,
                    prefill, to_jax_params)

__all__ = ["ArchConfig", "DecodeState", "DenseLM", "KVCache",
           "decode_attend", "decode_step", "evict_decode_state", "forward",
           "from_jax_params", "init_cache", "init_decode_state",
           "init_params", "insert_decode_state", "lm_loss", "logits_fn",
           "param_count", "prefill", "to_jax_params"]
