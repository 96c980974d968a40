"""The LM model zoo (the dense, MoE, RWKV6 and hybrid families so far)."""
from .attention import KVCache, decode_attend, init_cache
from .common import ArchConfig
from .model import (DecodeState, DenseLM, decode_step, evict_decode_state,
                    forward, forward_aux, from_jax_params, init_decode_state,
                    init_params, insert_decode_state, lm_loss, logits_fn,
                    param_count, prefill, to_jax_params)

__all__ = ["ArchConfig", "DecodeState", "DenseLM", "KVCache",
           "decode_attend", "decode_step", "evict_decode_state", "forward",
           "forward_aux", "from_jax_params", "init_cache", "init_decode_state",
           "init_params", "insert_decode_state", "lm_loss", "logits_fn",
           "param_count", "prefill", "to_jax_params"]
