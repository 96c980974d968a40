"""Zamba2-1.2B [arXiv:2411.15242]: a Mamba2 backbone and one shared
attention block applied after every 6th layer."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, attn_every=6)

SMOKE = ArchConfig(
    name="zamba2-1.2b-smoke", family="hybrid", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    ssm_state=16, attn_every=2)
