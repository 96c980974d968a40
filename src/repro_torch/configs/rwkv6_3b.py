"""RWKV6 "Finch" 3B [arXiv:2404.05892]: attention-free, data-dependent
decay."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, head_dim=64, d_ff=8960, vocab_size=65536,
    # the JAX package pads the 40-head decode state to 48 (3 heads a chip
    # on a 16-way model axis); the port keeps its layout
    head_pad_to=48)

SMOKE = ArchConfig(
    name="rwkv6-3b-smoke", family="ssm", num_layers=2, d_model=128,
    num_heads=2, num_kv_heads=2, head_dim=64, d_ff=256, vocab_size=512)
