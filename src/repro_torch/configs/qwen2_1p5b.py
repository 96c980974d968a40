"""Qwen2-1.5B [arXiv:2407.10671]: dense GQA with 2 KV heads, QKV bias."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="qwen2-1.5b", family="dense", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, head_dim=128, d_ff=8960,
    vocab_size=151936, qkv_bias=True)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    qkv_bias=True)
