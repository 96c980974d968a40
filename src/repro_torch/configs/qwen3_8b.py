"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense GQA with 8 KV heads, qk-norm."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="qwen3-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=12288,
    vocab_size=151936, qk_norm=True)

SMOKE = ArchConfig(
    name="qwen3-8b-smoke", family="dense", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    qk_norm=True)
