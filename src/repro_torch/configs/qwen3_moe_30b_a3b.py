"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: MoE, 128 experts top-8, GQA with
4 KV heads, qk-norm."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=4, head_dim=128, d_ff=768,
    vocab_size=151936, qk_norm=True, num_experts=128, experts_per_token=8)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=512,
    qk_norm=True, num_experts=4, experts_per_token=2)
