"""Phi-3.5-MoE [hf:microsoft/Phi-3.5-MoE-instruct]: MoE, 16 experts
top-2."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2)

SMOKE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b-smoke", family="moe", num_layers=2,
    d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=64,
    vocab_size=512, num_experts=4, experts_per_token=2)
