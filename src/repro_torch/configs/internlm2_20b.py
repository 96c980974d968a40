"""InternLM2-20B [arXiv:2403.17297]: dense GQA with 8 KV heads."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=92544)

SMOKE = ArchConfig(
    name="internlm2-20b-smoke", family="dense", num_layers=2, d_model=256,
    num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512)
