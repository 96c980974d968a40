"""InternVL2-76B [arXiv:2404.16821]: the InternViT front end stubbed (the
decoder takes pre-projected patch and token embeddings (B, S, d)); the
80-layer language model that consumes them."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
    vocab_size=128256, input_mode="embeds")

SMOKE = ArchConfig(
    name="internvl2-76b-smoke", family="vlm", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    input_mode="embeds")
