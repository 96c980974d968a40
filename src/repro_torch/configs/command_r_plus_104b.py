"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01]: dense GQA, no
bias."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="command-r-plus-104b", family="dense", num_layers=64, d_model=12288,
    num_heads=96, num_kv_heads=8, head_dim=128, d_ff=33792,
    vocab_size=256000)

SMOKE = ArchConfig(
    name="command-r-plus-104b-smoke", family="dense", num_layers=2,
    d_model=256, num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
    vocab_size=512)
