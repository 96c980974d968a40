"""Whisper-base [arXiv:2212.04356]: encoder-decoder, the mel/conv front
end stubbed (the encoder takes 1500 precomputed frame embeddings); 6
encoder and 6 decoder layers.  The vocabulary is padded to 51,968 rows."""
from ..models.common import ArchConfig

FULL = ArchConfig(
    name="whisper-base", family="audio", num_layers=6, d_model=512,
    num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=51865,
    vocab_pad_to=51968, encoder_layers=6, encoder_seq=1500)

SMOKE = ArchConfig(
    name="whisper-base-smoke", family="audio", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    encoder_layers=2, encoder_seq=32)
