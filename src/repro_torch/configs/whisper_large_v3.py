"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder backbone.

32 encoder + 32 decoder layers, d_model 1280, 20 heads, d_ff 5120, vocab
51866.  The mel-spectrogram conv frontend is a stub per the brief:
input_specs() provides precomputed frame embeddings (B, S, 1280).  Decode
shapes run the decoder (cross-attending to the cached encoder output) —
whisper is encoder-decoder, not encoder-only, so decode cells are live.
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, d_ff=5120, vocab=51866, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, remat=False)
