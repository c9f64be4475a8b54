"""whisper-base [audio]: enc-dec, 6L dec + 6L enc, d=512, 8H (kv=8),
ff=2048, vocab=51865.  Conv frontend is a stub: input_specs provides
precomputed mel-frame embeddings (B, 1500, 512).  [arXiv:2212.04356]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    mlp="gelu", encoder_layers=6, encoder_frames=1500,
    rope_theta=10_000.0, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=256, encoder_layers=2, encoder_frames=16, remat="none")
