"""xlstm-1.3b [ssm]: 48 blocks d=2048 4H, mLSTM backbone with sLSTM every
8th block (d_ff=0: blocks carry their own projections).
[arXiv:2405.04517]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    slstm_every=8, ssm_chunk=256, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=4, vocab=256,
        slstm_every=2, ssm_chunk=8, remat="none")
