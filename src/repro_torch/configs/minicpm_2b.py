"""minicpm-2b [dense]: 40L d=2304 36H (kv=36) ff=5760 vocab=122753,
llama-like; trained with the WSD schedule (optim/schedules.py).
[arXiv:2404.06395]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, d_ff=5760,
    vocab=122_753, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=72, n_heads=6, n_kv=6, d_ff=144,
        vocab=512, remat="none")
