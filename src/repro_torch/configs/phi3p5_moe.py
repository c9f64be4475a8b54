"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (kv=8), 16 experts top-2,
expert ff=6400, vocab=32064.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32_064, n_experts=16, n_shared=0, top_k=2, d_ff_expert=6400,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=256, n_experts=4, top_k=2, d_ff_expert=64, remat="none")
