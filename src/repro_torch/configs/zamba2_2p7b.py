"""zamba2-2.7b [hybrid]: 54 Mamba2 layers, d=2560, ssm_state=64, with ONE
shared attention block (32H, kv=32) applied every 6 layers.
[arXiv:2411.15242]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_expand=2, ssm_heads=80, d_conv=4,
    hybrid_attn_every=6, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=256,
        vocab=256, ssm_state=16, ssm_heads=4, hybrid_attn_every=2,
        ssm_chunk=8, remat="none")
