"""qwen2.5-14b [dense]: 48L d=5120 40H (kv=8) ff=13824 vocab=152064,
GQA with QKV bias.  [hf:Qwen/Qwen2.5-14B]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=13824,
    vocab=152_064, qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=192,
        vocab=512, remat="none")
