"""qwen2-vl-72b [vlm]: 80L d=8192 64H (kv=8) ff=29568 vocab=152064,
M-RoPE (t/h/w sections 16/24/24 of the 64-dim rotary half), QKV bias.
Vision patch frontend is a stub: input_specs provides precomputed patch
embeddings + 3-axis positions.  [arXiv:2409.12191]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
    vocab=152_064, qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=192,
        vocab=512, mrope_sections=(4, 2, 2), remat="none")
