"""granite-20b [dense, code]: 52L d=6144 48H MQA (kv=1) ff=24576 (4x GELU,
gpt-bigcode lineage) vocab=49152.  [arXiv:2405.04324]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, mlp="gelu", qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=256,
        vocab=256, remat="none")
