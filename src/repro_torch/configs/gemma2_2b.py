"""gemma2-2b [dense]: 26L d=2304 8H (kv=4) ff=9216, vocab=256000,
alternating local(4096-window)/global attention, attn softcap 50, final
softcap 30, post-norms, tied embeddings.  [arXiv:2408.00118]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216,
    vocab=256_000, d_head=256, local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=256,
        vocab=512, d_head=16, sliding_window=8, remat="none")
