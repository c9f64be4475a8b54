"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H, MLA (kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128), MoE 64 routed experts top-6 +
2 shared, expert ff=1408, first layer dense, vocab=102400.

Assignment-spec note (see DESIGN.md §7): the spec line lists both
"64e top-6" and "160 routed"; 160 routed belongs to full V2 — we follow
the leading spec (64 routed / top-6 / 2 shared).  [arXiv:2405.04434]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=10944,
    vocab=102_400, mla=True, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, d_head=192,
    n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408, first_dense=1,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=512, kv_lora=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, d_head=24, n_experts=8, n_shared=1, top_k=2,
        d_ff_expert=32, first_dense=1, remat="none")
