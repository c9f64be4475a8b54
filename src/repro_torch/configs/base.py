"""Model/config system: one frozen dataclass covers every assigned family.

Each ``configs/<id>.py`` exposes:
  CONFIG          — the exact published architecture
  smoke_config()  — a reduced same-family variant for CPU smoke tests

``registry.get(name)`` resolves ``--arch <id>`` everywhere (launcher,
dry-run, benchmarks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_lowers"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None      # defaults to d_model // n_heads
    mlp: str = "swiglu"               # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- gemma2-style extras
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global: bool = False        # alternate local/global attention
    post_norms: bool = False          # gemma2 post-attn/post-ffn norms
    # --- MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1                # MoE layer cadence (1 = all)
    first_dense: int = 0              # leading dense layers (deepseek)
    router_aux_coef: float = 0.001
    # --- MLA (deepseek)
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM / hybrid / xLSTM
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    d_conv: int = 4
    ssm_chunk: int = 256
    hybrid_attn_every: int = 0        # zamba2: shared attn block cadence
    slstm_every: int = 0              # xlstm: sLSTM cadence (0 = none)
    # --- enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0           # precomputed frame embeddings (stub)
    # --- VLM (qwen2-vl)
    mrope_sections: Optional[tuple[int, int, int]] = None
    vision_tokens: int = 0            # precomputed patch embeddings (stub)
    # --- attention execution (perf levers; see EXPERIMENTS.md §Perf)
    attn_schedule: str = "full"       # full | tri (triangular causal skip)
    q_chunk: int = 512
    kv_chunk: int = 1024
    prefill_logits: str = "all"       # all | last (serving returns 1 pos)
    seq_parallel: bool = False        # sequence-sharded residual stream
    moe_impl: str = "einsum"          # einsum (GShard) | scatter
    capacity_factor: float = 1.25
    # --- numerics
    dtype: str = "bfloat16"
    remat: str = "block"              # none | block (checkpoint each block)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline term)."""
        from repro_torch.models.registry import count_params  # lazy, avoids cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_lowers(shape: ShapeConfig) -> str:
    """Which step function a shape lowers (assignment rules)."""
    return {"train": "train_step", "prefill": "prefill_step",
            "decode": "decode_step"}[shape.kind]


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 512k-token decode needs "
                       "sub-quadratic attention (documented skip)")
    return True, ""
