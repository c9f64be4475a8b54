"""Roofline terms per (arch × shape × mesh) from a counted dry-run
step, the counterpart of ``repro.roofline.analysis``, with the H100's
constants (``hw``):

    compute term    = matmul FLOPs per rank / peak bf16 FLOP/s
    memory term     = analytic HBM bytes per rank / HBM bandwidth
    collective term = Σ over collectives of wire bytes / the link rate
                      of its group (NVLink inside a node of 8, the
                      inter-node rate across nodes)

(``cost.StepCost`` counts one rank's step on its local shards, so the
terms are per card directly.)  MODEL_FLOPS is ``repro``'s analytic form —
6·N·D for training (N = params, MoE: active params; D = tokens), 2·N·D
for prefill, 2·N·B for decode — and the ratio MODEL_FLOPS/FLOPs
measures how much of the counted compute is "useful" (remat, attention
schedule waste, dispatch overhead all show up here).  ``n_matmuls``
takes the place of ``repro``'s ``n_dots``; ``unknown_trip_whiles`` has
no subject, since an eager step unrolls its loops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..configs.base import ModelConfig, ShapeConfig
from .cost import StepCost
from .hw import HBM_BW, PEAK_FLOPS_BF16

__all__ = ["RooflineReport", "analyze", "model_flops", "analytic_bytes"]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    step: str
    # per rank, counted
    flops: float
    bytes_proxy: float                # Σ op operand + output bytes (upper bound)
    analytic_bytes_dev: float         # first-order HBM model (see analytic_bytes)
    wire_bytes: float
    collectives: dict
    n_matmuls: int
    # terms (seconds)
    t_compute: float
    t_memory: float                   # from analytic_bytes_dev
    t_memory_proxy: float
    t_collective: float
    bottleneck: str
    # analytic
    model_flops_global: float
    model_flops_per_chip: float
    useful_ratio: float               # model_flops / flops (per chip)
    roofline_fraction: float          # t_dominant_useful / t_total estimate
    # memory
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    # bookkeeping
    notes: str = ""
    collective_sites: Optional[list] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic 'useful' FLOPs per step (global)."""
    n = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * B * S
    if shape.kind == "prefill":
        return 2.0 * n * B * S
    return 2.0 * n * B            # decode: one token per sequence


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig, *, chips: int,
                   tp: int, microbatches: int) -> float:
    """First-order per-device HBM traffic per step (``repro``'s model,
    as it is).

      train:   weights (bf16/tp) × μ × 3 (fwd + bwd + remat re-read)
               + optimizer update (fp32 p/m/v/g, r+w) on the (dp·tp) shard
               + block activations × C_ACT (remat: block inputs only)
      prefill: weights × 1 + activations × C_ACT
      decode:  weights × 1 + full KV/state cache read + write-back

    C_ACT = 16 charges ~16 d_model-wide residual-stream buffers per
    layer per token (block in/out, norms, qkv/o, mlp io).  Chunked
    attention keeps (qc × kc) score tiles on chip — no S² HBM term.
    """
    n_total = cfg.param_count()
    dp = chips // tp
    B, S = shape.global_batch, shape.seq_len
    C_ACT = 16
    L = cfg.n_layers + cfg.encoder_layers
    d = cfg.d_model
    w_bf16 = 2.0 * n_total / tp

    if shape.kind == "train":
        tokens_dev = B * S / dp
        weights = w_bf16 * microbatches * 3
        opt = (4.0 * n_total / chips) * 8
        acts = tokens_dev * d * 2 * L * C_ACT
        return weights + opt + acts
    if shape.kind == "prefill":
        tokens_dev = B * S / dp
        return w_bf16 + tokens_dev * d * 2 * L * C_ACT
    # decode: read the whole cache once + weights once
    if cfg.mla:
        cache_row = cfg.kv_lora + cfg.qk_rope_dim
        cache = B * S * cache_row * 2 * cfg.n_layers
    elif cfg.family == "ssm":
        H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
        cache = B * H * D * D * 4 * cfg.n_layers
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        Hs = cfg.ssm_heads or d_in // 64
        P = d_in // Hs
        cache = (B * Hs * cfg.ssm_state * P * 4 * cfg.n_layers
                 + B * S * cfg.n_kv * cfg.head_dim * 2 * 2
                 * (cfg.n_layers // max(cfg.hybrid_attn_every, 1)))
    else:
        cache = B * S * cfg.n_kv * cfg.head_dim * 2 * 2 * cfg.n_layers
    return w_bf16 + 2.0 * cache / chips


def analyze(cfg: ModelConfig, shape: ShapeConfig, *, mesh_name: str,
            chips: int, step: str, cost: StepCost,
            memory: Optional[dict] = None, tp: int = 16,
            microbatches: int = 1, notes: str = "") -> RooflineReport:
    """The report of one counted step: ``cost`` is rank 0's
    ``StepCost``, ``memory`` its ``{"argument_bytes", "output_bytes",
    "temp_bytes"}``."""
    ab = analytic_bytes(cfg, shape, chips=chips, tp=tp,
                        microbatches=microbatches)
    t_c = cost.flops / PEAK_FLOPS_BF16
    t_m = ab / HBM_BW
    t_m_proxy = cost.bytes_hbm / HBM_BW
    t_x = cost.collective_seconds
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    mf_chip = mf / chips
    useful = mf_chip / cost.flops if cost.flops else 0.0
    # fraction of the roofline the useful work achieves if the dominant
    # term fully serializes (conservative; no overlap assumed)
    t_useful = mf_chip / PEAK_FLOPS_BF16
    t_total = max(terms.values())
    frac = t_useful / t_total if t_total > 0 else 0.0

    mem = memory or {}
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        step=step, flops=cost.flops, bytes_proxy=cost.bytes_hbm,
        analytic_bytes_dev=ab, wire_bytes=cost.collective_wire_bytes,
        collectives={k: {"count": v["count"],
                         "payload_bytes": v["payload_bytes"],
                         "wire_bytes": v["wire_bytes"]}
                     for k, v in cost.collectives.items()},
        n_matmuls=cost.n_matmuls,
        t_compute=t_c, t_memory=t_m, t_memory_proxy=t_m_proxy,
        t_collective=t_x, bottleneck=bottleneck,
        model_flops_global=mf, model_flops_per_chip=mf_chip,
        useful_ratio=useful, roofline_fraction=frac,
        argument_bytes=int(mem.get("argument_bytes", 0)),
        output_bytes=int(mem.get("output_bytes", 0)),
        temp_bytes=int(mem.get("temp_bytes", 0)),
        notes=notes,
        collective_sites=[[k, v] for k, v in cost.top_sites()],
    )
