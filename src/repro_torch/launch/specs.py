"""Shape and dtype stand-ins for every (arch × shape × step), the
counterpart of ``repro.launch.specs``: ``meta``-device tensors, so that
nothing is allocated, laid out in ``repro``'s trees (the parameters'
``group_{gi}`` lists with each leaf stacked over its repeats, the caches
one stacked list per group).  Modality frontends are stubs:
``[audio]`` gets precomputed mel-frame embeddings, ``[vlm]`` precomputed
patch embeddings + 3-axis M-RoPE positions.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.attention import init_layer_cache
from ..models.common import cdtype
from ..models.registry import model_class, stack_to_jax
from ..models.ssm import init_mamba2_state
from ..models.transformer import arch_groups
from ..models.xlstm import init_mlstm_state, init_slstm_state

__all__ = ["input_specs", "params_specs", "cache_specs_struct",
           "layer_caches"]

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Batch stand-ins for the step function this shape lowers."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    dt = cdtype(cfg)
    batch: dict[str, Any] = {}
    s_tok = 1 if kind == "decode" else S
    if cfg.family == "vlm":
        batch["embeds"] = _meta((B, s_tok, cfg.d_model), dt)
        batch["positions3"] = _meta((3, B, s_tok), torch.int32)
    else:
        batch["tokens"] = _meta((B, s_tok), torch.int32)
    if cfg.family in ("audio", "encdec") and kind != "decode":
        batch["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model), dt)
    if kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def params_specs(cfg: ModelConfig) -> dict:
    """The float32 masters' stand-ins in ``repro``'s ``init`` tree."""
    model = model_class(cfg)(cfg, device=META, masters=True)
    return stack_to_jax(cfg, dict(model.named_parameters()), torch.stack)


def _sublayer_cache(cfg, mixer: str, batch: int, max_len: int,
                    dtype) -> Optional[dict]:
    if mixer in ("attn", "attn_local", "shared_attn"):
        return init_layer_cache(cfg, batch, max_len, dtype, META)
    if mixer == "cross_attn":
        return init_layer_cache(cfg, batch, cfg.encoder_frames or 1, dtype,
                                META)
    if mixer == "mla":
        return {"ckv": _meta((batch, max_len, cfg.kv_lora), dtype),
                "kr": _meta((batch, max_len, cfg.qk_rope_dim), dtype)}
    if mixer == "mamba":
        return init_mamba2_state(cfg, batch, device=META)
    if mixer == "mlstm":
        return init_mlstm_state(cfg, batch, device=META)
    if mixer == "slstm":
        return init_slstm_state(cfg, batch, device=META)
    return None


def layer_caches(cfg: ModelConfig, shape: ShapeConfig,
                 dtype=torch.bfloat16) -> list:
    """The port's per-block decode caches (one dict, or None, per block
    in execution order) as stand-ins, of ``shape.seq_len`` positions."""
    return [_sublayer_cache(cfg, m, shape.global_batch, shape.seq_len,
                            dtype)
            for g in arch_groups(cfg) for _ in range(g.repeat)
            for (m, _f) in g.unit]


def cache_specs_struct(cfg: ModelConfig, shape: ShapeConfig,
                       dtype=torch.bfloat16) -> list:
    """Decode-shape KV/state cache stand-ins (cache len = shape.seq_len)
    in ``repro``'s tree: per group, a list over the unit's sub-layers of
    each cache with a leading (repeat,) dim."""
    out = []
    for g in arch_groups(cfg):
        unit = [_sublayer_cache(cfg, m, shape.global_batch, shape.seq_len,
                                dtype) for (m, _f) in g.unit]
        out.append([None if c is None else
                    {k: v.expand((g.repeat,) + tuple(v.shape))
                     for k, v in c.items()} for c in unit])
    return out
