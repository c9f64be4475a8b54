"""Architecture registry in plain PyTorch, the counterpart of
``repro.models.registry``: ``--arch <id>`` -> config + model functions.

``build(cfg, device=)`` returns the serving function set of every
family: the dense decoder, the VLM (qwen2-vl), mixture-of-experts, ssm
(xlstm), hybrid (zamba2) and encoder-decoder (whisper) families:
    init(generator) -> model                              [random init]
    prefill(model, batch, max_len=None) -> (logits, cache)
    decode(model, cache, batch, pos) -> (logits, cache)

The loss (``loss_fn``) is ROADMAP A13e.  ``params_from_jax`` loads the
JAX package's parameters (as numpy arrays) into the port's modules, so
that the two can be held against each other on the same weights.
"""
from __future__ import annotations

import importlib
from typing import Callable, Optional

import numpy as np
import torch

from .encdec import EncDec
from .transformer import LM, block_specs

ARCHS = [
    "whisper_base", "zamba2_2p7b", "granite_20b", "gemma2_2b", "minicpm_2b",
    "qwen2p5_14b", "deepseek_v2_lite", "phi3p5_moe", "xlstm_1p3b",
    "qwen2_vl_72b",
]

_ALIASES = {
    "whisper-base": "whisper_base", "zamba2-2.7b": "zamba2_2p7b",
    "granite-20b": "granite_20b", "gemma2-2b": "gemma2_2b",
    "minicpm-2b": "minicpm_2b", "qwen2.5-14b": "qwen2p5_14b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe", "xlstm-1.3b": "xlstm_1p3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

__all__ = ["ARCHS", "get_config", "get_smoke_config", "build",
           "count_params", "list_archs", "model_class", "params_from_jax",
           "resolve_device"]


def list_archs() -> list[str]:
    return list(ARCHS)


def _module(name: str):
    name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another; raises when CUDA is asked for and there is none."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{device} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------

def model_class(cfg) -> type:
    """The family's module: ``EncDec`` for the encoder-decoder family
    (whisper's ``audio``), ``LM`` for every other."""
    return EncDec if cfg.family in ("encdec", "audio") else LM


def count_params(cfg, active_only: bool = False) -> int:
    """Exact parameter count from the model's parameter shapes on the
    ``meta`` device (nothing is allocated).  ``active_only`` counts only
    top_k of the n_experts routed experts, by the JAX package's rule:
    the expert parameters are those under ``moe`` other than ``shared``
    and ``router``."""
    total = expert = 0
    for name, p in model_class(cfg)(cfg, device="meta").named_parameters():
        total += p.numel()
        keys = name.split(".")
        if "moe" in keys and "shared" not in keys and "router" not in keys:
            expert += p.numel()
    if active_only and cfg.n_experts:
        total -= int(expert * (1 - cfg.top_k / cfg.n_experts))
    return total


def params_from_jax(cfg, tree, *, device) -> LM:
    """The port's model holding the JAX ``init_lm`` (``init_encdec``)
    parameters ``tree`` (numpy arrays, or anything ``np.asarray``
    takes): each ``group_{gi}`` leaf's leading ``(repeat,)`` axis is
    unstacked into the blocks, and ``encoder.layers``' leading
    ``(encoder_layers,)`` axis into the encoder's layers.  The matmul
    weights are held in ``cfg.dtype``, cast from the float32 masters as
    the JAX code casts them at each use; norm scales, biases, the MoE
    router, xLSTM's gate and recurrent weights and Mamba2's
    ``A_log``/``D``/``dt_bias`` stay float32.  The hybrid family's
    top-level ``shared_attn`` fills the LM's one shared attention."""
    model = model_class(cfg)(cfg, device="meta").to_empty(device=device)
    want = dict(model.named_parameters())
    got = {}

    def walk(prefix, node, index=None):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "scale":       # a norm: {"scale": (d,)}
                    walk(prefix, v, index)
                else:
                    walk(f"{prefix}.{k}" if prefix else k, v, index)
        elif prefix not in want:
            raise KeyError(f"JAX parameter {prefix} has no counterpart")
        else:
            arr = np.asarray(node)
            got[prefix] = arr if index is None else arr[index]

    groups = {}
    for key, node in tree.items():
        if key.startswith("group_"):
            groups[int(key[len("group_"):])] = node
        elif key == "encoder":
            walk("encoder.final_norm", node["final_norm"])
            for j in range(cfg.encoder_layers):
                walk(f"encoder.layers.{j}", node["layers"], j)
        else:
            walk(key, node)
    for i, (gi, r, li, _, _) in enumerate(block_specs(cfg)):
        walk(f"layers.{i}", groups[gi][li], r)
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"no JAX parameter for {missing}")
    with torch.no_grad():
        for name, p in want.items():
            src = torch.from_numpy(np.array(got[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {tuple(src.shape)}, "
                                 f"port {tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


# ---------------------------------------------------------------------------

def build(cfg, device=None) -> dict[str, Callable]:
    """The serving functions of ``cfg`` on ``device`` (the card unless
    the caller names another).  ``batch`` is ``{"tokens": (B, S)}``, or
    for the decoder families ``{"embeds": (B, S, d)}`` in its place,
    with ``"positions3"`` (3, B, S) beside either (M-RoPE); the
    encoder-decoder family's prefill batch adds ``"frames"`` (B, F, d),
    which it encodes once into the cross caches.  ``max_len`` sizes the
    self-attention caches; cross caches keep the F frames and recurrent
    states have no length."""
    device = resolve_device(device)
    cls = model_class(cfg)
    encdec = cls is EncDec

    def init(generator: Optional[torch.Generator]) -> LM:
        return cls(cfg, device=device, generator=generator)

    def inputs(batch) -> dict:
        if encdec:
            return {"tokens": batch["tokens"].to(device)}
        kw = ({"embeds": batch["embeds"].to(device)} if "embeds" in batch
              else {"tokens": batch["tokens"].to(device)})
        if "positions3" in batch:
            kw["positions3"] = batch["positions3"].to(device)
        return kw

    @torch.no_grad()
    def prefill(model, batch, max_len: Optional[int] = None):
        kw = inputs(batch)
        if encdec:
            kw["frames"] = batch["frames"].to(device)
        logits, cache, _ = model(
            **kw, make_cache=True, max_len=max_len,
            last_logit_only=(cfg.prefill_logits == "last"))
        return logits, cache

    @torch.no_grad()
    def decode(model, cache, batch, pos: int):
        logits, cache, _ = model(**inputs(batch), cache=cache,
                                 cache_pos=pos)
        return logits, cache

    return {"init": init, "prefill": prefill, "decode": decode}
