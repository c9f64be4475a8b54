"""Shared model building blocks in plain PyTorch, the counterparts of
``repro.models.common``.

The JAX package stores every weight in float32 and casts it to the
compute dtype at each use.  Serving never updates a weight, so the
port's modules hold the matmul weights in the compute dtype once (the
same values the cast gives at each use) and keep the norm scales and
biases in float32, cast exactly where the JAX code casts them.
Training holds float32 masters instead (``masters=True`` on every
module): the same draws kept in float32, each a parameter that takes a
gradient; every forward casts at use, so the values it computes are the
serving path's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

__all__ = ["cdtype", "held_dtype", "param", "dense_init", "norm_init", "project", "rmsnorm",
           "layernorm", "rope_table", "mrope_table", "apply_rope",
           "apply_mrope", "softcap"]


def cdtype(cfg) -> torch.dtype:
    """The compute dtype ``cfg.dtype`` names ("bfloat16", "float32")."""
    return getattr(torch, cfg.dtype)


def held_dtype(cfg, masters: bool) -> torch.dtype:
    """The dtype a matmul weight is held in: float32 for the training
    masters, else the compute dtype (serving)."""
    return torch.float32 if masters else cdtype(cfg)


def param(t: torch.Tensor, masters: bool) -> nn.Parameter:
    """``t`` as a parameter that takes a gradient when it is a training
    master and none when it is held for serving."""
    return nn.Parameter(t, requires_grad=masters)


def dense_init(shape, *, generator: Optional[torch.Generator],
               device, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (maxtext-style): a standard normal
    cut to [-2, 2] times ``scale`` or 1/sqrt(fan_in), drawn in float32
    from ``generator`` and then cast to ``dtype``.  On the ``meta``
    device nothing is drawn (shapes only)."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)


def norm_init(d: int, device) -> torch.Tensor:
    """A norm's float32 scale of ones."""
    return torch.ones((d,), dtype=torch.float32, device=device)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->...", x, w)``: x (..., d) times a weight whose
    first axis is d, as one matmul over the weight's other axes."""
    y = x.reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s dtype;
    ``zero_centered`` scales by ``1 + scale`` (gemma)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if zero_centered:
        scale = 1.0 + scale
    return (y * scale).to(dt)


def layernorm(scale: torch.Tensor, x: torch.Tensor, *,
              bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm (population variance) computed in float32 and cast back
    to ``x``'s dtype; ``bias`` is added after the scale when given."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out.to(dt)


def rope_table(positions: torch.Tensor, dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for ``positions`` (..., S) -> (..., S, dim/2),
    the frequencies in float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def mrope_table(positions3: torch.Tensor, dim: int, theta: float,
                sections) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE's (sin, cos) tables: the rotary half is split into
    (t, h, w) ``sections``, each with its own slice of the frequencies
    (``theta ** (-2i / dim)`` for i in the section, in float32) and its
    own position stream.  ``positions3``: (3, B, S) -> (B, S, dim/2)."""
    d2 = dim // 2
    if sum(sections) != d2:
        raise ValueError(f"mrope sections {tuple(sections)} != dim/2 {d2}")
    sins, coss = [], []
    start = 0
    for i, width in enumerate(sections):
        exps = torch.arange(start, start + width, dtype=torch.float32,
                            device=positions3.device) * 2.0 / dim
        freqs = 1.0 / (theta ** exps)
        angles = positions3[i][..., None].float() * freqs
        sins.append(torch.sin(angles))
        coss.append(torch.cos(angles))
        start += width
    return torch.cat(sins, -1), torch.cat(coss, -1)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate-half rope.  x: (..., S, H, D); sin/cos: (..., S, D/2),
    broadcast over the heads; computed in float32, cast back."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    s, c = sin[..., None, :], cos[..., None, :]
    if s.ndim < x1.ndim:  # (S, D/2) -> broadcast batch
        s, c = s[None], c[None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, dim: int,
                theta: float, sections) -> torch.Tensor:
    """M-RoPE: rotate-half ``x`` (B, S, H, D) by ``mrope_table``'s
    tables.  Text tokens carry the same t/h/w position on all three
    axes, which makes it plain rope."""
    return apply_rope(x, *mrope_table(positions3, dim, theta, sections))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma2 logit soft-capping, cap * tanh(x / cap), in float32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
