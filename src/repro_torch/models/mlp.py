"""Feed-forward layers in plain PyTorch, the counterpart of
``repro.models.mlp``: the SwiGLU / GELU MLP.  GELU is the tanh
approximation, which ``jax.nn.gelu`` computes by default.  The mixture
of experts is ROADMAP A13b, not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import cdtype, dense_init, project

__all__ = ["MLP", "moe"]


class MLP(nn.Module):
    """``w_up`` (d, f), ``w_down`` (f, d) and, for SwiGLU, ``w_gate``
    (d, f), held in the compute dtype."""

    def __init__(self, cfg, *, device, generator=None, d_ff=None):
        super().__init__()
        self.cfg = cfg
        d_ff = d_ff or cfg.d_ff
        dt = cdtype(cfg)

        def init(shape):
            return nn.Parameter(dense_init(shape, generator=generator,
                                           device=device, dtype=dt),
                                requires_grad=False)

        self.w_up = init((cfg.d_model, d_ff))
        self.w_down = init((d_ff, cfg.d_model))
        if cfg.mlp == "swiglu":
            self.w_gate = init((cfg.d_model, d_ff))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        up = project(x, self.w_up.to(dt))
        if self.cfg.mlp == "swiglu":
            h = F.silu(project(x, self.w_gate.to(dt))) * up
        else:
            h = F.gelu(up, approximate="tanh")
        return project(h, self.w_down.to(dt))


def moe(*args, **kwargs):
    """The mixture of experts: not ported yet."""
    raise NotImplementedError("the MoE layer is ROADMAP A13b (MoE + MLA "
                              "serving), not ported yet")
