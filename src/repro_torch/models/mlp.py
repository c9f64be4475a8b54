"""Feed-forward layers in plain PyTorch, the counterpart of
``repro.models.mlp``: the SwiGLU / GELU MLP and the mixture of experts.
GELU is the tanh approximation, which ``jax.nn.gelu`` computes by
default.

The mixture of experts is GShard-style capacity dispatch: top-k routing
in float32, a per-row expert capacity C, and either the one-hot
(B, S, E, C) dispatch and combine products (``moe_impl="einsum"``) or
an index-add into a (B, E, C + 1, d) buffer whose slot C takes the
dropped pairs (``"scatter"``), each the twin of its JAX formulation.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.sharding import local_over
from .common import dense_init, held_dtype, param, project

__all__ = ["MLP", "MoE", "capacity"]


class MLP(nn.Module):
    """``w_up`` (d, f), ``w_down`` (f, d) and, for SwiGLU, ``w_gate``
    (d, f), held in the compute dtype (float32 masters with
    ``masters``)."""

    def __init__(self, cfg, *, device, generator=None, d_ff=None,
                 masters=False):
        super().__init__()
        self.cfg = cfg
        d_ff = d_ff or cfg.d_ff
        dt = held_dtype(cfg, masters)

        def init(shape):
            return param(dense_init(shape, generator=generator,
                                    device=device, dtype=dt), masters)

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


def capacity(cfg, S: int) -> int:
    """Each expert's buffer length per batch row: ceil(S·k/E·cf), at
    least 4 (the JAX expression, so that the float rounds the same)."""
    c = int(np.ceil(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(c, 4)


class MoE(nn.Module):
    """``router`` (d, E) in float32, since the JAX package routes from
    its float32 masters and a bf16 router would choose other experts;
    the experts' ``w_gate``/``w_up`` (E, d, f_e) and ``w_down`` (E, f_e,
    d) and, when ``n_shared`` > 0, ``shared.w_gate``/``w_up`` (d,
    n_shared·f_e) and ``shared.w_down``, held in the compute dtype
    (float32 masters with ``masters``).  The init keeps the JAX fan-in
    rule (the first axis: E for the expert tensors)."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        dt = held_dtype(cfg, masters)

        def init(shape, dtype=dt, scale=None):
            return param(dense_init(shape, generator=generator,
                                    device=device, dtype=dtype,
                                    scale=scale), masters)

        self.router = init((d, E), torch.float32, scale=0.02)
        self.w_gate = init((E, d, f))
        self.w_up = init((E, d, f))
        self.w_down = init((E, f, d))
        if cfg.n_shared:
            self.shared = nn.Module()
            self.shared.w_gate = init((d, cfg.n_shared * f))
            self.shared.w_up = init((d, cfg.n_shared * f))
            self.shared.w_down = init((cfg.n_shared * f, d))

    def route(self, x: torch.Tensor):
        """Top-k routing of x (B, S, d).  Returns the gates (B, S, E),
        zero off each token's top k and normalised over them, and the
        auxiliary loss before
        ``router_aux_coef``: the load-balance term E·Σ f_e·p̄_e plus
        1e-3 times the mean squared logsumexp of the logits (z-loss)."""
        cfg = self.cfg
        logits = project(x.float(), self.router.float())
        probs = torch.softmax(logits, dim=-1)
        topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
        onehot = F.one_hot(topi, cfg.n_experts).to(probs.dtype)
        gates = (topv[..., None] * onehot).sum(-2)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        frac = (gates > 0).float().mean((0, 1))
        aux = cfg.n_experts * torch.sum(frac * probs.mean((0, 1)))
        zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return gates, aux + 1e-3 * zloss

    @staticmethod
    def slots(gates: torch.Tensor, C: int):
        """Each (token, expert) pair's position in its expert's buffer,
        counted along S in each batch row, and which pairs are kept:
        selected and at a position below C."""
        sel = gates > 0
        pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1
        return pos, sel & (pos < C)

    @staticmethod
    def _expert_ffn(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
        """xe (B, E, C, d) -> (B, E, C, d) through each expert's
        SwiGLU."""
        dt = xe.dtype
        g = torch.einsum("becd,edf->becf", xe, w_gate.to(dt))
        u = torch.einsum("becd,edf->becf", xe, w_up.to(dt))
        return torch.einsum("becf,efd->becd", F.silu(g) * u,
                            w_down.to(dt))

    def _experts(self, x, disp, gates, w_gate, w_up, w_down):
        """The einsum path's dispatch, expert FFNs and combine: x (B, S,
        d), disp (B, S, E, C), gates (B, S, E) -> y (B, S, d)."""
        xe = torch.einsum("bsd,bsec->becd", x, disp)
        ye = self._expert_ffn(xe, w_gate, w_up, w_down)
        comb = disp * gates.to(x.dtype)[..., None]
        return torch.einsum("becd,bsec->bsd", ye, comb)

    def forward(self, x: torch.Tensor):
        """Returns (y, aux): y (B, S, d) in x's dtype and the auxiliary
        loss times ``router_aux_coef`` (float32)."""
        cfg = self.cfg
        B, S, d = x.shape
        dt = x.dtype
        E = cfg.n_experts
        gates, aux = self.route(x)
        C = capacity(cfg, S)
        pos, keep = self.slots(gates, C)

        if cfg.moe_impl == "einsum":
            disp = (keep[..., None] & (pos[..., None] == torch.arange(
                C, device=x.device))).to(dt)                  # (B,S,E,C)
            # on a mesh each rank runs its batch rows and its experts
            # (expert parallelism), y its partial sum over them
            y = local_over(
                self._experts,
                (x, disp, gates, self.w_gate, self.w_up, self.w_down),
                ((0, None), (0, 2), (0, 2), (None, 0), (None, 0),
                 (None, 0)), ((0, "partial"),))
        elif cfg.moe_impl == "scatter":
            bb = torch.arange(B, device=x.device)[:, None, None].expand(
                B, S, E)
            be = torch.arange(E, device=x.device).expand(B, S, E)
            posc = torch.where(keep, pos, C)                  # drop slot C
            xb = x[:, :, None, :].expand(B, S, E, d)
            buf = torch.zeros((B, E, C + 1, d), dtype=dt, device=x.device)
            buf.index_put_((bb, be, posc),
                           torch.where(keep[..., None], xb, 0),
                           accumulate=True)
            ye = F.pad(self._expert_ffn(buf[:, :, :C], self.w_gate,
                                        self.w_up, self.w_down),
                       (0, 0, 0, 1))
            y = (ye[bb, be, posc] * gates.to(dt)[..., None]
                 * keep[..., None]).sum(2)
        else:
            raise ValueError(cfg.moe_impl)

        if cfg.n_shared:
            sh = self.shared
            h = (F.silu(project(x, sh.w_gate.to(dt)))
                 * project(x, sh.w_up.to(dt)))
            y = y + project(h, sh.w_down.to(dt))
        return y, cfg.router_aux_coef * aux
