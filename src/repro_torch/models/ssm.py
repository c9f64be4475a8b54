"""The Mamba2 mixer (SSD) in plain PyTorch, the counterpart of
``repro.models.ssm``.

The selective-state-space recurrence

    h_t = exp(dt_t · A) · h_{t-1} + dt_t · B_t x_tᵀ ;  y_t = C_t h_t + D x_t

runs over a whole sequence in Mamba2's chunked "state-space duality"
form: within a chunk of ``pick_chunk(S, cfg.ssm_chunk)`` tokens the
terms are attention-like products under a cumulative-decay mask, and
across chunks the (H, N, P) state is carried by a loop that hands each
chunk the state before it.  Decode keeps the recurrent state and costs
O(1) a token.

The depthwise causal conv1d is ``k = d_conv`` shifted adds, as in the
JAX package, so that bf16 rounds in the same order.  The SSD runs in
float32; the states are float32 whatever the compute dtype, and decode's
conv over its float32 history runs in float32.

One repair of the reference (ROADMAP C4): a prefill of fewer than
``d_conv - 1`` tokens left-pads the conv state with zeros, the history
that the shifted adds already assume; ``repro`` keeps the short window
and its next decode step fails.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.sharding import keep_grad_layout, local_over
from .common import dense_init, held_dtype, norm_init, param, project, rmsnorm

__all__ = ["Mamba2", "init_mamba2_state", "pick_chunk", "softplus"]


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_inner // 64)
    P = d_inner // H          # head dim
    N = cfg.ssm_state         # state dim
    return d_inner, H, P, N


def pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x) as ``logaddexp(x, 0)``, with no
    linear cut-off (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_in(proj, cfg):
    d_inner, H, P, N = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xBC, w, k: int):
    """Depthwise causal conv1d as k shifted adds.  xBC: (B, S, D), w:
    (k, D)."""
    out = xBC * w[-1]
    for i in range(1, k):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[-1 - i]
    return F.silu(out)


def _ssd_chunked(x, dt, A_log, B, C, chunk):
    """x: (b, s, h, p), dt: (b, s, h), A_log: (h,), B, C: (b, s, n) (one
    group, broadcast over the heads), all float32.  Returns y (b, s, h,
    p) and the final state (b, h, n, p)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide {s}")
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    a = -torch.exp(A_log)[None, None, None, :] * dtc      # log-decay
    a_cum = torch.cumsum(a, dim=2)                        # (b,nc,l,h)

    # intra-chunk: y[t] = sum_{u<=t} C_t·B_u dt_u exp(a_cum_t - a_cum_u) x_u
    L = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                              device=x.device))
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (b,nc,t,u,h)
    decay = torch.exp(torch.where(L[None, None, :, :, None], seg,
                                  -torch.inf))
    cb = torch.einsum("bctn,bcun->bctu", Cc, Bc)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]     # (b,nc,t,u,h)
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", w, xc)

    # chunk states: S_c = sum_u exp(a_cum_last - a_cum_u) dt_u B_u x_u^T
    last = a_cum[:, :, -1:, :]                            # (b,nc,1,h)
    dstate = torch.exp(last - a_cum) * dtc                # (b,nc,l,h)
    states = torch.einsum("bcun,bcuhp->bchnp", Bc, xc * dstate[..., None])

    # inter-chunk: each chunk starts from the state before it
    chunk_decay = torch.exp(last[:, :, 0, :])             # (b,nc,h)
    carry = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                    # (b,nc,h,n,p)

    # y_off[t] = C_t exp(a_cum_t) · prev_state
    y_off = (torch.einsum("bctn,bchnp->bcthp", Cc, prev_states)
             * torch.exp(a_cum)[..., None])
    return (y_intra + y_off).reshape(b, s, h, p), carry


def init_mamba2_state(cfg, batch: int, *, device,
                      dtype=torch.float32) -> dict:
    """A zero recurrent state: ``ssm`` (B, H, N, P) and ``conv`` (B,
    d_conv - 1, d_inner + 2N)."""
    d_inner, H, P, N = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, N, P), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner + 2 * N),
                            dtype=dtype, device=device)}


def _conv_history(xBC_raw, k: int):
    """The last k raw conv inputs (b, k, D) in float32, zero-padded on
    the left when the sequence is shorter than k (C4)."""
    hist = F.pad(xBC_raw.float(), (0, 0, max(0, k - xBC_raw.shape[1]), 0))
    return hist[:, hist.shape[1] - k:]


def _window_conv(hist, w):
    """Decode's conv over the rolling window: hist (b, k, D), w (k, D)
    -> (b, 1, D)."""
    return F.silu(torch.einsum("bkd,kd->bd", hist, w))[:, None, :]


def _ssd_step(ssm, x, dt, A_log, Bv, Cv, D):
    """One recurrent SSD step: the state ssm (b, H, N, P), x (b, H, P),
    dt (b, H), A_log and D (H,), Bv, Cv (b, N) -> y (b, H, P) and the
    stepped state."""
    a = torch.exp(-torch.exp(A_log)[None] * dt)           # (b,H)
    h = (ssm * a[:, :, None, None]
         + (dt[:, :, None, None] * Bv[:, None, :, None]) * x[:, :, None, :])
    return torch.einsum("bn,bhnp->bhp", Cv, h) + x * D[None, :, None], h


class Mamba2(nn.Module):
    """``w_in`` (d, 2·d_inner + 2N + H) (z, x, B, C, dt), ``conv``
    (d_conv, d_inner + 2N) and ``w_out`` (d_inner, d) in the compute
    dtype (float32 masters with ``masters``); ``A_log``, ``D``,
    ``dt_bias`` (H,) and ``norm`` (d_inner,) in float32, as the JAX
    package uses them uncast."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        d_inner, H, P, N = _dims(cfg)
        dt = held_dtype(cfg, masters)

        def init(shape, scale=None):
            return param(dense_init(
                shape, generator=generator, device=device, dtype=dt,
                scale=scale), masters)

        def const(t):
            return param(t, masters)

        self.w_in = init((cfg.d_model, 2 * d_inner + 2 * N + H))
        self.conv = init((cfg.d_conv, d_inner + 2 * N), scale=0.5)
        # log(linspace(1, 16, H)) in float64, rounded once to float32
        self.A_log = const(torch.as_tensor(np.log(np.linspace(
            1.0, 16.0, H)).astype(np.float32), device=device))
        self.D = const(torch.ones((H,), dtype=torch.float32,
                                  device=device))
        self.dt_bias = const(torch.zeros((H,), dtype=torch.float32,
                                         device=device))
        self.w_out = init((d_inner, cfg.d_model))
        self.norm = const(norm_init(d_inner, device))

    def forward(self, u, *, state=None, return_state: bool = False):
        """Full sequence (``state`` None): u (B, S, d) -> y, or (y, state)
        when ``return_state`` (prefill).  One-token decode (``state``
        given): u (B, 1, d) -> (y, the stepped state)."""
        if state is not None:
            return self._decode(u, state)
        cfg = self.cfg
        d_inner, H, P, N = _dims(cfg)
        dt_ = u.dtype
        # its gradient back in the projection's layout (on a mesh: the
        # split gathers it, and w_in's gradient stays on its shard)
        proj = keep_grad_layout(project(u, self.w_in.to(dt_)))
        z, xBC_raw, dt = _split_in(proj, cfg)
        # on a mesh each rank convolves its batch rows
        xBC = local_over(
            functools.partial(_causal_conv, k=cfg.d_conv),
            (xBC_raw, self.conv.to(dt_)), ((0, None), (None, None)),
            ((0, None),))
        x, B, C = torch.split(xBC, [d_inner, N, N], dim=-1)
        b, s, _ = x.shape
        x = x.reshape(b, s, H, P)
        dt = softplus(dt.float() + self.dt_bias)          # (b,s,H)
        # on a mesh each rank runs its own batch rows and heads
        y, final = local_over(
            functools.partial(_ssd_chunked,
                              chunk=pick_chunk(s, cfg.ssm_chunk)),
            (x.float(), dt, self.A_log, B.float(), C.float()),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None)),
            ((0, 2), (0, 1)))
        y = y + x.float() * self.D[None, None, :, None]
        y = y.reshape(b, s, d_inner).to(dt_)
        y = rmsnorm(self.norm, y * F.silu(z), eps=cfg.norm_eps)
        out = project(y, self.w_out.to(dt_))
        if not return_state:
            return out
        conv = local_over(functools.partial(_conv_history, k=cfg.d_conv - 1),
                          (xBC_raw,), ((0, None),), ((0, None),))
        return out, {"ssm": final.float(), "conv": conv}

    def _decode(self, u, state):
        cfg = self.cfg
        d_inner, H, P, N = _dims(cfg)
        dt_ = u.dtype
        proj = project(u, self.w_in.to(dt_))
        z, xBC, dt = _split_in(proj, cfg)
        # conv over the rolling window, in the history's float32
        hist = torch.cat([state["conv"], xBC.to(state["conv"].dtype)], 1)
        w = self.conv.to(dt_).to(hist.dtype)
        xBC = local_over(_window_conv, (hist, w),
                         ((0, None), (None, None)), ((0, None),))
        x, B, C = torch.split(xBC, [d_inner, N, N], dim=-1)
        b = x.shape[0]
        x = x.reshape(b, H, P).float()
        dt = softplus(dt[:, 0].float() + self.dt_bias)
        # on a mesh each rank steps its batch rows and heads
        y, h = local_over(
            _ssd_step, (state["ssm"], x, dt, self.A_log, B[:, 0].float(),
                        C[:, 0].float(), self.D),
            ((0, 1), (0, 1), (0, 1), (None, 0), (0, None), (0, None),
             (None, 0)), ((0, 1), (0, 1)))
        y = y.reshape(b, 1, d_inner).to(dt_)
        y = rmsnorm(self.norm, y * F.silu(z), eps=cfg.norm_eps)
        out = project(y, self.w_out.to(dt_))
        return out, {"ssm": h.to(state["ssm"].dtype), "conv": hist[:, 1:]}
