"""xLSTM's blocks in plain PyTorch, the counterpart of
``repro.models.xlstm``: mLSTM (matrix memory, chunked parallel form)
and sLSTM (scalar memory, recurrent).

mLSTM runs a whole sequence in a chunked linear-attention form:
exponential input gates and log-sigmoid forget gates become per-step
log-decays, within a chunk the terms are an attention-like product
under a cumulative-decay mask, and across chunks the (H, D, D) matrix
state and its (H, D) normalizer are carried by a loop that hands each
chunk the state before it.  As in the JAX package (a documented
deviation from the paper) the running max-stabilizer is left out, so
the chunked and recurrent forms agree, and the normalizer keeps the
paper's ``max(|q·n|, 1)``.

sLSTM keeps the paper's scalar-memory recurrence with its full
stabilizer; its prefill is a loop over the tokens from ``m = -30``.

The gate weights ``wi``/``wf``, sLSTM's recurrent ``r_zifo`` and the
biases are float32, as the JAX package uses them uncast; the other
matmul weights are held in the compute dtype.  States are float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..runtime.sharding import local_over
from .common import dense_init, held_dtype, param, project
from .ssm import pick_chunk, softplus

__all__ = ["MLSTM", "SLSTM", "init_mlstm_state", "init_slstm_state"]


def _mdims(cfg):
    H = cfg.n_heads
    return H, cfg.d_model // H


def _headnorm(scale, h):
    """Per-head RMS norm, eps 1e-6 (not ``cfg.norm_eps``), computed in
    float32 and cast back to ``h``'s dtype."""
    var = h.float().square().mean(-1, keepdim=True)
    return (h * torch.rsqrt(var + 1e-6) * scale).to(h.dtype)


def _out(y, wo):
    """einsum("bshk,hkd->bsd"): y (B, S, H, D) through ``wo`` (H, D, d)."""
    B, S = y.shape[:2]
    return project(y.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))


def init_mlstm_state(cfg, batch: int, *, device,
                     dtype=torch.float32) -> dict:
    """A zero mLSTM state: ``S`` (B, H, D, D) and ``n`` (B, H, D)."""
    H, D = _mdims(cfg)
    return {"S": torch.zeros((batch, H, D, D), dtype=dtype, device=device),
            "n": torch.zeros((batch, H, D), dtype=dtype, device=device)}


class MLSTM(nn.Module):
    """``wq``/``wk``/``wv``/``ogate`` (d, H, D) and ``wo`` (H, D, d) in
    the compute dtype (float32 masters with ``masters``; ``wo`` drawn
    at std 1/sqrt(H): the JAX fan-in is the first axis); ``wi``/``wf``
    (d, H), ``f_bias`` (H,) and ``norm`` (H, D) in float32."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        H, D = _mdims(cfg)
        d, dt = cfg.d_model, held_dtype(cfg, masters)

        def init(shape, dtype=dt, scale=None):
            return param(dense_init(shape, generator=generator,
                                    device=device, dtype=dtype,
                                    scale=scale), masters)

        self.wq = init((d, H, D))
        self.wk = init((d, H, D))
        self.wv = init((d, H, D))
        self.wi = init((d, H), torch.float32, scale=0.02)
        self.wf = init((d, H), torch.float32, scale=0.02)
        self.f_bias = param(torch.full((H,), 3.0, dtype=torch.float32,
                                       device=device),
                            masters)                     # open forget gates
        self.wo = init((H, D, d))
        self.ogate = init((d, H, D), scale=0.02)
        self.norm = param(torch.ones((H, D), dtype=torch.float32,
                                     device=device), masters)

    def _gates(self, x):
        """The input gate i and log sigmoid of the forget gate, (B, S, H),
        float32."""
        xf = x.float()
        i = project(xf, self.wi)
        f = project(xf, self.wf) + self.f_bias
        return i, -softplus(-f)

    def _qkv(self, x):
        """q (scaled by 1/sqrt(D), float32 as in the JAX package, whose
        numpy scalar promotes it), k and v (B, S, H, D)."""
        D = _mdims(self.cfg)[1]
        dt = x.dtype
        q = project(x, self.wq.to(dt)).float() / np.float32(np.sqrt(D))
        return q, project(x, self.wk.to(dt)), project(x, self.wv.to(dt))

    def _finish(self, y, x):
        """Head norm, output gate, ``wo``."""
        dt = x.dtype
        o = torch.sigmoid(project(x, self.ogate.to(dt)))
        return _out(_headnorm(self.norm, y) * o, self.wo.to(dt))

    def forward(self, x, *, state=None, return_state: bool = False):
        """Chunked parallel form (``state`` None): x (B, S, d) -> y, or
        (y, {"S", "n"}) when ``return_state``.  Recurrent step
        (``state`` given): x (B, 1, d) -> (y, the stepped state).  On a
        mesh the recurrence runs on each rank's batch rows and heads
        (``local_over``)."""
        if state is not None:
            return self._decode(x, state)
        dt_ = x.dtype
        q, k, v = self._qkv(x)
        i, log_f = self._gates(x)                         # (B,S,H)
        chunk = pick_chunk(x.shape[1], self.cfg.ssm_chunk or 256)
        y, Sm, Sn = local_over(
            functools.partial(_mlstm_chunked, chunk=chunk),
            (q, k, v, i, log_f), ((0, 2),) * 5,
            ((0, 2), (0, 1), (0, 1)))
        out = self._finish(y.to(dt_), x)
        if return_state:
            return out, {"S": Sm, "n": Sn}
        return out

    def _decode(self, x, state):
        dt_ = x.dtype
        q, k, v = self._qkv(x)
        i, log_f = self._gates(x)                         # (B,1,H)
        y, S_new, n_new = local_over(
            _mlstm_step, (q, k, v, i, log_f, state["S"], state["n"]),
            ((0, 2),) * 5 + ((0, 1), (0, 1)),
            ((0, 2), (0, 1), (0, 1)))
        return self._finish(y.to(dt_), x), {"S": S_new.to(state["S"].dtype),
                                            "n": n_new.to(state["n"].dtype)}


def _mlstm_chunked(q, k, v, i, log_f, chunk: int):
    """mLSTM's chunked parallel form: q (float32), k, v (B, S, H, D), the
    gates i, log f (B, S, H) -> y (B, S, H, D) float32 and the final
    state S (B, H, D, D), n (B, H, D)."""
    B, S, H, D = q.shape
    nc = S // chunk
    qc = q.reshape(B, nc, chunk, H, D)
    kc = k.reshape(B, nc, chunk, H, D).float()
    vc = v.reshape(B, nc, chunk, H, D).float()
    ic = i.reshape(B, nc, chunk, H)
    fcum = torch.cumsum(log_f.reshape(B, nc, chunk, H), dim=2)
    last = fcum[:, :, -1:, :]

    # intra-chunk: w_tu = exp(fcum_t - fcum_u + i_u), u <= t
    L = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                              device=q.device))
    seg = (fcum[:, :, :, None, :] - fcum[:, :, None, :, :]
           + ic[:, :, None, :, :])
    dmat = torch.exp(torch.where(L[None, None, :, :, None], seg,
                                 -torch.inf))             # (B,nc,t,u,H)
    w = torch.einsum("bcthk,bcuhk->bctuh", qc, kc) * dmat
    y_intra = torch.einsum("bctuh,bcuhk->bcthk", w, vc)
    den_intra = w.sum(3)                                  # (B,nc,t,H)

    # chunk states: S_c = sum_u exp(last - fcum_u + i_u) k_u v_u^T
    kd = kc * torch.exp(last - fcum + ic)[..., None]
    states = torch.einsum("bcuhk,bcuhn->bchkn", kd, vc)
    nstates = kd.sum(2)                                   # (B,nc,H,D)
    cdecay = torch.exp(last[:, :, 0, :])                  # (B,nc,H)

    Sm = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    Sn = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    prevS, prevN = [], []
    for c in range(nc):                                   # hand on PREV
        prevS.append(Sm)
        prevN.append(Sn)
        Sm = Sm * cdecay[:, c, :, None, None] + states[:, c]
        Sn = Sn * cdecay[:, c, :, None] + nstates[:, c]

    qd = qc * torch.exp(fcum)[..., None]                  # to chunk start
    y_off = torch.einsum("bcthk,bchkn->bcthn", qd, torch.stack(prevS, 1))
    den_off = torch.einsum("bcthk,bchk->bcth", qd, torch.stack(prevN, 1))

    den = torch.clamp_min(torch.abs(den_intra + den_off), 1.0)
    return ((y_intra + y_off) / den[..., None]).reshape(B, S, H, D), Sm, Sn


def _mlstm_step(q, k, v, i, log_f, S, n):
    """One recurrent mLSTM step: q, k, v (B, 1, H, D), gates (B, 1, H),
    the state S (B, H, D, D), n (B, H, D) -> y (B, 1, H, D) float32 and
    the stepped state, float32."""
    q, k, v = q[:, 0], k[:, 0].float(), v[:, 0].float()  # (B,H,D)
    di = torch.exp(i[:, 0])
    df = torch.exp(log_f[:, 0])
    S_new = (S * df[:, :, None, None]
             + k[..., :, None] * v[..., None, :] * di[:, :, None, None])
    n_new = n * df[:, :, None] + k * di[:, :, None]
    num = torch.einsum("bhk,bhkn->bhn", q, S_new)
    den = torch.clamp_min(
        torch.abs(torch.einsum("bhk,bhk->bh", q, n_new)), 1.0)
    return (num / den[:, :, None])[:, None], S_new, n_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_state(cfg, batch: int, *, device,
                     dtype=torch.float32) -> dict:
    """sLSTM's starting state: ``c``, ``n``, ``h`` zero and the
    stabilizer ``m`` at -30, each (B, H, D)."""
    H, D = _mdims(cfg)

    def z():
        return torch.zeros((batch, H, D), dtype=dtype, device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, H, D), -30.0, dtype=dtype,
                            device=device)}


class SLSTM(nn.Module):
    """``w_zifo`` (d, 4, H, D) and ``wo`` (H, D, d) in the compute dtype
    (float32 masters with ``masters``); ``r_zifo`` (4, H, D, D),
    ``b_zifo`` (4, H, D) and ``norm`` (H, D) in float32."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        H, D = _mdims(cfg)
        d, dt = cfg.d_model, held_dtype(cfg, masters)

        def init(shape, dtype=dt, scale=None):
            return param(dense_init(shape, generator=generator,
                                    device=device, dtype=dtype,
                                    scale=scale), masters)

        self.w_zifo = init((d, 4, H, D))
        self.r_zifo = init((4, H, D, D), torch.float32, scale=0.02)
        self.b_zifo = param(torch.zeros((4, H, D), dtype=torch.float32,
                                        device=device), masters)
        self.wo = init((H, D, d))
        self.norm = param(torch.ones((H, D), dtype=torch.float32,
                                     device=device), masters)

    def forward(self, x, *, state=None, return_state: bool = False):
        """Sequential over S from the starting state (``state`` None): x
        (B, S, d) -> y, or (y, state) when ``return_state``.  One step
        (``state`` given): x (B, 1, d) -> (y, the stepped state).  On a
        mesh the recurrence runs on each rank's batch rows and heads
        (``local_over``)."""
        dt_ = x.dtype
        # (B,S,4,H,D); on a mesh each rank projects onto its own heads
        xg = local_over(project, (x, self.w_zifo.to(dt_)),
                        ((0, None), (None, 2)), ((0, 3),))
        st = state if state is not None else init_slstm_state(
            self.cfg, x.shape[0], device=x.device)
        names = ("c", "n", "h", "m")
        hs, *last = local_over(
            _slstm_scan, (xg, self.r_zifo, self.b_zifo,
                          *(st[k] for k in names)),
            ((0, 3), (None, 1), (None, 1)) + ((0, 1),) * 4,
            ((0, 2),) + ((0, 1),) * 4)
        out = _out(_headnorm(self.norm, hs.to(dt_)), self.wo.to(dt_))
        if state is not None:
            return out, {k: v.to(state[k].dtype)
                         for k, v in zip(names, last)}
        return (out, dict(zip(names, last))) if return_state else out


def _slstm_step(xt, st, r_zifo, b_zifo):
    """One sLSTM step with the full stabilizer.  xt: (B, 4, H, D), the
    input already projected; st: c, n, h, m (B, H, D)."""
    rec = torch.einsum("bhd,ghde->bghe", st["h"].float(), r_zifo)
    g = xt.float() + rec + b_zifo
    z = torch.tanh(g[:, 0])
    i = g[:, 1]                           # exponential input gate (log)
    log_f = -softplus(-g[:, 2])
    o = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(log_f + st["m"], i)
    di = torch.exp(i - m_new)
    df = torch.exp(log_f + st["m"] - m_new)
    c_new = df * st["c"] + di * z
    n_new = df * st["n"] + di
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_scan(xg, r_zifo, b_zifo, c, n, h, m):
    """sLSTM over the S steps of xg (B, S, 4, H, D) from the state c, n,
    h, m (B, H, D): every step's h (B, S, H, D) float32 and the last
    state."""
    st = {"c": c, "n": n, "h": h, "m": m}
    hs = []
    for t in range(xg.shape[1]):
        st = _slstm_step(xg[:, t], st, r_zifo, b_zifo)
        hs.append(st["h"])
    return (torch.stack(hs, 1), st["c"], st["n"], st["h"], st["m"])
