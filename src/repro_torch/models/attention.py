"""Attention in plain PyTorch, the counterpart of
``repro.models.attention``: the GQA layer (bias, softcap, sliding
window, Qwen2-VL's M-RoPE) with its train, prefill and decode modes and
its cross mode (whisper's encoder and decoder), and deepseek-v2's
multi-head latent attention (MLA).

Scores and softmax run in float32 as in the JAX package.  A masked
score is ``NEG_INF`` (a large finite number, not ``-inf``), so a row
with every key masked gives the uniform average the JAX code gives, not
NaN.  Long sequences run the online-softmax chunked attention, short
ones and decode the materializing one (``mha``'s dispatch rule).

Cache contract (per layer): GQA ``{"k": (B, T, Kv, dh), "v": (B, T,
Kv, dh)}``; MLA ``{"ckv": (B, T, kv_lora), "kr": (B, T, rope_dim)}``,
the compressed latent and the shared-head rope key; cross ``{"k": (B,
F, Kv, dh), "v": ...}``, the keys and values of the F encoder frames.
Decode writes the new entries into the caller's cache in place at
``cache_pos`` and attends over ``kv_len = cache_pos + S``; it reads a
cross cache and never writes it, and no cross cache is sized by
``max_len``.  Under an active mesh (serving on a mesh) every cache leaf
is a DTensor placed by ``runtime.sharding.cache_specs``' rule: prefill
makes each rank's block only, decode writes into its block in place
(``write_seq``) and attends on its own batch rows and heads
(``heads_local``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..runtime.sharding import cache_zeros, place_cache, write_seq
from .common import (apply_rope, dense_init, held_dtype, mrope_table,
                     norm_init, param, project, rmsnorm, rope_table,
                     softcap)

__all__ = ["NEG_INF", "Attention", "MLA", "chunked_mha", "plain_mha",
           "mha", "heads_local"]

NEG_INF = -2.0 ** 30


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: Optional[int], kv_len) -> torch.Tensor:
    """(qc, kc) bool mask for a block given absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    if kv_len is not None:
        m &= k_pos[None, :] < kv_len
    return m


def plain_mha(q, k, v, *, scale, causal=False, window=None, cap=None,
              q_offset=0, kv_len=None):
    """Materializing attention — decode / short-sequence path.
    q: (B, S, H, D), k/v: (B, T, Kv, Dv)."""
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    qg = q.reshape(B, S, Kv, rep, D)
    s = torch.einsum("bskrd,btkd->bkrst", qg.float(), k.float()) * scale
    s = softcap(s, cap)
    q_pos = q_offset + torch.arange(S, device=q.device)
    mask = _block_mask(q_pos, torch.arange(T, device=q.device),
                       causal=causal, window=window, kv_len=kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrst,btkd->bskrd", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def chunked_mha(q, k, v, *, scale, causal=True, window=None, cap=None,
                q_offset=0, q_chunk=512, kv_chunk=1024, schedule="full"):
    """Online-softmax attention over KV chunks: O(qc·kc) live scores.

    ``schedule``: "full" visits every kv block and masks the blocks
    above the diagonal; "tri" (causal, no window, T == S) visits only
    the blocks up to the diagonal, as the JAX ``fori_loop`` does."""
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // Kv
    qc = min(q_chunk, S)
    kc = min(kv_chunk, T)
    if S % qc or T % kc:
        raise ValueError(f"chunks ({qc}, {kc}) do not divide ({S}, {T})")
    nq, nk = S // qc, T // kc
    qb = q.reshape(B, nq, qc, Kv, rep, D)
    kb = k.reshape(B, nk, kc, Kv, D)
    vb = v.reshape(B, nk, kc, Kv, Dv)
    tri = schedule == "tri" and causal and window is None and T == S
    blocks = []
    for qi in range(nq):
        qblk = qb[:, qi].float()
        q_pos = q_offset + qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, Kv, rep, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Kv, rep, qc), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Kv, rep, qc, Dv), dtype=torch.float32,
                          device=q.device)
        for kj in range(qi + 1 if tri else nk):
            k_pos = kj * kc + torch.arange(kc, device=q.device)
            s = torch.einsum("bqkrd,btkd->bkrqt", qblk,
                             kb[:, kj].float()) * scale
            s = softcap(s, cap)
            msk = _block_mask(q_pos, k_pos, causal=causal, window=window,
                              kv_len=None)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            r = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * r + p.sum(-1)
            acc = acc * r[..., None] + torch.einsum(
                "bkrqt,btkd->bkrqd", p, vb[:, kj].float())
            m = m_new
        blocks.append(acc / torch.clamp_min(l[..., None], 1e-37))
    # (nq, B, Kv, rep, qc, Dv) -> (B, S, H, Dv)
    o = torch.stack(blocks).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, Dv)
    return o.to(q.dtype)


def mha(q, k, v, *, scale, causal, window, cap, q_offset=0, kv_len=None,
        q_chunk=512, kv_chunk=1024, schedule="full"):
    """Dispatch: chunked for long sequences, plain for short/decode.  On
    a mesh (DTensor q, k, v) it runs on each rank's heads and batch rows
    (``heads_local``)."""
    if isinstance(q, DTensor):
        return heads_local(functools.partial(
            mha, scale=scale, causal=causal, window=window, cap=cap,
            q_offset=q_offset, kv_len=kv_len, q_chunk=q_chunk,
            kv_chunk=kv_chunk, schedule=schedule), q, k, v)
    S, T = q.shape[1], k.shape[1]
    if S <= q_chunk or S % q_chunk or T % kv_chunk:
        return plain_mha(q, k, v, scale=scale, causal=causal, window=window,
                         cap=cap, q_offset=q_offset, kv_len=kv_len)
    return chunked_mha(q, k, v, scale=scale, causal=causal, window=window,
                       cap=cap, q_offset=q_offset, q_chunk=q_chunk,
                       kv_chunk=kv_chunk, schedule=schedule)


def heads_local(fn, q, k, v):
    """``fn(q, k, v)`` (an attention core: q (B, S, H, D), k/v (B, T, Kv,
    Dv) -> (B, S, H, Dv)) on DTensors, each rank computing its own batch
    rows and heads: the batch over the data axes when they divide it, the
    heads over "model" when it divides both H and Kv (each rank's query
    heads then use exactly its own kv heads), replicated otherwise.
    Attention is independent per row and head, so this is the sharded
    computation itself, with no collective inside; it spares DTensor's
    propagation through the core's reshapes and einsums, which flatten
    two sharded dims at once."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    B, H, Kv = q.shape[0], q.shape[2], k.shape[2]
    dp = [i for i, a in enumerate(names) if a != "model"]
    dp_size = math.prod(mesh.size(i) for i in dp)
    want = []
    for i, a in enumerate(names):
        n = mesh.size(i)
        if n == 1:
            want.append(Replicate())
        elif a == "model":
            want.append(Shard(2) if H % n == 0 and Kv % n == 0
                        else Replicate())
        else:
            want.append(Shard(0) if B % dp_size == 0 else Replicate())
    o = fn(*(t.redistribute(mesh, want).to_local() for t in (q, k, v)))
    return DTensor.from_local(o, mesh, want, run_check=False)


def _check_fits(cache_pos: int, S: int, T: int) -> None:
    if cache_pos + S > T:
        raise ValueError(f"decode at {cache_pos} of {S} tokens past a cache "
                         f"of {T}")


class Attention(nn.Module):
    """The GQA layer: ``wq`` (d, H, dh), ``wk``/``wv`` (d, Kv, dh), ``wo``
    (H, dh, d) in the compute dtype (float32 masters with ``masters``);
    ``bq``/``bk``/``bv`` in float32."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        dh, dt = cfg.head_dim, held_dtype(cfg, masters)

        def init(shape):
            return param(dense_init(shape, generator=generator,
                                    device=device, dtype=dt), masters)

        self.wq = init((cfg.d_model, cfg.n_heads, dh))
        self.wk = init((cfg.d_model, cfg.n_kv, dh))
        self.wv = init((cfg.d_model, cfg.n_kv, dh))
        self.wo = init((cfg.n_heads, dh, cfg.d_model))
        if cfg.qkv_bias:
            for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv),
                                ("bv", cfg.n_kv)):
                setattr(self, name, param(torch.zeros(
                    (heads, dh), dtype=torch.float32, device=device),
                    masters))

    def forward(self, x, *, layer_local: bool = False, positions3=None,
                cache: Optional[dict] = None, cache_pos: Optional[int] = None,
                make_cache: bool = False, max_len: Optional[int] = None,
                is_cross: bool = False, cross_inputs=None):
        """Modes: train (``cache=None``) -> (y, None); prefill
        (``make_cache``) -> (y, cache of ``max_len`` positions, default
        S, the first S written); decode (``cache`` + ``cache_pos``) ->
        (y, the same cache, written at ``cache_pos``).  Rope is M-RoPE
        from ``positions3`` (3, B, S) when ``cfg.mrope_sections`` is set
        and ``positions3`` is given, else plain rope from ``cache_pos``
        (0 when None) on.

        Cross (``is_cross``): keys and values from ``cross_inputs`` (B,
        F, d) — prefill, ``make_cache`` returns them as the cross cache,
        F long whatever ``max_len`` is — or, when it is None, from
        ``cache`` (decode: read, returned as it is); no rope, no causal
        mask."""
        cfg = self.cfg
        B, S, _ = x.shape
        dh = cfg.head_dim
        dt = x.dtype
        scale = 1.0 / np.sqrt(dh)
        schedule = getattr(cfg, "attn_schedule", "full")

        q = project(x, self.wq.to(dt))
        if cfg.qkv_bias:
            q = q + self.bq.to(dt)

        if is_cross:
            # encoder-side k/v: no rope, no causal mask
            if cross_inputs is not None:
                k = project(cross_inputs, self.wk.to(dt))
                v = project(cross_inputs, self.wv.to(dt))
                if cfg.qkv_bias:
                    k, v = k + self.bk.to(dt), v + self.bv.to(dt)
                new_cache = (place_cache({"k": k, "v": v}) if make_cache
                             else cache)
            else:  # decode: the cross cache built at prefill
                k, v = cache["k"], cache["v"]
                new_cache = cache
            o = mha(q, k, v, scale=scale, causal=False, window=None,
                    cap=cfg.attn_softcap, schedule=schedule)
            y = project(o.reshape(B, S, -1),
                        self.wo.to(dt).reshape(-1, cfg.d_model))
            return y, new_cache

        if cfg.mrope_sections is not None and positions3 is not None:
            sin, cos = mrope_table(positions3, dh, cfg.rope_theta,
                                   cfg.mrope_sections)
        else:
            base = 0 if cache_pos is None else cache_pos
            positions = (base + torch.arange(S, device=x.device))[None, :]
            sin, cos = rope_table(positions.expand(B, S), dh,
                                  cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = project(x, self.wk.to(dt))
        v = project(x, self.wv.to(dt))
        if cfg.qkv_bias:
            k, v = k + self.bk.to(dt), v + self.bv.to(dt)
        k = apply_rope(k, sin, cos)

        window = cfg.sliding_window if layer_local else None

        if cache is None:
            o = mha(q, k, v, scale=scale, causal=True, window=window,
                    cap=cfg.attn_softcap, schedule=schedule)
            new_cache = None
            if make_cache:
                new_cache = init_layer_cache(cfg, B, max_len or S, k.dtype,
                                             like=k)
                write_seq(new_cache["k"], 0, k)
                write_seq(new_cache["v"], 0, v)
        else:
            # decode: write new k/v at cache_pos, attend over the prefix
            ck, cv = cache["k"], cache["v"]
            _check_fits(cache_pos, S, ck.shape[1])
            write_seq(ck, cache_pos, k)
            write_seq(cv, cache_pos, v)
            core = functools.partial(
                plain_mha, scale=scale, causal=True, window=window,
                cap=cfg.attn_softcap, q_offset=cache_pos,
                kv_len=cache_pos + S)
            o = (heads_local(core, q, ck, cv) if isinstance(q, DTensor)
                 else core(q, ck, cv))
            new_cache = cache

        y = project(o.reshape(B, S, -1),
                    self.wo.to(dt).reshape(-1, cfg.d_model))
        return y, new_cache


def init_layer_cache(cfg, batch: int, max_len: int, dtype,
                     device=None, like=None) -> dict:
    """One attention layer's zero cache of ``max_len`` positions, on
    ``device``, or made as the activation ``like`` is (placed by
    ``cache_specs``' rule under an active mesh)."""
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    if like is None:
        like = torch.empty(0, device=device)
    return {n: cache_zeros(n, shape, dtype, like) for n in ("k", "v")}


class MLA(nn.Module):
    """deepseek-v2's latent attention: ``w_dkv`` (d, kv_lora), ``w_kr``
    (d, rope), ``w_uk`` (kv_lora, H, nope), ``w_uv`` (kv_lora, H, v),
    ``wo`` (H, v, d) and either ``wq`` (d, H, nope + rope) or, when
    ``q_lora`` > 0, ``w_dq`` (d, q_lora) and ``w_uq`` (q_lora, H, nope +
    rope), in the compute dtype (float32 masters with ``masters``);
    ``kv_norm`` (and ``q_norm``) in float32.  The init keeps the JAX fan-in rule (the first axis: H for
    ``wo``).

    Prefill decompresses the keys and values and runs ``mha`` with its
    default chunks and schedule, as the JAX layer does (it does not read
    ``cfg.attn_schedule``); the cache holds only the normed latent and
    the rope key.  Decode is the absorbed form: the query is taken into
    latent space through ``w_uk``, scored against the latent cache in
    float32, and the latent output leaves through ``w_uv`` and ``wo``."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        H, d, dt = cfg.n_heads, cfg.d_model, held_dtype(cfg, masters)
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim

        def init(shape):
            return param(dense_init(shape, generator=generator,
                                    device=device, dtype=dt), masters)

        self.w_dkv = init((d, cfg.kv_lora))
        self.w_kr = init((d, cfg.qk_rope_dim))
        self.w_uk = init((cfg.kv_lora, H, cfg.qk_nope_dim))
        self.w_uv = init((cfg.kv_lora, H, cfg.v_head_dim))
        self.wo = init((H, cfg.v_head_dim, d))
        self.kv_norm = param(norm_init(cfg.kv_lora, device), masters)
        if cfg.q_lora:
            self.w_dq = init((d, cfg.q_lora))
            self.w_uq = init((cfg.q_lora, H, qk))
            self.q_norm = param(norm_init(cfg.q_lora, device), masters)
        else:
            self.wq = init((d, H, qk))

    def forward(self, x, *, cache: Optional[dict] = None,
                cache_pos: Optional[int] = None, make_cache: bool = False,
                max_len: Optional[int] = None):
        """The modes of ``Attention.forward``, with the latent cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        dt = x.dtype
        H = cfg.n_heads
        nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim
        scale = 1.0 / np.sqrt(nope + rdim)

        base = 0 if cache_pos is None else cache_pos
        positions = (base + torch.arange(S, device=x.device))[None, :]
        sin, cos = rope_table(positions.expand(B, S), rdim, cfg.rope_theta)

        if cfg.q_lora:
            cq = rmsnorm(self.q_norm, project(x, self.w_dq.to(dt)),
                         eps=cfg.norm_eps)
            q = project(cq, self.w_uq.to(dt))
        else:
            q = project(x, self.wq.to(dt))
        q_nope = q[..., :nope]
        q_rope = apply_rope(q[..., nope:], sin, cos)

        ckv = rmsnorm(self.kv_norm, project(x, self.w_dkv.to(dt)),
                      eps=cfg.norm_eps)
        kr = apply_rope(project(x, self.w_kr.to(dt))[:, :, None, :], sin,
                        cos)[:, :, 0]                     # shared head

        if cache is not None:
            # absorbed decode: stay in latent space
            cc, ckr = cache["ckv"], cache["kr"]
            T = cc.shape[1]
            _check_fits(cache_pos, S, T)
            write_seq(cc, cache_pos, ckv)
            write_seq(ckr, cache_pos, kr)
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope,
                                 self.w_uk.to(dt))        # (B,S,H,lora)
            ccf = cc.float()
            s = (torch.einsum("bshr,btr->bhst", q_lat.float(), ccf)
                 + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                ckr.float())) * scale
            q_pos = cache_pos + torch.arange(S, device=x.device)
            msk = _block_mask(q_pos, torch.arange(T, device=x.device),
                              causal=True, window=None,
                              kv_len=cache_pos + S)
            p = torch.softmax(torch.where(msk, s, NEG_INF), dim=-1)
            o_lat = torch.einsum("bhst,btr->bshr", p, ccf)
            o = torch.einsum("bshr,rhv->bshv", o_lat.to(dt),
                             self.w_uv.to(dt))
            new_cache = cache
        else:
            # train / prefill: decompress k, v and run the attention
            k_nope = project(ckv, self.w_uk.to(dt))
            v = project(ckv, self.w_uv.to(dt))
            k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, rdim)],
                          -1)
            qf = torch.cat([q_nope, q_rope], -1)
            o = mha(qf, k, v, scale=scale, causal=True, window=None,
                    cap=None)
            new_cache = None
            if make_cache:
                T = max_len or S
                new_cache = {
                    "ckv": cache_zeros("ckv", (B, T, cfg.kv_lora), dt,
                                       ckv),
                    "kr": cache_zeros("kr", (B, T, rdim), dt, ckv)}
                write_seq(new_cache["ckv"], 0, ckv)
                write_seq(new_cache["kr"], 0, kr)
        wo = self.wo.to(dt).reshape(-1, cfg.d_model)
        return project(o.reshape(B, S, -1), wo), new_cache
