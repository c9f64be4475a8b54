"""Single-launch fused map phase of one level (join + support): the CUDA
kernels, their wrappers and their plain PyTorch versions.

``fused_level_packed`` replaces the TPU kernel
``repro.kernels.fused_level.fused_level_packed_pallas``
(``src/repro/kernels/fused_level.py:263``, the main path while the
database has fewer than 2^16 graphs); ``fused_level`` replaces its dense
twin ``fused_level_pallas`` (``src/repro/kernels/fused_level.py:194``).
Both kernels live in ``csrc/fused_level.cu`` and run the row walk of
``csrc/join.cuh``, as the Pallas kernels share ``_joined_blocks``; the
two-launch join runs it too.  The source notes there say what bounds
them on the H100 and what the design does about it.

Inputs (one device; ``ops.py`` owns the padding contract):
  sched_meta (Cs, 6) int32  [parent, stub, to, fwd, triple, valid]
  tiles      (NT, 2) int32  [parent, triple] per tile of Cs/NT rows
  gmask      (Gw,)   uint32 valid-graph bit lanes (packed only)
  pol        (PP, P, G, M, K) int32, PAD -1     pmask (PP, P, G, M) bool
  src/dst    (PP, T, G, F) int32                emask (PP, T, G, F) bool

Outputs, in scheduled order (gather with ``schedule.inv``):
  sup (PP, Cs) int32, emb (PP, Cs) int32 and, packed, vbits (PP, Cs, Gw)
  uint32 — the per-graph verdict words.  Graphs in [G, 32·Gw) are
  treated as padding (PAD vertices, zero masks) without being stored.

A wrapper runs its plain version only for tensors on the CPU.  On a
CUDA tensor it launches the kernel on the current stream or raises;
each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import torch

from .bitset import WORD, pack_bits, popcount
from .build import check_tensors, join_geometry, launch, on_cpu, store_dims

__all__ = ["fused_level", "fused_level_packed", "fused_level_ref",
           "fused_level_packed_ref", "launches", "reset_launches",
           "DEFAULT_TILE_C"]

DEFAULT_TILE_C = 8

# kernel launches per wrapper since the last reset_launches()
launches = {"fused_level_packed": 0, "fused_level": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(sched_meta, tiles, pol, pmask, src, dst, emask, gmask=None):
    """Validate what the kernels take; return (PP, P, G, M, K, T, F, NT,
    TC)."""
    PP, P, G, M, K, T, F = store_dims(pol, pmask, src, dst, emask)
    if sched_meta.dim() != 2 or sched_meta.shape[1] != 6:
        raise ValueError(f"sched_meta {tuple(sched_meta.shape)} must be "
                         f"(Cs, 6)")
    if tiles.dim() != 2 or tiles.shape[1] != 2 or tiles.shape[0] == 0:
        raise ValueError(f"tiles {tuple(tiles.shape)} must be (NT, 2)")
    Cs, NT = sched_meta.shape[0], tiles.shape[0]
    if Cs % NT:
        raise ValueError(f"Cs={Cs} not a multiple of NT={NT}")
    other = {}
    if gmask is not None:
        other["gmask"] = gmask
        if gmask.dtype != torch.uint32 or gmask.dim() != 1:
            raise TypeError(f"gmask must be a 1-D uint32 tensor, got "
                            f"{gmask.dtype} {tuple(gmask.shape)}")
        if gmask.shape[0] * WORD < G:
            raise ValueError(f"gmask holds {gmask.shape[0]} words, fewer "
                             f"than G={G} graphs need")
    check_tensors(pol.device, dict(sched_meta=sched_meta, tiles=tiles,
                                   pol=pol, src=src, dst=dst),
                  dict(pmask=pmask, emask=emask), other)
    return PP, P, G, M, K, T, F, NT, Cs // NT


def fused_level_packed(sched_meta, tiles, gmask, pol, pmask, src, dst,
                       emask):
    """Packed single-launch level supports: ``(sup, emb, vbits)``."""
    PP, P, G, M, K, T, F, NT, TC = _check(sched_meta, tiles, pol, pmask,
                                          src, dst, emask, gmask)
    if on_cpu(pol):
        return fused_level_packed_ref(sched_meta, tiles, gmask, pol, pmask,
                                      src, dst, emask)
    threads, smem = join_geometry(PP, T)
    Cs, Gw, dev = sched_meta.shape[0], gmask.shape[0], pol.device
    sup = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    emb = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    vbits = torch.empty((PP, Cs, Gw), dtype=torch.uint32, device=dev)
    launch("fused_level_packed", launches,
           (sched_meta, tiles, gmask, pol, pmask, src, dst, emask, sup, emb,
            vbits),
           (PP, P, G, M, K, T, F, NT, TC, Gw, threads, smem))
    return sup, emb, vbits


def fused_level(sched_meta, tiles, pol, pmask, src, dst, emask):
    """Dense single-launch level supports: ``(sup, emb)``."""
    PP, P, G, M, K, T, F, NT, TC = _check(sched_meta, tiles, pol, pmask,
                                          src, dst, emask)
    if on_cpu(pol):
        return fused_level_ref(sched_meta, tiles, pol, pmask, src, dst,
                               emask)
    threads, smem = join_geometry(PP, T)
    Cs, dev = sched_meta.shape[0], pol.device
    sup = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    emb = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    launch("fused_level", launches,
           (sched_meta, tiles, pol, pmask, src, dst, emask, sup, emb),
           (PP, P, G, M, K, T, F, NT, TC, threads, smem))
    return sup, emb


# ---------------------------------------------------------------------------
# plain PyTorch versions (same function, same inputs)
# ---------------------------------------------------------------------------

def _slot_values(po: torch.Tensor, slot: int) -> torch.Tensor:
    """po[..., slot], or 0 when slot is outside [0, K)."""
    K = po.shape[-1]
    if 0 <= slot < K:
        return po[..., slot]
    return torch.zeros(po.shape[:-1], dtype=po.dtype, device=po.device)


def _fused_ref(sched_meta, tiles, gmask, pol, pmask, src, dst, emask):
    PP, P, G, M, K = pol.shape
    Cs, NT = sched_meta.shape[0], tiles.shape[0]
    tc = Cs // NT
    dev = pol.device
    meta_h = sched_meta.cpu().tolist()
    tiles_h = tiles.cpu().tolist()
    sup = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    emb = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    vbits = None
    if gmask is not None:
        Gw = gmask.shape[0]
        vbits = torch.zeros((PP, Cs, Gw), dtype=torch.uint32, device=dev)
        gm = gmask.to(torch.int64)
    for ct in range(NT):
        rows = meta_h[ct * tc:(ct + 1) * tc]
        if not any(r[5] for r in rows):
            continue                        # whole-invalid tile: skipped
        parent, triple = tiles_h[ct]
        po = pol[:, parent]                                   # (PP,G,M,K)
        pm = pmask[:, parent].bool()
        s, d = src[:, triple], dst[:, triple]                 # (PP,G,F)
        pair_ok = pm[..., :, None] & emask[:, triple].bool()[..., None, :]
        member = torch.zeros(pair_ok.shape, dtype=torch.bool, device=dev)
        for k in range(K):                  # once per tile, as the TPU
            member |= d[..., None, :] == po[..., :, k, None]
        for i, (_, stub, to, fwd, _, valid) in enumerate(rows):
            row = ct * tc + i
            ok = (s[..., None, :] == _slot_values(po, stub)[..., None]) & pair_ok
            if fwd == 1:
                ok &= ~member
            else:
                ok &= d[..., None, :] == _slot_values(po, to)[..., None]
            hit = ok.flatten(-2).any(-1)                      # (PP, G)
            emb[:, row] = ok.flatten(-3).sum(-1, dtype=torch.int32) * valid
            if vbits is None:
                sup[:, row] = hit.sum(-1, dtype=torch.int32) * valid
                continue
            words = pack_bits(hit & (valid != 0)).to(torch.int64)
            words = torch.nn.functional.pad(words, (0, Gw - words.shape[-1]))
            words = words & gm
            vbits[:, row] = words.to(torch.uint32)
            sup[:, row] = popcount(words).sum(-1, dtype=torch.int32)
    return sup, emb, vbits


def fused_level_packed_ref(sched_meta, tiles, gmask, pol, pmask, src, dst,
                           emask):
    """Plain PyTorch version of the packed kernel (same inputs, same
    outputs, any device)."""
    return _fused_ref(sched_meta, tiles, gmask, pol, pmask, src, dst, emask)


def fused_level_ref(sched_meta, tiles, pol, pmask, src, dst, emask):
    """Plain PyTorch version of the dense kernel."""
    sup, emb, _ = _fused_ref(sched_meta, tiles, None, pol, pmask, src, dst,
                             emask)
    return sup, emb
