"""Pass 2 of one level: the child occurrence lists of every compact
survivor slot in one launch — the CUDA kernel's wrapper and its plain
version.

``materialize_level`` computes, for each slot s of the (S, 5) candidate
rows ``cmeta``, what ``core.embedding.materialize_one`` computes for
``cmeta[s]``, bit for bit, and writes it straight into the level's child
store.  Slots at or past the survivor count ``n_keep`` (a 0-dim device
int32: the host learns it only from the level's wire) are PAD with a
false mask and zero overflow, and on the card they do no join.  It
replaces no Pallas kernel: the JAX package materializes with XLA under a
``lax.cond`` that skips the dead slots.  The kernel is
``materialize_level_kernel`` in ``csrc/materialize.cu``; the source note
there says what bounds it on the H100.

Inputs (one device):
  cmeta      (S, 5) int32    [parent, stub, to, fwd, triple] per slot
  n_keep     () int32        survivor count
  pol        (..., P, G, M, K) int32, PAD -1   pmask (..., P, G, M) bool
  src/dst    (..., T, G, F) int32              emask (..., T, G, F) bool
Outputs: ol (..., S, G, Mc, W) int32, mask (..., S, G, Mc) bool and the
per-slot overflow (S,) int32 (matches dropped by the Mc cap, summed over
the leading dims and the graphs).  W is ``out_width`` (default K + 1)
and never below K.

The wrapper runs the plain version (the per-slot ``materialize_one``
loop) only for tensors on the CPU.  On a CUDA tensor it launches the
kernel on the current stream or raises; each launch adds one to
:data:`launches`.
"""
from __future__ import annotations

import math

import torch

from ..core.embedding import PAD, LevelOL, materialize_one
from .build import check_tensors, launch, on_cpu, store_dims

__all__ = ["materialize_level", "materialize_level_ref", "launches",
           "reset_launches"]

# kernel launches since the last reset_launches()
launches = {"materialize_level": 0}

# the grid's y (slots) and z (partitions) limit
_GRID_YZ = 65535


def reset_launches() -> None:
    launches["materialize_level"] = 0


def _width(K: int, out_width: int | None) -> int:
    W = K + 1 if out_width is None else out_width
    if W < K:
        raise ValueError(f"out_width={W} below parent vertex width {K}")
    return W


def materialize_level_ref(cmeta, n_keep, pol, pmask, src, dst, emask, *,
                          max_embeddings: int,
                          out_width: int | None = None):
    """Plain PyTorch version: ``materialize_one`` per slot, masked past
    ``n_keep`` (any device, any leading dims)."""
    S, Mc = cmeta.shape[0], max_embeddings
    lead = pol.shape[:-4]
    G, _, K = pol.shape[-3:]
    W = _width(K, out_width)
    dev = pol.device
    ol = torch.full(lead + (S, G, Mc, W), PAD, dtype=torch.int32,
                    device=dev)
    mask = torch.zeros(lead + (S, G, Mc), dtype=torch.bool, device=dev)
    over = torch.zeros(S, dtype=torch.int32, device=dev)
    valid_s = torch.arange(S, device=dev) < n_keep
    parents = LevelOL(pol, pmask)
    for s in range(S):
        ch, mk, ov = materialize_one(parents, src, dst, emask, cmeta[s],
                                     max_embeddings=Mc, out_width=W)
        v = valid_s[s]
        ol[..., s, :, :, :] = ch.masked_fill_(~v, PAD)
        mask[..., s, :, :] = mk & v
        over[s] = ov * v
    return ol, mask, over


def materialize_level(cmeta, n_keep, pol, pmask, src, dst, emask, *,
                      max_embeddings: int, out_width: int | None = None):
    """``(ol, mask, over)`` of the S slots of ``cmeta``; see the module
    docstring.  The rows of live slots must index inside the stores (the
    callers check their host rows; on the card a row outside them gives
    an all-PAD slot)."""
    if cmeta.dim() != 2 or cmeta.shape[1] != 5:
        raise ValueError(f"cmeta {tuple(cmeta.shape)} must be (S, 5)")
    if n_keep.dim() != 0:
        raise ValueError(f"n_keep must be 0-dim, got {tuple(n_keep.shape)}")
    if pol.dim() < 4:
        raise ValueError(f"pol {tuple(pol.shape)} must be (..., P, G, M, K)")
    lead = pol.shape[:-4]
    n_lead = math.prod(lead)
    flat = [x.reshape((n_lead,) + x.shape[len(lead):])
            for x in (pol, pmask, src, dst, emask)]
    PP, P, G, M, K, T, F = store_dims(*flat)
    W = _width(K, out_width)
    S, Mc = cmeta.shape[0], max_embeddings
    check_tensors(pol.device, dict(cmeta=cmeta, n_keep=n_keep, pol=pol,
                                   src=src, dst=dst),
                  dict(pmask=pmask, emask=emask))
    if on_cpu(pol):
        return materialize_level_ref(cmeta, n_keep, pol, pmask, src, dst,
                                     emask, max_embeddings=Mc, out_width=W)
    if S > _GRID_YZ or PP > _GRID_YZ:
        raise ValueError(f"S={S} slots or {PP} partitions exceed the CUDA "
                         f"grid limit {_GRID_YZ}")
    dev = pol.device
    ol = torch.empty((PP, S, G, Mc, W), dtype=torch.int32, device=dev)
    mask = torch.empty((PP, S, G, Mc), dtype=torch.bool, device=dev)
    over = torch.zeros(S, dtype=torch.int32, device=dev)
    if PP and S and G:
        launch("materialize_level", launches,
               (cmeta, n_keep, *flat, ol, mask, over),
               (PP, P, G, M, K, T, F, S, Mc, W))
    return (ol.reshape(lead + ol.shape[1:]),
            mask.reshape(lead + mask.shape[1:]), over)
