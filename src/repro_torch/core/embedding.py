"""Dense occurrence-list (OL) algebra — the device-side data plane.

MIRAGE's support counting is OL intersection (paper §IV-A.3, Fig. 6): the
child pattern's embeddings are the parent's embeddings joined with the
adjoined edge's occurrences.  This module keeps the layout of
``repro.core.embedding``: the host builders stay numpy, and the join,
support and materialization functions are torch tensor code that runs on
whatever device its inputs live on.

Dense shapes for one partition (G graphs padded):

  edge-OL   : src/dst (T, G, F) int32 + mask (T, G, F) bool
              T = directed frequent label triples, F = max occ/graph
  level-k OL: ol (P, G, M, K) int32 + mask (P, G, M) bool
              P = |F_k| patterns, M = max embeddings/graph,
              K = k+1 (vertex-count pad; unused slots are -1)
  candidates: meta (C, 5) int32 rows [parent, stub, to, fwd, triple_idx]

The torch functions accept any number of leading dimensions in front of
these shapes (the level program passes the whole (PP, ...) partition
stack at once), and a candidate's fields may be Python ints or 0-dim
tensors on the inputs' device (the level program gathers them on the
card, so nothing is read back to the host).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels.bitset import pack_bits, popcount, tail_mask
from .candgen import Candidate
from .dfscode import Code
from .graphdb import Graph

__all__ = [
    "EdgeOL", "LevelOL",
    "build_edge_ol", "level1_ol", "candidate_meta",
    "join_valid", "local_supports_ref", "support_bits_ref",
    "materialize_one", "materialize_ol",
]

PAD = -1


@dataclasses.dataclass
class EdgeOL:
    """Partition-static directed edge occurrence lists (paper Fig. 12b)."""

    triples: np.ndarray    # (T, 3) int32 — the directed label-triple table
    src: np.ndarray        # (T, G, F) int32
    dst: np.ndarray        # (T, G, F) int32
    mask: np.ndarray       # (T, G, F) bool
    triple_index: dict[tuple[int, int, int], int]

    @property
    def shape(self):
        return self.src.shape


@dataclasses.dataclass
class LevelOL:
    """Stacked OLs for all frequent patterns of one level."""

    ol: torch.Tensor       # (..., P, G, M, K) int32, PAD-filled
    mask: torch.Tensor     # (..., P, G, M) bool

    @property
    def P(self):
        return self.ol.shape[-4]


def build_edge_ol(
    graphs: Sequence[Graph],
    triples: Sequence[tuple[int, int, int]],
    *,
    pad_graphs: int | None = None,
    max_occ: int | None = None,
) -> EdgeOL:
    """Preparation-phase construction (host, once per partition).

    ``triples`` must be the *directed* closure of the frequent-edge
    alphabet so every partition indexes the same table.
    """
    tindex = {tuple(t): i for i, t in enumerate(triples)}
    G = pad_graphs or len(graphs)
    occs: list[list[list[tuple[int, int]]]] = [
        [[] for _ in range(G)] for _ in range(len(triples))]
    for gi, g in enumerate(graphs):
        for (u, v), el in zip(g.edges, g.elabels):
            lu, lv = int(g.vlabels[u]), int(g.vlabels[v])
            for (a, la, b, lb) in ((int(u), lu, int(v), lv),
                                   (int(v), lv, int(u), lu)):
                ti = tindex.get((la, int(el), lb))
                if ti is not None:
                    occs[ti][gi].append((a, b))
    # ``max_occ`` pads F and never truncates: a graph's every
    # occurrence of a triple stays in its edge OL (the JAX package cuts
    # the rows to ``max_occ`` and loses joins; ROADMAP queue C, C1)
    F = max(max_occ or 1,
            max((len(o) for row in occs for o in row), default=1))
    T = len(triples)
    src = np.full((T, G, F), PAD, np.int32)
    dst = np.full((T, G, F), PAD, np.int32)
    mask = np.zeros((T, G, F), bool)
    for ti in range(T):
        for gi in range(G):
            o = occs[ti][gi][:F]
            if o:
                src[ti, gi, : len(o)] = [p[0] for p in o]
                dst[ti, gi, : len(o)] = [p[1] for p in o]
                mask[ti, gi, : len(o)] = True
    return EdgeOL(np.asarray(triples, np.int32), src, dst, mask, tindex)


def level1_ol(
    codes: Sequence[Code],
    eol: EdgeOL,
    *,
    max_embeddings: int,
) -> LevelOL:
    """F_1 OLs from the edge-OL (host tensors).

    A single-edge pattern (0,1,a,e,b) embeds at every directed occurrence
    of (a,e,b); when a == b the two orientations are distinct embeddings
    and already both present in the directed edge-OL.
    """
    P, M = len(codes), max_embeddings
    _, G, F = eol.src.shape
    ol = np.full((P, G, M, 2), PAD, np.int32)
    mask = np.zeros((P, G, M), bool)
    for pi, code in enumerate(codes):
        (i, j, a, e, b) = code[0]
        ti = eol.triple_index[(a, e, b)]
        take = min(M, F)
        ol[pi, :, :take, 0] = eol.src[ti, :, :take]
        ol[pi, :, :take, 1] = eol.dst[ti, :, :take]
        mask[pi, :, :take] = eol.mask[ti, :, :take]
    return LevelOL(torch.from_numpy(ol), torch.from_numpy(mask))


def candidate_meta(cands: Sequence[Candidate], eol: EdgeOL) -> np.ndarray:
    """(C, 5) int32: [parent, stub, to, fwd, triple_idx]."""
    rows = []
    for c in cands:
        rows.append([c.parent, c.ext.stub, c.ext.to, int(c.ext.forward),
                     eol.triple_index[c.ext.triple]])
    return np.asarray(rows, np.int32).reshape(-1, 5)


# ---------------------------------------------------------------------------
# Reference join — semantics oracle for the CUDA kernels
# ---------------------------------------------------------------------------

def _take(x: torch.Tensor, dim: int, i) -> torch.Tensor:
    """``x`` indexed by one (host int or device 0-dim tensor) index along
    ``dim``, dim dropped.  A device index stays on the device."""
    if isinstance(i, torch.Tensor):
        idx = i.reshape(1).to(device=x.device, dtype=torch.int64)
        return x.index_select(dim, idx).squeeze(dim)
    return x.select(dim, int(i))


def _slot_values(pol: torch.Tensor, slot) -> torch.Tensor:
    """``pol[..., slot]`` by one-hot sum: 0 where ``slot`` is outside
    [0, K) — the JAX join's exact semantics for an out-of-range id."""
    K = pol.shape[-1]
    hot = torch.arange(K, device=pol.device) == slot
    return torch.where(hot, pol, 0).sum(-1, dtype=torch.int32)


def join_valid(
    parent_ol: torch.Tensor,    # (..., G, M, K)
    parent_mask: torch.Tensor,  # (..., G, M)
    src: torch.Tensor,          # (..., G, F)
    dst: torch.Tensor,          # (..., G, F)
    emask: torch.Tensor,        # (..., G, F)
    stub, to, forward,
) -> torch.Tensor:
    """Valid-match mask (..., G, M, F): parent embedding m ⋈ edge
    occurrence f."""
    K = parent_ol.shape[-1]
    stub_vals = _slot_values(parent_ol, stub)                   # (..., G, M)
    hit = src[..., None, :] == stub_vals[..., :, None]          # (..., G, M, F)
    hit &= parent_mask[..., :, None].bool() & emask[..., None, :].bool()

    # forward: new endpoint must not already be in the embedding (one
    # (G, M, F) compare per vertex slot keeps the footprint at the
    # output size instead of K times it)
    member = torch.zeros_like(hit)
    for k in range(K):
        member |= dst[..., None, :] == parent_ol[..., :, k, None]
    # backward: other endpoint must be exactly embedding[to]
    to_vals = _slot_values(parent_ol, to)
    bwd_ok = dst[..., None, :] == to_vals[..., :, None]
    fwd = torch.as_tensor(forward, device=hit.device) != 0
    return hit & torch.where(fwd, ~member, bwd_ok)


def _join_candidate(pol, pmask, src, dst, emask, cand):
    """join_valid for one candidate row against stores with a pattern
    axis (..., P, G, M, K) and a triple axis (..., T, G, F)."""
    parent, stub, to, fwd, tidx = (cand[0], cand[1], cand[2], cand[3],
                                   cand[4])
    return join_valid(_take(pol, -4, parent), _take(pmask, -3, parent),
                      _take(src, -3, tidx), _take(dst, -3, tidx),
                      _take(emask, -3, tidx), stub, to, fwd)


def _host_rows(meta) -> np.ndarray:
    return (meta.cpu().numpy() if isinstance(meta, torch.Tensor)
            else np.asarray(meta)).astype(np.int64)


def local_supports_ref(
    level: LevelOL,
    eol_src: torch.Tensor, eol_dst: torch.Tensor, eol_mask: torch.Tensor,
    meta,                  # (C, 5) host rows
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-candidate local support (#graphs with >=1 match) and total
    embedding count (the straggler-rebalance cost signal), both int32 of
    shape (..., C) for stores with leading dims (...)."""
    sups, cnts = [], []
    for cand in _host_rows(meta):
        valid = _join_candidate(level.ol, level.mask, eol_src, eol_dst,
                                eol_mask, cand)
        sups.append(valid.flatten(-2).any(-1).sum(-1, dtype=torch.int32))
        cnts.append(valid.flatten(-3).sum(-1, dtype=torch.int32))
    lead = level.ol.shape[:-4]
    empty = torch.zeros(lead + (0,), dtype=torch.int32,
                        device=level.ol.device)
    if not sups:
        return empty, empty.clone()
    return torch.stack(sups, -1), torch.stack(cnts, -1)


def support_bits_ref(
    meta,                  # (C, 5) host rows
    pol: torch.Tensor,     # (..., P, G, M, K)
    pmask: torch.Tensor,   # (..., P, G, M)
    src: torch.Tensor,     # (..., T, G, F)
    dst: torch.Tensor,
    emask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bitset-shaped support masks — the oracle for the packed kernel
    (DESIGN.md §12).  Per candidate, the boolean per-graph verdict packs
    to a ``ceil(G/32)``-word uint32 bitset (LSB-first, pad bits zero) and
    local support is popcount over the words.  Returns
    ``(sup (..., C), emb (..., C), vbits (..., C, ceil(G/32)))``."""
    G = pol.shape[-3]
    gmask = tail_mask(G, device=pol.device).to(torch.int64)
    bits, embs = [], []
    for cand in _host_rows(meta):
        valid = _join_candidate(pol, pmask, src, dst, emask, cand)
        words = pack_bits(valid.flatten(-2).any(-1)).to(torch.int64)
        bits.append((words & gmask).to(torch.uint32))
        embs.append(valid.flatten(-3).sum(-1, dtype=torch.int32))
    lead = pol.shape[:-4]
    if not bits:
        z = torch.zeros(lead + (0,), dtype=torch.int32, device=pol.device)
        return z, z.clone(), torch.zeros(lead + (0, gmask.shape[0]),
                                         dtype=torch.uint32,
                                         device=pol.device)
    vbits = torch.stack(bits, -2)
    sup = popcount(vbits).sum(-1, dtype=torch.int32)
    return sup, torch.stack(embs, -1), vbits


def materialize_one(
    level: LevelOL,
    eol_src: torch.Tensor, eol_dst: torch.Tensor, eol_mask: torch.Tensor,
    cand,                       # (5,) one candidate row
    *,
    max_embeddings: int,
    out_width: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Child OL of ONE candidate: (..., G, Mc, W) rows, (..., G, Mc)
    mask, and the overflow (matches dropped by the Mc cap, summed over
    the leading dims) as an int32 0-dim tensor.

    ``out_width`` is the child's vertex-slot width W (default K+1).
    Under shape bucketing the parent store is already wider than its
    real pattern, so W may equal K — the new vertex then lands in a slot
    that held PAD — and must never shrink below it."""
    pol = level.ol
    G, M, K = pol.shape[-3:]
    F = eol_src.shape[-1]
    Mc = max_embeddings
    W = K + 1 if out_width is None else out_width
    if W < K:
        raise ValueError(f"out_width={W} below parent vertex width {K}")

    parent, to, fwd, tidx = cand[0], cand[2], cand[3], cand[4]
    p_ol = _take(pol, -4, parent)                                # (..,G,M,K)
    dst = _take(eol_dst, -3, tidx)                               # (..,G,F)
    valid = _join_candidate(pol, level.mask, eol_src, eol_dst, eol_mask,
                            cand)                                # (..,G,M,F)
    fwd_b = torch.as_tensor(fwd, device=pol.device) != 0

    # child embedding (m, f): parent row m extended by dst[f] (forward)
    # or unchanged (backward).  Backward duplicates (same m, several f)
    # are collapsed to the first f per m.
    first_f = (valid.cumsum(-1, dtype=torch.int32) == 1) & valid
    vsel = torch.where(fwd_b, valid, first_f)
    del valid, first_f

    lead = vsel.shape[:-2]
    flat = vsel.reshape(lead[:-1] + (G, M * F))
    # stable compaction: output slot r holds the index of the (r+1)-th
    # valid entry of its graph row, by binary search (side='left') over
    # the int32 prefix sums; slots past the row's count are masked off
    csum = flat.cumsum(-1, dtype=torch.int32)                    # (..,G,MF)
    tgt = torch.arange(1, Mc + 1, dtype=torch.int32, device=pol.device)
    tgt = tgt.expand(csum.shape[:-1] + (Mc,)).contiguous()
    order = torch.searchsorted(csum, tgt)
    order = torch.clamp(order, max=M * F - 1)                    # (..,G,Mc)
    n_valid = csum[..., -1]
    del csum
    picked = (torch.arange(Mc, device=pol.device)
              < n_valid[..., None])                              # (..,G,Mc)
    m_idx, f_idx = order // F, order % F

    par_rows = torch.gather(
        p_ol, -2, m_idx[..., None].expand(m_idx.shape + (K,)))   # (..,G,Mc,K)
    new_v = torch.gather(dst, -1, f_idx)                         # (..,G,Mc)
    if W > K:
        child = torch.nn.functional.pad(par_rows, (0, W - K), value=PAD)
    else:
        child = par_rows
    # the new vertex goes to its DFS id (= ext.to for forward edges)
    slot = torch.arange(W, device=pol.device) == to
    child = torch.where(slot & fwd_b, new_v[..., None], child)
    child = torch.where(picked[..., None], child, PAD)
    overflow = (vsel.sum(dtype=torch.int32)
                - picked.sum(dtype=torch.int32))
    return child.to(torch.int32), picked, overflow


def materialize_ol(
    level: LevelOL,
    eol_src: torch.Tensor, eol_dst: torch.Tensor, eol_mask: torch.Tensor,
    meta,                       # (C', 5) host rows — survivors only
    *,
    max_embeddings: int,
    out_width: int | None = None,
) -> tuple[LevelOL, torch.Tensor]:
    """Compacted child OLs for the surviving candidates (pass 2).

    Returns the next LevelOL (pattern axis = the survivors, ``out_width``
    vertex slots, default K+1) and the per-candidate overflow count.
    Every row is a live slot of ``kernels.materialize.materialize_level``:
    one kernel launch on the card, the ``materialize_one`` loop on the
    CPU."""
    # imported here: the kernels' wrappers import this module
    from ..kernels.materialize import materialize_level
    dev = level.ol.device
    rows = torch.from_numpy(_host_rows(meta).astype(np.int32).reshape(-1, 5))
    cmeta = rows.to(dev)
    n_keep = torch.tensor(rows.shape[0], dtype=torch.int32, device=dev)
    ol, mask, over = materialize_level(
        cmeta, n_keep, level.ol, level.mask, eol_src, eol_dst, eol_mask,
        max_embeddings=max_embeddings, out_width=out_width)
    return LevelOL(ol, mask), over
