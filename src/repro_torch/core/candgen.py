"""Rightmost-path candidate generation (paper §IV-A.1).

Iteration k turns each frequent size-k pattern into size-(k+1) candidates
by adjoining one frequent edge:

  * **forward edge** — from any vertex on the rightmost path (RMP) to a
    brand-new vertex, which receives the next DFS id;
  * **back edge** — from the rightmost vertex (RMV) to another RMP vertex,
    provided the edge does not already exist (no multigraphs — paper
    Fig. 4 discussion).

The adjoined edge's label triple must belong to the globally frequent
edge alphabet (``F_1``), the Apriori prune.  Every candidate then passes
the min-dfs-code canonicality test (`dfscode.is_canonical`): of all
generation paths of a pattern exactly one survives, so the candidate
space is duplicate-free (completeness + no recount).

Candidates are *metadata* (host-side, tiny).  Each carries the join recipe
(`Extension`) the device layer executes against partition-local occurrence
lists.

The device half at the end (``device_candidates``, ``device_schedule``)
recasts the generator and the schedule as fixed-shape PyTorch programs
for the whole-run device loop (DESIGN.md §13), the port of
``repro.core.candgen``'s ``jnp`` twins: same candidates, same order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np
import torch

from .dfscode import (Code, Edge5, _compact_rows, _dump_index,
                      _gather_clamped, array_to_code,
                      code_array_rightmost_path, code_array_vertex_labels,
                      code_to_graph, is_canonical, min_dfs_canonical_array,
                      rightmost_path)

__all__ = ["Extension", "Candidate", "EdgeAlphabet", "generate_candidates",
           "filter_speculative", "CandidateSchedule", "schedule_candidates",
           "pad_schedule", "device_candidates", "device_candgen",
           "candidates_from_arrays", "device_schedule"]


@dataclasses.dataclass(frozen=True)
class Extension:
    """Join recipe for the device layer.

    forward:  child_emb = parent_emb + [v]  for edge occurrences (u, v) of
              ``triple`` with u == parent_emb[stub] and v not in parent_emb
    backward: child_emb = parent_emb        if an occurrence (u, v) of
              ``triple`` has u == parent_emb[stub] and v == parent_emb[to]
    """

    forward: bool
    stub: int            # dfs id of the existing attachment vertex
    to: int              # dfs id of other endpoint (new id if forward)
    triple: tuple[int, int, int]  # (l_stub, l_edge, l_other)


@dataclasses.dataclass(frozen=True)
class Candidate:
    code: Code           # parent code + one edge (already canonical)
    parent: int          # index into F_k
    ext: Extension

    @property
    def size(self) -> int:
        return len(self.code)


class EdgeAlphabet:
    """Globally frequent single-edge label triples (= F_1 keys).

    Stored symmetrically: ``(a, e, b)`` present iff ``(b, e, a)`` present.
    The *canonical* triple has ``a <= b``.
    """

    def __init__(self, triples: Iterable[tuple[int, int, int]]):
        s = set()
        for (a, e, b) in triples:
            s.add((int(a), int(e), int(b)))
            s.add((int(b), int(e), int(a)))
        self._set = frozenset(s)
        self.vlabels = sorted({a for (a, _, _) in s})
        self.elabels = sorted({e for (_, e, _) in s})

    def __contains__(self, triple: tuple[int, int, int]) -> bool:
        return tuple(int(x) for x in triple) in self._set

    def __len__(self) -> int:
        return len(self._set)

    def canonical(self) -> list[tuple[int, int, int]]:
        return sorted(t for t in self._set if t[0] <= t[2])

    def partners(self, label: int) -> list[tuple[int, int]]:
        """All (edge_label, other_vertex_label) adjoinable to ``label``."""
        return sorted({(e, b) for (a, e, b) in self._set if a == label})


def generate_candidates(
    frequent: Sequence[Code],
    alphabet: EdgeAlphabet,
) -> list[Candidate]:
    """All canonical size-(k+1) candidates from the frequent size-k set.

    Host-side cost is O(|F_k| · RMP · alphabet) plus one canonicality check
    per raw candidate — pattern-metadata scale, negligible next to
    support counting (the device side).
    """
    out: list[Candidate] = []
    for pidx, code in enumerate(frequent):
        g = code_to_graph(code)
        rmp = rightmost_path(code)
        rmv = rmp[-1]
        existing = {(min(int(u), int(v)), max(int(u), int(v)))
                    for (u, v) in g.edges}
        vl = g.vlabels
        n_v = g.n_vertices

        # ---- back edges: RMV -> strict-ancestor RMP vertex
        for w in rmp[:-1]:
            if (min(rmv, w), max(rmv, w)) in existing:
                continue  # would duplicate an edge (multigraph) — skip
            for (e_lab, other) in alphabet.partners(int(vl[rmv])):
                if other != int(vl[w]):
                    continue
                edge: Edge5 = (rmv, w, int(vl[rmv]), e_lab, int(vl[w]))
                child = code + (edge,)
                if is_canonical(child):
                    out.append(Candidate(child, pidx,
                                         Extension(False, rmv, w,
                                                   (int(vl[rmv]), e_lab, int(vl[w])))))

        # ---- forward edges: any RMP vertex -> new vertex (id = n_v)
        for w in rmp:
            for (e_lab, other) in alphabet.partners(int(vl[w])):
                edge = (int(w), n_v, int(vl[w]), e_lab, other)
                child = code + (edge,)
                if is_canonical(child):
                    out.append(Candidate(child, pidx,
                                         Extension(True, int(w), n_v,
                                                   (int(vl[w]), e_lab, other))))
    return out


def filter_speculative(spec: Sequence[Candidate],
                       keep: Sequence[int]) -> list[Candidate]:
    """Narrow a speculatively generated candidate list to the surviving
    parents (the overlapped-candgen path, DESIGN.md §11).

    ``spec`` was generated from level k's FULL candidate list — a
    superset of the frequent set F_k, available before the device
    program reports which candidates survived.  ``keep`` holds the
    surviving indices, ascending.  Because ``generate_candidates``
    visits parents in list order and each parent's extensions (RMP,
    existing-edge set, canonicality) depend on that parent's code alone,
    dropping non-survivors and remapping ``parent`` to its rank in
    ``keep`` yields EXACTLY ``generate_candidates([F[i] for i in keep],
    alphabet)`` — same candidates, same order.  The equivalence is
    pinned by a conformance test; the speculation itself is therefore
    semantically free, costing only wasted host work when survival is
    sparse."""
    rank = {int(p): r for r, p in enumerate(keep)}
    return [dataclasses.replace(c, parent=rank[c.parent])
            for c in spec if c.parent in rank]


# ---------------------------------------------------------------------------
# Parent-grouped candidate scheduling (fused map-phase feed)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateSchedule:
    """Tile-aligned candidate order for the fused level kernel.

    Candidates sorted by ``(parent, triple)`` and padded per group so
    every ``tile_c``-row block shares one parent OL and one edge-OL —
    the kernel streams those HBM tiles once per *block* instead of once
    per candidate.  ``inv[i]`` is the scheduled row of canonical
    candidate ``i``; gathering scheduled outputs with ``inv`` restores
    canonical order (the permutation round-trip the miner relies on).
    """

    meta: np.ndarray     # (Cs, 6) int32 [parent, stub, to, fwd, triple, valid]
    tiles: np.ndarray    # (Cs/tile_c, 2) int32 [parent, triple] per block
    inv: np.ndarray      # (C,) int32 — scheduled row of canonical candidate i
    tile_c: int

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]


def _padded_size(group_sizes: np.ndarray, tc: int) -> int:
    return int((-(-group_sizes // tc) * tc).sum())


def schedule_candidates(meta: np.ndarray, tile_c: int = 8, *,
                        max_inflation: float = 1.5) -> CandidateSchedule:
    """Host-side pass: group ``(C, 5)`` candidate metadata into uniform
    ``(parent, triple)`` tiles of ``tile_c`` rows.

    Stable-sorts by parent (major) then triple (minor), chunks each group
    into ``tile_c`` blocks, and pads the last block of each group with
    ``valid=0`` rows carrying the group's own (parent, triple) so block
    descriptors stay uniform.

    The tile size ADAPTS to the grouping structure: padding inflates the
    scheduled row count by one partial tile per distinct (parent, triple)
    pair, and padded rows burn real kernel compute (they are masked, not
    skipped).  Starting from ``tile_c`` and halving, the largest tile
    size whose padded row count stays within ``max_inflation``·C is
    chosen — candidate sets with heavy sibling sharing (the common case:
    every parent emits one candidate per alphabet partner) get wide
    blocks and maximal HBM-tile reuse, while adversarially scattered sets
    degrade gracefully to ``tile_c=1`` (still single-launch, still no
    (C, G) intermediates) instead of 8×-ing the map-phase work.

    Shape bucketing pads the finished schedule via ``pad_schedule``
    (whole invalid tiles + a parked inverse-permutation tail) — see
    ``core/buckets.py`` and the bucketed path of ``dispatch_level``.
    """
    meta = np.asarray(meta, np.int32).reshape(-1, 5)
    C = meta.shape[0]
    if tile_c < 1:
        raise ValueError(f"tile_c={tile_c} must be >= 1")
    if C == 0:                       # emit one fully-padded tile
        return CandidateSchedule(
            np.tile(np.asarray([0, 0, 0, 1, 0, 0], np.int32), (tile_c, 1)),
            np.zeros((1, 2), np.int32), np.empty(0, np.int32), tile_c)

    order = np.lexsort((meta[:, 4], meta[:, 0]))     # triple minor, parent major
    keys = meta[order][:, [0, 4]]
    boundaries = np.any(keys[1:] != keys[:-1], axis=1)
    group_sizes = np.diff(np.concatenate(
        [[0], np.flatnonzero(boundaries) + 1, [C]]))
    while tile_c > 1 and _padded_size(group_sizes, tile_c) > max_inflation * C:
        tile_c = tile_c // 2

    starts = np.cumsum(group_sizes) - group_sizes    # into `order`
    tiles_per_group = -(-group_sizes // tile_c)
    padded = tiles_per_group * tile_c
    offsets = np.cumsum(padded) - padded             # group start row in sched
    Cs = int(padded.sum())

    group_keys = keys[starts]                        # (n_groups, 2) [parent, triple]
    tiles = np.repeat(group_keys, tiles_per_group, axis=0)

    sched = np.empty((Cs, 6), np.int32)              # pad rows first …
    sched[:, [0, 4]] = np.repeat(group_keys, padded, axis=0)
    sched[:, [1, 2]] = 0
    sched[:, 3] = 1
    sched[:, 5] = 0
    # … then overwrite the leading rows of each group span with the real
    # candidates (padding sits only at group tails, so every tile_c block
    # stays within one group)
    pos = np.repeat(offsets, group_sizes) + (np.arange(C)
                                             - np.repeat(starts, group_sizes))
    sched[pos, :5] = meta[order]
    sched[pos, 5] = 1
    inv = np.empty(C, np.int32)
    inv[order] = pos
    return CandidateSchedule(sched, tiles.astype(np.int32), inv, tile_c)


def pad_schedule(sched: CandidateSchedule, *, rows_to: int | None = None,
                 inv_to: int | None = None) -> CandidateSchedule:
    """Bucket-pad an existing schedule (see ``schedule_candidates``):
    whole invalid tiles up to ``rows_to`` scheduled rows, and the
    inverse permutation out to ``inv_to`` padded candidates."""
    meta, tiles, inv = _pad_schedule(sched.meta, sched.tiles, sched.inv,
                                     sched.tile_c, rows_to, inv_to)
    return CandidateSchedule(meta, tiles, inv, sched.tile_c)


def _pad_schedule(sched: np.ndarray, tiles: np.ndarray, inv: np.ndarray,
                  tile_c: int, pad_rows_to: int | None,
                  pad_inv_to: int | None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket padding: whole invalid tiles on the row axis, parked
    pointers on the inverse permutation (see ``schedule_candidates``)."""
    Cs = sched.shape[0]
    target = Cs
    if pad_rows_to is not None:
        target = max(Cs, -(-pad_rows_to // tile_c) * tile_c)
    need_inv = pad_inv_to is not None and pad_inv_to > inv.shape[0]
    if need_inv and target == Cs and not (sched[:, 5] == 0).any():
        target += tile_c             # guarantee a row to park inv padding
    if target > Cs:
        pad_row = np.asarray([0, 0, 0, 1, 0, 0], np.int32)
        sched = np.concatenate([sched,
                                np.tile(pad_row, (target - Cs, 1))])
        tiles = np.concatenate(
            [tiles, np.zeros(((target - Cs) // tile_c, 2), np.int32)])
    if need_inv:
        # an invalid row always exists here (appended above if needed),
        # so padded candidates can never read a real candidate's support
        park = int(np.flatnonzero(sched[:, 5] == 0)[0])
        inv = np.concatenate(
            [inv, np.full(pad_inv_to - inv.shape[0], park, np.int32)])
    return sched, tiles, inv


# ---------------------------------------------------------------------------
# Device-side candidate generation + schedule (pipeline="device_loop",
# DESIGN.md §13) — `generate_candidates` and `schedule_candidates` recast
# as fixed-shape PyTorch programs so the level loop can stay on device.
# Nothing here reads a device value back: counts stay 0-dim tensors, and
# every scatter writes a dump slot that is sliced off.
# ---------------------------------------------------------------------------

def _compact_mask(mask: torch.Tensor, cap: int):
    """Prefix-sum compact a flat bool mask into ``cap`` index slots.

    Returns (idx (cap,) int64 — flat indices of the first ``cap`` set
    entries in order, 0-filled past ``n``; n int32; overflow)."""
    n = mask.sum()
    return _compact_rows(mask[None], cap)[0], n.to(torch.int32), n > cap


def _parent_slots(codes: torch.Tensor, pvalid: torch.Tensor,
                  triples: torch.Tensor, n_vertex_slots: int):
    """All structural extension slots of a batch of parent codes
    (pre-canonicality).

    Slot order matches `generate_candidates` exactly: back-edge slots
    (RMP ancestors root-first × alphabet rows) then forward slots (RMP
    vertices root-first × alphabet rows); the triples table is the sorted
    directed closure of the alphabet, so masking rows on the stub label
    leaves the same sorted ``partners`` subsequence the host iterates.

    Returns (ok (SP, SLOTS), edge (SP, SLOTS, 5), meta (SP, SLOTS, 4)
    [stub, to, fwd, triple]) with SLOTS = (2·NV − 1)·T, int64."""
    NV = n_vertex_slots
    SP, L = codes.shape[0], codes.shape[1]
    T = triples.shape[0]
    dev = codes.device
    code = codes.long()
    valid_e = code[..., 0] >= 0
    ne = valid_e.sum(1)
    vl = code_array_vertex_labels(code, NV)
    rmp, rmp_len, n_v = code_array_rightmost_path(code, NV)
    rmv = n_v - 1
    umin = torch.minimum(code[..., 0], code[..., 1])
    umax = torch.maximum(code[..., 0], code[..., 1])
    ta, te, tb = triples.long().unbind(1)
    tidx = torch.arange(T, device=dev)
    l_rmv = _gather_clamped(vl, rmv[:, None])[:, 0]
    room = (pvalid & (ne < L))[:, None, None]

    # ---- back-edge slots: (w_pos, t) for w_pos in [0, NV-2]
    wb = rmp[:, :NV - 1]                                         # (SP, NV-1)
    lb = _gather_clamped(vl, wb)
    edge_dup = (valid_e[:, None, :] & (umin[:, None, :] == wb[..., None])
                & (umax[:, None, :] == rmv[:, None, None])).any(2)
    okb = ((torch.arange(NV - 1, device=dev) < rmp_len[:, None] - 1
            )[..., None]
           & room & (ta == l_rmv[:, None])[:, None, :]
           & (tb == lb[..., None]) & ~edge_dup[..., None])        # (SP,NV-1,T)
    sb = (SP, NV - 1, T)
    bi = rmv[:, None, None].expand(sb)
    bj = wb[..., None].expand(sb)
    b_edge = torch.stack([bi, bj, ta.expand(sb), te.expand(sb),
                          tb.expand(sb)], -1)
    b_meta = torch.stack([bi, bj, torch.zeros_like(bi), tidx.expand(sb)], -1)

    # ---- forward slots: (w_pos, t) for w_pos in [0, NV-1]
    wf = rmp                                                     # (SP, NV)
    lf = _gather_clamped(vl, wf)
    okf = ((torch.arange(NV, device=dev) < rmp_len[:, None])[..., None]
           & room & (n_v < NV)[:, None, None]
           & (ta == lf[..., None]))                              # (SP,NV,T)
    sf = (SP, NV, T)
    fi = wf[..., None].expand(sf)
    fj = n_v[:, None, None].expand(sf)
    f_edge = torch.stack([fi, fj, ta.expand(sf), te.expand(sf),
                          tb.expand(sf)], -1)
    f_meta = torch.stack([fi, fj, torch.ones_like(fi), tidx.expand(sf)], -1)

    ok = torch.cat([okb.reshape(SP, -1), okf.reshape(SP, -1)], 1)
    edge = torch.cat([b_edge.reshape(SP, -1, 5), f_edge.reshape(SP, -1, 5)],
                     1)
    meta = torch.cat([b_meta.reshape(SP, -1, 4), f_meta.reshape(SP, -1, 4)],
                     1)
    return ok, edge, meta


def device_candidates(codes: torch.Tensor, n_par, triples: torch.Tensor, *,
                      n_vertex_slots: int, raw_budget: int, budget: int,
                      max_states: int):
    """Device twin of `generate_candidates` over array-shaped codes
    ``(SP, L, 5)``, the first ``n_par`` (an int or a 0-dim tensor) real.

    Two-stage compaction keeps the expensive canonicality machine off
    label-mismatched slots: structural slots are prefix-sum compacted
    into ``raw_budget`` rows first, `min_dfs_canonical_array` runs only
    over those, and canonical survivors compact again into ``budget``
    rows — parent-major and order-preserving, so row r is EXACTLY the
    r-th candidate the host generator would emit.

    Returns (meta (budget, 5) int32 [parent, stub, to, fwd, triple], pad
    rows [0,0,0,1,0]; child_codes (budget, L, 5) int32 -1-padded; n_cand
    int32; flags (3,) bool [raw overflow, canonical overflow, state
    overflow]).  Real rows index parents below SP and triples below T."""
    SP, L = codes.shape[0], codes.shape[1]
    NV = n_vertex_slots
    dev = codes.device
    pvalid = torch.arange(SP, device=dev) < n_par
    ok, edge, meta4 = _parent_slots(codes, pvalid, triples, NV)
    SLOTS = ok.shape[1]

    raw_idx, n_raw, raw_ovf = _compact_mask(ok.reshape(-1), raw_budget)
    raw_real = torch.arange(raw_budget, device=dev) < n_raw
    p_r = raw_idx // SLOTS                                       # (CBR,)
    pcode = codes.long().index_select(0, p_r)                    # (CBR,L,5)
    e_r = edge.reshape(-1, 5).index_select(0, raw_idx)
    m_r = meta4.reshape(-1, 4).index_select(0, raw_idx)
    ne_r = (pcode[..., 0] >= 0).sum(1)
    rows = torch.arange(L, device=dev)
    child = torch.where(rows[None, :, None] == ne_r[:, None, None],
                        e_r[:, None, :], pcode)                  # (CBR,L,5)

    canon, st_ovf = min_dfs_canonical_array(
        child, n_vertex_slots=NV, max_states=max_states)

    can_idx, n_cand, can_ovf = _compact_mask(canon & raw_real, budget)
    can_real = (torch.arange(budget, device=dev) < n_cand)[:, None]
    pad_row = (torch.arange(5, device=dev) == 3).long()          # [0,0,0,1,0]
    meta = torch.where(
        can_real,
        torch.cat([p_r[can_idx, None], m_r.index_select(0, can_idx)], 1),
        pad_row).to(torch.int32)
    out_codes = torch.where(can_real[..., None],
                            child.index_select(0, can_idx),
                            -1).to(torch.int32)
    flags = torch.stack([raw_ovf, can_ovf, (st_ovf & raw_real).any()])
    return meta, out_codes, n_cand, flags


@functools.lru_cache(maxsize=64)
def device_candgen(L: int, n_vertex_slots: int, raw_budget: int,
                   budget: int, max_states: int):
    """The `device_candidates` generator built once per static config
    (codes of width ``L``) — the counterpart of the JAX package's cached
    ``device_candgen_jit`` for the candgen="device" stepping stone
    (standalone, outside the whole-run loop)."""
    def generate(codes, n_par, triples):
        if codes.shape[1] != L:
            raise ValueError(f"codes of width {codes.shape[1]}, the "
                             f"generator was built for {L}")
        return device_candidates(
            codes, n_par, triples, n_vertex_slots=n_vertex_slots,
            raw_budget=raw_budget, budget=budget, max_states=max_states)
    return generate


def candidates_from_arrays(meta: np.ndarray, child_codes: np.ndarray,
                           n_cand: int,
                           triples: Sequence[tuple[int, int, int]]
                           ) -> list[Candidate]:
    """Rebuild host `Candidate` objects from `device_candidates` output
    (same candidates, same order)."""
    out = []
    for r in range(int(n_cand)):
        p, stub, to, fwd, tri = (int(x) for x in meta[r])
        a, e, b = triples[tri]
        out.append(Candidate(array_to_code(child_codes[r]), p,
                             Extension(bool(fwd), stub, to,
                                       (int(a), int(e), int(b)))))
    return out


def device_schedule(meta: torch.Tensor, n_cand, *, tile_c: int,
                    n_triples: int, rows: int):
    """Device twin of `schedule_candidates` under fixed shapes.

    Stable-sorts candidate slots by (parent, triple), sizes each group's
    tile-aligned span with a prefix sum, and emits the same
    (sched_meta (rows, 6) int32, tiles (rows/tile_c, 2) int32, inv (CB,)
    int64) the fused kernel consumes, plus the overflow flag: if the
    tile-padded row count exceeds ``rows`` the miner bails to the host
    pipeline.  Pad rows are ``valid = 0`` and pad tiles key to parent 0
    and triple 0; padding slots of ``inv`` park at row 0 — downstream
    gathers mask on the real candidate count."""
    CB = meta.shape[0]
    tc = tile_c
    NT = rows // tc
    dev = meta.device
    ar = torch.arange(CB, device=dev)
    m = meta.long()
    valid = ar < n_cand
    key = m[:, 0] * n_triples + m[:, 4]
    skey_in = torch.where(valid, key, 1 << 30)
    order = torch.argsort(skey_in, stable=True)
    skey = skey_in[order]
    svalid = valid[order]

    first = svalid & ((ar == 0) | (skey != torch.roll(skey, 1)))
    gid = first.cumsum(0) - 1                        # group id per sorted row
    n_groups = first.sum()
    gs = torch.zeros(CB + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, _dump_index(gid, svalid, CB), torch.ones_like(gid))[:CB]
    tpg = (gs + tc - 1) // tc                        # tiles per group
    padded = tpg * tc
    goff = padded.cumsum(0) - padded                 # group start sched row
    gstart = gs.cumsum(0) - gs                       # group start sorted row
    cg = gid.clamp(0, CB - 1)
    srows = goff[cg] + (ar - gstart[cg])
    ovf = padded.sum() > rows

    inv = torch.empty(CB, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.where(svalid, srows.clamp(0, rows - 1), 0))

    gkeys = torch.zeros(CB + 1, dtype=torch.int64, device=dev).scatter_(
        0, _dump_index(gid, first, CB), skey)[:CB]
    tend = tpg.cumsum(0)
    tgid = torch.searchsorted(tend, torch.arange(NT, device=dev), right=True)
    tkey = torch.where(tgid < n_groups, gkeys[tgid.clamp(0, CB - 1)], 0)
    tiles = torch.stack([tkey // n_triples, tkey % n_triples], 1)

    rkey = tkey[torch.arange(rows, device=dev) // tc]           # (rows,)
    zero = torch.zeros_like(rkey)
    sched = torch.stack([rkey // n_triples, zero, zero, zero + 1,
                         rkey % n_triples, zero, ], 1)
    vals = torch.cat([m[order], torch.ones_like(m[:, :1])], 1)
    sched = torch.cat([sched, sched[:1]]).index_copy_(
        0, _dump_index(srows, svalid, rows), vals)[:rows]
    return (sched.to(torch.int32), tiles.to(torch.int32), inv, ovf)
