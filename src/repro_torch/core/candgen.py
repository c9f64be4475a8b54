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

This is the host half of ``repro.core.candgen``; the device generator
and device schedule of the whole-run loop are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from .dfscode import Code, Edge5, code_to_graph, is_canonical, rightmost_path

__all__ = ["Extension", "Candidate", "EdgeAlphabet", "generate_candidates",
           "filter_speculative", "CandidateSchedule", "schedule_candidates",
           "pad_schedule"]


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
