"""Sequential baseline FSM algorithm (paper Fig. 3) — exact, host-side.

This is the in-memory algorithm MIRAGE distributes: breadth-first
candidate-generation-and-test with occurrence-list (OL) based support
counting (paper §IV-A.3).  It serves three roles here:

  1. the *baseline* the paper adapts (its Fig. 3), runnable as-is;
  2. the correctness oracle for the distributed engine and the kernels
     (exact, uncapped OLs, pure Python/numpy);
  3. the per-partition "local FSM" semantics reference: running it on a
     partition with ``minsup=1``-style non-zero-support retention yields
     exactly what a MIRAGE mapper chain would emit locally.

Patterns are keyed by min-dfs-code; OLs store *all* embeddings
(vertex-id tuples ordered by DFS id) per database graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .candgen import Candidate, EdgeAlphabet, generate_candidates
from .dfscode import Code
from .graphdb import Graph

__all__ = ["OccurrenceList", "PatternInfo", "MiningResult", "mine_host",
           "edge_occurrences", "frequent_edges"]


# OL: graph index -> list of embeddings; an embedding is a tuple of graph
# vertex ids, position = pattern DFS id.
OccurrenceList = dict[int, list[tuple[int, ...]]]


@dataclasses.dataclass
class PatternInfo:
    code: Code
    ol: OccurrenceList
    support: int


@dataclasses.dataclass
class MiningResult:
    frequent: dict[Code, PatternInfo]          # all levels merged
    levels: list[list[Code]]                   # frequent codes per level
    alphabet: EdgeAlphabet
    n_candidates: list[int]                    # per level, post-canonical
    n_raw_candidates: list[int] = dataclasses.field(default_factory=list)

    @property
    def codes(self) -> set[Code]:
        return set(self.frequent)


def edge_occurrences(graphs: Sequence[Graph]) -> dict[tuple[int, int, int], OccurrenceList]:
    """Directed edge occurrence lists per label triple (the partition-static
    *edge-OL* of paper Fig. 12b).  Triple (a, e, b) maps to (u, v) pairs
    with label(u)=a, elabel=e, label(v)=b — both orientations stored."""
    out: dict[tuple[int, int, int], OccurrenceList] = {}
    for gi, g in enumerate(graphs):
        for (u, v), el in zip(g.edges, g.elabels):
            lu, lv = int(g.vlabels[u]), int(g.vlabels[v])
            for (a, la, b, lb) in ((int(u), lu, int(v), lv),
                                   (int(v), lv, int(u), lu)):
                ol = out.setdefault((la, int(el), lb), {})
                ol.setdefault(gi, []).append((a, b))
    return out


def frequent_edges(
    graphs: Sequence[Graph], minsup: int
) -> tuple[EdgeAlphabet, dict[tuple[int, int, int], OccurrenceList]]:
    """F_1 in label-triple form + its occurrence lists (canonical a<=b)."""
    eocc = edge_occurrences(graphs)
    keep = []
    for (a, e, b), ol in eocc.items():
        if a <= b and len(ol) >= minsup:
            keep.append((a, e, b))
    alpha = EdgeAlphabet(keep)
    return alpha, {t: ol for t, ol in eocc.items()
                   if (min(t[0], t[2]), t[1], max(t[0], t[2])) in
                   {k for k in keep} | {(k[2], k[1], k[0]) for k in keep}}


def _single_edge_patterns(
    alphabet: EdgeAlphabet,
    eocc: dict[tuple[int, int, int], OccurrenceList],
    minsup: int,
) -> dict[Code, PatternInfo]:
    """F_1 as patterns: code ((0,1,a,e,b)) with a<=b; OL from edge-OL.

    For a == b both orientations of an occurrence are distinct embeddings.
    """
    out: dict[Code, PatternInfo] = {}
    for (a, e, b) in alphabet.canonical():
        code: Code = ((0, 1, a, e, b),)
        ol: OccurrenceList = {}
        for gi, occs in eocc.get((a, e, b), {}).items():
            ol[gi] = [tuple(p) for p in occs]
        sup = len(ol)
        if sup >= minsup:
            out[code] = PatternInfo(code, ol, sup)
    return out


def extend_ol(parent_ol: OccurrenceList, cand: Candidate,
              eocc: dict[tuple[int, int, int], OccurrenceList],
              max_embeddings: Optional[int] = None) -> OccurrenceList:
    """Child OL by parent-OL ⋈ edge-OL intersection (paper Fig. 6).

    This host routine is the semantic spec for the Pallas
    ``embedding_join`` kernel.
    """
    ext = cand.ext
    edge_ol = eocc.get(ext.triple, {})
    child: OccurrenceList = {}
    for gi, embs in parent_ol.items():
        occs = edge_ol.get(gi)
        if not occs:
            continue
        acc: list[tuple[int, ...]] = []
        for emb in embs:
            su = emb[ext.stub]
            if ext.forward:
                for (u, v) in occs:
                    if u == su and v not in emb:
                        acc.append(emb + (v,))
            else:
                tv = emb[ext.to]
                for (u, v) in occs:
                    if u == su and v == tv:
                        acc.append(emb)
                        break
        if acc:
            if max_embeddings is not None:
                acc = acc[:max_embeddings]
            child[gi] = acc
    return child


def mine_host(
    graphs: Sequence[Graph],
    minsup: int,
    *,
    max_size: Optional[int] = None,
) -> MiningResult:
    """The paper's Fig. 3 algorithm, exactly."""
    alphabet, eocc = frequent_edges(graphs, minsup)
    f1 = _single_edge_patterns(alphabet, eocc, minsup)
    frequent: dict[Code, PatternInfo] = dict(f1)
    levels: list[list[Code]] = [sorted(f1)]
    n_candidates: list[int] = [len(f1)]
    n_raw: list[int] = [len(f1)]

    current = {c: f1[c] for c in levels[0]}
    k = 1
    while current and (max_size is None or k < max_size):
        codes = sorted(current)
        cands = generate_candidates(codes, alphabet)
        n_candidates.append(len(cands))
        nxt: dict[Code, PatternInfo] = {}
        for cand in cands:
            parent = current[codes[cand.parent]]
            col = extend_ol(parent.ol, cand, eocc)
            sup = len(col)
            if sup >= minsup:
                nxt[cand.code] = PatternInfo(cand.code, col, sup)
        if not nxt:
            break
        levels.append(sorted(nxt))
        frequent.update(nxt)
        current = nxt
        k += 1
    return MiningResult(frequent, levels, alphabet, n_candidates, n_raw)
