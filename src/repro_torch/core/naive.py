"""Hill et al. [32]-style naive MapReduce FSM — the paper's comparison
baseline (Table III).

Deliberately reproduces the two deficiencies the paper calls out:

  1. **no duplicate elimination** — every generation path of a pattern is
     kept (no min-dfs-code canonicality test), so the candidate space and
     the emitted pattern set blow up exponentially with duplicates that
     a user must unify with their own isomorphism routine afterwards;
  2. **user-specified iteration count** — the loop runs exactly
     ``n_iterations`` regardless of when the frequent set empties.

Support counting still uses OL intersection so the comparison isolates
the algorithmic difference (candidate-space discipline), not data-plane
implementation details.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .candgen import EdgeAlphabet, Extension
from .dfscode import Code, code_to_graph, min_dfs_code, rightmost_path
from .graphdb import Graph
from .host_miner import (OccurrenceList, extend_ol, frequent_edges,
                         _single_edge_patterns)

__all__ = ["NaiveResult", "mine_naive"]


@dataclasses.dataclass
class NaiveResult:
    per_level_emitted: list[int]        # patterns emitted (with duplicates)
    per_level_candidates: list[int]     # candidates evaluated
    distinct_frequent: int              # after post-hoc unification
    duplicate_ratio: float              # emitted / distinct


@dataclasses.dataclass
class _Pat:
    code: Code          # generation-path code (NOT canonical)
    ol: OccurrenceList


def _all_extensions(code: Code, alphabet: EdgeAlphabet):
    """Every rightmost-path extension — *without* the canonicality test."""
    g = code_to_graph(code)
    rmp = rightmost_path(code)
    rmv = rmp[-1]
    vl = g.vlabels
    existing = {(min(int(u), int(v)), max(int(u), int(v))) for (u, v) in g.edges}
    out = []
    for w in rmp[:-1]:
        if (min(rmv, w), max(rmv, w)) in existing:
            continue
        for (e_lab, other) in alphabet.partners(int(vl[rmv])):
            if other == int(vl[w]):
                edge = (rmv, w, int(vl[rmv]), e_lab, int(vl[w]))
                out.append((code + (edge,),
                            Extension(False, rmv, w,
                                      (int(vl[rmv]), e_lab, int(vl[w])))))
    for w in rmp:
        for (e_lab, other) in alphabet.partners(int(vl[w])):
            edge = (int(w), g.n_vertices, int(vl[w]), e_lab, other)
            out.append((code + (edge,),
                        Extension(True, int(w), g.n_vertices,
                                  (int(vl[w]), e_lab, other))))
    return out


def mine_naive(graphs: Sequence[Graph], minsup: int,
               n_iterations: int) -> NaiveResult:
    alphabet, eocc = frequent_edges(graphs, minsup)
    f1 = _single_edge_patterns(alphabet, eocc, minsup)
    current = [_Pat(c, info.ol) for c, info in f1.items()]
    emitted = [len(current)]
    candidates = [len(current)]
    all_frequent_codes: list[Code] = [p.code for p in current]

    for _ in range(1, n_iterations):
        nxt: list[_Pat] = []
        n_cands = 0
        for p in current:
            for (child_code, ext) in _all_extensions(p.code, alphabet):
                n_cands += 1

                class _C:  # adapter for extend_ol's Candidate duck-type
                    pass
                c = _C()
                c.ext = ext
                col = extend_ol(p.ol, c, eocc)
                if len(col) >= minsup:
                    nxt.append(_Pat(child_code, col))
        candidates.append(n_cands)
        emitted.append(len(nxt))
        all_frequent_codes.extend(p.code for p in nxt)
        current = nxt
        if not current:
            break

    distinct = len({min_dfs_code(code_to_graph(c)) for c in all_frequent_codes})
    total = len(all_frequent_codes)
    return NaiveResult(emitted, candidates, distinct,
                       total / max(distinct, 1))
