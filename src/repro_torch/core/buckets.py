"""Shape bucketing for the level program (DESIGN.md §9).

The candidate count C, survivor cap S, parent store width P, embedding
cap M, vertex-slot width K and the fused schedule's row count change
between levels.  The JAX package rounds each of them UP to a small
geometric family — ``floor · 2^i`` — so consecutive levels present
identical shapes to ``jax.jit``.  PyTorch runs eagerly and compiles
nothing per shape, but the port keeps the same families: the padded
candidate count Cp fixes the length of the level wire, which must match
the JAX package word for word, and repeating store shapes let the
caching allocator hand the child store the blocks the parent store
just released.

Masking contract (who neutralizes which padded slots):

  C / Cp  padded candidate rows — excluded by the wire's ``real`` mask
          (verdicts, survivor compaction, cost signal) and sliced off by
          ``unpack_wire``; the fused schedule marks them ``valid=0`` so
          they contribute zero support.
  S       padded survivor slots — ``valid_s`` cond-gates pass-2 into a
          constant fill; their masks are all-False downstream.
  P       padded parent slots — never referenced (candidate ``parent``
          indices only address real patterns); masks all-False.
  M       padded embedding rows — mask=False, PAD(-1) vertex entries.
  K       padded vertex slots — PAD(-1); the join's stub/to one-hots
          never select them and the forward-membership test cannot
          match them (real vertex ids are >= 0).
"""
from __future__ import annotations

import dataclasses

__all__ = ["BucketSpec", "bucket_size", "round_up_multiple"]


def bucket_size(x: int, floor: int) -> int:
    """Smallest member of the geometric family {floor · 2^i} >= x."""
    if floor < 1:
        raise ValueError(f"bucket floor must be >= 1, got {floor}")
    n = floor
    while n < x:
        n *= 2
    return n


def round_up_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The per-run bucket family (from ``MirageConfig``).

    ``c_floor`` governs the padded candidate axis Cp (and the fused
    schedule's row bucket), ``s_floor`` the survivor cap S and the
    parent-store pattern axis P, ``k_floor`` the OL vertex-slot axis.
    The embedding axis M needs no floor of its own: its family is
    anchored at the (power-of-two) ``max_embeddings`` cap, which the
    escalation valve already walks by doubling.
    """

    c_floor: int = 64
    s_floor: int = 32
    k_floor: int = 8

    def candidates(self, c: int, n_workers: int) -> int:
        """Cp: bucket, then keep the divisibility contract Cp % W == 0
        (a no-op for power-of-two W) that both the reduce_scatter
        shuffle (tiled psum_scatter) and the SHARDED level wire — each
        worker packs exactly a Cp/W support slice, DESIGN.md §11 —
        rely on."""
        return round_up_multiple(bucket_size(c, self.c_floor), n_workers)

    def survivors(self, s: int, ceiling: int) -> int:
        """S (and the parent axis P): bucket, clamp at the (already
        bucketed) Cp ceiling so a cap miss retries into the NEXT family
        member instead of thrashing between adjacent predictions."""
        return min(ceiling, bucket_size(s, self.s_floor))

    def vertex_slots(self, k: int, parent_k: int | None = None) -> int:
        """K: reuse the parent store's (bucketed) width while the child
        pattern still fits — the store only grows at family boundaries,
        so consecutive levels alias the same arena shape."""
        if parent_k is not None and k <= parent_k:
            return parent_k
        return bucket_size(k, self.k_floor)

    def embeddings(self, m: int, anchor: int) -> int:
        """M family anchored at the configured cap (level-1 stores may
        need more than the cap to stay exact: M1 >= F)."""
        return bucket_size(m, bucket_size(anchor, 1))
