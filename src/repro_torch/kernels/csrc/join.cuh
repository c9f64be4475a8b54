// The join of one MIRAGE candidate in one graph, shared by every kernel
// that joins a parent occurrence list with an edge occurrence list:
// fused_level.cu (fused_level_packed_kernel, fused_level_kernel) and
// two_launch.cu (embedding_join_kernel).  The (m, f) test is one device
// function, pair_joins, so the three joins cannot drift apart.
//
// Replaces the join of the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/fused_level.py   _joined_blocks
//   src/repro/kernels/embedding_join.py _join_kernel
// Semantics (repro.core.embedding.join_valid): parent embedding m joins
// edge occurrence f iff pmask[m] and emask[f] and src[f] == pol[m][stub]
// and, for a forward edge (fwd == 1), dst[f] is none of the parent's K
// vertex slots, else (backward) dst[f] == pol[m][to].
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ int32_t slot_value(const int32_t* emb, int slot,
                                              int K) {
  // the JAX join takes pol[stub] as a one-hot sum: 0 when out of range
  return (slot >= 0 && slot < K) ? emb[slot] : 0;
}

// The pair predicate: does parent embedding `emb` (K vertex slots, with
// sv = its stub value and tv = its `to` value) join the set edge
// occurrence (s, *d)?  `d` is read only once the source matched.
__device__ __forceinline__ bool pair_joins(const int32_t* emb, int K,
                                           int32_t sv, int32_t tv, int fwd,
                                           int32_t s, const int32_t* d) {
  if (s != sv) return false;
  const int32_t v = *d;
  if (fwd == 1) {              // new endpoint must not be a parent vertex
    for (int k = 0; k < K; ++k) {
      if (emb[k] == v) return false;
    }
    return true;
  }
  return v == tv;              // other endpoint must be embedding[to]
}

// Number of joined (m, f) pairs of one candidate row in one graph, over
// the first M parent embeddings and the first F edge occurrences.
// pol_g/pm_g: the graph's parent OL rows (M x K) and mask; s_* : the
// graph's edge-OL row, element f at s_*[f * stride] (a staged shared
// memory column, or the row in device memory with stride 1).
__device__ int join_row(const int32_t* pol_g, const uint8_t* pm_g,
                        const int32_t* s_src, const int32_t* s_dst,
                        const uint8_t* s_em, int stride, int M, int K,
                        int F, int stub, int to, int fwd) {
  int count = 0;
  for (int m = 0; m < M; ++m) {
    if (!pm_g[m]) continue;
    const int32_t* emb = pol_g + (int64_t)m * K;
    const int32_t sv = slot_value(emb, stub, K);
    const int32_t tv = slot_value(emb, to, K);
    for (int f = 0; f < F; ++f) {
      const int i = f * stride;
      if (!s_em[i]) continue;
      count += pair_joins(emb, K, sv, tv, fwd, s_src[i], s_dst + i);
    }
  }
  return count;
}

}  // namespace
