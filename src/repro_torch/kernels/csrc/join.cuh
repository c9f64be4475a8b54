// The join of MIRAGE candidate rows with the occurrence-list stores,
// shared by every kernel that joins a parent occurrence list with an
// edge occurrence list: fused_level.cu (fused_level_packed_kernel,
// fused_level_kernel) and two_launch.cu (embedding_join_kernel).  The
// three kernels run one row walk (walk_rows) and one pair predicate
// (pair_joins), so they cannot drift apart; they differ only in where a
// row comes from and what it writes.
//
// Replaces the join of the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/fused_level.py   _joined_blocks
//   src/repro/kernels/embedding_join.py _join_kernel
// Semantics (repro.core.embedding.join_valid): parent embedding m joins
// edge occurrence f iff pmask[m] and emask[f] and src[f] == pol[m][stub]
// and, for a forward edge (fwd == 1), dst[f] is none of the parent's K
// vertex slots, else (backward) dst[f] == pol[m][to].
//
// The walk is built for what the inputs are: the stores fill every
// (parent, graph) and (triple, graph) row from slot 0, a few of M =
// 32..128 or F = 26..34 slots are set at the main runs' shapes, a few
// dozen parents and triples are shared by hundreds of rows, and the join
// work of one graph ranges from nothing to hundreds of (m, f) pairs.
//   * graph-chunk-major grid: one CTA owns kChunk = 32 consecutive
//     graphs of one partition (lane i <-> graph g0 + i) and walks every
//     row, so each mask row a launch needs is read once per CTA;
//   * count first: the CTA computes the span (last set index + 1) of the
//     emask row of every (triple, graph) once, into a shared table, from
//     coalesced 16-byte loads of the contiguous (32, F) mask slabs, when
//     the table of all T triples fits in shared memory (T up to 1,791);
//     past that, each warp computes the spans of its current triple when
//     the triple changes, as it does for the pmask rows of its current
//     parent when the parent changes (rows come parent-major, so parents
//     change rarely; any order stays correct);
//   * the warps take rows one at a time from a shared counter and never
//     wait for each other: a heavy row holds up only its own warp;
//   * join only inside the spans, with a row's work dealt out evenly
//     over the lanes: the row's (graph, m, f) slots inside both spans are
//     numbered (a warp scan of ps*ts over the 32 graphs) and lane i takes
//     slots i, i+32, ..., so a graph with many embeddings does not hold
//     up the other 31 lanes.  The lane reads pol, src and dst straight
//     from device memory (L1/L2) and tests both mask bits, so a mask with
//     holes stays exact.  A lane's slots visit the graphs in order, so
//     it adds its joined pairs of one graph into the warp's per-graph
//     count in shared memory once, when it moves on to the next graph;
//   * every row the source does not skip is handed to its emit with the
//     count of the lane's graph, zero when the row was not joined (a
//     padding row, a row outside the stores, a row with no slot inside
//     the spans), so every output it owns is written.
#pragma once

#include <cstdint>

namespace {

constexpr int kChunk = 32;         // graphs per CTA, one per lane of a warp

// The parent OL stack (PP, P, G, M, K) with its mask (PP, P, G, M) and
// the edge OL stack (PP, T, G, F) (src, dst, emask), row-major.
struct Stores {
  const int32_t* pol;
  const uint8_t* pmask;
  const int32_t* src;
  const int32_t* dst;
  const uint8_t* emask;
  int PP, P, G, M, K, T, F;
};

constexpr int kWarpWords = 3 * kChunk;   // per warp, beside the table

// Does `smem`, the dynamic shared bytes the wrapper gives a CTA of
// `threads` threads (kernels/build.py join_geometry), hold the span
// table of all T triples?  Else each warp keeps its triple's spans.  The
// launcher picks walk_rows<true> or walk_rows<false> by it.
inline bool span_table(int T, int threads, int smem) {
  return (int64_t)T * kChunk * 4 + (int64_t)(threads / 32) * kWarpWords * 4
         <= smem;
}

// One candidate row as the walk joins it.
struct JoinRow {
  int parent, triple, stub, to, fwd;
};

// What a row source says of a row: nothing to do (another row writes its
// outputs), write zeros, or join.
enum RowKind { kSkip, kZero, kJoin };

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

// Raise span[i / W] to i % W + 1 for every set byte i of the n-byte slab
// `p` (the W-byte mask rows of consecutive graphs), with `nt` threads
// (this one is `t`) taking 16-byte loads where the slab is aligned.
__device__ void slab_spans(const uint8_t* p, int n, int W, uint32_t* span,
                           int t, int nt) {
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  head = head < n ? head : n;
  const int nvec = (n - head) >> 4;
  for (int i = t; i < head; i += nt) {
    if (p[i]) atomicMax(span + i / W, (uint32_t)(i % W) + 1u);
  }
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int j = t; j < nvec; j += nt) {
    const uint4 x = v[j];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    for (int q = 0; q < 4; ++q) {
      for (int b = 0; b < 4 && (w[q] >> (8 * b)); ++b) {
        if ((w[q] >> (8 * b)) & 0xffu) {
          const int i = head + 16 * j + 4 * q + b;
          atomicMax(span + i / W, (uint32_t)(i % W) + 1u);
        }
      }
    }
  }
  for (int i = head + 16 * nvec + t; i < n; i += nt) {
    if (p[i]) atomicMax(span + i / W, (uint32_t)(i % W) + 1u);
  }
}

// The walk of one CTA of the (ceil(G / 32) or more, PP) grid over rows
// [0, n_rows).  `rows` is the row source and sink:
//   RowKind take(int r, JoinRow& j)  what to do with row r (uniform over
//                                     the warp; fills j for kJoin);
//   void emit(int r, uint32_t cnt)   warp-collective; cnt is the lane's
//                                     graph's joined pairs (0 past G and
//                                     for rows not joined).
// Dynamic shared memory (kernels/build.py join_geometry): with the table
// (kTable), the triple spans [T][kChunk] (uint32), then per warp the
// spans of its current parent, the inclusive ends of its graphs' slot
// ranges and its graphs' joined pairs, [kChunk] 32-bit words each;
// without it, per warp those three and the spans of its current triple.
template <bool kTable, class Rows>
__device__ void walk_rows(const Stores& S, const Rows& rows, int n_rows) {
  extern __shared__ uint32_t smem_words[];
  static __shared__ int s_next;       // next row to hand out
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int NW = blockDim.x >> 5;
  uint32_t* s_tspan = smem_words;
  uint32_t* s_pspan = kTable ? s_tspan + S.T * kChunk + warp * kWarpWords
                              : smem_words + warp * (kWarpWords + kChunk);
  int32_t* s_end = reinterpret_cast<int32_t*>(s_pspan + kChunk);
  uint32_t* s_cnt = s_pspan + 2 * kChunk;
  uint32_t* s_wtspan = s_pspan + 3 * kChunk;      // no table: the triple's
  const int pp = blockIdx.y, g0 = blockIdx.x * kChunk;
  const int ng = max(0, min(kChunk, S.G - g0));   // 0: a chunk past G

  if (kTable) {
    for (int i = t; i < S.T * kChunk; i += blockDim.x) s_tspan[i] = 0u;
  }
  s_cnt[lane] = 0u;
  if (t == 0) s_next = 0;
  __syncthreads();
  for (int tr = warp; kTable && ng && tr < S.T; tr += NW) {  // warp/slab
    slab_spans(S.emask + (((int64_t)pp * S.T + tr) * S.G + g0) * S.F,
               ng * S.F, S.F, s_tspan + tr * kChunk, lane, 32);
  }
  __syncthreads();

  int parent = -1, ps = 0, triple = -1;
  int64_t pg0 = 0;
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(&s_next, 1);
    r = __shfl_sync(0xffffffffu, r, 0);
    if (r >= n_rows) break;
    JoinRow j;
    const RowKind kind = rows.take(r, j);
    if (kind == kSkip) continue;
    bool joined = false;
    if (kind == kJoin) {
      if (j.parent != parent) {       // this warp's parent spans
        parent = j.parent;
        pg0 = ((int64_t)pp * S.P + parent) * S.G + g0;
        s_pspan[lane] = 0u;
        __syncwarp();
        slab_spans(S.pmask + pg0 * S.M, ng * S.M, S.M, s_pspan, lane, 32);
        __syncwarp();
        ps = (int)s_pspan[lane];
      }
      const uint32_t* ts = s_wtspan;
      if (kTable) {
        ts = s_tspan + j.triple * kChunk;
      } else if (j.triple != triple) {  // this warp's triple spans
        triple = j.triple;
        s_wtspan[lane] = 0u;
        __syncwarp();
        slab_spans(S.emask + (((int64_t)pp * S.T + triple) * S.G + g0) * S.F,
                   ng * S.F, S.F, s_wtspan, lane, 32);
        __syncwarp();
      }
      int end_g = ps * (int)ts[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, end_g, d);
        if (lane >= d) end_g += n;
      }
      const int total = __shfl_sync(0xffffffffu, end_g, 31);
      if (total) {
        s_end[lane] = end_g;
        __syncwarp();
        const int64_t eg0 =
            (((int64_t)pp * S.T + j.triple) * S.G + g0) * S.F;
        uint32_t c = 0u;
        int g = 0, gc = 0;
        for (int i = lane; i < total; i += 32) {
          while (s_end[g] <= i) ++g;
          if (g != gc) {              // the lane moves on to graph g
            if (c) atomicAdd(s_cnt + gc, c);
            c = 0u;
            gc = g;
          }
          const int local = i - (g ? s_end[g - 1] : 0);
          const int tsg = (int)ts[g];
          const int m = local / tsg, f = local - m * tsg;
          const int64_t pm = (pg0 + g) * S.M + m;
          const int64_t e = eg0 + (int64_t)g * S.F + f;
          const int32_t* embp = S.pol + pm * S.K;
          c += S.pmask[pm] && S.emask[e] &&
               pair_joins(embp, S.K, slot_value(embp, j.stub, S.K),
                          slot_value(embp, j.to, S.K), j.fwd, S.src[e],
                          S.dst + e);
        }
        if (c) atomicAdd(s_cnt + gc, c);
        __syncwarp();
        joined = true;
      }
    }
    uint32_t cnt = 0u;
    if (joined) {
      cnt = s_cnt[lane];
      s_cnt[lane] = 0u;
    }
    rows.emit(r, cnt);
    __syncwarp();                     // s_end, s_cnt serve the next row
  }
}

}  // namespace
