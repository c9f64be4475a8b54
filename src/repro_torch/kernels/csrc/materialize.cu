// Pass 2 of one MIRAGE level for Hopper (sm_90a): the child occurrence
// lists of the S compact survivor slots, one launch a level.
//
// Replaces no Pallas kernel: the JAX package materializes with XLA
// (src/repro/core/embedding.py materialize_one, under a lax.cond that
// skips the slots past the survivor count).  The port ran it as an eager
// chain of ~30 PyTorch ops per slot over the whole (PP, G, M·F) join, two
// int32 scans each, for every one of the S slots, since the host learns
// the survivor count only from the level's wire.  This kernel computes
// the same function (repro_torch.core.embedding.materialize_one, bit for
// bit) for all S slots at once and reads the survivor count on the
// device.
//
// Inputs (row-major, int64 offsets everywhere: a child store passes 2^31
// elements at the main runs' shapes):
//   cmeta (S, 5) int32  [parent, stub, to, fwd, triple] per compact slot
//   n_keep ()    int32  survivor count; slots at or past it are dead
//   pol   (PP, P, G, M, K) int32, PAD -1     pmask (PP, P, G, M) uint8/bool
//   src, dst (PP, T, G, F) int32             emask (PP, T, G, F) uint8/bool
// Outputs, every element written here:
//   ol    (PP, S, G, Mc, W) int32   mask (PP, S, G, Mc) uint8/bool
// and over (S,) int32, zeroed by the caller: Σ over (partition, graph) of
// max(0, joined − Mc), added with one integer atomic per (slot,
// partition, graph) that overflows.
//
// Semantics, per (slot, partition, graph): the join of join.cuh
// (slot_value, pair_joins: pmask[m], emask[f], src[f] == pol[m][stub]
// and, forward, dst[f] none of the K slots, else dst[f] == pol[m][to]; a
// stub or to outside [0, K) reads 0), the (m, f) pairs in row-major
// order; a backward edge keeps only the first f of each m.  The first Mc
// kept pairs become rows 0.. of the child: the parent's K slots, PAD up
// to W, and, for a forward edge with 0 <= to < W, dst[f] at slot to.
// Rows past the kept count are PAD with a false mask.  A dead slot, and a
// row outside the stores (a memory guard: the callers check their rows
// on the host), is all PAD with a false mask and no overflow.
//
// What bounds it on the H100: the bytes.  It must write the whole child
// store, PP·S·G·Mc·(4W + 1) bytes (the dead slots' PAD included, which
// the caller would otherwise fill), and read, for each live slot, its
// parent's pmask row and its triple's emask row for every (partition,
// graph), PP·G·(M + F) bytes, plus the K slots of each set embedding and
// src/dst of each set occurrence inside the spans; its compares are a few
// per (m, f) pair inside the spans, far below the card's 32-bit rate.
// At 3.35 TB/s the store dominates: level 3 of the 40K main run (PP 8,
// S 256, G 5,000, Mc 64, K = W = 8 under bucketing) writes 21.6 GB, 6.5
// ms.
//
// The design:
//   * grid (ceil(G / kRows), S, PP), kRows = 8 warps a CTA, one warp per
//     (slot, partition, graph): PP 8 × G 5,000 and PP 32 × G 1,250 give
//     the same number of warps a slot;
//   * a dead slot does no join: its CTA fills the contiguous stretch of
//     its kRows graphs' rows (kRows·Mc·W words, kRows·Mc mask bytes) with
//     16-byte stores, all 256 threads;
//   * a live warp takes the spans of its parent's pmask row and its
//     triple's emask row (last set index + 1, a warp max; the stores fill
//     each row from slot 0, and the spans stay exact on masks with holes
//     since each pair still tests both mask bits), then walks the ps·ts
//     pairs inside them 32 at a time in row-major (m, f) order: the
//     kept pairs' ranks come from a ballot and a popcount, so the
//     compaction needs no scan of the (M·F) join in memory; backward
//     first-f is the ballot of the valid lanes compared with the m of
//     the valid lane before (carried across chunks);
//   * each kept pair under the cap is written by its lane (its row is
//     4W contiguous bytes; consecutive ranks are consecutive rows), the
//     rest of the graph's Mc rows by the warp, then its Mc mask bytes.
#include <cstdint>
#include <cuda_runtime.h>

#include "join.cuh"

namespace {

constexpr int kRows = 8;           // graphs per CTA, one per warp
constexpr int32_t kPad = -1;

struct MatOut {
  const int32_t* cmeta;
  const int32_t* n_keep;
  int32_t* ol;
  uint8_t* mask;
  int32_t* over;
  int S, Mc, W;
};

// n 32-bit words at p set to v by threads t of nt, 16-byte stores where
// aligned.
__device__ void fill_words(int32_t* p, int64_t n, int32_t v, int t, int nt) {
  int64_t head = (int64_t)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) &
                            15) >> 2);
  head = head < n ? head : n;
  const int64_t nvec = (n - head) >> 2;
  for (int64_t i = t; i < head; i += nt) p[i] = v;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int4 v4 = make_int4(v, v, v, v);
  for (int64_t i = t; i < nvec; i += nt) q[i] = v4;
  for (int64_t i = head + 4 * nvec + t; i < n; i += nt) p[i] = v;
}

// n bytes at p set to zero by threads t of nt, 16-byte stores where
// aligned.
__device__ void zero_bytes(uint8_t* p, int64_t n, int t, int nt) {
  int64_t head = (int64_t)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  head = head < n ? head : n;
  const int64_t nvec = (n - head) >> 4;
  for (int64_t i = t; i < head; i += nt) p[i] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = t; i < nvec; i += nt) q[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = head + 16 * nvec + t; i < n; i += nt) p[i] = 0;
}

// Last set index + 1 of the n-byte mask row p, over the warp.
__device__ __forceinline__ int warp_span(const uint8_t* p, int n, int lane) {
  unsigned last = 0u;
  for (int i = lane; i < n; i += 32) {
    if (p[i]) last = (unsigned)i + 1u;
  }
  return (int)__reduce_max_sync(0xffffffffu, last);
}

__global__ void materialize_level_kernel(Stores S, MatOut O) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int s = blockIdx.y, pp = blockIdx.z;
  const int g0 = blockIdx.x * kRows;
  const int ng = min(kRows, S.G - g0);
  const int64_t rw = (int64_t)O.Mc * O.W;          // words a graph
  const int64_t slab = ((int64_t)pp * O.S + s) * S.G + g0;   // (pp,s,g0)
  if (s >= *O.n_keep) {                             // a dead slot: PAD
    fill_words(O.ol + slab * rw, ng * rw, kPad, t, blockDim.x);
    zero_bytes(O.mask + slab * O.Mc, (int64_t)ng * O.Mc, t, blockDim.x);
    return;
  }
  if (warp >= ng) return;
  const int g = g0 + warp;
  int32_t* out = O.ol + (slab + warp) * rw;
  uint8_t* mout = O.mask + (slab + warp) * O.Mc;

  const int32_t* row = O.cmeta + (int64_t)s * 5;
  const int parent = row[0], stub = row[1], to = row[2];
  const int fwd = row[3] != 0 ? 1 : 0, triple = row[4];
  const bool inside = parent >= 0 && parent < S.P && triple >= 0 &&
                      triple < S.T;
  int cnt = 0;                                      // kept pairs
  if (inside) {
    const int64_t pg = ((int64_t)pp * S.P + parent) * S.G + g;
    const int64_t eg = ((int64_t)pp * S.T + triple) * S.G + g;
    const uint8_t* pm = S.pmask + pg * S.M;
    const uint8_t* em = S.emask + eg * S.F;
    const int32_t* emb0 = S.pol + pg * S.M * S.K;
    const int32_t* src = S.src + eg * S.F;
    const int32_t* dst = S.dst + eg * S.F;
    const int ps = warp_span(pm, S.M, lane);
    const int ts = warp_span(em, S.F, lane);
    const int total = ps * ts;
    const unsigned lt = (1u << lane) - 1u;
    int last_m = -1;               // m of the last valid pair (backward)
    for (int base = 0; base < total; base += 32) {
      const int i = base + lane;
      const int m = i / ts, f = i - m * ts;
      const int32_t* emb = emb0 + (int64_t)m * S.K;
      const bool valid =
          i < total && pm[m] && em[f] &&
          pair_joins(emb, S.K, slot_value(emb, stub, S.K),
                     slot_value(emb, to, S.K), fwd, src[f], dst + f);
      const unsigned vb = __ballot_sync(0xffffffffu, valid);
      bool keep = valid;
      if (!fwd) {                  // only the first f of each m
        const unsigned prior = vb & lt;
        const int pm_l = __shfl_sync(0xffffffffu, m,
                                     prior ? 31 - __clz(prior) : lane);
        keep = valid && (prior ? pm_l : last_m) != m;
        if (vb) last_m = __shfl_sync(0xffffffffu, m, 31 - __clz(vb));
      }
      const unsigned kb = __ballot_sync(0xffffffffu, keep);
      const int r = cnt + __popc(kb & lt);
      if (keep && r < O.Mc) {
        int32_t* o = out + (int64_t)r * O.W;
        const int32_t nv = dst[f];
        for (int k = 0; k < O.W; ++k) {
          const int32_t v = k < S.K ? emb[k] : kPad;
          o[k] = (fwd && k == to) ? nv : v;
        }
      }
      cnt += __popc(kb);
    }
  }
  const int n = cnt < O.Mc ? cnt : O.Mc;
  fill_words(out + (int64_t)n * O.W, (int64_t)(O.Mc - n) * O.W, kPad, lane,
             32);
  for (int r = lane; r < O.Mc; r += 32) mout[r] = r < n;
  if (lane == 0 && cnt > O.Mc) atomicAdd(O.over + s, cnt - O.Mc);
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int materialize_level_launch(
    const void* cmeta, const void* n_keep, const void* pol, const void* pmask,
    const void* src, const void* dst, const void* emask, void* ol,
    void* mask, void* over, int PP, int P, int G, int M, int K, int T, int F,
    int S, int Mc, int W, void* stream) {
  materialize_level_kernel<<<dim3((G + kRows - 1) / kRows, S, PP),
                             kRows * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      Stores{static_cast<const int32_t*>(pol),
             static_cast<const uint8_t*>(pmask),
             static_cast<const int32_t*>(src),
             static_cast<const int32_t*>(dst),
             static_cast<const uint8_t*>(emask), PP, P, G, M, K, T, F},
      MatOut{static_cast<const int32_t*>(cmeta),
             static_cast<const int32_t*>(n_keep),
             static_cast<int32_t*>(ol), static_cast<uint8_t*>(mask),
             static_cast<int32_t*>(over), S, Mc, W});
  return (int)cudaGetLastError();
}
