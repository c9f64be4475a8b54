// Fused single-launch map phase of one MIRAGE level (join + support) for
// Hopper (sm_90a): a dense kernel and a bit-packed kernel that share one
// pair predicate (join.cuh), so the two cannot diverge.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   fused_level_packed_kernel  <- src/repro/kernels/fused_level.py
//                                 fused_level_packed_pallas / _fused_packed_kernel
//   fused_level_kernel         <- src/repro/kernels/fused_level.py
//                                 fused_level_pallas / _fused_kernel
//   pair_joins (join.cuh)      <- src/repro/kernels/fused_level.py _joined_blocks
//
// Inputs (row-major, int64 offsets everywhere: a child OL store passes
// 2^31 elements at the main run's shapes):
//   meta  (Cs, 6) int32  [parent, stub, to, fwd, triple, valid]
//   tiles (NT, 2) int32  [parent, triple] shared by the TC rows of a tile
//   pol   (PP, P, G, M, K) int32, PAD -1     pmask (PP, P, G, M) uint8/bool
//   src, dst (PP, T, G, F) int32             emask (PP, T, G, F) uint8/bool
//   gmask (Gw,) uint32 valid-graph bit lanes (packed only)
// Outputs: sup, emb (PP, Cs) int32, zeroed by the caller and accumulated
// with atomicAdd; vbits (PP, Cs, Gw) uint32, every word written here.
//
// What bounds them on the H100: the least time of a call is set by the
// bytes its data needs moved (the masks of the parent and triple rows its
// valid tiles reference, the K slots of every set embedding, src/dst of
// every set occurrence, the outputs); the (m, f) compares it needs take
// far less at the card's 32-bit rate.  chip_smoke.py computes that bound
// for each call from its inputs.
//
// fused_level_packed_kernel (B1; not yet redesigned) runs well above it:
// every thread reads its own graph's parent and edge rows, so a warp's
// loads are 32 scattered rows, and every tile re-reads its parent rows.
//   * one thread owns one graph, one warp owns 32 consecutive graphs, so
//     __ballot_sync of the per-graph any-match flags IS the LSB-first
//     verdict word of bitset.py (lane i <-> graph 32w+i); & gmask and
//     __popc give the support with no shift-OR pass;
//   * one CTA per (graph chunk, tile, partition) reads its tiles[] row
//     itself (the TPU kernel's scalar prefetch) and loops over the tile's
//     TC candidate rows; the thread's edge-OL row is staged in shared
//     memory column-wise ([f][thread]) without bank conflicts;
//   * each vbits word has one writer, including the all-invalid tiles
//     that skip the join (they write zeros).
//
// fused_level_kernel (B2) is built for what its inputs are: the stores
// fill every (parent, graph) and (triple, graph) row from slot 0, a few
// of M = 32..128 or F = 26..34 slots are set at the main run's shapes,
// tile_c falls to 1, a few dozen triples and parents are shared by
// hundreds of rows, and the join work of one graph ranges from nothing
// to hundreds of (m, f) pairs.  A kernel with one CTA per (graph chunk,
// tile, partition) that stages every edge row in full and scans every
// mask byte spends its time on empty slots.  So:
//   * graph-chunk-major grid: one CTA owns 32 consecutive graphs of one
//     partition (lane i <-> graph g0+i) and walks the whole schedule, so
//     each mask row a launch needs is read once per launch;
//   * count first: the CTA computes the span (last set index + 1) of the
//     emask row of every (triple, graph) once, into shared memory, from
//     coalesced 16-byte loads of the contiguous (32, F) mask slabs; a
//     warp does the same for the pmask rows of its current parent when
//     the parent changes (the schedule is parent-major, so rarely; any
//     order stays correct);
//   * the warps take schedule rows one at a time from a shared counter
//     and never wait for each other: a heavy row holds up only its own
//     warp (a barrier per parent's run of rows let the heaviest row of
//     the run idle the other warps, and cost more than the join);
//   * join only inside the spans, with a row's work dealt out evenly
//     over the lanes: the row's (graph, m, f) slots inside both spans are
//     numbered (a warp scan of ps*ts over the 32 graphs) and lane i takes
//     slots i, i+32, ..., so a graph with many embeddings does not hold
//     up the other 31 lanes.  The lane reads pol, src and dst straight
//     from device memory (L1/L2), tests both mask bits, so a mask with
//     holes stays exact, applies pair_joins, and sets the graph's hit
//     flag in shared memory; a ballot of the flags gives the support;
//   * one atomicAdd to sup and one to emb per (row, CTA), and only when
//     the count is non-zero; integer atomics are exact in any order and
//     wrap mod 2^32 as the JAX int32 sums do.  Rows with valid = 0, and
//     so whole-invalid tiles, cost one read of their valid flag.
#include <cstdint>
#include <cuda_runtime.h>

#include "join.cuh"

namespace {

struct Level {
  const int32_t* meta;
  const int32_t* tiles;
  const int32_t* pol;
  const uint8_t* pmask;
  const int32_t* src;
  const int32_t* dst;
  const uint8_t* emask;
  int PP, P, G, M, K, T, F, NT, TC;
};

__device__ __forceinline__ int tile_valid(const int32_t* rows, int TC) {
  int v = 0;
  for (int i = 0; i < TC; ++i) v |= rows[i * 6 + 5];
  return v;
}

// Stage this thread's edge-OL row of the tile's triple (column t).
__device__ __forceinline__ void stage_edges(const Level& L, int pp,
                                            int triple, int g, int t,
                                            int B, int32_t* s_src,
                                            int32_t* s_dst, uint8_t* s_em) {
  const int64_t base = (((int64_t)pp * L.T + triple) * L.G + g) * L.F;
  for (int f = 0; f < L.F; ++f) {
    s_src[f * B + t] = L.src[base + f];
    s_dst[f * B + t] = L.dst[base + f];
    s_em[f * B + t] = L.emask[base + f];
  }
}

// Per-thread join count of row `row` (0 for graphs past G).
__device__ __forceinline__ int thread_count(const Level& L, int pp,
                                            int parent, int g, int t, int B,
                                            const int32_t* rowm,
                                            const int32_t* s_src,
                                            const int32_t* s_dst,
                                            const uint8_t* s_em) {
  if (g >= L.G) return 0;
  const int64_t pg = ((int64_t)pp * L.P + parent) * L.G + g;
  return join_row(L.pol + pg * L.M * L.K, L.pmask + pg * L.M, s_src + t,
                  s_dst + t, s_em + t, B, L.M, L.K, L.F, rowm[1], rowm[2],
                  rowm[3]);
}

__global__ void fused_level_packed_kernel(Level L, const uint32_t* gmask,
                                          int Gw, int32_t* sup,
                                          int32_t* emb, uint32_t* vbits) {
  extern __shared__ unsigned char smem[];
  const int B = blockDim.x, t = threadIdx.x, lane = t & 31;
  const int pp = blockIdx.z, ct = blockIdx.y;
  const int g = blockIdx.x * B + t;
  const int word = g >> 5;
  const bool writer = lane == 0 && word < Gw;
  const int Cs = L.NT * L.TC;
  const int32_t* rows = L.meta + (int64_t)ct * L.TC * 6;

  if (!tile_valid(rows, L.TC)) {   // bucket padding: no join, zero words
    if (writer) {
      for (int i = 0; i < L.TC; ++i) {
        vbits[((int64_t)pp * Cs + ct * L.TC + i) * Gw + word] = 0u;
      }
    }
    return;
  }
  const int parent = L.tiles[ct * 2], triple = L.tiles[ct * 2 + 1];
  int32_t* s_src = reinterpret_cast<int32_t*>(smem);
  int32_t* s_dst = s_src + L.F * B;
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_dst + L.F * B);
  if (g < L.G) stage_edges(L, pp, triple, g, t, B, s_src, s_dst, s_em);

  for (int i = 0; i < L.TC; ++i) {
    const int32_t* rowm = rows + i * 6;
    const int valid = rowm[5];
    const int c = thread_count(L, pp, parent, g, t, B, rowm, s_src, s_dst,
                               s_em);
    uint32_t bits = __ballot_sync(0xffffffffu, c > 0);
    const int wsum = __reduce_add_sync(0xffffffffu, c);
    if (writer) {
      bits = valid != 0 ? (bits & gmask[word]) : 0u;
      const int64_t row = (int64_t)pp * Cs + ct * L.TC + i;
      vbits[row * Gw + word] = bits;
      atomicAdd(sup + row, __popc(bits));
      atomicAdd(emb + row, wsum * valid);
    }
  }
}

constexpr int kChunk = 32;         // graphs per CTA of the dense kernel

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

// Dynamic shared memory: the triple spans [T][kChunk] (uint32), then per
// warp the spans of its current parent [kChunk] (uint32), the inclusive
// ends of its graphs' slot ranges [kChunk] (int32) and their hit flags
// [kChunk] (uint8).
__global__ void fused_level_kernel(Level L, int32_t* sup, int32_t* emb) {
  extern __shared__ unsigned char smem[];
  __shared__ int s_next;              // next schedule row to hand out
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int NW = blockDim.x >> 5;
  uint32_t* s_tspan = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_pspan = s_tspan + L.T * kChunk + warp * 2 * kChunk;
  int32_t* s_end = reinterpret_cast<int32_t*>(s_pspan + kChunk);
  uint8_t* s_hit = reinterpret_cast<uint8_t*>(s_tspan + L.T * kChunk +
                                              NW * 2 * kChunk) +
                   warp * kChunk;
  const int pp = blockIdx.y, g0 = blockIdx.x * kChunk;
  const int ng = min(kChunk, L.G - g0);
  const int Cs = L.NT * L.TC;

  for (int i = t; i < L.T * kChunk; i += blockDim.x) s_tspan[i] = 0u;
  s_hit[lane] = 0;
  if (t == 0) s_next = 0;
  __syncthreads();
  for (int tr = warp; tr < L.T; tr += NW) {   // one warp per triple slab
    slab_spans(L.emask + (((int64_t)pp * L.T + tr) * L.G + g0) * L.F,
               ng * L.F, L.F, s_tspan + tr * kChunk, lane, 32);
  }
  __syncthreads();

  // Each warp takes the next row until none is left: a heavy row holds up
  // only its own warp, and the warps never wait for each other.
  int parent = -1, ps = 0;
  int64_t pg0 = 0;
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(&s_next, 1);
    r = __shfl_sync(0xffffffffu, r, 0);
    if (r >= Cs) break;
    const int32_t* row = L.meta + (int64_t)r * 6;
    const int valid = row[5];
    if (!valid) continue;             // padding rows and tiles: no work
    const int tile = r / L.TC;
    if (L.tiles[tile * 2] != parent) {  // this warp's parent spans
      parent = L.tiles[tile * 2];
      pg0 = ((int64_t)pp * L.P + parent) * L.G + g0;
      s_pspan[lane] = 0u;
      __syncwarp();
      slab_spans(L.pmask + pg0 * L.M, ng * L.M, L.M, s_pspan, lane, 32);
      __syncwarp();
      ps = (int)s_pspan[lane];
    }
    const int triple = L.tiles[tile * 2 + 1];
    const uint32_t* ts = s_tspan + triple * kChunk;
    // the row's (graph, m, f) slots inside both spans, dealt out evenly
    // over the lanes: a graph with many embeddings does not hold up the
    // other 31
    int end_g = ps * (int)ts[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, end_g, d);
      if (lane >= d) end_g += n;
    }
    const int total = __shfl_sync(0xffffffffu, end_g, 31);
    if (total == 0) continue;
    s_end[lane] = end_g;
    __syncwarp();
    const int stub = row[1], to = row[2], fwd = row[3];
    const int64_t eg0 = (((int64_t)pp * L.T + triple) * L.G + g0) * L.F;
    uint32_t c = 0u;
    int g = 0;
    for (int i = lane; i < total; i += 32) {
      while (s_end[g] <= i) ++g;
      const int local = i - (g ? s_end[g - 1] : 0);
      const int tsg = (int)ts[g];
      const int m = local / tsg, f = local - m * tsg;
      const int64_t pm = (pg0 + g) * L.M + m;
      const int64_t e = eg0 + (int64_t)g * L.F + f;
      const int32_t* embp = L.pol + pm * L.K;
      if (L.pmask[pm] && L.emask[e] &&
          pair_joins(embp, L.K, slot_value(embp, stub, L.K),
                     slot_value(embp, to, L.K), fwd, L.src[e], L.dst + e)) {
        ++c;
        s_hit[g] = 1;                 // several lanes may store the same 1
      }
    }
    __syncwarp();
    const uint32_t hit = __ballot_sync(0xffffffffu, s_hit[lane] != 0);
    s_hit[lane] = 0;
    const uint32_t pairs = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) {
      if (hit) {
        atomicAdd(reinterpret_cast<uint32_t*>(sup) + (int64_t)pp * Cs + r,
                  (uint32_t)__popc(hit) * (uint32_t)valid);
      }
      if (pairs) {
        atomicAdd(reinterpret_cast<uint32_t*>(emb) + (int64_t)pp * Cs + r,
                  pairs * (uint32_t)valid);
      }
    }
    __syncwarp();                     // s_end, s_hit serve the next row
  }
}

Level make_level(const void* meta, const void* tiles, const void* pol,
                 const void* pmask, const void* src, const void* dst,
                 const void* emask, int PP, int P, int G, int M, int K,
                 int T, int F, int NT, int TC) {
  return Level{static_cast<const int32_t*>(meta),
               static_cast<const int32_t*>(tiles),
               static_cast<const int32_t*>(pol),
               static_cast<const uint8_t*>(pmask),
               static_cast<const int32_t*>(src),
               static_cast<const int32_t*>(dst),
               static_cast<const uint8_t*>(emask),
               PP, P, G, M, K, T, F, NT, TC};
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int fused_level_packed_launch(
    const void* meta, const void* tiles, const void* gmask, const void* pol,
    const void* pmask, const void* src, const void* dst, const void* emask,
    void* sup, void* emb, void* vbits, int PP, int P, int G, int M, int K,
    int T, int F, int NT, int TC, int Gw, int threads, void* stream) {
  const size_t smem = (size_t)F * threads * 9;
  cudaError_t err = cudaFuncSetAttribute(
      fused_level_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Gw * 32 + threads - 1) / threads, NT, PP);
  fused_level_packed_kernel<<<grid, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      make_level(meta, tiles, pol, pmask, src, dst, emask, PP, P, G, M, K, T,
                 F, NT, TC),
      static_cast<const uint32_t*>(gmask), Gw, static_cast<int32_t*>(sup),
      static_cast<int32_t*>(emb), static_cast<uint32_t*>(vbits));
  return (int)cudaGetLastError();
}

extern "C" int fused_level_launch(
    const void* meta, const void* tiles, const void* pol, const void* pmask,
    const void* src, const void* dst, const void* emask, void* sup,
    void* emb, int PP, int P, int G, int M, int K, int T, int F, int NT,
    int TC, int threads, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kChunk - 1) / kChunk, PP);
  fused_level_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      make_level(meta, tiles, pol, pmask, src, dst, emask, PP, P, G, M, K, T,
                 F, NT, TC),
      static_cast<int32_t*>(sup), static_cast<int32_t*>(emb));
  return (int)cudaGetLastError();
}
