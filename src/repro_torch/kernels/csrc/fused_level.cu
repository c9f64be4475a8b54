// Fused single-launch map phase of one MIRAGE level (join + support) for
// Hopper (sm_90a): a dense kernel and a bit-packed kernel that share one
// join device function, so the two cannot diverge.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   fused_level_packed_kernel  <- src/repro/kernels/fused_level.py
//                                 fused_level_packed_pallas / _fused_packed_kernel
//   fused_level_kernel         <- src/repro/kernels/fused_level.py
//                                 fused_level_pallas / _fused_kernel
//   join_row (join.cuh)        <- src/repro/kernels/fused_level.py _joined_blocks
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
// What bounds it on the H100: the least time of a call is set by the
// bytes its data needs moved (the masks of the parent and triple rows its
// valid tiles reference, the K slots of every set embedding, src/dst of
// every set occurrence, the outputs); the (m, f) compares it needs take
// far less at the card's 32-bit rate.  chip_smoke.py computes that bound
// for each call from its inputs.  The kernel runs well above it (not
// profiled yet; read from the code): every thread reads its own graph's
// parent and edge rows, so a warp's loads are 32 scattered rows rather
// than one coalesced line, and every tile, and every row of a tile,
// re-reads its parent rows.  The design:
//   * one thread owns one graph, one warp owns 32 consecutive graphs, so
//     __ballot_sync of the per-graph any-match flags IS the LSB-first
//     verdict word of bitset.py (lane i <-> graph 32w+i); & gmask and
//     __popc give the support with no shift-OR pass;
//   * one CTA per (graph chunk, tile, partition) reads its tiles[] row
//     itself (the TPU kernel's scalar prefetch) and loops over the tile's
//     TC candidate rows, so the shared parent and edge rows stay hot;
//   * the thread's edge-OL row is staged in shared memory column-wise
//     ([f][thread]), so the M*F inner loop reads it without bank
//     conflicts; the forward-membership test runs lazily, only for the
//     (m, f) pairs whose source already matched (few per graph), instead
//     of the TPU kernel's dense (M, F, K) mask per block;
//   * sup/emb are integer atomics: addition mod 2^32 is exact in any
//     order, so the result does not depend on block order (and wraps
//     exactly as the JAX int32 sums do);
//   * each vbits word has one writer, including the all-invalid tiles
//     that skip the join (they write zeros).
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

__global__ void fused_level_kernel(Level L, int32_t* sup, int32_t* emb) {
  extern __shared__ unsigned char smem[];
  const int B = blockDim.x, t = threadIdx.x, lane = t & 31;
  const int pp = blockIdx.z, ct = blockIdx.y;
  const int g = blockIdx.x * B + t;
  const int Cs = L.NT * L.TC;
  const int32_t* rows = L.meta + (int64_t)ct * L.TC * 6;

  if (!tile_valid(rows, L.TC)) return;   // outputs stay at their zeros
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
    const uint32_t bits = __ballot_sync(0xffffffffu, c > 0);
    const int wsum = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0 && (g - lane) < L.G) {
      const int64_t row = (int64_t)pp * Cs + ct * L.TC + i;
      atomicAdd(sup + row, __popc(bits) * valid);
      atomicAdd(emb + row, wsum * valid);
    }
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
    int TC, int threads, void* stream) {
  const size_t smem = (size_t)F * threads * 9;
  cudaError_t err = cudaFuncSetAttribute(
      fused_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + threads - 1) / threads, NT, PP);
  fused_level_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      make_level(meta, tiles, pol, pmask, src, dst, emask, PP, P, G, M, K, T,
                 F, NT, TC),
      static_cast<int32_t*>(sup), static_cast<int32_t*>(emb));
  return (int)cudaGetLastError();
}
