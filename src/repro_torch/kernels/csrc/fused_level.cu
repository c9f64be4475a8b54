// Fused single-launch map phase of one MIRAGE level (join + support) for
// Hopper (sm_90a): a dense kernel and a bit-packed kernel, both the row
// walk of join.cuh over the parent-grouped schedule, so the two cannot
// diverge.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   fused_level_packed_kernel  <- src/repro/kernels/fused_level.py
//                                 fused_level_packed_pallas / _fused_packed_kernel
//   fused_level_kernel         <- src/repro/kernels/fused_level.py
//                                 fused_level_pallas / _fused_kernel
//   walk_rows, pair_joins (join.cuh) <- src/repro/kernels/fused_level.py
//                                 _joined_blocks
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
// for each call from its inputs.  Both kernels run well above it: the
// slot loop's loads are scattered L1/L2 reads, and each CTA recomputes
// the spans of every triple for its 32 graphs (join.cuh says what the
// walk does about the rest).
//
//   * fused_level_kernel (B2): rows with valid = 0 (bucket padding and
//     whole-invalid tiles) cost one read of their valid flag; a joined
//     row adds popc(ballot of its graphs' hit flags) * valid to sup and
//     its pairs * valid to emb, one integer atomic each per (row, CTA)
//     and only when non-zero (exact in any order, wrapping mod 2^32 as
//     the JAX int32 sums do);
//   * fused_level_packed_kernel (B1) is the same walk plus the verdict
//     word: a CTA's 32 graphs are exactly verdict word blockIdx.x of
//     every row (lane i <-> graph 32w + i, LSB-first as bitset.py), so
//     the ballot of the hit flags & gmask[w] (0 when valid = 0) IS the
//     word and the warp that took the row is its only writer.  The grid
//     has Gw chunks, not ceil(G / 32): a chunk past G joins nothing and
//     writes the zero tail words of the graph-tile padding, so every word
//     is written by the kernel, for invalid rows and rows with no slot in
//     the spans too.
#include <cstdint>
#include <cuda_runtime.h>

#include "join.cuh"

namespace {

// The schedule as a row source: a row's parent and triple are its tile's.
struct Sched {
  const int32_t* meta;
  const int32_t* tiles;
  int TC, Cs;

  __device__ __forceinline__ RowKind take(int r, JoinRow& j,
                                          RowKind invalid) const {
    const int32_t* row = meta + (int64_t)r * 6;
    if (!row[5]) return invalid;
    const int tile = r / TC;
    j = JoinRow{tiles[tile * 2], tiles[tile * 2 + 1], row[1], row[2],
                row[3]};
    return kJoin;
  }
  __device__ __forceinline__ int valid(int r) const {
    return meta[(int64_t)r * 6 + 5];
  }
};

struct DenseRows {
  Sched s;
  int32_t* sup;
  int32_t* emb;

  __device__ RowKind take(int r, JoinRow& j) const {
    return s.take(r, j, kSkip);       // padding rows: no work, no write
  }
  __device__ void emit(int r, uint32_t cnt) const {
    const uint32_t hit = __ballot_sync(0xffffffffu, cnt != 0u);
    const uint32_t pairs = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && (hit | pairs)) {
      const uint32_t valid = (uint32_t)s.valid(r);
      const int64_t o = (int64_t)blockIdx.y * s.Cs + r;
      if (hit) {
        atomicAdd(reinterpret_cast<uint32_t*>(sup) + o,
                  (uint32_t)__popc(hit) * valid);
      }
      if (pairs) {
        atomicAdd(reinterpret_cast<uint32_t*>(emb) + o, pairs * valid);
      }
    }
  }
};

struct PackedRows {
  Sched s;
  const uint32_t* gmask;
  int Gw;
  int32_t* sup;
  int32_t* emb;
  uint32_t* vbits;

  __device__ RowKind take(int r, JoinRow& j) const {
    return s.take(r, j, kZero);       // padding rows: a zero word
  }
  __device__ void emit(int r, uint32_t cnt) const {
    uint32_t bits = __ballot_sync(0xffffffffu, cnt != 0u);
    const uint32_t pairs = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0) {
      const int word = blockIdx.x;
      const uint32_t valid = (uint32_t)s.valid(r);
      const int64_t o = (int64_t)blockIdx.y * s.Cs + r;
      bits = valid ? (bits & gmask[word]) : 0u;
      vbits[o * Gw + word] = bits;
      if (bits) {
        atomicAdd(reinterpret_cast<uint32_t*>(sup) + o,
                  (uint32_t)__popc(bits));
      }
      if (pairs && valid) {
        atomicAdd(reinterpret_cast<uint32_t*>(emb) + o, pairs * valid);
      }
    }
  }
};

template <bool kTable>
__global__ void fused_level_packed_kernel(Stores S, PackedRows rows) {
  walk_rows<kTable>(S, rows, rows.s.Cs);
}

template <bool kTable>
__global__ void fused_level_kernel(Stores S, DenseRows rows) {
  walk_rows<kTable>(S, rows, rows.s.Cs);
}

Stores make_stores(const void* pol, const void* pmask, const void* src,
                   const void* dst, const void* emask, int PP, int P, int G,
                   int M, int K, int T, int F) {
  return Stores{static_cast<const int32_t*>(pol),
                static_cast<const uint8_t*>(pmask),
                static_cast<const int32_t*>(src),
                static_cast<const int32_t*>(dst),
                static_cast<const uint8_t*>(emask), PP, P, G, M, K, T, F};
}

Sched make_sched(const void* meta, const void* tiles, int NT, int TC) {
  return Sched{static_cast<const int32_t*>(meta),
               static_cast<const int32_t*>(tiles), TC, NT * TC};
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
// `threads` and `smem` come from the wrapper (build.py join_geometry).
extern "C" int fused_level_packed_launch(
    const void* meta, const void* tiles, const void* gmask, const void* pol,
    const void* pmask, const void* src, const void* dst, const void* emask,
    void* sup, void* emb, void* vbits, int PP, int P, int G, int M, int K,
    int T, int F, int NT, int TC, int Gw, int threads, int smem,
    void* stream) {
  const auto kernel = span_table(T, threads, smem)
                          ? fused_level_packed_kernel<true>
                          : fused_level_packed_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const PackedRows rows{make_sched(meta, tiles, NT, TC),
                        static_cast<const uint32_t*>(gmask), Gw,
                        static_cast<int32_t*>(sup),
                        static_cast<int32_t*>(emb),
                        static_cast<uint32_t*>(vbits)};
  kernel<<<dim3(Gw, PP), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      make_stores(pol, pmask, src, dst, emask, PP, P, G, M, K, T, F), rows);
  return (int)cudaGetLastError();
}

extern "C" int fused_level_launch(
    const void* meta, const void* tiles, const void* pol, const void* pmask,
    const void* src, const void* dst, const void* emask, void* sup,
    void* emb, int PP, int P, int G, int M, int K, int T, int F, int NT,
    int TC, int threads, int smem, void* stream) {
  const auto kernel = span_table(T, threads, smem)
                          ? fused_level_kernel<true>
                          : fused_level_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const DenseRows rows{make_sched(meta, tiles, NT, TC),
                       static_cast<int32_t*>(sup),
                       static_cast<int32_t*>(emb)};
  kernel<<<dim3((G + kChunk - 1) / kChunk, PP), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      make_stores(pol, pmask, src, dst, emask, PP, P, G, M, K, T, F), rows);
  return (int)cudaGetLastError();
}
