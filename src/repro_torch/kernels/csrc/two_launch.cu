// The two-launch map phase of one MIRAGE level for Hopper (sm_90a): a
// per-candidate, per-graph join that writes (C, G) intermediates to
// device memory, then a per-candidate reduction of them.  This is the
// backend "pallas" of the port: the on-device oracle for the fused
// kernels of fused_level.cu and the backend of the legacy pipeline.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   embedding_join_kernel <- src/repro/kernels/embedding_join.py
//                            embedding_join_pallas / _join_kernel
//                            (vmapped over the partitions by
//                            src/repro/kernels/ops.py device_local_supports)
//   support_count_kernel  <- src/repro/kernels/support_count.py
//                            support_count_pallas / _reduce_kernel
// The join itself is join_row of join.cuh, the device function the fused
// kernels use, so the three joins cannot drift apart.
//
// Inputs (row-major, int64 offsets everywhere):
//   meta  (C, 5) int32  [parent, stub, to, fwd, triple]
//   pol   (PP, P, G, M, K) int32, PAD -1     pmask (PP, P, G, M) uint8/bool
//   src, dst (PP, T, G, F) int32             emask (PP, T, G, F) uint8/bool
// Outputs: matched, count (PP, C, G) int32, every element written once by
// the join; sup, emb (PP, C) int32, every element written once by the
// reduction.
//
// What bounds them on the H100.  The join needs read, for every distinct
// parent and triple the candidates reference, the mask rows in full, the
// K slots of every set embedding and src/dst of every set occurrence, and
// it writes 8 bytes per (partition, candidate, graph); its (m, f)
// compares take far less at the card's 32-bit rate, so its bound is
// bytes.  It runs above that bound (read from the code; not profiled):
// each candidate re-reads its parent and edge rows, where candidates of
// one parent share them, and each thread reads its own graph's rows, so
// a warp's loads are 32 scattered rows.  The reduction reads the two
// intermediates once and is bound by bytes too; its loads are coalesced.
// The design:
//   * embedding_join_kernel: one thread per graph, one CTA per (graph
//     chunk, candidate, partition).  The CTA reads its candidate's meta
//     row itself (the TPU kernel's scalar prefetch); the partition axis
//     is the grid's z axis (the JAX vmap).  Candidates beyond the grid's
//     y limit are taken by a grid-stride loop.  The thread stages its
//     edge-OL row column-wise in shared memory ([f][thread]) so the M*F
//     loop of join_row reads it without bank conflicts.  Graphs past G
//     have no thread: the outputs have exactly G columns and the stores
//     are never padded.  A meta row outside the stores writes zeros (a
//     memory guard: the callers check their rows on the host).
//   * support_count_kernel: one CTA per (partition, candidate) row, a
//     strided sum over G, then a warp-shuffle reduction and one across
//     the warps.  The adds are on uint32_t, so a sum wraps mod 2^32
//     exactly as the JAX int32 sums do (signed overflow is undefined in
//     C++).
#include <cstdint>
#include <cuda_runtime.h>

#include "join.cuh"

namespace {

struct JoinArgs {
  const int32_t* meta;
  const int32_t* pol;
  const uint8_t* pmask;
  const int32_t* src;
  const int32_t* dst;
  const uint8_t* emask;
  int PP, P, G, M, K, T, F, C;
};

__global__ void embedding_join_kernel(JoinArgs J, int32_t* matched,
                                      int32_t* count) {
  extern __shared__ unsigned char smem[];
  const int B = blockDim.x, t = threadIdx.x;
  const int pp = blockIdx.z;
  const int g = blockIdx.x * B + t;
  if (g >= J.G) return;            // no collective below: safe to leave
  int32_t* s_src = reinterpret_cast<int32_t*>(smem);
  int32_t* s_dst = s_src + J.F * B;
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_dst + J.F * B);

  for (int c = blockIdx.y; c < J.C; c += gridDim.y) {
    const int32_t* row = J.meta + (int64_t)c * 5;
    const int parent = row[0], triple = row[4];
    int n = 0;
    if (parent >= 0 && parent < J.P && triple >= 0 && triple < J.T) {
      const int64_t eb = (((int64_t)pp * J.T + triple) * J.G + g) * J.F;
      for (int f = 0; f < J.F; ++f) {
        s_src[f * B + t] = J.src[eb + f];
        s_dst[f * B + t] = J.dst[eb + f];
        s_em[f * B + t] = J.emask[eb + f];
      }
      const int64_t pg = ((int64_t)pp * J.P + parent) * J.G + g;
      n = join_row(J.pol + pg * J.M * J.K, J.pmask + pg * J.M, s_src + t,
                   s_dst + t, s_em + t, B, J.M, J.K, J.F, row[1], row[2],
                   row[3]);
    }
    const int64_t o = ((int64_t)pp * J.C + c) * J.G + g;
    matched[o] = n > 0;
    count[o] = n;
  }
}

constexpr int kReduceThreads = 256;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void support_count_kernel(const int32_t* matched,
                                     const int32_t* count, int64_t rows,
                                     int G, int32_t* sup, int32_t* emb) {
  __shared__ uint32_t s_sup[kReduceThreads / 32];
  __shared__ uint32_t s_emb[kReduceThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int32_t* m = matched + r * G;
    const int32_t* c = count + r * G;
    uint32_t a = 0u, b = 0u;
    for (int g = t; g < G; g += kReduceThreads) {
      a += static_cast<uint32_t>(m[g]);
      b += static_cast<uint32_t>(c[g]);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      s_sup[warp] = a;
      s_emb[warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
      a = lane < kReduceThreads / 32 ? s_sup[lane] : 0u;
      b = lane < kReduceThreads / 32 ? s_emb[lane] : 0u;
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        sup[r] = static_cast<int32_t>(a);
        emb[r] = static_cast<int32_t>(b);
      }
    }
    __syncthreads();               // s_* are reused by the next row
  }
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int embedding_join_launch(
    const void* meta, const void* pol, const void* pmask, const void* src,
    const void* dst, const void* emask, void* matched, void* count, int PP,
    int P, int G, int M, int K, int T, int F, int C, int threads,
    void* stream) {
  const size_t smem = (size_t)F * threads * 9;
  cudaError_t err = cudaFuncSetAttribute(
      embedding_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + threads - 1) / threads, C < 65535 ? C : 65535, PP);
  embedding_join_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      JoinArgs{static_cast<const int32_t*>(meta),
               static_cast<const int32_t*>(pol),
               static_cast<const uint8_t*>(pmask),
               static_cast<const int32_t*>(src),
               static_cast<const int32_t*>(dst),
               static_cast<const uint8_t*>(emask), PP, P, G, M, K, T, F, C},
      static_cast<int32_t*>(matched), static_cast<int32_t*>(count));
  return (int)cudaGetLastError();
}

extern "C" int support_count_launch(const void* matched, const void* count,
                                    void* sup, void* emb, int PP, int C,
                                    int G, void* stream) {
  const int64_t rows = (int64_t)PP * C;
  const unsigned blocks = rows < (1 << 20) ? (unsigned)rows : (1u << 20);
  support_count_kernel<<<blocks, kReduceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(matched),
      static_cast<const int32_t*>(count), rows, G,
      static_cast<int32_t*>(sup), static_cast<int32_t*>(emb));
  return (int)cudaGetLastError();
}
