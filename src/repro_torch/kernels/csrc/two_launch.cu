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
// The join is the row walk of join.cuh (walk_rows, pair_joins), the one
// the fused kernels run, so the three joins cannot drift apart.
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
// bytes.  The reduction reads the two intermediates once and is bound by
// bytes too.
// The design:
//   * embedding_join_kernel (B3): the walk of join.cuh over the meta
//     rows, one CTA per (32-graph chunk, partition), grid (ceil(G / 32),
//     PP); rows come from the walk's counter, so C has no grid limit.
//     The callers pad the candidate table to its bucket with copies of
//     one row ([0, 0, 0, 1, 0]: at the 40K main run's level 2, 170 of
//     512 rows, each as costly as the commonest real row), and their
//     results ride in the wire's padded tail, so they must be computed.
//     So a row equal in all five ints to the row before it is a
//     follower: the warp that takes it does nothing, and the warp that
//     joins the head of a run of equal consecutive rows writes its
//     per-graph matched/count into every row of the run (lane g stores
//     graph g0 + g, two coalesced 128-byte stores per row).  Each output
//     element has one writer and no warp waits for another.  Equal rows
//     that are not consecutive are each joined (in the main runs only
//     the padding repeats: the 343 run heads of the 40K run's level 2 are
//     343 distinct rows).  A row outside the stores (a
//     memory guard: the callers check their rows on the host) writes
//     zeros, and so does its run.  Graphs past G have no lane: the
//     outputs have exactly G columns and the stores are never padded.
//   * support_count_kernel (B4): one 256-thread CTA per row with scalar
//     4-byte loads and two block barriers per row keeps too few bytes in
//     flight and loses to torch.sum.  So one warp owns a row,
//     with no barrier, and a grid of a few CTAs per SM (set by the
//     wrapper from the card's SM count) strides over the rows with int64
//     offsets.  Each lane keeps four 16-byte streaming loads (__ldcs) of
//     each array in flight; a row that does not start 16-byte aligned
//     (G % 4 != 0, or an offset data pointer) takes its unaligned head
//     and tail as scalars, each array on its own, so nothing is copied.
//     __reduce_add_sync sums the lanes and lane 0 stores: every output
//     element has one writer.  The adds are on uint32_t, so a sum wraps
//     mod 2^32 exactly as the JAX int32 sums do (signed overflow is
//     undefined in C++).
#include <cstdint>
#include <cuda_runtime.h>

#include "join.cuh"

namespace {

__device__ __forceinline__ bool same_row(const int32_t* a, const int32_t* b) {
  return a[0] == b[0] && a[1] == b[1] && a[2] == b[2] && a[3] == b[3] &&
         a[4] == b[4];
}

// The meta rows as a row source, with the (PP, C, G) outputs.
struct JoinRows {
  const int32_t* meta;
  int C, P, T, G;
  int32_t* matched;
  int32_t* count;

  __device__ RowKind take(int r, JoinRow& j) const {
    const int32_t* row = meta + (int64_t)r * 5;
    if (r > 0 && same_row(row, row - 5)) return kSkip;   // a follower
    j = JoinRow{row[0], row[4], row[1], row[2], row[3]};
    const bool inside = j.parent >= 0 && j.parent < P && j.triple >= 0 &&
                        j.triple < T;
    return inside ? kJoin : kZero;
  }
  // Write the lane's graph's result into every row of the run headed by r.
  __device__ void emit(int r, uint32_t cnt) const {
    const int lane = threadIdx.x & 31;
    const int32_t* head = meta + (int64_t)r * 5;
    int n = 1;                        // the run's length
    for (;;) {
      const int q = r + n + lane;
      const bool same = q < C && same_row(meta + (int64_t)q * 5, head);
      const uint32_t differ = __ballot_sync(0xffffffffu, !same);
      if (differ) {
        n += __ffs(differ) - 1;
        break;
      }
      n += 32;
    }
    const int g = blockIdx.x * kChunk + lane;
    if (g >= G) return;
    int64_t o = ((int64_t)blockIdx.y * C + r) * G + g;
    for (int q = 0; q < n; ++q, o += G) {
      matched[o] = cnt != 0u;
      count[o] = (int32_t)cnt;
    }
  }
};

template <bool kTable>
__global__ void embedding_join_kernel(Stores S, JoinRows rows) {
  walk_rows<kTable>(S, rows, rows.C);
}

// Split a row at p of G int32 into a scalar head [0, head), 16-byte
// vectors [head, head + 4 * nvec) and a scalar tail [head + 4 * nvec, G).
__device__ __forceinline__ void split_row(const int32_t* p, int G, int& head,
                                          int& nvec) {
  head = (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2);
  head = head < G ? head : G;
  nvec = (G - head) >> 2;
}

__device__ __forceinline__ uint32_t sum4(int4 v) {
  return (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
}

// The lane's share of the scalar head and tail of a split row.
__device__ __forceinline__ uint32_t edge_sum(const int32_t* p, int G,
                                             int head, int nvec, int lane) {
  uint32_t s = 0u;
  for (int g = lane; g < head; g += 32) s += (uint32_t)p[g];
  for (int g = head + 4 * nvec + lane; g < G; g += 32) s += (uint32_t)p[g];
  return s;
}

// One warp per (partition, candidate) row, grid-striding over the rows.
__global__ void support_count_kernel(const int32_t* __restrict__ matched,
                                     const int32_t* __restrict__ count,
                                     int64_t rows, int G, int32_t* sup,
                                     int32_t* emb) {
  const int lane = threadIdx.x & 31;
  const int64_t wpb = blockDim.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * wpb;
  for (int64_t r = blockIdx.x * wpb + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const int32_t* m = matched + r * G;
    const int32_t* c = count + r * G;
    int hm, nm, hc, nc;
    split_row(m, G, hm, nm);
    split_row(c, G, hc, nc);
    uint32_t a = edge_sum(m, G, hm, nm, lane);
    uint32_t b = edge_sum(c, G, hc, nc, lane);
    const int4* vm = reinterpret_cast<const int4*>(m + hm);
    const int4* vc = reinterpret_cast<const int4*>(c + hc);
    const int n = nm < nc ? nm : nc;
    int v = lane;
    for (; v + 96 < n; v += 128) {    // 4 loads in flight per array
      const int4 m0 = __ldcs(vm + v), m1 = __ldcs(vm + v + 32);
      const int4 m2 = __ldcs(vm + v + 64), m3 = __ldcs(vm + v + 96);
      const int4 c0 = __ldcs(vc + v), c1 = __ldcs(vc + v + 32);
      const int4 c2 = __ldcs(vc + v + 64), c3 = __ldcs(vc + v + 96);
      a += sum4(m0) + sum4(m1) + sum4(m2) + sum4(m3);
      b += sum4(c0) + sum4(c1) + sum4(c2) + sum4(c3);
    }
    for (; v < n; v += 32) {
      a += sum4(__ldcs(vm + v));
      b += sum4(__ldcs(vc + v));
    }
    for (int w = n + lane; w < nm; w += 32) a += sum4(__ldcs(vm + w));
    for (int w = n + lane; w < nc; w += 32) b += sum4(__ldcs(vc + w));
    a = __reduce_add_sync(0xffffffffu, a);
    b = __reduce_add_sync(0xffffffffu, b);
    if (lane == 0) {
      sup[r] = static_cast<int32_t>(a);
      emb[r] = static_cast<int32_t>(b);
    }
  }
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int embedding_join_launch(
    const void* meta, const void* pol, const void* pmask, const void* src,
    const void* dst, const void* emask, void* matched, void* count, int PP,
    int P, int G, int M, int K, int T, int F, int C, int threads, int smem,
    void* stream) {
  const auto kernel = span_table(T, threads, smem)
                          ? embedding_join_kernel<true>
                          : embedding_join_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const JoinRows rows{static_cast<const int32_t*>(meta), C, P, T, G,
                      static_cast<int32_t*>(matched),
                      static_cast<int32_t*>(count)};
  kernel<<<dim3((G + kChunk - 1) / kChunk, PP), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      Stores{static_cast<const int32_t*>(pol),
             static_cast<const uint8_t*>(pmask),
             static_cast<const int32_t*>(src),
             static_cast<const int32_t*>(dst),
             static_cast<const uint8_t*>(emask), PP, P, G, M, K, T, F},
      rows);
  return (int)cudaGetLastError();
}

extern "C" int support_count_launch(const void* matched, const void* count,
                                    void* sup, void* emb, int PP, int C,
                                    int G, int blocks, int threads,
                                    void* stream) {
  support_count_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(matched),
      static_cast<const int32_t*>(count), (int64_t)PP * C, G,
      static_cast<int32_t*>(sup), static_cast<int32_t*>(emb));
  return (int)cudaGetLastError();
}
