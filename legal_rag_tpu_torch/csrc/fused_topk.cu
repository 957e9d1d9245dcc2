// K3: fused column-major matmul + top-k, without the [Q, N] scores.
//
// Replaces the TPU kernel legal_rag_tpu/ops/dense.py _fused_topk_kernel
// (pallas_call in dense_topk_pallas). Docs are stored transposed,
// docs_t [D, N]. For each query q it returns the k best columns c by
// (score descending, lowest c on ties), where
//
//   score(q, c) = c < limit ? dot(docs_t[:, c], queries[q]) : -FLT_MAX
//
// Masked columns (limit <= c < N) still compete, as on the TPU, so when
// k > limit the tail holds masked ids in ascending order. k <= N.
//
// Two launches. The TPU kernel walks the doc blocks in order on one core
// and merges a running top-k; on the card the blocks run in parallel:
//
// 1. fused_topk_partial_kernel: block (query tile, split) scores its
//    split's columns, 256 at a time (one column a thread, the same
//    coalesced column-major loop as K4, colmajor.cuh), and keeps each
//    query's best k of the split in shared memory. A candidate enters a
//    query's buffer only if it beats that query's threshold, the current
//    k-th entry; when a buffer could overflow, a bitonic sort by the
//    (score, id) rule compacts every buffer to its best k and raises the
//    thresholds. Once the buffers hold k entries, few columns pass.
// 2. fused_topk_merge_kernel: one block per query reduces the splits'
//    n_splits * k candidates by the same threshold-and-compact rule.
//
// Exactness: the global top-k entries are each within the best k of
// their own split (fewer than k entries beat them anywhere), and the
// merge orders by the same total order, so the result is the top-k of
// the whole row.
//
// What bounds it: one pass over docs_t per 8-query tile at the memory
// rate, at serving batches; selection is a small share once thresholds
// rise. Numerics: fp32 in the order e = 0 .. D-1, each product rounded
// to fp32 and then added (no fused multiply-add), so the plain version,
// a loop of tensor multiply and add, gives the same bits and the same
// ids, ties included.

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "colmajor.cuh"

namespace {

constexpr int kThreads = 256;           // columns (or candidates) a tile
constexpr int kCap = 512;               // buffer slots per query
constexpr int kMaxK = kCap - kThreads;  // a compacted buffer takes a tile
constexpr int kQT = 8;                  // queries per partial block

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// (s, i) comes before (ts, ti): higher score, then lower id.
__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

// R candidate buffers of kCap (score, id) slots in shared memory, each
// with its fill count and threshold. Empty slots and the initial
// threshold are (-inf, INT_MAX), worse than any real entry.
template <int R>
struct Selection {
  float* s;
  int* id;
  int* count;
  float* ts;
  int* ti;

  static constexpr size_t bytes() {
    return static_cast<size_t>(R) * kCap * (sizeof(float) + sizeof(int)) +
           R * (2 * sizeof(int) + sizeof(float));
  }

  __device__ explicit Selection(void* base) {
    s = static_cast<float*>(base);
    id = reinterpret_cast<int*>(s + R * kCap);
    count = id + R * kCap;
    ts = reinterpret_cast<float*>(count + R);
    ti = reinterpret_cast<int*>(ts + R);
  }

  __device__ void init() {
    for (int j = threadIdx.x; j < R; j += blockDim.x) {
      count[j] = 0;
      ts[j] = neg_inf();
      ti[j] = INT_MAX;
    }
  }

  // After a tile's offers: compact when some buffer could not take
  // another whole tile. The first barrier ends the tile's offers; the
  // second (a block-wide OR) gives every thread the same answer.
  __device__ void make_room(int k) {
    __syncthreads();
    const bool low = threadIdx.x < R && count[threadIdx.x] > kCap - kThreads;
    if (__syncthreads_or(low)) compact(k);
  }

  __device__ void offer(int j, float v, int i) {
    if (better(v, i, ts[j], ti[j])) {
      const int slot = atomicAdd(&count[j], 1);
      s[j * kCap + slot] = v;
      id[j * kCap + slot] = i;
    }
  }

  // Sort every buffer by the rule (bitonic network over kCap slots, all
  // R buffers at once), keep its best k, and make its k-th entry the
  // threshold once it holds k. Every thread of the block calls this.
  __device__ void compact(int k) {
    __syncthreads();
    for (int t = threadIdx.x; t < R * kCap; t += blockDim.x) {
      if (t % kCap >= count[t / kCap]) {
        s[t] = neg_inf();
        id[t] = INT_MAX;
      }
    }
    __syncthreads();
    for (int size = 2; size <= kCap; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < R * kCap / 2; t += blockDim.x) {
          const int j = t / (kCap / 2);
          const int u = t % (kCap / 2);
          const int a = ((u & ~(stride - 1)) << 1) | (u & (stride - 1));
          const int pa = j * kCap + a;
          const int pb = pa + stride;
          const float sa = s[pa], sb = s[pb];
          const int ia = id[pa], ib = id[pb];
          // the best-first half of each bitonic block, worst-first the other
          const bool swap = (a & size) == 0 ? better(sb, ib, sa, ia)
                                            : better(sa, ia, sb, ib);
          if (swap) {
            s[pa] = sb;
            s[pb] = sa;
            id[pa] = ib;
            id[pb] = ia;
          }
        }
        __syncthreads();
      }
    }
    for (int j = threadIdx.x; j < R; j += blockDim.x) {
      const int c = count[j];
      if (c >= k) {
        ts[j] = s[j * kCap + k - 1];
        ti[j] = id[j * kCap + k - 1];
      }
      count[j] = min(c, k);
    }
    __syncthreads();
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial_kernel(const T* __restrict__ docs_t, long long ld,
                          long long n, const T* __restrict__ queries,
                          int n_q, int d, int k, long long limit,
                          long long chunk, int n_qt, int n_splits,
                          float* __restrict__ part_s,
                          int* __restrict__ part_i) {
  extern __shared__ float4 smem[];
  const int dp = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);     // [kQT, dp] fp32
  Selection<kQT> sel(qs + kQT * dp);
  // the query tile varies fastest: blocks reading one split are adjacent
  const int qt = static_cast<int>(blockIdx.x % n_qt);
  const int split = static_cast<int>(blockIdx.x / n_qt);
  const int q0 = qt * kQT;
  const int qn = min(kQT, n_q - q0);
  colmajor::stage_queries<T, kQT>(queries, q0, qn, d, dp, qs);
  sel.init();
  __syncthreads();

  const long long lo = static_cast<long long>(split) * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long base = lo; base < hi; base += kThreads) {
    const long long c = base + threadIdx.x;
    if (c < hi) {
      float acc[kQT];
      if (c < limit) {
        colmajor::dot_column<T, kQT, false>(docs_t + c, ld, d, qs, dp, acc);
      } else {
#pragma unroll
        for (int j = 0; j < kQT; ++j) acc[j] = -FLT_MAX;
      }
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        if (j < qn) sel.offer(j, acc[j], static_cast<int>(c));
      }
    }
    sel.make_room(k);
  }
  sel.compact(k);
  for (int t = threadIdx.x; t < qn * k; t += kThreads) {
    const int j = t / k;
    const int r = t - j * k;
    const long long o =
        (static_cast<long long>(q0 + j) * n_splits + split) * k + r;
    part_s[o] = sel.s[j * kCap + r];
    part_i[o] = sel.id[j * kCap + r];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_topk_merge_kernel(const float* __restrict__ part_s,
                        const int* __restrict__ part_i, long long n_cand,
                        int k, float* __restrict__ out_s,
                        int* __restrict__ out_i) {
  extern __shared__ float4 smem[];
  Selection<1> sel(smem);
  const long long q = blockIdx.x;
  sel.init();
  __syncthreads();
  const float* cs = part_s + q * n_cand;
  const int* ci = part_i + q * n_cand;
  for (long long base = 0; base < n_cand; base += kThreads) {
    const long long t = base + threadIdx.x;
    if (t < n_cand) sel.offer(0, cs[t], ci[t]);
    sel.make_room(k);
  }
  sel.compact(k);
  for (int r = threadIdx.x; r < k; r += kThreads) {
    out_s[q * k + r] = sel.s[r];
    out_i[q * k + r] = sel.id[r];
  }
}

template <typename T>
cudaError_t launch(const void* docs_t, long long ld, long long n,
                   const void* queries, int n_q, int d, int k,
                   long long limit, int n_splits, void* part_s, void* part_i,
                   void* out_s, void* out_i, cudaStream_t stream) {
  const int dp = (d + 3) & ~3;
  const size_t smem =
      static_cast<size_t>(kQT) * dp * sizeof(float) + Selection<kQT>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_partial_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (n_q + kQT - 1) / kQT;
  // whole tiles per split; trailing splits may be empty
  long long chunk = (n + n_splits - 1) / n_splits;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  fused_topk_partial_kernel<T><<<n_qt * n_splits, kThreads, smem, stream>>>(
      static_cast<const T*>(docs_t), ld, n, static_cast<const T*>(queries),
      n_q, d, k, limit, chunk, n_qt, n_splits,
      static_cast<float*>(part_s), static_cast<int*>(part_i));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_topk_merge_kernel<<<n_q, kThreads, Selection<1>::bytes(), stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<long long>(n_splits) * k, k, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// docs_t [d, >= n columns] with row stride ld (elements), queries
// [n_q, d] row-major; k <= min(n, kMaxK), n < 2^31. Scratch part_s /
// part_i hold [n_q, n_splits, k]; out_s / out_i are [n_q, k] (fp32,
// int32). dtype: 0 = float32, 1 = bfloat16. Columns >= limit score
// -FLT_MAX and compete. Returns the CUDA error of the launches (0 on
// success); both run asynchronously on ``stream``.
extern "C" int fused_topk_launch(const void* docs_t, long long ld,
                                 long long n, const void* queries, int n_q,
                                 int d, int k, long long limit, int n_splits,
                                 void* part_s, void* part_i, void* out_s,
                                 void* out_i, int dtype, int device,
                                 void* stream) {
  if (n_q < 1 || d < 1 || d > 1024 || k < 1 || k > kMaxK || k > n ||
      n > INT_MAX || n_splits < 1 || static_cast<long long>(n_q) * n_splits >
      0x7fffffffLL / kQT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(docs_t, ld, n, queries, n_q, d, k, limit, n_splits,
                        part_s, part_i, out_s, out_i, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(docs_t, ld, n, queries, n_q, d, k, limit,
                                n_splits, part_s, part_i, out_s, out_i, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
