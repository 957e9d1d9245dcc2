// K4: column-major segment max, phase 1 of the column-major two-phase
// exact dense top-k.
//
// Replaces the TPU kernel legal_rag_tpu/ops/dense.py _segmax_kernel
// (pallas_call in dense_topk_twophase). Docs are stored transposed,
// docs_t [D, N]. A segment is seg_rows docs strided 128 apart: map
// position p = G * 128 + lane holds docs G * seg_rows * 128 + r * 128 + lane
// for r in [0, seg_rows). For queries q:
//
//   out[q, p] = max over the segment's docs c of
//               (c < limit ? dot(docs_t[:, c], queries[q]) : -FLT_MAX)
//
// written query-major, [n_q, n_segs] with n_segs = ceil(N / (seg_rows *
// 128)) * 128 (columns >= N score -FLT_MAX, as the TPU kernel's padding
// does). The [n_q, N] score matrix never reaches device memory.
//
// What bounds it: at serving batches each doc byte feeds 2 (fp32) or 4
// (bf16) FLOP per query, far below the card's FLOP-per-byte balance, so
// one pass over docs_t at the memory rate is the bound. The layout suits
// the card: one thread owns one segment and keeps its maxima in
// registers (no shuffles); a warp's 32 threads own 32 adjacent lanes of
// one group, so at every step it reads 32 adjacent columns of one row
// (coalesced). The query tile (QT = 8 or 16 queries) sits in shared
// memory and is read by broadcast. Queries beyond one tile take more
// passes over docs_t; blocks of the same doc range and different query
// tiles are adjacent in launch order, so later passes mostly hit L2.
//
// Any D: a query tile too wide for shared memory ([QT, D] fp32 past
// 227 KB, D > 3,632 at QT = 16) is staged in chunks of kChunkD columns,
// and each member's dot product runs chunk by chunk, in order, with the
// block's barriers between chunks.
//
// Numerics: fp32 fused multiply-adds in the order e = 0 .. D-1 (no
// tensor cores, so no TF32). bf16 docs take bf16 queries; both widen
// exactly to fp32.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "colmajor.cuh"
#include "setup.cuh"

namespace {

constexpr int kThreads = 128;     // segments per block
constexpr int kLanes = 128;       // the stride of a segment's docs
constexpr int kChunkD = 2048;     // query columns a chunk, when D is staged in chunks

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
segmax_cm_kernel(const T* __restrict__ docs_t, long long ld,
                 const T* __restrict__ queries, int n_q, int d,
                 float* __restrict__ out, long long n_segs, int seg_rows,
                 long long limit, int n_qt, int dc) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);     // [QT, dc] fp32
  const int dp = (d + 3) & ~3;
  // the query tile varies fastest, so the blocks that read one doc
  // range run side by side and share it through L2
  const int qt = static_cast<int>(blockIdx.x % n_qt);
  const long long sb = blockIdx.x / n_qt;
  const int q0 = qt * QT;
  const int qn = min(QT, n_q - q0);
  const long long p = sb * kThreads + threadIdx.x;
  const long long first = (p / kLanes) * seg_rows * kLanes + (p % kLanes);
  float m[QT], acc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) m[j] = -FLT_MAX;
  if (dc >= dp) {
    // the whole query tile at once
    colmajor::stage_queries<T, QT>(queries, q0, qn, d, dp, qs);
    __syncthreads();
    if (p >= n_segs) return;
    for (int r = 0; r < seg_rows; ++r) {
      const long long c = first + static_cast<long long>(r) * kLanes;
      if (c >= limit) break;        // later members lie further right
      colmajor::dot_column<T, QT, true>(docs_t + c, ld, d, qs, dp, acc);
#pragma unroll
      for (int j = 0; j < QT; ++j) m[j] = fmaxf(m[j], acc[j]);
    }
  } else {
    // chunks of dc columns: every thread takes part in every chunk's
    // staging, while any thread of the block has a member left
    for (int r = 0; r < seg_rows; ++r) {
      const long long c = first + static_cast<long long>(r) * kLanes;
      const bool valid = p < n_segs && c < limit;
      if (!__syncthreads_or(valid)) break;
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] = 0.f;
      for (int e0 = 0; e0 < d; e0 += dc) {
        const int w = min(dc, d - e0);
        __syncthreads();            // the last chunk's readers are done
        for (int i = threadIdx.x; i < QT * dc; i += kThreads) {
          const int j = i / dc;
          const int e = i - j * dc;
          qs[i] = (j < qn && e < w)
                      ? colmajor::load_f32(queries + static_cast<long long>(q0 + j) * d + e0 + e)
                      : 0.f;
        }
        __syncthreads();
        if (valid) {
          colmajor::dot_column_acc<T, QT, true>(docs_t + c + static_cast<long long>(e0) * ld,
                                                ld, w, qs, dc, acc);
        }
      }
      if (valid) {
#pragma unroll
        for (int j = 0; j < QT; ++j) m[j] = fmaxf(m[j], acc[j]);
      }
    }
    if (p >= n_segs) return;
  }
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (j < qn) out[static_cast<long long>(q0 + j) * n_segs + p] = m[j];
  }
}

template <typename T, int QT>
cudaError_t launch(const void* docs_t, long long ld, const void* queries,
                   int n_q, int d, void* out, long long n_segs, int seg_rows,
                   long long limit, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  // the whole query tile where it fits, else chunks of kChunkD columns
  const int dp = (d + 3) & ~3;
  const int dc = static_cast<long long>(QT) * dp * sizeof(float) <= setup::kMaxSmemBytes
                     ? dp : kChunkD;
  const size_t smem = static_cast<size_t>(QT) * dc * sizeof(float);
  cudaError_t err =
      setup::allow_max_smem(segmax_cm_kernel<T, QT>, device, ready);
  if (err != cudaSuccess) return err;
  const int n_qt = (n_q + QT - 1) / QT;
  const long long blocks = (n_segs + kThreads - 1) / kThreads * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  segmax_cm_kernel<T, QT><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(
      static_cast<const T*>(docs_t), ld, static_cast<const T*>(queries), n_q,
      d, static_cast<float*>(out), n_segs, seg_rows, limit, n_qt, dc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* docs_t, long long ld, const void* queries,
                     int n_q, int d, void* out, long long n_segs,
                     int seg_rows, long long limit, int device,
                     cudaStream_t stream) {
  if (n_q <= 8) {
    return launch<T, 8>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows,
                        limit, device, stream);
  }
  return launch<T, 16>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows,
                       limit, device, stream);
}

}  // namespace

// docs_t [d, >= limit columns] with row stride ld (elements), queries
// [n_q, d] row-major, out [n_q, n_segs] fp32 with n_segs a multiple of
// 128. dtype: 0 = float32, 1 = bfloat16 (docs and queries alike).
// Columns >= limit are masked (the caller passes min(N, n_valid)).
// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on ``stream``.
extern "C" int segmax_cm_launch(const void* docs_t, long long ld,
                                const void* queries, int n_q, int d,
                                void* out, long long n_segs, int seg_rows,
                                long long limit, int dtype, int device,
                                void* stream) {
  if (n_q < 1 || d < 1 || seg_rows < 1 || seg_rows > 64 || n_segs < kLanes ||
      n_segs % kLanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch<float>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows,
                          limit, device, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(docs_t, ld, queries, n_q, d, out, n_segs,
                                  seg_rows, limit, device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
