// K1: row-major segment max, phase 1 of the two-phase exact dense top-k.
//
// Replaces the TPU kernel legal_rag_tpu/ops/dense.py _segmax_rm_kernel
// (pallas_call in dense_topk_twophase_rm). For doc rows r and queries q:
//
//   out[q, s] = max over r in [8s, 8s+8) of
//               (r < n_valid ? dot(docs[r], queries[q]) : -FLT_MAX)
//
// written query-major, [n_q, n_rows / 8]. The [n_q, n_rows] score matrix
// never reaches device memory.
//
// What bounds it: at serving batches (n_q <= 8) each doc byte read feeds
// about 2 (fp32) or 4 (bf16) FLOP per query, far below the card's
// FLOP-per-byte balance, so the kernel is bound by device-memory
// bandwidth. The design streams every doc row exactly once per query
// tile with 16-byte coalesced loads, keeps the query tile in shared
// memory, and reduces both the dot products and the segment max in
// registers and warp shuffles.
//
// Layout: one warp owns one 8-row segment at a time, as two groups of
// 16 lanes. Lane l of group g = l / 16 works on rows g, g+2, g+4, g+6
// of the segment and, in each, on the 16-byte chunks c with
// c % 16 == l % 16: the 16 lanes of a group read 256 contiguous bytes
// of a row per load. Each lane widens its 4 row parts to fp32
// registers once and reuses them for every query of the tile, four
// queries at a time; every query value it reads from shared memory
// feeds 4 FMAs (one per row), so shared-memory bandwidth does not
// bound large query tiles.
// Up to 64 queries sit in shared memory as fp32; larger batches take
// several query tiles (gridDim.y), each a full pass over the docs.
//
// Numerics: fp32 docs use fp32 FMA (no tensor cores, so no TF32).
// bf16 docs take bf16 queries; both widen exactly to fp32, so every
// product is exact and the sum is accumulated in fp32.
//
// int8 (the 4x capacity tier): int8 docs and int8 queries, products
// summed in int32 by __dp4a (four int8 products per instruction), rows
// >= n_valid masked to -2^30 (below any real sum: |sum| <= 384 * 127^2),
// and the map is int32 [n_q, n_rows / 8]. The doc quantization scale
// is shared by each 8-row segment, so it commutes with the segment max
// and the caller dequantizes the small map. The split differs: a
// 384-byte int8 row is 24 chunks of 16 bytes, which do not spread over
// 16 lanes, so an int8 lane loads 8-byte chunks (3 per lane and row,
// 16 lanes still reading 128 contiguous bytes per load); the rest of
// the layout (4 rows per lane, 2 row groups per warp) is the same.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "setup.cuh"

namespace {

constexpr int kSegRows = 8;       // rows per segment
constexpr int kRows = 4;          // rows per lane
constexpr int kLanesPerRow = 16;  // lanes sharing one row
constexpr int kGroups = 32 / kLanesPerRow;   // row groups per warp
static_assert(kGroups * kRows == kSegRows, "a warp covers one segment");
constexpr int kWarps = 8;         // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQTile = 64;     // queries per block (shared memory)
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Widen one 16-byte chunk of a doc row into fp32 values; the null
// pointer argument only selects the overload by element type.
__device__ __forceinline__ void widen(const float*, uint4 r, float* x) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// a bf16 is the upper half of an fp32: widening is a 16-bit shift.
// Element 2i is the low half of word i (little-endian).
__device__ __forceinline__ void widen(const __nv_bfloat16*, uint4 r,
                                      float* x) {
  x[0] = __uint_as_float(r.x << 16);
  x[1] = __uint_as_float(r.x & 0xffff0000u);
  x[2] = __uint_as_float(r.y << 16);
  x[3] = __uint_as_float(r.y & 0xffff0000u);
  x[4] = __uint_as_float(r.z << 16);
  x[5] = __uint_as_float(r.z & 0xffff0000u);
  x[6] = __uint_as_float(r.w << 16);
  x[7] = __uint_as_float(r.w & 0xffff0000u);
}

// acc[j][i] = this lane's part of dot(row i, query j). ``x[i]`` holds
// the lane's kVals values of its row i; ``q`` points at query 0's value
// matching x[i][0]. Each query value read from shared memory feeds
// kRows FMAs (one per row), which is what keeps shared memory, not the
// FMA units, from bounding the kernel at large query tiles.
template <int QB, int D, int kElems, int kPerLane, int kVals>
__device__ __forceinline__ void dot_queries(const float (*x)[kVals],
                                            const float* q,
                                            float (*acc)[kRows]) {
#pragma unroll
  for (int j = 0; j < QB; ++j) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[j][i] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
#pragma unroll
    for (int e = 0; e < kElems; e += 4) {
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(
            q + j * D + t * kLanesPerRow * kElems + e);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float* v = x[i] + t * kElems + e;
          acc[j][i] = fmaf(v[0], a.x, acc[j][i]);
          acc[j][i] = fmaf(v[1], a.y, acc[j][i]);
          acc[j][i] = fmaf(v[2], a.z, acc[j][i]);
          acc[j][i] = fmaf(v[3], a.w, acc[j][i]);
        }
      }
    }
  }
}

// For QB queries: finish each row's dot product (sum over the row's
// kLanesPerRow lanes), mask rows >= n_valid, take the max over the
// lane's kRows rows and then over the warp's row groups (the segment's
// 8 rows), and store from lane 0.
// The masked value and the max of each accumulator type.
__device__ __forceinline__ float masked(float) { return -FLT_MAX; }
__device__ __forceinline__ int masked(int) { return -(1 << 30); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

template <int QB, typename Acc>
__device__ __forceinline__ void reduce_store(Acc (*acc)[kRows],
                                             const bool* valid, int lane,
                                             Acc* dst, long long n_segs) {
#pragma unroll
  for (int m = 1; m < kLanesPerRow; m <<= 1) {
#pragma unroll
    for (int j = 0; j < QB; ++j) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[j][i] += __shfl_xor_sync(kFullMask, acc[j][i], m);
      }
    }
  }
  const Acc neg = masked(Acc());
  Acc v[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    v[j] = neg;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      v[j] = vmax(v[j], valid[i] ? acc[j][i] : neg);
    }
  }
#pragma unroll
  for (int m = kLanesPerRow; m < 32; m <<= 1) {
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      v[j] = vmax(v[j], __shfl_xor_sync(kFullMask, v[j], m));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < QB; ++j) dst[j * n_segs] = v[j];
  }
}

constexpr int kQB = 4;            // queries per inner step

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
segmax_rm_kernel(const T* __restrict__ docs, const T* __restrict__ queries,
                 float* __restrict__ out, long long n_segs, int n_q,
                 long long n_valid) {
  constexpr int kElems = 16 / sizeof(T);           // values per chunk
  constexpr int kChunks = D / kElems;              // chunks per row
  static_assert(D % kElems == 0, "row must split into 16-byte chunks");
  static_assert(kChunks % kLanesPerRow == 0, "row must split over its lanes");
  constexpr int kPerLane = kChunks / kLanesPerRow; // chunks per lane per row
  constexpr int kVals = kPerLane * kElems;         // values per lane per row

  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);     // [q_tile, D] fp32

  const int q0 = blockIdx.y * kMaxQTile;
  const int q_tile = min(kMaxQTile, n_q - q0);
  const T* qsrc = queries + static_cast<long long>(q0) * D;
  for (int i = threadIdx.x; i < q_tile * D; i += kThreads) {
    qs[i] = to_float(qsrc[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanesPerRow;
  const int sub = lane % kLanesPerRow;
  const float* qlane = qs + sub * kElems;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long seg = static_cast<long long>(blockIdx.x) * kWarps + warp;
       seg < n_segs; seg += stride) {
    // this lane's rows of the segment, widened to fp32 once and reused
    // for every query of the tile
    float x[kRows][kVals];
    bool valid[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long row = seg * kSegRows + group + kGroups * i;
      const uint4* src = reinterpret_cast<const uint4*>(docs + row * D);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        widen(static_cast<const T*>(nullptr),
              __ldg(src + sub + kLanesPerRow * t), x[i] + t * kElems);
      }
      valid[i] = row < n_valid;
    }
    float* dst = out + static_cast<long long>(q0) * n_segs + seg;
    int q = 0;
    for (; q + kQB <= q_tile; q += kQB) {
      float acc[kQB][kRows];
      dot_queries<kQB, D, kElems, kPerLane, kVals>(x, qlane + q * D, acc);
      reduce_store<kQB, float>(acc, valid, lane, dst + q * n_segs, n_segs);
    }
    for (; q < q_tile; ++q) {
      float acc[1][kRows];
      dot_queries<1, D, kElems, kPerLane, kVals>(x, qlane + q * D, acc);
      reduce_store<1, float>(acc, valid, lane, dst + q * n_segs, n_segs);
    }
  }
}

// int8 docs and queries -> int32 map; layout in the file comment.
template <int D>
__global__ void __launch_bounds__(kThreads)
segmax_rm_i8_kernel(const int8_t* __restrict__ docs,
                    const int8_t* __restrict__ queries,
                    int* __restrict__ out, long long n_segs, int n_q,
                    long long n_valid) {
  constexpr int kChunkBytes = 8;                   // one uint2 load
  constexpr int kChunks = D / kChunkBytes;         // chunks per row
  static_assert(D % kChunkBytes == 0, "row must split into 8-byte chunks");
  static_assert(kChunks % kLanesPerRow == 0, "row must split over its lanes");
  constexpr int kPerLane = kChunks / kLanesPerRow; // chunks per lane per row

  extern __shared__ float4 smem[];
  uint2* qs = reinterpret_cast<uint2*>(smem);     // [q_tile, kChunks]

  const int q0 = blockIdx.y * kMaxQTile;
  const int q_tile = min(kMaxQTile, n_q - q0);
  const uint2* qsrc = reinterpret_cast<const uint2*>(
      queries + static_cast<long long>(q0) * D);
  for (int i = threadIdx.x; i < q_tile * kChunks; i += kThreads) {
    qs[i] = qsrc[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanesPerRow;
  const int sub = lane % kLanesPerRow;
  const uint2* qlane = qs + sub;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long seg = static_cast<long long>(blockIdx.x) * kWarps + warp;
       seg < n_segs; seg += stride) {
    // this lane's 4 rows of the segment, 4 int8 values per register
    uint2 x[kRows][kPerLane];
    bool valid[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long row = seg * kSegRows + group + kGroups * i;
      const uint2* src = reinterpret_cast<const uint2*>(docs + row * D);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        x[i][t] = __ldg(src + sub + kLanesPerRow * t);
      }
      valid[i] = row < n_valid;
    }
    int* dst = out + static_cast<long long>(q0) * n_segs + seg;
    int q = 0;
    for (; q + kQB <= q_tile; q += kQB) {
      int acc[kQB][kRows];
#pragma unroll
      for (int j = 0; j < kQB; ++j) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[j][i] = 0;
      }
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
#pragma unroll
        for (int j = 0; j < kQB; ++j) {
          const uint2 a = qlane[(q + j) * kChunks + t * kLanesPerRow];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[j][i] = __dp4a(static_cast<int>(x[i][t].x),
                               static_cast<int>(a.x), acc[j][i]);
            acc[j][i] = __dp4a(static_cast<int>(x[i][t].y),
                               static_cast<int>(a.y), acc[j][i]);
          }
        }
      }
      reduce_store<kQB, int>(acc, valid, lane, dst + q * n_segs, n_segs);
    }
    for (; q < q_tile; ++q) {
      int acc[1][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[0][i] = 0;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const uint2 a = qlane[q * kChunks + t * kLanesPerRow];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[0][i] = __dp4a(static_cast<int>(x[i][t].x),
                             static_cast<int>(a.x), acc[0][i]);
          acc[0][i] = __dp4a(static_cast<int>(x[i][t].y),
                             static_cast<int>(a.y), acc[0][i]);
        }
      }
      reduce_store<1, int>(acc, valid, lane, dst + q * n_segs, n_segs);
    }
  }
}

// Persistent blocks: each stages its query tile once, then its warps
// walk the segments with a grid stride.
template <typename In, typename Out>
cudaError_t launch_persistent(
    void (*kernel)(const In*, const In*, Out*, long long, int, long long),
    std::atomic<unsigned long long>& ready, size_t smem_per_query,
    const void* docs, const void* queries, void* out, long long n_rows,
    int n_q, long long n_valid, int device, cudaStream_t stream) {
  const long long n_segs = n_rows / kSegRows;
  const int q_tile = n_q < kMaxQTile ? n_q : kMaxQTile;
  const size_t smem = static_cast<size_t>(q_tile) * smem_per_query;
  cudaError_t err = setup::allow_max_smem(kernel, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = setup::sm_count(device, &sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  long long blocks = (n_segs + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((n_q + kMaxQTile - 1) / kMaxQTile));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(docs), static_cast<const In*>(queries),
      static_cast<Out*>(out), n_segs, n_q, n_valid);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* docs, const void* queries, void* out,
                   long long n_rows, int n_q, long long n_valid, int device,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  if constexpr (std::is_same<T, int8_t>::value) {
    // the query tile stays int8 in shared memory: D bytes a query
    return launch_persistent<int8_t, int>(
        segmax_rm_i8_kernel<D>, ready, D, docs, queries, out, n_rows, n_q,
        n_valid, device, stream);
  } else {
    return launch_persistent<T, float>(
        segmax_rm_kernel<T, D>, ready, D * sizeof(float), docs, queries,
        out, n_rows, n_q, n_valid, device, stream);
  }
}

template <typename T>
cudaError_t dispatch_dim(const void* docs, const void* queries, void* out,
                         long long n_rows, int d, int n_q, long long n_valid,
                         int dev, cudaStream_t stream) {
  switch (d) {
    case 128: return launch<T, 128>(docs, queries, out, n_rows, n_q, n_valid, dev, stream);
    case 256: return launch<T, 256>(docs, queries, out, n_rows, n_q, n_valid, dev, stream);
    case 384: return launch<T, 384>(docs, queries, out, n_rows, n_q, n_valid, dev, stream);
    case 512: return launch<T, 512>(docs, queries, out, n_rows, n_q, n_valid, dev, stream);
    case 768: return launch<T, 768>(docs, queries, out, n_rows, n_q, n_valid, dev, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 and 1 = bfloat16 (float32 map ``out``), 2 = int8
// (int32 map). n_rows must be a multiple of 8; docs [n_rows, d] and
// queries [n_q, d] row-major, 16-byte aligned. Returns the CUDA error
// of the launch (0 on success); the kernel runs asynchronously on
// ``stream``.
extern "C" int segmax_rm_launch(const void* docs, const void* queries,
                                void* out, long long n_rows, int d,
                                int n_q, long long n_valid, int dtype,
                                int device, void* stream) {
  if (n_rows % kSegRows != 0 || n_q < 1 || n_rows < kSegRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch_dim<float>(docs, queries, out, n_rows, d, n_q, n_valid,
                              device, s);
  } else if (dtype == 1) {
    err = dispatch_dim<__nv_bfloat16>(docs, queries, out, n_rows, d, n_q,
                                      n_valid, device, s);
  } else if (dtype == 2) {
    err = dispatch_dim<int8_t>(docs, queries, out, n_rows, d, n_q, n_valid,
                               device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
