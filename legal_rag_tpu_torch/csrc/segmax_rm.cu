// K1: row-major segment max, phase 1 of the two-phase exact dense top-k.
//
// Replaces the TPU kernel legal_rag_tpu/ops/dense.py _segmax_rm_kernel
// (pallas_call in dense_topk_twophase_rm). For doc rows r and queries q:
//
//   out[q, s] = max over r in [s * sr, (s + 1) * sr) of
//               (r < n_valid ? dot(docs[r], queries[q]) : NEG)
//
// written query-major, [n_q, n_rows / sr]. NEG is -FLT_MAX for fp32 and
// bf16 and -2^30 for int8 (int8 docs and queries, int32 sums and map;
// the doc quantization scale is shared by each segment, so it commutes
// with the max and the caller dequantizes the small map). The
// [n_q, n_rows] score matrix never reaches device memory.
//
// Two kernels, chosen by shape in the wrapper (ops/segmax_rm.py):
//
// - segmax_rm_kernel / segmax_rm_i8_kernel, on the CUDA cores, fp32 and
//   int8, for small batches (sr = 8, D in 128..768). At a few queries
//   each doc byte feeds 2-4 FLOP a query, far below the card's
//   FLOP-per-byte balance: device memory bounds it, and this layout
//   streams it near the rate (below).
// - segmax_rm_tc_kernel, on the tensor cores (mma.sync), for every
//   other shape: any D, sr 1-64, query tiles of 8 to 64 (larger batches
//   take several tiles). At 64 queries the CUDA-core kernel's FMAs and
//   its 17 shuffles a query and segment cost more than the read; on the
//   tensor cores a fragment sums the whole dot product and a segment max
//   takes 0-3 shuffles (its own note, further down).
//
// The CUDA-core layout: one warp owns one 8-row segment at a time, as
// two groups of 16 lanes. Lane l of group g = l / 16 works on rows g,
// g+2, g+4, g+6 of the segment and, in each, on the 16-byte chunks c
// with c % 16 == l % 16: the 16 lanes of a group read 256 contiguous
// bytes of a row per load. Each lane widens its 4 row parts to fp32
// registers once and reuses them for every query of the tile, four
// queries at a time; every query value it reads from shared memory
// feeds 4 FMAs (one per row). Up to 64 queries sit in shared memory as
// fp32; larger batches take several query tiles (gridDim.y). fp32 sums
// by FMA, int8 by __dp4a; a 384-byte int8 row is 24 chunks of 16
// bytes, which do not spread over 16 lanes, so an int8 lane loads
// 8-byte chunks (3 per lane and row).

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
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

// One 16-byte chunk of an fp32 doc row as four values.
__device__ __forceinline__ void widen(uint4 r, float* x) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
segmax_rm_kernel(const float* __restrict__ docs,
                 const float* __restrict__ queries, float* __restrict__ out,
                 long long n_segs, int n_q, long long n_valid) {
  constexpr int kElems = 4;                        // values per chunk
  constexpr int kChunks = D / kElems;              // chunks per row
  static_assert(D % kElems == 0, "row must split into 16-byte chunks");
  static_assert(kChunks % kLanesPerRow == 0, "row must split over its lanes");
  constexpr int kPerLane = kChunks / kLanesPerRow; // chunks per lane per row
  constexpr int kVals = kPerLane * kElems;         // values per lane per row

  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);     // [q_tile, D] fp32

  const int q0 = blockIdx.y * kMaxQTile;
  const int q_tile = min(kMaxQTile, n_q - q0);
  const float* qsrc = queries + static_cast<long long>(q0) * D;
  for (int i = threadIdx.x; i < q_tile * D; i += kThreads) {
    qs[i] = qsrc[i];
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
    // this lane's rows of the segment, in registers once and reused for
    // every query of the tile
    float x[kRows][kVals];
    bool valid[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long row = seg * kSegRows + group + kGroups * i;
      const uint4* src = reinterpret_cast<const uint4*>(docs + row * D);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        widen(__ldg(src + sub + kLanesPerRow * t), x[i] + t * kElems);
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
    return launch_persistent<float, float>(
        segmax_rm_kernel<D>, ready, D * sizeof(float), docs, queries, out,
        n_rows, n_q, n_valid, device, stream);
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

// ---------------------------------------------------------------------
// The tensor-core path: any D, seg_rows 1-64, query tiles of 8 to 64.
//
// The row-major docs are mma.sync's A operand as they lie (rows = docs,
// depth = D) and the row-major queries its column-major B operand, so
// neither is copied or transposed. A block of 4 warps walks tiles of BM
// doc rows (a grid-stride loop over tiles); each tile arrives as chunks
// of [BM rows, 128 bytes of depth] through a cp.async ring (rows padded
// so that fragment loads hit distinct banks; bytes past a row's end and
// rows past n_rows are zero-filled, so the depth tail adds nothing).
// Warp (wm, wn) of a WM x WN grid computes 64 doc rows (4 m-tiles)
// against NT * 8 queries (QT = WN * NT * 8 a block). Every 32 bytes of
// depth is one mma step:
//   - bf16: m16n8k16, bf16 in, fp32 accumulate (products exact, sums in
//     the tensor cores' order);
//   - fp32: 3xTF32 m16n8k8 (lo*hi + hi*lo + hi*hi), each value split
//     by truncation (mma.cuh split_tf32_trunc: a logic operation in
//     place of two rounding conversions),
//     fragments by plain 8-byte loads with the k index permuted inside
//     each k8 step alike for both operands (logical t and t + 4 are
//     physical 2t and 2t + 1), which leaves every sum unchanged;
//   - int8: m16n8k32, int32 accumulate, exact (bit-equal to the plain
//     version).
// bf16 and int8 fragments come from ldmatrix (an int8 row of 16 bytes
// is 8 16-bit elements, the m16n8k32 layout).
//
// The segment max comes straight from the accumulators: c0, c1 hold
// row g = lane / 4 and c2, c3 row g + 8 of each m-tile, so a segment of
// 2, 4 or 8 rows is a max over lane groups (shfl_xor 4, 8, 16); 16 also
// folds c0/c2, 32 and 64 fold m-tiles in registers. Rows >= n_valid are
// masked first.
//
// The queries sit in shared memory for the block's life when they fit
// ([QT, D] padded to 128 bytes of depth); otherwise each ring stage also
// carries the tile's [QT, 128 bytes] query chunk, so D has no limit.

namespace tc {

constexpr int kThreads = 128;     // 4 warps
constexpr int kChunk = 128;       // bytes of depth a staged chunk holds
constexpr int kStep = 32;         // bytes of depth one mma step takes
constexpr int kMT = 4;            // m-tiles a warp: 64 rows

// Row padding of a staged chunk: fp32 fragments are 8-byte loads by 8
// row groups, which need rows 8 words apart modulo 32 banks (pitch 160
// bytes); ldmatrix reads 16-byte rows and needs them 4 words apart
// (pitch 144 bytes).
template <typename T>
__host__ __device__ constexpr int pad() { return sizeof(T) == 4 ? 32 : 16; }
template <typename T>
__host__ __device__ constexpr int pitch() { return kChunk + pad<T>(); }

// The accumulator type and the value of a masked row.
template <typename T>
struct Acc { using type = float; };
template <>
struct Acc<int8_t> { using type = int; };
__device__ __forceinline__ float masked_acc(float) { return -FLT_MAX; }
__device__ __forceinline__ int masked_acc(int) { return -(1 << 30); }

// Block shape: BM doc rows a tile (WM warps of 64 rows); the ring's
// stages.
__host__ __device__ constexpr int block_rows(int qt) { return qt <= 32 ? 256 : 128; }
constexpr int kStages = 3;

long long smem_bytes(int elt, int d, int qt, int stream_q) {
  const long long p = kChunk + (elt == 4 ? 32 : 16);
  const long long bm = block_rows(qt);
  const long long dpb = (static_cast<long long>(d) * elt + kChunk - 1) / kChunk * kChunk;
  if (stream_q) return kStages * (bm + qt) * p;
  return kStages * bm * p + qt * (dpb + (elt == 4 ? 32 : 16));
}

// Copies bytes [b0, b0 + nb) of rows [r0, r0 + rows) of a row-major
// matrix (row_bytes a row, n_src rows) into dst, rows ``dpitch`` bytes
// apart; bytes past a row's end and rows past n_src are zero. VEC 16, 8
// or 4: asynchronous copies (the caller commits and waits); 0: byte
// loads (rows whose length or start is not 4-byte aligned).
template <int VEC>
__device__ __forceinline__ void copy_rows(char* dst, int dpitch,
                                          const char* src, long long row_bytes,
                                          long long r0, int rows,
                                          long long n_src, long long b0,
                                          int nb) {
  constexpr int kUnit = VEC > 0 ? VEC : 1;
  const int per_row = nb / kUnit;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kUnit;
    const long long row = r0 + r;
    const long long left = row < n_src ? row_bytes - (b0 + c) : 0;
    char* to = dst + r * dpitch + c;
    const char* from = src + row * row_bytes + b0 + c;
    if constexpr (VEC > 0) {
      const int bytes = left <= 0 ? 0 : left >= VEC ? VEC : static_cast<int>(left);
      mma::cp_async<VEC>(to, bytes > 0 ? from : src, bytes);
    } else {
      *to = left > 0 ? __ldg(from) : 0;
    }
  }
}

__device__ __forceinline__ void copy_rows_any(int vec, char* dst, int dpitch,
                                              const char* src,
                                              long long row_bytes, long long r0,
                                              int rows, long long n_src,
                                              long long b0, int nb) {
  switch (vec) {
    case 16: copy_rows<16>(dst, dpitch, src, row_bytes, r0, rows, n_src, b0, nb); break;
    case 8: copy_rows<8>(dst, dpitch, src, row_bytes, r0, rows, n_src, b0, nb); break;
    case 4: copy_rows<4>(dst, dpitch, src, row_bytes, r0, rows, n_src, b0, nb); break;
    default: copy_rows<0>(dst, dpitch, src, row_bytes, r0, rows, n_src, b0, nb); break;
  }
}

// One staged chunk's products (kChunk / kStep mma steps) into acc.
// ``a`` points at the warp's first doc row of the stage, ``b`` at its
// first query row (pitches in bytes).
template <int NT>
__device__ __forceinline__ void chunk_mma(const char* a, int ap, const char* b,
                                          int bp, float (&acc)[kMT][NT][4],
                                          const __nv_bfloat16*) {
  const int lane = threadIdx.x & 31;
  const char* a_l = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * ap + (lane >> 4) * 16;
  const char* b_l = b + ((lane & 7) + (lane >> 4) * 8) * bp + ((lane >> 3) & 1) * 16;
  const char* b_l2 = b + (lane & 7) * bp + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int s = 0; s < kChunk; s += kStep) {
    unsigned af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) mma::ldmatrix_x4(af[mt], a_l + mt * 16 * ap + s);
    unsigned bf[NT][2];
#pragma unroll
    for (int p = 0; p + 1 < NT; p += 2) {
      unsigned r[4];
      mma::ldmatrix_x4(r, b_l + p * 8 * bp + s);
      bf[p][0] = r[0];
      bf[p][1] = r[1];
      bf[p + 1][0] = r[2];
      bf[p + 1][1] = r[3];
    }
    if constexpr (NT % 2 == 1) {
      mma::ldmatrix_x2(bf[NT - 1], b_l2 + (NT - 1) * 8 * bp + s);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

template <int NT>
__device__ __forceinline__ void chunk_mma(const char* a, int ap, const char* b,
                                          int bp, int (&acc)[kMT][NT][4],
                                          const int8_t*) {
  const int lane = threadIdx.x & 31;
  const char* a_l = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * ap + (lane >> 4) * 16;
  const char* b_l = b + ((lane & 7) + (lane >> 4) * 8) * bp + ((lane >> 3) & 1) * 16;
  const char* b_l2 = b + (lane & 7) * bp + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int s = 0; s < kChunk; s += kStep) {
    unsigned af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) mma::ldmatrix_x4(af[mt], a_l + mt * 16 * ap + s);
    unsigned bf[NT][2];
#pragma unroll
    for (int p = 0; p + 1 < NT; p += 2) {
      unsigned r[4];
      mma::ldmatrix_x4(r, b_l + p * 8 * bp + s);
      bf[p][0] = r[0];
      bf[p][1] = r[1];
      bf[p + 1][0] = r[2];
      bf[p + 1][1] = r[3];
    }
    if constexpr (NT % 2 == 1) {
      mma::ldmatrix_x2(bf[NT - 1], b_l2 + (NT - 1) * 8 * bp + s);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma::mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

template <int NT>
__device__ __forceinline__ void chunk_mma(const char* a, int ap, const char* b,
                                          int bp, float (&acc)[kMT][NT][4],
                                          const float*) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const char* a_l = a + g * ap + 8 * t;
  const char* b_l = b + g * bp + 8 * t;
#pragma unroll
  for (int s = 0; s < kChunk; s += kStep) {
    unsigned ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float2 x0 = *reinterpret_cast<const float2*>(a_l + mt * 16 * ap + s);
      const float2 x1 = *reinterpret_cast<const float2*>(a_l + (mt * 16 + 8) * ap + s);
      mma::split_tf32_trunc(x0.x, ah[mt][0], al[mt][0]);   // (g, t)
      mma::split_tf32_trunc(x1.x, ah[mt][1], al[mt][1]);   // (g + 8, t)
      mma::split_tf32_trunc(x0.y, ah[mt][2], al[mt][2]);   // (g, t + 4)
      mma::split_tf32_trunc(x1.y, ah[mt][3], al[mt][3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 y = *reinterpret_cast<const float2*>(b_l + nt * 8 * bp + s);
      unsigned bh0, bl0, bh1, bl1;
      mma::split_tf32_trunc(y.x, bh0, bl0);                // (k t, n g)
      mma::split_tf32_trunc(y.y, bh1, bl1);                // (k t + 4, n g)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma::mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
        mma::mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
        mma::mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
}

template <typename V>
__device__ __forceinline__ V vmax2(V a, V b) { return a > b ? a : b; }

// A finished tile: mask rows >= n_valid, reduce each segment of
// seg_rows rows to its max (module note) and store it, then zero acc.
// row0: the warp's first doc row; qc: its first query column (global).
template <int NT, typename V>
__device__ __forceinline__ void store_segments(V (&acc)[kMT][NT][4],
                                               long long row0, int qc, int n_q,
                                               long long n_valid, int seg_rows,
                                               long long n_segs, V* out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const V neg = masked_acc(V());
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + mt * 16 + g + 8 * h >= n_valid) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[mt][nt][2 * h] = neg;
          acc[mt][nt][2 * h + 1] = neg;
        }
      }
    }
  }
  // across the lane groups that hold a segment's rows
  for (int x = 4; x < 32 && (x >> 2) < seg_rows; x <<= 1) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = vmax2(acc[mt][nt][i], __shfl_xor_sync(kFullMask, acc[mt][nt][i], x));
  }
  if (seg_rows >= 16) {         // rows g and g + 8 of an m-tile
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] = vmax2(acc[mt][nt][0], acc[mt][nt][2]);
        acc[mt][nt][1] = vmax2(acc[mt][nt][1], acc[mt][nt][3]);
      }
  }
  if (seg_rows >= 32) {         // m-tiles 0 + 1 and 2 + 3
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[0][nt][i] = vmax2(acc[0][nt][i], acc[1][nt][i]);
        acc[2][nt][i] = vmax2(acc[2][nt][i], acc[3][nt][i]);
      }
  }
  if (seg_rows >= 64) {         // all four
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) acc[0][nt][i] = vmax2(acc[0][nt][i], acc[2][nt][i]);
  }
  const int sr8 = seg_rows < 8 ? seg_rows : 8;
  if (g % sr8 == 0) {
    const int mt_step = seg_rows > 16 ? seg_rows / 16 : 1;
    const int halves = seg_rows >= 16 ? 1 : 2;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt % mt_step != 0) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= halves) continue;
        const long long seg = (row0 + mt * 16 + g + 8 * h) / seg_rows;
        if (seg >= n_segs) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = qc + nt * 8 + 2 * t + j;
            if (q < n_q) out[static_cast<long long>(q) * n_segs + seg] = acc[mt][nt][2 * h + j];
          }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = V(0);
}

// Block (x, y): query tile y (QT queries), doc tiles x, x + gridDim.x,
// ... of BM = WM * 64 rows. out [n_q, n_rows / seg_rows].
template <typename T, int WM, int NT>
__global__ void __launch_bounds__(kThreads)
segmax_rm_tc_kernel(const T* __restrict__ docs, const T* __restrict__ queries,
                    typename Acc<T>::type* __restrict__ out, long long n_rows,
                    int d, int n_q, long long n_valid, int seg_rows,
                    int stream_q, int vec_d, int vec_q) {
  using V = typename Acc<T>::type;
  constexpr int WN = 4 / WM;
  constexpr int QT = WN * NT * 8;
  constexpr int BM = WM * 64;
  constexpr int kPitch = pitch<T>();
  static_assert(block_rows(QT) == BM, "block shape");
  extern __shared__ uint4 smem[];
  char* ring = reinterpret_cast<char*>(smem);
  const int stage_bytes = (BM + (stream_q ? QT : 0)) * kPitch;
  char* q_res = ring + kStages * stage_bytes;        // resident queries
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  const int dpb = static_cast<int>((row_bytes + kChunk - 1) / kChunk * kChunk);
  const int q_pitch = dpb + pad<T>();
  const int q0 = blockIdx.y * QT;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const char* dsrc = reinterpret_cast<const char*>(docs);
  const char* qsrc = reinterpret_cast<const char*>(queries);

  if (!stream_q) {
    copy_rows_any(vec_q, q_res, q_pitch, qsrc, row_bytes, q0, QT, n_q, 0, dpb);
  }
  const int kc_n = dpb / kChunk;
  const long long n_tiles = (n_rows + BM - 1) / BM;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const long long total = my_tiles * kc_n;

  auto load_chunk = [&](long long g) {
    const long long tile = blockIdx.x + (g / kc_n) * gridDim.x;
    const long long b0 = (g % kc_n) * kChunk;
    char* st = ring + static_cast<int>(g % kStages) * stage_bytes;
    copy_rows_any(vec_d, st, kPitch, dsrc, row_bytes, tile * BM, BM, n_rows, b0, kChunk);
    if (stream_q) {
      copy_rows_any(vec_q, st + BM * kPitch, kPitch, qsrc, row_bytes, q0, QT,
                    n_q, b0, kChunk);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_chunk(s);
    mma::cp_async_commit();
  }

  V acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = V(0);

  const long long n_segs = n_rows / seg_rows;
  for (long long g = 0; g < total; ++g) {
    mma::cp_async_wait<kStages - 2>();   // chunk g has landed
    __syncthreads();                     // and every warp is done with g - 1
    if (g + kStages - 1 < total) load_chunk(g + kStages - 1);
    mma::cp_async_commit();

    const int kc = static_cast<int>(g % kc_n);
    const char* st = ring + static_cast<int>(g % kStages) * stage_bytes;
    const char* a = st + wm * 64 * kPitch;
    const char* b = stream_q ? st + (BM + wn * NT * 8) * kPitch
                             : q_res + wn * NT * 8 * q_pitch + kc * kChunk;
    chunk_mma<NT>(a, kPitch, b, stream_q ? kPitch : q_pitch, acc,
                  static_cast<const T*>(nullptr));
    if (kc == kc_n - 1) {
      const long long tile = blockIdx.x + (g / kc_n) * gridDim.x;
      store_segments<NT, V>(acc, tile * BM + wm * 64, q0 + wn * NT * 8, n_q,
                            n_valid, seg_rows, n_segs, out);
    }
  }
  mma::cp_async_wait<0>();
}

template <typename T, int WM, int NT>
cudaError_t launch_tc(const void* docs, const void* queries, void* out,
                      long long n_rows, int d, int n_q, long long n_valid,
                      int seg_rows, int stream_q, int vec_d, int vec_q,
                      size_t smem, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = segmax_rm_tc_kernel<T, WM, NT>;
  cudaError_t err = setup::allow_max_smem(kernel, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = setup::sm_count(device, &sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  constexpr int QT = (4 / WM) * NT * 8;
  const long long n_tiles = (n_rows + WM * 64 - 1) / (WM * 64);
  const long long n_qt = (n_q + QT - 1) / QT;
  // persistent blocks: as many as the card holds, shared among the
  // query tiles
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = (blocks + n_qt - 1) / n_qt;
  if (blocks > n_tiles) blocks = n_tiles;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_qt));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(docs), static_cast<const T*>(queries),
      static_cast<typename Acc<T>::type*>(out), n_rows, d, n_q, n_valid,
      seg_rows, stream_q, vec_d, vec_q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tile(int qt, const void* docs, const void* queries,
                          void* out, long long n_rows, int d, int n_q,
                          long long n_valid, int seg_rows, int stream_q,
                          int vec_d, int vec_q, size_t smem, int device,
                          cudaStream_t s) {
  switch (qt) {
    case 8: return launch_tc<T, 4, 1>(docs, queries, out, n_rows, d, n_q, n_valid, seg_rows, stream_q, vec_d, vec_q, smem, device, s);
    case 16: return launch_tc<T, 4, 2>(docs, queries, out, n_rows, d, n_q, n_valid, seg_rows, stream_q, vec_d, vec_q, smem, device, s);
    case 32: return launch_tc<T, 4, 4>(docs, queries, out, n_rows, d, n_q, n_valid, seg_rows, stream_q, vec_d, vec_q, smem, device, s);
    case 64: return launch_tc<T, 2, 4>(docs, queries, out, n_rows, d, n_q, n_valid, seg_rows, stream_q, vec_d, vec_q, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// The CUDA-core path. dtype: 0 = float32 (float32 map ``out``), 2 = int8
// (int32 map); d 128, 256, 384, 512 or 768. n_rows must be a multiple
// of 8; docs [n_rows, d] and queries [n_q, d] row-major, 16-byte
// aligned. Returns the CUDA error
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
  } else if (dtype == 2) {
    err = dispatch_dim<int8_t>(docs, queries, out, n_rows, d, n_q, n_valid,
                               device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the tensor-core path, bytes, for dtype (0 =
// float32, 1 = bfloat16, 2 = int8), dimension d, query tile qt and
// whether the queries stream through the ring.
extern "C" int segmax_rm_tc_smem_bytes(int dtype, int d, int qt, int stream_q) {
  return static_cast<int>(tc::smem_bytes(dtype == 0 ? 4 : dtype == 1 ? 2 : 1,
                                         d, qt, stream_q));
}

// The tensor-core path: docs [n_rows, d] and queries [n_q, d] row-major
// (any d >= 1), n_rows a multiple of seg_rows (1, 2, 4, 8, 16, 32 or 64);
// out [n_q, n_rows / seg_rows] (float32, or int32 for int8). qt (8, 16,
// 32 or 64) queries a block; stream_q: queries through the ring
// instead of resident; vec_d / vec_q: the copy width (16, 8, 4, or 0 for
// byte loads) that the docs' / queries' rows and base address allow.
// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on ``stream``.
extern "C" int segmax_rm_tc_launch(const void* docs, const void* queries,
                                   void* out, long long n_rows, int d, int n_q,
                                   long long n_valid, int seg_rows, int dtype,
                                   int qt, int stream_q, int vec_d, int vec_q,
                                   int device, void* stream) {
  const bool pow2 = seg_rows >= 1 && seg_rows <= 64 && (seg_rows & (seg_rows - 1)) == 0;
  if (!pow2 || n_rows < seg_rows || n_rows % seg_rows != 0 || n_q < 1 ||
      d < 1 || (dtype < 0 || dtype > 2) ||
      (n_q + qt - 1) / qt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = tc::smem_bytes(dtype == 0 ? 4 : dtype == 1 ? 2 : 1,
                                        d, qt, stream_q);
  if (smem > setup::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == 0) {
    err = tc::dispatch_tile<float>(qt, docs, queries, out, n_rows, d, n_q, n_valid,
                                   seg_rows, stream_q, vec_d, vec_q, sm, device, s);
  } else if (dtype == 1) {
    err = tc::dispatch_tile<__nv_bfloat16>(qt, docs, queries, out, n_rows, d, n_q,
                                           n_valid, seg_rows, stream_q, vec_d,
                                           vec_q, sm, device, s);
  } else {
    err = tc::dispatch_tile<int8_t>(qt, docs, queries, out, n_rows, d, n_q,
                                    n_valid, seg_rows, stream_q, vec_d, vec_q, sm,
                                    device, s);
  }
  return static_cast<int>(err);
}
