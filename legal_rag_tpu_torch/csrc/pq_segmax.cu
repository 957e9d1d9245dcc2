// K2: 4-bit PQ segment max, phase 1 of the PQ capacity tier's top-k.
//
// Replaces the TPU kernel legal_rag_tpu/ops/pq.py _pq_segmax_kernel
// (pallas_call in pq_topk). A doc row is m packed bytes; byte b holds
// the codes of nibble subspaces 2b (low nibble) and 2b+1 (high nibble).
// With the per-query lookup table lut[q, s, c] (bf16, the values the TPU
// kernel reads), for doc rows r and queries q:
//
//   score[r, q] = sum over s < 2m of lut[q, s, nibble_s(codes[r])]
//   out[q, g]   = max over r in [8g, 8g+8) of
//                 (r < n_rows ? score[r, q] : -FLT_MAX)
//
// written query-major, [n_q, ceil(n_rows / 8)]; rows past n_rows in the
// last segment are never read. The TPU kernel builds one-hot matrices
// and multiplies them by the table on its matrix unit, a workaround for
// its compiler; here each lookup is a plain shared-memory read.
//
// What bounds it: a doc is m = 48 bytes, so at 3.35 TB/s device memory
// would allow ~70 G docs/s, while every doc costs 2m = 96 table lookups
// per query. Shared-memory reads (and the instructions around them)
// bound the kernel, not device memory. The design keeps the query
// tile's tables in shared memory as bf16 (2m * 16 * 2 = 3 KB a query at
// m = 48, so 64 queries take 192 KB), gives each thread one doc whose
// code bytes stay in registers across all queries of the tile, and
// reads one 16-entry table row per lookup: the 16 bf16 entries span 8
// consecutive banks, so the lanes of a warp never conflict. Sums run in
// fp32 over the subspaces in order; the max over a segment's 8 adjacent
// threads is taken with __shfl_xor_sync.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "setup.cuh"

namespace {

constexpr int kSegRows = 8;       // rows per segment (adjacent threads)
constexpr int kThreads = 512;     // threads (= docs) per block pass
constexpr int kMaxQTile = 64;     // queries per block (shared memory)
constexpr unsigned kFullMask = 0xffffffffu;

// bf16 is the upper half of an fp32: widening is a 16-bit shift
__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
pq_segmax_kernel(const uint8_t* __restrict__ codes,
                 const unsigned short* __restrict__ lut,   // [n_q, 2M, 16]
                 float* __restrict__ out, long long n_rows, int n_q) {
  constexpr int kSub = 2 * M;                 // nibble subspaces
  constexpr int kLut = kSub * 16;             // table entries per query
  constexpr int kWords = M / 4;               // code words per doc
  static_assert(M % 4 == 0, "code rows load as 32-bit words");

  extern __shared__ unsigned short tab[];    // [q_tile, 2M, 16]
  const int q0 = blockIdx.y * kMaxQTile;
  const int q_tile = min(kMaxQTile, n_q - q0);
  const unsigned short* src = lut + static_cast<long long>(q0) * kLut;
  for (int i = threadIdx.x; i < q_tile * kLut; i += kThreads) {
    tab[i] = src[i];
  }
  __syncthreads();

  const long long n_segs = (n_rows + kSegRows - 1) / kSegRows;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // every thread of a warp runs the same number of iterations (the
  // loop bound is a multiple of 32), so the shuffles see full warps
  const long long n_threads_total = n_segs * kSegRows;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       row - lane < n_threads_total; row += stride) {
    const bool valid = row < n_rows;
    uint32_t w[kWords];
    if (valid) {
      const uint32_t* r = reinterpret_cast<const uint32_t*>(codes + row * M);
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = __ldg(r + i);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 0;
    }
    const long long seg = row / kSegRows;
    for (int q = 0; q < q_tile; ++q) {
      const unsigned short* t = tab + q * kLut;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {       // 8 nibbles per word, in order
          const int s = i * 8 + b;
          const int c = (w[i] >> (4 * b)) & 0xF;
          acc += bf16_bits_to_float(t[s * 16 + c]);
        }
      }
      float v = valid ? acc : -FLT_MAX;
#pragma unroll
      for (int m = 1; m < kSegRows; m <<= 1) {
        v = fmaxf(v, __shfl_xor_sync(kFullMask, v, m));
      }
      if ((row & (kSegRows - 1)) == 0 && seg < n_segs) {
        out[static_cast<long long>(q0 + q) * n_segs + seg] = v;
      }
    }
  }
}

template <int M>
cudaError_t launch(const void* codes, const void* lut, float* out,
                   long long n_rows, int n_q, int device,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = pq_segmax_kernel<M>;
  const int q_tile = n_q < kMaxQTile ? n_q : kMaxQTile;
  const size_t smem = static_cast<size_t>(q_tile) * 2 * M * 16 *
                      sizeof(unsigned short);
  cudaError_t err = setup::allow_max_smem(kernel, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = setup::sm_count(device, &sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks: each stages its query tile's tables once, then
  // walks the rows with a grid stride
  const long long n_pad = (n_rows + kSegRows - 1) / kSegRows * kSegRows;
  long long blocks = (n_pad + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((n_q + kMaxQTile - 1) / kMaxQTile));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const unsigned short*>(lut), out, n_rows, n_q);
  return cudaGetLastError();
}

}  // namespace

// codes [n_rows, m] uint8 row-major, m in {8, 16, 32, 48} (rows load as
// 32-bit words: 4-byte aligned),
// lut [n_q, 2m, 16] bf16, out [n_q, ceil(n_rows / 8)] float32. Returns
// the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on ``stream``.
extern "C" int pq_segmax_launch(const void* codes, const void* lut,
                                float* out, long long n_rows, int m,
                                int n_q, int device, void* stream) {
  if (n_rows < 1 || n_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 8: err = launch<8>(codes, lut, out, n_rows, n_q, device, s); break;
    case 16: err = launch<16>(codes, lut, out, n_rows, n_q, device, s); break;
    case 32: err = launch<32>(codes, lut, out, n_rows, n_q, device, s); break;
    case 48: err = launch<48>(codes, lut, out, n_rows, n_q, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
