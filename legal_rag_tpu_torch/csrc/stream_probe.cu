// X1: the stream probe, the achievable read rate of the doc matrix.
//
// Replaces the TPU kernel scripts/exp_dense_roofline.py stream_kernel
// (its pallas_call in the "stream" section), which walks the [D, bn]
// column blocks of the zero-padded docs_t [D, N_pad] in order and adds
// each block's max into a scalar. Here, for bf16 docs_t:
//
//   block_max[j] = max over the block's D x bn elements   (j = 0 .. nb-1)
//   total        = ((0 + block_max[0]) + block_max[1]) + ...   (fp32, in
//                  block order, the TPU scalar's sum)
//
// What bounds it: bytes. Every element is read once and feeds one max,
// so one pass over D * N_pad * 2 bytes at the memory rate is the bound.
// The TPU's sequential grid gives 16-123 blocks, too few to fill 132
// SMs, so each column block is split over many blocks of this launch:
// block (s, j) takes rows s, s + splits, ... of block j, its threads
// read 16-byte chunks of a row side by side (coalesced, several loads in
// flight a thread) and write one partial max. A second, one-block launch
// reduces each column block's partials (a max is exact in any order) and
// sums the maxima in order.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "setup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // 16-byte loads in flight a thread
constexpr int kFinishThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// bf16 halves of a 32-bit word as fp32 (exact: a bf16 is the upper half
// of an fp32)
__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float max8(uint4 v) {
  const float a = fmaxf(fmaxf(lo_bf16(v.x), hi_bf16(v.x)),
                        fmaxf(lo_bf16(v.y), hi_bf16(v.y)));
  const float b = fmaxf(fmaxf(lo_bf16(v.z), hi_bf16(v.z)),
                        fmaxf(lo_bf16(v.w), hi_bf16(v.w)));
  return fmaxf(a, b);
}

// docs: [d rows of ld16 16-byte chunks]; column block j is chunks
// [j * bn16, (j + 1) * bn16) of every row. partial[j * splits + s].
__global__ void __launch_bounds__(kThreads)
stream_partial_kernel(const uint4* __restrict__ docs, long long ld16, int d,
                      int bn16, int splits, float* __restrict__ partial) {
  __shared__ float warp_max[kThreads / 32];
  const int s = blockIdx.x;
  const int j = blockIdx.y;
  float m = -FLT_MAX;
  for (int e = s; e < d; e += splits) {
    const uint4* row = docs + e * ld16 + static_cast<long long>(j) * bn16;
    for (int c = threadIdx.x; c < bn16; c += kThreads * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cc = c + u * kThreads;
        v[u] = cc < bn16 ? __ldg(row + cc) : v[0];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, max8(v[u]));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
  }
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    partial[static_cast<long long>(j) * splits + s] = m;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
stream_finish_kernel(const float* __restrict__ partial, int splits, int nb,
                     float* __restrict__ block_max, float* __restrict__ total) {
  for (int j = threadIdx.x; j < nb; j += kFinishThreads) {
    const float* p = partial + static_cast<long long>(j) * splits;
    float m = p[0];
    for (int s = 1; s < splits; ++s) m = fmaxf(m, p[s]);
    block_max[j] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int j = 0; j < nb; ++j) t = __fadd_rn(t, block_max[j]);
    *total = t;
  }
}

}  // namespace

// docs_t [d, n_pad] bf16 with row stride ld (elements), 16-byte aligned,
// ld and block_n multiples of 8, n_pad a multiple of block_n. partial
// [nb * splits] fp32 scratch, block_max [nb] fp32, total [1] fp32 with
// nb = n_pad / block_n. Returns the CUDA error of the launches (0 on
// success); they run asynchronously on ``stream``.
extern "C" int stream_probe_launch(const void* docs_t, long long ld, int d,
                                   long long n_pad, int block_n, int splits,
                                   void* partial, void* block_max, void* total,
                                   int device, void* stream) {
  if (d < 1 || block_n < 8 || block_n % 8 != 0 || ld % 8 != 0 ||
      n_pad < block_n || n_pad % block_n != 0 || splits < 1 || splits > d ||
      n_pad / block_n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(n_pad / block_n);
  stream_partial_kernel<<<dim3(splits, nb), kThreads, 0, s>>>(
      static_cast<const uint4*>(docs_t), ld / 8, d, block_n / 8, splits,
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      static_cast<const float*>(partial), splits, nb,
      static_cast<float*>(block_max), static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}
