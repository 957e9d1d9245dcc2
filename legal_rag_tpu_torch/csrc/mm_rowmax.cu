// X2: the matmul probe, the cost of the tensor-core product on top of
// the stream.
//
// Replaces the TPU kernel scripts/exp_dense_roofline.py mm_kernel (its
// pallas_call in the "matmul" section): for each [D, bn] column block j
// of the zero-padded docs_t [D, N_pad], the [Q, D] x [D, bn] product in
// fp32 and its row max. The TPU kernel keeps only the last block's row
// max (its output block never moves); this kernel computes every
// block's, the work the TPU probe does:
//
//   out[q, j] = max over c in [j * bn, (j + 1) * bn) of
//               sum over e of q[q, e] * docs_t[e, c]       (bf16 in, fp32)
//
// What bounds it: bytes. At 64 queries each doc byte feeds 64 multiply-
// adds, below the card's balance of about 295 operations a byte for
// bf16, so one pass over docs_t at the memory rate is the bound; the
// probe measures how close the tensor cores' product keeps to it.
//
// Design. A block holds 64 queries ([64, D] bf16 in shared memory,
// staged once) and walks 128-column tiles of docs_t (a grid-stride loop
// over tiles). docs_t is n-contiguous, so a tile arrives as k-chunks of
// [32 k-rows, 128 columns] through a 4-stage cp.async ring (16-byte
// copies, rows padded to 272 bytes so that ldmatrix reads no two rows
// from one bank); ldmatrix.trans turns a [16 k, 16 n] piece into the
// k-contiguous B fragments of two mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). Each of the 4 warps computes all 64 queries against 32
// of the tile's columns (4 x 4 mma tiles, 64 fp32 accumulators a
// thread). A tile's row maxima reduce in registers, across the 4 lanes
// of a quad by shuffles and across the warps in shared memory, into a
// partial [Q, N_pad / 128]; a second launch takes the max over each
// block's bn / 128 partials (a max is exact in any order).
//
// Numerics: the products of bf16 values are exact in fp32; the tensor
// cores sum them in their own order, so scores can differ from an fp32
// GEMM's in the last bits.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "setup.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kM = 64;          // queries a block
constexpr int kN = 128;         // columns a tile
constexpr int kK = 32;          // depth of one staged k-chunk
constexpr int kStages = 4;
constexpr int kBPitch = kN + 8; // bf16 a staged row: 272 B
constexpr int kWarpN = kN / 4;  // columns a warp
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// queries [n_q, d] bf16, docs_t [d, n_tiles * kN] bf16 with row stride
// ld; partial [n_q, n_tiles] fp32. Block (x, y): queries [y * kM, ...),
// tiles x, x + gridDim.x, ...
__global__ void __launch_bounds__(kThreads)
mm_rowmax_tiles_kernel(const __nv_bfloat16* __restrict__ queries, int n_q,
                       int d, const __nv_bfloat16* __restrict__ docs_t,
                       long long ld, long long n_tiles,
                       float* __restrict__ partial) {
  extern __shared__ uint4 smem[];
  const int a_pitch = d + 8;                         // bf16 a query row
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + kM * a_pitch;           // [kStages][kK][kBPitch]
  float* red = reinterpret_cast<float*>(b_s + kStages * kK * kBPitch);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.y * kM;

  // the block's queries, zero rows past n_q
  const int chunks_a = d / 8;
  for (int i = tid; i < kM * chunks_a; i += kThreads) {
    const int r = i / chunks_a;
    const int c = i - r * chunks_a;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n_q) {
      v = *reinterpret_cast<const uint4*>(
          queries + static_cast<long long>(q0 + r) * d + c * 8);
    }
    *reinterpret_cast<uint4*>(a_s + r * a_pitch + c * 8) = v;
  }

  const int kc_n = d / kK;
  const long long my_tiles =
      blockIdx.x < n_tiles
          ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const long long total = my_tiles * kc_n;

  // k-chunk g: tile blockIdx.x + (g / kc_n) * gridDim.x, rows
  // (g % kc_n) * kK .. + kK; 512 16-byte copies, 4 a thread
  auto load_chunk = [&](long long g) {
    const long long tile = blockIdx.x + (g / kc_n) * gridDim.x;
    const int k0 = static_cast<int>(g % kc_n) * kK;
    __nv_bfloat16* dst = b_s + static_cast<int>(g % kStages) * kK * kBPitch;
    const __nv_bfloat16* src = docs_t + tile * kN;
#pragma unroll
    for (int i = 0; i < kK * kN / 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kN / 8);
      const int c = idx % (kN / 8);
      cp_async16(dst + r * kBPitch + c * 8,
                 src + static_cast<long long>(k0 + r) * ld + c * 8);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_chunk(s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;
  const int lcol = (lane / 16) * 8;

  for (long long g = 0; g < total; ++g) {
    cp_async_wait<kStages - 2>();   // chunk g has landed
    __syncthreads();                // and every warp is done with g - 1
    if (g + kStages - 1 < total) load_chunk(g + kStages - 1);
    cp_async_commit();

    const int kc = static_cast<int>(g % kc_n);
    const __nv_bfloat16* bs = b_s + static_cast<int>(g % kStages) * kK * kBPitch;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4(a[mt], a_s + (mt * 16 + lrow) * a_pitch + kc * kK + kk + lcol);
      }
      unsigned b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (kk + lrow) * kBPitch + warp * kWarpN +
                                 np * 16 + lcol);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }

    if (kc == kc_n - 1) {
      // the tile's row maxima: accumulators c0, c1 hold row lane / 4 and
      // c2, c3 row lane / 4 + 8 of each 16-row query tile
      const long long tile = blockIdx.x + (g / kc_n) * gridDim.x;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float lo = -FLT_MAX, hi = -FLT_MAX;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          lo = fmaxf(lo, fmaxf(acc[mt][nt][0], acc[mt][nt][1]));
          hi = fmaxf(hi, fmaxf(acc[mt][nt][2], acc[mt][nt][3]));
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          lo = fmaxf(lo, __shfl_xor_sync(kFullMask, lo, o));
          hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, o));
        }
        if (lane % 4 == 0) {
          red[warp * kM + mt * 16 + lane / 4] = lo;
          red[warp * kM + mt * 16 + lane / 4 + 8] = hi;
        }
      }
      __syncthreads();
      if (tid < kM && q0 + tid < n_q) {
        float m = red[tid];
#pragma unroll
        for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w * kM + tid]);
        partial[static_cast<long long>(q0 + tid) * n_tiles + tile] = m;
      }
    }
  }
  cp_async_wait<0>();
}

// out[q, j] = max of partial[q, j * tpb .. (j + 1) * tpb)
__global__ void mm_rowmax_blocks_kernel(const float* __restrict__ partial,
                                        int n_q, long long n_tiles, int tpb,
                                        int nb, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_q) * nb) return;
  const int q = static_cast<int>(i / nb);
  const int j = static_cast<int>(i % nb);
  const float* p = partial + q * n_tiles + static_cast<long long>(j) * tpb;
  float m = p[0];
  for (int t = 1; t < tpb; ++t) m = fmaxf(m, p[t]);
  out[i] = m;
}

}  // namespace

// queries [n_q, d] bf16 contiguous; docs_t [d, n_pad] bf16 with row
// stride ld (elements); both 16-byte aligned, d a multiple of 32 up to
// 1024, ld a multiple of 8, block_n a multiple of 128, n_pad a multiple
// of block_n. partial [n_q, n_pad / 128] fp32 scratch, out [n_q, nb]
// fp32 with nb = n_pad / block_n; grid_x blocks walk the tiles. Returns
// the CUDA error of the launches (0 on success); they run asynchronously
// on ``stream``.
extern "C" int mm_rowmax_launch(const void* queries, int n_q, int d,
                                const void* docs_t, long long ld,
                                long long n_pad, int block_n, int grid_x,
                                void* partial, void* out, int device,
                                void* stream) {
  if (n_q < 1 || d < kK || d % kK != 0 || d > 1024 || ld % 8 != 0 ||
      block_n < kN || block_n % kN != 0 || n_pad < block_n ||
      n_pad % block_n != 0 || grid_x < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kM) * (d + 8) * 2 +
                      static_cast<size_t>(kStages) * kK * kBPitch * 2 +
                      static_cast<size_t>(kThreads / 32) * kM * sizeof(float);
  if (smem > static_cast<size_t>(setup::kMaxSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = setup::allow_max_smem(mm_rowmax_tiles_kernel, device, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = n_pad / kN;
  const dim3 grid(static_cast<unsigned>(grid_x), (n_q + kM - 1) / kM);
  mm_rowmax_tiles_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(queries), n_q, d,
      static_cast<const __nv_bfloat16*>(docs_t), ld, n_tiles,
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = static_cast<int>(n_pad / block_n);
  const long long n_out = static_cast<long long>(n_q) * nb;
  const int threads = 256;
  mm_rowmax_blocks_kernel<<<static_cast<unsigned>((n_out + threads - 1) / threads),
                            threads, 0, s>>>(
      static_cast<const float*>(partial), n_q, n_tiles, block_n / kN, nb,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
