// K2: 4-bit PQ segment max, phase 1 of the PQ capacity tier's top-k.
//
// Replaces the TPU kernel legal_rag_tpu/ops/pq.py _pq_segmax_kernel
// (pallas_call in pq_topk). A doc row is m packed bytes (m % 4 == 0);
// byte b holds the codes of nibble subspaces 2b (low nibble) and 2b+1
// (high nibble). With the per-query lookup table lut[q, s, c] (bf16, the
// values the TPU kernel reads), for doc rows r and queries q:
//
//   score[r, q] = sum over s < 2m of lut[q, s, nibble_s(codes[r])]
//   out[q, g]   = max over r in [8g, 8g+8) of
//                 (r < n_rows ? score[r, q] : -FLT_MAX)
//
// written query-major, [n_q, ceil(n_rows / 8)].
//
// What bounds it: a doc is m bytes, so device memory would allow ~70 G
// docs/s at m = 48, while every doc costs 2m table entries per query.
// The work, not the bytes, bounds it. A table lookup per (doc, query,
// subspace) costs ~5 instructions; this kernel computes the same sum as
// the TPU kernel does, as a one-hot matrix times the table, on the
// tensor cores:
//
//   - A, [16 docs, 16 codes] of one subspace, is the one-hot of the
//     docs' nibbles, built in registers (mma.sync m16n8k16's A fragment:
//     a lane holds rows g and g + 8, codes 2t, 2t+1, 2t+8 and 2t+9, so
//     two compares a row give its four bf16 pairs);
//   - B, [16 codes, 8 queries], is the subspace's slice of the tables,
//     [q, 2m * 16] bf16 in shared memory, read by ldmatrix (k-contiguous
//     per query, as the B operand wants it);
//   - the fp32 accumulator adds one table entry a step (the one-hot
//     products are exact), and each A fragment serves every query of
//     the tile.
//
// A block of 8 warps walks tiles of 256 docs (a grid-stride loop); a
// warp takes 32 docs (two m-tiles) against the query tile's QT = 8 * NT
// queries. The codes of a tile arrive as one contiguous [256, m] run by
// cp.async (two stages, or one where shared memory is short); the
// tables of the query tile stay resident, so QT shrinks as m grows
// (2m * 16 * 2 bytes a query). The segment max is a max over the lane
// groups that hold a segment's 8 rows (shfl_xor 4, 8, 16), rows past
// n_rows masked first. A query tile past the last query skips its
// empty n-tiles.
//
// Past m = 300 not even 8 queries' tables fit beside the codes, so
// wider codes go to a second kernel, pq_segmax_lookup_kernel: a thread a
// doc, one shared-memory table read per (doc, query, subspace) (the 16
// bf16 entries of a table row span 8 banks, so a warp's lanes never
// conflict), the segment max over 8 adjacent threads by shuffles. The
// wrapper picks by the code width.
//
// Numerics: the sums of bf16 entries run in fp32, in the tensor cores'
// order or in subspace order, so they can differ from the plain
// version's sums in the last bits.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "mma.cuh"
#include "setup.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kTile = 256;        // docs a block tile (32 a warp)
constexpr int kMT = 2;            // m-tiles a warp
constexpr int kLookupThreads = 512;   // the lookup kernel: a doc a thread
constexpr int kLookupMaxQ = 64;       // its most queries a block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kOne = 0x3f80u;          // bf16 1.0

__host__ __device__ constexpr long long table_pitch(int m) { return 64LL * m + 16; }

long long smem_bytes(int m, int qt, int stages) {
  return qt * table_pitch(m) + static_cast<long long>(stages) * kTile * m;
}

// The A fragment of one subspace for a row whose nibble is c: bf16
// pairs (codes 2t, 2t+1) and (2t+8, 2t+9), 1.0 where the code is c.
// A clamped funnel shift places bf16 1.0 in the low half (c = 2t), the
// high half (c = 2t + 1) or nowhere (a shift past 32, which a negative
// distance also is as unsigned).
__device__ __forceinline__ void one_hot(unsigned c, unsigned t, unsigned& lo,
                                        unsigned& hi) {
  const unsigned d = (c - 2u * t) << 4;
  lo = __funnelshift_lc(0u, kOne, d);
  hi = __funnelshift_lc(0u, kOne, d - 128u);
}

template <int VEC>
__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           long long avail, int nb) {
  for (int c = threadIdx.x * VEC; c < nb; c += kThreads * VEC) {
    const long long left = avail - c;
    const int bytes = left <= 0 ? 0 : left >= VEC ? VEC : static_cast<int>(left);
    mma::cp_async<VEC>(dst + c, bytes > 0 ? src + c : src, bytes);
  }
}

// nb bytes from src (avail of them real, the rest zero) into dst.
__device__ __forceinline__ void copy_any(int vec, char* dst, const char* src,
                                         long long avail, int nb) {
  switch (vec) {
    case 16: copy_bytes<16>(dst, src, avail, nb); break;
    case 8: copy_bytes<8>(dst, src, avail, nb); break;
    default: copy_bytes<4>(dst, src, avail, nb); break;
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
pq_segmax_kernel(const uint8_t* __restrict__ codes,
                 const unsigned short* __restrict__ lut,   // [n_q, 2m, 16]
                 float* __restrict__ out, long long n_rows, int m, int n_q,
                 int stages, int vec_c) {
  constexpr int QT = NT * 8;
  extern __shared__ uint4 smem[];
  char* tab = reinterpret_cast<char*>(smem);              // [QT][pitch]
  const int tp = static_cast<int>(table_pitch(m));
  char* ring = tab + QT * tp;                             // [stages][kTile * m]
  const int tile_bytes = kTile * m;
  const int q0 = blockIdx.y * QT;
  const int active = min(NT, (n_q - q0 + 7) / 8);         // n-tiles with queries
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned g = lane >> 2;
  const unsigned t = lane & 3;

  // the tables of the query tile, zero rows past n_q
  const int row_bytes = 64 * m;
  for (int i = threadIdx.x; i < QT * (row_bytes / 16); i += kThreads) {
    const int r = i / (row_bytes / 16);
    const int c = (i - r * (row_bytes / 16)) * 16;
    const bool real = q0 + r < n_q;
    const char* src = reinterpret_cast<const char*>(lut) +
                      (real ? static_cast<long long>(q0 + r) * row_bytes + c : 0);
    mma::cp_async<16>(tab + r * tp + c, src, real ? 16 : 0);
  }

  const long long n_tiles = (n_rows + kTile - 1) / kTile;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const long long total_bytes = n_rows * m;
  auto load_tile = [&](long long it, int stage) {
    const long long tile = blockIdx.x + it * gridDim.x;
    const long long b0 = tile * tile_bytes;
    copy_any(vec_c, ring + stage * tile_bytes,
             reinterpret_cast<const char*>(codes) + b0, total_bytes - b0, tile_bytes);
  };
  if (my_tiles > 0) load_tile(0, 0);
  mma::cp_async_commit();

  // ldmatrix row addresses into the tables: pairs of n-tiles (x4) and a
  // last single one (x2)
  const char* b_l = tab + ((lane & 7) + (lane >> 4) * 8) * tp + ((lane >> 3) & 1) * 16;
  const long long n_segs = (n_rows + 7) / 8;
  const int words = m / 4;

  for (long long it = 0; it < my_tiles; ++it) {
    if (stages == 2 && it + 1 < my_tiles) load_tile(it + 1, (it + 1) & 1);
    mma::cp_async_commit();
    if (stages == 2) {
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const char* ct = ring + (stages == 2 ? static_cast<int>(it & 1) : 0) * tile_bytes;
    const long long row0 = (blockIdx.x + it * gridDim.x) * kTile + warp * 32;
    // this lane's rows: m-tile mt, half h -> row warp * 32 + mt * 16 + g + 8h
    const char* crow[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) crow[mt][h] = ct + (warp * 32 + mt * 16 + g + 8 * h) * m;

    float acc[kMT][NT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    for (int w = 0; w < words; ++w) {
      unsigned cw[kMT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cw[mt][h] = *reinterpret_cast<const unsigned*>(crow[mt][h] + 4 * w);
#pragma unroll
      for (int b = 0; b < 8; ++b) {                 // subspace 8w + b
        const int s = 8 * w + b;
        unsigned af[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          one_hot((cw[mt][0] >> (4 * b)) & 15u, t, af[mt][0], af[mt][2]);
          one_hot((cw[mt][1] >> (4 * b)) & 15u, t, af[mt][1], af[mt][3]);
        }
        unsigned bf[NT][2];
#pragma unroll
        for (int p = 0; p + 1 < NT; p += 2) {
          if (p < active) {
            unsigned r[4];
            mma::ldmatrix_x4(r, b_l + p * 8 * tp + s * 32);
            bf[p][0] = r[0];
            bf[p][1] = r[1];
            bf[p + 1][0] = r[2];
            bf[p + 1][1] = r[3];
          }
        }
        if constexpr (NT == 1) {
          mma::ldmatrix_x2(bf[0], tab + (lane & 7) * tp + ((lane >> 3) & 1) * 16 + s * 32);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (nt < active) mma::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
    }

    // mask rows past n_rows, max over each segment's 8 rows (lane
    // groups g), store from the lanes of group 0
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + mt * 16 + g + 8 * h >= n_rows)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[mt][nt][2 * h] = -FLT_MAX;
            acc[mt][nt][2 * h + 1] = -FLT_MAX;
          }
#pragma unroll
    for (int x = 4; x < 32; x <<= 1)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = fmaxf(acc[mt][nt][i], __shfl_xor_sync(kFullMask, acc[mt][nt][i], x));
    if (g == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long seg = (row0 + mt * 16) / 8 + h;
          if (seg >= n_segs) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = q0 + nt * 8 + 2 * t + j;
              if (q < n_q) out[static_cast<long long>(q) * n_segs + seg] = acc[mt][nt][2 * h + j];
            }
        }
    }
    __syncthreads();                 // the stage is free for the next load
    if (stages == 1 && it + 1 < my_tiles) {
      load_tile(it + 1, 0);
      mma::cp_async_commit();
    }
  }
  mma::cp_async_wait<0>();
}

template <int NT>
cudaError_t launch(const void* codes, const void* lut, float* out,
                   long long n_rows, int m, int n_q, int stages, int vec_c,
                   size_t smem, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = pq_segmax_kernel<NT>;
  cudaError_t err = setup::allow_max_smem(kernel, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = setup::sm_count(device, &sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks: as many as the card holds for each query tile
  // (the tiles run one after another); each stages its tables once and
  // walks the doc tiles
  const long long n_qt = (n_q + NT * 8 - 1) / (NT * 8);
  const long long n_tiles = (n_rows + kTile - 1) / kTile;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_qt));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const unsigned short*>(lut), out, n_rows, m, n_q, stages,
      vec_c);
  return cudaGetLastError();
}

}  // namespace

// bf16 is the upper half of an fp32: widening is a 16-bit shift
__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// The lookup kernel (module note): rows of m bytes, each code word read
// (from L1 after the first query) for every query.
__global__ void __launch_bounds__(kLookupThreads)
pq_segmax_lookup_kernel(const uint8_t* __restrict__ codes,
                        const unsigned short* __restrict__ lut,   // [n_q, 2m, 16]
                        float* __restrict__ out, long long n_rows, int m,
                        int n_q, int q_tile_max) {
  const int words = m / 4;
  const int lut_len = 32 * m;                // table entries a query
  extern __shared__ unsigned short tab[];    // [q_tile, 2m, 16]
  const int q0 = blockIdx.y * q_tile_max;
  const int q_tile = min(q_tile_max, n_q - q0);
  const unsigned short* src = lut + static_cast<long long>(q0) * lut_len;
  for (int i = threadIdx.x; i < q_tile * lut_len; i += kLookupThreads) tab[i] = src[i];
  __syncthreads();

  const long long n_segs = (n_rows + 7) / 8;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kLookupThreads;
  // every thread of a warp runs the same number of iterations (the
  // loop bound is a multiple of 32), so the shuffles see full warps
  for (long long row = static_cast<long long>(blockIdx.x) * kLookupThreads + threadIdx.x;
       row - lane < n_segs * 8; row += stride) {
    const bool valid = row < n_rows;
    const uint32_t* r = reinterpret_cast<const uint32_t*>(codes + row * m);
    const long long seg = row / 8;
    for (int q = 0; q < q_tile; ++q) {
      const unsigned short* t = tab + q * lut_len;
      float acc = 0.f;
      for (int i = 0; i < words; ++i) {
        const uint32_t wi = valid ? __ldg(r + i) : 0u;
#pragma unroll
        for (int b = 0; b < 8; ++b) {       // 8 nibbles per word, in order
          acc += bf16_bits_to_float(t[(i * 8 + b) * 16 + ((wi >> (4 * b)) & 0xF)]);
        }
      }
      float v = valid ? acc : -FLT_MAX;
#pragma unroll
      for (int x = 1; x < 8; x <<= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, x));
      if ((row & 7) == 0 && seg < n_segs) {
        out[static_cast<long long>(q0 + q) * n_segs + seg] = v;
      }
    }
  }
}

static cudaError_t launch_lookup(const void* codes, const void* lut,
                                 float* out, long long n_rows, int m, int n_q,
                                 int q_tile, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = pq_segmax_lookup_kernel;
  const size_t smem = static_cast<size_t>(q_tile) * 32 * m * sizeof(unsigned short);
  cudaError_t err = setup::allow_max_smem(kernel, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = setup::sm_count(device, &sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kLookupThreads, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks: each stages its query tile's tables once, then
  // walks the rows with a grid stride
  const long long n_pad = (n_rows + 7) / 8 * 8;
  long long blocks = (n_pad + kLookupThreads - 1) / kLookupThreads;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((n_q + q_tile - 1) / q_tile));
  kernel<<<grid, kLookupThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const unsigned short*>(lut), out, n_rows, m, n_q, q_tile);
  return cudaGetLastError();
}

// Dynamic shared memory of the kernel, bytes, for m, the query tile qt
// and the code stages (1 or 2).
extern "C" int pq_segmax_smem_bytes(int m, int qt, int stages) {
  return static_cast<int>(smem_bytes(m, qt, stages));
}

// codes [n_rows, m] uint8 row-major (m % 4 == 0; 4-byte aligned), lut
// [n_q, 2m, 16] bf16 (16-byte aligned), out [n_q, ceil(n_rows / 8)]
// float32; qt (8, 16, 32 or 64) queries a block, stages (1 or 2) code
// tiles in flight, vec_c the copy width (16, 8 or 4) the codes' base
// address allows. Returns the CUDA error of the launch (0 on success);
// the kernel runs asynchronously on ``stream``.
extern "C" int pq_segmax_launch(const void* codes, const void* lut,
                                float* out, long long n_rows, int m,
                                int n_q, int qt, int stages, int vec_c,
                                int device, void* stream) {
  if (n_rows < 1 || n_q < 1 || m < 4 || m % 4 != 0 ||
      (stages != 1 && stages != 2) || (vec_c != 16 && vec_c != 8 && vec_c != 4) ||
      (n_q + qt - 1) / qt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_bytes(m, qt, stages);
  if (smem > setup::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  switch (qt) {
    case 8: err = launch<1>(codes, lut, out, n_rows, m, n_q, stages, vec_c, sm, device, s); break;
    case 16: err = launch<2>(codes, lut, out, n_rows, m, n_q, stages, vec_c, sm, device, s); break;
    case 32: err = launch<4>(codes, lut, out, n_rows, m, n_q, stages, vec_c, sm, device, s); break;
    case 64: err = launch<8>(codes, lut, out, n_rows, m, n_q, stages, vec_c, sm, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The lookup kernel (codes too wide for the tensor-core kernel's tables):
// codes and out as pq_segmax_launch; q_tile (at most 64, and
// 32 * m * 2 * q_tile bytes of tables within a block's shared memory)
// queries a block. Returns the CUDA error of the
// launch (0 on success).
extern "C" int pq_segmax_lookup_launch(const void* codes, const void* lut,
                                       float* out, long long n_rows, int m,
                                       int n_q, int q_tile, int device,
                                       void* stream) {
  if (n_rows < 1 || n_q < 1 || m < 4 || m % 4 != 0 || q_tile < 1 ||
      q_tile > kLookupMaxQ ||
      static_cast<long long>(q_tile) * 64 * m > setup::kMaxSmemBytes ||
      (n_q + q_tile - 1) / q_tile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_lookup(codes, lut, out, n_rows, m, n_q, q_tile,
                                        device, s));
}
