// K4: column-major segment max, phase 1 of the column-major two-phase
// exact dense top-k.
//
// Replaces the TPU kernel legal_rag_tpu/ops/dense.py _segmax_kernel
// (pallas_call in dense_topk_twophase). Docs are stored transposed,
// docs_t [D, N] (row stride ld >= N: a column slice is allowed). A
// segment is seg_rows docs strided 128 apart: map position p = G * 128 +
// lane holds docs G * seg_rows * 128 + r * 128 + lane for r in [0,
// seg_rows). For queries q:
//
//   out[q, p] = max over the segment's docs c of
//               (c < limit ? dot(docs_t[:, c], queries[q]) : -FLT_MAX)
//
// written query-major, [n_q, n_segs] with n_segs = ceil(N / (seg_rows *
// 128)) * 128 (columns >= N score -FLT_MAX, as the TPU kernel's padding
// does). The [n_q, N] score matrix never reaches device memory.
//
// What bounds it on an H100: by operation count, one pass over docs_t
// at the memory rate at every batch up to 64 queries (each doc byte
// feeds Q multiply-adds, below the tensor cores' ~295 operations a byte;
// fp32's 3xTF32 products at 64 queries still take less than the read at
// the TF32 peak). In practice bf16 runs near that read at every batch,
// and fp32 past 16 queries is held by the instructions around its
// products: three TF32 products and two splits for each fp32 product.
//
// Route: the tensor cores by mma.sync, for both types and every batch:
//   - bf16: m16n8k16, bf16 in, fp32 accumulate (products exact);
//   - fp32: 3xTF32 m16n8k8 (lo*hi + hi*lo + hi*hi, each value split by
//     truncation, mma.cuh split_tf32_trunc), about fp32's precision.
// Not wgmma: for fp32 it cannot serve, since wgmma takes TF32 operands
// K-major only and column-major docs are N-major; for bf16 (where
// wgmma does take an MN-major B) mma.sync already runs near the read
// (1M docs, 64 queries: about 0.32 ms against a 0.25 ms read, and
// cuBLAS takes 0.33 for the product alone). Not the CUDA cores: a
// kernel with a thread a segment and fp32 FMAs was slower at every
// batch from 1 to 128 queries, fp32 and bf16 (scripts/k4_shapes.py;
// fp32 Q=8 about 0.73 ms against 0.58, bf16 0.57 against 0.30).
//
// Design. The docs are mma.sync's A operand as they lie (rows of the
// product = doc columns, depth = D), the queries its B operand (columns
// = queries), so query tiles of 8, 16, 32 and 64 fill the n8 tiles and
// a batch past 64 takes tiles of 64. A tile is 128 doc columns, one
// member of a group: for member r, group G's tile is columns G *
// seg_rows * 128 + r * 128 + [0, 128). A block holds one query tile (in
// shared memory for its life where it fits, else a chunk of it in every
// ring stage, so D has no limit) and walks its units, a unit being a
// group's members or, where the groups are too few to give every SM two
// blocks (seg_rows 64 at 1M docs has 128), a run of them: persistent
// blocks, a grid-stride loop over units; the blocks of one doc range
// and different query tiles are adjacent in launch order. Each tile
// arrives as [32 rows, 128 columns] chunks through a cp.async ring
// (rows padded to 528 B fp32 and 272 B bf16, so that fragment loads hit
// distinct banks; columns >= limit and rows >= D are zero-filled, and a
// docs_t whose rows are not 16-byte aligned is loaded element by
// element). 4 warps across the columns (x 2 across the queries at 64)
// each compute 32 columns x 8-32 queries:
//   - bf16: ldmatrix.x4.trans gives the doc fragments (k-contiguous
//     pairs of the column-contiguous rows), ldmatrix the query
//     fragments (rows of the row-major query tile);
//   - fp32: plain LDS, with the k index permuted inside each k8 step
//     alike for both operands (logical t and t + 4 are physical 2t and
//     2t + 1, which leaves every sum unchanged) so that a query fragment
//     is one 8-byte load.
// The segment max comes free from the layout: a thread's accumulator
// (column j of the tile, query q) belongs to map position G * 128 + j
// for every member r, so after each tile the thread folds its masked
// accumulators into a running max in registers (no shuffles, no shared
// memory), and after the unit's last member it writes the group's
// [QT, 128] maxima: by plain stores when a unit is a whole group, else
// by an atomic max (exact in any order) into a map the launch fills with
// a pattern below every float. seg_rows changes the tiles a group has,
// not the work a tile takes. A tile wholly past limit is not read; a
// group with no column below limit is written -FLT_MAX without reading
// anything.
//
// Numerics: the tensor cores sum in their own order, so the map differs
// from an in-order fp32 sum in the last bits (within 1e-5 at D = 384).
// They also round each accumulation toward zero, and 3xTF32 adds three
// products a k8 step: summed into one accumulator over D = 384, that
// bias passed 1e-5 at scores of magnitude 4-5 (queries that are not unit
// vectors, tests/test_torch_experiments.py on the card). So each k8
// step's three products start from a zeroed fragment, whose small sum
// loses little to truncation, and join the accumulator by one fp32 add,
// rounded to nearest. bf16 takes one product a k16 step into the
// accumulator, a quarter of the truncations, well within 1e-5. Identical
// doc columns give identical operands and so identical scores, which
// keeps dense_topk_twophase's tie rule.

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "setup.cuh"

namespace {

constexpr int kN = 128;           // columns a tile: the stride of a segment's docs
constexpr int kK = 32;            // rows of docs_t a staged chunk holds
constexpr int kColWarps = 4;      // warps across a tile's columns
constexpr int kMW = 2;            // m-tiles (16 columns) a warp: 32 columns
constexpr int kQPitch = kK + 8;   // a streamed query chunk's row

// The ring per doc type: rows padded so that fragment loads hit
// distinct banks (fp32: word 8t + g for lane (g, t); bf16: ldmatrix rows
// 272 B apart), and stages enough to keep ~40-50 KB of loads in flight
// a block.
template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int kPitch = kN + 4;   // 528 B
  static constexpr int kStages = 4;
};
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int kPitch = kN + 8;   // 272 B
  static constexpr int kStages = 6;
};

// A block for a query tile of QT: kColWarps x kWN warps, each 32
// columns x kNT * 8 queries.
template <int QT>
struct Shape {
  static constexpr int kWN = QT == 64 ? 2 : 1;
  static constexpr int kNT = QT / 8 / kWN;
  static constexpr int kThreads = kColWarps * kWN * 32;
};

// A block's dynamic shared memory, bytes: the ring (each stage a doc
// chunk [kK][pitch] and, streamed, the query chunk [qt][kQPitch]) and
// the resident query tile [qt][D rounded up to kK, + 8].
long long smem_bytes(int elt, int d, int qt, int stream_q) {
  const long long pitch = elt == 4 ? Ring<float>::kPitch : Ring<__nv_bfloat16>::kPitch;
  const long long stages = elt == 4 ? Ring<float>::kStages : Ring<__nv_bfloat16>::kStages;
  const long long dp = (d + kK - 1LL) / kK * kK;
  const long long stage = kK * pitch + (stream_q ? static_cast<long long>(qt) * kQPitch : 0);
  return (stages * stage + (stream_q ? 0 : qt * (dp + 8))) * elt;
}

// An element as its raw bits, for the element-wise loads.
__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load_elem(const __nv_bfloat16* p) {
  return __ldg(p);
}
template <typename T>
__device__ __forceinline__ T zero_elem();
template <>
__device__ __forceinline__ float zero_elem<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// One staged chunk's products, bf16 by m16n8k16. ``ds``: the warp's
// first column of the doc chunk [kK][kPitch]; ``qs``: the warp's first
// query row at the chunk's depth, rows ``q_pitch`` apart.
// acc[mt][nt][i] holds column mt * 16 + g + (i >= 2 ? 8 : 0) of the warp
// and query nt * 8 + 2t + (i & 1), for lane (g, t) = (lane / 4, lane % 4).
template <int NT>
__device__ __forceinline__ void chunk_mma(const __nv_bfloat16* ds,
                                          const __nv_bfloat16* qs, int q_pitch,
                                          float (&acc)[kMW][NT][4]) {
  constexpr int kPitch = Ring<__nv_bfloat16>::kPitch;
  const int lane = threadIdx.x & 31;
  // A, transposed: matrix i = lane / 8 is (columns (i % 2) * 8 + [0, 8),
  // rows (i / 2) * 8 + [0, 8)); lane l gives row l % 8 of it
  const __nv_bfloat16* a_l = ds + ((lane & 7) + (lane >> 4) * 8) * kPitch + ((lane >> 3) & 1) * 8;
  // B: matrix i is (queries (i / 2) * 8 + [0, 8), depth (i % 2) * 8 + [0, 8))
  const __nv_bfloat16* b_l = qs + ((lane & 7) + (lane >> 4) * 8) * q_pitch + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* b_l2 = qs + (lane & 7) * q_pitch + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 16) {
    unsigned a[kMW][4];
#pragma unroll
    for (int mt = 0; mt < kMW; ++mt) mma::ldmatrix_x4_trans(a[mt], a_l + kk * kPitch + mt * 16);
    unsigned b[NT][2];
#pragma unroll
    for (int p = 0; p + 1 < NT; p += 2) {
      unsigned r[4];
      mma::ldmatrix_x4(r, b_l + p * 8 * q_pitch + kk);
      b[p][0] = r[0];
      b[p][1] = r[1];
      b[p + 1][0] = r[2];
      b[p + 1][1] = r[3];
    }
    if constexpr (NT % 2 == 1) {
      mma::ldmatrix_x2(b[NT - 1], b_l2 + (NT - 1) * 8 * q_pitch + kk);
    }
#pragma unroll
    for (int mt = 0; mt < kMW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma::mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// The same, fp32 by 3xTF32 m16n8k8.
template <int NT>
__device__ __forceinline__ void chunk_mma(const float* ds, const float* qs,
                                          int q_pitch,
                                          float (&acc)[kMW][NT][4]) {
  constexpr int kPitch = Ring<float>::kPitch;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* a_l = ds + 2 * t * kPitch + g;
  const float* b_l = qs + g * q_pitch + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 8) {
    unsigned ah[kMW][4], al[kMW][4];
#pragma unroll
    for (int mt = 0; mt < kMW; ++mt) {
      const float* ar = a_l + kk * kPitch + mt * 16;
      mma::split_tf32_trunc(ar[0], ah[mt][0], al[mt][0]);            // (g, t)
      mma::split_tf32_trunc(ar[8], ah[mt][1], al[mt][1]);            // (g + 8, t)
      mma::split_tf32_trunc(ar[kPitch], ah[mt][2], al[mt][2]);       // (g, t + 4)
      mma::split_tf32_trunc(ar[kPitch + 8], ah[mt][3], al[mt][3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 y = *reinterpret_cast<const float2*>(b_l + nt * 8 * q_pitch + kk);
      unsigned bh0, bl0, bh1, bl1;
      mma::split_tf32_trunc(y.x, bh0, bl0);                          // (k t, n g)
      mma::split_tf32_trunc(y.y, bh1, bl1);                          // (k t + 4, n g)
#pragma unroll
      for (int mt = 0; mt < kMW; ++mt) {
        // the step's three products from zero, then one rounded add
        // (file note: the tensor cores' own accumulation truncates)
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_tf32(c, al[mt], bh0, bh1);
        mma::mma_tf32(c, ah[mt], bl0, bl1);
        mma::mma_tf32(c, ah[mt], bh0, bh1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += c[i];
      }
    }
  }
}

// *p = max(*p, v), exact in any order: a float whose sign bit is clear
// orders as a signed int, one whose sign bit is set in reverse as an
// unsigned. *p starts as the pattern 0xffffffff, below every float in
// both orders.
__device__ __forceinline__ void atomic_max(float* p, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
  }
}

// A block's place in the work: its units u = x, x + stride, ... <
// n_live (unit u holds members (u % parts) * mr + [0, mr) of group u /
// parts) and, within the current unit, member r's chunk kc of tiles.
struct Cursor {
  long long unit;
  int r;
  int kc;
  int tiles;
};

// Block b: query tile b % n_qt (QT queries), units b / n_qt, + gridDim.x
// / n_qt, ... of a group's seg_rows / parts members (file note). out
// [n_q, n_segs], filled with 0xffffffff when parts > 1.
template <typename T, int QT>
__global__ void __launch_bounds__(Shape<QT>::kThreads, 2)
segmax_cm_kernel(const T* __restrict__ docs_t, long long ld,
                 const T* __restrict__ queries, int n_q, int d,
                 float* __restrict__ out, long long n_segs, int seg_rows,
                 long long limit, int parts, int n_qt, int stream_q,
                 int aligned, int q_aligned) {
  constexpr int kThreads = Shape<QT>::kThreads;
  constexpr int kNT = Shape<QT>::kNT;
  constexpr int kPitch = Ring<T>::kPitch;
  constexpr int kStages = Ring<T>::kStages;
  constexpr int kElems = 16 / sizeof(T);            // a 16-byte copy
  constexpr int kRowCopies = kN / kElems;
  constexpr int kCopies = kK * kRowCopies / kThreads;
  static_assert(kK * kRowCopies % kThreads == 0, "copies a thread");
  extern __shared__ uint4 smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int stage_elems = kK * kPitch + (stream_q ? QT * kQPitch : 0);
  T* q_res = ring + kStages * stage_elems;           // [QT][q_pitch] resident
  const int dp = (d + kK - 1) / kK * kK;
  const int q_pitch = dp + 8;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = (warp % kColWarps) * 32;          // the warp's columns
  const int qw0 = (warp / kColWarps) * kNT * 8;      // and queries in the tile
  const int q0 = static_cast<int>(blockIdx.x % n_qt) * QT;
  const int qn = min(QT, n_q - q0);
  const long long x = blockIdx.x / n_qt;
  const long long stride = gridDim.x / n_qt;
  const long long group_cols = static_cast<long long>(seg_rows) * kN;
  const int mr = seg_rows / parts;                   // members a unit
  const long long unit_cols = static_cast<long long>(mr) * kN;
  const long long n_live = (limit + unit_cols - 1) / unit_cols;   // units
  const int kc_n = dp / kK;

  // groups with no column below limit: the mask alone
  for (long long grp = (limit + group_cols - 1) / group_cols + x;
       grp < n_segs / kN; grp += stride) {
    for (int i = tid; i < qn * kN; i += kThreads) {
      out[static_cast<long long>(q0 + i / kN) * n_segs + grp * kN + i % kN] = -FLT_MAX;
    }
  }

  // the block's queries, zero past n_q and d: 16-byte loads where the
  // rows allow them, else element by element
  if (!stream_q) {
    if (q_aligned) {
      const int row_vecs = dp / kElems;
      for (int i = tid; i < QT * row_vecs; i += kThreads) {
        const int r = i / row_vecs;
        const int e = (i - r * row_vecs) * kElems;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < qn && e < d) {
          v = __ldg(reinterpret_cast<const uint4*>(
              queries + static_cast<long long>(q0 + r) * d + e));
        }
        *reinterpret_cast<uint4*>(q_res + r * q_pitch + e) = v;
      }
    } else {
      for (int i = tid; i < QT * dp; i += kThreads) {
        const int r = i / dp;
        const int e = i - r * dp;
        q_res[r * q_pitch + e] = r < qn && e < d
            ? load_elem(queries + static_cast<long long>(q0 + r) * d + e)
            : zero_elem<T>();
      }
    }
  }

  auto tiles_of = [&](long long u) {
    const long long left = (limit - u * unit_cols + kN - 1) / kN;
    return static_cast<int>(left < mr ? left : mr);
  };
  auto start = [&](Cursor& c) {
    c.unit = x;
    c.r = 0;
    c.kc = 0;
    c.tiles = x < n_live ? tiles_of(x) : 0;
  };
  auto advance = [&](Cursor& c) {
    if (++c.kc < kc_n) return;
    c.kc = 0;
    if (++c.r < c.tiles) return;
    c.r = 0;
    c.unit += stride;
    c.tiles = c.unit < n_live ? tiles_of(c.unit) : 0;
  };
  // chunk (c.unit, c.r, c.kc) into ring stage st: rows kc * kK .. + kK
  // of member r's 128 columns, and the queries' chunk when they stream
  auto load = [&](const Cursor& c, int st) {
    const long long col_base = (c.unit * mr + c.r) * kN;
    const int k0 = c.kc * kK;
    T* dst = ring + st * stage_elems;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kRowCopies;
      const int cc = (idx % kRowCopies) * kElems;
      const long long col = col_base + cc;
      const T* src = docs_t + static_cast<long long>(k0 + r) * ld + col;
      T* to = dst + r * kPitch + cc;
      const bool row_ok = k0 + r < d;
      if (aligned) {
        const long long left = row_ok ? limit - col : 0;
        const int bytes = left <= 0 ? 0
                          : left >= kElems ? 16
                                           : static_cast<int>(left) * static_cast<int>(sizeof(T));
        mma::cp_async<16>(to, bytes > 0 ? src : docs_t, bytes);
      } else {
#pragma unroll
        for (int j = 0; j < kElems; ++j) {
          to[j] = row_ok && col + j < limit ? load_elem(src + j) : zero_elem<T>();
        }
      }
    }
    if (stream_q) {
      T* qdst = dst + kK * kPitch;
      constexpr int kRowUnits = kK / kElems;
      for (int i = tid; i < QT * kRowUnits; i += kThreads) {
        const int r = i / kRowUnits;
        const int cc = (i - r * kRowUnits) * kElems;
        const T* src = queries + static_cast<long long>(q0 + r) * d + k0 + cc;
        T* to = qdst + r * kQPitch + cc;
        if (q_aligned) {
          const int left = r < qn ? d - (k0 + cc) : 0;
          const int bytes = left <= 0 ? 0
                            : left >= kElems ? 16
                                             : left * static_cast<int>(sizeof(T));
          mma::cp_async<16>(to, bytes > 0 ? src : queries, bytes);
        } else {
#pragma unroll
          for (int j = 0; j < kElems; ++j) {
            to[j] = r < qn && k0 + cc + j < d ? load_elem(src + j) : zero_elem<T>();
          }
        }
      }
    }
  };

  Cursor ld_c, cur;
  start(ld_c);
  start(cur);
  int ld_st = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld_c.unit < n_live) {
      load(ld_c, ld_st);
      advance(ld_c);
      ++ld_st;
    }
    mma::cp_async_commit();
  }

  float acc[kMW][kNT][4], mx[kMW][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMW; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0.f;
        mx[mt][nt][i] = -FLT_MAX;
      }

  int st = 0;
  while (cur.unit < n_live) {
    mma::cp_async_wait<kStages - 2>();   // this chunk has landed
    __syncthreads();                     // and every warp is done with the last
    if (ld_c.unit < n_live) {
      load(ld_c, ld_st);
      advance(ld_c);
      if (++ld_st == kStages) ld_st = 0;
    }
    mma::cp_async_commit();
    const T* stage = ring + st * stage_elems;
    const T* qs = stream_q ? stage + kK * kPitch + qw0 * kQPitch
                           : q_res + qw0 * q_pitch + cur.kc * kK;
    chunk_mma<kNT>(stage + col0, qs, stream_q ? kQPitch : q_pitch, acc);
    if (++st == kStages) st = 0;
    if (cur.kc == kc_n - 1) {
      // the member's tile is done: fold its columns below limit into
      // the running max
      const long long tile_col = (cur.unit * mr + cur.r) * kN + col0 + g;
#pragma unroll
      for (int mt = 0; mt < kMW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool live = tile_col + mt * 16 + 8 * h < limit;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& a = acc[mt][nt][2 * h + j];
              if (live) mx[mt][nt][2 * h + j] = fmaxf(mx[mt][nt][2 * h + j], a);
              a = 0.f;
            }
        }
      if (cur.r == cur.tiles - 1) {
        // the unit is done: its [QT, 128] maxima
        const long long p0 = cur.unit / parts * kN + col0 + g;
#pragma unroll
        for (int mt = 0; mt < kMW; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int q = qw0 + nt * 8 + 2 * t + j;
                float& m = mx[mt][nt][2 * h + j];
                if (q < qn) {
                  float* o = out + static_cast<long long>(q0 + q) * n_segs + p0 + mt * 16 + 8 * h;
                  if (parts == 1) {
                    *o = m;
                  } else {
                    atomic_max(o, m);
                  }
                }
                m = -FLT_MAX;
              }
      }
    }
    advance(cur);
  }
  mma::cp_async_wait<0>();
}

template <typename T, int QT>
cudaError_t launch(const void* docs_t, long long ld, const void* queries,
                   int n_q, int d, void* out, long long n_segs, int seg_rows,
                   long long limit, int stream_q, int aligned, int q_aligned,
                   size_t smem, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = segmax_cm_kernel<T, QT>;
  constexpr int kThreads = Shape<QT>::kThreads;
  cudaError_t err = setup::allow_max_smem(kernel, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = setup::sm_count(device, &sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long n_qt = (n_q + QT - 1) / QT;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  // a unit is a whole group while the live groups give every block
  // slot at least half a unit; else runs of members, halved until they do
  const long long group_cols = static_cast<long long>(seg_rows) * kN;
  long long n_live = (limit + group_cols - 1) / group_cols;
  int parts = 1;
  while (parts < seg_rows && n_live > 0 && 2 * n_live * n_qt <= slots) {
    parts *= 2;
    n_live = (limit + group_cols / parts - 1) / (group_cols / parts);
  }
  if (parts > 1) {
    err = cudaMemsetAsync(out, 0xff, static_cast<size_t>(n_q) * n_segs * sizeof(float), stream);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: as many as the card holds, shared among the
  // query tiles, at most one a live unit for each
  long long bx = (slots + n_qt - 1) / n_qt;
  if (bx > n_live) bx = n_live;
  if (bx < 1) bx = 1;
  if (bx * n_qt > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(bx * n_qt), kThreads, smem, stream>>>(
      static_cast<const T*>(docs_t), ld, static_cast<const T*>(queries), n_q,
      d, static_cast<float*>(out), n_segs, seg_rows, limit, parts,
      static_cast<int>(n_qt), stream_q, aligned, q_aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int qt, const void* docs_t, long long ld,
                     const void* queries, int n_q, int d, void* out,
                     long long n_segs, int seg_rows, long long limit,
                     int stream_q, int aligned, int q_aligned, size_t smem,
                     int device, cudaStream_t s) {
  switch (qt) {
    case 8: return launch<T, 8>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows, limit, stream_q, aligned, q_aligned, smem, device, s);
    case 16: return launch<T, 16>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows, limit, stream_q, aligned, q_aligned, smem, device, s);
    case 32: return launch<T, 32>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows, limit, stream_q, aligned, q_aligned, smem, device, s);
    case 64: return launch<T, 64>(docs_t, ld, queries, n_q, d, out, n_segs, seg_rows, limit, stream_q, aligned, q_aligned, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of a block, bytes, for dtype (0 = float32, 1 =
// bfloat16), dimension d, query tile qt and whether the queries stream
// through the ring.
extern "C" int segmax_cm_smem_bytes(int dtype, int d, int qt, int stream_q) {
  return static_cast<int>(smem_bytes(dtype == 0 ? 4 : 2, d, qt, stream_q));
}

// docs_t [d, >= limit columns] with row stride ld (elements; any ld and
// alignment), queries [n_q, d] row-major, out [n_q, n_segs] fp32 with
// n_segs a multiple of 128. dtype: 0 = float32, 1 = bfloat16 (docs and
// queries alike). Columns >= limit are masked (the caller passes min(N,
// n_valid)). qt (8, 16, 32 or 64) queries a block, stream_q the queries
// through the ring instead of resident. Returns the CUDA error of the
// launch (0 on success); the kernel runs asynchronously on ``stream``.
extern "C" int segmax_cm_launch(const void* docs_t, long long ld,
                                const void* queries, int n_q, int d,
                                void* out, long long n_segs, int seg_rows,
                                long long limit, int dtype, int qt,
                                int stream_q, int device, void* stream) {
  const bool pow2 = seg_rows >= 1 && seg_rows <= 64 && (seg_rows & (seg_rows - 1)) == 0;
  if (n_q < 1 || d < 1 || ld < 1 || !pow2 || n_segs < kN || n_segs % kN != 0 ||
      limit < 0 || limit > n_segs * seg_rows || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elt = dtype == 0 ? 4 : 2;
  const long long smem = smem_bytes(elt, d, qt, stream_q);
  if (smem > setup::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int aligned = reinterpret_cast<uintptr_t>(docs_t) % 16 == 0 &&
                      (ld * elt) % 16 == 0;
  const int q_aligned = reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                        (static_cast<long long>(d) * elt) % 16 == 0;
  const size_t sm = static_cast<size_t>(smem);
  err = dtype == 0
      ? dispatch<float>(qt, docs_t, ld, queries, n_q, d, out, n_segs, seg_rows,
                        limit, stream_q, aligned, q_aligned, sm, device, s)
      : dispatch<__nv_bfloat16>(qt, docs_t, ld, queries, n_q, d, out, n_segs,
                                seg_rows, limit, stream_q, aligned, q_aligned,
                                sm, device, s);
  return static_cast<int>(err);
}
