// K3: fused column-major matmul + top-k on the tensor cores, without the
// [Q, N] scores.
//
// Replaces the TPU kernel legal_rag_tpu/ops/dense.py _fused_topk_kernel
// (pallas_call in dense_topk_pallas). Docs are stored transposed,
// docs_t [D, N] (row stride ld >= N: a column slice is allowed). For
// each query q it returns the k best columns c by (score descending,
// lowest c on ties), where
//
//   score(q, c) = c < limit ? dot(docs_t[:, c], queries[q]) : -FLT_MAX
//
// Masked columns (limit <= c < N) still compete, as on the TPU, so when
// k > limit the tail holds masked ids in ascending order. k <= N.
//
// What bounds it: at 8 queries, one pass over docs_t at the memory rate
// (the bytes are 10x the tensor cores' work); at 64 fp32 queries the
// 3xTF32 products on mma.sync (three TF32 products for each fp32 one,
// and every warp splits the fragments it loads) take longer than the
// read; at 2,620 docs the launches and one tile a block. The selection
// costs little once the thresholds rise, more at large k.
//
// Design. Two launches:
//
// 1. fused_topk_partial_kernel: block (split, query tile) holds a tile
//    of QT = 16, 32 or 64 queries in shared memory for its whole life
//    and walks its split's 128-column tiles of docs_t once, so every
//    query of the tile reads each doc tile once. A tile arrives as
//    [32 k-rows, 128 columns] chunks through a cp.async ring (16-byte
//    copies; ragged rows and columns are zero-filled, and a docs_t whose
//    rows are not 16-byte aligned is loaded element by element instead).
//    The block's 4 warps (8 at 32 and 64 queries, two rows of 4) each
//    compute 16 or 32 queries against 32 columns on mma.sync:
//    - bf16: m16n8k16, bf16 in, fp32 accumulate; ldmatrix.x4 gives the
//      query fragments, ldmatrix.x4.trans the k-contiguous doc
//      fragments of the n-contiguous rows (padded to 272 B);
//    - fp32: 3xTF32 m16n8k8. Each value x splits into TF32 hi =
//      rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32), and the product
//      sums lo*hi + hi*lo + hi*hi in fp32, about fp32's precision (a
//      single TF32 pass keeps 11 bits, too few for the HIGHEST-precision
//      reference). Fragments are plain LDS (ldmatrix.trans would split
//      32-bit elements); inside each k8 step the k index is permuted
//      (logical t and t + 4 are physical 2t and 2t + 1, the same for
//      both operands, which leaves the sum unchanged) so that a query
//      fragment is one 8-byte load.
//    After a tile's last chunk each thread compares its accumulators
//    with its queries' current k-th (score, id), read from shared
//    memory; a block whose rows all stay below their thresholds is done
//    with the tile after one barrier. Thresholds only rise, so a stale
//    one admits extra candidates and never loses one. Survivors are
//    appended to per-query buffers of ``cap`` >= k + 32 slots (a power
//    of two), one shared atomic per quad of lanes (the 4 lanes that
//    hold one query row). When a buffer passes cap - 32 entries, or a
//    candidate finds it full and waits, the block refreshes every row:
//    at k <= 16 a row with at most 16 new entries is folded into its
//    sorted head by one thread (insertion); any other row is sorted by
//    one warp, a bitonic network in registers (64 or 128 slots: shuffles
//    below a stride of 32, register swaps above) or in shared memory
//    (256 or 512). A row keeps its best k and makes the k-th its
//    threshold, and waiting candidates are offered again. The kernel is
//    built once per sort (E), so each holds only the network its
//    buffers need. At the end of the split every buffer is refreshed
//    and its best k written to the scratch [Q, n_splits, k].
//    Large k (cap > 512 slots, k > 480): the buffers move to device
//    memory (the block's rows of a scratch the wrapper allocates; the
//    counters and thresholds stay in shared memory) and are sorted in
//    place there, the same network.
//    Large D (the query tile does not fit in shared memory with the
//    ring): each ring stage also carries the 16 queries' [16, 32] chunk
//    beside the doc chunk, so D has no limit.
// 2. fused_topk_merge_kernel: a block of 8 warps per query. Each warp
//    reduces every 8th run of 32 of the splits' n_splits * k candidates
//    by the same threshold, ballot appends and sorts; warp 0 then
//    merges the warps' best k (in shared memory, or in device memory
//    past 512 slots).
//
// Exactness: the global top-k entries are each within the best k of
// their own split (fewer than k entries beat them anywhere), and every
// step orders by the same total order, so the result is the top-k of the
// whole row.
//
// Numerics: the tensor cores sum products in their own order, so scores
// differ from an in-order fp32 loop in the last bits (within 1e-5 for
// unit vectors at D = 384), and ids agree with the plain version under
// the tie-aware rule. Identical doc columns give identical operands and
// so identical scores, which tie by lowest id.
//
// The entry point sets the device only when it is not current and
// raises the partial kernel's shared-memory limit once per device
// (setup.cuh).

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "setup.cuh"

namespace {

constexpr int kWarpsN = 4;             // warps across a tile's columns
constexpr int kN = 128;                 // columns a tile
constexpr int kWarpN = kN / kWarpsN;    // columns a warp
constexpr int kMergeWarps = 8;          // warps a query's merge block
constexpr int kK = 32;                  // depth of one staged k-chunk
constexpr int kMaxCap = 512;            // largest buffer kept in shared memory
constexpr int kQPitch = kK + 8;         // a streamed query chunk's row
constexpr unsigned kFull = 0xffffffffu;

// The ring's shape per doc type: rows padded so that fragment loads hit
// distinct banks (fp32: word 8t + g for lane (g, t); bf16: ldmatrix rows
// 272 B apart), and stages enough to keep ~40-50 KB of loads in flight
// on an SM that holds one block.
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

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// (s, i) comes before (ts, ti): higher score, then lower id.
__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

// A doc or query element as its raw bits, for the element-wise loads.
__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load_elem(const __nv_bfloat16* p) {
  return __ldg(p);
}
__device__ __forceinline__ void zero_elem(float& x) { x = 0.f; }
__device__ __forceinline__ void zero_elem(__nv_bfloat16& x) {
  x = __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// Sorts one buffer of E * 32 slots best first with one warp, in
// registers: slot e * 32 + lane sits in register e of the lane; slots
// [c, E * 32) are taken as empty (-inf, INT_MAX). A bitonic network
// swaps within a lane across registers for strides of 32 and more, and
// across lanes by shuffles below. Writes the best k back to slots
// [0, k) and returns the k-th in (kv, ki) on every lane (meaningful
// when c >= k). No block barrier: warps sort their own buffers side by
// side.
template <int E>
__device__ __forceinline__ void sort_reg(float* s, int* id, int c, int k,
                                         float& kv, int& ki) {
  const int lane = threadIdx.x & 31;
  float v[E];
  int ix[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < c ? s[i] : neg_inf();
    ix[e] = i < c ? id[i] : INT_MAX;
  }
  __syncwarp();
#pragma unroll
  for (int size = 2; size <= E * 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int es = stride / 32;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & es) continue;
          // registers e and e + es: best first where bit ``size`` of
          // the slot is clear (it depends on e alone, size >= 64)
          const bool up = ((e * 32) & size) == 0;
          const bool swap = up ? better(v[e + es], ix[e + es], v[e], ix[e])
                               : better(v[e], ix[e], v[e + es], ix[e + es]);
          if (swap) {
            const float tv = v[e];
            const int tx = ix[e];
            v[e] = v[e + es];
            ix[e] = ix[e + es];
            v[e + es] = tv;
            ix[e + es] = tx;
          }
        }
        continue;
      }
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ov = __shfl_xor_sync(kFull, v[e], stride);
        const int oi = __shfl_xor_sync(kFull, ix[e], stride);
        const bool up = ((e * 32 + lane) & size) == 0;
        const bool take = (lower == up) ? better(ov, oi, v[e], ix[e])
                                        : better(v[e], ix[e], ov, oi);
        if (take) {
          v[e] = ov;
          ix[e] = oi;
        }
      }
    }
  }
  float mv = neg_inf();
  int mi = INT_MAX;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < k) {
      s[i] = v[e];
      id[i] = ix[e];
    }
    if (e == (k - 1) >> 5) {
      mv = v[e];
      mi = ix[e];
    }
  }
  kv = __shfl_sync(kFull, mv, (k - 1) & 31);
  ki = __shfl_sync(kFull, mi, (k - 1) & 31);
  __syncwarp();
}

// Sorts one buffer of cap (a power of two) slots best-first with one
// warp, in place in shared memory: slots [c, cap) are first emptied to
// (-inf, INT_MAX), then a bitonic network runs over all cap slots, each
// lane taking every 32nd compare-exchange of a pass. Returns the k-th
// entry in (kv, ki) on every lane (meaningful when c >= k). No block
// barrier: warps sort their own buffers side by side.
__device__ __forceinline__ void sort_buffer(float* s, int* id, int c,
                                            int cap, int k, float& kv,
                                            int& ki) {
  const int lane = threadIdx.x & 31;
  for (int i = c + lane; i < cap; i += 32) {
    s[i] = neg_inf();
    id[i] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < cap / 2; p += 32) {
        const int a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int b = a + stride;
        const float sa = s[a], sb = s[b];
        const int ia = id[a], ib = id[b];
        // best-first inside blocks whose bit ``size`` is clear
        const bool swap = (a & size) == 0 ? better(sb, ib, sa, ia)
                                          : better(sa, ia, sb, ib);
        if (swap) {
          s[a] = sb;
          s[b] = sa;
          id[a] = ib;
          id[b] = ia;
        }
      }
      __syncwarp();
    }
  }
  kv = s[k - 1];
  ki = id[k - 1];
  __syncwarp();
}

// Sorts a buffer of cap slots best first with one warp: in registers
// (sort_reg) for E = cap / 32 of 2 or 4, in place (sort_buffer) for E =
// 0, the larger buffers in shared memory, and E = -1, buffers past
// kMaxCap slots, which live in device memory. A partial kernel is built
// for one E, so that it holds only the network its buffers need.
template <int E>
__device__ __forceinline__ void sort_any(float* s, int* id, int c, int cap,
                                         int k, float& kv, int& ki) {
  if constexpr (E > 0) {
    sort_reg<E>(s, id, c, k, kv, ki);
  } else {
    sort_buffer(s, id, c, cap, k, kv, ki);
  }
}

// The E of sort_any for a buffer of cap slots.
__host__ __device__ constexpr int sort_regs(int cap) {
  return cap == 64 ? 2 : cap == 128 ? 4 : 0;
}

// A row whose appended entries are at most kInsertMax, and k at most
// kInsertK, is refreshed by one thread inserting them one by one into
// its sorted head; any other row is sorted whole by a warp.
constexpr int kInsertMax = 16;
constexpr int kInsertK = 16;

// The block's per-query candidate buffers in shared memory: QT rows of
// ``cap`` (score, id) slots, rows ``cap + 1`` slots apart (so that the
// threads of one refresh, a row each, hit distinct banks). A row's
// first ``head`` slots hold its best entries so far, sorted best first
// (at most k); entries appended since the last refresh follow them, up
// to ``cnt``. The row's threshold is its k-th entry once it has k
// (initially (-inf, INT_MAX), worse than any real entry; +inf for rows
// past qn, which no value passes).
struct Selection {
  float* s;
  int* id;
  int* cnt;
  int* head;
  float* ts;
  int* ti;
  int cap;
  int pitch;
  int qn;       // rows in use

  __device__ Selection(void* base, int qt, int qn_, int cap_)
      : cap(cap_), pitch(cap_ + 1), qn(qn_) {
    s = static_cast<float*>(base);
    id = reinterpret_cast<int*>(s + qt * pitch);
    set_counters(id + qt * pitch, qt);
  }

  // Buffers in device memory (gs, gi: the block's qt rows of cap + 1
  // slots), counters and thresholds in shared memory at base.
  __device__ Selection(void* base, float* gs, int* gi, int qt, int qn_,
                       int cap_)
      : s(gs), id(gi), cap(cap_), pitch(cap_ + 1), qn(qn_) {
    set_counters(static_cast<int*>(base), qt);
  }

  __device__ void set_counters(int* base, int qt) {
    cnt = base;
    head = cnt + qt;
    ts = reinterpret_cast<float*>(head + qt);
    ti = reinterpret_cast<int*>(ts + qt);
  }

  __device__ void init(int qt) {
    for (int r = threadIdx.x; r < qt; r += blockDim.x) {
      cnt[r] = 0;
      head[r] = 0;
      ts[r] = r < qn ? neg_inf() : __int_as_float(0x7f800000);
      ti[r] = INT_MAX;
    }
  }

  __device__ bool needs_sort(int c, int h0, int k) const {
    return c > cap || c - h0 > kInsertMax || k > kInsertK;
  }

  __device__ void set_row(int r, int len, int k) {
    cnt[r] = len;
    head[r] = len;
    if (len >= k) {
      ts[r] = s[r * pitch + k - 1];
      ti[r] = id[r * pitch + k - 1];
    }
  }

  // Folds every row's appended entries into its sorted head, keeps the
  // best k and makes the k-th the threshold: one thread per row inserts
  // a few entries; a warp per row sorts the rows with many (the first
  // tiles) or an overflowed buffer. Every thread of the block calls this
  // after a barrier; it ends with one.
  template <int E>
  __device__ void refresh(int k) {
    bool sort_rows = false;
    for (int r = threadIdx.x; r < qn; r += blockDim.x) {
      const int c = cnt[r];
      const int h0 = head[r];
      if (c == h0) continue;
      if (needs_sort(c, h0, k)) {
        sort_rows = true;
        continue;
      }
      float* rs = s + r * pitch;
      int* ri = id + r * pitch;
      int len = h0;
      // the head grows over slots already read: slot len <= e
      for (int e = h0; e < c; ++e) {
        const float v = rs[e];
        const int vi = ri[e];
        int j = len;
        if (j == k) {
          if (!better(v, vi, rs[k - 1], ri[k - 1])) continue;
          j = k - 1;              // the k-th entry drops out
        } else {
          ++len;
        }
        while (j > 0 && better(v, vi, rs[j - 1], ri[j - 1])) {
          rs[j] = rs[j - 1];
          ri[j] = ri[j - 1];
          --j;
        }
        rs[j] = v;
        ri[j] = vi;
      }
      set_row(r, len, k);
    }
    if (!__syncthreads_or(sort_rows)) return;
    const int warps = blockDim.x / 32;
    for (int r = threadIdx.x / 32; r < qn; r += warps) {
      const int c = cnt[r];
      if (c == head[r] || !needs_sort(c, head[r], k)) continue;
      const int m = min(c, cap);
      float kv;
      int ki;
      sort_any<E>(s + r * pitch, id + r * pitch, m, cap, k, kv, ki);
      if ((threadIdx.x & 31) == 0) set_row(r, min(m, k), k);
      __syncwarp();
    }
    __syncthreads();
  }
};

// A warp's place in the block: the block has WR x 4 warps; warp (wr,
// wc) computes query rows [wr * MW * 16, (wr + 1) * MW * 16) against
// columns [wc * 32, wc * 32 + 32) of each tile.
template <int MW>
struct WarpTile {
  int row0;       // first query row of the warp
  int col0;       // first column of the warp in the tile
  __device__ WarpTile() {
    const int warp = threadIdx.x / 32;
    row0 = (warp / kWarpsN) * MW * 16;
    col0 = (warp % kWarpsN) * kWarpN;
  }
};

// The epilogue of one tile (module note). acc[mt][nt][i] holds row
// row0 + mt * 16 + lane / 4 + (i >= 2 ? 8 : 0), column base + col0 +
// nt * 8 + 2 (lane % 4) + (i & 1). First a quick test: a row whose max
// stays below its query's threshold admits nothing, and when that holds
// for every row of the block the tile is done (the common case once
// the thresholds rise). Otherwise each value is compared with its
// query's current k-th entry, and one that beats it takes a slot of the
// query's buffer by a shared atomic; a value that finds its buffer full
// waits, the block compacts and offers the waiting values again, until
// none is left (sort_any<E> compacts). Every thread of the block calls
// this; on return the accumulators are zero.
template <int MW, int E>
__device__ __forceinline__ void select_tile(Selection& sel,
                                            float (&acc)[MW][4][4],
                                            const WarpTile<MW>& wt,
                                            long long base, long long n,
                                            long long limit, int k) {
  const int g = (threadIdx.x & 31) >> 2;
  const long long col0 = base + wt.col0 + 2 * (threadIdx.x & 3);
  // bit (mt * 2 + h) * 8 + nt * 2 + j: a value still to offer
  unsigned todo = MW == 2 ? 0xffffffffu : 0xffffu;
  bool maybe = false;
  if (base + kN > limit) {
    // the ragged edge: masked columns score -FLT_MAX and columns past n
    // take no part
    todo = 0;
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long col = col0 + nt * 8 + (i & 1);
          if (col >= limit) acc[mt][nt][i] = -FLT_MAX;
          if (col < n) {
            todo |= 1u << ((mt * 2 + (i >> 1)) * 8 + nt * 2 + (i & 1));
          }
        }
      }
    }
    maybe = true;
  } else {
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = acc[mt][0][2 * h];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          m = fmaxf(m, fmaxf(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
        }
        maybe |= m >= sel.ts[wt.row0 + mt * 16 + g + 8 * h];
      }
    }
  }
  if (__syncthreads_or(maybe)) {
    const int t = threadIdx.x & 3;
    const int id0 = static_cast<int>(col0);
    while (true) {
      unsigned cand = 0;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wt.row0 + mt * 16 + g + 8 * h;
          const float tv = sel.ts[r];
          const int tix = sel.ti[r];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const unsigned bit = 1u << ((mt * 2 + h) * 8 + nt * 2 + j);
              if ((todo & bit) &&
                  better(acc[mt][nt][2 * h + j], id0 + nt * 8 + j, tv, tix)) {
                cand |= bit;
              }
            }
          }
        }
      }
      unsigned pend = 0;
      bool fill = false;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sh = (mt * 2 + h) * 8;
          const unsigned m8 = (cand >> sh) & 0xffu;
          if (!__any_sync(kFull, m8 != 0)) continue;
          // one atomic per quad (the 4 lanes of a row): an inclusive
          // scan of their counts, lane 3 reserves the slots
          const int r = wt.row0 + mt * 16 + g + 8 * h;
          const int mine = __popc(m8);
          int incl = mine;
          int x = __shfl_up_sync(kFull, incl, 1, 4);
          if (t >= 1) incl += x;
          x = __shfl_up_sync(kFull, incl, 2, 4);
          if (t >= 2) incl += x;
          const int total = __shfl_sync(kFull, incl, 3, 4);
          int first = 0;
          if (t == 3 && total > 0) {
            first = atomicAdd(&sel.cnt[r], total);
            fill |= first + total > sel.cap - 32;
          }
          int slot = __shfl_sync(kFull, first, 3, 4) + incl - mine;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int b = nt * 2 + j;
              if ((m8 >> b) & 1) {
                if (slot < sel.cap) {
                  sel.s[r * sel.pitch + slot] = acc[mt][nt][2 * h + j];
                  sel.id[r * sel.pitch + slot] = id0 + nt * 8 + j;
                } else {
                  pend |= 1u << (sh + b);
                }
                ++slot;
              }
            }
          }
        }
      }
      // the appends are done; a row past half its buffer, or a value
      // that waits, has the block fold the appends into the heads (the
      // thresholds rise), then offer what waited
      const int state = __syncthreads_or(pend != 0) ? 2 : __syncthreads_or(fill) ? 1 : 0;
      if (state == 0) break;
      sel.refresh<E>(k);
      if (state == 1) break;
      todo = pend;
    }
  }
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// One staged k-chunk's products: fp32 by 3xTF32 m16n8k8.
template <int MW>
__device__ __forceinline__ void chunk_mma(const float* a_s, int a_pitch,
                                         const float* bs, int kc,
                                         const WarpTile<MW>& wt,
                                         float (&acc)[MW][4][4]) {
  constexpr int kPitch = Ring<float>::kPitch;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* a_w = a_s + (wt.row0 + g) * a_pitch + kc * kK + 2 * t;
  const float* b_w = bs + 2 * t * kPitch + wt.col0 + g;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 8) {
    unsigned ah[MW][4], al[MW][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      const float* ar = a_w + mt * 16 * a_pitch + kk;
      const float2 x0 = *reinterpret_cast<const float2*>(ar);
      const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * a_pitch);
      mma::split_tf32(x0.x, ah[mt][0], al[mt][0]);   // (g, t)
      mma::split_tf32(x1.x, ah[mt][1], al[mt][1]);   // (g + 8, t)
      mma::split_tf32(x0.y, ah[mt][2], al[mt][2]);   // (g, t + 4)
      mma::split_tf32(x1.y, ah[mt][3], al[mt][3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* br = b_w + kk * kPitch + nt * 8;
      unsigned bh0, bl0, bh1, bl1;
      mma::split_tf32(br[0], bh0, bl0);                // (k t, n g)
      mma::split_tf32(br[kPitch], bh1, bl1);           // (k t + 4, n g)
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        mma::mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
        mma::mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
        mma::mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
}

// One staged k-chunk's products: bf16 by m16n8k16.
template <int MW>
__device__ __forceinline__ void chunk_mma(const __nv_bfloat16* a_s,
                                         int a_pitch,
                                         const __nv_bfloat16* bs, int kc,
                                         const WarpTile<MW>& wt,
                                         float (&acc)[MW][4][4]) {
  constexpr int kPitch = Ring<__nv_bfloat16>::kPitch;
  const int lane = threadIdx.x & 31;
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;
  const int lcol = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 16) {
    unsigned a[MW][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      mma::ldmatrix_x4(a[mt], a_s + (wt.row0 + mt * 16 + lrow) * a_pitch + kc * kK +
                             kk + lcol);
    }
    unsigned b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned r[4];
      mma::ldmatrix_x4_trans(r, bs + (kk + lrow) * kPitch + wt.col0 + np * 16 + lcol);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma::mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Block (split, query tile): queries [q0, q0 + 16 MT) against the tiles
// split, split + n_splits, ... of docs_t (the splits interleave, so the
// blocks in flight read neighbouring columns); writes each query's best
// k of its tiles, best first, to part [n_q, n_splits, k]. The block has
// WR x 4 warps (WR = 2 for 32 and 64 queries), each MT / WR m-tiles.
// kStreamQ: the queries do not fit in shared memory whole (large D), so
// each ring stage also carries their [QT, 32] chunk. E = -1: the
// candidate buffers are the block's rows of buf_s / buf_i in device
// memory (large k).
template <typename T, int MT, int E, bool kStreamQ>
__global__ void __launch_bounds__(kWarpsN * 32 * (MT >= 2 ? 2 : 1), 1)
fused_topk_partial_kernel(const T* __restrict__ docs_t, long long ld,
                          long long n, const T* __restrict__ queries,
                          int n_q, int d, int dp, int k, long long limit,
                          int cap, int n_splits, int aligned,
                          float* __restrict__ part_s,
                          int* __restrict__ part_i, float* __restrict__ buf_s,
                          int* __restrict__ buf_i) {
  constexpr int QT = MT * 16;
  constexpr int WR = MT >= 2 ? 2 : 1;
  constexpr int MW = MT / WR;
  constexpr int kBlock = kWarpsN * 32 * WR;
  constexpr int kPitch = Ring<T>::kPitch;
  constexpr int kStages = Ring<T>::kStages;
  constexpr int kElems = 16 / sizeof(T);            // a 16-byte copy
  constexpr int kRowCopies = kN / kElems;
  constexpr int kCopies = kK * kRowCopies / kBlock;
  // a stage: the doc chunk [kK][kPitch], then (kStreamQ) the query
  // chunk [QT][kQPitch]
  constexpr int kStageElems = kK * kPitch + (kStreamQ ? QT * kQPitch : 0);
  extern __shared__ uint4 smem[];
  T* b_s = reinterpret_cast<T*>(smem);               // [kStages][kStageElems]
  T* a_s = b_s + kStages * kStageElems;              // [QT][a_pitch] resident
  const int a_pitch = dp + 8;
  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, n_q - q0);
  void* sel_base = kStreamQ ? static_cast<void*>(a_s)
                            : static_cast<void*>(a_s + QT * a_pitch);
  const long long blk = static_cast<long long>(blockIdx.y) * n_splits + split;
  Selection sel = E < 0 ? Selection(sel_base, buf_s + blk * QT * (cap + 1),
                                    buf_i + blk * QT * (cap + 1), QT, qn, cap)
                        : Selection(sel_base, QT, qn, cap);
  const WarpTile<MW> wt;
  const bool q_aligned =
      d % kElems == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0;

  // the block's queries, zero past n_q and d: 16-byte loads where the
  // rows allow them, else element by element
  if (kStreamQ) {
  } else if (q_aligned) {
    const int row_vecs = dp / kElems;
    for (int i = tid; i < QT * row_vecs; i += kBlock) {
      const int r = i / row_vecs;
      const int e = (i - r * row_vecs) * kElems;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < qn && e < d) {
        v = __ldg(reinterpret_cast<const uint4*>(
            queries + static_cast<long long>(q0 + r) * d + e));
      }
      *reinterpret_cast<uint4*>(a_s + r * a_pitch + e) = v;
    }
  } else {
    for (int i = tid; i < QT * dp; i += kBlock) {
      const int r = i / dp;
      const int e = i - r * dp;
      T v;
      zero_elem(v);
      if (r < qn && e < d) v = load_elem(queries + static_cast<long long>(q0 + r) * d + e);
      a_s[r * a_pitch + e] = v;
    }
  }
  sel.init(QT);

  const long long n_tiles = (n + kN - 1) / kN;
  const long long my_tiles =
      split < n_tiles ? (n_tiles - split + n_splits - 1) / n_splits : 0;
  const int kc_n = dp / kK;
  const long long total = my_tiles * kc_n;

  // the next chunk to load: rows ld_kc * kK .. + kK of tile ld_tile
  long long ld_tile = split;
  int ld_kc = 0, ld_stage = 0;
  auto load_next = [&]() {
    const long long col_base = ld_tile * kN;
    const int k0 = ld_kc * kK;
    T* dst = b_s + ld_stage * kStageElems;
    if constexpr (kStreamQ) {
      // the query chunk: columns k0 .. k0 + kK of the tile's queries
      T* qdst = dst + kK * kPitch;
      constexpr int kRowUnits = kK / kElems;
      for (int i = tid; i < QT * kRowUnits; i += kBlock) {
        const int r = i / kRowUnits;
        const int c = (i - r * kRowUnits) * kElems;
        const T* src = queries + static_cast<long long>(q0 + r) * d + k0 + c;
        T* to = qdst + r * kQPitch + c;
        if (q_aligned) {
          const int left = r < qn ? d - (k0 + c) : 0;
          const int bytes = left <= 0 ? 0
                            : left >= kElems ? 16
                                             : left * static_cast<int>(sizeof(T));
          mma::cp_async<16>(to, bytes > 0 ? src : queries, bytes);
        } else {
#pragma unroll
          for (int j = 0; j < kElems; ++j) {
            T v;
            zero_elem(v);
            if (r < qn && k0 + c + j < d) v = load_elem(src + j);
            to[j] = v;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * kBlock;
      const int r = idx / kRowCopies;
      const int c = (idx % kRowCopies) * kElems;
      const long long col = col_base + c;
      const T* src = docs_t + static_cast<long long>(k0 + r) * ld + col;
      T* to = dst + r * kPitch + c;
      const bool row_ok = k0 + r < d;
      if (aligned) {
        const long long left = row_ok ? n - col : 0;
        const int bytes = left <= 0 ? 0
                          : left >= kElems ? 16
                                           : static_cast<int>(left) * static_cast<int>(sizeof(T));
        mma::cp_async<16>(to, bytes > 0 ? src : docs_t, bytes);
      } else {
#pragma unroll
        for (int j = 0; j < kElems; ++j) {
          T v;
          zero_elem(v);
          if (row_ok && col + j < n) v = load_elem(src + j);
          to[j] = v;
        }
      }
    }
    if (++ld_kc == kc_n) {
      ld_kc = 0;
      ld_tile += n_splits;
    }
    if (++ld_stage == kStages) ld_stage = 0;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_next();
    mma::cp_async_commit();
  }

  float acc[MW][4][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  long long tile = split;
  int kc = 0, stage = 0;
  for (long long g = 0; g < total; ++g) {
    mma::cp_async_wait<kStages - 2>();   // chunk g has landed
    __syncthreads();                // and every warp is done with g - 1
    if (g + kStages - 1 < total) load_next();
    mma::cp_async_commit();
    const T* bs = b_s + stage * kStageElems;
    if constexpr (kStreamQ) {
      chunk_mma<MW>(bs + kK * kPitch, kQPitch, bs, 0, wt, acc);
    } else {
      chunk_mma<MW>(a_s, a_pitch, bs, kc, wt, acc);
    }
    if (++stage == kStages) stage = 0;
    if (++kc == kc_n) {
      select_tile<MW, E>(sel, acc, wt, tile * kN, n, limit, k);
      kc = 0;
      tile += n_splits;
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();
  sel.refresh<E>(k);
  for (int i = tid; i < qn * k; i += kBlock) {
    const int r = i / k;
    const int slot = i - r * k;
    const long long o = (static_cast<long long>(q0 + r) * n_splits + split) * k + slot;
    const bool real = slot < sel.head[r];
    part_s[o] = real ? sel.s[r * sel.pitch + slot] : neg_inf();
    part_i[o] = real ? sel.id[r * sel.pitch + slot] : INT_MAX;
  }
}

// sort_any for a buffer of cap slots chosen at run time.
__device__ __forceinline__ void sort_cap(float* s, int* id, int c, int cap,
                                         int k, float& kv, int& ki) {
  switch (sort_regs(cap)) {
    case 2: sort_reg<2>(s, id, c, k, kv, ki); break;
    case 4: sort_reg<4>(s, id, c, k, kv, ki); break;
    default: sort_buffer(s, id, c, cap, k, kv, ki); break;
  }
}

// One warp keeps the best k of the candidates get(0 .. count - 1) in
// its buffer (s, id) of cap slots: a candidate that beats the running
// k-th entry is appended by ballot, and a buffer that could overflow is
// sorted and cut to its best k first. On return the buffer holds the
// best k, best first (empty slots (-inf, INT_MAX) when count < k).
template <typename Get>
__device__ __forceinline__ void warp_select(Get get, int count, float* s,
                                            int* id, int cap, int k) {
  const int lane = threadIdx.x & 31;
  float ts = neg_inf();
  int ti = INT_MAX;
  int cnt = 0;
  for (int b = 0; b < count; b += 32) {
    const int i = b + lane;
    float v = neg_inf();
    int vi = INT_MAX;
    if (i < count) get(i, v, vi);
    unsigned pass = __ballot_sync(kFull, better(v, vi, ts, ti));
    if (cnt + __popc(pass) > cap) {
      float kv;
      int ki;
      sort_cap(s, id, cnt, cap, k, kv, ki);
      if (cnt >= k) {
        ts = kv;
        ti = ki;
      }
      cnt = min(cnt, k);
      pass = __ballot_sync(kFull, better(v, vi, ts, ti));
    }
    if ((pass >> lane) & 1) {
      const int slot = cnt + __popc(pass & ((1u << lane) - 1));
      s[slot] = v;
      id[slot] = vi;
    }
    cnt += __popc(pass);
    __syncwarp();
  }
  float kv;
  int ki;
  sort_cap(s, id, cnt, cap, k, kv, ki);
}

// One block per query: each of its warps keeps the best k of every
// kMergeWarps-th run of 32 of the n_cand = n_splits * k candidates, then
// warp 0 keeps the best k of the warps' kMergeWarps * k. The warps'
// buffers ([kMergeWarps + 1][cap] slots) are in shared memory, or
// (kGlobal, cap > kMaxCap) the query's rows of gs / gi.
template <bool kGlobal>
__global__ void __launch_bounds__(kMergeWarps * 32)
fused_topk_merge_kernel(const float* __restrict__ part_s,
                        const int* __restrict__ part_i, int n_cand, int k,
                        int cap, float* __restrict__ gs, int* __restrict__ gi,
                        float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x / 32;
  const long long q = blockIdx.x;
  const long long slots = static_cast<long long>(kMergeWarps + 1) * cap;
  float* s = kGlobal ? gs + q * slots : reinterpret_cast<float*>(smem);
  int* id = kGlobal ? gi + q * slots : reinterpret_cast<int*>(s + slots);
  const float* cs = part_s + q * n_cand;
  const int* ci = part_i + q * n_cand;
  // warp w takes runs w, w + kMergeWarps, ... of 32 candidates
  const int runs = (n_cand + 31) / 32;
  const int mine = runs > warp ? (runs - warp + kMergeWarps - 1) / kMergeWarps : 0;
  warp_select(
      [&](int i, float& v, int& vi) {
        const int c = ((i / 32) * kMergeWarps + warp) * 32 + (i & 31);
        if (c < n_cand) {
          v = cs[c];
          vi = ci[c];
        }
      },
      mine * 32, s + warp * cap, id + warp * cap, cap, k);
  __syncthreads();
  if (warp != 0) return;
  warp_select(
      [&](int i, float& v, int& vi) {
        const int w = i / k;
        const int r = i - w * k;
        v = s[w * cap + r];
        vi = id[w * cap + r];
      },
      kMergeWarps * k, s + kMergeWarps * cap, id + kMergeWarps * cap, cap, k);
  for (int r = threadIdx.x; r < k; r += 32) {
    out_s[q * k + r] = s[kMergeWarps * cap + r];
    out_i[q * k + r] = id[kMergeWarps * cap + r];
  }
}

template <typename T>
constexpr long long ring_bytes() {
  return static_cast<long long>(Ring<T>::kStages) * kK * Ring<T>::kPitch *
         sizeof(T);
}

// The partial block's shared memory: the ring (with each stage's query
// chunk when the queries stream), the resident queries otherwise, the
// candidate buffers when they fit (cap <= kMaxCap), and four words a
// query row.
long long partial_smem(int dtype, int d, int qt, int cap, int stream_q) {
  const long long dp = (d + kK - 1) / kK * kK;
  const long long elt = dtype == 0 ? 4 : 2;
  const long long stages = dtype == 0 ? Ring<float>::kStages
                                      : Ring<__nv_bfloat16>::kStages;
  const long long ring = dtype == 0 ? ring_bytes<float>()
                                    : ring_bytes<__nv_bfloat16>();
  const long long queries = stream_q ? stages * qt * kQPitch * elt
                                     : qt * (dp + 8) * elt;
  const long long buffers =
      cap <= kMaxCap ? static_cast<long long>(qt) * (cap + 1) * 8 : 0;
  return ring + queries + buffers + qt * 16;
}

// The partial kernel's launch arguments.
struct PartialArgs {
  const void* docs_t;
  long long ld;
  long long n;
  const void* queries;
  int n_q;
  int d;
  int k;
  long long limit;
  int cap;
  int n_splits;
  size_t smem;
  int aligned;
  void* part_s;
  void* part_i;
  void* buf_s;
  void* buf_i;
  int device;
  cudaStream_t stream;
};

template <typename T, int MT, int E, bool S>
cudaError_t launch_partial(const PartialArgs& a) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = setup::allow_max_smem(
      fused_topk_partial_kernel<T, MT, E, S>, a.device, ready);
  if (err != cudaSuccess) return err;
  const int dp = (a.d + kK - 1) / kK * kK;
  const int threads = kWarpsN * 32 * (MT >= 2 ? 2 : 1);
  const dim3 grid(static_cast<unsigned>(a.n_splits),
                  static_cast<unsigned>((a.n_q + MT * 16 - 1) / (MT * 16)));
  fused_topk_partial_kernel<T, MT, E, S><<<grid, threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.docs_t), a.ld, a.n,
      static_cast<const T*>(a.queries), a.n_q, a.d, dp, a.k, a.limit, a.cap,
      a.n_splits, a.aligned, static_cast<float*>(a.part_s),
      static_cast<int*>(a.part_i), static_cast<float*>(a.buf_s),
      static_cast<int*>(a.buf_i));
  return cudaGetLastError();
}

template <typename T, int MT, bool S>
cudaError_t launch_sort(const PartialArgs& a) {
  if (a.cap > kMaxCap) return launch_partial<T, MT, -1, S>(a);
  switch (sort_regs(a.cap)) {
    case 2: return launch_partial<T, MT, 2, S>(a);
    case 4: return launch_partial<T, MT, 4, S>(a);
    default: return launch_partial<T, MT, 0, S>(a);
  }
}

// Streamed queries take the 16-query tile only (large D is rare).
template <typename T>
cudaError_t launch_tile(int qt, int stream_q, const PartialArgs& a) {
  if (stream_q) return qt == 16 ? launch_sort<T, 1, true>(a) : cudaErrorInvalidValue;
  switch (qt) {
    case 16: return launch_sort<T, 1, false>(a);
    case 32: return launch_sort<T, 2, false>(a);
    case 64: return launch_sort<T, 4, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of the partial kernel, bytes, for dtype (0 =
// float32, 1 = bfloat16), dimension d, query tile qt, buffer cap and
// whether the queries stream through the ring.
extern "C" int fused_topk_smem_bytes(int dtype, int d, int qt, int cap,
                                     int stream_q) {
  return static_cast<int>(partial_smem(dtype, d, qt, cap, stream_q));
}

// docs_t [d, >= n columns] with row stride ld (elements), queries
// [n_q, d] row-major; 1 <= k <= n < 2^31, any d >= 1. qt (16, 32 or 64)
// queries a block, stream_q (qt 16 only) the queries through the ring,
// cap (a power of two >= k + 32) buffer slots a query, n_splits blocks a
// query tile along the docs. Scratch part_s / part_i hold [n_q,
// n_splits, k]; for cap > 512, buf_s / buf_i hold the partial blocks'
// buffers ([n_q tiles * n_splits, qt, cap + 1]) and mbuf_s / mbuf_i the
// merge's ([n_q, 9, cap]). out_s / out_i are [n_q, k] (fp32, int32).
// Columns >= limit score -FLT_MAX and compete. Returns the CUDA error of
// the launches (0 on success); both run asynchronously on ``stream``.
extern "C" int fused_topk_launch(const void* docs_t, long long ld,
                                 long long n, const void* queries, int n_q,
                                 int d, int k, long long limit, int qt,
                                 int cap, int n_splits, int stream_q,
                                 void* part_s, void* part_i, void* buf_s,
                                 void* buf_i, void* mbuf_s, void* mbuf_i,
                                 void* out_s, void* out_i, int dtype,
                                 int device, void* stream) {
  if (n_q < 1 || d < 1 || k < 1 || k > n || n > INT_MAX || ld < n ||
      n_splits < 1 || static_cast<long long>(n_splits) * k > INT_MAX ||
      (qt != 16 && qt != 32 && qt != 64) || (cap & (cap - 1)) != 0 ||
      cap < k + 32 || (dtype != 0 && dtype != 1) ||
      (n_q + qt - 1) / qt > 65535 ||
      (cap > kMaxCap && (buf_s == nullptr || buf_i == nullptr ||
                         mbuf_s == nullptr || mbuf_i == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = partial_smem(dtype, d, qt, cap, stream_q);
  if (smem > setup::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long elt = dtype == 0 ? 4 : 2;
  const int aligned = reinterpret_cast<uintptr_t>(docs_t) % 16 == 0 &&
                      (ld * elt) % 16 == 0;
  const PartialArgs a{docs_t, ld, n, queries, n_q, d, k, limit, cap,
                      n_splits, static_cast<size_t>(smem), aligned, part_s,
                      part_i, buf_s, buf_i, device, s};
  err = dtype == 0 ? launch_tile<float>(qt, stream_q, a)
                   : launch_tile<__nv_bfloat16>(qt, stream_q, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cap > kMaxCap) {
    fused_topk_merge_kernel<true><<<n_q, kMergeWarps * 32, 0, s>>>(
        static_cast<const float*>(part_s), static_cast<const int*>(part_i),
        n_splits * k, k, cap, static_cast<float*>(mbuf_s),
        static_cast<int*>(mbuf_i), static_cast<float*>(out_s),
        static_cast<int*>(out_i));
  } else {
    fused_topk_merge_kernel<false><<<n_q, kMergeWarps * 32,
                                     (kMergeWarps + 1) * cap * 8, s>>>(
        static_cast<const float*>(part_s), static_cast<const int*>(part_i),
        n_splits * k, k, cap, nullptr, nullptr, static_cast<float*>(out_s),
        static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}
