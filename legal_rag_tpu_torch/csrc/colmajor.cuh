// Scoring of column-major docs for K4 (segmax_cm.cu).
//
// The doc matrix is docs_t [D, N] (row e holds component e of every doc,
// rows ``ld`` elements apart). One thread scores one doc column against
// a tile of QT queries kept in shared memory as fp32 rows of ``dp``
// floats (D rounded up to 4, zero padded). At each step a warp reads the
// same row of 32 adjacent columns: coalesced loads, 128 B (fp32) or 64 B
// (bf16) a warp. Query values are read by broadcast, four at a time, and
// every doc value loaded feeds QT multiply-adds from registers.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>

namespace colmajor {

// A doc element as fp32. bf16 is loaded as its 16 bits (no alignment
// beyond 2 bytes is needed) and widened exactly: a bf16 is the upper
// half of an fp32.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// Queries [q0, q0 + qn) of [n_q, d] into ``qs`` as QT fp32 rows of dp
// floats; rows past qn and columns past d are zero. Every thread of the
// block takes part; the caller synchronises before reading ``qs``.
template <typename T, int QT>
__device__ __forceinline__ void stage_queries(const T* __restrict__ queries,
                                              int q0, int qn, int d, int dp,
                                              float* qs) {
  for (int i = threadIdx.x; i < QT * dp; i += blockDim.x) {
    const int j = i / dp;
    const int e = i - j * dp;
    qs[i] = (j < qn && e < d)
                ? load_f32(queries + static_cast<long long>(q0 + j) * d + e)
                : 0.f;
  }
}

// One multiply-add. kFma: fused, one rounding. Otherwise the product is
// rounded to fp32 and then added, the two roundings that a plain loop of
// tensor multiply and add performs, so that loop gives the same bits.
template <bool kFma>
__device__ __forceinline__ float mac(float x, float q, float acc) {
  if constexpr (kFma) {
    return fmaf(x, q, acc);
  } else {
    return __fadd_rn(acc, __fmul_rn(x, q));
  }
}

// acc[j] += sum over e = 0 .. d-1, in that order, of col[e * ld] *
// q_j[e] for the QT query rows of ``qs`` (a chunk of a longer dot
// product continues it in order). 64-bit offsets: e * ld passes 2^31
// elements for large corpora.
template <typename T, int QT, bool kFma>
__device__ __forceinline__ void dot_column_acc(const T* __restrict__ col,
                                               long long ld, int d,
                                               const float* qs, int dp,
                                               float* acc) {
  int e = 0;
  for (; e + 8 <= d; e += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = load_f32(col + static_cast<long long>(e + u) * ld);
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(qs + j * dp + e);
      const float4 b = *reinterpret_cast<const float4*>(qs + j * dp + e + 4);
      float s = acc[j];
      s = mac<kFma>(x[0], a.x, s);
      s = mac<kFma>(x[1], a.y, s);
      s = mac<kFma>(x[2], a.z, s);
      s = mac<kFma>(x[3], a.w, s);
      s = mac<kFma>(x[4], b.x, s);
      s = mac<kFma>(x[5], b.y, s);
      s = mac<kFma>(x[6], b.z, s);
      s = mac<kFma>(x[7], b.w, s);
      acc[j] = s;
    }
  }
  for (; e < d; ++e) {
    const float x = load_f32(col + static_cast<long long>(e) * ld);
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = mac<kFma>(x, qs[j * dp + e], acc[j]);
  }
}

// acc[j] = the whole dot product, from zero (dot_column_acc).
template <typename T, int QT, bool kFma>
__device__ __forceinline__ void dot_column(const T* __restrict__ col,
                                           long long ld, int d,
                                           const float* qs, int dp,
                                           float* acc) {
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = 0.f;
  dot_column_acc<T, QT, kFma>(col, ld, d, qs, dp, acc);
}

}  // namespace colmajor
