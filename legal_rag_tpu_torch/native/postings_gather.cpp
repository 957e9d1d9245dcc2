// BM25 postings gather for a whole query batch in one call: the padded
// [Q, budget] doc ids and weights the served hybrid search scores.
//
// The port's C++ counterpart of BM25Index.gather_postings
// (ops/sparse.py), which runs a dozen numpy calls a query. The caller
// tokenizes each query once and hands over its distinct term ids in
// first-appearance order with their multiplicities. A query's postings
// in gather order are
//   row = for each term t, in order:  doc_ids[indptr[t]:indptr[t + 1]]
//   w   = for each term t, in order:  weights[indptr[t]:indptr[t + 1]] * mult[t]
// (float32 products, rounded once, as numpy's). A row that fits the
// budget is written so and padded with (n_docs, 0.0f). A row past the
// budget is cut by weight under ops.sparse.cut_by_weight's rule: c is
// the budget-th largest weight; every posting above c is kept, and of
// those equal to c the first in gather order until the row holds
// budget; the kept postings stay in gather order.
//
// The cut sorts nothing. For a float that is not negative, its bit
// pattern without the sign bit (its key) orders as its value does, -0.0
// and 0.0 both giving 0. A sample, one cache line of 16 postings in
// every 1,024, gives a key t_lo that about 9/8 of the budget reach; one
// pass copies the postings at or above t_lo, in gather order, to a
// candidate buffer (again with t_lo = 0 in the rare case that they are
// fewer than the budget); two histograms of the candidates' keys, of
// their top 15 bits and then of the low 16 bits inside the bucket that
// holds c, find c and how many postings of weight c fit; a last pass
// over the candidates writes the row. Both passes run eight lanes wide
// where the CPU has AVX2. No mutable static state: threads call it
// concurrently.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <memory>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define POSTINGS_HAVE_AVX2 1
#endif

namespace {

constexpr int kLowBits = 16;
constexpr uint32_t kLowMask = (1u << kLowBits) - 1;
constexpr size_t kHighBuckets = size_t{1} << (31 - kLowBits);
// the sample: kSampleRun postings in every kSampleEvery, in gather order
constexpr int64_t kSampleRun = 16;
constexpr int64_t kSampleEvery = 1024;
// copies of the candidates' high histogram, so that runs of equal keys
// do not wait on one counter
constexpr size_t kHighCopies = 4;

inline uint32_t order_key(float w) {
    uint32_t bits;
    std::memcpy(&bits, &w, sizeof(bits));
    return bits & 0x7fffffffu;
}

// The bucket of hist (the sum of `copies` histograms laid end to end),
// scanned from the top, where the running count starting at *above
// reaches `rank`; *above becomes the count of the buckets over it.
// Returns -1 where the whole histogram holds less.
inline int64_t bucket_at(const std::vector<uint32_t>& hist, size_t copies,
                         int64_t rank, int64_t* above) {
    const size_t n = hist.size() / copies;
    for (size_t b = n; b-- > 0;) {
        int64_t count = 0;
        for (size_t c = 0; c < copies; ++c) count += hist[c * n + b];
        if (*above + count >= rank) return static_cast<int64_t>(b);
        *above += count;
    }
    return -1;
}

// Appends the postings of one term whose key is at least t_lo to
// out_ids / out_w from pos; returns the new pos. Sets *bad where a
// weight is negative or NaN.
int64_t collect_scalar(const int32_t* ids, const float* src, int64_t n,
                       float m, uint32_t t_lo, int32_t* out_ids,
                       float* out_w, int64_t pos, bool* bad) {
    bool neg = false;
    for (int64_t i = 0; i < n; ++i) {
        const float w = src[i] * m;
        neg |= !(w >= 0.0f);
        if (order_key(w) >= t_lo) {
            out_ids[pos] = ids[i];
            out_w[pos] = w;
            ++pos;
        }
    }
    *bad |= neg;
    return pos;
}

// Writes the candidates past the cut key to out_ids / out_w from *pos,
// and of those at it the first *quota, until *pos reaches budget.
void keep_scalar(const int32_t* ids, const float* w, int64_t n,
                 uint32_t cut, int64_t* quota, int32_t* out_ids,
                 float* out_w, int64_t* pos, int64_t budget) {
    for (int64_t i = 0; i < n && *pos < budget; ++i) {
        const uint32_t k = order_key(w[i]);
        if (k > cut || (k == cut && *quota > 0)) {
            *quota -= k == cut;
            out_ids[*pos] = ids[i];
            out_w[*pos] = w[i];
            ++*pos;
        }
    }
}

#ifdef POSTINGS_HAVE_AVX2
// For each 8-bit lane mask, the lanes it keeps, packed to the front.
struct CompressTable {
    int32_t lanes[256][8];
    int32_t count[256];
    constexpr CompressTable() : lanes(), count() {
        for (int mask = 0; mask < 256; ++mask) {
            int c = 0;
            for (int lane = 0; lane < 8; ++lane) {
                if (mask >> lane & 1) lanes[mask][c++] = lane;
            }
            count[mask] = c;
        }
    }
};
constexpr CompressTable kCompress;

// Stores the lanes of `mask` of w and ids packed at out_w / out_ids (all
// eight lanes are written); returns how many were kept.
__attribute__((target("avx2")))
inline int32_t store_lanes(int mask, __m256 w, __m256i ids, float* out_w,
                           int32_t* out_ids) {
    const __m256i lanes = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(kCompress.lanes[mask]));
    _mm256_storeu_ps(out_w, _mm256_permutevar8x32_ps(w, lanes));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out_ids),
                        _mm256_permutevar8x32_epi32(ids, lanes));
    return kCompress.count[mask];
}

// collect_scalar eight lanes at a time; out_ids / out_w need 8 elements
// of room past the last kept.
__attribute__((target("avx2")))
int64_t collect_avx2(const int32_t* ids, const float* src, int64_t n,
                     float m, uint32_t t_lo, int32_t* out_ids, float* out_w,
                     int64_t pos, bool* bad) {
    const __m256 vm = _mm256_set1_ps(m);
    const __m256i sign_off = _mm256_set1_epi32(0x7fffffff);
    // keys are below 2^31, so a signed compare orders them
    const __m256i below = _mm256_set1_epi32(static_cast<int32_t>(t_lo) - 1);
    __m256 neg = _mm256_setzero_ps();
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        const __m256 w = _mm256_mul_ps(_mm256_loadu_ps(src + i), vm);
        neg = _mm256_or_ps(neg, _mm256_cmp_ps(w, _mm256_setzero_ps(),
                                              _CMP_NGE_UQ));
        const __m256i key = _mm256_and_si256(_mm256_castps_si256(w),
                                             sign_off);
        const int mask = _mm256_movemask_ps(
            _mm256_castsi256_ps(_mm256_cmpgt_epi32(key, below)));
        pos += store_lanes(mask, w, _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(ids + i)), out_w + pos,
            out_ids + pos);
    }
    *bad |= _mm256_movemask_ps(neg) != 0;
    return collect_scalar(ids + i, src + i, n - i, m, t_lo, out_ids, out_w,
                          pos, bad);
}

// keep_scalar eight lanes at a time while eight more fit the row; a
// group that holds keys equal to the cut settles them in lane order.
__attribute__((target("avx2")))
void keep_avx2(const int32_t* ids, const float* w, int64_t n, uint32_t cut,
               int64_t* quota, int32_t* out_ids, float* out_w, int64_t* pos,
               int64_t budget) {
    const __m256i vcut = _mm256_set1_epi32(static_cast<int32_t>(cut));
    const __m256i sign_off = _mm256_set1_epi32(0x7fffffff);
    int64_t i = 0;
    for (; i + 8 <= n && *pos + 8 <= budget; i += 8) {
        const __m256 wv = _mm256_loadu_ps(w + i);
        const __m256i key = _mm256_and_si256(_mm256_castps_si256(wv),
                                             sign_off);
        int mask = _mm256_movemask_ps(
            _mm256_castsi256_ps(_mm256_cmpgt_epi32(key, vcut)));
        int at_cut = _mm256_movemask_ps(
            _mm256_castsi256_ps(_mm256_cmpeq_epi32(key, vcut)));
        for (; at_cut && *quota > 0; at_cut &= at_cut - 1, --*quota) {
            mask |= at_cut & -at_cut;
        }
        *pos += store_lanes(mask, wv, _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(ids + i)), out_w + *pos,
            out_ids + *pos);
    }
    keep_scalar(ids + i, w + i, n - i, cut, quota, out_ids, out_w, pos,
                budget);
}
#endif

struct Row {
    const int64_t* terms;
    const float* mult;
    int64_t n_terms;
    const int64_t* indptr;
    const int32_t* doc_ids;
    const float* weights;
};

bool has_avx2() {
#ifdef POSTINGS_HAVE_AVX2
    static const bool avx2 = __builtin_cpu_supports("avx2");
    return avx2;
#else
    return false;
#endif
}

// Copies the row's postings whose key is at least t_lo, in gather order,
// to cand_ids / cand_w; returns their count, or -1 if a weight is
// negative or NaN.
int64_t collect(const Row& r, uint32_t t_lo, int32_t* cand_ids,
                float* cand_w) {
    int64_t pos = 0;
    bool bad = false;
    for (int64_t t = 0; t < r.n_terms; ++t) {
        const int64_t start = r.indptr[r.terms[t]];
        const int64_t n = r.indptr[r.terms[t] + 1] - start;
#ifdef POSTINGS_HAVE_AVX2
        if (has_avx2()) {
            pos = collect_avx2(r.doc_ids + start, r.weights + start, n,
                               r.mult[t], t_lo, cand_ids, cand_w, pos, &bad);
            continue;
        }
#endif
        pos = collect_scalar(r.doc_ids + start, r.weights + start, n,
                             r.mult[t], t_lo, cand_ids, cand_w, pos, &bad);
    }
    return bad ? -1 : pos;
}

// Cuts a row of `total` postings, past the budget, into out_ids / out_w.
// Returns 1 where the cut fell inside a group of equal weights (some
// postings of weight c dropped), 0 where it did not, -1 where a weight
// is negative or NaN.
int cut_row(const Row& r, int64_t total, int64_t budget, int32_t* out_ids,
            float* out_w, std::vector<uint32_t>& high,
            std::vector<uint32_t>& low) {
    // the sample's histogram, in the first copy of `high`
    std::fill(high.begin(), high.end(), 0u);
    int64_t base = 0;
    for (int64_t t = 0; t < r.n_terms; ++t) {
        const int64_t start = r.indptr[r.terms[t]];
        const int64_t n = r.indptr[r.terms[t] + 1] - start;
        const float m = r.mult[t];
        for (int64_t i = (kSampleEvery - base % kSampleEvery) % kSampleEvery;
             i < n; i += kSampleEvery) {
            const int64_t run = std::min(kSampleRun, n - i);
            for (int64_t j = i; j < i + run; ++j) {
                ++high[order_key(r.weights[start + j] * m) >> kLowBits];
            }
        }
        base += n;
    }
    const int64_t rank = (budget + budget / 8) * kSampleRun / kSampleEvery + 1;
    int64_t above = 0;
    const int64_t sampled = bucket_at(high, kHighCopies, rank, &above);
    uint32_t t_lo = sampled < 0 ? 0u : static_cast<uint32_t>(sampled) << kLowBits;

    std::unique_ptr<int32_t[]> cand_ids(new int32_t[total + 8]);
    std::unique_ptr<float[]> cand_w(new float[total + 8]);
    int64_t n_cand = collect(r, t_lo, cand_ids.get(), cand_w.get());
    if (n_cand >= 0 && n_cand < budget && t_lo > 0) {
        t_lo = 0;
        n_cand = collect(r, t_lo, cand_ids.get(), cand_w.get());
    }
    if (n_cand < 0) return -1;

    // c among the candidates: the bucket of its top bits, then its low bits
    std::fill(high.begin(), high.end(), 0u);
    for (int64_t i = 0; i < n_cand; ++i) {
        ++high[(i % kHighCopies) * kHighBuckets
               + (order_key(cand_w[i]) >> kLowBits)];
    }
    above = 0;
    const uint32_t hb = static_cast<uint32_t>(
        bucket_at(high, kHighCopies, budget, &above));
    std::fill(low.begin(), low.end(), 0u);
    for (int64_t i = 0; i < n_cand; ++i) {
        const uint32_t k = order_key(cand_w[i]);
        if ((k >> kLowBits) == hb) ++low[k & kLowMask];
    }
    const uint32_t lb = static_cast<uint32_t>(bucket_at(low, 1, budget, &above));
    const uint32_t cut = (hb << kLowBits) | lb;
    int64_t quota = budget - above;         // postings of weight c kept
    const int ties = low[lb] > quota ? 1 : 0;

    int64_t pos = 0;
#ifdef POSTINGS_HAVE_AVX2
    if (has_avx2()) {
        keep_avx2(cand_ids.get(), cand_w.get(), n_cand, cut, &quota, out_ids,
                  out_w, &pos, budget);
        return ties;
    }
#endif
    keep_scalar(cand_ids.get(), cand_w.get(), n_cand, cut, &quota, out_ids,
                out_w, &pos, budget);
    return ties;
}

}  // namespace

extern "C" {

// terms, mult: the batch's distinct term ids and multiplicities, query q's
// at [term_offsets[q], term_offsets[q + 1]). indptr, doc_ids, weights: the
// CSR index. out_ids, out_w: [n_queries, budget], every element written.
// out_totals: [n_queries], each query's postings before the cut.
// out_cut: [n_queries], 0 where the row fits, 1 where it was cut, 2 where
// it was cut inside a group of equal weights, so that the rule on ties
// decided what was kept. cut_seconds: the time spent on the rows cut.
// Returns 0, or -1 if a row past the budget holds a negative or NaN
// weight (its row and those past it are left unwritten).
int32_t bm25_gather_postings(
    const int64_t* terms, const float* mult, const int64_t* term_offsets,
    int64_t n_queries, const int64_t* indptr, const int32_t* doc_ids,
    const float* weights, int32_t n_docs, int64_t budget, int32_t* out_ids,
    float* out_w, int64_t* out_totals, uint8_t* out_cut,
    double* cut_seconds) {
    using clock = std::chrono::steady_clock;
    std::vector<uint32_t> high, low;
    clock::duration in_cut{0};
    *cut_seconds = 0.0;
    for (int64_t q = 0; q < n_queries; ++q) {
        const int64_t t0 = term_offsets[q];
        const int64_t t1 = term_offsets[q + 1];
        int64_t total = 0;
        for (int64_t t = t0; t < t1; ++t) {
            total += indptr[terms[t] + 1] - indptr[terms[t]];
        }
        out_totals[q] = total;
        int32_t* row_ids = out_ids + q * budget;
        float* row_w = out_w + q * budget;
        if (total > budget) {
            const clock::time_point begin = clock::now();
            if (high.empty()) {
                high.resize(kHighCopies * kHighBuckets);
                low.resize(size_t{1} << kLowBits);
            }
            const Row row{terms + t0, mult + t0, t1 - t0, indptr, doc_ids,
                          weights};
            const int ties = cut_row(row, total, budget, row_ids, row_w,
                                     high, low);
            in_cut += clock::now() - begin;
            if (ties < 0) return -1;
            out_cut[q] = static_cast<uint8_t>(1 + ties);
            continue;
        }
        out_cut[q] = 0;
        int64_t pos = 0;
        for (int64_t t = t0; t < t1; ++t) {
            const int64_t start = indptr[terms[t]];
            const int64_t n = indptr[terms[t] + 1] - start;
            std::memcpy(row_ids + pos, doc_ids + start,
                        static_cast<size_t>(n) * sizeof(int32_t));
            const float m = mult[t];
            const float* src = weights + start;
            float* dst = row_w + pos;
            for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * m;
            pos += n;
        }
        std::fill(row_ids + total, row_ids + budget, n_docs);
        std::fill(row_w + total, row_w + budget, 0.0f);
    }
    *cut_seconds = std::chrono::duration<double>(in_cut).count();
    return 0;
}

}  // extern "C"
