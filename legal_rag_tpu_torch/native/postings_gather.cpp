// BM25 postings gather for a whole query batch in one call: the padded
// [Q, budget] doc ids and weights the served hybrid search scores.
//
// The port's C++ counterpart of BM25Index.gather_postings
// (ops/sparse.py), which runs a dozen numpy calls a query. The caller
// tokenizes each query once and hands over its distinct term ids in
// first-appearance order with their multiplicities; per query, this
// writes the postings in the order the numpy code does:
//   row = for each term t, in order:  doc_ids[indptr[t]:indptr[t + 1]]
//   w   = for each term t, in order:  weights[indptr[t]:indptr[t + 1]] * mult[t]
// (float32 products, rounded once, as numpy's), then pads the row's rest
// with (n_docs, 0.0f). A query whose total passes the budget is written
// flat to the spill buffer instead, at spill_offsets[q], and its output
// row is left to the caller, who cuts it by weight with np.argpartition
// on that same array. No static state: threads call it concurrently.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// terms, mult: the batch's distinct term ids and multiplicities, query q's
// at [term_offsets[q], term_offsets[q + 1]). indptr, doc_ids, weights: the
// CSR index. out_ids, out_w: [n_queries, budget], every element of a row
// that fits written. out_totals: [n_queries], each query's postings.
// spill_offsets: [n_queries + 1], query q's room in spill_ids and spill_w
// at [spill_offsets[q], spill_offsets[q + 1]), empty where the row fits.
// Returns 0, or -1 if a query passing the budget has no room of its
// total's size in the spill buffer (nothing past that query is written).
int32_t bm25_gather_postings(
    const int64_t* terms, const float* mult, const int64_t* term_offsets,
    int64_t n_queries, const int64_t* indptr, const int32_t* doc_ids,
    const float* weights, int32_t n_docs, int64_t budget, int32_t* out_ids,
    float* out_w, int64_t* out_totals, const int64_t* spill_offsets,
    int32_t* spill_ids, float* spill_w) {
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
            if (spill_offsets[q + 1] - spill_offsets[q] != total) return -1;
            row_ids = spill_ids + spill_offsets[q];
            row_w = spill_w + spill_offsets[q];
        }
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
        if (total <= budget) {
            std::fill(row_ids + total, row_ids + budget, n_docs);
            std::fill(row_w + total, row_w + budget, 0.0f);
        }
    }
    return 0;
}

}  // extern "C"
