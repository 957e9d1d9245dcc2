// Cross-encoder pair encoding in one call: B (query, document) pairs to
// the padded [B, L] ids, mask and segment ids of a rerank batch.
//
// The port's C++ counterpart of CrossEncoder.encode_pairs
// (models/cross_encoder.py), which runs the Python tokenizer once a text.
// It tokenizes through wordpiece.cpp's wp_encode, linked into the same
// library (native_ext.py), and lays the rows out as encode_pairs and
// pad_and_bucket (models/wordpiece.py) do:
//   q_ids  = encode(q, max_len, no specials)[:max_len / 2 - 2]
//   d_ids  = encode(d, max_len, no specials)[:max_len - len(q_ids) - 3]
//   row    = [CLS] q_ids [SEP] d_ids [SEP]
//   types  = 0 over len(q_ids) + 2 positions, 1 over len(d_ids) + 1
//   L      = min(max_len, max(32, next power of two >= longest row))
// with Python's slice semantics (a negative stop counts from the end),
// rows cut to L, and pad_id, mask 0 and type 0 past each row's end.
// A query equal to the previous pair's is tokenized once.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int32_t wp_encode(void* handle, const char* text,
                             int32_t text_len, int32_t* out_ids,
                             int32_t max_out, int32_t add_special,
                             int32_t max_len);

namespace {

// len(x[:stop]) for a list of n items.
int64_t slice_len(int64_t n, int64_t stop) {
    if (stop < 0) stop += n;
    if (stop < 0) return 0;
    return stop < n ? stop : n;
}

}  // namespace

extern "C" {

// texts: the 2B texts, UTF-8, query then document of each pair, text i
// at [offsets[i], offsets[i + 1]). out_ids, out_mask, out_tt hold at
// least B * max_len int32 each; the [B, L] rows are written contiguous
// from their start. Returns L, or -1 if max_len < 1.
int32_t wp_encode_pairs(void* handle, const char* texts,
                        const int64_t* offsets, int32_t B, int32_t max_len,
                        int32_t pad_id, int32_t* out_ids, int32_t* out_mask,
                        int32_t* out_tt) {
    if (max_len < 1) return -1;
    // [CLS] and [SEP] as the handle has them: an empty text with specials
    int32_t special[2];
    wp_encode(handle, "", 0, special, 2, 1, 2);
    const int32_t cls_id = special[0];
    const int32_t sep_id = special[1];

    const int64_t q_budget = max_len / 2 - 2;
    std::vector<int32_t> buf(static_cast<size_t>(max_len));
    std::vector<std::vector<int32_t>> rows(static_cast<size_t>(B));
    std::vector<int64_t> q_lens(static_cast<size_t>(B));
    std::vector<int32_t> q_ids;
    const char* last_q = nullptr;
    int64_t last_q_len = -1;
    int64_t longest = 1;                 // pad_and_bucket's default
    for (int32_t i = 0; i < B; ++i) {
        const char* q = texts + offsets[2 * i];
        const int64_t q_len = offsets[2 * i + 1] - offsets[2 * i];
        if (q_len != last_q_len || std::memcmp(q, last_q, q_len) != 0) {
            int32_t n = wp_encode(handle, q, static_cast<int32_t>(q_len),
                                  buf.data(), max_len, 0, max_len);
            q_ids.assign(buf.begin(), buf.begin() + slice_len(n, q_budget));
            last_q = q;
            last_q_len = q_len;
        }
        const char* d = texts + offsets[2 * i + 1];
        const int64_t d_len = offsets[2 * i + 2] - offsets[2 * i + 1];
        int32_t n = wp_encode(handle, d, static_cast<int32_t>(d_len),
                              buf.data(), max_len, 0, max_len);
        const int64_t d_cap =
            static_cast<int64_t>(max_len) - static_cast<int64_t>(q_ids.size()) - 3;
        const int64_t n_d = slice_len(n, d_cap);

        std::vector<int32_t>& row = rows[static_cast<size_t>(i)];
        row.reserve(q_ids.size() + static_cast<size_t>(n_d) + 3);
        row.push_back(cls_id);
        row.insert(row.end(), q_ids.begin(), q_ids.end());
        row.push_back(sep_id);
        row.insert(row.end(), buf.begin(), buf.begin() + n_d);
        row.push_back(sep_id);
        q_lens[static_cast<size_t>(i)] = static_cast<int64_t>(q_ids.size());
        if (static_cast<int64_t>(row.size()) > longest) {
            longest = static_cast<int64_t>(row.size());
        }
    }

    int64_t L = 1;
    while (L < longest) L <<= 1;
    if (L < 32) L = 32;
    if (L > max_len) L = max_len;

    for (int32_t i = 0; i < B; ++i) {
        const std::vector<int32_t>& row = rows[static_cast<size_t>(i)];
        const int64_t n = static_cast<int64_t>(row.size()) < L
                              ? static_cast<int64_t>(row.size()) : L;
        const int64_t n_q = q_lens[static_cast<size_t>(i)] + 2;
        int32_t* ids = out_ids + i * L;
        int32_t* mask = out_mask + i * L;
        int32_t* tt = out_tt + i * L;
        for (int64_t j = 0; j < L; ++j) {
            const bool in_row = j < n;
            ids[j] = in_row ? row[static_cast<size_t>(j)] : pad_id;
            mask[j] = in_row ? 1 : 0;
            tt[j] = in_row && j >= n_q ? 1 : 0;
        }
    }
    return static_cast<int32_t>(L);
}

}  // extern "C"
