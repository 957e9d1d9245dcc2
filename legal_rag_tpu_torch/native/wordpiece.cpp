// C++ WordPiece tokenizer — native hot loop for host-side tokenization.
//
// The reference gets tokenization from HF `tokenizers` (Rust) via
// sentence-transformers; Rust is unavailable in this toolchain, so the
// framework ships this C++ implementation (loaded via ctypes, see
// legal_rag_tpu/native_ext.py) with the pure-Python tokenizer in
// models/wordpiece.py as the portable fallback. Behavior parity with
// the Python implementation is pinned by tests/test_native.py over the
// real legal corpus.
//
// Pipeline (BERT "basic" + WordPiece, matching models/wordpiece.py):
//   1. UTF-8 decode; drop control chars; space out CJK; normalize
//      whitespace.
//   2. Per WORD: lowercase (incl. the Final_Sigma context rule) + NFD
//      accent strip + combining-mark removal, all via tables generated
//      from CPython's unicodedata (gen_unicode_tables.py) — full
//      Unicode coverage, exact parity with the Python tokenizer.
//   3. Split punctuation (checked on the transformed codepoints, the
//      order the Python pipeline uses) into standalone tokens.
//   4. Greedy longest-match WordPiece with "##" continuations,
//      matching at codepoint boundaries; unmatchable words -> [UNK].
//
// Build: make -C legal_rag_tpu/native  (generates unicode_tables.h,
// then g++ -O2 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> table;
    int32_t unk_id = 0;
    int32_t cls_id = 0;
    int32_t sep_id = 0;
    int32_t pad_id = 0;
};

// ---------------- UTF-8 ----------------

// Decode one codepoint; advances i. Invalid bytes yield U+FFFD.
uint32_t decode_utf8(const unsigned char* s, size_t len, size_t& i) {
    unsigned char c = s[i];
    if (c < 0x80) { i += 1; return c; }
    if ((c >> 5) == 0x6 && i + 1 < len) {
        uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
        i += 2; return cp;
    }
    if ((c >> 4) == 0xE && i + 2 < len) {
        uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6)
                      | (s[i + 2] & 0x3F);
        i += 3; return cp;
    }
    if ((c >> 3) == 0x1E && i + 3 < len) {
        uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12)
                      | ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
        i += 4; return cp;
    }
    i += 1;
    return 0xFFFD;
}

void append_utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
        out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
        out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
        out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
}

// ---------------- character classes (generated tables) ----------------

bool in_ranges(uint32_t cp, const CpRange* table, int len) {
    int lo = 0, hi = len - 1;
    while (lo <= hi) {
        int mid = (lo + hi) / 2;
        if (cp < table[mid].lo) {
            hi = mid - 1;
        } else if (cp > table[mid].hi) {
            lo = mid + 1;
        } else {
            return true;
        }
    }
    return false;
}

// ASCII fast paths — legal corpora are overwhelmingly ASCII, so the
// hot loop should not binary-search for 'a'.
bool is_whitespace(uint32_t cp) {
    if (cp < 0x80)
        return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r';
    return in_ranges(cp, kSpaceRanges, kSpaceRanges_len);
}

bool is_control(uint32_t cp) {
    if (cp < 0x80)
        return (cp < 0x20 && cp != '\t' && cp != '\n' && cp != '\r') ||
               cp == 0x7F;
    return in_ranges(cp, kControlRanges, kControlRanges_len);
}

bool is_punctuation(uint32_t cp) {
    if (cp < 0x80)
        return (cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
               (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126);
    return in_ranges(cp, kPunctRanges, kPunctRanges_len);
}

bool is_cased_cp(uint32_t cp) {
    return in_ranges(cp, kCasedRanges, kCasedRanges_len);
}

bool is_case_ignorable_cp(uint32_t cp) {
    return in_ranges(cp, kCaseIgnorableRanges, kCaseIgnorableRanges_len);
}

// strip_Mn(NFD(lower(cp))); returns count written into out[MAX 4].
// Identity (count 1, out[0]=cp) when the table has no entry.
int transform_cp(uint32_t cp, uint32_t* out) {
    if (cp < 0x80) {  // ASCII: only A-Z transform
        out[0] = (cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
        return 1;
    }
    int lo = 0, hi = kTransforms_len - 1;
    while (lo <= hi) {
        int mid = (lo + hi) / 2;
        if (cp < kTransforms[mid].cp) {
            hi = mid - 1;
        } else if (cp > kTransforms[mid].cp) {
            lo = mid + 1;
        } else {
            for (int i = 0; i < kTransforms[mid].n; ++i)
                out[i] = kTransforms[mid].out[i];
            return kTransforms[mid].n;
        }
    }
    out[0] = cp;
    return 1;
}

bool is_cjk(uint32_t cp) {
    return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
           (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
           (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
           (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

constexpr uint32_t kCapitalSigma = 0x03A3;
constexpr uint32_t kSmallSigma = 0x03C3;
constexpr uint32_t kFinalSigma = 0x03C2;

// Whole-word lowercase + accent strip, matching str.lower()'s only
// context-sensitive rule (Final_Sigma) over the RAW codepoints, then
// per-cp transform. Words arrive whitespace-delimited, so the
// out-of-word context is never cased — in-word scanning suffices.
void transform_word(const std::vector<uint32_t>& raw,
                    std::vector<uint32_t>& out) {
    const size_t n = raw.size();
    uint32_t buf[4];
    for (size_t i = 0; i < n; ++i) {
        uint32_t cp = raw[i];
        if (cp == kCapitalSigma) {
            bool before = false;
            for (size_t j = i; j-- > 0;) {
                if (is_case_ignorable_cp(raw[j])) continue;
                before = is_cased_cp(raw[j]);
                break;
            }
            bool after = false;
            for (size_t j = i + 1; j < n; ++j) {
                if (is_case_ignorable_cp(raw[j])) continue;
                after = is_cased_cp(raw[j]);
                break;
            }
            out.push_back((before && !after) ? kFinalSigma : kSmallSigma);
            continue;
        }
        int m = transform_cp(cp, buf);
        for (int t = 0; t < m; ++t) out.push_back(buf[t]);
    }
}

constexpr size_t kMaxWordChars = 200;

void wordpiece_word(const Vocab& v, const std::string& word,
                    std::vector<int32_t>& out) {
    // count codepoints; oversized words -> UNK (BERT rule)
    size_t cps = 0;
    for (size_t i = 0; i < word.size();) {
        size_t j = i;
        decode_utf8(reinterpret_cast<const unsigned char*>(word.data()),
                    word.size(), j);
        i = j;
        ++cps;
    }
    if (cps > kMaxWordChars) { out.push_back(v.unk_id); return; }

    // codepoint boundary offsets
    std::vector<size_t> bounds;
    for (size_t i = 0; i < word.size();) {
        bounds.push_back(i);
        size_t j = i;
        decode_utf8(reinterpret_cast<const unsigned char*>(word.data()),
                    word.size(), j);
        i = j;
    }
    bounds.push_back(word.size());

    std::vector<int32_t> pieces;
    size_t start = 0;  // index into bounds
    const size_t n = bounds.size() - 1;
    while (start < n) {
        size_t end = n;
        int32_t found = -1;
        while (start < end) {
            std::string sub;
            if (start > 0) sub = "##";
            sub.append(word, bounds[start], bounds[end] - bounds[start]);
            auto it = v.table.find(sub);
            if (it != v.table.end()) { found = it->second; break; }
            --end;
        }
        if (found < 0) { out.push_back(v.unk_id); return; }
        pieces.push_back(found);
        start = end;
    }
    out.insert(out.end(), pieces.begin(), pieces.end());
}

void tokenize_text(const Vocab& v, const char* text, size_t len,
                   std::vector<int32_t>& out) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
    std::vector<uint32_t> raw, lowered;
    std::string piece;

    // Python order (models/wordpiece.py basic_tokenize): words are
    // whitespace/CJK-delimited with punctuation still INSIDE, the whole
    // word is lowercased+stripped, and only THEN is punctuation split —
    // so punctuation class is judged on transformed codepoints and
    // Final_Sigma sees the word's full raw context.
    auto flush_word = [&]() {
        if (raw.empty()) return;
        lowered.clear();
        transform_word(raw, lowered);
        raw.clear();
        piece.clear();
        for (uint32_t cp : lowered) {
            if (is_punctuation(cp)) {
                if (!piece.empty()) {
                    wordpiece_word(v, piece, out);
                    piece.clear();
                }
                std::string one;
                append_utf8(one, cp);
                wordpiece_word(v, one, out);
            } else {
                append_utf8(piece, cp);
            }
        }
        if (!piece.empty()) wordpiece_word(v, piece, out);
    };

    for (size_t i = 0; i < len;) {
        uint32_t cp = decode_utf8(s, len, i);
        if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
        if (is_whitespace(cp)) { flush_word(); continue; }
        if (is_cjk(cp)) {
            // CJK chars become standalone words (Python pads them with
            // spaces before the whitespace split)
            flush_word();
            raw.push_back(cp);
            flush_word();
            continue;
        }
        raw.push_back(cp);
    }
    flush_word();
}

}  // namespace

extern "C" {

void* wp_create(const char** tokens, int32_t n, int32_t unk_id,
                int32_t cls_id, int32_t sep_id, int32_t pad_id) {
    auto* v = new Vocab();
    v->table.reserve(static_cast<size_t>(n) * 2);
    for (int32_t i = 0; i < n; ++i) {
        v->table.emplace(tokens[i], i);
    }
    v->unk_id = unk_id;
    v->cls_id = cls_id;
    v->sep_id = sep_id;
    v->pad_id = pad_id;
    return v;
}

void wp_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode one text. Returns number of ids written (<= max_out).
// add_special wraps with [CLS]/[SEP] and truncates to max_len total.
int32_t wp_encode(void* handle, const char* text, int32_t text_len,
                  int32_t* out_ids, int32_t max_out, int32_t add_special,
                  int32_t max_len) {
    const Vocab& v = *static_cast<Vocab*>(handle);
    std::vector<int32_t> ids;
    ids.reserve(256);
    tokenize_text(v, text, static_cast<size_t>(text_len), ids);

    std::vector<int32_t> final_ids;
    if (add_special) {
        size_t body = ids.size();
        size_t cap = max_len >= 2 ? static_cast<size_t>(max_len - 2) : 0;
        if (body > cap) body = cap;
        final_ids.reserve(body + 2);
        final_ids.push_back(v.cls_id);
        final_ids.insert(final_ids.end(), ids.begin(), ids.begin() + body);
        final_ids.push_back(v.sep_id);
    } else {
        size_t body = ids.size();
        if (static_cast<int32_t>(body) > max_len) body = max_len;
        final_ids.assign(ids.begin(), ids.begin() + body);
    }
    int32_t count = static_cast<int32_t>(final_ids.size());
    if (count > max_out) count = max_out;
    std::memcpy(out_ids, final_ids.data(), sizeof(int32_t) * count);
    return count;
}

}  // extern "C"
