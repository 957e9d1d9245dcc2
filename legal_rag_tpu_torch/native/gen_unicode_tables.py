"""Generate unicode_tables.h for the native WordPiece tokenizer.

The native tokenizer must tokenize EXACTLY like the pure-Python one
(models/wordpiece.py), whose semantics come from CPython's unicodedata.
Hand-written Latin-range tables can't cover that (ADVICE r1: U+0964,
Turkish İ, Greek/Cyrillic case all diverged), so this generator derives
every table from the local CPython — the same oracle the parity tests
compare against:

- PUNCT / SPACE / CONTROL ranges straight from unicodedata categories
  (matching _is_punctuation/_is_whitespace/_is_control, including
  BERT's ASCII punctuation overrides and the \\t\\n\\r carve-outs),
- a TRANSFORM map: cp -> strip_Mn(NFD(lower(cp))) wherever that differs
  from the identity (covers case mapping incl. one-to-many like İ,
  accent stripping, and combining-mark deletion in one table),
- the Final_Sigma context sets (CASED / CASE_IGNORABLE), derived
  EMPIRICALLY by probing str.lower() — "Σ"+c lowers to "σ…" iff c is
  cased; "Σ"+c+"A" lowers to "σ…" with c non-cased iff c is
  case-ignorable. str.lower()'s only context-sensitive rule is
  Final_Sigma, so per-codepoint transforms plus these two sets
  reproduce whole-word lowering exactly.

Run: python gen_unicode_tables.py [out.h]   (the Makefile does this)
"""

import sys
import unicodedata

MAX_CP = 0x110000
MAX_OUT = 4  # longest strip(lower(ch)) sequence we allow


def _transform(ch: str) -> str:
    lowered = ch.lower()
    return "".join(
        c for c in unicodedata.normalize("NFD", lowered)
        if unicodedata.category(c) != "Mn"
    )


def ranges(pred):
    out = []
    start = None
    for cp in range(MAX_CP):
        if pred(cp):
            if start is None:
                start = cp
        elif start is not None:
            out.append((start, cp - 1))
            start = None
    if start is not None:
        out.append((start, MAX_CP - 1))
    return out


def main(path="unicode_tables.h"):
    def cat(cp):
        return unicodedata.category(chr(cp))

    def is_control(cp):
        if cp in (0x09, 0x0A, 0x0D):
            return False
        return cat(cp).startswith("C")

    def is_space(cp):
        return cp in (0x20, 0x09, 0x0A, 0x0D) or cat(cp) == "Zs"

    def is_punct(cp):
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
                or (123 <= cp <= 126):
            return True
        return cat(cp).startswith("P")

    # Final_Sigma context sets, CPython as oracle: Σ lowers to ς iff
    # preceded (skipping case-ignorables) by a cased char and not
    # followed (likewise) by one. A leading probe char exercises the
    # "preceded by" predicate directly:
    #   (c + "Σ").lower() ends in ς        <=> c is cased
    #   ("A" + c + "Σ").lower() ends in ς  <=> c is case-ignorable
    #     (the cased A is visible through c), for non-cased c.
    def is_cased(cp):
        if cat(cp) == "Cs":
            return False
        return (chr(cp) + "Σ").lower().endswith("ς")

    def is_case_ignorable(cp):
        if cat(cp) == "Cs" or is_cased(cp):
            return False
        return ("A" + chr(cp) + "Σ").lower().endswith("ς")

    transforms = []
    for cp in range(MAX_CP):
        if cat(cp) in ("Cs",):  # surrogates: chr() ops on them misbehave
            continue
        ch = chr(cp)
        if cp == 0x03A3:
            continue  # Σ handled contextually in the tokenizer
        t = _transform(ch)
        if t != ch:
            cps = [ord(c) for c in t]
            assert len(cps) <= MAX_OUT, (hex(cp), t)
            transforms.append((cp, cps))

    # self-check: per-cp transform + Final_Sigma == str.lower for words
    import random

    rng = random.Random(0)
    pool = [chr(rng.randrange(0x20, 0x2FA20)) for _ in range(4000)]
    pool = [c for c in pool if not unicodedata.category(c).startswith("C")]
    tmap = dict(transforms)

    def model_word(word):
        out = []
        chars = [ord(c) for c in word]
        for i, cp in enumerate(chars):
            if cp == 0x03A3:
                before = any(
                    is_cased(p)
                    for p in _first_non_ignorable(chars[:i][::-1])
                )
                after = any(
                    is_cased(p) for p in _first_non_ignorable(chars[i + 1:])
                )
                out.append(0x03C2 if (before and not after) else 0x03C3)
                continue
            out.extend(tmap.get(cp, [cp]))
        return "".join(map(chr, out))

    def _first_non_ignorable(seq):
        for p in seq:
            if is_case_ignorable(p):
                continue
            return [p]
        return []

    for _ in range(3000):
        w = "".join(rng.choice(pool) for _ in range(rng.randrange(1, 6)))
        if rng.random() < 0.5:
            pos = rng.randrange(len(w) + 1)
            w = w[:pos] + "Σ" + w[pos:]
        want = _transform(w)
        got = model_word(w)
        assert got == want, (repr(w), repr(want), repr(got))

    parts = []
    parts.append("// GENERATED by gen_unicode_tables.py — do not edit.")
    parts.append(f"// unicodedata {unicodedata.unidata_version}, "
                 f"python {sys.version.split()[0]}")
    parts.append("#pragma once\n#include <cstdint>\n")
    parts.append("struct CpRange { uint32_t lo, hi; };")
    parts.append(
        "struct CpTransform { uint32_t cp; uint8_t n; uint32_t out[%d]; };"
        % MAX_OUT
    )

    def emit_ranges(name, rs):
        body = ",".join(f"{{{a},{b}}}" for a, b in rs)
        parts.append(
            f"static const CpRange {name}[] = {{{body}}};\n"
            f"static const int {name}_len = {len(rs)};"
        )

    emit_ranges("kPunctRanges", ranges(is_punct))
    emit_ranges("kSpaceRanges", ranges(is_space))
    emit_ranges("kControlRanges", ranges(is_control))
    emit_ranges("kCasedRanges", ranges(is_cased))
    emit_ranges("kCaseIgnorableRanges", ranges(is_case_ignorable))

    rows = []
    for cp, cps in transforms:
        padded = cps + [0] * (MAX_OUT - len(cps))
        rows.append(
            f"{{{cp},{len(cps)},{{{','.join(map(str, padded))}}}}}"
        )
    parts.append(
        "static const CpTransform kTransforms[] = {%s};\n"
        "static const int kTransforms_len = %d;" % (",".join(rows), len(rows))
    )

    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(parts) + "\n")
    print(
        f"wrote {path}: punct {len(ranges(is_punct))} ranges, "
        f"transforms {len(transforms)} entries"
    )


if __name__ == "__main__":
    main(*sys.argv[1:])
