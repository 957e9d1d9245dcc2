"""Sparse-side levers for the paraphrase (sibling-span) split, on the
host: the counterpart of the JAX package's
``scripts/exp_paraphrase_sparse.py``, in numpy over the port's copy of
``ops.sparse`` (``tokenize``, ``BM25Index``, ``build_bm25``), so it
needs no card and gives the JAX script's numbers on the same chunks.

Two classic sparse levers can recover signal where word-level BM25 is
weakest without touching the encoder:

1. character n-gram BM25: morphology-level overlap ("punishable" ~
   "punishment") that word tokens miss;
2. pseudo-relevance feedback (PRF): expand the query with the
   highest-impact terms of the first-pass top docs.

Both (and their RRF fusions with word BM25) are scored on the sibling
and structure splits of a store's chunks. ``max_pairs`` caps each split
(the JAX script ran the full splits, the default here too).

Run:  python -m legal_rag_tpu_torch.scripts.exp_paraphrase_sparse
      --store DIR [--max-pairs N] [--report build/paraphrase_sparse.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from legal_rag_tpu_torch.evaluation import (
    labeled_pairs_from_chunks,
    mrr_at_k,
    recall_at_k,
    sibling_span_pairs_from_chunks,
)
from legal_rag_tpu_torch.ops.sparse import BM25Index, build_bm25, tokenize


# ---------------------------------------------------------------------------
# Char-ngram tokenization (fastText-style word-boundary markers)
# ---------------------------------------------------------------------------


def char_ngrams(word: str, nmin: int, nmax: int) -> List[str]:
    w = f"<{word}>"
    out = []
    for n in range(nmin, nmax + 1):
        if len(w) < n:
            break
        out.extend(w[i : i + n] for i in range(len(w) - n + 1))
    return out


def to_ngram_text(text: str, nmin: int, nmax: int) -> str:
    grams: List[str] = []
    for word in tokenize(text):
        grams.extend(char_ngrams(word, nmin, nmax))
    return " ".join(grams)


# ---------------------------------------------------------------------------
# Dense (full-corpus) BM25 scoring straight from the CSR index
# ---------------------------------------------------------------------------


def bm25_scores(index: BM25Index, query: str) -> np.ndarray:
    """Full [N] score vector for one query (numpy mirror of the device
    segsum scorer — fine at experiment scale)."""
    scores = np.zeros(index.n_docs, dtype=np.float64)
    counts: Dict[int, int] = {}
    for t in index.query_term_ids(query):
        counts[t] = counts.get(t, 0) + 1
    for t, mult in counts.items():
        lo, hi = int(index.indptr[t]), int(index.indptr[t + 1])
        scores[index.doc_ids[lo:hi]] += index.weights[lo:hi] * mult
    return scores


def scores_from_terms(
    index: BM25Index, term_weights: Dict[int, float]
) -> np.ndarray:
    scores = np.zeros(index.n_docs, dtype=np.float64)
    for t, wt in term_weights.items():
        lo, hi = int(index.indptr[t]), int(index.indptr[t + 1])
        scores[index.doc_ids[lo:hi]] += index.weights[lo:hi] * wt
    return scores


def prf_scores(
    index: BM25Index,
    query: str,
    fb_docs: int,
    fb_terms: int,
    beta: float,
    doc_term_cache: List[Optional[Dict[int, float]]],
    exclude: Optional[int] = None,
) -> np.ndarray:
    """Round 1 word BM25, expand with the top-``fb_terms`` impact terms
    of the top-``fb_docs`` docs, add beta-weighted expansion score."""
    base = bm25_scores(index, query)
    ranked = np.argsort(-base, kind="stable")
    picked: List[int] = []
    for d in ranked:
        if exclude is not None and int(d) == exclude:
            continue
        if base[d] <= 0.0:
            break
        picked.append(int(d))
        if len(picked) >= fb_docs:
            break
    agg: Dict[int, float] = {}
    qset = set(index.query_term_ids(query))
    for d in picked:
        terms = doc_term_cache[d]
        for t, impact in terms.items():
            if t in qset:
                continue
            agg[t] = agg.get(t, 0.0) + impact
    if not agg:
        return base
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:fb_terms]
    # normalize expansion weights to sum 1 so beta is comparable across
    # queries regardless of feedback-doc length
    total = sum(w for _, w in top)
    exp_terms = {t: w / total for t, w in top}
    return base + beta * scores_from_terms(index, exp_terms)


def build_doc_term_cache(index: BM25Index) -> List[Dict[int, float]]:
    """Per-doc map term -> BM25 impact (weight), from the CSR postings."""
    cache: List[Dict[int, float]] = [dict() for _ in range(index.n_docs)]
    v = index.vocab_size
    for t in range(v):
        lo, hi = int(index.indptr[t]), int(index.indptr[t + 1])
        w = index.weights[lo:hi]
        for off, d in enumerate(index.doc_ids[lo:hi]):
            cache[int(d)][t] = float(w[off])
    return cache


# ---------------------------------------------------------------------------
# Eval plumbing
# ---------------------------------------------------------------------------


def rrf_ranks(score_rows: Sequence[np.ndarray], k0: float = 60.0) -> np.ndarray:
    """RRF-fuse full score vectors: rank each, sum 1/(k0+rank)."""
    fused = np.zeros_like(score_rows[0])
    for s in score_rows:
        order = np.argsort(-s, kind="stable")
        ranks = np.empty_like(order)
        ranks[order] = np.arange(len(order))
        fused += 1.0 / (k0 + ranks + 1.0)
    return fused


def evaluate(
    name: str,
    score_fn,
    pairs: Sequence[Tuple],
    ks=(1, 5, 10),
    kmax: int = 11,
) -> Dict:
    n = len(pairs)
    ranked = np.full((n, kmax), -1, dtype=np.int64)
    for qi, p in enumerate(pairs):
        query = p[0]
        exclude = p[2] if len(p) > 2 else None
        s = score_fn(query, exclude)
        order = np.argsort(-s, kind="stable")[: kmax + 1]
        row = [int(d) for d in order if exclude is None or int(d) != exclude]
        ranked[qi, : min(len(row), kmax)] = row[:kmax]
    relevants = [p[1] for p in pairs]
    out = {f"recall@{k}": round(recall_at_k(ranked, relevants, k), 4) for k in ks}
    out["mrr"] = round(mrr_at_k(ranked, relevants, 10), 4)
    return out


def run(chunks: Sequence[Dict], nmin: int = 3, nmax: int = 5,
        fb_docs: int = 3, fb_terms: int = 10, beta: float = 0.5,
        max_pairs: Optional[int] = None, log=print) -> Dict:
    """Every variant's recall@k and MRR on both splits of ``chunks``."""
    texts = [c["text"] for c in chunks]
    t0 = time.time()
    word_idx = build_bm25(texts)
    ngram_texts = [to_ngram_text(t, nmin, nmax) for t in texts]
    char_idx = build_bm25(ngram_texts)
    doc_terms = build_doc_term_cache(word_idx)
    log(f"indexes built in {time.time()-t0:.1f}s — word V={word_idx.vocab_size}, "
        f"char[{nmin},{nmax}] V={char_idx.vocab_size}")

    splits = {
        "sibling": sibling_span_pairs_from_chunks(chunks, max_pairs=max_pairs),
        "structure": labeled_pairs_from_chunks(chunks, max_pairs=max_pairs),
    }

    def word_fn(q, _excl):
        return bm25_scores(word_idx, q)

    def char_fn(q, _excl):
        return bm25_scores(char_idx, to_ngram_text(q, nmin, nmax))

    def rrf_word_char(q, _excl):
        return rrf_ranks([word_fn(q, None), char_fn(q, None)])

    def prf_fn(q, _excl):
        return prf_scores(word_idx, q, fb_docs, fb_terms, beta, doc_terms)

    def prf_noself_fn(q, excl):
        # the sibling split's source chunk (rank-1 lexical self-match) is
        # barred from the feedback set, as in serving, where no
        # exact-match doc exists
        return prf_scores(word_idx, q, fb_docs, fb_terms, beta, doc_terms,
                          exclude=excl)

    def rrf_word_char_prf(q, excl):
        return rrf_ranks([prf_noself_fn(q, excl), char_fn(q, None)])

    variants = [
        ("word", word_fn),
        (f"char{nmin}{nmax}", char_fn),
        ("rrf(word,char)", rrf_word_char),
        (f"prf(b={beta},d={fb_docs},t={fb_terms})", prf_fn),
        ("prf-noself", prf_noself_fn),
        ("rrf(prf-noself,char)", rrf_word_char_prf),
    ]
    params = {"nmin": nmin, "nmax": nmax, "fb_docs": fb_docs,
              "fb_terms": fb_terms, "beta": beta, "max_pairs": max_pairs}
    report = {"params": params, "splits": {}}
    for split_name, pairs in splits.items():
        report["splits"][split_name] = {"n_queries": len(pairs), "modes": {}}
        for vname, fn in variants:
            t0 = time.time()
            entry = evaluate(vname, fn, pairs)
            report["splits"][split_name]["modes"][vname] = entry
            log(f"[{split_name}] {vname:28s} r@10={entry['recall@10']:.4f} "
                f"mrr={entry['mrr']:.4f}  ({time.time()-t0:.0f}s)")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--report", default=None)
    ap.add_argument("--nmin", type=int, default=3)
    ap.add_argument("--nmax", type=int, default=5)
    ap.add_argument("--fb-docs", type=int, default=3)
    ap.add_argument("--fb-terms", type=int, default=10)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--max-pairs", type=int, default=None)
    args = ap.parse_args(argv)
    chunks = json.loads((Path(args.store) / "chunks.json").read_text())
    print(f"{len(chunks)} chunks from {args.store}")
    report = run(chunks, args.nmin, args.nmax, args.fb_docs, args.fb_terms,
                 args.beta, args.max_pairs)
    report["store"] = args.store
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2))
        print(f"report -> {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
