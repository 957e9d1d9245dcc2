"""Sparse (keyword) search: Okapi BM25 over CSR term postings.

The host side (``tokenize``, :class:`BM25Index`, :func:`build_bm25`) is
the JAX package's code verbatim: the index is plain numpy and the
serving path gathers postings on the host, through
:func:`gather_postings_batch`, the port's own: the verbatim budget and
gather, in one C++ call a batch, with the cut at the budget under the
written rule of :func:`cut_by_weight`. The device side:

- :func:`bm25_gather_postings_device`, the ``[Q, P]`` postings batch
  built on the device from postings resident there and the host's
  ``[Q, T]`` term metadata (``BM25Index.query_term_meta``); ``ops`` API
  only, as in the JAX package: the engine keeps the host gather, whose
  budget truncation keeps the heaviest postings where this one keeps
  the first in term order;
- :func:`bm25_score_batch`, a batched scatter-add of the postings into
  a ``[Q, N]`` score accumulator (in fixed point, so the same on every
  run), and :func:`bm25_topk` over it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch import native_ext
from legal_rag_tpu_torch.ops.dense import lax_top_k


def tokenize(text: str) -> List[str]:
    """The reference's BM25 tokenizer (create_vector_store.py:60):
    lowercase whitespace split, no stemming, no stopwords."""
    return text.lower().split()


@dataclasses.dataclass
class BM25Index:
    """CSR term-postings index with precomputed Okapi weights."""

    vocab: Dict[str, int]            # term -> term id
    indptr: np.ndarray               # [V+1] int64, postings row offsets
    doc_ids: np.ndarray              # [nnz] int32
    weights: np.ndarray              # [nnz] float32, precomputed BM25 weight
    idf: np.ndarray                  # [V] float32 (kept for introspection)
    doc_len: np.ndarray              # [N] int32
    n_docs: int
    avgdl: float
    k1: float
    b: float
    epsilon: float

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def query_term_ids(self, query: str) -> List[int]:
        """Token ids of a query, with multiplicity; unknown terms drop
        (they contribute zero in rank_bm25 as well)."""
        return [self.vocab[t] for t in tokenize(query) if t in self.vocab]

    def gather_postings(
        self, queries: Sequence[str], budget: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side postings gather for a query batch.

        Returns ``(doc_ids [Q, budget] int32, weights [Q, budget] f32)``
        padded with ``doc_id = n_docs`` (dropped by the device scatter).
        A query token appearing m times contributes its postings with
        weight scaled by m (BM25 query-term multiplicity).
        """
        q = len(queries)
        out_ids = np.full((q, budget), self.n_docs, dtype=np.int32)
        out_w = np.zeros((q, budget), dtype=np.float32)
        for qi, query in enumerate(queries):
            counts: Dict[int, int] = {}
            for t in self.query_term_ids(query):
                counts[t] = counts.get(t, 0) + 1
            if not counts:
                continue
            terms = np.fromiter(counts.keys(), np.int64, len(counts))
            mult = np.fromiter(counts.values(), np.float32, len(counts))
            starts = self.indptr[terms]
            lens = self.indptr[terms + 1] - starts
            total = int(lens.sum())
            if total == 0:
                continue
            # Segmented iota (vectorized — no per-term Python): flat
            # posting index p belongs to term seg[p]; its CSR offset is
            # start[seg] + (p - excl_cumsum[seg]).
            excl = np.cumsum(lens) - lens
            seg = np.repeat(np.arange(len(terms)), lens)
            idx = starts[seg] + np.arange(total, dtype=np.int64) - excl[seg]
            ids = self.doc_ids[idx]
            w = self.weights[idx] * mult[seg]
            if total > budget:
                # Budget overflow: impact-ordered truncation — keep the
                # globally highest-weight postings (low-IDF stopword
                # postings drop first), so a capped budget degrades
                # ranking as little as possible.
                keep = np.argpartition(-w, budget - 1)[:budget]
                ids, w = ids[keep], w[keep]
                total = budget
            out_ids[qi, :total] = ids
            out_w[qi, :total] = w
        return out_ids, out_w

    def query_term_meta(
        self, queries: Sequence[str], max_terms: Optional[int] = None
    ):
        """Host-side metadata for the DEVICE postings gather: per query
        term, its CSR row start, length, and multiplicity —
        ``(starts, lens, counts)`` each ``[Q, max_terms]`` int32. This
        is O(query terms) scalar work; the heavy postings movement then
        happens on-device (:func:`bm25_gather_postings_device`), which
        is the layout that scales when postings live in HBM.

        ``max_terms`` defaults to BM25Config.max_query_terms.
        """
        if max_terms is None:
            from legal_rag_tpu_torch.config import BM25Config

            max_terms = BM25Config.max_query_terms
        q = len(queries)
        starts = np.zeros((q, max_terms), dtype=np.int32)
        lens = np.zeros((q, max_terms), dtype=np.int32)
        counts = np.zeros((q, max_terms), dtype=np.int32)
        for qi, query in enumerate(queries):
            agg: Dict[int, int] = {}
            for t in self.query_term_ids(query):
                agg[t] = agg.get(t, 0) + 1
            for slot, (t, c) in enumerate(agg.items()):
                if slot >= max_terms:
                    break
                starts[qi, slot] = self.indptr[t]
                lens[qi, slot] = self.indptr[t + 1] - self.indptr[t]
                counts[qi, slot] = c
        return starts, lens, counts

    def postings_budget(
        self, queries: Sequence[str], cap: Optional[int] = None
    ) -> int:
        """Smallest power-of-two budget covering the batch (bucketed so
        jit recompiles at most log2 times).

        ``cap`` (config: ``BM25Config.postings_budget_cap``) bounds the
        buffer: a stopword-dense query over a large corpus can demand
        millions of postings, and the cap trades that for the
        impact-ordered truncation in :meth:`gather_postings` — the
        recall effect is measured in scripts/bench_hybrid_scale.py.
        """
        worst = 1
        for query in queries:
            total = 0
            for t in set(self.query_term_ids(query)):
                total += int(self.indptr[t + 1] - self.indptr[t])
            worst = max(worst, total)
        budget = 1 << max(0, (worst - 1).bit_length())
        if cap is not None:
            cap_p2 = 1 << max(0, (int(cap) - 1).bit_length())
            budget = min(budget, cap_p2)
        return budget


def build_bm25(
    corpus: Sequence[str],
    k1: float = 1.5,
    b: float = 0.75,
    epsilon: float = 0.25,
) -> BM25Index:
    """Build the CSR BM25 index from raw chunk texts.

    IDF follows BM25Okapi: ``ln((N - df + 0.5) / (df + 0.5))`` with
    negative values floored to ``epsilon * mean(idf)`` (the mean taken
    over the raw, pre-floor IDFs of the whole vocab).
    """
    tokenized = [tokenize(t) for t in corpus]
    n_docs = len(tokenized)
    doc_len = np.array([len(t) for t in tokenized], dtype=np.int32)
    avgdl = float(doc_len.sum()) / max(n_docs, 1)

    vocab: Dict[str, int] = {}
    # per-term dict of doc -> tf
    postings_tf: List[Dict[int, int]] = []
    for d, toks in enumerate(tokenized):
        for tok in toks:
            tid = vocab.get(tok)
            if tid is None:
                tid = len(vocab)
                vocab[tok] = tid
                postings_tf.append({})
            tf_map = postings_tf[tid]
            tf_map[d] = tf_map.get(d, 0) + 1

    v = len(vocab)
    df = np.array([len(p) for p in postings_tf], dtype=np.int64)
    raw_idf = np.log(n_docs - df + 0.5) - np.log(df + 0.5)
    avg_idf = float(raw_idf.mean()) if v else 0.0
    idf = np.where(raw_idf < 0, epsilon * avg_idf, raw_idf).astype(np.float32)

    indptr = np.zeros(v + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(df)
    nnz = int(indptr[-1])
    doc_ids = np.empty(nnz, dtype=np.int32)
    weights = np.empty(nnz, dtype=np.float32)
    norm_denom = k1 * (1.0 - b + b * doc_len / max(avgdl, 1e-9))
    for tid, tf_map in enumerate(postings_tf):
        lo = int(indptr[tid])
        # dict preserves insertion order = ascending doc id (docs are
        # scanned in order), so postings are sorted by doc id.
        for off, (d, tf) in enumerate(tf_map.items()):
            doc_ids[lo + off] = d
            weights[lo + off] = idf[tid] * tf * (k1 + 1.0) / (tf + norm_denom[d])

    return BM25Index(
        vocab=vocab,
        indptr=indptr,
        doc_ids=doc_ids,
        weights=weights,
        idf=idf,
        doc_len=doc_len,
        n_docs=n_docs,
        avgdl=avgdl,
        k1=k1,
        b=b,
        epsilon=epsilon,
    )


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class GatheredPostings(NamedTuple):
    budget: int
    ids: np.ndarray           # [Q, budget] int32, padded with n_docs
    weights: np.ndarray       # [Q, budget] float32, padded with 0
    impl: str                 # "native-cpp" or "python"
    truncated: int            # queries cut at the budget
    ties: int                 # of those, cut inside a group of equal weights
    cut_s: float              # seconds spent on the cut rows


def cut_by_weight(w: np.ndarray, budget: int) -> np.ndarray:
    """The positions of a query's postings that a budget keeps.

    ``w``: the float32 weights of the query's gathered postings in gather
    order (its distinct terms in first appearance, each term's postings
    in CSR order; ``weights[p] * mult`` as the gather forms them). With
    ``c`` the ``budget``-th largest weight, every posting above ``c`` is
    kept, and of those equal to ``c`` the first ``budget - count(w > c)``
    in gather order. Returns the kept positions ascending, so the cut row
    keeps the gather order; all of them where ``len(w) <= budget``.

    This is the served cut (``native/postings_gather.cpp`` writes the
    same rows). The verbatim ``BM25Index.gather_postings`` keeps the same
    postings above ``c`` and as many of weight ``c``, but which of those
    it keeps where not all fit is whatever ``np.argpartition`` leaves on
    the kept side: that choice is the one departure. (It also leaves a
    cut row in the partition's order, which the scatter's fixed-point
    sums do not see.) Weights must not be negative (BM25's idf floor is
    positive): a negative or NaN weight raises ValueError."""
    w = np.asarray(w, np.float32)
    if not (w >= 0).all():
        raise ValueError("posting weights must be non-negative")
    if len(w) <= budget:
        return np.arange(len(w))
    c = np.partition(w, len(w) - budget)[len(w) - budget]
    keep = w > c
    at_cut = np.flatnonzero(w == c)
    keep[at_cut[:budget - np.count_nonzero(keep)]] = True
    return np.flatnonzero(keep)


def _gather_python(index: BM25Index, terms: np.ndarray, mult: np.ndarray,
                   offsets: np.ndarray, budget: int):
    """The native call's rows, cut count, tie count and cut seconds in
    numpy: each query gathered uncut as ``BM25Index.gather_postings``
    gathers it, then cut by :func:`cut_by_weight`."""
    q = len(offsets) - 1
    out_ids = np.full((q, budget), index.n_docs, np.int32)
    out_w = np.zeros((q, budget), np.float32)
    truncated = ties = 0
    cut_s = 0.0
    for qi in range(q):
        t = terms[offsets[qi]:offsets[qi + 1]]
        starts = index.indptr[t]
        lens = index.indptr[t + 1] - starts
        total = int(lens.sum())
        seg = np.repeat(np.arange(len(t)), lens)
        idx = starts[seg] + np.arange(total) - (np.cumsum(lens) - lens)[seg]
        ids = index.doc_ids[idx]
        w = index.weights[idx] * mult[offsets[qi]:offsets[qi + 1]][seg]
        if total > budget:
            start = time.perf_counter()
            keep = cut_by_weight(w, budget)
            truncated += 1
            ties += int(np.count_nonzero(w >= w[keep].min()) > budget)
            ids, w = ids[keep], w[keep]
            cut_s += time.perf_counter() - start
        out_ids[qi, :len(ids)] = ids
        out_w[qi, :len(w)] = w
    return out_ids, out_w, truncated, ties, cut_s


def gather_postings_batch(
    index: BM25Index, queries: Sequence[str], cap: Optional[int] = None,
    lo: int = 8,
) -> GatheredPostings:
    """A query batch's postings at the budget of
    ``_pad_pow2(index.postings_budget(queries, cap), lo)``, with each
    query tokenized once and the whole batch gathered in one GIL-free C++
    call (``native_ext.gather_postings``). A query that fits is gathered
    as ``index.gather_postings`` gathers it, bit for bit; a query past the
    budget is cut by :func:`cut_by_weight`'s rule inside that call. Where
    the native library does not build, numpy gathers each query uncut and
    applies :func:`cut_by_weight` (``impl`` "python"): the same arrays."""
    terms: List[int] = []
    mult: List[int] = []
    offsets = [0]
    for query in queries:
        # dict order: the terms in first appearance, as gather_postings
        counts = Counter(index.query_term_ids(query))
        terms.extend(counts)
        mult.extend(counts.values())
        offsets.append(len(terms))
    terms_a = np.array(terms, np.int64)
    mult_a = np.array(mult, np.float32)
    offsets_a = np.array(offsets, np.int64)
    lens = index.indptr[terms_a + 1] - index.indptr[terms_a]
    ends = np.zeros(len(terms) + 1, np.int64)
    np.cumsum(lens, out=ends[1:])
    totals = ends[offsets_a[1:]] - ends[offsets_a[:-1]]
    # postings_budget's rule: the worst total (at least 1) to a power of
    # two, under the cap's power of two; then the engine's floor of lo
    budget = _pow2_at_least(max(1, int(totals.max(initial=0))))
    if cap is not None:
        budget = min(budget, _pow2_at_least(cap))
    budget = _pow2_at_least(max(budget, lo))
    if not native_ext.native_available():
        ids, w, truncated, ties, cut_s = _gather_python(
            index, terms_a, mult_a, offsets_a, budget)
        return GatheredPostings(budget, ids, w, "python", truncated, ties,
                                cut_s)
    ids, w, _, cut, cut_s = native_ext.gather_postings(
        terms_a, mult_a, offsets_a, index.indptr, index.doc_ids,
        index.weights, index.n_docs, budget)
    return GatheredPostings(budget, ids, w, "native-cpp",
                            int(np.count_nonzero(cut)),
                            int(np.count_nonzero(cut == 2)), cut_s)


# the fixed-point sums' fraction bits: a posting's weight is kept to
# 2**-32 (2.3e-10), far below fp32's step at a BM25 total of ~1
FIXED_POINT_BITS = 32


def to_fixed_point(w: torch.Tensor) -> torch.Tensor:
    """Weights as int64 multiples of ``2**-FIXED_POINT_BITS``, cut toward
    zero (scaling by a power of two is exact in fp32). Magnitudes must
    stay below ``2**31``."""
    return (w.float() * 2.0 ** FIXED_POINT_BITS).long()


def from_fixed_point(total: torch.Tensor) -> torch.Tensor:
    """An int64 fixed-point total as fp32: the conversion is its one
    rounding, the scaling back exact."""
    return total.float() * 2.0 ** -FIXED_POINT_BITS


def bm25_score_batch(
    post_ids: torch.Tensor, post_w: torch.Tensor, n_docs: int
) -> torch.Tensor:
    """Batched scatter-add scoring: ``[Q, P]`` postings -> ``[Q, N]``
    dense scores. Ids outside ``[0, n_docs)`` (the gather's ``n_docs``
    padding, or ``-1``) drop.

    Out-of-range ids are remapped to an extra sink column ``n_docs``
    that is sliced off, so no id wraps or faults. The sum is taken in
    64-bit fixed point: each weight cut (toward zero) to a multiple of
    ``2**-FIXED_POINT_BITS``, the integers summed, the total rounded
    once to fp32. Integer adds give the same total in any order, so the
    card's atomics give the same scores on every run and in every graph
    replay (an fp32 scatter-add changes in the last bits from run to
    run). Weights and totals must stay below ``2**31`` in magnitude;
    BM25's are tens.
    """
    q = post_ids.shape[0]
    post_ids = post_ids.long()
    post_ids = torch.where(
        (post_ids >= 0) & (post_ids < n_docs), post_ids, n_docs
    )
    acc = torch.zeros((q, n_docs + 1), dtype=torch.int64,
                      device=post_w.device)
    acc.scatter_add_(1, post_ids, to_fixed_point(post_w))
    return from_fixed_point(acc[:, :n_docs])


def bm25_gather_postings_device(
    starts: torch.Tensor,    # [Q, T] CSR row starts per query term
    lens: torch.Tensor,      # [Q, T] postings lengths
    counts: torch.Tensor,    # [Q, T] query-term multiplicities
    doc_ids: torch.Tensor,   # [nnz] int32, device-resident postings
    weights: torch.Tensor,   # [nnz] float32
    budget: int,             # output width P
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the ``[Q, P]`` (doc_id int32, weight fp32) postings batch
    on the device. Output slot ``p`` belongs to the term whose output
    range covers it (a segmented iota: ``start[term] + p -
    out_offset[term]``), so the postings move by two gathers and no
    scatter.

    Slots past a query's postings are ``(-1, 0.0)``; postings past the
    budget drop in term order.
    """
    starts, lens = starts.long(), lens.long()
    t = starts.shape[1]
    out_offs = torch.cumsum(lens, dim=1) - lens           # exclusive [Q, T]
    total = lens.sum(dim=1)                               # [Q]
    p = torch.arange(budget, device=starts.device).expand(starts.shape[0], -1)
    # the term owning slot p: (terms with out_offset <= p) - 1
    term_idx = torch.searchsorted(out_offs.contiguous(), p.contiguous(),
                                  right=True) - 1
    term_idx = term_idx.clamp(0, t - 1)

    def take(m):
        return torch.gather(m, 1, term_idx)

    within = p - take(out_offs)
    valid = (p < total[:, None]) & (within < take(lens))
    idx = torch.where(valid, take(starts) + within, 0)
    post_ids = torch.where(valid, doc_ids[idx], -1)
    post_w = torch.where(valid, weights[idx] * take(counts.float()), 0.0)
    return post_ids.int(), post_w


def bm25_topk(
    post_ids: torch.Tensor, post_w: torch.Tensor, n_docs: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add scoring and top-k: ``(scores [Q, k], ids [Q, k]
    int32)``, scores descending, ties to the lowest doc id."""
    top_s, top_i = lax_top_k(bm25_score_batch(post_ids, post_w, n_docs), k)
    return top_s, top_i.int()
