"""Sparse (keyword) search: Okapi BM25 over CSR term postings.

The host side (``tokenize``, :class:`BM25Index`, :func:`build_bm25`) is
the JAX package's code verbatim: the index is plain numpy and the
postings gather runs on the host. The device side is
:func:`bm25_score_batch`, a batched scatter-add of the ``[Q, P]``
postings into a ``[Q, N]`` score accumulator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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


def bm25_score_batch(
    post_ids: torch.Tensor, post_w: torch.Tensor, n_docs: int
) -> torch.Tensor:
    """Batched scatter-add scoring: ``[Q, P]`` postings -> ``[Q, N]``
    dense scores. Ids outside ``[0, n_docs)`` (the gather's ``n_docs``
    padding, or ``-1``) drop.

    Out-of-range ids are remapped to an extra sink column ``n_docs``
    that is sliced off, so no id wraps or faults. On a CUDA tensor the
    scatter uses atomics: the summation order, and so the last bits of
    a doc's total, can change from run to run.
    """
    q = post_ids.shape[0]
    post_ids = post_ids.long()
    post_ids = torch.where(
        (post_ids >= 0) & (post_ids < n_docs), post_ids, n_docs
    )
    scores = torch.zeros(
        (q, n_docs + 1), dtype=torch.float32, device=post_w.device
    )
    scores.scatter_add_(1, post_ids, post_w.float())
    return scores[:, :n_docs]
