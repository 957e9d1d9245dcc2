"""Plain Okapi BM25 from the documents' own token streams.

The semantics of rank_bm25's ``BM25Okapi`` as the upstream deployment
builds it (``create_vector_store.py:55-61``: lowercase whitespace
tokens, k1 1.5, b 0.75, epsilon 0.25): ``idf = ln((N - df + 0.5) /
(df + 0.5))``, negative values floored to ``epsilon`` times the mean
raw idf over the vocabulary; a term's weight in a doc is ``idf * tf *
(k1 + 1) / (tf + k1 * (1 - b + b * len / avglen))``, times the term's
count in the query.

The served configuration caps the postings a query may gather
(``postings_cap``): a query whose terms carry more postings than the cap
keeps the heaviest ``cap`` of them and drops the rest. Postings whose
weight lies within a relative ``1e-6`` of the cut (the program keeps
its weights in float32) may fall on either side, so a doc's score is an
interval ``[lo, hi]``: ``lo`` counts the postings surely kept, ``hi``
adds those at the cut.

Everything is computed here again, in float64 on ``device``, from the
flat token ids and lengths that the benchmark generated; nothing is
read from the program's index.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

CUT_RTOL = 1e-6


class PlainBM25:
    def __init__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 vocab: Dict[str, int], k1: float = 1.5, b: float = 0.75,
                 epsilon: float = 0.25):
        """``tokens``: ``[T]`` term ids, docs concatenated; ``lengths``:
        ``[N]`` tokens a doc; ``vocab``: term text -> term id (ids that
        occur nowhere have df 0 and stay out of the idf mean)."""
        dev = tokens.device
        n = int(lengths.shape[0])
        self.n_docs = n
        self.vocab = vocab
        doc = torch.repeat_interleave(
            torch.arange(n, device=dev), lengths.long())
        key = tokens.long() * n + doc
        pairs, tf = torch.unique(key, return_counts=True)
        self.p_term = pairs // n
        self.p_doc = pairs % n
        self.tf = tf.double()
        n_terms = max(len(vocab), int(tokens.max()) + 1 if len(tokens) else 0)
        df = torch.bincount(self.p_term, minlength=n_terms)
        self.indptr = torch.zeros(n_terms + 1, dtype=torch.long, device=dev)
        self.indptr[1:] = torch.cumsum(df, 0)
        self.df = df
        present = df > 0
        raw_idf = (torch.log(n - df.double() + 0.5)
                   - torch.log(df.double() + 0.5))
        avg_idf = float(raw_idf[present].mean()) if bool(present.any()) else 0.0
        self.idf = torch.where(raw_idf < 0, epsilon * avg_idf, raw_idf)
        dl = lengths.double()
        avgdl = float(dl.sum()) / max(n, 1)
        self.norm = k1 * (1.0 - b + b * dl / avgdl)
        self.k1 = k1

    def term_counts(self, query: str) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for w in query.lower().split():
            t = self.vocab.get(w)
            if t is not None:
                counts[t] = counts.get(t, 0) + 1
        return counts

    def n_postings(self, query: str) -> int:
        """Postings of the query's distinct terms, before any cap."""
        return sum(int(self.df[t]) for t in self.term_counts(query))

    def postings(self, query: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(doc ids, weights)`` of every posting of the query's terms,
        each weight times the term's count in the query."""
        ids, ws = [], []
        for t, m in self.term_counts(query).items():
            lo, hi = int(self.indptr[t]), int(self.indptr[t + 1])
            d = self.p_doc[lo:hi]
            tf = self.tf[lo:hi]
            w = self.idf[t] * tf * (self.k1 + 1.0) / (tf + self.norm[d])
            ids.append(d)
            ws.append(w * m)
        if not ids:
            z = torch.zeros(0, device=self.indptr.device)
            return z.long(), z.double()
        return torch.cat(ids), torch.cat(ws)

    def scores(self, query: str, cap=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(lo [N], hi [N])`` float64 scores under the postings cap."""
        ids, w = self.postings(query)
        dev = self.indptr.device
        lo = torch.zeros(self.n_docs, dtype=torch.float64, device=dev)
        hi = torch.zeros_like(lo)
        if cap is not None and len(w) > cap:
            cut = float(torch.topk(w, cap).values[-1])
            sure = w > cut * (1 + CUT_RTOL)
            maybe = (~sure) & (w >= cut * (1 - CUT_RTOL))
            lo.index_add_(0, ids[sure], w[sure])
            hi.index_add_(0, ids[sure | maybe], w[sure | maybe])
            return lo, hi
        lo.index_add_(0, ids, w)
        return lo, lo.clone()


def vocab_from_texts(texts: Sequence[str]) -> Tuple[Dict[str, int], np.ndarray,
                                                     np.ndarray]:
    """Term ids by first occurrence over whitespace-lowercased texts:
    ``(vocab, flat token ids [T] int64, lengths [N] int64)``."""
    vocab: Dict[str, int] = {}
    flat: List[int] = []
    lengths = np.zeros(len(texts), np.int64)
    for i, text in enumerate(texts):
        toks = text.lower().split()
        lengths[i] = len(toks)
        for w in toks:
            t = vocab.get(w)
            if t is None:
                t = vocab[w] = len(vocab)
            flat.append(t)
    return vocab, np.asarray(flat, np.int64), lengths
