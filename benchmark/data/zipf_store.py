"""A million chunks of the legal corpus's shape, drawn on the device.

The law of ``legal_rag_tpu_torch/index/synthetic.py`` (frozen here):
chunk lengths lognormal with mean 104 tokens and sigma 0.5, cut to
8-400; tokens drawn from a Zipf(1) vocabulary, ``p(rank) ~ 1 / (rank +
2.7)``, whose head is the frequent function words of legal text and
whose tail is pronounceable synthetic words. Where the original draws
and sorts on the host (15.6 s for the tokens and 38.8 s for the index
at 1M docs on a CPU), this copy draws the tokens and builds the Okapi
CSR (term, then ascending doc) on the card, with the arithmetic of the
port's ``build_bm25`` in the same dtypes (float32 idf and numerator,
float64 denominator, float32 weight). The store's chunks are made only
when read (their text from their tokens), so no million dicts are built.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.data.inputs import padded_wordpiece_vocab
from benchmark.data.weights import generator

MEAN_LEN = 104.0
SIGMA = 0.5
HEAD = ["the", "of", "and", "to", "a", "in", "is", "for", "or", "be",
        "by", "any", "shall", "such", "with", "as", "on", "which",
        "who", "that", "under", "may", "it", "from", "at", "this",
        "was", "are", "what", "i", "my", "me", "how", "can", "just"]
_CONSONANTS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"
_SYLLABLES = [c + v for c in _CONSONANTS for v in _VOWELS]


def ranked_words(size: int) -> List[str]:
    """The vocabulary in rank order: the head, then synthetic words of
    2-3 syllables."""
    out = list(HEAD)
    taken = set(out)
    n_syl = len(_SYLLABLES)
    i = 0
    while len(out) < size:
        if i < n_syl ** 2:
            w = _SYLLABLES[i // n_syl] + _SYLLABLES[i % n_syl]
        else:
            j = i - n_syl ** 2
            w = (_SYLLABLES[j // n_syl ** 2] + _SYLLABLES[(j // n_syl) % n_syl]
                 + _SYLLABLES[j % n_syl])
        if w not in taken:
            out.append(w)
            taken.add(w)
        i += 1
    return out


class LazyChunks:
    """The store's chunks, each made when read: ``text`` from the doc's
    tokens, a header and a section id from its row."""

    def __init__(self, tokens: np.ndarray, starts: np.ndarray,
                 lengths: np.ndarray, words: np.ndarray):
        self._tokens, self._starts, self._lengths = tokens, starts, lengths
        self._words = words

    def __len__(self) -> int:
        return len(self._lengths)

    def text(self, i: int) -> str:
        lo = int(self._starts[i])
        return " ".join(self._words[self._tokens[lo:lo + int(self._lengths[i])]])

    def __getitem__(self, i: int) -> Dict:
        i = int(i)
        if i < 0 or i >= len(self):
            raise IndexError(i)
        return {"text": self.text(i), "canonical_header": f"SYN {i:07d}",
                "section_id": f"SYN_{i:07d}",
                "metadata": {"law": "SYN", "section": str(i),
                             "unit_type": "section"}}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def zipf_corpus(seed: int, n_docs: int, vocab_size: int, device,
                k1: float, b: float, epsilon: float) -> Dict:
    """The corpus and its Okapi CSR: ``{"tokens", "lengths", "words",
    "chunks", "csr"}``, the arrays on the host."""
    words = ranked_words(vocab_size)
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float64, device=device)
    p = 1.0 / (ranks + 2.7)
    cdf = torch.cumsum(p / p.sum(), 0)
    cdf[-1] = 1.0
    g = generator(seed, "zipf_lengths", device)
    mu = float(np.log(MEAN_LEN) - SIGMA ** 2 / 2)
    lengths = torch.exp(mu + SIGMA * torch.randn(n_docs, generator=g,
                                                 device=device,
                                                 dtype=torch.float64))
    lengths = lengths.clamp(8, 400).long()
    total = int(lengths.sum())
    g = generator(seed, "zipf_tokens", device)
    tokens = torch.empty(total, dtype=torch.int32, device=device)
    step = 1 << 25
    for lo in range(0, total, step):
        hi = min(total, lo + step)
        u = torch.rand(hi - lo, generator=g, device=device, dtype=torch.float64)
        tokens[lo:hi] = torch.searchsorted(cdf, u, right=True).clamp(
            max=vocab_size - 1).int()
    csr = _okapi_csr(tokens, lengths, n_docs, vocab_size, k1, b, epsilon)
    tokens_h = tokens.cpu().numpy()
    lengths_h = lengths.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(lengths_h)[:-1]])
    words_arr = np.asarray(words, dtype=object)
    present = csr.pop("present")
    csr["vocab"] = {words[t]: i for i, t in enumerate(present.tolist())}
    return {"tokens": tokens_h, "lengths": lengths_h, "words": words,
            "chunks": LazyChunks(tokens_h, starts, lengths_h, words_arr),
            "csr": csr}


def _okapi_csr(tokens, lengths, n_docs, vocab_size, k1, b, epsilon) -> Dict:
    """The CSR of ``build_bm25`` over the token streams, on the device:
    terms that occur, in rank order; postings by term then doc."""
    dev = tokens.device
    doc = torch.repeat_interleave(torch.arange(n_docs, device=dev), lengths)
    pairs, tf = torch.unique(tokens.long() * n_docs + doc, return_counts=True)
    del doc
    p_rank = pairs // n_docs
    p_doc = (pairs % n_docs).int()
    del pairs
    df_all = torch.bincount(p_rank, minlength=vocab_size)
    present = torch.nonzero(df_all).flatten()
    term_of_rank = torch.full((vocab_size,), -1, dtype=torch.long, device=dev)
    term_of_rank[present] = torch.arange(len(present), device=dev)
    p_term = term_of_rank[p_rank]
    df = df_all[present]
    raw_idf = torch.log(n_docs - df.double() + 0.5) - torch.log(df.double() + 0.5)
    avg_idf = float(raw_idf.mean())
    idf = torch.where(raw_idf < 0, epsilon * avg_idf, raw_idf).float()
    doc_len = lengths.int()
    avgdl = float(doc_len.double().sum()) / max(n_docs, 1)
    norm_denom = k1 * (1.0 - b + b * doc_len.double() / max(avgdl, 1e-9))
    num = idf[p_term] * tf.float() * torch.tensor(k1 + 1.0, dtype=torch.float32,
                                                  device=dev)
    weights = (num.double() / (tf.double() + norm_denom[p_doc.long()])).float()
    indptr = torch.zeros(len(present) + 1, dtype=torch.long, device=dev)
    indptr[1:] = torch.cumsum(df, 0)
    return {"indptr": indptr.cpu().numpy(), "doc_ids": p_doc.cpu().numpy(),
            "weights": weights.cpu().numpy(), "idf": idf.cpu().numpy(),
            "doc_len": doc_len.cpu().numpy(), "avgdl": avgdl,
            "present": present.cpu().numpy()}


def wordpiece_vocab(chunks: LazyChunks, size: int) -> Dict[str, int]:
    """The encoder's vocabulary, built from every 500th doc's text (the
    original samples 2,000 docs of a million), padded to ``size``."""
    step = max(1, len(chunks) // 2000)
    return padded_wordpiece_vocab([chunks.text(i)
                                   for i in range(0, len(chunks), step)],
                                  size)


def make(config: Dict, seed: int, device):
    """The ``zipf_store`` of ``config``: ``n_docs`` chunks, unit doc
    embeddings, the encoders' weights, a vocabulary from a sample of the
    text and the Okapi CSR, all from ``seed``."""
    from benchmark.data.inputs import Inputs
    from benchmark.data.weights import (
        cross_encoder_params, minilm_params, unit_embeddings,
    )

    enc, bm = config["encoder"], config["retrieval"]["bm25"]
    corpus = zipf_corpus(seed, config["n_docs"], config["vocab_size"], device,
                         bm["k1"], bm["b"], bm["epsilon"])
    wp_vocab = wordpiece_vocab(corpus["chunks"], enc["vocab_size"])
    emb = unit_embeddings(seed, config["n_docs"], enc["hidden"], device)
    return Inputs(
        chunks=corpus["chunks"],
        embeddings=emb.cpu().numpy(),
        wp_vocab=wp_vocab,
        encoder_params=minilm_params(seed, "encoder", enc, len(wp_vocab),
                                     device),
        ce_params=cross_encoder_params(seed, config["cross_encoder"],
                                       len(wp_vocab), device),
        ce_alpha=config["cross_encoder"]["alpha"],
        bm25_tokens=corpus["tokens"], bm25_lengths=corpus["lengths"],
        bm25_vocab={w: i for i, w in enumerate(corpus["words"])},
        csr=corpus["csr"],
        ranked_words=corpus["words"],
    )
