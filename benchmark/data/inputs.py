"""What the benchmark generates from a seed and hands to both sides."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Inputs:
    chunks: Sequence[Dict]          # the store's chunks (chunks.json form)
    embeddings: np.ndarray          # [N, D] float32 unit doc embeddings
    wp_vocab: Dict[str, int]        # the encoders' WordPiece vocabulary
    encoder_params: Dict            # MiniLM pytree (JAX layout, float32)
    ce_params: Dict                 # {"trunk": pytree, "head": {"w", "b"}}
    ce_alpha: float                 # the cross-encoder's blend weight
    bm25_tokens: np.ndarray         # [T] BM25 term ids, docs concatenated
    bm25_lengths: np.ndarray        # [N] BM25 tokens a doc
    bm25_vocab: Dict[str, int]      # BM25 term -> id of bm25_tokens
    csr: Optional[Dict] = None      # a prepared Okapi CSR (large stores),
                                    # None: the program indexes the texts
    ranked_words: Optional[List[str]] = None   # vocabulary by frequency

    @property
    def n_docs(self) -> int:
        return int(self.embeddings.shape[0])


def padded_wordpiece_vocab(texts: Iterable[str], size: int) -> Dict[str, int]:
    """The WordPiece vocabulary built from ``texts``, padded to ``size``
    pieces with ``[unusedN]`` entries (as BERT's vocabulary has them,
    and which no text tokenizes to), so that the encoders' word tables
    have the published vocabulary's rows."""
    from benchmark.reference.wordpiece import build_wordpiece_vocab

    vocab = build_wordpiece_vocab(texts, size=size)
    i = 0
    while len(vocab) < size:
        vocab.setdefault(f"[unused{i}]", len(vocab))
        i += 1
    return vocab
