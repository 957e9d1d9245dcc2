"""The bytes kernel K1 (``csrc/segmax_rm.cu``, the dense channel's first
phase at a large store) needs for one search, counting only what the
inputs need, as ``counting.py`` does, so that the count does not move
when the implementation does: the doc matrix read once in its stored
type and the real queries' float32 embeddings. What K1 writes (one max
a segment and query) is its own choice of layout and is not counted."""

from __future__ import annotations

from benchmark.layers.counting import HBM_BYTES_PER_S


def k1_bytes(q_real: int, n_docs: int, dim: int, doc_bytes: int) -> int:
    return n_docs * dim * doc_bytes + q_real * dim * 4


def k1_least_seconds(q_real: int, n_docs: int, dim: int,
                     doc_bytes: int) -> float:
    """The least time one search's K1 could take: its bytes over the
    card's memory rate."""
    return k1_bytes(q_real, n_docs, dim, doc_bytes) / HBM_BYTES_PER_S
