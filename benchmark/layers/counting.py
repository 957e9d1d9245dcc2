"""Operations and bytes the served work needs, and the card's peaks.

Copied in spirit from ``legal_rag_tpu_torch/bench.py`` (``:371-377``:
bytes read once over the memory rate, ``2 Q N D`` operations), but
counting only what the inputs need, so that the count does not move
when the implementation does: the doc matrix read once a search in its
stored type, the real queries' embeddings, the postings that survive the
cap (8 bytes each: a doc id and a weight, not the padded budget), the
top-k written once; operations ``2 Q_real N D`` plus one a posting. The
MiniLM forward counts the real tokens of each text at the published
widths, attention included.
"""

from __future__ import annotations

from typing import Iterable

# one NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet)
PEAK_FLOPS = 989e12          # bf16/fp16 tensor cores: the highest dense rate
HBM_BYTES_PER_S = 3.35e12


def search_bytes(q_real: int, n_docs: int, dim: int, doc_bytes: int,
                 postings: int, k: int) -> int:
    return (n_docs * dim * doc_bytes + q_real * dim * 4 + postings * 8
            + q_real * k * 8)


def search_ops(q_real: int, n_docs: int, dim: int, postings: int) -> int:
    return 2 * q_real * n_docs * dim + postings


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS)


def minilm_ops(lengths: Iterable[int], hidden: int, layers: int,
               intermediate: int) -> int:
    """Multiply-adds times two of a MiniLM forward over sequences of the
    given real lengths: the Q, K, V and output projections, the scores
    and the weighted sum of attention, and the feed-forward."""
    total = 0
    for n in lengths:
        total += layers * (8 * n * hidden * hidden + 4 * n * n * hidden
                           + 4 * n * hidden * intermediate)
    return total
