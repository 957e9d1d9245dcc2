"""Dense (semantic) search: exact inner-product top-k.

Two backends with the JAX package's semantics (scores are fp32 inner
products, sorted descending, ties broken by ascending doc id):

- :func:`dense_topk_matmul` — one matmul and a top-k over the full
  ``[Q, N]`` score matrix; the small-N path.
- :func:`dense_topk_twophase_rm` — the large-N path around kernel K1
  (:mod:`legal_rag_tpu_torch.ops.segmax_rm`): phase 1 reduces each
  segment of ``seg_rows`` contiguous docs to its max score per query,
  phase 2 takes the best segments, gathers and rescores their members
  in fp32 and sorts by (score desc, id asc). int8 docs (with
  per-segment scales) take int8 queries and score in the int8 metric.
- :func:`exact_rescore` — the host fp32 rescore that restores exact
  order over the int8 and PQ tiers' oversampled candidates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.ops.segmax_rm import segmax_rm

# Dispatch constants, copied from legal_rag_tpu/ops/dense.py so that the
# port and the reference take the same path at the same corpus size
# (and tests can force both the same way). They were set for another
# chip; setting them by measurement on the H100 is queued in ROADMAP.md.
TWOPHASE_MIN_DOCS = 393216
TWOPHASE_BLOCK_N = 8192
TWOPHASE_SEG_ROWS = 8
LARGE_N_THRESHOLD = 65536
_SCORE_MATRIX_BUDGET_BYTES = 1 << 30

# Extra segments taken beyond k to absorb exact-score ties at the
# selection boundary; the fp32 rescore then orders exactly. Correct as
# long as no more than this many segments tie EXACTLY at the k-th
# boundary score (the reference's contract).
_TIE_OVERSAMPLE = 64


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization; zero rows stay zero."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def lax_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim in ``jax.lax.top_k``'s order: values
    descending, equal values by ascending index. ``torch.topk`` fixes no
    tie order on CUDA, so this sorts stably instead."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sort_score_desc_id_asc(
    scores: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-key row sort: score descending, then id ascending."""
    ids_s, perm = torch.sort(ids, dim=1, stable=True)
    scores_s = torch.gather(scores, 1, perm)
    scores_s, perm2 = torch.sort(scores_s, dim=1, descending=True, stable=True)
    return scores_s, torch.gather(ids_s, 1, perm2)


def matmul_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """``[Q, D] x [N, D] -> [Q, N]`` fp32 inner products. bf16 operands
    widen exactly to fp32 (so every product is exact, as on the TPU's
    bf16 path); the widening runs in row blocks to bound the transient
    fp32 copy of the doc matrix."""
    if docs.dtype == torch.float32 and queries.dtype == torch.float32:
        return queries @ docs.T
    qf = queries.float()
    out = torch.empty((queries.shape[0], docs.shape[0]),
                      dtype=torch.float32, device=docs.device)
    step = 1 << 16
    for lo in range(0, docs.shape[0], step):
        out[:, lo:lo + step] = qf @ docs[lo:lo + step].float().T
    return out


def quantize_queries(
    queries: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of float queries, as the JAX
    package's int8 paths do: ``scale = max|q| / 127`` (1 for a zero
    row), ``round(q / scale)`` (half to even) clipped to +-127.
    Returns ``(int8 [Q, D], scale [Q] float32)``."""
    q = queries.float()
    q_scale = q.abs().amax(dim=1) / 127.0
    q_scale = torch.where(q_scale == 0, 1.0, q_scale)
    q_i8 = torch.clamp(torch.round(q / q_scale[:, None]), -127, 127)
    return q_i8.to(torch.int8), q_scale


def dense_topk_matmul(
    queries: torch.Tensor, docs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via one matmul: ``(scores [Q, k] f32, ids [Q, k])``."""
    s, i = lax_top_k(matmul_scores(queries, docs), k)
    return s, i.int()


def dense_topk_twophase_rm(
    queries: torch.Tensor,      # [Q, D], the docs' dtype (float for int8)
    docs: torch.Tensor,         # [N, D] float32, bfloat16 or int8, row-major
    k: int,
    *,
    n_valid: Optional[int] = None,
    seg_rows: int = TWOPHASE_SEG_ROWS,
    doc_scales: Optional[torch.Tensor] = None,   # [N] f32, int8 docs only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Large-N exact top-k: K1 segment maxima, then an exact refine.

    Only rows ``< min(N, n_valid)`` compete. Returns
    ``(scores [Q, k] f32, ids [Q, k] i32)`` in (score desc, id asc)
    order; exact while fewer than ``_TIE_OVERSAMPLE`` segments tie at
    the selection boundary.

    int8 docs need ``doc_scales``, constant within each segment (the
    per-segment quantization of ``ShardedIndex.from_embeddings``).
    Queries quantize per row (:func:`quantize_queries`); K1 gives the
    int32 segment maxima, which the segment scales dequantize (the
    shared scale commutes with the max), and the refine scores
    ``acc * q_scale * seg_scale`` in that order, as the JAX package does.
    """
    q, d = queries.shape
    n, d2 = docs.shape
    if d != d2:
        raise ValueError(f"dim mismatch {d} vs {d2}")
    is_int8 = docs.dtype == torch.int8
    if is_int8 and doc_scales is None:
        raise ValueError("int8 docs require doc_scales (per-segment)")
    limit = n if n_valid is None else max(0, min(n, int(n_valid)))
    n_p = -(-n // seg_rows) * seg_rows
    if n_p != n:   # pad copy only for misaligned callers
        docs = torch.cat([docs, docs.new_zeros((n_p - n, d))])
    queries = queries.contiguous()
    n_segs = n_p // seg_rows

    # phase 1 (kernel K1): [Q, n_segs] segment maxima
    if is_int8:
        scales = doc_scales.float()
        if n_p != n:
            scales = torch.cat([scales, scales.new_ones(n_p - n)])
        seg_scales = scales[::seg_rows]                           # [n_segs]
        q_i8, q_scale = quantize_queries(queries)
        seg_m = segmax_rm(q_i8, docs, limit, seg_rows).float() * seg_scales
    else:
        seg_m = segmax_rm(queries, docs, limit, seg_rows)

    # phase 2: the best segments, their members gathered as one
    # contiguous seg_rows*D row each, rescored exactly in fp32
    kk = min(k + _TIE_OVERSAMPLE, n_segs)
    seg_pos = torch.topk(seg_m, kk, dim=1, sorted=False).indices   # [Q, kk]
    member = torch.arange(seg_rows, device=docs.device)
    cand = (seg_pos[:, :, None] * seg_rows + member).reshape(q, kk * seg_rows)
    gathered = docs.view(n_segs, seg_rows * d)[seg_pos]
    gathered = gathered.view(q, kk * seg_rows, d).float()
    if is_int8:
        # int32 dot products, exact in fp32 (see segmax_rm_reference),
        # dequantized by the query's and the candidate segment's scales
        acc = torch.bmm(gathered, q_i8.float()[:, :, None])[:, :, 0]
        cand_scales = seg_scales[seg_pos].repeat_interleave(seg_rows, dim=1)
        scores = acc * q_scale[:, None] * cand_scales
    else:
        scores = torch.bmm(gathered, queries.float()[:, :, None])[:, :, 0]
    scores = torch.where(cand < limit, scores, float("-inf"))
    scores, ids = sort_score_desc_id_asc(scores, cand)
    return scores[:, :k], ids[:, :k].int()


def exact_rescore(
    queries: np.ndarray,        # [Q, D] float32
    cand_ids: np.ndarray,       # [Q, C*] candidate doc ids (may contain
                                #         invalid ids < 0 or >= N)
    embeddings: np.ndarray,     # [N, D] full-precision docs (mmap ok)
    keyword: Optional[np.ndarray] = None,   # [Q, C*] normalized BM25
    weights: Optional[np.ndarray] = None,   # [Q] hybrid weights
    k: Optional[int] = None,
    dense_candidates: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Exact re-ranking of a small candidate set against full-precision
    embeddings — the recall-recovery pass for quantized (int8) indexes.

    The int8 index finds a slightly-oversampled candidate list fast and
    small (4x less HBM); this gathers just those C* docs' fp32 vectors
    (host mmap page reads, ~C*D*4 bytes per query) and recomputes exact
    cosine + weighted fusion, restoring recall@k = 1.0 for <10% extra
    latency (BASELINE.md int8 row; VERDICT r1 item 7).

    ``dense_candidates``: when set, the fusion pool is first narrowed
    to the exact dense top-``dense_candidates`` of the rescored set —
    reproducing the reference's dense-candidates-only fusion semantics
    (retrieval_engine.py:79-92) with the SAME pool the fp32 engine
    would use, so int8+rescore returns identical results to fp32 as
    long as the oversampled list covers that pool.

    Returns ``(fused [Q,k], ids [Q,k], sem [Q,k], keyword [Q,k])``
    sorted by fused desc, ties by ascending id (backend parity order).
    """
    q, c = cand_ids.shape
    k = min(k or c, c)
    valid = (cand_ids >= 0) & (cand_ids < embeddings.shape[0])
    safe = np.where(valid, cand_ids, 0)
    gathered = np.asarray(embeddings[safe.ravel()], dtype=np.float32)
    gathered = gathered.reshape(q, c, -1)
    sem = np.einsum(
        "qd,qcd->qc", queries.astype(np.float32), gathered
    ).astype(np.float32)
    sem = np.where(valid, sem, -np.inf)
    if keyword is None:
        keyword = np.zeros((q, c), dtype=np.float32)

    if dense_candidates is not None and dense_candidates < c:
        # exact dense top-C pool (sem desc, id asc), like the device
        # program's candidate stage but at full precision
        pool = np.lexsort((safe, -sem), axis=1)[:, :dense_candidates]
        take_pool = lambda a: np.take_along_axis(a, pool, axis=1)
        cand_ids = take_pool(cand_ids)
        sem = take_pool(sem)
        keyword = take_pool(keyword)
        valid = take_pool(valid)
        safe = take_pool(safe)
        c = dense_candidates
        k = min(k, c)

    if weights is None:
        fused = sem
    else:
        w = np.asarray(weights, dtype=np.float32)[:, None]
        fused = sem * (1.0 - w) + np.where(valid, keyword, 0.0) * w
        fused = np.where(valid, fused, -np.inf)

    # (fused desc, id asc) — same tie order as the device backends
    order = np.lexsort((safe, -fused), axis=1)[:, :k]
    take = lambda a: np.take_along_axis(a, order, axis=1)
    return take(fused), take(cand_ids), take(sem), take(keyword)
