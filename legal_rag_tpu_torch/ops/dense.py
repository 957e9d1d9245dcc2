"""Dense (semantic) search: exact inner-product top-k.

Backends with the JAX package's semantics (scores are fp32 inner
products, sorted descending, ties broken by ascending doc id):

- :func:`dense_topk_matmul` — one matmul and a top-k over the full
  ``[Q, N]`` score matrix; the small-N path.
- :func:`dense_topk_twophase_rm` — the large-N path around kernel K1
  (:mod:`legal_rag_tpu_torch.ops.segmax_rm`): phase 1 reduces each
  segment of ``seg_rows`` contiguous docs to its max score per query,
  phase 2 takes the best segments, gathers and rescores their members
  in fp32 and sorts by (score desc, id asc). int8 docs (with
  per-segment scales) take int8 queries and score in the int8 metric.
- :func:`dense_topk_twophase` — the same two phases over docs stored
  transposed, ``docs_t [D, N]``, around kernel K4
  (:mod:`legal_rag_tpu_torch.ops.segmax_cm`; segments strided 128 apart).
- :func:`dense_topk_fused` — kernel K3
  (:mod:`legal_rag_tpu_torch.ops.fused_topk`): matmul and running top-k
  in one pass over ``docs_t``, never writing the ``[Q, N]`` scores.
- :func:`dense_topk` — the dispatcher of the public ``ops`` API over
  ``[N, D]`` docs: matmul, or K3 with ``fused=True``.
- :func:`exact_rescore` — the host fp32 rescore that restores exact
  order over the int8 and PQ tiers' oversampled candidates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.ops.fused_topk import fused_topk
from legal_rag_tpu_torch.ops.segmax_cm import segmax_cm, segment_members
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

# Segment count from which :func:`select_segments` may select in two
# levels, copied from legal_rag_tpu/ops/dense.py (tests lower it to
# reach the two-level branch on small corpora).
_TWO_LEVEL_MIN_SEGS = 16384


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


def gather_supers(s3: torch.Tensor, sup_idx: torch.Tensor) -> torch.Tensor:
    """The member values ``[Q, kk * sup]`` of the super-segments
    ``sup_idx [Q, kk]`` of ``s3 [Q, n_sup, sup]``, by one gather (the JAX
    package's one-hot einsum worked around slow TPU gathers)."""
    q, kk = sup_idx.shape
    sup = s3.shape[2]
    rows = torch.gather(s3, 1, sup_idx[:, :, None].expand(q, kk, sup))
    return rows.reshape(q, kk * sup)


def select_segments(
    seg_m: torch.Tensor, kk: int, sup: Optional[int] = None
) -> torch.Tensor:
    """The top-``kk`` segment positions ``[Q, kk]`` (in no order) of the
    map ``seg_m [Q, n_segs]``; the counterpart of
    ``legal_rag_tpu.ops.dense._select_segments``.

    ``sup=None`` takes one flat ``torch.topk`` over the map. An int
    takes two levels, as the JAX package does, when ``n_segs >=
    _TWO_LEVEL_MIN_SEGS``, ``sup`` divides ``n_segs`` and at least
    ``kk`` super-segments exist (else the flat select): each run of
    ``sup`` segments reduces to its max, the top-``kk`` of those maxima
    pick super-segments, and a top-``kk`` over their ``kk * sup``
    members picks the segments. The j-th best segment has at most j - 1
    segments above it, hence at most j - 1 better super-segments, so
    both ways pick the same set under the shared tie contract (exact
    while fewer than ``_TIE_OVERSAMPLE`` segments tie at the boundary).
    """
    q, n_segs = seg_m.shape
    if (sup is not None and n_segs >= _TWO_LEVEL_MIN_SEGS
            and n_segs % sup == 0 and n_segs // sup >= kk):
        s3 = seg_m.reshape(q, n_segs // sup, sup)
        sup_idx = torch.topk(s3.amax(dim=2), kk, dim=1, sorted=False).indices
        vals = gather_supers(s3, sup_idx)                       # [Q, kk*sup]
        j = torch.topk(vals, kk, dim=1, sorted=False).indices
        return torch.gather(sup_idx, 1, j // sup) * sup + j % sup
    return torch.topk(seg_m, kk, dim=1, sorted=False).indices


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
    sup: Optional[int] = None,
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

    ``sup``: phase 2's segment select (:func:`select_segments`); None,
    the served path, takes one flat top-k, an int the JAX package's
    two-level select over super-segments of ``sup`` segments.
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
    seg_pos = select_segments(seg_m, kk, sup)                  # [Q, kk]
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


def dense_topk_twophase(
    queries: torch.Tensor,      # [Q, D], the docs' dtype
    docs_t: torch.Tensor,       # [D, N] float32 or bfloat16, column-major docs
    k: int,
    *,
    n_valid: Optional[int] = None,
    seg_rows: int = TWOPHASE_SEG_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-major large-N exact top-k: K4 segment maxima, then an exact
    refine. The counterpart of ``legal_rag_tpu.ops.dense.
    dense_topk_twophase``; its ``block_n`` and ``block_q`` only set the
    TPU's padding and are not taken here.

    Only columns ``< min(N, n_valid)`` compete. Phase 1 (K4) gives the
    ``[Q, n_segs]`` maxima of segments of ``seg_rows`` docs strided 128
    apart. Phase 2 takes the best ``kk = min(k + _TIE_OVERSAMPLE,
    n_segs)`` segments by one flat top-kk, recovers their members by
    index arithmetic, gathers those columns, rescores them in fp32,
    masks members past the limit to -inf and sorts by (score desc, id
    asc). The JAX package selects segments in two levels above
    ``_TWO_LEVEL_MIN_SEGS``; both pick the top-kk segments, so under the
    shared tie contract (exact while fewer than ``_TIE_OVERSAMPLE``
    segments tie at the boundary) the results are the same. Returns
    ``(scores [Q, k] f32, ids [Q, k] i32)``.
    """
    q, d = queries.shape
    d2, n = docs_t.shape
    if d != d2:
        raise ValueError(f"dim mismatch {d} vs {d2}")
    limit = n if n_valid is None else max(0, min(n, int(n_valid)))
    seg_m = segmax_cm(queries.contiguous(), docs_t, limit, seg_rows)
    kk = min(k + _TIE_OVERSAMPLE, seg_m.shape[1])
    seg_pos = torch.topk(seg_m, kk, dim=1, sorted=False).indices   # [Q, kk]
    cand = segment_members(seg_pos, seg_rows).reshape(q, kk * seg_rows)
    gathered = docs_t[:, cand.clamp(max=n - 1)]                 # [D, Q, C]
    scores = torch.einsum("qd,dqc->qc", queries.float(), gathered.float())
    scores = torch.where(cand < limit, scores, float("-inf"))
    scores, ids = sort_score_desc_id_asc(scores, cand)
    return scores[:, :k], ids[:, :k].int()


def dense_topk_fused(
    queries: torch.Tensor,      # [Q, D], the docs' dtype
    docs_t: torch.Tensor,       # [D, N] float32 or bfloat16, column-major docs
    k: int,
    *,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused matmul + top-k without the ``[Q, N]`` scores (kernel K3):
    ``(scores [Q, k] f32, ids [Q, k] i32)``, ties by ascending id. The
    counterpart of ``legal_rag_tpu.ops.dense.dense_topk_pallas``, whose
    ``block_n`` and ``block_q`` only set the TPU's padding. Columns
    ``>= min(N, n_valid)`` score ``finfo(float32).min`` and still
    compete, so with ``n_valid < k`` the tail holds masked ids in
    ascending order; ``k > N`` raises."""
    return fused_topk(queries.contiguous(), docs_t, k, n_valid)


def dense_topk(
    queries: torch.Tensor,      # [Q, D]
    docs: torch.Tensor,         # [N, D]
    k: int,
    *,
    fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over row-major docs: :func:`dense_topk_matmul`, or
    with ``fused=True`` kernel K3 (:func:`dense_topk_fused`) on one
    transposed copy of ``docs`` (callers that keep a persistent index
    should store ``docs.T`` and call that directly). The counterpart of
    ``legal_rag_tpu.ops.dense.dense_topk``, ``fused`` of its
    ``use_pallas``."""
    if fused:
        return dense_topk_fused(queries, docs.T.contiguous(), k)
    return dense_topk_matmul(queries, docs, k)


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
