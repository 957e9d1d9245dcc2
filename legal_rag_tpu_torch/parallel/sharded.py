"""Hybrid search over one device: dense top-C, BM25, fusion.

The body of ``legal_rag_tpu.parallel.sharded.sharded_hybrid_search`` at
one shard (S=1): the dense local top-C, BM25 by scatter (small shards)
or sorted-postings segment sums (large shards, and always with IVF),
the global dense top-C, and weighted or RRF fusion. Results are
identical in form: ``(fused [Q,k], ids [Q,k], sem [Q,k], keyword [Q,k])``.

The dense stage follows the doc matrix's storage tier:

- float32 / bfloat16: a plain matmul + top-k for small shards, the
  two-phase K1 path for large ones;
- int8 (per-segment scales): the same dispatch in the int8 metric, K1's
  int8 variant at large N;
- pq (uint8 codes): :func:`legal_rag_tpu_torch.ops.pq.pq_topk` (kernel
  K2), or its IVF-pruned form when the index carries IVF cells.

The late-interaction tier (:class:`ShardedMultiVectorIndex`) keeps the
``[Npad, Td, D]`` token slab beside the dense index:
:func:`sharded_maxsim_topk` scans it whole, and
:func:`sharded_maxsim_rerank_topk` late-interacts only the dense stage's
top-C candidates (K1 at large N, through :func:`_local_dense_topc`).

Sharding over several devices is queued in ROADMAP.md (P13); at one
shard each reference function's cross-shard merge is its final
two-key sort.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.ops.dense import (
    LARGE_N_THRESHOLD, TWOPHASE_BLOCK_N, TWOPHASE_MIN_DOCS,
    TWOPHASE_SEG_ROWS, _SCORE_MATRIX_BUDGET_BYTES, dense_topk_twophase_rm,
    lax_top_k, matmul_scores, quantize_queries, sort_score_desc_id_asc,
)
from legal_rag_tpu_torch.ops.fusion import rrf_fusion
from legal_rag_tpu_torch.ops.maxsim import maxsim_rescore, maxsim_topk
from legal_rag_tpu_torch.ops.sparse import bm25_score_batch

_NEG_INF = float("-inf")


def _topk_padded(scores: torch.Tensor, c: int):
    """top-k that tolerates c > row length: missing slots are padded
    with (-inf, -1) so candidate shapes stay [Q, C]."""
    q, width = scores.shape
    cl = min(c, width)
    s, i = lax_top_k(scores, cl)
    if cl < c:
        s = torch.cat([s, s.new_full((q, c - cl), _NEG_INF)], dim=1)
        i = torch.cat([i, i.new_full((q, c - cl), -1)], dim=1)
    return s, i


def _local_dense_topc(q, docs_local, n_docs: int, c: int, doc_scales=None):
    """[Q, C] dense candidates, ids int64; padding rows (ids >= n_docs)
    masked. bf16 docs take bf16 queries with fp32 accumulation; int8
    docs take per-row int8 queries, exact int32 dot products and the
    ``q_scale * doc_scale`` dequantization."""
    n_local_w = docs_local.shape[0]
    if docs_local.dtype == torch.int8:
        aligned8 = (n_local_w % TWOPHASE_BLOCK_N == 0
                    and n_local_w % TWOPHASE_SEG_ROWS == 0)
        if aligned8 and (
            n_local_w >= TWOPHASE_MIN_DOCS
            or q.shape[0] * n_local_w * 4 > _SCORE_MATRIX_BUDGET_BYTES
        ):
            s, i = dense_topk_twophase_rm(
                q, docs_local, c, n_valid=min(n_docs, n_local_w),
                seg_rows=TWOPHASE_SEG_ROWS, doc_scales=doc_scales,
            )
            i = i.long()
            s = torch.where((i >= 0) & (i < n_docs), s, _NEG_INF)
            return s, i
        # the int32 dot products of int8 values are exact in an fp32
        # matmul (every partial sum is an integer below 2**24)
        q_i8, q_scale = quantize_queries(q)
        acc = matmul_scores(q_i8.float(), docs_local)
        scores = acc * q_scale[:, None] * doc_scales[None, :]
        col = torch.arange(n_local_w, device=scores.device)
        scores = torch.where(col < n_docs, scores, _NEG_INF)
        return _topk_padded(scores, c)
    if docs_local.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    aligned = n_local_w % TWOPHASE_BLOCK_N == 0
    if (n_local_w >= TWOPHASE_MIN_DOCS and aligned) or (
        q.shape[0] * n_local_w * 4 > _SCORE_MATRIX_BUDGET_BYTES
    ):
        s, i = dense_topk_twophase_rm(
            q, docs_local, c, n_valid=min(n_docs, n_local_w),
            seg_rows=TWOPHASE_SEG_ROWS,
        )
        i = i.long()
        s = torch.where((i >= 0) & (i < n_docs), s, _NEG_INF)
        return s, i
    scores = matmul_scores(q, docs_local)
    col = torch.arange(n_local_w, device=scores.device)
    scores = torch.where(col < n_docs, scores, _NEG_INF)
    return _topk_padded(scores, c)


def _pad_candidates(s: torch.Tensor, i: torch.Tensor, c: int):
    """Pad ``[Q, c'] `` candidates to ``[Q, c]`` with (-inf, -1)."""
    q, have = s.shape
    if have < c:
        s = torch.cat([s, s.new_full((q, c - have), _NEG_INF)], dim=1)
        i = torch.cat([i, i.new_full((q, c - have), -1)], dim=1)
    return s, i


def _local_pq_topc(q, codes_local, codebooks, n_docs: int, c: int):
    """[Q, C] PQ candidates (approximate under the PQ metric; callers
    oversample and rescore in fp32). ``q`` is OPQ-rotated already when
    the codebook has a rotation."""
    from legal_rag_tpu_torch.ops.pq import pq_topk

    n_local = codes_local.shape[0]
    c_req = min(c, n_local)
    s, i = pq_topk(q, codes_local, codebooks, c_req,
                   n_valid=min(n_docs, n_local))
    s, i = _pad_candidates(s, i.long(), c)
    bad = (i < 0) | ~torch.isfinite(s)
    return torch.where(bad, _NEG_INF, s), torch.where(bad, -1, i)


def _local_pq_ivf_topc(q, codes_local, ids_local, cent_local, codebooks,
                       c: int, probes: int, cell_size: int, q_valid=None):
    """[Q, C] PQ candidates over the IVF cells, global ids through the
    cell permutation. The probe budget grows with the batch so every
    query keeps at least 4 cells of its own: ``max(probes, 4 Q)``."""
    from legal_rag_tpu_torch.ops.pq import _pq_ivf_topk_impl

    p = min(max(probes, 4 * q.shape[0]), cent_local.shape[0])
    kk = min(c, p * cell_size)
    s, i = _pq_ivf_topk_impl(
        q, cent_local, codes_local, ids_local, codebooks, kk, p,
        cell_size, q_valid=q_valid,
    )
    return _pad_candidates(s, i, c)


def _bm25_segment_stats(pids: torch.Tensor, pw: torch.Tensor, n_docs: int):
    """Per-doc BM25 totals from the postings alone (no [Q, N] buffer).

    Sorts postings by doc id and segment-sums by cumsum differences;
    the previous segment's end is found by a cummax over end POSITIONS,
    so totals are right for any weight sign. Returns
    ``(sid, valid, totals, global_max)``: sorted ids [Q, P], the mask of
    each doc's last posting, the doc totals at those positions, and the
    per-query max total (0 when no posting is valid).
    """
    q, p = pids.shape
    sid, order = torch.sort(pids.long(), dim=1, stable=True)
    sw = torch.gather(pw.float(), 1, order)
    cs = torch.cumsum(sw, dim=1)
    nxt = torch.cat([sid[:, 1:], sid.new_full((q, 1), -2)], dim=1)
    is_end = sid != nxt
    pos = torch.arange(p, device=sid.device).expand(q, p)
    end_pos = torch.where(is_end, pos, -1)
    last_end = torch.cat(
        [end_pos.new_full((q, 1), -1),
         torch.cummax(end_pos, dim=1).values[:, :-1]],
        dim=1,
    )
    prev_end = torch.where(
        last_end >= 0,
        torch.gather(cs, 1, last_end.clamp(min=0)),
        0.0,
    )
    totals = cs - prev_end
    valid = is_end & (sid >= 0) & (sid < n_docs)
    masked = torch.where(valid, totals, _NEG_INF)
    global_max = masked.max(dim=1).values
    global_max = torch.where(torch.isfinite(global_max), global_max, 0.0)
    return sid, valid, totals, global_max


def _segment_totals_at(sid, valid, totals, ids):
    """BM25 totals of ``ids [Q, C]`` from the segment stats (0 where a
    doc has no posting). ``sid`` is sorted, so a doc's total sits at
    the last position of its run, found by binary search."""
    end = torch.searchsorted(sid, ids.contiguous(), right=True) - 1
    at = end.clamp(min=0)
    hit = (end >= 0) & (torch.gather(sid, 1, at) == ids) & torch.gather(valid, 1, at)
    return torch.where(hit, torch.gather(totals, 1, at), 0.0)


@dataclasses.dataclass
class ShardedIndex:
    """The device-resident dense index of one device, in one storage
    tier:

    - ``float32`` / ``bfloat16``: the doc matrix ``[Npad, D]``;
    - ``int8``: ``[Npad, D]`` int8 with ``doc_scales [Npad]`` (one scale
      per 8-row segment, repeated per row), 4x smaller than fp32;
    - ``pq``: packed 4-bit codes ``[N, m]`` uint8 (``m`` bytes a doc),
      ``pq_codebooks [2m, 16, dsub]`` and the optional OPQ rotation
      (host, ``[D, D]``); with IVF, the codes are cell-ordered and
      ``ivf_centroids`` / ``ivf_doc_ids`` carry the cells.

    Float and int8 corpora at or above ``TWOPHASE_MIN_DOCS`` pad to a
    multiple of ``TWOPHASE_BLOCK_N`` rows, so they take the K1 path
    (smaller int8 corpora pad to the 8-row segment)."""

    docs: torch.Tensor
    n_docs: int
    doc_scales: Optional[torch.Tensor] = None
    pq_codebooks: Optional[torch.Tensor] = None
    pq_rotation: Optional[np.ndarray] = None
    ivf_centroids: Optional[torch.Tensor] = None
    ivf_doc_ids: Optional[torch.Tensor] = None
    ivf_cell_size: int = 0

    @classmethod
    def from_pq_ivf(cls, ivf, codebooks: np.ndarray, rotation=None,
                    device="cuda") -> "ShardedIndex":
        """IVF-pruned PQ layout: cell-ordered codes, the cell means and
        the global-id permutation (-1 on the padded tail)."""
        return cls(
            docs=torch.from_numpy(np.asarray(ivf.codes, np.uint8)).to(device),
            n_docs=int((np.asarray(ivf.doc_ids) >= 0).sum()),
            pq_codebooks=_device_f32(codebooks, device),
            pq_rotation=_host_rotation(rotation),
            ivf_centroids=_device_f32(ivf.centroids, device),
            ivf_doc_ids=torch.from_numpy(
                np.asarray(ivf.doc_ids, np.int32)).to(device),
            ivf_cell_size=int(ivf.cell_size),
        )

    @classmethod
    def from_pq(cls, codes: np.ndarray, codebooks: np.ndarray,
                rotation=None, device="cuda") -> "ShardedIndex":
        return cls(
            docs=torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(device),
            n_docs=int(codes.shape[0]),
            pq_codebooks=_device_f32(codebooks, device),
            pq_rotation=_host_rotation(rotation),
        )

    @classmethod
    def from_embeddings(
        cls,
        embeddings: np.ndarray,
        dtype: str = "float32",
        device="cuda",
        pq_m: int = 48,
    ) -> "ShardedIndex":
        if dtype not in ("float32", "bfloat16", "int8", "pq"):
            raise ValueError(f"unknown dense dtype {dtype!r}")
        n, d = embeddings.shape
        if dtype == "pq":
            # train at load; builds persist the codebooks instead
            from legal_rag_tpu_torch.ops.pq import encode_pq, train_pq

            emb = np.asarray(embeddings, np.float32)
            cb = train_pq(emb, m=pq_m, opq_iters=8, device=device)
            codes = encode_pq(emb, cb, device=device)
            return cls.from_pq(codes, cb.codebooks, cb.rotation, device)
        unit = TWOPHASE_SEG_ROWS if dtype == "int8" else 1
        if n >= TWOPHASE_MIN_DOCS:
            unit = TWOPHASE_BLOCK_N
        n_pad = -(-n // unit) * unit
        host = np.zeros((n_pad, d), dtype=np.float32)
        host[:n] = embeddings
        if dtype == "int8":
            # symmetric quantization with one scale per 8-row segment
            # (the max over its rows of max|x| / 127), so K1's integer
            # segment max commutes with the dequantization
            g = TWOPHASE_SEG_ROWS
            per_doc = np.abs(host).max(axis=1) / 127.0
            scales = per_doc.reshape(n_pad // g, g).max(axis=1)
            scales[scales == 0] = 1.0
            scales = np.repeat(scales, g)
            quant = np.clip(
                np.rint(host / scales[:, None]), -127, 127
            ).astype(np.int8)
            return cls(
                docs=torch.from_numpy(quant).to(device), n_docs=n,
                doc_scales=torch.from_numpy(
                    scales.astype(np.float32)).to(device),
            )
        docs = torch.from_numpy(host).to(device)
        if dtype == "bfloat16":
            docs = docs.to(torch.bfloat16)
        return cls(docs=docs, n_docs=n)


def _device_f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _host_rotation(rotation) -> Optional[np.ndarray]:
    return None if rotation is None else np.asarray(rotation, np.float32)


def hybrid_search(
    docs: torch.Tensor,       # [Npad, D] float32 / bfloat16 / int8, or
                              # PQ codes [Npad, m] uint8
    post_ids: torch.Tensor,   # [Q, P] global doc ids
    post_w: torch.Tensor,     # [Q, P] posting weights
    q_emb: torch.Tensor,      # [Q, D] float32 query embeddings (OPQ-
                              # rotated for a PQ index with a rotation)
    weights: torch.Tensor,    # [Q] hybrid weights
    doc_scales: Optional[torch.Tensor] = None,     # [Npad] f32, int8 tier
    pq_codebooks: Optional[torch.Tensor] = None,   # [2m, 16, dsub], pq tier
    ivf_centroids: Optional[torch.Tensor] = None,  # [n_cells, D], IVF
    ivf_doc_ids: Optional[torch.Tensor] = None,    # [Npad] global ids, IVF
    *,
    k: int,
    c: int,
    n_docs: int,
    mode: str = "weighted",
    rrf_k: int = 60,
    sparse_mode: str = "auto",   # auto | scatter | segsum
    ivf_probes: int = 64,
    ivf_cell_size: int = 1024,
    n_queries: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(fused [Q,k], ids [Q,k] int32, sem [Q,k], keyword [Q,k])``.

    ``mode='weighted'``: fusion over the dense candidates;
    ``mode='rrf'``: reciprocal-rank fusion of the dense and sparse
    lists (sem/keyword are then 0). ``n_queries``: the real (unpadded)
    rows of the batch; only they vote for IVF cells.
    """
    if mode not in ("weighted", "rrf"):
        raise ValueError(f"unknown fusion mode {mode!r}")
    is_pq = docs.dtype == torch.uint8
    if is_pq and pq_codebooks is None:
        raise ValueError("uint8 (PQ) doc codes require pq_codebooks")
    if docs.dtype == torch.int8 and doc_scales is None:
        raise ValueError("int8 docs require doc_scales")
    is_ivf = is_pq and ivf_centroids is not None
    if is_ivf and ivf_doc_ids is None:
        raise ValueError("IVF mode requires ivf_doc_ids (the global-id "
                         "cell permutation)")
    n_local = docs.shape[0]
    pids = post_ids.long()
    pw = post_w.float()
    # IVF cells hold arbitrary global ids, so the scatter path's row
    # arithmetic cannot apply: IVF always takes the segment sums
    use_segsum = is_ivf or sparse_mode == "segsum" or (
        sparse_mode == "auto" and n_local > LARGE_N_THRESHOLD
    )

    if is_ivf:
        nq = q_emb.shape[0] if n_queries is None else int(n_queries)
        q_valid = torch.arange(q_emb.shape[0], device=docs.device) < nq
        d_s, d_i = _local_pq_ivf_topc(
            q_emb, docs, ivf_doc_ids, ivf_centroids, pq_codebooks, c,
            ivf_probes, ivf_cell_size, q_valid=q_valid,
        )
    elif is_pq:
        d_s, d_i = _local_pq_topc(q_emb, docs, pq_codebooks, n_docs, c)
    else:
        d_s, d_i = _local_dense_topc(q_emb, docs, n_docs, c, doc_scales)

    if use_segsum:
        sid, s_valid, s_totals, global_max = _bm25_segment_stats(
            pids, pw, n_docs
        )
    else:
        # a [Q, n_local] accumulator over the whole shard, padding rows
        # included (as the reference's scatter path)
        bm_local = bm25_score_batch(pids, pw, n_local)
        global_max = bm_local.max(dim=1).values
        d_bm = torch.gather(bm_local, 1, d_i.clamp(0, n_local - 1))
        d_bm = torch.where((d_i >= n_docs) | (d_i < 0), 0.0, d_bm)

    if mode == "rrf" and not use_segsum:
        col = torch.arange(n_local, device=docs.device)
        bm_masked = torch.where(col < n_docs, bm_local, _NEG_INF)
        s_s, s_i = _topk_padded(bm_masked, c)

    # global dense top-C (one shard: a stable re-rank of its list)
    top_ds, pos = lax_top_k(d_s, c)
    top_di = torch.gather(d_i, 1, pos)
    if use_segsum:
        top_dbm = _segment_totals_at(sid, s_valid, s_totals, top_di)
    else:
        top_dbm = torch.gather(d_bm, 1, pos)

    gmax = torch.where(global_max > 0, global_max, 1.0)[:, None]
    bm_norm = top_dbm / gmax

    if mode == "weighted":
        w = weights.float()[:, None]
        fused = top_ds * (1.0 - w) + bm_norm * w
        f, fpos = lax_top_k(fused, k)
        ids = torch.gather(top_di, 1, fpos)
        sem = torch.gather(top_ds, 1, fpos)
        key = torch.gather(bm_norm, 1, fpos)
        return f, ids.int(), sem, key

    if use_segsum:
        masked = torch.where(s_valid, s_totals, _NEG_INF)
        top_ss, spos = _topk_padded(masked, c)
        safe_pos = spos.clamp(0, masked.shape[1] - 1)
        top_si = torch.gather(sid, 1, safe_pos)
        top_si = torch.where((spos >= 0) & torch.isfinite(top_ss), top_si, -1)
    else:
        _, spos = lax_top_k(s_s, c)
        top_si = torch.gather(s_i, 1, spos)

    # invalid slots get unique out-of-range ids so the merge never
    # joins them; rrf_fusion then gives them no mass and sinks them
    def sanitize(ids_, offset):
        slot = torch.arange(ids_.shape[1], device=ids_.device)
        bad = (ids_ < 0) | (ids_ >= n_docs)
        return torch.where(bad, n_docs + offset + slot, ids_)

    f, ids = rrf_fusion(
        sanitize(top_di, 0), sanitize(top_si, c), k,
        rrf_k=rrf_k, n_valid=n_docs,
    )
    return f, ids, torch.zeros_like(f), torch.zeros_like(f)


def _merge_topk(s: torch.Tensor, i: torch.Tensor, k: int, n_docs: int):
    """One shard's ``[Q, k']`` MaxSim winners as the reference's merge
    leaves them: non-finite slots become ``(-inf, -1)``, the list pads
    to ``k`` and sorts by (score desc, id asc), ids past the corpus -1."""
    bad = (i < 0) | ~torch.isfinite(s)
    gids = torch.where(bad, -1, i.long())
    s, gids = _pad_candidates(torch.where(bad, _NEG_INF, s), gids, k)
    slot = torch.arange(k, device=s.device)
    sort_ids = torch.where(gids < 0, n_docs + slot, gids)
    out_s, out_i = sort_score_desc_id_asc(s, sort_ids)
    return out_s, torch.where(out_i >= n_docs, -1, out_i).int()


def sharded_maxsim_topk(
    doc_tokens: torch.Tensor,   # [Npad, Td, D]
    doc_mask: torch.Tensor,     # [Npad, Td]
    q_tokens: torch.Tensor,     # [Q, Tq, D]
    q_mask: torch.Tensor,       # [Q, Tq]
    *,
    k: int,
    n_docs: int,
    block_n: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Late-interaction (MaxSim) top-k over the whole token slab, rows
    past ``n_docs`` masked. Returns ``(scores [Q, k] fp32, ids [Q, k]
    int32)``, (score desc, id asc); slots beyond the corpus carry
    ``(-inf, -1)``."""
    n_pad = doc_tokens.shape[0]
    s, i = maxsim_topk(
        q_tokens, q_mask, doc_tokens, doc_mask, min(k, n_pad),
        block_n=block_n, n_valid=min(max(n_docs, 0), n_pad),
    )
    return _merge_topk(s, i, k, n_docs)


def sharded_maxsim_rerank_topk(
    docs: torch.Tensor,         # [Npad, D] single-vector matrix
    doc_tokens: torch.Tensor,   # [Npad, Td, D] token slab
    doc_mask: torch.Tensor,     # [Npad, Td]
    q_emb: torch.Tensor,        # [Q, D] sentence embeddings
    q_tokens: torch.Tensor,     # [Q, Tq, D] query token embeddings
    q_mask: torch.Tensor,       # [Q, Tq]
    *,
    k: int,
    c: int,
    n_docs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-first late interaction, the capacity-safe MaxSim tier: the
    single-vector dense stage takes each query's top-``c``
    (:func:`_local_dense_topc`: K1's two-phase search at large N), and
    MaxSim rescores only those candidates against the slab
    (:func:`legal_rag_tpu_torch.ops.maxsim.maxsim_rescore`), so a batch
    reads ``O(c * Td * D)`` of the slab instead of all of it. Recall
    then rests on the dense stage covering the MaxSim winners.

    Returns ``(scores [Q, k] fp32, ids [Q, k] int32)``, (score desc, id
    asc), ``(-inf, -1)`` beyond the corpus.
    """
    n_pad = docs.shape[0]
    if doc_tokens.shape[0] != n_pad or doc_mask.shape[0] != n_pad:
        # a mismatch rescores another document's tokens, so this is a
        # hard error, not an assert that -O strips
        raise ValueError(
            "dense tier and token slab must share row padding: docs "
            f"{n_pad} vs doc_tokens {doc_tokens.shape[0]} / doc_mask "
            f"{doc_mask.shape[0]}; build the slab with n_pad=docs.shape[0]"
        )
    cl = min(c, n_pad)
    kl = min(k, cl)
    n_valid = min(max(n_docs, 0), n_pad)
    _, d_i = _local_dense_topc(q_emb, docs, n_docs, cl)
    s, i = maxsim_rescore(q_tokens, q_mask, doc_tokens, doc_mask, d_i, kl,
                          n_valid=n_valid)
    return _merge_topk(s, i, k, n_docs)


@dataclasses.dataclass
class ShardedMultiVectorIndex:
    """The device-resident token slab for late-interaction search: the
    multi-vector analogue of :class:`ShardedIndex`. Storage defaults to
    bfloat16 (at Td=32 a bf16 slab is 16x the fp32 single-vector
    matrix)."""

    doc_tokens: torch.Tensor   # [Npad, Td, D]
    doc_mask: torch.Tensor     # [Npad, Td] int32
    n_docs: int

    @classmethod
    def from_arrays(
        cls,
        tokens: np.ndarray,      # [N, Td, D] float (any precision; may be
                                 # a memory map)
        mask: np.ndarray,        # [N, Td]
        dtype: str = "bfloat16",
        n_pad: Optional[int] = None,
        device="cuda",
    ) -> "ShardedMultiVectorIndex":
        """``n_pad``: callers serving maxsim-rerank pass the dense
        index's padded row count, so a doc id names the same row in
        both. The slab is allocated at the target dtype on ``device``
        and filled in row chunks of ~256 MB of source, converted there:
        no transient fp32 (or host) copy of the whole slab."""
        n, td, d = tokens.shape
        n_pad = n if n_pad is None else int(n_pad)
        if n_pad < n:
            raise ValueError(f"n_pad {n_pad} must be at least N={n}")
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        toks = torch.zeros((n_pad, td, d), dtype=target, device=device)
        step = max(1, (1 << 28) // max(1, td * d * tokens.itemsize))
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            # a copy: a memory-mapped store's slab is read-only
            chunk = torch.from_numpy(np.array(tokens[lo:hi]))
            toks[lo:hi] = chunk.to(device).to(target)
        mpad = torch.zeros((n_pad, td), dtype=torch.int32, device=device)
        mpad[:n] = torch.from_numpy(np.asarray(mask, dtype=np.int32)).to(device)
        return cls(doc_tokens=toks, doc_mask=mpad, n_docs=n)

    def search(
        self, q_tokens, q_mask, k: int, block_n: int = 512
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.doc_tokens.device
        return sharded_maxsim_topk(
            self.doc_tokens, self.doc_mask,
            torch.as_tensor(q_tokens).to(dev, self.doc_tokens.dtype),
            torch.as_tensor(q_mask).to(dev),
            k=min(k, self.n_docs), n_docs=self.n_docs, block_n=block_n,
        )

    def rerank_search(
        self, index: "ShardedIndex", q_emb, q_tokens, q_mask, k: int, c: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense-first MaxSim: candidates from ``index``'s float tier,
        late interaction on those only (:func:`sharded_maxsim_rerank_topk`)."""
        if index.docs.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                "maxsim-rerank needs a float/bf16 dense tier for the "
                f"candidate stage (got {index.docs.dtype}); serve the "
                "quantized tiers with mode='maxsim' or 'weighted'"
            )
        if index.docs.shape[0] != self.doc_tokens.shape[0]:
            raise ValueError(
                "single-vector matrix and token slab must share row "
                f"padding ({index.docs.shape[0]} vs "
                f"{self.doc_tokens.shape[0]}); build the slab with "
                "n_pad=index.docs.shape[0]"
            )
        dev = self.doc_tokens.device
        return sharded_maxsim_rerank_topk(
            index.docs, self.doc_tokens, self.doc_mask,
            torch.as_tensor(q_emb).to(dev, index.docs.dtype),
            torch.as_tensor(q_tokens).to(dev, self.doc_tokens.dtype),
            torch.as_tensor(q_mask).to(dev),
            k=min(k, self.n_docs), c=c, n_docs=self.n_docs,
        )
