"""Sharded hybrid search over a device mesh: dense top-C, BM25, fusion.

The port of ``legal_rag_tpu.parallel.sharded``. One body runs per shard
of the mesh's ``shard`` axis (and, on a 2-D ``(data, shard)`` mesh, per
slice of the query batch), with no communication:

- the dense top-C of the shard's ``[n_local, D]`` row slice, with global
  ids (the shard's ``base`` offset) and padding masked;
- BM25 by scatter into a ``[Q, n_local]`` accumulator of the postings
  that land in the shard's rows (small shards), its local max, the BM25
  value at the dense candidates and, for RRF, the shard's sparse top-C;
  large shards (and IVF) take sorted-postings segment sums instead,
  computed once from the replicated postings.

Then the collectives, functions of the mesh (``parallel/mesh.py``): one
gather of each ``[Q, C]`` candidate tuple to ``[S, Q, C]`` and the max
of the BM25 norm over shards (the reference's ``all_gather`` and
``pmax``). Within one process they are moves onto the merge device; a
single shard's tensor is used where it lies, so one device runs the ops
and launches of the unsharded search. Across processes they are
``dist.all_gather`` and ``dist.all_reduce(MAX)``. The replicated
epilogue takes the global dense top-C from the ``[Q, S*C]`` candidates
and fuses (weighted, or RRF over both lists). Results are
``(fused [Q,k], ids [Q,k], sem [Q,k], keyword [Q,k])`` on the merge
device, every process holding all of them.

The dense stage follows the doc matrix's storage tier:

- float32 / bfloat16: a plain matmul + top-k for small shards, the
  two-phase K1 path for large ones;
- int8 (per-segment scales): the same dispatch in the int8 metric, K1's
  int8 variant at large N;
- pq (uint8 codes): :func:`legal_rag_tpu_torch.ops.pq.pq_topk` (kernel
  K2), or its IVF-pruned form when the index carries IVF cells, which
  each shard probes on its own.

The late-interaction tier (:class:`ShardedMultiVectorIndex`) keeps the
``[Npad, Td, D]`` token slab sharded like the dense index:
:func:`sharded_maxsim_topk` scans each shard's slab, and
:func:`sharded_maxsim_rerank_topk` late-interacts only each shard's
dense top-C (K1 at large N, through :func:`_local_dense_topc`); one
gather and a two-key sort merge the shards' winners. Because candidates
are taken per shard, ``maxsim-rerank``, IVF, the int8 scales (padding
moves with S) and the RRF zero-score fill on the scatter path depend on
S: results equal the reference's at the same mesh shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
from legal_rag_tpu_torch.parallel.mesh import (
    AXIS, GlobalArray, Mesh, as_global, device_put_global, gather_items,
    make_mesh, max_items, positions_along, replicate_global,
)

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


def _globalize(i: torch.Tensor, base: int) -> torch.Tensor:
    """Local row ids to global ones; -1 slots stay -1."""
    return i if base == 0 else torch.where(i >= 0, i + base, i)


def _local_dense_topc(q, docs_local, base: int, n_docs: int, c: int,
                      doc_scales=None):
    """The shard's [Q, C] dense candidates with global ids (int64);
    rows past the corpus (global id >= n_docs) masked. bf16 docs take
    bf16 queries with fp32 accumulation; int8 docs take per-row int8
    queries, exact int32 dot products and the ``q_scale * doc_scale``
    dequantization."""
    n_local_w = docs_local.shape[0]
    n_valid = min(max(n_docs - base, 0), n_local_w)
    if docs_local.dtype == torch.int8:
        aligned8 = (n_local_w % TWOPHASE_BLOCK_N == 0
                    and n_local_w % TWOPHASE_SEG_ROWS == 0)
        if aligned8 and (
            n_local_w >= TWOPHASE_MIN_DOCS
            or q.shape[0] * n_local_w * 4 > _SCORE_MATRIX_BUDGET_BYTES
        ):
            s, i = dense_topk_twophase_rm(
                q, docs_local, c, n_valid=n_valid,
                seg_rows=TWOPHASE_SEG_ROWS, doc_scales=doc_scales,
            )
            i = _globalize(i.long(), base)
            s = torch.where((i >= 0) & (i < n_docs), s, _NEG_INF)
            return s, i
        # the int32 dot products of int8 values are exact in an fp32
        # matmul (every partial sum is an integer below 2**24)
        q_i8, q_scale = quantize_queries(q)
        acc = matmul_scores(q_i8.float(), docs_local)
        scores = acc * q_scale[:, None] * doc_scales[None, :]
        col = torch.arange(n_local_w, device=scores.device)
        scores = torch.where(col < n_docs - base, scores, _NEG_INF)
        s, i = _topk_padded(scores, c)
        return s, _globalize(i, base)
    if docs_local.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    aligned = n_local_w % TWOPHASE_BLOCK_N == 0
    if (n_local_w >= TWOPHASE_MIN_DOCS and aligned) or (
        q.shape[0] * n_local_w * 4 > _SCORE_MATRIX_BUDGET_BYTES
    ):
        s, i = dense_topk_twophase_rm(
            q, docs_local, c, n_valid=n_valid, seg_rows=TWOPHASE_SEG_ROWS,
        )
        i = _globalize(i.long(), base)
        s = torch.where((i >= 0) & (i < n_docs), s, _NEG_INF)
        return s, i
    scores = matmul_scores(q, docs_local)
    col = torch.arange(n_local_w, device=scores.device)
    scores = torch.where(col < n_docs - base, scores, _NEG_INF)
    s, i = _topk_padded(scores, c)
    return s, _globalize(i, base)


def _pad_candidates(s: torch.Tensor, i: torch.Tensor, c: int):
    """Pad ``[Q, c'] `` candidates to ``[Q, c]`` with (-inf, -1)."""
    q, have = s.shape
    if have < c:
        s = torch.cat([s, s.new_full((q, c - have), _NEG_INF)], dim=1)
        i = torch.cat([i, i.new_full((q, c - have), -1)], dim=1)
    return s, i


def _local_pq_topc(q, codes_local, codebooks, base: int, n_docs: int,
                   c: int):
    """The shard's [Q, C] PQ candidates with global ids (approximate
    under the PQ metric; callers oversample and rescore in fp32). ``q``
    is OPQ-rotated already when the codebook has a rotation."""
    from legal_rag_tpu_torch.ops.pq import pq_topk

    n_local = codes_local.shape[0]
    c_req = min(c, n_local)
    s, i = pq_topk(q, codes_local, codebooks, c_req,
                   n_valid=min(max(n_docs - base, 0), n_local))
    s, i = _pad_candidates(s, i.long(), c)
    bad = (i < 0) | ~torch.isfinite(s)
    return torch.where(bad, _NEG_INF, s), torch.where(bad, -1, i + base if base else i)


def _local_pq_ivf_topc(q, codes_local, ids_local, cent_local, codebooks,
                       c: int, probes: int, cell_size: int, q_valid=None):
    """The shard's [Q, C] PQ candidates over its own IVF cells, global
    ids through the cell permutation. The probe budget grows with the
    batch so every query keeps at least 4 cells of its own:
    ``max(probes, 4 Q)``, at most the shard's cells."""
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


# -- the per-shard layout ---------------------------------------------------


class _Work:
    """The work items of one sharded call: ``(data slice, shard)`` keys,
    the mesh position that runs each, the process that owns it, the
    merge device, and this process's query rows on each device."""

    def __init__(self, mesh: Mesh, data_axis: Optional[str], n_rows: int):
        n_shards = mesh.shape[AXIS]
        if data_axis is None:
            self.n_data = 1
            self.where = {(0, s): pos
                          for s, pos in enumerate(positions_along(mesh))}
        else:
            self.n_data = mesh.shape[data_axis]
            if n_rows % self.n_data:
                raise ValueError(
                    f"query batch {n_rows} must divide data axis size "
                    f"{self.n_data}"
                )
            d_dim = mesh.axis_names.index(data_axis)
            s_dim = mesh.axis_names.index(AXIS)
            self.where = {(pos[d_dim], pos[s_dim]): pos
                          for pos in mesh.positions()}
        self.mesh = mesh
        self.n_shards = n_shards
        self.rows = n_rows // self.n_data
        self.owners = {key: mesh.rank_of(pos) for key, pos in self.where.items()}
        self.local = [(key, pos) for key, pos in sorted(self.where.items())
                      if mesh.is_local(pos)]
        self.dest = mesh.devices[mesh.local_positions()[0]]
        self._cache: Dict = {}

    def device(self, pos) -> torch.device:
        return self.mesh.devices[pos]

    def query_rows(self, x, d: int, dev) -> torch.Tensor:
        """Rows of data slice ``d`` of a replicated query-side input (a
        tensor or a replicated GlobalArray) on ``dev``, made once a
        device (no copy where the tensor lies there, no slice at one
        data slice)."""
        key = (id(x), d, dev)
        if key not in self._cache:
            t = x.full() if isinstance(x, GlobalArray) else x
            if self.n_data > 1:
                t = t[d * self.rows:(d + 1) * self.rows]
            self._cache[key] = t.to(dev)
        return self._cache[key]

    def gather(self, items: Dict) -> Dict:
        """Every work item's tensor on the merge device (the
        reference's ``all_gather``)."""
        return gather_items(self.mesh, items, self.owners, self.dest)

    def to_qc(self, gathered: Dict, d: int) -> torch.Tensor:
        """``[Q, S*C]``: the shards' ``[Q, C]`` lists of data slice
        ``d`` side by side, shard-major (one shard: its tensor)."""
        parts = [gathered[(d, s)] for s in range(self.n_shards)]
        if len(parts) == 1:
            return parts[0]
        st = torch.stack(parts)                                 # [S, Q, C]
        return st.transpose(0, 1).reshape(st.shape[1], -1)


def sharded_hybrid_search(
    docs,                     # [Npad, D] float32 / bfloat16 / int8, or
                              # PQ codes [Npad, m] uint8; row-sharded
    post_ids: torch.Tensor,   # [Q, P] global doc ids (replicated)
    post_w: torch.Tensor,     # [Q, P] posting weights
    q_emb: torch.Tensor,      # [Q, D] float32 query embeddings (OPQ-
                              # rotated for a PQ index with a rotation)
    weights: torch.Tensor,    # [Q] hybrid weights
    doc_scales=None,          # [Npad] f32, int8 tier, row-sharded
    pq_codebooks=None,        # [2m, 16, dsub], pq tier, replicated
    ivf_centroids=None,       # [n_cells_pad, D], IVF, row-sharded
    ivf_doc_ids=None,         # [Npad] global ids, IVF, row-sharded
    *,
    mesh: Mesh,
    k: int,
    c: int,
    n_docs: int,
    mode: str = "weighted",
    rrf_k: int = 60,
    sparse_mode: str = "auto",   # auto | scatter | segsum
    data_axis: Optional[str] = None,
    ivf_probes: int = 64,
    ivf_cell_size: int = 1024,
    n_queries: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(fused [Q,k], ids [Q,k] int32, sem [Q,k], keyword [Q,k])``.

    ``mode='weighted'``: fusion over the dense candidates;
    ``mode='rrf'``: reciprocal-rank fusion of the dense and sparse
    lists (sem/keyword are then 0). ``n_queries``: the real (unpadded)
    rows of the batch; only they vote for IVF cells. ``data_axis``: on a
    2-D ``(data, shard)`` mesh the query batch also splits over this
    axis (Q must divide its size). The row-sharded operands are
    GlobalArrays on ``mesh`` or tensors (split into row views where
    they lie); the query-side ones tensors or replicated GlobalArrays.
    """
    if mode not in ("weighted", "rrf"):
        raise ValueError(f"unknown fusion mode {mode!r}")
    docs = as_global(docs, mesh, AXIS)
    is_pq = docs.dtype == torch.uint8
    if is_pq and pq_codebooks is None:
        raise ValueError("uint8 (PQ) doc codes require pq_codebooks")
    if docs.dtype == torch.int8 and doc_scales is None:
        raise ValueError("int8 docs require doc_scales")
    is_ivf = is_pq and ivf_centroids is not None
    if is_ivf and ivf_doc_ids is None:
        raise ValueError("IVF mode requires ivf_doc_ids (the global-id "
                         "cell permutation)")
    work = _Work(mesh, data_axis, q_emb.shape[0])
    n_local = docs.shape[0] // work.n_shards
    scales = None if doc_scales is None else as_global(doc_scales, mesh, AXIS)
    cbs = None if pq_codebooks is None else as_global(pq_codebooks, mesh, None)
    if is_ivf:
        cents = as_global(ivf_centroids, mesh, AXIS)
        cell_ids = as_global(ivf_doc_ids, mesh, AXIS)
    nq = q_emb.shape[0] if n_queries is None else int(n_queries)
    # IVF cells hold arbitrary global ids, so the scatter path's row
    # arithmetic cannot apply: IVF always takes the segment sums
    use_segsum = is_ivf or sparse_mode == "segsum" or (
        sparse_mode == "auto" and n_local > LARGE_N_THRESHOLD
    )

    # ---- per shard: dense candidates, and the scatter path's BM25
    out: Dict[str, Dict] = {n: {} for n in ("ds", "di", "dbm", "max", "ss", "si")}
    for key, pos in work.local:
        d, shard = key
        dev = work.device(pos)
        base = shard * n_local
        qe = work.query_rows(q_emb, d, dev)
        if is_ivf:
            # padded batch rows do not vote for cells: real rows by
            # GLOBAL query index (a 2-D mesh splits Q contiguously)
            q_valid = torch.arange(work.rows, device=dev) + d * work.rows < nq
            d_s, d_i = _local_pq_ivf_topc(
                qe, docs.local(pos), cell_ids.local(pos), cents.local(pos),
                cbs.local(pos), c, ivf_probes, ivf_cell_size, q_valid=q_valid,
            )
        elif is_pq:
            d_s, d_i = _local_pq_topc(qe, docs.local(pos), cbs.local(pos),
                                      base, n_docs, c)
        else:
            d_s, d_i = _local_dense_topc(
                qe, docs.local(pos), base, n_docs, c,
                None if scales is None else scales.local(pos),
            )
        out["ds"][key], out["di"][key] = d_s, d_i
        if use_segsum:
            continue
        # a [Q, n_local] accumulator over the shard's rows, padding rows
        # included; postings outside them drop
        pids = work.query_rows(post_ids, d, dev).long()
        bm_local = bm25_score_batch(pids - base if base else pids,
                                    work.query_rows(post_w, d, dev), n_local)
        out["max"][key] = bm_local.max(dim=1).values
        d_bm = torch.gather(bm_local, 1,
                            (d_i - base if base else d_i).clamp(0, n_local - 1))
        out["dbm"][key] = torch.where((d_i >= n_docs) | (d_i < 0), 0.0, d_bm)
        if mode == "rrf":
            # the shard's sparse top-C over its whole accumulator (only
            # RRF reads it; weighted fuses the dense candidates only)
            col = torch.arange(n_local, device=dev)
            bm_masked = torch.where(col < n_docs - base, bm_local, _NEG_INF)
            s_s, s_i = _topk_padded(bm_masked, c)
            out["ss"][key], out["si"][key] = s_s, _globalize(s_i, base)

    # ---- collectives: one gather of each candidate tuple, the BM25 max
    g = {name: work.gather(items) for name, items in out.items()
         if items and name != "max"}
    if not use_segsum:
        maxes = max_items(mesh, out["max"], work.owners, work.n_data,
                          work.dest)

    # ---- replicated epilogue, one data slice at a time
    res = []
    for d in range(work.n_data):
        all_ds, all_di = work.to_qc(g["ds"], d), work.to_qc(g["di"], d)
        top_ds, pos = lax_top_k(all_ds, c)         # the global dense top-C
        top_di = torch.gather(all_di, 1, pos)
        if use_segsum:
            sid, s_valid, s_totals, global_max = _bm25_segment_stats(
                work.query_rows(post_ids, d, work.dest),
                work.query_rows(post_w, d, work.dest), n_docs,
            )
            top_dbm = _segment_totals_at(sid, s_valid, s_totals, top_di)
        else:
            global_max = maxes[d]
            top_dbm = torch.gather(work.to_qc(g["dbm"], d), 1, pos)
        gmax = torch.where(global_max > 0, global_max, 1.0)[:, None]
        bm_norm = top_dbm / gmax

        if mode == "weighted":
            w = work.query_rows(weights, d, work.dest).float()[:, None]
            fused = top_ds * (1.0 - w) + bm_norm * w
            f, fpos = lax_top_k(fused, k)
            ids = torch.gather(top_di, 1, fpos)
            sem = torch.gather(top_ds, 1, fpos)
            key = torch.gather(bm_norm, 1, fpos)
            res.append((f, ids.int(), sem, key))
            continue
        if use_segsum:
            masked = torch.where(s_valid, s_totals, _NEG_INF)
            top_ss, spos = _topk_padded(masked, c)
            safe_pos = spos.clamp(0, masked.shape[1] - 1)
            top_si = torch.gather(sid, 1, safe_pos)
            top_si = torch.where((spos >= 0) & torch.isfinite(top_ss),
                                 top_si, -1)
        else:
            _, spos = lax_top_k(work.to_qc(g["ss"], d), c)
            top_si = torch.gather(work.to_qc(g["si"], d), 1, spos)

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
        res.append((f, ids, torch.zeros_like(f), torch.zeros_like(f)))
    if len(res) == 1:
        return res[0]
    return tuple(torch.cat(parts) for parts in zip(*res))


def _shard_winners(s: torch.Tensor, i: torch.Tensor, base: int, k: int):
    """One shard's ``[Q, k']`` MaxSim winners as the reference's body
    leaves them: non-finite or invalid slots ``(-inf, -1)``, global ids,
    padded to ``k``."""
    bad = (i < 0) | ~torch.isfinite(s)
    gids = torch.where(bad, -1, i.long() + base)
    return _pad_candidates(torch.where(bad, _NEG_INF, s), gids, k)


def _merge_winners(work: _Work, g: Dict, k: int, n_docs: int):
    """The shards' winners of each data slice, gathered, in (score desc,
    id asc) order: invalid slots take unique ids past the corpus so the
    two-key sort sinks them, then show as -1."""
    res = []
    for d in range(work.n_data):
        all_s, all_i = work.to_qc(g["s"], d), work.to_qc(g["i"], d)
        slot = torch.arange(all_i.shape[1], device=all_i.device)
        sort_ids = torch.where(all_i < 0, n_docs + slot, all_i)
        out_s, out_i = sort_score_desc_id_asc(all_s, sort_ids)
        out_i = out_i[:, :k]
        res.append((out_s[:, :k], torch.where(out_i >= n_docs, -1, out_i).int()))
    if len(res) == 1:
        return res[0]
    return tuple(torch.cat(parts) for parts in zip(*res))


def sharded_maxsim_topk(
    doc_tokens,                 # [Npad, Td, D] row-sharded
    doc_mask,                   # [Npad, Td] row-sharded
    q_tokens: torch.Tensor,     # [Q, Tq, D] replicated
    q_mask: torch.Tensor,       # [Q, Tq]
    *,
    mesh: Mesh,
    k: int,
    n_docs: int,
    block_n: int = 512,
    data_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Late-interaction (MaxSim) top-k over the mesh: each shard scans
    its slab (rows past ``n_docs`` masked), one gather merges the
    per-shard ``[Q, k]`` winners, and a two-key sort gives the exact
    global (score desc, id asc) order. Returns ``(scores [Q, k] fp32,
    ids [Q, k] int32)``; slots beyond the corpus carry ``(-inf, -1)``."""
    doc_tokens = as_global(doc_tokens, mesh, AXIS)
    doc_mask = as_global(doc_mask, mesh, AXIS)
    work = _Work(mesh, data_axis, q_tokens.shape[0])
    n_local = doc_tokens.shape[0] // work.n_shards
    kl = min(k, n_local)
    out: Dict[str, Dict] = {"s": {}, "i": {}}
    for key, pos in work.local:
        d, shard = key
        dev = work.device(pos)
        base = shard * n_local
        s, i = maxsim_topk(
            work.query_rows(q_tokens, d, dev), work.query_rows(q_mask, d, dev),
            doc_tokens.local(pos), doc_mask.local(pos), kl, block_n=block_n,
            n_valid=min(max(n_docs - base, 0), n_local),
        )
        out["s"][key], out["i"][key] = _shard_winners(s, i, base, k)
    return _merge_winners(work, {n: work.gather(v) for n, v in out.items()},
                          k, n_docs)


def sharded_maxsim_rerank_topk(
    docs,                       # [Npad, D] single-vector matrix, row-sharded
    doc_tokens,                 # [Npad, Td, D] token slab, row-sharded
    doc_mask,                   # [Npad, Td] row-sharded
    q_emb: torch.Tensor,        # [Q, D] sentence embeddings, replicated
    q_tokens: torch.Tensor,     # [Q, Tq, D] query token embeddings
    q_mask: torch.Tensor,       # [Q, Tq]
    *,
    mesh: Mesh,
    k: int,
    c: int,
    n_docs: int,
    data_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-first late interaction, the capacity-safe MaxSim tier: each
    shard's single-vector dense stage takes each query's top-``c`` of
    its rows (:func:`_local_dense_topc`: K1's two-phase search at large
    N), and MaxSim rescores only those against the shard's slab
    (:func:`legal_rag_tpu_torch.ops.maxsim.maxsim_rescore`), so a batch
    reads ``O(c * Td * D)`` of each slab. Recall then rests on each
    shard's dense stage covering its MaxSim winners.

    Returns ``(scores [Q, k] fp32, ids [Q, k] int32)``, (score desc, id
    asc), ``(-inf, -1)`` beyond the corpus.
    """
    docs = as_global(docs, mesh, AXIS)
    doc_tokens = as_global(doc_tokens, mesh, AXIS)
    doc_mask = as_global(doc_mask, mesh, AXIS)
    n_pad = docs.shape[0]
    if doc_tokens.shape[0] != n_pad or doc_mask.shape[0] != n_pad:
        # a mismatch rescores another document's tokens, so this is a
        # hard error, not an assert that -O strips
        raise ValueError(
            "dense tier and token slab must share row padding: docs "
            f"{n_pad} vs doc_tokens {doc_tokens.shape[0]} / doc_mask "
            f"{doc_mask.shape[0]}; build the slab with n_pad=docs.shape[0]"
        )
    work = _Work(mesh, data_axis, q_emb.shape[0])
    n_local = n_pad // work.n_shards
    cl = min(c, n_local)
    kl = min(k, cl)
    out: Dict[str, Dict] = {"s": {}, "i": {}}
    for key, pos in work.local:
        d, shard = key
        dev = work.device(pos)
        base = shard * n_local
        _, d_i = _local_dense_topc(work.query_rows(q_emb, d, dev),
                                   docs.local(pos), base, n_docs, cl)
        local_ids = d_i if base == 0 else torch.where(d_i >= 0, d_i - base, -1)
        s, i = maxsim_rescore(
            work.query_rows(q_tokens, d, dev), work.query_rows(q_mask, d, dev),
            doc_tokens.local(pos), doc_mask.local(pos), local_ids, kl,
            n_valid=min(max(n_docs - base, 0), n_local),
        )
        out["s"][key], out["i"][key] = _shard_winners(s, i, base, k)
    return _merge_winners(work, {n: work.gather(v) for n, v in out.items()},
                          k, n_docs)


# -- the indexes ------------------------------------------------------------


def _default_mesh(mesh: Optional[Mesh], device) -> Mesh:
    return mesh if mesh is not None else make_mesh(device=device)


@dataclasses.dataclass
class ShardedIndex:
    """The device-resident dense index, row-sharded over ``mesh``'s
    ``shard`` axis, in one storage tier:

    - ``float32`` / ``bfloat16``: the doc matrix ``[Npad, D]``;
    - ``int8``: ``[Npad, D]`` int8 with ``doc_scales [Npad]`` (one scale
      per 8-row segment, repeated per row), 4x smaller than fp32;
    - ``pq``: packed 4-bit codes ``[Npad, m]`` uint8 (``m`` bytes a
      doc), ``pq_codebooks [2m, 16, dsub]`` replicated and the optional
      OPQ rotation (host, ``[D, D]``); with IVF, the codes are
      cell-ordered and ``ivf_centroids`` / ``ivf_doc_ids`` carry the
      cells, each shard a run of whole cells.

    The arrays are :class:`~legal_rag_tpu_torch.parallel.mesh.GlobalArray`
    s. Rows pad to a multiple of S; float and int8 corpora with at least
    ``TWOPHASE_MIN_DOCS`` rows a shard pad each shard to a multiple of
    ``TWOPHASE_BLOCK_N`` rows, so they take the K1 path (smaller int8
    corpora pad each shard to the 8-row segment)."""

    docs: GlobalArray
    mesh: Mesh
    n_docs: int
    doc_scales: Optional[GlobalArray] = None
    pq_codebooks: Optional[GlobalArray] = None
    pq_rotation: Optional[np.ndarray] = None
    ivf_centroids: Optional[GlobalArray] = None
    ivf_doc_ids: Optional[GlobalArray] = None
    ivf_cell_size: int = 0

    @classmethod
    def from_pq_ivf(cls, ivf, codebooks: np.ndarray, mesh: Optional[Mesh] = None,
                    rotation=None, device="cuda") -> "ShardedIndex":
        """IVF-pruned PQ layout: cell-ordered codes row-sharded along
        cell boundaries, the cell means and the global-id permutation
        sharded alongside. The cell count pads to a multiple of S with
        EMPTY cells (ids -1), which the probe masks by their ids; real
        padding sits only in the corpus's tail cell, so each shard's
        validity stays a prefix."""
        mesh = _default_mesh(mesh, device)
        n_shards = mesh.shape[AXIS]
        n_cells, s_cell = ivf.n_cells, int(ivf.cell_size)
        m = ivf.codes.shape[1]
        d = ivf.centroids.shape[1]
        nc_pad = -(-n_cells // n_shards) * n_shards
        cents = np.zeros((nc_pad, d), np.float32)
        cents[:n_cells] = ivf.centroids
        codes = np.zeros((nc_pad * s_cell, m), np.uint8)
        codes[: n_cells * s_cell] = ivf.codes
        ids = np.full((nc_pad * s_cell,), -1, np.int32)
        ids[: n_cells * s_cell] = ivf.doc_ids
        return cls(
            docs=device_put_global(codes, mesh),
            mesh=mesh,
            n_docs=int((np.asarray(ivf.doc_ids) >= 0).sum()),
            pq_codebooks=replicate_global(np.asarray(codebooks, np.float32),
                                          mesh),
            pq_rotation=_host_rotation(rotation),
            ivf_centroids=device_put_global(cents, mesh),
            ivf_doc_ids=device_put_global(ids, mesh),
            ivf_cell_size=s_cell,
        )

    @classmethod
    def from_pq(cls, codes: np.ndarray, codebooks: np.ndarray,
                mesh: Optional[Mesh] = None, rotation=None,
                device="cuda") -> "ShardedIndex":
        mesh = _default_mesh(mesh, device)
        n, m = codes.shape
        n_shards = mesh.shape[AXIS]
        n_pad = -(-n // n_shards) * n_shards
        if n_pad != n:
            padded = np.zeros((n_pad, m), dtype=np.uint8)
            padded[:n] = codes
            codes = padded
        return cls(
            docs=device_put_global(np.ascontiguousarray(codes, np.uint8), mesh),
            mesh=mesh,
            n_docs=int(n),
            pq_codebooks=replicate_global(np.asarray(codebooks, np.float32),
                                          mesh),
            pq_rotation=_host_rotation(rotation),
        )

    @classmethod
    def from_embeddings(
        cls,
        embeddings: np.ndarray,
        mesh: Optional[Mesh] = None,
        dtype: str = "float32",
        pq_m: int = 48,
        device="cuda",
    ) -> "ShardedIndex":
        if dtype not in ("float32", "bfloat16", "int8", "pq"):
            raise ValueError(f"unknown dense dtype {dtype!r}")
        mesh = _default_mesh(mesh, device)
        n, d = embeddings.shape
        n_shards = mesh.shape[AXIS]
        if dtype == "pq":
            # train at load, on the mesh's first device; builds persist
            # the codebooks instead
            from legal_rag_tpu_torch.ops.pq import encode_pq, train_pq

            dev = mesh.devices[mesh.local_positions()[0]]
            emb = np.asarray(embeddings, np.float32)
            cb = train_pq(emb, m=pq_m, opq_iters=8, device=dev)
            codes = encode_pq(emb, cb, device=dev)
            return cls.from_pq(codes, cb.codebooks, mesh, cb.rotation)
        # big shards align to the two-phase kernel's block, so the large-N
        # dispatch never pays a pad copy; int8 groups rows by the segment
        unit = n_shards
        if dtype == "int8":
            unit = n_shards * TWOPHASE_SEG_ROWS
        if -(-n // n_shards) >= TWOPHASE_MIN_DOCS:
            unit = n_shards * TWOPHASE_BLOCK_N
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
                docs=device_put_global(quant, mesh), mesh=mesh, n_docs=n,
                doc_scales=device_put_global(scales.astype(np.float32), mesh),
            )
        return cls(
            docs=device_put_global(
                host, mesh,
                dtype=torch.bfloat16 if dtype == "bfloat16" else None),
            mesh=mesh, n_docs=n,
        )


def _host_rotation(rotation) -> Optional[np.ndarray]:
    return None if rotation is None else np.asarray(rotation, np.float32)


@dataclasses.dataclass
class ShardedMultiVectorIndex:
    """The device-resident token slab for late-interaction search, the
    multi-vector analogue of :class:`ShardedIndex`: the ``[Npad, Td,
    D]`` slab and its mask row-sharded over ``mesh``. Storage defaults
    to bfloat16 (at Td=32 a bf16 slab is 16x the fp32 single-vector
    matrix)."""

    doc_tokens: GlobalArray    # [Npad, Td, D]
    doc_mask: GlobalArray      # [Npad, Td] int32
    mesh: Mesh
    n_docs: int

    @classmethod
    def from_arrays(
        cls,
        tokens: np.ndarray,      # [N, Td, D] float (any precision; may be
                                 # a memory map)
        mask: np.ndarray,        # [N, Td]
        mesh: Optional[Mesh] = None,
        dtype: str = "bfloat16",
        n_pad: Optional[int] = None,
        device="cuda",
    ) -> "ShardedMultiVectorIndex":
        """``n_pad``: callers serving maxsim-rerank pass the dense
        index's padded row count, so a doc id lands on the same shard
        and row in both (default: N rounded up to a multiple of S). Each
        shard's slab is allocated at the target dtype on its device and
        filled in row chunks of ~256 MB of source, converted there: no
        transient fp32 (or host) copy of the whole slab."""
        mesh = _default_mesh(mesh, device)
        n, td, d = tokens.shape
        n_shards = mesh.shape[AXIS]
        if n_pad is None:
            n_pad = -(-n // n_shards) * n_shards
        n_pad = int(n_pad)
        if n_pad % n_shards or n_pad < n:
            raise ValueError(
                f"n_pad {n_pad} must be a >=N multiple of {n_shards}")
        n_local = n_pad // n_shards
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        step = max(1, (1 << 28) // max(1, td * d * tokens.itemsize))
        mask = np.asarray(mask, dtype=np.int32)
        dim = mesh.axis_names.index(AXIS)
        made: Dict = {}
        tok_blocks, mask_blocks = {}, {}
        for pos in mesh.local_positions():
            dev, shard = mesh.devices[pos], pos[dim]
            if (dev, shard) not in made:
                lo0, hi0 = shard * n_local, min((shard + 1) * n_local, n)
                toks = torch.zeros((n_local, td, d), dtype=target, device=dev)
                mpad = torch.zeros((n_local, td), dtype=torch.int32, device=dev)
                for lo in range(lo0, hi0, step):
                    hi = min(lo + step, hi0)
                    # a copy: a memory-mapped store's slab is read-only
                    chunk = torch.from_numpy(np.array(tokens[lo:hi]))
                    toks[lo - lo0:hi - lo0] = chunk.to(dev).to(target)
                if hi0 > lo0:
                    mpad[:hi0 - lo0] = torch.from_numpy(mask[lo0:hi0]).to(dev)
                made[(dev, shard)] = (toks, mpad)
            tok_blocks[pos], mask_blocks[pos] = made[(dev, shard)]
        return cls(
            doc_tokens=GlobalArray((n_pad, td, d), target, mesh, AXIS,
                                   tok_blocks),
            doc_mask=GlobalArray((n_pad, td), torch.int32, mesh, AXIS,
                                 mask_blocks),
            mesh=mesh, n_docs=n,
        )

    def _query_device(self) -> torch.device:
        return self.mesh.devices[self.mesh.local_positions()[0]]

    def search(
        self, q_tokens, q_mask, k: int, block_n: int = 512
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self._query_device()
        return sharded_maxsim_topk(
            self.doc_tokens, self.doc_mask,
            torch.as_tensor(q_tokens).to(dev, self.doc_tokens.dtype),
            torch.as_tensor(q_mask).to(dev), mesh=self.mesh,
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
        dev = self._query_device()
        return sharded_maxsim_rerank_topk(
            index.docs, self.doc_tokens, self.doc_mask,
            torch.as_tensor(q_emb).to(dev, index.docs.dtype),
            torch.as_tensor(q_tokens).to(dev, self.doc_tokens.dtype),
            torch.as_tensor(q_mask).to(dev), mesh=self.mesh,
            k=min(k, self.n_docs), c=c, n_docs=self.n_docs,
        )
