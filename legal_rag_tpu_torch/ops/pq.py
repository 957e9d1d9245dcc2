"""Product quantization: the device-memory capacity tier of the dense index.

The PyTorch counterpart of ``legal_rag_tpu.ops.pq`` (4-bit PQ: ``2m``
nibble subspaces of 16 centroids each, two codes packed per byte, so
``m`` bytes a doc; 48 bytes is 32x smaller than fp32), with the same
functions and semantics:

- training and coding: :func:`train_pq` (k-means per subspace, batched
  over the subspaces, plus the optional OPQ rotation), :func:`encode_pq`,
  and the host helpers :class:`PQCodebook`, :func:`unpack_codes`,
  :func:`decode_pq`, copied from the JAX package;
- search: :func:`pq_topk`, whose phase 1 is kernel K2
  (:mod:`legal_rag_tpu_torch.ops.pq_segmax`) and whose phase 2 rescores
  the best segments' members exactly under the PQ metric in fp32, and
  :func:`pq_search_rescored` (PQ candidates, then the exact fp32 rescore);
- IVF coarse pruning over balanced cells: :class:`IVFIndex`,
  :func:`build_ivf`, :func:`pq_ivf_topk`.

Randomness comes from a numpy ``Generator`` drawn in the JAX package's
order, so the same seed gives the same samples and initial centroids.
The device work runs on the device of the tensors given, or on
``device``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.ops.dense import lax_top_k, sort_score_desc_id_asc
from legal_rag_tpu_torch.ops.pq_segmax import pq_segmax, unpack_nibbles

_NEG_F32 = float(np.finfo(np.float32).min)


class PQCodebook(NamedTuple):
    """Trained product-quantization codebooks (4-bit).

    codebooks: ``[2m, 16, dsub]`` float32 — 16 centroids per nibble
      subspace; byte ``b`` of a packed code holds subspaces ``2b`` (low
      nibble) and ``2b+1`` (high nibble).
    rotation:  optional ``[D, D]`` orthogonal OPQ rotation. Vectors are
      quantized in the rotated space (``x @ R``); since
      ``q·x ≈ (q R)·(x̂ R)``, queries rotate at prep time and the
      scoring kernel never changes. OPQ spreads variance evenly across
      subspaces, cutting quantization error on anisotropic embeddings
      (the common case for trained encoders).
    """

    codebooks: np.ndarray
    rotation: Optional[np.ndarray] = None

    @property
    def n_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def m(self) -> int:
        """Packed bytes per document."""
        return self.codebooks.shape[0] // 2

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.n_subspaces * self.dsub

    def rotate(self, x: np.ndarray) -> np.ndarray:
        """Project into the quantization space (no-op without OPQ)."""
        if self.rotation is None:
            return x
        return np.asarray(x, np.float32) @ self.rotation


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _kmeans_subspace(
    x: torch.Tensor, init: torch.Tensor, iters: int
) -> torch.Tensor:
    """Lloyd's k-means: ``x [..., S, d]``, ``init [..., K, d]`` (any
    leading batch dims, one problem each) -> the updated centroids.
    Assignment is ``argmax(x·c - ||c||^2 / 2)`` (first index on ties);
    empty clusters keep their previous centroid. The JAX package's
    ``_kmeans_subspace`` step for step, batched instead of vmapped."""
    batched = x.dim() == 3
    if not batched:
        x, init = x[None], init[None]
    c = init
    k = c.shape[1]
    for _ in range(iters):
        logits = torch.bmm(x, c.transpose(1, 2)) - 0.5 * (c * c).sum(2)[:, None]
        assign = logits.argmax(dim=2)                              # [B, S]
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = onehot.sum(dim=1)                                 # [B, K]
        sums = torch.bmm(onehot.transpose(1, 2), x)                # [B, K, d]
        c = torch.where(
            counts[:, :, None] > 0, sums / counts.clamp(min=1)[:, :, None], c
        )
    return c if batched else c[0]


def _train_pq_sample(
    x: np.ndarray, n_sub: int, iters: int, rng: np.random.Generator,
    device="cuda",
) -> np.ndarray:
    """16-centroid k-means codebooks for a pre-sampled ``[S, D]``."""
    s, d = x.shape
    dsub = d // n_sub
    xs = x.reshape(s, n_sub, dsub).transpose(1, 0, 2)   # [n_sub, S, dsub]
    init_rows = rng.choice(s, size=16, replace=s < 16)
    init = xs[:, init_rows, :]                          # [n_sub, 16, dsub]
    trained = _kmeans_subspace(
        torch.from_numpy(np.ascontiguousarray(xs)).to(device),
        torch.from_numpy(np.ascontiguousarray(init)).to(device),
        iters,
    )
    return trained.cpu().numpy().astype(np.float32)


def train_pq(
    embeddings: np.ndarray,
    m: int = 48,
    iters: int = 25,
    sample: int = 65536,
    seed: int = 0,
    opq_iters: int = 0,
    device="cuda",
) -> PQCodebook:
    """Train 4-bit PQ codebooks: ``2m`` nibble subspaces, 16 centroids
    each (``m`` packed bytes/doc); with ``opq_iters > 0`` also an OPQ
    rotation (alternating quantization and an orthogonal Procrustes
    solve by numpy SVD). As ``legal_rag_tpu.ops.pq.train_pq``, with the
    k-means on ``device``: the same rows are sampled and the same
    initial centroids drawn for the same seed."""
    n, d = embeddings.shape
    n_sub = 2 * m
    if d % n_sub:
        raise ValueError(f"dim {d} not divisible by 2*m={n_sub}")
    rng = np.random.default_rng(seed)
    rows = (
        rng.choice(n, size=sample, replace=False) if n > sample
        else np.arange(n)
    )
    x = np.asarray(embeddings[rows], dtype=np.float32)

    rotation = None
    if opq_iters > 0:
        rotation = np.eye(d, dtype=np.float32)
        for _ in range(opq_iters):
            xr = x @ rotation
            cb_t = PQCodebook(_train_pq_sample(xr, n_sub, 6, rng, device))
            recon = decode_pq(encode_pq(xr, cb_t, device=device), cb_t)
            u, _, vt = np.linalg.svd(x.T @ recon)
            rotation = (u @ vt).astype(np.float32)
        x = x @ rotation

    trained = _train_pq_sample(x, n_sub, iters, rng, device)
    return PQCodebook(trained, rotation)


def _nearest_nibbles(xb: torch.Tensor, c: torch.Tensor,
                     c_norm: torch.Tensor) -> torch.Tensor:
    """``[B, 2m]`` index of each subspace's nearest centroid."""
    xs = xb.reshape(xb.shape[0], c.shape[0], c.shape[2])
    logits = torch.einsum("bmd,mcd->bmc", xs, c) - c_norm[None]
    return logits.argmax(dim=2)


def encode_pq(embeddings: np.ndarray, cb: PQCodebook,
              batch: int = 131072, device="cuda") -> np.ndarray:
    """Nearest centroid per nibble subspace (in the OPQ-rotated space
    when the codebook carries a rotation), two 4-bit codes packed per
    byte. Returns ``codes [N, m]`` uint8; batched, so device memory is
    O(batch) at any N."""
    n, d = embeddings.shape
    if d != cb.dim:
        raise ValueError(f"dim {d} != codebook dim {cb.dim}")
    c = torch.tensor(np.asarray(cb.codebooks, np.float32), device=device)
    c_norm = 0.5 * (c * c).sum(dim=2)                  # [2m, 16]
    rot = None
    if cb.rotation is not None:
        rot = torch.tensor(np.asarray(cb.rotation, np.float32), device=device)
    out = np.empty((n, cb.m), dtype=np.uint8)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        xb = torch.from_numpy(
            np.ascontiguousarray(embeddings[lo:hi], dtype=np.float32)
        ).to(device)
        if rot is not None:
            xb = xb @ rot
        nib = _nearest_nibbles(xb, c, c_norm)
        packed = nib[:, 0::2] | (nib[:, 1::2] << 4)
        out[lo:hi] = packed.to(torch.uint8).cpu().numpy()
    return out


def unpack_codes(codes: np.ndarray) -> np.ndarray:
    """``[..., m]`` packed bytes -> ``[..., 2m]`` nibble codes."""
    codes = np.asarray(codes)
    out = np.empty(codes.shape[:-1] + (codes.shape[-1] * 2,), np.uint8)
    out[..., 0::2] = codes & 0xF
    out[..., 1::2] = codes >> 4
    return out


def decode_pq(codes: np.ndarray, cb: PQCodebook) -> np.ndarray:
    """Reconstruct approximate vectors in the ORIGINAL space
    (debug/eval; search never does this)."""
    nibs = unpack_codes(codes)
    parts = [
        cb.codebooks[s][nibs[:, s]] for s in range(cb.n_subspaces)
    ]
    recon = np.concatenate(parts, axis=1)
    if cb.rotation is not None:
        recon = recon @ cb.rotation.T
    return recon


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def pq_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query lookup tables ``[Q, 2m, 16]`` fp32:
    ``lut[q, s, c] = queries[q, s-th subspace] · codebooks[s, c]``."""
    q = queries.shape[0]
    n_sub, _, dsub = codebooks.shape
    return torch.einsum(
        "qmd,mcd->qmc", queries.float().reshape(q, n_sub, dsub),
        codebooks.float(),
    )


def pq_topk(
    queries: torch.Tensor,      # [Q, D] (OPQ-rotated when in play)
    codes: torch.Tensor,        # [N, m] uint8
    codebooks: torch.Tensor,    # [2m, 16, dsub] float32
    k: int,
    *,
    n_valid: Optional[int] = None,
    seg_rows: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates over a 4-bit-PQ-coded corpus, exact under the
    PQ metric: ``(pq_scores [Q, k] f32, ids [Q, k] i32)`` sorted by
    (PQ score desc, id asc); ``k <= N``.

    Phase 1 is K2 over the bf16-rounded tables (rows ``>= N`` masked in
    the kernel); segments starting at or past ``n_valid`` are then
    masked whole, and phase 2 takes ``k + 16`` segments, decodes their
    members with the fp32 codebooks, scores them exactly, masks members
    ``>= n_valid`` to -inf and sorts by two keys. As
    ``legal_rag_tpu.ops.pq.pq_topk``, without the TPU's query-batch
    split (rows are independent here).
    """
    q, d = queries.shape
    n, m = codes.shape
    n_sub = 2 * m
    dsub = d // n_sub
    queries = queries.float()
    lut = pq_lut(queries, codebooks)                            # [Q, 2m, 16]
    seg_m = pq_segmax(lut.to(torch.bfloat16).contiguous(), codes, seg_rows)
    n_segs = seg_m.shape[1]
    if n_valid is not None:
        # whole segments past n_valid can never hold a real doc
        seg_start = torch.arange(n_segs, device=codes.device) * seg_rows
        seg_m = torch.where(seg_start[None, :] < n_valid, seg_m, _NEG_F32)

    # phase 2: best segments, their members decoded and scored in fp32
    kk = min(k + 16, n_segs)
    seg_pos = torch.topk(seg_m, kk, dim=1, sorted=False).indices   # [Q, kk]
    member = (
        seg_pos[:, :, None] * seg_rows
        + torch.arange(seg_rows, device=codes.device)
    ).reshape(q, kk * seg_rows)
    member_safe = member.clamp(max=n - 1)
    nibs = unpack_nibbles(codes[member_safe])                    # [Q, C, 2m]
    sub = torch.arange(n_sub, device=codes.device)
    decoded = codebooks.float()[sub, nibs]                       # [Q, C, 2m, dsub]
    cand = torch.bmm(
        decoded.reshape(q, kk * seg_rows, n_sub * dsub), queries[:, :, None]
    )[:, :, 0]
    limit = n if n_valid is None else min(int(n_valid), n)
    cand = torch.where(member < limit, cand, float("-inf"))
    s, i = sort_score_desc_id_asc(cand, member)
    return s[:, :k], i[:, :k].int()


def pq_search_rescored(
    queries: np.ndarray,
    codes: torch.Tensor,
    cb: PQCodebook,
    embeddings: np.ndarray,
    k: int,
    *,
    oversample: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity-mode search end to end: PQ candidates on the codes'
    device, then the exact fp32 rescore of the oversampled list on the
    host (only ``k * oversample`` rows of ``embeddings`` are read per
    query). Returns ``(scores [Q, k], ids [Q, k])``."""
    from legal_rag_tpu_torch.ops.dense import exact_rescore

    rotated = np.asarray(cb.rotate(np.asarray(queries)), np.float32)
    _, cand = pq_topk(
        torch.from_numpy(rotated).to(codes.device), codes,
        torch.tensor(np.asarray(cb.codebooks, np.float32), device=codes.device),
        k * oversample,
    )
    fused, ids, _, _ = exact_rescore(
        np.asarray(queries, np.float32), cand.cpu().numpy(), embeddings,
        k=k,
    )
    return fused, ids


# ---------------------------------------------------------------------------
# IVF coarse pruning
# ---------------------------------------------------------------------------


class IVFIndex(NamedTuple):
    """Balanced-cell IVF layout over a PQ-coded corpus.

    The classic IVF (faiss ``IndexIVFPQ``) keeps ragged per-cluster
    posting lists — a shape XLA cannot tile. The TPU-shaped variant
    here is *balanced cells*: documents are sorted by coarse k-means
    cluster and chopped into consecutive fixed-size cells of
    ``cell_size`` rows, each cell summarized by the mean of its member
    embeddings. Every shape is static; a cell read is one contiguous
    ``[cell_size, m]`` slice; only the corpus tail is padding.

    centroids: ``[n_cells, D]`` float32 cell means (OPQ-rotated space,
      matching the space queries are scored in).
    codes:     ``[n_cells*cell_size, m]`` uint8, cell-ordered.
    doc_ids:   ``[n_cells*cell_size]`` int32 original doc ids, -1 on
      the padded tail.
    cell_size: rows per cell.
    """

    centroids: np.ndarray
    codes: np.ndarray
    doc_ids: np.ndarray
    cell_size: int

    @property
    def n_cells(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_pad(self) -> int:
        """Padded tail rows (all in the last cell)."""
        return int((self.doc_ids < 0).sum())


def build_ivf(
    embeddings: np.ndarray,
    cb: PQCodebook,
    codes: np.ndarray,
    cell_size: int = 1024,
    sample: int = 131072,
    iters: int = 15,
    seed: int = 0,
    batch: int = 131072,
    device="cuda",
) -> IVFIndex:
    """Cluster a PQ-coded corpus into balanced cells for coarse pruning:
    coarse k-means (``ceil(N / cell_size)`` centroids, trained on a
    sample in the rotated space), every doc assigned to its nearest
    coarse centroid, docs sorted by cluster (stable) and cut into
    ``cell_size`` cells, each cell summarized by the mean of its actual
    members. As ``legal_rag_tpu.ops.pq.build_ivf``, with the k-means,
    the assignment and the cell means on ``device``."""
    n, d = embeddings.shape
    n_cells = max(1, -(-n // cell_size))
    rng = np.random.default_rng(seed)

    rows = (
        rng.choice(n, size=sample, replace=False) if n > sample
        else np.arange(n)
    )
    x_sample = cb.rotate(np.asarray(embeddings[rows], np.float32))
    k_coarse = min(n_cells, len(rows))
    init = x_sample[rng.choice(len(rows), size=k_coarse, replace=False)]
    coarse = _kmeans_subspace(
        torch.from_numpy(np.ascontiguousarray(x_sample)).to(device),
        torch.from_numpy(np.ascontiguousarray(init)).to(device),
        iters,
    )
    c_half = 0.5 * (coarse * coarse).sum(dim=1)
    rot = None
    if cb.rotation is not None:
        rot = torch.tensor(np.asarray(cb.rotation, np.float32), device=device)

    def rotated_batch(lo: int, hi: int) -> torch.Tensor:
        xb = torch.from_numpy(
            np.ascontiguousarray(embeddings[lo:hi], dtype=np.float32)
        ).to(device)
        return xb if rot is None else xb @ rot

    # nearest coarse centroid by least squares, like the k-means
    assign = np.empty(n, np.int32)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        logits = rotated_batch(lo, hi) @ coarse.T - c_half[None, :]
        assign[lo:hi] = logits.argmax(dim=1).int().cpu().numpy()

    order = np.argsort(assign, kind="stable").astype(np.int32)
    n_total = n_cells * cell_size
    doc_ids = np.full(n_total, -1, np.int32)
    doc_ids[:n] = order
    cell_codes = np.zeros((n_total, codes.shape[1]), np.uint8)
    cell_codes[:n] = np.asarray(codes)[order]

    # cell means over the actual members, in the rotated (scoring) space
    position = np.empty(n, np.int64)
    position[order] = np.arange(n)
    cell_of = torch.from_numpy(position // cell_size).to(device)
    sums = torch.zeros((n_cells, d), dtype=torch.float64, device=device)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        sums.index_add_(0, cell_of[lo:hi], rotated_batch(lo, hi).double())
    counts = torch.bincount(cell_of, minlength=n_cells).double()
    centroids = torch.where(
        counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], 0.0
    )
    return IVFIndex(
        centroids=centroids.float().cpu().numpy(), codes=cell_codes,
        doc_ids=doc_ids, cell_size=cell_size,
    )


def _pq_ivf_topk_impl(
    queries: torch.Tensor,       # [Q, D]
    centroids: torch.Tensor,     # [n_cells, D]
    cell_codes: torch.Tensor,    # [n_cells * cell_size, m] uint8
    cell_doc_ids: torch.Tensor,  # [n_cells * cell_size] int, -1 = pad
    codebooks: torch.Tensor,     # [2m, 16, dsub]
    k: int,
    probes: int,
    cell_size: int,
    q_valid: Optional[torch.Tensor] = None,   # [Q] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ top-k over ``probes`` cells shared by the batch: each valid
    query's own top-``probes // Q`` cells are picked first, the
    remaining slots go to the best cells by the batch's max score; empty
    cells (first id -1) never compete and queries with ``q_valid``
    False do not vote. Returns ``(pq_scores [Q, k], global ids [Q, k])``
    with ``(-inf, -1)`` in empty slots. As the JAX package's
    ``_pq_ivf_topk_impl``."""
    q = queries.shape[0]
    n_cells = centroids.shape[0]
    dev = queries.device
    neg_inf = float("-inf")
    cell_scores = queries.float() @ centroids.float().T          # [Q, n_cells]
    cell_valid = cell_doc_ids.view(n_cells, cell_size)[:, 0] >= 0
    cell_scores = torch.where(cell_valid[None, :], cell_scores, neg_inf)
    if q_valid is not None:
        cell_scores = torch.where(q_valid[:, None], cell_scores, neg_inf)
    t = max(1, min(probes // q, n_cells))
    _, per_q = lax_top_k(cell_scores, t)                         # [Q, t]
    vote = (
        torch.ones((q, t), device=dev) if q_valid is None
        else q_valid[:, None].float().expand(q, t)
    )
    picked = torch.zeros(n_cells, device=dev).scatter_reduce(
        0, per_q.reshape(-1), vote.reshape(-1), reduce="amax"
    )
    agg = cell_scores.max(dim=0).values
    # two keys, picked first, then the aggregate score; stable sorts
    # keep ties in ascending cell order
    by_agg = torch.sort(-agg, stable=True).indices
    by_picked = torch.sort(-picked[by_agg], stable=True).indices
    sel = by_agg[by_picked][:probes]
    # ascending cells: the padded tail cell comes last, so validity of
    # the gathered sub-corpus is a prefix count
    sel = torch.sort(sel).values

    rows = (sel[:, None] * cell_size
            + torch.arange(cell_size, device=dev)[None, :]).reshape(-1)
    sub_codes = cell_codes[rows]                                 # [P*S, m]
    sub_ids = cell_doc_ids[rows].long()                          # [P*S]
    n_sub = probes * cell_size
    n_valid = int((sub_ids >= 0).sum())

    kk = min(k, n_sub)
    s, i = pq_topk(queries, sub_codes, codebooks, kk, n_valid=n_valid)
    i = i.long()
    gids = sub_ids[i.clamp(0, n_sub - 1)]
    bad = (i < 0) | (gids < 0) | ~torch.isfinite(s)
    return torch.where(bad, neg_inf, s), torch.where(bad, -1, gids)


def pq_ivf_topk(
    queries: torch.Tensor,
    ivf: IVFIndex,
    codebooks,
    k: int,
    *,
    probes: int = 64,
    q_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k PQ candidates scanning only ``probes`` cells (o(N) reads);
    rows with ``q_valid`` False neither claim cells nor steer the shared
    probe set. Returns ``(pq_scores [Q, k], global_ids [Q, k])``; the
    candidates feed :func:`legal_rag_tpu_torch.ops.dense.exact_rescore`
    as the flat path's do."""
    dev = queries.device
    probes = min(probes, ivf.n_cells)
    return _pq_ivf_topk_impl(
        queries, torch.from_numpy(np.asarray(ivf.centroids)).to(dev),
        torch.from_numpy(np.asarray(ivf.codes)).to(dev),
        torch.from_numpy(np.asarray(ivf.doc_ids)).to(dev),
        torch.tensor(np.asarray(codebooks, np.float32), device=dev),
        k, probes, ivf.cell_size, q_valid=q_valid,
    )
