"""K3: the fused column-major matmul + top-k, without the ``[Q, N]`` scores.

For ``docs_t [D, N]`` and queries ``[Q, D]``, :func:`fused_topk` returns
per query the ``k`` best columns by (score descending, lowest id on
ties), where a column ``c >= min(N, n_valid)`` scores
``finfo(float32).min`` and still competes: with ``n_valid < k <= N``
the tail holds masked ids in ascending order, as the TPU kernel returns
them. ``k > N`` raises. It replaces the TPU kernel
``legal_rag_tpu/ops/dense.py _fused_topk_kernel``.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/fused_topk.cu`` (scores on the tensor cores
by ``mma.sync``: bf16 directly, fp32 as 3xTF32; a partial top-k per doc
split, then a merge; built with nvcc on first use, loaded with ctypes)
and raises on anything the kernel does not take. Any ``k <= N`` and any
``D``: past 512 candidate slots (``k > 480``) the kernel's buffers move
to device memory, and a query tile that does not fit in shared memory
beside the doc ring streams through it. On CPU tensors it runs :func:`fused_topk_reference`, the plain
PyTorch version of the same function; nothing else ever takes that path.

Numerics: the plain version sums fp32 products over ``e = 0 .. D-1`` in
that order, each product rounded before it is added (bf16 widens
exactly). The kernel's tensor cores sum in their own order, so the two
agree within ``1e-5`` on unit vectors at D = 384, not bit for bit, and
their ids agree under the tie-aware rule (a doc may trade places with
one whose score is within that band). Identical doc columns score
identically on both and tie by lowest id.

:func:`launch_plan` derives the kernel's query tile, buffer size, split
count and whether the queries stream from the dtype, D, k, N, Q and the
card's SM count, so that the block's shared memory stays within 227 KB.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from legal_rag_tpu_torch.utils.cuda_build import (
    CudaKernel, current_stream, sm_count,
)

MAX_SMEM = 232_448           # dynamic shared memory a block can take
SM_SMEM = 233_472            # an SM's shared memory, 1 KB a block reserved
_TILE = 128                  # columns a partial block scores at a time
_DEPTH = 32                  # rows of docs_t a staged chunk holds
_RING = {torch.float32: (4, _TILE + 4), torch.bfloat16: (6, _TILE + 8)}
_BLOCKS_PER_SM = 2           # most 128-thread partial blocks an SM holds
_SHARED_CAP = 512            # most candidate slots kept in shared memory
_MERGE_ROWS = 9              # the merge block's buffers: 8 warps and one
_QPITCH = _DEPTH + 8         # a streamed query chunk's row
# device memory the large-k scratch may take; the split count shrinks
# to stay within it
_SCRATCH_BYTES = 1 << 30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = float(torch.finfo(torch.float32).min)

K3 = CudaKernel("fused_topk", "fused_topk.cu", {
    "fused_topk_launch": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, *[ctypes.c_void_p] * 8,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "fused_topk_smem_bytes": [ctypes.c_int] * 5,
})


def fused_scores_reference(
    queries: torch.Tensor,      # [Q, D]
    docs_t: torch.Tensor,       # [D, N]
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """``[Q, N]`` fp32 scores of the plain version: sums over ``D`` in
    order (one rounded product and one rounded add per step), masked
    columns set to the finite fp32 minimum."""
    n = docs_t.shape[1]
    limit = n if n_valid is None else max(0, min(n, int(n_valid)))
    q = queries.float()
    scores = torch.zeros((q.shape[0], n), device=docs_t.device)
    for e in range(docs_t.shape[0]):
        scores.add_(q[:, e:e + 1] * docs_t[e].float())
    scores[:, limit:] = _NEG
    return scores


def fused_topk_reference(
    queries: torch.Tensor,      # [Q, D]
    docs_t: torch.Tensor,       # [D, N]
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: :func:`fused_scores_reference` and a stable
    descending sort, whose ties keep ascending ids."""
    scores = fused_scores_reference(queries, docs_t, n_valid)
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].int()


class Plan(NamedTuple):
    query_tile: int     # queries a partial block holds: 16, 32 or 64
    cap: int            # candidate slots a query in a partial block
    n_splits: int       # partial blocks along the docs per query tile
    smem: int           # a partial block's dynamic shared memory, bytes
    stream_q: bool      # queries stream through the ring (large D)


def capacity(k: int) -> int:
    """Candidate slots a query: the smallest power of two >= k + 32, so
    that a compaction always frees room for a warp's offers and the
    buffer sorts in place."""
    cap = 64
    while cap < k + 32:
        cap *= 2
    return cap


def smem_bytes(dtype: torch.dtype, d: int, query_tile: int, cap: int,
               stream_q: bool = False) -> int:
    """The partial block's shared memory: the doc ring, the query tile
    (rows of D rounded up to 32, plus 8; or, streamed, a [QT, 40] chunk
    a stage), the candidate buffers where they stay in shared memory
    (rows of cap + 1 slots, cap <= 512) and four words a row;
    ``fused_topk.cu partial_smem`` computes the same."""
    stages, pitch = _RING[dtype]
    elt = 4 if dtype == torch.float32 else 2
    dp = -(-d // _DEPTH) * _DEPTH
    queries = (stages * query_tile * _QPITCH if stream_q
               else query_tile * (dp + 8)) * elt
    buffers = query_tile * (cap + 1) * 8 if cap <= _SHARED_CAP else 0
    return (stages * _DEPTH * pitch * elt + queries + buffers
            + query_tile * 16)


@functools.lru_cache(maxsize=512)
def launch_plan(dtype: torch.dtype, d: int, k: int, n: int, n_q: int,
                sms: int) -> Plan:
    """The smallest query tile that holds Q, halved while the block's
    shared memory would pass MAX_SMEM, and halved again while too few
    (tile, query tile) blocks exist to give every SM one; 16 queries
    that still do not fit stream through the ring. Then enough doc
    splits for every SM to hold as many blocks as fit (one of 256
    threads at 32 and 64 queries, two of 128 at 16), no split narrower
    than a tile, and (large k) no more than keep the scratch within
    1 GiB."""
    cap = capacity(k)
    tiles = -(-n // _TILE)
    qt = 16 if n_q <= 16 else 32 if n_q <= 32 else 64
    while qt > 16 and (smem_bytes(dtype, d, qt, cap) > MAX_SMEM
                       or tiles * -(-n_q // qt) < sms):
        qt //= 2
    stream_q = smem_bytes(dtype, d, qt, cap) > MAX_SMEM
    smem = smem_bytes(dtype, d, qt, cap, stream_q)
    per_sm = max(1, min(_BLOCKS_PER_SM if qt == 16 else 1,
                        SM_SMEM // (smem + 1024)))
    n_qt = -(-n_q // qt)
    n_splits = max(1, min(tiles, -(-per_sm * sms // n_qt)))
    per_split = n_q * k * 8 + (n_qt * qt * (cap + 1) * 8
                               if cap > _SHARED_CAP else 0)
    n_splits = max(1, min(n_splits, _SCRATCH_BYTES // per_split))
    return Plan(qt, cap, n_splits, smem, stream_q)


def fused_topk(
    queries: torch.Tensor,      # [Q, D], the docs' dtype
    docs_t: torch.Tensor,       # [D, N] float32 or bfloat16, unit column stride
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores [Q, k] f32, ids [Q, k] i32)`` (module doc). ``docs_t``
    may be a column slice of a wider matrix."""
    n = docs_t.shape[1]
    if not 0 < k <= n:
        raise ValueError(f"fused_topk: need 0 < k <= N (k={k}, N={n})")
    if not (docs_t.is_cuda and queries.is_cuda):
        if docs_t.device.type == "cpu" and queries.device.type == "cpu":
            return fused_topk_reference(queries, docs_t, k, n_valid)
    dev = docs_t.get_device()
    if not docs_t.is_cuda or queries.get_device() != dev:
        raise ValueError(
            f"fused_topk: docs_t on {docs_t.device}, queries on "
            f"{queries.device}; both must be on one CUDA device"
        )
    if docs_t.dim() != 2 or queries.dim() != 2:
        raise ValueError("fused_topk: docs_t and queries must be 2-D")
    d = docs_t.shape[0]
    q = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"fused_topk: dim mismatch {queries.shape[1]} vs {d}")
    dtype = docs_t.dtype
    if dtype not in _DTYPE_CODES or queries.dtype != dtype:
        raise ValueError(
            f"fused_topk: docs_t {dtype} / queries {queries.dtype}; "
            "both float32 or both bfloat16"
        )
    if d == 0 or q == 0 or n >= 2 ** 31:
        raise ValueError(
            f"fused_topk: need D > 0, Q > 0 and N < 2**31 "
            f"(got D={d}, Q={q}, N={n})"
        )
    ld = docs_t.stride(0)
    if docs_t.stride(1) != 1 or ld < n:
        raise ValueError("fused_topk: docs_t rows must be contiguous")
    if not queries.is_contiguous():
        raise ValueError("fused_topk: queries must be contiguous")
    plan = launch_plan(dtype, d, k, n, q, sm_count(dev))
    device = docs_t.device
    # one allocation for the scratch (scores, then ids) and one for both
    # outputs (the scores' bits, then the ids)
    part = torch.empty((2, q, plan.n_splits, k), dtype=torch.int32,
                       device=device)
    out = torch.empty((2, q, k), dtype=torch.int32, device=device)
    out_s, out_i = out[0].view(torch.float32), out[1]
    limit = n if n_valid is None else max(0, min(n, int(n_valid)))
    part_s = part.data_ptr()
    out_p = out.data_ptr()
    bufs = [None] * 4
    if plan.cap > _SHARED_CAP:
        # the candidate buffers in device memory: the partial blocks'
        # (scores, then ids) and the merge's
        n_blocks = -(-q // plan.query_tile) * plan.n_splits
        blk = n_blocks * plan.query_tile * (plan.cap + 1)
        mrg = q * _MERGE_ROWS * plan.cap
        scratch = torch.empty(2 * (blk + mrg), dtype=torch.int32,
                              device=device)
        p = scratch.data_ptr()
        bufs = [p, p + blk * 4, p + 2 * blk * 4, p + (2 * blk + mrg) * 4]
    K3.launch(
        "fused_topk_launch",
        docs_t.data_ptr(), ld, n, queries.data_ptr(), q, d, k, limit,
        plan.query_tile, plan.cap, plan.n_splits, int(plan.stream_q),
        part_s, part_s + q * plan.n_splits * k * 4, *bufs,
        out_p, out_p + q * k * 4, _DTYPE_CODES[dtype], dev,
        current_stream(dev),
    )
    return out_s, out_i
