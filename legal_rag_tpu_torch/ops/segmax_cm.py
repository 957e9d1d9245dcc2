"""K4: the column-major segment max, phase 1 of ``dense_topk_twophase``.

Docs are stored transposed, ``docs_t [D, N]``. A segment is ``seg_rows``
docs strided 128 apart: map position ``p = G*128 + lane`` holds the docs
``G*seg_rows*128 + r*128 + lane`` for ``r`` in ``[0, seg_rows)``
(:func:`segment_members`). :func:`segmax_cm` computes, query-major::

    seg_max[q, p] = max over the segment's docs c of
                    (c < min(N, n_valid) ? dot(docs_t[:, c], queries[q])
                                         : finfo(float32).min)

as ``[Q, n_segs]`` float32 with ``n_segs = ceil(N / (seg_rows*128))*128``,
without writing the ``[Q, N]`` score matrix. It replaces the TPU kernel
``legal_rag_tpu/ops/dense.py _segmax_kernel``. The map does not depend
on that kernel's ``block_n`` (a multiple of ``seg_rows*128``), so it
equals the TPU kernel's map on every segment both emit; the TPU's extra
trailing segments, from its padding to ``block_n``, are all masked.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/segmax_cm.cu`` (built with nvcc on first use,
loaded with ctypes) and raises on anything the kernel does not take.
On CPU tensors it runs :func:`segmax_cm_reference`, the plain PyTorch
version of the same function; nothing else ever takes that path.
"""

from __future__ import annotations

import ctypes

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel

LANES = 128                           # the stride of a segment's docs
SUPPORTED_SEG_ROWS = (1, 2, 4, 8, 16)
MAX_DIM = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = float(torch.finfo(torch.float32).min)

K4 = CudaKernel("segmax_cm", "segmax_cm.cu", {
    "segmax_cm_launch": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
})


def n_segments(n: int, seg_rows: int) -> int:
    """Map width for ``n`` docs: whole groups of ``seg_rows*128`` docs."""
    return -(-n // (seg_rows * LANES)) * LANES


def segment_members(seg_pos: torch.Tensor, seg_rows: int) -> torch.Tensor:
    """Doc ids ``[..., seg_rows]`` of map positions ``seg_pos`` (ids past
    the corpus belong to masked padding)."""
    group, lane = seg_pos // LANES, seg_pos % LANES
    r = torch.arange(seg_rows, device=seg_pos.device)
    return ((group * (seg_rows * LANES) + lane)[..., None] + r * LANES)


def segmax_cm_reference(
    queries: torch.Tensor,      # [Q, D]
    docs_t: torch.Tensor,       # [D, N]
    n_valid: int,
    seg_rows: int,
) -> torch.Tensor:
    """Plain PyTorch K4: fp32 scores of the unmasked columns (bf16 widens
    exactly), the finite fp32 minimum elsewhere up to the map's padded
    width, then the max over each segment's strided members."""
    q = queries.shape[0]
    n = docs_t.shape[1]
    limit = max(0, min(n, int(n_valid)))
    n_segs = n_segments(n, seg_rows)
    scores = torch.full((q, n_segs * seg_rows), _NEG, device=docs_t.device)
    scores[:, :limit] = queries.float() @ docs_t[:, :limit].float()
    groups = scores.view(q, n_segs // LANES, seg_rows, LANES)
    return groups.amax(dim=2).reshape(q, n_segs)


def segmax_cm(
    queries: torch.Tensor,      # [Q, D], the docs' dtype
    docs_t: torch.Tensor,       # [D, N] float32 or bfloat16, unit column stride
    n_valid: int,
    seg_rows: int,
) -> torch.Tensor:
    """Segment maxima ``[Q, n_segments(N, seg_rows)]`` float32 (module
    doc). ``docs_t`` may be a column slice of a wider matrix."""
    if docs_t.device.type == "cpu" and queries.device.type == "cpu":
        return segmax_cm_reference(queries, docs_t, n_valid, seg_rows)
    if docs_t.device.type != "cuda" or queries.device != docs_t.device:
        raise ValueError(
            f"segmax_cm: docs_t on {docs_t.device}, queries on "
            f"{queries.device}; both must be on one CUDA device"
        )
    if docs_t.dim() != 2 or queries.dim() != 2:
        raise ValueError("segmax_cm: docs_t and queries must be 2-D")
    d, n = docs_t.shape
    q = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"segmax_cm: dim mismatch {queries.shape[1]} vs {d}")
    if docs_t.dtype not in _DTYPE_CODES or queries.dtype != docs_t.dtype:
        raise ValueError(
            f"segmax_cm: docs_t {docs_t.dtype} / queries {queries.dtype}; "
            "both float32 or both bfloat16"
        )
    if seg_rows not in SUPPORTED_SEG_ROWS:
        raise ValueError(
            f"segmax_cm: seg_rows={seg_rows} not in {SUPPORTED_SEG_ROWS}")
    if not 0 < d <= MAX_DIM or n == 0 or q == 0:
        raise ValueError(
            f"segmax_cm: need 0 < D <= {MAX_DIM}, N > 0 and Q > 0 "
            f"(got D={d}, N={n}, Q={q})"
        )
    if docs_t.stride(1) != 1 or docs_t.stride(0) < n:
        raise ValueError("segmax_cm: docs_t rows must be contiguous")
    if not queries.is_contiguous():
        raise ValueError("segmax_cm: queries must be contiguous")
    n_segs = n_segments(n, seg_rows)
    out = torch.empty((q, n_segs), dtype=torch.float32, device=docs_t.device)
    lib = K4.library()
    stream = torch.cuda.current_stream(docs_t.device).cuda_stream
    err = lib.segmax_cm_launch(
        docs_t.data_ptr(), docs_t.stride(0), queries.data_ptr(), q, d,
        out.data_ptr(), n_segs, seg_rows, max(0, min(int(n_valid), n)),
        _DTYPE_CODES[docs_t.dtype], docs_t.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"segmax_cm kernel launch failed: CUDA error {err}")
    K4.count_launch()
    return out
