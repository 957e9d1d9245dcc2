"""K1: the row-major segment max, phase 1 of the two-phase dense top-k.

:func:`segmax_rm` computes, for every query ``q`` and every segment
``s`` of ``seg_rows`` contiguous doc rows::

    seg_max[q, s] = max over r in [s*seg_rows, (s+1)*seg_rows) of
                    (r < n_valid ? dot(docs[r], queries[q]) : finfo.min)

query-major, ``[Q, N / seg_rows]`` float32, without writing the
``[Q, N]`` score matrix. It replaces the TPU kernel
``legal_rag_tpu/ops/dense.py _segmax_rm_kernel``, including its int8
branch: int8 docs and int8 queries give exact int32 dot products, rows
``>= n_valid`` are masked to ``-2**30``, and the map is int32.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/segmax_rm.cu`` (built with nvcc on first use,
loaded with ctypes) and raises on anything the kernel does not take.
On CPU tensors it runs :func:`segmax_rm_reference`, the plain PyTorch
version of the same function; nothing else ever takes that path.
"""

from __future__ import annotations

import ctypes

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel

SEG_ROWS = 8                          # the kernel's warp layout: 8 rows
SUPPORTED_DIMS = (128, 256, 384, 512, 768)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NEG = float(torch.finfo(torch.float32).min)
INT8_MASK = -(2 ** 30)                # below any int8 dot: 384 * 127**2 < 2**23


def segmax_rm_reference(
    queries: torch.Tensor,      # [Q, D]
    docs: torch.Tensor,         # [N, D], N a multiple of seg_rows
    n_valid: int,
    seg_rows: int = SEG_ROWS,
) -> torch.Tensor:
    """Plain PyTorch K1: full ``[N, Q]`` fp32 scores, rows ``>= n_valid``
    masked to the finite fp32 minimum, max over each segment.

    int8 docs and queries: the fp32 product of their values is exact
    (every partial sum is an integer below 2**24 in magnitude, in any
    order, as long as the matmul runs in true fp32 and not TF32), so
    the int32 map equals the kernel's bit for bit."""
    n = docs.shape[0]
    scores = docs.float() @ queries.float().T                    # [N, Q]
    row = torch.arange(n, device=docs.device)[:, None]
    if docs.dtype == torch.int8:
        scores = torch.where(row < n_valid, scores, float(INT8_MASK))
        seg = scores.view(n // seg_rows, seg_rows, -1).amax(dim=1)
        return seg.T.to(torch.int32).contiguous()
    scores = torch.where(row < n_valid, scores, _NEG)
    seg = scores.view(n // seg_rows, seg_rows, -1).amax(dim=1)  # [S, Q]
    return seg.T.contiguous()


class SegmaxKernel(CudaKernel):
    """K1's library; ``launches`` counts float32/bfloat16 launches and
    ``int8_launches`` those of the int8 tier."""

    def __init__(self) -> None:
        super().__init__("segmax_rm", "segmax_rm.cu", {
            "segmax_rm_launch": [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ],
        })
        self.int8_launches = 0

    def count_launch(self, int8: bool = False) -> None:
        with self._lock:
            if int8:
                self.int8_launches += 1
            else:
                self.launches += 1


K1 = SegmaxKernel()


def segmax_rm(
    queries: torch.Tensor,      # [Q, D], the docs' dtype
    docs: torch.Tensor,         # [N, D] float32, bfloat16 or int8
    n_valid: int,
    seg_rows: int = SEG_ROWS,
) -> torch.Tensor:
    """Segment maxima ``[Q, N / seg_rows]``: float32, or int32 for int8
    docs (see module doc)."""
    if docs.device.type == "cpu" and queries.device.type == "cpu":
        return segmax_rm_reference(queries, docs, n_valid, seg_rows)
    if docs.device.type != "cuda" or queries.device != docs.device:
        raise ValueError(
            f"segmax_rm: docs on {docs.device}, queries on "
            f"{queries.device}; both must be on one CUDA device"
        )
    if docs.dim() != 2 or queries.dim() != 2:
        raise ValueError("segmax_rm: docs and queries must be 2-D")
    n, d = docs.shape
    q = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"segmax_rm: dim mismatch {queries.shape[1]} vs {d}")
    if docs.dtype not in _DTYPE_CODES or queries.dtype != docs.dtype:
        raise ValueError(
            f"segmax_rm: docs {docs.dtype} / queries {queries.dtype}; "
            "both float32, both bfloat16 or both int8"
        )
    if seg_rows != SEG_ROWS:
        raise ValueError(f"segmax_rm: the kernel takes seg_rows={SEG_ROWS}")
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"segmax_rm: dim {d} not in {SUPPORTED_DIMS}")
    if n == 0 or n % seg_rows or q == 0:
        raise ValueError(
            f"segmax_rm: need N > 0 a multiple of {seg_rows} and Q > 0 "
            f"(got N={n}, Q={q})"
        )
    if not (docs.is_contiguous() and queries.is_contiguous()):
        raise ValueError("segmax_rm: docs and queries must be contiguous")
    if docs.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("segmax_rm: tensors must be 16-byte aligned")
    is_int8 = docs.dtype == torch.int8
    out = torch.empty((q, n // seg_rows),
                      dtype=torch.int32 if is_int8 else torch.float32,
                      device=docs.device)
    lib = K1.library()
    stream = torch.cuda.current_stream(docs.device).cuda_stream
    err = lib.segmax_rm_launch(
        docs.data_ptr(), queries.data_ptr(), out.data_ptr(), n, d, q,
        max(0, min(int(n_valid), n)), _DTYPE_CODES[docs.dtype],
        docs.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"segmax_rm kernel launch failed: CUDA error {err}")
    K1.count_launch(int8=is_int8)
    return out
