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

On a CUDA tensor the wrapper launches a hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/segmax_rm.cu`` (built with nvcc on first use,
loaded with ctypes) and raises on anything the kernels do not take. Two
kernels share the file, chosen by shape (:func:`uses_tensor_cores`),
never by failure: the tensor-core kernel takes every ``seg_rows`` in
:data:`SEG_ROWS_ALLOWED`, any ``D`` and any ``Q`` (query tiles of at most
64, several of them past 64), and the CUDA-core kernel keeps the small
fp32 and int8 batches at ``seg_rows`` 8 and the widths it was built for.
On CPU tensors it runs :func:`segmax_rm_reference`, the plain PyTorch
version of the same function; nothing else ever takes that path.

:func:`launch_plan` derives the tensor-core kernel's query tile and
whether the queries stay resident in shared memory or stream with the
docs, so that a block's shared memory stays within 232,448 bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel, current_stream

SEG_ROWS = 8                          # the two-phase search's default
SEG_ROWS_ALLOWED = (1, 2, 4, 8, 16, 32, 64)
QUERY_TILES = (8, 16, 32, 64)         # the tensor-core kernel's builds
MAX_SMEM = 232_448                    # dynamic shared memory a block can take
# the most a block may take for two to share an SM (233,472 bytes, 1 KB
# reserved a block)
TWO_BLOCKS_SMEM = 233_472 // 2 - 1024
_CHUNK = 128                          # bytes of depth a staged chunk holds
# The CUDA-core kernel (a warp an 8-row segment, FMAs and shuffles) is
# built for fp32 and int8 at these widths and seg_rows 8; it keeps
# batches of at most CUDA_CORE_MAX_Q[dtype] queries (see
# uses_tensor_cores). The engine pads a batch to a power of two of at
# least 8, so the served batches are 8, 16, 32, 64, 128, ...; each
# switch is the largest of those at which the CUDA-core kernel was no
# slower than the tensor-core one in scripts/k1_k2_shapes.py (1,007,616
# rows, D=384; NVIDIA H100 80GB HBM3, 700 W), ms CUDA cores / tensor
# cores: fp32 0.575 / 0.716 at Q=16, 0.960 / 0.966 at 32; int8 0.144 /
# 0.156 at Q=8, 0.231 / 0.216 at 16. bf16 takes the tensor cores at
# every Q (at Q=8 0.300 ms, against 0.314 for the bf16 CUDA-core kernel
# this file had before).
CUDA_CORE_DIMS = (128, 256, 384, 512, 768)
CUDA_CORE_MAX_Q = {torch.float32: 32, torch.int8: 8}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NEG = float(torch.finfo(torch.float32).min)
INT8_MASK = -(2 ** 30)
# The int8 mask stays below every real sum while D * 128**2 < 2**30 (an
# int8 value can be -128, so a product can reach 128 * 128 in magnitude).
INT8_MAX_DIM = (2 ** 30 - 1) // 128 ** 2


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


class Plan(NamedTuple):
    query_tile: int     # queries a block: one of QUERY_TILES
    stream_q: bool      # queries stream with the docs (else resident)
    smem: int           # a block's dynamic shared memory, bytes


def smem_bytes(elt: int, d: int, query_tile: int, stream_q: bool) -> int:
    """The tensor-core block's shared memory: the ring of doc chunks (3
    stages of 256 rows up to 32 queries, of 128 rows above), rows of 128
    bytes plus 32 (fp32) or 16 bytes of padding, and either
    the resident queries (rows of D padded to 128 bytes, plus the
    padding) or each stage's query chunk; ``segmax_rm.cu
    tc::smem_bytes`` computes the same."""
    pad = 32 if elt == 4 else 16
    rows = 256 if query_tile <= 32 else 128
    if stream_q:
        return 3 * (rows + query_tile) * (_CHUNK + pad)
    dpb = -(-d * elt // _CHUNK) * _CHUNK
    return 3 * rows * (_CHUNK + pad) + query_tile * (dpb + pad)


@functools.lru_cache(maxsize=512)
def launch_plan(dtype: torch.dtype, d: int, n_q: int) -> Plan:
    """The smallest query tile that holds Q, or 64 a tile (several query
    tiles) above 64; the queries resident in shared memory where they
    fit. At 64 queries they stream with the docs instead when that lets
    two blocks share an SM and resident queries would not (one block of
    4 warps an SM leaves too few warps to hide the tensor cores'
    latency)."""
    elt = torch.empty((), dtype=dtype).element_size()
    qt = next((t for t in QUERY_TILES if t >= n_q), QUERY_TILES[-1])
    resident = smem_bytes(elt, d, qt, False)
    stream_q = resident > MAX_SMEM or (
        qt >= 64 and resident > TWO_BLOCKS_SMEM
        and smem_bytes(elt, d, qt, True) <= TWO_BLOCKS_SMEM)
    return Plan(qt, stream_q, smem_bytes(elt, d, qt, stream_q))


def uses_tensor_cores(dtype: torch.dtype, d: int, n_q: int,
                      seg_rows: int) -> bool:
    """Which kernel a launch takes. The CUDA-core kernel keeps batches
    of at most CUDA_CORE_MAX_Q[dtype] fp32 or int8 queries at seg_rows 8
    and the widths it is built for; every other shape goes to the
    tensor-core kernel."""
    return not (n_q <= CUDA_CORE_MAX_Q.get(dtype, 0) and seg_rows == 8
                and d in CUDA_CORE_DIMS)


def copy_width(row_bytes: int, ptr: int) -> int:
    """The widest asynchronous copy (16, 8 or 4 bytes) that every row
    start allows, or 0 for byte loads."""
    for w in (16, 8, 4):
        if row_bytes % w == 0 and ptr % w == 0:
            return w
    return 0


class SegmaxKernel(CudaKernel):
    """K1's library; ``launches`` counts float32/bfloat16 launches and
    ``int8_launches`` those of the int8 tier, whichever kernel ran;
    ``tensor_core_launches`` counts the tensor-core kernel's among both."""

    COUNTERS = ("launches", "int8_launches", "tensor_core_launches")

    def __init__(self) -> None:
        super().__init__("segmax_rm", "segmax_rm.cu", {
            "segmax_rm_launch": [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ],
            "segmax_rm_tc_launch": [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ],
            "segmax_rm_tc_smem_bytes": [ctypes.c_int] * 4,
        })
        self.int8_launches = 0
        self.tensor_core_launches = 0

    def count_launch(self, int8: bool = False,
                     tensor_cores: bool = False) -> None:
        if int8:
            self.int8_launches += 1
        else:
            self.launches += 1
        if tensor_cores:
            self.tensor_core_launches += 1


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
    if seg_rows not in SEG_ROWS_ALLOWED:
        raise ValueError(
            f"segmax_rm: seg_rows={seg_rows} not in {SEG_ROWS_ALLOWED}")
    if n == 0 or n % seg_rows or q == 0 or d == 0:
        raise ValueError(
            f"segmax_rm: need N > 0 a multiple of {seg_rows}, D > 0 and "
            f"Q > 0 (got N={n}, D={d}, Q={q})"
        )
    if docs.dtype == torch.int8 and d > INT8_MAX_DIM:
        raise ValueError(
            f"segmax_rm: int8 D={d} > {INT8_MAX_DIM}: the -2**30 mask "
            "would no longer lie below every dot product")
    if not (docs.is_contiguous() and queries.is_contiguous()):
        raise ValueError("segmax_rm: docs and queries must be contiguous")
    if uses_tensor_cores(docs.dtype, d, q, seg_rows):
        return _launch_tensor_cores(queries, docs, n_valid, seg_rows)
    return _launch_cuda_cores(queries, docs, n_valid)


def _map(queries: torch.Tensor, docs: torch.Tensor,
         seg_rows: int) -> torch.Tensor:
    return torch.empty(
        (queries.shape[0], docs.shape[0] // seg_rows),
        dtype=torch.int32 if docs.dtype == torch.int8 else torch.float32,
        device=docs.device)


def _launch_tensor_cores(queries: torch.Tensor, docs: torch.Tensor,
                         n_valid: int, seg_rows: int) -> torch.Tensor:
    """The tensor-core kernel on inputs :func:`segmax_rm` has checked
    (timing scripts and tests call it to compare the two kernels)."""
    n, d = docs.shape
    q = queries.shape[0]
    out = _map(queries, docs, seg_rows)
    plan = launch_plan(docs.dtype, d, q)
    row_bytes = d * docs.element_size()
    dev = docs.device.index or 0
    K1.launch(
        "segmax_rm_tc_launch",
        docs.data_ptr(), queries.data_ptr(), out.data_ptr(), n, d, q,
        max(0, min(int(n_valid), n)), seg_rows, _DTYPE_CODES[docs.dtype],
        plan.query_tile, int(plan.stream_q),
        copy_width(row_bytes, docs.data_ptr()),
        copy_width(row_bytes, queries.data_ptr()), dev, current_stream(dev),
        int8=docs.dtype == torch.int8, tensor_cores=True,
    )
    return out


def _launch_cuda_cores(queries: torch.Tensor, docs: torch.Tensor,
                       n_valid: int) -> torch.Tensor:
    """The CUDA-core kernel (fp32 or int8, seg_rows 8, D in
    CUDA_CORE_DIMS) on inputs :func:`segmax_rm` has checked."""
    if docs.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("segmax_rm: tensors must be 16-byte aligned")
    n, d = docs.shape
    q = queries.shape[0]
    out = _map(queries, docs, SEG_ROWS)
    dev = docs.device.index or 0
    K1.launch(
        "segmax_rm_launch",
        docs.data_ptr(), queries.data_ptr(), out.data_ptr(), n, d, q,
        max(0, min(int(n_valid), n)), _DTYPE_CODES[docs.dtype], dev,
        current_stream(dev), int8=docs.dtype == torch.int8,
    )
    return out
