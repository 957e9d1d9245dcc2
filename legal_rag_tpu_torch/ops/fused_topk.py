"""K3: the fused column-major matmul + top-k, without the ``[Q, N]`` scores.

For ``docs_t [D, N]`` and queries ``[Q, D]``, :func:`fused_topk` returns
per query the ``k`` best columns by (score descending, lowest id on
ties), where a column ``c >= min(N, n_valid)`` scores
``finfo(float32).min`` and still competes: with ``n_valid < k <= N``
the tail holds masked ids in ascending order, as the TPU kernel returns
them. ``k > N`` raises. It replaces the TPU kernel
``legal_rag_tpu/ops/dense.py _fused_topk_kernel``.

Scores are fp32 sums over ``e = 0 .. D-1`` in that order, each product
rounded to fp32 before it is added (bf16 widens exactly). The kernel and
:func:`fused_topk_reference` perform the same roundings, so their scores
agree bit for bit and their ids exactly, ties included.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/fused_topk.cu`` (a partial top-k per doc
split, then a merge; built with nvcc on first use, loaded with ctypes)
and raises on anything the kernel does not take, ``k > MAX_K``
included. On CPU tensors it runs :func:`fused_topk_reference`, the plain
PyTorch version of the same function; nothing else ever takes that path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel

MAX_K = 256                  # buffer slots (512) less one tile (256) a query
MAX_DIM = 1024
_QUERY_TILE = 8              # queries per partial block
_TILE = 256                  # columns a partial block scores at a time
_BLOCKS_PER_SM = 4           # partial blocks in flight per SM (44 KB each)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = float(torch.finfo(torch.float32).min)

K3 = CudaKernel("fused_topk", "fused_topk.cu", {
    "fused_topk_launch": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
})


def fused_topk_reference(
    queries: torch.Tensor,      # [Q, D]
    docs_t: torch.Tensor,       # [D, N]
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: the ``[Q, N]`` fp32 scores summed over ``D`` in
    order (one rounded product and one rounded add per step, the
    kernel's arithmetic), masked columns set to the finite fp32 minimum,
    and a stable descending sort, whose ties keep ascending ids."""
    n = docs_t.shape[1]
    limit = n if n_valid is None else max(0, min(n, int(n_valid)))
    q = queries.float()
    scores = torch.zeros((q.shape[0], n), device=docs_t.device)
    for e in range(docs_t.shape[0]):
        scores.add_(q[:, e:e + 1] * docs_t[e].float())
    scores[:, limit:] = _NEG
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].int()


def _splits(n: int, n_q: int, device: torch.device) -> int:
    """Doc splits per query tile: enough partial blocks to fill the card
    once, and no split narrower than one tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_qt = -(-n_q // _QUERY_TILE)
    return max(1, min(-(-n // _TILE), -(-_BLOCKS_PER_SM * sms // n_qt)))


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
    if docs_t.device.type == "cpu" and queries.device.type == "cpu":
        return fused_topk_reference(queries, docs_t, k, n_valid)
    if docs_t.device.type != "cuda" or queries.device != docs_t.device:
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
    if docs_t.dtype not in _DTYPE_CODES or queries.dtype != docs_t.dtype:
        raise ValueError(
            f"fused_topk: docs_t {docs_t.dtype} / queries {queries.dtype}; "
            "both float32 or both bfloat16"
        )
    if k > MAX_K:
        raise ValueError(f"fused_topk: the kernel takes k <= {MAX_K} (k={k})")
    if not 0 < d <= MAX_DIM or q == 0 or n >= 2 ** 31:
        raise ValueError(
            f"fused_topk: need 0 < D <= {MAX_DIM}, Q > 0 and N < 2**31 "
            f"(got D={d}, Q={q}, N={n})"
        )
    if docs_t.stride(1) != 1 or docs_t.stride(0) < n:
        raise ValueError("fused_topk: docs_t rows must be contiguous")
    if not queries.is_contiguous():
        raise ValueError("fused_topk: queries must be contiguous")
    dev = docs_t.device
    n_splits = _splits(n, q, dev)
    part_s = torch.empty((q, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q, n_splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    limit = n if n_valid is None else max(0, min(n, int(n_valid)))
    lib = K3.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_topk_launch(
        docs_t.data_ptr(), docs_t.stride(0), n, queries.data_ptr(), q, d, k,
        limit, n_splits, part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), _DTYPE_CODES[docs_t.dtype],
        dev.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error {err}")
    K3.count_launch()
    return out_s, out_i
