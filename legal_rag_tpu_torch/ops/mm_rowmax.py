"""X2: the matmul probe, the tensor cores' product on top of the stream.

For queries ``[Q, D]`` and ``docs_t [D, N_pad]`` cut into column blocks
of ``block_n``, :func:`mm_rowmax` returns ``[Q, N_pad / block_n]``
float32: each block's ``[Q, D] x [D, block_n]`` product in fp32, reduced
to its row max. The TPU probe ``scripts/exp_dense_roofline.py
mm_kernel`` computes the same products and keeps only the last block's
row max (its output block never moves): that is ``out[:, -1:]`` here.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/mm_rowmax.cu`` (bf16, ``mma.sync`` on the
tensor cores; built with nvcc on first use, loaded with ctypes) and
raises on anything the kernel does not take. On CPU tensors it runs
:func:`mm_rowmax_reference`, the plain PyTorch version of the same
function; nothing else ever takes that path.
"""

from __future__ import annotations

import ctypes

import torch

from legal_rag_tpu_torch.utils.cuda_build import (
    CudaKernel, current_stream, sm_count,
)

TILE_N = 128          # columns a kernel tile; block_n is a multiple of it
DEPTH = 32            # D is a multiple of the kernel's k-chunk
MAX_DIM = 1024
_BLOCKS_PER_SM = 2    # resident blocks an SM holds (86 KB of shared memory each at D=384)

X2 = CudaKernel("mm_rowmax", "mm_rowmax.cu", {
    "mm_rowmax_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ],
})


def _blocks(docs_t: torch.Tensor, block_n: int) -> int:
    n_pad = docs_t.shape[1]
    if block_n < 1 or n_pad == 0 or n_pad % block_n:
        raise ValueError(f"mm_rowmax: N_pad={n_pad} is not a positive "
                         f"multiple of block_n={block_n}")
    return n_pad // block_n


def mm_rowmax_reference(
    queries: torch.Tensor, docs_t: torch.Tensor, block_n: int
) -> torch.Tensor:
    """Plain PyTorch X2: the fp32 product (bf16 widens exactly), then
    the max over each block's columns."""
    q = queries.shape[0]
    nb = _blocks(docs_t, block_n)
    scores = queries.float() @ docs_t.float()
    return scores.view(q, nb, block_n).amax(dim=-1)


def mm_rowmax(
    queries: torch.Tensor,      # [Q, D] bfloat16
    docs_t: torch.Tensor,       # [D, N_pad] bfloat16, N_pad % block_n == 0
    block_n: int,
) -> torch.Tensor:
    """Row maxima of every block's product, ``[Q, N_pad / block_n]``."""
    if docs_t.device.type == "cpu" and queries.device.type == "cpu":
        return mm_rowmax_reference(queries, docs_t, block_n)
    if docs_t.device.type != "cuda" or queries.device != docs_t.device:
        raise ValueError(
            f"mm_rowmax: docs_t on {docs_t.device}, queries on "
            f"{queries.device}; both must be on one CUDA device"
        )
    if (docs_t.dim() != 2 or queries.dim() != 2
            or docs_t.dtype != torch.bfloat16
            or queries.dtype != torch.bfloat16):
        raise ValueError("mm_rowmax: queries and docs_t must be 2-D bfloat16")
    nb = _blocks(docs_t, block_n)
    d, n_pad = docs_t.shape
    q = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"mm_rowmax: dim mismatch {queries.shape[1]} vs {d}")
    if q == 0 or d % DEPTH or not 0 < d <= MAX_DIM or block_n % TILE_N:
        raise ValueError(
            f"mm_rowmax: need Q > 0, D a multiple of {DEPTH} up to "
            f"{MAX_DIM} and block_n a multiple of {TILE_N} (got Q={q}, "
            f"D={d}, block_n={block_n})"
        )
    if not (docs_t.is_contiguous() and queries.is_contiguous()):
        raise ValueError("mm_rowmax: queries and docs_t must be contiguous")
    if docs_t.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("mm_rowmax: tensors must be 16-byte aligned")
    dev = docs_t.device
    n_tiles = n_pad // TILE_N
    sms = sm_count(dev.index or 0)
    grid_x = min(n_tiles, _BLOCKS_PER_SM * sms)
    partial = torch.empty((q, n_tiles), dtype=torch.float32, device=dev)
    out = torch.empty((q, nb), dtype=torch.float32, device=dev)
    X2.launch(
        "mm_rowmax_launch",
        queries.data_ptr(), q, d, docs_t.data_ptr(), docs_t.stride(0), n_pad,
        block_n, grid_x, partial.data_ptr(), out.data_ptr(), dev.index or 0,
        current_stream(dev.index or 0),
    )
    return out
