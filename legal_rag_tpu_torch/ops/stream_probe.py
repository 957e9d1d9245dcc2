"""X1: the stream probe, a read of every element of the doc matrix.

For ``docs_t [D, N_pad]`` cut into column blocks of ``block_n``,
:func:`stream_probe` returns each block's max ``[N_pad / block_n]``
float32 and their sum taken in block order, the scalar the TPU probe
``scripts/exp_dense_roofline.py stream_kernel`` emits. The work is one
pass over the matrix, so its time is the achievable read rate of the
card for this layout (``legal_rag_tpu_torch.scripts.exp_dense_roofline``
reports it as GB/s).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/stream_probe.cu`` (bf16 only; built with
nvcc on first use, loaded with ctypes) and raises on anything the kernel
does not take. On CPU tensors it runs :func:`stream_probe_reference`,
the plain PyTorch version of the same function; nothing else ever takes
that path. The block maxima are exact in any order, so the kernel's
equal the plain version's bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from legal_rag_tpu_torch.utils.cuda_build import (
    CudaKernel, current_stream, sm_count,
)

_WAVES = 16       # partial blocks per SM that the splits aim at (8 resident)

X1 = CudaKernel("stream_probe", "stream_probe.cu", {
    "stream_probe_launch": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ],
})


def _blocks(docs_t: torch.Tensor, block_n: int) -> int:
    n_pad = docs_t.shape[1]
    if block_n < 1 or n_pad == 0 or n_pad % block_n:
        raise ValueError(f"stream_probe: N_pad={n_pad} is not a positive "
                         f"multiple of block_n={block_n}")
    return n_pad // block_n


def stream_probe_reference(
    docs_t: torch.Tensor, block_n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch X1: each block's max, then their in-order sum."""
    d = docs_t.shape[0]
    nb = _blocks(docs_t, block_n)
    block_max = docs_t.reshape(d, nb, block_n).amax(dim=(0, 2)).float()
    return block_max, torch.cumsum(block_max, dim=0)[-1]


def stream_probe(
    docs_t: torch.Tensor,       # [D, N_pad] bfloat16, N_pad % block_n == 0
    block_n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(block_max [N_pad / block_n] f32, total f32 scalar)``."""
    if docs_t.device.type == "cpu":
        return stream_probe_reference(docs_t, block_n)
    if docs_t.device.type != "cuda":
        raise ValueError(f"stream_probe: docs_t on {docs_t.device}; "
                         "need a CUDA tensor")
    if docs_t.dim() != 2 or docs_t.dtype != torch.bfloat16:
        raise ValueError("stream_probe: docs_t must be 2-D bfloat16")
    nb = _blocks(docs_t, block_n)
    d = docs_t.shape[0]
    if block_n % 8 or nb > 65535 or d == 0:
        raise ValueError(f"stream_probe: need block_n a multiple of 8, at "
                         f"most 65535 blocks and D > 0 (block_n={block_n}, "
                         f"blocks={nb}, D={d})")
    if not docs_t.is_contiguous() or docs_t.data_ptr() % 16:
        raise ValueError("stream_probe: docs_t must be contiguous and "
                         "16-byte aligned")
    dev = docs_t.device
    sms = sm_count(dev.index or 0)
    splits = max(1, min(d, -(-_WAVES * sms // nb)))
    partial = torch.empty(nb * splits, dtype=torch.float32, device=dev)
    block_max = torch.empty(nb, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    X1.launch(
        "stream_probe_launch",
        docs_t.data_ptr(), docs_t.stride(0), d, docs_t.shape[1], block_n,
        splits, partial.data_ptr(), block_max.data_ptr(), total.data_ptr(),
        dev.index or 0, current_stream(dev.index or 0),
    )
    return block_max, total
