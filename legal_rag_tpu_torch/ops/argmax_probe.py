"""P: a compile-and-launch probe of the card's toolchain.

The counterpart of the JAX package's hardware probe
(``tests/test_tpu_hardware.py``, an in-kernel argmax of an ``[8, 256]``
input with equal maxima at columns 33 and 200, which the TPU resolves to
the LAST occurrence). :func:`row_argmax` reduces each row of a float32
matrix to its (max, lowest index), the tie rule K3's selection relies
on, so :func:`probe_input`'s rows give 33.

On a CUDA tensor the wrapper launches ``legal_rag_tpu_torch/csrc/
argmax_probe.cu`` (built with nvcc on first use, loaded with ctypes);
on a CPU tensor it runs :func:`row_argmax_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel, current_stream

TIE_COLUMNS = (33, 200)

P = CudaKernel("argmax_probe", "argmax_probe.cu", {
    "argmax_probe_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ],
})


def probe_input(device="cuda") -> torch.Tensor:
    """The probe's ``[8, 256]`` rows: zeros with ones at 33 and 200."""
    x = torch.zeros((8, 256), dtype=torch.float32, device=device)
    x[:, list(TIE_COLUMNS)] = 1.0
    return x


def row_argmax_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch P: per row, the lowest column holding the max."""
    col = torch.arange(x.shape[1], device=x.device).expand_as(x)
    at_max = x == x.amax(dim=1, keepdim=True)
    return torch.where(at_max, col, x.shape[1]).amin(dim=1).int()


def row_argmax(x: torch.Tensor) -> torch.Tensor:
    """``[R]`` int32: each row's (max, lowest index) column."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return row_argmax_reference(x)
        raise ValueError(f"row_argmax: x on {x.device}; need a CUDA tensor")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("row_argmax: x must be 2-D contiguous float32")
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"row_argmax: empty input {tuple(x.shape)}")
    dev = x.get_device()
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    P.launch("argmax_probe_launch", x.data_ptr(), rows, cols,
             out.data_ptr(), dev, current_stream(dev))
    return out
