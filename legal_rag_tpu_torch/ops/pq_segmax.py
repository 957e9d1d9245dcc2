"""K2: the 4-bit PQ segment max, phase 1 of the PQ tier's top-k.

For packed codes ``codes [N, m]`` (byte ``b`` holds nibble subspaces
``2b`` low and ``2b+1`` high) and per-query lookup tables
``lut [Q, 2m, 16]``, :func:`pq_segmax` computes::

    score[r, q]  = sum over s of lut[q, s, nibble_s(codes[r])]
    seg_max[q, g] = max over r in [8g, 8g+8) of
                    (r < N ? score[r, q] : finfo.min)

query-major, ``[Q, ceil(N / 8)]`` float32. It replaces the TPU kernel
``legal_rag_tpu/ops/pq.py _pq_segmax_kernel``; the tables are the bf16
values that kernel reads, summed in fp32.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/pq_segmax.cu`` (built with nvcc on first use,
loaded with ctypes) and raises on anything the kernel does not take.
On CPU tensors it runs :func:`pq_segmax_reference`, the plain PyTorch
version of the same function; nothing else ever takes that path.
"""

from __future__ import annotations

import ctypes

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel

SEG_ROWS = 8                          # the kernel's segment: 8 threads
SUPPORTED_M = (8, 16, 32, 48)         # packed bytes per doc
_NEG = float(torch.finfo(torch.float32).min)
_REF_ELEMS = 1 << 24                  # plain version: gathered values per block


def unpack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """``[..., m]`` packed uint8 -> ``[..., 2m]`` int64 nibble codes
    (low nibble first)."""
    c = codes.long()
    return torch.stack([c & 0xF, c >> 4], dim=-1).flatten(-2)


def pq_segmax_reference(
    lut: torch.Tensor,          # [Q, 2m, 16], read as its values in fp32
    codes: torch.Tensor,        # [N, m] uint8
    seg_rows: int = SEG_ROWS,
) -> torch.Tensor:
    """Plain PyTorch K2: gather each doc's ``2m`` table entries per
    query and sum them in fp32, in row blocks (bounding the
    ``[Q, block, 2m]`` transient), then the masked segment max."""
    q, n_sub, _ = lut.shape
    n = codes.shape[0]
    n_segs = -(-n // seg_rows)
    flat = lut.float().reshape(q, n_sub * 16)
    base = torch.arange(n_sub, device=codes.device) * 16
    scores = torch.full((q, n_segs * seg_rows), _NEG, device=codes.device)
    block = max(256, _REF_ELEMS // (q * n_sub))
    for lo in range(0, n, block):
        idx = unpack_nibbles(codes[lo:lo + block]) + base        # [B, 2m]
        scores[:, lo:lo + idx.shape[0]] = flat[:, idx].sum(dim=2)
    return scores.view(q, n_segs, seg_rows).amax(dim=2)


K2 = CudaKernel("pq_segmax", "pq_segmax.cu", {
    "pq_segmax_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
})


def pq_segmax(
    lut: torch.Tensor,          # [Q, 2m, 16] bfloat16
    codes: torch.Tensor,        # [N, m] uint8
    seg_rows: int = SEG_ROWS,
) -> torch.Tensor:
    """Segment maxima ``[Q, ceil(N / seg_rows)]`` float32 (module doc)."""
    if lut.device.type == "cpu" and codes.device.type == "cpu":
        return pq_segmax_reference(lut, codes, seg_rows)
    if codes.device.type != "cuda" or lut.device != codes.device:
        raise ValueError(
            f"pq_segmax: codes on {codes.device}, lut on {lut.device}; "
            "both must be on one CUDA device"
        )
    if codes.dim() != 2 or lut.dim() != 3:
        raise ValueError("pq_segmax: codes must be 2-D and lut 3-D")
    n, m = codes.shape
    q = lut.shape[0]
    if codes.dtype != torch.uint8 or lut.dtype != torch.bfloat16:
        raise ValueError(
            f"pq_segmax: codes {codes.dtype} / lut {lut.dtype}; need "
            "uint8 codes and a bfloat16 table"
        )
    if lut.shape[1:] != (2 * m, 16):
        raise ValueError(
            f"pq_segmax: lut {tuple(lut.shape)} does not match m={m} "
            f"(want [Q, {2 * m}, 16])"
        )
    if seg_rows != SEG_ROWS:
        raise ValueError(f"pq_segmax: the kernel takes seg_rows={SEG_ROWS}")
    if m not in SUPPORTED_M:
        raise ValueError(f"pq_segmax: m={m} not in {SUPPORTED_M}")
    if n == 0 or q == 0:
        raise ValueError(f"pq_segmax: need N > 0 and Q > 0 (got {n}, {q})")
    if not (codes.is_contiguous() and lut.is_contiguous()):
        raise ValueError("pq_segmax: codes and lut must be contiguous")
    if codes.data_ptr() % 4 or lut.data_ptr() % 4:
        raise ValueError("pq_segmax: tensors must be 4-byte aligned")
    out = torch.empty((q, -(-n // seg_rows)), dtype=torch.float32,
                      device=codes.device)
    lib = K2.library()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.pq_segmax_launch(
        codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, m, q,
        codes.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"pq_segmax kernel launch failed: CUDA error {err}")
    K2.count_launch()
    return out
