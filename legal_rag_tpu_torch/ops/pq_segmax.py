"""K2: the 4-bit PQ segment max, phase 1 of the PQ tier's top-k.

For packed codes ``codes [N, m]`` (byte ``b`` holds nibble subspaces
``2b`` low and ``2b+1`` high) and per-query lookup tables
``lut [Q, 2m, 16]``, :func:`pq_segmax` computes::

    score[r, q]  = sum over s of lut[q, s, nibble_s(codes[r])]
    seg_max[q, g] = max over r in [S g, S g + S) of
                    (r < N ? score[r, q] : finfo.min)

query-major, ``[Q, ceil(N / S)]`` float32, for segments of ``S =
seg_rows`` rows (8 by default; the kernels take every seg_rows from 1
to 64). It replaces the TPU kernel
``legal_rag_tpu/ops/pq.py _pq_segmax_kernel``; the tables are the bf16
values that kernel reads, summed in fp32.

On a CUDA tensor the wrapper launches a hand-written Hopper kernel in
``legal_rag_tpu_torch/csrc/pq_segmax.cu`` (built with nvcc on first use,
loaded with ctypes) and raises on anything the kernels do not take. Two
kernels share the file, chosen by the code width, never by failure:
every ``m % 4 == 0`` up to :data:`TC_MAX_M` takes the tensor-core kernel
(the one-hot matrix of each subspace's codes times its slice of the
tables, whose cost per doc is shared by every query of a tile;
:func:`launch_plan` shrinks its query tile, whose tables stay in shared
memory, as ``m`` grows); wider codes, up to :data:`MAX_M`, take the
lookup kernel (one shared-memory table read per doc, query and
subspace; one query's tables fit a block). On CPU tensors it runs
:func:`pq_segmax_reference`, the plain PyTorch version of the same
function; nothing else ever takes that path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from legal_rag_tpu_torch.utils.cuda_build import CudaKernel, current_stream

SEG_ROWS = 8                          # the default segment: 8 rows
SUPPORTED_SEG_ROWS = tuple(range(1, 65))   # the segments the kernels take
QUERY_TILES = (64, 32, 16, 8)         # the kernel's builds, widest first
MAX_SMEM = 232_448                    # dynamic shared memory a block can take
_TILE = 256                           # docs a tensor-core block tile
_LOOKUP_MAX_TILE = 64
_NEG = float(torch.finfo(torch.float32).min)
_REF_ELEMS = 1 << 24                  # plain version: gathered values per block


def smem_bytes(m: int, query_tile: int, stages: int) -> int:
    """The block's shared memory: the query tile's tables (rows of
    ``2m * 16`` bf16 plus 16 bytes) and ``stages`` tiles of 128 code
    rows; ``pq_segmax.cu smem_bytes`` computes the same."""
    return query_tile * (64 * m + 16) + stages * _TILE * m


class Plan(NamedTuple):
    query_tile: int     # queries a block: one of QUERY_TILES
    stages: int         # code tiles in flight: 2, or 1 where memory is short
    smem: int           # a block's dynamic shared memory, bytes


@functools.lru_cache(maxsize=512)
def launch_plan(m: int, n_q: int) -> Plan:
    """The smallest query tile that holds Q, or the widest that fits in
    shared memory with two code stages, else with one; raises when not
    even 8 queries' tables fit (m > MAX_M)."""
    want = next((t for t in reversed(QUERY_TILES) if t >= n_q), QUERY_TILES[0])
    for qt in QUERY_TILES:
        if qt > want:
            continue
        for stages in (2, 1):
            if smem_bytes(m, qt, stages) <= MAX_SMEM:
                return Plan(qt, stages, smem_bytes(m, qt, stages))
    raise ValueError(f"pq_segmax: m={m} > {TC_MAX_M}: 8 queries' tables "
                     "do not fit in shared memory beside the codes")


# the widest code rows whose tables fit the tensor-core kernel (8
# queries, one stage) and the lookup kernel (one query)
TC_MAX_M = max(m for m in range(4, 1024, 4) if smem_bytes(m, 8, 1) <= MAX_SMEM)
MAX_M = MAX_SMEM // 64 // 4 * 4
_LOOKUP_XCH = 64                      # the lookup kernel's 64-row exchange
_LOOKUP_SUMS = 512 * 4                # its turn's sums at other seg_rows


def lookup_smem_bytes(m: int, q_tile: int, seg_rows: int) -> int:
    """The lookup kernel's shared memory: ``q_tile`` queries' tables
    and, at 64 rows a segment, 64 bytes where two warps meet, or at a
    seg_rows that is not a power of two the 512 sums of a block's turn;
    ``pq_segmax.cu lookup_smem_bytes`` computes the same."""
    if seg_rows == 64:
        extra = _LOOKUP_XCH
    else:
        extra = 0 if seg_rows & (seg_rows - 1) == 0 else _LOOKUP_SUMS
    return q_tile * 64 * m + extra


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "pq_segmax_smem_bytes": [ctypes.c_int] * 3,
    "pq_segmax_lookup_smem_bytes": [ctypes.c_int] * 3,
    "pq_segmax_lookup_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
})


def lookup_tile(m: int, n_q: int, seg_rows: int = SEG_ROWS) -> int:
    """The lookup kernel's queries a block: all of them up to 64, as
    many as 232,448 bytes of shared memory hold."""
    room = MAX_SMEM - lookup_smem_bytes(m, 0, seg_rows)
    return max(1, min(_LOOKUP_MAX_TILE, n_q, room // (64 * m)))


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
    if seg_rows not in SUPPORTED_SEG_ROWS:
        raise ValueError(f"pq_segmax: seg_rows={seg_rows}; the kernels take "
                         "1 to 64")
    if m % 4 or not 0 < m <= MAX_M or (
            m > TC_MAX_M and lookup_smem_bytes(m, 1, seg_rows) > MAX_SMEM):
        raise ValueError(f"pq_segmax: m={m}; the kernel takes m % 4 == 0 "
                         f"up to {MAX_M} (one query's tables must fit "
                         "beside the segments' exchange)")
    if n == 0 or q == 0:
        raise ValueError(f"pq_segmax: need N > 0 and Q > 0 (got {n}, {q})")
    if not (codes.is_contiguous() and lut.is_contiguous()):
        raise ValueError("pq_segmax: codes and lut must be contiguous")
    if codes.data_ptr() % 4 or lut.data_ptr() % 16:
        raise ValueError("pq_segmax: codes must be 4-byte and lut 16-byte "
                         "aligned")
    if m <= TC_MAX_M:
        return _launch_tensor_cores(lut, codes, seg_rows)
    return _launch_lookup(lut, codes, seg_rows)


def _launch_tensor_cores(lut: torch.Tensor, codes: torch.Tensor,
                         seg_rows: int = SEG_ROWS) -> torch.Tensor:
    """The tensor-core kernel (m <= TC_MAX_M) on inputs :func:`pq_segmax`
    has checked (tests call it beside the lookup kernel)."""
    n, m = codes.shape
    q = lut.shape[0]
    out = torch.empty((q, -(-n // seg_rows)), dtype=torch.float32,
                      device=codes.device)
    plan = launch_plan(m, q)
    ptr = codes.data_ptr()
    vec = 16 if ptr % 16 == 0 else 8 if ptr % 8 == 0 else 4
    dev = codes.device.index or 0
    err = K2.library().pq_segmax_launch(
        ptr, lut.data_ptr(), out.data_ptr(), n, m, q, seg_rows,
        plan.query_tile, plan.stages, vec, dev, current_stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"pq_segmax kernel launch failed: CUDA error {err}")
    K2.count_launch()
    return out


def _launch_lookup(lut: torch.Tensor, codes: torch.Tensor,
                   seg_rows: int = SEG_ROWS) -> torch.Tensor:
    """The lookup kernel (any m up to MAX_M) on inputs :func:`pq_segmax`
    has checked."""
    n, m = codes.shape
    q = lut.shape[0]
    out = torch.empty((q, -(-n // seg_rows)), dtype=torch.float32,
                      device=codes.device)
    dev = codes.device.index or 0
    err = K2.library().pq_segmax_lookup_launch(
        codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, m, q, seg_rows,
        lookup_tile(m, q, seg_rows), dev, current_stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"pq_segmax kernel launch failed: CUDA error {err}")
    K2.count_launch()
    return out
