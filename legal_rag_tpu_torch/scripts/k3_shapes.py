"""K3's times at the smoke's phase-2f shapes, beside its yardsticks.

For float32 and bfloat16 column slices ``docs_t[:, :n]`` of one
``[384, 2**20]`` matrix of unit columns, ``n`` in 2,620 (the serving
corpus), 65,536 and 1,007,616 (the 1M store's padded rows) and 8 and 64
unit queries, k = 10: CUDA-event ms of ``fused_topk`` (kernel K3) and its
plain version, in turns plain, kernel, kernel, plain, and of one PyTorch
call that computes the same function (:func:`library_call`), never
called by the port. The bound is the larger of the bytes over 3.35 TB/s
and the operations over the peak rate of the work's type: bf16 products
at 989 TFLOP/s; fp32 products as K3 computes them, three TF32 products
each (3xTF32), at 495 TFLOP/s.

Run on the card:  python -m legal_rag_tpu_torch.scripts.k3_shapes
(one JSON line a shape).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Tuple

import torch

from legal_rag_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
from legal_rag_tpu_torch.utils.timing import time_ms

D = 384
N_COLS = 1 << 20
N_K3 = (2_620, 65_536, 1_007_616)
Q_K3 = (8, 64)
K = 10
HBM_BYTES_PER_S = 3.35e12
# dense peaks of one H100 SXM (NVIDIA's data sheet); fp32 products count
# three times at the TF32 rate, the work of K3's 3xTF32 split
PEAK = {torch.float32: (3, 495e12), torch.bfloat16: (1, 989e12)}


def library_call(q: torch.Tensor, docs_t: torch.Tensor,
                 k: int) -> Tuple[Optional[Callable[[], object]], str]:
    """``(fn, what)``: one PyTorch call for K3's function at k (fp32
    scores, top-k), or ``(None, reason)``. bf16 inputs need an fp32
    product out of bf16 operands, ``torch.mm(..., out_dtype=float32)``,
    where the installed torch has it."""
    if docs_t.dtype == torch.float32:
        return (lambda: torch.topk(q @ docs_t, k, dim=1),
                "torch.topk(q @ docs_t, k)")
    try:
        torch.mm(q[:1], docs_t[:, :8], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        return None, f"none: torch.mm(out_dtype=float32) unavailable ({e})"
    return (lambda: torch.topk(torch.mm(q, docs_t, out_dtype=torch.float32),
                               k, dim=1),
            "torch.topk(torch.mm(q, docs_t, out_dtype=float32), k)")


def bound_ms(q: int, n: int, dtype: torch.dtype, k: int = K) -> Tuple[float, str]:
    """The least time for one call, ms, and what sets it."""
    elt = torch.empty((), dtype=dtype).element_size()
    t_bytes = ((n + q) * D * elt + q * k * 8) / HBM_BYTES_PER_S * 1e3
    mult, peak = PEAK[dtype]
    t_ops = mult * 2 * q * n * D / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_shape(q: torch.Tensor, docs_t: torch.Tensor,
               k: int = K) -> Dict[str, object]:
    """One shape's times (module doc); fewer calls at large N."""
    it, wu = (5, 1) if docs_t.shape[1] > 100_000 else (20, 3)
    kernel = lambda: fused_topk(q, docs_t, k)
    plain = lambda: fused_topk_reference(q, docs_t, k)
    p1, ka, kb, p2 = (time_ms(f, iters=it, warmup=wu)
                      for f in (plain, kernel, kernel, plain))
    lib, what = library_call(q, docs_t, k)
    return {"k3_ms": (ka + kb) / 2, "k3_ms_each": [ka, kb],
            "plain_ms": (p1 + p2) / 2,
            "library_ms": None if lib is None else time_ms(lib, iters=it,
                                                           warmup=wu),
            "library": what,
            "bound": bound_ms(q.shape[0], docs_t.shape[1], docs_t.dtype, k)}


def unit_columns(g: torch.Generator, d: int, n: int) -> torch.Tensor:
    x = torch.randn(d, n, generator=g, device="cuda")
    return x / x.norm(dim=0, keepdim=True)


def run(seed: int = 0, log: Callable[[str], None] = print):
    if not torch.cuda.is_available():
        raise RuntimeError("k3_shapes needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    full32 = unit_columns(g, D, N_COLS)
    qs = unit_columns(g, D, max(Q_K3)).T.contiguous()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        full = full32.to(dtype)
        for n in N_K3:
            for qp in Q_K3:
                t = time_shape(qs[:qp].to(dtype), full[:, :n])
                row = {"dtype": str(dtype).split(".")[-1], "n": n, "q": qp,
                       **t}
                log(json.dumps(row))
                rows.append(row)
        del full
    return rows


if __name__ == "__main__":
    run()
