"""K4 (the column-major segment max) at 1,048,576 docs, beside its plain
version, cuBLAS and its bound.

``segmax_cm`` over 1,048,576 unit columns (``docs_t [384, N]``, the
column-major two-phase search's shape in ``bench_scale`` and the smoke),
seg_rows 8 and 32, fp32 and bf16, Q in 1, 4, 8, 16, 32, 64 and 128. For
each shape: CUDA-event ms of the kernel and of its plain version, in
turns plain, kernel, kernel, plain; cuBLAS ``q @ docs_t`` alone as a
yardstick (for bf16 both its bf16 product and ``torch.mm(...,
out_dtype=float32)``; no segment max, so not the same function); and the
bound, the larger of the bytes (docs and queries read once, the map
written once) over 3.35 TB/s and the products over the peak rate of
their type: 989 TFLOP/s for bf16, and for fp32 three TF32 products each
(3xTF32) at 495 TFLOP/s.

``--tree DIR`` imports the package from another checkout (an archived
parent), so that two versions are timed by one script in one call;
without it, the checkout that holds this file.

Run on the card:  python legal_rag_tpu_torch/scripts/k4_shapes.py
[--tree DIR] (one JSON line a shape).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

N_DOCS, DIM = 1 << 20, 384
QS = (1, 4, 8, 16, 32, 64, 128)
SEG_ROWS = (8, 32)
HBM_BYTES_PER_S = 3.35e12
# dense peaks of one H100 SXM (NVIDIA's data sheet): (products counted
# per product, rate)
PEAK = {"fp32": (3, 495e12), "bf16": (1, 989e12)}


def bound(tag: str, q: int, seg_rows: int, elt: int) -> Tuple[float, str]:
    """K4's least time on the card, ms, and what sets it."""
    mult, rate = PEAK[tag]
    n_segs = -(-N_DOCS // (seg_rows * 128)) * 128
    t_bytes = ((N_DOCS + q) * DIM * elt + q * n_segs * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = mult * 2 * q * N_DOCS * DIM / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(time_ms, a: Callable, b: Callable, iters: int = 10,
             warmup: int = 2) -> Tuple[float, float]:
    """``(a, b)`` mean ms, timed a, b, b, a."""
    a1, b1, b2, a2 = (time_ms(f, iters=iters, warmup=warmup)
                      for f in (a, b, b, a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def run(log: Callable[[str], None] = print, seed: int = 0):
    import torch

    from legal_rag_tpu_torch.ops import segmax_cm as k4
    from legal_rag_tpu_torch.utils.timing import time_ms

    if not torch.cuda.is_available():
        raise RuntimeError("k4_shapes needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    docs32 = torch.randn(DIM, N_DOCS, generator=g, device="cuda")
    docs32 /= docs32.norm(dim=0, keepdim=True)
    q32 = torch.randn(max(QS), DIM, generator=g, device="cuda")
    q32 /= q32.norm(dim=1, keepdim=True)
    rows = []
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        docs_t, qs = docs32.to(dtype), q32.to(dtype)
        for qp in QS:
            q = qs[:qp].contiguous()
            cublas = {"cublas_ms": time_ms(lambda: q @ docs_t, iters=10,
                                           warmup=2)}
            if dtype == torch.bfloat16:
                cublas["cublas_f32_out_ms"] = time_ms(
                    lambda: torch.mm(q, docs_t, out_dtype=torch.float32),
                    iters=10, warmup=2)
            for sr in SEG_ROWS:
                kernel = lambda: k4.segmax_cm(q, docs_t, N_DOCS, sr)
                plain = lambda: k4.segmax_cm_reference(q, docs_t, N_DOCS, sr)
                plain_ms, k_ms = in_turns(time_ms, plain, kernel)
                row: Dict[str, object] = {
                    "kernel": "K4", "dtype": tag, "q": qp, "seg_rows": sr,
                    "ms": k_ms, "plain_ms": plain_ms, **cublas,
                    "bound": bound(tag, qp, sr, docs_t.element_size()),
                }
                log(json.dumps(row))
                rows.append(row)
        del docs_t
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="import legal_rag_tpu_torch from this checkout")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    run()


if __name__ == "__main__":
    main()
