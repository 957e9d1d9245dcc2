"""K1 (fp32, bf16, int8) and K2 (m=48) at the served shapes, beside their
plain versions.

K1: ``segmax_rm`` over 1,007,616 unit rows (the 1M store's padded rows),
D=384, seg_rows 8; K2: ``pq_segmax`` over 1,000,000 random 48-byte codes
with bf16 tables. The engine pads every batch to a power of two of at
least 8, so the served batches are 8 (one request), 16, 32, 64 (the
coalescer's flush) and 128 (a flush of 64 plus a victim's 4 queries);
Q=1, 4 and 67 are shapes of direct ``ops`` callers. For each Q:
CUDA-event ms of the kernel and of its plain version, in turns plain,
kernel, kernel, plain. Where the installed K1 has two kernels (its
module-private ``_launch_cuda_cores`` and ``_launch_tensor_cores``),
both are timed on fp32 and int8 up to Q=32, in turns (the CUDA-core
kernel, the tensor-core kernel, the tensor-core kernel, the CUDA-core
kernel), to place the dispatch's switch. The bound is
the larger of the bytes (each input read once, the map written once)
over 3.35 TB/s and the operations over the peak rate of their type: K1's
products at 989 TFLOP/s (bf16), 1,979 TOP/s (int8) and, for fp32, three
TF32 products each (3xTF32) at 495 TFLOP/s; K2's 2m fp32 additions per
doc and query at 67 TFLOP/s.

``--only crossover`` places the dense dispatch's crossover in fp32:
``bench_scale.run`` (matmul + top-k against K1's two-phase search) over
fp32 docs at 2^18, 393,216 (the TPU's ``TWOPHASE_MIN_DOCS``) and 2^20
rows, at Q=8 and Q=64; it is not part of the default run.

``--tree DIR`` imports the package from another checkout (an archived
parent), so that two versions are timed by one script in one call; run
the file then, not the module (``-m`` would import this checkout's
package first).

Run on the card:  python -m legal_rag_tpu_torch.scripts.k1_k2_shapes
[--only k1|k2|crossover], or python legal_rag_tpu_torch/scripts/k1_k2_shapes.py
--tree DIR (one JSON line a shape).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Tuple

N_ROWS, DIM = 1_007_616, 384
N_CODES, PQ_M = 1_000_000, 48
QS = (1, 4, 8, 16, 32, 64, 67, 128)
BOTH_K1 = 32        # K1's two kernels are both timed up to this batch
HBM_BYTES_PER_S = 3.35e12
# dense peaks of one H100 SXM (NVIDIA's data sheet): (products counted
# per product, rate)
PEAK = {"fp32": (3, 495e12), "bf16": (1, 989e12), "int8": (1, 1979e12)}
FP32_PEAK = 67e12
CROSSOVER_SIZES = (1 << 18, 393_216, 1 << 20)
CROSSOVER_QS = (8, 64)


def bound(n_bytes: float, n_ops: float, rate: float) -> Tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(tag: str, q: int, elt: int) -> Tuple[float, str]:
    mult, rate = PEAK[tag]
    return bound((N_ROWS + q) * DIM * elt + q * (N_ROWS // 8) * 4,
                 mult * 2 * q * N_ROWS * DIM, rate)


def k2_bound(q: int) -> Tuple[float, str]:
    return bound(N_CODES * PQ_M + q * 2 * PQ_M * 16 * 2
                 + q * (-(-N_CODES // 8)) * 4,
                 q * N_CODES * 2 * PQ_M, FP32_PEAK)


def in_turns(time_ms, a: Callable, b: Callable, iters: int = 20,
             warmup: int = 3) -> Tuple[float, float]:
    """``(a, b)`` mean ms, timed a, b, b, a."""
    a1, b1, b2, a2 = (time_ms(f, iters=iters, warmup=warmup)
                      for f in (a, b, b, a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def run_k1(torch, log, seed: int = 0):
    from legal_rag_tpu_torch.ops.dense import quantize_queries
    from legal_rag_tpu_torch.ops import segmax_rm as k1
    from legal_rag_tpu_torch.ops.segmax_rm import (
        segmax_rm, segmax_rm_reference,
    )
    from legal_rag_tpu_torch.utils.timing import time_ms

    two = hasattr(k1, "_launch_tensor_cores")
    g = torch.Generator(device="cuda").manual_seed(seed)
    docs32 = torch.randn(N_ROWS, DIM, generator=g, device="cuda")
    docs32 /= docs32.norm(dim=1, keepdim=True)
    q32 = torch.randn(max(QS), DIM, generator=g, device="cuda")
    q32 /= q32.norm(dim=1, keepdim=True)
    rows = []
    for tag in ("fp32", "bf16", "int8"):
        if tag == "int8":
            scale = docs32.abs().amax(dim=1, keepdim=True) / 127
            docs = torch.round(docs32 / scale).clamp(-127, 127).to(torch.int8)
            qs = quantize_queries(q32)[0]
        else:
            dt = torch.float32 if tag == "fp32" else torch.bfloat16
            docs, qs = docs32.to(dt), q32.to(dt)
        for qp in QS:
            q = qs[:qp].contiguous()
            kernel = lambda: segmax_rm(q, docs, N_ROWS)
            plain = lambda: segmax_rm_reference(q, docs, N_ROWS)
            plain_ms, k_ms = in_turns(time_ms, plain, kernel, iters=10,
                                      warmup=2)
            row: Dict[str, object] = {
                "kernel": "K1", "dtype": tag, "q": qp, "ms": k_ms,
                "plain_ms": plain_ms,
                "bound": k1_bound(tag, qp, docs.element_size()),
            }
            if two and qp <= BOTH_K1 and tag != "bf16":
                cc = lambda: k1._launch_cuda_cores(q, docs, N_ROWS)
                tc = lambda: k1._launch_tensor_cores(q, docs, N_ROWS, 8)
                row["cuda_core_ms"], row["tensor_core_ms"] = in_turns(
                    time_ms, cc, tc)
            log(json.dumps(row))
            rows.append(row)
        del docs
    return rows


def run_k2(torch, log, seed: int = 0):
    from legal_rag_tpu_torch.ops.pq_segmax import (
        pq_segmax, pq_segmax_reference,
    )
    from legal_rag_tpu_torch.utils.timing import time_ms

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    codes = torch.randint(0, 256, (N_CODES, PQ_M), generator=g, device="cuda",
                          dtype=torch.uint8)
    luts = (torch.randn(max(QS), 2 * PQ_M, 16, generator=g, device="cuda")
            * 0.05).to(torch.bfloat16)
    rows = []
    for qp in QS:
        lut = luts[:qp].contiguous()
        plain_ms, k_ms = in_turns(time_ms, lambda: pq_segmax_reference(lut, codes),
                                  lambda: pq_segmax(lut, codes), iters=10,
                                  warmup=2)
        row = {"kernel": "K2", "m": PQ_M, "q": qp, "ms": k_ms,
               "plain_ms": plain_ms, "bound": k2_bound(qp)}
        log(json.dumps(row))
        rows.append(row)
    return rows


def run_crossover(torch, log):
    from legal_rag_tpu_torch.scripts import bench_scale

    rows = []
    for qp in CROSSOVER_QS:
        for row in bench_scale.run(CROSSOVER_SIZES, "cuda", False,
                                   log=lambda line: None,
                                   dtype=torch.float32, n_q=qp):
            row = {"crossover": "fp32", "q": qp, **row}
            log(json.dumps(row))
            rows.append(row)
    return rows


def run(only: str = "", log: Callable[[str], None] = print):
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("k1_k2_shapes needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    if only in ("", "k1"):
        rows += run_k1(torch, log)
    if only in ("", "k2"):
        rows += run_k2(torch, log)
    if only == "crossover":
        rows += run_crossover(torch, log)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="import legal_rag_tpu_torch from this checkout")
    ap.add_argument("--only", default="", choices=("", "k1", "k2", "crossover"))
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    run(args.only)


if __name__ == "__main__":
    main()
