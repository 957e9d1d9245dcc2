"""seg_rows / block_n sweep of the row-major two-phase search around
kernel K1 on one CUDA card: 2^20 docs (``SWEEP_N``), D=384, 64 queries,
k=10, bf16 unit rows; then the int8 tier (K1-int8, per-segment scales
at seg_rows 8) and the two-level select's super-segment width ``sup`` in
{64, 256}. The counterpart of the JAX package's
``scripts/exp_rm_sweep.py``; its numbers are what the dispatch
constants (``ops/dense.py`` TWOPHASE_*) are to be set from.

What differs from the JAX script:

- ``block_n`` is the TPU kernel's doc block. The port's
  ``dense_topk_twophase_rm`` has no block and pads only to a multiple
  of ``seg_rows``; here ``block_n`` sets the padding unit: the docs are
  zero-padded to a multiple of it once, outside the timed call, and
  ``n_valid`` masks the tail. Each row reports that padded width
  (``n_pad``).
- The JAX sweep ran each config with and without an in-kernel
  transpose of the segment map (``kernel_transpose``, the Mosaic probe
  behind ``LEGAL_RAG_RM_KERNEL_T``). K1 writes the map query-major, so
  there is one variant; ROADMAP.md lists the probe under "Do not
  port".

Rows: ``matmul+topk`` (the reference: exact fp32 products of the bf16
values, a stable top-k), one ``rm bn=.. sr=..`` row a config, ``rm int8``
and ``rm sup=..``. Each two-phase row carries ``recall`` (recall@10
against the reference's ids) and ``match`` (its top-10 equal to the
reference's under the tie rule of tests/test_dense.py); the int8 row
holds against the int8 metric's own flat top-k, and its ``recall``
against the bf16 reference is informational, as in the JAX script.
Times are CUDA events after warm-up (``exp_common``); on the CPU every
``ms`` is None.

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_rm_sweep
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Sequence, Tuple

import torch

from legal_rag_tpu_torch.ops.dense import (
    dense_topk_matmul, dense_topk_twophase_rm, quantize_queries,
)
from legal_rag_tpu_torch.scripts.bench_scale import recall
from legal_rag_tpu_torch.scripts.exp_common import (
    D, K, Q, Log, card_main, generator, timed_row, topk_agrees, unit_rows,
)

N = 1 << 20
CONFIGS = (
    (8192, 8),     # the served default (TWOPHASE_BLOCK_N, TWOPHASE_SEG_ROWS)
    (8192, 16),
    (8192, 32),
    (16384, 8),
    (16384, 16),
    (32768, 16),
    (32768, 32),
)
SUPS = (64, 256)
INT8_SEG_ROWS = 8


def quantize_per_segment(docs: torch.Tensor, seg_rows: int):
    """int8 docs and their ``[N]`` scales, constant within each segment
    (the JAX script's per-segment quantization)."""
    per_doc = docs.float().abs().amax(dim=1) / 127.0
    seg = per_doc.view(-1, seg_rows).amax(dim=1)
    seg = torch.where(seg == 0, torch.ones_like(seg), seg)
    scales = seg.repeat_interleave(seg_rows)
    docs_i8 = torch.clamp(torch.round(docs.float() / scales[:, None]),
                          -127, 127).to(torch.int8)
    return docs_i8, scales


def int8_flat_topk(queries: torch.Tensor, docs_i8: torch.Tensor,
                   scales: torch.Tensor, k: int, block: int = 1 << 16):
    """The int8 metric's exact top-k by plain torch: the quantized
    queries' int32 products with the docs (exact in fp32), scaled by the
    query's and the doc's scales as the two-phase refine scales them."""
    q_i8, q_scale = quantize_queries(queries.float())
    out = torch.empty((queries.shape[0], docs_i8.shape[0]),
                      dtype=torch.float32, device=docs_i8.device)
    for lo in range(0, docs_i8.shape[0], block):
        acc = q_i8.float() @ docs_i8[lo:lo + block].float().T
        out[:, lo:lo + block] = (acc * q_scale[:, None]
                                 * scales[None, lo:lo + block])
    vals, idx = torch.sort(out, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].int()


def run(n: int = N, configs: Sequence[Tuple[int, int]] = CONFIGS,
        sups: Sequence[int] = SUPS, device="cuda", seed: int = 0,
        log: Log = print, iters: int = 20, warmup: int = 3) -> List[Dict]:
    """The rows of the module doc; bytes for GB/s are the bf16 doc
    matrix's (the int8 row: its codes')."""
    device = torch.device(device)
    g = generator(device, seed)
    docs = unit_rows(g, n, D, device).to(torch.bfloat16)
    qs = unit_rows(g, Q, D, device).to(torch.bfloat16)
    gb = n * D * 2
    timing = (iters, warmup)

    ref = dense_topk_matmul(qs, docs, K)
    rows = [timed_row("matmul+topk", lambda: dense_topk_matmul(qs, docs, K),
                      device, log, *timing, n_bytes=gb)]

    def two_phase_row(name, fn, want, n_bytes, **extra):
        got = fn()
        return timed_row(name, fn, device, log, *timing, n_bytes=n_bytes,
                         recall=recall(got[1], ref[1]),
                         match=topk_agrees(got, want), **extra)

    padded = {}
    for bn, sr in configs:
        n_pad = -(-n // bn) * bn
        if n_pad not in padded:
            padded[n_pad] = (docs if n_pad == n else torch.cat(
                [docs, docs.new_zeros((n_pad - n, D))]))
        d_pad = padded[n_pad]
        rows.append(two_phase_row(
            f"rm bn={bn} sr={sr}",
            lambda d=d_pad, sr=sr: dense_topk_twophase_rm(
                qs, d, K, n_valid=n, seg_rows=sr),
            ref, gb, block_n=bn, seg_rows=sr, n_pad=n_pad))
    del padded

    # int8 capacity tier: 1 byte a doc-dim, int32 segment maxima (K1-int8)
    docs_i8, scales = quantize_per_segment(docs, INT8_SEG_ROWS)
    qf = qs.float()
    rows.append(two_phase_row(
        f"rm int8 sr={INT8_SEG_ROWS}",
        lambda: dense_topk_twophase_rm(qf, docs_i8, K, doc_scales=scales,
                                       seg_rows=INT8_SEG_ROWS),
        int8_flat_topk(qf, docs_i8, scales, K), n * D,
        seg_rows=INT8_SEG_ROWS, n_pad=n))
    del docs_i8, scales

    # the two-level segment select's super-segment width
    for sup in sups:
        rows.append(two_phase_row(
            f"rm sr=8 sup={sup}",
            lambda sup=sup: dense_topk_twophase_rm(qs, docs, K, sup=sup),
            ref, gb, seg_rows=8, sup=sup, n_pad=n))
    return rows


def main() -> int:
    n = int(os.environ.get("SWEEP_N", N))

    def body(log: Log) -> None:
        log(f"N={n} D={D} Q={Q} k={K} bf16 (int8 row: per-segment scales)")
        run(n, device="cuda", log=log)

    return card_main("exp_rm_sweep", body)


if __name__ == "__main__":
    sys.exit(main())
