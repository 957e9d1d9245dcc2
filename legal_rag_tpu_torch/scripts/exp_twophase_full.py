"""The whole column-major two-phase search around kernel K4 on one CUDA
card, at 1,000,000 docs (``BENCH_N``), D=384, 64 queries, k=10, seg_rows
8, bf16: does a call copy the doc matrix, and what does the tie
oversample cost? The counterpart of the JAX package's
``scripts/exp_twophase_full.py``, which asked whether XLA hoists the pad
copy of ``docs_t`` out of its timing loop. The port's question is
whether the torch path copies the doc matrix a call: each row reports
the device memory the call allocated above what was already allocated
(``peak_extra_mb``) beside the doc matrix's size.

Cases (``dense_topk_twophase``; the JAX script's ``block_n`` and
``block_q`` only set the TPU's padding and have no counterpart):

  unpadded       docs_t [D, 1M]: K4 masks the ragged tail itself
  prepadded      docs_t zero-padded once, outside the call, to a
                 multiple of 8192 columns (1,007,616), n_valid=1M
  prepad+kk32    the same with ``ops.dense._TIE_OVERSAMPLE`` set from 64
                 to 22 for the call (kk = k + 22 = 32 segments), then
                 restored, as the JAX script monkeypatches it
  prepad+noemit  phase 1 alone: K4's segment maxima, summed

Each top-k row carries ``recall`` (recall@10 against an exact matmul
top-k over the same bf16 docs, fp32 products) and ``match`` (equal to
it under the tie rule of tests/test_dense.py); the kk32 row still
matches while fewer than 22 segments tie at the boundary. Times are
CUDA events after warm-up (``exp_common``); on the CPU every ``ms`` and
``peak_extra_mb`` is None.

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_twophase_full
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List, Optional

import torch

import legal_rag_tpu_torch.ops.dense as dense
from legal_rag_tpu_torch.ops.segmax_cm import segmax_cm
from legal_rag_tpu_torch.scripts.bench_scale import recall
from legal_rag_tpu_torch.scripts.exp_common import (
    BN, D, K, Q, SR, Log, card_main, generator, timed_row, topk_agrees,
    unit_rows,
)

N = 1_000_000
KK32_OVERSAMPLE = 22


def peak_extra_mb(fn: Callable[[], object], device) -> Optional[float]:
    """Device memory a call of ``fn`` allocates above what was allocated
    before it, MB (None off a card)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - before) / 2 ** 20


def run(n: int = N, device="cuda", seed: int = 0, log: Log = print,
        iters: int = 20, warmup: int = 3) -> List[Dict]:
    """The rows of the module doc."""
    device = torch.device(device)
    g = generator(device, seed)
    docs = unit_rows(g, n, D, device)
    qs = (torch.randn(Q, D, generator=g, device=device) / D ** 0.5).to(
        torch.bfloat16)
    dt16 = docs.T.contiguous().to(torch.bfloat16)
    del docs
    n_pad = -(-n // BN) * BN
    dt16_pad = torch.cat([dt16, dt16.new_zeros((D, n_pad - n))], dim=1)
    gb = n * D * 2
    timing = (iters, warmup)
    ref = dense.dense_topk_matmul(qs, dt16.T, K)
    log(f"doc matrix {gb / 2 ** 20:.1f} MB bf16; padded width {n_pad}")

    def top_row(name, fn):
        got = fn()
        return timed_row(name, fn, device, log, *timing, n_bytes=gb,
                         recall=recall(got[1], ref[1]),
                         match=topk_agrees(got, ref),
                         peak_extra_mb=peak_extra_mb(fn, device))

    unpadded = lambda: dense.dense_topk_twophase(qs, dt16, K, seg_rows=SR)
    prepadded = lambda: dense.dense_topk_twophase(qs, dt16_pad, K, n_valid=n,
                                                  seg_rows=SR)
    noemit = lambda: segmax_cm(qs, dt16_pad, n, SR).sum()
    rows = [top_row("unpadded", unpadded), top_row("prepadded", prepadded)]
    old = dense._TIE_OVERSAMPLE
    dense._TIE_OVERSAMPLE = KK32_OVERSAMPLE
    try:
        rows.append(top_row("prepad+kk32", prepadded))
    finally:
        dense._TIE_OVERSAMPLE = old
    rows.append(timed_row("prepad+noemit", noemit, device, log, *timing,
                          n_bytes=gb,
                          peak_extra_mb=peak_extra_mb(noemit, device)))
    for row in rows:
        if row["peak_extra_mb"] is not None:
            row["copies_docs"] = row["peak_extra_mb"] * 2 ** 20 >= gb
            log(f"{row['name']}: {row['peak_extra_mb']:.1f} MB allocated "
                f"a call; copies the doc matrix: {row['copies_docs']}")
    return rows


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))

    def body(log: Log) -> None:
        log(f"N={n} D={D} Q={Q} k={K} bn={BN} sr={SR} bf16")
        run(n, device="cuda", log=log)

    return card_main("exp_twophase_full", body)


if __name__ == "__main__":
    sys.exit(main())
