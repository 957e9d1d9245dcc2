"""The row-major select's member stage, taken apart, on one CUDA card, at
2^20 docs (``BENCH_N``), bf16 Gaussian rows, 64 queries, k=10, seg_rows
8. The counterpart of the JAX package's ``scripts/exp_member_topk.py``.
Each M row runs K1, the super-segment top-kk at 64 and the one-hot
member values, then:

  M1  +member topk only   the top-kk over the member values
  M2  +extract only       the member ids at fixed positions (no top-k)
  M3  +both               both: the whole select

and the full path ``dense_topk_twophase_rm`` at super-segments of 64,
32 and 16 (FULL rows), each top-10 checked against the flat select,
then the flat select itself (``sup=None``, the served path).

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_member_topk
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import torch

from legal_rag_tpu_torch.ops.dense import dense_topk_twophase_rm
from legal_rag_tpu_torch.ops.segmax_rm import segmax_rm
from legal_rag_tpu_torch.scripts.exp_common import (
    BN, K, KK, Q, SR, Log, card_main, gaussian_data, members,
    onehot_member_values, super_tops, timed_row, topk_agrees,
)

N = 1 << 20
M_SUP = 64
FULL_SUPS = (64, 32, 16)


def run(n: int = N, device="cuda", seed: int = 0, log: Log = print,
        iters: int = 20, warmup: int = 3) -> List[Dict]:
    """Rows M1-M3, FULL at each of ``FULL_SUPS`` (carrying ``match``) and
    FULL flat (module doc)."""
    device = torch.device(device)
    qs, docs = gaussian_data(n, device, seed)
    fixed = torch.arange(KK, device=device).expand(Q, KK)

    def upto_vals():
        s3, sup_idx = super_tops(segmax_rm(qs, docs, n), M_SUP)
        return onehot_member_values(s3, sup_idx), sup_idx

    def m1():
        v, pos = torch.topk(upto_vals()[0], KK, dim=1, sorted=False)
        return v.sum() + pos.sum()

    def m2():
        vals, sup_idx = upto_vals()
        return vals.sum() + members(sup_idx, M_SUP).gather(1, fixed).sum()

    def m3():
        vals, sup_idx = upto_vals()
        pos = torch.topk(vals, KK, dim=1, sorted=False).indices
        return members(sup_idx, M_SUP).gather(1, pos).sum()

    flat = dense_topk_twophase_rm(qs, docs, K)
    timing = (iters, warmup)
    rows = [
        timed_row("M1 +member topk only", m1, device, log, *timing),
        timed_row("M2 +extract only", m2, device, log, *timing),
        timed_row("M3 +both (=C4)", m3, device, log, *timing),
    ]
    for sup in FULL_SUPS:
        full = lambda: dense_topk_twophase_rm(qs, docs, K, sup=sup)
        rows.append(timed_row(f"FULL sup={sup}", full, device, log, *timing,
                              match=topk_agrees(full(), flat)))
    rows.append(timed_row("FULL flat (sup=None)",
                          lambda: dense_topk_twophase_rm(qs, docs, K), device,
                          log, *timing))
    return rows


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))

    def body(log: Log) -> None:
        log(f"N={n} Q={Q} k={K} bn={BN} sr={SR} kk={KK} bf16")
        run(n, "cuda", log=log)

    return card_main("exp_member_topk", body)


if __name__ == "__main__":
    sys.exit(main())
