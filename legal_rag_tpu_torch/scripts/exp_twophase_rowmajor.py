"""Row-major two-phase prototype on one CUDA card: docs stored
``[N, D]``, phase 1 by kernel K1 (the JAX script's own row-major segment
max, ``segmax_rm_kernel``, computes what K1 computes; K1 writes the map
query-major, so the JAX script's transpose has no counterpart), the
candidates gathered as contiguous doc rows. The counterpart of the JAX
package's ``scripts/exp_twophase_rowmajor.py``, at 1M docs
(``BENCH_N``) padded to 8192 rows, bf16, 64 queries, seg_rows 8:

  A phase1-rm   K1's ``[Q, n_segs]`` segment maxima, summed
  B +sel        + the two-level select at super-segments of 128
  C +gather     + the row gather ``[Q, C, D]`` and the exact fp32 rescore
  D full        + the (score desc, id asc) ordering; its top-10 is
                checked against ``dense_topk_twophase_rm`` (flat select)

then recall@10 of D against an fp32 golden over all 64 queries.

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_twophase_rowmajor
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List

import torch
import torch.nn.functional as F

from legal_rag_tpu_torch.ops.dense import (
    dense_topk_twophase_rm, select_segments, sort_score_desc_id_asc,
)
from legal_rag_tpu_torch.ops.segmax_rm import segmax_rm
from legal_rag_tpu_torch.scripts.bench_scale import recall
from legal_rag_tpu_torch.scripts.exp_common import (
    BN, D, K, KK, Q, SR, Log, card_main, generator, timed_row, topk_agrees,
    unit_rows,
)

N = 1_000_000
SUP = 128


def run(n: int = N, device="cuda", seed: int = 0, log: Log = print,
        iters: int = 20, warmup: int = 3) -> List[Dict]:
    """Rows A-D (module doc; ``D full`` carries ``match``) and a last row
    with ``recall``."""
    device = torch.device(device)
    g = generator(device, seed)
    n_pad = -(-n // BN) * BN
    d_rm = F.pad(unit_rows(g, n, D, device), (0, 0, 0, n_pad - n))
    d_rm = d_rm.to(torch.bfloat16)                            # [n_pad, D]
    q16 = (torch.randn(Q, D, generator=g, device=device)
           / math.sqrt(D)).to(torch.bfloat16)
    gb = n * D * 2
    member = torch.arange(SR, device=device)

    def phase1():
        return segmax_rm(q16, d_rm, n)                        # [Q, n_pad/8]

    def select(seg_m):
        return select_segments(seg_m, KK, sup=SUP)

    def gather_rescore(seg_pos):
        cand = (seg_pos[:, :, None] * SR + member).reshape(Q, KK * SR)
        gathered = d_rm[cand.clamp(max=n_pad - 1)]            # [Q, C, D]
        scores = torch.bmm(gathered.float(), q16.float()[:, :, None])[:, :, 0]
        return torch.where(cand < n, scores, float("-inf")), cand

    def full():
        s, ids = sort_score_desc_id_asc(*gather_rescore(select(phase1())))
        return s[:, :K], ids[:, :K]

    def stage_c():
        s, cand = gather_rescore(select(phase1()))
        return s.sum() + cand.sum()

    top = full()
    match = topk_agrees(top, dense_topk_twophase_rm(q16, d_rm, K, n_valid=n))
    timing = (iters, warmup)
    rows = [
        timed_row("A phase1-rm", lambda: phase1().sum(), device, log,
                  *timing, n_bytes=gb),
        timed_row("B +sel", lambda: select(phase1()).sum(), device, log,
                  *timing, n_bytes=gb),
        timed_row("C +gather", stage_c, device, log, *timing, n_bytes=gb),
        timed_row("D full", full, device, log, *timing, n_bytes=gb,
                  match=match),
    ]
    scores = q16.float() @ d_rm[:n].float().T
    gold = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :K]
    del scores
    r = recall(top[1], gold)
    log(f"recall@{K} vs f32 golden: {r:.4f}")
    rows.append({"name": f"recall@{K} vs f32 golden", "ms": None,
                 "gbps": None, "recall": r})
    return rows


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))

    def body(log: Log) -> None:
        log(f"N={n} D={D} Q={Q} k={K} bn={BN} sr={SR} bf16")
        run(n, "cuda", log=log)

    return card_main("exp_twophase_rowmajor", body)


if __name__ == "__main__":
    sys.exit(main())
