"""Stage-by-stage timing of the column-major two-phase search around
kernel K4 on one CUDA card, at 1M docs (``BENCH_N``) padded to 8192
columns, bf16, 64 queries, seg_rows 8. The counterpart of the JAX
package's ``scripts/exp_twophase_stages.py``. Stages (cumulative):

  A phase1        K4's segment maxima, summed
  B +select       + the two-level select at super-segments of 128
  C +gather       + member ids (``segment_members``), the doc-column
                  gather and the exact fp32 rescore
  D full          + the (score desc, id asc) ordering; its top-10 is
                  checked against ``dense_topk_twophase`` (flat select)
  E flat-select   A + one flat top-kk over the map instead of B

GB/s is the bf16 doc matrix's size over the stage's time.

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_twophase_stages
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List

import torch
import torch.nn.functional as F

from legal_rag_tpu_torch.ops.dense import (
    dense_topk_twophase, select_segments, sort_score_desc_id_asc,
)
from legal_rag_tpu_torch.ops.segmax_cm import segmax_cm, segment_members
from legal_rag_tpu_torch.scripts.exp_common import (
    BN, D, K, KK, Q, SR, Log, card_main, generator, timed_row, topk_agrees,
    unit_rows,
)

N = 1_000_000
SUP = 128


def run(n: int = N, device="cuda", seed: int = 0, log: Log = print,
        iters: int = 20, warmup: int = 3) -> List[Dict]:
    """Rows A-E (module doc); ``D full`` carries ``match``."""
    device = torch.device(device)
    g = generator(device, seed)
    n_pad = -(-n // BN) * BN
    dpad = F.pad(unit_rows(g, n, D, device).T, (0, n_pad - n))
    dpad = dpad.to(torch.bfloat16).contiguous()              # [D, n_pad]
    q16 = (torch.randn(Q, D, generator=g, device=device)
           / math.sqrt(D)).to(torch.bfloat16)
    gb = n * D * 2

    def phase1():
        return segmax_cm(q16, dpad, n, SR)                   # [Q, n_pad/8]

    def select(seg_m):
        return select_segments(seg_m, KK, sup=SUP)

    def gather_rescore(seg_pos):
        cand = segment_members(seg_pos, SR).reshape(Q, KK * SR)
        gathered = dpad[:, cand.clamp(max=n_pad - 1)]        # [D, Q, C]
        scores = torch.einsum("qd,dqc->qc", q16.float(), gathered.float())
        return torch.where(cand < n, scores, float("-inf")), cand

    def full():
        s, ids = sort_score_desc_id_asc(*gather_rescore(select(phase1())))
        return s[:, :K], ids[:, :K]

    def stage_c():
        s, cand = gather_rescore(select(phase1()))
        return s.sum() + cand.sum()

    match = topk_agrees(full(), dense_topk_twophase(q16, dpad, K, n_valid=n,
                                                    seg_rows=SR))
    timing = (iters, warmup)
    return [
        timed_row("A phase1", lambda: phase1().sum(), device, log, *timing,
                  n_bytes=gb),
        timed_row("B +select", lambda: select(phase1()).sum(), device, log,
                  *timing, n_bytes=gb),
        timed_row("C +gather", stage_c, device, log, *timing, n_bytes=gb),
        timed_row("D full", full, device, log, *timing, n_bytes=gb,
                  match=match),
        timed_row("E flat-select",
                  lambda: torch.topk(phase1(), KK, dim=1, sorted=False)
                  .indices.sum(), device, log, *timing, n_bytes=gb),
    ]


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))

    def body(log: Log) -> None:
        log(f"N={n} D={D} Q={Q} k={K} bn={BN} sr={SR} bf16")
        run(n, "cuda", log=log)

    return card_main("exp_twophase_stages", body)


if __name__ == "__main__":
    sys.exit(main())
