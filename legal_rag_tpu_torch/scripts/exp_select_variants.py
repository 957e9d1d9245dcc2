"""The row-major phase 2's select and final ordering, piece by piece, on
one CUDA card, at 2^20 docs (``BENCH_N``), bf16 Gaussian rows, 64
queries, k=10, seg_rows 8, super-segments of ``SUP`` (default 64)
segments. The counterpart of the JAX package's
``scripts/exp_select_variants.py``. Each C row runs K1 and the select up
to its piece:

  C1  +lvl1 max        the super-segment maxima
  C2  +sup top_k       + the top-kk super-segments
  C3  +one-hot vals    + their member values by a one-hot batched matmul
  C3b +block gather    + their member values by one gather instead
  C4  select (onehot)  the whole select, one-hot member values
  C4b select (bgather) the whole select, gathered member values

and two full paths, whose top-10 are checked against the flat select:

  E0  full current     ``dense_topk_twophase_rm(sup=SUP)``
  E1  full narrowed    C4, the gather and rescore, a top-kk by score,
                       then the two-key sort over kk instead of kk*8

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_select_variants
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import torch

from legal_rag_tpu_torch.ops.dense import (
    dense_topk_twophase_rm, gather_supers, sort_score_desc_id_asc,
)
from legal_rag_tpu_torch.ops.segmax_rm import segmax_rm
from legal_rag_tpu_torch.scripts.exp_common import (
    BN, D, K, KK, Q, SR, Log, card_main, gaussian_data, members,
    onehot_member_values, super_tops, timed_row, topk_agrees,
)

N = 1 << 20
SUP = 64


def run(n: int = N, sup: int = SUP, device="cuda", seed: int = 0,
        log: Log = print, iters: int = 20, warmup: int = 3) -> List[Dict]:
    """Rows C1-C4b and E0-E1 (module doc); the E rows carry ``match``."""
    device = torch.device(device)
    qs, docs = gaussian_data(n, device, seed)
    n_segs = n // SR
    seg_rows = torch.arange(SR, device=device)

    def tops():
        return super_tops(segmax_rm(qs, docs, n), sup)

    def select_full(member_values):
        s3, sup_idx = tops()
        pos = torch.topk(member_values(s3, sup_idx), KK, dim=1,
                         sorted=False).indices
        return members(sup_idx, sup).gather(1, pos)           # [Q, KK]

    def c3(member_values):
        return member_values(*tops()).sum()

    def narrowed():
        seg_pos = select_full(onehot_member_values)
        cand = (seg_pos[:, :, None] * SR + seg_rows).reshape(Q, KK * SR)
        gathered = docs.view(n_segs, SR * D)[seg_pos].view(Q, KK * SR, D)
        scores = torch.bmm(gathered.float(), qs.float()[:, :, None])[:, :, 0]
        v, pos = torch.topk(scores, KK, dim=1, sorted=False)
        s, ids = sort_score_desc_id_asc(v, cand.gather(1, pos))
        return s[:, :K], ids[:, :K]

    def current():
        return dense_topk_twophase_rm(qs, docs, K, sup=sup)

    flat = dense_topk_twophase_rm(qs, docs, K)
    timing = (iters, warmup)
    return [
        timed_row("C1 +lvl1 max",
                  lambda: segmax_rm(qs, docs, n).view(Q, -1, sup)
                  .amax(dim=2).sum(), device, log, *timing),
        timed_row("C2 +sup top_k", lambda: tops()[1].sum(), device, log,
                  *timing),
        timed_row("C3 +one-hot vals", lambda: c3(onehot_member_values),
                  device, log, *timing),
        timed_row("C3b +block gather", lambda: c3(gather_supers), device,
                  log, *timing),
        timed_row("C4 select (onehot)",
                  lambda: select_full(onehot_member_values).sum(), device,
                  log, *timing),
        timed_row("C4b select (bgather)",
                  lambda: select_full(gather_supers).sum(), device, log,
                  *timing),
        timed_row("E0 full current", current, device, log, *timing,
                  match=topk_agrees(current(), flat)),
        timed_row("E1 full narrowed", narrowed, device, log, *timing,
                  match=topk_agrees(narrowed(), flat)),
    ]


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))
    sup = int(os.environ.get("SUP", SUP))

    def body(log: Log) -> None:
        log(f"N={n} Q={Q} k={K} bn={BN} sr={SR} sup={sup} kk={KK} bf16")
        run(n, sup, "cuda", log=log)

    return card_main("exp_select_variants", body)


if __name__ == "__main__":
    sys.exit(main())
