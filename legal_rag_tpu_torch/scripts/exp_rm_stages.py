"""Stage breakdown of the row-major two-phase search around kernel K1 on
one CUDA card, at 2^20 docs (``BENCH_N``), bf16 Gaussian rows, 64
queries, k=10, seg_rows 8, the two-level select at ``SUP`` (default 64).
The counterpart of the JAX package's ``scripts/exp_rm_stages.py``;
stages are cumulative and each line shows what it adds:

  A phase1        K1's segment maxima, summed
  B +transpose    the JAX script's [n_segs, Q] -> [Q, n_segs] transpose:
                  K1 writes the map query-major, so nothing is timed
  C +select       + ``select_segments(sup=SUP)``
  D +gather+res   + the segment-row gather and the fp32 rescore
  E full          ``dense_topk_twophase_rm(sup=SUP)`` (adds the final
                  two-key sort); its top-10 is checked against the
                  flat-select path (``sup=None``)

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_rm_stages
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import torch

from legal_rag_tpu_torch.ops.dense import (
    _TIE_OVERSAMPLE, dense_topk_twophase_rm, select_segments,
)
from legal_rag_tpu_torch.ops.segmax_rm import segmax_rm
from legal_rag_tpu_torch.scripts.exp_common import (
    BN, D, K, Q, SR, Log, card_main, gaussian_data, note_row, timed_row,
    topk_agrees,
)

N = 1 << 20
SUP = 64


def run(n: int = N, sup: int = SUP, device="cuda", seed: int = 0,
        log: Log = print, iters: int = 20, warmup: int = 3) -> List[Dict]:
    """Rows A-E (module doc); each timed row carries ``delta_ms`` over
    the previous timed stage, ``E full`` also ``match``."""
    device = torch.device(device)
    qs, docs = gaussian_data(n, device, seed)
    n_segs = n // SR
    kk = min(K + _TIE_OVERSAMPLE, n_segs)

    def phase1():
        return segmax_rm(qs, docs, n)                         # [Q, n_segs]

    def stage_d():
        seg_pos = select_segments(phase1(), kk, sup)
        gathered = docs.view(n_segs, SR * D)[seg_pos].view(Q, kk * SR, D)
        return torch.bmm(gathered.float(), qs.float()[:, :, None]).sum()

    def full(s=sup):
        return dense_topk_twophase_rm(qs, docs, K, sup=s)

    match = topk_agrees(full(), full(None))
    timing = (iters, warmup)
    rows = [timed_row("A phase1", lambda: phase1().sum(), device, log,
                      *timing)]
    rows.append(note_row("B +transpose", "nothing to time: K1 writes the "
                         "map query-major, [Q, n_segs]", log))
    rows.append(timed_row(
        "C +select", lambda: select_segments(phase1(), kk, sup).sum(),
        device, log, *timing))
    rows.append(timed_row("D +gather+rescore", stage_d, device, log, *timing))
    rows.append(timed_row("E full rm path", lambda: full(), device, log,
                          *timing, match=match))
    prev = 0.0
    for row in rows:
        if row["ms"] is not None:
            row["delta_ms"] = row["ms"] - prev
            prev = row["ms"]
    if prev:
        log("added by each stage, ms: " + ", ".join(
            f"{r['name'].split()[0]} +{r['delta_ms']:.4f}" for r in rows
            if "delta_ms" in r))
    return rows


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))
    sup = int(os.environ.get("SUP", SUP))

    def body(log: Log) -> None:
        log(f"N={n} D={D} Q={Q} k={K} bn={BN} sr={SR} sup={sup} bf16")
        run(n, sup, "cuda", log=log)

    return card_main("exp_rm_stages", body)


if __name__ == "__main__":
    sys.exit(main())
