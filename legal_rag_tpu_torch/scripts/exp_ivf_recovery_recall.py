"""PQ/IVF recovery, recall only, in numpy on the host: the counterpart of
the JAX package's ``scripts/exp_ivf_recovery_recall.py``. The PQ metric
is mirrored in numpy (the same 4-bit ADC table sums) and the IVF probe
step for step from ``ops.pq._pq_ivf_topk_impl`` (each query's own top
``probes // Q`` cells first, the rest of the shared probe set by the
batch's best score, empty cells never), so its candidate sets are the
dispatch's up to the order of float sums at a tie. The corpus, the
codebook and the cells are ``exp_ivf_recovery``'s (trained by the port
on ``device``; ``train_fn`` substitutes the codebook's training).

Each row holds the mirror's post-rescore recall@10 (``recall``) and,
beside it, ``overlap``: the mean share of the mirror's candidates that
the port's own dispatch (``pq_topk`` or the IVF search on ``device``,
kernel K2 on a card) also returns. Only the codebook's training and the
dispatch run on ``device``; the mirror is numpy.

Run:  python -m legal_rag_tpu_torch.scripts.exp_ivf_recovery_recall
      [--device cpu]
Env:  RECOVERY_N (default 2^20), RECOVERY_Q (default 64). The report is
printed as JSON; ``--report PATH`` also writes it (the repository's own
EVAL_IVF_RECOVERY.json is the JAX package's result and is not written).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.ops.pq import (
    IVFIndex, build_ivf, encode_pq, pq_topk, unpack_codes,
)
from legal_rag_tpu_torch.scripts.exp_common import Log
from legal_rag_tpu_torch.scripts.exp_ivf_recovery import (
    CELL_SIZE, DISPATCHES, K, M, N, OVERSAMPLES, Q, TrainFn,
    clustered_corpus, gold_topk, ivf_search, post_rescore_recall, train_opq,
)


def pq_scores(qrot: np.ndarray, nibbles: np.ndarray,
              codebooks: np.ndarray) -> np.ndarray:
    """Exact ADC: ``score[q, n] = sum_j lut[q, j, nibbles[n, j]]``."""
    n_sub, _, dsub = codebooks.shape
    scores = np.zeros((qrot.shape[0], nibbles.shape[0]), np.float32)
    for j in range(n_sub):
        lut = qrot[:, j * dsub:(j + 1) * dsub] @ codebooks[j].T  # [Q, 16]
        scores += lut[:, nibbles[:, j]]
    return scores


def ivf_candidates(qrot: np.ndarray, ivf: IVFIndex, nibbles_cellorder,
                   codebooks: np.ndarray, kk: int, probes: int) -> np.ndarray:
    """Numpy mirror of ``ops.pq._pq_ivf_topk_impl``'s candidate ids
    ``[Q, kk]``."""
    n_cells, cell_size = ivf.centroids.shape[0], ivf.cell_size
    cell_scores = qrot @ np.asarray(ivf.centroids).T       # [Q, n_cells]
    doc_ids = np.asarray(ivf.doc_ids)
    cell_valid = doc_ids.reshape(n_cells, cell_size)[:, 0] >= 0
    cell_scores[:, ~cell_valid] = -np.inf
    t = max(1, min(probes // qrot.shape[0], n_cells))
    per_q = np.argsort(-cell_scores, axis=1, kind="stable")[:, :t]
    picked = np.zeros(n_cells, np.float32)
    picked[per_q.reshape(-1)] = 1.0
    agg = cell_scores.max(axis=0)
    order = np.lexsort((np.arange(n_cells), -agg, -picked))
    sel = np.sort(order[:probes])
    rows = (sel[:, None] * cell_size
            + np.arange(cell_size, dtype=np.int64)[None, :]).reshape(-1)
    sub_scores = pq_scores(qrot, nibbles_cellorder[rows], codebooks)
    sub_ids = doc_ids[rows]
    sub_scores[:, sub_ids < 0] = -np.inf
    kk = min(kk, len(rows))
    top = np.argsort(-sub_scores, axis=1, kind="stable")[:, :kk]
    return sub_ids[top]


def overlap(mirror: np.ndarray, dispatch: np.ndarray) -> float:
    """Mean share of each row's valid mirror ids the dispatch returns."""
    shares = []
    for a, b in zip(mirror, dispatch):
        want = set(a[a >= 0].tolist())
        shares.append(len(want & set(b.tolist())) / max(1, len(want)))
    return float(np.mean(shares))


def run(n: int = N, q: int = Q, oversamples: Sequence[int] = OVERSAMPLES,
        dispatches: Sequence[str] = DISPATCHES, device="cuda", seed: int = 0,
        log: Log = print, train_fn: Optional[TrainFn] = None) -> List[Dict]:
    """One row a (dispatch, oversample): ``recall`` (the mirror's
    post-rescore recall@10) and ``overlap`` (module doc)."""
    device = torch.device(device)
    t_start = time.time()
    docs, qs = clustered_corpus(n, q, seed)
    cb = (train_fn or train_opq)(docs, device)
    codes = encode_pq(docs, cb, device=device)
    ivf = build_ivf(docs, cb, codes, cell_size=CELL_SIZE, device=device)
    log(f"PQ+IVF trained ({ivf.n_cells} cells x {ivf.cell_size}) "
        f"[{time.time() - t_start:.0f}s]")
    cbs = np.asarray(cb.codebooks, np.float32)
    qrot = np.asarray(cb.rotate(qs), np.float32)
    nib = unpack_codes(np.asarray(codes))
    nib_cell = unpack_codes(np.asarray(ivf.codes))
    gold = gold_topk(docs, qs, K, device)
    flat_scores = pq_scores(qrot, nib, cbs)
    log(f"flat ADC scored [{time.time() - t_start:.0f}s]")
    qrot_d = torch.from_numpy(qrot).to(device)
    codes_d = torch.from_numpy(codes).to(device)
    cbs_d = torch.tensor(cbs, device=device)
    ivf_topk = ivf_search(ivf, cbs, device)

    rows = []
    for name in dispatches:
        for x in oversamples:
            kk = K * x
            if name == "flat":
                cand = np.argsort(-flat_scores, axis=1, kind="stable")[:, :kk]
                got = pq_topk(qrot_d, codes_d, cbs_d, kk)[1]
            else:
                probes = int(name[3:])
                cand = ivf_candidates(qrot, ivf, nib_cell, cbs, kk, probes)
                got = ivf_topk(qrot_d, kk, probes)[1]
            rows.append({
                "dispatch": name, "oversample": x, "candidates": kk,
                "recall": post_rescore_recall(cand, qs, docs, gold),
                "overlap": overlap(cand, got.cpu().numpy()),
            })
            log(f"{name:<7} oversample={x:<3} (cand {kk:4}): post-rescore "
                f"recall@{K} = {rows[-1]['recall']:.4f}, dispatch overlap "
                f"{rows[-1]['overlap']:.4f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    n = int(os.environ.get("RECOVERY_N", N))
    q = int(os.environ.get("RECOVERY_Q", Q))
    log = lambda s: print(s, file=sys.stderr, flush=True)
    rows = run(n, q, device=args.device, log=log)
    report = {
        "n_docs": n, "queries": q, "pq_m": M, "k": K,
        "corpus": "clustered stress (2048 centers, 0.3 sigma)",
        "method": "numpy ADC + numpy mirror of _pq_ivf_topk_impl coarse "
                  f"probe; overlap against the port's dispatch on "
                  f"{args.device}",
        "rows": rows,
    }
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
