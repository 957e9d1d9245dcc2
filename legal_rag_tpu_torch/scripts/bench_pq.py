"""PQ capacity-tier benchmark on one CUDA card: the counterpart of the
JAX package's ``scripts/bench_pq.py``, at 1,000,000 docs (``BENCH_N``),
D=384, m=48, 64 queries, k=80 candidates.

1. Speed on random codes (the compute profile of trained ones):
   ``pq_topk`` and its phase 1 alone, kernel K2 (``pq_segmax``), with
   the codes' GB/s, at seg_rows 8 and 16, with K2's launches a row. The JAX script swept
   (block_n, seg_rows) in {(4096, 8), (4096, 16)}; ``block_n`` is the
   TPU kernel's tiling and has no counterpart here.
2. Candidate recall@10 of ``pq_topk``'s k=80 against the exact fp32
   top-10, 16 queries, on 200,000 clustered docs (OPQ trained on them).
3. IVF at the full N on clustered docs: the flat scan and the IVF
   search (``exp_ivf_recovery.ivf_search``: the engine's, over arrays
   kept on the device) at 32, 64 and 128 probes of 1,024-doc cells (16
   queries), each with its device time, candidate recall@10 and the
   codes it reads.

The data come from one numpy generator in the JAX script's order. The
codebooks are trained by the port on ``device`` (``train_fn``
substitutes the training, so that a test can hold both packages to one
codebook). Times are CUDA events after warm-up (``exp_common``); on the
CPU ``ms`` is None.

Run on the card:  python -m legal_rag_tpu_torch.scripts.bench_pq
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.ops.pq import build_ivf, encode_pq, pq_lut, pq_topk
from legal_rag_tpu_torch.ops.pq_segmax import K2, pq_segmax
from legal_rag_tpu_torch.scripts.exp_common import Log, card_main, timed_row
from legal_rag_tpu_torch.scripts.exp_ivf_recovery import (
    CELL_SIZE, TrainFn, ivf_search, train_opq,
)

N = 1_000_000
D, MB, Q, K = 384, 48, 64, 80
SPEED_SEG_ROWS = (8, 16)        # the JAX script's sweep
RECALL_DOCS = 200_000
PROBES = (32, 64, 128)
RECALL_Q = 16


def clustered(rng: np.random.Generator, centers: np.ndarray, n: int, q: int):
    """Docs (a center + 0.3 noise) and queries (a doc + 0.05 noise), unit
    rows, drawn from ``rng`` in the JAX script's order."""
    docs = centers[rng.integers(0, 2048, n)] + 0.3 * (
        rng.standard_normal((n, D)).astype(np.float32)
    )
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs = docs[rng.integers(0, n, q)] + 0.05 * (
        rng.standard_normal((q, D)).astype(np.float32)
    )
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return docs, qs


def candidate_recall(ids: np.ndarray, exact: np.ndarray) -> float:
    """Mean share of each query's exact top-10 among its candidates."""
    return float(np.mean([
        len(set(np.argsort(-exact[i], kind="stable")[:10].tolist())
            & set(ids[i].tolist())) / 10 for i in range(ids.shape[0])
    ]))


def run(n: int = N, recall_docs: int = RECALL_DOCS,
        probes: Sequence[int] = PROBES, device="cuda", seed: int = 0,
        log: Log = print, iters: int = 20, warmup: int = 3,
        train_fn: Optional[TrainFn] = None) -> List[Dict]:
    """The rows of the module doc; ``recall`` on the recall rows."""
    device = torch.device(device)
    train = train_fn or train_opq
    rng = np.random.default_rng(seed)
    timing = (iters, warmup)

    # -- 1. speed: random codes
    codes = torch.from_numpy(
        rng.integers(0, 256, (n, MB), dtype=np.uint8)).to(device)
    cbs = torch.from_numpy(
        (rng.standard_normal((2 * MB, 16, D // (2 * MB))) * 0.2)
        .astype(np.float32)).to(device)
    q = torch.from_numpy(
        rng.standard_normal((Q, D)).astype(np.float32)).to(device)
    lut = pq_lut(q, cbs).to(torch.bfloat16).contiguous()
    gb = n * MB
    rows = []
    for sr in SPEED_SEG_ROWS:
        for name, fn in (
            (f"pq_topk sr={sr} Q={Q} k={K}",
             lambda sr=sr: pq_topk(q, codes, cbs, K, seg_rows=sr)),
            (f"K2 pq_segmax sr={sr} Q={Q}",
             lambda sr=sr: pq_segmax(lut, codes, sr)),
        ):
            before = K2.launches
            rows.append(timed_row(name, fn, device, log, *timing, n_bytes=gb))
            rows[-1]["k2_launches"] = K2.launches - before
    del codes, lut

    # -- 2. candidate recall on trained codes of clustered data
    n_small = min(n, recall_docs)
    centers = rng.standard_normal((2048, D)).astype(np.float32)
    docs, qs = clustered(rng, centers, n_small, RECALL_Q)
    cb = train(docs, device)
    trained = torch.from_numpy(encode_pq(docs, cb, device=device)).to(device)
    _, ids = pq_topk(
        torch.from_numpy(np.asarray(cb.rotate(qs), np.float32)).to(device),
        trained, torch.tensor(np.asarray(cb.codebooks), device=device), K)
    rows.append({"name": f"candidate recall@10 k={K} n={n_small}",
                 "ms": None, "gbps": None,
                 "recall": candidate_recall(ids.cpu().numpy(), qs @ docs.T)})
    log(f"candidate recall@10 (k={K} oversample, {n_small} clustered docs, "
        f"OPQ): {rows[-1]['recall']:.4f}")
    del docs, trained

    # -- 3. IVF coarse pruning at the full N, against the flat scan
    big_docs, bq = clustered(rng, centers, n, RECALL_Q)
    cb_big = train(big_docs, device)
    codes_big = encode_pq(big_docs, cb_big, device=device)
    t0 = time.time()
    ivf = build_ivf(big_docs, cb_big, codes_big, cell_size=CELL_SIZE,
                    device=device)
    log(f"IVF build at N={n}: {time.time() - t0:.1f} s "
        f"({ivf.n_cells} cells x {CELL_SIZE})")
    exact = bq @ big_docs.T
    del big_docs
    qrot = torch.from_numpy(np.asarray(cb_big.rotate(bq), np.float32)).to(device)
    codes_big_d = torch.from_numpy(codes_big).to(device)
    cbs_big = torch.tensor(np.asarray(cb_big.codebooks), device=device)
    ivf_topk = ivf_search(ivf, cb_big.codebooks, device)
    scans = [("flat", lambda: pq_topk(qrot, codes_big_d, cbs_big, K), n)]
    scans += [(f"ivf p={p}", lambda p=p: ivf_topk(qrot, K, p),
               min(p, ivf.n_cells) * CELL_SIZE) for p in probes]
    for name, fn, n_read in scans:
        rec = candidate_recall(fn()[1].cpu().numpy(), exact)
        rows.append(timed_row(f"{name} Q={RECALL_Q}", fn, device, log,
                              *timing, n_bytes=n_read * MB, recall=rec,
                              codes_mb=n_read * MB / 1e6))
        log(f"  recall@10 {rec:.4f} (reads {n_read * MB / 1e6:.0f} MB)")
    return rows


def main() -> int:
    n = int(os.environ.get("BENCH_N", N))

    def body(log: Log) -> None:
        log(f"N={n} D={D} m={MB} Q={Q} k={K}")
        run(n, device="cuda", log=log)

    return card_main("bench_pq", body)


if __name__ == "__main__":
    sys.exit(main())
