"""PQ/IVF recovery at 2^20 clustered docs on one CUDA card: for the flat
PQ dispatch and IVF at 256 and 512 probes, sweep the oversample factor
and report recall@10 after the exact fp32 rescore, with the scan's
device time and the host rescore's time a query. The counterpart of the
JAX package's ``scripts/exp_ivf_recovery.py``; the scans run kernel K2
(``ops/pq_segmax.py``) through ``pq_topk`` and the IVF search of
``ops.pq`` over arrays kept on the device, as the engine keeps them.

The corpus is the JAX script's, from the same numpy seed: 2,048
Gaussian centers, docs = a center + 0.3 noise, queries = a doc + 0.05
noise, unit rows; 4-bit PQ with m=48 and OPQ (15 k-means rounds, 4 OPQ
rounds, 32,768 samples) and IVF cells of 1,024, trained by the port on
``device`` (``train_fn`` substitutes the codebook's training, so that a
test can hold both packages to one codebook). Times are CUDA events
after warm-up (``exp_common``); on the CPU ``ms`` is None.

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_ivf_recovery
Env: RECOVERY_N (default 2^20), RECOVERY_Q (default 64).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.ops.dense import exact_rescore
from legal_rag_tpu_torch.ops.pq import (
    IVFIndex, PQCodebook, _pq_ivf_topk_impl, build_ivf, encode_pq, pq_topk,
    train_pq,
)
from legal_rag_tpu_torch.scripts.exp_common import Log, card_main, timed_row

N = 1 << 20
Q = 64
D, M, K = 384, 48, 10
CELL_SIZE = 1024
OVERSAMPLES = (4, 8, 16, 32, 64)
DISPATCHES = ("flat", "ivf256", "ivf512")
TrainFn = Callable[[np.ndarray, torch.device], PQCodebook]


def clustered_corpus(n: int, q: int, seed: int = 0, d: int = D):
    """``(docs [n, d], queries [q, d])`` float32 unit rows of the JAX
    scripts' clustered stress corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((2048, d)).astype(np.float32)
    docs = centers[rng.integers(0, 2048, n)] + 0.3 * (
        rng.standard_normal((n, d)).astype(np.float32)
    )
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs = docs[rng.integers(0, n, q)] + 0.05 * (
        rng.standard_normal((q, d)).astype(np.float32)
    )
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return docs, qs


def train_opq(docs: np.ndarray, device) -> PQCodebook:
    """The scripts' codebook: m=48, OPQ, 15 k-means rounds on 32,768
    samples, 4 OPQ rounds."""
    return train_pq(docs, m=M, iters=15, sample=32768, opq_iters=4,
                    device=device)


def ivf_search(ivf: IVFIndex, codebooks, device):
    """``search(queries, k, probes)``: ``pq_ivf_topk`` over the IVF
    arrays uploaded to ``device`` once, as the engine keeps them
    (``parallel/sharded.py``); ``pq_ivf_topk`` itself uploads them a
    call, which at 1M docs costs more than the scan."""
    arrays = [torch.tensor(np.asarray(a), device=device) for a in (
        ivf.centroids, ivf.codes, ivf.doc_ids)]
    cbs = torch.tensor(np.asarray(codebooks, np.float32), device=device)

    def search(queries: torch.Tensor, k: int, probes: int):
        return _pq_ivf_topk_impl(queries, *arrays, cbs, k,
                                 min(probes, ivf.n_cells), ivf.cell_size)

    return search


def gold_topk(docs: np.ndarray, qs: np.ndarray, k: int, device):
    """Each query's exact top-``k`` ids as sets (fp32 products, a stable
    sort), in query blocks of 16 as the JAX script computes them."""
    d = torch.from_numpy(docs).to(device)
    gold = []
    for lo in range(0, qs.shape[0], 16):
        sc = torch.from_numpy(qs[lo:lo + 16]).to(device) @ d.T
        idx = torch.sort(sc, dim=1, descending=True, stable=True).indices
        gold.extend(set(row) for row in idx[:, :k].cpu().tolist())
    return gold


def post_rescore_recall(cand: np.ndarray, qs: np.ndarray, docs: np.ndarray,
                        gold, k: int = K) -> float:
    """Recall@k of the exact fp32 rescore of each query's candidates
    (``ops.dense.exact_rescore``; ids < 0 are empty slots)."""
    _, top, _, _ = exact_rescore(qs, cand, docs, k=k)
    return float(np.mean([len(set(row[row >= 0].tolist()) & want) / k
                          for row, want in zip(top, gold)]))


def run(n: int = N, q: int = Q, oversamples: Sequence[int] = OVERSAMPLES,
        dispatches: Sequence[str] = DISPATCHES, device="cuda", seed: int = 0,
        log: Log = print, iters: int = 20, warmup: int = 3,
        train_fn: Optional[TrainFn] = None) -> List[Dict]:
    """One row a (dispatch, oversample): ``recall`` (post-rescore
    recall@10), ``ms`` (the scan of the batch), ``rescore_ms_per_q``
    (host)."""
    device = torch.device(device)
    docs, qs = clustered_corpus(n, q, seed)
    t0 = time.time()
    cb = (train_fn or train_opq)(docs, device)
    codes = encode_pq(docs, cb, device=device)
    ivf = build_ivf(docs, cb, codes, cell_size=CELL_SIZE, device=device)
    log(f"PQ+IVF trained on {device} ({ivf.n_cells} cells x {CELL_SIZE}) "
        f"in {time.time() - t0:.1f} s")
    gold = gold_topk(docs, qs, K, device)
    qrot = torch.from_numpy(np.asarray(cb.rotate(qs), np.float32)).to(device)
    codes_d = torch.from_numpy(codes).to(device)
    cbs = torch.tensor(np.asarray(cb.codebooks, np.float32), device=device)
    ivf_topk = ivf_search(ivf, cb.codebooks, device)

    rows = []
    for name in dispatches:
        for x in oversamples:
            kk = K * x
            if name == "flat":
                scan = lambda kk=kk: pq_topk(qrot, codes_d, cbs, kk)
            else:
                scan = lambda kk=kk, p=int(name[3:]): ivf_topk(qrot, kk, p)
            cand = scan()[1].cpu().numpy()
            t0 = time.perf_counter()
            rec = post_rescore_recall(cand, qs, docs, gold)
            rescore = (time.perf_counter() - t0) * 1e3 / q
            rows.append(timed_row(
                f"{name} oversample={x}", scan, device, log, iters, warmup,
                dispatch=name, oversample=x, candidates=kk, recall=rec,
                rescore_ms_per_q=rescore))
            log(f"  post-rescore recall@{K} {rec:.4f}, host rescore "
                f"{rescore:.3f} ms/q")
    return rows


def main() -> int:
    n = int(os.environ.get("RECOVERY_N", N))
    q = int(os.environ.get("RECOVERY_Q", Q))

    def body(log: Log) -> None:
        log(f"N={n} Q={q} m={M} k={K} cells of {CELL_SIZE}")
        run(n, q, device="cuda", log=log)

    return card_main("exp_ivf_recovery", body)


if __name__ == "__main__":
    sys.exit(main())
