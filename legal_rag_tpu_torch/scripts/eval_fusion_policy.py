"""Fusion-mode form policy, measured: the counterpart of the JAX
package's ``scripts/eval_fusion_policy.py``, over a store on one device.

Per split (structure titles, sibling spans), with bootstrap 95% CIs of
the recall@10 and MRR deltas against pure RRF:

  rrf               pure RRF (the serving default)
  dense             pure dense (the weighted program at weight 0)
  policy_words      narrative = more than HEADING_MAX_WORDS words
  policy_person     narrative = the words test and a person marker
  policy_narrative  narrative = ``retrieval.query_form.is_narrative``
  policy_union      narrative rows take the dense-first interleave of
                    both rankings (the orchestrator's dense-union)

The bootstrap draws from ``numpy.random.default_rng(seed)``, one fresh
generator a delta as in the JAX script, so one seed gives the JAX
script's intervals on the same rankings. The JAX script cached its two
base rankings under /tmp; this one ranks afresh each run.

Run:  python -m legal_rag_tpu_torch.scripts.eval_fusion_policy --store DIR
      [--max-pairs N] [--bootstrap 1000] [--seed 0] [--device cuda]
      [--report build/eval_fusion_policy.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np

PERSON_MARKERS = frozenset(
    "i me my mine we our us you your yours he she him her his hers "
    "someone stranger neighbour neighbor husband wife ex boyfriend "
    "girlfriend cousin nephew niece son daughter family".split()
)
POLICIES = (("policy_words", "words"), ("policy_person", "person"),
            ("policy_narrative", "narrative"))
MODES = ("rrf", "dense", "policy_words", "policy_person",
         "policy_narrative", "policy_union")


def is_narrative(query: str, variant: str) -> bool:
    from legal_rag_tpu_torch.models.cross_encoder import HEADING_MAX_WORDS
    from legal_rag_tpu_torch.retrieval import query_form

    words = query.lower().split()
    if len(words) <= HEADING_MAX_WORDS:
        return False
    if variant == "words":
        return True
    if variant == "person":
        return any(w in PERSON_MARKERS for w in query_form._tokens(query))
    if variant == "narrative":
        return query_form.is_narrative(query)
    raise ValueError(variant)


def ranked_ids(engine, queries, kmax, mode, weights=None, chunk=256):
    out = np.full((len(queries), kmax), -1, dtype=np.int64)
    for lo in range(0, len(queries), chunk):
        sub = queries[lo:lo + chunk]
        rows = engine.search_batch(
            sub, k=kmax,
            hybrid_weights=None if weights is None else [weights] * len(sub),
            mode=mode,
        )
        for qi, row in enumerate(rows):
            for j, r in enumerate(row[:kmax]):
                out[lo + qi, j] = r.doc_id
    return out


def mask_excludes(ranked, excludes):
    filt = np.full_like(ranked, -1)
    for qi in range(ranked.shape[0]):
        row = [d for d in ranked[qi] if d != excludes[qi]]
        filt[qi, : len(row)] = row
    return filt


def score(ranked, relevants, ks=(1, 5, 10)):
    from legal_rag_tpu_torch.evaluation import mrr_at_k, recall_at_k

    entry = {f"recall@{k}": round(recall_at_k(ranked, relevants, k), 4)
             for k in ks}
    entry["mrr"] = round(mrr_at_k(ranked, relevants, ranked.shape[1]), 4)
    return entry


def per_query_hits(ranked, relevants, k=10):
    hits = np.zeros(ranked.shape[0])
    rr = np.zeros(ranked.shape[0])
    for qi in range(ranked.shape[0]):
        rel = set(relevants[qi])
        for j, d in enumerate(ranked[qi]):
            if d in rel:
                rr[qi] = 1.0 / (j + 1)
                if j < k:
                    hits[qi] = 1.0
                break
    return hits, rr


def bootstrap_delta(a, b, n=1000, seed=0):
    """95% CI of mean(a) - mean(b) over query resamples."""
    rng = np.random.default_rng(seed)
    nq = len(a)
    deltas = [
        float(np.mean(a[idx]) - np.mean(b[idx]))
        for idx in (rng.integers(0, nq, nq) for _ in range(n))
    ]
    return (round(float(np.mean(a) - np.mean(b)), 4),
            round(float(np.percentile(deltas, 2.5)), 4),
            round(float(np.percentile(deltas, 97.5)), 4))


def union_interleave(dense, rrf, kmax):
    """Each row's dense-first interleave of the two rankings, deduped."""
    union = np.full_like(rrf, -1)
    for qi in range(rrf.shape[0]):
        seen, merged = set(), []
        for j in range(kmax):
            for d in (dense[qi, j], rrf[qi, j]):
                if d >= 0 and d not in seen:
                    seen.add(d)
                    merged.append(d)
        union[qi, : len(merged[:kmax])] = merged[:kmax]
    return union


def run(store, max_pairs: Optional[int] = None, bootstrap: int = 1000,
        seed: int = 0, engine=None, device="cuda", log=print) -> Dict:
    """The report: per split, each mode's recall@k and MRR, and the
    deltas' CIs against rrf."""
    from legal_rag_tpu_torch.evaluation import (
        labeled_pairs_from_chunks, sibling_span_pairs_from_chunks,
    )
    from legal_rag_tpu_torch.quality import _provenance
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = engine or RetrievalEngine(store, device=device)
    splits = {
        "structure": labeled_pairs_from_chunks(
            store.chunks, max_pairs=max_pairs),
        "sibling": sibling_span_pairs_from_chunks(
            store.chunks, max_pairs=max_pairs),
    }
    report = {"splits": {}, "provenance": _provenance(engine)}
    for name, pairs in splits.items():
        queries = [p[0] for p in pairs]
        relevants = [p[1] for p in pairs]
        excludes = [p[2] if len(p) > 2 else None for p in pairs]
        extra = int(any(e is not None for e in excludes))
        kmax = min(10 + extra, store.n_docs)
        rrf = ranked_ids(engine, queries, kmax, "rrf")
        dense = ranked_ids(engine, queries, kmax, "weighted", weights=0.0)
        if extra:
            rrf, dense = mask_excludes(rrf, excludes), mask_excludes(
                dense, excludes)

        rows = {"rrf": rrf, "dense": dense}
        for pol, variant in POLICIES:
            narr = np.array(
                [is_narrative(q, variant=variant) for q in queries])
            rows[pol] = np.where(narr[:, None], dense, rrf)
            rows[f"{pol}:narrative_rate"] = narr
        narr = rows["policy_narrative:narrative_rate"]
        rows["policy_union"] = np.where(
            narr[:, None], union_interleave(dense, rrf, kmax), rrf)
        rows["policy_union:narrative_rate"] = narr

        out = {}
        base_hits, base_rr = per_query_hits(rows["rrf"], relevants)
        for mode in MODES:
            entry = score(rows[mode], relevants)
            if mode != "rrf":
                hits, rr = per_query_hits(rows[mode], relevants)
                entry["delta_r10_vs_rrf_ci95"] = bootstrap_delta(
                    hits, base_hits, n=bootstrap, seed=seed)
                entry["delta_mrr_vs_rrf_ci95"] = bootstrap_delta(
                    rr, base_rr, n=bootstrap, seed=seed)
            if f"{mode}:narrative_rate" in rows:
                entry["narrative_rate"] = round(
                    float(rows[f"{mode}:narrative_rate"].mean()), 3)
            out[mode] = entry
            log(f"[{name}] {mode}: {entry}")
        report["splits"][name] = {"n_queries": len(queries), "modes": out}
    return report


def main(argv=None) -> int:
    from legal_rag_tpu_torch.index.store import VectorStore

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--bootstrap", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    report = run(VectorStore.load(args.store), args.max_pairs,
                 args.bootstrap, args.seed, device=args.device,
                 log=lambda s: print(s, flush=True))
    report["store"] = args.store
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
