"""Cross-encoder value where it can win: the counterpart of the JAX
package's ``scripts/eval_ce_paraphrase.py``, over a store that carries a
cross-encoder checkpoint, on one device.

Per split (structure titles, sibling-span paraphrases): base RRF top-C
-> CE rerank over an alpha grid -> MRR and recall@10, each with a
bootstrap 95% CI of the MRR delta against the base; then the form
policy (``models.cross_encoder.ce_policy_alpha``: heading-like queries
take a heading alpha, the rest the serving alpha). The bootstrap draws
from ``numpy.random.default_rng(seed)``, one fresh generator a delta as
in the JAX script. The JAX script wrote the repository's
EVAL_CE_PARAPHRASE.json by default and could cache its CE scores under a
directory; this one prints its report as JSON (``--report PATH`` also
writes it) and scores afresh each run.

Run:  python -m legal_rag_tpu_torch.scripts.eval_ce_paraphrase --store DIR
      [--n 400] [--candidates 20] [--ce-batch 256] [--device cuda]
      [--report build/eval_ce_paraphrase.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np

ALPHAS = (0.0, 0.1, 0.2, 0.3, 0.5, 0.7, 1.0)
HEADING_ALPHAS = (0.3, 0.5, 0.7)


def mrr(ranked, relevant_sets):
    out = []
    for row, rel in zip(ranked, relevant_sets):
        rr = 0.0
        for pos, d in enumerate(row):
            if d in rel:
                rr = 1.0 / (pos + 1)
                break
        out.append(rr)
    return np.asarray(out)


def recall10(ranked, relevant_sets):
    out = []
    for row, rel in zip(ranked, relevant_sets):
        out.append(len(set(row[:10]) & rel) / max(1, min(len(rel), 10)))
    return np.asarray(out)


def bootstrap_ci(delta, n_boot=2000, seed=0):
    rng = np.random.default_rng(seed)
    n = len(delta)
    means = delta[rng.integers(0, n, (n_boot, n))].mean(axis=1)
    return float(np.quantile(means, 0.025)), float(np.quantile(means, 0.975))


def _delta_entry(m, r10, base_mrr, n_boot, seed) -> Dict:
    delta = m - base_mrr
    lo_ci, hi_ci = bootstrap_ci(delta, n_boot, seed)
    return {
        "mrr": float(m.mean()),
        "recall@10": float(r10.mean()),
        "delta_mrr": float(delta.mean()),
        "delta_mrr_ci95": [lo_ci, hi_ci],
        "ci_excludes_zero": bool(lo_ci > 0 or hi_ci < 0),
    }


def run(store, n: int = 400, candidates: int = 20, ce_batch: int = 256,
        n_boot: int = 2000, seed: int = 0, device="cuda", log=print) -> Dict:
    """The report: per split, the base, every alpha and every heading
    policy's MRR and recall@10 with their CIs, and the best alpha."""
    import dataclasses

    from legal_rag_tpu_torch.config import DEFAULT_CONFIG, FusionConfig
    from legal_rag_tpu_torch.evaluation import (
        labeled_pairs_from_chunks, sibling_span_pairs_from_chunks,
    )
    from legal_rag_tpu_torch.models.cross_encoder import (
        CrossEncoder, blend_scores, ce_policy_alpha,
    )
    from legal_rag_tpu_torch.quality import _provenance
    from legal_rag_tpu_torch.retrieval.classifier import classify_heuristic
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    if store.ce_params is None:
        raise ValueError("store has no cross_encoder.npz checkpoint")
    cfg = dataclasses.replace(DEFAULT_CONFIG, fusion=FusionConfig(mode="rrf"))
    engine = RetrievalEngine(store, config=cfg, device=device)
    ce = CrossEncoder(engine.encoder, params=store.ce_params)
    serving_alpha = getattr(store, "ce_alpha", None) or 0.1
    c = candidates

    splits = {
        "structure": [
            (q, rel, None) for q, rel in labeled_pairs_from_chunks(
                store.chunks, max_pairs=n)
        ],
        "paraphrase": sibling_span_pairs_from_chunks(
            store.chunks, max_pairs=n),
    }
    report = {
        "candidates": c,
        "serving_alpha": serving_alpha,
        "provenance": _provenance(engine),
        "splits": {},
    }
    for name, pairs in splits.items():
        queries = [p[0] for p in pairs]
        rels = [set(p[1]) for p in pairs]
        excludes = [p[2] for p in pairs]

        # +1 so dropping the masked source chunk still leaves C
        base = engine.search_batch(queries, k=c + 1, mode="rrf")
        cand_ids, cand_base = [], []
        for rows, ex in zip(base, excludes):
            cand_ids.append([r.doc_id for r in rows if r.doc_id != ex][:c])
            cand_base.append([r.score for r in rows if r.doc_id != ex][:c])

        # flat CE scoring in batches
        flat_q, flat_d = [], []
        for qi, ids in enumerate(cand_ids):
            for d in ids:
                flat_q.append(queries[qi])
                flat_d.append(store.chunks[d]["text"])
        ce_scores = np.zeros(len(flat_q), np.float32)
        for lo in range(0, len(flat_q), ce_batch):
            hi = min(lo + ce_batch, len(flat_q))
            ce_scores[lo:hi] = ce.score_pairs(flat_q[lo:hi], flat_d[lo:hi])
        per_q_ce, pos = [], 0
        for ids in cand_ids:
            per_q_ce.append(ce_scores[pos:pos + len(ids)])
            pos += len(ids)

        def reranked(alpha_of):
            ranked = []
            for qi, ids in enumerate(cand_ids):
                if not ids:
                    ranked.append([])
                    continue
                blended = blend_scores(
                    per_q_ce[qi], np.asarray(cand_base[qi]), alpha_of(qi))
                order = np.argsort(-blended, kind="stable")
                ranked.append([ids[j] for j in order])
            return ranked

        base_mrr = mrr(cand_ids, rels)
        entry = {
            "n_queries": len(queries),
            "base": {"mrr": float(base_mrr.mean()),
                     "recall@10": float(recall10(cand_ids, rels).mean())},
            "alphas": {},
        }
        best = None
        for a in ALPHAS:
            ranked = reranked(lambda qi, a=a: a)
            m = mrr(ranked, rels)
            entry["alphas"][str(a)] = _delta_entry(
                m, recall10(ranked, rels), base_mrr, n_boot, seed)
            if best is None or m.mean() > best[1]:
                best = (a, m.mean())
        entry["best_alpha"] = best[0]

        # the form policy: heading-like queries take the heading alpha,
        # the rest keep the serving alpha
        distress = [
            classify_heuristic(q).user_context == "victim_distress"
            for q in queries
        ]
        entry["policy"] = {}
        for a_h in HEADING_ALPHAS:
            alpha_of = lambda qi, a_h=a_h: ce_policy_alpha(
                queries[qi], serving_alpha, a_h, distress=distress[qi])
            ranked = reranked(alpha_of)
            n_head = sum(1 for qi, ids in enumerate(cand_ids) if ids
                         and alpha_of(qi) == a_h and not distress[qi])
            e = _delta_entry(mrr(ranked, rels), recall10(ranked, rels),
                             base_mrr, n_boot, seed)
            e["heading_rate"] = n_head / max(1, len(queries))
            entry["policy"][f"heading@{a_h}"] = e
        report["splits"][name] = entry
        b = entry["base"]
        log(f"{name}: base MRR {b['mrr']:.4f} r@10 {b['recall@10']:.4f}")
        for key, e in [*entry["alphas"].items(), *entry["policy"].items()]:
            star = " *" if e["ci_excludes_zero"] else ""
            log(f"  {key:<12} MRR {e['mrr']:.4f} (d={e['delta_mrr']:+.4f} "
                f"CI[{e['delta_mrr_ci95'][0]:+.4f},"
                f"{e['delta_mrr_ci95'][1]:+.4f}]{star}) "
                f"r@10 {e['recall@10']:.4f}")
    return report


def main(argv=None) -> int:
    from legal_rag_tpu_torch.index.store import VectorStore

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--n", type=int, default=400,
                    help="queries per split")
    ap.add_argument("--candidates", type=int, default=20)
    ap.add_argument("--ce-batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    report = run(VectorStore.load(args.store), args.n, args.candidates,
                 args.ce_batch, seed=args.seed, device=args.device,
                 log=lambda s: print(s, file=sys.stderr, flush=True))
    report["store"] = args.store
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
