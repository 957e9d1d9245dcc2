"""Where the paraphrase suite's expected sections are lost end to end: the
counterpart of the JAX package's ``scripts/diag_paraphrase.py``, over a
store on one device.

Each query of ``quality.PARAPHRASE_SUITE`` is replayed through the
orchestrator's stages one at a time (mirroring
``LegalOrchestrator.orchestrate``), and the rank of the first expected
section is recorded after each; the loss is labelled:

  encoder_miss        not in the merged fetch pool at all
  rerank_pool_cut     in the pool, dropped past the reranker's pool cap
  rerank_loss         in the pool within k, the CE blend pushed it out
  boost_loss          within k before the rule boosts, past k after
  expansion_dilution  the main query ranks it within k, the merged pool
                      (concept expansions first deduped) past k
  cutoff_loss         in the pool but past k before and after the boosts
  served              grounded (the query passes)

Run:  python -m legal_rag_tpu_torch.scripts.diag_paraphrase --store DIR
      [--mode rrf] [--k 5] [--device cuda] [--report build/diag.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional


def best_rank(rows, prefixes):
    """1-based rank of the first chunk matching any prefix; None if absent.

    ``rows`` is a list of dicts with ["chunk"]["section_id"].
    """
    for i, r in enumerate(rows):
        sid = r["chunk"].get("section_id") or ""
        if any(sid.startswith(p) for p in prefixes):
            return i + 1
    return None


def leak_of(stagelog: Dict, k: int, has_reranker: bool) -> str:
    """The stage at which the expected section was lost (module doc)."""
    merged_rank = stagelog["merged_pool_rank"]
    main_rank = stagelog["main_rank@fetch"]
    if stagelog["served_rank"] is not None:
        return "served"
    if merged_rank is None:
        return "encoder_miss"
    if has_reranker and stagelog.get("rerank_rank") is None:
        return "rerank_pool_cut"
    if (has_reranker and stagelog["rerank_rank"] is not None
            and stagelog["rerank_rank"] > k >= merged_rank):
        return "rerank_loss"
    if (stagelog["boosted_rank"] is not None and stagelog["boosted_rank"] > k
            and (stagelog.get("rerank_rank") or merged_rank) <= k):
        return "boost_loss"
    if main_rank is not None and main_rank <= k and merged_rank > k:
        return "expansion_dilution"
    return "cutoff_loss"


def run(store_dir=None, mode: Optional[str] = None, k: int = 5,
        legal=None, device="cuda", log=print) -> Dict:
    """One stage log a suite query, and the count of each leak."""
    from legal_rag_tpu_torch.quality import PARAPHRASE_SUITE
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine
    from legal_rag_tpu_torch.retrieval.orchestrator import expansion_queries

    legal = legal or LegalEngine(store_dir=store_dir, device=device)
    orch = legal.orchestrator
    engine = orch.engine
    fusion_cfg = engine.config.fusion

    rows_out = []
    for query, _, prefixes in PARAPHRASE_SUITE:
        intent = orch.classifier.classify(query)

        queries = [query]
        if intent.user_context == "victim_distress":
            queries.extend(expansion_queries(intent))
        queries = queries[: engine.config.max_expanded_queries]
        weights = [
            fusion_cfg.procedural_weight
            if intent.category == "procedure" or "procedure" in q.lower()
            else fusion_cfg.hybrid_weight
            for q in queries
        ]

        k_fetch = max(k, orch.rerank_candidates) if orch.reranker else k
        batched = engine.search_batch(
            queries, k=k_fetch, hybrid_weights=weights, mode=mode
        )

        # per-channel depth of the expected section for the MAIN query
        def deep_rank(weight, deep_mode):
            rows = engine.search_batch([query], k=30, hybrid_weights=[weight],
                                       mode=deep_mode)[0]
            return best_rank([r.to_dict() for r in rows], prefixes)

        main_rows = [r.to_dict() for r in batched[0]]
        # merge in query order, dedupe by canonical header (orchestrate)
        merged, seen = [], set()
        for rows in batched:
            for r in rows:
                header = r.chunk.get("canonical_header")
                if header and header not in seen:
                    seen.add(header)
                    merged.append(r.to_dict())
        stagelog = {
            "query": query,
            "expected": list(prefixes),
            "intent": {
                "category": intent.category,
                "user_context": intent.user_context,
            },
            "n_expansion": len(queries) - 1,
            "dense_rank@30": deep_rank(0.0, "weighted"),
            "bm25_rank@30": deep_rank(1.0, "weighted"),
            "fused_rank@30": deep_rank(weights[0], mode),
            "main_rank@fetch": best_rank(main_rows, prefixes),
            "merged_pool_rank": best_rank(merged, prefixes),
            "pool_size": len(merged),
        }

        reranked = list(merged)
        if orch.reranker is not None:
            reranked = orch.rerank_results(
                query, [dict(r) for r in merged], k=k, intent=intent
            )
            stagelog["rerank_rank"] = best_rank(reranked, prefixes)

        prioritized = orch.prioritize_results(
            [dict(r) for r in reranked], intent
        )
        stagelog["boosted_rank"] = best_rank(prioritized, prefixes)
        final = orch.expand_results(prioritized[:k])
        stagelog["served_rank"] = best_rank(final, prefixes)
        stagelog["leak"] = leak_of(stagelog, k, orch.reranker is not None)
        rows_out.append(stagelog)
        log(json.dumps(stagelog, ensure_ascii=False))

    summary: Dict[str, int] = {}
    for r in rows_out:
        summary[r["leak"]] = summary.get(r["leak"], 0) + 1
    return {
        "mode": mode or engine.config.fusion.mode,
        "k": k,
        "summary": summary,
        "rows": rows_out,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--mode", default=None, help="fusion mode (None=config)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    out = run(args.store, args.mode, args.k, device=args.device)
    out["store"] = args.store
    print("SUMMARY:", json.dumps(out["summary"]))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2, ensure_ascii=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
