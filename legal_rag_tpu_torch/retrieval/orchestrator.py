"""Retrieval orchestration: classification, concept expansion, priority
boosting, parent expansion.

Functional parity with the reference ``LegalOrchestrator``
(orchestrator.py:8-139) with one deliberate architectural change: the
reference runs concept-expansion queries *sequentially* through the
engine (orchestrator.py:54, flagged HOT in SURVEY.md §3.1); here all
expansion queries are stacked into one query matrix and executed as a
single batched device program — one encoder launch, one search launch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from legal_rag_tpu_torch.retrieval.classifier import QueryClassifier, QueryIntent
from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine, SearchResult
from legal_rag_tpu_torch.retrieval.llm import LLMClient

_EXPANSION_OFFENCES = ("robbery", "assault", "rape", "theft")


def _union_interleave(
    dense_row: List["SearchResult"],
    base_row: List["SearchResult"],
    k: int,
    rrf_k: int,
) -> List["SearchResult"]:
    """Dense-first rank interleave of two rankings for one query
    (round-5 narrative `dense-union` policy).

    Measured on the serving store's cached rankings
    (EVAL_FUSION_POLICY.json `policy_union` rows): holds structure
    r@5/r@10 exactly at RRF's while giving the best sibling MRR of any
    mode (0.497 vs dense 0.490 / rrf 0.464) — and unlike pure-dense
    replacement it keeps BM25-carried groundings (the E2E suite's
    statute-vocabulary hits sit at RRF rank 1 and survive at union
    rank <= 2; pure replacement dropped the suite from 2/10 to 1/10).

    Rows are RE-SCORED by reciprocal interleave rank, 1/(rrf_k + pos):
    the two sources score on different scales (cosine fusion vs RRF
    sums) and every downstream stage — CE minmax blend, multiplicative
    rule boosts, the k cut — orders by `score`, so the interleaved
    rank must be what the score encodes. semantic/keyword components
    keep their source values for display.
    """
    import dataclasses

    seen, out = set(), []
    for j in range(max(len(dense_row), len(base_row))):
        for row in (dense_row[j:j + 1] + base_row[j:j + 1]):
            if row.doc_id not in seen:
                seen.add(row.doc_id)
                out.append(dataclasses.replace(
                    row, score=1.0 / (rrf_k + len(out))
                ))
            if len(out) >= k:
                return out
    return out


def expansion_queries(intent: QueryIntent) -> List[str]:
    """The reference's victim-distress concept expansion
    (orchestrator.py:42-48): FIR procedure, NALSA compensation, Zero FIR."""
    offence = next(
        (e for e in intent.key_entities if e.lower() in _EXPANSION_OFFENCES),
        "crime",
    )
    return [
        f"How to file FIR for {offence} BNSS procedure",
        f"Victim compensation rights for {offence} NALSA scheme",
        "Zero FIR registration procedure BNSS",
    ]


class LegalOrchestrator:
    def __init__(
        self,
        engine: RetrievalEngine,
        classifier: Optional[QueryClassifier] = None,
        llm: Optional[LLMClient] = None,
        reranker=None,
        rerank_candidates: int = 16,
        rerank_alpha: float = 1.0,
        rerank_alpha_heading: Optional[float] = None,
    ):
        self.engine = engine
        self.classifier = classifier or QueryClassifier(llm)
        # optional cross-encoder precision stage (beyond the reference,
        # whose ranking is bi-encoder + BM25 only): rerank the merged
        # candidate pool by joint (query, doc) attention before the
        # rule boosts (models/cross_encoder.py)
        self.reranker = reranker
        self.rerank_candidates = rerank_candidates
        # CE blend weight fit by the build gate (store.ce_alpha):
        # final = (1-alpha)*minmax(base) + alpha*minmax(ce)
        self.rerank_alpha = rerank_alpha
        # measured heading-form alpha (models/cross_encoder.py
        # ce_policy_alpha): short heading-like queries take the
        # structure-split optimum, everything else keeps rerank_alpha;
        # None disables the policy
        self.rerank_alpha_heading = rerank_alpha_heading
        # (law, section) -> section chunk, for parent expansion
        # (reference orchestrator.py:19-27)
        self.section_lookup: Dict[Tuple[str, str], Dict] = {}
        for chunk in engine.store.chunks:
            meta = chunk.get("metadata", {})
            law, section = meta.get("law"), meta.get("section")
            if law and section and meta.get("unit_type") == "section":
                self.section_lookup[(law, section)] = chunk

    def orchestrate(
        self, query: str, k: int = 5, mode: Optional[str] = None
    ) -> Dict[str, Any]:
        with self.engine.timer.stage("classify"):
            intent = self.classifier.classify(query)
        fusion_cfg = self.engine.config.fusion

        queries = [query]
        if intent.user_context == "victim_distress":
            queries.extend(expansion_queries(intent))
        queries = queries[: self.engine.config.max_expanded_queries]

        # per-query hybrid weight: procedural queries lean harder on
        # keywords (reference orchestrator.py:56 semantics, weights
        # from config instead of inline constants)
        weights = [
            fusion_cfg.procedural_weight
            if intent.category == "procedure" or "procedure" in q.lower()
            else fusion_cfg.hybrid_weight
            for q in queries
        ]

        # ONE batched device program for the whole expansion set; with
        # a reranker, fetch a wider pool for the precision stage to act on
        k_fetch = max(k, self.rerank_candidates) if self.reranker else k
        batched = self._search_with_form_policy(
            queries, k_fetch, weights, mode
        )

        # merge in query order, dedupe by canonical header
        # (reference orchestrator.py:58-62)
        merged: List[Dict] = []
        seen: set = set()
        for rows in batched:
            for r in rows:
                header = r.chunk.get("canonical_header")
                if header and header not in seen:
                    seen.add(header)
                    merged.append(r.to_dict())

        if self.reranker is not None:
            merged = self.rerank_results(query, merged, k=k, intent=intent)
        prioritized = self.prioritize_results(merged, intent)
        expanded = self.expand_results(prioritized[:k])
        return {"intent": intent.to_dict(), "results": expanded}

    def _search_with_form_policy(
        self,
        queries: List[str],
        k_fetch: int,
        weights: List[float],
        mode: Optional[str],
    ) -> List[List[SearchResult]]:
        """Per-query fusion routing by query form (round 5).

        Narrative-register queries take ``fusion.narrative_mode``
        (measured: dense beats RRF on the paraphrase split, r@10 0.690
        vs 0.659, and the E2E leak diagnosis showed RRF burying targets
        the dense channel surfaced at ranks 4-20); heading-register
        queries keep the default mode. An explicit caller ``mode``
        (API ``fusion_mode``) pins every query and bypasses the policy.
        At most two device programs per request (one per form present).
        """
        fusion_cfg = self.engine.config.fusion
        if mode is not None or not fusion_cfg.narrative_mode:
            return self.engine.search_batch(
                queries, k=k_fetch, hybrid_weights=weights, mode=mode
            )
        from legal_rag_tpu_torch.retrieval.query_form import is_narrative

        narrative = [is_narrative(q) for q in queries]
        if not any(narrative):
            return self.engine.search_batch(
                queries, k=k_fetch, hybrid_weights=weights, mode=None
            )
        if fusion_cfg.narrative_mode == "dense-union":
            # the default-mode program covers every query; narrative
            # rows are then union-merged with a dense ranking
            out = self.engine.search_batch(
                queries, k=k_fetch, hybrid_weights=weights, mode=None
            )
            narr_idx = [i for i, n in enumerate(narrative) if n]
            dense_rows = self.engine.search_batch(
                [queries[i] for i in narr_idx], k=k_fetch,
                hybrid_weights=[0.0] * len(narr_idx), mode="weighted",
            )
            for i, drow in zip(narr_idx, dense_rows):
                out[i] = _union_interleave(
                    drow, out[i], k_fetch, fusion_cfg.rrf_k
                )
            return out
        # pure-replacement variants: "dense" rides the weighted program
        # with weight 0 (the fused score then IS the dense score,
        # evaluation.py's dense mode); other values name an engine mode
        narr_mode, narr_weights = (
            ("weighted", [0.0] * len(queries))
            if fusion_cfg.narrative_mode == "dense"
            else (fusion_cfg.narrative_mode, weights)
        )
        out2: List[Optional[List[SearchResult]]] = [None] * len(queries)
        for flag, sub_mode in ((True, narr_mode), (False, None)):
            idx = [i for i, n in enumerate(narrative) if n is flag]
            if not idx:
                continue
            sub_w = [(narr_weights if flag else weights)[i] for i in idx]
            rows = self.engine.search_batch(
                [queries[i] for i in idx], k=k_fetch,
                hybrid_weights=sub_w, mode=sub_mode,
            )
            for i, row in zip(idx, rows):
                out2[i] = row
        return out2  # type: ignore[return-value]

    def rerank_results(
        self, query: str, results: List[Dict], k: int = 0, intent=None
    ) -> List[Dict]:
        """Cross-encoder precision stage: score every (query, candidate
        text) pair jointly in one batched forward, min-max normalize the
        logits to [0, 1] over the pool (so the multiplicative rule
        boosts that follow keep their semantics on a positive score),
        and reorder. Retrieval scores are preserved under
        ``retrieval_score``; ``rerank_score`` carries the raw logit.
        The pool is at least ``max(rerank_candidates, k)`` wide so the
        caller's k contract is preserved (a k=50 request is never
        silently truncated to the 16-candidate rerank pool); candidates
        past that cap are dropped rather than appended — their
        un-normalized retrieval scores are not comparable to the
        normalized pool scores.
        """
        pool = results[: max(self.rerank_candidates, k)]
        if not pool:
            return results
        texts = [r["chunk"]["text"] for r in pool]
        logits = self.reranker.score_pairs([query] * len(texts), texts)
        from legal_rag_tpu_torch.models.cross_encoder import (
            blend_scores, ce_policy_alpha,
        )

        alpha = ce_policy_alpha(
            query, self.rerank_alpha, self.rerank_alpha_heading,
            distress=(
                intent is not None
                and intent.user_context == "victim_distress"
            ),
        )
        final = blend_scores(
            logits, np.asarray([r["score"] for r in pool]), alpha,
        )
        for r, logit, f in zip(pool, logits, final):
            r["retrieval_score"] = r["score"]
            r["rerank_score"] = float(logit)
            r["score"] = float(f)
        pool.sort(key=lambda r: -r["score"])
        return pool

    # -- rule-based boosts (reference orchestrator.py:75-110) ---------------

    def prioritize_results(
        self, results: List[Dict], intent: QueryIntent
    ) -> List[Dict]:
        for res in results:
            meta = res["chunk"].get("metadata", {})
            law = str(meta.get("law", "")).upper()
            boost = 1.0

            if intent.user_context == "victim_distress":
                sub = intent.sub_intent or ""
                is_police_task = intent.category in (
                    "police_duty", "procedure",
                ) or any(w in sub for w in ("FIR", "report", "police"))
                if "BNSS" in law or "SOP" in law:
                    boost += 0.5 if is_police_task else 0.3
                if "NALSA" in law:
                    boost += 0.2 if is_police_task else 0.4
                if "BNS" in law and "BNSS" not in law:
                    boost -= 0.2

            for entity in intent.key_entities:
                if entity.upper() in law:
                    boost += 0.2

            if intent.category in ("definition", "punishment") and "SOP" in law:
                boost -= 0.3

            res["score"] *= boost

        results.sort(key=lambda r: r["score"], reverse=True)
        return results

    # -- parent expansion (reference orchestrator.py:112-139) ---------------

    def expand_results(self, results: List[Dict]) -> List[Dict]:
        final: List[Dict] = []
        seen: set = set()
        for res in results:
            chunk = res["chunk"]
            header = chunk.get("canonical_header")
            if header in seen:
                continue
            seen.add(header)
            meta = chunk.get("metadata", {})
            if meta.get("unit_type") in (
                "illustration", "explanation", "sub_section",
            ):
                parent = self.section_lookup.get(
                    (meta.get("law"), meta.get("section"))
                )
                if parent and parent.get("canonical_header") != header:
                    res["parent_context"] = parent["text"]
            final.append(res)
        return final
