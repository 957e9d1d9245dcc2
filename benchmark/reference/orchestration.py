"""Frozen copy of the host orchestration of ``LegalEngine.query``.

Copied from ``legal_rag_tpu_torch/retrieval/orchestrator.py``,
``retrieval/query_form.py`` and ``models/cross_encoder.py`` (host code:
the query form, the concept expansion, the per-query hybrid weights, the
dense-union interleave of narrative queries, the merge by canonical
header, the cross-encoder's min-max blend and its form policy, the rule
boosts and the parent expansion). It plans the searches a request must
make and, given the rows those searches returned and the cross-encoder
logits, the context the request must return.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.classifier import QueryIntent, classify_heuristic

_EXPANSION_OFFENCES = ("robbery", "assault", "rape", "theft")
HEADING_MAX_WORDS = 8
FUNCTION_WORDS = frozenset(
    "shall is are was were be been being has have had he she his her "
    "him my me i we you such any said whoever who whom it that may "
    "must".split()
)
INTERROGATIVES = frozenset(
    "what how can when where which who why does do is are am should "
    "could will".split()
)


def is_narrative(query: str) -> bool:
    if len(query.split()) <= HEADING_MAX_WORDS:
        return False
    toks = [w.strip(".,?!'\"()–-—;:") for w in query.lower().split()]
    return (
        any(w in FUNCTION_WORDS for w in toks)
        or (bool(toks) and toks[0] in INTERROGATIVES)
        or "?" in query
    )


def expansion_queries(intent: QueryIntent) -> List[str]:
    offence = next(
        (e for e in intent.key_entities if e.lower() in _EXPANSION_OFFENCES),
        "crime",
    )
    return [
        f"How to file FIR for {offence} BNSS procedure",
        f"Victim compensation rights for {offence} NALSA scheme",
        "Zero FIR registration procedure BNSS",
    ]


def plan(query: str, fusion: Dict, max_expanded: int, k: int,
         rerank_candidates: int):
    """``(intent, searches)``: each search ``(queries, k, weights,
    mode)`` in the order the orchestrator makes them."""
    intent = classify_heuristic(query)
    queries = [query]
    if intent.user_context == "victim_distress":
        queries.extend(expansion_queries(intent))
    queries = queries[:max_expanded]
    weights = [
        fusion["procedural_weight"]
        if intent.category == "procedure" or "procedure" in q.lower()
        else fusion["hybrid_weight"]
        for q in queries
    ]
    k_fetch = max(k, rerank_candidates)
    searches = [(queries, k_fetch, weights, fusion["mode"])]
    narr = [q for q in queries if is_narrative(q)]
    if narr and fusion.get("narrative_mode") == "dense-union":
        searches.append((narr, k_fetch, [0.0] * len(narr), "weighted"))
    return intent, searches


def union_interleave(dense_row: List[Dict], base_row: List[Dict], k: int,
                     rrf_k: int) -> List[Dict]:
    seen, out = set(), []
    for j in range(max(len(dense_row), len(base_row))):
        for row in (dense_row[j:j + 1] + base_row[j:j + 1]):
            if row["doc"] not in seen:
                seen.add(row["doc"])
                out.append(dict(row, score=1.0 / (rrf_k + len(out))))
            if len(out) >= k:
                return out
    return out


def blend_scores(ce_scores, base_scores, alpha: float) -> np.ndarray:
    def norm(x):
        x = np.asarray(x, np.float64)
        lo, hi = float(x.min()), float(x.max())
        return (x - lo) / ((hi - lo) or 1.0)

    return (1.0 - alpha) * norm(base_scores) + alpha * norm(ce_scores)


def ce_policy_alpha(query: str, serving_alpha: float,
                    heading_alpha: Optional[float], distress: bool) -> float:
    if heading_alpha is None or distress:
        return serving_alpha
    if len(query.split()) <= HEADING_MAX_WORDS:
        return heading_alpha
    return serving_alpha


def merged_pool(query: str, intent: QueryIntent, searches, rows_of,
                chunks: Sequence[Dict], fusion: Dict,
                rerank_candidates: int, k: int) -> List[Dict]:
    """The candidate pool the cross-encoder scores: each query's rows
    (narrative ones interleaved with their dense rows), merged in query
    order, deduplicated by canonical header, cut to the pool's width.
    ``rows_of[i]``: the rows (doc, fused score) search ``i`` returned."""
    queries = searches[0][0]
    k_fetch = searches[0][1]
    per_query = [[{"doc": d, "score": f} for d, f in row]
                 for row in rows_of[0]]
    if len(searches) > 1:
        narr_idx = [i for i, q in enumerate(queries) if is_narrative(q)]
        for i, drow in zip(narr_idx, rows_of[1]):
            dense = [{"doc": d, "score": f} for d, f in drow]
            per_query[i] = union_interleave(dense, per_query[i], k_fetch,
                                            fusion["rrf_k"])
    merged, seen = [], set()
    for row in per_query:
        for r in row:
            header = chunks[r["doc"]].get("canonical_header")
            if header and header not in seen:
                seen.add(header)
                merged.append(r)
    return merged[:max(rerank_candidates, k)]


def section_lookup(chunks: Sequence[Dict]) -> Dict[Tuple, Dict]:
    """(law, section) -> the section's own chunk, for parent expansion."""
    out = {}
    for c in chunks:
        meta = c.get("metadata", {})
        if meta.get("law") and meta.get("section") and \
                meta.get("unit_type") == "section":
            out[(meta["law"], meta["section"])] = c
    return out


def final_context(query: str, intent: QueryIntent, pool: List[Dict],
                  logits: np.ndarray, chunks: Sequence[Dict],
                  sections: Dict[Tuple, Dict], ce_alpha: float,
                  heading_alpha: Optional[float], k: int):
    """Blend, boost, cut and expand: ``(rows, scores)``, the request's
    context rows, each ``{"doc", "score", "section_id", "header",
    "expanded"}``, and every pooled header's final score."""
    alpha = ce_policy_alpha(query, ce_alpha, heading_alpha,
                            intent.user_context == "victim_distress")
    final = blend_scores(logits, [r["score"] for r in pool], alpha)
    rows = [dict(r, score=float(f)) for r, f in zip(pool, final)]
    rows.sort(key=lambda r: -r["score"])
    for r in rows:
        meta = chunks[r["doc"]].get("metadata", {})
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
        r["score"] *= boost
    rows.sort(key=lambda r: r["score"], reverse=True)
    scores = {chunks[r["doc"]].get("canonical_header"): r["score"]
              for r in rows}
    out, seen = [], set()
    for r in rows[:k]:
        chunk = chunks[r["doc"]]
        header = chunk.get("canonical_header")
        if header in seen:
            continue
        seen.add(header)
        meta = chunk.get("metadata", {})
        expanded = False
        if meta.get("unit_type") in ("illustration", "explanation",
                                     "sub_section"):
            parent = sections.get((meta.get("law"), meta.get("section")))
            expanded = bool(parent and parent.get("canonical_header") != header)
        out.append(dict(r, section_id=chunk.get("section_id"), header=header,
                        expanded=expanded))
    return out, scores


def context_matches(got: List[Dict], want: List[Dict],
                    scores: Dict[int, float], tol: float = 1e-6) -> bool:
    """The program's context (``citation``, ``section_id``, ``expanded``
    a row) against the reference's, docs whose final scores lie within
    ``tol`` of each other free to trade places."""
    if len(got) != len(want):
        return False
    by_header = {r["header"]: r for r in want}
    for g, w in zip(got, want):
        if g["citation"] == w["header"]:
            if g["section_id"] != w["section_id"] or \
                    g["expanded"] != w["expanded"]:
                return False
            continue
        other = scores.get(g["citation"])
        if other is None or abs(other - w["score"]) > tol * max(1.0, abs(other)):
            return False
        if g["citation"] in by_header and \
                by_header[g["citation"]]["section_id"] != g["section_id"]:
            return False
    return True
