"""Retrieval-quality evaluation: labeled pairs from corpus structure.

The port of ``legal_rag_tpu.evaluation``. The labeled splits (section,
SOP topic and NALSA clause titles; the lexical-gap and sibling-span
paraphrase splits) and the metrics (recall@k, MRR) are the JAX
package's host code verbatim. The evaluations run the port's
``RetrievalEngine`` on ``device`` (or the engine given), and the
BM25-only ranking goes through the port's ``ops.sparse.bm25_topk``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.config import RetrievalConfig, DEFAULT_CONFIG

_SOP_PREFIX = "SOP ON "


def labeled_pairs_from_chunks(
    chunks: Sequence[Dict],
    min_title_words: int = 2,
    max_pairs: Optional[int] = None,
    seed: int = 0,
) -> List[Tuple[str, List[int]]]:
    """Derive (query, relevant chunk ids) pairs from chunk metadata.

    Queries with identical text merge their relevant sets (several laws
    share titles like "Punishment for criminal conspiracy"), so a hit
    on any of them counts — matching how a user would judge it.
    """
    by_query: Dict[str, set] = {}
    for i, chunk in enumerate(chunks):
        meta = chunk.get("metadata", {})
        law = meta.get("law")
        title = None
        if law in ("BNS", "BNSS", "BSA") and meta.get("section"):
            title = meta.get("section_title")
        elif law == "SOP":
            title = meta.get("chapter_title") or ""
            if title.upper().startswith(_SOP_PREFIX):
                title = title[len(_SOP_PREFIX):]
        elif law == "NALSA" and meta.get("clause"):
            title = meta.get("clause_title")
        if not title:
            continue
        title = title.strip().rstrip(".").strip()
        if len(title.split()) < min_title_words:
            continue
        by_query.setdefault(title, set()).add(i)

    pairs = sorted(
        ((q, sorted(ids)) for q, ids in by_query.items()),
        key=lambda p: p[0],
    )
    if max_pairs is not None and len(pairs) > max_pairs:
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(pairs), size=max_pairs, replace=False)
        pairs = [pairs[int(j)] for j in sorted(keep)]
    return pairs


def paraphrase_pairs_from_chunks(
    chunks: Sequence[Dict],
    min_query_words: int = 4,
    max_query_words: int = 16,
    per_section: int = 2,
    max_pairs: Optional[int] = None,
    seed: int = 0,
) -> List[Tuple[str, List[int]]]:
    """Lexical-gap ("paraphrase") split: BM25-unwinnable by construction.

    Title queries (labeled_pairs_from_chunks) appear verbatim inside the
    target chunks' headers, so BM25 wins them by exact match and the
    split cannot show what the dense side adds. This split inverts that:
    the query is built from the content tokens UNIQUE to one chunk of a
    multi-chunk section, and the relevant set is that section's OTHER
    chunks — every query token is absent from every relevant chunk, so
    lexical matching carries zero signal and only semantic
    generalization (the thing the corpus-contrastive fine-tune trains —
    same-section spans are its positives, models/finetune.py) can
    retrieve the target. The dense-vs-BM25 gap on this split is the
    measured value of the hybrid stack's dense half.
    """
    groups: Dict[tuple, List[int]] = {}
    for i, chunk in enumerate(chunks):
        meta = chunk.get("metadata", {})
        law = meta.get("law")
        key = None
        if law in ("BNS", "BNSS", "BSA") and meta.get("section"):
            key = (law, str(meta.get("section")))
        elif law == "SOP" and meta.get("chapter_title"):
            key = (law, meta.get("chapter_title"))
        elif law == "NALSA" and meta.get("clause"):
            key = (law, str(meta.get("clause")))
        if key is not None:
            groups.setdefault(key, []).append(i)

    rng = np.random.default_rng(seed)
    pairs: List[Tuple[str, List[int]]] = []
    for key in sorted(groups):
        ids = groups[key]
        if len(ids) < 2:
            continue
        toks = {
            i: {
                w for w in chunks[i]["text"].lower().split() if w.isalpha()
            }
            for i in ids
        }
        candidates = []
        for src in ids:
            rest = [i for i in ids if i != src]
            other = set().union(*(toks[i] for i in rest))
            seen: set = set()
            uniq: List[str] = []
            for w in chunks[src]["text"].lower().split():
                if w.isalpha() and w not in other and w not in seen:
                    seen.add(w)
                    uniq.append(w)
            if len(uniq) >= min_query_words:
                candidates.append(
                    (" ".join(uniq[:max_query_words]), sorted(rest))
                )
        if len(candidates) > per_section:
            keep = rng.choice(
                len(candidates), size=per_section, replace=False
            )
            candidates = [candidates[int(j)] for j in sorted(keep)]
        pairs.extend(candidates)

    if max_pairs is not None and len(pairs) > max_pairs:
        keep = rng.choice(len(pairs), size=max_pairs, replace=False)
        pairs = [pairs[int(j)] for j in sorted(keep)]
    return pairs


def sibling_span_pairs_from_chunks(
    chunks: Sequence[Dict],
    span_words: int = 12,
    max_pairs: Optional[int] = None,
    seed: int = 0,
) -> List[Tuple[str, List[int], int]]:
    """Paraphrase-style split: natural spans, sibling targets, source
    masked.

    Each query is a CONTIGUOUS ``span_words``-word window sampled from
    one chunk of a multi-chunk legal unit (section / SOP chapter /
    NALSA clause); the relevant set is that unit's OTHER chunks, and
    the source chunk itself is excluded from the ranking (third tuple
    element — ``evaluate_store`` drops it before scoring, else the
    trivial lexical self-match would be the answer). This is the
    in-distribution probe of the fine-tune's sibling objective
    (models/finetune.py make_sibling_pairs): a span retrieves its
    section's sibling chunks only through section-level semantics,
    since the exact span text occurs nowhere in the targets. BM25 still
    gets natural section-vocabulary signal (shared defined terms, law
    names), so the split is a fair fight — the hybrid-vs-BM25 delta
    here is the measured value of the dense half.

    (The earlier lexical-gap variant, paraphrase_pairs_from_chunks,
    strips every sibling-shared token from the query; that floors BM25
    at exactly 0 but is so far out of any encoder's input distribution
    that dense scores chance too — kept as a diagnostic, not a split a
    system is expected to win.)
    """
    from legal_rag_tpu_torch.models.finetune import section_groups

    rng = np.random.default_rng(seed)
    pairs: List[Tuple[str, List[int], int]] = []
    for group in section_groups(chunks):
        if len(group) < 2:
            continue
        for src in group:
            words = chunks[src]["text"].split()
            if len(words) < 8:
                continue
            take = min(span_words, len(words))
            lo = int(rng.integers(0, len(words) - take + 1))
            query = " ".join(words[lo : lo + take])
            rest = [i for i in group if i != src]
            pairs.append((query, rest, src))
    if max_pairs is not None and len(pairs) > max_pairs:
        keep = rng.choice(len(pairs), size=max_pairs, replace=False)
        pairs = [pairs[int(j)] for j in sorted(keep)]
    return pairs


def recall_at_k(
    ranked_ids: np.ndarray, relevants: Sequence[Sequence[int]], k: int
) -> float:
    """Fraction of queries with >= 1 relevant doc in the top k."""
    hits = 0
    for qi, rel in enumerate(relevants):
        rel = set(rel)
        if any(int(d) in rel for d in ranked_ids[qi, :k]):
            hits += 1
    return hits / max(len(relevants), 1)


def mrr_at_k(
    ranked_ids: np.ndarray, relevants: Sequence[Sequence[int]], k: int
) -> float:
    """Mean reciprocal rank of the first relevant doc within top k."""
    total = 0.0
    for qi, rel in enumerate(relevants):
        rel = set(rel)
        for rank, d in enumerate(ranked_ids[qi, :k], start=1):
            if int(d) in rel:
                total += 1.0 / rank
                break
    return total / max(len(relevants), 1)


def _bm25_ranked_ids(
    store, queries: Sequence[str], k: int,
    config: RetrievalConfig = DEFAULT_CONFIG, device="cuda",
) -> np.ndarray:
    """BM25-only ranking straight from the sparse ops, with the
    postings budget capped as serving caps it."""
    from legal_rag_tpu_torch.ops.sparse import bm25_topk

    budget = max(8, store.bm25.postings_budget(
        queries, cap=config.bm25.postings_budget_cap
    ))
    budget = 1 << (budget - 1).bit_length()
    pids, pw = store.bm25.gather_postings(queries, budget)
    _, ids = bm25_topk(
        torch.from_numpy(pids).to(device), torch.from_numpy(pw).to(device),
        store.n_docs, min(k, store.n_docs),
    )
    return ids.cpu().numpy()


def evaluate_store(
    store,
    pairs: Sequence[Tuple[str, Sequence[int]]],
    ks: Sequence[int] = (1, 5, 10),
    modes: Sequence[str] = ("dense", "bm25", "weighted", "rrf"),
    config: RetrievalConfig = DEFAULT_CONFIG,
    encoder=None,
    engine=None,
    device="cuda",
) -> Dict:
    """recall@k / MRR per retrieval mode over one store + encoder, on
    ``engine`` or a new engine on ``device``.

    ``dense`` runs the production weighted program with weight 0 (the
    fused score then IS the dense score over dense candidates);
    ``bm25`` ranks the whole corpus by sparse score alone; ``weighted``
    and ``rrf`` are the two production fusion modes. ``pq`` (opt-in)
    runs dense-only through the PQ capacity tier (dtype='pq' engine,
    oversample + fp32 rescore) — its gap vs ``dense`` is the measured
    cost of 32x compression on this corpus.
    """
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = engine or RetrievalEngine(
        store, config=config, encoder=encoder, device=device
    )
    queries = [p[0] for p in pairs]
    relevants = [p[1] for p in pairs]
    # optional third element: a doc id to mask from the ranking (the
    # sibling-span split's source chunk) — retrieve one extra and drop
    # it per row before scoring
    excludes = [p[2] if len(p) > 2 else None for p in pairs]
    extra = int(any(e is not None for e in excludes))
    kmax = min(max(ks) + extra, store.n_docs)
    # chunk to a serving-sized bucket: one moderate executable reused
    # across chunks instead of one giant Q=next_pow2(len(pairs)) program
    chunk = 256

    def batched_search(**kw):
        rows = []
        for lo in range(0, len(queries), chunk):
            sub = queries[lo:lo + chunk]
            w = kw.get("hybrid_weights")
            rows.extend(
                kw["engine"].search_batch(
                    sub, k=kmax,
                    hybrid_weights=None if w is None else w[:len(sub)],
                    mode=kw["mode"],
                )
            )
        return rows

    def ids_from_results(results):
        out = np.full((len(queries), kmax), -1, dtype=np.int64)
        for qi, row in enumerate(results):
            for j, r in enumerate(row[:kmax]):
                out[qi, j] = r.doc_id
        return out

    report: Dict = {"n_queries": len(queries), "modes": {}}
    for mode in modes:
        if mode == "dense":
            ranked = ids_from_results(batched_search(
                engine=engine, mode="weighted",
                hybrid_weights=[0.0] * chunk,
            ))
        elif mode == "bm25":
            ranked = _bm25_ranked_ids(
                store, queries, kmax, config=config, device=engine.device
            )
        elif mode in ("weighted", "rrf"):
            ranked = ids_from_results(batched_search(
                engine=engine, mode=mode, hybrid_weights=None,
            ))
        elif mode == "pq":
            import dataclasses

            cfg_pq = dataclasses.replace(
                config, dense=dataclasses.replace(config.dense, dtype="pq")
            )
            eng_pq = RetrievalEngine(
                store, config=cfg_pq, encoder=engine.encoder,
                device=engine.device,
            )
            ranked = ids_from_results(batched_search(
                engine=eng_pq, mode="weighted",
                hybrid_weights=[0.0] * chunk,
            ))
        elif mode in ("maxsim", "maxsim-rerank"):
            # late-interaction tier (requires build --multi-vector);
            # its delta vs 'dense' is what token-level interaction
            # buys; 'maxsim-rerank' additionally measures what the
            # bounded dense-first candidate stage costs vs the full
            # slab scan
            ranked = ids_from_results(batched_search(
                engine=engine, mode=mode, hybrid_weights=None,
            ))
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if extra:
            filt = np.full_like(ranked, -1)
            for qi in range(ranked.shape[0]):
                row = [d for d in ranked[qi] if d != excludes[qi]]
                filt[qi, : len(row)] = row
            ranked = filt
        entry = {f"recall@{k}": recall_at_k(ranked, relevants, k) for k in ks}
        entry["mrr"] = mrr_at_k(ranked, relevants, kmax - extra)
        report["modes"][mode] = entry
    return report


def compare_encoders(
    chunks: Sequence[Dict],
    config: RetrievalConfig = DEFAULT_CONFIG,
    finetune_steps: int = 300,
    finetune_batch: int = 32,
    ks: Sequence[int] = (1, 5, 10),
    max_pairs: Optional[int] = None,
    mesh=None,
    log_fn=None,
    device="cuda",
) -> Dict:
    """The VERDICT-r1 ablation: random-init vs corpus-fine-tuned encoder
    across all four retrieval modes, one report.

    Builds the random-encoder store, evaluates, fine-tunes the SAME
    encoder (shared tokenizer) on corpus span pairs, re-encodes, and
    evaluates again.
    """
    from legal_rag_tpu_torch.index.builder import build_index
    from legal_rag_tpu_torch.models.finetune import finetune_encoder
    from legal_rag_tpu_torch.parallel.mesh import make_mesh

    mesh = mesh or make_mesh(config.sharding.num_shards, device=device)
    store = build_index(chunks, config=config, device=device)
    pairs = labeled_pairs_from_chunks(
        store.chunks, max_pairs=max_pairs
    )
    if log_fn:
        log_fn(f"{len(pairs)} labeled structure queries")

    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = RetrievalEngine(store, config=config, device=device)
    base_report = evaluate_store(
        store, pairs, ks=ks, config=config, engine=engine
    )
    if log_fn:
        log_fn(f"random-init encoder: {base_report['modes']}")

    tuned, losses = finetune_encoder(
        engine.encoder,
        [c["text"] for c in store.chunks],
        mesh,
        steps=finetune_steps,
        batch_size=finetune_batch,
        log_fn=log_fn,
        chunks=store.chunks,
    )
    tuned_store = build_index(
        chunks, encoder=tuned, config=config, device=device
    )
    tuned_report = evaluate_store(
        tuned_store, pairs, ks=ks, config=config, encoder=tuned,
        device=device,
    )
    if log_fn:
        log_fn(f"fine-tuned encoder:  {tuned_report['modes']}")
    return {
        "n_queries": base_report["n_queries"],
        "finetune": {
            "steps": finetune_steps,
            "loss_first": losses[0] if losses else None,
            "loss_last": losses[-1] if losses else None,
        },
        "random_encoder": base_report["modes"],
        "finetuned_encoder": tuned_report["modes"],
    }


def evaluate_rerank(
    store,
    pairs: Sequence[Tuple[str, Sequence[int]]],
    reranker,
    base_mode: str = "rrf",
    candidates: int = 20,
    ks: Sequence[int] = (1, 5, 10),
    config: RetrievalConfig = DEFAULT_CONFIG,
    engine=None,
    alpha: float = 1.0,
    alphas: Optional[Sequence[float]] = None,
    device="cuda",
) -> Dict:
    """Cross-encoder rerank stage on top of a base retrieval mode:
    retrieve top-``candidates`` with ``base_mode``, rerank them jointly
    (models/cross_encoder.py), report recall@k / MRR before vs after.
    ``alpha`` blends CE scores with the base scores (1.0 = pure CE).

    ``alphas`` evaluates a whole blend grid in ONE pass — the base
    retrieval and the CE forward (the expensive parts) run once and
    only the cheap host-side blend varies per alpha; the report then
    carries ``modes["reranked@<alpha>"]`` per grid point plus
    ``modes["reranked"]`` for the best-MRR alpha (``best_alpha`` at top
    level). The index build's gate fits its serving alpha this way.
    """
    from legal_rag_tpu_torch.models.cross_encoder import blend_scores
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = engine or RetrievalEngine(store, config=config, device=device)
    queries = [q for q, _ in pairs]
    relevants = [rel for _, rel in pairs]
    c = min(candidates, store.n_docs)
    kmax = min(max(ks), c)
    grid = [float(a) for a in (alphas if alphas is not None else [alpha])]

    base = engine.search_batch(queries, k=c, mode=base_mode)
    base_ids = np.full((len(queries), c), -1, dtype=np.int64)
    rer_ids = {
        a: np.full((len(queries), c), -1, dtype=np.int64) for a in grid
    }
    for qi, (query, rows) in enumerate(zip(queries, base)):
        ids = [r.doc_id for r in rows]
        base_ids[qi, : len(ids)] = ids
        if not ids:
            continue
        texts = [store.chunks[d]["text"] for d in ids]
        ce_scores = reranker.score_pairs([query] * len(texts), texts)
        bs = np.asarray([r.score for r in rows], dtype=np.float64)
        for a in grid:
            s = ce_scores if a >= 1.0 else blend_scores(ce_scores, bs, a)
            order = np.argsort(-s, kind="stable")
            rer_ids[a][qi, : len(order)] = [ids[j] for j in order]

    def entry(ranked):
        e = {f"recall@{k}": recall_at_k(ranked, relevants, k)
             for k in ks if k <= c}
        e["mrr"] = mrr_at_k(ranked, relevants, kmax)
        return e

    out = {"n_queries": len(queries), "base_mode": base_mode,
           "candidates": c, "modes": {"base": entry(base_ids)}}
    per_alpha = {a: entry(rer_ids[a]) for a in grid}
    best_alpha = max(grid, key=lambda a: per_alpha[a]["mrr"])
    out["best_alpha"] = best_alpha
    out["modes"]["reranked"] = per_alpha[best_alpha]
    if alphas is not None:
        for a in grid:
            out["modes"][f"reranked@{a}"] = per_alpha[a]
    return out
