"""The comparison that decides ``correct``: the program's recorded
outputs against the plain reference, number by number, each with its
limit (``benchmark/limits/<workload>.json``, else ``default.json``).

Numbers:

- ``emb_gap``: the largest absolute difference between an element of a
  query embedding the program's encoder returned and the reference's;
- ``rank_band``: the largest tie band a returned search row needs to sit
  where its query's exact dense and BM25 scores allow (``search.py``);
- ``ce_gap``: the largest difference between a cross-encoder logit the
  program returned and the reference's, over the spread of the
  reference's logits in that pool (what the min-max blend reads);
- ``requests_wrong``: requests whose searches (queries, weights, modes)
  differ from the orchestration's plan, whose cross-encoder pool differs
  from the merge of their own rows, or whose returned context differs
  from the one the reference derives from their rows and its own logits
  (docs whose final scores tie may trade places).

The reference derives everything again from the benchmark's inputs: the
embeddings from the texts and the weights, BM25 from the token streams.
Only the request's context is followed from the program's own rows: the
rows themselves are judged by ``rank_band``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from benchmark.data.inputs import Inputs
from benchmark.reference import orchestration as orch
from benchmark.reference.bm25 import PlainBM25
from benchmark.reference.minilm import (
    PlainCrossEncoder, PlainEncoder, matmul_precision,
)
from benchmark.reference.search import Channels, band_needed, plain_rows

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def limits_for(workload: str) -> Dict[str, float]:
    out = json.loads((LIMITS_DIR / "default.json").read_text())
    own = LIMITS_DIR / f"{workload}.json"
    if own.exists():
        out.update(json.loads(own.read_text()))
    return {k: v for k, v in out.items() if not k.startswith("_")}


def pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class Reference:
    """The plain reference over one run's inputs, on ``device``."""

    def __init__(self, inputs: Inputs, config: Dict, device):
        enc, r = config["encoder"], config["retrieval"]
        self.config, self.inputs, self.device = config, inputs, device
        self.encoder = PlainEncoder(inputs.encoder_params, inputs.wp_vocab,
                                    enc["heads"], enc["max_len"], device)
        self.ce = PlainCrossEncoder(inputs.ce_params, inputs.wp_vocab,
                                    enc["heads"], enc["max_len"], device)
        bm = r["bm25"]
        self.bm25 = PlainBM25(torch.as_tensor(inputs.bm25_tokens, device=device),
                              torch.as_tensor(inputs.bm25_lengths, device=device),
                              inputs.bm25_vocab, bm["k1"], bm["b"],
                              bm["epsilon"])
        self.cap = pow2(bm["postings_cap"]) if bm["postings_cap"] else None
        self.docs = torch.as_tensor(inputs.embeddings, device=device).double()
        self.fusion = r["fusion"]
        self._emb: Dict[str, np.ndarray] = {}

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        todo = [t for t in dict.fromkeys(texts) if t not in self._emb]
        if todo:
            for t, e in zip(todo, self.encoder.encode(todo)):
                self._emb[t] = e
        return np.stack([self._emb[t] for t in texts])

    def channels(self, text: str, q_emb: Optional[np.ndarray] = None) -> Channels:
        q = self.embed([text])[0] if q_emb is None else q_emb
        dense = self.docs @ torch.as_tensor(q, device=self.device).double()
        lo, hi = self.bm25.scores(text, self.cap)
        return Channels(dense, lo, hi)

    def c_of(self, k: int) -> int:
        return max(self.fusion["candidate_multiplier"] * k, k)


def emb_gap(ref: Reference, encodes) -> float:
    gap = 0.0
    for texts, emb in encodes:
        gap = max(gap, float(np.abs(np.asarray(emb, np.float64)
                                    - ref.embed(texts)).max()))
    return gap


def rank_band(ref: Reference, calls) -> float:
    band, worst = 0.0, None
    for call in calls:
        for q, w, rows in zip(call.queries, call.weights, call.rows):
            ch = ref.channels(q)
            b = band_needed(ch, rows, call.mode, call.k, ref.c_of(call.k),
                            ref.fusion["rrf_k"], w)
            if b > band:
                band, worst = b, (q, call.mode, w, rows, ch, call.k)
    if worst is not None:
        _describe(ref, band, *worst)
    return band


def _describe(ref: Reference, band, q, mode, w, rows, ch, k) -> None:
    """One line on the query that needed the widest band: the program's
    rows beside the reference's own channel lists."""
    c = ref.c_of(k)
    d_top = torch.topk(ch.dense, min(c, ch.n))
    s_top = torch.topk(ch.lo, min(c, ch.n))
    print(json.dumps({
        "widest_band": band, "query": q, "mode": mode, "weight": w,
        "rows": [[int(r[0]), float(r[1])] for r in rows],
        "dense_top": [[int(i), float(v)] for v, i in zip(*d_top)],
        "sparse_top": [[int(i), float(v), float(ch.hi[i])]
                       for v, i in zip(*s_top)],
        "postings": ref.bm25.n_postings(q)}), flush=True)


def ce_gap(ref: Reference, ce_calls) -> float:
    gap = 0.0
    for queries, docs, logits in ce_calls:
        want = ref.ce.scores(queries, docs).astype(np.float64)
        spread = max(float(want.max() - want.min()), 1e-6)
        gap = max(gap, float(np.abs(np.asarray(logits) - want).max()) / spread)
    return gap


def request_wrong(ref: Reference, query: str, rec: Dict, result: Dict) -> bool:
    """Whether one ``LegalEngine.query`` request is wrong beyond its rows
    (see the module doc)."""
    cfg = ref.config
    r, ce = cfg["retrieval"], cfg["cross_encoder"]
    k = r["k"]
    intent, searches = orch.plan(query, ref.fusion, r["max_expanded_queries"],
                                 k, ce["candidates"])
    got = [(c.queries, c.k, [round(w, 6) for w in c.weights], c.mode)
           for c in rec["search"]]
    want = [(list(q), kk, [round(w, 6) for w in ws], m)
            for q, kk, ws, m in searches]
    if got != want:
        return True
    chunks = ref.inputs.chunks
    rows_of = [[[(d, f) for d, f, _, _ in row] for row in c.rows]
               for c in rec["search"]]
    pool = orch.merged_pool(query, intent, searches, rows_of, chunks,
                            ref.fusion, ce["candidates"], k)
    if len(rec["ce"]) != (1 if pool else 0):
        return True
    if not pool:
        return bool(result["context_used"])
    texts = [chunks[p["doc"]]["text"] for p in pool]
    if rec["ce"][0][1] != texts or rec["ce"][0][0] != [query] * len(texts):
        return True
    logits = ref.ce.scores([query] * len(texts), texts)
    rows, scores = orch.final_context(
        query, intent, pool, logits, chunks, ref.sections, ref.inputs.ce_alpha,
        ref.fusion["ce_heading_alpha"], k)
    return not orch.context_matches(result["context_used"], rows, scores)


def judge(ref: Reference, encodes, calls, requests=()) -> Dict[str, float]:
    """The numbers of one run; ``requests``: ``(query, record, result)``
    of the sampled ``LegalEngine.query`` requests."""
    out = {"emb_gap": emb_gap(ref, encodes), "rank_band": rank_band(ref, calls)}
    if requests:
        ref.sections = orch.section_lookup(ref.inputs.chunks)
        out["ce_gap"] = ce_gap(ref, [c for _, rec, _ in requests
                                     for c in rec["ce"]])
        out["requests_wrong"] = float(sum(
            request_wrong(ref, q, rec, res) for q, rec, res in requests))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number at or under its limit."""
    checks = {name: {"value": v, "limit": limits[name]}
              for name, v in numbers.items()}
    return all(v <= limits[n] for n, v in numbers.items()), checks


# -- the control: the reference in the program's place, one precision down --

def control_records(ref: Reference, texts_batches, requests=(), k: int = 5,
                    mode: str = "rrf"):
    """Records as the program would leave them, made by the reference
    with every matmul in TF32: ``(encodes, calls, requests)``."""
    from benchmark.program import SearchCall

    fu = ref.fusion
    with matmul_precision(True):
        def rows_for(queries, kk, weights, m):
            emb = ref.encoder.encode(queries, tf32=True)
            docs32 = ref.docs.float()
            out = []
            for q, e, w in zip(queries, emb, weights):
                dense = (docs32 @ torch.as_tensor(e, device=ref.device)).double()
                lo, _ = ref.bm25.scores(q, ref.cap)
                out.append(plain_rows(dense, lo, m, kk, ref.c_of(kk),
                                      fu["rrf_k"], w))
            return emb, out

        encodes, calls = [], []
        for qs in texts_batches:
            emb, rows = rows_for(qs, k, [fu["hybrid_weight"]] * len(qs), mode)
            encodes.append((list(qs), emb))
            calls.append(SearchCall(list(qs), k, [fu["hybrid_weight"]] * len(qs),
                                    mode, rows))
        reqs = []
        cfg = ref.config
        r, ce = cfg["retrieval"], cfg["cross_encoder"]
        sections = orch.section_lookup(ref.inputs.chunks) if requests else {}
        for query in requests:
            intent, searches = orch.plan(query, fu, r["max_expanded_queries"],
                                         r["k"], ce["candidates"])
            rec = {"search": [], "ce": []}
            for qs, kk, ws, m in searches:
                emb, rows = rows_for(qs, kk, ws, m)
                encodes.append((list(qs), emb))
                rec["search"].append(SearchCall(list(qs), kk, list(ws), m, rows))
            rows_of = [[[(d, f) for d, f, _, _ in row] for row in c.rows]
                       for c in rec["search"]]
            pool = orch.merged_pool(query, intent, searches, rows_of,
                                    ref.inputs.chunks, fu, ce["candidates"],
                                    r["k"])
            texts = [ref.inputs.chunks[p["doc"]]["text"] for p in pool]
            logits = ref.ce.scores([query] * len(texts), texts, tf32=True)
            rec["ce"].append(([query] * len(texts), texts, logits))
            ctx, _ = orch.final_context(query, intent, pool, logits,
                                        ref.inputs.chunks, sections,
                                        ref.inputs.ce_alpha,
                                        fu["ce_heading_alpha"], r["k"])
            result = {"context_used": [
                {"citation": c["header"], "section_id": c["section_id"],
                 "expanded": c["expanded"]} for c in ctx]}
            reqs.append((query, rec, result))
    return encodes, calls, reqs
