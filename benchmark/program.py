"""The system under test: ``legal_rag_tpu_torch``, built from the
benchmark's inputs and the configuration file, and watched at the
boundaries the comparison reads.

This is the only module of the benchmark that imports the program. It
makes the store the served path reads (the chunks, the doc embeddings,
the encoders' weights and vocabulary, and the BM25 index: the program's
own ``build_bm25`` over the texts, or the prepared CSR of a large
store), the served configuration, and the engine behind the cell's
entry (``LegalEngine.query`` or ``RetrievalEngine.search_batch``) with
request coalescing on, as the server runs it.

:class:`Recorder` wraps the engine's query encoder, its ``search_batch``
and the cross-encoder's ``score_pairs`` on their instances, keeping what
each call returned (a seeded sample of it), so the comparison judges
what the timed path produced.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List

import numpy as np

from benchmark.data.inputs import Inputs


def retrieval_config(config: Dict):
    """The port's ``RetrievalConfig`` with every served setting the
    configuration file states."""
    from legal_rag_tpu_torch.config import (
        BM25Config, DenseConfig, EncoderConfig, FusionConfig, RetrievalConfig,
    )

    r, enc = config["retrieval"], config["encoder"]
    fu, bm = r["fusion"], r["bm25"]
    return RetrievalConfig(
        k=r["k"],
        dense=DenseConfig(dim=enc["hidden"], dtype=r["dense_dtype"]),
        bm25=BM25Config(k1=bm["k1"], b=bm["b"], epsilon=bm["epsilon"],
                        postings_budget_cap=bm["postings_cap"]),
        fusion=FusionConfig(
            mode=fu["mode"], hybrid_weight=fu["hybrid_weight"],
            procedural_weight=fu["procedural_weight"], rrf_k=fu["rrf_k"],
            candidate_multiplier=fu["candidate_multiplier"],
            ce_heading_alpha=fu["ce_heading_alpha"],
            narrative_mode=fu["narrative_mode"]),
        encoder=EncoderConfig(
            hidden=enc["hidden"], layers=enc["layers"], heads=enc["heads"],
            intermediate=enc["intermediate"], max_len=enc["max_len"],
            type_vocab_size=enc["type_vocab_size"]),
        max_expanded_queries=r["max_expanded_queries"],
    )


def build_store(inputs: Inputs, config: Dict):
    """The port's ``VectorStore`` over the inputs."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.ops.sparse import BM25Index, build_bm25

    bm = config["retrieval"]["bm25"]
    if inputs.csr is None:
        bm25 = build_bm25([c["text"] for c in inputs.chunks], k1=bm["k1"],
                          b=bm["b"], epsilon=bm["epsilon"])
    else:
        csr = inputs.csr
        bm25 = BM25Index(vocab=csr["vocab"], indptr=csr["indptr"],
                         doc_ids=csr["doc_ids"], weights=csr["weights"],
                         idf=csr["idf"], doc_len=csr["doc_len"],
                         n_docs=inputs.n_docs, avgdl=csr["avgdl"],
                         k1=bm["k1"], b=bm["b"], epsilon=bm["epsilon"])
    enc = config["encoder"]
    return VectorStore(
        embeddings=inputs.embeddings, bm25=bm25, chunks=inputs.chunks,
        wp_vocab=inputs.wp_vocab,
        encoder_info={"hidden": enc["hidden"], "layers": enc["layers"],
                      "heads": enc["heads"],
                      "intermediate": enc["intermediate"],
                      "max_len": enc["max_len"], "dtype": enc["dtype"],
                      "vocab_size": len(inputs.wp_vocab)},
        encoder_params=inputs.encoder_params, ce_params=inputs.ce_params,
        ce_alpha=inputs.ce_alpha,
    )


def make_engine(entry: str, store, config: Dict, device):
    """``(engine, retrieval_engine)``: a ``LegalEngine`` (LLM stages off,
    cross-encoder on) for ``query``, a ``RetrievalEngine`` for
    ``search_batch``; request coalescing on."""
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    cfg = retrieval_config(config)
    co = config["retrieval"]["coalescing"]
    if entry == "query":
        eng = LegalEngine(store=store, config=cfg, use_llm=False, rerank=True,
                          device=device)
        eng.orchestrator.rerank_candidates = \
            config["cross_encoder"]["candidates"]
        ret = eng.engine
    elif entry == "search_batch":
        eng = ret = RetrievalEngine(store, config=cfg, device=device)
    else:
        raise ValueError(f"unknown entry {entry!r}")
    ret.enable_request_coalescing(window_s=co["window_s"],
                                  max_batch=co["max_batch"])
    return eng, ret


def postings_budget(ret, queries: List[str]) -> int:
    """The power-of-two postings budget a batch takes (a program graph
    key: the warm-up sends a batch of each)."""
    from legal_rag_tpu_torch.retrieval.engine import _pad_pow2

    return _pad_pow2(ret.store.bm25.postings_budget(
        queries, cap=ret.config.bm25.postings_budget_cap))


def counters(ret) -> Dict[str, int]:
    """The program's counters: device dispatches, coalesced requests and
    dispatches, graphs captured and replayed, and kernel launches (on
    their own and inside replays)."""
    from legal_rag_tpu_torch.utils.cuda_build import KERNELS

    co = getattr(ret, "_coalescer", None)
    out = {"device_dispatches": getattr(ret, "device_dispatches", 0),
           "coalescer_requests": co.requests if co else 0,
           "coalescer_dispatches": co.dispatches if co else 0}
    if ret.graphs is not None:
        st = ret.graphs.stats()
        out.update(graphs=st["graphs"], graph_replays=st["replays"],
                   graph_pool_bytes=st["pool_bytes"])
    for k in KERNELS:
        for name, v in k.counts().items():
            if v:
                out[f"{k.name}.{name}"] = v
    return out


@dataclasses.dataclass
class SearchCall:
    queries: List[str]
    k: int
    weights: List[float]
    mode: str
    rows: List[List[tuple]]          # per query: (doc, fused, semantic, keyword)


class Recorder:
    """Keeps what the timed path returned at three boundaries.

    - every query-encoder call's texts and embeddings, a seeded
      reservoir of ``keep`` calls;
    - per request (the thread that runs it), each ``search_batch``
      call's arguments and rows and each cross-encoder call's pairs and
      logits, while :meth:`request` marks that thread.
    """

    def __init__(self, eng, ret, rng: np.random.Generator, keep: int):
        self.rng = rng
        self.keep = keep
        self.encodes: List[tuple] = []
        self.n_encodes = 0
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        encoder = ret.encoder
        raw_encode = encoder.encode

        def encode(texts, *a, **kw):
            out = raw_encode(texts, *a, **kw)
            if self.on:
                self._keep_encode(list(texts), out)
            return out

        encoder.encode = encode
        raw_search = ret.search_batch

        def search_batch(queries, k=None, hybrid_weights=None, mode=None):
            rows = raw_search(queries, k=k, hybrid_weights=hybrid_weights,
                              mode=mode)
            rec = getattr(self._local, "rec", None)
            if rec is not None:
                cfg = ret.config
                rec["search"].append(SearchCall(
                    list(queries), k or cfg.k,
                    list(hybrid_weights) if hybrid_weights is not None
                    else [cfg.fusion.hybrid_weight] * len(queries),
                    mode or cfg.fusion.mode,
                    [[(r.doc_id, r.score, r.semantic, r.keyword) for r in row]
                     for row in rows]))
            return rows

        ret.search_batch = search_batch
        reranker = getattr(getattr(eng, "orchestrator", None), "reranker", None)
        if reranker is not None:
            raw_score = reranker.score_pairs

            def score_pairs(queries, docs):
                out = raw_score(queries, docs)
                rec = getattr(self._local, "rec", None)
                if rec is not None:
                    rec["ce"].append((list(queries), list(docs),
                                      np.asarray(out, np.float64)))
                return out

            reranker.score_pairs = score_pairs

    def _keep_encode(self, texts, emb) -> None:
        with self._lock:
            self.n_encodes += 1
            if len(self.encodes) < self.keep:
                self.encodes.append((texts, np.array(emb)))
                return
            j = int(self.rng.integers(self.n_encodes))
            if j < self.keep:
                self.encodes[j] = (texts, np.array(emb))

    def request(self):
        """A fresh record for the calling thread's request; ``done``
        detaches it."""
        rec = {"search": [], "ce": []}
        self._local.rec = rec
        return rec

    def done(self) -> None:
        self._local.rec = None
