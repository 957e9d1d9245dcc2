"""LegalEngine facade: one call = full RAG cycle.

The port's counterpart of ``legal_rag_tpu.retrieval.facade``: classify
-> retrieve (batched concept expansion) -> rerank -> prioritize/expand
-> generate, returning ``{query, intent, response, context_used,
adapted}``. Same constructor arguments plus ``device``; ``query`` and
the ``adapted`` view are the JAX package's code verbatim, but for the
spans ``query`` opens on the engine's ``StageTimer``: ``request`` around
it and ``respond`` around the responder and the adapted view.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from legal_rag_tpu_torch.config import RetrievalConfig, DEFAULT_CONFIG
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine
from legal_rag_tpu_torch.retrieval.llm import LLMClient, default_llm_client
from legal_rag_tpu_torch.retrieval.classifier import QueryClassifier
from legal_rag_tpu_torch.retrieval.orchestrator import LegalOrchestrator
from legal_rag_tpu_torch.retrieval.responder import LegalResponder
from legal_rag_tpu_torch.utils.timing import timed


class LegalEngine:
    def __init__(
        self,
        store_dir=None,
        store: Optional[VectorStore] = None,
        config: RetrievalConfig = DEFAULT_CONFIG,
        classifier_llm: Optional[LLMClient] = None,
        responder_llm: Optional[LLMClient] = None,
        use_llm: bool = True,
        rerank: Optional[bool] = None,
        device="cuda",
    ):
        """``rerank``: None (default) auto-enables the cross-encoder
        precision stage when the store carries a trained checkpoint;
        True/False force it on/off. ``device``: where the encoders and
        the doc matrix live (``"cuda"`` or ``"cpu"``)."""
        if store is None:
            if store_dir is None:
                raise ValueError("need store_dir or store")
            store = VectorStore.load(Path(store_dir))
        if use_llm:
            if classifier_llm is None:
                classifier_llm = default_llm_client(
                    ("CLASSIFIER_MODELS", "LLM_MODELS")
                )
            if responder_llm is None:
                responder_llm = default_llm_client(
                    ("RESPONDER_MODELS", "LLM_MODELS")
                )
        self.engine = RetrievalEngine(store, config=config, device=device)
        # the engine's one StageTimer: /health and the benchmark read it
        self.timer = self.engine.timer
        reranker = None
        if rerank is None:
            rerank = store.ce_params is not None
        if rerank:
            from legal_rag_tpu_torch.models.cross_encoder import CrossEncoder

            if store.ce_params is None:
                raise ValueError(
                    "rerank=True but the store has no cross_encoder.npz "
                    "checkpoint; rebuild with --rerank-steps"
                )
            reranker = CrossEncoder(
                self.engine.encoder, params=store.ce_params, timer=self.timer,
            )
        self.orchestrator = LegalOrchestrator(
            self.engine, classifier=QueryClassifier(classifier_llm),
            reranker=reranker, rerank_alpha=store.ce_alpha,
            rerank_alpha_heading=self.engine.config.fusion.ce_heading_alpha,
        )
        self.responder = LegalResponder(responder_llm)

    @timed("request")
    def query(
        self, query_text: str, k: int = 5, mode: Optional[str] = None
    ) -> Dict[str, Any]:
        """mode: None = config default; 'weighted' = reference-parity
        fusion; 'rrf' = native fusion (keyword-only hits can surface).
        """
        orchestration = self.orchestrator.orchestrate(query_text, k=k, mode=mode)
        with self.timer.stage("respond"):
            response = self.responder.generate_response(
                query=query_text,
                context=orchestration["results"],
                intent=orchestration["intent"],
            )
            result = {
                "query": query_text,
                "intent": orchestration["intent"],
                "response": response.to_dict(),
                "context_used": [
                    {
                        "citation": c["chunk"]["canonical_header"],
                        "section_id": c["chunk"].get("section_id"),
                        "expanded": "parent_context" in c,
                    }
                    for c in orchestration["results"]
                ],
            }
            result["adapted"] = self._adapted_view(result, orchestration)
        return result

    def _adapted_view(
        self, result: Dict[str, Any], orchestration: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Timeline anchors + confidence + sentence attribution over
        the engine result (the response layer the reference only
        specified in its ghost-module tests)."""
        from legal_rag_tpu_torch.server.adapter import (
            adapt_response, rag_view_from_engine,
        )
        from legal_rag_tpu_torch.server.sentence_attribution import (
            compute_sentence_attribution,
        )

        rag_view = rag_view_from_engine(result)
        adapted = adapt_response(rag_view, result["query"])

        citations = []
        for c in orchestration["results"]:
            chunk = c["chunk"]
            sid = chunk.get("section_id")
            law = str(chunk.get("metadata", {}).get("law", "")).lower()
            if not sid:
                continue
            source_type = {
                "bns": "bns", "bnss": "bnss", "bsa": "bsa",
                "nalsa": "nalsa",
            }.get(law, "general_sop" if sid.startswith("GSOP") else "rape_sop")
            citations.append({
                "source_type": source_type,
                "source_id": sid,
                "display": chunk.get("canonical_header", "").replace(
                    "\n", " — "
                ),
                "context_snippet": chunk.get("text", "")[:200],
            })
        attribution = compute_sentence_attribution(
            result["response"].get("answer", ""),
            citations,
            getattr(self.responder, "llm", None),
        )
        out = adapted.model_dump()
        out["sentence_attribution"] = attribution
        return out
