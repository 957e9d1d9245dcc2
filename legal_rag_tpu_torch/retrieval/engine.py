"""Hybrid retrieval engine: the serving-path core.

The PyTorch counterpart of ``legal_rag_tpu.retrieval.engine``: the same
interface for the orchestrator and the HTTP layer (``.store``,
``.config``, ``.encoder``, ``.timer``, ``search_batch``,
``enable_request_coalescing``), one ``[Q, D]`` query matrix per call,
and the same power-of-two query bucketing and postings budget. The
device work is :func:`legal_rag_tpu_torch.parallel.sharded.sharded_hybrid_search`
over the engine's mesh (``mesh=``, else ``config.sharding.num_shards``
devices of the engine's kind: every visible card by default, one on a
one-card machine), over the storage tier that ``config.dense.dtype`` names:
float32, bfloat16, int8 or pq (with IVF pruning when the store carries
IVF cells and ``dense.use_ivf`` is set). The int8 and pq tiers
oversample their candidates and, in weighted mode, rescore them exactly
in fp32 on the host (``exact_rescore``), as the JAX engine does.

The late-interaction modes run over the store's token slab
(``mv_tokens.npy``, from ``build --multi-vector``), uploaded on first
use: ``"maxsim"`` scans the whole slab, ``"maxsim-rerank"`` rescores
the float dense tier's top-C candidates
(:class:`legal_rag_tpu_torch.parallel.sharded.ShardedMultiVectorIndex`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.config import RetrievalConfig, DEFAULT_CONFIG
from legal_rag_tpu_torch.utils.timing import StageTimer
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.wordpiece import WordPieceTokenizer
from legal_rag_tpu_torch.ops.dense import exact_rescore
from legal_rag_tpu_torch.ops.maxsim import (
    minilm_token_and_pooled, scan_block_n,
)
from legal_rag_tpu_torch.parallel.mesh import make_mesh
from legal_rag_tpu_torch.parallel.sharded import (
    ShardedIndex, ShardedMultiVectorIndex, sharded_hybrid_search,
)

logger = logging.getLogger("LegalRAG-RetrievalEngine")


@dataclasses.dataclass
class SearchResult:
    chunk: Dict
    score: float
    semantic: float
    keyword: float
    doc_id: int

    def to_dict(self) -> Dict:
        """Reference-shaped result dict (retrieval_engine.py:86-91)."""
        return {
            "chunk": self.chunk,
            "score": self.score,
            "semantic": self.semantic,
            "keyword": self.keyword,
        }


def _pad_pow2(n: int, lo: int = 8) -> int:
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


class RetrievalEngine:
    """Device-resident hybrid searcher over a VectorStore."""

    def __init__(
        self,
        store: VectorStore,
        config: RetrievalConfig = DEFAULT_CONFIG,
        encoder: Optional[SentenceEncoder] = None,
        device="cuda",
        mesh=None,
    ):
        # fp32 matmuls in full fp32 on the GPU: the reference computes
        # with Precision.HIGHEST, and TF32 keeps about three digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.store = store
        self.config = config
        self.device = torch.device(device)
        self.timer = StageTimer()
        if encoder is None:
            enc_cfg = config.encoder
            # the store records the encoder that built its embeddings;
            # query encoding must match it
            prefer_tok = "auto"
            if store.encoder_info:
                info = dict(store.encoder_info)
                info.pop("seed", None)
                # pin the tokenizer implementation that embedded the
                # docs (python vs native-cpp diverge on non-Latin text)
                prefer_tok = info.pop("tokenizer_impl", "auto")
                enc_cfg = dataclasses.replace(
                    enc_cfg, **{
                        k: v for k, v in info.items()
                        if hasattr(enc_cfg, k) and v is not None
                    }
                )
            if not store.wp_vocab:
                raise ValueError(
                    "store has no wp_vocab.txt; the encoder's WordPiece "
                    "vocab must come from the store that embedded the docs"
                )
            encoder = SentenceEncoder(
                cfg=enc_cfg, params=store.encoder_params,
                tokenizer=WordPieceTokenizer(store.wp_vocab),
                prefer_tokenizer=prefer_tok, device=self.device,
            )
        if encoder.cfg.hidden != store.dim:
            raise ValueError(
                f"encoder hidden dim {encoder.cfg.hidden} != store "
                f"embedding dim {store.dim}; the store was built with a "
                "different encoder (see manifest['encoder'])"
            )
        self.encoder = encoder
        self.mesh = mesh or make_mesh(config.sharding.num_shards,
                                      device=self.device)
        if config.dense.dtype == "pq" and store.pq_codes is not None:
            # build-time PQ artifacts: loads skip k-means
            ivf = store.ivf_index() if config.dense.use_ivf else None
            if ivf is not None:
                self.index = ShardedIndex.from_pq_ivf(
                    ivf, store.pq_codebooks, self.mesh,
                    rotation=store.pq_rotation,
                )
            else:
                self.index = ShardedIndex.from_pq(
                    store.pq_codes, store.pq_codebooks, self.mesh,
                    rotation=store.pq_rotation,
                )
        else:
            if config.dense.dtype == "pq":
                logger.warning(
                    "dense.dtype='pq' but the store has no persisted PQ "
                    "artifacts — falling back to boot-time k-means over "
                    "all %d embeddings, which can add a long cold start "
                    "on large corpora. Rebuild with `build --pq-m %d` "
                    "to persist the codebooks.",
                    store.n_docs, config.dense.pq_m,
                )
            self.index = ShardedIndex.from_embeddings(
                store.embeddings, self.mesh, dtype=config.dense.dtype,
                pq_m=config.dense.pq_m,
            )

    # -- native batched API -------------------------------------------------

    def enable_request_coalescing(
        self, window_s: float = 0.003, max_batch: int = 64
    ):
        """Route concurrent ``search_batch`` calls (e.g. parallel HTTP
        requests, each on its own worker thread) through a shared
        micro-batch window: one device dispatch serves them all
        (server/batching.py). Returns the coalescer for observability.
        """
        from legal_rag_tpu_torch.server.batching import RequestCoalescer

        self._coalescer = RequestCoalescer(
            self._search_batch_impl, window_s=window_s, max_batch=max_batch
        )
        return self._coalescer

    def search_batch(
        self,
        queries: Sequence[str],
        k: Optional[int] = None,
        hybrid_weights: Optional[Sequence[float]] = None,
        mode: Optional[str] = None,
    ) -> List[List[SearchResult]]:
        """Hybrid search for a whole query batch in one device program
        (coalesced with concurrent callers when enabled)."""
        cfg = self.config
        k = k or cfg.k
        mode = mode or cfg.fusion.mode
        if hybrid_weights is None:
            hybrid_weights = [cfg.fusion.hybrid_weight] * len(queries)
        coalescer = getattr(self, "_coalescer", None)
        if coalescer is not None:
            return coalescer.submit(queries, k, hybrid_weights, mode)
        return self._search_batch_impl(
            queries, k=k, hybrid_weights=hybrid_weights, mode=mode
        )

    def _search_batch_impl(
        self,
        queries: Sequence[str],
        k: int,
        hybrid_weights: Sequence[float],
        mode: str,
    ) -> List[List[SearchResult]]:
        self.device_dispatches = getattr(self, "device_dispatches", 0) + 1
        cfg = self.config
        n_real = len(queries)
        # the int8/pq tiers recover exactness by rescoring an oversampled
        # candidate set in fp32 after the device pass (weighted mode
        # only: RRF is rank-based over both lists)
        rescore = (
            cfg.dense.dtype in ("int8", "pq")
            and cfg.dense.int8_rescore
            and mode == "weighted"
        )
        oversample = (
            cfg.dense.pq_oversample
            if cfg.dense.dtype == "pq"
            else cfg.dense.int8_oversample
        )
        k_dev = (
            min(max(k * oversample, k), self.store.n_docs)
            if rescore
            else k
        )

        # Bucket the query count to a power of two (min 8), as the JAX
        # engine does, so both run the same shapes.
        q_pad = _pad_pow2(n_real)
        queries = list(queries) + [""] * (q_pad - n_real)
        hybrid_weights = list(hybrid_weights) + [0.0] * (q_pad - n_real)

        if mode in ("maxsim", "maxsim-rerank"):
            # late interaction over the [N, Td, D] token slab, no sparse
            # side: "maxsim" scans the whole slab; "maxsim-rerank" runs
            # the single-vector dense stage first and late-interacts its
            # top-C candidates only
            mv = self.mv_index     # raises early when artifacts are absent
            with self.timer.stage("encode"):
                q_tok, q_mask, q_emb = self._encode_query_tokens(queries)
            with self.timer.stage("device_search"):
                if mode == "maxsim":
                    s, i = mv.search(q_tok, q_mask, k, block_n=scan_block_n(
                        *q_mask.shape, mv.doc_tokens.shape[1]))
                else:
                    s, i = mv.rerank_search(
                        self.index, q_emb, q_tok, q_mask, k,
                        c=max(cfg.fusion.candidate_multiplier * k, k),
                    )
                scores, ids = s.cpu().numpy(), i.cpu().numpy()
            sem, key = scores, np.zeros_like(scores)
            return self._assemble_results(n_real, k, scores, ids, sem, key)

        with self.timer.stage("encode"):
            q_emb = self.encoder.encode(queries)
        # OPQ: the device pass scores in the rotated space; the fp32
        # rescore stays in the original space
        q_dev = q_emb
        if self.index.pq_rotation is not None:
            q_dev = np.asarray(q_emb, np.float32) @ self.index.pq_rotation
        with self.timer.stage("postings"):
            budget = _pad_pow2(
                self.store.bm25.postings_budget(
                    queries, cap=cfg.bm25.postings_budget_cap
                )
            )
            post_ids, post_w = self.store.bm25.gather_postings(queries, budget)
        with self.timer.stage("device_search"):
            dev = self.device
            idx = self.index
            scores, ids, sem, key = sharded_hybrid_search(
                idx.docs,
                torch.from_numpy(post_ids).to(dev),
                torch.from_numpy(post_w).to(dev),
                torch.from_numpy(np.ascontiguousarray(q_dev)).to(dev),
                torch.tensor(hybrid_weights, dtype=torch.float32, device=dev),
                idx.doc_scales,
                idx.pq_codebooks,
                idx.ivf_centroids,
                idx.ivf_doc_ids,
                mesh=self.mesh,
                k=k_dev,
                c=max(cfg.fusion.candidate_multiplier * k_dev, k_dev),
                n_docs=self.store.n_docs,
                mode=mode,
                rrf_k=cfg.fusion.rrf_k,
                ivf_probes=cfg.dense.ivf_probes,
                ivf_cell_size=idx.ivf_cell_size,
                n_queries=n_real,
            )
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            sem, key = sem.cpu().numpy(), key.cpu().numpy()
        if rescore:
            with self.timer.stage("int8_rescore"):
                # narrow to the exact dense top-C pool first, so the
                # fusion (dense candidates only) matches the fp32 engine
                scores, ids, sem, key = exact_rescore(
                    np.asarray(q_emb),
                    ids,
                    self.store.embeddings,
                    keyword=key,
                    weights=np.asarray(hybrid_weights, dtype=np.float32),
                    k=k,
                    dense_candidates=max(
                        cfg.fusion.candidate_multiplier * k, k
                    ),
                )
        return self._assemble_results(n_real, k, scores, ids, sem, key)

    def _assemble_results(
        self, n_real, k, scores, ids, sem, key
    ) -> List[List[SearchResult]]:
        out: List[List[SearchResult]] = []
        k = min(k, ids.shape[1])
        for qi in range(n_real):
            row = []
            for j in range(k):
                doc = int(ids[qi, j])
                if doc < 0 or doc >= self.store.n_docs:
                    continue
                if not np.isfinite(scores[qi, j]):
                    continue
                row.append(
                    SearchResult(
                        chunk=self.store.chunks[doc],
                        score=float(scores[qi, j]),
                        semantic=float(sem[qi, j]),
                        keyword=float(key[qi, j]),
                        doc_id=doc,
                    )
                )
            out.append(row)
        return out

    # -- late-interaction (multi-vector) tier --------------------------------

    @property
    def mv_index(self) -> ShardedMultiVectorIndex:
        """The token slab on the engine's device, uploaded on first use
        (it is Td times the embedding matrix; only maxsim callers pay)."""
        if self.store.mv_tokens is None:
            raise ValueError(
                "store has no multi-vector artifacts; rebuild with "
                "`build --multi-vector <token_budget>`"
            )
        mv = getattr(self, "_mv_index", None)
        if mv is None:
            # the dense tier's row padding, so a candidate id names the
            # same row in both; only for the float tiers that
            # rerank_search accepts (a quantized tier's rows are codes,
            # IVF-reordered and padded to whole cells)
            n_pad = None
            if self.index.docs.dtype in (torch.float32, torch.bfloat16):
                n_pad = int(self.index.docs.shape[0])
            mv = ShardedMultiVectorIndex.from_arrays(
                self.store.mv_tokens, self.store.mv_mask, self.mesh,
                n_pad=n_pad,
            )
            self._mv_index = mv
        return mv

    def _encode_query_tokens(self, queries: Sequence[str]):
        """The query's token embeddings (the slab's encoder and token
        budget) and, from the same forward, its pooled sentence
        embedding for maxsim-rerank's dense stage. The pooled view
        means over the Td-truncated tokens, so for a query longer than
        Td it differs slightly from ``SentenceEncoder.encode``'s, as in
        the JAX engine. Returns ``(tokens [Q, Tq, D], mask [Q, Tq] numpy,
        pooled [Q, D])``, the tensors on the engine's device."""
        td = int(self.store.mv_tokens.shape[1])
        ids, am = self.encoder.fast_tokenizer.encode_batch(
            list(queries), max_len=min(self.encoder.cfg.max_len, td)
        )
        dev = self.device
        with torch.inference_mode():
            q_tok, q_emb = minilm_token_and_pooled(
                self.encoder.model, torch.from_numpy(ids).to(dev),
                torch.from_numpy(am).to(dev),
            )
        return q_tok, am, q_emb

    # -- reference-compatible API --------------------------------------------

    def search(
        self, query: str, k: int = 5, hybrid_weight: float = 0.5
    ) -> List[Dict]:
        """Single-query compatibility wrapper (reference
        retrieval_engine.py:59 contract)."""
        results = self.search_batch(
            [query], k=k, hybrid_weights=[hybrid_weight], mode="weighted"
        )[0]
        return [r.to_dict() for r in results]
