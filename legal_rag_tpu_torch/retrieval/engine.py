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

Where the JAX engine compiles one executable per bucket, this one
captures one CUDA graph per key (``utils/graphs.py``): the search's key
is its static arguments, ``(q_pad, budget, k_dev, c, mode, rrf_k,
dtype, ivf_probes, ivf_cell_size)``, the real query count an input, so
every batch of a bucket replays one graph. The engine's
:class:`~legal_rag_tpu_torch.utils.graphs.GraphSet` (``.graphs``) also
serves the query encoder's forward and, through the facade, the
cross-encoder's. It exists when every mesh position sits on the
engine's card in this process (S=1, or shards repeating that card);
on the CPU, or a mesh over several cards, the programs run op by op.

A dispatch gathers its BM25 postings on the host through
:func:`legal_rag_tpu_torch.ops.sparse.gather_postings_batch`, one C++
call a batch where the native library builds (``postings_gathers``
counts the calls by implementation, ``postings_truncated`` the queries
cut at the budget, ``postings_cut_ties`` those cut inside a group of
equal weights; :meth:`postings_counters` reads the three).

The engine's ``timer`` is the served path's one ``StageTimer`` (``/health``
and the benchmark read it): ``search`` around each ``search_batch`` call
as its caller waits for it, ``coalesce_wait`` (each coalesced call's
queue wait), ``encode``, ``postings``, ``device_search``,
``int8_rescore`` and ``assemble`` in a dispatch, ``postings_cut`` (the
cut's time inside ``postings``, in a dispatch that cut a query; measured
by the gather itself, so recorded with ``StageTimer.add``), ``graph_wait``
(the graph set's lock) and ``graph_fill`` (the inputs' staging) inside
the spans that replay; the facade adds
``request``, ``classify``, ``ce`` and ``respond``.

The late-interaction modes run over the store's token slab
(``mv_tokens.npy``, from ``build --multi-vector``), uploaded on first
use: ``"maxsim"`` scans the whole slab, ``"maxsim-rerank"`` rescores
the float dense tier's top-C candidates
(:class:`legal_rag_tpu_torch.parallel.sharded.ShardedMultiVectorIndex`).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.config import RetrievalConfig, DEFAULT_CONFIG
from legal_rag_tpu_torch.utils.timing import StageTimer, timed
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.wordpiece import WordPieceTokenizer
from legal_rag_tpu_torch.ops.dense import exact_rescore
from legal_rag_tpu_torch.ops.maxsim import (
    minilm_token_and_pooled, scan_block_n,
)
from legal_rag_tpu_torch.ops.sparse import gather_postings_batch
from legal_rag_tpu_torch.parallel.mesh import make_mesh
from legal_rag_tpu_torch.parallel.sharded import (
    ShardedIndex, ShardedMultiVectorIndex, sharded_hybrid_search,
)
from legal_rag_tpu_torch.utils.graphs import GraphSet, run_program

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
        # the served search's host postings gathers by implementation,
        # the queries they cut at the budget, and of those the queries
        # whose cut fell inside a group of equal weights (the tie rule of
        # ops.sparse.cut_by_weight decided what was kept)
        self.postings_gathers = {"native-cpp": 0, "python": 0}
        self.postings_truncated = 0
        self.postings_cut_ties = 0
        self._count_lock = threading.Lock()
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
        self.mesh = mesh or make_mesh(config.sharding.num_shards,
                                      device=self.device)
        self.graphs = self._graph_set()
        # the encoder's forward replays through the engine's graphs too
        encoder.graphs = self.graphs
        self.encoder = encoder
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

    def _graph_set(self) -> Optional[GraphSet]:
        """The engine's captured programs: on a card, when every mesh
        position lies on it in this process; else None (op by op)."""
        if self.device.type != "cuda" or self.mesh.multi_process:
            return None
        graphs = GraphSet(self.device, timer=self.timer)
        if any(d != graphs.device for d in self.mesh.devices.flat):
            return None
        return graphs

    def postings_counters(self) -> Dict:
        """The host postings gather's counters (``/health`` shows them):
        gathers by implementation, queries cut at the budget, and of
        those the queries cut inside a group of equal weights."""
        with self._count_lock:
            return {"gathers": dict(self.postings_gathers),
                    "truncated": self.postings_truncated,
                    "cut_ties": self.postings_cut_ties}

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
            self._search_batch_impl, window_s=window_s, max_batch=max_batch,
            stage_timer=self.timer,
        )
        return self._coalescer

    @timed("search")
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
            with self.timer.stage("assemble"):
                return self._assemble_results(n_real, k, scores, ids, sem,
                                              key)

        with self.timer.stage("encode"):
            q_emb = self.encoder.encode(queries)
        # OPQ: the device pass scores in the rotated space; the fp32
        # rescore stays in the original space
        q_dev = q_emb
        if self.index.pq_rotation is not None:
            q_dev = np.asarray(q_emb, np.float32) @ self.index.pq_rotation
        with self.timer.stage("postings"):
            post = gather_postings_batch(
                self.store.bm25, queries, cap=cfg.bm25.postings_budget_cap
            )
            if post.truncated:
                # measured inside the GIL-free call: no profiler range
                self.timer.add("postings_cut", post.cut_s)
        budget, post_ids, post_w = post.budget, post.ids, post.weights
        with self._count_lock:
            self.postings_gathers[post.impl] += 1
            self.postings_truncated += post.truncated
            self.postings_cut_ties += post.ties
        with self.timer.stage("device_search"):
            c = max(cfg.fusion.candidate_multiplier * k_dev, k_dev)
            idx = self.index
            program_key = (
                "search", q_pad, budget, k_dev, c, mode, cfg.fusion.rrf_k,
                str(idx.docs.dtype), cfg.dense.ivf_probes, idx.ivf_cell_size,
            )

            def search(post_ids, post_w, q_emb, weights, n_queries):
                return sharded_hybrid_search(
                    idx.docs, post_ids, post_w, q_emb, weights,
                    idx.doc_scales, idx.pq_codebooks, idx.ivf_centroids,
                    idx.ivf_doc_ids, mesh=self.mesh, k=k_dev, c=c,
                    n_docs=self.store.n_docs, mode=mode,
                    rrf_k=cfg.fusion.rrf_k, ivf_probes=cfg.dense.ivf_probes,
                    ivf_cell_size=idx.ivf_cell_size, n_queries=n_queries,
                )

            # every input whole, padded rows included: a replay reads
            # nothing a previous batch left behind
            scores, ids, sem, key = run_program(
                self.graphs, program_key, search, {
                    "post_ids": post_ids, "post_w": post_w,
                    "q_emb": np.ascontiguousarray(q_dev, np.float32),
                    "weights": np.asarray(hybrid_weights, np.float32),
                    "n_queries": np.asarray(n_real, np.int64),
                }, self.device)
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
        with self.timer.stage("assemble"):
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
