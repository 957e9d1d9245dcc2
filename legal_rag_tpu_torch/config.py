"""Typed configuration for the whole framework.

The reference scatters magic numbers inline (k=5, 2k dense candidates,
hybrid weights 0.5/0.6, encode batch 64, source limit 4 — see
reference retrieval_engine.py:59-96, orchestrator.py:29-57,
create_vector_store.py:42, responder.py:135). Here they live in one
dataclass tree so kernels, sharding, and serving agree on shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    """Dense (semantic) search configuration."""

    dim: int = 384                  # MiniLM embedding dim
    dtype: str = "float32"          # doc matrix storage tier:
                                    # float32 | bfloat16 | int8 | pq
    block_n: int = 1024             # Pallas: docs per grid step
    block_q: int = 8                # Pallas: queries per grid step (fp32 sublane)
    use_pallas: bool = True  # permit Pallas paths where measured to win
                             # (dense top-C always rides XLA since the
                             # r2 shootout; see parallel/sharded.py)
    int8_rescore: bool = True       # exact fp32 rescore of int8/pq candidates
    int8_oversample: int = 4        # candidate oversampling factor for the
                                    # int8 tier's rescore (mild quantization)
    pq_oversample: int = 64         # candidate oversampling for the pq tier:
                                    # PQ(m=48) ADC distortion on a clustered
                                    # 1M corpus needs 64x to restore
                                    # post-rescore recall@10 to 1.00 flat /
                                    # 0.958 ivf512 (EVAL_IVF_RECOVERY.json;
                                    # 4x leaves it at 0.37)
    pq_m: int = 48                  # PQ packed bytes/doc when dtype="pq"
                                    # (2*pq_m nibble subspaces; dim must
                                    # divide by 2*pq_m)
    ivf_probes: int = 64            # cells scanned per shard when the
                                    # store carries IVF artifacts
                                    # (build --ivf-cell-size); an o(N)
                                    # read instead of the flat scan.
                                    # Measured recovery contract at 1M
                                    # clustered docs (EVAL_IVF_RECOVERY
                                    # .json): probes=512 with
                                    # pq_oversample=64 holds
                                    # post-rescore recall@10 >= 0.95;
                                    # the 64-probe default suits small/
                                    # well-separated corpora — raise to
                                    # 512 at 1M+ clustered scale
    use_ivf: bool = True            # permit IVF pruning when artifacts
                                    # exist (False = flat PQ scan)


@dataclasses.dataclass(frozen=True)
class BM25Config:
    """Okapi BM25 parameters — defaults match rank_bm25.BM25Okapi so the
    parity tests can pin scores exactly (reference create_vector_store.py:60)."""

    k1: float = 1.5
    b: float = 0.75
    epsilon: float = 0.25           # negative-IDF floor factor
    max_query_terms: int = 32       # static pad for query term ids
    postings_budget_cap: Optional[int] = 1 << 17
    # Upper bound on the per-query postings buffer (131,072 postings ≈
    # 1 MB/query). Exact for any query on corpora up to ~100k docs; on
    # larger corpora a stopword-dense query overflows and degrades via
    # impact-ordered truncation (ops/sparse.py gather_postings) — the
    # measured recall effect at 1M docs is in BASELINE.md. None = uncapped.


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Hybrid fusion. `weighted` mode reproduces the reference semantics
    exactly (dense candidates only, score = sem*(1-w) + bm25n*w,
    reference retrieval_engine.py:71-96). `rrf` is the framework-native
    mode fusing both candidate lists by reciprocal rank.

    Default is `rrf` by measurement (EVAL_RETRIEVAL.json, serving
    store, n=1000/split bootstrap): RRF beats weighted on BOTH splits
    — structure r@10 0.975 vs 0.957, paraphrase 0.659 vs 0.636 — and
    the retrieval gate (EVAL_GATE.json) and E2E quality harness
    (quality_report.json) certify the RRF configuration. `weighted`
    remains available as the reference-parity mode; the single-query
    ``RetrievalEngine.search()`` compatibility wrapper always pins it.
    """

    mode: str = "rrf"               # rrf (measured default) | weighted
    hybrid_weight: float = 0.5
    procedural_weight: float = 0.6  # reference orchestrator.py:56
    rrf_k: int = 60
    candidate_multiplier: int = 2   # dense candidates = multiplier * k
    # CE blend for short heading-register queries (the reranker's
    # training distribution; models/cross_encoder.py ce_policy_alpha).
    # None disables the form policy — every query uses the store's
    # gate-fit ce_alpha. 0.5 is the measured policy row from
    # EVAL_CE_PARAPHRASE.json (TPU serving store, n=1000/split):
    # structure MRR +0.0412 [CI +0.0297, +0.0531] at heading_rate 0.59,
    # paraphrase untouched (heading_rate 0.00 — no 12-word span query
    # is heading-like, so those keep the conservative gate-fit alpha).
    ce_heading_alpha: "float | None" = 0.5
    # Round-5 fusion form policy (retrieval/query_form.py): queries in
    # narrative register (long + function-word/interrogative marker)
    # get a dense-leaning ranking; heading-register queries keep
    # `mode`. Measured per split with bootstrap CI95 in
    # EVAL_FUSION_POLICY.json (n=1042 structure / 2029 sibling, serving
    # store): "dense-union" (dense-first rank interleave with the
    # default-mode ranking) holds structure r@5/r@10 exactly at RRF's,
    # gives the best sibling MRR of any mode (0.497 vs dense 0.490 /
    # rrf 0.464), and keeps BM25-carried E2E groundings that the
    # pure-"dense" replacement lost (suite 2/10 -> 1/10, so replacement
    # was demoted to an opt-in). None disables the policy.
    narrative_mode: "str | None" = "dense-union"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """MiniLM (6-layer BERT) encoder, reference all-MiniLM-L6-v2."""

    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_len: int = 256              # MiniLM sequence window
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    encode_batch: int = 64          # ingest-time batch (reference :42)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Multi-chip layout: documents (dense rows + BM25 postings) are
    sharded along the `shard` mesh axis; query batches replicate."""

    mesh_axis: str = "shard"
    num_shards: Optional[int] = None   # None = every visible CUDA card


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    k: int = 5
    dense: DenseConfig = dataclasses.field(default_factory=DenseConfig)
    bm25: BM25Config = dataclasses.field(default_factory=BM25Config)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
    max_expanded_queries: int = 4   # 1 primary + 3 concept expansions


DEFAULT_CONFIG = RetrievalConfig()
