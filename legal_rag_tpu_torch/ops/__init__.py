"""Device ops: dense top-k (kernels K1, K3, K4), PQ (K2), BM25 scoring,
MaxSim late interaction, fusion."""

from legal_rag_tpu_torch.ops.dense import (
    l2_normalize,
    dense_topk,
    dense_topk_matmul,
    dense_topk_fused,
    dense_topk_twophase,
    dense_topk_twophase_rm,
)
from legal_rag_tpu_torch.ops.sparse import (
    BM25Index,
    build_bm25,
    bm25_score_batch,
    bm25_topk,
)
from legal_rag_tpu_torch.ops.maxsim import (
    MultiVectorIndex,
    maxsim_topk,
)
from legal_rag_tpu_torch.ops.fusion import (
    weighted_fusion,
    rrf_fusion,
)

__all__ = [
    "l2_normalize",
    "dense_topk",
    "dense_topk_matmul",
    "dense_topk_fused",
    "dense_topk_twophase",
    "dense_topk_twophase_rm",
    "BM25Index",
    "build_bm25",
    "bm25_score_batch",
    "bm25_topk",
    "MultiVectorIndex",
    "maxsim_topk",
    "weighted_fusion",
    "rrf_fusion",
]
