"""Device ops: dense top-k (kernels K1, K3, K4), PQ (K2), BM25 scoring,
fusion."""

from legal_rag_tpu_torch.ops.dense import (
    l2_normalize,
    dense_topk,
    dense_topk_matmul,
    dense_topk_fused,
    dense_topk_twophase,
    dense_topk_twophase_rm,
)

__all__ = [
    "l2_normalize",
    "dense_topk",
    "dense_topk_matmul",
    "dense_topk_fused",
    "dense_topk_twophase",
    "dense_topk_twophase_rm",
]
