"""Multi-device execution: mesh helpers + sharded hybrid search."""

from legal_rag_tpu_torch.parallel.mesh import make_mesh
from legal_rag_tpu_torch.parallel.sharded import (
    ShardedIndex, sharded_hybrid_search,
)

__all__ = ["make_mesh", "ShardedIndex", "sharded_hybrid_search"]
