"""Host-side ingest: legal markdown -> hierarchical chunks with stable IDs."""

from legal_rag_tpu_torch.ingest.parser import LegalChunk, UnitContext, LegalMarkdownParser
from legal_rag_tpu_torch.ingest.pipeline import parse_corpus, CORPUS_SPECS

__all__ = [
    "LegalChunk",
    "UnitContext",
    "LegalMarkdownParser",
    "parse_corpus",
    "CORPUS_SPECS",
]
