"""Corpus-level ingest driver.

Mirrors the reference's corpus traversal order exactly (reference
ingest_legal_docs.py:247-298): the three chapter-split statute
directories in sorted order, then the NALSA scheme, its compensation
schedule table, and the two SOPs — order matters because chunk ids are
positional and the index artifacts address documents by row.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from legal_rag_tpu_torch.ingest.parser import LegalChunk, LegalMarkdownParser

# (relative path, is_directory, context overrides)
CORPUS_SPECS: Sequence[Tuple[str, bool, Dict]] = (
    ("BNS", True, {
        "law": "BNS",
        "law_name": "Bharatiya Nyaya Sanhita",
        "year": 2023,
        "doc_type": "primary_legislation",
    }),
    ("BNSS", True, {
        "law": "BNSS",
        "law_name": "Bharatiya Nagarik Suraksha Sanhita",
        "year": 2023,
        "doc_type": "primary_legislation",
    }),
    ("BSA", True, {
        "law": "BSA",
        "law_name": "Bharatiya Sakshya Adhiniyam",
        "year": 2023,
        "doc_type": "primary_legislation",
    }),
    ("nalsa.md", False, {
        "law": "NALSA",
        "law_name": "NALSA Compensation Scheme",
        "year": 2018,
        "doc_type": "compensation_scheme",
    }),
    ("nalsa_table.md", False, {
        "law": "NALSA",
        "law_name": "NALSA Compensation Scheme",
        "year": 2018,
        "doc_type": "compensation_scheme",
        "chapter_title": "Schedule – Women Victims of Crimes",
    }),
    ("General SOP.md", False, {
        "law": "SOP",
        "law_name": "General SOP",
        "doc_type": "sop",
    }),
    ("sop_rape_against_women.md", False, {
        "law": "SOP",
        "law_name": "SOP on Rape Against Women",
        "doc_type": "sop",
    }),
)


def parse_corpus(
    docs_dir,
    specs: Sequence[Tuple[str, bool, Dict]] = CORPUS_SPECS,
) -> List[LegalChunk]:
    """Parse the full legal corpus rooted at ``docs_dir``.

    Missing entries are skipped (same tolerance as the reference), so a
    partial corpus still ingests.
    """
    docs_dir = Path(docs_dir)
    parser = LegalMarkdownParser()
    for rel, is_dir, overrides in specs:
        path = docs_dir / rel
        if not path.exists():
            continue
        if is_dir:
            for f in sorted(path.iterdir()):
                if f.name.endswith(".md"):
                    parser.parse_file(f, overrides)
        else:
            parser.parse_file(path, overrides)
    return parser.chunks


def generic_specs(docs_dir) -> List[Tuple[str, bool, Dict]]:
    """Corpus specs for an ARBITRARY markdown tree: every top-level
    ``*.md`` file and every subdirectory becomes a corpus entry whose
    law/label derives from its name. This generalizes the framework
    beyond the fixed legal corpus — any markdown knowledge base
    ingests, with the structural parser still extracting PART/CHAPTER/
    Section/step hierarchy where present."""
    docs_dir = Path(docs_dir)
    specs: List[Tuple[str, bool, Dict]] = []
    seen_laws: Dict[str, int] = {}
    for entry in sorted(docs_dir.iterdir()):
        label = entry.stem.replace("_", " ").strip()
        law = entry.stem.upper()[:16]
        # distinct sources must not merge under one truncated label
        count = seen_laws.get(law, 0)
        seen_laws[law] = count + 1
        if count:
            law = f"{law[:13]}_{count + 1}"
        overrides = {
            "law": law,
            "law_name": label.title(),
            "doc_type": "document",
        }
        if entry.is_dir():
            specs.append((entry.name, True, overrides))
        elif entry.name.endswith(".md"):
            specs.append((entry.name, False, overrides))
    return specs


def parse_any_corpus(docs_dir) -> List[LegalChunk]:
    """Parse a markdown tree with no predefined corpus layout."""
    return parse_corpus(docs_dir, specs=generic_specs(docs_dir))


def law_counts(chunks: Sequence[LegalChunk]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for c in chunks:
        law = c.metadata.get("law") or "Unknown"
        counts[law] = counts.get(law, 0) + 1
    return counts
