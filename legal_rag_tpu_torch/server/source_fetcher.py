"""Verbatim source fetching by stable section id.

Spec: reference tests/test_source_fetcher.py (ghost module,
SURVEY.md §2.4) — the /rag/source capability: given (SourceType,
section id) return the EXACT source text with metadata and optional
highlight offsets, no LLM anywhere. ID normalization accepts
"183", "Section 183", "BNSS Section 183", "§183", case-insensitive
GSOP ids.

Content comes from the ingest layer's chunks (which carry the stable
``section_id`` this framework's parser assigns); a catalog groups them
per addressable unit and concatenates verbatim bodies.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Sequence

from legal_rag_tpu_torch.server.schemas import Highlight, SourceResponse, SourceType

_LAW_FOR_TYPE = {
    SourceType.BNS: "BNS",
    SourceType.BNSS: "BNSS",
    SourceType.BSA: "BSA",
}

_STAGE_RULES = (
    ("reporting", ("petition", "complaint", "fir", "information")),
    ("investigation", ("investigation", "search", "seizure", "evidence",
                       "witness", "examination")),
    ("arrest", ("arrest", "custody", "handcuff")),
    ("medical", ("medical",)),
    ("property", ("property", "attachment")),
)


def _procedural_stage(title: str) -> str:
    t = title.lower()
    for stage, needles in _STAGE_RULES:
        if any(n in t for n in needles):
            return stage
    return "procedure"


def _body(chunk_text: str, header: str) -> str:
    """Chunk text minus its canonical header prefix."""
    if header and chunk_text.startswith(header):
        return chunk_text[len(header):].lstrip("\n")
    return chunk_text


_GSOP_ID = re.compile(r"^GSOP_(\d+)$")


class SourceCatalog:
    """Groups ingest chunks into addressable verbatim units.

    General-SOP chunks are registered at BLOCK granularity: the ingest
    parser assigns each chunk the id of its first addressable block and
    reserves one id per block (``split_sop_blocks``), so the catalog
    recovers every block id as ``base + index``. Block text is the
    chunk body verbatim — original markdown (####, bullets, bold)
    included — matching the ghost spec's verbatim-content requirement
    (reference tests/test_source_fetcher.py:81-88)."""

    def __init__(self, chunks: Sequence[Dict]):
        from legal_rag_tpu_torch.ingest.parser import split_sop_blocks

        self._units: Dict[str, Dict] = {}
        for chunk in chunks:
            sid = chunk.get("section_id")
            if not sid:
                continue
            meta = chunk.get("metadata", {})
            body = _body(chunk["text"], chunk.get("canonical_header", ""))
            m = _GSOP_ID.match(sid)
            if m and str(meta.get("source_file") or "").startswith("General"):
                base = int(m.group(1))
                for i, (head, text) in enumerate(split_sop_blocks(body)):
                    self._units[f"GSOP_{base + i:03d}"] = {
                        "bodies": [text],
                        "law": meta.get("law"),
                        "chapter": meta.get("chapter"),
                        "block_title": head,
                        "chapter_title": meta.get("chapter_title"),
                        "section_title": meta.get("section_title"),
                    }
                continue
            unit = self._units.setdefault(
                sid,
                {
                    "bodies": [],
                    "law": meta.get("law"),
                    "chapter": meta.get("chapter"),
                    "chapter_title": meta.get("chapter_title"),
                    "section_title": meta.get("section_title"),
                },
            )
            unit["bodies"].append(body)

    def lookup(self, sid: str) -> Optional[Dict]:
        return self._units.get(sid)

    def content(self, sid: str) -> Optional[str]:
        unit = self._units.get(sid)
        if unit is None:
            return None
        return "\n\n".join(unit["bodies"])


# -- default catalog (lazy, thread-safe) -------------------------------------

_default_catalog: Optional[SourceCatalog] = None
_catalog_lock = threading.Lock()


def set_default_catalog(chunks: Sequence[Dict]) -> None:
    """Install the serving store's chunks as the fetch source."""
    global _default_catalog
    with _catalog_lock:
        _default_catalog = SourceCatalog(chunks)


def _get_catalog() -> Optional[SourceCatalog]:
    """Lazy default: the serving store's chunks (LEGAL_RAG_STORE), or a
    corpus directory (LEGAL_RAG_DOCS) — never a hardcoded path. Callers
    that own a store should call :func:`set_default_catalog` instead."""
    global _default_catalog
    with _catalog_lock:
        if _default_catalog is None:
            import json
            import os
            from pathlib import Path

            store_dir = os.environ.get("LEGAL_RAG_STORE")
            docs_dir = os.environ.get("LEGAL_RAG_DOCS")
            if store_dir and (Path(store_dir) / "chunks.json").exists():
                with open(
                    Path(store_dir) / "chunks.json", encoding="utf-8"
                ) as f:
                    _default_catalog = SourceCatalog(json.load(f))
            elif docs_dir and Path(docs_dir).exists():
                from legal_rag_tpu_torch.ingest import parse_corpus

                chunks = []
                for c in parse_corpus(docs_dir):
                    d = c.to_reference_dict()
                    d["section_id"] = c.section_id
                    chunks.append(d)
                _default_catalog = SourceCatalog(chunks)
        return _default_catalog


# -- id normalization --------------------------------------------------------


def normalize_section_id(source_type: SourceType, raw: str) -> Optional[str]:
    """Map user-facing id spellings onto catalog keys."""
    s = (raw or "").strip()
    if not s:
        return None
    if source_type == SourceType.GENERAL_SOP:
        m = re.search(r"gsop[_\s\-]*(\d+)", s, re.I)
        return f"GSOP_{int(m.group(1)):03d}" if m else None
    if source_type == SourceType.RAPE_SOP:
        m = re.search(r"(?:rsop[_\s\-]*|step\s*)?(\d+)", s, re.I)
        return f"RSOP_{int(m.group(1)):03d}" if m else None
    if source_type == SourceType.NALSA:
        if "schedule" in s.lower():
            return "NALSA_SCHEDULE"  # compensation schedule rows
        m = re.search(r"(\d+)", s)
        return f"NALSA_C{m.group(1)}" if m else None
    law = _LAW_FOR_TYPE.get(source_type)
    if law is None:
        return None
    # "183" / "Section 183" / "BNSS Section 183" / "§183" / "BNSS_183"
    m = re.search(
        rf"(?:{law}[\s_\-]*)?(?:section\s+|§\s*)?(\d+[A-Za-z]?)\s*$",
        s,
        re.I,
    )
    return f"{law}_{m.group(1).upper()}" if m else None


def _compute_highlights(content: str, snippet: Optional[str]) -> List[Highlight]:
    """Exact-first offset computation: the raw snippet (minus a
    truncation ``...`` suffix) is searched verbatim BEFORE any
    whitespace stripping, so offsets are exact even when the snippet
    starts or ends mid-whitespace (reference
    tests/test_source_fetcher.py:110-151 pins start==50/end==150 for
    ``content[50:150]``; a strip-first search was off by one)."""
    if not snippet:
        return []
    probe = snippet
    if probe.rstrip().endswith("..."):
        probe = probe.rstrip()[:-3]
    if not probe.strip():
        return []
    for candidate in (probe, probe.strip()):
        idx = content.find(candidate)
        if idx < 0:
            idx = content.lower().find(candidate.lower())
        if idx >= 0:
            return [Highlight(start=idx, end=idx + len(candidate))]
    return []


def fetch_source_content(
    source_type: SourceType,
    section_id: str,
    highlight_snippet: Optional[str] = None,
    catalog: Optional[SourceCatalog] = None,
) -> Optional[SourceResponse]:
    """Fetch verbatim source content; None when the id doesn't resolve."""
    catalog = catalog or _get_catalog()
    if catalog is None:
        return None
    sid = normalize_section_id(source_type, section_id)
    if sid is None:
        return None
    unit = catalog.lookup(sid)
    if unit is None:
        return None
    content = catalog.content(sid) or ""

    metadata: Dict[str, object] = {"law": unit.get("law")}
    if source_type in (SourceType.GENERAL_SOP, SourceType.RAPE_SOP):
        title = (
            unit.get("block_title")
            or unit.get("chapter_title")
            or unit.get("section_title")
            or ""
        )
        metadata["title"] = title
        metadata["procedural_stage"] = _procedural_stage(title)
    else:
        metadata["chapter_no"] = unit.get("chapter")
        metadata["chapter_title"] = unit.get("chapter_title")
        metadata["section_title"] = unit.get("section_title")

    return SourceResponse(
        source_type=source_type,
        section_id=sid,
        content=content,
        metadata=metadata,
        highlights=_compute_highlights(content, highlight_snippet),
    )
