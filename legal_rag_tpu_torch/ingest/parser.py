"""Stateful legal-markdown chunker.

Re-implements, from observed behavior, the chunking semantics of the
reference ingest stage (reference ingest_legal_docs.py:31-245) so that
parsing the same corpus yields byte-identical chunks — the parity gate
of SURVEY.md §7 stage 1. The architecture differs: instead of one long
``parse_line`` method, each structural construct is a *rule* — a
predicate over the line plus a context transition — evaluated in a
fixed pipeline; this keeps every reference subtlety (rules that consume
the line vs. fall through, matches computed but only applied for some
laws) explicit and individually testable.

Grammar recognized (one rule each):

- ``---`` separators and ``## N | Page`` PDF artifacts: flush only.
- ``# PART II`` / ``## PART-II``: part context.
- ``# CHAPTER III``: chapter context; resets chapter_title/section/
  sub_section/mode.
- ``## Section 14 — Title``: section context (BNS/BNSS/BSA).
- ``## 2. DEFINITIONS``: clause context — applied only for NALSA, but
  *recognized* for all laws (which suppresses the chapter-title rule;
  the reference shares this quirk, ingest_legal_docs.py:157-182).
- ``## **SOP ON ...**``: SOP topic -> chapter_title + sop mode.
- ``## ALL CAPS TITLE`` while inside a chapter: chapter_title.
- ``**01. Step — Suggested ...**`` / ``**Step 1:**``: SOP steps.
- ``**(1)**`` sub-section markers: set context, *keep* the line.
- short ``Illustration`` lines / ``**Explanation.—`` prefixes: modes
  (explanation lines stay in the buffer, illustration lines don't).
- ``| ... |`` table rows: one chunk per row, skipping separator and
  header rows.

Each flushed chunk carries a synthesized canonical header (law, part,
chapter – title, Section N – title, detail line) prepended to its text,
full context metadata, a ``unit_type``, and — new in this framework — a
stable ``section_id`` (e.g. ``BNSS_183``, ``NALSA_C5``, ``GSOP_004``)
that the source-fetching API addresses verbatim content by.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional


@dataclasses.dataclass
class UnitContext:
    """Hierarchical position within a statute/SOP document."""

    law: Optional[str] = None
    law_name: Optional[str] = None
    year: Optional[int] = None
    doc_type: Optional[str] = None
    part: Optional[str] = None
    chapter: Optional[str] = None
    chapter_title: Optional[str] = None
    section: Optional[str] = None
    section_title: Optional[str] = None
    clause: Optional[str] = None
    clause_title: Optional[str] = None
    sub_section: Optional[str] = None
    step: Optional[str] = None
    mode: str = "normal"  # normal | illustration | explanation | table | sop | step
    source_file: Optional[str] = None


@dataclasses.dataclass
class LegalChunk:
    """One retrievable unit. ``to_reference_dict`` emits exactly the
    reference's artifact shape (text/metadata/canonical_header) so
    parity can be diffed against legal_chunks.json; ``section_id`` and
    ``char_span`` are framework additions kept out of that view."""

    text: str
    metadata: Dict
    canonical_header: str
    section_id: Optional[str] = None
    topic_ordinal: Optional[int] = None   # SOP topic index within file

    def to_reference_dict(self) -> Dict:
        return {
            "text": self.text,
            "metadata": self.metadata,
            "canonical_header": self.canonical_header,
        }


# Line-classification patterns (each compiled once; ordering matters and
# mirrors the precedence the corpus relies on).
_PAGE_CHUNK = re.compile(r"^\|?\s*\d+\s*\|\s*Page\s*\|?$", re.I)
_PAGE_LINE = re.compile(r"^##\s+\d+\s+\|\s+Page", re.I)
_PART = re.compile(r"^(?:#|##)\s+(PART\s?[-–\s]?\s?[IVXLC]+.*)", re.I)
_CHAPTER = re.compile(r"^(?:#|##)\s+(CHAPTER\s+[IVXLC]+.*)", re.I)
_SECTION = re.compile(r"^##\s+Section\s+(\d+[A-Z]*)\s*[—\-]\s*(.*)", re.I)
_NUMBERED_CLAUSE = re.compile(r"^##\s+(\d+)\.\s*(.*)")
_SOP_TOPIC = re.compile(r"^##\s+\*\*(SOP\s+ON\s+.*)\*\*", re.I)
_H2_NON_NUMERIC = re.compile(r"^##\s+[^0-9]+")
_H2_TEXT = re.compile(r"^##\s+(.*)")
_NUMBERED_STEP = re.compile(r"^\*\*(\d+)\.\s*(.*?)(?:\s*[—\-]\s*Suggested.*?)?\*\*")
_LABELLED_STEP = re.compile(r"^\*\*(Step\s+\d+):\*\*")
_SUB_SECTION = re.compile(r"^(?:\*\*|\s)*\((\d+[a-z]?)\)(?:\*\*|\s)*")
_ILLUSTRATION = re.compile(r"Illustration(s)?(\.|:)?", re.I)
_TABLE_SEPARATOR = re.compile(r"^[\|\-\s]+$")

# Addressable-block boundary inside a General-SOP topic: an UNNUMBERED
# "### Heading" line (numbered "### 1. ..." subsections are enumeration
# items of their parent and stay inside its block; "####" deeper
# headings also stay inside). This is the granularity the ghost
# source-fetcher spec addresses — e.g. GSOP_004 is the
# "FIR Issuance & Jurisdiction" block of the RECEIPT OF COMPLAINT
# topic (reference tests/test_source_fetcher.py:20-27,81-88).
_SOP_BLOCK_BOUNDARY = re.compile(r"^###\s+(?!#|\d+\.)\s*(.+?)\s*$")


def split_sop_blocks(body: str):
    """Split a General-SOP chunk body into its addressable blocks.

    Returns ``[(heading_or_None, block_text), ...]`` in order; the text
    before the first unnumbered ``###`` heading (the topic intro) is
    block 0 with heading ``None``. Headings keep their title text
    (markdown markers stripped) for procedural-stage metadata.
    """
    blocks = []
    cur_head = None
    cur_lines: List[str] = []
    for line in body.split("\n"):
        m = _SOP_BLOCK_BOUNDARY.match(line.strip())
        if m:
            text = "\n".join(cur_lines).strip()
            if text or cur_head is not None:
                blocks.append((cur_head, text))
            cur_head = m.group(1).strip().strip("*").strip()
            cur_lines = [line]
            continue
        cur_lines.append(line)
    text = "\n".join(cur_lines).strip()
    if text or cur_head is not None:
        blocks.append((cur_head, text))
    return blocks or [(None, body.strip())]


class LegalMarkdownParser:
    """Consumes markdown line streams, emits :class:`LegalChunk` lists."""

    def __init__(self) -> None:
        self.ctx = UnitContext()
        self.chunks: List[LegalChunk] = []
        self._buffer: List[str] = []
        self._topic_ordinal = 0
        # next free General-SOP block id; each chunk consumes one id per
        # addressable block it contains (see split_sop_blocks)
        self._gsop_next = 0

    # -- chunk emission ----------------------------------------------------

    def _header_lines(self) -> List[str]:
        ctx = self.ctx
        lines: List[str] = []
        if ctx.law_name:
            lines.append(
                f"{ctx.law_name}, {ctx.year}" if ctx.year else ctx.law_name
            )
        if ctx.part:
            lines.append(ctx.part)
        if ctx.chapter:
            lines.append(
                f"{ctx.chapter} – {ctx.chapter_title}"
                if ctx.chapter_title
                else ctx.chapter
            )
        if ctx.section:
            lines.append(
                f"Section {ctx.section} – {ctx.section_title}"
                if ctx.section_title
                else f"Section {ctx.section}"
            )
        elif ctx.clause:
            lines.append(
                f"Clause {ctx.clause} – {ctx.clause_title}"
                if ctx.clause_title
                else f"Clause {ctx.clause}"
            )
        detail: List[str] = []
        if ctx.sub_section:
            detail.append(f"Sub-section ({ctx.sub_section})")
        if ctx.mode == "illustration":
            detail.append("Illustration")
        elif ctx.mode == "explanation":
            detail.append("Explanation")
        elif ctx.mode in ("sop", "step") and ctx.step:
            detail.append(ctx.step)
        if detail:
            lines.append(" / ".join(detail))
        return lines

    def _unit_type(self) -> str:
        ctx = self.ctx
        if ctx.mode == "illustration":
            return "illustration"
        if ctx.mode == "explanation":
            return "explanation"
        if ctx.mode == "table":
            return "table_row"
        if ctx.step:
            return "step"
        if ctx.sub_section:
            return "sub_section"
        if ctx.section:
            return "section"
        if ctx.clause:
            return "clause"
        return "general"

    def _section_id(self, body: str) -> Optional[str]:
        """Stable addressable ID (framework addition, spec'd by the
        reference's ghost source-fetcher tests — SURVEY.md §2.4).

        General-SOP ids are 0-based over addressable BLOCKS, not
        topics: a chunk's id is its first block's, and the counter
        advances by the chunk's block count, so the source fetcher can
        recover every block id from (chunk id, block index). This is
        the numbering under which the reference spec's GSOP_003 /
        GSOP_004 land on the Classification-of-Content and
        FIR-Issuance blocks (tests/test_source_fetcher.py:20-27,81-88).
        """
        ctx = self.ctx
        if ctx.law in ("BNS", "BNSS", "BSA") and ctx.section:
            return f"{ctx.law}_{ctx.section}"
        if ctx.law == "NALSA":
            if ctx.clause:
                return f"NALSA_C{ctx.clause}"
            if ctx.source_file and ctx.source_file.startswith("nalsa_table"):
                return "NALSA_SCHEDULE"  # compensation schedule rows
        if ctx.law == "SOP":
            if ctx.source_file and ctx.source_file.startswith("General"):
                sid = f"GSOP_{self._gsop_next:03d}"
                self._gsop_next += len(split_sop_blocks(body))
                return sid
            elif ctx.step:
                digits = re.sub(r"\D", "", ctx.step)
                if digits:
                    return f"RSOP_{int(digits):03d}"
        return None

    def _flush(self) -> None:
        if not self._buffer:
            return
        body = "\n".join(self._buffer).strip()
        self._buffer = []
        if not body or _PAGE_CHUNK.match(body):
            return
        header = "\n".join(self._header_lines())
        meta = dataclasses.asdict(self.ctx)
        meta["unit_type"] = self._unit_type()
        self.chunks.append(
            LegalChunk(
                text=f"{header}\n\n{body}",
                metadata=meta,
                canonical_header=header,
                section_id=self._section_id(body),
                topic_ordinal=self._topic_ordinal or None,
            )
        )

    # -- the rule pipeline -------------------------------------------------

    def feed(self, line: str) -> None:
        """Classify one raw line (newline included) and update state."""
        ctx = self.ctx
        stripped = line.strip()

        if stripped == "---" or _PAGE_LINE.match(stripped):
            self._flush()
            return

        m = _PART.match(stripped)
        if m:
            self._flush()
            ctx.part = m.group(1).strip()
            return

        m = _CHAPTER.match(stripped)
        if m:
            self._flush()
            ctx.chapter = m.group(1).strip()
            ctx.chapter_title = None
            ctx.section = None
            ctx.sub_section = None
            ctx.mode = "normal"
            return

        # These three are *recognized* unconditionally so the
        # chapter-title rule below stays suppressed for numbered "##"
        # headings even outside NALSA (corpus-relied-upon precedence).
        section_m = _SECTION.match(stripped)
        clause_m = _NUMBERED_CLAUSE.match(stripped)
        topic_m = _SOP_TOPIC.match(stripped)

        if section_m:
            self._flush()
            ctx.section = section_m.group(1).strip()
            ctx.section_title = section_m.group(2).strip()
            ctx.sub_section = None
            ctx.clause = None
            ctx.step = None
            ctx.mode = "normal"
            return

        if clause_m and ctx.law == "NALSA":
            self._flush()
            ctx.clause = clause_m.group(1).strip()
            ctx.clause_title = clause_m.group(2).strip()
            ctx.section = None
            ctx.sub_section = None
            ctx.mode = "normal"
            return

        if topic_m:
            self._flush()
            ctx.chapter_title = topic_m.group(1).strip()
            ctx.mode = "sop"
            self._topic_ordinal += 1
            return

        if (
            ctx.chapter
            and not (section_m or clause_m or topic_m)
            and _H2_NON_NUMERIC.match(stripped)
        ):
            m = _H2_TEXT.match(stripped)
            if m:
                ctx.chapter_title = m.group(1).strip()
                return

        m = _NUMBERED_STEP.match(stripped)
        if m:
            self._flush()
            ctx.step = f"Step {m.group(1)}"
            ctx.section_title = m.group(2).strip()
            ctx.mode = "step"
            return

        m = _LABELLED_STEP.match(stripped)
        if m:
            self._flush()
            ctx.step = m.group(1)
            ctx.mode = "step"
            return

        m = _SUB_SECTION.match(stripped)
        if m:
            # Context switch only — the marker line carries the body
            # text, so it falls through into the (fresh) buffer.
            self._flush()
            ctx.sub_section = m.group(1)
            ctx.mode = "normal"

        if _ILLUSTRATION.search(stripped) and len(stripped) < 30:
            self._flush()
            ctx.mode = "illustration"
            return

        if "Explanation" in stripped and (
            stripped.startswith("**Explanation")
            or stripped.startswith("*Explanation")
            or "Explanation.—" in stripped
        ):
            # Mode switch that KEEPS the line (it opens the new chunk).
            self._flush()
            ctx.mode = "explanation"

        if (
            stripped.startswith("|")
            and not _TABLE_SEPARATOR.match(stripped)
            and "Particulars" not in stripped
        ):
            if ctx.mode != "table":
                self._flush()
                ctx.mode = "table"
            self._buffer.append(stripped)
            self._flush()  # one chunk per table row
            return

        if stripped:
            self._buffer.append(line)

    # -- file driver -------------------------------------------------------

    def parse_file(self, path, overrides: Optional[Dict] = None) -> None:
        """Parse one document with a fresh context (plus overrides)."""
        path = Path(path)
        self.ctx = UnitContext(source_file=path.name)
        self._topic_ordinal = 0
        self._gsop_next = 0
        for key, value in (overrides or {}).items():
            setattr(self.ctx, key, value)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                self.feed(line)
        self._flush()
