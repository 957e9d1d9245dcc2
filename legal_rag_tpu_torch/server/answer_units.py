"""Span-based answer attribution: verbatim vs derived answer units.

Spec: reference tests/test_answer_units.py (ghost module,
SURVEY.md §2.4). An LLM answer is decomposed into *units*; each unit is
either ``verbatim`` (carries a quote that must resolve to a concrete
character span inside a retrieved chunk — and only then becomes
clickable/highlightable in a UI) or ``derived`` (synthesized; NEVER
clickable). Invariants:

- a verbatim unit without a quote, or whose quote cannot be resolved
  (exact, whitespace-normalized, or fuzzy), downgrades to derived,
- derived units never get highlights regardless of attached spans,
- LLM output parsing is defensive (fences, leading prose, nested
  braces) and returns [] on garbage so callers fall back to the plain
  answer path.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class SourceSpan:
    doc_id: str
    section_id: str
    start_char: int
    end_char: int
    quote: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ChunkWithOffsets:
    """A retrieved chunk with its character range in the source doc."""

    doc_id: str
    section_id: str
    text: str
    start_char: int
    end_char: int


@dataclasses.dataclass
class AnswerUnit:
    id: str
    text: str
    kind: str                                   # verbatim | derived
    quote: Optional[str] = None
    supporting_sources: List[str] = dataclasses.field(default_factory=list)
    source_spans: List[SourceSpan] = dataclasses.field(default_factory=list)

    @property
    def is_clickable(self) -> bool:
        """Only verbatim units with a resolved span are clickable —
        derived units never are, even if spans were (wrongly) attached."""
        return self.kind == "verbatim" and len(self.source_spans) > 0

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "text": self.text,
            "kind": self.kind,
            "quote": self.quote,
            "supporting_sources": list(self.supporting_sources),
            "source_spans": [s.to_dict() for s in self.source_spans],
            "is_clickable": self.is_clickable,
        }


# ---------------------------------------------------------------------------
# Text matching helpers
# ---------------------------------------------------------------------------


def _normalize_text(text: str) -> str:
    """Lowercase + collapse all whitespace runs to single spaces."""
    return re.sub(r"\s+", " ", text).strip().lower()


def _fuzzy_find(
    needle: str, haystack: str, threshold: float = 0.8
) -> Optional[Tuple[int, int]]:
    """Approximate substring search: slide a needle-sized window (half-
    needle stride) and refine the best window with SequenceMatcher's
    longest matching block. Returns (start, end) in haystack or None."""
    if not needle or not haystack or len(needle) > len(haystack) * 2:
        return None
    n = len(needle)
    step = max(1, n // 2)
    best: Optional[Tuple[float, int]] = None
    for start in range(0, max(1, len(haystack) - n + 1), step):
        window = haystack[start : start + n + step]
        ratio = difflib.SequenceMatcher(
            None, needle.lower(), window.lower()
        ).ratio()
        if ratio >= threshold and (best is None or ratio > best[0]):
            best = (ratio, start)
    if best is None:
        return None
    start = best[1]
    window = haystack[start : start + n + step]
    match = difflib.SequenceMatcher(
        None, needle.lower(), window.lower()
    ).find_longest_match(0, len(needle), 0, len(window))
    if match.size == 0:
        return None
    lo = start + match.b
    hi = min(len(haystack), lo + n)
    return lo, hi


def resolve_span(
    quote: str, chunks: Sequence[ChunkWithOffsets]
) -> Optional[SourceSpan]:
    """Locate a quote inside the retrieved chunks.

    Strategy per chunk: case-insensitive exact find, then whitespace-
    normalized find (mapped back through an offset table), then fuzzy.
    First chunk with a hit wins.
    """
    if not quote or not chunks:
        return None
    for chunk in chunks:
        text = chunk.text
        # 1. exact (case-insensitive)
        idx = text.lower().find(quote.lower())
        if idx >= 0:
            return SourceSpan(
                doc_id=chunk.doc_id,
                section_id=chunk.section_id,
                start_char=chunk.start_char + idx,
                end_char=chunk.start_char + idx + len(quote),
                quote=text[idx : idx + len(quote)],
            )
        # 2. whitespace-normalized with offset mapping
        norm_chars: List[str] = []
        offsets: List[int] = []
        prev_space = True
        for i, ch in enumerate(text):
            if ch.isspace():
                if prev_space:
                    continue
                norm_chars.append(" ")
                offsets.append(i)
                prev_space = True
            else:
                norm_chars.append(ch.lower())
                offsets.append(i)
                prev_space = False
        norm = "".join(norm_chars)
        nq = _normalize_text(quote)
        idx = norm.find(nq)
        if idx >= 0 and nq:
            lo = offsets[idx]
            hi = offsets[min(idx + len(nq) - 1, len(offsets) - 1)] + 1
            return SourceSpan(
                doc_id=chunk.doc_id,
                section_id=chunk.section_id,
                start_char=chunk.start_char + lo,
                end_char=chunk.start_char + hi,
                quote=text[lo:hi],
            )
        # 3. fuzzy
        span = _fuzzy_find(quote, text)
        if span is not None:
            lo, hi = span
            return SourceSpan(
                doc_id=chunk.doc_id,
                section_id=chunk.section_id,
                start_char=chunk.start_char + lo,
                end_char=chunk.start_char + hi,
                quote=text[lo:hi],
            )
    return None


def resolve_all_spans(
    units: Sequence[AnswerUnit], chunks: Sequence[ChunkWithOffsets]
) -> List[AnswerUnit]:
    """Resolve spans for every verbatim unit; downgrade failures."""
    out: List[AnswerUnit] = []
    for unit in units:
        if unit.kind == "verbatim":
            span = resolve_span(unit.quote or "", chunks)
            if span is None:
                unit = dataclasses.replace(
                    unit, kind="derived", source_spans=[]
                )
            else:
                unit = dataclasses.replace(unit, source_spans=[span])
        out.append(unit)
    return out


# ---------------------------------------------------------------------------
# LLM response parsing
# ---------------------------------------------------------------------------


def _extract_json_from_response(response: str) -> str:
    """Pull the JSON object out of an LLM reply: strips markdown fences,
    skips leading prose, and balances braces while respecting string
    literals (so braces inside strings don't truncate the payload)."""
    text = response.strip()
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, re.S)
    if fence:
        text = fence.group(1).strip()
    start = text.find("{")
    if start < 0:
        return text
    depth = 0
    in_string = False
    escaped = False
    for i in range(start, len(text)):
        ch = text[i]
        if in_string:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_string = False
            continue
        if ch == '"':
            in_string = True
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return text[start : i + 1]
    return text[start:]


def parse_answer_units_response(response: str) -> List[AnswerUnit]:
    """Parse LLM output into AnswerUnits; [] on garbage (legacy path)."""
    try:
        data = json.loads(_extract_json_from_response(response))
    except (json.JSONDecodeError, TypeError):
        return []
    if not isinstance(data, dict):
        return []  # e.g. a bare JSON array — still the legacy path
    units: List[AnswerUnit] = []
    for i, raw in enumerate(data.get("answer_units") or []):
        if not isinstance(raw, dict) or not raw.get("text"):
            continue
        kind = raw.get("kind", "derived")
        quote = raw.get("quote")
        if kind == "verbatim" and not quote:
            kind = "derived"  # unverifiable verbatim claims downgrade
        units.append(
            AnswerUnit(
                id=str(raw.get("id") or f"S{i + 1}"),
                text=str(raw["text"]),
                kind=kind if kind in ("verbatim", "derived") else "derived",
                quote=quote if kind == "verbatim" else None,
                supporting_sources=_clean_supporting_sources(
                    raw.get("supporting_sources")
                ),
            )
        )
    return units


def get_answer_unit_prompt(context: str, question: str) -> str:
    return f"""You are a precise legal assistant. Answer the question using ONLY the provided context, decomposed into attributable units.

Context:
{context}

Question: {question}

Return ONLY a JSON object of the form:
{{"answer_units": [{{"id": "S1", "text": "...", "kind": "verbatim", "quote": "..."}},
                   {{"id": "S2", "text": "...", "kind": "derived", "supporting_sources": ["GSOP_004"]}}]}}

Rules:
- "verbatim" units restate a source almost word-for-word and MUST carry a "quote": an exact substring copied from the context (it will be verified character-by-character).
- "derived" units synthesize or summarize; they must list the section ids they rest on in "supporting_sources" and must NOT carry a quote.
- Prefer verbatim for legal requirements, deadlines and definitions; derived for transitions and advice.
- No text outside the JSON object."""


# ---------------------------------------------------------------------------
# Supporting-source cleanup
# ---------------------------------------------------------------------------

_ID_PATTERNS = (
    re.compile(r"\b([A-Z]{2,5}SOP_\d+|GSOP_\d+|RSOP_\d+)\b", re.I),
    re.compile(r"\bsection\s+(\d+[A-Za-z]?)\b", re.I),
    re.compile(r"\b(?:BNSS|BNS|BSA|NALSA)[\s_\-]+(\d+[A-Za-z]?)\b", re.I),
)


def _extract_section_id(source: str) -> str:
    """Normalize an LLM-provided source string to a clean section id:
    GSOP-style ids pass through, 'Section 173 BNSS' / 'BNSS_183' /
    plain numbers reduce to the number, anything else truncates."""
    s = source.strip()
    for pat in _ID_PATTERNS:
        m = pat.search(s)
        if m:
            g = m.group(1)
            return g.upper() if "_" in g or g[:1].isalpha() else g
    if re.fullmatch(r"\d+[A-Za-z]?", s):
        return s
    if len(s) <= 25:
        return s
    return s[:25] + "..."


def _clean_supporting_sources(sources) -> List[str]:
    """Clean + dedupe (order-preserving); drop non-strings."""
    if not sources:
        return []
    out: List[str] = []
    seen = set()
    for s in sources:
        if not isinstance(s, str):
            continue
        cleaned = _extract_section_id(s)
        if cleaned and cleaned not in seen:
            seen.add(cleaned)
            out.append(cleaned)
    return out
