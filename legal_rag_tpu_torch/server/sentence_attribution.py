"""Sentence-level citation attribution.

Spec: reference tests/test_sentence_attribution.py (ghost module,
SURVEY.md §2.4). An answer is split into sentences (markdown-header and
abbreviation aware); each sentence maps to zero or more citation keys
``source_type:source_id``. Attribution uses the injected LLM when
available and a deterministic keyword-overlap heuristic otherwise — so
the path is fully testable offline.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

# Abbreviations whose trailing dot must not end a sentence.
_ABBREVIATIONS = (
    "dr", "mr", "mrs", "ms", "prof", "sec", "no", "vs", "viz", "etc",
    "i.e", "e.g", "u/s", "hon", "w.e.f", "rs",
)
_ABBREV_RE = re.compile(
    r"\b(" + "|".join(re.escape(a) for a in _ABBREVIATIONS) + r")\.",
    re.I,
)
_DOT_TOKEN = "\x00DOT\x00"


def split_into_sentences(text: str) -> List[Dict[str, str]]:
    """Split an answer into [{'sid': 'S1', 'text': ...}, ...].

    Markdown header lines are skipped entirely; abbreviation dots are
    protected before splitting on sentence punctuation.
    """
    if not text or not text.strip():
        return []
    lines = [
        line for line in text.splitlines()
        if not line.strip().startswith("#")
    ]
    body = " ".join(line.strip() for line in lines if line.strip())
    if not body:
        return []
    protected = _ABBREV_RE.sub(lambda m: m.group(1) + _DOT_TOKEN, body)
    parts = re.split(r"(?<=[.!?])\s+", protected)
    out: List[Dict[str, str]] = []
    for part in parts:
        sentence = part.replace(_DOT_TOKEN, ".").strip()
        if sentence:
            out.append({"sid": f"S{len(out) + 1}", "text": sentence})
    return out


def build_citation_key(source_type: str, source_id: str) -> str:
    return f"{source_type}:{source_id}"


def parse_citation_key(key: str) -> Tuple[str, str]:
    if ":" in key:
        source_type, source_id = key.split(":", 1)
        return source_type, source_id
    return "unknown", key


def get_available_citations(citations: Sequence[Dict]) -> List[str]:
    return [
        build_citation_key(c["source_type"], c["source_id"])
        for c in citations
        if c.get("source_type") and c.get("source_id")
    ]


def create_attribution_prompt(
    sentences: Sequence[Dict[str, str]],
    citation_keys: Sequence[str],
    answer: str,
) -> str:
    numbered = "\n".join(f"{s['sid']}: {s['text']}" for s in sentences)
    keys = "\n".join(f"- {k}" for k in citation_keys)
    return f"""Map each sentence of a legal answer to the citations that support it.

Full answer:
{answer}

Sentences:
{numbered}

Available citation keys:
{keys}

Return ONLY a JSON object mapping sentence ids to lists of citation keys, e.g.:
{{"S1": ["bnss:183"], "S2": []}}
Use ONLY keys from the list; use [] when no citation supports a sentence."""


_STOPWORDS = frozenset(
    "the a an of to in for and or is are be must shall should with at on "
    "by it this that as from under any all".split()
)


def _keywords(text: str) -> set:
    return {
        w for w in re.findall(r"[a-z0-9/]+", text.lower())
        if len(w) > 2 and w not in _STOPWORDS
    }


def _heuristic_attribution(
    sentences: Sequence[Dict[str, str]],
    citations: Sequence[Dict],
) -> Dict[str, List[str]]:
    """Deterministic attribution: keyword overlap with each citation's
    display + context snippet, plus explicit section-number references.
    """
    mapping: Dict[str, List[str]] = {}
    prepared = []
    for c in citations:
        key = build_citation_key(
            c.get("source_type", "unknown"), c.get("source_id", "")
        )
        kw = _keywords(
            f"{c.get('display', '')} {c.get('context_snippet', '')}"
        )
        sid_digits = re.sub(r"\D", "", str(c.get("source_id", "")))
        prepared.append((key, kw, sid_digits))

    for sent in sentences:
        text = sent["text"]
        skw = _keywords(text)
        matches: List[Tuple[float, str]] = []
        sent_numbers = set(re.findall(r"\b(\d+[A-Za-z]?)\b", text))
        for key, kw, sid_digits in prepared:
            score = 0.0
            if kw and skw:
                score = len(kw & skw) / max(1, min(len(kw), len(skw)))
            if sid_digits and sid_digits in sent_numbers:
                score += 1.0  # explicit section reference
            if score >= 0.2:
                matches.append((score, key))
        matches.sort(key=lambda t: -t[0])
        mapping[sent["sid"]] = [k for _, k in matches[:2]]
    return mapping


def compute_sentence_attribution(
    answer: str,
    citations: Sequence[Dict],
    llm=None,
) -> Optional[Dict]:
    """Full attribution: split, map (LLM or heuristic), return
    {'sentences': [...], 'mapping': {sid: [keys]}} or None for empty
    answers."""
    if not answer or not answer.strip():
        return None
    sentences = split_into_sentences(answer)
    if not sentences:
        return None
    if not citations:
        return {
            "sentences": sentences,
            "mapping": {s["sid"]: [] for s in sentences},
        }

    keys = get_available_citations(citations)
    mapping: Optional[Dict[str, List[str]]] = None
    if llm is not None:
        try:
            raw = llm.generate_json(
                create_attribution_prompt(sentences, keys, answer)
            )
            valid = set(keys)
            mapping = {
                s["sid"]: [
                    k for k in (raw.get(s["sid"]) or []) if k in valid
                ]
                for s in sentences
            }
        except Exception:  # noqa: BLE001 — degrade to heuristic
            mapping = None
    if mapping is None:
        mapping = _heuristic_attribution(sentences, citations)
    return {"sentences": sentences, "mapping": mapping}
