"""Structured answer generation.

Same response contract as the reference ``LegalResponder``
(responder.py:17-167): the 8-field ``LegalResponse`` (answer,
safety_alert, immediate_action_plan, legal_basis, procedure_steps,
important_notes, sources, disclaimer), victim-centric system
instruction, ``[PARENT CONTEXT]/[SPECIFIC CLAUSE]`` stitching, and the
two post-processing enforcements (sources replaced with the actual
retrieval context, safety fields nulled outside victim_distress).

Adds what the reference lacks: a deterministic *extractive* fallback
that composes an answer from the retrieved chunks when no LLM is
available, so the full pipeline works offline and is testable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from legal_rag_tpu_torch.retrieval.llm import LLMClient

DISCLAIMER = (
    "This information is provided for general awareness and is not legal "
    "advice. Consult a qualified legal professional or contact your "
    "nearest Legal Services Authority for advice on your specific case."
)


@dataclasses.dataclass
class LegalSource:
    law: str
    section: str
    content: str
    citation: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LegalResponse:
    answer: str
    legal_basis: str
    disclaimer: str
    safety_alert: Optional[str] = None
    immediate_action_plan: List[str] = dataclasses.field(default_factory=list)
    procedure_steps: List[str] = dataclasses.field(default_factory=list)
    important_notes: List[str] = dataclasses.field(default_factory=list)
    sources: List[LegalSource] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["sources"] = [
            s if isinstance(s, dict) else dataclasses.asdict(s)
            for s in d["sources"]
        ]
        return d


_SYSTEM_TEMPLATE = """You are a supportive and highly precise Indian Legal Assistant. Your primary goal is to assist users, particularly victims of crimes, by providing clear, actionable, and empathetic guidance.

USER CONTEXT: {user_context}

VICTIM-CENTRIC RULES (Priority if context is 'victim_distress'):
1. FIRST PRIORITY: User safety. Use the 'safety_alert' field for critical advice (e.g., "Call 112 immediately").
2. SECOND PRIORITY: Immediate Action. List 3-5 clear steps in 'immediate_action_plan'. Use simple verbs, Grade 8 reading level.
3. TONE: Supportive, direct, and empathetic. Address the user as 'You'.
4. ANSWER FORMATTING: Markdown; merge 'important_notes' into the answer.
5. ACCESSIBILITY: Explain legal terms in simple parentheses.

GENERAL / INFORMATIONAL RULES (if context is 'informational' or 'professional'):
1. DO NOT generate 'safety_alert' or 'immediate_action_plan'.
2. Markdown answer; only use the provided context; exact citations of canonical headers; no personalized legal advice; always include the mandatory disclaimer."""

_TASK_TEMPLATE = """User Query: {query}
Intent Category: {category}
Key Entities: {entities}

Legal Context:
{context}

Task: Provide a structured legal response in JSON format with these EXACT keys:
1. "safety_alert": (string or null)
2. "immediate_action_plan": (list of strings)
3. "answer": (string, markdown)
4. "legal_basis": (string)
5. "procedure_steps": (list of strings)
6. "important_notes": (list of strings)
7. "sources": (list of objects with keys: "law", "section", "content", "citation")
8. "disclaimer": (string)"""


def format_context(context: List[Dict]) -> str:
    """SOURCE/CONTENT blocks with parent stitching
    (reference responder.py:67-80)."""
    items = []
    for c in context:
        chunk = c["chunk"]
        text = chunk["text"]
        if c.get("parent_context"):
            text = f"[PARENT CONTEXT]: {c['parent_context']}\n[SPECIFIC CLAUSE]: {text}"
        items.append(f"SOURCE: {chunk['canonical_header']}\nCONTENT: {text}")
    return "\n\n".join(items)


def context_sources(context: List[Dict], limit: int = 4) -> List[LegalSource]:
    """The actual retrieval context as sources — replaces whatever the
    LLM claimed (reference responder.py:132-155)."""
    sources = []
    for c in context[:limit]:
        chunk = c["chunk"]
        meta = chunk.get("metadata", {})
        text = chunk["text"]
        if c.get("parent_context"):
            text = f"{c['parent_context']}\n\n[Clause]: {text}"
        sources.append(
            LegalSource(
                law=str(meta.get("law", "Unknown")),
                section=str(meta.get("section", "Unknown")),
                citation=str(chunk.get("canonical_header", "Unknown")),
                content=text,
            )
        )
    return sources


def _relevant_excerpt(query: str, body: str, max_chars: int = 400) -> str:
    """Query-aware excerpt: pick the sentences with the highest query-
    token overlap (in document order) instead of a blind prefix cut."""
    from legal_rag_tpu_torch.server.sentence_attribution import (
        split_into_sentences,
    )

    sentences = split_into_sentences(body)
    if len(sentences) <= 1:
        excerpt = body
    else:
        q_tokens = {t for t in query.lower().split() if len(t) > 2}
        scored = []
        for idx, s in enumerate(sentences):
            toks = set(s["text"].lower().split())
            scored.append((len(q_tokens & toks), idx, s["text"]))
        scored.sort(key=lambda t: (-t[0], t[1]))
        picked = sorted(
            [t for t in scored[:3] if t[0] > 0] or scored[:2],
            key=lambda t: t[1],
        )
        excerpt = " ".join(t[2] for t in picked)
    if len(excerpt) > max_chars:
        excerpt = excerpt[:max_chars].rsplit(" ", 1)[0] + "…"
    return excerpt


def _extractive_response(
    query: str, context: List[Dict], intent: Dict
) -> LegalResponse:
    """Deterministic no-LLM answer: cite and excerpt the top chunks."""
    victim = intent.get("user_context") == "victim_distress"
    lines = []
    basis = []
    for c in context[:3]:
        chunk = c["chunk"]
        header = chunk["canonical_header"].replace("\n", " — ")
        body = chunk["text"].split("\n\n", 1)[-1].strip()
        lines.append(f"**{header}**\n\n{_relevant_excerpt(query, body)}")
        basis.append(header)
    answer = (
        f"Based on the retrieved legal provisions for your query "
        f"“{query}”:\n\n" + "\n\n---\n\n".join(lines)
        if lines
        else "No relevant legal provisions were found for this query."
    )
    resp = LegalResponse(
        answer=answer,
        legal_basis="; ".join(basis) if basis else "No provisions retrieved.",
        disclaimer=DISCLAIMER,
    )
    if victim:
        resp.safety_alert = (
            "If you are in immediate danger, call 112 (national emergency "
            "number) right away."
        )
        resp.immediate_action_plan = [
            "Move to a safe place and call 112 if you are in danger.",
            "Go to the nearest police station — any station can register "
            "a Zero FIR regardless of jurisdiction.",
            "Ask for a free copy of the FIR; it is your right.",
            "Preserve evidence (clothes, messages, photos, CCTV details).",
            "Contact the District Legal Services Authority for free legal "
            "aid and NALSA compensation.",
        ]
        resp.procedure_steps = [
            "File the FIR under Section 173 BNSS (oral, written, or "
            "electronic).",
            "Obtain the free FIR copy.",
            "Request medical examination where applicable.",
            "Apply to the SLSA/DLSA for interim compensation under the "
            "NALSA scheme.",
        ]
    return resp


class LegalResponder:
    def __init__(self, llm: Optional[LLMClient] = None):
        self.llm = llm

    def generate_response(
        self,
        query: str,
        context: List[Dict[str, Any]],
        intent: Dict[str, Any],
    ) -> LegalResponse:
        user_context = intent.get("user_context", "informational")

        result: Optional[LegalResponse] = None
        if self.llm is not None:
            try:
                raw = self.llm.generate_json(
                    _TASK_TEMPLATE.format(
                        query=query,
                        category=intent.get("category"),
                        entities=", ".join(intent.get("key_entities", [])),
                        context=format_context(context),
                    ),
                    system=_SYSTEM_TEMPLATE.format(user_context=user_context),
                )
                result = LegalResponse(
                    answer=str(raw.get("answer", "")),
                    legal_basis=str(raw.get("legal_basis", "")),
                    disclaimer=str(raw.get("disclaimer") or DISCLAIMER),
                    safety_alert=raw.get("safety_alert"),
                    immediate_action_plan=[
                        str(s) for s in raw.get("immediate_action_plan") or []
                    ],
                    procedure_steps=[
                        str(s) for s in raw.get("procedure_steps") or []
                    ],
                    important_notes=[
                        str(s) for s in raw.get("important_notes") or []
                    ],
                )
            except Exception:  # noqa: BLE001 — degrade to extractive
                result = None
        if result is None:
            result = _extractive_response(query, context, intent)

        # post-processing enforcement (reference responder.py:132-160)
        if context:
            result.sources = context_sources(context)
        if user_context != "victim_distress":
            result.safety_alert = None
            result.immediate_action_plan = []
        return result
