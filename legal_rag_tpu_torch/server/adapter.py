"""Timeline anchors + confidence scoring.

Spec: reference tests/test_anchors.py (the ghost adapter,
SURVEY.md §2.4). Core guarantees:

- every Tier-1 crime has its non-negotiable procedural anchors
  (rape/sexual_assault/pocso: FIR + medical exam + statement recording
  + victim protection) injected into the timeline EVEN IF retrieval
  missed them (2-pass extraction),
- anchors always precede secondary timeline items (regression: a
  property-attachment SOP must never lead a robbery timeline),
- a Tier-1 anchor with no supporting retrieval block raises an
  ANCHOR_MISSING system notice and caps confidence at LOW,
- confidence: LOW on clarification/system notice; HIGH only with
  anchors resolved + citations + answer; MEDIUM otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from legal_rag_tpu_torch.server.schemas import (
    ConfidenceLevel,
    SystemNotice,
    TierType,
    TimelineItem,
)

# ---------------------------------------------------------------------------
# Anchor tables
# ---------------------------------------------------------------------------

_VICTIM_CRITICAL_ANCHORS = [
    {
        "stage": "fir_registration",
        "title": "Register the FIR",
        "deadline": "Immediately",
        "audience": "victim",
        "description": "FIR under Section 173 BNSS at any police station "
        "(Zero FIR applies regardless of jurisdiction); recorded by a "
        "woman officer for offences against women; free copy to victim.",
        "source": "BNSS_173",
    },
    {
        "stage": "medical_examination",
        "title": "Medical examination of the victim",
        "deadline": "Within 24 hours",
        "audience": "victim",
        "description": "Time-bound medical examination under Section 184 "
        "BNSS by a registered medical practitioner, with consent.",
        "source": "BNSS_184",
    },
    {
        "stage": "statement_recording",
        "title": "Recording of the victim's statement",
        "deadline": "At the earliest, at a place of the victim's choice",
        "audience": "police",
        "description": "Statement under Section 180/183 BNSS, recorded by "
        "a woman officer where applicable.",
        "source": "BNSS_183",
    },
    {
        "stage": "victim_protection",
        "title": "Victim protection measures",
        "deadline": "Ongoing from first report",
        "audience": "police",
        "description": "Protection, privacy and support measures for the "
        "victim, including identity protection and witness protection.",
        "source": "SOP",
    },
]

_PROPERTY_CRIME_ANCHORS = [
    {
        "stage": "fir_registration",
        "title": "Register the FIR",
        "deadline": "Immediately",
        "audience": "victim",
        "description": "FIR under Section 173 BNSS; Zero FIR applies at "
        "any police station.",
        "source": "BNSS_173",
    },
    {
        "stage": "investigation_commencement",
        "title": "Investigation commences",
        "deadline": "Without delay after FIR",
        "audience": "police",
        "description": "Officer in charge proceeds to investigate under "
        "Chapter XIII BNSS.",
        "source": "BNSS_176",
    },
]

TIMELINE_ANCHORS: Dict[str, List[Dict[str, Any]]] = {
    "rape": list(_VICTIM_CRITICAL_ANCHORS),
    "sexual_assault": list(_VICTIM_CRITICAL_ANCHORS),
    "pocso": list(_VICTIM_CRITICAL_ANCHORS),
    "acid_attack": list(_VICTIM_CRITICAL_ANCHORS),
    "robbery": list(_PROPERTY_CRIME_ANCHORS),
    "theft": list(_PROPERTY_CRIME_ANCHORS),
    "burglary": list(_PROPERTY_CRIME_ANCHORS),
    "general": [
        {
            "stage": "fir_registration",
            "title": "Register the FIR",
            "deadline": "Immediately",
            "audience": "victim",
            "description": "FIR under Section 173 BNSS at any police "
            "station.",
            "source": "BNSS_173",
        },
    ],
}

TIER1_CASE_TYPES = ("rape", "sexual_assault", "pocso", "acid_attack")
TIER3_CASE_TYPES = ("robbery", "theft", "burglary")

_CASE_SYNONYMS = {
    "sexual assault": "sexual_assault",
    "molestation": "sexual_assault",
    "rape case": "rape",
    "child sexual abuse": "pocso",
    "acid attack": "acid_attack",
    "chain snatching": "robbery",
    "stealing": "theft",
}


def _normalize_case_type(case_type: Optional[str]) -> str:
    if not case_type:
        return "general"
    key = case_type.strip().lower().replace("-", " ")
    key = _CASE_SYNONYMS.get(key, key).replace(" ", "_")
    return key if key in TIMELINE_ANCHORS else "general"


_STAGE_KEYWORDS = (
    ("fir_registration", ("fir", "first information", "complaint",
                          "petition", "information in cognizable")),
    ("medical_examination", ("medical examination", "medical", "184")),
    ("statement_recording", ("statement", "examination of witnesses",
                             "witness", "180 bnss", "183")),
    ("victim_protection", ("protection", "dignity", "treatment of victim",
                           "compensation")),
    ("investigation_commencement", ("investigation", "search", "seizure",
                                    "evidence", "crime scene")),
)


def infer_stage(chunk: Dict[str, Any]) -> Optional[str]:
    """Map a retrieved chunk onto a procedural stage by its headings —
    the bridge from this framework's chunks (which carry structural
    metadata, not stage labels) into the anchor-evidence pass."""
    meta = chunk.get("metadata", {})
    probe = " ".join(
        str(meta.get(key) or "")
        for key in ("chapter_title", "section_title", "step")
    ).lower()
    if not probe.strip():
        probe = chunk.get("canonical_header", "").lower()
    for stage, needles in _STAGE_KEYWORDS:
        if any(n in probe for n in needles):
            return stage
    return None


def rag_view_from_engine(result: Dict[str, Any]) -> Dict[str, Any]:
    """Adapt a LegalEngine result dict into the rag_result shape the
    timeline/confidence layer consumes (the ghost adapter's input
    contract, reference tests/test_anchors.py:163-168)."""
    intent = result.get("intent", {})
    offence = next(
        (
            e.lower().replace(" ", "_")
            for e in intent.get("key_entities", [])
            if _normalize_case_type(e) != "general"
        ),
        None,
    )
    blocks = []
    for source in result.get("response", {}).get("sources", []):
        blocks.append({
            "text": source.get("content", ""),
            "metadata": {
                "stage": infer_stage({
                    "metadata": {},
                    "canonical_header": source.get("citation", ""),
                }),
                "title": source.get("citation", "").splitlines()[-1]
                if source.get("citation") else None,
            },
        })
    return {
        "case_type": offence,
        "detected_stages": [
            b["metadata"]["stage"] for b in blocks if b["metadata"]["stage"]
        ],
        "citations": [
            s.get("citation") for s in
            result.get("response", {}).get("sources", [])
        ],
        "answer": result.get("response", {}).get("answer", ""),
        "retrieval": {"sop_blocks": blocks, "general_sop_blocks": []},
    }


def _iter_retrieval_blocks(rag_result: Dict[str, Any]):
    retrieval = rag_result.get("retrieval") or {}
    for key in ("sop_blocks", "general_sop_blocks"):
        for block in retrieval.get(key) or []:
            yield block


def extract_timeline_with_anchors(
    rag_result: Dict[str, Any],
    case_type: Optional[str],
    tier: TierType,
) -> Tuple[List[TimelineItem], Optional[SystemNotice]]:
    """Two-pass timeline extraction.

    Pass 1 collects retrieval evidence per stage; pass 2 emits the
    anchor table for the case type (evidence-enriched where available,
    injected bare otherwise), then appends secondary (non-anchor)
    stages found in retrieval. Tier-1 cases with unevidenced anchors
    get an ANCHOR_MISSING notice.
    """
    normalized = _normalize_case_type(case_type)
    anchors = TIMELINE_ANCHORS[normalized]
    anchor_stages = {a["stage"] for a in anchors}

    # pass 1: stage -> retrieval block metadata
    evidence: Dict[str, Dict[str, Any]] = {}
    secondary: List[TimelineItem] = []
    for block in _iter_retrieval_blocks(rag_result):
        meta = block.get("metadata") or {}
        stage = meta.get("stage")
        if not stage:
            continue
        if stage in anchor_stages:
            evidence.setdefault(stage, {**meta, "text": block.get("text", "")})
        else:
            secondary.append(
                TimelineItem(
                    stage=stage,
                    title=meta.get("title") or stage.replace("_", " ").title(),
                    description=block.get("text"),
                    deadline=meta.get("time_limit"),
                    is_anchor=False,
                    audience=meta.get("audience", "police"),
                )
            )

    # pass 2: anchors in table order, enriched by evidence when present
    timeline: List[TimelineItem] = []
    missing: List[str] = []
    for anchor in anchors:
        ev = evidence.get(anchor["stage"])
        if ev is None:
            missing.append(anchor["stage"])
        timeline.append(
            TimelineItem(
                stage=anchor["stage"],
                title=(ev or {}).get("title") or anchor["title"],
                description=(ev or {}).get("text") or anchor["description"],
                deadline=(ev or {}).get("time_limit") or anchor["deadline"],
                is_anchor=True,
                audience=anchor["audience"],
                source=anchor.get("source"),
            )
        )
    timeline.extend(secondary)

    notice: Optional[SystemNotice] = None
    if tier == TierType.TIER1 and missing:
        notice = SystemNotice(
            type="ANCHOR_MISSING",
            message=(
                "Retrieval did not surface supporting material for "
                f"critical stages: {', '.join(missing)}. The standard "
                "requirements are shown from the anchor table; verify "
                "with official sources."
            ),
        )
    return timeline, notice


def calculate_confidence(
    tier: TierType,
    case_type: Optional[str],
    detected_stages: Sequence[str],
    has_citations: bool,
    has_answer: bool,
    anchors_resolved: bool,
    has_system_notice: bool,
    clarification_needed: bool,
    timeline_count: int,
) -> ConfidenceLevel:
    """Hardened confidence rules (reference tests/test_anchors.py:379-470):
    LOW beats everything; HIGH requires the full evidence triple."""
    if clarification_needed or has_system_notice or not anchors_resolved:
        return ConfidenceLevel.LOW if (
            clarification_needed or has_system_notice
        ) else ConfidenceLevel.MEDIUM
    if has_citations and has_answer and timeline_count > 0:
        return ConfidenceLevel.HIGH
    return ConfidenceLevel.MEDIUM


def infer_tier(case_type: Optional[str]) -> TierType:
    normalized = _normalize_case_type(case_type)
    if normalized in TIER1_CASE_TYPES:
        return TierType.TIER1
    if normalized in TIER3_CASE_TYPES:
        return TierType.TIER3
    return TierType.STANDARD


def adapt_response(rag_result: Dict[str, Any], query: str):
    """Assemble the timeline-anchored view of a RAG result."""
    from legal_rag_tpu_torch.server.schemas import AdaptedResponse

    case_type = rag_result.get("case_type")
    tier = infer_tier(case_type)
    timeline, notice = extract_timeline_with_anchors(rag_result, case_type, tier)

    citations = rag_result.get("citations") or []
    answer = rag_result.get("answer") or ""
    confidence = calculate_confidence(
        tier=tier,
        case_type=case_type,
        detected_stages=rag_result.get("detected_stages") or [],
        has_citations=bool(citations),
        has_answer=bool(answer),
        anchors_resolved=notice is None,
        has_system_notice=notice is not None,
        clarification_needed=bool(rag_result.get("clarification_needed")),
        timeline_count=len(timeline),
    )
    return AdaptedResponse(
        answer=answer,
        case_type=case_type,
        tier=tier,
        timeline=timeline,
        confidence=confidence,
        system_notice=notice,
        citations=[str(c) for c in citations],
    )
