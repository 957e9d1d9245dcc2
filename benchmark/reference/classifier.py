"""Frozen copy of the port's rule-based query classifier.

Copied from ``legal_rag_tpu_torch/retrieval/classifier.py`` (the
deterministic path only: the benchmark serves with the LLM stages off),
so that the reference orchestration of ``LegalEngine.query`` classifies
each request without importing the program.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional


QUERY_TYPES = (
    "definition",
    "procedure",
    "punishment",
    "bailability",
    "jurisdiction",
    "rights_of_victim",
    "police_duty",
    "court_power",
    "compensation",
    "general_explanation",
)

USER_CONTEXTS = ("victim_distress", "informational", "professional")


@dataclasses.dataclass
class QueryIntent:
    category: str
    user_context: str
    confidence: float
    sub_intent: Optional[str] = None
    key_entities: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# Rule tables for the deterministic path -------------------------------------

_OFFENCES = (
    "robbery", "rape", "assault", "theft", "murder", "kidnapping",
    "acid attack", "stalking", "dowry", "cheating", "extortion",
    "burglary", "molestation", "harassment",
)

# verb/participle forms -> canonical offence entity
_OFFENCE_FORMS = {
    "robbed": "robbery",
    "raped": "rape",
    "assaulted": "assault",
    "stolen": "theft",
    "stole": "theft",
    "burgled": "burglary",
    "cheated": "cheating",
    "kidnapped": "kidnapping",
    "abducted": "kidnapping",
    "stalked": "stalking",
    "harassed": "harassment",
    "murdered": "murder",
    "extorted": "extortion",
    "molested": "molestation",
    # paraphrase forms (round 4): victims rarely use the statute's
    # vocabulary — these high-precision phrasings map scenario
    # descriptions to the offence entity so the distress heuristics
    # (pronoun + offence) still fire (quality.py PARAPHRASE_SUITE)
    "snatched": "theft",
    "grabbed my": "theft",
    "pickpocket": "theft",
    "following me": "stalking",
    "follows me everywhere": "stalking",
    "keeps messaging me": "stalking",
    "acid thrown": "acid attack",
    "threw acid": "acid attack",
    "corrosive liquid": "acid attack",
    "corrosive substance": "acid attack",
    "lured away": "kidnapping",
    "demanding dowry": "dowry",
    "dowry demand": "dowry",
    "sold me fake": "cheating",
    "defrauded": "cheating",
    "blackmail": "extortion",
    "blackmailed": "extortion",
}

# single-word forms that need WORD boundaries: plain substring matching
# (right for the stemmed/multi-word forms above) false-fires here —
# "ransom" is a prefix of "ransomware", a different offence domain
_OFFENCE_FORMS_WORD = {
    "ransom": "kidnapping",
}
_LAWS = ("BNS", "BNSS", "BSA", "NALSA", "IPC", "CRPC")

_CATEGORY_RULES = (
    ("compensation", ("compensation", "compensate", "relief fund", "nalsa")),
    ("bailability", ("bail", "bailable", "anticipatory")),
    ("punishment", ("punishment", "punish", "sentence", "imprisonment", "fine for")),
    ("police_duty", ("police duty", "police do", "police officer", "sho", "duty of police")),
    ("court_power", ("court power", "magistrate", "high court", "supreme court", "jurisdiction of court")),
    ("jurisdiction", ("jurisdiction", "which police station", "where to file", "where should i file")),
    ("rights_of_victim", ("rights", "victim rights", "my rights")),
    ("procedure", ("procedure", "how to", "how do i", "file", "fir", "register", "complaint", "report", "what should i do", "what do i do")),
    ("definition", ("what is", "define", "definition", "meaning of")),
)

_DISTRESS_MARKERS = (
    "i was", "i am", "i have been", "i've been", "my ", "me ", "just now",
    "help", "happened to me", "attacked", "robbed", "raped", "assaulted",
    "stolen", "threatened", "urgent",
)
_PROFESSIONAL_MARKERS = (
    "i am a lawyer", "as a lawyer", "i am a police", "as an officer",
    "advocate", "counsel for", "my client",
)


def classify_heuristic(query: str) -> QueryIntent:
    """Deterministic rule-based intent classification."""
    q = query.lower()

    entities: List[str] = []
    for law in _LAWS:
        if re.search(rf"\b{law.lower()}\b", q):
            entities.append(law)
    for off in _OFFENCES:
        if off in q:
            entities.append(off)
    for form, off in _OFFENCE_FORMS.items():
        if form in q and off not in entities:
            entities.append(off)
    for form, off in _OFFENCE_FORMS_WORD.items():
        if re.search(rf"\b{form}\b", q) and off not in entities:
            entities.append(off)
    for sec in re.findall(r"section\s+(\d+[a-z]?)", q):
        entities.append(f"Section {sec}")
    if "fir" in q.split() or "zero fir" in q:
        entities.append("FIR")

    # an offence is "present" if named directly OR recognized through a
    # verb/paraphrase form above (the canonical entity then sits in
    # `entities`) — victims describing the scenario in their own words
    # must trigger the same distress handling as statute vocabulary
    has_offence = any(off in q for off in _OFFENCES) or any(
        e in _OFFENCES for e in entities
    )
    context = "informational"
    if any(m in q for m in _PROFESSIONAL_MARKERS):
        context = "professional"
    elif any(m in q for m in _DISTRESS_MARKERS) and has_offence:
        context = "victim_distress"
    elif re.search(r"\b(i|my|me)\b", q) and any(
        w in q for w in ("robbed", "attacked", "raped", "assaulted", "stolen",
                         "cheated", "threatened", "harassed")
    ):
        context = "victim_distress"

    category = "general_explanation"
    for cat, needles in _CATEGORY_RULES:
        if any(n in q for n in needles):
            category = cat
            break
    # victim asking anything actionable is procedural
    if context == "victim_distress" and category in (
        "general_explanation", "definition",
    ):
        category = "procedure"

    return QueryIntent(
        category=category,
        user_context=context,
        confidence=0.55,
        sub_intent=None,
        key_entities=entities,
    )


