"""Typed response schemas for the serving layer.

Spec: the reference's ghost-module tests (tests/test_anchors.py:20,
tests/test_source_fetcher.py:12) import TierType, TimelineItem,
ConfidenceLevel, SourceType, SourceResponse from src/server/schemas —
this module is the concrete realization.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field


class TierType(str, enum.Enum):
    """Case severity tier: TIER1 = victim-critical crimes with hard
    anchor guarantees; TIER3 = property/other recognized crimes;
    STANDARD = everything else."""

    TIER1 = "tier1"
    TIER3 = "tier3"
    STANDARD = "standard"


class ConfidenceLevel(str, enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class SourceType(str, enum.Enum):
    GENERAL_SOP = "general_sop"
    RAPE_SOP = "rape_sop"
    BNS = "bns"
    BNSS = "bnss"
    BSA = "bsa"
    NALSA = "nalsa"


class TimelineItem(BaseModel):
    stage: str
    title: Optional[str] = None
    description: Optional[str] = None
    deadline: Optional[str] = None
    is_anchor: bool = False
    audience: str = "victim"           # victim | police | court
    source: Optional[str] = None       # citation / section id


class SystemNotice(BaseModel):
    type: str                          # e.g. ANCHOR_MISSING
    message: str


class Highlight(BaseModel):
    start: int
    end: int
    reason: str = "Referenced in response"


class SourceResponse(BaseModel):
    source_type: SourceType
    section_id: str
    content: str
    metadata: Dict[str, Any] = Field(default_factory=dict)
    highlights: List[Highlight] = Field(default_factory=list)


class AdaptedResponse(BaseModel):
    """The timeline-and-confidence view of an engine answer."""

    answer: str = ""
    case_type: Optional[str] = None
    tier: TierType = TierType.STANDARD
    timeline: List[TimelineItem] = Field(default_factory=list)
    confidence: ConfidenceLevel = ConfidenceLevel.MEDIUM
    system_notice: Optional[SystemNotice] = None
    citations: List[str] = Field(default_factory=list)
