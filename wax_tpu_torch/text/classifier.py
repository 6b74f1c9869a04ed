# Verbatim copy of wax_tpu/text/classifier.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Rule-based query classification + adaptive fusion weights.

Mirrors the reference's classifier/weights pair (reference:
Sources/Wax/UnifiedSearch/RuleBasedQueryClassifier.swift:8-42 and
AdaptiveFusionConfig.swift:22-27 — e.g. factual {bm25 .7, vec .3},
temporal {.25, .25, temporal .5}). Deterministic, pure host logic.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Mapping

from wax_tpu_torch.types import QueryType

__all__ = ["classify_query", "AdaptiveFusionConfig"]

# Temporal = the query is about *recency/time ranges* (relative-time words, explicit
# date filters) — NOT "when was X born", which is a factual question about a date
# stored in content and routes through the factual lanes + asks_date intent.
_TEMPORAL_RE = re.compile(
    r"\b(yesterday|today|tomorrow|tonight|recently|recent|latest|last\s+(week|month|year|night)|"
    r"this\s+(week|month|year|morning)|\d+\s+(days?|weeks?|months?|years?)\s+ago|"
    r"on\s+\d{1,2}[/-]\d{1,2}|what\s+happened)\b",
    re.IGNORECASE,
)
_FACTUAL_RE = re.compile(
    r"^\s*(who|what|where|when|which|whose|how\s+(many|much|old)|did|does|is|are|was|were)\b",
    re.IGNORECASE,
)
_EXPLORATORY_RE = re.compile(
    r"\b(tell\s+me\s+about|overview|explain|describe|summar(y|ize|ise)|everything\s+about|"
    r"what\s+do\s+you\s+know)\b",
    re.IGNORECASE,
)


def classify_query(query: str) -> QueryType:
    """Deterministic rule cascade: temporal > exploratory > factual > semantic."""
    q = query.strip()
    if _TEMPORAL_RE.search(q):
        return QueryType.TEMPORAL
    if _EXPLORATORY_RE.search(q) or len(q.split()) > 14:
        return QueryType.EXPLORATORY
    if _FACTUAL_RE.match(q) or '"' in q:
        return QueryType.FACTUAL
    return QueryType.SEMANTIC


@dataclass(frozen=True)
class AdaptiveFusionConfig:
    """Per-query-type lane weights for weighted RRF.

    Keys: "bm25", "vector", "temporal", "structured". Values follow the reference's
    published pairs (factual .7/.3, temporal .25/.25/.5); semantic/exploratory mirror
    them symmetrically. Structured-evidence lane gets a constant boost weight when
    enabled, applied on top of the per-type dense/lexical split.
    """

    weights: Mapping[QueryType, Mapping[str, float]] = field(
        default_factory=lambda: {
            QueryType.FACTUAL: {"bm25": 0.7, "vector": 0.3, "structured": 0.3},
            QueryType.SEMANTIC: {"bm25": 0.3, "vector": 0.7, "structured": 0.2},
            QueryType.TEMPORAL: {"bm25": 0.25, "vector": 0.25, "temporal": 0.5, "structured": 0.2},
            QueryType.EXPLORATORY: {"bm25": 0.5, "vector": 0.5, "structured": 0.2},
        }
    )

    def for_type(self, qt: QueryType) -> dict[str, float]:
        return dict(self.weights[qt])
