# Verbatim copy of wax_tpu/types.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Common value types shared across the framework.

These mirror the *capability surface* of the reference engine's search
request/response model (reference: Sources/Wax/UnifiedSearch/SearchRequest.swift:1-145,
SearchResponse.swift:1-75) re-designed as plain Python dataclasses: the TPU build keeps
all device work in pure jitted functions and uses these host-side types only at the API
boundary.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence


def now_ms() -> int:
    return int(time.time() * 1000)


class SearchMode(str, enum.Enum):
    """Which retrieval lanes participate in a unified search."""

    HYBRID = "hybrid"
    TEXT_ONLY = "text"
    VECTOR_ONLY = "vector"


class QueryType(str, enum.Enum):
    """Rule-based query classification driving adaptive fusion weights
    (reference: RuleBasedQueryClassifier.swift:8-42)."""

    FACTUAL = "factual"
    SEMANTIC = "semantic"
    TEMPORAL = "temporal"
    EXPLORATORY = "exploratory"


class LaneSource(str, enum.Enum):
    """Provenance of a fused search hit."""

    BM25 = "bm25"
    VECTOR = "vector"
    STRUCTURED = "structured"
    TEMPORAL = "temporal"


class FrameStatus(str, enum.Enum):
    ACTIVE = "active"
    DELETED = "deleted"


class FrameKind(str, enum.Enum):
    DOCUMENT = "document"
    CHUNK = "chunk"
    SURROGATE = "surrogate"
    INTERNAL = "internal"


@dataclass(frozen=True)
class TimeRange:
    """Half-open [after_ms, before_ms) time filter."""

    after_ms: int | None = None
    before_ms: int | None = None

    def contains(self, ts_ms: int) -> bool:
        if self.after_ms is not None and ts_ms < self.after_ms:
            return False
        if self.before_ms is not None and ts_ms >= self.before_ms:
            return False
        return True


@dataclass(frozen=True)
class SearchRequest:
    """Unified hybrid-search request.

    Mirrors the reference's SearchRequest (SearchRequest.swift:1-145): query text,
    optional precomputed embedding, lane mode, top-k, RRF constant, frame filter,
    time range, structured-memory as-of, and diagnostics toggles.
    """

    query: str
    embedding: Sequence[float] | None = None
    mode: SearchMode = SearchMode.HYBRID
    top_k: int = 10
    rrf_k: float = 60.0
    frame_filter: frozenset[int] | None = None
    time_range: TimeRange | None = None
    as_of_ms: int | None = None
    use_structured_memory: bool = True
    preview_max_bytes: int = 4096
    include_diagnostics: bool = False
    # Metadata equality filters applied after fusion.
    metadata_filter: Mapping[str, str] | None = None


@dataclass(frozen=True)
class RankingDiagnostics:
    """Per-result fusion provenance (reference: UnifiedSearch.swift:203-263)."""

    lane_ranks: Mapping[str, int]
    lane_scores: Mapping[str, float]
    rrf_score: float
    tie_break: str = ""


@dataclass(frozen=True)
class SearchHit:
    frame_id: int
    score: float
    preview: str = ""
    sources: tuple[LaneSource, ...] = ()
    diagnostics: RankingDiagnostics | None = None


@dataclass(frozen=True)
class SearchResponse:
    hits: tuple[SearchHit, ...]
    query_type: QueryType
    lane_counts: Mapping[str, int] = field(default_factory=dict)
    elapsed_ms: float = 0.0
    # Query-level advisories (e.g. an AND query under a manual postings budget
    # below the auto recall floor — silent-recall-loss configurations warn
    # instead of failing).
    warnings: tuple[str, ...] = ()


@dataclass(frozen=True)
class FrameMeta:
    """Host-side per-frame metadata record.

    Mirrors the reference FrameMeta (WaxCore/FileFormat/FrameMeta.swift:19-45):
    identity, timestamps, kind/role, chunk lineage, status, supersede links, tags,
    and a free-form metadata map. Payload location fields live in the storage layer.
    """

    frame_id: int
    timestamp_ms: int
    kind: str = FrameKind.DOCUMENT.value
    search_text: str | None = None
    metadata: Mapping[str, str] = field(default_factory=dict)
    tags: tuple[str, ...] = ()
    parent_id: int | None = None
    chunk_index: int | None = None
    chunk_count: int | None = None
    status: str = FrameStatus.ACTIVE.value
    supersedes: int | None = None
    superseded_by: int | None = None
