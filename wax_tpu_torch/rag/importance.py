# Verbatim copy of wax_tpu/rag/importance.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Importance scoring + surrogate tier selection.

Mirrors the reference pair (reference: Sources/Wax/RAG/ImportanceScorer.swift:19-50 —
importance = weighted age-decay + access frequency + recency with half-lives 168h/24h —
and SurrogateTierSelector.swift — map score/age/query signals to tier full/gist/micro).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from wax_tpu_torch.rag.surrogates import SurrogateTier

__all__ = ["ImportanceScorer", "SurrogateTierSelector"]

_AGE_HALF_LIFE_MS = 168 * 3600 * 1000  # 168 h
_RECENCY_HALF_LIFE_MS = 24 * 3600 * 1000  # 24 h


@dataclass(frozen=True)
class ImportanceScorer:
    age_weight: float = 0.4
    frequency_weight: float = 0.35
    recency_weight: float = 0.25
    frequency_saturation: float = 10.0

    def score(
        self,
        now_ms: int,
        created_ms: int,
        access_count: int = 0,
        last_access_ms: int | None = None,
    ) -> float:
        """Importance in [0, 1]."""
        age = max(0, now_ms - created_ms)
        age_term = math.exp(-math.log(2) * age / _AGE_HALF_LIFE_MS)
        freq_term = min(1.0, access_count / self.frequency_saturation)
        if last_access_ms is None:
            rec_term = 0.0
        else:
            since = max(0, now_ms - last_access_ms)
            rec_term = math.exp(-math.log(2) * since / _RECENCY_HALF_LIFE_MS)
        return (
            self.age_weight * age_term
            + self.frequency_weight * freq_term
            + self.recency_weight * rec_term
        )


@dataclass(frozen=True)
class SurrogateTierSelector:
    """score -> tier: important/fresh memories get richer surrogates."""

    full_threshold: float = 0.6
    gist_threshold: float = 0.25

    def select(self, importance: float, query_specificity: float = 0.0) -> SurrogateTier:
        # specific queries pull one tier richer (they can use the extra detail)
        boosted = importance + 0.15 * query_specificity
        if boosted >= self.full_threshold:
            return SurrogateTier.FULL
        if boosted >= self.gist_threshold:
            return SurrogateTier.GIST
        return SurrogateTier.MICRO
