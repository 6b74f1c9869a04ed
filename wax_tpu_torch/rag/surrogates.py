# Verbatim copy of wax_tpu/rag/surrogates.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Extractive surrogate generation: MMR sentence selection at three tiers.

Mirrors the reference's surrogate pipeline (reference:
Sources/Wax/Maintenance/ExtractiveSurrogateGenerator.swift:3-120 — MMR sentence
selection over normalized segments in one scoring pass, token-truncated;
SurrogateTiers.swift:9-37 — tiers full≈100 / gist≈25 / micro≈8 tokens).
Deterministic: hash-based sentence vectors (no model dependency), fixed tie-breaks.
"""
from __future__ import annotations

import enum
import re
import zlib
from dataclasses import dataclass

import numpy as np

from wax_tpu_torch.text.token_counter import TokenCounter

__all__ = ["SurrogateTier", "TIER_TOKEN_BUDGETS", "generate_surrogate", "split_sentences"]


class SurrogateTier(str, enum.Enum):
    FULL = "full"
    GIST = "gist"
    MICRO = "micro"


TIER_TOKEN_BUDGETS = {
    SurrogateTier.FULL: 100,
    SurrogateTier.GIST: 25,
    SurrogateTier.MICRO: 8,
}

_SENT_RE = re.compile(r"(?<=[.!?])\s+|\n+")
_WORD_RE = re.compile(r"[a-z0-9]+")


def split_sentences(text: str) -> list[str]:
    return [s.strip() for s in _SENT_RE.split(text) if s.strip()]


def _sentence_vectors(sentences: list[str], dim: int = 256) -> np.ndarray:
    """Deterministic hashed bag-of-words vectors (L2-normalized). Uses crc32, not
    Python hash(), which is randomized per process."""
    vecs = np.zeros((len(sentences), dim), np.float32)
    for i, s in enumerate(sentences):
        for w in _WORD_RE.findall(s.lower()):
            vecs[i, zlib.crc32(w.encode()) % dim] += 1.0
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    return np.where(norms > 0, vecs / np.maximum(norms, 1e-9), vecs)


@dataclass(frozen=True)
class SurrogateResult:
    text: str
    tier: SurrogateTier
    token_count: int
    source_sentences: int


def generate_surrogate(
    text: str,
    tier: SurrogateTier = SurrogateTier.GIST,
    counter: TokenCounter | None = None,
    mmr_lambda: float = 0.7,
) -> SurrogateResult:
    """MMR-greedy extractive summary under the tier's token budget.

    Relevance = similarity to the document centroid; redundancy = max similarity to
    already-selected sentences. Selected sentences keep document order.
    """
    counter = counter or TokenCounter()
    budget = TIER_TOKEN_BUDGETS[tier]
    sentences = split_sentences(text)
    if not sentences:
        return SurrogateResult("", tier, 0, 0)
    vecs = _sentence_vectors(sentences)
    centroid = vecs.mean(axis=0)
    cn = np.linalg.norm(centroid)
    centroid = centroid / cn if cn > 0 else centroid
    relevance = vecs @ centroid

    selected: list[int] = []
    tokens_used = 0
    remaining = list(range(len(sentences)))
    while remaining:
        best_i, best_score = None, -1e9
        for i in remaining:
            redundancy = max((float(vecs[i] @ vecs[j]) for j in selected), default=0.0)
            score = mmr_lambda * float(relevance[i]) - (1.0 - mmr_lambda) * redundancy
            if score > best_score + 1e-12 or (best_i is None):
                best_i, best_score = i, score
        cost = counter.count(sentences[best_i])
        if tokens_used + cost > budget:
            if not selected:
                # even the best sentence exceeds the budget: hard-truncate it
                truncated = counter.truncate(sentences[best_i], budget)
                return SurrogateResult(truncated, tier, counter.count(truncated), 1)
            break
        selected.append(best_i)
        tokens_used += cost
        remaining.remove(best_i)
    selected.sort()
    out = " ".join(sentences[i] for i in selected)
    return SurrogateResult(out, tier, counter.count(out), len(selected))
