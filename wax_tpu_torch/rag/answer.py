# Verbatim copy of wax_tpu/rag/answer.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Deterministic answer-span extraction for offline recall-quality benchmarking.

Mirrors the reference's DeterministicAnswerExtractor (reference:
Sources/Wax/RAG/DeterministicAnswerExtractor.swift:10-50+ — heuristic candidate lanes
for owner/date/city/allergy/pet-style questions over RAG items, used by the
long-memory benchmark harness, not by production recall).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from wax_tpu_torch.rag.context import RAGContext
from wax_tpu_torch.text.analyzer import analyze_query

__all__ = ["AnswerCandidate", "extract_answer"]

_DATE_RE = re.compile(
    r"\b((january|february|march|april|may|june|july|august|september|october|november|december)"
    r"\s+\d{1,2}(,?\s+\d{4})?|\d{1,2}[/-]\d{1,2}[/-]\d{2,4}|(19|20)\d{2})\b",
    re.IGNORECASE,
)
_OWNER_RE = re.compile(r"\b([A-Z][a-z]+)(?:'s)?\s+(?:owns?|owned|has|bought)\b|\bbelongs to\s+([A-Z][a-z]+)", )
_LOCATION_RE = re.compile(
    r"\b(?:in|at|near|located in|lives in|moved to)\s+([A-Z][a-zA-Z]+(?:\s+[A-Z][a-zA-Z]+)?)"
)
_NAME_AFTER_IS_RE = re.compile(r"\b(?:is|was|named|called)\s+([A-Z][a-z]+(?:\s+[A-Z][a-z]+)?)")
_ALLERGY_RE = re.compile(r"\b(?:allergic to|allergy to|allergies to)\s+([a-zA-Z]+(?:\s+and\s+[a-zA-Z]+)?)")
_PREFERENCE_RE = re.compile(
    r"\b(?:favou?rite\s+\w+\s+is|prefers?|loves)\s+(?:the\s+|a\s+)?([a-zA-Z]+(?:\s+[a-z]+)?)"
)
_PET_NAME_RE = re.compile(r"\b([A-Z][a-z]+)\s+the\s+([a-z]+)")


@dataclass(frozen=True)
class AnswerCandidate:
    text: str
    lane: str
    frame_id: int
    score: float


_SENTENCE_SPLIT_RE = re.compile(r"[.;!?\n]")
_OWNERSHIP_VERBS = frozenset({"owns", "own", "owner", "owned", "belongs", "has", "bought", "whose"})


def _sentence_around(text: str, pos: int) -> str:
    start = 0
    for m in _SENTENCE_SPLIT_RE.finditer(text[:pos]):
        start = m.end()
    m = _SENTENCE_SPLIT_RE.search(text, pos)
    return text[start : m.start() if m else len(text)]


def _subject_overlap(sentence: str, subject_terms: frozenset[str]) -> float:
    """Fraction of the query's non-intent content terms present in the sentence —
    ownership/date answers must be about the asked-about OBJECT, not merely phrased
    with an ownership verb (the reference extractor weighs candidate spans by
    query-term proximity the same way)."""
    if not subject_terms:
        return 1.0
    low = sentence.lower()
    return sum(1 for t in subject_terms if t in low) / len(subject_terms)


def extract_answer(context: RAGContext, query: str) -> AnswerCandidate | None:
    """Pick the best heuristic answer span from RAG items, lane chosen by intent."""
    signals = analyze_query(query)
    low_q = query.lower()
    subject_terms = frozenset(t for t in signals.content_terms if t not in _OWNERSHIP_VERBS)
    candidates: list[AnswerCandidate] = []
    for rank, item in enumerate(context.items):
        weight = 1.0 / (1.0 + rank)
        text = item.text
        if signals.asks_date:
            for m in _DATE_RE.finditer(text):
                candidates.append(AnswerCandidate(m.group(0), "date", item.frame_id, 2.0 * weight))
        if signals.asks_location:
            for m in _LOCATION_RE.finditer(text):
                candidates.append(AnswerCandidate(m.group(1), "location", item.frame_id, 2.0 * weight))
        if signals.asks_ownership:
            for m in _OWNER_RE.finditer(text):
                name = m.group(1) or m.group(2)
                if name:
                    ov = _subject_overlap(_sentence_around(text, m.start()), subject_terms)
                    candidates.append(
                        AnswerCandidate(name, "owner", item.frame_id, 2.0 * weight * (0.25 + 2.0 * ov))
                    )
        if "allerg" in low_q:
            for m in _ALLERGY_RE.finditer(text):
                candidates.append(AnswerCandidate(m.group(1), "allergy", item.frame_id, 2.0 * weight))
        if any(w in low_q for w in ("favorite", "favourite", "prefer", "love")):
            for m in _PREFERENCE_RE.finditer(text):
                candidates.append(
                    AnswerCandidate(m.group(1), "preference", item.frame_id, 1.5 * weight)
                )
        if any(w in low_q for w in ("dog", "cat", "pet", "labrador", "parrot", "name of")):
            for m in _PET_NAME_RE.finditer(text):
                candidates.append(AnswerCandidate(m.group(1), "pet-name", item.frame_id, 1.2 * weight))
        for m in _NAME_AFTER_IS_RE.finditer(text):
            candidates.append(AnswerCandidate(m.group(1), "copula", item.frame_id, 0.8 * weight))
        # entity-term sentences as weak generic candidates
        for ent in signals.entity_terms:
            if ent.lower() in text.lower():
                candidates.append(AnswerCandidate(ent, "entity-echo", item.frame_id, 0.2 * weight))
    if not candidates:
        return None
    candidates.sort(key=lambda c: (-c.score, c.lane, c.text))
    return candidates[0]
