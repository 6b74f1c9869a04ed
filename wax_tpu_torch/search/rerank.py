# Verbatim copy of wax_tpu/search/rerank.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Deterministic intent-aware reranking.

Full-fidelity port of the reference's two calibrated rerank passes (the weights are
behavioral spec, replicated for capability parity):

* `intent_aware_rerank` — the search-results pass
  (reference: Sources/Wax/UnifiedSearch/UnifiedSearch.swift:701-1010). Lower
  recall/precision weights than the answer pass (false positives are more visible on
  a results page), separate numeric/alpha entity scoring with a higher numeric weight
  (queries disambiguate via ids like "atlas10"), and the broader distractor set.
* `rerank_for_answer` — the context-assembly pass
  (reference: Sources/Wax/RAG/FastRAGContextBuilder.swift:384-506). Higher recall and
  entity-coverage weights (answer extraction depends on entity presence), the narrower
  distractor set plus "no authoritative" confidence-undermining language.

Both are pure host functions over (original score, preview/content text, query
signals): permutation-stable, deterministic, tie-broken by (composite desc, original
score desc, frame id asc) exactly as the reference (:783-791, :495-501).
"""
from __future__ import annotations

import re
from typing import Callable, Sequence

from wax_tpu_torch.text.analyzer import QuerySignals, analyze_query

__all__ = [
    "intent_aware_rerank",
    "rerank_for_answer",
    "looks_distractor_like",
    "looks_distractor",
    "contains_tentative_launch_language",
]

_MOVED_TO_RE = re.compile(r"\b(?:moved|move)\s+to\s+[A-Z][a-z]+(?:\s+[A-Z][a-z]+)?\b")
_HIGHLIGHT_RE = re.compile(r"</?(?:b|em|mark)>")


def contains_tentative_launch_language(text: str) -> bool:
    """(reference: Utilities/RerankingHelpers.swift:10-19)"""
    return any(
        p in text
        for p in (
            "tentative", "draft", "proposed", "pending approval",
            "target is", "target date", "could be", "estimate",
        )
    )


def looks_distractor_like(text: str) -> bool:
    """Broad search-results distractor set (reference: UnifiedSearch.swift:945-958)."""
    return any(
        p in text
        for p in (
            "weekly report", "checklist", "signoff", "allergic",
            "distractor", "draft memo", "tentative", "pending approval",
        )
    )


def looks_distractor(text: str) -> bool:
    """Narrow answer-assembly distractor set incl. confidence-undermining language
    (reference: FastRAGContextBuilder.swift:506-513)."""
    return any(
        p in text for p in ("no authoritative", "weekly report", "checklist", "signoff")
    )


def _is_digits(t: str) -> bool:
    return bool(t) and t.isdigit()


def _is_alpha(t: str) -> bool:
    return bool(t) and t.isalpha()


def _has_digits(t: str) -> bool:
    return any(c.isdigit() for c in t)


def _dehighlight(preview: str) -> str:
    return _HIGHLIGHT_RE.sub("", preview)


def _normalized_phrase_text(text: str) -> str:
    return re.sub(r"[^a-z0-9]+", " ", text.lower()).strip()


def intent_aware_rerank(
    hits: Sequence,
    previews: dict[int, str],
    signals: QuerySignals,
    window: int,
    vector_influenced: Callable[[object], bool],
) -> list:
    """Rerank the head window of fused search results by the composite intent score.

    Args:
      hits: fused SearchHit list (must expose .frame_id/.score).
      previews: frame_id -> preview text.
      signals: analyze_query() output for the query.
      window: head size to rerank (reference: maxWindow, default 12).
      vector_influenced: hit -> bool (vector lane contributed to this hit).
    """
    window = min(max(0, window), len(hits))
    if window <= 1:
        return list(hits)

    q_terms = set(signals.content_terms)
    q_entities = {e.lower() for e in signals.entity_terms}
    q_years = set(signals.years)
    q_date_keys = set(signals.date_keys)
    raw_phrases = [p.lower() for p in signals.quoted_phrases]
    norm_phrases = [_normalized_phrase_text(p) for p in signals.quoted_phrases if p]
    q_numeric_entities = {e for e in q_entities if _has_digits(e)}
    q_alpha_entities = {e for e in q_entities if _is_alpha(e)}
    q_numeric_terms = {t for t in q_terms if _is_digits(t)}

    has_target_intent = signals.asks_location or signals.asks_date or signals.asks_ownership
    has_disambiguation = bool(
        q_entities or q_years or q_date_keys or raw_phrases or norm_phrases
    )
    if not has_target_intent or not has_disambiguation:
        return list(hits)

    strict_raw = [p for p in raw_phrases if "-" in p or len(p.split()) >= 2]

    def composite(hit) -> float:
        total = float(hit.score)
        preview = previews.get(hit.frame_id) or ""
        if not preview:
            return total
        comparable = _dehighlight(preview)
        psig = analyze_query(comparable)
        p_terms = set(psig.content_terms)
        p_entities = {e.lower() for e in psig.entity_terms}
        p_years = set(psig.years)
        p_date_keys = set(psig.date_keys)
        p_alpha_entities = {e for e in p_entities if _is_alpha(e)}
        lower = comparable.lower()
        norm_lower = _normalized_phrase_text(comparable)
        vec = vector_influenced(hit)

        if q_terms and p_terms:
            overlap = len(q_terms & p_terms)
            total += (overlap / max(1, len(q_terms))) * 0.55
            total += (overlap / max(1, len(p_terms))) * 0.25

        if q_entities:
            entity_hits = len(q_entities & p_entities)
            if q_numeric_entities:
                total += (len(q_numeric_entities & p_entities) / len(q_numeric_entities)) * 1.95
            if q_alpha_entities:
                total += (len(q_alpha_entities & p_alpha_entities) / len(q_alpha_entities)) * 1.25
            total += (entity_hits / len(q_entities)) * 0.30
            if entity_hits == 0:
                total -= 0.85 if q_numeric_entities else 0.45
                if q_numeric_terms and q_numeric_terms & p_terms:
                    total -= 0.75
            if q_alpha_entities and not (q_alpha_entities & p_alpha_entities) and p_alpha_entities:
                total -= 0.40

        if q_years:
            year_hits = len(q_years & p_years)
            total += (year_hits / len(q_years)) * 1.25
            if year_hits == 0 and p_years:
                total -= 1.10

        if q_date_keys:
            date_hits = len(q_date_keys & p_date_keys)
            total += (date_hits / len(q_date_keys)) * 1.15
            if date_hits == 0 and p_date_keys:
                total -= 0.95

        if raw_phrases:
            exact_hits = sum(1 for p in raw_phrases if p in lower)
            strict_hits = sum(1 for p in strict_raw if p in lower)
            strict_intent = bool(strict_raw)
            if exact_hits > 0:
                total += exact_hits * (2.10 if strict_intent else 1.20)
            else:
                total -= 1.40 if strict_intent else 0.35
            strict_misses = len(strict_raw) - strict_hits
            if strict_misses > 0:
                total -= strict_misses * 0.85

        if norm_phrases:
            norm_hits = sum(1 for p in norm_phrases if p and p in norm_lower)
            strict_miss = bool(strict_raw) and not any(p in lower for p in strict_raw)
            total += (norm_hits / max(1, len(norm_phrases))) * (0.20 if strict_miss else 0.75)
            if strict_miss:
                total -= 0.55
            if norm_hits == 0:
                total -= 0.45 if strict_miss else 0.20

        if signals.asks_location:
            if _MOVED_TO_RE.search(comparable):
                total += 1.60
            elif "moved to" in lower or "move to" in lower:
                total += 0.45
            elif "city" in lower:
                total += 0.10
            if "without a destination" in lower or "city move" in lower or "retrospective" in lower:
                total -= 0.75
            if "allergic" in lower or "health" in lower or "peanut" in lower:
                total -= 1.10
            if "prefers" in lower or "prefer" in lower:
                total -= 0.55

        if signals.asks_date:
            tentative = contains_tentative_launch_language(lower)
            if "public launch is" in lower and not tentative:
                total += 1.70
            elif "public launch" in lower or psig.date_literals:
                total += 1.20
            if tentative:
                total -= max(2.90 if vec else 2.45, float(hit.score) * (1.60 if vec else 1.40))
            if "draft memo" in lower:
                total -= 1.45 if vec else 1.20
            if " owns " in lower or "owner" in lower or "deployment readiness" in lower:
                total -= 0.40

        if signals.asks_ownership:
            if " owns " in lower or "owner" in lower or "owns deployment readiness" in lower:
                total += 1.10
            if "public launch" in lower and " owns " not in lower:
                total -= 0.35

        if looks_distractor_like(lower):
            total -= 0.40
        return total

    scored = [(composite(h), h) for h in hits[:window]]
    scored.sort(key=lambda t: (-t[0], -t[1].score, t[1].frame_id))
    return [h for _, h in scored] + list(hits[window:])


def rerank_for_answer(
    hits: Sequence,
    contents: Callable[[int], str],
    signals: QuerySignals,
    window: int,
    distractor_penalty: float,
    vector_influenced: bool,
) -> list:
    """Answer-focused rerank of the context-assembly head window
    (reference: FastRAGContextBuilder.rerankCandidatesForAnswer :384-506)."""
    window = min(max(0, window), len(hits))
    if window <= 1:
        return list(hits)
    q_terms = set(signals.content_terms)
    q_entities = {e.lower() for e in signals.entity_terms}
    q_years = set(signals.years)
    q_date_keys = set(signals.date_keys)
    if not signals.intents and not q_terms:
        return list(hits)

    def score(hit) -> float:
        total = float(hit.score)
        preview = contents(hit.frame_id) or ""
        if not preview:
            return total
        lower = preview.lower()
        psig = analyze_query(preview)
        p_terms = set(psig.content_terms)
        p_entities = {e.lower() for e in psig.entity_terms}
        p_years = set(psig.years)
        p_date_keys = set(psig.date_keys)

        if q_terms and p_terms:
            overlap = len(q_terms & p_terms)
            total += (overlap / max(1, len(q_terms))) * 0.80
            total += (overlap / max(1, len(p_terms))) * 0.40

        if q_entities:
            ehits = len(q_entities & p_entities)
            total += (ehits / len(q_entities)) * (1.25 if vector_influenced else 0.90)
            if ehits == 0:
                total -= 0.65 if vector_influenced else 0.35

        if q_years:
            yhits = len(q_years & p_years)
            total += (yhits / len(q_years)) * 1.35
            if yhits == 0 and p_years:
                total -= 1.35 if vector_influenced else 1.05

        if q_date_keys:
            dhits = len(q_date_keys & p_date_keys)
            total += (dhits / len(q_date_keys)) * 1.15
            if dhits == 0 and p_date_keys:
                total -= 1.15 if vector_influenced else 0.90

        if signals.asks_location and "moved to" in lower:
            total += 0.45
        if signals.asks_date and (
            "public launch" in lower or "launch is" in lower or psig.date_literals
        ):
            total += 0.45
        if signals.asks_date and contains_tentative_launch_language(lower):
            total -= distractor_penalty * (2.8 if vector_influenced else 1.8)
        if signals.asks_ownership and (
            "owns deployment readiness" in lower or " owns " in lower
        ):
            total += 0.45
        if looks_distractor(lower):
            total -= distractor_penalty * (2.2 if vector_influenced else 1.0)
            if vector_influenced and signals.asks_date and not psig.date_literals:
                total -= 0.35
        return total

    head = list(hits[:window])
    head.sort(key=lambda h: (-score(h), -h.score, h.frame_id))
    return head + list(hits[window:])
