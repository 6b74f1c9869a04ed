# Verbatim copy of wax_tpu/search/fts_preprocess.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""FTS query preprocessing — the reference's exact sanitize/expand pipeline.

Mirrors Sources/Wax/UnifiedSearch/UnifiedSearch.swift:
  * primary_fts_query (:565-581): a query containing NO ASCII punctuation passes
    RAW to MATCH (so `apple OR banana` keeps FTS5 OR semantics); anything with
    punctuation is rewritten to quoted phrases + quoted tokens joined by spaces
    (implicit AND) — which is how `"red bicycle" rides` reaches FTS5 as a phrase.
  * or_expanded_query (:550-563): quoted phrases + tokens joined with OR — the
    fallback lane.
  * normalized_fts_tokens (:1003-1025): split on whitespace + ASCII punctuation,
    lowercase, drop stopwords and tokens with no letters/digits, dedupe, cap 16.
  * raw_quoted_phrases (:1027-1066): "..." and '...' captures in position order,
    deduped case-insensitively, cap 4.
  * candidate_limit (:1195-1200): clamp(top_k * 3, top_k, 1000).
"""
from __future__ import annotations

import re

__all__ = [
    "primary_fts_query",
    "or_expanded_query",
    "normalized_fts_tokens",
    "normalized_quoted_phrases",
    "candidate_limit",
    "requires_safe_normalization",
    "FTS_STOP_WORDS",
]

_ASCII_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

# reference :997-1001
FTS_STOP_WORDS = frozenset(
    "a an and are at did do for from in is of on or the to what when where which who with date".split()
)

_QUOTED_RES = (re.compile(r'"([^"]+)"'), re.compile(r"'([^']+)'"))


def requires_safe_normalization(query: str) -> bool:
    """True when the query contains any ASCII punctuation (reference :991-995)."""
    return any(c in _ASCII_PUNCT for c in query)


def _alias_tokens(query: str) -> list[str]:
    """Split on whitespace and ASCII punctuation, preserving everything else
    (reference structuredAliasTokens :1172-1193)."""
    out: list[str] = []
    buf: list[str] = []
    for c in query:
        if c.isspace() or c in _ASCII_PUNCT:
            if buf:
                out.append("".join(buf))
                buf.clear()
        else:
            buf.append(c)
    if buf:
        out.append("".join(buf))
    return out


def _has_letters_or_digits(s: str) -> bool:
    return any(c.isalpha() or c.isdigit() for c in s)


def normalized_fts_tokens(query: str, max_tokens: int = 16) -> list[str]:
    if max_tokens <= 0:
        return []
    seen: set[str] = set()
    tokens: list[str] = []
    for tok in _alias_tokens(query):
        norm = tok.lower()
        if not norm or norm in FTS_STOP_WORDS or not _has_letters_or_digits(norm):
            continue
        if norm not in seen:
            seen.add(norm)
            tokens.append(norm)
            if len(tokens) >= max_tokens:
                break
    return tokens


def _raw_quoted_phrases(query: str, max_phrases: int = 4) -> list[str]:
    matches: list[tuple[int, str]] = []
    for rx in _QUOTED_RES:
        for m in rx.finditer(query):
            phrase = m.group(1).strip()
            if phrase:
                matches.append((m.start(1), phrase))
    matches.sort(key=lambda t: (t[0], len(t[1])))
    seen: set[str] = set()
    phrases: list[str] = []
    for _, phrase in matches:
        if len(phrases) >= max_phrases:
            break
        if not _has_letters_or_digits(phrase):
            continue
        key = phrase.lower()
        if key not in seen:
            seen.add(key)
            phrases.append(phrase)
    return phrases


def normalized_quoted_phrases(
    query: str, max_phrases: int = 4, max_tokens_per_phrase: int = 8
) -> list[str]:
    seen: set[str] = set()
    out: list[str] = []
    for phrase in _raw_quoted_phrases(query, max_phrases):
        tokens = normalized_fts_tokens(phrase, max_tokens_per_phrase)
        if not tokens:
            continue
        value = " ".join(tokens)
        if value not in seen:
            seen.add(value)
            out.append(value)
    return out


def _quote(s: str) -> str:
    return '"' + s.replace('"', '""') + '"'


def primary_fts_query(query: str, max_tokens: int = 16) -> str | None:
    """The first-pass MATCH string; None when nothing quotable survives
    (caller then uses the trimmed raw query, reference :100)."""
    if not requires_safe_normalization(query):
        return query
    clauses = [_quote(p) for p in normalized_quoted_phrases(query)]
    clauses += [_quote(t) for t in normalized_fts_tokens(query, max_tokens)]
    return " ".join(clauses) if clauses else None


def or_expanded_query(query: str, max_tokens: int = 16) -> str | None:
    clauses = [_quote(p) for p in normalized_quoted_phrases(query)]
    clauses += [_quote(t) for t in normalized_fts_tokens(query, max_tokens)]
    return " OR ".join(clauses) if clauses else None


def candidate_limit(top_k: int) -> int:
    if top_k <= 0:
        return 0
    return max(top_k, min(top_k * 3, 1000))
