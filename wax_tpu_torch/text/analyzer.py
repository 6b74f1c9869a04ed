# Verbatim copy of wax_tpu/text/analyzer.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Deterministic query signal extraction.

Mirrors the reference's QueryAnalyzer (reference: Sources/Wax/RAG/QueryAnalyzer.swift:3-247):
entity terms, date literals/years, quoted phrases, a specificity score, and an intent
set {asks_location, asks_date, asks_ownership, multi_hop}. Pure host logic used by
intent-aware reranking and the RAG builder.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["QuerySignals", "analyze_query"]

_QUOTED_RE = re.compile(r'"([^"]+)"|\'([^\']+)\'')
_YEAR_RE = re.compile(r"\b(19|20)\d{2}\b")
_DATE_RE = re.compile(
    r"\b(\d{1,2}[/-]\d{1,2}([/-]\d{2,4})?|"
    r"(january|february|march|april|may|june|july|august|september|october|november|december)"
    r"(\s+\d{1,2})?)\b",
    re.IGNORECASE,
)
_LOCATION_RE = re.compile(r"\b(where|location|located|city|country|address|place)\b", re.IGNORECASE)
_DATE_INTENT_RE = re.compile(r"\b(when|what\s+(date|day|time|year)|how\s+long\s+ago)\b", re.IGNORECASE)
_OWNER_RE = re.compile(r"\b(whose|who\s+owns?|belongs?\s+to|owner)\b", re.IGNORECASE)
_MULTIHOP_RE = re.compile(r"\b(and\s+(then|also)|both|as\s+well\s+as)\b|\?.*\?", re.IGNORECASE | re.DOTALL)
_STOPWORDS = frozenset(
    "a an the and or but of in on at to for from with by is are was were be been do does did "
    "i you he she it we they my your his her its our their what who where when which how why "
    "me him them us this that these those as if then than so not no yes".split()
)
_WORD_RE = re.compile(r"[A-Za-z0-9][\w'-]*")


_MONTHS = {
    m: i + 1
    for i, m in enumerate(
        "january february march april may june july august september october november december".split()
    )
}
_NUM_DATE_RE = re.compile(r"\b(\d{1,2})[/-](\d{1,2})(?:[/-](\d{2,4}))?\b")
_MONTH_DAY_RE = re.compile(
    r"\b(january|february|march|april|may|june|july|august|september|october|november|december)"
    r"(?:\s+(\d{1,2}))?(?:,?\s+((?:19|20)\d{2}))?\b",
    re.IGNORECASE,
)


_ISO_DATE_RE = re.compile(r"\b(\d{4})-(\d{1,2})-(\d{1,2})\b")


def date_keys(text: str) -> tuple[str, ...]:
    """Canonical date keys ("MM-DD" / "YYYY-MM-DD") from date literals, so "March 14",
    "3/14" and "2024-03-14" compare equal during reranking (reference: QueryAnalyzer
    normalizedDateKeys, QueryAnalyzer.swift). Year-qualified literals emit BOTH the
    full key and the bare MM-DD key, so a year-less mention still anchors to them.
    """
    keys: list[str] = []

    def emit(mo: int, day: int, year: int | None) -> None:
        if not (1 <= mo <= 12 and 1 <= day <= 31):
            return
        bare = f"{mo:02d}-{day:02d}"
        if year is not None:
            keys.append(f"{year:04d}-{bare}")
        keys.append(bare)

    iso_spans = []
    for m in _ISO_DATE_RE.finditer(text):
        emit(int(m.group(2)), int(m.group(3)), int(m.group(1)))
        iso_spans.append(m.span())
    # mask ISO matches so the M/D[/Y] pass cannot re-parse their "MM-DD" tail
    masked = text
    for a, b in reversed(iso_spans):
        masked = masked[:a] + " " * (b - a) + masked[b:]
    for m, d, y in _NUM_DATE_RE.findall(masked):
        year = None
        if y:
            yy = int(y)
            year = yy + (2000 if yy < 70 else 1900) if yy < 100 else yy
        emit(int(m), int(d), year)
    for name, d, y in _MONTH_DAY_RE.findall(text):
        if not d:
            continue
        emit(_MONTHS[name.lower()], int(d), int(y) if y else None)
    return tuple(dict.fromkeys(keys))


@dataclass(frozen=True)
class QuerySignals:
    entity_terms: tuple[str, ...] = ()
    content_terms: tuple[str, ...] = ()
    quoted_phrases: tuple[str, ...] = ()
    years: tuple[str, ...] = ()
    date_literals: tuple[str, ...] = ()
    date_keys: tuple[str, ...] = ()
    specificity: float = 0.0
    asks_location: bool = False
    asks_date: bool = False
    asks_ownership: bool = False
    multi_hop: bool = False
    intents: frozenset[str] = field(default_factory=frozenset)


def analyze_query(query: str) -> QuerySignals:
    quoted = tuple(a or b for a, b in _QUOTED_RE.findall(query))
    years = tuple(m.group(0) for m in _YEAR_RE.finditer(query))
    dates = tuple(m.group(0) for m in _DATE_RE.finditer(query))

    words = _WORD_RE.findall(query)
    # entity terms: capitalized tokens that are not sentence-initial, plus all-caps
    entities: list[str] = []
    for i, w in enumerate(words):
        if len(w) < 2 or w.lower() in _STOPWORDS:
            continue
        if w.isupper() or (w[0].isupper() and i > 0):
            entities.append(w)
    content = tuple(w.lower() for w in words if w.lower() not in _STOPWORDS and len(w) > 1)

    asks_location = bool(_LOCATION_RE.search(query))
    asks_date = bool(_DATE_INTENT_RE.search(query)) or bool(years)
    asks_ownership = bool(_OWNER_RE.search(query))
    multi_hop = bool(_MULTIHOP_RE.search(query))

    # specificity: fraction of non-stopword tokens + bonuses for quoted/entity/date anchors
    n = max(1, len(words))
    spec = len(content) / n
    spec += 0.2 * bool(quoted) + 0.15 * bool(entities) + 0.15 * bool(years or dates)
    spec = min(1.0, spec)

    intents = frozenset(
        name
        for name, on in [
            ("asks_location", asks_location),
            ("asks_date", asks_date),
            ("asks_ownership", asks_ownership),
            ("multi_hop", multi_hop),
        ]
        if on
    )
    return QuerySignals(
        entity_terms=tuple(dict.fromkeys(entities)),
        content_terms=tuple(dict.fromkeys(content)),
        quoted_phrases=quoted,
        years=years,
        date_literals=dates,
        date_keys=date_keys(query),
        specificity=spec,
        asks_location=asks_location,
        asks_date=asks_date,
        asks_ownership=asks_ownership,
        multi_hop=multi_hop,
        intents=intents,
    )
