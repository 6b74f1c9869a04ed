# Verbatim copy of wax_tpu/search/snippet.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""FTS5-parity snippet generation with [..] highlight markers.

The reference renders text-lane previews with SQLite's
`snippet(frames_fts, 0, '[', ']', '...', 10)` (reference:
Sources/WaxTextSearch/FTS5SearchEngine.swift:138-140) and uses the marked snippet
as the hit preview (UnifiedSearch.swift:196-198, :444-459). This module reproduces
that output on the host against the same unicode61 tokenization the index uses.

Window-selection algorithm (reverse-engineered from the real engine with positional
sweeps — see tests/test_fts5_parity.py::TestSnippetParity for the differential
evidence):

  * candidate windows: the [0, n) start-of-text window, plus one window anchored at
    every phrase-instance offset io ([io, io+n)), evaluated in position order;
  * window score: 1000 per DISTINCT query phrase present (start-in-window), +1 per
    repeat instance; the start-of-text window gets a small constant bonus (the exact
    engine constant is unobservable in [10, 990] — every comparison FTS5 can express
    lands outside that range — we use 100);
  * a strictly greater score replaces the incumbent (ties keep the earlier window);
  * an anchored winner is re-centered: start = iFirst - (n - (iLast-iFirst+1))//2,
    clamped to [0, n_tokens - n], where iFirst/iLast are the first instance start /
    last instance end inside the anchored window.

Rendering: raw document text from the window's first token start to its last token
end (inter-token punctuation preserved), '[' before each instance's first token and
']' after its last (overlapping instances merge, extending the close), with '...'
glued on each trimmed side.
"""
from __future__ import annotations

from wax_tpu_torch.index.lex import _FOLD_TRANS, _TOKEN_RUN_RE
from wax_tpu_torch.text.match_query import (
    MatchSyntaxError,
    Phrase,
    parse_match_query,
    query_phrases,
)

__all__ = ["fts5_snippet", "tokenize_spans", "phrase_token_spans", "snippet_for_query"]

_BOL_BONUS = 100
_PHRASE_HIT = 1000


def tokenize_spans(content: str) -> tuple[list[str], list[tuple[int, int]]]:
    """unicode61 tokens of `content` plus each token's (start, end) char span in
    the raw text (end exclusive) — the mapping FTS5 keeps as byte offsets."""
    terms: list[str] = []
    spans: list[tuple[int, int]] = []
    for m in _TOKEN_RUN_RE.finditer(content):
        t = m.group().translate(_FOLD_TRANS)
        if t:
            terms.append(t)
            spans.append((m.start(), m.end()))
    return terms, spans


def phrase_token_spans(terms: list[str], phrase: Phrase) -> list[tuple[int, int]]:
    """(start, end) inclusive token-index spans where `phrase` occurs in `terms`
    (prefix phrases match the last term by startswith; `first` anchors at 0)."""
    pts = phrase.terms
    m = len(pts)
    if m == 0 or len(terms) < m:
        return []
    out: list[tuple[int, int]] = []
    last = len(terms) - m
    for s in range(0, last + 1):
        if phrase.first and s != 0:
            break
        ok = True
        for i in range(m):
            t = terms[s + i]
            want = pts[i]
            if phrase.prefix and i == m - 1:
                if not t.startswith(want):
                    ok = False
                    break
            elif t != want:
                ok = False
                break
        if ok:
            out.append((s, s + m - 1))
    return out


def _pick_window(n_tok: int, insts: list[tuple[int, int, int]], n: int) -> int:
    """Start token of the chosen window. `insts` = (phrase_idx, start, end)
    sorted by (start, phrase_idx)."""
    if n_tok <= n:
        return 0

    def score_at(pos: int) -> tuple[int, int, int]:
        seen: set[int] = set()
        sc, first, last = 0, -1, -1
        for pi, s, e in insts:
            if pos <= s < pos + n:
                sc += 1 if pi in seen else _PHRASE_HIT
                seen.add(pi)
                if first < 0:
                    first = s
                last = e
        return sc, first, last

    best_sc, _, _ = score_at(0)
    best_sc += _BOL_BONUS
    best_start = 0
    for _, s, _ in insts:
        sc, first, last = score_at(s)
        if sc > best_sc:
            iadj = first - (n - (last - first + 1)) // 2
            iadj = min(iadj, n_tok - n)
            best_sc, best_start = sc, max(iadj, 0)
    return best_start


def fts5_snippet(
    content: str,
    phrase_instances: list[list[tuple[int, int]]],
    spans: list[tuple[int, int]],
    n_tokens: int = 10,
    mark_open: str = "[",
    mark_close: str = "]",
    ellipsis: str = "...",
) -> str:
    """Render the FTS5-equal snippet.

    Args:
      content: raw document text.
      phrase_instances: per query phrase, its (start, end) inclusive token spans.
      spans: char spans of every document token (from tokenize_spans).
      n_tokens: snippet window size (the reference passes 10).
    """
    n_tok = len(spans)
    if n_tok == 0:
        return ""
    insts = sorted(
        ((pi, s, e) for pi, lst in enumerate(phrase_instances) for s, e in lst),
        key=lambda t: (t[1], t[0]),
    )
    start = _pick_window(n_tok, insts, n_tokens)
    end = min(start + n_tokens, n_tok)  # exclusive token index

    # highlight regions within the window, merged on overlap (FTS5 extends the
    # pending close instead of nesting markers)
    regions: list[tuple[int, int]] = []  # (first_tok, last_tok) inclusive
    for _, s, e in insts:
        if not (start <= s < end):
            continue
        e = min(e, end - 1)
        if regions and s <= regions[-1][1] + 0:
            regions[-1] = (regions[-1][0], max(regions[-1][1], e))
        else:
            regions.append((s, e))

    out: list[str] = []
    if start > 0:
        out.append(ellipsis)
    cursor = spans[start][0]
    for rs, re_ in regions:
        a = spans[rs][0]
        b = spans[re_][1]
        out.append(content[cursor:a])
        out.append(mark_open)
        out.append(content[a:b])
        out.append(mark_close)
        cursor = b
    out.append(content[cursor : spans[end - 1][1]])
    if end < n_tok:
        out.append(ellipsis)
    return "".join(out)


def snippet_for_query(content: str, match_query: str, n_tokens: int = 10) -> str | None:
    """Snippet of `content` for an FTS5 MATCH query string; None when the query
    does not parse (caller falls back to a plain preview).

    Highlighted instances are the MATCHED-BRANCH ones (FTS5 keeps a phrase's
    poslist out of snippet/bm25 when its OR branch missed or NEAR pruned it —
    verified differentially): the query is evaluated against the document via the
    MATCH engine on a one-doc index, which applies exactly that filtering."""
    from wax_tpu_torch.index.lex import LexIndexBuilder
    from wax_tpu_torch.search.match import match_search

    try:
        node = parse_match_query(match_query)
    except MatchSyntaxError:
        return None
    terms, spans = tokenize_spans(content)
    b = LexIndexBuilder()
    b.add(0, content)
    hits = match_search(b, match_query, 1)
    if hits:
        instances: list[list[tuple[int, int]]] = [list(i) for i in hits[0].instances]
    else:
        # the document does not match this query (defensive path): fall back to
        # unfiltered phrase occurrences
        instances = [phrase_token_spans(terms, ph) for ph in query_phrases(node)]
    return fts5_snippet(content, instances, spans, n_tokens=n_tokens)
