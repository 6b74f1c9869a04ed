# Verbatim copy of wax_tpu/text/match_query.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""FTS5 MATCH query parser — the syntax the reference feeds to SQLite verbatim.

The reference passes the raw user query to FTS5 MATCH (reference:
Sources/WaxTextSearch/FTS5SearchEngine.swift:143), so quoted phrases, `tok*`
prefixes, NEAR groups, AND/OR/NOT operators, `+` phrase concatenation and the `^`
first-token anchor all shape retrieval. This module parses that grammar into a small
AST evaluated by wax_tpu/search/match.py.

Grammar and semantics were verified empirically against this environment's SQLite
FTS5 (tests/test_fts5_parity.py drives the same engine differentially):

  expr      := and_chain (OR and_chain)*            # OR lowest precedence
  and_chain := not_chain (AND not_chain)*
  not_chain := unit (NOT unit)*                     # binary NOT, highest precedence
  unit      := '(' expr ')' | nearset+              # implicit AND chains ONLY
                                                    # phrases/NEAR groups — a paren
                                                    # group next to a phrase is a
                                                    # syntax error, like FTS5
  nearset   := phrase_seq | NEAR '(' phrase_seq+ (',' NUMBER)? ')'
  phrase_seq:= phrase ('+' phrase)*                 # '+' concatenates into one phrase
  phrase    := ('^')? (bareword | quoted) ('*')?    # '*' = prefix on last token

Operators are case-sensitive (``near(...)`` is a bareword, like FTS5). Barewords
allow [0-9A-Za-z_] plus any non-ASCII character; all other punctuation outside
quotes is a syntax error — the same errors the reference surfaces for queries like
``what's`` (FTS5 raises ``fts5: syntax error near "'"``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from wax_tpu_torch.index.lex import analyze

__all__ = [
    "MatchSyntaxError",
    "Phrase",
    "Near",
    "BoolNode",
    "parse_match_query",
    "query_phrases",
    "has_match_syntax",
    "DEFAULT_NEAR_DISTANCE",
]

DEFAULT_NEAR_DISTANCE = 10


class MatchSyntaxError(ValueError):
    """FTS5-style syntax error (mirrors SQLite's `fts5: syntax error near ...`)."""


@dataclass(frozen=True)
class Phrase:
    """One FTS5 phrase: a sequence of analyzed terms that must occur adjacently.

    `prefix` marks the LAST term as a prefix pattern (``tok*`` / ``"a b"*``);
    `first` anchors the match at token position 0 (``^tok``).
    """

    terms: tuple[str, ...]
    prefix: bool = False
    first: bool = False


@dataclass(frozen=True)
class Near:
    """NEAR(p1 p2 ... pn, N): every pair of phrase instances within N intervening
    tokens (verified pairwise, instance-minimized — FTS5 semantics)."""

    phrases: tuple[Phrase, ...]
    distance: int = DEFAULT_NEAR_DISTANCE


@dataclass(frozen=True)
class BoolNode:
    op: str  # "and" | "or" | "not"
    left: object
    right: object


# Token kinds: ( ) , * + ^ caret handled inline; AND/OR/NOT/NEAR exact-case keywords.
_BAREWORD_RE = re.compile(r"[0-9A-Za-z_-\U0010FFFF]+")
_NUMBER_RE = re.compile(r"[0-9]+")


@dataclass
class _Tok:
    kind: str  # "word" | "quoted" | "(" | ")" | "," | "*" | "+" | "^" | ":"
    text: str = ""
    pos: int = 0


def _lex(q: str) -> list[_Tok]:
    toks: list[_Tok] = []
    i, n = 0, len(q)
    while i < n:
        c = q[i]
        if c.isspace():
            i += 1
            continue
        if c in "(),*+^:":
            toks.append(_Tok(c, c, i))
            i += 1
            continue
        if c == '"':
            j = q.find('"', i + 1)
            if j < 0:
                raise MatchSyntaxError("unterminated string")
            toks.append(_Tok("quoted", q[i + 1 : j], i))
            i = j + 1
            continue
        m = _BAREWORD_RE.match(q, i)
        if m:
            toks.append(_Tok("word", m.group(0), i))
            i = m.end()
            continue
        raise MatchSyntaxError(f'fts5: syntax error near "{c}"')
    return toks


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> _Tok | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> _Tok | None:
        t = self.peek()
        if t is not None:
            self.i += 1
        return t

    def error(self, t: _Tok | None):
        near = t.text if t is not None else ""
        raise MatchSyntaxError(f'fts5: syntax error near "{near}"')

    # expr := and_chain (OR and_chain)*
    def expr(self):
        node = self.and_chain()
        while self._keyword("OR"):
            node = BoolNode("or", node, self.and_chain())
        return node

    def and_chain(self):
        node = self.not_chain()
        while self._keyword("AND"):
            node = BoolNode("and", node, self.not_chain())
        return node

    def not_chain(self):
        node = self.unit()
        while self._keyword("NOT"):
            node = BoolNode("not", node, self.unit())
        return node

    def _keyword(self, kw: str) -> bool:
        t = self.peek()
        if t is not None and t.kind == "word" and t.text == kw:
            self.i += 1
            return True
        return False

    def _at_keyword(self) -> bool:
        t = self.peek()
        return t is not None and t.kind == "word" and t.text in ("AND", "OR", "NOT")

    def unit(self):
        t = self.peek()
        if t is None:
            self.error(t)
        if t.kind == "(":
            self.next()
            node = self.expr()
            t2 = self.next()
            if t2 is None or t2.kind != ")":
                self.error(t2)
            return node
        # implicit-AND chain of nearsets (phrases / NEAR groups) — parens may NOT
        # appear inside the chain (FTS5: `(a OR x) b` is a syntax error)
        node = self.nearset()
        while True:
            nxt = self.peek()
            if nxt is None or self._at_keyword() or nxt.kind in (")", ","):
                break
            if nxt.kind == "(":
                self.error(nxt)
            node = BoolNode("and", node, self.nearset())
        return node

    def nearset(self):
        t = self.peek()
        if t is not None and t.kind == "word" and t.text == "NEAR":
            nxt = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None
            if nxt is not None and nxt.kind == "(":
                self.i += 2
                phrases = [self.phrase_seq()]
                while True:
                    t2 = self.peek()
                    if t2 is None:
                        self.error(t2)
                    if t2.kind in (",", ")"):
                        break
                    phrases.append(self.phrase_seq())
                dist = DEFAULT_NEAR_DISTANCE
                if self.peek() is not None and self.peek().kind == ",":
                    self.next()
                    tn = self.next()
                    if tn is None or tn.kind != "word" or not _NUMBER_RE.fullmatch(tn.text):
                        self.error(tn)
                    dist = int(tn.text)
                tc = self.next()
                if tc is None or tc.kind != ")":
                    self.error(tc)
                if len(phrases) == 1:
                    return phrases[0]
                return Near(tuple(phrases), dist)
        return self.phrase_seq()

    def phrase_seq(self) -> Phrase:
        terms, prefix, first = self._one_phrase()
        while self.peek() is not None and self.peek().kind == "+":
            if prefix:
                self.error(self.peek())
            self.next()
            t2, p2, f2 = self._one_phrase()
            if f2:
                self.error(self.peek())
            terms += t2
            prefix = p2
        return Phrase(tuple(terms), prefix=prefix, first=first)

    def _one_phrase(self):
        first = False
        t = self.peek()
        if t is not None and t.kind == "^":
            self.next()
            first = True
            t = self.peek()
        if t is None or t.kind not in ("word", "quoted"):
            self.error(t)
        self.next()
        if t.kind == "word" and t.text in ("AND", "OR", "NOT", "NEAR"):
            # operators are not phrases (`AND` alone is a syntax error in FTS5)
            self.error(t)
        if self.peek() is not None and self.peek().kind == ":":
            raise MatchSyntaxError(f"no such column: {t.text}")
        terms = tuple(analyze(t.text))
        prefix = False
        if self.peek() is not None and self.peek().kind == "*":
            self.next()
            prefix = True
            nxt = self.peek()
            if nxt is not None and nxt.kind == "*":
                self.error(nxt)
        return terms, prefix, first


def parse_match_query(query: str):
    """Parse an FTS5 MATCH string into Phrase / Near / BoolNode nodes.

    Raises MatchSyntaxError on the same inputs SQLite FTS5 rejects (verified
    differentially in tests/test_fts5_parity.py).
    """
    toks = _lex(query)
    if not toks:
        raise MatchSyntaxError('fts5: syntax error near ""')
    p = _Parser(toks)
    node = p.expr()
    if p.peek() is not None:
        p.error(p.peek())
    return node


def query_phrases(node) -> list[Phrase]:
    """All phrases in the query, in parse order — FTS5's bm25() scores a row by
    summing contributions of EVERY phrase in the expression (including ones under
    NOT or unmatched OR branches, which contribute tf=0)."""
    out: list[Phrase] = []

    def walk(n):
        if isinstance(n, Phrase):
            out.append(n)
        elif isinstance(n, Near):
            out.extend(n.phrases)
        elif isinstance(n, BoolNode):
            walk(n.left)
            walk(n.right)

    walk(node)
    return out


# A bare comma is natural punctuation, not MATCH syntax — the comma that IS
# syntax (NEAR's argument separator) always co-occurs with "NEAR(" / parens.
_SYNTAX_CHARS = re.compile(r'["*()^+:]|\bAND\b|\bOR\b|\bNOT\b|\bNEAR\(')


def has_match_syntax(query: str) -> bool:
    """Cheap detector: does this query use FTS5 MATCH syntax (phrases, prefixes,
    NEAR, booleans) that the bag-of-terms device lane cannot express?"""
    return bool(_SYNTAX_CHARS.search(query))
