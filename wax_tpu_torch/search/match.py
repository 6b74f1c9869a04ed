# Port of wax_tpu/search/match.py: the JAX module's semantics over a position
# index of the port builder's token log (see the docstring). Keep the two in step.
"""FTS5 MATCH evaluation engine — phrase / prefix / NEAR / boolean retrieval.

The reference gets this whole surface for free by passing the raw query to SQLite
FTS5 (reference: Sources/WaxTextSearch/FTS5SearchEngine.swift:143 MATCH + :129-161
bm25() ranking). wax-tpu's device BM25 lane (ops/bm25.py) covers bag-of-terms AND/OR;
this module adds the positional subset on the host: it parses the MATCH grammar
(text/match_query.py), evaluates phrases against per-document token sequences kept by
the LexIndexBuilder, and scores with SQLite's exact bm25 formula — idf clamped at
1e-6, per-phrase tf, rank = -score — so result sets AND rank order are differentially
testable against a real FTS5 table (tests/test_fts5_parity.py).

Work model: candidate docs come from postings intersections (host dict/CSR lookups),
then only candidates are position-verified — the same work FTS5's doclist+position
merge does. This lane is host-side by design: phrase queries narrow to small
candidate sets, and round-tripping variable-length position lists through the TPU
would cost more than it saves (the dense/BM25 bulk lanes stay on device).

PyTorch port of `wax_tpu.search.match`: the same grammar, matched-branch rules, NEAR
pruning and float64 bm25, evaluated over whole arrays. A position index of the
builder's token log (every token's row, and the positions of each term id in order),
cached per builder generation, finds a phrase's instances in every live row at once,
where the JAX module verifies candidate rows one at a time in Python; boolean nodes
are row masks, and each slot's bm25 term is added over all rows in slot order, so
scores and order equal the JAX module's. NEAR keeps the JAX module's per-row rule on
the rows all its phrases share.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass

import numpy as np

from wax_tpu_torch.index.lex import BM25_B, BM25_K1, LexIndexBuilder
from wax_tpu_torch.text.match_query import (
    BoolNode,
    MatchSyntaxError,
    Near,
    Phrase,
    parse_match_query,
)

__all__ = ["match_search", "MatchHit", "MatchSyntaxError", "phrase_instances_in"]


@dataclass(frozen=True)
class MatchHit:
    frame_id: int
    score: float  # -rank: SQLite bm25() negated (reference scoreFromBM25Rank :966)
    row: int
    # instance (start, end) token spans of every query phrase in this doc, parse
    # order — feeds snippet highlighting (FTS5 snippet() parity, unified.py)
    instances: tuple[tuple[tuple[int, int], ...], ...]


# ---------------------------------------------------------------------------------
# Builder access: the position index of the token log, and prefix expansion
# ---------------------------------------------------------------------------------


class _PositionIndex:
    """Token log of a builder generation as arrays: `tok` [L] term id per position,
    `off` [N+1] row offsets, `pos_row` [L] row of each position, `by_tid` [L] positions
    grouped by term id (ascending within a term) with offsets `tid_off` [T+1]; and the
    rows' `active` flags, frame ids, lengths `dls` (f64), `avgdl` and `n_live`."""

    def __init__(self, builder: LexIndexBuilder):
        self.tok, self.off = builder.token_log()
        n = len(self.off) - 1
        self.pos_row = np.repeat(np.arange(n, dtype=np.int64), np.diff(self.off))
        self.by_tid = np.argsort(self.tok, kind="stable")
        t = len(builder._vocab)
        self.tid_off = np.zeros(t + 1, np.int64)
        if t:
            np.cumsum(np.bincount(self.tok, minlength=t), out=self.tid_off[1:])
        self.active = np.asarray(builder._active, bool)
        self.fids = np.asarray(builder._frame_ids, np.int64) if builder._frame_ids else np.zeros(0, np.int64)
        self.dls = np.asarray(builder._doc_len, np.float64) if builder._doc_len else np.zeros(0)
        self.n_live = max(1, int(self.active.sum()))
        avgdl = float(self.dls[self.active].sum() / self.n_live) if len(self.dls) else 1.0
        self.avgdl = max(avgdl, 1e-9)

    @property
    def n_rows(self) -> int:
        return len(self.active)

    def positions(self, tid: int) -> np.ndarray:
        return self.by_tid[self.tid_off[tid] : self.tid_off[tid + 1]]


def _position_index(builder: LexIndexBuilder) -> _PositionIndex:
    """The builder's position index, cached per builder generation."""
    cache = getattr(builder, "_match_index_cache", None)
    if cache is not None and cache[0] == builder.generation:
        return cache[1]
    idx = _PositionIndex(builder)
    builder._match_index_cache = (builder.generation, idx)
    return idx


def _sorted_vocab(builder: LexIndexBuilder) -> list[str]:
    """Sorted vocab list for prefix expansion, cached per builder generation."""
    cache = getattr(builder, "_match_vocab_cache", None)
    if cache is not None and cache[0] == builder.generation:
        return cache[1]
    terms = sorted(builder._vocab.keys())
    builder._match_vocab_cache = (builder.generation, terms)
    return terms


def _expand_prefix(builder: LexIndexBuilder, prefix: str) -> list[int]:
    """Term ids of every vocab term starting with `prefix` (FTS5 `tok*`)."""
    terms = _sorted_vocab(builder)
    lo = bisect.bisect_left(terms, prefix)
    hi = bisect.bisect_left(terms, prefix + "\uffff")
    return [builder._vocab[t] for t in terms[lo:hi]]


# ---------------------------------------------------------------------------------
# Phrase instance computation
# ---------------------------------------------------------------------------------


def phrase_instances_in(seq: np.ndarray, tids: list[object], first: bool) -> list[tuple[int, int]]:
    """Instances of a phrase in one token-id sequence.

    `tids` entries are either an int term id or a frozenset of ids (prefix slot).
    Returns (start, end) spans, leftmost first.
    """
    m = len(tids)
    n = len(seq)
    if m == 0 or n < m:
        return []
    t0 = tids[0]
    if isinstance(t0, frozenset):
        starts = np.nonzero(np.isin(seq[: n - m + 1], list(t0)))[0]
    else:
        starts = np.nonzero(seq[: n - m + 1] == t0)[0]
    if first:
        starts = starts[starts == 0]
    for i in range(1, m):
        if len(starts) == 0:
            return []
        ti = tids[i]
        nxt = seq[starts + i]
        if isinstance(ti, frozenset):
            starts = starts[np.isin(nxt, list(ti))]
        else:
            starts = starts[nxt == ti]
    return [(int(s), int(s) + m - 1) for s in starts]


class _PhraseEval:
    """Per-phrase match data: the instances of the phrase in every live row, as
    arrays `inst_row` (ascending) and `inst_start` (token offset in its row, ascending
    within a row); `mask` marks the rows with an instance."""

    def __init__(self, builder: LexIndexBuilder, phrase: Phrase, idx: _PositionIndex):
        self.phrase = phrase
        vocab = builder._vocab
        tids: list[object] = []
        self.empty = False
        for i, term in enumerate(phrase.terms):
            if phrase.prefix and i == len(phrase.terms) - 1:
                exp = _expand_prefix(builder, term)
                if not exp:
                    self.empty = True
                    break
                tids.append(frozenset(exp) if len(exp) > 1 else exp[0])
            else:
                tid = vocab.get(term)
                if tid is None:
                    self.empty = True
                    break
                tids.append(tid)
        if not phrase.terms:
            self.empty = True
        self.tids = tids
        self.inst_row = np.zeros(0, np.int64)
        self.inst_start = np.zeros(0, np.int64)
        self.mask = np.zeros(idx.n_rows, bool)
        if self.empty:
            return
        m = len(tids)
        t0 = tids[0]
        if isinstance(t0, frozenset):
            p = np.sort(np.concatenate([idx.positions(x) for x in t0]))
        else:
            p = idx.positions(t0)
        rows = idx.pos_row[p]
        # live rows, the phrase within its row, and `^` at the row's first token
        keep = idx.active[rows] & (p + (m - 1) < idx.off[rows + 1])
        if phrase.first:
            keep &= p == idx.off[rows]
        p, rows = p[keep], rows[keep]
        for i in range(1, m):
            ti = tids[i]
            nxt = idx.tok[p + i]
            keep = np.isin(nxt, list(ti)) if isinstance(ti, frozenset) else nxt == ti
            p, rows = p[keep], rows[keep]
        self.inst_row = rows
        self.inst_start = p - idx.off[rows]
        self.mask[rows] = True

    def spans(self, row: int) -> list[tuple[int, int]]:
        """(start, end) token spans of the phrase in `row`, leftmost first."""
        lo, hi = np.searchsorted(self.inst_row, [row, row + 1])
        m = len(self.tids)
        return [(int(s), int(s) + m - 1) for s in self.inst_start[lo:hi]]

    @property
    def n_hit(self) -> int:
        return int(self.mask.sum())


def _near_filtered(evals: list[_PhraseEval], distance: int) -> list[dict[int, list[tuple[int, int]]]]:
    """NEAR(p1..pn, N) instance filtering with FTS5 semantics.

    A row matches iff one instance per phrase can be chosen with every pairwise gap
    <= N intervening tokens — equivalently (1-D Helly, verified against FTS5):
    exists a token point t with start <= t <= end + N + 1 for every phrase. FTS5
    additionally PRUNES each phrase's position list to the instances that
    participate in some valid configuration, and bm25's per-row tf counts only the
    survivors — so this returns, per phrase, {row: kept instances}.
    """
    common = np.logical_and.reduce([e.mask for e in evals])
    out: list[dict[int, list[tuple[int, int]]]] = [{} for _ in evals]
    for row in np.nonzero(common)[0].tolist():
        spans = [e.spans(row) for e in evals]
        ts = sorted({s for sp in spans for s, _ in sp})
        # valid points: every phrase has an instance whose window covers t
        valid_ts = [
            t
            for t in ts
            if all(any(s <= t <= e + distance + 1 for s, e in sp) for sp in spans)
        ]
        if not valid_ts:
            continue
        for i, sp in enumerate(spans):
            kept = [
                (s, e) for s, e in sp if any(s <= t <= e + distance + 1 for t in valid_ts)
            ]
            out[i][row] = kept
    return out


# ---------------------------------------------------------------------------------
# Query evaluation + FTS5-exact bm25
# ---------------------------------------------------------------------------------


def match_search(builder: LexIndexBuilder, query: str, top_k: int) -> list[MatchHit]:
    """Evaluate an FTS5 MATCH query with exact SQLite semantics.

    Raises MatchSyntaxError on queries FTS5 would reject. Ordering mirrors the
    reference's SQL: rank ASC (= score DESC), frame_id ASC
    (FTS5SearchEngine.swift:146-149).
    """
    node = parse_match_query(query)
    idx = _position_index(builder)
    n_rows = idx.n_rows

    # raw per-phrase instances, shared across parse slots with equal phrase value
    eval_cache: dict[Phrase, _PhraseEval] = {}

    def get_eval(ph: Phrase) -> _PhraseEval:
        ev = eval_cache.get(ph)
        if ev is None:
            ev = eval_cache[ph] = _PhraseEval(builder, ph, idx)
        return ev

    # One scoring slot per phrase in parse order: (phrase, its eval, None) for a bare
    # phrase, (phrase, None, {row: kept instances}) for a NEAR member. A slot reports
    # instances in a row ONLY when its branch of the expression actually matched that
    # row (in `apple OR banana cherry`, a row with apple+banana but no cherry scores
    # apple alone; NOT right operands never report).
    slots: list[tuple[Phrase, _PhraseEval | None, dict | None]] = []
    node_matched: dict[int, np.ndarray] = {}
    slot_node: list[int] = []  # slots[i] belongs to AST node id slot_node[i]

    def walk(n) -> np.ndarray:
        if isinstance(n, Phrase):
            ev = get_eval(n)
            slots.append((n, ev, None))
            slot_node.append(id(n))
            rows = ev.mask
        elif isinstance(n, Near):
            evals = [get_eval(p) for p in n.phrases]
            filtered = _near_filtered(evals, n.distance)
            rows = None
            for p, f in zip(n.phrases, filtered):
                slots.append((p, None, f))
                slot_node.append(id(n))
                nonempty = np.zeros(n_rows, bool)
                nonempty[[r for r, inst in f.items() if inst]] = True
                rows = nonempty if rows is None else (rows & nonempty)
            rows = rows if rows is not None else np.zeros(n_rows, bool)
        elif isinstance(n, BoolNode):
            left = walk(n.left)
            right = walk(n.right)
            if n.op == "and":
                rows = left & right
            elif n.op == "or":
                rows = left | right
            else:
                rows = left & ~right
        else:
            raise AssertionError(f"unknown node {n!r}")
        node_matched[id(n)] = rows
        return rows

    matched = walk(node)
    if not matched.any():
        return []

    # top-down: rows where each node is on a matching path of the expression
    node_active: dict[int, np.ndarray] = {}
    nothing = np.zeros(n_rows, bool)

    def assign(n, active: np.ndarray) -> None:
        node_active[id(n)] = active
        if isinstance(n, BoolNode):
            if n.op == "or":
                assign(n.left, active & node_matched[id(n.left)])
                assign(n.right, active & node_matched[id(n.right)])
            elif n.op == "and":
                assign(n.left, active)
                assign(n.right, active)
            else:  # NOT: right operand phrases never report instances
                assign(n.left, active)
                assign(n.right, nothing)
        # Phrase/Near: leaves — active set already recorded

    assign(node, matched)

    # FTS5 bm25: idf = ln((N - nHit + 0.5)/(nHit + 0.5)) clamped to 1e-6 when <= 0,
    # nHit = rows matching the phrase alone (UNfiltered by NEAR); tf = surviving
    # instances in the row; dl = row token count (fts5_aux.c, verified
    # differentially in tests/test_fts5_parity.py)
    n_live = idx.n_live
    idfs = []
    for ph, _ev, _near in slots:
        n_hit = eval_cache[ph].n_hit
        idf = math.log((n_live - n_hit + 0.5) / (n_hit + 0.5))
        idfs.append(idf if idf > 0.0 else 1e-6)

    # each slot's term added over all rows in slot order, in the JAX module's float64
    # expression, so every row's sum is bit-identical to its per-row loop
    dl, avgdl = idx.dls, idx.avgdl
    score = np.zeros(n_rows)
    for (ph, ev, near), nid, idf in zip(slots, slot_node, idfs):
        if near is None:
            tf = np.bincount(ev.inst_row, minlength=n_rows).astype(np.float64)
        else:
            tf = np.zeros(n_rows)
            for r, inst in near.items():
                tf[r] = len(inst)
        tf = np.where(node_active[nid], tf, 0.0)
        term = idf * (tf * (BM25_K1 + 1.0)) / (
            tf + BM25_K1 * (1.0 - BM25_B + BM25_B * dl / avgdl)
        )
        score = np.where(tf > 0.0, score + term, score)

    rows = np.nonzero(matched)[0]
    order = np.lexsort((idx.fids[rows], -score[rows]))[: max(1, top_k)]
    hits: list[MatchHit] = []
    for row in rows[order].tolist():
        inst_all = []
        for (ph, ev, near), nid in zip(slots, slot_node):
            inst = []
            if node_active[nid][row]:
                inst = ev.spans(row) if near is None else near.get(row, [])
            inst_all.append(tuple(inst))
        hits.append(MatchHit(int(idx.fids[row]), float(score[row]), row, tuple(inst_all)))
    return hits
