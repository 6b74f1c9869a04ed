"""Lexical (BM25) index: CSR postings snapshot and a host-side builder.

PyTorch port of the unbudgeted part of `wax_tpu.index.lex`. `analyze` and the BM25
constants are copied from the JAX package (its `__init__` imports jax eagerly); the
builder keeps the same row, vocabulary and tombstone semantics and produces the same
CSR arrays, built with numpy instead of a per-posting Python loop.

Left out: the TPU-only layout (reversed postings copies, packed impact chunks,
1024-aligned DMA-window padding), the forward index, and frozen-array persistence. A
postings budget that would truncate a term raises NotImplementedError: the budgeted
lane is ROADMAP item 6.
"""
from __future__ import annotations

import re
from array import array
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "LexIndex",
    "LexIndexBuilder",
    "analyze",
    "BM25_K1",
    "BM25_B",
    "ANALYZER_VERSION",
    "auto_postings_floor",
]


def auto_postings_floor(n_rows: int) -> int | None:
    """The "auto" per-term postings budget for an n_rows corpus: None (exact) below
    256K rows, then max(4096, n//256)."""
    return None if n_rows < 262_144 else max(4096, n_rows // 256)


BM25_K1 = 1.2
BM25_B = 0.75
# Bump whenever analyze()'s token output changes (kept equal to the JAX package's).
ANALYZER_VERSION = "u61-r4"


def _build_tokenizer():
    """Compile the probed unicode61 tables into a run-finding regex and a per-char
    translate map: a token is a maximal run of token/internal chars; internal chars
    (combining diacritics) delete within a run, token chars map through the fold."""
    from wax_tpu_torch.text.unicode61_tables import INTERNAL_RANGES, TOKEN_FOLD, TOKEN_RANGES

    cls = "".join(
        f"{chr(a)}-{chr(b)}" if b > a else re.escape(chr(a))
        for a, b in sorted(TOKEN_RANGES + INTERNAL_RANGES)
    )
    run_re = re.compile(f"[{cls}]+")
    trans: dict[int, str | None] = dict(TOKEN_FOLD)
    for a, b in INTERNAL_RANGES:
        for cp in range(a, b + 1):
            trans[cp] = None
    return run_re, trans


_TOKEN_RUN_RE, _FOLD_TRANS = _build_tokenizer()

_FOLD_MEMO: dict[str, str] = {}
_FOLD_MEMO_CAP = 262144


def analyze(text: str) -> list[str]:
    """SQLite FTS5 unicode61 analysis: simple per-char case folding, Latin diacritic
    removal, split on unicode61 separators (copy of the JAX package's analyzer,
    memoised per token run)."""
    memo = _FOLD_MEMO
    out = []
    for m in _TOKEN_RUN_RE.finditer(text):
        run = m.group()
        t = memo.get(run)
        if t is None:
            t = run.translate(_FOLD_TRANS)
            if len(run) <= 64:
                if len(memo) >= _FOLD_MEMO_CAP:
                    memo.clear()
                memo[run] = t
        if t:
            out.append(t)
    return out


@dataclass(frozen=True)
class LexIndex:
    """CSR postings snapshot.

    Attributes:
      doc_rows:  [P] int32 row of each posting, grouped by term, rows ascending.
      tfs:       [P] f32 term frequency of each posting.
      offsets:   [T+1] int32 CSR offsets per term id.
      idf:       [T] f32 FTS5 idf per term (df over active rows).
      doc_len:   [N_cap] f32 analysed token count per row.
      frame_ids: [N_cap] int32 row -> external id (-1 for padding and tombstones).
      active:    [N_cap] bool.
      count:     0-d int32 occupied rows.
      avgdl:     0-d f32 mean document length over live rows.
      wnorm:     [P] f32 tf-normalised weight per posting (0 for tombstoned rows).
      max_df:    longest postings list, rounded up to 128 (as the JAX package).
    """

    doc_rows: torch.Tensor
    tfs: torch.Tensor
    offsets: torch.Tensor
    idf: torch.Tensor
    doc_len: torch.Tensor
    frame_ids: torch.Tensor
    active: torch.Tensor
    count: torch.Tensor
    avgdl: torch.Tensor
    wnorm: torch.Tensor
    max_df: int = 0

    @property
    def n_terms(self) -> int:
        return self.idf.shape[0]

    @property
    def n_postings(self) -> int:
        return self.doc_rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.doc_len.device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class LexIndexBuilder:
    """Host-side mutable postings builder producing `LexIndex` snapshots.

    Documents are analysed on add; removal tombstones the row (its postings stay and
    are masked by `active`).
    """

    def __init__(self, postings_budget: int | str | None = None):
        # None keeps every posting; "auto" resolves per snapshot (exact below 256K
        # rows); an int caps each term's list. Only budgets that truncate nothing are
        # served by this port.
        self.postings_budget = postings_budget
        self._vocab: dict[str, int] = {}
        self._df_all: list[int] = []  # postings per term id (tombstoned rows included)
        # flat posting log in insertion order: (term id, row, tf), as C int arrays
        self._post_tid = array("i")
        self._post_row = array("i")
        self._post_tf = array("i")
        self._doc_len: list[int] = []
        self._frame_ids: list[int] = []
        self._active: list[bool] = []
        self._row_of: dict[int, int] = {}
        self._generation = 0

    def __len__(self) -> int:
        return len(self._row_of)

    def __contains__(self, frame_id: int) -> bool:
        return int(frame_id) in self._row_of

    @property
    def generation(self) -> int:
        return self._generation

    def _tid(self, term: str) -> int:
        tid = self._vocab.get(term)
        if tid is None:
            tid = len(self._vocab)
            self._vocab[term] = tid
            self._df_all.append(0)
        return tid

    def add(self, frame_id: int, text: str) -> None:
        fid = int(frame_id)
        if fid in self._row_of:
            self.remove(fid)
        terms = analyze(text)
        row = len(self._doc_len)
        self._doc_len.append(len(terms))
        self._frame_ids.append(fid)
        self._active.append(True)
        self._row_of[fid] = row
        for term, tf in Counter(terms).items():
            tid = self._tid(term)
            self._df_all[tid] += 1
            self._post_tid.append(tid)
            self._post_row.append(row)
            self._post_tf.append(tf)
        self._generation += 1

    def add_batch(self, items: list[tuple[int, str]]) -> None:
        for fid, text in items:
            self.add(fid, text)

    def remove(self, frame_id: int) -> bool:
        row = self._row_of.pop(int(frame_id), None)
        if row is None:
            return False
        self._active[row] = False
        self._frame_ids[row] = -1
        self._generation += 1
        return True

    def term_ids(self, terms: list[str]) -> list[int]:
        """Map analysed terms to term ids, dropping unknown terms."""
        return [self._vocab[t] for t in terms if t in self._vocab]

    def query_term_ids(self, query: str) -> list[int]:
        return self.term_ids(analyze(query))

    def row_space(self) -> int:
        """Padded row count a snapshot of the current state uses (n_cap)."""
        return max(128, _round_up(max(len(self._doc_len), 1), 128))

    def df(self, tid: int) -> int:
        """Postings of a term id (tombstoned rows included, as in the JAX package)."""
        return self._df_all[tid] if 0 <= tid < len(self._df_all) else 0

    def max_term_df(self) -> int:
        return max(self._df_all, default=0)

    def resolve_postings_budget(self, n_rows: int) -> int | None:
        b = self.postings_budget
        if b == "auto":
            return auto_postings_floor(n_rows)
        return b

    def snapshot(self, device: str | torch.device = "cpu") -> LexIndex:
        n = len(self._doc_len)
        budget = self.resolve_postings_budget(n)
        if budget is not None and self.max_term_df() > budget:
            raise NotImplementedError(
                f"postings budget {budget} truncates a term (max df {self.max_term_df()}); "
                "the budgeted BM25 lane is not ported yet: ROADMAP item 6"
            )
        n_cap = self.row_space()
        t = len(self._vocab)
        active = np.zeros(n_cap, bool)
        active[:n] = self._active
        doc_len = np.zeros(n_cap, np.float32)
        doc_len[:n] = self._doc_len
        frame_ids = np.full(n_cap, -1, np.int32)
        frame_ids[:n] = self._frame_ids
        live = max(1, int(active.sum()))
        # the JAX package's exact float expressions, so both give identical arrays
        avgdl = float(doc_len[:n][np.asarray(self._active, bool)].sum() / live) if n else 1.0
        avgdl = max(avgdl, 1e-6)

        tid = np.asarray(self._post_tid).astype(np.int64)
        rows = np.asarray(self._post_row).astype(np.int64)
        order = np.lexsort((rows, tid))  # CSR: term-major, rows ascending
        tid_s = tid[order]
        doc_rows = rows[order].astype(np.int32)
        tfs = np.asarray(self._post_tf, np.float32)[order]
        sizes = np.bincount(tid_s, minlength=t) if t else np.zeros(0, np.int64)
        offsets = np.zeros(max(t, 1) + 1, np.int32)
        offsets[1 : t + 1] = np.cumsum(sizes, dtype=np.int64).astype(np.int32)
        # FTS5 idf: ln((N - df + 0.5) / (df + 0.5)) over active rows, clamped to 1e-6
        df = np.bincount(tid_s, weights=active[doc_rows], minlength=t) if t else np.zeros(1)
        v = np.log((live - df + 0.5) / (df + 0.5))
        idf = np.where(v > 0.0, v, 1e-6).astype(np.float32) if t else np.zeros(1, np.float32)
        pdl = doc_len[doc_rows]
        wn = tfs * (BM25_K1 + 1.0) / (tfs + BM25_K1 * (1.0 - BM25_B + BM25_B * pdl / avgdl))
        wnorm = np.where(active[doc_rows], wn, 0.0).astype(np.float32)
        max_df = int(sizes.max()) if t else 0

        def dev(a):
            return torch.tensor(a, device=device)

        return LexIndex(
            doc_rows=dev(doc_rows),
            tfs=dev(tfs),
            offsets=dev(offsets),
            idf=dev(idf),
            doc_len=dev(doc_len),
            frame_ids=dev(frame_ids),
            active=dev(active),
            count=torch.tensor(n, dtype=torch.int32, device=device),
            avgdl=torch.tensor(avgdl, dtype=torch.float32, device=device),
            wnorm=dev(wnorm),
            max_df=_round_up(max(max_df, 1), 128),
        )
