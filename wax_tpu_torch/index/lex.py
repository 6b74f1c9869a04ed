"""Lexical (BM25) index: CSR postings snapshot and a host-side builder.

PyTorch port of `wax_tpu.index.lex`. `analyze`, the BM25 constants,
`packed_row_bits`, `build_impact_chunks` and `fuse_forward` are copied from the JAX
package (its `__init__` imports jax eagerly); the builder keeps the same row,
vocabulary, tombstone and postings-budget semantics and produces the same arrays,
built with vectorised numpy instead of per-posting and per-document Python loops.

A postings budget that truncates a term keeps each term's impact head (the postings
with the largest exact BM25 contribution, ties to the lowest row), scores with idf
from the full document frequency, and adds the exact-rescore forward index
(`fwd_tids`, `fwd_wnorm`, fused as `fwd_fused`) and the impact-chunked packed
postings (`pk_chunks`) that the candidate kernels read.

The builder also keeps each document's token-id sequence (an int32 token log with
per-row offsets), which the v2 lex segment, the host MATCH engine (phrases, NEAR) and
snippets read, and a CSR view of its postings cached per generation. Its state is
arrays already, so a segment's frozen arrays are adopted straight into the logs
(`from_frozen_arrays`) and `frozen_or_built_arrays` returns the JAX builder's arrays.

Left out: the TPU-only layout (reversed postings copies `doc_rows_rev`, `wnorm_rev`,
`pk_chunks_rev`, and the 1024-aligned DMA-window padding).
"""
from __future__ import annotations

import re
from array import array
from collections import Counter
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from wax_tpu_torch.utils.device import resolve_device

__all__ = [
    "LexIndex",
    "LexIndexBuilder",
    "analyze",
    "BM25_K1",
    "BM25_B",
    "ANALYZER_VERSION",
    "FWD_WIDTH_CAP",
    "PK_CHUNK",
    "auto_postings_floor",
    "build_impact_chunks",
    "fuse_forward",
    "packed_row_bits",
]


def auto_postings_floor(n_rows: int) -> int | None:
    """The "auto" per-term postings budget for an n_rows corpus: None (exact) below
    256K rows, then max(4096, n//256)."""
    return None if n_rows < 262_144 else max(4096, n_rows // 256)


BM25_K1 = 1.2
BM25_B = 0.75
# Bump whenever analyze()'s token output changes (kept equal to the JAX package's).
ANALYZER_VERSION = "u61-r4"
# Forward-index width cap: documents with more unique terms keep their
# FWD_WIDTH_CAP highest-impact terms (lowest-tid ties).
FWD_WIDTH_CAP = 512
# Postings per impact chunk of the packed candidate layout.
PK_CHUNK = 1024
_I32_MAX = np.int32(2**31 - 1)


def packed_row_bits(n_cap: int) -> tuple[int, int]:
    """(row_bits, qb) split of the 31 usable i32 bits of a packed posting
    `(row << qb) | qcon`: row_bits = bit_length(n_cap) keeps every packed value below
    INT32_MAX (the pad sentinel); qb is capped at 12 so the candidate kernel's
    `rank * 128` tie-break key stays within i32."""
    rb = max(1, int(n_cap).bit_length())
    qb = min(31 - rb, 12)
    if qb < 6:
        raise ValueError(
            f"capacity {n_cap} leaves only {qb} quantization bits; "
            "shard the corpus below 2^25 rows per device"
        )
    return rb, qb


def _impact_order(rows, con, tid_post):
    """The permutation `np.lexsort((rows, -con, tid_post))`: term ascending, then
    contribution descending, then row ascending, as one stable sort of (term,
    contribution rank) packed in an int64 (a fraction of the three-key lexsort's
    cost). The postings must be in CSR order with each term's rows ascending, as
    every snapshot's are (the builder's CSR, its budgeted heads and each shard's
    slice keep that order); other input raises ValueError."""
    if np.any((rows[1:] <= rows[:-1]) & (tid_post[1:] == tid_post[:-1])):
        raise ValueError("impact chunks need CSR postings with each term's rows ascending")
    uniq, rank = np.unique(con, return_inverse=True)
    bits = max(1, (len(uniq) - 1).bit_length())  # terms < 2^31 and postings < 2^31: the key fits
    return np.argsort((tid_post << bits) | (len(uniq) - 1 - rank.reshape(-1)), kind="stable")


def build_impact_chunks(doc_rows, wnorm, offsets, idf, n_cap):
    """Impact-chunked packed postings for the chunked candidate kernel (K4).

    Per term t: order its postings by exact contribution idf[t]*wnorm (descending,
    ties to the lowest row, tombstones last), split into PK_CHUNK-sized impact
    chunks, sort each chunk by row, and pack every posting as (row << qb) | qcon with
    qcon = round(con / max_con * (2^qb - 1)) clamped to [1, 2^qb - 1] (0 for
    tombstones). Chunks are PK_CHUNK-aligned blocks padded with INT32_MAX, plus one
    all-INT32_MAX block at the end (the target of dead slots).

    Returns (pk [PB*PK_CHUNK] i32, chunk_base [T] i32, chunk_counts [T] i32, qb).
    """
    t = len(offsets) - 1
    p_total = int(offsets[-1])
    _, qb = packed_row_bits(n_cap)
    qmax = (1 << qb) - 1
    sizes = np.diff(offsets.astype(np.int64))
    nch = ((sizes + PK_CHUNK - 1) // PK_CHUNK).astype(np.int64)
    chunk_base = np.zeros(t, np.int32)
    if t:
        chunk_base[1:] = np.cumsum(nch)[:-1].astype(np.int32)
    pb_total = int(nch.sum()) + 1
    pk = np.full(pb_total * PK_CHUNK, _I32_MAX, np.int32)
    if p_total:
        rows = doc_rows[:p_total].astype(np.int64)
        tid_post = np.repeat(np.arange(t, dtype=np.int64), sizes)
        con = wnorm[:p_total].astype(np.float64) * idf[tid_post]
        scale = float(con.max())
        if scale <= 0.0:
            scale = 1.0
        qcon = np.clip(np.rint(con / scale * qmax), 1, qmax).astype(np.int64)
        qcon = np.where(con > 0.0, qcon, 0)
        p1 = _impact_order(rows, con, tid_post)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        chunk_j = (np.arange(p_total, dtype=np.int64) - starts[tid_post[p1]]) // PK_CHUNK
        gchunk = chunk_base[tid_post[p1]].astype(np.int64) + chunk_j
        # row order within each chunk: one sort of (chunk, row) packed in an int64
        # (rows < n_cap; a chunk holds one term's postings, so the keys are unique)
        p2 = np.argsort((gchunk << max(1, (int(n_cap) - 1).bit_length())) | rows[p1], kind="stable")
        g_sorted = gchunk[p2]
        src = p1[p2]
        first_of_chunk = np.concatenate([[True], g_sorted[1:] != g_sorted[:-1]])
        chunk_start_pos = np.where(first_of_chunk, np.arange(p_total, dtype=np.int64), 0)
        chunk_start_pos = np.maximum.accumulate(chunk_start_pos)
        within = np.arange(p_total, dtype=np.int64) - chunk_start_pos
        dest = g_sorted * PK_CHUNK + within
        pk[dest] = ((rows[src] << qb) | qcon[src]).astype(np.int32)
    return pk, chunk_base, nch.astype(np.int32), qb


def fuse_forward(fwd_tids: np.ndarray, fwd_wnorm: np.ndarray, width: int) -> np.ndarray:
    """The forward index as ONE i32 array [N, 2*L2]: lanes [0, L2) the tids (-1 pad),
    lanes [L2, 2*L2) the matching f32 weights as bit patterns; L2 = the real width
    rounded up to 64. The exact rescore (K3) gathers one row per candidate."""
    n = fwd_tids.shape[0]
    l2 = max(64, ((max(width, 1) + 63) // 64) * 64)
    fused = np.empty((n, 2 * l2), np.int32)
    fused[:, :l2] = fwd_tids[:, :l2]
    fused[:, l2:] = np.ascontiguousarray(fwd_wnorm[:, :l2].astype(np.float32)).view(np.int32)
    return fused


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
      max_df:    longest (kept) postings list, rounded up to 128 (as the JAX package).

    Present only when the postings budget truncated a term (None / 0 otherwise):
      fwd_tids / fwd_wnorm: [N_cap, L_pad] doc-major forward index of each live
                 document's unique terms (tid ascending, -1 / 0.0 padding) with exact
                 per-(doc, term) weights, from the UNBUDGETED postings.
      fwd_fused: [N_cap, 2*L2] i32 `fuse_forward` of the two (K3's input).
      pk_chunks: [PB*PK_CHUNK] i32 impact-chunked packed postings
                 (`build_impact_chunks`, K4's input); chunk_base / chunk_counts [T].
      pk_qb, pk_max_chunks, fwd_width: the packed quantisation bits, the most chunks
                 of one term, and the real forward width.
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
    fwd_tids: torch.Tensor | None = None
    fwd_wnorm: torch.Tensor | None = None
    fwd_fused: torch.Tensor | None = None
    pk_chunks: torch.Tensor | None = None
    chunk_base: torch.Tensor | None = None
    chunk_counts: torch.Tensor | None = None
    max_df: int = 0
    pk_qb: int = 0
    pk_max_chunks: int = 0
    fwd_width: int = 0

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
    are masked by `active`). Within each term id the posting log's rows ascend: an add
    appends a new row, and an adopted segment's log is its CSR order.
    """

    def __init__(self, postings_budget: int | str | None = None):
        # None keeps every posting; "auto" resolves per snapshot (exact below 256K
        # rows, then max(4096, n // 256)); an int caps each term's list at its impact
        # head, and the snapshot then carries the exact-rescore forward index.
        self.postings_budget = postings_budget
        self._vocab: dict[str, int] = {}
        self._df_all: list[int] = []  # postings per term id (tombstoned rows included)
        # flat posting log in insertion order: (term id, row, tf), as C int arrays
        self._post_tid = array("i")
        self._post_row = array("i")
        self._post_tf = array("i")
        # token log: the analysed token ids of every row in order, row r at
        # _tok[_tok_off[r] : _tok_off[r + 1]]
        self._tok = array("i")
        self._tok_off = array("q", [0])
        self._csr_cache: tuple | None = None
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
        # term ids in token order: first occurrences assign new ids in the order the
        # JAX builder assigns them (Counter order)
        tids = [self._tid(t) for t in analyze(text)]
        row = len(self._doc_len)
        self._doc_len.append(len(tids))
        self._frame_ids.append(fid)
        self._active.append(True)
        self._row_of[fid] = row
        self._tok.extend(tids)
        self._tok_off.append(len(self._tok))
        for tid, tf in Counter(tids).items():
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

    def token_log(self) -> tuple[np.ndarray, np.ndarray]:
        """(token ids int32 [L], row offsets int64 [N+1]): every row's analysed token-id
        sequence in order, row r at [off[r], off[r + 1]); copies."""
        return np.array(self._tok, np.int32), np.array(self._tok_off, np.int64)

    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(post_offsets int64 [T+1], doc_rows int32 [P], tfs int32 [P]): the postings
        grouped by term id, rows ascending within a term, tombstoned rows included;
        cached per generation. Read-only views: copy before mutating."""
        cache = self._csr_cache
        if cache is not None and cache[0] == self._generation:
            return cache[1]
        t = len(self._vocab)
        tid = np.array(self._post_tid, np.int32)
        # rows ascend within each term id of the log, so a stable sort by term gives
        # the CSR order
        order = np.argsort(tid, kind="stable")
        post_offsets = np.zeros(t + 1, np.int64)
        if t:
            np.cumsum(np.bincount(tid, minlength=t), out=post_offsets[1:])
        out = (post_offsets, np.array(self._post_row, np.int32)[order], np.array(self._post_tf, np.int32)[order])
        for a in out:
            a.flags.writeable = False
        self._csr_cache = (self._generation, out)
        return out

    def frozen_or_built_arrays(self) -> tuple[list[str], dict]:
        """(vocab_list, v2 segment arrays), equal to the JAX builder's for the same adds
        and removes: doc_tids i32 + doc_offsets i64 (token-id sequence per row),
        frame_ids i64 (-1 for removed rows), active bool, and the postings CSR
        doc_rows i32 + tfs i32 + post_offsets i64 (tombstoned rows included)."""
        post_offsets, doc_rows, tfs = self.csr()
        doc_tids, doc_offsets = self.token_log()
        return list(self._vocab), {
            "doc_tids": doc_tids,
            "doc_offsets": doc_offsets,
            "frame_ids": np.asarray(self._frame_ids, np.int64),
            "active": np.asarray(self._active, bool),
            "doc_rows": doc_rows.copy(),
            "tfs": tfs.copy(),
            "post_offsets": post_offsets.copy(),
        }

    @classmethod
    def from_frozen_arrays(
        cls, vocab_list: list[str], arrays: dict, postings_budget: int | str | None = None
    ) -> "LexIndexBuilder":
        """A builder over v2-segment arrays (see `frozen_or_built_arrays`): the vocab in
        tid order, the token sequences adopted as the token log and the postings CSR as
        the posting log (term-major, rows ascending within a term, which is all the
        snapshot's stable sort by term needs)."""

        def log(code: str, a) -> array:
            out = array(code)
            out.frombytes(np.ascontiguousarray(a, np.int32 if code == "i" else np.int64).tobytes())
            return out

        b = cls(postings_budget=postings_budget)
        b._vocab = {t: i for i, t in enumerate(vocab_list)}
        po = np.asarray(arrays["post_offsets"], np.int64)
        sizes = np.diff(po)
        b._df_all = sizes.tolist()
        b._post_tid = log("i", np.repeat(np.arange(len(sizes), dtype=np.int32), sizes))
        b._post_row = log("i", arrays["doc_rows"])
        b._post_tf = log("i", arrays["tfs"])
        offs = np.asarray(arrays["doc_offsets"], np.int64)
        b._tok = log("i", arrays["doc_tids"])
        b._tok_off = log("q", offs)
        b._doc_len = np.diff(offs).tolist()
        fids = np.asarray(arrays["frame_ids"], np.int64)
        active = np.asarray(arrays["active"], bool)
        b._frame_ids = fids.tolist()
        b._active = active.tolist()
        live = np.nonzero(active & (fids >= 0))[0]
        b._row_of = dict(zip(fids[live].tolist(), live.tolist()))
        return b

    def compact(self) -> None:
        """Physically drop tombstoned rows and unreferenced vocab, renumbering rows
        (reference: MemoryOrchestrator+Maintenance.swift:160-171). As in the JAX
        package, the generation restarts: it is the fresh builder's plus one. So
        caches keyed on the generation (the MATCH engine's position index) are
        dropped with the old state."""
        fresh = self._rebuilt(None)
        self.__dict__.clear()
        self.__dict__.update(fresh.__dict__)
        self._generation += 1

    def remapped(self, remap: Mapping[int, int]) -> "LexIndexBuilder":
        """A fresh builder (generation 0) over the live rows whose frame ids `remap`
        holds, each under its new id: the live-set rewrite's lexical index."""
        return self._rebuilt(remap)

    def _rebuilt(self, remap: Mapping[int, int] | None) -> "LexIndexBuilder":
        """The live rows in row order, as if their token sequences were added again to
        an empty builder: term ids in first-occurrence order, each row's postings in
        its own first-occurrence order (the JAX builder's Counter order). Frame ids go
        through `remap` when given, and rows of frames it lacks are dropped."""
        fids = np.asarray(self._frame_ids, np.int64)
        keep = np.asarray(self._active, bool) & (fids >= 0)
        if remap is not None:
            keep &= np.fromiter((int(f) in remap for f in fids.tolist()), bool, len(fids))
        rows = np.nonzero(keep)[0]
        new_fids = fids[rows].tolist()
        if remap is not None:
            new_fids = [int(remap[f]) for f in new_fids]
        tok = np.frombuffer(self._tok, np.int32) if len(self._tok) else np.zeros(0, np.int32)
        off = np.frombuffer(self._tok_off, np.int64)
        lens = off[rows + 1] - off[rows]
        new_off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=new_off[1:])
        old_tids = tok[np.repeat(off[rows] - new_off[:-1], lens) + np.arange(new_off[-1])]
        # term ids anew, in order of first occurrence over the kept rows
        uniq, first = np.unique(old_tids, return_index=True)
        seen = uniq[np.argsort(first, kind="stable")]
        to_new = np.zeros(len(self._vocab), np.int64)
        to_new[seen] = np.arange(len(seen))
        new_tids = to_new[old_tids]
        n_terms = len(seen)
        # (row, term) pairs with their counts, ordered by first occurrence: row-major,
        # and within a row in the order its terms first appear
        row_of_tok = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
        ukey, ufirst, ucount = np.unique(
            row_of_tok * max(n_terms, 1) + new_tids, return_index=True, return_counts=True
        )
        order = np.argsort(ufirst, kind="stable")
        post_row, post_tid = np.divmod(ukey[order], max(n_terms, 1))

        inv = list(self._vocab)
        fresh = LexIndexBuilder(postings_budget=self.postings_budget)
        fresh._vocab = {inv[t]: i for i, t in enumerate(seen.tolist())}
        fresh._df_all = np.bincount(post_tid, minlength=n_terms).tolist()
        fresh._post_tid = array("i", post_tid.astype(np.int32).tobytes())
        fresh._post_row = array("i", post_row.astype(np.int32).tobytes())
        fresh._post_tf = array("i", ucount[order].astype(np.int32).tobytes())
        fresh._tok = array("i", new_tids.astype(np.int32).tobytes())
        fresh._tok_off = array("q", new_off.tobytes())
        fresh._doc_len = lens.tolist()
        fresh._frame_ids = new_fids
        fresh._active = [True] * len(rows)
        fresh._row_of = {f: r for r, f in enumerate(new_fids)}
        return fresh

    def snapshot(self, device: str | torch.device | None = None) -> LexIndex:
        """Build the snapshot on `device` (None: the current CUDA device)."""
        device = resolve_device(device)
        n = len(self._doc_len)
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

        # the postings in CSR order (term-major, rows ascending), widened to int64
        post_offsets, csr_rows, csr_tfs = self.csr()
        sizes = np.diff(post_offsets)
        tid_s = np.repeat(np.arange(t, dtype=np.int64), sizes)
        rows_s, tf_s = csr_rows.astype(np.int64), csr_tfs.astype(np.int64)
        # FTS5 idf: ln((N - df + 0.5) / (df + 0.5)) over active rows, clamped to 1e-6,
        # from the FULL document frequency (a budget never changes the statistics)
        df = np.bincount(tid_s, weights=active[rows_s], minlength=t) if t else np.zeros(1)
        v = np.log((live - df + 0.5) / (df + 0.5))
        idf = np.where(v > 0.0, v, 1e-6).astype(np.float32) if t else np.zeros(1, np.float32)

        budget = self.resolve_postings_budget(n)
        truncated = budget is not None and t > 0 and int(sizes.max()) > budget
        kept = (tid_s, rows_s, tf_s)
        if truncated:
            kept = self._impact_heads(tid_s, rows_s, tf_s, sizes, budget, avgdl)
        k_tid, k_rows, k_tf = kept
        k_sizes = np.bincount(k_tid, minlength=t) if t else np.zeros(0, np.int64)
        offsets = np.zeros(max(t, 1) + 1, np.int32)
        offsets[1 : t + 1] = np.cumsum(k_sizes, dtype=np.int64).astype(np.int32)
        doc_rows = k_rows.astype(np.int32)
        tfs = k_tf.astype(np.float32)
        pdl = doc_len[doc_rows]
        wn = tfs * (BM25_K1 + 1.0) / (tfs + BM25_K1 * (1.0 - BM25_B + BM25_B * pdl / avgdl))
        wnorm = np.where(active[doc_rows], wn, 0.0).astype(np.float32)
        max_df = int(k_sizes.max()) if t else 0

        def dev(a):
            return None if a is None else torch.tensor(a, device=device)

        fwd_tids = fwd_wnorm = fwd_fused = pk = cbase = ccounts = None
        pk_qb = pk_maxc = fwd_width = 0
        if truncated:
            fwd_tids, fwd_wnorm = self._build_forward(n_cap, rows_s, tid_s, tf_s, avgdl, idf)
            fwd_width = int((fwd_tids >= 0).sum(axis=1).max()) if fwd_tids.size else 0
            fwd_fused = fuse_forward(fwd_tids, fwd_wnorm, fwd_width)
            pk, cbase, ccounts, pk_qb = build_impact_chunks(
                doc_rows, wnorm, offsets, idf.astype(np.float64), n_cap
            )
            pk_maxc = int(ccounts.max()) if len(ccounts) else 0

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
            fwd_tids=dev(fwd_tids),
            fwd_wnorm=dev(fwd_wnorm),
            fwd_fused=dev(fwd_fused),
            pk_chunks=dev(pk),
            chunk_base=dev(cbase),
            chunk_counts=dev(ccounts),
            max_df=_round_up(max(max_df, 1), 128),
            pk_qb=pk_qb,
            pk_max_chunks=pk_maxc,
            fwd_width=fwd_width,
        )

    def _impact(self, rows, tf, avgdl: float) -> np.ndarray:
        """Exact per-posting tf/length weight in float64 (the JAX builder's Python
        doubles, operation for operation); -1 for tombstoned rows."""
        dl = np.asarray(self._doc_len, np.float64)[rows]
        tf = tf.astype(np.float64)
        w = tf * (BM25_K1 + 1.0) / (tf + BM25_K1 * (1.0 - BM25_B + BM25_B * dl / avgdl))
        return np.where(np.asarray(self._active, bool)[rows], w, -1.0)

    def _impact_heads(self, tid_s, rows_s, tf_s, sizes, budget: int, avgdl: float):
        """Each term's `budget` postings of largest impact (ties to the lowest row),
        back in CSR order."""
        imp = self._impact(rows_s, tf_s, avgdl)
        # stable: within a term, equal impacts keep their ascending-row order
        o = np.lexsort((-imp, tid_s))
        starts = np.concatenate([[0], np.cumsum(sizes)])
        rank = np.arange(len(o), dtype=np.int64) - starts[tid_s[o]]
        keep = np.zeros(len(o), bool)
        keep[o[rank < budget]] = True
        return tid_s[keep], rows_s[keep], tf_s[keep]

    def _build_forward(self, n_cap, rows_s, tid_s, tf_s, avgdl, idf):
        """Doc-major forward index from the UNBUDGETED postings of live rows, each row
        tid-ascending; rows with more than FWD_WIDTH_CAP unique terms keep their
        highest-impact terms (ties to the lowest tid)."""
        live = np.asarray(self._active, bool)[rows_s]
        r, tid, tf = rows_s[live], tid_s[live], tf_s[live]
        o = np.lexsort((tid, r))
        r, tid = r[o], tid[o]
        wn = self._impact(r, tf[o], avgdl)
        widths = np.bincount(r, minlength=len(self._doc_len))
        starts = np.concatenate([[0], np.cumsum(widths)])
        keep = np.ones(len(r), bool)
        for row in np.nonzero(widths > FWD_WIDTH_CAP)[0]:
            seg = np.arange(starts[row], starts[row + 1])
            rank = np.lexsort((tid[seg], -(wn[seg] * idf[tid[seg]].astype(np.float64))))
            keep[seg[rank[FWD_WIDTH_CAP:]]] = False
        r, tid, wn = r[keep], tid[keep], wn[keep]
        widths = np.minimum(widths, FWD_WIDTH_CAP)
        l_pad = max(128, _round_up(int(widths.max(initial=1)), 128))
        starts = np.concatenate([[0], np.cumsum(widths)])
        pos = np.arange(len(r), dtype=np.int64) - starts[r]
        fwd_tids = np.full((n_cap, l_pad), -1, np.int32)
        fwd_wnorm = np.zeros((n_cap, l_pad), np.float32)
        fwd_tids[r, pos] = tid
        fwd_wnorm[r, pos] = wn
        return fwd_tids, fwd_wnorm
