# Verbatim copy of wax_tpu/structured/memory.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Structured memory: bitemporal entity/predicate/fact store with evidence links.

Mirrors the reference's structured-memory model (reference:
Sources/WaxCore/StructuredMemory/ — typed fact values text/int/real/bool/blob/time/
entity, fact + span content hashes StructuredMemoryHashing.swift:4-50, as-of queries
StructuredMemoryAsOf.swift — and the SQL schema in
Sources/WaxTextSearch/StructuredMemorySchema.swift:4-70: sm_entity, sm_entity_alias,
sm_predicate, sm_fact with typed object columns + CHECK constraints, sm_fact_span for
bitemporal validity, evidence spans; handlers FTS5SearchEngine.swift:164-398 — entity
upsert/alias resolve, fact assert/retract, evidenceFrameIds joining facts -> evidence
-> frames for the structured search lane).

Backend: stdlib sqlite3 (the reference uses SQLite for the same role); the whole DB
image serializes into the store's "structured" segment via Connection.serialize(),
the exact analogue of the reference's FTS5 image serialization trick.
"""
from __future__ import annotations

import hashlib
import re
import sqlite3
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from wax_tpu_torch.types import now_ms

__all__ = ["FactValue", "FactRow", "StructuredMemory"]

_VALUE_KINDS = ("text", "int", "real", "bool", "blob", "time", "entity")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS sm_entity (
  entity_id INTEGER PRIMARY KEY,
  name TEXT NOT NULL UNIQUE,
  kind TEXT,
  created_ms INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS sm_entity_alias (
  alias TEXT NOT NULL PRIMARY KEY,
  entity_id INTEGER NOT NULL REFERENCES sm_entity(entity_id)
);
CREATE TABLE IF NOT EXISTS sm_predicate (
  predicate_id INTEGER PRIMARY KEY,
  name TEXT NOT NULL UNIQUE
);
CREATE TABLE IF NOT EXISTS sm_fact (
  fact_id INTEGER PRIMARY KEY,
  subject_id INTEGER NOT NULL REFERENCES sm_entity(entity_id),
  predicate_id INTEGER NOT NULL REFERENCES sm_predicate(predicate_id),
  value_kind TEXT NOT NULL CHECK (value_kind IN
    ('text','int','real','bool','blob','time','entity')),
  value_text TEXT, value_int INTEGER, value_real REAL, value_blob BLOB,
  content_hash TEXT NOT NULL,
  asserted_ms INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS sm_fact_span (
  fact_id INTEGER NOT NULL REFERENCES sm_fact(fact_id),
  valid_from_ms INTEGER NOT NULL,
  valid_to_ms INTEGER,            -- NULL = open-ended
  span_hash TEXT NOT NULL,
  PRIMARY KEY (fact_id, valid_from_ms)
);
CREATE TABLE IF NOT EXISTS sm_evidence (
  fact_id INTEGER NOT NULL REFERENCES sm_fact(fact_id),
  frame_id INTEGER NOT NULL,
  span_start INTEGER,            -- optional char range within the frame content
  span_end INTEGER,
  PRIMARY KEY (fact_id, frame_id)
);
CREATE INDEX IF NOT EXISTS sm_fact_subject ON sm_fact(subject_id, predicate_id);
PRAGMA application_id = 0x57415853;  -- 'WAXS'
PRAGMA user_version = 1;
"""

_WORD_RE = re.compile(r"[A-Za-z0-9][\w'-]*")


@dataclass(frozen=True)
class FactValue:
    kind: str
    value: Any

    def __post_init__(self):
        if self.kind not in _VALUE_KINDS:
            raise ValueError(f"unknown fact value kind {self.kind}")

    @classmethod
    def text(cls, v: str) -> "FactValue":
        return cls("text", str(v))

    @classmethod
    def integer(cls, v: int) -> "FactValue":
        return cls("int", int(v))

    @classmethod
    def real(cls, v: float) -> "FactValue":
        return cls("real", float(v))

    @classmethod
    def boolean(cls, v: bool) -> "FactValue":
        return cls("bool", bool(v))

    @classmethod
    def blob(cls, v: bytes) -> "FactValue":
        return cls("blob", bytes(v))

    @classmethod
    def time_ms(cls, v: int) -> "FactValue":
        return cls("time", int(v))

    @classmethod
    def entity(cls, entity_id: int) -> "FactValue":
        return cls("entity", int(entity_id))

    def canonical(self) -> bytes:
        if self.kind == "blob":
            return self.kind.encode() + b"\x00" + self.value
        return f"{self.kind}\x00{self.value}".encode()


@dataclass(frozen=True)
class FactRow:
    fact_id: int
    subject: str
    predicate: str
    value: FactValue
    asserted_ms: int
    valid_from_ms: int
    valid_to_ms: int | None
    evidence_frames: tuple[int, ...]


def _fact_hash(subject: str, predicate: str, value: FactValue) -> str:
    h = hashlib.sha256()
    h.update(subject.encode())
    h.update(b"\x00")
    h.update(predicate.encode())
    h.update(b"\x00")
    h.update(value.canonical())
    return h.hexdigest()


def _span_hash(fact_hash: str, valid_from: int, valid_to: int | None) -> str:
    return hashlib.sha256(f"{fact_hash}\x00{valid_from}\x00{valid_to}".encode()).hexdigest()


class _EagerCursor:
    """Fully-fetched result of one locked execute (safe to consume lock-free)."""

    __slots__ = ("_rows", "lastrowid", "rowcount", "_i")

    def __init__(self, rows, lastrowid, rowcount=-1):
        self._rows = rows
        self.lastrowid = lastrowid
        self.rowcount = rowcount
        self._i = 0

    def fetchone(self):
        if self._i >= len(self._rows):
            return None
        row = self._rows[self._i]
        self._i += 1
        return row

    def fetchall(self):
        rows = self._rows[self._i :]
        self._i = len(self._rows)
        return rows

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row


class _LockedConn:
    """Thread-safe facade over one sqlite3 connection: every statement executes and
    fetches under an RLock, returning eager cursors."""

    def __init__(self, conn: sqlite3.Connection):
        import threading

        self._conn = conn
        self._lock = threading.RLock()

    def execute(self, sql, params=()):
        with self._lock:
            cur = self._conn.execute(sql, params)
            rows = cur.fetchall() if cur.description is not None else []
            return _EagerCursor(rows, cur.lastrowid, cur.rowcount)

    def executescript(self, script):
        with self._lock:
            self._conn.executescript(script)

    def commit(self):
        with self._lock:
            self._conn.commit()

    def serialize(self):
        with self._lock:
            return self._conn.serialize()

    def close(self):
        with self._lock:
            self._conn.close()


class StructuredMemory:
    def __init__(
        self,
        conn: sqlite3.Connection | None = None,
        now: Callable[[], int] | None = None,
    ):
        # check_same_thread=False + an internal lock: since round 3 the
        # orchestrator's READ phase runs concurrently (facts_query/entity_resolve
        # and the evidence lane inside every hybrid search), and a shared sqlite3
        # connection must not execute statements from two threads at once on
        # SQLITE_THREADSAFE=2 builds. _LockedConn serializes execution AND row
        # fetching (cursors re-enter the connection on iteration).
        raw = conn if conn is not None else sqlite3.connect(":memory:", check_same_thread=False)
        self.conn = raw if isinstance(raw, _LockedConn) else _LockedConn(raw)
        self.conn.executescript(_SCHEMA)
        # injectable clock for deterministic bitemporal replay (reference:
        # TimestampOverrideTests / deterministicNowMs)
        self._now = now if now is not None else now_ms

    # ------------------------------------------------------------------- entities ----
    def entity_upsert(
        self, name: str, kind: str | None = None, aliases: Sequence[str] = ()
    ) -> int:
        cur = self.conn.execute("SELECT entity_id, kind FROM sm_entity WHERE name = ?", (name,))
        row = cur.fetchone()
        if row is None:
            cur = self.conn.execute(
                "INSERT INTO sm_entity (name, kind, created_ms) VALUES (?,?,?)",
                (name, kind, self._now()),
            )
            eid = cur.lastrowid
        else:
            eid = row[0]
            if kind is not None and row[1] != kind:
                self.conn.execute("UPDATE sm_entity SET kind=? WHERE entity_id=?", (kind, eid))
        for a in aliases:
            self.conn.execute(
                "INSERT OR REPLACE INTO sm_entity_alias (alias, entity_id) VALUES (?,?)",
                (a.lower(), eid),
            )
        self.conn.commit()
        return eid

    def entity_resolve(self, name_or_alias: str) -> int | None:
        cur = self.conn.execute(
            "SELECT entity_id FROM sm_entity WHERE name = ?", (name_or_alias,)
        )
        row = cur.fetchone()
        if row:
            return row[0]
        cur = self.conn.execute(
            "SELECT entity_id FROM sm_entity_alias WHERE alias = ?", (name_or_alias.lower(),)
        )
        row = cur.fetchone()
        return row[0] if row else None

    def entity_name(self, entity_id: int) -> str | None:
        row = self.conn.execute(
            "SELECT name FROM sm_entity WHERE entity_id=?", (entity_id,)
        ).fetchone()
        return row[0] if row else None

    # ----------------------------------------------------------------------- facts ----
    def _predicate_id(self, name: str) -> int:
        cur = self.conn.execute("SELECT predicate_id FROM sm_predicate WHERE name=?", (name,))
        row = cur.fetchone()
        if row:
            return row[0]
        return self.conn.execute("INSERT INTO sm_predicate (name) VALUES (?)", (name,)).lastrowid

    def fact_assert(
        self,
        subject: str | int,
        predicate: str,
        value: FactValue,
        valid_from_ms: int | None = None,
        evidence_frames: Sequence = (),
        supersede_open_spans: bool = True,
    ) -> int:
        """Assert a fact. By default closes any open span for the same
        (subject, predicate) — the bitemporal update pattern.

        evidence_frames entries are frame ids, or (frame_id, span_start, span_end)
        tuples pinning the supporting char range (reference: evidence spans)."""
        eid = subject if isinstance(subject, int) else self.entity_upsert(subject)
        pid = self._predicate_id(predicate)
        ts = self._now()
        vf = valid_from_ms if valid_from_ms is not None else ts
        subject_name = self.entity_name(eid) or str(eid)
        chash = _fact_hash(subject_name, predicate, value)

        if supersede_open_spans:
            self.conn.execute(
                """UPDATE sm_fact_span SET valid_to_ms=? WHERE valid_to_ms IS NULL AND fact_id IN
                   (SELECT fact_id FROM sm_fact WHERE subject_id=? AND predicate_id=?)""",
                (vf, eid, pid),
            )

        cols = dict(value_text=None, value_int=None, value_real=None, value_blob=None)
        if value.kind in ("text",):
            cols["value_text"] = value.value
        elif value.kind in ("int", "time", "entity"):
            cols["value_int"] = int(value.value)
        elif value.kind == "bool":
            cols["value_int"] = 1 if value.value else 0
        elif value.kind == "real":
            cols["value_real"] = value.value
        elif value.kind == "blob":
            cols["value_blob"] = value.value
        cur = self.conn.execute(
            """INSERT INTO sm_fact (subject_id, predicate_id, value_kind, value_text,
               value_int, value_real, value_blob, content_hash, asserted_ms)
               VALUES (?,?,?,?,?,?,?,?,?)""",
            (eid, pid, value.kind, cols["value_text"], cols["value_int"], cols["value_real"],
             cols["value_blob"], chash, ts),
        )
        fact_id = cur.lastrowid
        self.conn.execute(
            "INSERT INTO sm_fact_span (fact_id, valid_from_ms, valid_to_ms, span_hash) VALUES (?,?,?,?)",
            (fact_id, vf, None, _span_hash(chash, vf, None)),
        )
        for ev in evidence_frames:
            if isinstance(ev, tuple):
                fid, span_start, span_end = ev
            else:
                fid, span_start, span_end = ev, None, None
            self.conn.execute(
                "INSERT OR IGNORE INTO sm_evidence (fact_id, frame_id, span_start, span_end)"
                " VALUES (?,?,?,?)",
                (fact_id, int(fid), span_start, span_end),
            )
        self.conn.commit()
        return fact_id

    def fact_retract(self, fact_id: int, valid_to_ms: int | None = None) -> bool:
        ts = valid_to_ms if valid_to_ms is not None else self._now()
        cur = self.conn.execute(
            "UPDATE sm_fact_span SET valid_to_ms=? WHERE fact_id=? AND valid_to_ms IS NULL",
            (ts, fact_id),
        )
        self.conn.commit()
        return cur.rowcount > 0

    def _row_to_fact(self, row) -> FactRow:
        (fact_id, subject, predicate, kind, vt, vi, vr, vb, asserted, vf, vto) = row
        if kind == "text":
            val = FactValue("text", vt)
        elif kind == "bool":
            val = FactValue("bool", bool(vi))
        elif kind in ("int", "time", "entity"):
            val = FactValue(kind, vi)
        elif kind == "real":
            val = FactValue("real", vr)
        else:
            val = FactValue("blob", vb)
        ev = tuple(
            r[0]
            for r in self.conn.execute(
                "SELECT frame_id FROM sm_evidence WHERE fact_id=? ORDER BY frame_id", (fact_id,)
            )
        )
        return FactRow(fact_id, subject, predicate, val, asserted, vf, vto, ev)

    def facts_query(
        self,
        subject: str | int | None = None,
        predicate: str | None = None,
        as_of_ms: int | None = None,
    ) -> list[FactRow]:
        """Facts valid at as_of (valid-time) and asserted by then (transaction-time);
        None = current open spans (reference: StructuredMemoryAsOf.swift)."""
        q = """SELECT f.fact_id, e.name, p.name, f.value_kind, f.value_text, f.value_int,
                      f.value_real, f.value_blob, f.asserted_ms, s.valid_from_ms, s.valid_to_ms
               FROM sm_fact f
               JOIN sm_entity e ON e.entity_id = f.subject_id
               JOIN sm_predicate p ON p.predicate_id = f.predicate_id
               JOIN sm_fact_span s ON s.fact_id = f.fact_id
               WHERE 1=1"""
        args: list = []
        if subject is not None:
            eid = subject if isinstance(subject, int) else self.entity_resolve(subject)
            if eid is None:
                return []
            q += " AND f.subject_id = ?"
            args.append(eid)
        if predicate is not None:
            q += " AND p.name = ?"
            args.append(predicate)
        if as_of_ms is None:
            q += " AND s.valid_to_ms IS NULL"
        else:
            q += " AND s.valid_from_ms <= ? AND (s.valid_to_ms IS NULL OR s.valid_to_ms > ?)"
            q += " AND f.asserted_ms <= ?"
            args += [as_of_ms, as_of_ms, as_of_ms]
        q += " ORDER BY f.fact_id"
        return [self._row_to_fact(r) for r in self.conn.execute(q, args)]

    # -------------------------------------------------------------------- evidence ----
    def evidence_spans(self, fact_id: int) -> list[tuple[int, int | None, int | None]]:
        """(frame_id, span_start, span_end) rows for a fact."""
        return [
            (r[0], r[1], r[2])
            for r in self.conn.execute(
                "SELECT frame_id, span_start, span_end FROM sm_evidence WHERE fact_id=?"
                " ORDER BY frame_id",
                (fact_id,),
            )
        ]

    def evidence_frame_ids(self, query_text: str, as_of_ms: int | None = None) -> list[int]:
        """Structured search lane: resolve entities/predicates mentioned in the query,
        return evidence frame ids of their valid facts
        (reference: FTS5SearchEngine.evidenceFrameIds :398)."""
        words = _WORD_RE.findall(query_text)
        eids: set[int] = set()
        for i, w in enumerate(words):
            got = self.entity_resolve(w) or self.entity_resolve(w.lower())
            if got is not None:
                eids.add(got)
            if i + 1 < len(words):
                two = f"{w} {words[i+1]}"
                got = self.entity_resolve(two) or self.entity_resolve(two.lower())
                if got is not None:
                    eids.add(got)
        if not eids:
            return []
        frame_ids: list[int] = []
        seen = set()
        for eid in sorted(eids):
            for fact in self.facts_query(subject=eid, as_of_ms=as_of_ms):
                for fid in fact.evidence_frames:
                    if fid not in seen:
                        seen.add(fid)
                        frame_ids.append(fid)
        return frame_ids

    # --------------------------------------------------------------- serialization ----
    def serialize(self) -> bytes:
        return self.conn.serialize()

    @classmethod
    def deserialize(cls, blob: bytes, now: Callable[[], int] | None = None) -> "StructuredMemory":
        conn = sqlite3.connect(":memory:", check_same_thread=False)
        conn.deserialize(blob)
        return cls(conn, now=now)

    def stats_attrs(self) -> dict[str, str]:
        return {k: str(v) for k, v in self.stats().items()}

    def stats(self) -> dict:
        def count(table):
            return self.conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]

        return {
            "entities": count("sm_entity"),
            "aliases": count("sm_entity_alias"),
            "predicates": count("sm_predicate"),
            "facts": count("sm_fact"),
            "spans": count("sm_fact_span"),
            "evidence_links": count("sm_evidence"),
        }
