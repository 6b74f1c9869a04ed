# Verbatim copy of wax_tpu/storage/wal.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Crash-safe WAL ring: fixed-size ring buffer with checksummed records.

Mirrors the reference's WAL layer (reference: Sources/WaxCore/WAL/ —
WALRingWriter.swift:74-510: 48-byte record headers {seq, len, flags, sha256}, padding
records on wrap, sentinel terminator, capacity math, fsync policy;
WALRingReader.swift:49-371: replay scan from the checkpoint with checksum validation,
stop at sentinel/corruption; WALEntryCodec.swift:12-139: opcodes putFrame=0x01,
deleteFrame=0x02, supersedeFrame=0x03, putEmbedding=0x04 with raw f32 LE vectors
inline).

Differences from the reference, by design: frame payload bytes live in the append-only
data region (written at put time, exactly like the reference's payload pwrite at
dataEnd) and the WAL putFrame record carries the frame meta + payload location + hash,
so replay validates payload bytes already in the file.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from wax_tpu_torch.storage.codec import BinaryDecoder, BinaryEncoder, CodecError
from wax_tpu_torch.storage.fdfile import FDFile
from wax_tpu_torch.storage.format import sha256

__all__ = [
    "WAL_RECORD_HEADER",
    "WalOp",
    "WalEntry",
    "WalRingWriter",
    "WalRingReader",
    "WalStats",
    "WalFullError",
]

WAL_RECORD_HEADER = 48  # seq u64 | len u32 | flags u32 | sha256 32

FLAG_SENTINEL = 1
FLAG_PADDING = 2


class WalFullError(Exception):
    pass


class WalOp:
    PUT_FRAME = 0x01
    DELETE_FRAME = 0x02
    SUPERSEDE_FRAME = 0x03
    PUT_EMBEDDING = 0x04


@dataclass(frozen=True)
class WalEntry:
    op: int
    # PUT_FRAME / SUPERSEDE_FRAME: encoded frame-meta blob (format.encode_frame_meta)
    frame_blob: bytes | None = None
    frame_id: int = -1
    old_frame_id: int = -1
    embedding: np.ndarray | None = None

    def encode(self) -> bytes:
        e = BinaryEncoder()
        e.u8(self.op)
        if self.op in (WalOp.PUT_FRAME, WalOp.SUPERSEDE_FRAME):
            if self.op == WalOp.SUPERSEDE_FRAME:
                e.i64(self.old_frame_id)
            e.blob(self.frame_blob or b"")
        elif self.op == WalOp.DELETE_FRAME:
            e.i64(self.frame_id)
        elif self.op == WalOp.PUT_EMBEDDING:
            vec = np.asarray(self.embedding, dtype="<f4")
            e.i64(self.frame_id).u32(vec.shape[0]).raw(vec.tobytes())
        else:
            raise CodecError(f"unknown WAL op {self.op}")
        return e.data()

    @classmethod
    def decode(cls, data: bytes) -> "WalEntry":
        d = BinaryDecoder(data)
        op = d.u8()
        if op == WalOp.PUT_FRAME:
            return cls(op=op, frame_blob=d.blob())
        if op == WalOp.SUPERSEDE_FRAME:
            old = d.i64()
            return cls(op=op, old_frame_id=old, frame_blob=d.blob())
        if op == WalOp.DELETE_FRAME:
            return cls(op=op, frame_id=d.i64())
        if op == WalOp.PUT_EMBEDDING:
            fid = d.i64()
            dim = d.u32()
            vec = np.frombuffer(d.raw(dim * 4), dtype="<f4").copy()
            return cls(op=op, frame_id=fid, embedding=vec)
        raise CodecError(f"unknown WAL op {op}")


@dataclass
class WalStats:
    """Operational counters (reference: WaxWALStats, Wax.swift:38-79)."""

    write_pos: int = 0
    checkpoint_pos: int = 0
    last_seq: int = 0
    pending_bytes: int = 0
    pending_records: int = 0
    wrap_count: int = 0
    checkpoint_count: int = 0
    sentinel_write_count: int = 0
    append_count: int = 0
    auto_commit_count: int = 0
    replay_snapshot_hit_count: int = 0


def _record_header(seq: int, length: int, flags: int, payload: bytes) -> bytes:
    return struct.pack("<QII", seq, length, flags) + sha256(payload)


class WalRingWriter:
    """Single-writer ring over a region of the store file."""

    def __init__(self, fd: FDFile, wal_offset: int, wal_size: int):
        if wal_size < 4 * WAL_RECORD_HEADER:
            raise ValueError("WAL too small")
        self.fd = fd
        self.base = wal_offset
        self.size = wal_size
        self.stats = WalStats()

    # -- state restore on open ----------------------------------------------------------
    def restore(self, write_pos: int, checkpoint_pos: int, last_seq: int, pending_bytes: int, pending_records: int = 0):
        s = self.stats
        s.write_pos, s.checkpoint_pos = write_pos, checkpoint_pos
        s.last_seq, s.pending_bytes = last_seq, pending_bytes
        s.pending_records = pending_records

    # -- capacity -----------------------------------------------------------------------
    def _free_bytes(self) -> int:
        s = self.stats
        if s.pending_bytes == 0:
            return self.size - 2 * WAL_RECORD_HEADER
        used = (s.write_pos - s.checkpoint_pos) % self.size
        return self.size - used - 2 * WAL_RECORD_HEADER

    def can_append(self, payload_len: int) -> bool:
        return self._plan_batch([payload_len]) is not None

    def can_append_batch(self, payload_lens: list[int]) -> bool:
        return self._plan_batch(payload_lens) is not None

    def _plan_batch(self, payload_lens: list[int]) -> list[int] | None:
        """Simulate record placement (including wrap padding and the trailing
        sentinel); returns per-record start positions, or None if the batch would
        overrun the checkpointed region."""
        s = self.stats
        pos = s.write_pos
        budget = self._free_bytes()
        positions: list[int] = []
        for ln in payload_lens:
            need = WAL_RECORD_HEADER + ln
            if pos + need + WAL_RECORD_HEADER > self.size:
                budget -= self.size - pos  # padding + skipped tail
                pos = 0
            budget -= need
            if budget < 0 or need + WAL_RECORD_HEADER > self.size:
                return None
            positions.append(pos)
            pos += need
        # sentinel space (may itself wrap)
        if pos + WAL_RECORD_HEADER > self.size:
            budget -= self.size - pos
            if budget < 0:
                return None
        return positions

    def fill_fraction(self) -> float:
        s = self.stats
        used = (s.write_pos - s.checkpoint_pos) % self.size if s.pending_bytes else 0
        return used / self.size

    # -- appends -------------------------------------------------------------------------
    def _write_at(self, pos: int, data: bytes) -> None:
        self.fd.pwrite_exact(self.base + pos, data)

    def _pad_and_wrap(self, pos: int) -> int:
        """Write a padding record covering the ring tail, return 0."""
        remaining = self.size - pos
        if remaining >= WAL_RECORD_HEADER:
            pad_payload_len = remaining - WAL_RECORD_HEADER
            self._write_at(pos, _record_header(0, pad_payload_len, FLAG_PADDING, b""))
        self.stats.wrap_count += 1
        return 0

    def append(self, entry: WalEntry, fsync: bool = False) -> int:
        return self.append_batch([entry], fsync=fsync)

    def append_batch(self, entries: list[WalEntry], fsync: bool = False) -> int:
        """Append entries + trailing sentinel; returns the last sequence number."""
        payloads = [e.encode() for e in entries]
        if self._plan_batch([len(p) for p in payloads]) is None:
            raise WalFullError(
                f"WAL full: {sum(map(len, payloads))} bytes do not fit "
                f"(free={self._free_bytes()})"
            )
        s = self.stats
        pos = s.write_pos
        for payload in payloads:
            need = WAL_RECORD_HEADER + len(payload)
            if pos + need + WAL_RECORD_HEADER > self.size:
                pos = self._pad_and_wrap(pos)
            s.last_seq += 1
            self._write_at(pos, _record_header(s.last_seq, len(payload), 0, payload) + payload)
            pos += need
            s.pending_bytes += need
            s.pending_records += 1
            s.append_count += 1
        # sentinel marks the logical end (not counted in pending bytes)
        self.write_sentinel(pos)
        s.write_pos = pos
        if fsync:
            self.fd.fsync()
        return s.last_seq

    def write_sentinel(self, pos: int | None = None) -> None:
        pos = self.stats.write_pos if pos is None else pos
        if pos + WAL_RECORD_HEADER > self.size:
            pos = self._pad_and_wrap(pos)
        self._write_at(pos, _record_header(self.stats.last_seq, 0, FLAG_SENTINEL, b""))
        self.stats.sentinel_write_count += 1

    def record_checkpoint(self) -> None:
        """Advance the checkpoint to the current write position (called after a
        successful commit persisted everything up to last_seq)."""
        s = self.stats
        s.checkpoint_pos = s.write_pos
        s.pending_bytes = 0
        s.pending_records = 0
        s.checkpoint_count += 1


@dataclass
class WalScanResult:
    entries: list[tuple[int, WalEntry]] = field(default_factory=list)  # (seq, entry)
    last_seq: int = 0
    write_pos: int = 0
    pending_bytes: int = 0
    stopped_on: str = "sentinel"  # sentinel | corruption | wraparound-limit


class WalRingReader:
    def __init__(self, fd: FDFile, wal_offset: int, wal_size: int):
        self.fd = fd
        self.base = wal_offset
        self.size = wal_size

    def scan_pending(self, checkpoint_pos: int, committed_seq: int) -> WalScanResult:
        """Replay scan (reference: WALRingReader.scanPendingMutationsWithState :82):
        walk records from the checkpoint, validate checksums, collect entries with
        seq > committed_seq, stop at sentinel or first corruption."""
        res = WalScanResult(last_seq=committed_seq, write_pos=checkpoint_pos)
        pos = checkpoint_pos
        prev_seq: int | None = None
        seen = 0
        max_bytes = self.size  # never scan more than one full ring
        while seen < max_bytes:
            if pos + WAL_RECORD_HEADER > self.size:
                pos = 0
                continue
            hdr = self.fd.pread(self.base + pos, WAL_RECORD_HEADER)
            if len(hdr) < WAL_RECORD_HEADER:
                res.stopped_on = "corruption"
                break
            seq, length, flags = struct.unpack("<QII", hdr[:16])
            digest = hdr[16:48]
            if flags & FLAG_SENTINEL:
                res.stopped_on = "sentinel"
                break
            if flags & FLAG_PADDING:
                pos = 0
                seen += WAL_RECORD_HEADER + length
                continue
            if length > self.size or pos + WAL_RECORD_HEADER + length > self.size:
                res.stopped_on = "corruption"
                break
            payload = self.fd.pread(self.base + pos + WAL_RECORD_HEADER, length)
            if len(payload) != length or sha256(payload) != digest:
                res.stopped_on = "corruption"
                break
            if prev_seq is not None and seq != prev_seq + 1:
                # non-monotonic: stale record from a previous ring cycle
                res.stopped_on = "corruption"
                break
            prev_seq = seq
            try:
                entry = WalEntry.decode(payload)
            except CodecError:
                res.stopped_on = "corruption"
                break
            res.last_seq = max(res.last_seq, seq)
            if seq > committed_seq:
                res.entries.append((seq, entry))
                res.pending_bytes += WAL_RECORD_HEADER + length
            pos += WAL_RECORD_HEADER + length
            seen += WAL_RECORD_HEADER + length
            res.write_pos = pos
        return res

    def probe_terminal_marker(self, write_pos: int, last_seq: int) -> bool:
        """Replay-snapshot fast path: verify a sentinel with the expected seq sits at
        the snapshot's write position (reference: WALRingReader.isTerminalMarker :49)."""
        pos = write_pos
        if pos + WAL_RECORD_HEADER > self.size:
            pos = 0
        hdr = self.fd.pread(self.base + pos, WAL_RECORD_HEADER)
        if len(hdr) < WAL_RECORD_HEADER:
            return False
        seq, length, flags = struct.unpack("<QII", hdr[:16])
        return bool(flags & FLAG_SENTINEL) and length == 0 and seq == last_seq
