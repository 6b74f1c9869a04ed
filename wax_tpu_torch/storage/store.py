# Verbatim copy of wax_tpu/storage/store.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""WaxStore: single-writer crash-safe snapshot store (the `.wxs` file).

The TPU-build equivalent of the reference's `Wax` actor (reference:
Sources/WaxCore/Wax.swift — create :398, open :523-746, put :816, putBatch :1004,
putEmbedding(Batch) :1041/:1124, delete :1189, supersede :1203,
stage*IndexForNextCommit :1248/:1294, commit :1386-1563, verify :2123, timeline :2108,
writer lease :313-367, crash-injection checkpoints :96-103, proactive auto-commit
:249-309). Same durability recipe, Python host logic (index math lives on the TPU):

  * append-only payload region; payloads written at put() time (Wax.swift:837-1003);
  * metadata WAL ring with checksummed records + sentinel;
  * commit = write staged index blobs -> TOC -> footer -> fsync -> alternate header
    page (generation + replay snapshot) -> fsync, with crash checkpoints between the
    steps driven by env WAX_TPU_CRASH_CHECKPOINT;
  * open = select newest valid header page, probe header-pointed footer + bounded
    backward scan (newest generation wins), decode TOC, replay WAL past committed_seq
    (snapshot fast path when the terminal sentinel matches), validate pending payload
    hashes, repair trailing garbage.
"""
from __future__ import annotations

import os
import signal
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

from wax_tpu_torch.storage.compression import ENC_RAW, compress, decompress

from wax_tpu_torch.storage.codec import BinaryDecoder, CodecError
from wax_tpu_torch.storage.fdfile import FDFile, FileLock
from wax_tpu_torch.storage.format import (
    DEFAULT_WAL_SIZE,
    FOOTER_ALIGN,
    FOOTER_SIZE,
    Footer,
    FrameTable,
    HEADER_REGION,
    HEADER_SIZE,
    HeaderPage,
    ReplaySnapshot,
    SegmentManifest,
    StoreTOC,
    decode_frame_meta,
    encode_frame_meta,
    scan_all_footers,
    select_valid_header,
    sha256,
)
from wax_tpu_torch.storage.wal import (
    WalEntry,
    WalFullError,
    WalOp,
    WalRingReader,
    WalRingWriter,
)
from wax_tpu_torch.types import FrameMeta, FrameStatus, TimeRange, now_ms

__all__ = ["WaxStore", "StoreOptions", "StoreError", "StaleIndexError", "CrashCheckpoint"]


class StoreError(Exception):
    pass


class StaleIndexError(StoreError):
    """Commit guard: staged vec index does not cover all pending embeddings
    (reference: Wax.swift:1395-1413)."""


class CrashCheckpoint:
    """Crash-injection seams inside commit (reference: Wax.swift:96-103).
    Set env WAX_TPU_CRASH_CHECKPOINT to one of these to SIGKILL the process there."""

    TOC_WRITTEN = "toc_written"
    FOOTER_WRITTEN = "footer_written"
    FSYNC_DONE = "fsync_done"
    HEADER_WRITTEN = "header_written"

    ENV = "WAX_TPU_CRASH_CHECKPOINT"

    @classmethod
    def maybe_crash(cls, point: str) -> None:
        if os.environ.get(cls.ENV) == point:
            os.kill(os.getpid(), signal.SIGKILL)


@dataclass(frozen=True)
class StoreOptions:
    """(reference: WaxCore/WaxOptions.swift:3-29)"""

    wal_size: int = DEFAULT_WAL_SIZE
    fsync_on_append: bool = False
    compress_payloads: bool = True
    compression: str = "zlib"  # "zlib" | "lz4" (native) | "none"
    auto_commit_fill: float = 0.8
    enable_replay_snapshot: bool = True
    # Salvage escape hatch: by default, open() REFUSES a file whose recoverable
    # state is older than what the header proves was durably committed (external
    # damage — e.g. truncation destroyed the newest TOC/footer). Crashes can never
    # produce that shape (the header is updated only after the footer is fsynced),
    # so silent rollback would always be real data loss. Set True to salvage the
    # newest decodable generation anyway.
    allow_rollback_recovery: bool = False


@dataclass
class _PendingFrame:
    meta: FrameMeta
    payload_offset: int
    payload_len: int
    payload_sha: bytes
    encoding: int


class WaxStore:
    """Single-writer store handle. Not thread-safe by design: the single-controller
    process model replaces the reference's actor isolation (SURVEY.md §2.7)."""

    # ------------------------------------------------------------------ lifecycle ----
    def __init__(self, path: Path, fd: FDFile, options: StoreOptions, readonly: bool = False):
        self.path = path
        self.fd = fd
        self.options = options
        self.readonly = readonly
        self.lock = FileLock(Path(str(path) + ".lock"))
        self.toc = StoreTOC.empty()
        self.data_start = HEADER_REGION + options.wal_size
        self.data_end = self.data_start
        self.header_gen = 0
        self.header_slot = 0
        self.committed_seq = 0
        self.wal = WalRingWriter(fd, HEADER_REGION, options.wal_size)
        # pending (uncommitted) view
        self._pending: dict[int, _PendingFrame] = {}
        self._pending_deletes: set[int] = set()
        self._pending_supersedes: dict[int, int] = {}
        self._pending_embeddings: list[tuple[int, int, np.ndarray]] = []  # (seq, fid, vec)
        self._staged: dict[str, tuple[bytes, dict[str, str]]] = {}
        # None = no vec index staged this session: nothing is covered, including
        # overflow-recovered embeddings (seq 0). Prevents a plain commit() after
        # reopen from silently dropping durably-journaled embeddings.
        self._staged_vec_covers_seq: int | None = None
        self.stats_counters = {"puts": 0, "deletes": 0, "supersedes": 0, "commits": 0, "auto_commits": 0}
        self._closed = False

    @classmethod
    def create(cls, path: str | Path, options: StoreOptions = StoreOptions()) -> "WaxStore":
        path = Path(path)
        if path.exists() and path.stat().st_size > 0:
            raise StoreError(f"{path} already exists")
        fd = FDFile(path, create=True)
        store = cls(path, fd, options)
        if not store.lock.acquire(exclusive=True, blocking=False):
            fd.close()
            raise StoreError(f"{path} is locked by another writer")
        header = HeaderPage(
            header_gen=1,
            file_gen=0,
            footer_offset=0,
            wal_offset=HEADER_REGION,
            wal_size=options.wal_size,
            committed_seq=0,
            replay_snapshot=ReplaySnapshot(0, 0, 0),
        )
        fd.pwrite_exact(0, header.encode())
        fd.pwrite_exact(HEADER_SIZE, b"\x00" * HEADER_SIZE)
        store.wal.write_sentinel(0)
        fd.fsync()
        store.header_gen = 1
        store.header_slot = 0
        return store

    @classmethod
    def open(cls, path: str | Path, options: StoreOptions = StoreOptions(), readonly: bool = False) -> "WaxStore":
        path = Path(path)
        if not path.exists():
            raise StoreError(f"{path} does not exist")
        fd = FDFile(path, readonly=readonly)
        page_a = fd.pread(0, HEADER_SIZE)
        page_b = fd.pread(HEADER_SIZE, HEADER_SIZE)
        sel = select_valid_header(page_a, page_b)
        if sel is None:
            fd.close()
            raise StoreError("no valid header page")
        header, slot = sel
        options = replace(options, wal_size=header.wal_size)
        store = cls(path, fd, options, readonly=readonly)
        if not store.lock.acquire(exclusive=not readonly, blocking=False):
            fd.close()
            raise StoreError(f"{path} is locked by another writer")
        store.header_gen = header.header_gen
        store.header_slot = slot
        try:
            store._recover(header)
        except StoreError:
            store.lock.release()
            fd.close()
            raise
        return store

    # ------------------------------------------------------------------- recovery ----
    def _recover(self, header: HeaderPage) -> None:
        fd = self.fd
        file_size = fd.size()
        candidates: list[tuple[Footer, int]] = []
        # direct probe at the header-pointed footer offset
        if header.footer_offset >= self.data_start:
            try:
                f = Footer.decode(fd.pread_exact(header.footer_offset, FOOTER_SIZE))
                candidates.append((f, header.footer_offset))
            except (CodecError, OSError):
                pass
        # newest valid generation whose TOC decodes wins; older generations are
        # legitimate fallbacks when the newest footer's TOC bytes are damaged
        # (reference: Wax.swift:568-593; demo: scripts/demo_recovery.py corrupt-toc)
        def pick_best(cands: list[tuple[Footer, int]]):
            best: tuple[Footer, int, StoreTOC] | None = None
            for f, off in cands:
                if best is not None and f.generation <= best[0].generation:
                    continue
                try:
                    raw = fd.pread_exact(f.toc_offset, f.toc_len)
                    if sha256(raw)[:16] != f.toc_sha16:
                        continue
                    toc = StoreTOC.decode(raw)
                    best = (f, off, toc)
                except (CodecError, OSError):
                    continue
            return best

        # Footers are append-only, so any footer NEWER than the header-pointed one
        # lives at a HIGHER offset — when the direct probe succeeded, the backward
        # scan first covers only [probe offset, EOF) (on a cleanly committed store
        # that region is one footer, making open I/O O(1) instead of a 32 MiB read).
        # If nothing in that region yields a decodable TOC (corrupt-TOC salvage),
        # fall back to the full bounded scan for older generations.
        scan_floor = max(self.data_start, candidates[0][1]) if candidates else self.data_start
        candidates.extend(scan_all_footers(fd, file_size, scan_floor))
        best = pick_best(candidates)
        if best is None and scan_floor > self.data_start:
            best = pick_best(scan_all_footers(fd, file_size, self.data_start))

        if best is not None:
            footer, footer_off, toc = best
            if footer.committed_seq < header.committed_seq and not self.options.allow_rollback_recovery:
                raise StoreError(
                    f"committed state lost: header proves seq {header.committed_seq} was "
                    f"durable but the newest recoverable footer has seq {footer.committed_seq} "
                    "(external damage — pass allow_rollback_recovery=True to salvage)"
                )
            self.toc = toc
            self.committed_seq = footer.committed_seq
            self.data_end = footer_off + FOOTER_SIZE
        else:
            if (header.footer_offset or header.committed_seq) and not self.options.allow_rollback_recovery:
                raise StoreError(
                    f"committed state lost: header points at footer offset {header.footer_offset} "
                    f"(seq {header.committed_seq}) but no valid footer/TOC survives "
                    "(external damage — pass allow_rollback_recovery=True to salvage)"
                )
            self.toc = StoreTOC.empty()
            self.committed_seq = header.committed_seq if header.footer_offset == 0 else 0
            self.data_end = self.data_start

        # WAL replay (snapshot fast path or full scan; reference: Wax.swift:616-650)
        snap = header.replay_snapshot
        reader = WalRingReader(fd, HEADER_REGION, self.options.wal_size)
        checkpoint_pos = snap.wal_write_pos if snap else 0
        last_seq = snap.wal_last_seq if snap else self.committed_seq
        if (
            self.options.enable_replay_snapshot
            and snap is not None
            and snap.pending_bytes == 0
            and reader.probe_terminal_marker(snap.wal_write_pos, snap.wal_last_seq)
        ):
            self.wal.restore(snap.wal_write_pos, snap.wal_write_pos, snap.wal_last_seq, 0)
            self.wal.stats.replay_snapshot_hit_count += 1
            self._load_overflow_embeddings()
            self._repair_tail(file_size)
            return
        scan = reader.scan_pending(checkpoint_pos, self.committed_seq)
        max_valid_end = self.data_end
        for seq, entry in scan.entries:
            applied_end = self._apply_recovered(seq, entry)
            if applied_end is not None:
                max_valid_end = max(max_valid_end, applied_end)
        self.wal.restore(
            scan.write_pos,
            checkpoint_pos,
            max(scan.last_seq, last_seq),
            scan.pending_bytes,
            pending_records=len(scan.entries),
        )
        self.data_end = max(self.data_end, max_valid_end)
        # keep only the dense prefix of recovered frames: a damaged entry mid-batch
        # would otherwise leave an id gap that blocks every future commit
        expected = len(self.toc.frames)
        keep: dict[int, _PendingFrame] = {}
        for fid in sorted(self._pending):
            if fid != expected:
                break
            keep[fid] = self._pending[fid]
            expected += 1
        dropped = set(self._pending) - set(keep)
        if dropped:
            self._pending = keep
            self._pending_supersedes = {
                old: new for old, new in self._pending_supersedes.items() if new not in dropped
            }
        self._load_overflow_embeddings()
        self._repair_tail(file_size)

    def _apply_recovered(self, seq: int, entry: WalEntry) -> int | None:
        """Apply one replayed WAL entry to the pending view; returns the payload end
        offset when the entry references validated payload bytes."""
        if entry.op in (WalOp.PUT_FRAME, WalOp.SUPERSEDE_FRAME):
            try:
                meta, off, ln, sha, enc = decode_frame_meta(BinaryDecoder(entry.frame_blob))
                payload = self.fd.pread_exact(off, ln)
                if sha256(payload) != sha:
                    return None  # damaged tail: drop (reference preserves valid pending bytes only)
            except (CodecError, OSError):
                return None
            pf = _PendingFrame(meta, off, ln, sha, enc)
            self._pending[meta.frame_id] = pf
            if entry.op == WalOp.SUPERSEDE_FRAME and entry.old_frame_id >= 0:
                self._pending_supersedes[entry.old_frame_id] = meta.frame_id
            return off + ln
        if entry.op == WalOp.DELETE_FRAME:
            self._pending_deletes.add(entry.frame_id)
            return None
        if entry.op == WalOp.PUT_EMBEDDING:
            self._pending_embeddings.append((seq, entry.frame_id, entry.embedding))
            return None
        return None

    def _load_overflow_embeddings(self) -> None:
        """Prepend overflow-segment embeddings (persisted by an auto-commit) to the
        pending list. They carry seq 0 and stay UNCOVERED until stage_index('vec') is
        called this session (_staged_vec_covers_seq starts as None), so a plain
        commit() cannot silently drop them."""
        blob = self.read_segment("pending_emb")
        if blob:
            recovered = [(0, fid, vec) for fid, vec in _decode_pending_embeddings(blob)]
            self._pending_embeddings = recovered + self._pending_embeddings

    def _repair_tail(self, file_size: int) -> None:
        """Truncate trailing garbage past the last valid byte (reference:
        Wax.swift:674-692 — preserve pending payload bytes, drop the rest)."""
        if self.readonly:
            return
        if file_size > self.data_end:
            self.fd.truncate(self.data_end)

    # ------------------------------------------------------------------ frame view ----
    @property
    def next_frame_id(self) -> int:
        return len(self.toc.frames) + len(self._pending)

    def _frame_record(self, frame_id: int) -> tuple[FrameMeta, int, int, bytes, int] | None:
        pf = self._pending.get(frame_id)
        if pf is not None:
            return (pf.meta, pf.payload_offset, pf.payload_len, pf.payload_sha, pf.encoding)
        if 0 <= frame_id < len(self.toc.frames):
            return self.toc.frames[frame_id]
        return None

    def frame_ids_of_kind(self, kind: str) -> list[int]:
        """Ascending frame ids with the given kind (committed via the TOC's kind
        column when available — no meta materialization — plus pending frames)."""
        ft = self.toc.frames
        if isinstance(ft, FrameTable):
            ids = ft.ids_of_kind(kind)
        else:
            ids = [i for i, (m, *_rest) in enumerate(ft) if m.kind == kind]
        ids += [fid for fid, pf in sorted(self._pending.items()) if pf.meta.kind == kind]
        return ids

    def frame_meta(self, frame_id: int) -> FrameMeta | None:
        rec = self._frame_record(frame_id)
        if rec is None:
            return None
        meta = rec[0]
        if frame_id in self._pending_deletes:
            meta = replace(meta, status=FrameStatus.DELETED.value)
        new = self._pending_supersedes.get(frame_id)
        if new is not None:
            meta = replace(meta, superseded_by=new)
        return meta

    def frame_count(self) -> int:
        return len(self.toc.frames) + len(self._pending)

    def frame_content(self, frame_id: int) -> bytes | None:
        rec = self._frame_record(frame_id)
        if rec is None:
            return None
        _, off, ln, sha, enc = rec
        raw = self.fd.pread_exact(off, ln)
        if sha256(raw) != sha:
            raise StoreError(f"payload checksum mismatch for frame {frame_id}")
        return decompress(raw, enc)

    def frame_contents(self, frame_ids: list[int]) -> dict[int, bytes]:
        return {fid: c for fid in frame_ids if (c := self.frame_content(fid)) is not None}

    def frame_previews(self, frame_ids: list[int], max_bytes: int = 4096) -> dict[int, str]:
        out = {}
        for fid in frame_ids:
            c = self.frame_content(fid)
            if c is not None:
                out[fid] = c[:max_bytes].decode("utf-8", errors="ignore")
        return out

    def timeline(
        self,
        time_range: TimeRange | None = None,
        limit: int | None = None,
        newest_first: bool = True,
        include_deleted: bool = False,
        include_superseded: bool = False,
    ) -> list[FrameMeta]:
        out = []
        for fid in range(self.frame_count()):
            m = self.frame_meta(fid)
            if m is None:
                continue
            if not include_deleted and (m.status == FrameStatus.DELETED.value):
                continue
            if not include_superseded and m.superseded_by is not None:
                continue
            if time_range is not None and not time_range.contains(m.timestamp_ms):
                continue
            out.append(m)
        out.sort(key=lambda m: (-m.timestamp_ms, -m.frame_id) if newest_first else (m.timestamp_ms, m.frame_id))
        return out[:limit] if limit is not None else out

    # -------------------------------------------------------------------- mutation ----
    def _check_writable(self) -> None:
        if self.readonly:
            raise StoreError("store opened read-only")
        if self._closed:
            raise StoreError("store closed")

    def _encode_payload(self, content: bytes) -> tuple[bytes, int]:
        # store-smaller-only policy (reference Wax.swift:771-782)
        if not self.options.compress_payloads:
            return content, ENC_RAW
        return compress(content, self.options.compression)

    def _append_payload(self, payload: bytes) -> int:
        off = self.data_end
        self.fd.pwrite_exact(off, payload)
        self.data_end = off + len(payload)
        return off

    def _wal_append(self, entries: list[WalEntry]) -> int:
        try:
            return self.wal.append_batch(entries, fsync=self.options.fsync_on_append)
        except WalFullError:
            # safe: callers journal BEFORE registering state, so this commit only
            # covers previously-registered mutations
            self.auto_commit()
            return self.wal.append_batch(entries, fsync=self.options.fsync_on_append)

    def _maybe_proactive_commit(self) -> None:
        """WAL-pressure commit; call only AFTER the journaled state is registered
        in the pending view (reference: proactive thresholds, Wax.swift:249-309)."""
        if self.wal.fill_fraction() > self.options.auto_commit_fill:
            self.auto_commit()

    def put(self, content: bytes | str, **meta_kwargs) -> int:
        return self.put_batch([(content, meta_kwargs)])[0]

    def put_batch(self, items: list[tuple[bytes | str, dict]]) -> list[int]:
        """Hot ingest loop (reference: Wax.swift:837-1003): payload pwrite at data end
        + one batched WAL append."""
        self._check_writable()
        ids, entries, staged_frames = [], [], []
        fid = self.next_frame_id
        for content, meta_kwargs in items:
            raw = content.encode("utf-8") if isinstance(content, str) else bytes(content)
            payload, enc = self._encode_payload(raw)
            off = self._append_payload(payload)
            meta_kwargs = dict(meta_kwargs)
            meta_kwargs.setdefault("timestamp_ms", now_ms())
            meta = FrameMeta(frame_id=fid, **meta_kwargs)
            sha = sha256(payload)
            staged_frames.append((fid, _PendingFrame(meta, off, len(payload), sha, enc)))
            entries.append(
                WalEntry(op=WalOp.PUT_FRAME, frame_blob=encode_frame_meta(meta, off, len(payload), sha, enc))
            )
            ids.append(fid)
            fid += 1
        # journal FIRST: a WAL-pressure auto-commit inside _wal_append must not see
        # (and commit) these frames, or the retried append would double-record them
        self._wal_append(entries)
        for f, pf in staged_frames:
            self._pending[f] = pf
            self.stats_counters["puts"] += 1
        self._maybe_proactive_commit()
        return ids

    def put_embedding(self, frame_id: int, vec: np.ndarray) -> None:
        self.put_embedding_batch([frame_id], np.asarray(vec)[None, :])

    def put_embedding_batch(self, frame_ids: list[int], vecs: np.ndarray) -> None:
        self._check_writable()
        vecs = np.asarray(vecs, dtype=np.float32)
        entries = [
            WalEntry(op=WalOp.PUT_EMBEDDING, frame_id=int(fid), embedding=vecs[i])
            for i, fid in enumerate(frame_ids)
        ]
        seq0 = self.wal.stats.last_seq
        self._wal_append(entries)
        for i, fid in enumerate(frame_ids):
            self._pending_embeddings.append((seq0 + 1 + i, int(fid), vecs[i]))
        self._maybe_proactive_commit()

    def delete(self, frame_id: int) -> bool:
        self._check_writable()
        if self._frame_record(frame_id) is None:
            return False
        self._wal_append([WalEntry(op=WalOp.DELETE_FRAME, frame_id=frame_id)])
        self._pending_deletes.add(frame_id)
        self.stats_counters["deletes"] += 1
        self._maybe_proactive_commit()
        return True

    def supersede(self, old_id: int, content: bytes | str, **meta_kwargs) -> int:
        self._check_writable()
        if self._frame_record(old_id) is None:
            raise StoreError(f"no frame {old_id}")
        raw = content.encode("utf-8") if isinstance(content, str) else bytes(content)
        payload, enc = self._encode_payload(raw)
        off = self._append_payload(payload)
        fid = self.next_frame_id
        meta_kwargs.setdefault("timestamp_ms", now_ms())
        meta = FrameMeta(frame_id=fid, supersedes=old_id, **meta_kwargs)
        sha = sha256(payload)
        self._wal_append(
            [
                WalEntry(
                    op=WalOp.SUPERSEDE_FRAME,
                    old_frame_id=old_id,
                    frame_blob=encode_frame_meta(meta, off, len(payload), sha, enc),
                )
            ]
        )
        self._pending[fid] = _PendingFrame(meta, off, len(payload), sha, enc)
        self._pending_supersedes[old_id] = fid
        self.stats_counters["supersedes"] += 1
        self._maybe_proactive_commit()
        return fid

    # -------------------------------------------------------------------- staging ----
    def stage_index(self, kind: str, blob: bytes, attrs: dict[str, str] | None = None) -> None:
        """Stage an index segment for the next commit (reference:
        stageLexIndexForNextCommit :1248 / stageVecIndexForNextCommit :1294).

        Staging a blob identical to the committed segment is a no-op for the data
        region — the commit reuses the existing manifest. This bounds file growth on
        repeated unchanged commits (the reference shipped exactly this fix: unchanged
        index compaction grew the file ~7.7 MB/run before, README:158)."""
        self._check_writable()
        if kind == "vec":
            self._staged_vec_covers_seq = self.wal.stats.last_seq
        current = self.toc.manifests.get(kind)
        if current is not None and current.length == len(blob) and current.sha == sha256(blob):
            self._staged.pop(kind, None)  # keep the committed segment as-is
            return
        self._staged[kind] = (blob, dict(attrs or {}))

    def pending_embeddings(self) -> list[tuple[int, np.ndarray]]:
        return [(fid, vec) for _, fid, vec in self._pending_embeddings]

    # --------------------------------------------------------------------- commit ----
    def commit(self, allow_pending_embeddings: bool = False) -> int:
        """Atomic checkpoint (reference: commitLocked Wax.swift:1386-1563)."""
        self._check_writable()
        uncovered = [
            (seq, fid, vec)
            for seq, fid, vec in self._pending_embeddings
            if self._staged_vec_covers_seq is None or seq > self._staged_vec_covers_seq
        ]
        if uncovered and not allow_pending_embeddings:
            raise StaleIndexError(
                f"{len(uncovered)} pending embeddings not covered by a staged vec index"
            )

        # 1. merge pending mutations into a new frame table
        frames = list(self.toc.frames)
        for fid in sorted(self._pending):
            pf = self._pending[fid]
            if pf.meta.frame_id != len(frames):
                raise StoreError(f"non-dense pending frame id {pf.meta.frame_id}")
            frames.append((pf.meta, pf.payload_offset, pf.payload_len, pf.payload_sha, pf.encoding))
        frames = [
            (self._finalize_meta(m), off, ln, sha, enc) for (m, off, ln, sha, enc) in frames
        ]

        # 2. write staged index blobs + overflow pending-embedding segment
        manifests = dict(self.toc.manifests)
        catalog = list(self.toc.segment_catalog)
        staged = dict(self._staged)
        if uncovered and allow_pending_embeddings:
            staged["pending_emb"] = (_encode_pending_embeddings(uncovered), {"count": str(len(uncovered))})
        elif "pending_emb" in manifests and not uncovered:
            manifests.pop("pending_emb", None)
        for kind in sorted(staged):
            blob, attrs = staged[kind]
            off = self._append_payload(blob)
            man = SegmentManifest(kind=kind, offset=off, length=len(blob), sha=sha256(blob), attrs=attrs)
            manifests[kind] = man
            catalog.append(man)

        # 3. TOC
        generation = self.toc.generation + 1
        committed_seq = self.wal.stats.last_seq
        toc = StoreTOC(
            frames=tuple(frames),
            manifests=manifests,
            segment_catalog=tuple(catalog),
            committed_seq=committed_seq,
            generation=generation,
        )
        toc_bytes = toc.encode()
        toc_off = self._append_payload(toc_bytes)
        CrashCheckpoint.maybe_crash(CrashCheckpoint.TOC_WRITTEN)

        # 4. footer (aligned)
        pad = (-self.data_end) % FOOTER_ALIGN
        if pad:
            self._append_payload(b"\x00" * pad)
        footer = Footer(
            toc_offset=toc_off,
            toc_len=len(toc_bytes),
            generation=generation,
            committed_seq=committed_seq,
            toc_sha16=sha256(toc_bytes)[:16],
        )
        footer_off = self._append_payload(footer.encode())
        CrashCheckpoint.maybe_crash(CrashCheckpoint.FOOTER_WRITTEN)
        self.fd.fsync()
        CrashCheckpoint.maybe_crash(CrashCheckpoint.FSYNC_DONE)

        # 5. alternate header page with replay snapshot
        self.wal.record_checkpoint()
        self.header_gen += 1
        self.header_slot = 1 - self.header_slot
        header = HeaderPage(
            header_gen=self.header_gen,
            file_gen=generation,
            footer_offset=footer_off,
            wal_offset=HEADER_REGION,
            wal_size=self.options.wal_size,
            committed_seq=committed_seq,
            # Written unconditionally: the checkpoint position is required for correct
            # recovery after a WAL ring wrap (scanning from 0 would see only post-wrap
            # records and the dense-prefix prune would drop every pending mutation).
            # options.enable_replay_snapshot only gates the sentinel FAST PATH at open.
            replay_snapshot=ReplaySnapshot(self.wal.stats.write_pos, committed_seq, 0),
        )
        self.fd.pwrite_exact(self.header_slot * HEADER_SIZE, header.encode())
        CrashCheckpoint.maybe_crash(CrashCheckpoint.HEADER_WRITTEN)
        self.fd.fsync()

        # 6. clear pending state; uncovered embeddings stay pending in memory (they
        # are crash-safe in the overflow segment and await the next vec staging)
        self.toc = toc
        self.committed_seq = committed_seq
        self._pending.clear()
        self._pending_deletes.clear()
        self._pending_supersedes.clear()
        self._pending_embeddings = list(uncovered)
        self._staged.clear()
        self.stats_counters["commits"] += 1
        return generation

    def _finalize_meta(self, m: FrameMeta) -> FrameMeta:
        if m.frame_id in self._pending_deletes:
            m = replace(m, status=FrameStatus.DELETED.value)
        new = self._pending_supersedes.get(m.frame_id)
        if new is not None:
            m = replace(m, superseded_by=new)
        return m

    def auto_commit(self) -> None:
        """Proactive commit under WAL pressure (reference: Wax.swift:249-309)."""
        self.commit(allow_pending_embeddings=True)
        self.stats_counters["auto_commits"] += 1
        self.wal.stats.auto_commit_count += 1

    # ------------------------------------------------------------------- segments ----
    def read_segment(self, kind: str) -> bytes | None:
        from wax_tpu_torch.utils.profiling import span

        man = self.toc.manifests.get(kind)
        if man is None:
            return None
        with span("store.segment_pread"):
            raw = self.fd.pread_exact(man.offset, man.length)
        with span("store.segment_sha256"):
            if sha256(raw) != man.sha:
                raise StoreError(f"segment {kind} checksum mismatch")
        return raw


    # ------------------------------------------------------------------ inspection ----
    def verify(self, deep: bool = False) -> dict:
        """Integrity check (reference: Wax.swift:2123)."""
        report = {
            "frames": self.frame_count(),
            "generation": self.toc.generation,
            "merkle_root": self.toc.merkle_root().hex(),
            "errors": [],
        }
        if deep:
            actual_shas = []
            for fid in range(self.frame_count()):
                rec = self._frame_record(fid)
                if rec is None:
                    continue
                _, off, ln, sha, _ = rec
                try:
                    actual = sha256(self.fd.pread_exact(off, ln))
                    actual_shas.append(actual)
                    if actual != sha:
                        report["errors"].append(f"frame {fid} payload hash mismatch")
                except OSError as e:
                    report["errors"].append(f"frame {fid} unreadable: {e}")
            for kind in self.toc.manifests:
                try:
                    self.read_segment(kind)
                except StoreError as e:
                    report["errors"].append(str(e))
            # the merkle commitment must match what the file actually contains
            rebuilt = self.toc.with_updates(
                frames=tuple(
                    (m, o, l, a, e)
                    for (m, o, l, _s, e), a in zip(self.toc.frames, actual_shas)
                )
            ).merkle_root()
            if len(actual_shas) == len(self.toc.frames) and rebuilt != self.toc.merkle_root():
                report["errors"].append("merkle root does not match file contents")
            if (
                self.toc.stored_merkle is not None
                and self.toc.stored_merkle != self.toc.merkle_root()
            ):
                report["errors"].append("stored merkle root does not match TOC columns")
        report["ok"] = not report["errors"]
        return report

    def stats(self) -> dict:
        return {
            **self.stats_counters,
            "frame_count": self.frame_count(),
            "pending_frames": len(self._pending),
            "pending_embeddings": len(self._pending_embeddings),
            "generation": self.toc.generation,
            "data_end": self.data_end,
            "file_size": self.fd.size(),
        }

    def wal_stats(self) -> dict:
        s = self.wal.stats
        return {
            "write_pos": s.write_pos,
            "checkpoint_pos": s.checkpoint_pos,
            "last_seq": s.last_seq,
            "pending_bytes": s.pending_bytes,
            "pending_records": s.pending_records,
            "wrap_count": s.wrap_count,
            "checkpoint_count": s.checkpoint_count,
            "sentinel_write_count": s.sentinel_write_count,
            "append_count": s.append_count,
            "auto_commit_count": s.auto_commit_count,
            "replay_snapshot_hit_count": s.replay_snapshot_hit_count,
            "fill_fraction": self.wal.fill_fraction(),
        }

    def close(self) -> None:
        if not self._closed:
            self.fd.close()
            self.lock.release()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _encode_pending_embeddings(items: list[tuple[int, int, np.ndarray]]) -> bytes:
    from wax_tpu_torch.storage.codec import BinaryEncoder

    e = BinaryEncoder()
    e.u32(len(items))
    for seq, fid, vec in items:
        v = np.asarray(vec, dtype="<f4")
        e.u64(seq).i64(fid).u32(v.shape[0]).raw(v.tobytes())
    return e.data()


def _decode_pending_embeddings(blob: bytes) -> list[tuple[int, np.ndarray]]:
    d = BinaryDecoder(blob)
    out = []
    for _ in range(d.u32()):
        _seq = d.u64()
        fid = d.i64()
        dim = d.u32()
        out.append((fid, np.frombuffer(d.raw(dim * 4), dtype="<f4").copy()))
    return out
