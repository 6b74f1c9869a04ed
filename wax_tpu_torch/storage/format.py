# Verbatim copy of wax_tpu/storage/format.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""WXS1 single-file snapshot format: dual header pages, TOC, footer, manifests.

TPU-build redesign of the reference's MV2S format (reference:
Sources/WaxCore/FileFormat/ — MV2SHeaderPage.swift:3-340 dual 4 KiB headers with
generation + checksum + optional WAL replay snapshot; MV2STOC.swift:42-253 dense frame
array + index manifests + segment catalog; MV2SFooter.swift:1-86 64-byte footer;
FooterScanner.swift:20-267 bounded backward scan; Constants.swift:4-55). The layout
keeps the same crash-safety recipe — append-only data, atomic footer+header flip —
with segment manifests generalized to the TPU index set (lex CSR / dense vectors /
graph adjacency / structured store) stored as checksummed array blobs.

File layout:
    [header A: 4 KiB][header B: 4 KiB][WAL ring: wal_size][data region ...]
Data region holds payload frames, index segment blobs, TOCs and footers, all
append-only; commits write TOC -> footer -> alternate header.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field, replace

from wax_tpu_torch.storage.codec import LIMITS, BinaryDecoder, BinaryEncoder, CodecError
from wax_tpu_torch.types import FrameMeta

__all__ = [
    "MAGIC",
    "FOOTER_MAGIC",
    "HEADER_SIZE",
    "HEADER_REGION",
    "FOOTER_SIZE",
    "FOOTER_ALIGN",
    "FOOTER_SCAN_BOUND",
    "DEFAULT_WAL_SIZE",
    "FORMAT_VERSION",
    "HeaderPage",
    "ReplaySnapshot",
    "SegmentManifest",
    "StoreTOC",
    "FrameTable",
    "Footer",
    "encode_frame_meta",
    "decode_frame_meta",
    "select_valid_header",
    "scan_all_footers",
    "scan_for_footer",
]

MAGIC = b"WXS1"
FOOTER_MAGIC = b"WXS1FOOT"
FORMAT_VERSION = 1
HEADER_SIZE = 4096
HEADER_REGION = 2 * HEADER_SIZE
FOOTER_SIZE = 64
FOOTER_ALIGN = 64
FOOTER_SCAN_BOUND = 32 * 1024 * 1024  # reference Constants.swift:53
DEFAULT_WAL_SIZE = 16 * 1024 * 1024


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# -- header -----------------------------------------------------------------------------


@dataclass(frozen=True)
class ReplaySnapshot:
    """WAL scan state persisted in the header so open() can skip the full WAL scan
    (reference: MV2SHeaderPage.swift:22-48, used Wax.swift:607-650)."""

    wal_write_pos: int
    wal_last_seq: int
    pending_bytes: int


@dataclass(frozen=True)
class HeaderPage:
    header_gen: int
    file_gen: int
    footer_offset: int
    wal_offset: int
    wal_size: int
    committed_seq: int
    replay_snapshot: ReplaySnapshot | None = None
    format_version: int = FORMAT_VERSION

    def encode(self) -> bytes:
        e = BinaryEncoder()
        e.raw(MAGIC).u32(self.format_version)
        e.u64(self.header_gen).u64(self.file_gen).u64(self.footer_offset)
        e.u64(self.wal_offset).u64(self.wal_size).u64(self.committed_seq)
        e.boolean(self.replay_snapshot is not None)
        if self.replay_snapshot is not None:
            s = self.replay_snapshot
            e.u64(s.wal_write_pos).u64(s.wal_last_seq).u64(s.pending_bytes)
        body = e.data()
        page = body + sha256(body)
        assert len(page) <= HEADER_SIZE
        return page + b"\x00" * (HEADER_SIZE - len(page))

    @classmethod
    def decode(cls, page: bytes) -> "HeaderPage":
        if len(page) < 64 or page[:4] != MAGIC:
            raise CodecError("bad header magic")
        d = BinaryDecoder(page, 4)
        version = d.u32()
        header_gen = d.u64()
        file_gen = d.u64()
        footer_offset = d.u64()
        wal_offset = d.u64()
        wal_size = d.u64()
        committed_seq = d.u64()
        snap = None
        if d.boolean():
            snap = ReplaySnapshot(d.u64(), d.u64(), d.u64())
        body_len = d.offset
        digest = page[body_len : body_len + 32]
        if digest != sha256(page[:body_len]):
            raise CodecError("header checksum mismatch")
        return cls(header_gen, file_gen, footer_offset, wal_offset, wal_size, committed_seq, snap, version)


def select_valid_header(page_a: bytes, page_b: bytes) -> tuple[HeaderPage, int] | None:
    """Pick the newest valid header page; returns (header, slot 0|1) or None
    (reference: MV2SHeaderPage.selectValidPage :309)."""
    best: tuple[HeaderPage, int] | None = None
    for slot, page in ((0, page_a), (1, page_b)):
        try:
            h = HeaderPage.decode(page)
        except CodecError:
            continue
        if best is None or h.header_gen > best[0].header_gen:
            best = (h, slot)
    return best


# -- frame meta codec ---------------------------------------------------------------------


def encode_frame_meta(m: FrameMeta, payload_offset: int, payload_len: int, payload_sha: bytes, encoding: int) -> bytes:
    e = BinaryEncoder()
    e.i64(m.frame_id).i64(m.timestamp_ms).string(m.kind)
    e.opt_string(m.search_text)
    e.str_map(dict(m.metadata)).str_list(list(m.tags))
    e.opt_i64(m.parent_id).opt_i64(m.chunk_index).opt_i64(m.chunk_count)
    e.string(m.status).opt_i64(m.supersedes).opt_i64(m.superseded_by)
    e.u64(payload_offset).u64(payload_len).raw(payload_sha).u8(encoding)
    return e.data()


_S_U32 = struct.Struct("<I")
_S_QQ = struct.Struct("<qq")
_S_Q = struct.Struct("<q")
_S_QQ_U = struct.Struct("<QQ")


def decode_frame_meta(d: BinaryDecoder) -> tuple[FrameMeta, int, int, bytes, int]:
    """Single-pass frame-meta parse (same byte format as encode_frame_meta).

    Hand-rolled with struct.unpack_from instead of the generic BinaryDecoder: the
    TOC decodes every frame on open, and the per-field codec's method/slice overhead
    made frame decode the cold-open hotspot (38 ms for 1K frames; this path is ~6x
    faster). Bounds violations surface as CodecError exactly like the slow path.
    """
    buf, o = d._d, d._o
    blen = len(buf)
    try:
        frame_id, ts = _S_QQ.unpack_from(buf, o)
        o += 16

        def rd_str(o):
            (n,) = _S_U32.unpack_from(buf, o)
            o += 4
            if n > LIMITS.MAX_STRING:
                raise CodecError("string too long")
            if o + n > blen:
                raise CodecError("decode overrun: string")
            return buf[o : o + n].decode("utf-8"), o + n

        kind, o = rd_str(o)
        if o >= blen:
            raise CodecError("decode overrun")
        search_text = None
        if buf[o] > 1:
            raise CodecError(f"invalid bool byte {buf[o]}")
        if buf[o]:
            search_text, o = rd_str(o + 1)
        else:
            o += 1
        (nmap,) = _S_U32.unpack_from(buf, o)
        o += 4
        if nmap > LIMITS.MAX_ARRAY_ITEMS:
            raise CodecError("map too large")
        metadata = {}
        for _ in range(nmap):
            mk, o = rd_str(o)
            mv, o = rd_str(o)
            metadata[mk] = mv
        (ntags,) = _S_U32.unpack_from(buf, o)
        o += 4
        if ntags > LIMITS.MAX_ARRAY_ITEMS:
            raise CodecError("array too large")
        tags = []
        for _ in range(ntags):
            tg, o = rd_str(o)
            tags.append(tg)

        def rd_opt_i64(o):
            if o >= blen:
                raise CodecError("decode overrun")
            flag = buf[o]
            if flag > 1:
                raise CodecError(f"invalid bool byte {flag}")
            if flag:
                (v,) = _S_Q.unpack_from(buf, o + 1)
                return v, o + 9
            return None, o + 1

        parent_id, o = rd_opt_i64(o)
        chunk_index, o = rd_opt_i64(o)
        chunk_count, o = rd_opt_i64(o)
        status, o = rd_str(o)
        supersedes, o = rd_opt_i64(o)
        superseded_by, o = rd_opt_i64(o)
        off, ln = _S_QQ_U.unpack_from(buf, o)
        o += 16
        if o + 33 > blen:
            raise CodecError("decode overrun: frame trailer")
        sha = buf[o : o + 32]
        encoding = buf[o + 32]
        o += 33
    except struct.error as e:
        raise CodecError(f"decode overrun: {e}") from None
    d._o = o
    meta = FrameMeta(
        frame_id=frame_id,
        timestamp_ms=ts,
        kind=kind,
        search_text=search_text,
        metadata=metadata,
        tags=tuple(tags),
        parent_id=parent_id,
        chunk_index=chunk_index,
        chunk_count=chunk_count,
        status=status,
        supersedes=supersedes,
        superseded_by=superseded_by,
    )
    return meta, off, ln, bytes(sha), encoding


# -- TOC ----------------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentManifest:
    """Committed index blob descriptor (reference: IndexManifests.swift:1-156 +
    SegmentCatalog.swift:1-122 unified — kind in {"lex","vec","graph","structured"})."""

    kind: str
    offset: int
    length: int
    sha: bytes
    version: int = 1
    # kind-specific counters (doc_count / vector_count+dim / node_count ...)
    attrs: dict[str, str] = field(default_factory=dict)

    def encode(self, e: BinaryEncoder) -> None:
        e.string(self.kind).u64(self.offset).u64(self.length).raw(self.sha)
        e.u32(self.version).str_map(self.attrs)

    @classmethod
    def decode(cls, d: BinaryDecoder) -> "SegmentManifest":
        return cls(
            kind=d.string(),
            offset=d.u64(),
            length=d.u64(),
            sha=d.raw(32),
            version=d.u32(),
            attrs=d.str_map(),
        )


class FrameTable:
    """Columnar committed-frame table with LAZY FrameMeta materialization.

    Decoded from a WXSTOC02 TOC: fixed-width fields live in numpy column views over
    the TOC bytes; a frame's FrameMeta object is only built (and cached) when that
    frame is actually touched. Open-time cost is therefore O(1) in the frame count —
    the v1 per-frame decode was the cold-open scaling wall (17 ms at 1K frames,
    linear). Supports the same read protocol as the v1 tuple-of-records: len(),
    iteration, and indexing yield (meta, payload_off, payload_len, sha, encoding).
    """

    __slots__ = ("_n", "_c", "_rows")

    def __init__(self, n: int, cols: dict):
        self._n = n
        self._c = cols
        self._rows: list = [None] * n

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def payload_sha(self, i: int) -> bytes:
        return bytes(self._c["shas"][i * 32 : (i + 1) * 32])

    def ids_of_kind(self, kind: str) -> list[int]:
        """Frame ids whose kind equals `kind` — a numpy scan over the kind-code
        column, no row materialization (open-time lookups stay O(1) in metas)."""
        import numpy as np

        try:
            code = self._c["kind_vocab"].index(kind)
        except ValueError:
            return []
        return np.nonzero(self._c["kind_code"] == code)[0].tolist()

    def __getitem__(self, i: int):
        if not (0 <= i < self._n):
            raise IndexError(i)
        row = self._rows[i]
        if row is None:
            c = self._c
            opt = lambda v: None if v < 0 else int(v)  # noqa: E731
            st = None
            if c["has_st"][i]:
                st = bytes(c["st_blob"][c["st_off"][i] : c["st_off"][i + 1]]).decode("utf-8")
            mo = c["md_off"]
            m0, m1 = int(mo[i]), int(mo[i + 1])
            so = c["md_str_off"]
            blob = c["md_blob"]
            metadata = {}
            for p in range(m0, m1):
                k = bytes(blob[so[2 * p] : so[2 * p + 1]]).decode("utf-8")
                v = bytes(blob[so[2 * p + 1] : so[2 * p + 2]]).decode("utf-8")
                metadata[k] = v
            to = c["tg_off"]
            t0, t1 = int(to[i]), int(to[i + 1])
            tso = c["tg_str_off"]
            tags = tuple(
                bytes(c["tg_blob"][tso[p] : tso[p + 1]]).decode("utf-8") for p in range(t0, t1)
            )
            meta = FrameMeta(
                frame_id=i,
                timestamp_ms=int(c["ts"][i]),
                kind=c["kind_vocab"][c["kind_code"][i]],
                search_text=st,
                metadata=metadata,
                tags=tags,
                parent_id=opt(c["parent"][i]),
                chunk_index=opt(c["ci"][i]),
                chunk_count=opt(c["cc"][i]),
                status=c["status_vocab"][c["status_code"][i]],
                supersedes=opt(c["sup"][i]),
                superseded_by=opt(c["supby"][i]),
            )
            row = (meta, int(c["off"][i]), int(c["ln"][i]), self.payload_sha(i), int(c["enc"][i]))
            self._rows[i] = row
        return row


@dataclass(frozen=True)
class StoreTOC:
    """Table of contents written on every commit (reference: MV2STOC.swift:42-253).

    frames: dense by frame id — (meta, payload_offset, payload_len, payload_sha,
    encoding) records; a tuple on the write path, a lazy FrameTable when decoded
    from a v2 TOC. manifests: current committed index blobs keyed by kind.
    segment_catalog: append-only history of every segment ever written.
    """

    frames: tuple | FrameTable
    manifests: dict[str, SegmentManifest]
    segment_catalog: tuple[SegmentManifest, ...]
    committed_seq: int
    generation: int
    # the root as stored in the decoded TOC bytes (v2 path); None on the write path.
    # v2 decode does not recompute the root (O(n) sha256 — a cold-open scaling
    # cost; the body sha256 already guards integrity): deep verify compares this
    # against the recomputed root instead.
    stored_merkle: bytes | None = None

    def merkle_root(self) -> bytes:
        """Merkle root over all committed content hashes (reference: MV2STOC.swift:42
        carries a merkle root next to the TOC checksum).

        Leaves are the per-frame payload sha256s followed by the segment-catalog
        sha256s, each re-hashed for domain separation, then reduced pairwise (odd
        node pairs with itself). Lets an auditor prove any single payload against
        one 32-byte commitment without re-reading the whole file.
        """
        if isinstance(self.frames, FrameTable):
            leaves = [self.frames.payload_sha(i) for i in range(len(self.frames))]
        else:
            leaves = [sha for (_m, _o, _l, sha, _e) in self.frames]
        leaves += [seg.sha for seg in self.segment_catalog]
        if not leaves:
            return b"\x00" * 32
        level = [sha256(leaf) for leaf in leaves]
        while len(level) > 1:
            level = [
                sha256(level[i] + (level[i + 1] if i + 1 < len(level) else level[i]))
                for i in range(0, len(level), 2)
            ]
        return level[0]

    def encode(self) -> bytes:
        """v2 columnar TOC (magic WXSTOC02): frame fields as packed column blobs so
        decode can wrap numpy views instead of parsing per frame. v1 (WXSTOC01)
        remains readable for stores written before round 3."""
        import numpy as np

        n = len(self.frames)
        ts = np.empty(n, np.int64)
        off = np.empty(n, np.uint64)
        ln = np.empty(n, np.uint64)
        enc_col = np.empty(n, np.uint8)
        parent = np.empty(n, np.int64)
        ci = np.empty(n, np.int64)
        cc = np.empty(n, np.int64)
        sup = np.empty(n, np.int64)
        supby = np.empty(n, np.int64)
        has_st = np.zeros(n, np.uint8)
        kind_code = np.empty(n, np.uint16)
        status_code = np.empty(n, np.uint8)
        shas = bytearray()
        kind_vocab: dict[str, int] = {}
        status_vocab: dict[str, int] = {}
        st_parts: list[bytes] = []
        st_lens = np.zeros(n, np.int64)
        md_counts = np.zeros(n, np.int64)
        md_parts: list[bytes] = []
        md_lens: list[int] = []
        tg_counts = np.zeros(n, np.int64)
        tg_parts: list[bytes] = []
        tg_lens: list[int] = []
        opt = lambda v: -1 if v is None else int(v)  # noqa: E731
        for i, (meta, o_, l_, sha, e_) in enumerate(self.frames):
            if meta.frame_id != i:
                raise CodecError(f"non-dense frame ids: slot {i} holds {meta.frame_id}")
            ts[i] = meta.timestamp_ms
            off[i], ln[i], enc_col[i] = o_, l_, e_
            parent[i] = opt(meta.parent_id)
            ci[i] = opt(meta.chunk_index)
            cc[i] = opt(meta.chunk_count)
            sup[i] = opt(meta.supersedes)
            supby[i] = opt(meta.superseded_by)
            shas += sha
            kind_code[i] = kind_vocab.setdefault(meta.kind, len(kind_vocab))
            status_code[i] = status_vocab.setdefault(meta.status, len(status_vocab))
            if meta.search_text is not None:
                has_st[i] = 1
                raw = meta.search_text.encode("utf-8")
                st_parts.append(raw)
                st_lens[i] = len(raw)
            md_counts[i] = len(meta.metadata)
            for k in sorted(meta.metadata):
                kb, vb = k.encode("utf-8"), meta.metadata[k].encode("utf-8")
                md_parts += [kb, vb]
                md_lens += [len(kb), len(vb)]
            tg_counts[i] = len(meta.tags)
            for t in meta.tags:
                tb = t.encode("utf-8")
                tg_parts.append(tb)
                tg_lens.append(len(tb))
        if len(kind_vocab) > 65535 or len(status_vocab) > 255:
            raise CodecError("vocab overflow in TOC columns")

        e = BinaryEncoder()
        e.raw(b"WXSTOC02").u32(FORMAT_VERSION)
        e.u64(self.generation).u64(self.committed_seq)
        e.u32(n)
        for col in (ts, off, ln, enc_col, parent, ci, cc, sup, supby, has_st, kind_code, status_code):
            e.blob(col.tobytes())
        e.blob(bytes(shas))
        e.str_list(list(kind_vocab))
        e.str_list(list(status_vocab))
        e.blob(st_lens.tobytes()).blob(b"".join(st_parts))
        e.blob(md_counts.tobytes())
        e.blob(np.asarray(md_lens, np.int64).tobytes()).blob(b"".join(md_parts))
        e.blob(tg_counts.tobytes())
        e.blob(np.asarray(tg_lens, np.int64).tobytes()).blob(b"".join(tg_parts))
        e.u32(len(self.manifests))
        for kind in sorted(self.manifests):
            self.manifests[kind].encode(e)
        e.u32(len(self.segment_catalog))
        for seg in self.segment_catalog:
            seg.encode(e)
        e.raw(self.merkle_root())
        body = e.data()
        return body + sha256(body)

    @classmethod
    def decode(cls, data: bytes) -> "StoreTOC":
        if len(data) < 44 or data[:8] not in (b"WXSTOC01", b"WXSTOC02"):
            raise CodecError("bad TOC magic")
        body, digest = data[:-32], data[-32:]
        if sha256(body) != digest:
            raise CodecError("TOC checksum mismatch")
        if data[:8] == b"WXSTOC02":
            return cls._decode_v2(body)
        d = BinaryDecoder(body, 8)
        _version = d.u32()
        generation = d.u64()
        committed_seq = d.u64()
        n = d.u32()
        frames = []
        for _ in range(n):
            sub = BinaryDecoder(d.blob())
            frames.append(decode_frame_meta(sub))
        manifests = {}
        for _ in range(d.u32()):
            m = SegmentManifest.decode(d)
            manifests[m.kind] = m
        catalog = tuple(SegmentManifest.decode(d) for _ in range(d.u32()))
        toc = cls(tuple(frames), manifests, catalog, committed_seq, generation)
        stored_root = d.raw(32)
        if stored_root != toc.merkle_root():
            raise CodecError("TOC merkle root mismatch")
        return toc

    @classmethod
    def _decode_v2(cls, body: bytes) -> "StoreTOC":
        """Columnar decode: numpy views over the TOC bytes, lazy FrameMeta rows.

        The merkle root is NOT recomputed here (the body sha256 above already
        guarantees integrity of the column data, and recomputing is O(n) sha256
        calls — a cold-open scaling cost); deep verify recomputes it from actual
        payload bytes (store.verify)."""
        import numpy as np

        d = BinaryDecoder(body, 8)
        _version = d.u32()
        generation = d.u64()
        committed_seq = d.u64()
        n = d.u32()
        dtypes = (
            np.int64, np.uint64, np.uint64, np.uint8, np.int64, np.int64, np.int64,
            np.int64, np.int64, np.uint8, np.uint16, np.uint8,
        )
        names = ("ts", "off", "ln", "enc", "parent", "ci", "cc", "sup", "supby", "has_st", "kind_code", "status_code")
        cols: dict = {}
        for name, dt in zip(names, dtypes):
            raw = d.blob()
            col = np.frombuffer(raw, dt)
            if len(col) != n:
                raise CodecError(f"TOC column {name} length mismatch")
            cols[name] = col
        shas = d.blob()
        if len(shas) != 32 * n:
            raise CodecError("TOC sha column length mismatch")
        cols["shas"] = shas
        cols["kind_vocab"] = d.str_list()
        cols["status_vocab"] = d.str_list()
        st_lens = np.frombuffer(d.blob(), np.int64)
        cols["st_off"] = np.concatenate([[0], np.cumsum(st_lens)])
        cols["st_blob"] = d.blob()
        md_counts = np.frombuffer(d.blob(), np.int64)
        cols["md_off"] = np.concatenate([[0], np.cumsum(md_counts)])
        md_lens = np.frombuffer(d.blob(), np.int64)
        cols["md_str_off"] = np.concatenate([[0], np.cumsum(md_lens)])
        cols["md_blob"] = d.blob()
        tg_counts = np.frombuffer(d.blob(), np.int64)
        cols["tg_off"] = np.concatenate([[0], np.cumsum(tg_counts)])
        tg_lens = np.frombuffer(d.blob(), np.int64)
        cols["tg_str_off"] = np.concatenate([[0], np.cumsum(tg_lens)])
        cols["tg_blob"] = d.blob()
        if (
            len(st_lens) != n
            or len(md_counts) != n
            or len(tg_counts) != n
            or (len(cols["kind_vocab"]) == 0 and n > 0)
            # numpy-vectorized bound checks: builtin any() would iterate per element
            or bool((cols["kind_code"] >= max(len(cols["kind_vocab"]), 1)).any())
            or bool((cols["status_code"] >= max(len(cols["status_vocab"]), 1)).any())
        ):
            raise CodecError("TOC column inconsistency")
        manifests = {}
        for _ in range(d.u32()):
            m = SegmentManifest.decode(d)
            manifests[m.kind] = m
        catalog = tuple(SegmentManifest.decode(d) for _ in range(d.u32()))
        stored_root = d.raw(32)  # checked by deep verify, not here (see docstring)
        return cls(FrameTable(n, cols), manifests, catalog, committed_seq, generation, stored_root)

    @classmethod
    def empty(cls) -> "StoreTOC":
        return cls(frames=(), manifests={}, segment_catalog=(), committed_seq=0, generation=0)

    def with_updates(self, **kw) -> "StoreTOC":
        # any mutation invalidates the decoded stored_merkle (it described the old
        # columns); re-encoding computes a fresh root
        kw.setdefault("stored_merkle", None)
        return replace(self, **kw)


# -- footer --------------------------------------------------------------------------------


@dataclass(frozen=True)
class Footer:
    """64-byte footer (reference: MV2SFooter.swift:1-86): magic, TOC location+hash,
    generation, committed WAL seq, self-checksum."""

    toc_offset: int
    toc_len: int
    generation: int
    committed_seq: int
    toc_sha16: bytes  # first 16 bytes of the TOC sha256

    def encode(self) -> bytes:
        body = (
            FOOTER_MAGIC
            + self.toc_offset.to_bytes(8, "little")
            + self.toc_len.to_bytes(8, "little")
            + self.generation.to_bytes(8, "little")
            + self.committed_seq.to_bytes(8, "little")
            + self.toc_sha16
        )
        out = body + sha256(body)[:8]
        assert len(out) == FOOTER_SIZE
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Footer":
        if len(data) != FOOTER_SIZE or data[:8] != FOOTER_MAGIC:
            raise CodecError("bad footer")
        if sha256(data[:56])[:8] != data[56:]:
            raise CodecError("footer checksum mismatch")
        return cls(
            toc_offset=int.from_bytes(data[8:16], "little"),
            toc_len=int.from_bytes(data[16:24], "little"),
            generation=int.from_bytes(data[24:32], "little"),
            committed_seq=int.from_bytes(data[32:40], "little"),
            toc_sha16=data[40:56],
        )


def scan_all_footers(fd, file_size: int, data_start: int) -> list[tuple[Footer, int]]:
    """Bounded backward scan for EVERY decodable footer, newest generation first
    (reference: FooterScanner.findLastValidFooter :20-72 — last 32 MiB). Returning
    all candidates lets recovery fall back to an older generation when the newest
    footer's TOC bytes are damaged (the WaxDemoCorruptTOC scenario)."""
    lo = max(data_start, file_size - FOOTER_SCAN_BOUND)
    lo = lo + (-lo) % FOOTER_ALIGN
    found: list[tuple[Footer, int]] = []
    off = file_size - (file_size % FOOTER_ALIGN) - FOOTER_SIZE
    # read in chunks from the end backward
    while off >= lo:
        chunk_lo = max(lo, off - 4 * 1024 * 1024)
        blob = fd.pread(chunk_lo, off - chunk_lo + FOOTER_SIZE)
        # memchr-speed magic scan (a Python loop slicing every 64 bytes was a
        # cold-open hotspot); alignment is checked on each hit
        i = blob.find(FOOTER_MAGIC)
        while i != -1:
            if (chunk_lo + i) % FOOTER_ALIGN == 0 and i + FOOTER_SIZE <= len(blob):
                try:
                    f = Footer.decode(blob[i : i + FOOTER_SIZE])
                    found.append((f, chunk_lo + i))
                except CodecError:
                    pass
            i = blob.find(FOOTER_MAGIC, i + 1)
        off = chunk_lo - FOOTER_SIZE
        if chunk_lo == lo:
            break
    found.sort(key=lambda t: (-t[0].generation, -t[1]))
    return found


def scan_for_footer(fd, file_size: int, data_start: int) -> tuple[Footer, int] | None:
    """Newest valid footer, or None (see scan_all_footers)."""
    all_found = scan_all_footers(fd, file_size, data_start)
    return all_found[0] if all_found else None
