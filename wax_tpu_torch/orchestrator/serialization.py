"""Index builder <-> segment blob serialization.

The TPU analogue of the reference's index-image serialization: FTS5 serializes the
whole SQLite image into the lex segment (reference: FTS5SearchEngine.swift:486-543) and
the vector engines serialize a raw f32 matrix / USearch buffer wrapped in a "MV2V"
header (VectorSerializer.swift:5-220). Here both become array serialization: a raw
zero-copy array container (save_arrays/load_arrays) holding the dense index's live
arrays and the lex index's columnar token/postings arrays — each wrapped in the
store's checksummed segment manifest. Legacy round-2 formats (npz dense, JSON lex)
remain readable.

PyTorch port of `wax_tpu.orchestrator.serialization`: the blobs and attrs are the JAX
package's, byte for byte, so a store written by either package opens in the other.
Engines are rebuilt on an explicit `device`. A `sharded` segment is layout-free and
loads as a flat engine (the mesh-sharded engine waits for multi-GPU, ROADMAP queue 1,
item 5).
"""
from __future__ import annotations

import io
import json
from collections import Counter

import numpy as np

from wax_tpu_torch.index.dense import DenseIndexBuilder
from wax_tpu_torch.index.lex import LexIndexBuilder

__all__ = [
    "serialize_dense",
    "deserialize_dense",
    "serialize_lex",
    "deserialize_lex",
    "serialize_vector_engine",
    "deserialize_vector_engine",
]

def save_arrays(arrays: dict) -> bytes:
    """Raw array container: one JSON header {name, dtype, shape, offset} + packed
    array bytes.

    Chosen over npz/npy: np.savez costs ~70 ms to re-read a 7.5 MB segment (zip
    chunked reads + crc32) and even np.load on plain .npy blocks pays a chunked
    fp.read copy loop (~80 ms measured on the throttled host) — both cold-open
    hotspots. load_arrays returns ZERO-COPY np.frombuffer views over the blob
    (read-only; builders copy into their own mutable state as needed)."""
    metas = []
    parts = []
    off = 0
    for name, a in arrays.items():
        a = np.asarray(a)
        shape = list(a.shape)  # BEFORE ascontiguousarray: it promotes 0-d to 1-d
        a = np.ascontiguousarray(a)
        raw = a.tobytes()
        metas.append({"n": name, "d": a.dtype.str, "s": shape, "o": off})
        parts.append(raw)
        off += len(raw)
    header = json.dumps(metas, separators=(",", ":")).encode("utf-8")
    return len(header).to_bytes(4, "little") + header + b"".join(parts)


def load_arrays(blob: bytes) -> dict:
    n = int.from_bytes(blob[:4], "little")
    metas = json.loads(blob[4 : 4 + n].decode("utf-8"))
    base = 4 + n
    out = {}
    for m in metas:
        dt = np.dtype(m["d"])
        count = int(np.prod(m["s"], dtype=np.int64)) if m["s"] else 1
        out[m["n"]] = np.frombuffer(blob, dt, count=count, offset=base + m["o"]).reshape(m["s"])
    return out


DENSE_FORMAT = "wxs-dense-npz-v1"  # read-compat only (round-2 stores)
DENSE_FORMAT_V2 = "wxs-dense-raw-v2"  # written: sequential .npy container
LEX_FORMAT = "wxs-lex-json-v1"  # read-compat only (round-2 stores)
LEX_FORMAT_V2 = "wxs-lex-cols-v2"  # written format: columnar arrays, frozen fast load
HNSW_FORMAT = "wxs-hnsw-npz-v1"  # read-compat only
HNSW_FORMAT_V2 = "wxs-hnsw-raw-v2"


def serialize_dense(builder: DenseIndexBuilder) -> tuple[bytes, dict[str, str]]:
    # aligned=True pads the stored row count to the builder's ROW_ALIGN so the next
    # open ADOPTS the container views zero-copy (from_state_arrays); the live count
    # travels in attrs["count"]
    arrays = builder.state_arrays(aligned=True)
    blob = save_arrays(
        {
            "emb": arrays["emb"].astype(np.float32),
            "frame_ids": arrays["frame_ids"],
            "active": arrays["active"],
        }
    )
    attrs = {
        "format": DENSE_FORMAT_V2,
        "dim": str(builder.dim),
        "similarity": builder.similarity,
        "count": str(builder.count),
        "live": str(len(builder)),
    }
    return blob, attrs


def deserialize_dense(blob: bytes, attrs: dict[str, str]) -> DenseIndexBuilder:
    if attrs.get("format") not in (DENSE_FORMAT, DENSE_FORMAT_V2):
        raise ValueError(f"unsupported dense segment format {attrs.get('format')!r}")
    data = np.load(io.BytesIO(blob)) if blob[:2] == b"PK" else load_arrays(blob)
    count = int(attrs["count"]) if attrs.get("count") else None
    return DenseIndexBuilder.from_state_arrays(
        {"emb": data["emb"], "frame_ids": data["frame_ids"], "active": data["active"]},
        dim=int(attrs["dim"]),
        similarity=attrs.get("similarity", "cosine"),
        count=count,
    )


def serialize_vector_engine(
    engine, embedder_identity: str | None = None
) -> tuple[bytes, dict[str, str]]:
    """Serialize a flat, auto, HNSW or IVF vector engine into a segment blob.

    When `embedder_identity` is given it is recorded in the segment attrs so a later
    open can detect that the index was built by a different provider (the analogue of
    the reference tying its vector index to the CoreML model identity)."""
    blob, attrs = _serialize_vector_engine(engine)
    if embedder_identity is not None:
        attrs["embedder"] = embedder_identity
    return blob, attrs


def _serialize_vector_engine(engine) -> tuple[bytes, dict[str, str]]:
    if engine.kind in ("flat", "sharded", "auto"):
        # "auto" (the recall-aware router) persists exactly like flat: the raw
        # vectors are the source of truth and the routing decision is re-measured
        # on the reopened corpus
        blob, attrs = serialize_dense(engine.builder)
        attrs["engine"] = engine.kind
        return blob, attrs
    if engine.kind == "hnsw":
        arrays = engine.builder.state_arrays()
        attrs = {
            "format": HNSW_FORMAT_V2,
            "engine": "hnsw",
            "dim": str(engine.dim),
            "count": str(len(engine)),
            "ef_search": str(engine.ef_search),
        }
        return save_arrays(dict(arrays)), attrs
    if engine.kind == "ivf":
        # the raw vectors are the source of truth; buckets rebuild deterministically
        blob, attrs = serialize_dense(engine.builder)
        attrs.update(
            engine="ivf",
            nprobe=str(engine.nprobe),
            seed=str(engine.seed),
            n_clusters="" if engine.n_clusters is None else str(engine.n_clusters),
            spill=str(engine.spill),
        )
        return blob, attrs
    raise ValueError(f"unknown vector engine kind {engine.kind!r}")


def deserialize_vector_engine(blob: bytes, attrs: dict[str, str], device=None):
    """The segment's engine with its snapshots on `device` (None: the current CUDA
    device). A `sharded` segment (layout-free) loads as a flat engine."""
    from wax_tpu_torch.search.vector_engines import (AutoVectorEngine, FlatVectorEngine, HNSWVectorEngine,
                                                     IVFVectorEngine)

    kind = attrs.get("engine", "flat")
    if kind in ("flat", "sharded", "auto"):
        builder = deserialize_dense(blob, attrs)
        if kind == "auto":
            eng = AutoVectorEngine(dim=builder.dim, similarity=builder.similarity, device=device)
        else:
            eng = FlatVectorEngine(dim=builder.dim, similarity=builder.similarity, device=device)
        eng.builder = builder
        return eng
    if kind == "hnsw":
        if blob[:2] == b"PK":  # legacy npz (v1)
            data = np.load(io.BytesIO(blob))
            arrays = {k: data[k] for k in data.files}
        else:
            arrays = load_arrays(blob)
        eng = HNSWVectorEngine(dim=int(attrs["dim"]), device=device)
        eng.builder = type(eng.builder).from_state_arrays(arrays, dim=int(attrs["dim"]))
        eng.ef_search = int(attrs.get("ef_search", "64"))
        return eng
    if kind == "ivf":
        builder = deserialize_dense(blob, attrs)
        spill_raw = attrs.get("spill", "0.0")
        spill = spill_raw if spill_raw == "auto" else float(spill_raw or 0.0)
        eng = IVFVectorEngine(
            dim=builder.dim,
            n_clusters=int(attrs["n_clusters"]) if attrs.get("n_clusters") else None,
            nprobe=int(attrs.get("nprobe", "8")),
            seed=int(attrs.get("seed", "0")),
            spill=spill,
            device=device,
        )
        eng.builder = builder
        return eng
    raise ValueError(f"unknown vector engine kind {kind!r}")


def serialize_lex(builder: LexIndexBuilder) -> tuple[bytes, dict[str, str]]:
    """v2 columnar lex segment: token-id sequences + postings CSR as npz arrays.

    Replaced the v1 JSON payload (round 3): JSON + a per-doc Python rebuild loop was
    the cold-open hotspot (28 ms at 1K docs, scaling linearly); the npz arrays load
    into a FROZEN builder (LexIndexBuilder.from_frozen_arrays) whose snapshot() is
    vectorized padding, deferring dict materialization to the first mutation.
    Vocab terms are newline-joined (analyze() never emits whitespace in a term).
    """
    vocab_list, arrays = builder.frozen_or_built_arrays()
    vocab_blob = "\n".join(vocab_list).encode("utf-8")
    blob = save_arrays(
        {
            "vocab": np.frombuffer(vocab_blob, np.uint8),
            "doc_tids": arrays["doc_tids"].astype(np.int32),
            "doc_offsets": arrays["doc_offsets"].astype(np.int64),
            "frame_ids": arrays["frame_ids"].astype(np.int64),
            "active": arrays["active"].astype(bool),
            "doc_rows": arrays["doc_rows"].astype(np.int32),
            "tfs": arrays["tfs"].astype(np.int32),
            "post_offsets": arrays["post_offsets"].astype(np.int64),
        }
    )
    from wax_tpu_torch.index.lex import ANALYZER_VERSION

    attrs = {
        "format": LEX_FORMAT_V2,
        "docs": str(len(builder)),
        "terms": str(len(vocab_list)),
        # tokens in this segment were produced by this analyze() version; the
        # orchestrator rebuilds the lex index when it differs at open time
        "analyzer": ANALYZER_VERSION,
    }
    return blob, attrs


def lex_segment_current(attrs: dict[str, str] | None) -> bool:
    """False when the segment's vocab was produced by a DIFFERENT analyze()
    version (incl. pre-versioning segments): serving it would silently match
    nothing, and re-serializing it would stamp the current version onto a stale
    vocab, masking the mismatch forever. Every open path (orchestrator AND
    session) must rebuild from frames instead of deserializing such a segment."""
    from wax_tpu_torch.index.lex import ANALYZER_VERSION

    return (attrs or {}).get("analyzer", "pre-u61") == ANALYZER_VERSION


def load_lex_if_current(store, manifest) -> tuple[LexIndexBuilder | None, bool]:
    """Deserialize the committed lex segment iff its analyzer matches the
    runtime's: returns ``(builder, stale)``.

    The analyzer version is checked on the MANIFEST before the blob is read —
    a stale multi-MB segment costs zero IO at open. ``stale=True`` means a
    segment exists but was tokenized by a different ``analyze()``; the caller's
    frame catch-up loop must rebuild with the current analyzer (deserializing
    would silently match nothing, and the next commit would re-stamp the stale
    vocab with the current version string, masking the mismatch forever).
    Shared by both open paths (orchestrator + session) so the guard can't drift.
    """
    if manifest is None:
        return None, False
    if not lex_segment_current(manifest.attrs):
        import logging

        logging.getLogger("wax_tpu").warning(
            "lex segment analyzer %r != current; rebuilding the text index "
            "from frames (persisted at next commit)",
            (manifest.attrs or {}).get("analyzer", "pre-u61"),
        )
        return None, True
    blob = store.read_segment("lex")
    if blob is None:
        return None, False
    return deserialize_lex(blob, manifest.attrs), False


def deserialize_lex(blob: bytes, attrs: dict[str, str]) -> LexIndexBuilder:
    fmt = attrs.get("format")
    if fmt == LEX_FORMAT_V2:
        data = load_arrays(blob)
        vocab_bytes = bytes(data["vocab"])
        vocab_list = vocab_bytes.decode("utf-8").split("\n") if vocab_bytes else []
        return LexIndexBuilder.from_frozen_arrays(
            vocab_list,
            {
                k: data[k]
                for k in (
                    "doc_tids", "doc_offsets", "frame_ids", "active",
                    "doc_rows", "tfs", "post_offsets",
                )
            },
        )
    if fmt != LEX_FORMAT:
        raise ValueError(f"unsupported lex segment format {fmt!r}")
    payload = json.loads(blob.decode("utf-8"))
    # rebuild the v2 arrays from the stored analyses (no re-tokenization); term ids in
    # order of first occurrence, as the JAX loader assigns them
    vocab: dict[str, int] = {}
    doc_tids: list[int] = []
    doc_offsets = [0]
    post: list[tuple[int, int, int]] = []  # (tid, row, tf)
    for row, terms in enumerate(payload["doc_terms"]):
        tids = [vocab.setdefault(t, len(vocab)) for t in terms]
        doc_tids.extend(tids)
        doc_offsets.append(len(doc_tids))
        post.extend((tid, row, tf) for tid, tf in Counter(tids).items())
    post.sort()
    p = np.asarray(post, np.int64).reshape(-1, 3)
    post_offsets = np.zeros(len(vocab) + 1, np.int64)
    np.cumsum(np.bincount(p[:, 0], minlength=len(vocab)), out=post_offsets[1:])
    b = LexIndexBuilder.from_frozen_arrays(
        list(vocab),
        {
            "doc_tids": np.asarray(doc_tids, np.int32),
            "doc_offsets": np.asarray(doc_offsets, np.int64),
            "frame_ids": np.asarray(payload["frame_ids"], np.int64),
            "active": np.asarray(payload["active"], bool),
            "doc_rows": p[:, 1].astype(np.int32),
            "tfs": p[:, 2].astype(np.int32),
            "post_offsets": post_offsets,
        },
    )
    b._doc_len = [int(d) for d in payload["doc_len"]]  # as stored
    return b
