"""MemoryOrchestrator — the primary public API.

Mirrors the reference's MemoryOrchestrator actor (reference:
Sources/Wax/Orchestrator/MemoryOrchestrator.swift — open/init :136-196, remember
:229-402 (chunk -> batched embed -> doc frame + chunk frames + text index), recall
:503-544 (FastRAG build + access recording), search :553-605, session tagging
:202-214, handoff records :684-776, flush/close :851-867, runtime stats :608-674,
embedding cache wiring :172). Composition: WaxStore (crash-safe persistence) +
HybridSearchEngine (TPU index snapshots) + FastRAGContextBuilder + AccessStats +
StructuredMemory, with index state serialized into store segments at flush
(the stage -> commit protocol of WaxSession.swift:421).

PyTorch port of `wax_tpu.orchestrator.orchestrator`. The orchestrator takes a
`device` (None: the current CUDA device, which raises without one; "cpu" on request)
and passes it to its `HybridSearchEngine`; stores cross between the two packages in
both directions (`orchestrator/serialization.py`). Differences from the JAX module:

- no JAX compile cache: `OrchestratorConfig.enable_compile_cache` does nothing;
- `warmup()` builds the snapshots under the read lock and, outside it, runs one query
  down the vector and BM25 lanes, so the first user query pays neither the kernels'
  nvcc build nor their first launch;
- every vector engine serves (`vector_engine` "auto", "flat", "hnsw" or "ivf"), and
  `warmup()` runs one search on the engine's snapshot through its `trace`;
- `sharded_lanes=True` serves on the one-device mesh with the flat or IVF engine; with
  `vector_engine="auto"` (the mesh-sharded flat engine), `mesh_slices > 1` or
  `mesh_tp > 1` it raises NotImplementedError (ROADMAP queue 1, item 5);
- a parked vector engine is reclaimed only onto its own device, and it keeps its
  device snapshot (device memory) after `close()` until the engine cache drops it
  (`search/engine_cache.clear()`);
- maintenance (`maintainer`: surrogates, compaction, the live-set rewrite) raises
  NotImplementedError (ROADMAP queue 1, item 4); `flush` reaches it only when
  `rewrite_schedule.enabled`, which is off by default. So does `remember_file` on a
  PDF (its text extraction, `text/pdf.py`, is item 4's too);
- `remember_batch` records spans of its steps (`remember.chunk_store`,
  `remember.lex_add`, `remember.embed`, `remember.store_embeddings`,
  `remember.vector_add`).
"""
from __future__ import annotations

import functools
import threading
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from wax_tpu_torch.embed.hash_embedder import HashEmbedder
from wax_tpu_torch.embed.memoizer import EmbeddingMemoizer
from wax_tpu_torch.embed.provider import validate_on_device
from wax_tpu_torch.ops.bm25 import pad_term_ids
from wax_tpu_torch.orchestrator.config import OrchestratorConfig
from wax_tpu_torch.orchestrator.serialization import (
    deserialize_lex,
    deserialize_vector_engine,
    serialize_lex,
    serialize_vector_engine,
)
from wax_tpu_torch.orchestrator.stats import ACCESS_STATS_KIND, AccessStats
from wax_tpu_torch.rag.builder import FastRAGContextBuilder
from wax_tpu_torch.rag.context import RAGContext
from wax_tpu_torch.search import engine_cache
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.unified import _bm25_run, unified_search
from wax_tpu_torch.search.vector_engines import make_vector_engine
from wax_tpu_torch.structured.memory import FactValue, StructuredMemory
from wax_tpu_torch.storage.store import StoreError, WaxStore
from wax_tpu_torch.text.chunker import chunk_text
from wax_tpu_torch.text.token_counter import TokenCounter
from wax_tpu_torch.utils.concurrency import RWLock
from wax_tpu_torch.utils.device import resolve_device
from wax_tpu_torch.utils.profiling import span, span_stats
from wax_tpu_torch.types import (
    FrameKind,
    FrameMeta,
    FrameStatus,
    SearchRequest,
    SearchResponse,
    TimeRange,
    now_ms,
)

__all__ = ["MemoryOrchestrator", "RememberResult"]

HANDOFF_KIND = "wax.handoff"
_INTERNAL_PREFIX = "wax.internal."


def _synchronized(method):
    """WRITE-phase entry point — exclusive against all readers and writers.

    The host-side analogue of the reference's actor isolation plus its
    AsyncReadWriteLock read/write phases (SURVEY.md §5 race detection;
    ReadWriteLock.swift:79-156): mutations are exclusive, while `_synchronized_read`
    entry points (search/recall/stats) run CONCURRENTLY with each other. Mutable
    substructures touched on the read path (access stats, embedding memoizer,
    token-counter LRU, engine snapshot caches) carry their own internal locks."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock.write():
            return method(self, *args, **kwargs)

    return wrapper


def _synchronized_read(method):
    """READ-phase entry point — concurrent with other readers, excluded by writers
    (writer-preferring, so a stream of searches cannot starve a flush)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock.read():
            return method(self, *args, **kwargs)

    return wrapper


@dataclass(frozen=True)
class RememberResult:
    document_id: int
    chunk_ids: tuple[int, ...]

    @property
    def frame_ids(self) -> tuple[int, ...]:
        return (self.document_id, *self.chunk_ids)


class StoreFrameView:
    """FrameCatalog-compatible read view over a WaxStore (search/RAG read path).
    Internal frames (kind wax.internal.*) are hidden from timeline scans."""

    def __init__(self, store: WaxStore):
        self.store = store

    def get(self, frame_id: int) -> FrameMeta | None:
        return self.store.frame_meta(frame_id)

    def content(self, frame_id: int) -> str | None:
        raw = self.store.frame_content(frame_id)
        return None if raw is None else raw.decode("utf-8", errors="ignore")

    def preview(self, frame_id: int, max_bytes: int = 4096) -> str:
        raw = self.store.frame_content(frame_id) or b""
        return raw[:max_bytes].decode("utf-8", errors="ignore")

    def is_live(self, frame_id: int) -> bool:
        m = self.get(frame_id)
        return (
            m is not None
            and m.status == FrameStatus.ACTIVE.value
            and m.superseded_by is None
        )

    def timeline(self, time_range=None, *, limit=None, newest_first=True, **kw):
        metas = self.store.timeline(time_range, limit=None, newest_first=newest_first)
        metas = [m for m in metas if not m.kind.startswith(_INTERNAL_PREFIX)]
        return metas[:limit] if limit is not None else metas


class MemoryOrchestrator:
    def __init__(
        self,
        path: str | Path,
        embedder=None,
        config: OrchestratorConfig = OrchestratorConfig(),
        readonly: bool = False,
        device=None,
    ):
        """`readonly=True` opens with a shared lease: searches/recall work, any
        mutation raises (reference: WaxSession read-only mode, WaxSession.swift:50-74).
        `device` holds the index snapshots (None: the current CUDA device; "cpu" on
        request)."""
        self.config = config
        self.path = Path(path)
        self.readonly = readonly
        self.device = resolve_device(device)
        if config.sharded_lanes and (
            config.vector_engine == "auto" or config.mesh_slices > 1 or config.mesh_tp > 1
        ):
            raise NotImplementedError(
                "sharded_lanes with vector_engine='auto' (the mesh-sharded flat engine), "
                "mesh_slices > 1 or mesh_tp > 1 need multi-GPU serving, which is not ported "
                "yet (ROADMAP queue 1, item 5: multi-GPU); use vector_engine='flat' or 'ivf' "
                "on the one-device mesh"
            )
        self._lock = RWLock()
        self._closed = False
        self._now = config.clock_ms if config.clock_ms is not None else now_ms
        embedder = embedder if embedder is not None else HashEmbedder()
        validate_on_device(embedder, config.require_on_device_providers)
        self.memoizer = EmbeddingMemoizer(embedder, config.embedding_cache_capacity)
        # constructing the counter here prewarms the BPE vocab during open, the
        # analogue of the reference's tokenizer preload overlap (:141-154)
        self.counter = TokenCounter()

        if self.path.exists() and self.path.stat().st_size > 0:
            with span("open.store_recover"):
                self.store = WaxStore.open(self.path, config.store, readonly=readonly)
        elif readonly:
            raise StoreError(f"{self.path} does not exist (read-only open)")
        else:
            self.store = WaxStore.create(self.path, config.store)

        try:
            self._init_after_store_open(config, embedder)
        except BaseException:
            # release the writer lease: a failed open (e.g. the embedder-mismatch
            # guard) must not leave the path locked against a corrected retry
            self.store.close()
            raise

    def _init_after_store_open(self, config: OrchestratorConfig, embedder) -> None:
        self.structured = (
            StructuredMemory(now=self._now) if config.enable_structured_memory else None
        )
        mesh = None
        if config.sharded_lanes:
            # the sharded BM25 lane on the one-device mesh (multi-GPU is item 5)
            from wax_tpu_torch.parallel.mesh import data_mesh

            mesh = data_mesh(self.device)
        self.engine = HybridSearchEngine(
            embedder=self.memoizer,
            dim=embedder.dimensions,
            frames=StoreFrameView(self.store),
            structured_evidence=(
                (lambda q, as_of: self.structured.evidence_frame_ids(q, as_of))
                if self.structured is not None
                else None
            ),
            vector_preference=config.vector_engine,
            device=self.device,
            lex_sharded=config.sharded_lanes,
            mesh=mesh,
            lex_postings_budget=config.lex_postings_budget,
        )
        self.access_stats = AccessStats()
        self._access_stats_frame: int | None = None
        self.session_id: str | None = None
        self._flush_count = 0
        self._load_committed_state()
        self._warmup_thread: threading.Thread | None = None
        self.rag_builder = FastRAGContextBuilder(
            self.engine, config.rag, self.counter, self.access_stats
        )

    @property
    def maintainer(self):
        """Maintenance facade (surrogates, compaction, live-set rewrite): not ported."""
        raise NotImplementedError(
            "orchestrator maintenance (surrogates, compaction, the live-set rewrite) is not "
            "ported yet (ROADMAP queue 1, item 4: orchestrator/maintenance.py)"
        )

    # ------------------------------------------------------------------- open/load ----
    def _load_committed_state(self) -> None:
        """Rebuild index builders from committed segments + WAL catch-up
        (the analogue of UnifiedSearchEngineCache incremental catch-up :252)."""
        lex_man = self.store.toc.manifests.get("lex")
        vec_man = self.store.toc.manifests.get("vec")
        self._cache_key = (lex_man.sha if lex_man else None, vec_man.sha if vec_man else None)
        reclaimed = engine_cache.reclaim(self.path, *self._cache_key)
        got_lex = got_vec = False
        if reclaimed is not None:
            lex_builder, vector_engine = reclaimed
            if self.config.enable_text_search and lex_builder is not None:
                self.engine.lex = lex_builder
                got_lex = True
            if (
                self.config.enable_vector_search
                and vector_engine is not None
                and vector_engine.kind == self.engine.vector.kind
                # a reclaimed sharded engine carries its mesh; reopening under a
                # different topology config must not serve the old layout
                and getattr(vector_engine, "mesh", None) == getattr(self.engine.vector, "mesh", None)
                # nor may an engine parked by an orchestrator on another device serve
                # this one (a CPU open of a store a card orchestrator closed)
                and getattr(vector_engine, "device", None) == self.engine.device
            ):
                self.engine.vector = vector_engine
                got_vec = True
        lex_rebuilt = False
        if not got_lex and self.config.enable_text_search:
            from wax_tpu_torch.orchestrator.serialization import load_lex_if_current

            with span("open.lex_decode"):
                lex_builder, lex_rebuilt = load_lex_if_current(self.store, lex_man)
            if lex_builder is not None:
                self.engine.lex = lex_builder
        # the budget is runtime config, not persisted state — re-apply after load
        self.engine.lex.postings_budget = self.config.lex_postings_budget
        if not got_vec:
            vec_blob = self.store.read_segment("vec")
            if vec_blob is not None and self.config.enable_vector_search:
                with span("open.vec_decode"):
                    self.engine.vector = deserialize_vector_engine(
                        vec_blob, vec_man.attrs, device=self.engine.device
                    )
        # catch-up: replay pending embeddings recovered from the WAL / overflow segment
        if self.structured is not None:
            sm_blob = self.store.read_segment("structured")
            if sm_blob is not None:
                self.structured = StructuredMemory.deserialize(sm_blob, now=self._now)
                self.engine.structured_evidence = (
                    lambda q, as_of: self.structured.evidence_frame_ids(q, as_of)
                )
        pend = self.store.pending_embeddings()
        if pend and self.config.enable_vector_search:
            fids = np.asarray([fid for fid, _ in pend])
            vecs = np.stack([v for _, v in pend])
            self.engine.vector.add_batch(fids, vecs)
        # catch-up: lex-index any live frame not yet in the lex builder
        if self.config.enable_text_search:
            # Coverage fast path: the staged lex segment records how many frames
            # existed when it was serialized ("scanned_frames") — every frame below
            # that id was already considered for lex indexing at stage time, so the
            # catch-up scan starts there (on a clean open it scans nothing, keeping
            # cold open O(1) in frame count). Segments without the attr (v1 / other
            # writers) scan from 0 as before.
            start_fid = 0
            if lex_man is not None and not lex_rebuilt and not self.store.pending_embeddings():
                try:
                    start_fid = min(
                        int(lex_man.attrs.get("scanned_frames", 0)), self.store.frame_count()
                    )
                except ValueError:
                    start_fid = 0
            for fid in range(start_fid, self.store.frame_count()):
                m = self.store.frame_meta(fid)
                if (
                    m is None
                    or m.status == FrameStatus.DELETED.value
                    or m.kind.startswith(_INTERNAL_PREFIX)
                    or m.frame_id in self.engine.lex
                ):
                    continue
                text = m.search_text
                if text is None and m.kind in (FrameKind.CHUNK.value, FrameKind.DOCUMENT.value):
                    raw = self.store.frame_content(m.frame_id)
                    text = raw.decode("utf-8", errors="ignore") if raw else None
                if text:
                    self.engine.lex.add(m.frame_id, text)
        # access stats from the hidden internal frame
        if self.config.enable_access_stats:
            # kind-column lookup (no per-frame meta materialization): newest
            # non-superseded stats frame wins
            for fid in reversed(self.store.frame_ids_of_kind(ACCESS_STATS_KIND)):
                m = self.store.frame_meta(fid)
                if m and m.superseded_by is None:
                    raw = self.store.frame_content(fid)
                    if raw:
                        self.access_stats = AccessStats.from_json(raw.decode("utf-8"))
                    self._access_stats_frame = fid
                    break
        # embedder identity guard: the vec segment records which provider built it
        # (serialization.serialize_vector_engine); a different provider at open time
        # means stored vectors and fresh query embeddings live in different spaces
        if self.config.enable_vector_search and vec_man is not None:
            stored_ident = (vec_man.attrs or {}).get("embedder")
            cur_ident = self.memoizer.provider.identity
            if stored_ident and stored_ident != cur_ident:
                mode = self.config.embedder_mismatch
                if mode == "reindex":
                    self._reembed_all()
                elif mode != "ignore":
                    raise StoreError(
                        f"vector index was built by embedder {stored_ident!r} but the "
                        f"orchestrator was opened with {cur_ident!r}; pass the original "
                        "provider, or set OrchestratorConfig(embedder_mismatch="
                        "'reindex') to rebuild (or 'ignore' to keep the stale index)"
                    )

    def _reembed_all(self) -> None:
        """Drop the vector index and re-embed every live frame that has search text
        with the current provider (embedder_mismatch='reindex')."""
        old = self.engine.vector
        self.engine.vector = make_vector_engine(old.kind, dim=old.dim, device=self.engine.device)
        fids: list[int] = []
        texts: list[str] = []
        for m in self.store.timeline(include_superseded=False):
            if m.kind.startswith(_INTERNAL_PREFIX):
                continue
            text = m.search_text
            if (
                text is None
                and m.chunk_count is None  # multi-chunk parents are not embedded
                and m.kind in (FrameKind.CHUNK.value, FrameKind.DOCUMENT.value)
            ):
                raw = self.store.frame_content(m.frame_id)
                text = raw.decode("utf-8", errors="ignore") if raw else None
            if text:
                fids.append(m.frame_id)
                texts.append(text)
        bs = self.config.embed_batch_size
        for i in range(0, len(fids), bs):
            vecs = self.memoizer.embed_batch(texts[i : i + bs])
            self.engine.index_embedding_batch(fids[i : i + bs], vecs)

    def _check_writable(self) -> None:
        if self.readonly:
            raise StoreError("orchestrator opened read-only")

    # -------------------------------------------------------------------- remember ----
    @_synchronized
    def remember(
        self,
        content: str,
        metadata: Mapping[str, str] | None = None,
        tags: Sequence[str] = (),
        timestamp_ms: int | None = None,
        kind: str = FrameKind.DOCUMENT.value,
    ) -> RememberResult:
        """Ingest one document: chunk -> batched embeddings -> frames + indexes
        (reference: MemoryOrchestrator.remember :229-402)."""
        ts = timestamp_ms if timestamp_ms is not None else self._now()
        tags = tuple(tags)
        if self.session_id:
            tags = tags + (f"session:{self.session_id}",)
        metadata = dict(metadata or {})

        chunks = chunk_text(content, self.config.chunking, self.counter)
        doc_id = self.store.put(
            content,
            kind=kind,
            timestamp_ms=ts,
            metadata=metadata,
            tags=tags,
            search_text=content if len(chunks) <= 1 else None,
            chunk_count=len(chunks) if len(chunks) > 1 else None,
        )
        chunk_ids: list[int] = []
        if len(chunks) <= 1:
            texts = [content]
            embed_targets = [doc_id]
            if self.config.enable_text_search:
                self.engine.index_text(doc_id, content)
        else:
            items = [
                (
                    c.text,
                    dict(
                        kind=FrameKind.CHUNK.value,
                        timestamp_ms=ts,
                        parent_id=doc_id,
                        chunk_index=c.index,
                        chunk_count=len(chunks),
                        tags=tags,
                        search_text=c.text,
                    ),
                )
                for c in chunks
            ]
            chunk_ids = self.store.put_batch(items)
            texts = [c.text for c in chunks]
            embed_targets = chunk_ids
            if self.config.enable_text_search:
                for fid, c in zip(chunk_ids, chunks):
                    self.engine.index_text(fid, c.text)

        if self.config.enable_vector_search:
            bs = self.config.embed_batch_size
            for i in range(0, len(texts), bs):
                batch = texts[i : i + bs]
                targets = embed_targets[i : i + bs]
                vecs = self.memoizer.embed_batch(batch)
                self.store.put_embedding_batch(list(targets), vecs)
                self.engine.index_embedding_batch(targets, vecs)

        return RememberResult(document_id=doc_id, chunk_ids=tuple(chunk_ids))

    @_synchronized
    def remember_batch(
        self,
        contents: Sequence[str],
        metadatas: Sequence[Mapping[str, str]] | None = None,
        timestamp_ms: int | None = None,
    ) -> list[RememberResult]:
        """Bulk ingest: one embedding forward per batch across documents and one WAL
        batch per store write (reference: the batched-ingest path exercised by
        RAGBenchmarks' batched profiles)."""
        self._check_writable()
        ts = timestamp_ms if timestamp_ms is not None else self._now()
        metadatas = metadatas or [{}] * len(contents)
        tags = (f"session:{self.session_id}",) if self.session_id else ()

        # plan all frames first (frame ids are assigned densely, so document and
        # chunk ids are known up front), then issue ONE store batch — a single
        # WAL append covers the whole ingest
        with span("remember.chunk_store"):
            next_id = self.store.next_frame_id
            items: list[tuple[str, dict]] = []
            plan: list[tuple[int, tuple[int, ...]]] = []  # (doc_id, chunk_ids)
            texts: list[str] = []
            targets: list[int] = []
            for content, metadata in zip(contents, metadatas):
                chunks = chunk_text(content, self.config.chunking, self.counter)
                doc_id = next_id
                items.append(
                    (
                        content,
                        dict(
                            kind=FrameKind.DOCUMENT.value,
                            timestamp_ms=ts,
                            metadata=dict(metadata),
                            tags=tags,
                            search_text=content if len(chunks) <= 1 else None,
                            chunk_count=len(chunks) if len(chunks) > 1 else None,
                        ),
                    )
                )
                next_id += 1
                chunk_ids: list[int] = []
                if len(chunks) <= 1:
                    texts.append(content)
                    targets.append(doc_id)
                else:
                    for c in chunks:
                        items.append(
                            (
                                c.text,
                                dict(
                                    kind=FrameKind.CHUNK.value,
                                    timestamp_ms=ts,
                                    parent_id=doc_id,
                                    chunk_index=c.index,
                                    chunk_count=len(chunks),
                                    tags=tags,
                                    search_text=c.text,
                                ),
                            )
                        )
                        chunk_ids.append(next_id)
                        next_id += 1
                        texts.append(c.text)
                    targets.extend(chunk_ids)
                plan.append((doc_id, tuple(chunk_ids)))

            # store sub-batches of bounded size: one WAL append must always fit the
            # ring (an append larger than the whole ring cannot be journaled)
            assigned: list[int] = []
            for i in range(0, len(items), 1024):
                assigned.extend(self.store.put_batch(items[i : i + 1024]))
        assert assigned[0] == plan[0][0] if plan else True
        if self.config.enable_text_search:
            with span("remember.lex_add"):
                for fid, text in zip(targets, texts):
                    self.engine.index_text(fid, text)
        if self.config.enable_vector_search and texts:
            bs = self.config.embed_batch_size
            for i in range(0, len(texts), bs):
                with span("remember.embed"):
                    vecs = self.memoizer.embed_batch(texts[i : i + bs])
                batch_targets = targets[i : i + bs]
                with span("remember.store_embeddings"):
                    self.store.put_embedding_batch(list(batch_targets), vecs)
                with span("remember.vector_add"):
                    self.engine.index_embedding_batch(batch_targets, vecs)
        return [RememberResult(d, c) for d, c in plan]

    @_synchronized
    def remember_file(self, path: str | Path, **kwargs) -> RememberResult:
        """Ingest a file read as UTF-8 text (reference: MemoryOrchestrator+File.swift:5-36).
        PDFs raise NotImplementedError: their text extraction (`text/pdf.py`) is not
        ported yet."""
        p = Path(path)
        raw = p.read_bytes()
        if raw.startswith(b"%PDF"):
            raise NotImplementedError(
                "PDF text extraction is not ported yet (ROADMAP queue 1, item 4: text/pdf.py)"
            )
        content = raw.decode("utf-8", errors="ignore")
        kwargs.setdefault("metadata", {})
        kwargs["metadata"] = {**dict(kwargs["metadata"]), "source_file": p.name}
        return self.remember(content, **kwargs)

    @_synchronized
    def forget(self, frame_id: int) -> bool:
        """Delete a frame (and its chunks) from store + indexes."""
        m = self.store.frame_meta(frame_id)
        if m is None:
            return False
        doomed = [frame_id]
        for fid in range(self.store.frame_count()):
            child = self.store.frame_meta(fid)
            if child is not None and child.parent_id == frame_id:
                doomed.append(fid)
        for fid in doomed:
            self.store.delete(fid)
            self.engine.remove(fid)
        return True

    # ----------------------------------------------------------------------- recall ----
    @_synchronized_read
    def recall(self, query: str, top_k: int | None = None) -> RAGContext:
        with span("orchestrator.recall"):
            ctx = self.rag_builder.build(query, top_k)
        if self.config.enable_access_stats and ctx.items:
            self.access_stats.record_batch([i.frame_id for i in ctx.items], self._now())
        return ctx

    @_synchronized_read
    def search(self, request: SearchRequest | str, top_k: int = 10) -> SearchResponse:
        if isinstance(request, str):
            request = SearchRequest(query=request, top_k=top_k)
        with span("orchestrator.search"):
            resp = unified_search(self.engine, request)
        if self.config.enable_access_stats and resp.hits:
            self.access_stats.record_batch([h.frame_id for h in resp.hits], self._now())
        return resp

    @_synchronized_read
    def timeline(self, time_range: TimeRange | None = None, limit: int | None = None):
        return self.engine.frames.timeline(time_range, limit=limit)

    # -------------------------------------------------------------------- sessions ----
    def session_start(self, name: str | None = None) -> str:
        self.session_id = name or uuid.uuid4().hex[:12]
        return self.session_id

    def session_end(self) -> None:
        self.session_id = None

    @_synchronized
    def handoff(
        self,
        content: str,
        metadata: Mapping[str, str] | None = None,
        session_id: str | None = None,
        project: str | None = None,
        pending_tasks: Sequence[str] = (),
    ) -> int:
        """Persist a handoff record (reference: MemoryOrchestrator.swift:684-776;
        scoping fields per ToolSchemas.swift waxHandoff — explicit session_id,
        optional project scope, optional pending-task list)."""
        meta = dict(metadata or {})
        sid = session_id or self.session_id
        if sid:
            meta.setdefault("session_id", sid)
        if project:
            meta.setdefault("project", project)
        if pending_tasks:
            import json as _json

            meta.setdefault("pending_tasks", _json.dumps(list(pending_tasks)))
        return self.store.put(
            content,
            kind=HANDOFF_KIND,
            timestamp_ms=self._now(),
            metadata=meta,
            tags=(f"session:{sid}",) if sid else (),
        )

    @_synchronized_read
    def handoff_latest(
        self, session_id: str | None = None, project: str | None = None
    ) -> tuple[FrameMeta, str] | None:
        """Newest active handoff, optionally scoped by session and/or project
        (reference: waxHandoffLatest project scope)."""
        for fid in reversed(self.store.frame_ids_of_kind(HANDOFF_KIND)):
            m = self.store.frame_meta(fid)
            if m is None or m.status != FrameStatus.ACTIVE.value:
                continue
            if session_id is not None and m.metadata.get("session_id") != session_id:
                continue
            if project is not None and m.metadata.get("project") != project:
                continue
            raw = self.store.frame_content(fid) or b""
            return m, raw.decode("utf-8", errors="ignore")
        return None

    # -------------------------------------------------------- structured passthrough ----
    # (reference: MemoryOrchestrator.swift:778-847)
    @_synchronized
    def entity_upsert(self, name: str, kind: str | None = None, aliases=()) -> int:
        self._require_structured()
        return self.structured.entity_upsert(name, kind, aliases)

    @_synchronized_read
    def entity_resolve(self, name_or_alias: str) -> int | None:
        self._require_structured()
        return self.structured.entity_resolve(name_or_alias)

    @_synchronized
    def fact_assert(
        self, subject, predicate: str, value: FactValue, valid_from_ms=None, evidence_frames=()
    ) -> int:
        self._require_structured()
        return self.structured.fact_assert(
            subject, predicate, value, valid_from_ms, evidence_frames
        )

    @_synchronized
    def fact_retract(self, fact_id: int, valid_to_ms: int | None = None) -> bool:
        self._require_structured()
        return self.structured.fact_retract(fact_id, valid_to_ms)

    @_synchronized_read
    def facts_query(self, subject=None, predicate=None, as_of_ms=None):
        self._require_structured()
        return self.structured.facts_query(subject, predicate, as_of_ms)

    def _require_structured(self) -> None:
        if self.structured is None:
            raise RuntimeError("structured memory disabled in OrchestratorConfig")

    # ----------------------------------------------------------------------- flush ----
    @_synchronized
    def flush(self) -> int:
        """Stage index segments + access stats, then commit
        (reference: flush -> session.commit -> stage + wax.commit)."""
        if self.config.enable_access_stats and len(self.access_stats):
            payload = self.access_stats.export_json()
            if self._access_stats_frame is not None:
                self._access_stats_frame = self.store.supersede(
                    self._access_stats_frame, payload, kind=ACCESS_STATS_KIND
                )
            else:
                self._access_stats_frame = self.store.put(payload, kind=ACCESS_STATS_KIND)
        if self.config.enable_text_search:
            blob, attrs = serialize_lex(self.engine.lex)
            # every frame below this count has been considered for lex indexing —
            # lets the next open start its catch-up scan here (cold-open fast path)
            attrs["scanned_frames"] = str(self.store.frame_count())
            self.store.stage_index("lex", blob, attrs)
        if self.config.enable_vector_search:
            blob, attrs = serialize_vector_engine(
                self.engine.vector, embedder_identity=self.memoizer.provider.identity
            )
            self.store.stage_index("vec", blob, attrs)
        if self.structured is not None:
            self.store.stage_index("structured", self.structured.serialize(), self.structured.stats_attrs())
        gen = self.store.commit()
        self._flush_count += 1
        if self.config.rewrite_schedule.enabled:
            self.maintainer.note_flush()
            self.maintainer.maybe_scheduled_rewrite()
        return gen

    def warmup(self, background: bool = True) -> None:
        """Run one query down the vector and BM25 lanes so the first real query skips
        the kernels' build (nvcc) and first launch. Long-lived surfaces call this right
        after open: the build overlaps the idle gap before the first request instead of
        landing on it."""

        def _trace() -> None:
            try:
                # hold the reader side only to BUILD snapshots (builds iterate the
                # live builders; unlocked they could race a writer and cache a torn
                # snapshot under the new generation). The lanes run on the immutable
                # snapshots OUTSIDE the lock: a kernel build must never block writers.
                vec = vec_snap = lex_snap = None
                with self._lock.read():
                    if self._closed:
                        return
                    if self.config.enable_vector_search and len(self.engine.vector) > 0:
                        vec = self.engine.vector
                        vec_snap = vec.snapshot()
                    if self.config.enable_text_search and self.engine.lex.max_term_df():
                        lex_snap = (
                            self.engine.lex_sharded_snapshot()
                            if self.engine.lex_sharded
                            else self.engine.lex_snapshot()
                        )
                if vec_snap is not None:
                    vec.trace(vec_snap)
                if lex_snap is not None:
                    import torch

                    padded = torch.from_numpy(pad_term_ids([0])[None, :]).to(self.engine.device)
                    _bm25_run(self.engine, padded, 24, "any", snap=lex_snap)
            except Exception:  # noqa: BLE001 — warmup must never break an open
                pass

        if background:
            self._warmup_thread = threading.Thread(target=_trace, daemon=True, name="wax-warmup")
            self._warmup_thread.start()
        else:
            _trace()

    def wait_for_warmup(self, timeout: float | None = None) -> bool:
        """Block until a background warmup() finishes (True) or the timeout lapses
        (False; the next query then pays its own trace — never an error). Lets a
        serving surface gate its FIRST request on readiness instead of racing the
        warmup thread for the compile."""
        t = self._warmup_thread
        if t is None:
            return True
        t.join(timeout=timeout)
        return not t.is_alive()

    def close(self) -> None:
        self._closed = True  # a queued warmup thread exits before touching state
        warmup_alive = False
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout=30.0)
            warmup_alive = self._warmup_thread.is_alive()
            self._warmup_thread = None
        # park the live builders for a possible warm re-open (engine_cache docstring
        # explains why park/reclaim — not sharing — is the safe ownership model here).
        # A warmup thread that outlived the join (e.g. a multi-minute remote compile)
        # may still be reading the builders — don't hand them to the cache where a
        # fresh open could reclaim and mutate them concurrently.
        try:
            if not warmup_alive:
                lex_man = self.store.toc.manifests.get("lex")
                vec_man = self.store.toc.manifests.get("vec")
                engine_cache.park(
                    self.path,
                    lex_man.sha if lex_man else None,
                    vec_man.sha if vec_man else None,
                    self.engine.lex if self.config.enable_text_search else None,
                    self.engine.vector if self.config.enable_vector_search else None,
                )
        except Exception:  # noqa: BLE001 — caching must never block a close
            pass
        self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------------------- stats ----
    @_synchronized_read
    def runtime_stats(self) -> dict:
        """Operator-facing counters (reference: runtimeStats :608-674)."""
        return {
            "store": self.store.stats(),
            "wal": self.store.wal_stats(),
            "engine": dict(self.engine.stats),
            "embedding_cache": dict(self.memoizer.stats),
            "token_cache": dict(self.counter.stats),
            "access_stats_entries": len(self.access_stats),
            "lex_docs": len(self.engine.lex),
            "vector_count": len(self.engine.vector),
            "vector_engine": self.engine.vector.kind,
            # recall-aware auto router decision (AutoVectorEngine.stats):
            # {engine, measured_recall, reason[, nprobe]}
            **(
                {"vector_routing": self.engine.vector.stats()}
                if hasattr(self.engine.vector, "stats")
                else {}
            ),
            "flush_count": self._flush_count,
            "spans": span_stats(),
        }
