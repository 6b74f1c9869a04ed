# Copy of wax_tpu/session.py with one change: `WaxSession` and `open_session` take
# `device` (None: the current CUDA device, raising without one; "cpu" on request),
# which holds the engine's snapshots; `open_session` resolves it before it opens the
# store. Keep the two in step.
"""WaxSession: the mid-level write-session API over a store.

Mirrors the reference's WaxSession actor (reference: Sources/Wax/WaxSession.swift:6-529
— owns live FTS5 + vector engine instances over a `Wax` store, merges put + embed +
index operations, stage()/commit() orchestration, writer-lease acquisition, read-only
mode, and `Wax.openSession` ext :522). Sits between the raw WaxStore and the
MemoryOrchestrator: no chunking, RAG, or structured memory — callers control exactly
what gets indexed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from wax_tpu_torch.orchestrator.serialization import (
    deserialize_vector_engine,
    load_lex_if_current,
    serialize_lex,
    serialize_vector_engine,
)
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.unified import unified_search
from wax_tpu_torch.storage.store import StoreError, StoreOptions, WaxStore
from wax_tpu_torch.types import SearchRequest, SearchResponse
from wax_tpu_torch.utils.device import resolve_device

__all__ = ["WaxSession", "open_session"]


class WaxSession:
    """Write session: puts + embeddings + text indexing + hybrid search + commit."""

    def __init__(self, store: WaxStore, dim: int, vector_preference: str = "auto", device=None):
        from wax_tpu_torch.orchestrator.orchestrator import StoreFrameView

        self.store = store
        self.engine = HybridSearchEngine(
            embedder=None,
            dim=dim,
            frames=StoreFrameView(store),
            vector_preference=vector_preference,
            device=device,
        )
        self._load_committed()

    def _load_committed(self) -> None:
        # stale-analyzer segments return None (warned): the catch-up loop below
        # re-tokenizes every frame with the CURRENT analyzer
        lex_builder, _ = load_lex_if_current(self.store, self.store.toc.manifests.get("lex"))
        if lex_builder is not None:
            self.engine.lex = lex_builder
        vec_blob = self.store.read_segment("vec")
        if vec_blob is not None:
            self.engine.vector = deserialize_vector_engine(
                vec_blob, self.store.toc.manifests["vec"].attrs, device=self.engine.device
            )
        pend = self.store.pending_embeddings()
        if pend:
            self.engine.vector.add_batch(
                np.asarray([fid for fid, _ in pend]), np.stack([v for _, v in pend])
            )
        # Lex catch-up: WAL-recovered pending frames are not in the committed lex
        # segment; without re-indexing their search_text here, the next commit()
        # would persist a lex segment durably missing them (invisible to BM25).
        for m in self.store.timeline(include_superseded=True):
            if m.search_text and m.frame_id not in self.engine.lex:
                self.engine.lex.add(m.frame_id, m.search_text)

    @property
    def readonly(self) -> bool:
        return self.store.readonly

    # ---------------------------------------------------------------------- writes ----
    def put(
        self,
        content: str | bytes,
        embedding: np.ndarray | None = None,
        index_text: bool = True,
        **meta_kwargs,
    ) -> int:
        """Store one frame; optionally index its text and embedding."""
        text = content if isinstance(content, str) else content.decode("utf-8", "ignore")
        if index_text and "search_text" not in meta_kwargs:
            meta_kwargs["search_text"] = text
        fid = self.store.put(content, **meta_kwargs)
        if index_text:
            self.engine.index_text(fid, text)
        if embedding is not None:
            self.store.put_embedding(fid, np.asarray(embedding, np.float32))
            self.engine.index_embedding(fid, np.asarray(embedding, np.float32))
        return fid

    def put_batch(
        self,
        contents: Sequence[str],
        embeddings: np.ndarray | None = None,
        metadatas: Sequence[Mapping[str, str]] | None = None,
    ) -> list[int]:
        metadatas = metadatas or [{}] * len(contents)
        items = [
            (c, dict(metadata=dict(m), search_text=c)) for c, m in zip(contents, metadatas)
        ]
        fids = self.store.put_batch(items)
        for fid, c in zip(fids, contents):
            self.engine.index_text(fid, c)
        if embeddings is not None:
            embeddings = np.asarray(embeddings, np.float32)
            self.store.put_embedding_batch(fids, embeddings)
            self.engine.index_embedding_batch(fids, embeddings)
        return fids

    def delete(self, frame_id: int) -> bool:
        ok = self.store.delete(frame_id)
        if ok:
            self.engine.remove(frame_id)
        return ok

    # ---------------------------------------------------------------------- search ----
    def search(self, request: SearchRequest | str, top_k: int = 10) -> SearchResponse:
        if isinstance(request, str):
            request = SearchRequest(query=request, top_k=top_k)
        return unified_search(self.engine, request)

    # -------------------------------------------------------------------- stage/commit ----
    def stage(self) -> None:
        """Serialize both engines into staged store segments
        (reference: WaxSession stage() -> stageLex/VecIndexForNextCommit)."""
        blob, attrs = serialize_lex(self.engine.lex)
        self.store.stage_index("lex", blob, attrs)
        blob, attrs = serialize_vector_engine(self.engine.vector)
        self.store.stage_index("vec", blob, attrs)

    def commit(self) -> int:
        """stage + atomic store commit (reference: WaxSession.commit :421)."""
        self.stage()
        return self.store.commit()

    def close(self) -> None:
        self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_session(
    path: str | Path,
    dim: int,
    options: StoreOptions = StoreOptions(),
    readonly: bool = False,
    vector_preference: str = "auto",
    device=None,
) -> WaxSession:
    """Open (or create) a store and wrap it in a session
    (reference: Wax.openSession, WaxSession.swift:522)."""
    device = resolve_device(device)
    path = Path(path)
    if path.exists() and path.stat().st_size > 0:
        store = WaxStore.open(path, options, readonly=readonly)
    elif readonly:
        raise StoreError(f"{path} does not exist (read-only open)")
    else:
        store = WaxStore.create(path, options)
    return WaxSession(store, dim=dim, vector_preference=vector_preference, device=device)
