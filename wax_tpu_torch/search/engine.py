"""Hybrid search engine: an embedder, a flat vector engine and a lexical builder.

PyTorch port of `wax_tpu.search.engine.HybridSearchEngine`, narrowed to what the
hybrid query path needs: host-side builders, device snapshots cached per builder
generation, and query embedding. The frame catalog, structured evidence and the
sharded lexical lane belong to the orchestrator slice.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from wax_tpu_torch.embed.provider import BatchEmbeddingProvider, EmbeddingProvider
from wax_tpu_torch.index.dense import Similarity
from wax_tpu_torch.index.lex import LexIndex, LexIndexBuilder
from wax_tpu_torch.search.vector_engines import FlatVectorEngine

__all__ = ["HybridSearchEngine"]


class HybridSearchEngine:
    """Owns the lexical builder and a flat vector engine whose snapshots live on
    `device`."""

    def __init__(
        self,
        embedder: EmbeddingProvider | BatchEmbeddingProvider | None,
        dim: int | None = None,
        similarity: str = Similarity.COSINE,
        device: str | torch.device = "cpu",
    ):
        if dim is None:
            if embedder is None:
                raise ValueError("either embedder or dim is required")
            dim = embedder.dimensions
        self.embedder = embedder
        self.device = torch.device(device)
        self.vector = FlatVectorEngine(dim, similarity=similarity, device=self.device)
        self.lex = LexIndexBuilder()
        self._lex_snap: LexIndex | None = None
        self._lex_gen = -1
        self.stats = {"lex_snapshots": 0}
        # snapshot builds are read-triggered cache fills; serialize just the build
        self._snap_lock = threading.Lock()

    def index_text(self, frame_id: int, text: str) -> None:
        self.lex.add(frame_id, text)

    def index_embedding(self, frame_id: int, vec: np.ndarray) -> None:
        self.vector.add(frame_id, vec)

    def index_embedding_batch(self, frame_ids: Sequence[int], vecs: np.ndarray) -> None:
        self.vector.add_batch(np.asarray(frame_ids), vecs)

    def remove(self, frame_id: int) -> None:
        self.lex.remove(frame_id)
        self.vector.remove(frame_id)

    def lex_snapshot(self) -> LexIndex:
        with self._snap_lock:
            if self._lex_snap is None or self._lex_gen != self.lex.generation:
                self._lex_snap = self.lex.snapshot(device=self.device)
                self._lex_gen = self.lex.generation
                self.stats["lex_snapshots"] += 1
            return self._lex_snap

    def embed_query(self, text: str) -> np.ndarray | None:
        if self.embedder is None:
            return None
        return np.asarray(self.embedder.embed(text), np.float32)
