"""Hybrid search engine: frames, a vector engine and a lexical builder.

PyTorch port of `wax_tpu.search.engine.HybridSearchEngine`: the frame catalog,
host-side builders, device snapshots cached per builder generation (the plain CSR
snapshot, and the mesh-sharded one for the sharded BM25 lane), the structured-evidence
hook and query embedding. Unlike the JAX engine it takes an explicit `device`.
"""
from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np
import torch

from wax_tpu_torch.embed.provider import BatchEmbeddingProvider, EmbeddingProvider
from wax_tpu_torch.index.dense import Similarity
from wax_tpu_torch.index.frames import FrameCatalog
from wax_tpu_torch.index.lex import LexIndex, LexIndexBuilder
from wax_tpu_torch.parallel.mesh import Mesh, data_mesh
from wax_tpu_torch.parallel.sharded_hybrid import shard_lex_index
from wax_tpu_torch.search.vector_engines import VectorEngine, make_vector_engine
from wax_tpu_torch.utils.device import resolve_device
from wax_tpu_torch.utils.profiling import span

__all__ = ["HybridSearchEngine"]


class HybridSearchEngine:
    """Owns the frame catalog, the lexical builder and a vector engine whose snapshots
    live on `device` (None: the current CUDA device).

    `structured_evidence` is an optional hook returning evidence frame ids for a query
    (the orchestrator wires it to its structured memory: the structured lane).

    `vector_preference` picks the engine (`make_vector_engine`): "auto" (default; the
    exact scan below 2,097,152 rows, then an IVF engine of measured recall), "flat" or
    "ivf"; `vector_kwargs` go to it.

    `lex_postings_budget` caps each term's postings (None exact, "auto" exact below
    256K rows, or an int); a truncated snapshot carries the exact-rescore forward
    index. `lex_sharded` sends the BM25 lane to the sharded program over `mesh`
    (default: the one-device mesh of `device`).
    """

    def __init__(
        self,
        embedder: EmbeddingProvider | BatchEmbeddingProvider | None,
        dim: int | None = None,
        similarity: str = Similarity.COSINE,
        frames: FrameCatalog | None = None,
        structured_evidence: Callable[[str, int | None], list[int]] | None = None,
        device: str | torch.device | None = None,
        lex_sharded: bool = False,
        mesh: Mesh | None = None,
        lex_postings_budget: int | str | None = None,
        vector_preference: str = "auto",
        vector_kwargs: dict | None = None,
    ):
        if dim is None:
            if embedder is None:
                raise ValueError("either embedder or dim is required")
            dim = embedder.dimensions
        self.embedder = embedder
        self.frames = frames if frames is not None else FrameCatalog()
        self.structured_evidence = structured_evidence
        self.device = resolve_device(device)
        kw = dict(vector_kwargs or {})
        if vector_preference in ("auto", "flat"):
            kw.setdefault("similarity", similarity)
        kw.setdefault("device", self.device)
        self.vector: VectorEngine = make_vector_engine(vector_preference, dim=dim, **kw)
        self.lex = LexIndexBuilder(postings_budget=lex_postings_budget)
        self._lex_snap: LexIndex | None = None
        self._lex_gen = -1
        self.lex_sharded = lex_sharded
        self.mesh = mesh
        if lex_sharded and mesh is None:
            self.mesh = data_mesh(self.device)
        self._lex_sharded_snap = None
        self._lex_sharded_gen = -1
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
                with span("engine.lex_snapshot"):
                    self._lex_snap = self.lex.snapshot(device=self.device)
                self._lex_gen = self.lex.generation
                self.stats["lex_snapshots"] += 1
            return self._lex_snap

    def lex_sharded_snapshot(self):
        """Mesh-sharded CSR snapshot, cached per builder generation."""
        with self._snap_lock:
            if self._lex_sharded_snap is None or self._lex_sharded_gen != self.lex.generation:
                self._lex_sharded_snap = shard_lex_index(self.lex, self.mesh, self.lex.row_space())
                self._lex_sharded_gen = self.lex.generation
                self.stats["lex_snapshots"] += 1
            return self._lex_sharded_snap

    def embed_query(self, text: str) -> np.ndarray | None:
        if self.embedder is None:
            return None
        return np.asarray(self.embedder.embed(text), np.float32)
