# Verbatim copy of wax_tpu/embed/memoizer.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""LRU embedding cache.

Mirrors the reference's EmbeddingMemoizer (reference:
Sources/Wax/Embeddings/EmbeddingMemoizer.swift:6-200 — LRU capacity 2048, keyed by a
hash of text + provider identity + dims + normalized flag).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Sequence

import numpy as np

from wax_tpu_torch.embed.provider import BatchEmbeddingProvider, EmbeddingProvider

__all__ = ["EmbeddingMemoizer"]


class EmbeddingMemoizer:
    def __init__(self, provider: EmbeddingProvider | BatchEmbeddingProvider, capacity: int = 2048):
        self.provider = provider
        self.capacity = capacity
        self._cache: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self.stats = {"hits": 0, "misses": 0}
        import threading

        # the cache mutates on LOOKUPS (LRU move_to_end); concurrent read-phase
        # searches need it internally consistent
        self._lock = threading.Lock()

    def _key(self, text: str) -> bytes:
        h = hashlib.sha256()
        h.update(text.encode("utf-8"))
        h.update(b"\x00")
        h.update(self.provider.identity.encode())
        h.update(str(self.provider.dimensions).encode())
        h.update(b"1" if self.provider.normalized else b"0")
        return h.digest()

    def _put(self, key: bytes, vec: np.ndarray) -> None:
        with self._lock:
            self._cache[key] = vec
            self._cache.move_to_end(key)
            if len(self._cache) > self.capacity:
                self._cache.popitem(last=False)

    def _get(self, key: bytes):
        with self._lock:
            v = self._cache.get(key)
            if v is not None:
                self._cache.move_to_end(key)
                self.stats["hits"] += 1
            else:
                self.stats["misses"] += 1
            return v

    def embed(self, text: str) -> np.ndarray:
        key = self._key(text)
        v = self._get(key)
        if v is not None:
            return v
        v = np.asarray(self.provider.embed(text), np.float32)
        self._put(key, v)
        return v

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        keys = [self._key(t) for t in texts]
        out: list[np.ndarray | None] = []
        missing_idx, missing_texts = [], []
        for i, k in enumerate(keys):
            v = self._get(k)
            if v is not None:
                out.append(v)
            else:
                out.append(None)
                missing_idx.append(i)
                missing_texts.append(texts[i])
        if missing_texts:
            if isinstance(self.provider, BatchEmbeddingProvider) or hasattr(self.provider, "embed_batch"):
                fresh = np.asarray(self.provider.embed_batch(missing_texts), np.float32)
            else:
                fresh = np.stack([self.provider.embed(t) for t in missing_texts]).astype(np.float32)
            for j, i in enumerate(missing_idx):
                out[i] = fresh[j]
                self._put(keys[i], fresh[j])
        return np.stack(out) if out else np.zeros((0, self.provider.dimensions), np.float32)
