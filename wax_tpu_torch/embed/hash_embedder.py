# Verbatim copy of wax_tpu/embed/hash_embedder.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Deterministic hash embedder — the offline default and the test fake.

Mirrors the reference's DeterministicTextEmbedder mock (reference:
Tests/WaxIntegrationTests/Mocks/MockEmbedders.swift:9-75 — hash-seeded vectors used in
every test in place of the real model), promoted here to a first-class provider: it is
fully offline, platform-stable (SHA-256 -> PCG64 -> unit normal -> L2 normalize), and
gives *related texts related vectors* by mixing token-level vectors so recall-quality
tests are meaningful, not just smoke tests.
"""
from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

from wax_tpu_torch.embed.provider import ExecutionMode

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class HashEmbedder:
    """Deterministic, content-sensitive embedding provider.

    The vector for a text is the L2-normalized mix of (a) a whole-text hash vector and
    (b) the mean of per-token hash vectors, so texts sharing vocabulary land near each
    other — enough signal for recall@k tests against a flat-scan oracle.
    """

    def __init__(self, dimensions: int = 384, token_weight: float = 0.85, seed: str = "wax-tpu"):
        self._dim = int(dimensions)
        self._token_weight = float(token_weight)
        self._seed = seed
        self._token_cache: dict[str, np.ndarray] = {}

    # -- provider protocol ---------------------------------------------------------
    @property
    def dimensions(self) -> int:
        return self._dim

    @property
    def identity(self) -> str:
        return f"hash-embedder/{self._seed}/{self._dim}"

    @property
    def normalized(self) -> bool:
        return True

    @property
    def execution_mode(self) -> str:
        return ExecutionMode.ON_DEVICE_ONLY

    @property
    def batch_size(self) -> int:
        return 1024

    # -- implementation --------------------------------------------------------------
    def _hash_vec(self, key: str) -> np.ndarray:
        digest = hashlib.sha256(f"{self._seed}\x00{key}".encode()).digest()
        gen = np.random.Generator(np.random.PCG64(int.from_bytes(digest[:8], "little")))
        return gen.standard_normal(self._dim).astype(np.float32)

    def _token_vec(self, tok: str) -> np.ndarray:
        v = self._token_cache.get(tok)
        if v is None:
            v = self._hash_vec("tok:" + tok)
            if len(self._token_cache) < 65536:
                self._token_cache[tok] = v
        return v

    def embed(self, text: str) -> np.ndarray:
        whole = self._hash_vec("txt:" + text)
        toks = _TOKEN_RE.findall(text.lower())
        if toks:
            tv = np.mean([self._token_vec(t) for t in toks], axis=0)
            v = self._token_weight * tv + (1.0 - self._token_weight) * whole
        else:
            v = whole
        n = np.linalg.norm(v)
        return (v / n if n > 0 else v).astype(np.float32)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self._dim), np.float32)
        return np.stack([self.embed(t) for t in texts])
