# Verbatim copy of wax_tpu/text/token_counter.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Token counting/truncation service with an LRU cache.

Mirrors the reference's TokenCounter actor (reference:
Sources/Wax/RAG/TokenCounter.swift:6-460 — shared cl100k BPE with encode/decode/count/
truncate + batch variants, LRU tokenization cache, 8 MiB input cap, preload for
cold-start overlap). Host-side and synchronous here: token budgeting happens during
RAG assembly on tiny strings relative to device work.
"""
from __future__ import annotations

from collections import OrderedDict

from wax_tpu_torch.text.bpe import BpeEncoder, load_cl100k

__all__ = ["TokenCounter", "MAX_INPUT_BYTES"]

MAX_INPUT_BYTES = 8 * 1024 * 1024  # reference cap: 8 MiB per input


class TokenCounter:
    _shared: "TokenCounter | None" = None

    def __init__(self, encoder: BpeEncoder | None = None, cache_capacity: int = 4096):
        import threading

        self._lock = threading.Lock()
        self._encoder = encoder or load_cl100k()
        self._cache: OrderedDict[str, int] = OrderedDict()
        self._capacity = cache_capacity
        self.stats = {"hits": 0, "misses": 0}

    @classmethod
    def shared(cls) -> "TokenCounter":
        """Process-wide instance (reference: TokenCounter.shared(), :6)."""
        if cls._shared is None:
            cls._shared = cls()
        return cls._shared

    @property
    def exact(self) -> bool:
        return self._encoder.exact

    @property
    def encoder_name(self) -> str:
        return self._encoder.name

    def _check(self, text: str) -> None:
        if len(text) > MAX_INPUT_BYTES:
            raise ValueError(f"input exceeds {MAX_INPUT_BYTES} byte cap")

    def encode(self, text: str) -> list[int]:
        self._check(text)
        return self._encoder.encode(text)

    def decode(self, ids: list[int]) -> str:
        return self._encoder.decode(ids)

    def count(self, text: str) -> int:
        self._check(text)
        # the shared counter is hit from concurrent read-phase searches; the LRU
        # mutates on lookups, so both sides go through the lock (the BPE encode
        # itself runs outside it)
        with self._lock:
            cached = self._cache.get(text)
            if cached is not None:
                self._cache.move_to_end(text)
                self.stats["hits"] += 1
                return cached
            self.stats["misses"] += 1
        n = len(self._encoder.encode(text))
        with self._lock:
            self._cache[text] = n
            if len(self._cache) > self._capacity:
                self._cache.popitem(last=False)
        return n

    def count_batch(self, texts: list[str]) -> list[int]:
        return [self.count(t) for t in texts]

    def truncate(self, text: str, max_tokens: int) -> str:
        """Token-exact prefix truncation (decode path when exact; byte-proportional
        fallback otherwise)."""
        self._check(text)
        if max_tokens <= 0:
            return ""
        ids = self._encoder.encode(text)
        if len(ids) <= max_tokens:
            return text
        if self._encoder.exact:
            return self._encoder.decode(ids[:max_tokens])
        frac = max_tokens / len(ids)
        return text[: max(1, int(len(text) * frac))]

    def truncate_batch(self, texts: list[str], max_tokens: int) -> list[str]:
        return [self.truncate(t, max_tokens) for t in texts]
