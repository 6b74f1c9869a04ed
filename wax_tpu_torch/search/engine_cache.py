# Verbatim copy of wax_tpu/search/engine_cache.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Process-wide engine cache: skip index deserialization on warm re-open.

The analogue of the reference's UnifiedSearchEngineCache (reference:
Sources/Wax/UnifiedSearch/UnifiedSearchEngineCache.swift:53-123 — process-wide cache
of deserialized engines keyed by store identity + committed-index checksum + engine
kind, with incremental catch-up). Ownership differs to fit our model: the store is
single-writer (flock lease), so live MUTABLE engines can never be aliased across
orchestrators; instead a closing orchestrator PARKS its builders here keyed by
(path, lex sha, vec sha), and a later open RECLAIMS a DEEP COPY iff the committed
segment checksums still match — the parked entry stays, so any number of concurrent
read-only openers (and later writers) are served warm, matching the reference cache's
concurrent-reader behavior while keeping exclusive ownership of every live object.
Copying host arrays is 1-2 orders of magnitude cheaper than json/npz deserialization.
WAL catch-up still runs after a hit, so reclaimed engines converge to exactly the
state a cold load would build.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path

__all__ = ["park", "reclaim", "cache_stats", "clear"]

_MAX_ENTRIES = 4
_lock = threading.Lock()
_entries: OrderedDict[tuple, tuple] = OrderedDict()
_stats = {"parks": 0, "hits": 0, "misses": 0}


def _key(path, lex_sha: bytes | None, vec_sha: bytes | None) -> tuple:
    return (str(Path(path).resolve()), lex_sha, vec_sha)


def park(path, lex_sha, vec_sha, lex_builder, vector_engine) -> None:
    """Store a closing orchestrator's engines for possible reclaim.

    A session with no committed index segments is never parked: its key would be
    (path, None, None), which a brand-new store created later at the same path would
    wrongly match (WAL catch-up rebuilds such small states cheaply anyway).
    """
    if lex_sha is None and vec_sha is None:
        return
    with _lock:
        key = _key(path, lex_sha, vec_sha)
        _entries.pop(key, None)
        _entries[key] = (lex_builder, vector_engine)
        _stats["parks"] += 1
        while len(_entries) > _MAX_ENTRIES:
            _entries.popitem(last=False)


def reclaim(path, lex_sha, vec_sha):
    """Warm engines when the committed checksums still match, or None.

    Returns a DEEP COPY of (lex_builder, vector_engine); the parked entry stays so
    further opens (e.g. read-only sessions while a writer is live) also hit. The copy
    guarantees exclusive ownership — no two sessions ever share a mutable builder.
    """
    if lex_sha is None and vec_sha is None:
        return None
    key = _key(path, lex_sha, vec_sha)
    # Pop the entry BEFORE copying: two threads racing on an uncopyable engine must
    # never both receive the same mutable tuple, so whoever pops owns it exclusively
    # until the copy succeeds and the original is re-parked.
    with _lock:
        entry = _entries.pop(key, None)
        if entry is None:
            _stats["misses"] += 1
            return None
        _stats["hits"] += 1
    import copy

    try:
        copied = copy.deepcopy(entry)
    except Exception:  # noqa: BLE001
        # engines holding uncopyable state (a sharded engine's Mesh/Device handles,
        # the C++ HNSW builder's ctypes pointer — which may raise any exception
        # class from deepcopy): EXCLUSIVE handover of the popped entry — it is no
        # longer in the cache, so no other thread can alias it
        return entry
    with _lock:
        # restore the original for future openers unless a newer park replaced it
        _entries.setdefault(key, entry)
        _entries.move_to_end(key)
    return copied


def cache_stats() -> dict:
    with _lock:
        return dict(_stats, entries=len(_entries))


def clear() -> None:
    with _lock:
        _entries.clear()
        for k in _stats:
            _stats[k] = 0
