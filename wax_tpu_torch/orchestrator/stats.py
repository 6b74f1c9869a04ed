# Verbatim copy of wax_tpu/orchestrator/stats.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Per-frame access statistics.

Mirrors the reference's AccessStats (reference: Sources/Wax/Stats/AccessStats.swift:4-115
— in-memory per-frame access counts/recency, persisted as a hidden internal frame of
kind `wax.internal.access_stats`, with import/export/prune).
"""
from __future__ import annotations

import json

__all__ = ["AccessStats", "ACCESS_STATS_KIND"]

ACCESS_STATS_KIND = "wax.internal.access_stats"


class AccessStats:
    def __init__(self):
        self._counts: dict[int, int] = {}
        self._last_ms: dict[int, int] = {}
        # internal lock: access recording happens on the orchestrator's READ path
        # (concurrent searches share one RWLock read phase), so the counter
        # read-modify-write must be atomic on its own
        import threading

        self._lock = threading.Lock()

    def record(self, frame_id: int, now_ms: int) -> None:
        fid = int(frame_id)
        with self._lock:
            self._counts[fid] = self._counts.get(fid, 0) + 1
            self._last_ms[fid] = now_ms

    def record_batch(self, frame_ids, now_ms: int) -> None:
        for fid in frame_ids:
            self.record(fid, now_ms)

    def stats_for(self, frame_id: int) -> tuple[int, int | None]:
        fid = int(frame_id)
        return self._counts.get(fid, 0), self._last_ms.get(fid)

    def prune(self, live_ids: set[int]) -> int:
        dead = [fid for fid in self._counts if fid not in live_ids]
        for fid in dead:
            self._counts.pop(fid, None)
            self._last_ms.pop(fid, None)
        return len(dead)

    def __len__(self) -> int:
        return len(self._counts)

    # -- persistence (hidden internal frame payload) -------------------------------------
    def export_json(self) -> str:
        return json.dumps(
            {str(fid): [self._counts[fid], self._last_ms.get(fid)] for fid in sorted(self._counts)}
        )

    @classmethod
    def from_json(cls, payload: str) -> "AccessStats":
        s = cls()
        try:
            data = json.loads(payload)
        except json.JSONDecodeError:
            return s
        for fid, (count, last) in data.items():
            s._counts[int(fid)] = int(count)
            if last is not None:
                s._last_ms[int(fid)] = int(last)
        return s
