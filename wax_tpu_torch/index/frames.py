# Verbatim copy of wax_tpu/index/frames.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Host-side frame catalog: metadata + content for every frame in a store.

The in-memory projection of the reference's dense TOC frame array (reference:
Sources/WaxCore/FileFormat/MV2STOC.swift:42-86 — dense FrameMeta records — and the
frameContent/framePreviews accessors, WaxCore/Wax.swift:1674, :2119). Content payloads
live here (optionally compressed in the persistent snapshot); indexes reference frames
by id. Timeline queries (WaxCore/Search/TimelineQuery.swift:3-32) scan this catalog.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterable

from wax_tpu_torch.types import FrameMeta, FrameStatus, TimeRange

__all__ = ["FrameCatalog"]


class FrameCatalog:
    """Dense frame-id catalog with supersede/delete semantics.

    Frame ids are assigned densely from 0 (the reference enforces dense frame ids in
    its TOC). Deletion is logical (status flips); supersede links old -> new.
    """

    def __init__(self):
        self._meta: list[FrameMeta] = []
        self._content: list[str] = []

    def __len__(self) -> int:
        return len(self._meta)

    def __contains__(self, frame_id: int) -> bool:
        return 0 <= int(frame_id) < len(self._meta)

    @property
    def next_id(self) -> int:
        return len(self._meta)

    # -- writes ----------------------------------------------------------------------
    def put(self, content: str, meta: FrameMeta | None = None, **meta_kwargs) -> int:
        fid = len(self._meta)
        if meta is None:
            from wax_tpu_torch.types import now_ms

            meta_kwargs.setdefault("timestamp_ms", now_ms())
            meta = FrameMeta(frame_id=fid, **meta_kwargs)
        else:
            meta = replace(meta, frame_id=fid)
        self._meta.append(meta)
        self._content.append(content)
        return fid

    def delete(self, frame_id: int) -> bool:
        m = self.get(frame_id)
        if m is None or m.status == FrameStatus.DELETED.value:
            return False
        self._meta[frame_id] = replace(m, status=FrameStatus.DELETED.value)
        return True

    def supersede(self, old_id: int, content: str, **meta_kwargs) -> int:
        old = self.get(old_id)
        if old is None:
            raise KeyError(f"no frame {old_id}")
        new_id = self.put(content, supersedes=old_id, **meta_kwargs)
        self._meta[old_id] = replace(old, superseded_by=new_id)
        return new_id

    # -- reads -----------------------------------------------------------------------
    def get(self, frame_id: int) -> FrameMeta | None:
        fid = int(frame_id)
        return self._meta[fid] if 0 <= fid < len(self._meta) else None

    def content(self, frame_id: int) -> str | None:
        fid = int(frame_id)
        return self._content[fid] if 0 <= fid < len(self._content) else None

    def preview(self, frame_id: int, max_bytes: int = 4096) -> str:
        c = self.content(frame_id) or ""
        raw = c.encode("utf-8")[:max_bytes]
        return raw.decode("utf-8", errors="ignore")

    def is_live(self, frame_id: int) -> bool:
        m = self.get(frame_id)
        return (
            m is not None
            and m.status == FrameStatus.ACTIVE.value
            and m.superseded_by is None
        )

    def live_ids(self) -> list[int]:
        return [m.frame_id for m in self._meta if self.is_live(m.frame_id)]

    def iter_meta(self) -> Iterable[FrameMeta]:
        return iter(self._meta)

    def timeline(
        self,
        time_range: TimeRange | None = None,
        *,
        limit: int | None = None,
        newest_first: bool = True,
        include_deleted: bool = False,
        include_superseded: bool = False,
        kinds: set[str] | None = None,
    ) -> list[FrameMeta]:
        """Time-ordered frame scan with bounds and visibility flags
        (reference: TimelineQuery.swift:3-32, executor Wax.swift:2108)."""
        out = []
        for m in self._meta:
            if not include_deleted and m.status == FrameStatus.DELETED.value:
                continue
            if not include_superseded and m.superseded_by is not None:
                continue
            if kinds is not None and m.kind not in kinds:
                continue
            if time_range is not None and not time_range.contains(m.timestamp_ms):
                continue
            out.append(m)
        out.sort(key=lambda m: (-m.timestamp_ms, -m.frame_id) if newest_first else (m.timestamp_ms, m.frame_id))
        return out[:limit] if limit is not None else out

    # -- state hooks for persistence ---------------------------------------------------
    def state(self) -> tuple[list[FrameMeta], list[str]]:
        return self._meta, self._content

    @classmethod
    def from_state(cls, meta: list[FrameMeta], content: list[str]) -> "FrameCatalog":
        c = cls()
        c._meta = list(meta)
        c._content = list(content)
        return c
