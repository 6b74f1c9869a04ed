# Copy of wax_tpu/multimodal/video.py with one change: `VideoRAGOrchestrator` takes `device`
# (None: the current CUDA device, raising without one; "cpu" on request) and passes it
# to its inner `MemoryOrchestrator`, which holds the index snapshots there.
# Keep the two in step.
"""Video RAG: segment-level ingest + video-grouped recall over host transcripts.

Mirrors the reference's VideoRAGOrchestrator at full surface depth (reference:
Sources/Wax/VideoRAG/VideoRAGOrchestrator.swift:22-1277, VideoRAGConfig.swift:8-95,
VideoRAGTypes.swift:95-169, VideoMetadataKey.swift):

* ingest segments the video (segment_ms duration, optional overlap, <= 360 segments
  per video), maps host transcript chunks to segments by >= 250 ms temporal overlap
  (VideoRAGProtocols.swift:36-44), caps stored transcript bytes per segment, embeds
  and lex-indexes each non-empty segment, and stamps segment index/count/start/end/
  mid metadata (VideoMetadataKey.swift:12-17);
* dedupe is by (video id, pipeline version); a version bump re-ingests and removes
  the stale root (ingestOneFile :533-560);
* recall groups segment hits under their video root (recall :206-505): per-video
  score = best segment, evidence lanes union (vector / text snippet / timeline),
  segments sorted by start time and capped per video, summary text budgeted by
  cl100k tokens, keyframe references surfaced per segment.

Frames live in a dedicated store (the reference keeps ~/.wax/video.mv2s) managed by
an inner MemoryOrchestrator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

from wax_tpu_torch.multimodal.protocols import TranscriptProvider
from wax_tpu_torch.orchestrator.config import OrchestratorConfig
from wax_tpu_torch.orchestrator.orchestrator import MemoryOrchestrator
from wax_tpu_torch.types import LaneSource, SearchRequest, TimeRange, now_ms

__all__ = [
    "VideoRAGConfig",
    "VideoSegmentHit",
    "VideoItem",
    "VideoRecallContext",
    "VideoIngestResult",
    "VideoRAGOrchestrator",
]

VIDEO_ROOT_KIND = "wax.video.root"
VIDEO_SEGMENT_KIND = "wax.video.segment"
PIPELINE_VERSION = "video-v2"
_MIN_OVERLAP_MS = 250  # reference: VideoRAGProtocols.swift:36-44


@dataclass(frozen=True)
class VideoRAGConfig:
    """Tunables mirroring VideoRAGConfig.swift:8-95."""

    pipeline_version: str = PIPELINE_VERSION
    segment_ms: int = 10_000  # segmentDurationSeconds * 1000
    segment_overlap_ms: int = 0  # segmentOverlapSeconds * 1000
    max_segments_per_video: int = 360  # maxSegmentsPerVideo
    max_transcript_bytes_per_segment: int = 8_192  # maxTranscriptBytesPerSegment
    search_top_k: int = 64  # searchTopK candidate pool before grouping
    segment_limit_per_video: int = 4  # VideoQuery.segmentLimitPerVideo default
    max_text_tokens: int = 1200  # VideoContextBudget.maxTextTokens
    timeline_fallback_limit: int = 50
    orchestrator: OrchestratorConfig = field(default_factory=OrchestratorConfig)


@dataclass(frozen=True)
class VideoIngestResult:
    video_id: str
    root_frame: int
    segment_frames: tuple[int, ...]
    skipped_duplicate: bool = False
    superseded_root: int | None = None


@dataclass(frozen=True)
class VideoSegmentHit:
    """One matched segment (reference: VideoSegmentHit :95-120)."""

    video_id: str
    segment_index: int
    start_ms: int
    end_ms: int
    score: float
    text: str
    frame_id: int
    keyframe_ref: str | None = None
    evidence: tuple[str, ...] = ()


@dataclass(frozen=True)
class VideoItem:
    """A recalled video with grouped segment hits and a prompt-ready summary
    (reference: VideoRAGItem :123-138)."""

    video_id: str
    score: float
    evidence: tuple[str, ...]
    summary: str
    segments: tuple[VideoSegmentHit, ...]


@dataclass(frozen=True)
class VideoRecallContext:
    """Deterministic recall output + diagnostics (reference: VideoRAGContext :140)."""

    items: tuple[VideoItem, ...]
    used_text_tokens: int = 0


class VideoRAGOrchestrator:
    def __init__(
        self, store_path: str | Path, embedder=None, config: VideoRAGConfig = VideoRAGConfig(), device=None
    ):
        self.config = config
        self.inner = MemoryOrchestrator(store_path, embedder, config.orchestrator, device=device)
        # video id -> (root frame, pipeline version at ingest)
        self._ingested: dict[str, tuple[int, str]] = {}
        self._load_ingested()
        # keep root-frame ids valid across scheduled live-set rewrites (which renumber
        # the dense id space — orchestrator/maintenance.py)
        self.inner.maintainer.remap_listeners.append(self._on_remap)

    def _on_remap(self, remap: dict[int, int]) -> None:
        self._ingested = {
            vid: (remap[fid], ver) for vid, (fid, ver) in self._ingested.items() if fid in remap
        }

    def _load_ingested(self) -> None:
        for m in self.inner.store.timeline(include_superseded=False):
            if m.kind == VIDEO_ROOT_KIND:
                self._ingested[m.metadata.get("video_id", "")] = (
                    m.frame_id,
                    m.metadata.get("pipeline", ""),
                )

    # ---------------------------------------------------------------------- ingest ----
    def ingest(
        self,
        video_id: str,
        duration_ms: int,
        transcript_provider: TranscriptProvider,
        keyframe_refs: Sequence[str] | None = None,
        taken_at_ms: int | None = None,
    ) -> VideoIngestResult:
        """Segment the video, map transcript spans to segments by temporal overlap,
        embed and index each non-empty segment.

        Re-ingest semantics match the reference: same (video id, pipeline version)
        is a duplicate skip; a pipeline-version bump re-ingests and drops the stale
        root (ingestOneFile :533-560)."""
        prev = self._ingested.get(video_id)
        if prev is not None and prev[1] == self.config.pipeline_version:
            return VideoIngestResult(video_id, prev[0], (), skipped_duplicate=True)
        ts = taken_at_ms if taken_at_ms is not None else now_ms()
        seg_ms = self.config.segment_ms
        stride = max(1, seg_ms - self.config.segment_overlap_ms)
        n_segments = min(
            max(1, -(-max(duration_ms - self.config.segment_overlap_ms, 1) // stride)),
            self.config.max_segments_per_video,
        )
        spans = list(transcript_provider.transcript(video_id))
        byte_cap = self.config.max_transcript_bytes_per_segment

        def seg_bounds(i: int) -> tuple[int, int]:
            s0 = i * stride
            return s0, min(s0 + seg_ms, duration_ms)

        def seg_text(i: int) -> str:
            s0, s1 = seg_bounds(i)
            parts = []
            for sp in spans:
                overlap = min(s1, sp.end_ms) - max(s0, sp.start_ms)
                if overlap >= _MIN_OVERLAP_MS:
                    parts.append(sp.text)
            text = " ".join(parts)
            # byte cap per segment (reference: maxTranscriptBytesPerSegment)
            raw = text.encode("utf-8")[:byte_cap]
            return raw.decode("utf-8", errors="ignore")

        root = self.inner.store.put(
            f"video {video_id}",
            kind=VIDEO_ROOT_KIND,
            timestamp_ms=ts,
            metadata={
                "video_id": video_id,
                "duration_ms": str(duration_ms),
                "segments": str(n_segments),
                "pipeline": self.config.pipeline_version,
            },
        )
        seg_frames: list[int] = []
        texts_to_embed: list[tuple[int, str]] = []
        for i in range(n_segments):
            text = seg_text(i)
            if not text.strip():
                continue
            s0, s1 = seg_bounds(i)
            meta = {
                "video_id": video_id,
                "segment_index": str(i),
                "segment_count": str(n_segments),
                "start_ms": str(s0),
                "end_ms": str(s1),
                "mid_ms": str((s0 + s1) // 2),
            }
            if keyframe_refs is not None and i < len(keyframe_refs):
                meta["keyframe_ref"] = keyframe_refs[i]
            fid = self.inner.store.put(
                text,
                kind=VIDEO_SEGMENT_KIND,
                timestamp_ms=ts + s0,
                parent_id=root,
                metadata=meta,
                search_text=text,
            )
            self.inner.engine.index_text(fid, text)
            texts_to_embed.append((fid, text))
            seg_frames.append(fid)
        if texts_to_embed and self.inner.config.enable_vector_search:
            fids = [f for f, _ in texts_to_embed]
            vecs = self.inner.memoizer.embed_batch([t for _, t in texts_to_embed])
            self.inner.store.put_embedding_batch(fids, vecs)
            self.inner.engine.index_embedding_batch(fids, vecs)
        superseded = None
        if prev is not None:
            superseded = prev[0]
            self.inner.forget(superseded)
        self._ingested[video_id] = (root, self.config.pipeline_version)
        return VideoIngestResult(video_id, root, tuple(seg_frames), superseded_root=superseded)

    # ---------------------------------------------------------------------- recall ----
    def recall(
        self,
        query: str,
        top_k: int = 8,
        time_range: TimeRange | None = None,
        video_ids: Sequence[str] | None = None,
    ) -> list[VideoSegmentHit]:
        """Flat segment hits (round-1 compat view over the grouped recall)."""
        ctx = self.recall_context(
            query, top_k=top_k, time_range=time_range, video_ids=video_ids,
            segment_limit_per_video=max(top_k, self.config.segment_limit_per_video),
        )
        flat = [s for item in ctx.items for s in item.segments]
        flat.sort(key=lambda s: (-s.score, s.frame_id))
        return flat[:top_k]

    def recall_context(
        self,
        query: str,
        top_k: int = 8,
        time_range: TimeRange | None = None,
        video_ids: Sequence[str] | None = None,
        segment_limit_per_video: int | None = None,
    ) -> VideoRecallContext:
        """Video-grouped recall (reference: recall :206-505): segment hits group
        under their root, evidence unions, per-video segments are time-sorted and
        capped, summaries are budgeted by cl100k tokens."""
        seg_limit = segment_limit_per_video or self.config.segment_limit_per_video
        resp = self.inner.search(
            SearchRequest(
                query=query,
                top_k=max(self.config.search_top_k, top_k * seg_limit * 4),
                time_range=time_range,
            )
        )
        allow_roots = None
        if video_ids is not None:
            allow_roots = {
                self._ingested[v][0] for v in video_ids if v in self._ingested
            }

        by_root: dict[int, dict] = {}
        for h in resp.hits:
            m = self.inner.store.frame_meta(h.frame_id)
            if m is None or m.kind != VIDEO_SEGMENT_KIND:
                continue
            root_id = m.parent_id if m.parent_id is not None else h.frame_id
            if allow_roots is not None and root_id not in allow_roots:
                continue
            root_meta = self.inner.store.frame_meta(root_id)
            if root_meta is None or root_meta.status == "deleted" or root_meta.superseded_by:
                continue
            ev = tuple(
                lane
                for src, lane in (
                    (LaneSource.VECTOR, "vector"),
                    (LaneSource.BM25, "text"),
                    (LaneSource.TEMPORAL, "timeline"),
                )
                if src in h.sources
            )
            raw = self.inner.store.frame_content(h.frame_id) or b""
            seg = VideoSegmentHit(
                video_id=m.metadata.get("video_id", ""),
                segment_index=int(m.metadata.get("segment_index", "0")),
                start_ms=int(m.metadata.get("start_ms", "0")),
                end_ms=int(m.metadata.get("end_ms", "0")),
                score=h.score,
                text=raw.decode("utf-8", errors="ignore"),
                frame_id=h.frame_id,
                keyframe_ref=m.metadata.get("keyframe_ref"),
                evidence=ev,
            )
            entry = by_root.setdefault(root_id, {"score": h.score, "evidence": [], "segments": {}})
            entry["score"] = max(entry["score"], h.score)
            for e in ev:
                if e not in entry["evidence"]:
                    entry["evidence"].append(e)
            # keep the best hit per segment index (overlapping windows can both match)
            existing = entry["segments"].get(seg.segment_index)
            if existing is None or seg.score > existing.score:
                entry["segments"][seg.segment_index] = seg

        ranked = sorted(by_root.items(), key=lambda kv: (-kv[1]["score"], kv[0]))[:top_k]

        from wax_tpu_torch.text.token_counter import TokenCounter

        tc = TokenCounter.shared()
        per_item = max(1, self.config.max_text_tokens // max(1, len(ranked) or 1))
        used = 0
        items: list[VideoItem] = []
        for root_id, entry in ranked:
            segs = sorted(entry["segments"].values(), key=lambda s: s.start_ms)[:seg_limit]
            vid = segs[0].video_id if segs else ""
            summary = " ".join(s.text for s in segs)
            summary = tc.truncate(summary, per_item)
            tokens = tc.count(summary)
            if used + tokens > self.config.max_text_tokens:
                break
            used += tokens
            items.append(
                VideoItem(
                    video_id=vid,
                    score=entry["score"],
                    evidence=tuple(entry["evidence"]),
                    summary=summary,
                    segments=tuple(segs),
                )
            )
        return VideoRecallContext(items=tuple(items), used_text_tokens=used)

    def forget(self, video_id: str) -> bool:
        """Delete a video's root and segment frames; space is reclaimed by the
        scheduled live-set rewrite (reference: delete :512-525)."""
        entry = self._ingested.pop(video_id, None)
        if entry is None:
            return False
        return self.inner.forget(entry[0])

    def flush(self) -> int:
        return self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
