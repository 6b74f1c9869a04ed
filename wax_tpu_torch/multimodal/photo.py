# Copy of wax_tpu/multimodal/photo.py with one change: `PhotoRAGOrchestrator` takes `device`
# (None: the current CUDA device, raising without one; "cpu" on request) and passes it
# to its inner `MemoryOrchestrator`, which holds the index snapshots there.
# Keep the two in step.
"""Photo RAG: asset-level ingest (OCR blocks + summary + caption + tags + regions +
GPS bins) and root-aggregated recall with evidence.

Mirrors the reference's PhotoRAGOrchestrator at full granularity (reference:
Sources/Wax/PhotoRAG/PhotoRAGOrchestrator.swift:21-1316, PhotoRAGConfig.swift:8-119,
PhotoRAGTypes.swift:88-210, PhotoFrameKind.swift, PhotoMetadataKey.swift):

* ingest writes a ROOT frame carrying the global image embedding, a searchable
  caption frame, a searchable tags frame, ONE searchable OCR-summary frame plus
  per-block OCR frames (bbox + confidence + language metadata, not lex-indexed —
  ingestOne :559-607), and region frames proposed from OCR block bboxes with
  per-crop image-tower embeddings (proposeRegions :1246-1262, region put :628-705);
* dedupe is by (asset id, pipeline version): bumping the pipeline version re-ingests
  and supersedes the old root (ingestOne :462-466);
* recall groups child hits by their root (parentId), unions evidence (vector / text
  snippet / region bbox / timeline — PhotoRAGItem.Evidence :1036-1053), scores each
  asset by its best frame, builds a caption+OCR+tags summary under a per-item token
  budget (buildSummaryText :1080-1131, budget loop :391-404), and surfaces matched
  region bboxes + crop refs.

OS photo-library access stays behind the provider protocols; frames live in a
dedicated store (the reference keeps ~/.wax/photo.mv2s).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from wax_tpu_torch.multimodal.protocols import (
    CaptionProvider,
    MultimodalEmbeddingProvider,
    OCRProvider,
)
from wax_tpu_torch.orchestrator.config import OrchestratorConfig
from wax_tpu_torch.orchestrator.orchestrator import MemoryOrchestrator
from wax_tpu_torch.types import LaneSource, SearchRequest, TimeRange, now_ms

__all__ = [
    "PhotoRAGConfig",
    "PhotoIngestResult",
    "PhotoHit",
    "PhotoRecallContext",
    "PhotoRegion",
    "PhotoRAGOrchestrator",
    "gps_bin",
]

PHOTO_ROOT_KIND = "wax.photo.root"
PHOTO_CAPTION_KIND = "wax.photo.caption"
PHOTO_OCR_KIND = "wax.photo.ocr"  # the indexed OCR summary (photo.ocr.summary)
PHOTO_OCR_BLOCK_KIND = "wax.photo.ocr.block"
PHOTO_TAGS_KIND = "wax.photo.tags"
PHOTO_REGION_KIND = "wax.photo.region"
PIPELINE_VERSION = "photo-v2"


def gps_bin(lat: float, lon: float, precision: float = 0.01) -> str:
    """Quantized location bin tag (reference: locationBin :868-878)."""
    return f"gps:{round(lat / precision) * precision:.2f},{round(lon / precision) * precision:.2f}"


@dataclass(frozen=True)
class PhotoRAGConfig:
    """Tunables mirroring PhotoRAGConfig.swift:8-119 (host-app tradeoffs)."""

    pipeline_version: str = PIPELINE_VERSION
    max_ocr_blocks: int = 64  # maxOCRBlocksPerPhoto
    max_ocr_summary_lines: int = 32  # maxOCRSummaryLines
    min_ocr_confidence: float = 0.3
    enable_region_embeddings: bool = True
    max_regions_per_photo: int = 8  # maxRegionsPerPhoto
    search_top_k: int = 48  # searchTopK (pre-filter candidate pool)
    # recall context budget (ContextBudget, PhotoRAGTypes.swift:5-25)
    max_text_tokens: int = 1200
    max_ocr_lines_per_item: int = 8
    orchestrator: OrchestratorConfig = field(default_factory=OrchestratorConfig)


@dataclass(frozen=True)
class PhotoIngestResult:
    asset_id: str
    root_frame: int
    caption_frame: int | None
    tags_frame: int | None
    ocr_summary_frame: int | None
    ocr_block_frames: tuple[int, ...]
    region_frames: tuple[int, ...]
    skipped_duplicate: bool = False
    superseded_root: int | None = None

    # round-1 compat alias (ocr_frames meant "the indexed OCR frames")
    @property
    def ocr_frames(self) -> tuple[int, ...]:
        return (self.ocr_summary_frame,) if self.ocr_summary_frame is not None else ()


@dataclass(frozen=True)
class PhotoRegion:
    """A matched region: normalized top-left-origin bbox + optional crop reference
    (reference: PhotoRAGItem.RegionContext, PhotoRAGTypes.swift:177-185)."""

    bbox: tuple[float, float, float, float]
    crop_ref: str | None = None
    region_type: str = "ocr"


@dataclass(frozen=True)
class PhotoHit:
    """One asset-level recall item (reference: PhotoRAGItem :169-210). `kind`/`text`
    describe the best-matching child frame (round-1 compat)."""

    asset_id: str
    score: float
    frame_id: int
    kind: str
    text: str
    taken_at_ms: int
    gps: str | None = None
    thumbnail_ref: str | None = None
    summary: str = ""
    evidence: tuple[str, ...] = ()
    regions: tuple[PhotoRegion, ...] = ()


@dataclass(frozen=True)
class PhotoRecallContext:
    """recall() + diagnostics (reference: PhotoRAGContext :145-167)."""

    items: tuple[PhotoHit, ...]
    used_text_tokens: int = 0


def _parse_bbox(s: str) -> tuple[float, float, float, float]:
    parts = [float(x) for x in s.split(",")]
    return (parts[0], parts[1], parts[2], parts[3])


def _merge_boxes(a, b):
    x0 = min(a[0], b[0])
    y0 = min(a[1], b[1])
    x1 = max(a[0] + a[2], b[0] + b[2])
    y1 = max(a[1] + a[3], b[1] + b[3])
    return (x0, y0, x1 - x0, y1 - y0)


def _overlaps(a, b) -> bool:
    return not (
        a[0] + a[2] < b[0] or b[0] + b[2] < a[0] or a[1] + a[3] < b[1] or b[1] + b[3] < a[1]
    )


def propose_regions(
    blocks: Sequence[tuple[tuple[float, float, float, float], str]], max_regions: int
) -> list[tuple[tuple[float, float, float, float], str]]:
    """Merge overlapping OCR block bboxes into region proposals, capped
    (reference: proposeRegions :1246-1262)."""
    regions: list[tuple[tuple[float, float, float, float], str]] = []
    for bbox, rtype in blocks:
        for i, (rb, rt) in enumerate(regions):
            if _overlaps(bbox, rb):
                regions[i] = (_merge_boxes(rb, bbox), rt)
                break
        else:
            regions.append((bbox, rtype))
    return regions[:max_regions]


class PhotoRAGOrchestrator:
    def __init__(
        self,
        store_path: str | Path,
        embedder: MultimodalEmbeddingProvider | None = None,
        ocr_provider: OCRProvider | None = None,
        caption_provider: CaptionProvider | None = None,
        config: PhotoRAGConfig = PhotoRAGConfig(),
        device=None,
    ):
        self.config = config
        self.mm_embedder = embedder
        self.ocr_provider = ocr_provider
        self.caption_provider = caption_provider
        # text lane uses the multimodal text tower when available
        inner_embedder = _TextTowerAdapter(embedder) if embedder is not None else None
        self.inner = MemoryOrchestrator(store_path, inner_embedder, config.orchestrator, device=device)
        # asset -> (root frame, pipeline version at ingest)
        self._ingested: dict[str, tuple[int, str]] = {}
        for m in self.inner.store.timeline(include_superseded=False):
            if m.kind == PHOTO_ROOT_KIND:
                self._ingested[m.metadata.get("asset_id", "")] = (
                    m.frame_id,
                    m.metadata.get("pipeline", ""),
                )
        # keep root-frame ids valid across scheduled live-set rewrites (which renumber
        # the dense id space — orchestrator/maintenance.py)
        self.inner.maintainer.remap_listeners.append(self._on_remap)

    def _on_remap(self, remap: dict[int, int]) -> None:
        self._ingested = {
            aid: (remap[fid], ver) for aid, (fid, ver) in self._ingested.items() if fid in remap
        }

    def forget(self, asset_id: str) -> bool:
        """Delete an asset's root + derived frames; space is reclaimed by the
        scheduled live-set rewrite of the inner store (reference: delete :417-434)."""
        entry = self._ingested.pop(asset_id, None)
        if entry is None:
            return False
        return self.inner.forget(entry[0])

    # ---------------------------------------------------------------------- ingest ----
    def ingest(
        self,
        asset_id: str,
        image: np.ndarray | bytes | str,
        taken_at_ms: int | None = None,
        gps: tuple[float, float] | None = None,
        tags: Sequence[str] = (),
        thumbnail_ref: str | None = None,
        caption_text: str | None = None,
        ocr_texts: Sequence[str] | None = None,
        camera: Mapping[str, str] | None = None,
    ) -> PhotoIngestResult:
        """Ingest one asset. `caption_text`/`ocr_texts` override the providers when
        the host has already run its own vision pipeline (the MCP path).

        Re-ingest semantics: same asset id + same pipeline version -> duplicate skip;
        a pipeline-version bump re-ingests and supersedes the previous root
        (reference: ingestOne :462-466 'previousRoot ... supersede')."""
        prev = self._ingested.get(asset_id)
        if prev is not None and prev[1] == self.config.pipeline_version:
            return PhotoIngestResult(
                asset_id, prev[0], None, None, None, (), (), skipped_duplicate=True
            )
        ts = taken_at_ms if taken_at_ms is not None else now_ms()
        base_tags = tuple(tags)
        if gps is not None:
            base_tags = base_tags + (gps_bin(*gps),)
        root_meta = {"asset_id": asset_id, "pipeline": self.config.pipeline_version}
        if thumbnail_ref:
            root_meta["thumbnail_ref"] = thumbnail_ref
        if gps is not None:
            root_meta["gps"] = f"{gps[0]:.5f},{gps[1]:.5f}"
        for k, v in (camera or {}).items():
            root_meta[f"camera.{k}"] = v
        root = self.inner.store.put(
            f"photo {asset_id}",
            kind=PHOTO_ROOT_KIND,
            timestamp_ms=ts,
            metadata=root_meta,
            tags=base_tags,
        )

        def child(
            content: str, kind: str, extra_meta: dict | None = None, *, indexed: bool = True
        ) -> int:
            fid = self.inner.store.put(
                content,
                kind=kind,
                timestamp_ms=ts,
                parent_id=root,
                metadata={"asset_id": asset_id, **(extra_meta or {})},
                tags=base_tags,
                search_text=content if indexed else None,
            )
            if indexed:
                self.inner.engine.index_text(fid, content)
            return fid

        embed_jobs: list[tuple[int, np.ndarray]] = []
        if self.mm_embedder is not None:
            # global embedding lives on the ROOT frame (reference: rootId put with
            # globalEmbedding, ingestOne :516-528)
            embed_jobs.append((root, np.asarray(self.mm_embedder.embed_image(image))))

        caption_frame = None
        caption = caption_text
        if caption is None and self.caption_provider is not None:
            caption = self.caption_provider.caption(image)
        if caption and caption.strip():
            caption_frame = child(caption, PHOTO_CAPTION_KIND)
            if self.mm_embedder is not None:
                embed_jobs.append((caption_frame, np.asarray(self.mm_embedder.embed_text(caption))))

        tags_frame = None
        tag_text = " ".join(
            list(tags) + [f"{k} {v}" for k, v in (camera or {}).items()]
        ).strip()
        if tag_text:
            tags_frame = child(tag_text, PHOTO_TAGS_KIND)

        # OCR: one searchable summary + per-block frames with bbox/confidence metadata
        blocks: list[tuple[str, tuple[float, float, float, float], float, str | None]] = []
        if ocr_texts is not None:
            blocks = [
                (t, (0.0, 0.0, 1.0, 1.0), 1.0, None) for t in ocr_texts if t.strip()
            ]
        elif self.ocr_provider is not None:
            blocks = [
                (b.text, b.bbox, b.confidence, getattr(b, "language", None))
                for b in self.ocr_provider.ocr(image)
                if b.confidence >= self.config.min_ocr_confidence and b.text.strip()
            ]
        blocks = blocks[: self.config.max_ocr_blocks]

        ocr_summary_frame = None
        ocr_block_frames: list[int] = []
        if blocks:
            summary = "\n".join(t for t, _, _, _ in blocks[: self.config.max_ocr_summary_lines])
            ocr_summary_frame = child(summary, PHOTO_OCR_KIND, {"blocks": str(len(blocks))})
            if self.mm_embedder is not None:
                embed_jobs.append(
                    (ocr_summary_frame, np.asarray(self.mm_embedder.embed_text(summary)))
                )
            for text, bbox, conf, lang in blocks:
                meta = {
                    "bbox": ",".join(f"{v:.4f}" for v in bbox),
                    "confidence": f"{conf:.3f}",
                }
                if lang:
                    meta["language"] = lang
                ocr_block_frames.append(
                    child(text, PHOTO_OCR_BLOCK_KIND, meta, indexed=False)
                )

        # Regions proposed from OCR block bboxes, embedded via pixel crops when the
        # image is an array; whole-image region otherwise (keeps the image lane alive
        # for byte/ref-typed images where cropping is the host's job)
        region_frames: list[int] = []
        if self.mm_embedder is not None and self.config.enable_region_embeddings:
            proposals = propose_regions(
                [(bbox, "ocr") for _, bbox, _, _ in blocks if bbox != (0.0, 0.0, 1.0, 1.0)],
                self.config.max_regions_per_photo,
            )
            if not proposals:
                proposals = [((0.0, 0.0, 1.0, 1.0), "full")]
            for bbox, rtype in proposals:
                crop = self._crop(image, bbox)
                fid = child(
                    f"region {rtype} of {asset_id}",
                    PHOTO_REGION_KIND,
                    {
                        "bbox": ",".join(f"{v:.4f}" for v in bbox),
                        "region_type": rtype,
                    },
                    indexed=False,
                )
                embed_jobs.append((fid, np.asarray(self.mm_embedder.embed_image(crop))))
                region_frames.append(fid)

        if embed_jobs:
            fids = [f for f, _ in embed_jobs]
            vecs = np.stack([v for _, v in embed_jobs]).astype(np.float32)
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = np.where(norms > 0, vecs / np.maximum(norms, 1e-12), vecs)
            self.inner.store.put_embedding_batch(fids, vecs)
            self.inner.engine.index_embedding_batch(fids, vecs)

        superseded = None
        if prev is not None:
            superseded = prev[0]
            self.inner.forget(superseded)
        self._ingested[asset_id] = (root, self.config.pipeline_version)
        return PhotoIngestResult(
            asset_id,
            root,
            caption_frame,
            tags_frame,
            ocr_summary_frame,
            tuple(ocr_block_frames),
            tuple(region_frames),
            superseded_root=superseded,
        )

    @staticmethod
    def _crop(image, bbox):
        """Pixel crop for ndarray images (H, W[, C]); pass-through otherwise —
        the deterministic analogue of the reference's CGImage crop (:1270-1280)."""
        if isinstance(image, np.ndarray) and image.ndim >= 2 and bbox != (0.0, 0.0, 1.0, 1.0):
            h, w = image.shape[0], image.shape[1]
            # Clamp to the image bounds first — OCR providers may return slightly
            # out-of-range normalized coords; unclamped negatives would wrap and crop
            # unrelated pixels (mirrors the reference's CGRect intersection).
            bx0 = min(max(bbox[0], 0.0), 1.0)
            by0 = min(max(bbox[1], 0.0), 1.0)
            bx1 = min(max(bbox[0] + max(bbox[2], 0.0), bx0), 1.0)
            by1 = min(max(bbox[1] + max(bbox[3], 0.0), by0), 1.0)
            y0, x0 = int(by0 * h), int(bx0 * w)
            y1 = min(max(int(by1 * h), y0 + 1), h)
            x1 = min(max(int(bx1 * w), x0 + 1), w)
            y0, x0 = min(y0, h - 1), min(x0, w - 1)
            return image[y0:y1, x0:x1]
        return image

    # ---------------------------------------------------------------------- recall ----
    def recall(
        self,
        query: str,
        top_k: int = 8,
        time_range: TimeRange | None = None,
        near: tuple[float, float] | None = None,
    ) -> list[PhotoHit]:
        return list(self.recall_context(query, top_k, time_range, near).items)

    def recall_context(
        self,
        query: str,
        top_k: int = 8,
        time_range: TimeRange | None = None,
        near: tuple[float, float] | None = None,
    ) -> PhotoRecallContext:
        """Root-aggregated constraint recall (reference: recall :221-415): child hits
        group under their root asset, evidence lanes union, summaries are built from
        caption + OCR + tags under the per-item token budget."""
        embedding = None
        if self.mm_embedder is not None:
            embedding = np.asarray(self.mm_embedder.embed_text(query), np.float32).tolist()
        resp = self.inner.search(
            SearchRequest(
                query=query,
                embedding=embedding,
                top_k=max(top_k * 3, self.config.search_top_k),
                time_range=time_range,
            )
        )
        want_bin = gps_bin(*near) if near is not None else None

        # group child hits by root (reference: candidates by rootId :277-310)
        by_root: dict[int, dict] = {}
        for h in resp.hits:
            m = self.inner.store.frame_meta(h.frame_id)
            if m is None or not m.kind.startswith("wax.photo."):
                continue
            if want_bin is not None and want_bin not in m.tags:
                continue
            root_id = m.parent_id if m.parent_id is not None else h.frame_id
            root_meta = (
                m if root_id == h.frame_id else self.inner.store.frame_meta(root_id)
            )
            if root_meta is None or root_meta.status == "deleted" or root_meta.superseded_by:
                continue
            entry = by_root.setdefault(
                root_id,
                {
                    "score": h.score,
                    "best": (h.frame_id, m.kind),
                    "evidence": [],
                    "regions": [],
                    "root_meta": root_meta,
                },
            )
            entry["score"] = max(entry["score"], h.score)
            for src in h.sources:
                ev = {
                    LaneSource.VECTOR: "vector",
                    LaneSource.BM25: "text",
                    LaneSource.TEMPORAL: "timeline",
                    LaneSource.STRUCTURED: "structured",
                }.get(src)
                if ev and ev not in entry["evidence"]:
                    entry["evidence"].append(ev)
            if m.kind == PHOTO_REGION_KIND and "bbox" in m.metadata:
                entry["regions"].append(
                    PhotoRegion(
                        bbox=_parse_bbox(m.metadata["bbox"]),
                        crop_ref=m.metadata.get("crop_ref"),
                        region_type=m.metadata.get("region_type", "ocr"),
                    )
                )
                if "region" not in entry["evidence"]:
                    entry["evidence"].append("region")

        ranked = sorted(
            by_root.items(), key=lambda kv: (-kv[1]["score"], kv[0])
        )[:top_k]

        # per-item token budget over the summaries (reference: :391-404)
        from wax_tpu_torch.text.token_counter import TokenCounter

        tc = TokenCounter.shared()
        per_item = max(1, self.config.max_text_tokens // max(1, len(ranked) or 1))
        used = 0
        items: list[PhotoHit] = []
        for root_id, entry in ranked:
            root_meta = entry["root_meta"]
            asset_id = root_meta.metadata.get("asset_id", "")
            summary = self._summary_for_root(root_id)
            summary = tc.truncate(summary, per_item)
            tokens = tc.count(summary)
            if used + tokens > self.config.max_text_tokens:
                break
            used += tokens
            best_fid, best_kind = entry["best"]
            raw = self.inner.store.frame_content(best_fid) or b""
            items.append(
                PhotoHit(
                    asset_id=asset_id,
                    score=entry["score"],
                    frame_id=best_fid,
                    kind=best_kind,
                    text=raw.decode("utf-8", errors="ignore"),
                    taken_at_ms=root_meta.timestamp_ms,
                    gps=root_meta.metadata.get("gps"),
                    thumbnail_ref=root_meta.metadata.get("thumbnail_ref"),
                    summary=summary,
                    evidence=tuple(entry["evidence"]),
                    regions=tuple(entry["regions"]),
                )
            )
        return PhotoRecallContext(items=tuple(items), used_text_tokens=used)

    def _summary_for_root(self, root_id: int) -> str:
        """caption + capped OCR lines + tags (reference: buildSummaryText :1080-1131)."""
        parts: list[str] = []
        ocr_lines: list[str] = []
        for m in self.inner.store.timeline(include_superseded=False):
            if m.parent_id != root_id:
                continue
            raw = self.inner.store.frame_content(m.frame_id)
            text = raw.decode("utf-8", errors="ignore") if raw else ""
            if m.kind == PHOTO_CAPTION_KIND and text:
                parts.insert(0, text)
            elif m.kind == PHOTO_OCR_KIND and text:
                ocr_lines = text.splitlines()[: self.config.max_ocr_lines_per_item]
            elif m.kind == PHOTO_TAGS_KIND and text:
                parts.append(f"tags: {text}")
        if ocr_lines:
            parts.insert(min(1, len(parts)), "text in photo: " + " / ".join(ocr_lines))
        return "\n".join(parts)

    def flush(self) -> int:
        return self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _TextTowerAdapter:
    """EmbeddingProvider view of a multimodal provider's text tower."""

    def __init__(self, mm: MultimodalEmbeddingProvider):
        self._mm = mm

    @property
    def dimensions(self) -> int:
        return self._mm.dimensions

    @property
    def identity(self) -> str:
        return f"text-tower/{self._mm.identity}"

    @property
    def normalized(self) -> bool:
        return True

    @property
    def execution_mode(self) -> str:
        from wax_tpu_torch.embed.provider import ExecutionMode

        return ExecutionMode.ON_DEVICE_ONLY

    @property
    def batch_size(self) -> int:
        return 256

    def embed(self, text: str) -> np.ndarray:
        v = np.asarray(self._mm.embed_text(text), np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed_batch(self, texts):
        return np.stack([self.embed(t) for t in texts])
