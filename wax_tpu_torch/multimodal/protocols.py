# Verbatim copy of wax_tpu/multimodal/protocols.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Multimodal provider protocols.

Mirrors the reference's host-supplied provider contracts (reference:
Sources/Wax/PhotoRAG/PhotoRAGProtocols.swift:28-56 — OCR and caption providers;
Sources/Wax/VideoRAG/VideoRAGProtocols.swift:36-44 — transcript provider;
Sources/Wax/MultimodalEmbeddingProvider.swift:10-32 — text + image-pixels embedding).
OS-specific implementations (Apple Vision OCR, PHAsset access, AVFoundation) stay
host-supplied; the framework contract is these protocols plus deterministic test
stubs (tests/test_multimodal.py), exactly as in the reference's mock suite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = [
    "OCRBlock",
    "TranscriptSpan",
    "ImageRegion",
    "OCRProvider",
    "CaptionProvider",
    "TranscriptProvider",
    "MultimodalEmbeddingProvider",
]


@dataclass(frozen=True)
class OCRBlock:
    text: str
    # normalized [0,1] bounding box (x, y, w, h)
    bbox: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    confidence: float = 1.0


@dataclass(frozen=True)
class TranscriptSpan:
    start_ms: int
    end_ms: int
    text: str


@dataclass(frozen=True)
class ImageRegion:
    label: str
    bbox: tuple[float, float, float, float]
    confidence: float = 1.0


@runtime_checkable
class OCRProvider(Protocol):
    def ocr(self, image: np.ndarray | bytes | str) -> Sequence[OCRBlock]: ...


@runtime_checkable
class CaptionProvider(Protocol):
    def caption(self, image: np.ndarray | bytes | str) -> str: ...


@runtime_checkable
class TranscriptProvider(Protocol):
    def transcript(self, video_ref: str) -> Sequence[TranscriptSpan]: ...


@runtime_checkable
class MultimodalEmbeddingProvider(Protocol):
    """CLIP-style joint text/image embedding space."""

    @property
    def dimensions(self) -> int: ...

    @property
    def identity(self) -> str: ...

    def embed_text(self, text: str) -> np.ndarray: ...

    def embed_image(self, image: np.ndarray | bytes | str) -> np.ndarray: ...
