# Verbatim copy of wax_tpu/embed/provider.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Embedding provider protocols.

Mirrors the reference's provider contracts (reference:
Sources/WaxVectorSearch/Embeddings/EmbeddingProvider.swift:4-44 — dimensions, identity,
L2-normalization flag, on-device execution gate, single + batch embed). The framework is
written against these protocols; the bundled providers are the deterministic hash
embedder (offline default / test fake) and the JAX MiniLM-architecture encoder.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np


class ExecutionMode:
    ON_DEVICE_ONLY = "on_device_only"
    MAY_USE_NETWORK = "may_use_network"


@runtime_checkable
class EmbeddingProvider(Protocol):
    """Single-text embedding provider."""

    @property
    def dimensions(self) -> int: ...

    @property
    def identity(self) -> str:
        """Stable identity string — part of embedding-cache keys and snapshot manifests."""
        ...

    @property
    def normalized(self) -> bool: ...

    @property
    def execution_mode(self) -> str: ...

    def embed(self, text: str) -> np.ndarray: ...


@runtime_checkable
class BatchEmbeddingProvider(EmbeddingProvider, Protocol):
    """Batched variant — the TPU-preferred entry (one jitted forward per batch)."""

    @property
    def batch_size(self) -> int: ...

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray: ...


def validate_on_device(provider: EmbeddingProvider, require_on_device: bool) -> None:
    """Policy gate mirroring the reference's ProviderValidation
    (Sources/Wax/Utilities/ — reject network-capable providers when the orchestrator
    is configured offline-only)."""
    if require_on_device and provider.execution_mode != ExecutionMode.ON_DEVICE_ONLY:
        raise ValueError(
            f"provider {provider.identity!r} may use the network but the orchestrator "
            "requires on-device-only providers"
        )
