# Verbatim copy of wax_tpu/rag/context.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""RAG context value types (reference: Sources/Wax/RAG/RAGContext.swift — ordered
items {kind: expanded/surrogate/snippet, frameId, score, sources, text})."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class RAGItemKind(str, enum.Enum):
    EXPANDED = "expanded"
    SURROGATE = "surrogate"
    SNIPPET = "snippet"


@dataclass(frozen=True)
class RAGItem:
    kind: RAGItemKind
    frame_id: int
    score: float
    text: str
    token_count: int
    sources: tuple[str, ...] = ()


@dataclass(frozen=True)
class RAGContext:
    items: tuple[RAGItem, ...]
    total_tokens: int
    query: str
    budget_tokens: int
    diagnostics: dict = field(default_factory=dict)

    def render(self, separator: str = "\n\n") -> str:
        """Deterministic flat rendering for prompt assembly."""
        return separator.join(item.text for item in self.items)
