# Verbatim copy of wax_tpu/text/chunker.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Token-aware text chunking with overlap.

Mirrors the reference's TextChunker (reference: Sources/Wax/Ingest/TextChunker.swift:6-134
— cl100k token-target chunks with overlap, streaming variant; defaults 400/40 from
OrchestratorConfig.swift:11). Chunk boundaries prefer sentence/paragraph breaks inside
a tolerance window so chunks stay semantically coherent.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator

from wax_tpu_torch.text.token_counter import TokenCounter

__all__ = ["Chunk", "ChunkingStrategy", "chunk_text", "chunk_text_stream"]

_SENTENCE_END_RE = re.compile(r"[.!?]\s|\n\n|\n")


@dataclass(frozen=True)
class Chunk:
    text: str
    index: int
    token_count: int
    start_char: int


@dataclass(frozen=True)
class ChunkingStrategy:
    target_tokens: int = 400
    overlap_tokens: int = 40

    def __post_init__(self):
        if self.overlap_tokens >= self.target_tokens:
            raise ValueError("overlap must be smaller than target")


def chunk_text(
    text: str, strategy: ChunkingStrategy = ChunkingStrategy(), counter: TokenCounter | None = None
) -> list[Chunk]:
    return list(chunk_text_stream(text, strategy, counter))


def chunk_text_stream(
    text: str, strategy: ChunkingStrategy = ChunkingStrategy(), counter: TokenCounter | None = None
) -> Iterator[Chunk]:
    """Stream chunks of ~target tokens with ~overlap-token overlap.

    Works on token ids when the encoder is exact (token-faithful boundaries, with a
    preference for cutting at sentence breaks within the last 15% of the window);
    falls back to word-proportional windows otherwise.
    """
    counter = counter or TokenCounter()
    text = text.strip()
    if not text:
        return
    total = counter.count(text)
    if total <= strategy.target_tokens:
        yield Chunk(text=text, index=0, token_count=total, start_char=0)
        return

    if counter.exact:
        ids = counter.encode(text)
        step = strategy.target_tokens - strategy.overlap_tokens
        idx = 0
        pos = 0
        consumed_chars = 0
        while pos < len(ids):
            window = ids[pos : pos + strategy.target_tokens]
            piece = counter.decode(window)
            # prefer a sentence boundary in the tail 15% of the window
            if pos + strategy.target_tokens < len(ids):
                tail_start = int(len(piece) * 0.85)
                tail = piece[tail_start:]
                cut = None
                for m in _SENTENCE_END_RE.finditer(tail):
                    cut = tail_start + m.end()
                if cut:
                    piece = piece[:cut]
                    window = counter.encode(piece)
            yield Chunk(
                text=piece.strip(),
                index=idx,
                token_count=len(window),
                start_char=consumed_chars,
            )
            advance = max(1, len(window) - strategy.overlap_tokens) if len(window) > strategy.overlap_tokens else max(1, step)
            consumed_chars += len(counter.decode(ids[pos : pos + advance]))
            pos += advance
            idx += 1
    else:
        words = text.split()
        # approximate tokens-per-word from the whole text
        tpw = max(total / max(1, len(words)), 0.25)
        win = max(1, int(strategy.target_tokens / tpw))
        step = max(1, int((strategy.target_tokens - strategy.overlap_tokens) / tpw))
        idx = 0
        for start in range(0, len(words), step):
            piece_words = words[start : start + win]
            if not piece_words:
                break
            piece = " ".join(piece_words)
            yield Chunk(
                text=piece,
                index=idx,
                token_count=counter.count(piece),
                start_char=0,
            )
            idx += 1
            if start + win >= len(words):
                break
