# Verbatim copy of wax_tpu/text/wordpiece.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""BERT-style WordPiece tokenizer.

Mirrors the reference's BertTokenizer capability (reference:
Sources/WaxVectorSearchMiniLM/CoreML/BertTokenizer.swift:39-440 — WordPiece vocab,
batch input building, adaptive sequence-length selection) without shipping a vocab
file: when a `vocab.txt` is available it is loaded; offline, a deterministic hashed
fallback maps word pieces into the BERT vocab id range so the encoder architecture can
run (and be trained) end-to-end with stable ids.
"""
from __future__ import annotations

import hashlib
import re
import unicodedata
from pathlib import Path

import numpy as np

__all__ = ["WordPieceTokenizer"]

_BASIC_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)


def _basic_normalize(text: str) -> str:
    """HF-BERT-uncased basic normalization: lowercase, NFD accent stripping, and
    control-char removal (tab/newline/CR count as whitespace, as in
    BasicTokenizer._clean_text). CJK chars then fall out of _BASIC_RE one char at a
    time — the same per-character treatment BERT's CJK spacing produces."""
    text = unicodedata.normalize("NFD", text.lower())
    out = []
    for c in text:
        cat = unicodedata.category(c)
        if cat == "Mn":  # combining accent
            continue
        if cat.startswith("C") and c not in ("\t", "\n", "\r"):
            continue
        out.append(c)
    return "".join(out)

CLS_ID = 101
SEP_ID = 102
PAD_ID = 0
UNK_ID = 100
_HASH_BASE = 1000  # hashed fallback ids live in [1000, vocab_size)


class WordPieceTokenizer:
    def __init__(self, vocab_path: str | Path | None = None, vocab_size: int = 30522, max_len: int = 512):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.vocab: dict[str, int] | None = None
        if vocab_path and Path(vocab_path).exists():
            self.vocab = {}
            for i, line in enumerate(Path(vocab_path).read_text().splitlines()):
                self.vocab[line.strip()] = i
            self.vocab_size = max(vocab_size, len(self.vocab))
        # word -> piece-ids memo: words repeat heavily across a corpus, and both the
        # greedy-longest-match loop and the hashed fallback's per-piece sha256 are
        # the tokenize hot path (ingest is tokenizer-bound on slow hosts)
        self._word_cache: dict[str, list[int]] = {}

    @property
    def using_real_vocab(self) -> bool:
        return self.vocab is not None

    def _hash_id(self, piece: str) -> int:
        h = int.from_bytes(hashlib.sha256(piece.encode()).digest()[:4], "little")
        base = min(_HASH_BASE, self.vocab_size // 2)
        return base + h % max(1, self.vocab_size - base)

    def _wordpiece(self, word: str) -> list[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        out = self._wordpiece_uncached(word)
        if len(self._word_cache) < 65536:
            self._word_cache[word] = out
        return out

    def _wordpiece_uncached(self, word: str) -> list[int]:
        if self.vocab is None:
            # hashed fallback: split long words into 4-char pieces (##-prefixed tail)
            pieces = [word[:6]] + [f"##{word[i:i+4]}" for i in range(6, len(word), 4)]
            return [self._hash_id(p) for p in pieces]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.vocab.get("[UNK]", UNK_ID)]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        max_len = max_len or self.max_len
        toks: list[int] = [CLS_ID]
        for w in _BASIC_RE.findall(_basic_normalize(text)):
            toks.extend(self._wordpiece(w))
            if len(toks) >= max_len - 1:
                break
        toks = toks[: max_len - 1]
        toks.append(SEP_ID)
        return toks

    def encode_batch(self, texts: list[str], max_len: int | None = None):
        """Batch encode with adaptive sequence length (shortest power-of-two-ish bucket
        covering the batch, mirroring BertTokenizer.swift:415), padded with PAD_ID.

        Returns (ids [B, L] int32, mask [B, L] int32).
        """
        max_len = max_len or self.max_len
        encoded = [self.encode(t, max_len) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        buckets = [16, 32, 64, 128, 256, 384, 512]
        length = next((b for b in buckets if b >= longest and b <= max_len), max_len)
        ids = np.full((len(texts), length), PAD_ID, np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask
