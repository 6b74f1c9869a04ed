# Verbatim copy of wax_tpu/text/bpe.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Native byte-pair-encoding engine (cl100k_base-compatible).

The reference treats exact cl100k_base token counts as a correctness contract for its
token-budgeted RAG assembly and ships its own heap-based BPE next to swift-tiktoken
(reference: Sources/Wax/RAG/NativeBpeTokenizer.swift:5-225, TokenCounter.swift:6-460).
This module is our own implementation of the same public algorithm: the standard
tiktoken-format vocab (base64 token + rank per line) + the published cl100k
pre-tokenization regex + greedy lowest-rank pair merging.

The vocab *data file* is public OpenAI-published data and is not shipped in-repo; it is
discovered at runtime (env `WAX_TPU_CL100K`, the tiktoken cache, or any configured
path). Without it, a deterministic byte-level fallback provides stable counts (roughly
1 token per 4 bytes) so budgeting still works offline — flagged via `exact`.
"""
from __future__ import annotations

import base64
import os
from pathlib import Path

__all__ = ["BpeEncoder", "find_cl100k_vocab", "load_cl100k"]

# Published cl100k_base pre-tokenization pattern (public constant from the tiktoken
# project); requires the `regex` module for \p classes and possessive quantifiers.
_CL100K_PATTERN = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}"""
    r"""| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""
)

_SPECIAL_TOKENS = {
    "<|endoftext|>": 100257,
    "<|fim_prefix|>": 100258,
    "<|fim_middle|>": 100259,
    "<|fim_suffix|>": 100260,
    "<|endofprompt|>": 100276,
}


# Vendored public vocab data (the reference likewise ships it:
# Sources/Wax/RAG/Resources/cl100k_base.tiktoken). Exact token counts are a
# correctness contract — budgets must not silently degrade to the byte fallback.
_VENDORED_VOCAB = Path(__file__).parent / "resources" / "cl100k_base.tiktoken.gz"


def find_cl100k_vocab() -> Path | None:
    """Locate a cl100k_base.tiktoken vocab data file (vendored copy first)."""
    candidates: list[Path] = []
    env = os.environ.get("WAX_TPU_CL100K")
    if env:
        candidates.append(Path(env))
    candidates.append(_VENDORED_VOCAB)
    for cache_root in (
        os.environ.get("TIKTOKEN_CACHE_DIR"),
        os.path.expanduser("~/.cache/tiktoken"),
        "/tmp/data-gym-cache",
    ):
        if cache_root and Path(cache_root).is_dir():
            candidates.extend(Path(cache_root).glob("*"))
    for c in candidates:
        try:
            if not c.is_file():
                continue
            if c.suffix == ".gz":
                import gzip

                head_bytes = gzip.open(c, "rb").read(64)
                if c.stat().st_size < 100_000:
                    continue
            else:
                if c.stat().st_size < 1_000_000:
                    continue
                head_bytes = c.read_bytes()[:64]
            head = head_bytes.split(b"\n")[0].split()
            if len(head) == 2:
                base64.b64decode(head[0], validate=True)
                int(head[1])
                return c
        except Exception:  # noqa: BLE001
            continue
    return None


class BpeEncoder:
    """Greedy BPE over a rank table, with the cl100k pre-tokenizer when available."""

    def __init__(self, ranks: dict[bytes, int], pattern: str | None = _CL100K_PATTERN, name: str = "cl100k_base"):
        self.name = name
        self.ranks = ranks
        self.exact = pattern is not None and len(ranks) > 256
        self._decode_map = {v: k for k, v in ranks.items()}
        if pattern is not None:
            import regex

            self._pat = regex.compile(pattern)
        else:
            self._pat = None
        # native merge core (reference keeps BPE native — NativeBpeTokenizer.swift);
        # built lazily on first encode so import stays cheap, Python loop otherwise
        self._native = None
        self._native_tried = False
        # piece -> ids memo: BPE merges are context-free per regex piece, so
        # repeated words across a corpus skip the merge (and the FFI round-trip)
        # entirely. Natural-language piece vocab is ~50K; the cap only guards
        # adversarial streams (cleared, not evicted — refills in one batch).
        self._piece_memo: dict[str, list[int]] = {}
        self._piece_memo_cap = 131072

    # -- construction -----------------------------------------------------------------
    @classmethod
    def from_tiktoken_file(cls, path: str | Path) -> "BpeEncoder":
        path = Path(path)
        if path.suffix == ".gz":
            import gzip

            raw = gzip.open(path, "rb").read()
        else:
            raw = path.read_bytes()
        ranks: dict[bytes, int] = {}
        for line in raw.splitlines():
            if not line:
                continue
            tok_b64, rank = line.split()
            ranks[base64.b64decode(tok_b64)] = int(rank)
        return cls(ranks)

    @classmethod
    def byte_fallback(cls) -> "BpeEncoder":
        """Deterministic offline fallback: 256 byte tokens, greedy 4-byte grouping.

        Counts are stable and subadditive; `exact` is False so callers can surface
        that budgets are approximate relative to cl100k.
        """
        ranks = {bytes([i]): i for i in range(256)}
        return cls(ranks, pattern=None, name="byte-fallback")

    # -- encoding ---------------------------------------------------------------------
    def _native_handle(self):
        """Build (once) the C++ merge table; None when the toolchain is unavailable."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        if not self.exact:
            return None
        try:
            import ctypes

            import numpy as np

            from wax_tpu_torch.native.build import load_library

            lib = load_library()
            if lib is None or not hasattr(lib, "wax_bpe_create"):
                return None
            lib.wax_bpe_create.restype = ctypes.c_void_p
            lib.wax_bpe_create.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
            ]
            lib.wax_bpe_encode_piece.restype = ctypes.c_int32
            lib.wax_bpe_encode_piece.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            if hasattr(lib, "wax_bpe_encode_batch_counts"):
                lib.wax_bpe_encode_batch_counts.restype = ctypes.c_int32
                lib.wax_bpe_encode_batch_counts.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int32),
                ]
            keys = list(self.ranks.items())
            blob = b"".join(k for k, _ in keys)
            lens = np.asarray([len(k) for k, _ in keys], np.int32)
            rks = np.asarray([r for _, r in keys], np.int32)
            handle = lib.wax_bpe_create(
                blob,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                rks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(keys),
            )
            if handle:
                self._native = (lib, ctypes.c_void_p(handle), ctypes)
        except Exception:  # noqa: BLE001 — any toolchain issue falls back to Python
            self._native = None
        return self._native

    def _encode_pieces_native(self, pieces: list[bytes], native) -> list[list[int]] | None:
        """Merge the given pieces in one C++ call (FFI amortized), returning the
        per-piece id lists (the counts out-array carries the boundaries)."""
        import numpy as np

        lib, handle, ctypes_mod = native
        if not hasattr(lib, "wax_bpe_encode_batch_counts"):
            return None
        blob = b"".join(pieces)
        lens = np.asarray([len(p) for p in pieces], np.int32)
        buf = np.empty(max(16, len(blob) + 8), np.int32)
        counts = np.empty(len(pieces), np.int32)
        i32p = ctypes_mod.POINTER(ctypes_mod.c_int32)
        n = lib.wax_bpe_encode_batch_counts(
            handle,
            blob,
            lens.ctypes.data_as(i32p),
            len(pieces),
            buf.ctypes.data_as(i32p),
            len(buf),
            counts.ctypes.data_as(i32p),
        )
        if n < 0:
            return None
        ids = buf[:n].tolist()
        out: list[list[int]] = []
        pos = 0
        for c in counts.tolist():
            out.append(ids[pos : pos + c])
            pos += c
        return out

    def _piece_ids_python(self, piece: bytes) -> list[int]:
        r = self.ranks.get(piece)
        return [r] if r is not None else self._merge_piece(piece)

    def _merge_piece(self, piece: bytes) -> list[int]:
        if len(piece) == 1:
            return [self.ranks[piece]]
        parts = [bytes([b]) for b in piece]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            r = self.ranks.get(p)
            if r is None:
                out.extend(self.ranks[bytes([b])] for b in p)
            else:
                out.append(r)
        return out

    def encode(self, text: str) -> list[int]:
        if self._pat is not None:
            memo = self._piece_memo
            pieces = [m.group() for m in self._pat.finditer(text)]
            parts = [memo.get(p) for p in pieces]
            # dedupe misses: one FFI merge per UNIQUE unseen piece, not per occurrence
            miss = list(dict.fromkeys(p for p, ids in zip(pieces, parts) if ids is None))
            if miss:
                miss_b = [p.encode("utf-8") for p in miss]
                native = self._native_handle()
                id_lists = self._encode_pieces_native(miss_b, native) if native else None
                if id_lists is None:
                    id_lists = [self._piece_ids_python(b) for b in miss_b]
                fill = dict(zip(miss, id_lists))
                if len(memo) >= self._piece_memo_cap:
                    memo.clear()
                # length-bound keys: pieces beyond ~64 chars barely repeat (base64
                # blobs, long URLs) and would let the memo pin unbounded host RAM
                memo.update((p, ids) for p, ids in fill.items() if len(p) <= 64)
                parts = [ids if ids is not None else fill[p] for p, ids in zip(pieces, parts)]
            data: list[int] = []
            for ids in parts:
                data.extend(ids)
            return data
        # byte fallback: 1 token per 4 bytes, deterministic
        raw = text.encode("utf-8")
        data = []
        for i in range(0, len(raw), 4):
            data.append(raw[i])
        return data

    def decode(self, ids: list[int]) -> str:
        if self._pat is None:
            raise NotImplementedError("byte-fallback encoder cannot decode")
        return b"".join(self._decode_map.get(i, b"") for i in ids).decode("utf-8", errors="replace")

    def count(self, text: str) -> int:
        return len(self.encode(text))


_cached: BpeEncoder | None = None


def load_cl100k() -> BpeEncoder:
    """Process-wide encoder: exact cl100k if the vocab file exists, else fallback."""
    global _cached
    if _cached is None:
        path = find_cl100k_vocab()
        _cached = BpeEncoder.from_tiktoken_file(path) if path else BpeEncoder.byte_fallback()
    return _cached
