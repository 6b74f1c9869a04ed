# Verbatim copy of wax_tpu/storage/codec.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Deterministic little-endian binary codec with bounded decode limits.

Mirrors the reference's BinaryEncoder/BinaryDecoder contract (reference:
Sources/WaxCore/BinaryCodec/BinaryEncoder.swift:1-226, BinaryDecoder.swift:1-156;
limits from WaxCore/Constants.swift:47-50 — 16 MiB strings, 256 MiB blobs, 10M array
items, 1M max embedding dims).
"""
from __future__ import annotations

import struct

__all__ = ["BinaryEncoder", "BinaryDecoder", "CodecError", "LIMITS"]


class CodecError(Exception):
    pass


class LIMITS:
    MAX_STRING = 16 * 1024 * 1024
    MAX_BLOB = 256 * 1024 * 1024
    MAX_ARRAY_ITEMS = 10_000_000
    MAX_EMBEDDING_DIMS = 1_000_000


class BinaryEncoder:
    def __init__(self):
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "BinaryEncoder":
        self._parts.append(struct.pack("<B", v))
        return self

    def u32(self, v: int) -> "BinaryEncoder":
        self._parts.append(struct.pack("<I", v))
        return self

    def u64(self, v: int) -> "BinaryEncoder":
        self._parts.append(struct.pack("<Q", v))
        return self

    def i64(self, v: int) -> "BinaryEncoder":
        self._parts.append(struct.pack("<q", v))
        return self

    def f32(self, v: float) -> "BinaryEncoder":
        self._parts.append(struct.pack("<f", v))
        return self

    def f64(self, v: float) -> "BinaryEncoder":
        self._parts.append(struct.pack("<d", v))
        return self

    def boolean(self, v: bool) -> "BinaryEncoder":
        return self.u8(1 if v else 0)

    def string(self, s: str) -> "BinaryEncoder":
        raw = s.encode("utf-8")
        if len(raw) > LIMITS.MAX_STRING:
            raise CodecError("string too long")
        self.u32(len(raw))
        self._parts.append(raw)
        return self

    def opt_string(self, s: str | None) -> "BinaryEncoder":
        self.boolean(s is not None)
        if s is not None:
            self.string(s)
        return self

    def opt_i64(self, v: int | None) -> "BinaryEncoder":
        self.boolean(v is not None)
        if v is not None:
            self.i64(v)
        return self

    def blob(self, b: bytes) -> "BinaryEncoder":
        if len(b) > LIMITS.MAX_BLOB:
            raise CodecError("blob too large")
        self.u64(len(b))
        self._parts.append(bytes(b))
        return self

    def raw(self, b: bytes) -> "BinaryEncoder":
        self._parts.append(bytes(b))
        return self

    def str_map(self, m: dict[str, str]) -> "BinaryEncoder":
        if len(m) > LIMITS.MAX_ARRAY_ITEMS:
            raise CodecError("map too large")
        self.u32(len(m))
        for k in sorted(m):  # deterministic order
            self.string(k).string(m[k])
        return self

    def str_list(self, items: list[str] | tuple[str, ...]) -> "BinaryEncoder":
        if len(items) > LIMITS.MAX_ARRAY_ITEMS:
            raise CodecError("array too large")
        self.u32(len(items))
        for s in items:
            self.string(s)
        return self

    def data(self) -> bytes:
        return b"".join(self._parts)


class BinaryDecoder:
    def __init__(self, data: bytes, offset: int = 0):
        self._d = data
        self._o = offset

    @property
    def offset(self) -> int:
        return self._o

    @property
    def remaining(self) -> int:
        return len(self._d) - self._o

    def _take(self, n: int) -> bytes:
        if self._o + n > len(self._d):
            raise CodecError(f"decode overrun: need {n} bytes, have {self.remaining}")
        b = self._d[self._o : self._o + n]
        self._o += n
        return b

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self._take(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        v = self.u8()
        if v > 1:
            raise CodecError(f"invalid bool byte {v}")
        return v == 1

    def string(self) -> str:
        n = self.u32()
        if n > LIMITS.MAX_STRING:
            raise CodecError("string too long")
        return self._take(n).decode("utf-8")

    def opt_string(self) -> str | None:
        return self.string() if self.boolean() else None

    def opt_i64(self) -> int | None:
        return self.i64() if self.boolean() else None

    def blob(self) -> bytes:
        n = self.u64()
        if n > LIMITS.MAX_BLOB:
            raise CodecError("blob too large")
        return self._take(n)

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def str_map(self) -> dict[str, str]:
        n = self.u32()
        if n > LIMITS.MAX_ARRAY_ITEMS:
            raise CodecError("map too large")
        return {self.string(): self.string() for _ in range(n)}

    def str_list(self) -> list[str]:
        n = self.u32()
        if n > LIMITS.MAX_ARRAY_ITEMS:
            raise CodecError("array too large")
        return [self.string() for _ in range(n)]
