# Verbatim copy of wax_tpu/storage/compression.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Payload compression codecs: zlib (stdlib) + LZ4 block (native C++).

Mirrors the reference's compression layer (reference:
Sources/WaxCore/Compression/PayloadCompressor.swift:11-60 + CompressionKind.swift —
LZ4/zlib-deflate with a store-smaller-only policy; C shims on Linux,
WaxCoreCompressionC). Encoding ids are persisted per frame (store.py).
"""
from __future__ import annotations

import ctypes
import zlib

from wax_tpu_torch.native.build import load_library

__all__ = ["compress", "decompress", "lz4_available", "ENC_RAW", "ENC_ZLIB", "ENC_LZ4"]

ENC_RAW = 0
ENC_ZLIB = 1
ENC_LZ4 = 2


def lz4_available() -> bool:
    return load_library() is not None


def lz4_compress(data: bytes) -> bytes:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cap = int(lib.wax_lz4_bound(len(data)))
    out = (ctypes.c_uint8 * cap)()
    n = lib.wax_lz4_compress(data, len(data), out, cap)
    if n < 0:
        raise ValueError("lz4 compression failed")
    return bytes(bytearray(out)[:n])


def lz4_decompress(data: bytes, decompressed_size: int) -> bytes:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = (ctypes.c_uint8 * decompressed_size)()
    n = lib.wax_lz4_decompress(data, len(data), out, decompressed_size)
    if n < 0:
        raise ValueError("malformed lz4 data")
    return bytes(bytearray(out)[:n])


def compress(data: bytes, codec: str = "zlib", min_size: int = 64) -> tuple[bytes, int]:
    """Store-smaller-only compression; returns (payload, encoding id).

    LZ4 payloads carry a 4-byte LE decompressed-size header (block format does not
    encode it)."""
    if codec == "none" or len(data) <= min_size:
        return data, ENC_RAW
    if codec == "zlib":
        z = zlib.compress(data, 6)
        return (z, ENC_ZLIB) if len(z) < len(data) else (data, ENC_RAW)
    if codec == "lz4":
        if not lz4_available():
            return compress(data, "zlib", min_size)
        body = lz4_compress(data)
        framed = len(data).to_bytes(4, "little") + body
        return (framed, ENC_LZ4) if len(framed) < len(data) else (data, ENC_RAW)
    raise ValueError(f"unknown codec {codec!r}")


def decompress(payload: bytes, encoding: int) -> bytes:
    if encoding == ENC_RAW:
        return payload
    if encoding == ENC_ZLIB:
        return zlib.decompress(payload)
    if encoding == ENC_LZ4:
        size = int.from_bytes(payload[:4], "little")
        return lz4_decompress(payload[4:], size)
    raise ValueError(f"unknown payload encoding {encoding}")
