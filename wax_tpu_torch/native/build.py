# Copy of wax_tpu/native/build.py with one change: the library is built into
# wax_tpu_torch/_build/native/ (git-ignored) from this package's copies of the C++
# sources, not next to them. Keep the two in step.
"""Native library build + load: compiles the C++ sources once, caches the .so.

The reference leans on native engines for its host-side hot paths (USearch C++ HNSW,
SQLite FTS5 C, C compression shims — SURVEY.md §2); here the native layer is built
from the checked-in C++ sources with the system toolchain on first use and cached
next to the package (or WAX_TPU_NATIVE_DIR). Loading falls back gracefully: callers
check `load_library() is not None` and use the pure-Python implementation otherwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["load_library", "native_available"]

_SRC_DIR = Path(__file__).parent
_SOURCES = ["hnsw.cpp", "lz4.cpp", "bpe.cpp"]
_LIB_BASENAME = "libwaxnative"

_loaded: ctypes.CDLL | None = None
_load_failed = False


def _cache_dir() -> Path:
    env = os.environ.get("WAX_TPU_NATIVE_DIR")
    if env:
        return Path(env)
    return _SRC_DIR.parent / "_build" / "native"


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> None:
    """Two-step build: objects get fast-math (vectorized reductions), the LINK does
    not — linking with -ffast-math pulls in crtfastmath.o, which flips the process
    into flush-to-zero/denormals-are-zero mode at dlopen and silently breaks IEEE
    subnormals for the whole host (numpy, hypothesis, jax callbacks)."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    compile_flags = ["-O3", "-march=native", "-ffast-math", "-funroll-loops", "-std=c++17", "-fPIC"]
    objs = []
    for s in _SOURCES:
        obj = lib_path.parent / (Path(s).stem + ".o")
        subprocess.run(
            ["g++", *compile_flags, "-c", "-o", str(obj), str(_SRC_DIR / s)],
            check=True,
            capture_output=True,
            timeout=300,
        )
        objs.append(str(obj))
    subprocess.run(
        ["g++", "-shared", "-o", str(lib_path), *objs],
        check=True,
        capture_output=True,
        timeout=300,
    )
    for o in objs:
        os.unlink(o)


def load_library() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _loaded, _load_failed
    if _loaded is not None:
        return _loaded
    if _load_failed or os.environ.get("WAX_TPU_DISABLE_NATIVE") == "1":
        return None
    lib_path = _cache_dir() / f"{_LIB_BASENAME}-{_source_digest()}.so"
    try:
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _configure(lib)
        _loaded = lib
        return lib
    except Exception:  # noqa: BLE001 — any toolchain failure => pure-Python fallback
        _load_failed = True
        return None


def native_available() -> bool:
    return load_library() is not None


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.wax_lz4_bound.restype = c.c_int64
    lib.wax_lz4_bound.argtypes = [c.c_int64]
    lib.wax_lz4_compress.restype = c.c_int64
    lib.wax_lz4_compress.argtypes = [c.c_char_p, c.c_int64, c.POINTER(c.c_uint8), c.c_int64]
    lib.wax_lz4_decompress.restype = c.c_int64
    lib.wax_lz4_decompress.argtypes = [c.c_char_p, c.c_int64, c.POINTER(c.c_uint8), c.c_int64]
    lib.wax_hnsw_create.restype = c.c_void_p
    lib.wax_hnsw_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int]
    lib.wax_hnsw_free.argtypes = [c.c_void_p]
    lib.wax_hnsw_add.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_float)]
    lib.wax_hnsw_add_batch.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_float)]
    lib.wax_hnsw_remove.restype = c.c_int
    lib.wax_hnsw_remove.argtypes = [c.c_void_p, c.c_int64]
    lib.wax_hnsw_count.restype = c.c_int64
    lib.wax_hnsw_count.argtypes = [c.c_void_p]
    lib.wax_hnsw_live.restype = c.c_int64
    lib.wax_hnsw_live.argtypes = [c.c_void_p]
    lib.wax_hnsw_contains.restype = c.c_int
    lib.wax_hnsw_contains.argtypes = [c.c_void_p, c.c_int64]
    lib.wax_hnsw_generation.restype = c.c_int64
    lib.wax_hnsw_generation.argtypes = [c.c_void_p]
    lib.wax_hnsw_set_extend_candidates.argtypes = [c.c_void_p, c.c_int]
    lib.wax_hnsw_search_batch.argtypes = [
        c.c_void_p,
        c.c_int64,
        c.POINTER(c.c_float),
        c.c_int,
        c.c_int,
        c.POINTER(c.c_int64),
    ]
    lib.wax_hnsw_edge_count.restype = c.c_int64
    lib.wax_hnsw_edge_count.argtypes = [c.c_void_p]
    lib.wax_hnsw_export.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_float),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int64),
    ]
    lib.wax_hnsw_import.argtypes = [
        c.c_void_p,
        c.c_int64,
        c.POINTER(c.c_float),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32),
        c.c_int64,
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int64),
    ]
