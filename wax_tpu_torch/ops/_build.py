"""Build and load the port's CUDA kernels.

Every `wax_tpu_torch/csrc/*.cu` source is compiled with nvcc for `sm_90a` into one
shared library with a plain C interface, which is loaded with ctypes. The build runs
at first use (when a CUDA tensor first reaches a kernel wrapper), lands in
`wax_tpu_torch/_build/`, and is keyed by a hash of the sources and flags, so an edit
rebuilds. Importing this module needs no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load_library", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libwax_torch_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are compiled from "
        "wax_tpu_torch/csrc at first use"
    )


def build() -> tuple[Path, float, str]:
    """Compile the library unless this source hash is already built.

    Returns (path, seconds spent compiling, nvcc's output). Raises on failure."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return out, secs, log


def load_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.wax_k1_packed_sel.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            lib.wax_k1_packed_sel.restype = i
            lib.wax_k2_scan_topk.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
            lib.wax_k2_scan_topk.restype = i
            lib.wax_cuda_error_string.argtypes = [i]
            lib.wax_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
