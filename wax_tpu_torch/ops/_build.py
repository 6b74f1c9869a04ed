"""Build and load the port's CUDA kernels, and the helpers every kernel wrapper uses.

Every `wax_tpu_torch/csrc/*.cu` source is compiled with nvcc for `sm_90a` into an
object file, all sources at once in parallel, and the objects are linked into one
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

import torch

__all__ = ["build", "load_library", "library_path", "on_cpu", "launch"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every kernel entry: (argument types); each returns a cudaError_t.
_SIGNATURES = {
    "wax_k1_packed_sel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "wax_k2_scan_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "wax_k3_rescore_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wax_k4_chunked_sel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wax_k5_rescore_split": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "wax_k6_chunk_maxima": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wax_k7_bucket_rescore": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wax_k8_candidates": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wax_k9_packed_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}
# entries that launch nothing: (argument types); each returns a cudaError_t.
_QUERIES = {
    "wax_k4_plan": [_P],
    "wax_k3k5_plan": [_I, _I, _I, _I, _P],
    "wax_k6_mma_plan": [_I, _I, _P],
    "wax_k7_plan": [_I, _I, _I, _I, _P],
    "wax_flat_scan_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
}


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
    """Compile the library unless this source hash is already built: one nvcc per
    source, all started together, then one link.

    Returns (path, seconds spent compiling, nvcc's output). Raises on failure."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = _BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log += f"$ {' '.join(cmd)}\n{text}"
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = [nvcc, *_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            failed.append(f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
            for name, args in {**_SIGNATURES, **_QUERIES}.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, _I
            lib.wax_cuda_error_string.argtypes = [_I]
            lib.wax_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version runs), False for tensors on one CUDA
    device (the kernel runs); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {kinds}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry `name` with `args` on the current stream of `device`; raise
    with CUDA's message if the launch failed."""
    lib = load_library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        msg = lib.wax_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
