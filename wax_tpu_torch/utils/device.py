"""Where the port's entry points put their tensors.

Every entry point (`MiniLMEmbedder`, `DenseIndexBuilder.snapshot`,
`LexIndexBuilder.snapshot`, `FlatVectorEngine`, `HybridSearchEngine`) takes
`device=None`, which means the current CUDA device. Without a card that default
raises instead of falling back to the CPU; a CPU run is asked for explicitly with
`device="cpu"`.

`resolve_devices` does the same for the device meshes of the sharded programs: a
device, a sequence of devices, or None for every visible CUDA device.

`f32_products` (and its decorator form `full_f32_matmul`) keeps the port's f32
products in f32 on the card when a process turns TF32 on.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

__all__ = ["resolve_device", "resolve_devices", "f32_products", "full_f32_matmul"]

_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = False


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device` as a torch.device; None is the current CUDA device and raises
    RuntimeError when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: wax_tpu_torch runs on the GPU by default; pass device='cpu' "
            "to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device without an index names the current one."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_devices(device) -> tuple[torch.device, ...]:
    """`device` as a tuple of torch.devices: a device (or its name) gives one, a
    sequence gives each in order (repeats allowed: logical shards on one device), and
    None gives every visible CUDA device, raising RuntimeError when there is none. A
    sequence that is empty or mixes CPU and CUDA devices raises ValueError."""
    if device is None:
        resolve_device(None)  # raises without a card
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if isinstance(device, (str, torch.device)):
        return (_indexed(torch.device(device)),)
    devs = tuple(_indexed(torch.device(d)) for d in device)
    if not devs:
        raise ValueError("a device mesh needs at least one device")
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu", "cuda"):
        raise ValueError(f"a device mesh holds CPU devices or CUDA devices, not {sorted({d.type for d in devs})}")
    return devs


@contextlib.contextmanager
def f32_products(active: bool = True):
    """Within the block, f32 matrix products run in full f32 whatever the process-wide
    TF32 setting (`torch.backends.cuda.matmul.allow_tf32`, which a caller may turn on
    and which makes cuBLAS round f32 operands to TF32's 10-bit mantissa); with `active`
    false the block runs as it is. The setting is process-wide: the first of
    overlapping blocks (any thread) turns it off, the last restores it, and other
    threads' f32 products meanwhile also run in f32. Callers must not change
    `allow_tf32` while such blocks can run (an orchestrator serving searches): a
    setting made meanwhile is undone when the last one ends."""
    if not active:
        yield
        return
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = _f32_saved


def full_f32_matmul(fn):
    """Decorator: run `fn` inside `f32_products` when one of its tensor arguments lies
    on a CUDA device; on CPU tensors `fn` runs as it is."""

    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with f32_products(any(isinstance(a, torch.Tensor) and a.is_cuda for a in (*args, *kwargs.values()))):
            return fn(*args, **kwargs)

    return pinned
