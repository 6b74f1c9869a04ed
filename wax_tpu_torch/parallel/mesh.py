"""The device meshes the sharded programs run on, including the two-level topology.

PyTorch port of `wax_tpu.parallel.mesh`. The JAX package is single-controller SPMD:
one process drives every device through `shard_map` over a named mesh. The port keeps
that model without a process group: a `Mesh` is an ordered tuple of torch.devices
laid out over JAX's axes, ("data",), ("data", "tp"), ("slice", "data") or ("slice",
"data", "tp"), and the sharded programs issue each corpus shard's work from one
Python loop onto its device's current stream, with no host synchronisation inside the
loop, so the devices overlap as JAX's shards do.

Corpus shard s (slice-major over the corpus axes) lives on `shard_devices[s]`, the
shard's first tp device; tp planes replicate the corpus and serve it once. The trainer
splits the encoder's layers over each shard's tp devices (`shard_groups`). A device
may appear more than once: those are logical shards on one device (JAX's tests put 8
virtual CPU devices on one host the same way). With no devices given a mesh holds
every visible CUDA device, as JAX's meshes hold `jax.devices()`, and raises without
one; a mesh mixing CPU and CUDA devices raises.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from wax_tpu_torch.utils.device import resolve_devices

__all__ = [
    "Mesh",
    "make_mesh",
    "data_mesh",
    "make_two_level_mesh",
    "corpus_axes",
    "corpus_shards",
    "shard_rows",
    "replicate",
    "on_device",
]

DATA_AXIS = "data"
MODEL_AXIS = "tp"
SLICE_AXIS = "slice"


@dataclass(frozen=True)
class Mesh:
    """`devices` in row-major order over `axis_names`, whose sizes are `axis_sizes`
    (None: one axis over every device). `devices` may be one device, a sequence, or
    None (every visible CUDA device)."""

    devices: tuple = None
    axis_names: tuple = (DATA_AXIS,)
    axis_sizes: tuple | None = None

    def __post_init__(self):
        devs = resolve_devices(self.devices)
        names = tuple(self.axis_names)
        sizes = (len(devs),) if self.axis_sizes is None else tuple(int(n) for n in self.axis_sizes)
        if len(sizes) != len(names) or math.prod(sizes) != len(devs):
            raise ValueError(f"axes {names} of sizes {sizes} do not lay out {len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device(self) -> torch.device:
        """The lead device: merged results and the fused ranking live here."""
        return self.devices[0]

    @property
    def corpus_shards(self) -> int:
        return math.prod(self.shape[ax] for ax in corpus_axes(self))

    @property
    def shard_devices(self) -> tuple:
        """The device of each corpus shard, in corpus order (slice, then data)."""
        return self.devices[:: self.shape.get(MODEL_AXIS, 1)]

    @property
    def shard_groups(self) -> tuple:
        """Each corpus shard's tp devices, in corpus order: shard s holds
        `devices[s * tp : (s + 1) * tp]` (JAX's device order: slice-major, then data,
        then tp), led by `shard_devices[s]`."""
        tp = self.shape.get(MODEL_AXIS, 1)
        return tuple(self.devices[i : i + tp] for i in range(0, len(self.devices), tp))


def _device_list(devices) -> tuple:
    """An int n takes the first n visible CUDA devices; anything else goes to
    `resolve_devices`."""
    if isinstance(devices, int) and not isinstance(devices, bool):
        return resolve_devices(None)[:devices]
    return resolve_devices(devices)


def make_mesh(devices=None, tp: int = 1) -> Mesh:
    """2-D ("data", "tp") mesh over `devices` (a count of visible CUDA devices, a
    device or a sequence; None: every visible CUDA device). tp must divide the count."""
    devs = _device_list(devices)
    if len(devs) % tp:
        raise ValueError(f"tp={tp} does not divide device count {len(devs)}")
    return Mesh(devs, (DATA_AXIS, MODEL_AXIS), (len(devs) // tp, tp))


def data_mesh(device=None) -> Mesh:
    """1-D corpus-sharding mesh: one shard on a single device, one shard per entry of a
    sequence (or of the first n visible CUDA devices for an int n), every visible CUDA
    device for None."""
    return Mesh(_device_list(device))


def make_two_level_mesh(n_slices: int, per_slice: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """("slice", "data"[, "tp"]) mesh: `n_slices` slices of `per_slice` devices, taken
    in order from `devices` (None: every visible CUDA device), so consecutive devices
    form a slice. tp > 1 splits each slice's devices into (data, tp)."""
    devs = _device_list(devices)
    if per_slice is None:
        if len(devs) % n_slices:
            raise ValueError(f"n_slices={n_slices} does not divide {len(devs)} devices")
        per_slice = len(devs) // n_slices
    need = n_slices * per_slice
    if need > len(devs):
        raise ValueError(f"need {need} devices, have {len(devs)}")
    if per_slice % tp:
        raise ValueError(f"tp={tp} does not divide per_slice={per_slice}")
    if tp == 1:
        return Mesh(devs[:need], (SLICE_AXIS, DATA_AXIS), (n_slices, per_slice))
    return Mesh(devs[:need], (SLICE_AXIS, DATA_AXIS, MODEL_AXIS), (n_slices, per_slice // tp, tp))


def corpus_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the corpus (row) dimension is sharded over, innermost last."""
    if SLICE_AXIS in mesh.axis_names:
        return (SLICE_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def corpus_shards(mesh: Mesh) -> int:
    """Total number of corpus row shards on this mesh."""
    return mesh.corpus_shards


def shard_rows(mesh: Mesh, x: torch.Tensor) -> tuple:
    """The leading (row) axis of `x` split into one block per corpus shard, each on
    its shard's device (a view where `x` is there already): shard s takes rows
    [s * B / S, (s + 1) * B / S), as JAX's P(corpus_axes, None) places them; B that S
    does not divide raises ValueError."""
    s = corpus_shards(mesh)
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split over {s} shards")
    return tuple(blk.to(dev) for blk, dev in zip(torch.chunk(x, s), mesh.shard_devices))


def replicate(mesh: Mesh, x: torch.Tensor) -> tuple:
    """`x` on every corpus shard's device, one copy per distinct device."""
    copies = {}
    for dev in mesh.shard_devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
    return tuple(copies[dev] for dev in mesh.shard_devices)


def on_device(device: torch.device):
    """Context in which `device` is the current CUDA device (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
