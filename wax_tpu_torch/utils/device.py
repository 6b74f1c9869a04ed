"""Where the port's entry points put their tensors.

Every entry point (`MiniLMEmbedder`, `DenseIndexBuilder.snapshot`,
`LexIndexBuilder.snapshot`, `FlatVectorEngine`, `HybridSearchEngine`) takes
`device=None`, which means the current CUDA device. Without a card that default
raises instead of falling back to the CPU; a CPU run is asked for explicitly with
`device="cpu"`.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
