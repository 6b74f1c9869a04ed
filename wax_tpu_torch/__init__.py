"""wax_tpu_torch: the PyTorch / CUDA port of wax-tpu.

The package mirrors `wax_tpu`'s module layout. It imports torch and numpy, never jax
or anything from `wax_tpu`. Members are imported lazily, so `import wax_tpu_torch`
is cheap and builds no kernel: the CUDA kernels are compiled from `csrc/` the first
time a CUDA tensor reaches one.
"""
from __future__ import annotations

import importlib

__all__ = [
    "DenseIndex",
    "DenseIndexBuilder",
    "Similarity",
    "LexIndex",
    "LexIndexBuilder",
    "flat_scan_topk",
    "normalize_rows",
    "bm25_topk",
    "rrf_fuse",
    "FlatVectorEngine",
    "HybridSearchEngine",
    "MiniLMEmbedder",
]

_WHERE = {
    "DenseIndex": "wax_tpu_torch.index.dense",
    "DenseIndexBuilder": "wax_tpu_torch.index.dense",
    "Similarity": "wax_tpu_torch.index.dense",
    "LexIndex": "wax_tpu_torch.index.lex",
    "LexIndexBuilder": "wax_tpu_torch.index.lex",
    "flat_scan_topk": "wax_tpu_torch.ops.flat_scan",
    "normalize_rows": "wax_tpu_torch.ops.flat_scan",
    "bm25_topk": "wax_tpu_torch.ops.bm25",
    "rrf_fuse": "wax_tpu_torch.ops.fusion",
    "FlatVectorEngine": "wax_tpu_torch.search.vector_engines",
    "HybridSearchEngine": "wax_tpu_torch.search.engine",
    "MiniLMEmbedder": "wax_tpu_torch.embed.minilm",
}


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module 'wax_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
