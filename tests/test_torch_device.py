"""The port's entry points run on the card unless the caller asks for the CPU.

`device=None` (the default of every entry point) resolves to the current CUDA device;
without a card it raises instead of falling back to the CPU quietly. Whether a card
is present is read from `torch.cuda.is_available`, monkeypatched here both ways.
"""
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from wax_tpu_torch.embed.hash_embedder import HashEmbedder
from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEmbedder
from wax_tpu_torch.index.dense import DenseIndexBuilder
from wax_tpu_torch.index.ivf import build_ivf, ivf_index_from_numpy
from wax_tpu_torch.index.lex import LexIndexBuilder
from wax_tpu_torch.orchestrator import MemoryOrchestrator
from wax_tpu_torch.parallel.mesh import data_mesh
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.vector_engines import AutoVectorEngine, FlatVectorEngine, IVFVectorEngine, make_vector_engine
from wax_tpu_torch.utils.device import full_f32_matmul, resolve_device

TINY = MiniLMConfig(vocab_size=100, hidden=16, layers=1, heads=2, intermediate=32, max_positions=16)


def _dense():
    b = DenseIndexBuilder(8)
    b.add(1, np.ones(8, np.float32))
    return b


def _orchestrator_device(**kw):
    """The device a MemoryOrchestrator over a fresh store in a temporary directory
    serves on (it resolves the device before it creates the store)."""
    tmp = tempfile.mkdtemp()
    try:
        o = MemoryOrchestrator(Path(tmp) / "memory.mv2s", HashEmbedder(8), **kw)
        o.close()
        return o.device
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ENTRY_POINTS = {
    "MiniLMEmbedder": lambda **kw: MiniLMEmbedder(cfg=TINY, dtype=torch.float32, **kw).device,
    "DenseIndexBuilder.snapshot": lambda **kw: _dense().snapshot(**kw).device,
    "LexIndexBuilder.snapshot": lambda **kw: LexIndexBuilder().snapshot(**kw).device,
    "FlatVectorEngine": lambda **kw: FlatVectorEngine(8, **kw).device,
    "HybridSearchEngine": lambda **kw: HybridSearchEngine(None, dim=8, **kw).device,
    "data_mesh": lambda **kw: data_mesh(**kw).device,
    "IVFVectorEngine": lambda **kw: IVFVectorEngine(8, **kw).device,
    "AutoVectorEngine": lambda **kw: AutoVectorEngine(8, **kw).device,
    "make_vector_engine(auto)": lambda **kw: make_vector_engine("auto", 8, **kw).device,
    "make_vector_engine(ivf)": lambda **kw: make_vector_engine("ivf", 8, **kw).device,
    "HybridSearchEngine(ivf)": lambda **kw: HybridSearchEngine(None, dim=8, vector_preference="ivf", **kw).vector.device,
    "build_ivf": lambda **kw: build_ivf(np.eye(8, dtype=np.float32), np.arange(8), n_clusters=2, **kw).device,
    "ivf_index_from_numpy": lambda **kw: ivf_index_from_numpy(
        np.ones((1, 8), np.float32), np.ones((1, 128, 8), np.float32), np.zeros((1, 128), np.int32),
        np.zeros((1, 128), np.float32), False, **kw).device,
    "MemoryOrchestrator": _orchestrator_device,
}


def test_default_resolves_to_the_current_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
    assert ENTRY_POINTS[entry](device="cpu") == torch.device("cpu")


def test_f32_pin_leaves_cpu_calls_alone():
    """`full_f32_matmul` turns the process-wide TF32 flag off only around a call with
    an operand on a CUDA device; a call on CPU tensors sees the caller's setting."""
    seen = []

    @full_f32_matmul
    def probe(x):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return x

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        probe(torch.ones(2))
        probe(x=torch.ones(2))
        assert seen == [True, True] and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
