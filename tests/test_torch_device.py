"""The port's entry points run on the card unless the caller asks for the CPU.

`device=None` (the default of every entry point) resolves to the current CUDA device;
without a card it raises instead of falling back to the CPU quietly. Whether a card
is present is read from `torch.cuda.is_available`, monkeypatched here both ways.
"""
import numpy as np
import pytest
import torch

from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEmbedder
from wax_tpu_torch.index.dense import DenseIndexBuilder
from wax_tpu_torch.index.lex import LexIndexBuilder
from wax_tpu_torch.parallel.mesh import data_mesh
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.vector_engines import FlatVectorEngine
from wax_tpu_torch.utils.device import resolve_device

TINY = MiniLMConfig(vocab_size=100, hidden=16, layers=1, heads=2, intermediate=32, max_positions=16)


def _dense():
    b = DenseIndexBuilder(8)
    b.add(1, np.ones(8, np.float32))
    return b


ENTRY_POINTS = {
    "MiniLMEmbedder": lambda **kw: MiniLMEmbedder(cfg=TINY, dtype=torch.float32, **kw).device,
    "DenseIndexBuilder.snapshot": lambda **kw: _dense().snapshot(**kw).device,
    "LexIndexBuilder.snapshot": lambda **kw: LexIndexBuilder().snapshot(**kw).device,
    "FlatVectorEngine": lambda **kw: FlatVectorEngine(8, **kw).device,
    "HybridSearchEngine": lambda **kw: HybridSearchEngine(None, dim=8, **kw).device,
    "data_mesh": lambda **kw: data_mesh(**kw).device,
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
