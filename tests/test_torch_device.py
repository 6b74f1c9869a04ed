"""The port's entry points run on the card unless the caller asks for the CPU.

`device=None` (the default of every entry point) resolves to the current CUDA device;
without a card it raises instead of falling back to the CPU quietly. Whether a card
is present is read from `torch.cuda.is_available`, monkeypatched here both ways.
"""
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from wax_tpu_torch.embed.hash_embedder import HashEmbedder
from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEmbedder, MiniLMEncoder
from wax_tpu_torch.index.dense import DenseIndexBuilder
from wax_tpu_torch.index.graph import HNSWBuilder, graph_index_from_numpy
from wax_tpu_torch.index.ivf import build_ivf, ivf_index_from_numpy
from wax_tpu_torch.index.lex import LexIndexBuilder
from wax_tpu_torch.multimodal.photo import PhotoRAGOrchestrator
from wax_tpu_torch.multimodal.video import VideoRAGOrchestrator
from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
from wax_tpu_torch.parallel.mesh import Mesh, data_mesh, make_mesh, make_two_level_mesh
from wax_tpu_torch.parallel.train import Trainer
from wax_tpu_torch.surfaces import cli as port_cli
from wax_tpu_torch.surfaces.mcp_server import build_server
from wax_tpu_torch.surfaces.repo import RepoIndexer
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.vector_engines import (AutoVectorEngine, FlatVectorEngine, HNSWVectorEngine, IVFVectorEngine,
                                                 ShardedFlatVectorEngine, make_vector_engine)
from wax_tpu_torch.session import open_session
from wax_tpu_torch.utils.device import full_f32_matmul, resolve_device, resolve_devices

TINY = MiniLMConfig(vocab_size=100, hidden=16, layers=1, heads=2, intermediate=32, max_positions=16)


def _dense():
    b = DenseIndexBuilder(8)
    b.add(1, np.ones(8, np.float32))
    return b


def _graph():
    b = HNSWBuilder(8)
    b.add(1, np.ones(8, np.float32))
    return b


def _session_device(**kw):
    """The device an open_session over a fresh store in a temporary directory serves
    on (it resolves the device before it opens the store)."""
    tmp = tempfile.mkdtemp()
    try:
        s = open_session(Path(tmp) / "session.wxs", dim=8, **kw)
        s.close()
        return s.engine.device
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def _wrapper_device(cls, **kw):
    """The device a photo or video orchestrator's inner store serves on."""
    tmp = tempfile.mkdtemp()
    try:
        o = cls(Path(tmp) / "media.mv2s", HashEmbedder(8), **kw)
        o.close()
        return o.inner.device
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _maintained_device(engine: str, step: str, **kw):
    """The device of the snapshots taken after the maintainer rebuilt the builders
    (a compaction or a live-set rewrite, after a forget)."""
    tmp = tempfile.mkdtemp()
    try:
        o = MemoryOrchestrator(Path(tmp) / "memory.mv2s", HashEmbedder(8),
                               OrchestratorConfig(vector_engine=engine), **kw)
        try:
            fids = [o.remember(f"note {i} about the lake").document_id for i in range(4)]
            o.forget(fids[1])
            getattr(o.maintainer, step)()
            lex_dev = o.engine.lex_snapshot().device
            vec_dev = o.engine.vector.snapshot().device
            assert lex_dev == vec_dev and o.search("lake note").hits
            return vec_dev
        finally:
            o.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _server_device(**kw):
    """The device of build_server's orchestrator over a fresh store (hash embedder)."""
    tmp = tempfile.mkdtemp()
    saved = os.environ.get("WAX_TPU_EMBEDDER")
    os.environ["WAX_TPU_EMBEDDER"] = "hash"
    try:
        srv = build_server(Path(tmp) / "memory.wxs", **kw)
        srv.close()
        return srv.orch.device
    finally:
        if saved is None:
            os.environ.pop("WAX_TPU_EMBEDDER", None)
        else:
            os.environ["WAX_TPU_EMBEDDER"] = saved
        shutil.rmtree(tmp, ignore_errors=True)


def _repo_device(**kw):
    tmp = tempfile.mkdtemp()
    try:
        idx = RepoIndexer(Path(tmp) / "repo.wxs", HashEmbedder(8), **kw)
        idx.close()
        return idx.orch.device
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_device(**kw):
    """The device the CLI's `remember` opened its store's orchestrator on."""
    tmp = tempfile.mkdtemp()
    seen = []
    real = port_cli._orchestrator

    def spy(args):
        orch = real(args)
        seen.append(orch.device)
        return orch

    port_cli._orchestrator = spy
    try:
        assert port_cli.main(["remember", "a note", "--store", str(Path(tmp) / "cli.wxs")], **kw) == 0
        return seen[0]
    finally:
        port_cli._orchestrator = real
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
    "HNSWVectorEngine": lambda **kw: HNSWVectorEngine(8, **kw).device,
    "make_vector_engine(hnsw)": lambda **kw: make_vector_engine("hnsw", 8, **kw).device,
    "HybridSearchEngine(hnsw)": lambda **kw: HybridSearchEngine(None, dim=8, vector_preference="hnsw", **kw).vector.device,
    "HNSWBuilder.snapshot": lambda **kw: _graph().snapshot(**kw).device,
    "graph_index_from_numpy": lambda **kw: graph_index_from_numpy(
        np.full((128, 48), -1, np.int32), np.ones((128, 8), np.float32), np.zeros(128, np.int32),
        np.zeros(128, np.float32), np.zeros(8, np.int32), **kw).device,
    "open_session": _session_device,
    "PhotoRAGOrchestrator": lambda **kw: _wrapper_device(PhotoRAGOrchestrator, **kw),
    "VideoRAGOrchestrator": lambda **kw: _wrapper_device(VideoRAGOrchestrator, **kw),
    "Maintainer.compact_indexes(auto)": lambda **kw: _maintained_device("auto", "compact_indexes", **kw),
    "Maintainer.compact_indexes(ivf)": lambda **kw: _maintained_device("ivf", "compact_indexes", **kw),
    "Maintainer.rewrite_live_set(flat)": lambda **kw: _maintained_device("flat", "rewrite_live_set", **kw),
    "Maintainer.rewrite_live_set(hnsw)": lambda **kw: _maintained_device("hnsw", "rewrite_live_set", **kw),
    "Trainer": lambda **kw: Trainer(MiniLMEncoder(TINY), data_mesh(**kw) if kw else None).device,
    "make_mesh": lambda **kw: make_mesh(kw.get("device")).device,
    "make_two_level_mesh": lambda **kw: make_two_level_mesh(1, devices=kw.get("device")).device,
    "Mesh": lambda **kw: Mesh(kw.get("device")).device,
    "ShardedFlatVectorEngine": lambda **kw: ShardedFlatVectorEngine(8, **kw).device,
    "make_vector_engine(sharded)": lambda **kw: make_vector_engine("sharded", 8, **kw).mesh.device,
    "MemoryOrchestrator(sharded_lanes)": lambda **kw: _orchestrator_device(
        config=OrchestratorConfig(sharded_lanes=True), **kw),
    "MemoryOrchestrator(mesh_slices)": lambda **kw: _orchestrator_device(
        config=OrchestratorConfig(sharded_lanes=True, mesh_slices=1), **kw),
    "build_server": _server_device,
    "RepoIndexer": _repo_device,
    "cli.main(remember)": _cli_device,
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


def test_default_mesh_is_every_visible_card(monkeypatch):
    """No devices: every visible CUDA device, as JAX's meshes take jax.devices()."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    want = tuple(torch.device("cuda", i) for i in range(4))
    assert resolve_devices(None) == want and data_mesh().devices == want
    assert make_two_level_mesh(2).shape == {"slice": 2, "data": 2}
    assert resolve_devices("cuda") == (torch.device("cuda", 0),)
    assert data_mesh("cuda:1").devices == (torch.device("cuda", 1),)


@pytest.mark.parametrize("build", [
    lambda d: data_mesh(d), lambda d: Mesh(d), lambda d: make_two_level_mesh(2, devices=d),
    lambda d: resolve_devices(d), lambda d: _orchestrator_device(config=OrchestratorConfig(sharded_lanes=True), device=d),
], ids=["data_mesh", "Mesh", "make_two_level_mesh", "resolve_devices", "MemoryOrchestrator"])
def test_mixed_cpu_and_cuda_mesh_raises(build):
    """A mesh holds CPU devices or CUDA devices: a mix raises, and nothing falls back
    to the CPU."""
    with pytest.raises(ValueError, match="CPU devices or CUDA devices"):
        build(["cpu", "cuda:0", "cpu", "cuda:0"])


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
