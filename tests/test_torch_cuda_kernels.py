"""Kernels K1 and K2 on the GPU against their plain torch twins (needs a card).

CUDA kernels have no CPU mode, so these tests skip without a CUDA device. They import
no JAX, so they also run on a machine that has none; run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up JAX for the rest of the suite).
"""
import numpy as np
import pytest
import torch

from wax_tpu_torch.index.dense import DenseIndexBuilder, Similarity
from wax_tpu_torch.ops import flat_scan as fs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1/K2 kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _grid(g, shape, dev, dtype=torch.float32):
    """Entries k/8 in [-1, 1]: every dot product is exact in f32, ties are common."""
    return (torch.randint(-8, 9, shape, generator=g) / 8.0).to(dev, dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,tn", [(13, 10, 4096, 2048), (256, 24, 8192, 2048),
                                      (64, 128, 2048, 1024), (7, 1, 1536, 512)])
def test_kernels_equal_plain_on_exact_data(dev, dtype, b, k, n, tn):
    g = torch.Generator().manual_seed(b * 1000 + k)
    q, emb = _grid(g, (b, 96), dev, dtype), _grid(g, (n, 96), dev, dtype)
    bias = torch.zeros(n, device=dev)
    bias[torch.randperm(n, generator=g)[: n // 10].to(dev)] = fs.NEG_INF
    assert torch.equal(fs.packed_sel_tiles(q, emb, bias, k, tn), fs._packed_sel_topk_plain(q, emb, bias, k, tn))
    (kv, kr), (pv, pr) = fs.scan_topk_tiles(q, emb, bias, k, tn), fs._scan_topk_plain(q, emb, bias, k, tn)
    assert torch.equal(kv, pv) and torch.equal(kr, pr)


def test_launch_counters_count_kernel_launches_only(dev):
    q, emb, bias = torch.zeros(4, 32, device=dev), torch.zeros(1024, 32, device=dev), torch.zeros(1024, device=dev)
    k1, k2 = fs.K1_LAUNCHES, fs.K2_LAUNCHES
    fs.packed_sel_tiles(q, emb, bias, 5, 512)
    fs.scan_topk_tiles(q, emb, bias, 5, 512)
    fs._packed_sel_topk_plain(q, emb, bias, 5, 512)
    assert (fs.K1_LAUNCHES, fs.K2_LAUNCHES) == (k1 + 1, k2 + 1)


def test_flat_scan_topk_cuda_equals_cpu(dev):
    rng = np.random.default_rng(0)
    b = DenseIndexBuilder(64, Similarity.DOT, capacity=6144)
    b.add_batch(np.arange(5000), (rng.integers(-8, 9, (5000, 64)) / 8).astype(np.float32))
    for fid in (3, 2047, 2048, 4000):
        b.remove(fid)
    cpu, gpu = b.snapshot(), b.snapshot(device=dev)
    q = torch.from_numpy((rng.integers(-8, 9, (13, 64)) / 8).astype(np.float32))
    for backend in ("auto", "pallas", "pallas_packed_sel", "xla", "blockmax"):
        for k in (1, 10, 100):
            want = fs.flat_scan_topk(q, cpu, k, backend=backend)
            got = fs.flat_scan_topk(q.to(dev), gpu, k, backend=backend)
            for w, g in zip(want, got):
                assert torch.equal(w, g.cpu()), (backend, k)


def test_wrappers_raise_instead_of_falling_back(dev):
    q, emb, bias = torch.zeros(4, 32, device=dev), torch.zeros(1024, 32, device=dev), torch.zeros(1024, device=dev)
    with pytest.raises(ValueError):
        fs.packed_sel_tiles(q, emb, bias, 129, 512)
    with pytest.raises(ValueError):
        fs.scan_topk_tiles(q.cpu(), emb, bias, 5, 512)
    with pytest.raises(ValueError):
        fs.scan_topk_tiles(q.double(), emb.double(), bias, 5, 512)
