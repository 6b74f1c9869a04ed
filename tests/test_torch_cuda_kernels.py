"""Kernels K1-K9 on the GPU against their plain torch twins, the HNSW beam search on
the card against its CPU run, and the f32 paths (scans, IVF, the trainer) with TF32
turned on (needs a card).

CUDA kernels have no CPU mode, so these tests skip without a CUDA device. They import
no JAX, so they also run on a machine that has none; run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up JAX for the rest of the suite).
"""
import numpy as np
import pytest
import torch

from wax_tpu_torch.index.dense import DenseIndexBuilder, Similarity
from wax_tpu_torch.index.lex import PK_CHUNK, build_impact_chunks
from wax_tpu_torch.ops import bm25_candidates_pallas as k8
from wax_tpu_torch.ops import bm25_chunked_pallas as ck
from wax_tpu_torch.ops import bm25_rescore as rs
from wax_tpu_torch.ops import chunkmax_scan as cm
from wax_tpu_torch.ops import flat_scan as fs
from wax_tpu_torch.ops import ivf_kernel as ivf
from wax_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _grid(g, shape, dev, dtype=torch.float32):
    """Entries k/8 in [-1, 1]: every dot product is exact in f32, ties are common."""
    return (torch.randint(-8, 9, shape, generator=g) / 8.0).to(dev, dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,tn,d,split,unaligned", [
    (13, 10, 4096, 2048, 96, None, False), (256, 24, 8192, 2048, 96, None, False),
    (64, 128, 2048, 1024, 96, None, False), (7, 1, 1536, 512, 96, None, False),
    (1, 10, 2048, 2048, 384, None, False),  # plan: S 8
    (13, 24, 10240, 2048, 37, None, True),  # S 8; rows not 16-byte aligned
    (256, 10, 10240, 2048, 384, None, False),  # the headline shape: S 8, 160 CTAs
    (300, 100, 10240, 2048, 768, 4, False),
    (256, 24, 32768, 2048, 384, None, False),  # exact_30k's capacity: S 4
    (300, 128, 32768, 2048, 96, None, True),  # S 2
    (256, 24, 32768, 2048, 768, 1, False),
    (13, 1, 10240, 2048, 96, 2, False),
    (300, 24, 2048, 1024, 384, 8, True),
])
def test_kernels_equal_plain_on_exact_data(dev, dtype, b, k, n, tn, d, split, unaligned):
    """K1 and K2 on the 1/8 grid, where their 3xTF32 scores are exact: bit-equal to the
    plain twins at every cluster split (S 1, 2, 4, 8: forced, or the plan's), ragged
    and wide batches, d 37 to 768, k 1 to 128, aligned and unaligned bases."""
    g = torch.Generator().manual_seed(b * 1000 + k + d)
    q, emb = _grid(g, (b, d), dev, dtype), _grid(g, (n, d), dev, dtype)
    bias = torch.zeros(n, device=dev)
    bias[torch.randperm(n, generator=g)[: n // 10].to(dev)] = fs.NEG_INF
    if unaligned:
        q, emb = _unaligned(q), _unaligned(emb)
    k1, k2 = counters().get("wax_k1_packed_sel", 0), counters().get("wax_k2_scan_topk", 0)
    got = fs.packed_sel_tiles(q, emb, bias, k, tn, split)
    assert torch.equal(got, fs._packed_sel_topk_plain(q, emb, bias, k, tn))
    (kv, kr), (pv, pr) = fs.scan_topk_tiles(q, emb, bias, k, tn, split), fs._scan_topk_plain(q, emb, bias, k, tn)
    assert torch.equal(kv, pv) and torch.equal(kr, pr)
    assert (counters().get("wax_k1_packed_sel", 0), counters().get("wax_k2_scan_topk", 0)) == (k1 + 1, k2 + 1)


def _assert_exact_near(got, ref, scores, k):
    """Per-tile (vals, rows) of K2 against its plain twin on random data: tile values
    within 1e-5; merged top-k ids equal except near-ties of the k-th exact score."""
    (gv, gr), (rv, rr) = got, ref
    assert float((gv - rv).abs().max()) <= 1e-5
    (mv, mr), (pv, pr) = fs._merge_tiles(gv, gr, k), fs._merge_tiles(rv, rr, k)
    hit = 0
    for b in range(mr.shape[0]):
        a, p = set(mr[b].tolist()), set(pr[b].tolist())
        hit += len(a & p)
        for row in a ^ p:
            assert row >= 0 and abs(float(scores[b, row]) - float(pv[b, k - 1])) <= 1e-5, (b, row)
    assert hit / mr.numel() >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,tn,d", [(256, 10, 10240, 2048, 384), (256, 24, 32768, 2048, 384),
                                        (300, 128, 2048, 1024, 96), (13, 24, 10240, 2048, 37)])
def test_k1_k2_near_plain_on_random_unit_vectors(dev, dtype, b, k, n, tn, d):
    """On random unit vectors K1's 3xTF32 keys may differ from the plain twin's and
    K9's only at a 2^-12 bucket edge; K2's tile values sit within 1e-5 of the f32 sums
    and its ids differ only among near-ties."""
    g = torch.Generator().manual_seed(b + k + n + d)
    q = fs.normalize_rows(torch.randn((b, d), generator=g)).to(dev, dtype).contiguous()
    emb = fs.normalize_rows(torch.randn((n, d), generator=g)).to(dev, dtype).contiguous()
    bias = torch.zeros(n, device=dev)
    bias[torch.randperm(n, generator=g)[: n // 10].to(dev)] = fs.NEG_INF
    scores = fs._scores_f32(q, emb) + bias[None, :]
    got = fs.packed_sel_tiles(q, emb, bias, k, tn)
    _assert_packed_near(got, fs._packed_sel_topk_plain(q, emb, bias, k, tn), scores, k, tn, "K1 vs plain")
    _assert_packed_near(got, fs.packed_topk_tiles(q, emb, bias, k, tn), scores, k, tn, "K1 vs K9")
    _assert_exact_near(fs.scan_topk_tiles(q, emb, bias, k, tn), fs._scan_topk_plain(q, emb, bias, k, tn), scores, k)


def test_launch_plan_reports_the_cluster_split(dev):
    """The C side's plan: a CTA fits the card at every split, and the split is
    scan_plan's (S 8 at 10,240 rows, S 4 at 32,768, S 1 at 131,072 for B 256)."""
    for n, want in ((10240, 8), (32768, 4), (131072, 1)):
        for exact, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.bfloat16)):
            p = fs.launch_plan(256, n, 2048, 24, dtype=dtype, exact=exact, device=dev)
            assert p["split"] == want and p["ctas_per_sm"] >= 1 and p["max_active_clusters"] >= 1, p
    p = fs.launch_plan(256, 10240, 2048, 128, exact=True, device=dev)  # the most shared memory: u64 lists of 128
    assert p["split"] == 8 and p["ctas_per_sm"] >= 1 and p["max_active_clusters"] >= 1, p


def test_k9_unaligned_views_launch(dev):
    """Rows whose base is not 16-byte aligned take the ordinary-load stage fill."""
    g = torch.Generator().manual_seed(5)
    q = _grid(g, (33, 97), dev)[:, 1:].contiguous()
    emb_all = _grid(g, (2048 * 96 + 1,), dev)
    emb = emb_all[1:].view(2048, 96)  # contiguous, 4 bytes past a 16-byte boundary
    assert emb.is_contiguous() and emb.data_ptr() % 16 == 4
    bias = torch.zeros(2048, device=dev)
    got = fs.packed_topk_tiles(q, emb, bias, 10, 1024)
    assert torch.equal(got, fs._packed_sel_topk_plain(q, emb, bias, 10, 1024))


def test_launch_counters_count_kernel_launches_only(dev):
    q, emb, bias = torch.zeros(4, 32, device=dev), torch.zeros(1024, 32, device=dev), torch.zeros(1024, device=dev)
    k1, k2 = counters().get("wax_k1_packed_sel", 0), counters().get("wax_k2_scan_topk", 0)
    fs.packed_sel_tiles(q, emb, bias, 5, 512)
    fs.scan_topk_tiles(q, emb, bias, 5, 512)
    fs._packed_sel_topk_plain(q, emb, bias, 5, 512)
    assert (counters().get("wax_k1_packed_sel", 0), counters().get("wax_k2_scan_topk", 0)) == (k1 + 1, k2 + 1)


def test_flat_scan_topk_cuda_equals_cpu(dev):
    rng = np.random.default_rng(0)
    b = DenseIndexBuilder(64, Similarity.DOT, capacity=6144)
    b.add_batch(np.arange(5000), (rng.integers(-8, 9, (5000, 64)) / 8).astype(np.float32))
    for fid in (3, 2047, 2048, 4000):
        b.remove(fid)
    cpu, gpu = b.snapshot(device="cpu"), b.snapshot(device=dev)
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
    with pytest.raises(ValueError):  # 512 rows do not split into 8 CTAs of a multiple of 128
        fs.packed_sel_tiles(q, emb, bias, 5, 512, split=8)
    with pytest.raises(ValueError):
        fs.scan_topk_tiles(q, emb, bias, 5, 512, split=3)


def _unaligned(x):
    """A contiguous copy of x whose base lies one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 16 // x.element_size(), dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d", [(256, 8192, 384), (37, 4096, 768), (13, 2048, 100), (64, 4096, 96),
                                   (1, 20096, 64), (200, 20096, 384), (300, 8192, 768), (256, 4096, 1536),
                                   (128, 2048, 384), (129, 2048, 64)])
def test_k6_chunk_maxima_equal_plain_on_exact_data(dev, dtype, b, n, d):
    """Bit-equal to the plain twin on exact-arithmetic data, on 16-byte aligned and
    unaligned bases; within 1e-5 on random unit vectors. The edges of the bf16 tile:
    B 1 / 128 / 129 / 200 / 256 / 300 (one or two query blocks of 128 or 256), d 64 to
    1,536, 157 chunks (not a multiple of the persistent grid), a dead tail."""
    g = torch.Generator().manual_seed(b + n + d)
    q, emb = _grid(g, (b, d), dev, dtype), _grid(g, (n, d), dev, dtype)
    bias = torch.zeros(n, device=dev)
    bias[n - 200:] = fs.NEG_INF
    k6 = counters().get("wax_k6_chunk_maxima", 0)
    got = cm.chunk_maxima(q, emb, bias)
    assert counters().get("wax_k6_chunk_maxima", 0) == k6 + 1
    want = cm._chunk_maxima_plain(q, emb, bias)
    assert torch.equal(got, want)
    assert torch.equal(cm.chunk_maxima(_unaligned(q), _unaligned(emb), _unaligned(bias)), want)
    qr = fs.normalize_rows(torch.randn((b, d), generator=g)).to(dev, dtype).contiguous()
    er = fs.normalize_rows(torch.randn((n, d), generator=g)).to(dev, dtype).contiguous()
    err = (cm.chunk_maxima(qr, er, bias) - cm._chunk_maxima_plain(qr, er, bias)).abs().max()
    assert float(err) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nprobe,d,k", [(256, 20, 384, 10), (5, 3, 100, 128), (9, 7, 96, 1),
                                          (64, 20, 384, 32), (64, 20, 384, 33), (64, 20, 768, 128),
                                          (64, 20, 384, 129), (13, 24, 37, 20), (300, 6, 100, 33)])
def test_k7_bucket_rescore_equal_plain_on_exact_data(dev, dtype, b, nprobe, d, k):
    """Bit-equal to the plain twin on exact-arithmetic data: k 1-128 on the slab ring
    (lists of 32 keys for k <= 32, 128 for k <= 128) and k 129 on the arg-max body;
    duplicated buckets (ties to the lower probe rank), a bucket with no live row, rows
    that are not 16-byte multiples (d 37, and d 100 in bf16: ordinary loads) and a base
    that is not 16-byte aligned."""
    g = torch.Generator().manual_seed(b * nprobe + d + k)
    c = 32
    emb3 = _grid(g, (c, 128, d), dev, dtype)
    emb3[1] = emb3[5]  # duplicate buckets: ties go to the lower probe rank
    q = _grid(g, (b, d), dev)
    probes = torch.stack([torch.randperm(c, generator=g)[:nprobe] for _ in range(b)]).to(dev, torch.int32)
    counts = torch.randint(1, 129, (c,), generator=g).to(dev, torch.int32)
    counts[probes[0, 1]] = 0  # a probed bucket with no live row
    pv, pp = ivf._bucket_rescore_plain(q, probes, counts, emb3, k)
    for e3 in (emb3, _unaligned(emb3)):
        k7 = counters().get("wax_k7_bucket_rescore", 0)
        kv, kp = ivf.bucket_rescore(q, probes, counts, e3, k)
        assert counters().get("wax_k7_bucket_rescore", 0) == k7 + 1
        assert torch.equal(kv, pv) and torch.equal(kp, pp)
    assert bool((pv[0] > fs.NEG_INF).any())


@pytest.mark.parametrize("b,nprobe,d,k", [(256, 20, 384, 20), (256, 24, 768, 24), (37, 8, 100, 64),
                                          (64, 4, 384, 200)])
def test_k7_bucket_rescore_near_plain_on_random_unit_vectors(dev, b, nprobe, d, k):
    """On random unit vectors (bf16 rows) K7's values sit within 1e-5 of the plain
    twin's (another f32 sum order) and its positions differ only among near-ties of
    the k-th value."""
    g = torch.Generator().manual_seed(b + nprobe + d + k)
    c = 64
    emb3 = fs.normalize_rows(torch.randn((c * 128, d), generator=g)).to(dev, torch.bfloat16).view(c, 128, d)
    q = fs.normalize_rows(torch.randn((b, d), generator=g)).to(dev)
    probes = torch.stack([torch.randperm(c, generator=g)[:nprobe] for _ in range(b)]).to(dev, torch.int32)
    counts = torch.randint(64, 129, (c,), generator=g).to(dev, torch.int32)
    k7 = counters().get("wax_k7_bucket_rescore", 0)
    kv, kp = ivf.bucket_rescore(q, probes, counts, emb3, k)
    assert counters().get("wax_k7_bucket_rescore", 0) == k7 + 1
    pv, pp = ivf._bucket_rescore_plain(q, probes, counts, emb3, k)
    assert float((kv - pv).abs().max()) <= 1e-5
    for i in range(b):
        for pos in set(kp[i].tolist()) ^ set(pp[i].tolist()):
            s = float((emb3[probes[i, pos // 128].long(), pos % 128].float() * q[i]).sum())
            assert abs(s - float(pv[i, k - 1])) <= 1e-5, (i, pos)


def test_k4_k7_launch_plans(dev):
    """K4's 32-slot body: 1,024 threads and the padded 132 KiB plane, one CTA per SM;
    K7 takes its ring body for k <= 128 (32-row slabs at d 384 bf16, at least two CTAs
    per SM, so B 256 is resident at once) and the arg-max body above."""
    p = ck.launch_plan()
    assert p == {"threads": 1024, "smem_bytes": 135_168, "ctas_per_sm": 1}, p
    p = ivf.launch_plan(384, 128, 20)
    assert p["ring"] == 1 and p["rows_per_slab"] == 32 and p["ctas_per_sm"] >= 2, p
    assert ivf.launch_plan(768, 128, 128)["ring"] == 1
    assert ivf.launch_plan(37, 128, 33, torch.float32)["ring"] == 1
    assert ivf.launch_plan(384, 128, 129)["ring"] == 0


@pytest.mark.parametrize("dtype,s,nprobe,k", [(torch.bfloat16, 384, 8, 10), (torch.bfloat16, 384, 8, 20),
                                               (torch.float32, 1152, 8, 10), (torch.float32, 1152, 64, 20),
                                               (torch.float32, 1152, 16, 128)])
def test_k7_ivf_shapes_equal_plain_on_exact_data(dev, dtype, s, nprobe, k):
    """K7 at the IVF paths' shapes, d 768: the bench's 384-row bf16 buckets at 8
    probes (k 10, and the spilled window 20) and the 2M engine's 1,152-row f32 buckets
    at 8-64 probes; buckets filled to random prefixes, one probed bucket empty. Bit-equal
    to the plain twin."""
    g = torch.Generator().manual_seed(s + nprobe + k)
    c, b, d = 80, 48, 768
    emb3 = _grid(g, (c, s, d), dev, dtype)
    q = _grid(g, (b, d), dev)
    probes = torch.stack([torch.randperm(c, generator=g)[:nprobe] for _ in range(b)]).to(dev, torch.int32)
    counts = torch.randint(s // 2, s + 1, (c,), generator=g).to(dev, torch.int32)
    counts[probes[0, 1]] = 0
    k7 = counters().get("wax_k7_bucket_rescore", 0)
    kv, kp = ivf.bucket_rescore(q, probes, counts, emb3, k)
    assert counters().get("wax_k7_bucket_rescore", 0) == k7 + 1
    pv, pp = ivf._bucket_rescore_plain(q, probes, counts, emb3, k)
    assert torch.equal(kv, pv) and torch.equal(kp, pp)


def test_k7_ivf_launch_plans(dev):
    """Both IVF shapes take the ring body: 384-row bf16 buckets at d 768 in 16-row
    slabs, 1,152-row f32 buckets in 8-row slabs."""
    p = ivf.launch_plan(768, 384, 20, torch.bfloat16)
    assert p["ring"] == 1 and p["rows_per_slab"] == 16 and p["ctas_per_sm"] >= 1, p
    p = ivf.launch_plan(768, 1152, 20, torch.float32)
    assert p["ring"] == 1 and p["rows_per_slab"] == 8 and p["ctas_per_sm"] >= 1, p


def test_ivf_build_repeats_and_search_cuda_equals_cpu(dev):
    """build_ivf on the card repeats bit for bit (no atomics in the centroid sums); the
    K7 search of an index on the card equals the plain path on a CPU copy (exact data,
    spilled and not). A spilled k 200 launches K7's arg-max body at nprobe 4 and takes
    the plain path at nprobe 96, where its key plane does not fit shared memory."""
    import dataclasses

    from wax_tpu_torch.index.ivf import build_ivf, ivf_search_topk
    from wax_tpu_torch.ops.ivf_kernel import ivf_search_topk_pallas

    g = torch.Generator().manual_seed(11)
    centres = torch.randint(-6, 7, (40, 96), generator=g)
    rows = (centres[torch.randint(0, 40, (20_000,), generator=g)] + torch.randint(-2, 3, (20_000, 96), generator=g))
    vecs = (rows.clamp(-8, 8) / 8.0).float()
    q = vecs[:64].clone()
    for spill in (0.0, "auto"):
        a = build_ivf(vecs.to(dev), range(20_000), n_clusters=96, iters=4, normalize=False, spill=spill, device=dev)
        b = build_ivf(vecs.to(dev), range(20_000), n_clusters=96, iters=4, normalize=False, spill=spill, device=dev)
        for f in ("centroids", "emb", "ids", "bias"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (spill, f)
        cent = torch.round(a.centroids * 64.0) / 64.0  # every product exact
        idx = dataclasses.replace(a, centroids=cent)
        cpu = dataclasses.replace(idx, **{f: getattr(idx, f).cpu() for f in ("centroids", "emb", "ids", "bias")})
        for k, nprobe in ((10, 8), (20, 16), (200, 4), (200, 96)):
            k7 = counters().get("wax_k7_bucket_rescore", 0)
            gv, gf = ivf_search_topk_pallas(q.to(dev), idx, k=k, nprobe=nprobe)
            plain = spill and 2 * k > 128 and not ivf.argmax_fits(96, idx.bucket_size, nprobe)
            assert plain == (spill and nprobe == 96), (idx.bucket_size, nprobe)
            assert counters().get("wax_k7_bucket_rescore", 0) == k7 + (0 if plain else 1)
            cv, cf = ivf_search_topk_pallas(q, cpu, k=k, nprobe=nprobe)
            assert torch.equal(gf.cpu(), cf) and torch.equal(gv.cpu(), cv), (spill, k)
            if not spill:
                pv, pf = ivf_search_topk(q, cpu, k=min(k, 128), nprobe=nprobe)
                assert torch.equal(pf, cf)


def test_chunkmax_scan_cuda_equals_cpu(dev):
    g = torch.Generator().manual_seed(0)
    emb, q = _grid(g, (8192, 64), "cpu", torch.bfloat16), _grid(g, (33, 64), "cpu")
    bias = torch.zeros(8192)
    bias[8000:] = fs.NEG_INF
    for k in (1, 24, 100):
        want = cm.chunkmax_scan_topk(q, emb, bias, k)
        got = cm.chunkmax_scan_topk(q.to(dev), emb.to(dev), bias.to(dev), k)
        for w, gt in zip(want, got):
            assert torch.equal(w, gt.cpu()), k


def test_sharded_scan_runs_k6_k7_a_card(dev):
    """`sharded_flat_scan_topk` over the cards present, 2^20 contiguous bf16 unit rows a
    card, B 64, k 10: one K6 launch and one count of the chunkmax route a card a call,
    no synchronising call; the merged top-10's scores within 2e-05 of the f32-product
    route's (`_scores_f32`, `blockmax_topk` a card, the same merge) and of each
    returned row's own score, ten distinct ids a query."""
    from wax_tpu_torch.ops.topk import blockmax_topk
    from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex, sharded_flat_scan_topk

    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n, d, b, k = 1 << 20, 384, 64, 10
    emb = []
    for c, dv in enumerate(devs):
        g = torch.Generator(device=dv).manual_seed(100 + c)
        emb.append(fs.normalize_rows(torch.randn((n, d), generator=g, device=dv)).to(torch.bfloat16))
    fids = tuple(torch.arange(c * n, (c + 1) * n, dtype=torch.int32, device=e.device) for c, e in enumerate(emb))
    bias = tuple(torch.zeros(n, device=e.device) for e in emb)
    index = ShardedDenseIndex(emb=tuple(emb), frame_ids=fids, bias=bias, contiguous=True)
    mesh = data_mesh(devs)
    g = torch.Generator(device=devs[0]).manual_seed(7)
    q = fs.normalize_rows(torch.randn((b, d), generator=g, device=devs[0])).to(torch.bfloat16).float()
    sharded_flat_scan_topk(q, index, k, mesh)  # builds the kernels
    for dv in devs:
        torch.cuda.synchronize(dv)
    k6, routed = counters().get("wax_k6_chunk_maxima", 0), counters().get("sharded_scan.chunkmax_shards", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        v, f = sharded_flat_scan_topk(q, index, k, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counters()["wax_k6_chunk_maxima"] == k6 + len(devs)
    assert counters()["sharded_scan.chunkmax_shards"] == routed + len(devs)
    lv, lf = [], []
    for e, fi, bi in zip(emb, fids, bias):
        rv, rr = blockmax_topk(fs._scores_f32(q.to(e.device).to(e.dtype), e, bi), k)
        lv.append(rv)
        lf.append(fi[rr.long()])
    rv, _ = merge_topk_across_mesh(lv, lf, k, mesh)
    assert f.shape == (b, k) and bool((f >= 0).all()) and all(len(set(r)) == k for r in f.tolist())
    assert float((v - rv).abs().max()) <= 2e-5
    own = torch.stack([emb[i // n][i % n].to(devs[0]).float() for i in f.flatten().tolist()]).reshape(b, k, d)
    assert float((torch.einsum("bd,bkd->bk", q, own) - v).abs().max()) <= 2e-5


def _fwd_rows(g, n, l, width, layout, vocab):
    """n forward rows of l lanes holding each term at most once in their first `width`
    lanes: "holes" (a random term per lane, 30% of lanes -1 anywhere) or "packed"
    (tid-ascending live lanes first, then -1 pads, lengths 0..width, as the snapshot
    builders lay them out)."""
    tids = torch.full((n, l), -1, dtype=torch.int32)
    tids[:, :width] = torch.argsort(torch.rand((n, vocab), generator=g), dim=1)[:, :width].to(torch.int32)
    if layout == "holes":
        tids[:, :width][torch.rand((n, width), generator=g) < 0.3] = -1
    else:
        lens = torch.randint(0, width + 1, (n, 1), generator=g)
        live = torch.arange(width)[None, :] < lens
        tids[:, :width] = torch.where(live, torch.sort(tids[:, :width], dim=1).values, -1)
    return tids


def _query_slots(g, b, q, vocab, dev):
    """[B, Q] slots (-1 pads) and idf k/4 > 0; every query of >= 2 slots repeats its
    first term in its last slot."""
    tq = torch.randint(-1, vocab, (b, q), generator=g, dtype=torch.int32)
    if q >= 2:
        tq[:, -1] = tq[:, 0]
    iq = torch.where(tq >= 0, torch.randint(1, 5, (b, q), generator=g) / 4.0, 0.0).float()
    return tq.to(dev), iq.to(dev)


def _assert_k3_equal_plain(fused, cand, tq, iq):
    k3 = counters().get("wax_k3_rescore_fused", 0)
    ks, kc = rs.rescore_fused(fused, cand, tq, iq)
    assert counters().get("wax_k3_rescore_fused", 0) == k3 + (1 if cand.numel() else 0)
    ps, pc = rs._rescore_fused_plain(fused, cand, tq, iq)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    return ks, kc


_K3_CASES = [(16, 64), (1, 64), (128, 192)] + [(q, l2) for l2 in (64, 128, 256, 512) for q in (1, 16, 33, 128)
                                               if (q, l2) != (16, 64) and (q, l2) != (1, 64)]


@pytest.mark.parametrize("q,l2", _K3_CASES)
def test_k3_rescore_equal_plain_on_exact_data(dev, q, l2):
    """K3 bit-equal to its plain twin on exact-arithmetic and random weights, at every
    register width (L2 64-512) and Q 1-128: 37 queries x 256 candidates on rows with
    holes, then one query of F 1, 7, 256 and 257 candidates on holey and on left-packed
    rows, queries that repeat a term."""
    g = torch.Generator().manual_seed(q + l2)
    n, b, f = 3000, 37, 256
    vocab = 400 if l2 <= 400 else 1024
    # each row holds a term once, as a forward index does
    tids = torch.argsort(torch.rand((n, vocab), generator=g), dim=1)[:, :l2].to(torch.int32)
    tids[torch.rand((n, l2), generator=g) < 0.3] = -1
    w_real = torch.rand((n, l2), generator=g)  # random weights: bit-equal too (slot order)
    w = (torch.randint(1, 9, (n, l2), generator=g) / 8.0).float()
    fused = torch.cat([tids, w.view(torch.int32)], dim=1).to(dev)
    cand = torch.randint(-1, n, (b, f), generator=g, dtype=torch.int32).to(dev)
    tq = torch.randint(-1, vocab, (b, q), generator=g, dtype=torch.int32).to(dev)
    iq = torch.where(tq >= 0, (torch.randint(1, 5, (b, q), generator=g) / 4.0).to(dev), 0.0).float()
    _assert_k3_equal_plain(fused, cand, tq, iq)
    fused_real = torch.cat([tids, w_real.view(torch.int32)], dim=1).to(dev)
    iq_real = torch.where(tq >= 0, torch.rand((b, q), generator=g).to(dev) + 0.5, 0.0).float()
    _assert_k3_equal_plain(fused_real, cand, tq, iq_real)
    for layout in ("holes", "packed"):
        lt = _fwd_rows(g, n, l2, l2, layout, vocab)
        lw = torch.where(lt >= 0, torch.rand((n, l2), generator=g) + 0.01, 0.0).float()
        lf = torch.cat([lt, lw.view(torch.int32)], dim=1).to(dev)
        for f1 in (1, 7, 256, 257):
            c1 = torch.randint(-1, n, (1, f1), generator=g, dtype=torch.int32).to(dev)
            t1, i1 = _query_slots(g, 1, q, vocab, dev)
            _assert_k3_equal_plain(lf, c1, t1, i1)
        # every candidate holds every live slot's term: the counts reach Q
        t1 = lt[c1[0, 1:2].clamp(min=0).cpu().long(), :q].to(dev)
        _assert_k3_equal_plain(lf, c1, t1.contiguous(), torch.where(t1 >= 0, 0.75, 0.0).float().contiguous())


def test_k3_k5_every_plan_instance(dev):
    """Every launch instance `wax_k3k5_plan` can choose (K3 at L2 64-512, K5 narrow and
    wide at L 32-512) agrees with the plain mirror `launch_plan` and with its plain twin
    bit for bit, on left-packed rows with random weights and 16-slot queries; F 75 is
    no multiple of the candidates per CTA."""
    g = torch.Generator().manual_seed(9)
    n, b, f, q, vocab = 2000, 5, 75, 16, 1024
    seen = set()
    for split, widths in ((False, range(64, 513, 64)), (True, range(32, 513, 32))):
        for l in widths:
            for width in ((64, l) if split and l >= 64 else (l,)):
                plan = rs.device_plan(split, width, b, f)
                assert {k: v for k, v in plan.items() if k != "ctas_per_sm"} == rs.launch_plan(width, b, f)
                assert plan["ctas_per_sm"] >= 1 and plan["nl"] * 32 // plan["cpw"] >= width
                seen.add((split, plan["nl"], plan["cpw"]))
                tids = _fwd_rows(g, n, l, width, "packed", vocab)
                w = torch.where(tids >= 0, torch.rand((n, l), generator=g) + 0.01, 0.0).float()
                w[tids[:, 0] == 5] = 0.0  # a tombstoned row: live tids, weights 0
                cand = torch.randint(-1, n, (b, f), generator=g, dtype=torch.int32).to(dev)
                tq, iq = _query_slots(g, b, q, vocab, dev)
                if split:
                    ft, fw = tids.to(dev), w.to(dev)
                    got = rs.rescore_split(ft, fw, cand, tq, iq, width)
                    want = rs._rescore_split_plain(ft, fw, cand, tq, iq, width)
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (l, width)
                else:
                    _assert_k3_equal_plain(torch.cat([tids, w.view(torch.int32)], dim=1).to(dev), cand, tq, iq)
    assert seen == {(False, 4, 2), (False, 8, 2), (False, 8, 1), (False, 16, 1), (True, 2, 2), (True, 4, 2),
                    (True, 8, 2), (True, 8, 1), (True, 16, 1)}


@pytest.mark.parametrize("mode", ["any", "count"])
@pytest.mark.parametrize("n_terms,case", [(1, "random"), (16, "random"), (40, "random"), (100, "random"),
                                          (16, "serving"), (5, "sentinel"), (32, "repeat")],
                         ids=["1", "16", "40", "100", "serving", "sentinel", "repeat"])
def test_k4_chunked_sel_equal_plain(dev, mode, n_terms, case):
    """Bit-equal to the plain twin at 32 slots (the register network: 1, 5, 16 and 32
    terms) and at 64 and 128 (the scratch-plane body: 40 and 100 terms); at the serving
    shape (B 256, 16-term queries), with the sentinel block in the windows (5 terms fill
    at most 20 of 32 slots), and with one row set in all 32 slots (runs of 32 equal rows:
    the segmented-sum window at its full 2^seg_log2, and at half of it)."""
    rng = np.random.default_rng(n_terms)
    n_rows, t = 200_000, 128
    sizes = rng.integers(1, 4000, t)
    if case == "repeat":  # every term holds the same 1,000 rows: one chunk each
        base = np.sort(rng.choice(n_rows, 1000, replace=False))
        sizes = np.full(t, 1000)
        rows = np.concatenate([base] * t).astype(np.int32)
    else:
        rows = np.concatenate([np.sort(rng.choice(n_rows, m, replace=False)) for m in sizes]).astype(np.int32)
    wn = rng.random(len(rows)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    pk, cb, cc, qb = build_impact_chunks(*map(torch.from_numpy, (rows, wn, offsets, rng.random(t) + 0.5)), n_rows)
    pk, cb, cc = (a.to(dev) for a in (pk, cb, cc))
    b = 256 if case == "serving" else 9
    tids = torch.from_numpy(np.stack([rng.choice(t, n_terms, replace=False) for _ in range(b)]).astype(np.int32))
    slots = ck.slots_for_query(n_terms)
    dead = pk.shape[0] // PK_CHUNK - 1
    win = ck.pack_query_chunks(tids.to(dev), cb, cc, slots, int(cc.max()), dead)
    if case == "sentinel":
        assert bool((win == dead).any(dim=1).all())
    seg = max(1, int(np.ceil(np.log2(2 * n_terms))))
    for sg in (5, 4) if case == "repeat" else (seg,):  # the window equals the runs of 32, or half of them
        k4 = counters().get("wax_k4_chunked_sel", 0)
        kr, kk = ck.chunked_sel(win, pk, qb=qb, seg_log2=sg, mode=mode)
        assert counters().get("wax_k4_chunked_sel", 0) == k4 + 1
        pr, pkeys = ck._chunked_sel_plain(win, pk, qb, sg, mode, 3)
        assert torch.equal(kk, pkeys) and torch.equal(kr, pr), sg
        assert bool((pr >= 0).any())


def _assert_packed_near(got, ref, scores, k, tn, what):
    """Merged top-k of two packed-key outputs: decoded scores within 1e-5 + 2^-12 |s|,
    every differing row a near-tie of the k-th exact score, overlap >= 0.999."""
    (gv, gr), (rv, rr) = (fs._merge_tiles(*fs._decode_packed(x, k, tn), k) for x in (got, ref))
    assert bool(((gv - rv).abs() <= 1e-5 + 2.0**-12 * rv.abs()).all()), what
    hit = 0
    for b in range(gr.shape[0]):
        a, p = set(gr[b].tolist()), set(rr[b].tolist())
        hit += len(a & p)
        kth = float(rv[b, k - 1])
        for row in a ^ p:
            assert row >= 0 and abs(float(scores[b, row]) - kth) <= 1e-5 + 2.0**-12 * abs(kth), (what, b, row)
    assert hit / gr.numel() >= 0.999, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,tn,d", [(13, 10, 4096, 2048, 96), (256, 24, 8192, 2048, 96),
                                        (64, 128, 2048, 1024, 96), (7, 1, 1536, 512, 96),
                                        (13, 10, 4096, 2048, 37), (200, 24, 8192, 2048, 37),
                                        (13, 128, 2048, 1024, 384), (200, 24, 8192, 2048, 384)])
def test_k9_equals_plain_on_exact_data_and_k1_on_any(dev, dtype, b, k, n, tn, d):
    """K9's tensor-core scores are exact on the 1/8 grid, so its keys equal the plain
    twin's and K1's bit for bit there; on random unit vectors its 3xTF32 scores sit
    within ~1e-6 of the f32 sums, so its keys may differ only at a 2^-12 bucket edge."""
    g = torch.Generator().manual_seed(b * 7 + k + d)
    q, emb = _grid(g, (b, d), dev, dtype), _grid(g, (n, d), dev, dtype)
    bias = torch.zeros(n, device=dev)
    bias[torch.randperm(n, generator=g)[: n // 10].to(dev)] = fs.NEG_INF
    k9 = counters().get("wax_k9_packed_topk", 0)
    got = fs.packed_topk_tiles(q, emb, bias, k, tn)
    assert counters().get("wax_k9_packed_topk", 0) == k9 + 1
    assert torch.equal(got, fs._packed_sel_topk_plain(q, emb, bias, k, tn))
    assert torch.equal(got, fs.packed_sel_tiles(q, emb, bias, k, tn))
    qr = fs.normalize_rows(torch.randn((b, d), generator=g)).to(dev, dtype).contiguous()
    er = fs.normalize_rows(torch.randn((n, d), generator=g)).to(dev, dtype).contiguous()
    got = fs.packed_topk_tiles(qr, er, bias, k, tn)
    scores = fs._scores_f32(qr, er) + bias[None, :]
    _assert_packed_near(got, fs._packed_sel_topk_plain(qr, er, bias, k, tn), scores, k, tn, "K9 vs plain")
    _assert_packed_near(got, fs.packed_sel_tiles(qr, er, bias, k, tn), scores, k, tn, "K9 vs K1")


def _split_forward(g, n, l, width, vocab=400):
    """A forward index of n rows x l lanes holding each term once in its first `width`
    lanes; weights k/8 > 0."""
    tids = torch.full((n, l), -1, dtype=torch.int32)
    tids[:, :width] = torch.argsort(torch.rand((n, vocab), generator=g), dim=1)[:, :width].to(torch.int32)
    tids[:, :width][torch.rand((n, width), generator=g) < 0.3] = -1
    w = torch.where(tids >= 0, torch.randint(1, 9, (n, l), generator=g) / 8.0, 0.0).float()
    return tids, w


_K5_CASES = [(16, 128, 64), (1, 128, 128), (128, 384, 384), (16, 512, 64)] + [
    (q, l, width) for l in (64, 128, 256, 512) for width in sorted({64, l}) for q in (1, 16, 33, 128)
    if (q, l, width) not in ((16, 128, 64), (1, 128, 128), (16, 512, 64))]


@pytest.mark.parametrize("q,l,width", _K5_CASES)
def test_k5_rescore_equal_plain_and_k3(dev, q, l, width):
    """K5 in its narrow (64 lanes) and wide forms bit-equal to its plain twin on
    exact-arithmetic and random weights, and to K3 on the same rows; then one query of
    F 1, 7, 256 and 257 on holey and left-packed rows with tombstoned rows (live tids,
    weights 0), queries that repeat a term."""
    g = torch.Generator().manual_seed(q + l + width)
    n, b, f = 3000, 37, 256
    vocab = 400 if l <= 400 else 1024
    tids, w = _split_forward(g, n, l, min(width, 200), vocab)
    cand = torch.randint(-1, n, (b, f), generator=g, dtype=torch.int32).to(dev)
    tq = torch.randint(-1, 400, (b, q), generator=g, dtype=torch.int32).to(dev)
    iq = torch.where(tq >= 0, (torch.randint(1, 5, (b, q), generator=g) / 4.0).to(dev), 0.0).float()
    ft, fw = tids.to(dev), w.to(dev)
    k5 = counters().get("wax_k5_rescore_split", 0)
    ks, kc = rs.rescore_split(ft, fw, cand, tq, iq, width)
    assert counters().get("wax_k5_rescore_split", 0) == k5 + 1
    ps, pc = rs._rescore_split_plain(ft, fw, cand, tq, iq, width)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    if l % 64 == 0:
        fused = torch.cat([tids, w.view(torch.int32)], dim=1).to(dev)  # K3's input, same data
        fs3, fc3 = rs.rescore_fused(fused, cand, tq, iq)
        assert torch.equal(ks, fs3) and torch.equal(kc, fc3)
    wr = torch.where(tids >= 0, torch.rand((n, l), generator=g) + 0.01, 0.0).float().to(dev)
    iqr = torch.where(tq >= 0, torch.rand((b, q), generator=g).to(dev) + 0.5, 0.0).float()
    (ks, kc), (ps, pc) = rs.rescore_split(ft, wr, cand, tq, iqr, width), \
        rs._rescore_split_plain(ft, wr, cand, tq, iqr, width)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    for layout in ("holes", "packed"):
        lt = _fwd_rows(g, n, l, width, layout, vocab)
        lw = torch.where(lt >= 0, torch.rand((n, l), generator=g) + 0.01, 0.0).float()
        lw[torch.rand(n, generator=g) < 0.1] = 0.0  # tombstoned rows
        lt, lw = lt.to(dev), lw.to(dev)
        for f1 in (1, 7, 256, 257):
            c1 = torch.randint(-1, n, (1, f1), generator=g, dtype=torch.int32).to(dev)
            t1, i1 = _query_slots(g, 1, q, vocab, dev)
            got, want = rs.rescore_split(lt, lw, c1, t1, i1, width), rs._rescore_split_plain(lt, lw, c1, t1, i1, width)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (layout, f1)


def _postings(rng, n_rows, sizes, exact):
    rows = np.concatenate([np.sort(rng.choice(n_rows, m, replace=False)) for m in sizes]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    if exact:  # multiples of 1/8, a tenth 0 (tombstoned rows)
        wn = (rng.integers(1, 9, len(rows)) / 8.0).astype(np.float32)
        idf = (rng.integers(1, 5, len(sizes)) / 4.0).astype(np.float32)
    else:
        wn = rng.random(len(rows)).astype(np.float32)
        idf = (rng.random(len(sizes)) + 0.5).astype(np.float32)
    wn[rng.random(len(rows)) < 0.1] = 0.0
    return rows, offsets, wn, idf


@pytest.mark.parametrize("sel", [0, 3])
@pytest.mark.parametrize("mode", ["any", "all", "count"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,split", [(13, None), (1, None), (2, None), (256, None), (13, 1), (1, 1), (2, 7),
                                     (1, "plan_max"), (13, 512)])
def test_k8_candidates_equal_plain(dev, exact, mode, sel, b, split):
    """K8 at the auto guard's widest window (W2 32,768 for 16 slots: max_df 31,744),
    rows over several 8,192-row tiles, batches of 1, 2, 13 and 256 queries (13: ragged,
    with an empty and an all -1 query, duplicated ids; tombstoned (weight 0) postings)
    at the plan's G CTAs a query and at forced ones (1, 7, the largest plan, 512):
    bit-equal to its twin, one launch a call."""
    rng = np.random.default_rng(int(exact) * 10 + sel)
    n_rows, t = 60_000, 40
    sizes = rng.integers(0, 3000, t)
    sizes[:3] = (31_744, 20_000, 9)
    rows, offsets, wn, idf = _postings(rng, n_rows, sizes, exact)
    tids = rng.integers(0, t, (max(b, 13), 16)).astype(np.int32)
    tids[:, :2] = rng.integers(0, 3, (len(tids), 2))
    tids[rng.random(tids.shape) < 0.2] = -1
    tids[4] = -1
    tids[5, 1] = tids[5, 0]
    tids[6, 3:] = -1
    tids = tids[[0, 5, 6, 4, 1, 2, 3, *range(7, len(tids))][:b]]  # B 1 and 2 keep the duplicate and the ragged
    args = [torch.from_numpy(a).to(dev) for a in (rows, wn, offsets, idf)]
    tq = torch.from_numpy(tids).to(dev)
    assert k8.dma_window(31_744) == 32_768
    if split == "plan_max":
        split = k8.device_plan(1, 16, 32_768, sel, dev)["g"]
    n8 = counters().get("wax_k8_candidates", 0)
    got = k8.candidate_scores_pallas(tq, *args, max_df=31_744, mode=mode, sel=sel, split=split)
    assert counters().get("wax_k8_candidates", 0) == n8 + 1
    want = k8._candidate_scores_plain(tq, *args, 16, 32_768, mode, sel)
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and torch.equal(a, c)
    assert (got[0] >= 0).any() or mode == "all"
    if b == 13:
        assert (got[0][3] == -1).all()
        narrow = k8.candidate_scores_pallas(tq[:, :3].contiguous(), *args, max_df=31_744, mode=mode, sel=sel,
                                            split=split)
        for a, c in zip(narrow, k8._candidate_scores_plain(tq[:, :3], *args, 4, 32_768, mode, sel)):
            assert torch.equal(a, c)
    again = k8.candidate_scores_pallas(tq, *args, max_df=31_744, mode=mode, sel=sel, split=split)
    assert all(torch.equal(a, c) for a, c in zip(again, got))  # the sel merge's tickets were left at zero


@pytest.mark.parametrize("sel", [0, 3])
def test_k8_orch_sharded_shape(dev, sel):
    """[orch_sharded]'s shard shape: B 1, 16 terms over 25,600 rows, max_df 31,744 (W2
    32,768, a 4 MiB plane), `all` and `any`, with rows every term holds: bit-equal to
    the twin at the plan's G and at G 1."""
    rng = np.random.default_rng(31 + sel)
    n_rows, t = 25_600, 24
    sizes = rng.integers(800, 2600, t)
    rows, offsets, wn, idf = _postings(rng, n_rows, sizes, False)
    common = np.sort(rng.choice(n_rows, 40, replace=False))
    for k in range(t):  # 40 rows in every term's slice
        sl = slice(offsets[k], offsets[k + 1])
        rows[sl] = np.sort(np.union1d(common, rng.choice(np.setdiff1d(np.arange(n_rows), common),
                                                         sizes[k] - 40, replace=False)))
    args = [torch.from_numpy(a).to(dev) for a in (rows, wn, offsets, idf)]
    tq = torch.from_numpy(rng.choice(t, (1, 16), replace=False).astype(np.int32)).to(dev)
    plan = k8.device_plan(1, 16, 32_768, sel, dev)
    assert plan["g"] == k8.launch_plan(1, 16, 32_768, plan["sms"], plan["ctas_per_sm"], sel)["g"] > 1
    for mode in ("all", "any"):
        want = k8._candidate_scores_plain(tq, *args, 16, 32_768, mode, sel)
        for split in (None, 1):
            got = k8.candidate_scores_pallas(tq, *args, max_df=31_744, mode=mode, sel=sel, split=split)
            assert all(torch.equal(a, c) for a, c in zip(got, want)), (mode, split)
        assert (want[0] >= 0).any()


def test_k8_launch_plans(dev):
    """The C plan (`wax_k8_plan`) is `launch_plan` at the card's SMs and CTAs an SM:
    at sel 0 G fills the card at small B and is 1 once B does; at sel > 0 it covers
    Q2 slices of W2 / 2 postings at WALK_MIN a CTA."""
    for b in (1, 2, 13, 64, 131, 132, 256, 4096):
        for q2, w2 in ((16, 32_768), (4, 2048), (2, 2048), (1024, 2048), (64, 65_536), (16, 262_144)):
            for sel in (0, 3):
                plan = k8.device_plan(b, q2, w2, sel, dev)
                mirror = k8.launch_plan(b, q2, w2, plan["sms"], plan["ctas_per_sm"], sel)
                assert {key: plan[key] for key in mirror} == mirror, (b, q2, w2, sel, plan)
                assert plan["ctas_per_sm"] >= 1 and plan["smem_bytes"] <= 232_448


@pytest.mark.parametrize("b", [32, 256])
def test_k8_walk_at_hybrid_density(dev, b):
    """K8's postings walk at hybrid_msmarco1.b256's shape (B 32 and 256, Q2 16, W2
    262,144, sel 3; about 9M row ids, Zipf slices cut to 131,072) at the plan's G and
    forced ones (1, 7, 512): bit-equal to its twin (per 16 queries) in every mode, one
    launch a call counted as `k8.walk.postings`, and a second call equal to the first
    (the merge's tickets were left at zero)."""
    from chip_smoke import zipf_postings, zipf_queries

    rows, wn, offsets, idf = zipf_postings(dev)
    tq = torch.from_numpy(zipf_queries(np.random.default_rng(b), b)).to(dev)
    max_df = int((offsets[1:] - offsets[:-1]).max())
    assert k8.dma_window(max_df) == 262_144
    for mode in ("any", "all", "count"):
        want = [k8._candidate_scores_plain(tq[i:i + 16], rows, wn, offsets, idf, 16, 262_144, mode, 3)
                for i in range(0, b, 16)]
        want = [torch.cat(x, 0) for x in zip(*want)]
        for split in (None, 1, 7, 512):
            n8, nw = counters().get("wax_k8_candidates", 0), counters().get("k8.walk.postings", 0)
            got = k8.candidate_scores_pallas(tq, rows, wn, offsets, idf, max_df=max_df, mode=mode, sel=3, split=split)
            assert counters().get("wax_k8_candidates", 0) == n8 + 1
            assert counters().get("k8.walk.postings", 0) == nw + 1
            assert all(torch.equal(a, c) for a, c in zip(got, want)), (mode, split)
            again = k8.candidate_scores_pallas(tq, rows, wn, offsets, idf, max_df=max_df, mode=mode, sel=3,
                                               split=split)
            assert all(torch.equal(a, c) for a, c in zip(again, got))
        assert (want[0] >= 0).any()


def _tf32_blind_centroids(c: int, d: int) -> torch.Tensor:
    """[c, d] centroids whose best match for the all-ones-in-two-dims query needs f32:
    centroid 1 (1 + 2^-12 on dim 1) beats centroid 0 (1 + 2^-13 on dim 0) in f32; TF32
    rounds both to 1 and ties them, so its first maximum is centroid 0. The rest point
    away (-1 on dim 2)."""
    cent = torch.zeros((c, d))
    cent[:, 2] = -1.0
    cent[0, :3] = torch.tensor([1 + 2**-13, 0.0, 0.0])
    cent[1, :3] = torch.tensor([0.0, 1 + 2**-12, 0.0])
    return cent


TF32_PATHS = ["scores_f32", "blockmax16_rescore", "kmeans_assign", "centroid_sums", "probe_selection",
              "probe_loop_scores", "incremental_placement", "blockmax16_ties", "k6_twin", "k7_twin"]


@pytest.mark.parametrize("path", TF32_PATHS)
def test_f32_products_hold_with_tf32_on(dev, path):
    """With TF32 turned on process-wide (`torch.backends.cuda.matmul.allow_tf32`), the
    port's f32 product paths still compute in f32 and equal their CPU results: the
    `xla` scan's scores (`flat_scan._scores_f32`) and blockmax16's exact rescore, the
    IVF build's centroid sums and the plain probe loop's scores (within 1e-5 on unit
    vectors); k-means assignment (`ivf._assign`), IVF probe selection
    (`ivf.ivf_search_topk`) and the IVF engine's incremental placement
    (`_try_incremental`) on centroids only f32 tells apart. Without the f32 pin
    (`utils.device.full_f32_matmul`) five of these differed on an H100: scores by
    8.1e-05, centroid sums by 4.55e-05, probe-loop scores by 0.0409, and the assignment
    and placement picked centroid 0 for 1; blockmax16's rescore and probe selection at
    these shapes held without it. On rows only f32 tells apart, blockmax16's exact
    rescore and the plain twins of K6 (`_chunk_maxima_plain`) and K7
    (`_bucket_rescore_plain`) give the same bits with TF32 on as off, and rank row 1
    first."""
    from wax_tpu_torch.index import ivf as ivfm
    from wax_tpu_torch.search.vector_engines import IVFVectorEngine

    g = torch.Generator().manual_seed(11)
    d, c = 384, 1024
    cent = _tf32_blind_centroids(c, d)
    ones = torch.zeros((4096, d))
    ones[:, :2] = 1.0
    q = fs.normalize_rows(torch.randn((256, d), generator=g))
    emb = fs.normalize_rows(torch.randn((8192, d), generator=g))

    def close(fn, *args):
        got, want = fn(*[a.to(dev) for a in args]), fn(*args)
        for x, y in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            err = float((x.cpu().float() - y.float()).abs().max())
            assert err <= 1e-5, f"{path}: max |card - CPU| = {err:.3g}"

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        if path == "scores_f32":
            close(fs._scores_f32, q, emb)
        elif path == "blockmax16_rescore":
            bias = torch.zeros(8192)
            got = fs._blockmax16_topk(q.to(dev), emb.to(dev), bias.to(dev), 10)
            want = fs._blockmax16_topk(q, emb, bias, 10)
            err = float((got[0].cpu() - want[0]).abs().max())
            assert err <= 1e-5, f"{path}: max |card - CPU| = {err:.3g}"
        elif path in ("blockmax16_ties", "k6_twin", "k7_twin"):
            qq, rows, zero = ones[:8].to(dev), cent.to(dev), torch.zeros(c, device=dev)
            probes = torch.zeros((8, 1), dtype=torch.int32, device=dev)  # bucket 0: rows 0-127
            full = torch.full((c // 128,), 128, dtype=torch.int32, device=dev)
            run = {"blockmax16_ties": lambda: fs._blockmax16_topk(qq, rows, zero, 4),
                   "k6_twin": lambda: (cm._chunk_maxima_plain(qq, rows, zero),),
                   "k7_twin": lambda: ivf._bucket_rescore_plain(qq, probes, full, rows.reshape(-1, 128, d), 4)}[path]
            got = run()
            torch.backends.cuda.matmul.allow_tf32 = False
            want = run()
            torch.backends.cuda.matmul.allow_tf32 = True
            for x, y in zip(got, want):
                assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                                   y.view(torch.int32) if y.is_floating_point() else y), path
            if path == "k6_twin":
                assert bool((got[0][:, 0] == 1 + 2**-12).all())
            else:
                assert bool((got[1][:, 0] == 1).all()), f"{path}: TF32 ranked {got[1][:, 0].tolist()} first"
        elif path == "centroid_sums":
            assign = torch.randint(0, 64, (8192,), generator=g)
            close(lambda v, a: ivfm._update_centroids(v, a, 64)[0], emb, assign)
        elif path == "kmeans_assign":
            got = ivfm._assign(ones.to(dev), cent.to(dev)).cpu()
            assert torch.equal(got, ivfm._assign(ones, cent)) and bool((got == 1).all()), \
                f"{path}: card assigns {got.unique().tolist()}, the CPU {ivfm._assign(ones, cent).unique().tolist()}"
        else:
            s = 128
            bucket = torch.zeros((c, s, d))
            ids = torch.full((c, s), -1, dtype=torch.int32)
            bias = torch.full((c, s), fs.NEG_INF)
            bucket[:, 0, 0] = 1.0  # one live row a bucket, frame id = its bucket
            ids[:, 0] = torch.arange(c, dtype=torch.int32)
            bias[:, 0] = 0.0

            def index(device, centroids=cent, rows=bucket):
                return ivfm.IVFIndex(centroids=centroids.to(device), emb=rows.to(device), ids=ids.to(device),
                                     bias=bias.to(device))

            if path == "probe_selection":
                _, f = ivfm.ivf_search_topk(ones[:8].to(dev), index(dev), k=1, nprobe=1)
                _, f_cpu = ivfm.ivf_search_topk(ones[:8], index("cpu"), k=1, nprobe=1)
                assert torch.equal(f.cpu(), f_cpu) and bool((f_cpu == 1).all()), \
                    f"{path}: card probes {f.cpu().unique().tolist()}, the CPU {f_cpu.unique().tolist()}"
            elif path == "probe_loop_scores":
                rows = fs.normalize_rows(torch.randn((c, s, d), generator=g))
                cents = fs.normalize_rows(torch.randn((c, d), generator=g))
                v, _ = ivfm.ivf_search_topk(q.to(dev), index(dev, cents, rows), k=10, nprobe=4)
                v_cpu, _ = ivfm.ivf_search_topk(q, index("cpu", cents, rows), k=10, nprobe=4)
                err = float((v.cpu() - v_cpu).abs().max())
                assert err <= 1e-5, f"{path}: max |card - CPU| = {err:.3g}"
            else:
                placed = {}
                for device in (dev, "cpu"):
                    eng = IVFVectorEngine(dim=d, device=device)
                    eng._snap = index(device)
                    eng._pending_adds = [(10_000 + i, ones[0].numpy()) for i in range(4)]
                    snap = eng._try_incremental()
                    placed[str(device)] = torch.nonzero(snap.ids.cpu() >= 10_000)[:, 0]
                assert torch.equal(placed[str(dev)], placed["cpu"]) and bool((placed["cpu"] == 1).all()), \
                    f"{path}: card places in buckets {placed[str(dev)].tolist()}, the CPU {placed['cpu'].tolist()}"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _hnsw_grid_graph(n: int = 2048, d: int = 64):
    """A numpy-builder graph (normalize=False) over 1/8-grid rows with a few dead rows,
    and grid queries: every product of the beam search is exact in f32."""
    from wax_tpu_torch.index.graph import HNSWBuilder

    rng = np.random.default_rng(2)
    b = HNSWBuilder(dim=d, m=8, ef_construction=40, normalize=False)
    b.add_batch(np.arange(n), (rng.integers(-8, 9, (n, d)) / 8.0).astype(np.float32))
    for fid in range(0, n, 97):
        b.remove(fid)
    return b, torch.from_numpy((rng.integers(-8, 9, (64, d)) / 8.0).astype(np.float32))


def test_hnsw_search_cuda_equals_cpu_and_ignores_tf32(dev):
    """`hnsw_search` on the card equals its CPU run bit for bit on the grid graph at ef
    16 and 64, also with TF32 turned on process-wide, and the caller's TF32 setting is
    restored afterwards. On random unit vectors TF32 would round both products (the
    seed product and the per-step row product); `full_f32_matmul` keeps them f32."""
    from wax_tpu_torch.index.graph_cpp import CppHNSWBuilder
    from wax_tpu_torch.ops.beam_search import hnsw_search

    b, q = _hnsw_grid_graph()
    cpu, card = b.snapshot(device="cpu"), b.snapshot(device=dev)
    assert card.device.type == "cuda" and card.adjacency.shape[1] == 24
    for ef in (16, 64):
        want = hnsw_search(q, cpu, k=10, ef=ef)
        got = hnsw_search(q.to(dev), card, k=10, ef=ef)
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
    rng = np.random.default_rng(4)
    unit = rng.standard_normal((4096, 384)).astype(np.float32)
    ub = CppHNSWBuilder(dim=384)
    ub.add_batch(np.arange(4096), unit)
    ug = ub.snapshot(device=dev)
    uq = fs.normalize_rows(torch.from_numpy(rng.standard_normal((128, 384)).astype(np.float32))).to(dev)
    off = hnsw_search(uq, ug, k=10, ef=64)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = hnsw_search(uq, ug, k=10, ef=64)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for x, y in zip(on, off):
        assert torch.equal(x, y)


def test_hnsw_engine_on_the_card(dev):
    """The engine builds with the native builder and keeps its snapshot on the card;
    its answers equal a CPU engine's over the same adds at ef 64 on rows of four
    entries of +-0.5 (unit norm, so the engine's normalisation keeps every product
    exact)."""
    from wax_tpu_torch.index.graph_cpp import CppHNSWBuilder
    from wax_tpu_torch.search.vector_engines import HNSWVectorEngine

    rng = np.random.default_rng(6)
    rows = np.zeros((3000, 32), np.float32)
    for r in rows:
        r[rng.choice(32, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    card, cpu = HNSWVectorEngine(dim=32, device=dev), HNSWVectorEngine(dim=32, device="cpu")
    for e in (card, cpu):
        e.add_batch(np.arange(3000), rows)
    assert isinstance(card.builder, CppHNSWBuilder)
    snap = card.snapshot()
    assert snap.device.type == "cuda" and snap.emb.is_cuda and snap.adjacency.is_cuda
    card.trace(snap)
    cv, cf = card.search(rows[:40], 10)
    pv, pf = cpu.search(rows[:40], 10)
    assert np.array_equal(cf, pf) and np.array_equal(cv, pv)


def test_orchestrator_maintenance_on_the_card_equals_cpu(dev, tmp_path):
    """A 4,096-document orchestrator on the card, then a forget of 10%, a compaction and
    a live-set rewrite: after each step its answers (ids, lanes, scores within rtol
    1e-6) equal a CPU orchestrator's after the same steps, its snapshots are rebuilt
    on the card and its vector lane runs K1. Texts embed to rows of four entries of
    +-0.5 (unit norm), so every product is exact and K1 ranks as its plain twin."""
    import hashlib

    from wax_tpu_torch.embed.hash_embedder import HashEmbedder
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig

    class GridEmbedder(HashEmbedder):
        def embed(self, text):
            seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
            rng = np.random.default_rng(seed)
            v = np.zeros(self.dimensions, np.float32)
            v[rng.choice(self.dimensions, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
            return v

        def embed_batch(self, texts):
            return np.stack([self.embed(t) for t in texts])

    rng = np.random.default_rng(13)
    words = [f"w{i}" for i in range(600)]
    p = 1.0 / np.arange(1, len(words) + 1)
    docs = [" ".join(rng.choice(words, 12, p=p / p.sum())) for _ in range(4096)]
    queries = [" ".join(rng.choice(words[:200], 3, replace=False)) for _ in range(32)]
    gone = rng.permutation(4096)[:409].tolist()
    cfg = OrchestratorConfig(enable_access_stats=False)
    card = MemoryOrchestrator(tmp_path / "card.mv2s", GridEmbedder(64), cfg, device=dev)
    cpu = MemoryOrchestrator(tmp_path / "cpu.mv2s", GridEmbedder(64), cfg, device="cpu")
    try:
        for o in (card, cpu):
            o.remember_batch(docs)
            o.flush()
            for fid in gone:
                o.forget(fid)
        for step in ("compact_indexes", "rewrite_live_set"):
            for o in (card, cpu):
                getattr(o.maintainer, step)()
            assert len(card.engine.vector) == len(cpu.engine.vector) == 4096 - 409
            k1 = counters().get("wax_k1_packed_sel", 0)
            for q in queries:
                a, b = cpu.search(q), card.search(q)
                assert [h.frame_id for h in a.hits] == [h.frame_id for h in b.hits], (step, q)
                np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits], rtol=1e-6)
                assert a.lane_counts == b.lane_counts
            assert counters().get("wax_k1_packed_sel", 0) - k1 == len(queries)
            assert card.engine.vector.snapshot().emb.is_cuda and card.engine.lex_snapshot().device.type == "cuda"
    finally:
        card.close()
        cpu.close()


def test_trainer_on_the_card_equals_cpu(dev, tmp_path):
    """The contrastive Trainer at the CPU tests' small config in f32 (TF32 off): three
    steps on the card give the CPU's losses within rtol 1e-4, and a checkpoint written
    on the card resumes on the CPU with the card's next losses."""
    from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEncoder
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.train import Trainer

    cfg = MiniLMConfig(hidden=64, layers=2, heads=4, intermediate=128, vocab_size=1000, max_positions=64)
    model = MiniLMEncoder(cfg, dtype=torch.float32)
    model.init_random(torch.Generator().manual_seed(0))
    init = {n: t.clone() for n, t in model.state_dict().items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, (4, 16, 24)).astype(np.int32)
    mask = (np.arange(24)[None, None, :] < rng.integers(8, 25, (4, 16, 1))).astype(np.int32)
    batches = [{"q_ids": ids[i] * mask[i], "q_mask": mask[i], "d_ids": ids[(i + 1) % 4] * mask[i],
                "d_mask": mask[i]} for i in range(4)]
    losses, states = {}, {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        trainer = Trainer(model, data_mesh(device), learning_rate=2e-5)
        state = trainer.init_state(init)
        out = []
        for b in batches[:3]:
            state, loss = trainer.step(state, b)
            out.append(float(loss))
        losses[name], states[name] = out, (trainer, state)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    card, card_state = states["cuda"]
    card.save_checkpoint(card_state, tmp_path / "ck.npz")
    _, next_card = card.step(card_state, batches[3])
    cpu, _ = states["cpu"]
    resumed = cpu.load_checkpoint(cpu.init_state(init), tmp_path / "ck.npz")
    assert int(resumed.step) == 3
    _, next_cpu = cpu.step(resumed, batches[3])
    np.testing.assert_allclose(float(next_cpu), float(next_card), rtol=1e-4)


@pytest.mark.parametrize("tp", [1, 2])
def test_trainer_f32_holds_with_tf32_on(dev, tp):
    """With TF32 turned on process-wide, the encoder's f32 forward and the trainer's f32
    loss and gradients on 4 logical shards of the card (data 4, or data 2 x tp 2) are
    bit for bit as with it off (the pin: `utils.device.f32_products`), and agree with
    the same mesh of CPU shards: hidden states within 1e-5, the loss within rtol 1e-6."""
    from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEncoder
    from wax_tpu_torch.parallel.mesh import make_mesh
    from wax_tpu_torch.parallel.train import Trainer

    cfg = MiniLMConfig(hidden=64, layers=2, heads=4, intermediate=128, vocab_size=1000, max_positions=64)
    model = MiniLMEncoder(cfg, dtype=torch.float32)
    model.init_random(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(1, 1000, (16, 24), generator=g, dtype=torch.int32) for k in ("q_ids", "d_ids")}
    batch.update({k: (torch.arange(24)[None, :] < torch.randint(4, 25, (16, 1), generator=g)).to(torch.int32)
                  for k in ("q_mask", "d_mask")})

    def run(device):
        on = {k: v.to(device) for k, v in batch.items()}
        model.to(device)
        with torch.no_grad():
            hidden = model(on["q_ids"], on["q_mask"])
        trainer = Trainer(model, make_mesh([device] * 4, tp=tp))
        loss, grads = trainer.loss_and_grads(trainer.init_state(model.state_dict()).params, on)
        return hidden.cpu(), loss.cpu(), {n: t.cpu() for n, t in grads.items()}

    off = run(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = run(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert all(torch.equal(on[2][n], off[2][n]) for n in off[2])
    hidden, loss, _ = run(torch.device("cpu"))
    assert float((off[0] - hidden).abs().max()) <= 1e-5
    np.testing.assert_allclose(float(off[1]), float(loss), rtol=1e-6)
