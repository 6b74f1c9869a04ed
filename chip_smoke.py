#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's hybrid query path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing lines tagged with its name:

  device   require CUDA, print the card's name and power limit (nvidia-smi), turn TF32 off
  build    compile wax_tpu_torch/csrc/*.cu (nvcc, sm_90a) and print the seconds
  kernels  hold kernels K1 (packed-key scan) and K2 (exact scan) against their plain
           torch twins: exact-arithmetic data must agree bit for bit, random unit
           vectors within the stated tolerances; kernel and plain times (CUDA events)
  ingest   102,400 synthetic documents (32 Zipf words each) into a HybridSearchEngine
           on the card: BM25 builder on the host, full-width MiniLM (random weights,
           bf16) in batches of 256 into the flat vector engine
  serve    4 batches of 256 text queries through both lanes (vector lane: embed +
           FlatVectorEngine.search, whose "auto" backend is K1; BM25 lane: bm25_topk,
           `any` mode x3 and `all` mode x1) and weighted RRF, plus one batch of
           exact-score requests (flat_scan_topk backend="pallas_exact", K2); launch
           counts are reset before and read after this phase
  checks   repeat serving is bit-identical; vector-lane top-10 against the plain exact
           scan of the snapshot copied to the CPU; BM25 lane against the CPU scorer;
           the bf16 encoder against its f32 CPU run

It exits non-zero on any failure, and when no CUDA device is present. The line before
the last is a JSON object of per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FETCH_K = 24  # unified_search's candidate depth floor
WEIGHTS = {"bm25": 0.5, "vector": 0.5}  # the EXPLORATORY query type's lane weights
N_DOCS, DOC_WORDS, VOCAB_WORDS = 102_400, 32, 8192
# K1 returns scores truncated to 2^-12 relative. The kernel and its twin sum in
# different orders, so a score within an ulp of a truncation boundary can land one
# step apart: K1's tolerance is the f32 tolerance plus one truncation step.
F32_TOL = 1e-5
TRUNC_REL = 2.0**-12


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------------------ device


def device_phase():
    import torch

    if not torch.cuda.is_available():
        fail("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return torch.device("cuda:0"), smi


# ------------------------------------------------------------------------------- build


def build_phase() -> None:
    from wax_tpu_torch.ops import _build

    path, secs, out = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    log("build", f"{path.name} built in {secs:.3f} s")
    for ln in regs:
        log("build", ln)


# ----------------------------------------------------------------------------- kernels


def _kernel_case(name, q, emb, bias, k, tn, exact, timed, results):
    """Run K1 and K2 on one input against their plain twins; record errors/times."""
    import torch

    from wax_tpu_torch.ops import flat_scan as fs

    scores = fs._scores_f32(q, emb) + bias[None, :]  # exact scores for near-tie checks
    for kern in ("K1", "K2"):
        if kern == "K1":
            def run_kernel():
                return fs.packed_sel_tiles(q, emb, bias, k, tn)

            def run_plain():
                return fs._packed_sel_topk_plain(q, emb, bias, k, tn)

            got, ref = run_kernel(), run_plain()
            torch.cuda.synchronize()
            if exact:
                check(torch.equal(got, ref), f"{name}: K1 keys differ from the plain twin")
            kv, kr = fs._merge_tiles(*fs._decode_packed(got, k, tn), k)
            pv, pr = fs._merge_tiles(*fs._decode_packed(ref, k, tn), k)
        else:
            def run_kernel():
                return fs.scan_topk_tiles(q, emb, bias, k, tn)

            def run_plain():
                return fs._scan_topk_plain(q, emb, bias, k, tn)

            (gv, gr), (rv, rr) = run_kernel(), run_plain()
            torch.cuda.synchronize()
            if exact:
                check(torch.equal(gv, rv) and torch.equal(gr, rr), f"{name}: K2 tiles differ from the plain twin")
            else:
                check(float((gv - rv).abs().max()) <= F32_TOL, f"{name}: K2 tile values beyond {F32_TOL}")
            kv, kr = fs._merge_tiles(gv, gr, k)
            pv, pr = fs._merge_tiles(rv, rr, k)
        err = float((kv - pv).abs().max())
        if exact:
            check(torch.equal(kv, pv) and torch.equal(kr, pr), f"{name}: {kern} top-k differs from the plain twin")
            overlap = 1.0
        else:
            tol = F32_TOL + (TRUNC_REL * pv.abs() if kern == "K1" else 0.0)
            check(bool(((kv - pv).abs() <= tol).all()), f"{name}: {kern} scores beyond tolerance (max {err:.3g})")
            hit = 0
            for b in range(kr.shape[0]):
                a, p = set(kr[b].tolist()), set(pr[b].tolist())
                hit += len(a & p)
                kth = float(pv[b, k - 1])
                slack = F32_TOL + (TRUNC_REL * abs(kth) if kern == "K1" else 0.0)
                for row in a ^ p:
                    check(row >= 0 and abs(float(scores[b, row]) - kth) <= slack,
                          f"{name}: {kern} row {row} of query {b} differs and is not a near-tie")
            overlap = hit / kr.numel()
            check(overlap >= 0.999, f"{name}: {kern} top-{k} overlap {overlap:.4f} < 0.999")
        ms = cuda_ms(run_kernel) if timed else float("nan")
        plain_ms = cuda_ms(run_plain) if timed else float("nan")
        r = results.setdefault(kern, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log("kernels", f"{name} {kern}: agree (max_abs_err={err:.3g}, overlap={overlap:.4f}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if name.startswith("slice") and k == FETCH_K and not exact:
            r["ms"], r["plain_ms"] = ms, plain_ms


def kernel_phase(dev, seed: int, quick: bool = False) -> dict:
    """K1/K2 against their plain twins over the headline, slice and edge shapes."""
    import torch

    from wax_tpu_torch.ops.flat_scan import NEG_INF, _pick_tn, normalize_rows

    g = torch.Generator(device="cpu").manual_seed(seed)
    d = 384

    def exact_data(rows):  # multiples of 1/8 in [-1, 1]: every dot product exact in f32
        return (torch.randint(-8, 9, (rows, d), generator=g) / 8.0).to(dev)

    def unit_data(rows):
        return normalize_rows(torch.randn((rows, d), generator=g)).to(dev)

    def bias_for(cap, live, dead=None):
        bias = torch.full((cap,), NEG_INF, device=dev)
        bias[:live] = 0.0
        if dead is not None:
            bias[dead] = NEG_INF
        return bias

    results: dict = {}
    head, cap, live = 10_240, 131_072, 102_400
    cases = [("headline 10240x384 B=256 k=10", head, head, 256, 10, None, torch.float32)]
    if not quick:
        tomb = torch.randperm(head, generator=g)[: head // 10].to(dev)
        cases += [
            (f"slice {cap}x384 live={live} B=256 k=10", cap, live, 256, 10, None, torch.float32),
            (f"slice {cap}x384 live={live} B=256 k={FETCH_K}", cap, live, 256, FETCH_K, None, torch.float32),
            ("edge ragged B=13 k=10", head, head, 13, 10, None, torch.float32),
            ("edge k=1", head, head, 256, 1, None, torch.float32),
            ("edge k=100", head, head, 256, 100, None, torch.float32),
            ("edge tombstoned 10%", head, head, 256, 10, tomb, torch.float32),
            ("edge bf16 corpus", head, head, 256, 10, None, torch.bfloat16),
        ]
    for name, n, nlive, b, k, dead, dtype in cases:
        tn = _pick_tn(n)
        bias = bias_for(n, nlive, dead)
        for exact in (True, False):
            if exact and dtype == torch.bfloat16:
                continue  # bf16 holds the 1/8 grid exactly too, but its case is the random one
            if exact:
                emb, q = exact_data(n), exact_data(b)
            else:
                emb, q = unit_data(n), unit_data(b)
            emb, q = emb.to(dtype).contiguous(), q.to(dtype).contiguous()
            timed = not exact
            _kernel_case(f"{name} {'exact-data' if exact else 'random-unit'}", q, emb, bias, k, tn,
                         exact, timed, results)
            del emb, q
    return results


# ------------------------------------------------------------------------------ corpus


def make_corpus(seed: int):
    """(vocabulary, documents, queries): an 8,192-word synthetic vocabulary, 102,400
    documents of 32 words and 4 x 256 queries of 6-10 words, words drawn Zipf (s=1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab: set[str] = set()
    while len(vocab) < VOCAB_WORDS:
        vocab.add("".join(rng.choice(letters, int(rng.integers(3, 10)))))
    words = sorted(vocab)
    rng.shuffle(words)  # Zipf rank independent of spelling
    p = 1.0 / np.arange(1, VOCAB_WORDS + 1)
    p /= p.sum()
    draws = rng.choice(VOCAB_WORDS, (N_DOCS, DOC_WORDS), p=p)
    docs = [" ".join(words[i] for i in row) for row in draws]
    queries = [
        [" ".join(words[i] for i in rng.choice(VOCAB_WORDS, int(rng.integers(6, 11)), p=p)) for _ in range(256)]
        for _ in range(4)
    ]
    return words, docs, queries


# ------------------------------------------------------------------------------ ingest


def ingest_phase(dev, docs):
    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEmbedder, mean_pool
    from wax_tpu_torch.search.engine import HybridSearchEngine

    cfg = MiniLMConfig()
    embedder = MiniLMEmbedder(dtype=torch.bfloat16, batch_size=256, seed=0, device=dev)
    engine = HybridSearchEngine(embedder, device=dev)
    log("ingest", f"MiniLM vocab={cfg.vocab_size} hidden={cfg.hidden} layers={cfg.layers} "
        f"heads={cfg.heads} intermediate={cfg.intermediate} dtype=bf16 weights=random(seed 0)")
    t0 = time.perf_counter()
    for fid, text in enumerate(docs):
        engine.index_text(fid, text)
    t_lex = time.perf_counter() - t0
    t0 = time.perf_counter()
    device_ms = 0.0
    for i in range(0, len(docs), 256):
        batch = docs[i : i + 256]
        ids, mask = embedder.tokenizer.encode_batch(batch)
        ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        with torch.no_grad():
            vecs = mean_pool(embedder.model(ids_t, mask_t), mask_t)
        e.record()
        vecs = vecs.cpu().numpy()
        device_ms += s.elapsed_time(e)
        check(vecs.shape == (len(batch), cfg.hidden) and np.isfinite(vecs).all(), "encoder output malformed")
        engine.index_embedding_batch(np.arange(i, i + len(batch)), vecs)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = engine.vector.snapshot()
    lex = engine.lex_snapshot()
    torch.cuda.synchronize()
    t_snap = time.perf_counter() - t0
    check(len(engine.vector) == len(docs) and len(engine.lex) == len(docs), "ingest lost documents")
    log("ingest", f"{len(docs)} docs: host seconds lex={t_lex:.2f} encode(tokenize+forward+builder)={t_enc:.2f} "
        f"snapshots={t_snap:.2f}; device seconds encoder={device_ms / 1e3:.3f}; "
        f"dense capacity={snap.capacity} dtype={snap.emb.dtype}, lex rows={lex.doc_len.shape[0]} "
        f"terms={lex.n_terms} postings={lex.n_postings} max_df={lex.max_df}")
    return engine


# ------------------------------------------------------------------------------- serve


def _term_batch(engine, texts, mode):
    """[B, W] padded distinct term ids, as unified_search pads one query; in `all` mode a
    query with an unindexed term matches nothing (FTS5's conjunction)."""
    import numpy as np

    from wax_tpu_torch.index.lex import analyze
    from wax_tpu_torch.ops.bm25 import MAX_QUERY_TERMS, pad_term_ids

    rows = []
    for t in texts:
        terms = analyze(t)
        tids = engine.lex.term_ids(terms)
        if mode == "all" and len(tids) < len(terms):
            tids = []
        rows.append(pad_term_ids(tids, dfs=engine.lex.df))
    width = max(MAX_QUERY_TERMS, max(len(r) for r in rows))
    out = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def serve_batch(engine, texts, mode, timings=None):
    """Both lanes for one batch; returns (vector vals, vector fids, bm25 vals, bm25 fids,
    query embeddings) with lanes as numpy arrays."""
    import torch

    from wax_tpu_torch.ops.bm25 import bm25_topk
    from wax_tpu_torch.ops.flat_scan import normalize_rows

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    q = normalize_rows(engine.embedder.encode(texts))
    ev[1].record()
    vv, vf = engine.vector.search(q, FETCH_K)
    ev[2].record()
    term_ids = _term_batch(engine, texts, mode)
    bv, _, bf = bm25_topk(term_ids, engine.lex_snapshot(), FETCH_K, mode=mode)
    bv, bf = bv.cpu().numpy(), bf.cpu().numpy()
    ev[3].record()
    ev[3].synchronize()
    if timings is not None:
        for name, a, b in (("embed", 0, 1), ("vector", 1, 2), ("bm25", 2, 3)):
            timings.setdefault(name, []).append(ev[a].elapsed_time(ev[b]))
    return vv, vf, bv, bf, q


def fuse(vv, vf, bv, bf):
    from wax_tpu_torch.ops.fusion import rrf_fuse

    out = []
    for i in range(vf.shape[0]):
        lanes = {
            "bm25": [(int(f), float(v)) for f, v in zip(bf[i], bv[i]) if f >= 0],
            "vector": [(int(f), float(v)) for f, v in zip(vf[i], vv[i]) if f >= 0],
        }
        out.append(rrf_fuse(lanes, WEIGHTS))
    return out


def serve_phase(engine, queries):
    import torch

    from wax_tpu_torch.ops import flat_scan as fs

    modes = ["any", "any", "any", "all"]
    timings: dict = {}
    served = []
    fs.K1_LAUNCHES = fs.K2_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for texts, mode in zip(queries, modes):
        vv, vf, bv, bf, q = serve_batch(engine, texts, mode, timings)
        tf = time.perf_counter()
        fused = fuse(vv, vf, bv, bf)
        timings.setdefault("fusion", []).append((time.perf_counter() - tf) * 1e3)
        served.append((vv, vf, bv, bf, q, fused))
    # exact-score requests go to the exact kernel (flat_scan_topk backend="pallas_exact")
    ex_vals, _, ex_fids = fs.flat_scan_topk(served[0][4], engine.vector.snapshot(), FETCH_K, backend="pallas_exact")
    ex_fids = ex_fids.cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fs.K1_LAUNCHES, "K2": fs.K2_LAUNCHES}
    check(launches["K1"] > 0, "the vector lane did not launch K1")
    check(launches["K2"] > 0, "the exact-score request did not launch K2")
    n_q = sum(len(t) for t in queries)
    for i, (vv, vf, bv, bf, q, fused) in enumerate(served):
        check(vf.shape == (256, FETCH_K) and bf.shape == (256, FETCH_K), f"batch {i}: lane shapes")
        check(all(len(h) > 0 for h in fused), f"batch {i}: a query got no fused hit")
    bm25_hits = [float((bf >= 0).sum(axis=1).mean()) for _, _, _, bf, _, _ in served]
    med = {k: statistics.median(v) for k, v in timings.items()}
    log("serve", f"{n_q} queries ({len(queries)} batches of 256, modes {modes}) in {wall:.3f} s "
        f"= {n_q / wall:.1f} queries/s; per-batch medians ms: embed={med['embed']:.3f} "
        f"vector={med['vector']:.3f} bm25={med['bm25']:.3f} fusion(host)={med['fusion']:.3f}; "
        f"mean bm25 hits/query per batch={bm25_hits}; launches {launches}")
    return served, (ex_vals, ex_fids), launches, modes


# ------------------------------------------------------------------------------ checks


def checks_phase(engine, queries, served, exact_req, modes):
    import numpy as np
    import torch

    from wax_tpu_torch.index.dense import DenseIndex
    from wax_tpu_torch.index.lex import LexIndex
    from wax_tpu_torch.ops.bm25 import bm25_topk
    from wax_tpu_torch.ops.flat_scan import flat_scan_topk

    # (i) repeat serving is bit-identical, in both BM25 modes
    for i in (0, 3):
        again = serve_batch(engine, queries[i], modes[i])
        for a, b, what in zip(again[:4], served[i][:4], ("vector vals", "vector fids", "bm25 vals", "bm25 fids")):
            check(np.array_equal(a, b), f"batch {i}: repeat serving changed {what}")
    log("checks", "(i) repeat serving bit-identical for an `any` and an `all` batch")

    # (ii) vector lane top-10 vs the plain exact scan of the snapshot copied to the CPU
    snap = engine.vector.snapshot()
    cpu = DenseIndex(**{f: getattr(snap, f).cpu() for f in ("emb", "frame_ids", "active", "count")},
                     similarity=snap.similarity, contiguous=snap.contiguous)
    q0 = served[0][4].cpu()
    _, _, ref = flat_scan_topk(q0, cpu, FETCH_K, backend="pallas_exact")
    ref = ref.numpy()
    vf = served[0][1]
    ov10 = np.mean([len(set(a[:10]) & set(b[:10])) / 10 for a, b in zip(vf, ref)])
    check(ov10 >= 0.99, f"vector lane top-10 overlap vs CPU exact {ov10:.4f} < 0.99")
    ov_ex = np.mean([len(set(a) & set(b)) / FETCH_K for a, b in zip(exact_req[1], ref)])
    check(ov_ex >= 0.999, f"exact-score request (K2) top-{FETCH_K} overlap vs CPU exact {ov_ex:.4f} < 0.999")
    log("checks", f"(ii) vector lane (K1) top-10 overlap vs CPU exact scan = {ov10:.4f}; "
        f"exact request (K2) top-{FETCH_K} overlap = {ov_ex:.4f}")

    # BM25 lane against the same scorer on the snapshot copied to the CPU
    lex = engine.lex_snapshot()
    lex_cpu = LexIndex(**{f: (getattr(lex, f).cpu() if torch.is_tensor(getattr(lex, f)) else getattr(lex, f))
                          for f in LexIndex.__dataclass_fields__})
    for i in (0, 3):
        term_ids = _term_batch(engine, queries[i], modes[i])
        cv, _, cf = bm25_topk(term_ids, lex_cpu, FETCH_K, mode=modes[i])
        gv, gf = served[i][2], served[i][3]
        check(np.array_equal(cf.numpy(), gf), f"batch {i}: BM25 ids differ between CPU and GPU")
        check(np.allclose(cv.numpy(), gv, rtol=1e-6, atol=0.0), f"batch {i}: BM25 scores differ beyond rtol 1e-6")
    log("checks", "BM25 lane identical to the CPU scorer (ids equal, scores rtol 1e-6) in `any` and `all` mode")

    # encoder: bf16 on the card against the same weights in f32 on the CPU
    from wax_tpu_torch.embed.minilm import MiniLMEmbedder

    ref_enc = MiniLMEmbedder(dtype=torch.float32, seed=0, device="cpu")
    texts = queries[0][:16]
    a = engine.embedder.encode(texts).cpu()
    b = ref_enc.encode(texts)
    cos = (a * b).sum(dim=1)
    check(bool(torch.isfinite(a).all()) and float(cos.min()) >= 0.99,
          f"bf16 encoder vs f32 CPU encoder: min cosine {float(cos.min()):.4f} < 0.99")
    log("checks", f"encoder bf16 (card) vs f32 (CPU), same weights: min cosine {float(cos.min()):.5f}")


# -------------------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed for all generated data")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    dev, smi = device_phase()
    sys.path.insert(0, str(REPO))
    import wax_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_phase()
    results = kernel_phase(dev, args.seed)
    _, docs, queries = make_corpus(args.seed)
    engine = ingest_phase(dev, docs)
    served, exact_req, launches, modes = serve_phase(engine, queries)
    checks_phase(engine, queries, served, exact_req, modes)

    import torch

    kernels = []
    for name, fn_line, kern in (("packed_sel_scan_topk", "wax_tpu/ops/flat_scan.py:201", "K1"),
                                ("scan_topk", "wax_tpu/ops/flat_scan.py:299", "K2")):
        r = results[kern]
        kernels.append({
            "name": f"{kern} {name}", "route": "cuda", "source": "wax_tpu_torch/csrc/flat_scan.cu",
            "replaces": fn_line, "launches": launches[kern], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
