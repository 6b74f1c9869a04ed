#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's query paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing lines tagged with its name:

  device    require CUDA, print the card's name and power limit (nvidia-smi), turn TF32 off
  build     compile wax_tpu_torch/csrc/*.cu (nvcc, sm_90a, one process per source) and
            print the seconds, each kernel's registers and spills, K3's and K5's launch
            plans at each path's widths (held against `launch_plan`), K4's and K7's (K7
            also at the IVF shapes: d 768, S 384 bf16 and S 1,152 f32), and K6's
            tensor-core launch (dynamic shared memory per CTA, CTAs per SM, grid)
  kernels   hold kernels K1 (packed-key scan), K2 (exact scan) and K9 (K1's function
            on K9's own tile), all three on 3xTF32 tensor-core scores, against their
            plain torch twins, and K1 against K9: exact-arithmetic data must agree bit
            for bit, random unit vectors within the stated tolerances (near-ties only,
            overlap >= 0.999); each K1/K2 launch's plan (cluster split, grid, CTAs per
            SM, shared memory); kernel and plain times (CUDA events), bounds (3xTF32
            basis, FP32-FMA basis beside) and torch.matmul f32 at the slice shape and
            at the headline 10,240 rows
  kernels2  the same for K6 (chunk maxima) and K7 (bucket rescore) at the 1M-row
            shapes: 1,048,576 x 384 and 1,048,576 x 768 bf16, B = 256 (x 768's numbers
            under the key "x768" of their kernels-line entries)
  ingest    102,400 synthetic documents (32 Zipf words each) into a HybridSearchEngine
            on the card: BM25 builder on the host, full-width MiniLM (random weights,
            bf16) in batches of 256 into the flat vector engine
  serve     4 batches of 256 text queries through both lanes (vector lane: embed +
            FlatVectorEngine.search, whose "auto" backend is K1; BM25 lane: bm25_topk,
            `any` mode x3 and `all` mode x1) and weighted RRF, plus one batch of
            exact-score requests (flat_scan_topk backend="pallas_exact", K2)
  checks    repeat serving is bit-identical; vector-lane top-10 against the plain exact
            scan of the snapshot copied to the CPU; BM25 lane against the CPU scorer;
            the bf16 encoder against its f32 CPU run
  engine_1m path (a): 1,048,576 synthetic documents into a HybridSearchEngine with
            the "auto" postings budget (4,096 at this size) and seeded unit vectors
            into its FlatVectorEngine (bf16 at this size; capacity 1,048,576, so
            "auto" scans with chunkmax: K6 then K7). 4 batches of 256 queries (`any`
            x3, `all` x1) through the vector lane, `search.unified._bm25_run` (budgeted
            candidates, then the exact rescore K3) and host RRF; then again with
            `lex_sharded` (chunked candidates K4, then K3). Checks: repeat serving
            bit-identical, the vector lane against the plain exact scan, both BM25
            lanes against the port's plain path on a CPU copy. Then, in a window of its
            own, `bm25_candidates_topk_pallas` on the snapshot without its fused
            forward index: K4, then `rescore_topk(fwd_fused=None)` (K5), equal bit for
            bit to the fused route (K4, then K3); K3 (L2 64) and K5 (its narrow form,
            and the wide one) held against their plain twins and timed on the
            candidates the lane passed them ("engine_1m_l2_64" under K3 in the kernels
            line; K5's own numbers are its narrow form's here)
  hybrid_1m path (b): `sharded_hybrid_topk` on the one-GPU mesh at the bench's
            hybrid_1m_x384 shape (1,048,576 rows x 384 bf16, B 256, k 10, 16,384
            terms, 16-term queries, budget 3,072, seeds 3/5/7), timed with the term
            ids perturbed per call; K3 (L2 128), K4 and K5 (narrow and wide forms; and
            against K3) held against their plain twins on this path's own inputs (K5
            wide timed as "hybrid_1m_wide"); the fused ids against the same program on a
            CPU copy
  exact_30k path (c): 30,720 documents of the smoke corpus, encoded by the full-width
            MiniLM, in a HybridSearchEngine with `lex_sharded` and the "auto" budget,
            which keeps this store exact: its sharded BM25 lane resolves to K8 (the
            unchunked candidate kernel). 4 batches of 256 queries (`any` x3, `all` x1)
            through the encoder, the vector lane (K1), the sharded BM25 lane (K8) and
            host RRF, plus one batch of `flat_scan_topk(backend="pallas_packed")`
            requests (K9); then `sharded_hybrid_topk` on the same store (blockmax dense
            lane, K8, on-device RRF), timed with the term ids perturbed per call; K8
            held against its plain twin at the phase's own inputs, sel 0 and 3, all
            three modes
  ivf_1m    path (d): the bench's ivf_1m_x768_nprobe8 shape: 1,048,576 x 768 bf16 rows
            of the bench's clustered corpus (2,000 centres of scale 2 plus unit noise,
            normalised; seeded on the card), 256 fresh queries of the same mixture;
            build_ivf (4,096 clusters, 4 iterations, 524,288 training rows, S 384 bf16
            buckets, spill "auto") timed and built twice (bit-identical), then
            ivf_search_topk_pallas at k 10, nprobe 8 (K7 at k 20, then the dedup):
            against the plain probe loop (near-ties only), recall@10 against the exact
            chunkmax lane (K6 + K7) >= 0.93; K7 held against its plain twin at the
            call's own probes ("ivf_1m" under K7 in the kernels line); calls per second
  auto_2m   path (e): make_vector_engine("auto", dim=768) with its defaults over
            2,097,152 x 768 rows of the same mixture: the routing decision (the bf16
            flat lane's exact answers for 64 sampled queries, K6 + K7; IVF builds of
            2,896 clusters of S 1,152 f32 and K7 searches up the nprobe ladder) in a
            window of its own, stats() printed; then 4 x 256 perturbed corpus rows
            served through search() (K7 on an IVF route); repeat serving bit-identical,
            served recall@10 against the flat lane >= 0.92 on an IVF route; K7 held at
            the served probes ("auto_2m" under K7)
  orch_100k path (f): the MemoryOrchestrator users call, in a temporary directory that
            it removes: a .mv2s store, remember_batch over smoke_100k's 102,400
            documents in calls of 1,024 (full-width MiniLM, bf16, random weights; the
            default "auto" vector engine is flat at capacity 131,072 x 384 f32), flush;
            256 search(top_k=10) and 256 recall() calls one at a time (p50, p99,
            calls/s, spans; K1 launched once per vector-lane call, B 1); a profiled
            window of 32 fresh searches; K1 held and timed at this B 1 shape
            ("orch_b1" under K1); close, clear the engine cache and reopen cold (the
            segments deserialized, warmup, the same searches bit-identical); a read-only reopen
            with lex_postings_budget=4,096 (64 searches through the candidate lane and
            K3); the same requests on the CPU with the card's query vectors, both
            budgets: BM25 lanes equal; every vector-lane score within a truncation
            step of its frame id's exact score and every id in one lane only a
            near-tie of the k-th score; each query whose fused top-10 differs answered
            as the card did once the CPU is given the card's vector lane; fused top-10
            equal for >= ORCH_FUSED_FLOOR of queries (the 99% that was asked for is
            not met: near-tie swaps in the vector lane reorder 1.6-4.7% of them)

Each serving phase sets the launch counts to 0 just before it runs and reads them just
after; every kernel of its path must have launched. Each profiled window also prints its
port kernels' recorded device events against their launches. It exits non-zero on any failure,
and when no CUDA device is present. The line before the last is a JSON object of
per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
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
N_1M = 1_048_576
N_QUERIES = 256  # queries per serving batch
N_30K = 30_720  # the largest store of this corpus that the TPU serves through K8
# the least time the card could take: bytes over the memory rate, operations over the
# peak rate of their type (NVIDIA H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
KERNEL_IDS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(bound_ms, bound_by) for work that moves `nbytes` and does `ops` operations of
    type `kind`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_counts() -> dict:
    from wax_tpu_torch.ops import (bm25_candidates_pallas, bm25_chunked_pallas, bm25_rescore, chunkmax_scan,
                                   flat_scan, ivf_kernel)

    return {"K1": flat_scan.K1_LAUNCHES, "K2": flat_scan.K2_LAUNCHES, "K3": bm25_rescore.K3_LAUNCHES,
            "K4": bm25_chunked_pallas.K4_LAUNCHES, "K5": bm25_rescore.K5_LAUNCHES,
            "K6": chunkmax_scan.K6_LAUNCHES, "K7": ivf_kernel.K7_LAUNCHES,
            "K8": bm25_candidates_pallas.K8_LAUNCHES, "K9": flat_scan.K9_LAUNCHES}


def reset_launch_counts() -> None:
    from wax_tpu_torch.ops import (bm25_candidates_pallas, bm25_chunked_pallas, bm25_rescore, chunkmax_scan,
                                   flat_scan, ivf_kernel)

    flat_scan.K1_LAUNCHES = flat_scan.K2_LAUNCHES = flat_scan.K9_LAUNCHES = 0
    bm25_rescore.K3_LAUNCHES = bm25_rescore.K5_LAUNCHES = bm25_chunked_pallas.K4_LAUNCHES = 0
    chunkmax_scan.K6_LAUNCHES = ivf_kernel.K7_LAUNCHES = bm25_candidates_pallas.K8_LAUNCHES = 0


# K1 and K2 are one template (csrc/flat_scan.cu `scan_topk`), told apart by their output
KERNEL_FRAGMENTS = {"PackedOut": "K1", "ExactOut": "K2", "k3_rescore": "K3", "k4_chunked": "K4",
                    "k5_rescore": "K5", "k6_chunk_maxima": "K6", "k7_bucket": "K7", "k8_candidates": "K8",
                    "k9_packed_topk": "K9"}


def short_kernel_name(key: str) -> str:
    """K1..K9 for a port kernel's (demangled) name, else the name's first 60 characters."""
    for frag, kid in KERNEL_FRAGMENTS.items():
        if frag in key:
            return kid
    return key[:60]


def device_profile(phase: str, fn, iters: int = 3, top: int = 8) -> dict:
    """Run fn() `iters` times under torch.profiler and print the device's busy share of
    the window (device time of all kernels / wall time), the device time by kernel, and
    each port kernel's recorded device events against its launch count in the window;
    where the two differ, also the window's device timeline. The profiler records no
    device event from the first few ms of its trace, so one untimed call of fn() runs
    first, and only the device events that start after it count. A full garbage
    collection runs before the timed calls, so that one over a large host heap does not
    land in them at random. Returns the port kernels' launches in the window
    ("launched") and their recorded device events ("recorded", None when the profiler
    recorded no device time)."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "device_profile window"  # also a device-side annotation event, which is no kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        gc.collect()
        before = launch_counts()
        with record_function(mark):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {kid: n - before[kid] for kid, n in launch_counts().items() if n > before[kid]}
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == mark)
    timeline = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name) for e in events
                      if e.device_type == DeviceType.CUDA and e.time_range.start >= start and e.name != mark)
    if not timeline:
        log(phase, f"profile: no device time recorded over {wall_ms:.3f} ms of wall time (not measured)")
        return {"launched": launched, "recorded": None}
    by_name: dict = {}
    for _, dur, name in timeline:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur / 1e3, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    log(phase, f"profile over {iters} calls: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%); device ms by kernel: "
        + "; ".join(f"{short_kernel_name(k)} {ms:.3f} ({n}x)" for ms, n, k in rows[:top]))
    recorded = {kid: sum(1 for *_, name in timeline if short_kernel_name(name) == kid) for kid in launched}
    log(phase, "profile: port kernels recorded/launched in the window: "
        + ", ".join(f"{kid} {recorded[kid]}/{n}" for kid, n in sorted(launched.items())))
    if recorded != launched:
        log(phase, "profile: device timeline (start us, duration us, kernel): "
            + "; ".join(f"{t - start:.1f} {d:.1f} {short_kernel_name(name)}" for t, d, name in timeline))
    return {"launched": launched, "recorded": recorded}


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


def queued_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of fn() in ms for a kernel shorter than its wrapper's host time:
    the `iters` calls are queued behind a sleep kernel of about 10 ms, so CUDA events
    around them measure the device, not the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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


def ptxas_functions(nvcc_log: str) -> dict:
    """{kernel (mangled name): [registers, spill store bytes, spill load bytes]} from the
    output of nvcc -Xptxas=-v."""
    out, cur = {}, None
    for ln in nvcc_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [None, None, None])
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        elif cur and (m := re.search(r"Used (\d+) registers", ln)):
            out[cur][0] = int(m.group(1))
    return out


def build_phase() -> None:
    """Build the kernels; print each kernel's registers and spills (ptxas), K4's and
    K7's launches (shared memory per CTA, CTAs per SM), K3's and K5's (register groups,
    candidates per warp and per CTA, grid, CTAs per SM) and K6's tensor-core launch:
    dynamic shared memory per CTA, CTAs per SM, grid."""
    import torch

    from wax_tpu_torch.ops import _build
    from wax_tpu_torch.ops import bm25_chunked_pallas as ck
    from wax_tpu_torch.ops import bm25_rescore as rs
    from wax_tpu_torch.ops import chunkmax_scan as cm
    from wax_tpu_torch.ops import ivf_kernel as ivf

    path, secs, out = _build.build()
    _build.load_library()
    log("build", f"{path.name} built in {secs:.3f} s")
    logfile = path.with_suffix(".log")
    funcs = ptxas_functions(out or (logfile.read_text() if logfile.exists() else ""))
    names = list(funcs)
    filt = Path(_build._nvcc()).parent / "cu++filt"
    if names and filt.exists():
        demangled = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True).stdout
        names = demangled.splitlines() if len(demangled.splitlines()) == len(funcs) else names
    for name, (regs, st, ld) in zip(names, funcs.values()):
        for noise in ("(int)", "<unnamed>::", "(anonymous namespace)::", "void "):
            name = name.replace(noise, "")
        log("build", f"{short_kernel_name(name)} {name.split('(')[0]}: {regs} registers, "
            f"{st} bytes spill stores, {ld} bytes spill loads")
    p = ck.launch_plan()
    check(p["ctas_per_sm"] >= 1, f"K4's 32-slot body does not fit an SM: {p}")
    log("build", f"K4 32-slot body: {p['threads']} threads, {p['smem_bytes']} bytes of dynamic shared memory per "
        f"CTA, {p['ctas_per_sm']} CTA(s) per SM")
    for d, s, k, dt in ((384, 128, 20, torch.bfloat16), (768, 128, 24, torch.bfloat16),
                        (768, 384, 20, torch.bfloat16), (768, 1152, 20, torch.float32), (768, 1152, 10, torch.float32)):
        p = ivf.launch_plan(d, s, k, dt)
        what = f"K7 at d {d}, S {s} {str(dt).split('.')[-1]}, k {k}"
        check(p["ring"] == 1 and p["ctas_per_sm"] >= 1, f"{what} does not take the ring body: {p}")
        log("build", f"{what}: ring body, {p['rows_per_slab']}-row slabs, {p['smem_bytes']} bytes of dynamic shared "
            f"memory per CTA, {p['ctas_per_sm']} CTA(s) per SM")
    for name, split, width in (("K3 at engine_1m's L2", False, 64), ("K3 at hybrid_1m's L2", False, 128),
                               ("K5 narrow", True, 64), ("K5 wide at hybrid_1m's L", True, 128)):
        p = rs.device_plan(split, width, N_QUERIES, 256)
        check({k: v for k, v in p.items() if k != "ctas_per_sm"} == rs.launch_plan(width, N_QUERIES, 256),
              f"{name}: the library's plan {p} differs from launch_plan's")
        log("build", f"{name} {width}, B {N_QUERIES}, F 256: {p['nl']} register groups of {32 // p['cpw']} lanes, "
            f"{p['cpw']} candidate(s) a warp, {p['cands_per_cta']} candidates per CTA of {p['threads']} threads, "
            f"grid {p['grid_x']} x {p['grid_y']}, {p['ctas_per_sm']} CTA(s) per SM")
    for b in (N_QUERIES, 128):
        p = cm.mma_plan(b, N_1M)
        log("build", f"K6 tensor-core path at B {b}, N {N_1M}: {p['queries_per_cta']} queries per CTA, "
            f"{p['smem_bytes']} bytes of dynamic shared memory per CTA ({p['stages']} stages of "
            f"{p['depth_per_stage']} depths), {p['ctas_per_sm']} CTA(s) per SM, grid {p['grid_x']} x {p['grid_y']}")


# ----------------------------------------------------------------------------- kernels


def _topk_agree(name, what, kv, kr, pv, pr, scores, k, exact, rel):
    """Merged top-k (kv, kr) against a reference (pv, pr): equal on exact data; else
    scores within F32_TOL + rel * |s|, every differing row a near-tie of the reference's
    k-th score and overlap >= 0.999. Returns (max_abs_err, overlap)."""
    import torch

    err = float((kv - pv).abs().max())
    if exact:
        check(torch.equal(kv, pv) and torch.equal(kr, pr), f"{name}: {what} top-k differs")
        return err, 1.0
    check(bool(((kv - pv).abs() <= F32_TOL + rel * pv.abs()).all()), f"{name}: {what} scores beyond tolerance "
          f"(max {err:.3g})")
    hit = 0
    for b in range(kr.shape[0]):
        a, p = set(kr[b].tolist()), set(pr[b].tolist())
        hit += len(a & p)
        kth = float(pv[b, k - 1])
        for row in a ^ p:
            check(row >= 0 and abs(float(scores[b, row]) - kth) <= F32_TOL + rel * abs(kth),
                  f"{name}: {what} row {row} of query {b} differs and is not a near-tie")
    overlap = hit / kr.numel()
    check(overlap >= 0.999, f"{name}: {what} top-{k} overlap {overlap:.4f} < 0.999")
    return err, overlap


def _kernel_case(name, q, emb, bias, k, tn, exact, timed, results):
    """Run K1, K2 and K9 on one input against their plain twins, and K9 against K1
    (bit for bit on exact data, near-ties only on random data); log K1's and K2's
    launch plans; record errors, and at the slice (k 24) and headline shapes on random
    data the times, bounds and torch.matmul f32 (the headline's under "rows_10240")."""
    import torch

    from wax_tpu_torch.ops import flat_scan as fs

    (b, d), n = q.shape, emb.shape[0]
    scores = fs._scores_f32(q, emb) + bias[None, :]  # exact scores for near-tie checks
    for kern in ("K1", "K2", "K9"):
        if kern in ("K1", "K2"):
            p = fs.launch_plan(b, n, tn, k, dtype=q.dtype, exact=kern == "K2", device=q.device)
            log("kernels", f"{name} {kern} plan: split {p['split']}, grid {p['grid']} = {p['ctas']} CTAs, "
                f"{p['ctas_per_sm']} CTA(s) per SM, {p['max_active_clusters']} co-resident clusters, "
                f"{p['smem_bytes']} bytes of shared memory, {p['threads']} threads ({p['consumer_warps']} consumer, "
                f"{p['producer_warps']} producer warps), {p['stages']} stages")
        if kern in ("K1", "K9"):
            sel_fn = fs.packed_sel_tiles if kern == "K1" else fs.packed_topk_tiles

            def run_kernel():
                return sel_fn(q, emb, bias, k, tn)

            def run_plain():
                return fs._packed_sel_topk_plain(q, emb, bias, k, tn)

            got, ref = run_kernel(), run_plain()
            torch.cuda.synchronize()
            if exact:
                check(torch.equal(got, ref), f"{name}: {kern} keys differ from the plain twin")
            kv, kr = fs._merge_tiles(*fs._decode_packed(got, k, tn), k)
            pv, pr = fs._merge_tiles(*fs._decode_packed(ref, k, tn), k)
            if kern == "K9":  # K1's function on K9's tile: K1's keys up to bucket edges
                k1 = fs.packed_sel_tiles(q, emb, bias, k, tn)
                if exact:
                    check(torch.equal(got, k1), f"{name}: K9 keys differ from K1's on exact data")
                _, ov1 = _topk_agree(name, "K9 vs K1", kv, kr, *fs._merge_tiles(*fs._decode_packed(k1, k, tn), k),
                                     scores, k, exact, TRUNC_REL)
                log("kernels", f"{name} K9 vs K1: overlap={ov1:.4f}, keys bit-equal={torch.equal(got, k1)}")
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
        err, overlap = _topk_agree(name, kern, kv, kr, pv, pr, scores, k, exact, 0.0 if kern == "K2" else TRUNC_REL)
        ms = cuda_ms(run_kernel) if timed else float("nan")
        plain_ms = cuda_ms(run_plain) if timed else float("nan")
        r = results.setdefault(kern, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log("kernels", f"{name} {kern}: agree (max_abs_err={err:.3g}, overlap={overlap:.4f}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if exact or not (name.startswith("slice") and k == FETCH_K or name.startswith("headline")):
            continue
        out_bytes = b * (n // tn) * k * (8 if kern == "K2" else 4)
        nbytes = q.element_size() * (b * d + n * d) + 4 * n + out_bytes
        flops = 2 * b * n * d  # on the tensor cores three TF32 products per f32 product (one for bf16)
        fma_ms, _ = bound(nbytes, flops, "fp32")
        rec = {"ms": ms, "plain_ms": plain_ms}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, (3 if q.dtype == torch.float32 else 1) * flops, "tf32")
        rec["library_ms"] = cuda_ms(lambda: torch.matmul(q, emb.t()))
        if name.startswith("slice"):
            r.update(rec)
        else:
            r["rows_10240"] = rec
        log("kernels", f"{name} {kern}: bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, 3xTF32 at "
            f"{PEAK_OPS_PER_S['tf32'] / 1e12:.0f} TFLOP/s; FP32 FMA basis {fma_ms:.4f} ms), "
            f"library (torch.matmul f32) {rec['library_ms']:.4f} ms")


def kernel_phase(dev, seed: int, quick: bool = False) -> dict:
    """K1, K2 and K9 against their plain twins over the headline, slice and edge shapes."""
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


def make_corpus(seed: int, n_docs: int = N_DOCS):
    """(vocabulary, documents, queries): an 8,192-word synthetic vocabulary, `n_docs`
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
    draws = rng.choice(VOCAB_WORDS, (n_docs, DOC_WORDS), p=p)
    docs = [" ".join(map(words.__getitem__, row)) for row in draws.tolist()]
    queries = [
        [" ".join(words[i] for i in rng.choice(VOCAB_WORDS, int(rng.integers(6, 11)), p=p)) for _ in range(256)]
        for _ in range(4)
    ]
    return words, docs, queries


# ------------------------------------------------------------------------------ ingest


def ingest_phase(dev, docs, phase: str = "ingest", **engine_kw):
    """Index `docs` into a HybridSearchEngine(**engine_kw) on the card: BM25 builder on
    the host, full-width MiniLM (random weights, bf16) in batches of 256."""
    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEmbedder, mean_pool
    from wax_tpu_torch.search.engine import HybridSearchEngine

    cfg = MiniLMConfig()
    embedder = MiniLMEmbedder(dtype=torch.bfloat16, batch_size=256, seed=0, device=dev)
    engine = HybridSearchEngine(embedder, device=dev, **engine_kw)
    log(phase, f"MiniLM vocab={cfg.vocab_size} hidden={cfg.hidden} layers={cfg.layers} "
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
    log(phase, f"{len(docs)} docs: host seconds lex={t_lex:.2f} encode(tokenize+forward+builder)={t_enc:.2f} "
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
    reset_launch_counts()
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


# ---------------------------------------------------------------- kernels K6 and K7


def _grid_bf16(g, shape, dev):
    """Entries k/8 in [-1, 1] as bf16: every dot product is exact in f32."""
    import torch

    return torch.randint(-8, 9, shape, generator=g, device=dev, dtype=torch.int8).to(torch.bfloat16).mul_(0.125)


def kernel2_phase(dev, seed: int) -> dict:
    """K6 (chunk maxima) and K7 (bucket rescore of the winning chunks) against their
    plain twins at 1,048,576 x 384 (the slice shape) and 1,048,576 x 768 bf16, B 256:
    exact-arithmetic data bit for bit, random unit vectors within F32_TOL."""
    import torch

    from wax_tpu_torch.ops.flat_scan import NEG_INF, normalize_rows
    from wax_tpu_torch.ops.topk import blockmax_topk

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    results = {"K6": {"max_abs_err": 0.0}, "K7": {"max_abs_err": 0.0}}
    b = 256
    for d, kc in ((384, 20), (768, 24)):
        for exact in (True, False):
            name = f"{N_1M}x{d} bf16 B={b} probes={kc} {'exact-data' if exact else 'random-unit'}"
            if exact:
                emb, q = _grid_bf16(g, (N_1M, d), dev), _grid_bf16(g, (b, d), dev)
            else:
                emb = normalize_rows(torch.randn((N_1M, d), generator=g, device=dev)).to(torch.bfloat16)
                q = normalize_rows(torch.randn((b, d), generator=g, device=dev)).to(torch.bfloat16)
            bias = torch.zeros(N_1M, device=dev)
            bias[N_1M - 1000:] = NEG_INF  # a dead tail: the last chunks are partly live
            r6, cmp = _k6_case("kernels2", name, q, emb, bias, exact=exact, timed=not exact)
            _, probes = blockmax_topk(cmp, kc)  # the chunks chunkmax_scan_topk rescores
            probes = probes.to(torch.int32).contiguous()
            counts = (bias.reshape(-1, 128) > NEG_INF * 0.5).sum(dim=1).to(torch.int32)
            r7 = _k7_case("kernels2", name, q.float(), probes, counts, emb.view(-1, 128, d), kc, b, exact=exact,
                          timed=not exact)
            if not exact:
                for kern, r in (("K6", r6), ("K7", r7)):
                    results[kern]["max_abs_err"] = max(results[kern]["max_abs_err"], r.pop("max_abs_err"))
                if d == 384:  # the slice shape (path b) is the kernels line's own
                    results["K6"].update(r6)
                    results["K7"].update(r7)
                else:  # the bench's flat_1m_x768 shape rides beside it
                    results["K6"]["x768"], results["K7"]["x768"] = r6, r7
            del emb, q, cmp
            torch.cuda.empty_cache()
    return results


def _k6_case(phase, what, q, emb, bias, exact: bool = False, timed: bool = True):
    """K6 at one call's own arguments against its plain twin: equal on exact-arithmetic
    data, else within F32_TOL. Then K6's time, the twin's, torch.matmul's (the library
    call) and the bound: the corpus, queries, bias and chunk maxima each moved once
    (bytes), or the multiply-adds at the corpus type's rate. Returns (the kernels-line
    record, the twin's chunk maxima)."""
    import torch

    from wax_tpu_torch.ops import chunkmax_scan as cm

    (b, d), n = q.shape, emb.shape[0]
    got, want = cm.chunk_maxima(q, emb, bias), cm._chunk_maxima_plain(q, emb, bias)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want) if exact else err <= F32_TOL, f"{phase} {what}: K6 differs (max {err:.3g})")
    rec = dict(max_abs_err=err)
    msg = f"{what}: K6 agrees with its plain twin (max_abs_err={err:.3g})"
    if timed:
        el = emb.element_size()
        ms = cuda_ms(lambda: cm.chunk_maxima(q, emb, bias))
        plain_ms = cuda_ms(lambda: cm._chunk_maxima_plain(q, emb, bias))
        library_ms = cuda_ms(lambda: torch.matmul(q, emb.t()))
        bms, by = bound(n * d * el + b * d * el + n * 4 + b * (n // 128) * 4, 2 * b * n * d,
                        "bf16" if emb.dtype == torch.bfloat16 else "fp32")
        p = cm.mma_plan(b, n)
        msg += (f"; B {b}, {n} x {d} {str(emb.dtype).split('.')[-1]}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"(torch.matmul) {library_ms:.4f} ms, bound {bms:.4f} ms ({by}); plan: {p['queries_per_cta']} "
                f"queries per CTA, grid {p['grid_x']} x {p['grid_y']}")
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by)
    log(phase, msg)
    return rec, want


def _k7_bound(q, probes, counts, emb3, k):
    """K7's bound at one call. Bytes: the live rows of each distinct probed bucket read
    once, with the queries, probes, live counts and outputs; operations: one f32
    multiply-add per element of every live row a query probes, at the FP32 rate.
    Returns (ms, bound_by, a note with the byte counts beside the per-query reading)."""
    b, nprobe = probes.shape
    c, s, d = emb3.shape
    el = emb3.element_size()
    distinct = probes.unique().long()
    live = int(counts[distinct].sum())
    probed_live = int(counts[probes.long()].sum())
    nbytes = live * d * el + b * d * 4 + b * nprobe * 4 + c * 4 + b * k * 8
    bms, by = bound(nbytes, 2 * probed_live * d, "fp32")
    note = (f"{by}: {nbytes / 1e9:.4f} GB = {live} live rows of {distinct.numel()} distinct buckets among "
            f"{b * nprobe} probes; whole distinct buckets {distinct.numel() * s * d * el / 1e9:.4f} GB; every "
            f"probe's bucket read per query {b * nprobe * s * d * el / 1e9:.4f} GB")
    return bms, by, note


def _k7_case(phase, what, q, probes, counts, emb3, k, block: int, exact: bool = False, timed: bool = True):
    """K7 at one call's own arguments against its plain twin (run in query blocks of
    `block`: it gathers [B, nprobe * S, d]): on exact-arithmetic data values and
    positions equal; else values within F32_TOL and positions differing only among
    near-ties of the k-th value. Then K7's time, the twin's (the sum over its blocks)
    and `_k7_bound`. Returns the kernels-line record."""
    import torch

    from wax_tpu_torch.ops import ivf_kernel as ivf

    b, nprobe = probes.shape
    s, d = emb3.shape[1], emb3.shape[2]
    kv, kp = ivf.bucket_rescore(q, probes, counts, emb3, k)
    pv, pp = [], []
    for i in range(0, b, block):
        v, p = ivf._bucket_rescore_plain(q[i : i + block], probes[i : i + block], counts, emb3, k)
        pv.append(v)
        pp.append(p)
    pv, pp = torch.cat(pv), torch.cat(pp)
    torch.cuda.synchronize()
    err = float((kv - pv).abs().max())
    if exact:
        check(torch.equal(kv, pv) and torch.equal(kp, pp), f"{phase} {what}: K7 differs from its plain twin")
        overlap = 1.0
    else:
        check(err <= F32_TOL, f"{phase} {what}: K7 values beyond {F32_TOL} of its plain twin (max {err:.3g})")
        hit = 0
        for i in range(b):
            a, p = set(kp[i].tolist()), set(pp[i].tolist())
            hit += len(a & p)
            for pos in a ^ p:  # only near-ties of the k-th value may differ
                sc = float((emb3[probes[i, pos // s].long(), pos % s].float() * q[i]).sum())
                check(abs(sc - float(pv[i, k - 1])) <= F32_TOL,
                      f"{phase} {what}: K7 position {pos} of query {i} is not a near-tie")
        overlap = hit / pp.numel()
    rec = dict(max_abs_err=err)
    msg = (f"{what}: K7 at B {b}, {nprobe} probes of {s} x {d} {str(emb3.dtype).split('.')[-1]}, k {k}: agrees "
           f"with its plain twin (max_abs_err={err:.3g}, overlap={overlap:.4f})")
    if timed:
        ms = cuda_ms(lambda: ivf.bucket_rescore(q, probes, counts, emb3, k))
        plain_ms = sum(cuda_ms(lambda i=i: ivf._bucket_rescore_plain(q[i : i + block], probes[i : i + block],
                                                                      counts, emb3, k), iters=5, warmup=1)
                       for i in range(0, b, block))
        bms, by, note = _k7_bound(q, probes, counts, emb3, k)
        p = ivf.launch_plan(d, s, k, emb3.dtype)
        msg += (f"; {ms:.4f} ms, plain {plain_ms:.4f} ms (blocks of {block}), bound {bms:.4f} ms ({note}); plan: "
                f"ring {p['ring']}, {p['rows_per_slab']}-row slabs, {p['smem_bytes']} bytes of shared memory, "
                f"{p['ctas_per_sm']} CTA(s) per SM")
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    log(phase, msg)
    return rec


# ---------------------------------------------------------------------------- engine_1m


def _cpu_copy(obj):
    """A copy of a snapshot dataclass with every tensor field on the CPU."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
                                       if torch.is_tensor(getattr(obj, f.name))})


def serve_engine_batch(engine, texts, qv, mode, timings=None):
    """Both lanes of one batch through the engine: the query vectors `qv` (encoded
    from `texts` by the engine's embedder when None), the vector lane
    (FlatVectorEngine.search) and the BM25 lane (search.unified._bm25_run). Returns
    (vector vals, vector fids, bm25 vals, bm25 fids, term ids, query vectors)."""
    import torch

    from wax_tpu_torch.ops.flat_scan import normalize_rows
    from wax_tpu_torch.search.unified import _bm25_run

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    encode = qv is None
    if encode:
        qv = normalize_rows(engine.embedder.encode(texts))
    ev[1].record()
    vv, vf = engine.vector.search(qv, FETCH_K)
    ev[2].record()
    term_ids = _term_batch(engine, texts, mode)
    bv, bf = _bm25_run(engine, term_ids, FETCH_K, mode)
    bv, bf = bv.cpu().numpy(), bf.cpu().numpy()
    ev[3].record()
    ev[3].synchronize()
    if timings is not None:
        if encode:
            timings.setdefault("embed", []).append(ev[0].elapsed_time(ev[1]))
        timings.setdefault("vector", []).append(ev[1].elapsed_time(ev[2]))
        timings.setdefault("bm25", []).append(ev[2].elapsed_time(ev[3]))
    return vv, vf, bv, bf, term_ids, qv


@contextlib.contextmanager
def first_call_args(module, name: str, seen: dict):
    """Within the block, record the arguments of the first call of `module.name` in
    seen[name] and the number of its calls in seen[name + " calls"] (the call itself
    runs unchanged)."""
    fn = getattr(module, name)

    def recorded(*args):
        seen.setdefault(name, args)
        seen[name + " calls"] = seen.get(name + " calls", 0) + 1
        return fn(*args)

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, fn)


def engine_1m_phase(dev, seed: int, results: dict) -> dict:
    """Path (a): the engine at 1,048,576 documents; returns this phase's launches."""
    import dataclasses

    import numpy as np
    import torch

    from wax_tpu_torch.ops import bm25_rescore as rs
    from wax_tpu_torch.ops.bm25_candidates import bm25_candidates_topk
    from wax_tpu_torch.ops.bm25_candidates_pallas import bm25_candidates_topk_pallas
    from wax_tpu_torch.ops.flat_scan import flat_scan_topk, normalize_rows
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.sharded_hybrid import sharded_bm25_topk
    from wax_tpu_torch.search.engine import HybridSearchEngine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, docs, queries = make_corpus(seed + 1, N_1M)
    t_corpus = time.perf_counter() - t0
    engine = HybridSearchEngine(None, dim=384, device=dev, lex_postings_budget="auto")
    # the same builders behind a second engine whose BM25 lane is the sharded program
    engine_sh = HybridSearchEngine(None, dim=384, device=dev, lex_sharded=True, lex_postings_budget="auto")
    engine_sh.lex, engine_sh.vector = engine.lex, engine.vector
    t0 = time.perf_counter()
    for fid, text in enumerate(docs):
        engine.index_text(fid, text)
    t_lex = time.perf_counter() - t0
    del docs
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(seed + 2)
    for i in range(0, N_1M, 131_072):
        m = min(131_072, N_1M - i)
        engine.index_embedding_batch(np.arange(i, i + m), torch.randn((m, 384), generator=g).numpy())
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap, lex = engine.vector.snapshot(), engine.lex_snapshot()
    torch.cuda.synchronize()
    t_snap = time.perf_counter() - t0
    t0 = time.perf_counter()
    lex_sh = engine_sh.lex_sharded_snapshot()
    torch.cuda.synchronize()
    t_snap_sh = time.perf_counter() - t0
    check(snap.capacity == N_1M and snap.emb.dtype == torch.bfloat16 and snap.contiguous,
          f"dense snapshot {snap.capacity} rows {snap.emb.dtype}: auto would not pick chunkmax")
    check(lex.fwd_fused is not None and lex_sh.pk_chunks is not None, "the auto budget did not truncate a term")
    log("engine_1m", f"{N_1M} docs: host seconds corpus={t_corpus:.2f} lex={t_lex:.2f} vectors={t_vec:.2f} "
        f"snapshots={t_snap:.2f} sharded snapshot={t_snap_sh:.2f}; budget="
        f"{engine.lex.resolve_postings_budget(N_1M)} terms={lex.n_terms} postings kept={lex.n_postings} "
        f"max_df={lex.max_df} fwd_width={lex.fwd_width} impact chunks={lex.pk_chunks.shape[0] // 1024} "
        f"qb={lex.pk_qb}; dense capacity={snap.capacity} dtype={snap.emb.dtype}")

    # query vectors: seeded perturbations of known documents (each is its own top-1)
    rng = np.random.default_rng(seed + 3)
    src = rng.integers(0, N_1M, (4, 256))
    qvs = []
    for row in src:
        base = torch.from_numpy(np.stack([engine.vector.builder.vector(int(f)) for f in row]))
        qvs.append(normalize_rows(base + 0.05 * torch.randn(base.shape, generator=g)).to(dev))
    modes = ["any", "any", "any", "all"]
    served, stats = {}, {}
    reset_launch_counts()
    torch.cuda.synchronize()
    for label, eng in (("lanes", engine), ("sharded", engine_sh)):
        timings: dict = {}
        t0 = time.perf_counter()
        out = []
        for texts, qv, mode in zip(queries, qvs, modes):
            vv, vf, bv, bf, term_ids, _ = serve_engine_batch(eng, texts, qv, mode, timings)
            tf = time.perf_counter()
            fused = fuse(vv, vf, bv, bf)
            timings.setdefault("fusion", []).append((time.perf_counter() - tf) * 1e3)
            out.append((vv, vf, bv, bf, term_ids, fused))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served[label] = out
        med = {k: statistics.median(v) for k, v in timings.items()}
        stats[label] = (wall, med)
        for i, (vv, vf, bv, bf, _, fused) in enumerate(out):
            check(vf.shape == (256, FETCH_K) and bf.shape == (256, FETCH_K), f"{label} batch {i}: lane shapes")
            check(all(len(h) > 0 for h in fused), f"{label} batch {i}: a query got no fused hit")
        log("engine_1m", f"serve ({label}): 1024 queries (modes {modes}) in {wall:.3f} s = {1024 / wall:.1f} "
            f"queries/s; per-batch medians ms: vector={med['vector']:.3f} bm25={med['bm25']:.3f} "
            f"fusion(host)={med['fusion']:.3f}")
    launches = launch_counts()
    for kern in ("K3", "K4", "K6", "K7"):
        check(launches[kern] > 0, f"engine_1m: {kern} was not launched")
    for label, eng in (("lanes", engine), ("sharded", engine_sh)):
        device_profile(f"engine_1m {label}", lambda: fuse(*serve_engine_batch(eng, queries[0], qvs[0], "any")[:4]),
                       iters=1)
    log("engine_1m", f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # (i) repeat serving is bit-identical
    for label, eng in (("lanes", engine), ("sharded", engine_sh)):
        for i in (0, 3):
            again = serve_engine_batch(eng, queries[i], qvs[i], modes[i])
            for a, b, what in zip(again[:4], served[label][i][:4], ("vector vals", "vector ids", "bm25 vals",
                                                                    "bm25 ids")):
                check(np.array_equal(a, b), f"engine_1m {label} batch {i}: repeat serving changed {what}")
    # (ii) the vector lane (K6 + K7) against the plain exact scan of the same snapshot
    vv, vf = served["lanes"][0][0], served["lanes"][0][1]
    pv, _, pf = flat_scan_topk(qvs[0], snap, FETCH_K, backend="xla")
    pv, pf = pv.cpu().numpy(), pf.cpu().numpy()
    err = float(np.abs(vv - pv).max())
    check(err <= F32_TOL, f"engine_1m vector lane scores differ from the plain scan by {err:.3g}")
    ov = np.mean([len(set(a) & set(b)) / FETCH_K for a, b in zip(vf, pf)])
    check(ov >= 0.999, f"engine_1m vector lane overlap with the plain exact scan {ov:.4f} < 0.999")
    top1 = float(np.mean(vf[:, 0] == src[0]))
    check(top1 >= 0.99, f"engine_1m vector lane finds the perturbed source document for {top1:.3f} of queries")
    # (iii) both BM25 lanes against the port's plain path on a CPU copy (64 queries)
    lex_cpu, lex_sh_cpu, cpu_mesh = _cpu_copy(lex), _cpu_copy(lex_sh), data_mesh("cpu")
    for i in (0, 3):
        tids = torch.from_numpy(served["lanes"][i][4][:64])
        cv, _, cf = bm25_candidates_topk(tids, lex_cpu, FETCH_K, mode=modes[i])
        sv, sf = sharded_bm25_topk(tids, lex_sh_cpu, FETCH_K, cpu_mesh, mode=modes[i], backend="candidates_pallas")
        for label, (v, f) in (("lanes", (cv, cf)), ("sharded", (sv, sf))):
            gv, gf = served[label][i][2][:64], served[label][i][3][:64]
            check(np.array_equal(f.numpy(), gf), f"engine_1m {label} batch {i}: BM25 ids differ from the CPU plain path")
            check(np.allclose(v.numpy(), gv, rtol=1e-6, atol=0.0),
                  f"engine_1m {label} batch {i}: BM25 scores differ beyond rtol 1e-6")
    log("engine_1m", f"checks: repeat serving bit-identical (both engines, an `any` and the `all` batch); "
        f"vector lane vs plain exact scan max_abs_err={err:.3g} overlap={ov:.4f} top-1 source={top1:.3f}; "
        f"BM25 lanes (candidates+K3, sharded K4+K3) equal to the CPU plain path on 64 queries "
        f"(ids equal, scores rtol 1e-6)")

    # (iv) the kernel candidate lane on a snapshot without the fused forward index:
    # rescore_topk(fwd_fused=None) takes K5, which must equal the fused route (K3)
    split = dataclasses.replace(lex, fwd_fused=None)
    tids4 = [torch.from_numpy(served["lanes"][i][4]).to(dev) for i in range(4)]
    for i, t in enumerate(tids4):  # K4 itself on each batch's chunk windows
        _, _, slots, _ = _k4_case(f"engine_1m batch {i}", lex.pk_chunks, lex.chunk_base, lex.chunk_counts,
                                  lex.pk_max_chunks, lex.pk_qb, t)
    log("engine_1m", f"K4 on the 4 batches' own chunk windows ({slots} slots, the last batch's) equal to its "
        f"plain twin in `any` and `count` modes")
    seen: dict = {}  # the first batch's K3 and K5 arguments, as the lane passes them
    with first_call_args(rs, "rescore_fused", seen), first_call_args(rs, "rescore_split", seen):
        via_k3 = [bm25_candidates_topk_pallas(t, lex, FETCH_K, mode) for t, mode in zip(tids4, modes)]
        torch.cuda.synchronize()
        reset_launch_counts()
        via_k5 = [bm25_candidates_topk_pallas(t, split, FETCH_K, mode) for t, mode in zip(tids4, modes)]
        torch.cuda.synchronize()
    k5_window = launch_counts()
    check(k5_window["K5"] > 0 and k5_window["K3"] == 0, f"engine_1m: rescore_topk(fwd_fused=None) launched "
          f"K5 {k5_window['K5']} and K3 {k5_window['K3']} times")
    for i, (a, b) in enumerate(zip(via_k3, via_k5)):
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"engine_1m batch {i}: the K5 route differs from K3's")
    launches["K5"] = k5_window["K5"]
    log("engine_1m", f"bm25_candidates_topk_pallas without fwd_fused (K4 + K5) equal to the fused route (K4 + K3) "
        f"for 4 x 256 queries (scores and ids bit for bit); launches {k5_window}")
    # (v) K3 and K5 on the candidates the lane passed them (batch 0)
    fused, cand, tq, iq = seen["rescore_fused"]
    ft, fw, cand5, tq5, iq5, w5 = seen["rescore_split"]
    check(torch.equal(cand, cand5) and torch.equal(tq, tq5) and torch.equal(iq, iq5) and w5 == 64,
          f"engine_1m: K5 did not take the narrow form (width {w5}) on K3's candidates")
    rc = _k3_k5_cases("engine_1m", fused, ft, fw, cand, tq, iq, lex.fwd_width)
    results.setdefault("K3", {})["engine_1m_l2_64"] = rc["K3"]
    results.setdefault("K5", {}).update(rc["K5"][w5])
    log("engine_1m", f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


# ---------------------------------------------------------------------------- hybrid_1m


def synth_sharded_lex(n: int, n_terms: int, budget: int, dev, seed: int = 5, per_doc: int = 64):
    """The bench's synthetic Zipf (s = 0.7) postings as a one-shard ShardedLexIndex:
    per-term row-sorted slices, df clamped at `budget` (impact-budget semantics),
    doc_len == avgdl == 64, the forward index and the impact chunks. Same draws as
    bench.py `_synth_sharded_lex`, without the TPU's padding and reversed copies."""
    import numpy as np
    import torch

    from wax_tpu_torch.index.lex import build_impact_chunks, fuse_forward
    from wax_tpu_torch.parallel.sharded_hybrid import ShardedLexIndex

    rng = np.random.default_rng(seed)
    raw_df = (1.0 / np.arange(1, n_terms + 1)) ** 0.7
    df_natural = np.minimum((raw_df / raw_df.sum() * per_doc * n).astype(np.int64) + 1, n)
    df = np.minimum(df_natural, budget)
    max_df = int(((df.max() + 127) // 128) * 128)
    offsets = np.zeros(n_terms + 1, np.int64)
    offsets[1:] = np.cumsum(df)
    total = int(offsets[-1])
    doc_rows = np.zeros(total, np.int32)
    wnorm = np.zeros(total, np.float32)
    tfs = np.zeros(total, np.float32)
    for t in range(n_terms):
        a, bb = int(offsets[t]), int(offsets[t + 1])
        m = bb - a
        rows = np.sort(rng.choice(n, size=m, replace=False)) if m < n // 4 else np.sort(rng.permutation(n)[:m])
        tf = rng.integers(1, 5, m).astype(np.float32)
        doc_rows[a:bb] = rows
        tfs[a:bb] = tf
        wnorm[a:bb] = tf * 2.2 / (tf + 1.2)
    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)
    tid_all = np.repeat(np.arange(n_terms, dtype=np.int32), df)
    order = np.argsort(doc_rows, kind="stable")  # stable: tid-ascending per document
    sr = doc_rows[order]
    widths = np.bincount(sr, minlength=n)
    l_pad = max(128, int(((widths.max() + 127) // 128) * 128))
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(widths, out=starts[1:])
    pos = np.arange(total, dtype=np.int64) - starts[sr]
    ft = np.full((n, l_pad), -1, np.int32)
    fw = np.zeros((n, l_pad), np.float32)
    ft[sr, pos] = tid_all[order]
    fw[sr, pos] = wnorm[order]
    fwd_width = int(widths.max())
    fz = fuse_forward(ft, fw, fwd_width)
    pk, cb, cc, qb = build_impact_chunks(doc_rows, wnorm, offsets, idf.astype(np.float64), n)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)

    return ShardedLexIndex(
        doc_rows=put(doc_rows), tfs=put(tfs), offsets=put(offsets.astype(np.int32)), idf=put(idf),
        doc_len=put(np.full(n, 64.0, np.float32)), frame_ids=put(np.arange(n, dtype=np.int32)),
        live=put(np.ones(n, bool)), row_base=torch.zeros(1, dtype=torch.int32, device=dev),
        avgdl=torch.tensor(64.0, device=dev), wnorm=put(wnorm), fwd_tids=put(ft), fwd_wnorm=put(fw),
        fwd_fused=put(fz), pk_chunks=put(pk), chunk_base=put(cb), chunk_counts=put(cc), max_df=max_df,
        pk_qb=qb, pk_max_chunks=int(cc.max()), fwd_width=fwd_width,
    )


def _k4_case(what, pk, chunk_base, chunk_counts, max_chunks, qb, tids):
    """K4 against its plain twin in `any` and `count` modes on a batch's own chunk
    windows, as `chunked_candidates_sel` builds them. Returns (win, seg_log2, slots,
    the plain twin's `count`-mode (rows, keys))."""
    import torch

    from wax_tpu_torch.index.lex import PK_CHUNK
    from wax_tpu_torch.ops import bm25_chunked_pallas as ck

    q = tids.shape[1]
    slots = ck.slots_for_query(q)
    win = ck.pack_query_chunks(tids, chunk_base, chunk_counts, slots, max_chunks, pk.shape[0] // PK_CHUNK - 1)
    seg = 1
    while (1 << seg) < 2 * q:
        seg += 1
    for mode in ("any", "count"):
        (kr, kk), (pr, pkk) = ck.chunked_sel(win, pk, qb=qb, seg_log2=seg, mode=mode), \
            ck._chunked_sel_plain(win, pk, qb, seg, mode, 3)
        torch.cuda.synchronize()
        check(torch.equal(kr, pr) and torch.equal(kk, pkk), f"{what}: K4 ({mode}) differs from its plain twin")
    return win, seg, slots, (pr, pkk)


def rescore_rows(pr, pkk, f: int = 256):
    """The rescore's candidates as the lane builds them from K4's output (rows, keys):
    the top-f rows by key, row-sorted, -1 (dead) last."""
    import torch

    from wax_tpu_torch.ops.topk import stable_top_k

    _, cpos = stable_top_k(pkk, f)
    crows = torch.gather(pr, 1, cpos)
    big = 2**30
    rows_sorted, _ = torch.sort(torch.where(crows < 0, big, crows.long()), dim=-1)
    return torch.where(rows_sorted >= big, -1, rows_sorted).to(torch.int32).contiguous()


def rescore_read_bytes(tids_rows, cand, tids_q, width: int):
    """(bytes K3/K5 read for these candidates: every tid lane of each live row and the
    32-byte sectors of its matched weights; live tid lanes a live row)."""
    import torch

    rows = tids_rows[cand.clamp(min=0).long()][..., :width]  # [B, F, width]
    live_c = cand >= 0
    hit = ((rows[..., None] == tids_q[:, None, None, :]) & (tids_q >= 0)[:, None, None, :]).any(-1)
    hit &= (rows >= 0) & live_c[..., None]
    sectors = int(hit.reshape(*hit.shape[:2], -1, 8).any(-1).sum())
    n_live = int(live_c.sum())
    lanes = float(((rows >= 0) & live_c[..., None]).sum()) / max(n_live, 1)
    return n_live * width * 4 + sectors * 32, lanes


def _k4_hybrid_case(lex, tids, results):
    """K4 against its plain twin on this path's own chunk windows, timed; returns the
    rescore's inputs as the lane builds them from K4's output: (the candidates K4
    ranks, row-sorted; query slots; their idf)."""
    from wax_tpu_torch.index.lex import PK_CHUNK
    from wax_tpu_torch.ops import bm25_chunked_pallas as ck
    from wax_tpu_torch.ops import bm25_rescore as rs

    b, q = tids.shape
    pk = lex.pk_chunks[0]
    win, seg, slots, (pr, pkk) = _k4_case("hybrid_1m", pk, lex.chunk_base[0], lex.chunk_counts[0],
                                          lex.pk_max_chunks, lex.pk_qb, tids)
    rows_sorted = rescore_rows(pr, pkk, 256)
    tids_q, idf_q = rs._query_planes(tids, lex.idf[0])
    tids_q, idf_q = tids_q.contiguous(), idf_q.contiguous()
    t4 = (cuda_ms(lambda: ck.chunked_sel(win, pk, qb=lex.pk_qb, seg_log2=seg, mode="any")),
          cuda_ms(lambda: ck._chunked_sel_plain(win, pk, lex.pk_qb, seg, "any", 3)))
    n = slots * PK_CHUNK
    stages = sum(1 + (run.bit_length() - 1) for run in (PK_CHUNK << i for i in range(slots.bit_length() - 1)))
    b4 = bound(b * n * 4 + b * slots * 4 + 2 * b * 3 * PK_CHUNK * 4, b * stages * (n // 2), "fp32")
    results["K4"] = dict(max_abs_err=0.0, ms=t4[0], plain_ms=t4[1], library_ms=None, bound_ms=b4[0], bound_by=b4[1])
    log("hybrid_1m", f"K4 [{b} queries x {slots} slots x {PK_CHUNK}] equal to its plain twin in `any` and `count` "
        f"modes; {t4[0]:.4f} ms, plain {t4[1]:.4f} ms, bound {b4[0]:.4f} ms ({b4[1]}, {stages} merge stages)")
    return rows_sorted, tids_q, idf_q


def _k3_k5_cases(phase, fused, ft, fw, cand, tids_q, idf_q, fwd_width: int) -> dict:
    """K3 (fused rows) and K5 (both forms: the first 64 lanes and every lane) against
    their plain twins on one path's own rescore inputs, on the path's weights and on
    exact-arithmetic ones (k/8, idf k/4): bit for bit; K5 also against K3 where it reads
    the same lanes. Times each with its plain twin, bound (every lane of every gathered
    row read once) and the bytes it reads; the kernels are timed queued (`queued_ms`):
    they are shorter than their wrappers' host time. Returns {"K3": entry, "K5": {width: entry},
    "K5 path width": the form exact_rescore takes here}."""
    import torch

    from wax_tpu_torch.ops import bm25_rescore as rs

    (b, f), q, l2, l = cand.shape, tids_q.shape[1], fused.shape[1] // 2, ft.shape[1]
    tid_lanes = fused[:, :l2]
    w_exact = torch.where(tid_lanes >= 0, ((tid_lanes % 8) + 1).float() / 8.0, 0.0)
    fused_exact = torch.cat([tid_lanes, w_exact.view(torch.int32)], dim=1).contiguous()
    idf_exact = torch.where(tids_q >= 0, ((tids_q % 4) + 1).float() / 4.0, 0.0).contiguous()
    want3 = {}
    for data, fz, idf in (("path", fused, idf_q), ("exact-arithmetic", fused_exact, idf_exact)):
        (ks, kc), (ps, pc) = rs.rescore_fused(fz, cand, tids_q, idf), rs._rescore_fused_plain(fz, cand, tids_q, idf)
        torch.cuda.synchronize()
        rel = float(((ks - ps).abs() / ps.abs().clamp(min=1e-30)).max())
        check(torch.equal(kc, pc) and torch.equal(ks, ps),
              f"{phase}: K3 differs from its plain twin on the {data} weights (max relative {rel:.3g})")
        want3[data] = (ks, kc)
    fw_exact = torch.where(ft >= 0, ((ft % 8) + 1).float() / 8.0, 0.0).contiguous()
    tail_dead = l <= l2 or bool((ft[:, l2:] < 0).all())  # K5 over every lane reads K3's lanes
    widths = (64, l) if l > 64 else (l,)
    for w5 in widths:
        for data, weights, idf in (("path", fw, idf_q), ("exact-arithmetic", fw_exact, idf_exact)):
            got, plain = rs.rescore_split(ft, weights, cand, tids_q, idf, w5), \
                rs._rescore_split_plain(ft, weights, cand, tids_q, idf, w5)
            torch.cuda.synchronize()
            check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
                  f"{phase}: K5 (width {w5}) differs from its plain twin on the {data} weights")
            if (w5 == l and tail_dead) or w5 == l2:
                check(all(torch.equal(x, y) for x, y in zip(got, want3[data])), f"{phase}: K5 (width {w5}) differs "
                      f"from K3 on the {data} weights")
    # the form exact_rescore takes on this index (narrow: a real width <= 64)
    path_w5 = 64 if 0 < fwd_width <= 64 and l >= 128 and f % 2 == 0 else l

    def entry(run, plain, width, tids_rows, err=0.0):
        ms, plain_ms = queued_ms(run), cuda_ms(plain)
        bd = bound(b * f * 2 * width * 4 + b * f * 4 + b * q * 8 + b * f * 8, 2 * b * f * width * q, "fp32")
        read, lanes = rescore_read_bytes(tids_rows, cand, tids_q, width)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bd[0], bound_by=bd[1],
                    read_mb=read / 1e6, live_lanes=lanes, read_bound_ms=read / HBM_BYTES_PER_S * 1e3)

    out = {"K3": entry(lambda: rs.rescore_fused(fused, cand, tids_q, idf_q),
                       lambda: rs._rescore_fused_plain(fused, cand, tids_q, idf_q), l2, tid_lanes),
           "K5": {w: entry(lambda: rs.rescore_split(ft, fw, cand, tids_q, idf_q, w),
                           lambda: rs._rescore_split_plain(ft, fw, cand, tids_q, idf_q, w), w, ft) for w in widths},
           "K5 path width": path_w5}
    for name, e, width in [("K3", out["K3"], l2)] + [("K5", out["K5"][w], w) for w in widths]:
        plan = rs.launch_plan(width, b, f)
        log(phase, f"{name} [{b} x {f} candidates, {'L2' if name == 'K3' else 'width'} {width}, Q {q}; plan: "
            f"{plan['nl']} register groups, {plan['cpw']} candidate(s) a warp, grid {plan['grid_x']} x "
            f"{plan['grid_y']}] bit-equal to its plain twin on the path's and exact-arithmetic weights; "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}); "
            f"reads {e['read_mb']:.2f} MB ({e['live_lanes']:.1f} live tid lanes a live row; "
            f"{e['read_bound_ms']:.4f} ms at 3.35 TB/s)")
    log(phase, f"K5 wide equal to K3 where it reads K3's lanes; exact_rescore takes width {path_w5} here")
    return out


def hybrid_1m_phase(dev, results: dict, n_terms: int = 16_384, iters: int = 20) -> dict:
    """Path (b): the fused one-device program at the bench's hybrid_1m_x384 shape;
    returns this phase's launches."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops.flat_scan import normalize_rows
    from wax_tpu_torch.parallel import sharded_hybrid as sh
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    b, d, k, q_terms, budget = 256, 384, 10, 16, 3072
    g = torch.Generator(device=dev).manual_seed(3)
    emb = normalize_rows(torch.randn((N_1M, d), generator=g, device=dev)).to(torch.bfloat16)
    q0 = normalize_rows(torch.randn((b, d), generator=g, device=dev))
    t0 = time.perf_counter()
    lex = synth_sharded_lex(N_1M, n_terms, budget, dev)
    t_lex = time.perf_counter() - t0
    dense = ShardedDenseIndex(emb=emb, frame_ids=torch.arange(N_1M, dtype=torch.int32, device=dev),
                              bias=torch.zeros(N_1M, device=dev), contiguous=True)
    tids0 = torch.from_numpy(np.random.default_rng(7).integers(0, n_terms, (b, q_terms)).astype(np.int32)).to(dev)
    mesh = data_mesh(dev)
    log("hybrid_1m", f"{N_1M} rows x {d} bf16; synthetic postings built in {t_lex:.2f} s: {lex.doc_rows.shape[1]} "
        f"postings, {n_terms} terms, budget {budget}, max_df={lex.max_df}, fwd_width={lex.fwd_width}, "
        f"impact chunks={lex.pk_chunks.shape[1] // 1024}, qb={lex.pk_qb}")
    fv0, ff0 = sh.sharded_hybrid_topk(q0, tids0, dense, lex, k, mesh)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(iters):
        sh.sharded_hybrid_topk(q0, (tids0 + i) % n_terms, dense, lex, k, mesh)
        ev[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for kern in ("K3", "K4", "K6", "K7"):
        check(launches[kern] > 0, f"hybrid_1m: {kern} was not launched")
    per_call = [ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]
    med = statistics.median(per_call)
    lane = {"dense": [], "bm25": []}
    for i in range(5):
        t2 = (tids0 + i) % n_terms
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        sh._dense_lane(q0, dense, 20, True, False)
        e[1].record()
        sh._bm25_lane(t2, lex, 20, "any", "candidates_pallas")
        e[2].record()
        e[2].synchronize()
        lane["dense"].append(e[0].elapsed_time(e[1]))
        lane["bm25"].append(e[1].elapsed_time(e[2]))
    log("hybrid_1m", f"sharded_hybrid_topk B={b} k={k}: {iters} calls (term ids perturbed per call) in "
        f"{wall:.3f} s wall; per call median {med:.3f} ms (min {min(per_call):.3f}, max {max(per_call):.3f}) "
        f"= {b / (med / 1e3):.1f} queries/s; lane medians ms: dense (K6+K7)="
        f"{statistics.median(lane['dense']):.3f} bm25 (K4+K3)={statistics.median(lane['bm25']):.3f}; "
        f"launches {launches}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_profile("hybrid_1m", lambda: sh.sharded_hybrid_topk(q0, tids0, dense, lex, k, mesh))
    rows_sorted, tids_q, idf_q = _k4_hybrid_case(lex, tids0, results)
    rc = _k3_k5_cases("hybrid_1m", lex.fwd_fused[0], lex.fwd_tids[0], lex.fwd_wnorm[0], rows_sorted, tids_q, idf_q,
                      lex.fwd_width)
    results.setdefault("K3", {}).update(rc["K3"])
    results.setdefault("K5", {})["hybrid_1m_wide"] = rc["K5"][rc["K5 path width"]]

    # the fused ids against the same program through the plain versions (CPU copy)
    nq = 32
    fv, ff = fv0[:nq].cpu(), ff0[:nq].cpu()
    dense_cpu, lex_cpu = _cpu_copy(dense), _cpu_copy(lex)
    cv, cf = sh.sharded_hybrid_topk(q0[:nq].cpu(), tids0[:nq].cpu(), dense_cpu, lex_cpu, k, data_mesh("cpu"),
                                    lex_backend="candidates_pallas")
    gdv, gdr = sh._dense_lane(q0[:nq], dense, 20, True, False)
    cdv, cdr = sh._dense_lane(q0[:nq].cpu(), dense_cpu, 20, True, False)
    gbv, gbf = sh._bm25_lane(tids0[:nq], lex, 20, "any", "candidates_pallas")
    cbv, cbf = sh._bm25_lane(tids0[:nq].cpu(), lex_cpu, 20, "any", "candidates_pallas")
    check(torch.equal(gbf.cpu(), cbf) and torch.allclose(gbv.cpu(), cbv, rtol=1e-6, atol=0.0),
          "hybrid_1m: BM25 lane (K4+K3) differs from the plain path")
    derr = float((gdv.cpu() - cdv).abs().max())
    check(derr <= F32_TOL, f"hybrid_1m: dense lane (K6+K7) scores differ from the plain path by {derr:.3g}")
    same = [torch.equal(ff[i], cf[i]) for i in range(nq)]
    for i in range(nq):  # a fused list may differ only through a near-tie of the dense lane
        check(same[i] or not torch.equal(gdr[i].cpu(), cdr[i]), f"hybrid_1m: query {i} fused ids differ")
    check(sum(same) / nq >= 0.9, f"hybrid_1m: fused ids equal for only {sum(same)}/{nq} queries")
    check(bool(torch.isfinite(fv).all()) and bool((ff[:, 0] >= 0).all()), "hybrid_1m: malformed fused output")
    log("hybrid_1m", f"checks: fused ids equal to the plain program on a CPU copy for {sum(same)}/{nq} queries; "
        f"BM25 lane ids equal (scores rtol 1e-6); dense lane max_abs_err={derr:.3g}")
    log("hybrid_1m", f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


# ---------------------------------------------------------------------------- exact_30k


def _k8_cases(lex, tids, results):
    """K8 against its plain twin at this path's inputs (the lane's postings and one
    serving batch's term ids), sel 0 and 3, every mode, on the path's weights and on
    exact-arithmetic ones (k/8, idf k/4): bit for bit. Times at sel 0 (what the lane
    runs on an exact store) and sel 3 (the rescore fetch)."""
    import torch

    from wax_tpu_torch.ops import bm25_candidates_pallas as k8

    rows, offs, max_df = lex.doc_rows[0], lex.offsets[0], int(lex.max_df)
    wn, idf = lex.wnorm[0], lex.idf[0]
    wn_exact = torch.where(wn > 0, ((torch.arange(wn.numel(), device=wn.device) % 8) + 1).float() / 8.0, 0.0)
    idf_exact = ((torch.arange(idf.numel(), device=idf.device) % 4) + 1).float() / 4.0
    b, q = tids.shape
    q2, w2 = 2, k8.dma_window(max_df)
    while q2 < q:
        q2 *= 2
    for data, w, i in (("path", wn, idf), ("exact-arithmetic", wn_exact, idf_exact)):
        for sel in (0, 3):
            for mode in ("any", "all", "count"):
                got = k8.candidate_scores_pallas(tids, rows, w, offs, i, max_df=max_df, mode=mode, sel=sel)
                want = k8._candidate_scores_plain(tids, rows, w, offs, i, q2, w2, mode, sel)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"K8 ({data} weights, {mode}, sel {sel}) differs from its plain twin")
                del got, want
        log("exact_30k", f"K8 [{b} queries x Q2 {q2} x W2 {w2}] bit-equal to its plain twin on the {data} "
            f"weights, modes any/all/count, sel 0 and 3")
    _, eff, _, _, _ = k8._slots(tids, offs, idf, q2, w2)
    n_read = int(eff.sum())
    t = {}
    for sel in (0, 3):
        out_bytes = b * (q2 * w2 if sel == 0 else sel * 1024) * 8
        t[sel] = (cuda_ms(lambda: k8.candidate_scores_pallas(tids, rows, wn, offs, idf, max_df=max_df, sel=sel)),
                  cuda_ms(lambda: k8._candidate_scores_plain(tids, rows, wn, offs, idf, q2, w2, "any", sel), iters=5),
                  bound(n_read * 8 + b * q * 4 + b * q2 * 12 + out_bytes, 2 * n_read, "fp32"))
        log("exact_30k", f"K8 sel {sel} (`any`): {t[sel][0]:.4f} ms, plain {t[sel][1]:.4f} ms, bound "
            f"{t[sel][2][0]:.4f} ms ({t[sel][2][1]}: {n_read} postings read, {out_bytes / 1e9:.4f} GB written)")
    results["K8"] = dict(max_abs_err=0.0, ms=t[0][0], plain_ms=t[0][1], library_ms=None, bound_ms=t[0][2][0],
                         bound_by=t[0][2][1])


def exact_30k_phase(dev, seed: int, results: dict) -> dict:
    """Path (c): the sharded BM25 lane on an exact-postings store (K8); returns this
    phase's launches (serving window and fused-program window)."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops.bm25_candidates_pallas import dma_window
    from wax_tpu_torch.ops.flat_scan import _pick_tn, flat_scan_topk, launch_plan, scan_scores
    from wax_tpu_torch.parallel import sharded_hybrid as sh
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.sharded_scan import shard_dense_index

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, docs, queries = make_corpus(seed, N_30K)
    engine = ingest_phase(dev, docs, "exact_30k", lex_sharded=True, lex_postings_budget="auto")
    del docs
    t0 = time.perf_counter()
    lex = engine.lex_sharded_snapshot()
    torch.cuda.synchronize()
    t_snap = time.perf_counter() - t0
    max_df = int(lex.max_df)
    check(lex.fwd_tids is None and lex.fwd_fused is None and lex.pk_chunks is None,
          "exact_30k: the auto budget truncated a term (the snapshot has a forward index)")
    check(((max_df + 127) // 128) * 128 + 1024 <= 32_768, f"exact_30k: max_df {max_df} is past K8's 16-slot guard")
    check(sh._resolve_lex_backend(lex, "auto", q2=16) == "candidates_pallas",
          "exact_30k: `auto` did not resolve the BM25 lane to candidates_pallas (K8)")
    log("exact_30k", f"sharded snapshot in {t_snap:.2f} s: exact (no forward index), max_df={max_df}, "
        f"W2={dma_window(max_df)}, `auto` -> candidates_pallas")

    modes = ["any", "any", "any", "all"]
    timings: dict = {}
    served = []
    snap = engine.vector.snapshot()
    tn = _pick_tn(snap.capacity)
    p = launch_plan(N_QUERIES, snap.capacity, tn, FETCH_K, dtype=snap.emb.dtype, device=dev)
    log("exact_30k", f"vector lane: K1 over capacity {snap.capacity} ({snap.emb.dtype}, tiles of {tn}) at B "
        f"{N_QUERIES}, k {FETCH_K}: split {p['split']}, grid {p['grid']} = {p['ctas']} CTAs, {p['ctas_per_sm']} "
        f"CTA(s) per SM, {p['smem_bytes']} bytes of shared memory")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for texts, mode in zip(queries, modes):
        vv, vf, bv, bf, term_ids, qv = serve_engine_batch(engine, texts, None, mode, timings)
        tf = time.perf_counter()
        fused = fuse(vv, vf, bv, bf)
        timings.setdefault("fusion", []).append((time.perf_counter() - tf) * 1e3)
        served.append((vv, vf, bv, bf, term_ids, qv, fused))
    # the packed-key requests (flat_scan_topk backend="pallas_packed") go to K9
    k9_vals, k9_rows, _ = flat_scan_topk(served[0][5], snap, FETCH_K, backend="pallas_packed")
    k9_rows = k9_rows.cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for kern in ("K1", "K8", "K9"):
        check(launches[kern] > 0, f"exact_30k: {kern} was not launched while serving")
    check(launches["K3"] == 0 and launches["K4"] == 0, f"exact_30k: the exact store launched K3/K4 {launches}")
    for i, (vv, vf, bv, bf, _, _, fused) in enumerate(served):
        check(vf.shape == (256, FETCH_K) and bf.shape == (256, FETCH_K), f"exact_30k batch {i}: lane shapes")
        check(all(len(h) > 0 for h in fused), f"exact_30k batch {i}: a query got no fused hit")
    med = {k: statistics.median(v) for k, v in timings.items()}
    hits = [float((bf >= 0).sum(axis=1).mean()) for _, _, _, bf, _, _, _ in served]
    log("exact_30k", f"serve: 1024 queries (modes {modes}) + 256 packed-key requests in {wall:.3f} s = "
        f"{1024 / wall:.1f} queries/s; per-batch medians ms: embed={med['embed']:.3f} vector={med['vector']:.3f} "
        f"bm25 (sharded K8)={med['bm25']:.3f} fusion(host)={med['fusion']:.3f}; mean bm25 hits/query per batch="
        f"{hits}; launches {launches}")
    device_profile("exact_30k serve", lambda: fuse(*serve_engine_batch(engine, queries[0], served[0][5], "any")[:4]),
                   iters=1)

    # (i) repeat serving is bit-identical
    for i in (0, 3):
        again = serve_engine_batch(engine, queries[i], served[i][5], modes[i])
        for a, b, what in zip(again[:4], served[i][:4], ("vector vals", "vector ids", "bm25 vals", "bm25 ids")):
            check(np.array_equal(a, b), f"exact_30k batch {i}: repeat serving changed {what}")
    # (ii) the vector lane (K1) against the plain exact scan; K9's requests against K1's
    pv, _, pf = flat_scan_topk(served[0][5], snap, FETCH_K, backend="xla")
    pv, pf = pv.cpu().numpy(), pf.cpu().numpy()
    ov = np.mean([len(set(a) & set(b)) / FETCH_K for a, b in zip(served[0][1], pf)])
    check(ov >= 0.99, f"exact_30k vector lane overlap with the plain exact scan {ov:.4f} < 0.99")
    # K9 computes K1's keys with 3xTF32 scores: equal ids up to near-ties of the k-th
    s_vals, s_rows, _ = flat_scan_topk(served[0][5], snap, FETCH_K, backend="pallas_packed_sel")
    exact_scores = scan_scores(served[0][5], snap).cpu()
    _, k9_overlap = _topk_agree("exact_30k", "the packed-key requests (K9) vs the vector lane's K1", k9_vals.cpu(),
                                k9_rows, s_vals.cpu(), s_rows.cpu(), exact_scores, FETCH_K, False, TRUNC_REL)
    # (iii) the sharded BM25 lane against the port's plain path on a CPU copy (64 queries)
    lex_cpu, cpu_mesh = _cpu_copy(lex), data_mesh("cpu")
    for i in (0, 3):
        tids = torch.from_numpy(served[i][4][:64])
        cv, cf = sh.sharded_bm25_topk(tids, lex_cpu, FETCH_K, cpu_mesh, mode=modes[i], backend="candidates_pallas")
        check(np.array_equal(cf.numpy(), served[i][3][:64]), f"exact_30k batch {i}: BM25 ids differ from the CPU "
              "plain path")
        check(np.array_equal(cv.numpy(), served[i][2][:64]), f"exact_30k batch {i}: BM25 scores differ from the "
              "CPU plain path")
    log("exact_30k", f"checks: repeat serving bit-identical (an `any` and the `all` batch); vector lane (K1) "
        f"overlap with the plain exact scan {ov:.4f}; packed-key requests (K9) overlap with K1's {k9_overlap:.4f} "
        f"(every difference a near-tie); sharded BM25 lane "
        f"(K8) equal to the CPU plain path on 64 queries of an `any` and the `all` batch (ids and scores bit for bit)")

    # the fused program on the same store: dense lane, K8, on-device RRF
    mesh = data_mesh(dev)
    dense = shard_dense_index(snap, mesh)
    q0, tids0 = served[0][5], torch.from_numpy(served[0][4]).to(dev)
    n_terms, k, iters = int(lex.idf.shape[1]), 10, 20

    def perturbed(i):
        return torch.where(tids0 >= 0, (tids0 + i) % n_terms, -1)

    fv0, ff0 = sh.sharded_hybrid_topk(q0, tids0, dense, lex, k, mesh)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for i in range(iters):
        sh.sharded_hybrid_topk(q0, perturbed(i), dense, lex, k, mesh)
        ev[i + 1].record()
    torch.cuda.synchronize()
    fused_launches = launch_counts()
    check(fused_launches["K8"] > 0, "exact_30k: the fused program did not launch K8")
    check(fused_launches["K3"] == 0 and fused_launches["K4"] == 0, "exact_30k: the fused program launched K3/K4")
    per_call = [ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]
    fmed = statistics.median(per_call)
    log("exact_30k", f"sharded_hybrid_topk B=256 k={k}: per call median {fmed:.3f} ms (min {min(per_call):.3f}, "
        f"max {max(per_call):.3f}) over {iters} calls (term ids perturbed per call) = {256 / (fmed / 1e3):.1f} "
        f"queries/s; launches {fused_launches}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_profile("exact_30k fused", lambda: sh.sharded_hybrid_topk(q0, tids0, dense, lex, k, mesh))
    nq = 32
    cv, cf = sh.sharded_hybrid_topk(q0[:nq].cpu(), tids0[:nq].cpu(), _cpu_copy(dense), lex_cpu, k, cpu_mesh,
                                    lex_backend="candidates_pallas")
    same = [torch.equal(ff0[i].cpu(), cf[i]) for i in range(nq)]
    _, gdr = sh._dense_lane(q0[:nq], dense, 20, False, False)
    _, cdr = sh._dense_lane(q0[:nq].cpu(), _cpu_copy(dense), 20, False, False)
    for i in range(nq):  # a fused list may differ only through a near-tie of the dense lane
        check(same[i] or not torch.equal(gdr[i].cpu(), cdr[i]), f"exact_30k: query {i} fused ids differ")
    check(sum(same) / nq >= 0.9, f"exact_30k: fused ids equal to the plain program for only {sum(same)}/{nq} queries")
    check(bool(torch.isfinite(fv0).all()) and bool((ff0[:, 0] >= 0).all()), "exact_30k: malformed fused output")
    log("exact_30k", f"checks: fused ids equal to the plain program on a CPU copy for {sum(same)}/{nq} queries")

    _k8_cases(lex, tids0, results)
    log("exact_30k", f"phase seconds {time.perf_counter() - t_phase:.1f}")
    launches["K8"] += fused_launches["K8"]
    return launches


# --------------------------------------------------------------------- ivf_1m, auto_2m


def clustered_corpus(n: int, g, dev, d: int = 768, n_centres: int = 2000, b: int = N_QUERIES):
    """(rows [n, d] bf16, queries [b, d] f32): the bench's clustered corpus
    (`bench.py` `_make_corpus_1m`): 2,000 centres of scale 2 plus unit noise,
    normalised, drawn on the card from generator g in blocks; queries are fresh points
    of the same mixture."""
    import torch

    from wax_tpu_torch.ops.flat_scan import normalize_rows

    centres = torch.randn((n_centres, d), generator=g, device=dev) * 2.0
    rows = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 131_072):
        m = min(131_072, n - s)
        pick = torch.randint(0, n_centres, (m,), generator=g, device=dev)
        rows[s : s + m] = normalize_rows(centres[pick] + torch.randn((m, d), generator=g, device=dev))
    pick = torch.randint(0, n_centres, (b,), generator=g, device=dev)
    return rows, normalize_rows(centres[pick] + torch.randn((b, d), generator=g, device=dev))


class _RowScores:
    """scores[b, row] = q[b] . rows[row] in f32, computed on demand (for `_topk_agree`'s
    near-tie checks on a corpus too large for a full score matrix)."""

    def __init__(self, q, rows):
        self.q, self.rows = q, rows

    def __getitem__(self, key):
        b, row = key
        return float(self.q[b] @ self.rows[row].float())


def ivf_1m_phase(dev, seed: int, results: dict) -> dict:
    """Path (d): the bench's ivf_1m_x768_nprobe8 shape: build_ivf (4,096 clusters,
    S 384 bf16 buckets, spill "auto") over 1,048,576 x 768 clustered rows and 256
    queries through ivf_search_topk_pallas (K7), against the exact chunkmax lane (K6 +
    K7). Returns this phase's launches."""
    import numpy as np
    import torch

    from wax_tpu_torch.index.ivf import build_ivf, ivf_search_topk
    from wax_tpu_torch.ops import chunkmax_scan as cm
    from wax_tpu_torch.ops import ivf_kernel as ivfk
    from wax_tpu_torch.ops.ivf_kernel import ivf_search_topk_pallas
    from wax_tpu_torch.search.vector_engines import AutoVectorEngine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    rows, q = clustered_corpus(N_1M, g, dev)
    torch.cuda.synchronize()
    build_kw = dict(n_clusters=4096, iters=4, normalize=False, bucket_dtype=torch.bfloat16, train_rows=524_288,
                    spill="auto", device=dev)
    k, nprobe = 10, 8
    truth_args, search_args = {}, {}
    reset_launch_counts()
    with first_call_args(cm, "chunk_maxima", truth_args), first_call_args(cm, "ivf_rescore", truth_args):
        _, exact = cm.chunkmax_scan_topk(q, rows, torch.zeros(N_1M, device=dev), k)  # exact ground truth: K6 + K7
    torch.cuda.synchronize()
    truth = launch_counts()
    check(truth["K6"] == 1 and truth["K7"] == 1, f"ivf_1m: the chunkmax ground truth launched {truth}")
    t0 = time.perf_counter()
    index = build_ivf(rows, np.arange(N_1M), **build_kw)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    reset_launch_counts()
    with first_call_args(ivfk, "ivf_rescore", search_args):
        vals, fids = ivf_search_topk_pallas(q, index, k=k, nprobe=nprobe)
    torch.cuda.synchronize()
    search = launch_counts()
    check(search["K7"] == 1 and search["K6"] == 0, f"ivf_1m: ivf_search_topk_pallas launched {search}, not one K7")
    launches = {kid: truth[kid] + search[kid] for kid in truth}
    live = int((index.ids >= 0).sum())
    log("ivf_1m", f"build_ivf over {N_1M} x 768 bf16 in {t_build:.2f} s (host clock, synchronised): "
        f"{index.n_clusters} clusters of S {index.bucket_size}, spilled={index.spilled}, {live} live slots "
        f"({live - N_1M} copies), buckets {index.emb.numel() * index.emb.element_size() / 1e9:.3f} GB; launches "
        f"{launches}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(index.bucket_size == 384 and index.spilled and index.emb.dtype == torch.bfloat16,
          f"ivf_1m: index S {index.bucket_size} spilled={index.spilled} {index.emb.dtype}")

    # the same build again: bit for bit
    again = build_ivf(rows, np.arange(N_1M), **build_kw)
    check(torch.equal(again.ids, index.ids) and torch.equal(again.emb, index.emb)
          and torch.equal(again.centroids, index.centroids), "ivf_1m: a second build with the same seed differs")
    del again
    torch.cuda.empty_cache()
    check(tuple(fids.shape) == (N_QUERIES, k) and bool(torch.isfinite(vals).all()) and bool((fids >= 0).all()),
          "ivf_1m: malformed search output")
    # the K7 entry against the plain probe loop on the same index
    pv, pf = ivf_search_topk(q, index, k=k, nprobe=nprobe)
    _, overlap = _topk_agree("ivf_1m", "ivf_search_topk_pallas vs ivf_search_topk", vals.cpu(), fids.cpu(),
                             pv.cpu(), pf.cpu(), _RowScores(q, rows), k, False, 0.0)
    rec = AutoVectorEngine._recall(exact.cpu().numpy(), fids.cpu().numpy())
    check(rec >= 0.93, f"ivf_1m: recall@{k} {rec:.4f} against the exact chunkmax lane < 0.93")
    log("ivf_1m", f"checks: a second build is bit-identical (ids, buckets, centroids); the K7 entry agrees with the "
        f"plain probe loop (overlap {overlap:.4f}, differences near-ties only); recall@{k} against the exact "
        f"chunkmax lane (K6 + K7) {rec:.4f} (>= 0.93)")

    # the ground truth's K6 and K7 at their own arguments (timed at this width in
    # kernels2), then K7 at the IVF call's own arguments, and the entry's rate
    _k6_case("ivf_1m", "chunkmax ground truth", *truth_args["chunk_maxima"], timed=False)
    q7, probes7, counts7, emb7, _, k7 = truth_args["ivf_rescore"]
    _k7_case("ivf_1m", "chunkmax ground truth", q7, probes7, counts7, emb7, k7, N_QUERIES, timed=False)
    q7, probes7, counts7, emb7, _, k7 = search_args["ivf_rescore"]
    check(k7 == min(2 * k, 128) and emb7 is index.emb, f"ivf_1m: the IVF call fetched {k7}, not {min(2 * k, 128)}")
    rec7 = _k7_case("ivf_1m", "IVF search", q7, probes7, counts7, emb7, k7, 32)
    rec7["launches"] = search["K7"]
    results["K7"]["ivf_1m"] = rec7
    ms = cuda_ms(lambda: ivf_search_topk_pallas(q, index, k=k, nprobe=nprobe))
    plain = cuda_ms(lambda: ivf_search_topk(q, index, k=k, nprobe=nprobe), iters=5)
    log("ivf_1m", f"ivf_search_topk_pallas B {N_QUERIES} k {k} nprobe {nprobe}: {ms:.4f} ms a call (CUDA events, 20 "
        f"calls) = {1e3 / ms:.1f} calls/s = {N_QUERIES * 1e3 / ms:.1f} queries/s; plain probe loop {plain:.4f} ms")
    device_profile("ivf_1m search", lambda: ivf_search_topk_pallas(q, index, k=k, nprobe=nprobe))
    log("ivf_1m", f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


N_2M = 2_097_152


def auto_2m_phase(dev, seed: int, results: dict) -> dict:
    """Path (e): make_vector_engine("auto") at its own threshold: 2,097,152 x 768 rows,
    the routing decision (the flat lane's exact answers for 64 sampled queries, IVF
    builds and K7 searches up the nprobe ladder), then 4 x 256 perturbed corpus rows
    served through search(). Returns the launches of the decision and serving windows."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops import chunkmax_scan as cm
    from wax_tpu_torch.ops import ivf_kernel as ivfk
    from wax_tpu_torch.ops.flat_scan import normalize_rows
    from wax_tpu_torch.search.vector_engines import _AUTO_SAMPLE_Q, AutoVectorEngine, IVFVectorEngine, \
        make_vector_engine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    rows, _ = clustered_corpus(N_2M, g, dev)
    engine = make_vector_engine("auto", dim=768, device=dev)
    t0 = time.perf_counter()
    for s in range(0, N_2M, 262_144):
        block = rows[s : s + 262_144].float().cpu().numpy()
        engine.add_batch(np.arange(s, s + len(block)), block)
    del rows
    torch.cuda.empty_cache()
    t_add = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 13)  # queries as the engine's _sample_queries draws them
    state = engine.builder.state_arrays()
    queries = []
    for _ in range(4):
        base = state["emb"][rng.choice(N_2M, N_QUERIES, replace=False)]
        queries.append(normalize_rows(torch.from_numpy(base + rng.normal(0.0, 0.05, base.shape).astype(np.float32))))

    flat_args = {}  # the flat lane's K6 and K7 calls in the decision (the IVF engines call ivfk's own)
    reset_launch_counts()
    t0 = time.perf_counter()
    with first_call_args(cm, "chunk_maxima", flat_args), first_call_args(cm, "ivf_rescore", flat_args):
        snap = engine.snapshot()  # takes the routing decision
    torch.cuda.synchronize()
    t_decide = time.perf_counter() - t0
    decide = launch_counts()
    stats = engine.stats()
    log("auto_2m", f"{N_2M} x 768 rows added in {t_add:.2f} s (host); decision in {t_decide:.2f} s (host clock, "
        f"synchronised); stats() {stats}; launches {decide}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(decide["K6"] > 0 and decide["K7"] > decide["K6"], f"auto_2m: the decision launched K6 {decide['K6']} / "
          f"K7 {decide['K7']} times")
    # the flat lane's K6 (its B <= 128 instance) and K7 at the decision's own arguments
    q6, emb6, bias6 = flat_args["chunk_maxima"]
    check(tuple(q6.shape) == (_AUTO_SAMPLE_Q, 768) and tuple(emb6.shape) == (N_2M, 768)
          and emb6.dtype == torch.bfloat16, f"auto_2m: the flat lane's K6 call {tuple(q6.shape)} x "
          f"{tuple(emb6.shape)} {emb6.dtype}")
    rec6, _ = _k6_case("auto_2m", "flat lane, decision's sample queries", q6, emb6, bias6)
    rec6["launches"] = decide["K6"]
    results["K6"]["auto_2m"] = rec6
    q7, probes7, counts7, emb7, _, k7 = flat_args["ivf_rescore"]
    rec7 = _k7_case("auto_2m", "flat lane, decision's sample queries", q7, probes7, counts7, emb7, k7, _AUTO_SAMPLE_Q)
    rec7["launches"] = flat_args["ivf_rescore calls"]
    results["K7"]["auto_2m_flat"] = rec7
    route = engine._route()
    check(stats["engine"] == ("ivf" if isinstance(route, IVFVectorEngine) else "flat"),
          f"auto_2m: stats() {stats} does not name the served engine {route.kind}")
    if stats["engine"] == "ivf":
        check((snap.n_clusters, snap.bucket_size, snap.emb.dtype) == (2896, 1152, torch.float32),
              f"auto_2m: IVF snapshot {snap.n_clusters} x {snap.bucket_size} {snap.emb.dtype}")
        log("auto_2m", f"IVF snapshot: {snap.n_clusters} clusters of S {snap.bucket_size} f32, spilled="
            f"{snap.spilled}, buckets {snap.emb.numel() * 4 / 1e9:.3f} GB")

    serve_args = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    served, per_batch = [], []
    t0 = time.perf_counter()
    with first_call_args(ivfk, "ivf_rescore", serve_args):
        for qb in queries:
            t1 = time.perf_counter()
            served.append(engine.search(qb.to(dev), 10))
            per_batch.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    serve = launch_counts()
    check(serve["K7"] == len(queries), f"auto_2m: serving {len(queries)} batches launched K7 {serve['K7']} times")
    log("auto_2m", f"serve ({stats['engine']} route): 1024 queries in {wall:.3f} s = {1024 / wall:.1f} queries/s; "
        f"per-batch ms (host clock, ending in the copy to the host) {[round(x, 3) for x in per_batch]}; "
        f"launches {serve}")
    for i in (0, 3):
        again = engine.search(queries[i].to(dev), 10)
        check(all(np.array_equal(a, b) for a, b in zip(again, served[i])), f"auto_2m batch {i}: repeat serving "
              "changed the results")
    exact = [engine._flat.search(qb.to(dev), 10)[1] for qb in queries]
    rec = AutoVectorEngine._recall(np.concatenate(exact), np.concatenate([f for _, f in served]))
    if stats["engine"] == "ivf":
        check(rec >= 0.92, f"auto_2m: served recall@10 {rec:.4f} against the flat lane < 0.92")
        q7, probes7, counts7, emb7, _, k7 = serve_args["ivf_rescore"]  # the first served batch's K7 call
        check(emb7 is snap.emb and probes7.shape[1] == route.nprobe, "auto_2m: the served K7 call is not the route's")
        rec7 = _k7_case("auto_2m", "served batch 0", q7, probes7, counts7, emb7, k7, 8)
        rec7["launches"] = decide["K7"] - flat_args["ivf_rescore calls"] + serve["K7"]
        results["K7"]["auto_2m"] = rec7
        q0 = queries[0].to(dev)
        device_profile("auto_2m serve", lambda: engine.search(q0, 10), iters=2)
    else:
        check(rec == 1.0, "auto_2m: the flat route does not serve the flat lane's answers")
    log("auto_2m", f"checks: repeat serving bit-identical; served recall@10 against the flat lane {rec:.4f} "
        f"({stats['engine']} route); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return {kid: decide[kid] + serve[kid] for kid in decide}


# ------------------------------------------------------------------------ orch_100k

ORCH_BUDGET = 4096  # the budgeted reopen's manual lex_postings_budget
# The least share of queries whose fused top-10 must equal the CPU's. Where they differ,
# the vector lane reordered near-ties (RRF fuses ranks, so one swap there can reorder
# the fused list): K1 ranks scores truncated to 2^-12 relative, summed in another order
# than the CPU's f32 product. Seeds 0-2 on an H100 gave 96.9-98.4% of 256 queries and
# 95.3-96.9% of the 64 budgeted ones; the floor leaves room for the 64-query set, where
# one query is 1.6%.
ORCH_FUSED_FLOOR = 0.90


def _hit_keys(resp) -> list:
    return [(h.frame_id, h.score, h.preview) for h in resp.hits]


def _lanes_agree(phase, what, qs, card, cpu) -> None:
    """BM25 lane lists [(frame_id, score)] of the card against the CPU, query by query:
    ids equal and scores within rtol 1e-6."""
    import numpy as np

    for q, a, b in zip(qs, card, cpu):
        check(len(a) == len(b), f"{phase}: {what} lane lengths differ for {q!r}: {len(a)} vs {len(b)}")
        check([f for f, _ in a] == [f for f, _ in b], f"{phase}: {what} lane ids differ for {q!r}")
        check(np.allclose([s for _, s in a], [s for _, s in b], rtol=1e-6, atol=0.0),
              f"{phase}: {what} lane scores beyond rtol 1e-6 for {q!r}")


def _vector_lanes_agree(phase, what, requests, card, cpu, snap) -> dict:
    """Vector lane lists [(frame_id, score)] of the card against the CPU, held to
    `_topk_agree`'s rule by each frame id's exact score: the f32 product of the
    request's normalised query vector with that id's row of the CPU's dense snapshot
    (`snap`), plus the bias. Every listed score, on either side, is within F32_TOL +
    TRUNC_REL * |exact| of its own id's exact score (so an id paired with another row's
    score fails), the same id's two scores are within that tolerance of each other,
    every id in one list and not the other is a near-tie of the CPU's k-th score by its
    exact score, and the ids overlap on >= 0.99 of all listed places. Returns the
    number of queries whose id lists differ (order included), the overlap, and the
    largest same-id and listed-vs-exact gaps."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops import flat_scan as fs

    qv = np.stack([np.asarray(r.embedding, np.float32) for r in requests])
    qv = qv / np.linalg.norm(qv, axis=1, keepdims=True)
    exact = fs.scan_scores(torch.from_numpy(qv), snap).numpy()
    fids = snap.frame_ids.cpu().numpy()
    live = np.nonzero(fids >= 0)[0]
    row_of = dict(zip(fids[live].tolist(), live.tolist()))
    differ = hit = listed = 0
    same_gap = exact_gap = 0.0
    for i, (r, a, b) in enumerate(zip(requests, card, cpu)):
        q = r.query
        check(len(a) == len(b) and len(b) > 0, f"{phase}: {what} lane lengths differ for {q!r}: {len(a)} vs {len(b)}")

        def exact_of(fid):
            row = row_of.get(fid)
            check(row is not None, f"{phase}: {what} lane lists frame id {fid} for {q!r}, which no live row holds")
            return float(exact[i, row])

        for side, lane in (("card", a), ("CPU", b)):
            for fid, s in lane:
                e = exact_of(fid)
                exact_gap = max(exact_gap, abs(s - e))
                check(abs(s - e) <= F32_TOL + TRUNC_REL * abs(e),
                      f"{phase}: {what} lane of the {side} gives frame {fid} score {s!r} for {q!r}, its exact "
                      f"score is {e!r}")
        sb = dict(b)
        for fid, s in a:
            if fid in sb:
                same_gap = max(same_gap, abs(s - sb[fid]))
                check(abs(s - sb[fid]) <= F32_TOL + TRUNC_REL * abs(sb[fid]),
                      f"{phase}: {what} lane scores of frame {fid} differ beyond a near-tie for {q!r}")
        ia, ib = set(f for f, _ in a), set(sb)
        kth = b[-1][1]
        for fid in ia ^ ib:
            check(abs(exact_of(fid) - kth) <= F32_TOL + TRUNC_REL * abs(kth),
                  f"{phase}: {what} lane frame {fid} of {q!r} is in one list only and is not a near-tie of the "
                  f"k-th score {kth!r}")
        hit += len(ia & ib)
        listed += len(b)
        differ += [f for f, _ in a] != [f for f, _ in b]
    overlap = hit / listed
    check(overlap >= 0.99, f"{phase}: {what} lane ids overlap {overlap:.4f} < 0.99")
    return {"differ": differ, "overlap": overlap, "same_gap": same_gap, "exact_gap": exact_gap}


def _fused_agree(phase, what, orch_cpu, requests, card, cpu, vec_card, vec_cpu) -> int:
    """Fused top-10 of the card against the CPU (frame ids, scores, previews). A query
    whose answers differ must have had its vector lane reordered (the lanes were held
    to near-ties by `_lanes_agree`), and the CPU orchestrator given the card's vector
    lane for that request must then answer exactly as the card did: the difference is
    the vector lane's near-tie order and nothing downstream of it. Returns the queries
    that differ."""
    import wax_tpu_torch.search.unified as unified

    differ = 0
    for r, a, b, va, vb in zip(requests, card, cpu, vec_card, vec_cpu):
        if _hit_keys(a) == _hit_keys(b):
            continue
        check([f for f, _ in va] != [f for f, _ in vb],
              f"{phase}: {what} fused top-10 differs for {r.query!r} with equal lanes")
        lane = unified._vector_lane
        unified._vector_lane = lambda engine, request, fetch_k, va=va: list(va)
        try:
            again = orch_cpu.search(r)
        finally:
            unified._vector_lane = lane
        check(_hit_keys(again) == _hit_keys(a),
              f"{phase}: {what} fused top-10 of {r.query!r} differs from the card's with the card's vector lane")
        differ += 1
    return differ


def orch_100k_phase(dev, seed: int, results: dict) -> dict:
    """path (f): the MemoryOrchestrator a user calls, over the smoke corpus's 102,400
    documents with the full-width MiniLM (random weights, bf16) in a temporary
    directory: remember_batch in calls of 1,024, flush, 256 search and 256 recall
    calls, a profiled window, a cold reopen (bit-identical answers), a read-only
    reopen with a manual postings budget (the candidate lane and K3), the same
    requests on the CPU, and K1 timed at the orchestrator's own B 1 shape."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMEmbedder
    from wax_tpu_torch.ops import flat_scan as fs
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.search.unified import _bm25_lane, _vector_lane
    from wax_tpu_torch.types import SearchRequest
    from wax_tpu_torch.utils.profiling import reset_spans, span_stats

    phase = "orch_100k"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, docs, queries = make_corpus(seed)
    qs = queries[0]
    tmp = Path(tempfile.mkdtemp(prefix="wax-orch-100k-"))
    path = tmp / "memory.mv2s"

    def spans(prefix: str) -> str:
        return "; ".join(f"{k} n={v['count']} total={v['total_ms']:.1f} p50={v['p50_ms']:.3f} p95={v['p95_ms']:.3f} ms"
                         for k, v in sorted(span_stats().items()) if k.startswith(prefix))

    def lanes(orch, requests):
        """(BM25 lane, vector lane) lists of each request, as unified_search runs them."""
        bm = [_bm25_lane(orch.engine, r.query, FETCH_K)[0] for r in requests]
        ve = [_vector_lane(orch.engine, r, FETCH_K) for r in requests]
        return bm, ve

    orch = None
    try:
        # 1. create and ingest
        embedder = MiniLMEmbedder(dtype=torch.bfloat16, batch_size=256, seed=0, device=dev)
        reset_spans()
        orch = MemoryOrchestrator(path, embedder, OrchestratorConfig(), device=dev)
        t0 = time.perf_counter()
        for i in range(0, len(docs), 1024):
            orch.remember_batch(docs[i : i + 1024])
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        ingest_spans = spans("remember.")
        t0 = time.perf_counter()
        orch.flush()
        t_flush = time.perf_counter() - t0
        wal = orch.store.wal_stats()
        check(len(orch.engine.lex) == len(docs) and len(orch.engine.vector) == len(docs),
              f"{phase}: ingest lost documents ({len(orch.engine.lex)} lex, {len(orch.engine.vector)} vectors)")
        log(phase, f"{len(docs)} docs through remember_batch (calls of 1,024) in {t_ingest:.2f} s = "
            f"{len(docs) / t_ingest:.1f} docs/s (host clock ending in a sync): {ingest_spans}")
        log(phase, f"flush {t_flush:.2f} s; file {path.stat().st_size} bytes; WAL auto-commits "
            f"{wal['auto_commit_count']}, wraps {wal['wrap_count']}, appends {wal['append_count']}")

        # 2. serve: search and recall one call at a time
        reset_spans()
        reset_launch_counts()
        torch.cuda.synchronize()
        lat_s, served = [], []
        for q in qs:
            t0 = time.perf_counter()
            served.append(orch.search(q, top_k=10))
            torch.cuda.synchronize()
            lat_s.append(time.perf_counter() - t0)
        lat_r, ctxs = [], []
        for q in qs:
            t0 = time.perf_counter()
            ctxs.append(orch.recall(q))
            torch.cuda.synchronize()
            lat_r.append(time.perf_counter() - t0)
        serve_launches = launch_counts()
        st = span_stats()
        vec_calls = st["search.vector_lane"]["count"]
        check(serve_launches["K1"] == vec_calls and vec_calls >= 2 * len(qs),
              f"{phase}: K1 launched {serve_launches['K1']} times for {vec_calls} vector-lane calls")
        for q, r, c in zip(qs, served, ctxs):
            check(len(r.hits) == 10 and all(np.isfinite(h.score) and h.score > 0 for h in r.hits),
                  f"{phase}: search({q!r}) returned {len(r.hits)} hits or a bad score")
            check(c.items and 0 < c.total_tokens <= c.budget_tokens and c.render(),
                  f"{phase}: recall({q!r}) assembled no context within its budget")
        for what, lat in (("search", lat_s), ("recall", lat_r)):
            p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
            log(phase, f"{what}: {len(lat)} calls one at a time, p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
                f"{len(lat) / sum(lat):.1f} calls/s (host clock ending in a device sync)")
        log(phase, f"spans: {spans('search.')}; {spans('orchestrator.')}")
        log(phase, f"launches over the {2 * len(qs)} calls: K1 {serve_launches['K1']} (= vector-lane calls "
            f"{vec_calls}), other port kernels {({k: v for k, v in serve_launches.items() if v and k != 'K1'})}")
        mean_bm25 = np.mean([r.lane_counts.get("bm25", 0) for r in served])
        log(phase, f"mean lane counts: bm25 {mean_bm25:.2f}, vector "
            f"{np.mean([r.lane_counts.get('vector', 0) for r in served]):.2f}; query types "
            f"{sorted(collections.Counter(r.query_type.value for r in served).items())}")
        # the card's query vectors (memoised by the searches above) and lanes, for the CPU
        reqs = [SearchRequest(query=q, top_k=10, embedding=orch.engine.embed_query(q)) for q in qs]
        bm_card, vec_card = lanes(orch, reqs)

        # 3. profile: 32 fresh searches (encoder included) in the window
        batches = iter([queries[1][:32], queries[1][32:64]])
        prof = device_profile(phase, lambda: [orch.search(q, top_k=10) for q in next(batches)], iters=1)
        check(prof["launched"].get("K1", 0) == 32,
              f"{phase}: the profiled window launched K1 {prof['launched'].get('K1', 0)} times for 32 searches")

        # 4. K1 at the orchestrator's own shape: B 1 over the live engine's snapshot, k 24
        snap = orch.engine.vector.snapshot()
        n, d = snap.emb.shape
        q1 = torch.from_numpy(reqs[0].embedding / np.linalg.norm(reqs[0].embedding))[None, :].to(dev)
        bias, tn = fs._index_bias(snap), fs._pick_tn(n)
        k = FETCH_K
        check(n == 131_072 and snap.emb.dtype == torch.float32, f"{phase}: dense snapshot {n} x {d} {snap.emb.dtype}")

        def run_kernel():
            return fs.packed_sel_tiles(q1, snap.emb, bias, k, tn)

        def run_plain():
            return fs._packed_sel_topk_plain(q1, snap.emb, bias, k, tn)

        kv, kr = fs._merge_tiles(*fs._decode_packed(run_kernel(), k, tn), k)
        pv, pr = fs._merge_tiles(*fs._decode_packed(run_plain(), k, tn), k)
        err, overlap = _topk_agree(phase, "K1 B 1", kv, kr, pv, pr, fs._scores_f32(q1, snap.emb) + bias[None, :],
                                   k, False, TRUNC_REL)
        out_bytes = (n // tn) * k * 4
        nbytes = 4 * (d + n * d) + 4 * n + out_bytes
        rec = {"ms": queued_ms(run_kernel), "plain_ms": queued_ms(run_plain), "max_abs_err": err}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * 2 * n * d, "tf32")
        rec["library_ms"] = queued_ms(lambda: torch.matmul(q1, snap.emb.t()))
        results["K1"]["orch_b1"] = rec
        results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], err)
        log(phase, f"K1 at B 1 x {n} x {d} f32, k {k} (tn {tn}): agree (max_abs_err={err:.3g}, overlap={overlap:.4f}); "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {nbytes} bytes), library (torch.matmul f32) {rec['library_ms']:.4f} ms "
            "(each queued behind a sleep kernel, CUDA events)")

        # 5. cold reopen: no parked engines, the segments deserialized
        orch.close()
        orch = None
        engine_cache.clear()
        reset_spans()
        t0 = time.perf_counter()
        orch = MemoryOrchestrator(path, embedder, OrchestratorConfig(), device=dev)
        t_open = time.perf_counter() - t0
        check(engine_cache.cache_stats()["hits"] == 0, f"{phase}: the cold reopen reclaimed a parked engine")
        t0 = time.perf_counter()
        orch.warmup(background=False)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        log(phase, f"cold reopen {t_open:.3f} s ({spans('open.')}); warmup {t_warm:.3f} s")
        again = [orch.search(q, top_k=10) for q in qs]
        same = sum(_hit_keys(a) == _hit_keys(b) for a, b in zip(served, again))
        check(same == len(qs), f"{phase}: the cold reopen answers {len(qs) - same} of {len(qs)} queries differently")
        log(phase, f"cold reopen: {len(qs)} searches bit-identical (frame ids, scores, previews); the adopted "
            f"dense snapshot holds {orch.engine.vector.snapshot().capacity} rows (the live one {n})")

        orch.close()  # the writer's lease must go before a read-only open
        orch = None

        # 6. read-only reopen with a manual budget: truncated terms take the candidate lane
        bcfg = OrchestratorConfig(lex_postings_budget=ORCH_BUDGET)
        orch = MemoryOrchestrator(path, embedder, bcfg, readonly=True, device=dev)
        lex = orch.engine.lex_snapshot()
        dfs = np.diff(orch.engine.lex.csr()[0])
        check(lex.fwd_tids is not None, f"{phase}: budget {ORCH_BUDGET} truncated no term")
        bq = [r for r in reqs[:64]]
        reset_launch_counts()
        served_b = [orch.search(r.query, top_k=10) for r in bq]
        budget_launches = launch_counts()
        check(budget_launches["K3"] > 0, f"{phase}: the budgeted reopen did not launch K3")
        check(all(len(r.hits) == 10 for r in served_b), f"{phase}: a budgeted search returned fewer than 10 hits")
        bm_card_b, vec_card_b = lanes(orch, bq)
        log(phase, f"budgeted reopen (lex_postings_budget={ORCH_BUDGET}, read-only): {int((dfs > ORCH_BUDGET).sum())} "
            f"terms above the budget, max df {int(dfs.max())}; 64 searches launched K3 {budget_launches['K3']} and "
            f"K1 {budget_launches['K1']} times; warnings on {sum(bool(r.warnings) for r in served_b)} responses")
        orch.close()
        orch = None

        # 7. the same requests on the CPU, with the card's query vectors
        for label, cfg, reqs_c, card, bm_c, vec_c in (
            ("unbudgeted", OrchestratorConfig(), reqs, served, bm_card, vec_card),
            (f"budget {ORCH_BUDGET}", bcfg, bq, served_b, bm_card_b, vec_card_b),
        ):
            engine_cache.clear()
            t0 = time.perf_counter()
            orch = MemoryOrchestrator(path, embedder, cfg, readonly=True, device="cpu")
            cpu = [orch.search(r) for r in reqs_c]
            bm_cpu, vec_cpu = lanes(orch, reqs_c)
            qtexts = [r.query for r in reqs_c]
            _lanes_agree(phase, f"{label} BM25", qtexts, bm_c, bm_cpu)
            vec = _vector_lanes_agree(phase, f"{label} vector", reqs_c, vec_c, vec_cpu, orch.engine.vector.snapshot())
            fdiff = _fused_agree(phase, label, orch, reqs_c, card, cpu, vec_c, vec_cpu)
            orch.close()
            orch = None
            spread = np.median([va[0][1] - va[-1][1] for va in vec_c])
            equal = (len(reqs_c) - fdiff) / len(reqs_c)
            log(phase, f"CPU cross-check ({label}, {len(reqs_c)} requests, {time.perf_counter() - t0:.1f} s): BM25 "
                f"lanes equal (ids; scores rtol 1e-6); vector lanes equal on {len(reqs_c) - vec['differ']}, the rest "
                f"near-ties by exact score (K1's 2^-12 keys; id overlap {vec['overlap']:.4f}, same-id score gap max "
                f"{vec['same_gap']:.3g}, listed-vs-exact gap max {vec['exact_gap']:.3g}, median top-{FETCH_K} spread "
                f"{spread:.3g}); fused top-10 equal on {len(reqs_c) - fdiff} of {len(reqs_c)} ({100 * equal:.1f}%), "
                "each other one equal to the card's given the card's vector lane")
            check(equal >= ORCH_FUSED_FLOOR, f"{phase}: {label} fused top-10 equal on {100 * equal:.1f}% of queries, "
                  f"under the floor {100 * ORCH_FUSED_FLOOR:.0f}%")
    finally:
        if orch is not None:
            orch.close()
        engine_cache.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    log(phase, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"K1": serve_launches["K1"], "K3": budget_launches["K3"]}


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
    t0 = time.perf_counter()
    results = kernel_phase(dev, args.seed)
    log("kernels", f"phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    results.update(kernel2_phase(dev, args.seed))
    log("kernels2", f"phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    _, docs, queries = make_corpus(args.seed)
    engine = ingest_phase(dev, docs)
    served, exact_req, launches, modes = serve_phase(engine, queries)
    checks_phase(engine, queries, served, exact_req, modes)
    log("checks", f"ingest + serve + checks phase seconds {time.perf_counter() - t0:.1f}")
    del engine, served, docs

    import torch

    torch.cuda.empty_cache()
    path_a = engine_1m_phase(dev, args.seed, results)
    torch.cuda.empty_cache()
    path_b = hybrid_1m_phase(dev, results)
    torch.cuda.empty_cache()
    path_c = exact_30k_phase(dev, args.seed, results)
    torch.cuda.empty_cache()
    path_d = ivf_1m_phase(dev, args.seed, results)
    torch.cuda.empty_cache()
    path_e = auto_2m_phase(dev, args.seed, results)
    torch.cuda.empty_cache()
    path_f = orch_100k_phase(dev, args.seed, results)
    launches["K1"] += path_f["K1"]
    launches["K3"] = path_a["K3"] + path_b["K3"] + path_f["K3"]
    launches["K4"] = path_a["K4"] + path_b["K4"]
    for kern in ("K6", "K7"):
        launches[kern] = path_a[kern] + path_b[kern] + path_d[kern] + path_e[kern]
    launches["K5"] = path_a["K5"]
    launches["K8"], launches["K9"] = path_c["K8"], path_c["K9"]

    sources = {
        "K1": ("packed_sel_scan_topk", "flat_scan.cu", "wax_tpu/ops/flat_scan.py:201"),
        "K2": ("scan_topk", "flat_scan.cu", "wax_tpu/ops/flat_scan.py:299"),
        "K3": ("rescore_fused", "bm25_rescore.cu", "wax_tpu/ops/bm25_rescore.py:218"),
        "K4": ("chunked_candidates_sel", "bm25_chunked.cu", "wax_tpu/ops/bm25_chunked_pallas.py:115"),
        "K5": ("rescore_split", "bm25_rescore.cu", "wax_tpu/ops/bm25_rescore.py:87"),
        "K6": ("chunk_maxima", "chunkmax.cu", "wax_tpu/ops/chunkmax_scan.py:45"),
        "K7": ("bucket_rescore", "ivf_kernel.cu", "wax_tpu/ops/ivf_kernel.py:34"),
        "K8": ("candidate_scores_pallas", "bm25_candidates.cu", "wax_tpu/ops/bm25_candidates_pallas.py:150"),
        "K9": ("packed_topk_tiles", "packed_topk.cu", "wax_tpu/ops/flat_scan.py:115"),
    }
    kernels = []
    for kern in KERNEL_IDS:
        name, src, fn_line = sources[kern]
        r = results[kern]
        kernels.append({
            "name": f"{kern} {name}", "route": "cuda", "source": f"wax_tpu_torch/csrc/{src}",
            "replaces": fn_line, "launches": launches[kern], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{key: r[key] for key in ("x768", "rows_10240", "engine_1m_l2_64", "hybrid_1m_wide", "ivf_1m", "auto_2m",
                                       "auto_2m_flat", "orch_b1") if key in r},
        })
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
