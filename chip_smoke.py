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
            `lex_sharded` (chunked candidates K4, then K3); the BM25 builder is built
            in a process of its own from the start, beside the phases before this one.
            Checks: repeat serving
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
  hybrid_1m_sharded the same program on [hybrid_1m]'s rows, queries, term ids and
            postings split over 2 corpus shards (524,288 rows a shard: K6 + K7, K4, K3
            each shard), 4 shards (262,144: K1, K4, K3) and the 2 x 2 two-level mesh
            (equal to 4 shards bit for bit): per-call median of 20, launches a call
            (each kernel exactly S), busy share, the fused ids against the same program
            on a CPU copy (32 queries); 4 distinct cards when the machine has them,
            else 4 logical shards on the one card (printed)
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
  shard_10m BASELINE.md's scale configuration: 10,485,760 x 768 unit rows in bf16
            (16.1 GB) drawn on the card in seeded 1M-row chunks, split over 4 shards:
            sharded_flat_scan_topk at B 256, k 10 on the flat mesh and the 2 x 2 mesh
            (bit-equal; 2,621,440 contiguous rows a shard take K6 + K7), against one
            shard of the same rows on 64 queries (scores within rtol 1e-6, ids equal but
            near-ties of the k-th score), a 1/8-grid slab of 1,048,576 rows: 4 shards
            and 2 x 2 bit-equal (262,144 rows a shard: the f32-product route), one shard
            (K6 + K7) with the same scores, each id's float64 product its score; ms a
            batch (median of 10) on each mesh, each shard's K6 + K7 device ms and the
            merge's, busy share, peak memory, the synchronising calls
            of one call at S 1, 2 and 4 (set_sync_debug_mode "warn"; they must not grow
            with S); then sharded_ivf_search_topk over [ivf_1m]'s index (kept, not
            rebuilt) on 4 slot shards: scores equal to the one-device plain probe loop
            within rtol 1e-6, recall@10 against [ivf_1m]'s exact lane, ms a call
  auto_2m   path (e): make_vector_engine("auto", dim=768) with its defaults over
            2,097,152 x 768 rows of the same mixture: the routing decision (the bf16
            flat lane's exact answers for 64 sampled queries, K6 + K7; IVF builds of
            2,896 clusters of S 1,152 f32 and K7 searches up the nprobe ladder) in a
            window of its own, stats() printed; then 4 x 256 perturbed corpus rows
            served through search() (K7 on an IVF route); repeat serving bit-identical,
            served recall@10 against the flat lane >= 0.92 on an IVF route; K7 held at
            the served probes ("auto_2m" under K7)
  orch_100k path (f): the MemoryOrchestrator users call, in a temporary directory that
            [orch_maint] then works on: a .mv2s store, remember_batch over smoke_100k's 102,400
            documents in calls of 1,024 (full-width MiniLM, bf16, random weights; the
            default "auto" vector engine is flat at capacity 131,072 x 384 f32), flush;
            128 search(top_k=10) and 128 recall() calls one at a time (p50, p99,
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
  orch_maint maintenance on [orch_100k]'s store (no second ingest): forget 10,240 of
            its documents (10%, drawn from --seed; seconds); 64 searches at B 1 with no
            forgotten frame id in any lane; dead_bytes(); compact_indexes() (seconds;
            lex and vector rows down to the live count); the 64 searches again, K1
            held and timed at the compacted shape ("orch_maint" under K1);
            rewrite_live_set() (frames and bytes before and after, seconds; the file
            shrinks; the 64 answers equal the compacted ones under the id remap, bit
            for bit); verify(deep=True) and a cold reopen answering bit for bit; the
            rewritten file read-only on the CPU against the card at [orch_100k]'s gates
  hnsw_100k path (g): BASELINE config 3: make_vector_engine("hnsw", dim=384) (the
            native CppHNSWBuilder, required; M 16, efConstruction 100) over 102,400
            hard-clustered unit rows (scripts/hnsw_parity.py's "hard" set: 200 centres,
            noise 0.15), the build's host seconds, the snapshot's seconds and bytes on
            the card; 256 queries (the same set from seed + 1) at ef 16, 64, 128 and 256
            through `hnsw_search` on the card: recall@10 against the exact top-10 of K2
            (`flat_scan_topk(backend="pallas")`, K2 held against its twin and timed
            there, "hnsw_100k" under K2), ms a batch (median of 20, CUDA events), kernels
            a search and busy share (torch.profiler); every id live and unique, every
            score within 3e-5 of its float64 score, recall falling by no more than 0.01
            as ef grows and >= 0.95 at ef 256; TF32 on gives the same bits; the same
            graph on the CPU overlaps the card's top-10 >= 0.98 (32 queries, ef 64); a
            4,096 x 64 grid graph answers bit for bit as the CPU at ef 16 and 64
  orch_hnsw MemoryOrchestrator(OrchestratorConfig(vector_engine="hnsw")) over the first
            10,240 smoke documents (full-width MiniLM, bf16, random weights):
            remember_batch, 64 searches and 16 recalls one at a time (p50, p99; no port
            kernel launched), a profiled window, the vector lane's recall@10 against a
            flat engine over the same embeddings (reported), flush, close and a cold
            reopen (stats "hnsw", CppHNSWBuilder, the 64 answers bit-identical); then
            open_session(..., vector_preference="hnsw"): put_batch of the documents with
            their embeddings, commit, reopen, 16 searches bit-identical
  orch_maint_hnsw maintenance on [orch_hnsw]'s store: optimize_surrogates() twice (the
            second finds every surrogate current); forget 10% and rewrite_live_set():
            the graph rebuilt by CppHNSWBuilder on the card, the vector lane's
            recall@10 against a flat engine within 0.02 of [orch_hnsw]'s, a cold reopen
            bit-identical. Then PhotoRAGOrchestrator(device=dev): 1,024 synthetic
            224x224x3 images, 4 OCR blocks each (a stub provider), a seeded
            deterministic multimodal embedder of width 384 (more than 2,048 inner
            rows, so recall runs through K1), 64 recalls; forget 10% of the assets,
            compact, recall, rewrite: the asset roots follow the remap and the recalls
            equal the compacted ones under it. VideoRAGOrchestrator: 256 videos of 16
            transcript segments, the same steps with recall(top_k=4) (the default
            top_k 8 asks the flat lane for 256 hits, past K1's k 128)
  train     the contrastive Trainer (parallel/train.py) at MiniLMConfig()'s width: BERT's
            random initialisation from the seed (matrices N(0, 0.02^2)), lr 1e-4, f32
            parameters, bf16 compute, TRAIN_STEPS steps of 256 synthetic query/document
            pairs of length 64 that share no token (12 of 8,192 concepts each, written
            with disjoint token ranges); losses, step ms (p50 and spread), tokens/s,
            train_mfu (model FLOPs of a step over its p50 time at 989 TFLOP/s bf16), peak
            memory, a profiled window of 3 steps; recall@10 of 256 held-out queries over
            10,240 held-out documents through FlatVectorEngine (auto -> K1, k 10) before
            and after (K1 twice, nothing else); K1 held and timed at that shape
            ("train_eval" under K1); a checkpoint saved at step 3 and resumed gives the
            uninterrupted run's losses bit for bit under
            torch.use_deterministic_algorithms (ops without a deterministic CUDA form
            are named, and then held within rtol 1e-5). Then, from the same init and
            batches, on data 4 and data 2 x tp 2 (4 distinct cards when present, else
            4 logical shards of the card): in f32 with TF32 off, 3 steps on each against
            one device's (losses within rtol 1e-5; leaves within atol 1e-6, the
            attention key biases and elements whose gradient fell below 1e-6 within the
            learning rate a step more), the loss and gradients of a step with TF32
            turned on bit for bit as with it off (one device and data 2 x tp 2), a
            checkpoint saved on data 2 x tp 2 resumed on one device (rtol 1e-5, 305
            leaves) and on the same mesh bit for bit; in bf16 on one device and each
            mesh: the loss at the init against one device's, step ms p50 (CUDA events),
            busy share and device launches a step, and synchronising calls a step (not
            more on a mesh than on one device)
  mcp       the MCP server (surfaces/mcp_server.py): a store of the smoke corpus's
            102,400 documents built with HashEmbedder(384) in a process of its own
            beside [train]; build_server in process (the hash embedder kept by
            _select_embedder): a profiled window of 32 searches, then 1,024 JSON-RPC
            messages in an agent session's order (the handshake, 256 rounds of
            wax_search and wax_recall, 256 wax_remember, 64 structured calls, 16
            handoffs and their latest, 88 searches with the tool's options, the
            timeline, stats, 64 forgets, a flush): p50 and p99 per tool; K1 once per
            vector-lane call at B 1 over the reopened store's 102,400 x 384 f32
            snapshot, until the remembers double it to 204,800 rows, past the 131,072
            up to which flat_scan's auto picks K1 (the later calls run the plain
            blockmax scan, as JAX's do); 64 searches of the server reopened over the
            flushed store against a CPU server over its copy (BM25 lanes equal,
            vector lanes by exact score, fused top-10 at ORCH_FUSED_FLOOR), with
            `python -m wax_tpu_torch.surfaces.cli mcp doctor` meanwhile (exit 0, the
            card named); `python -m wax_tpu_torch.surfaces.mcp_server` over stdio on
            that store finds a note remembered and flushed above and exits 0 on
            closed stdin
  orch_sharded [mcp]'s flushed store reopened read-only as
            OrchestratorConfig(sharded_lanes=True) over 4 shards and again with
            mesh_slices=2: N_ORCH_SHARDED search and recall calls one at a time (p50,
            p99), the cold open; the exact BM25 lane through K8 on each shard (K8 = 4 x
            the lane's sharded runs); the store's `auto` vector segment keeps its engine
            (K1 at B 1 on the lead card); the two-level answers equal the flat mesh's,
            the BM25 lane the unsharded reopen's (scores within rtol 1e-6, ids but for
            near-tie swaps), and a CPU orchestrator of the same config over the same
            file (its BM25 lane on K8's plain twin): BM25 lanes equal, vector lanes by
            exact score, the fused top-10 at ORCH_FUSED_FLOOR; then
            make_vector_engine("sharded", mesh=...) over the store's vectors on 4
            shards (what `sharded_lanes` builds for a fresh store): its snapshot adds
            no more to a card than that card's shards, its answers agree with one
            shard's (scores within rtol 1e-6, ids but for near-ties), its `sharded`
            segment loads on the 2 x 2 mesh and answers bit for bit as it, an added row
            is a new generation the next search finds; B 1 search p50 on 4 shards and
            on one; K8 held against its plain twin at the lane's first call on 4 shards
            (recorded by `first_call_args`) and timed there, queued ("orch_sharded"
            under K8 in the kernels line)

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
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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


# each port kernel's entry in the kernel library, whose launches `ops/_build.launch` counts
KERNEL_ENTRIES = {"K1": "wax_k1_packed_sel", "K2": "wax_k2_scan_topk", "K3": "wax_k3_rescore_fused",
                  "K4": "wax_k4_chunked_sel", "K5": "wax_k5_rescore_split", "K6": "wax_k6_chunk_maxima",
                  "K7": "wax_k7_bucket_rescore", "K8": "wax_k8_candidates", "K9": "wax_k9_packed_topk"}


def launch_counts() -> dict:
    from wax_tpu_torch.utils.profiling import counters

    counts = counters()
    return {kid: counts.get(entry, 0) for kid, entry in KERNEL_ENTRIES.items()}


def reset_launch_counts() -> None:
    from wax_tpu_torch.utils.profiling import reset_counters

    reset_counters()


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
    """Run fn() `iters` times under torch.profiler and print the devices' busy share of
    the window (device time of all kernels / wall time, over the cards that ran one),
    the device time by kernel, and
    each port kernel's recorded device events against its launch count in the window;
    where the two differ, also the window's device timeline. The profiler records no
    device event from the first few ms of its trace, so one untimed call of fn() runs
    first, and only the device events that start after it count. A full garbage
    collection runs before the timed calls, so that one over a large host heap does not
    land in them at random. Returns the port kernels' launches in the window
    ("launched"), their recorded device events ("recorded", None when the profiler
    recorded no device time), the device events of all kernels ("events") and the busy
    share ("busy"; both None without device time)."""
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
    # the profiler's raw events: `prof.events()` would build a Python tree of every
    # host op first, seconds for a window of thousands of launches
    events = [e for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()]
    start = min(e.start_ns() for e in events if e.name() == mark) / 1e3
    cuda = [e for e in events
            if e.device_type() == DeviceType.CUDA and e.start_ns() / 1e3 >= start and e.name() != mark]
    timeline = sorted((e.start_ns() / 1e3, e.duration_ns() / 1e3, e.name()) for e in cuda)
    cards = max(1, min(len({e.device_index() for e in cuda}), torch.cuda.device_count()))
    if not timeline:
        log(phase, f"profile: no device time recorded over {wall_ms:.3f} ms of wall time (not measured)")
        return {"launched": launched, "recorded": None, "events": None, "busy": None}
    by_name: dict = {}
    for _, dur, name in timeline:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur / 1e3, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    share = busy / (wall_ms * cards)
    log(phase, f"profile over {iters} calls: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms on {cards} card(s) "
        f"({100 * share:.1f}%, idle {100 - 100 * share:.1f}%); device ms by kernel: "
        + "; ".join(f"{short_kernel_name(k)} {ms:.3f} ({n}x)" for ms, n, k in rows[:top]))
    recorded = {kid: sum(1 for *_, name in timeline if short_kernel_name(name) == kid) for kid in launched}
    log(phase, "profile: port kernels recorded/launched in the window: "
        + ", ".join(f"{kid} {recorded[kid]}/{n}" for kid, n in sorted(launched.items())))
    if recorded != launched:
        log(phase, "profile: device timeline (start us, duration us, kernel): "
            + "; ".join(f"{t - start:.1f} {d:.1f} {short_kernel_name(name)}" for t, d, name in timeline))
    return {"launched": launched, "recorded": recorded, "events": len(timeline), "busy": share}


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


def median_call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` calls of fn() in ms, each timed by CUDA events recorded just
    before and just after it (a host-bound call's events span its launches too)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    scores = fs.scores_f32(q, emb) + bias[None, :]  # exact scores for near-tie checks
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
    launches = {kid: n for kid, n in launch_counts().items() if kid in ("K1", "K2")}
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
    """A copy of a snapshot dataclass with every tensor field (or per-shard tuple of
    tensors) on the CPU."""
    import dataclasses

    import torch

    def cpu(v):  # a tensor, or a tuple of per-shard tensors
        return tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()

    return dataclasses.replace(obj, **{f.name: cpu(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                                       if torch.is_tensor(getattr(obj, f.name)) or isinstance(getattr(obj, f.name),
                                                                                            tuple)})


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
    """Within the block, record the positional arguments of the first call of
    `module.name` in seen[name], its keyword arguments in seen[name + " kwargs"] and the
    number of its calls in seen[name + " calls"] (the call itself runs unchanged)."""
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        seen.setdefault(name, args)
        seen.setdefault(name + " kwargs", kwargs)
        seen[name + " calls"] = seen.get(name + " calls", 0) + 1
        return fn(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, fn)


def build_engine_1m_lex(out_dir: str, seed: int) -> None:
    """[engine_1m]'s BM25 builder: make_corpus(seed + 1)'s 1,048,576 documents added one
    by one with the budget "auto" (what `HybridSearchEngine.index_text` does),
    serialized (`serialize_lex`) into `out_dir` beside the corpus's queries; prints
    its seconds. `start_engine_1m_lex` runs it in a process of its own."""
    from wax_tpu_torch.index.lex import LexIndexBuilder
    from wax_tpu_torch.orchestrator.serialization import serialize_lex

    t0 = time.perf_counter()
    _, docs, queries = make_corpus(seed + 1, N_1M)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    lex = LexIndexBuilder(postings_budget="auto")
    for fid, text in enumerate(docs):
        lex.add(fid, text)
    t_lex = time.perf_counter() - t0
    blob, attrs = serialize_lex(lex)
    out = Path(out_dir)
    (out / "lex.bin").write_bytes(blob)
    (out / "meta.json").write_text(json.dumps({"attrs": attrs, "queries": queries}))
    print(json.dumps({"corpus_s": t_corpus, "lex_s": t_lex, "bytes": len(blob)}), flush=True)


def start_engine_1m_lex(tmp: Path, seed: int):
    """Build [engine_1m]'s BM25 builder in a process of its own (`build_engine_1m_lex`),
    on the host beside the phases before it. Returns (directory, process)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.build_engine_1m_lex(sys.argv[2], int(sys.argv[3]))")
    proc = subprocess.Popen([sys.executable, "-c", code, str(REPO), str(tmp), str(seed)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return tmp, proc


def engine_1m_phase(dev, seed: int, results: dict, lex_job=None) -> dict:
    """Path (a): the engine at 1,048,576 documents; returns this phase's launches.
    `lex_job` (from `start_engine_1m_lex`) supplies its BM25 builder, built beside the
    earlier phases; without one the phase builds it here."""
    import dataclasses

    import numpy as np
    import torch

    from wax_tpu_torch.ops import bm25_rescore as rs
    from wax_tpu_torch.ops.bm25_lane import bm25_candidates_topk, bm25_candidates_topk_pallas
    from wax_tpu_torch.ops.flat_scan import flat_scan_topk, normalize_rows
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.sharded_hybrid import sharded_bm25_topk
    from wax_tpu_torch.search.engine import HybridSearchEngine

    from wax_tpu_torch.orchestrator.serialization import deserialize_lex

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = HybridSearchEngine(None, dim=384, device=dev, lex_postings_budget="auto")
    if lex_job is None:
        lex_job = start_engine_1m_lex(Path(tempfile.mkdtemp(prefix="wax-engine-1m-")), seed)
    out_dir, proc = lex_job
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=900)
    t_wait = time.perf_counter() - t0
    check(proc.returncode == 0, f"engine_1m: the BM25 builder's process exited {proc.returncode}: "
          f"{err.strip().splitlines()[-5:]}")
    built = json.loads(out.strip().splitlines()[-1])
    meta = json.loads((out_dir / "meta.json").read_text())
    queries = meta["queries"]
    t0 = time.perf_counter()
    engine.lex = deserialize_lex((out_dir / "lex.bin").read_bytes(), meta["attrs"])
    engine.lex.postings_budget = "auto"  # runtime config, as the orchestrator re-applies it
    t_load = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    t_corpus, t_lex = built["corpus_s"], built["lex_s"]
    # the same builders behind a second engine whose BM25 lane is the sharded program
    engine_sh = HybridSearchEngine(None, dim=384, device=dev, lex_sharded=True, lex_postings_budget="auto")
    engine_sh.lex, engine_sh.vector = engine.lex, engine.vector
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
    log("engine_1m", f"{N_1M} docs: host seconds corpus={t_corpus:.2f} lex={t_lex:.2f} (both in a process of its own "
        f"beside the earlier phases; {t_wait:.2f} s waited for it here, its {built['bytes']} bytes loaded in "
        f"{t_load:.2f} s) vectors={t_vec:.2f} snapshots={t_snap:.2f} sharded snapshot={t_snap_sh:.2f}; budget="
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


def synth_lex_arrays(n: int, n_terms: int, budget: int, seed: int = 5, per_doc: int = 64) -> dict:
    """The bench's synthetic Zipf (s = 0.7) postings as numpy arrays: per-term
    row-sorted slices, df clamped at `budget` (impact-budget semantics), doc_len ==
    avgdl == 64, and the forward index.
    Same draws as bench.py `_synth_sharded_lex`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    raw_df = (1.0 / np.arange(1, n_terms + 1)) ** 0.7
    df_natural = np.minimum((raw_df / raw_df.sum() * per_doc * n).astype(np.int64) + 1, n)
    df = np.minimum(df_natural, budget)
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
    return dict(doc_rows=doc_rows, tfs=tfs, offsets=offsets, idf=idf, doc_len_g=np.full(n, 64.0, np.float32),
                frame_ids_g=np.arange(n, dtype=np.int32), active_g=np.ones(n, bool), count=n, avgdl_f=64.0,
                fwd_tids=ft, fwd_wnorm=fw, fwd_width=int(widths.max()), wnorm=wnorm)


def synth_sharded_lex(arrays: dict, dev):
    """`synth_lex_arrays`' postings as a one-shard ShardedLexIndex with the bench's
    weights, the fused forward index and the impact chunks, without the TPU's padding
    and reversed copies."""
    import numpy as np
    import torch

    from wax_tpu_torch.index.lex import build_impact_chunks, fuse_forward
    from wax_tpu_torch.parallel.sharded_hybrid import ShardedLexIndex

    a = arrays
    n, offsets, idf, wnorm = a["count"], a["offsets"], a["idf"], a["wnorm"]
    max_df = int(((np.diff(offsets).max() + 127) // 128) * 128)
    fz = fuse_forward(torch.from_numpy(a["fwd_tids"]), torch.from_numpy(a["fwd_wnorm"]), a["fwd_width"])
    pk, cb, cc, qb = build_impact_chunks(*map(torch.from_numpy, (a["doc_rows"], wnorm, offsets, idf.astype(np.float64))),
                                         n)

    def put(x):  # one shard's array
        return (torch.as_tensor(np.ascontiguousarray(x)).to(dev),)

    return ShardedLexIndex(
        doc_rows=put(a["doc_rows"]), tfs=put(a["tfs"]), offsets=put(offsets.astype(np.int32)), idf=put(idf),
        doc_len=put(a["doc_len_g"]), frame_ids=put(a["frame_ids_g"]), live=put(a["active_g"]),
        row_base=(torch.zeros((), dtype=torch.int32, device=dev),),
        count=(torch.tensor(n, dtype=torch.int32, device=dev),), avgdl=torch.tensor(64.0, device=dev),
        wnorm=put(wnorm), fwd_tids=put(a["fwd_tids"]), fwd_wnorm=put(a["fwd_wnorm"]), fwd_fused=put(fz),
        pk_chunks=put(pk), chunk_base=put(cb), chunk_counts=put(cc), max_df=max_df, pk_qb=qb,
        pk_max_chunks=int(cc.max()), fwd_width=a["fwd_width"],
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


def hybrid_1m_phase(dev, results: dict, n_terms: int = 16_384, iters: int = 20, keep: dict | None = None) -> dict:
    """Path (b): the fused one-device program at the bench's hybrid_1m_x384 shape;
    returns this phase's launches. `keep` (a dict) receives the rows, the queries, the
    term ids and the postings' arrays for [hybrid_1m_sharded]."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk
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
    arrays = synth_lex_arrays(N_1M, n_terms, budget)
    lex = synth_sharded_lex(arrays, dev)
    t_lex = time.perf_counter() - t0
    dense = ShardedDenseIndex(emb=(emb,), frame_ids=(torch.arange(N_1M, dtype=torch.int32, device=dev),),
                              bias=(torch.zeros(N_1M, device=dev),), contiguous=True)
    tids0 = torch.from_numpy(np.random.default_rng(7).integers(0, n_terms, (b, q_terms)).astype(np.int32)).to(dev)
    mesh = data_mesh(dev)
    log("hybrid_1m", f"{N_1M} rows x {d} bf16; synthetic postings built in {t_lex:.2f} s: {lex.doc_rows[0].shape[0]} "
        f"postings, {n_terms} terms, budget {budget}, max_df={lex.max_df}, fwd_width={lex.fwd_width}, "
        f"impact chunks={lex.pk_chunks[0].shape[0] // 1024}, qb={lex.pk_qb}")
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
        chunkmax_scan_topk(q0, dense.emb[0], dense.bias[0], 20)
        e[1].record()
        sh._bm25_lane(t2, lex, 0, 20, "any", "candidates_pallas")
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
    gdv, gdr = chunkmax_scan_topk(q0[:nq], dense.emb[0], dense.bias[0], 20)
    cdv, cdr = chunkmax_scan_topk(q0[:nq].cpu(), dense_cpu.emb[0], dense_cpu.bias[0], 20)
    gbv, gbf = sh._bm25_lane(tids0[:nq], lex, 0, 20, "any", "candidates_pallas")
    cbv, cbf = sh._bm25_lane(tids0[:nq].cpu(), lex_cpu, 0, 20, "any", "candidates_pallas")
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
    if keep is not None:
        keep.update(emb=emb, q0=q0, tids0=tids0, arrays=arrays, n_terms=n_terms, fused=(fv0, ff0))
    log("hybrid_1m", f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


# ---------------------------------------------------------------------------- exact_30k


def _k8_bound(tids, offs, idf, q2: int, w2: int, sel: int) -> tuple:
    """(bound ms, bound_by, postings read, bytes written) of one K8 call: each posting
    its window holds read once (row and weight), the term ids, each slot's offsets and
    idf, and the output plane (sel 0) or its top `sel` per slot position written."""
    from wax_tpu_torch.ops import bm25_candidates_pallas as k8

    b, q = tids.shape
    _, eff, _, _, _ = k8._slots(tids, offs, idf, q2, w2)
    n_read = int(eff.sum())
    out_bytes = b * (q2 * w2 if sel == 0 else sel * 1024) * 8
    return (*bound(n_read * 8 + b * q * 4 + b * q2 * 12 + out_bytes, 2 * n_read, "fp32"), n_read, out_bytes)


def _k8_call_case(phase: str, args: tuple, kwargs: dict) -> dict:
    """K8 at the arguments a path passed it (recorded by `first_call_args`): bit-equal
    to its plain twin, kernel and plain times queued behind a sleep kernel, the bound."""
    import torch

    from wax_tpu_torch.ops import bm25_candidates_pallas as k8

    tids, rows, wn, offs, idf = args
    mode, sel = kwargs.get("mode", "any"), kwargs.get("sel", 0)
    q2, w2 = 2, k8.dma_window(int(kwargs["max_df"]))
    while q2 < tids.shape[1]:
        q2 *= 2

    def run_kernel():
        return k8.candidate_scores_pallas(*args, **kwargs)

    def run_plain():
        return k8._candidate_scores_plain(tids.to(torch.int32), rows, wn, offs, idf, q2, w2, mode, sel)

    want = run_plain()
    check(all(torch.equal(x, y) for x, y in zip(run_kernel(), want)),
          f"{phase}: K8 differs from its plain twin at the lane's arguments")
    check(all(torch.equal(x, y) for x, y in zip(k8.candidate_scores_pallas(*args, **kwargs, split=1), want)),
          f"{phase}: K8 at one CTA a query differs from its plain twin at the lane's arguments")
    plan = k8.device_plan(tids.shape[0], q2, w2, sel, rows.device)
    ms, plain_ms = queued_ms(run_kernel), queued_ms(run_plain, iters=10)
    bound_ms, bound_by, n_read, out_bytes = _k8_bound(tids, offs, idf, q2, w2, sel)
    rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "max_abs_err": 0.0, "plan_g": plan["g"],
           "shape": f"B {tids.shape[0]} x Q {tids.shape[1]} (Q2 {q2} x W2 {w2}), {rows.numel()} postings, "
                    f"mode {mode}, sel {sel}"}
    log(phase, f"K8 at the lane's first call ({rec['shape']}, on {rows.device}): bit-equal to its plain twin at "
        f"the plan's G and at G 1; plan G {plan['g']} CTAs a query ({plan['ctas_per_sm']} CTAs an SM, "
        f"{plan['sms']} SMs, {plan['smem_bytes']} B shared); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (each "
        f"queued behind a sleep kernel, CUDA events), bound {bound_ms:.6f} ms ({bound_by}: {n_read} postings read, "
        f"{out_bytes} bytes written)")
    return rec


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
    for sel in (0, 3):  # the same at G 2 and at 1/8 of the batch, where the plan splits each query
        want = k8._candidate_scores_plain(tids, rows, wn, offs, idf, q2, w2, "any", sel)
        got = k8.candidate_scores_pallas(tids, rows, wn, offs, idf, max_df=max_df, sel=sel, split=2)
        check(all(torch.equal(x, y) for x, y in zip(got, want)), f"K8 at G 2 (sel {sel}) differs from its plain twin")
        part = b // 8
        got = k8.candidate_scores_pallas(tids[:part], rows, wn, offs, idf, max_df=max_df, sel=sel)
        check(all(torch.equal(x, y[:part]) for x, y in zip(got, want)),
              f"K8 at B {part} (sel {sel}) differs from its plain twin")
        del got, want
    t = {}
    for sel in (0, 3):
        t[sel] = (cuda_ms(lambda: k8.candidate_scores_pallas(tids, rows, wn, offs, idf, max_df=max_df, sel=sel)),
                  cuda_ms(lambda: k8._candidate_scores_plain(tids, rows, wn, offs, idf, q2, w2, "any", sel), iters=5),
                  _k8_bound(tids, offs, idf, q2, w2, sel))
        g = k8.device_plan(b, q2, w2, sel, rows.device)["g"]
        walk = "postings in merge order" if sel else "row tiles"
        log("exact_30k", f"K8 sel {sel} ({walk}; `any`, plan G {g}; G 2 and B {b // 8} at G "
            f"{k8.device_plan(b // 8, q2, w2, sel, rows.device)['g']} also bit-equal): {t[sel][0]:.4f} ms, plain "
            f"{t[sel][1]:.4f} ms, bound "
            f"{t[sel][2][0]:.4f} ms ({t[sel][2][1]}: {t[sel][2][2]} postings read, {t[sel][2][3] / 1e9:.4f} GB "
            "written)")
    results["K8"] = dict(max_abs_err=0.0, ms=t[0][0], plain_ms=t[0][1], library_ms=None, bound_ms=t[0][2][0],
                         bound_by=t[0][2][1])


def zipf_postings(dev, n_rows: int = 9_000_000, terms: int = 400, cap: int = 131_072, seed: int = 0):
    """(rows, wnorm, offsets, idf): term slices over n_rows rows at hybrid_msmarco1.b256's
    density, drawn on `dev`: term t holds about min(cap, 2.3e7 / (t + 1)) rows drawn
    uniformly (so the first ~175 terms are cut to the budget), rows ascending; random
    weights, a tenth tombstoned (0)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    slices = []
    for t in range(terms):
        df = min(cap, int(2.3e7 / (t + 1)))
        r = torch.nonzero(torch.rand(n_rows, generator=g, device=dev) < df / n_rows).flatten()[:cap]
        slices.append(r.to(torch.int32))
    rows = torch.cat(slices)
    offsets = torch.zeros(terms + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.tensor([len(x) for x in slices], device=dev), 0)
    wn = torch.rand(rows.shape[0], generator=g, device=dev)
    wn[torch.rand(rows.shape[0], generator=g, device=dev) < 0.1] = 0.0
    idf = torch.rand(terms, generator=g, device=dev) + 0.5
    return rows, wn, offsets.to(torch.int32), idf


def zipf_queries(rng, b: int, terms: int = 400):
    """[b, 16] i32 numpy term ids for `zipf_postings`: 1 + Binomial(15, 1/3) distinct
    Zipf(1) terms a query, -1 padded."""
    import numpy as np

    p = 1.0 / np.arange(1, terms + 1)
    tids = np.full((b, 16), -1, np.int32)
    for i in range(b):
        n = 1 + rng.binomial(15, 1 / 3)
        tids[i, :n] = rng.choice(terms, n, replace=False, p=p / p.sum())
    return tids


def _k8_hybrid_case(dev, results: dict) -> None:
    """K8's selection mode at hybrid_msmarco1.b256's shape and density (256 queries of
    Q2 16 x W2 262,144 over about 9M row ids, `zipf_postings`): bit-equal to its plain
    twin (per 16 queries) in every mode at the plan's G and at G 1, and timed."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops import bm25_candidates_pallas as k8

    t0 = time.perf_counter()
    rows, wn, offs, idf = zipf_postings(dev)
    tids = torch.from_numpy(zipf_queries(np.random.default_rng(0), 256)).to(dev)
    max_df = int((offs[1:] - offs[:-1]).max())
    q2, w2, sel = 16, k8.dma_window(max_df), 3
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    for mode in ("any", "all", "count"):
        want = [k8._candidate_scores_plain(tids[i:i + 16], rows, wn, offs, idf, q2, w2, mode, sel)
                for i in range(0, tids.shape[0], 16)]
        want = [torch.cat(x, 0) for x in zip(*want)]
        for split in (None, 1):
            got = k8.candidate_scores_pallas(tids, rows, wn, offs, idf, max_df=max_df, mode=mode, sel=sel, split=split)
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"K8 at the hybrid cell's density ({mode}, G {split or 'plan'}) differs from its plain twin")
        del got, want
    g = k8.device_plan(tids.shape[0], q2, w2, sel, dev)["g"]
    ms = queued_ms(lambda: k8.candidate_scores_pallas(tids, rows, wn, offs, idf, max_df=max_df, sel=sel), iters=10)
    bound_ms, bound_by, n_read, out_bytes = _k8_bound(tids, offs, idf, q2, w2, sel)
    results["K8"]["hybrid"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "plan_g": g}
    log("exact_30k", f"K8 sel {sel} at the hybrid cell's density (postings in merge order; {tids.shape[0]} queries x "
        f"Q2 {q2} x W2 {w2}, {rows.numel()} postings over {int(rows.max()) + 1} rows, drawn in {draw_s:.1f} s; "
        f"bit-equal to its plain twin per 16 queries, modes any/all/count, at plan G {g} and at G 1): {ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {n_read} postings read, {out_bytes / 1e9:.4f} GB written)")


def exact_30k_phase(dev, seed: int, results: dict) -> dict:
    """Path (c): the sharded BM25 lane on an exact-postings store (K8); returns this
    phase's launches (serving window and fused-program window)."""
    import numpy as np
    import torch

    from wax_tpu_torch.ops.bm25_candidates_pallas import dma_window
    from wax_tpu_torch.ops.flat_scan import _pick_tn, blockmax_scan_topk, flat_scan_topk, launch_plan, scan_scores
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
    n_terms, k, iters = int(lex.idf[0].shape[0]), 10, 20

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
    _, gdr = blockmax_scan_topk(q0[:nq], dense.emb[0], dense.bias[0], 20)
    dense_cpu = _cpu_copy(dense)
    _, cdr = blockmax_scan_topk(q0[:nq].cpu(), dense_cpu.emb[0], dense_cpu.bias[0], 20)
    for i in range(nq):  # a fused list may differ only through a near-tie of the dense lane
        check(same[i] or not torch.equal(gdr[i].cpu(), cdr[i]), f"exact_30k: query {i} fused ids differ")
    check(sum(same) / nq >= 0.9, f"exact_30k: fused ids equal to the plain program for only {sum(same)}/{nq} queries")
    check(bool(torch.isfinite(fv0).all()) and bool((ff0[:, 0] >= 0).all()), "exact_30k: malformed fused output")
    log("exact_30k", f"checks: fused ids equal to the plain program on a CPU copy for {sum(same)}/{nq} queries")

    _k8_cases(lex, tids0, results)
    _k8_hybrid_case(dev, results)
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


def ivf_1m_phase(dev, seed: int, results: dict, keep: dict | None = None) -> dict:
    """Path (d): the bench's ivf_1m_x768_nprobe8 shape: build_ivf (4,096 clusters,
    S 384 bf16 buckets, spill "auto") over 1,048,576 x 768 clustered rows and 256
    queries through ivf_search_topk_pallas (K7), against the exact chunkmax lane (K6 +
    K7). Returns this phase's launches; `keep` (a dict) receives the index, the queries
    and their exact top-10 for [shard_10m]'s sharded IVF."""
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
    if keep is not None:
        keep.update(index=index, q=q, exact=exact)
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

# ------------------------------------------------------------- shard_10m, hybrid_1m_sharded

N_10M = 10_485_760  # BASELINE.md's scale configuration: 10M x 768 sharded, distributed flat scan
N_SHARDS = 4
N_EXACT_SLAB = 1_048_576  # [shard_10m]'s exact-arithmetic slab (1/8-grid entries)
SHARD_ROW_CHUNK = 1 << 20


def mesh_devices(dev, n: int = N_SHARDS):
    """(devices of an n-shard mesh, what ran): n distinct cards when the machine has
    them, else n logical shards on `dev`."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], f"{n} distinct cards"
    return [dev] * n, f"{n} logical shards on {dev} (one card)"


def unit_rows(n: int, d: int, seed: int, device):
    """n seeded unit rows in bf16, drawn on `device` SHARD_ROW_CHUNK rows at a time
    (chunk c from its own generator), so no f32 temporary holds more than a chunk."""
    import torch

    from wax_tpu_torch.ops.flat_scan import normalize_rows

    out = torch.empty((n, d), dtype=torch.bfloat16, device=device)
    for lo in range(0, n, SHARD_ROW_CHUNK):
        hi = min(n, lo + SHARD_ROW_CHUNK)
        g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + lo // SHARD_ROW_CHUNK)
        out[lo:hi] = normalize_rows(torch.randn((hi - lo, d), generator=g, device=device)).to(torch.bfloat16)
    return out


def dense_over(blocks):
    """A ShardedDenseIndex of all-live rows: `blocks`, equal row blocks of one corpus
    (frame id = row), one per corpus shard on the shard's device."""
    import torch

    from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex

    fids = tuple(torch.arange(i * e.shape[0], (i + 1) * e.shape[0], dtype=torch.int32, device=e.device)
                 for i, e in enumerate(blocks))
    bias = tuple(torch.zeros(e.shape[0], device=e.device) for e in blocks)
    return ShardedDenseIndex(emb=tuple(blocks), frame_ids=fids, bias=bias, contiguous=True)


def sync_calls(fn) -> tuple[int, list]:
    """(synchronising CUDA calls a warm fn() made, their first messages) under
    torch.cuda.set_sync_debug_mode("warn"); one untimed call runs first, so that the
    caching allocator holds the call's blocks."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    msgs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    return len(msgs), [m[:160] for m in msgs[:3]]


def _near_tie_agree(phase, what, v, f, rv, rf, rtol: float = 1e-6) -> int:
    """(vals, ids) [B, k] against a reference: scores within rtol place by place, and
    ids equal except near-ties: an id in one list only has its list's score within
    rtol of the reference's k-th score. Returns the queries whose ids differ."""
    import numpy as np

    v, f, rv, rf = (np.asarray(x) for x in (v, f, rv, rf))
    check(np.allclose(v, rv, rtol=rtol, atol=0.0), f"{phase}: {what}: scores beyond rtol {rtol} "
          f"(max gap {np.abs(v - rv).max():.3g})")
    differ = 0
    for i in range(f.shape[0]):
        if np.array_equal(f[i], rf[i]):
            continue
        differ += 1
        kth = abs(rv[i, -1])
        for j in range(f.shape[1]):
            if f[i, j] != rf[i, j]:  # a swap: both places hold near-equal scores
                check(abs(v[i, j] - rv[i, j]) <= rtol * max(abs(rv[i, j]), 1e-30),
                      f"{phase}: {what}: query {i} place {j} differs beyond a near-tie")
        for j in np.nonzero(~np.isin(f[i], rf[i]))[0]:
            check(abs(abs(v[i, j]) - kth) <= rtol * kth, f"{phase}: {what}: query {i} lists id {f[i, j]} that the "
                  f"reference does not, at score {v[i, j]!r} against its k-th {rv[i, -1]!r}")
    return differ


def shard_10m_phase(dev, seed: int, ivf: dict) -> dict:
    """[shard_10m]: BASELINE.md's scale configuration, 10,485,760 x 768 unit rows in
    bf16 (16.1 GB) split over 4 corpus shards: `sharded_flat_scan_topk` at B 256, k 10
    on the flat 4-shard mesh and the 2 x 2 two-level mesh (bit-equal), against a
    one-shard scan of the same rows (64 queries), on a 1/8-grid slab with the same
    scores (bit for bit between 4 shards and 2 x 2); the synchronising calls of one
    call at S 1, 2 and 4; then `sharded_ivf_search_topk` over [ivf_1m]'s index (`ivf`:
    index, queries, exact top-10) on 4 slot shards. Shards of 2,621,440 rows and more
    take the chunkmax lane (K6 + K7); the slab's 262,144-row shards the f32 products."""
    import numpy as np
    import torch

    from wax_tpu_torch.index.ivf import ivf_search_topk
    from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk
    from wax_tpu_torch.ops.flat_scan import normalize_rows
    from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
    from wax_tpu_torch.parallel.mesh import data_mesh, make_two_level_mesh, shard_rows
    from wax_tpu_torch.parallel.sharded_ivf import shard_ivf_index, sharded_ivf_search_topk
    from wax_tpu_torch.parallel.sharded_scan import sharded_flat_scan_topk
    from wax_tpu_torch.search.vector_engines import AutoVectorEngine

    phase = "shard_10m"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    d, b, k = 768, N_QUERIES, 10
    devs, how = mesh_devices(dev)
    per = N_10M // N_SHARDS
    mesh4, mesh22 = data_mesh(devs), make_two_level_mesh(2, devices=devs)
    mesh2, mesh1 = data_mesh(devs[:2]), data_mesh(dev)
    t0 = time.perf_counter()
    full = unit_rows(N_10M, d, seed, dev)  # also the one-shard reference's rows
    # each mesh's blocks: views of `full` on its card, copies on the others
    idx4, idx2, idx1 = (dense_over(shard_rows(m, full)) for m in (mesh4, mesh2, mesh1))
    for x in devs:
        torch.cuda.synchronize(x)
    t_data = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    q = normalize_rows(torch.randn((b, d), generator=g, device=dev))
    log(phase, f"{how}: {N_10M} x {d} bf16 unit rows ({N_10M * d * 2 / 1e9:.2f} GB) drawn on the card(s) in "
        f"{t_data:.2f} s; {N_SHARDS} shards of {per} rows; mesh {mesh4.axis_names} {mesh4.axis_sizes} and "
        f"{mesh22.axis_names} {mesh22.axis_sizes}")

    # 1. the flat mesh and the two-level mesh, bit for bit
    v4, f4 = sharded_flat_scan_topk(q, idx4, k, mesh4)
    v22, f22 = sharded_flat_scan_topk(q, idx4, k, mesh22)
    check(torch.equal(v4, v22) and torch.equal(f4, f22), f"{phase}: the 2 x 2 mesh differs from the flat 4-shard mesh")
    check(tuple(f4.shape) == (b, k) and bool(torch.isfinite(v4).all()) and bool((f4 >= 0).all()),
          f"{phase}: malformed output")
    # 2. against one shard of the same rows, 64 queries
    v1, f1 = sharded_flat_scan_topk(q[:64], idx1, k, mesh1)
    differ = _near_tie_agree(phase, "4 shards vs one shard", v4[:64].cpu(), f4[:64].cpu(), v1.cpu(), f1.cpu())
    # 3. exact arithmetic: a 1/8-grid slab, every mesh bit for bit
    ge = torch.Generator(device=dev).manual_seed(seed + 103)
    slab = (torch.randint(-8, 9, (N_EXACT_SLAB, d), generator=ge, device=dev) / 8.0).to(torch.bfloat16)
    qe = torch.randint(-8, 9, (64, d), generator=ge, device=dev) / 8.0
    ex4 = dense_over(shard_rows(mesh4, slab))
    e1 = sharded_flat_scan_topk(qe, dense_over((slab,)), k, mesh1)
    e4 = sharded_flat_scan_topk(qe, ex4, k, mesh4)
    e22 = sharded_flat_scan_topk(qe, ex4, k, mesh22)
    # one shard takes K6 + K7, whose exact ties rank by chunk: the same scores, tied ids
    check(all(torch.equal(a, c) for a, c in zip(e4, e22)) and torch.equal(e1[0], e4[0]),
          f"{phase}: the 1/8-grid slab's answers differ between one shard, 4 shards and 2 x 2")
    want = (qe[:4].double() @ slab.double().t()).topk(k, dim=1).values.float()
    check(torch.equal(e4[0][:4], want.to(e4[0].device)), f"{phase}: the 1/8-grid scores are not the float64 products")
    own = torch.einsum("bd,bkd->bk", qe.double(), slab[e1[1].long()].double()).float()
    check(torch.equal(own, e1[0]) and all(len(set(r)) == k for r in e1[1].tolist()),
          f"{phase}: one shard's 1/8-grid ids do not score their listed scores")
    del want, own
    del slab, ex4
    log(phase, f"checks: 2 x 2 equals the flat 4-shard mesh bit for bit (B {b}); 4 shards against one shard on 64 "
        f"queries: scores within rtol 1e-6, ids equal on {64 - differ} (the rest near-ties of the k-th score); "
        f"a {N_EXACT_SLAB} x {d} 1/8-grid slab: 4 shards and 2 x 2 bit-equal, one shard the same scores, "
        f"scores = float64 products")

    # 4. times: a batch (median of 10), each shard's device work and the merge
    ms4 = median_call_ms(lambda: sharded_flat_scan_topk(q, idx4, k, mesh4), iters=10, warmup=1)
    ms22 = median_call_ms(lambda: sharded_flat_scan_topk(q, idx4, k, mesh22), iters=10, warmup=1)
    ms1 = median_call_ms(lambda: sharded_flat_scan_topk(q, idx1, k, mesh1), iters=10, warmup=1)
    shard_ms, lists = [], ([], [])
    for s_ in range(N_SHARDS):
        e, fi, bi = idx4.shard(s_)
        with torch.cuda.device(e.device):
            qs = q.to(e.device)
            shard_ms.append(median_call_ms(lambda: chunkmax_scan_topk(qs, e, bi, k), iters=5, warmup=1))
            vv, rr = chunkmax_scan_topk(qs, e, bi, k)
        lists[0].append(vv)
        lists[1].append(fi[rr.long()])
    merge_ms = median_call_ms(lambda: merge_topk_across_mesh(lists[0], lists[1], k, mesh4), iters=20)
    nbytes = N_10M * d * 2 + N_10M * 4 + b * d * 4 + b * k * 8
    bms, bby = bound(nbytes, 2.0 * b * N_10M * d, "bf16")
    prof = device_profile(phase, lambda: sharded_flat_scan_topk(q, idx4, k, mesh4), iters=3)
    busy = "not measured" if prof["busy"] is None else f"{100 * prof['busy']:.1f}%"
    log(phase, f"sharded_flat_scan_topk B {b} k {k}: 4 shards {ms4:.3f} ms a batch (median of 10, CUDA events on "
        f"{dev}), 2 x 2 {ms22:.3f} ms, one shard {ms1:.3f} ms = {b * 1e3 / ms4:.1f} queries/s on 4 shards; per "
        f"shard (K6 + K7, median of 5) " + ", ".join(f"{t:.3f}" for t in shard_ms)
        + f" ms; the merge {merge_ms:.4f} ms; bound {bms:.4f} ms ({bby}); busy {busy}")
    # 5. synchronising calls of one call, at 1, 2 and 4 shards
    syncs = {1: sync_calls(lambda: sharded_flat_scan_topk(q, idx1, k, mesh1)),
             2: sync_calls(lambda: sharded_flat_scan_topk(q, idx2, k, mesh2)),
             4: sync_calls(lambda: sharded_flat_scan_topk(q, idx4, k, mesh4))}
    check(syncs[2][0] <= syncs[1][0] and syncs[4][0] <= syncs[1][0],
          f"{phase}: synchronising calls grow with the shards: {syncs}")
    log(phase, f"synchronising calls of one sharded_flat_scan_topk (set_sync_debug_mode warn): S 1 {syncs[1][0]}, "
        f"S 2 {syncs[2][0]}, S 4 {syncs[4][0]} {[m for _, ms in syncs.values() for m in ms] or ''}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del full, idx4, idx2, idx1, lists
    torch.cuda.empty_cache()

    # 6. sharded IVF over [ivf_1m]'s index, 4 slot shards
    index, qi, exact = ivf["index"], ivf["q"], ivf["exact"]
    t0 = time.perf_counter()
    sivf = shard_ivf_index(index, mesh4)
    for x in devs:
        torch.cuda.synchronize(x)
    t_shard = time.perf_counter() - t0
    pv, pf = ivf_search_topk(qi, index, k=k, nprobe=8)
    sv, sf = sharded_ivf_search_topk(qi, sivf, k, mesh4, nprobe=8)
    tv, tf = sharded_ivf_search_topk(qi, sivf, k, mesh22, nprobe=8)
    check(torch.allclose(sv.cpu(), pv.cpu(), rtol=1e-6, atol=0.0),
          f"{phase}: sharded IVF scores differ from the one-device probe loop beyond rtol 1e-6 "
          f"(max gap {float((sv.cpu() - pv.cpu()).abs().max()):.3g})")
    check(torch.equal(sv, tv) and torch.equal(sf, tf), f"{phase}: sharded IVF on 2 x 2 differs from 4 shards")
    ids_eq = float((sf.cpu() == pf.cpu()).float().mean())
    rec = AutoVectorEngine._recall(exact.cpu().numpy(), sf.cpu().numpy())
    ivf_ms = median_call_ms(lambda: sharded_ivf_search_topk(qi, sivf, k, mesh4, nprobe=8), iters=10)
    one_ms = median_call_ms(lambda: ivf_search_topk(qi, index, k=k, nprobe=8), iters=10)
    log(phase, f"sharded IVF over [ivf_1m]'s index ({index.n_clusters} clusters of S {index.bucket_size}, spilled="
        f"{index.spilled}; slot shards of {sivf.local_slots}, laid out in {t_shard:.3f} s): B {qi.shape[0]} k {k} "
        f"nprobe 8: scores equal to the one-device probe loop within rtol 1e-6, ids equal on {100 * ids_eq:.2f}% of "
        f"places, 2 x 2 bit-equal; recall@{k} against the exact lane {rec:.4f}; {ivf_ms:.3f} ms a call (median of "
        f"10) against the one-device probe loop's {one_ms:.3f} ms")
    log(phase, f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"ms4": ms4, "syncs": {s_: c for s_, (c, _) in syncs.items()}}


def hybrid_1m_sharded_phase(dev, kept: dict) -> dict:
    """[hybrid_1m_sharded]: `sharded_hybrid_topk` at [hybrid_1m]'s shape (its rows,
    queries, term ids and postings, `kept`) over 2 shards (K6 + K7, K4, K3 a shard),
    4 shards (K1, K4, K3 a shard) and the 2 x 2 mesh (bit-equal to 4 shards); at each,
    the fused ids against the same program on a CPU copy. Returns the launches of the
    timed windows."""
    import torch

    from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk, takes_chunkmax
    from wax_tpu_torch.ops.flat_scan import packed_sel_scan_topk
    from wax_tpu_torch.parallel import sharded_hybrid as sh
    from wax_tpu_torch.parallel.mesh import data_mesh, make_two_level_mesh, shard_rows

    phase = "hybrid_1m_sharded"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    emb, q0, tids0, arrays, n_terms = kept["emb"], kept["q0"], kept["tids0"], kept["arrays"], kept["n_terms"]
    b, k, iters = q0.shape[0], 10, 20
    nq = min(32, b)
    total = {kid: 0 for kid in KERNEL_IDS}
    answers = {}
    for label, n in (("S 2", 2), ("S 4", 4), ("2 x 2", 4)):
        devs, how = mesh_devices(dev, n)
        mesh = make_two_level_mesh(2, devices=devs) if label == "2 x 2" else data_mesh(devs)
        if label != "2 x 2":
            t0 = time.perf_counter()
            # the same postings through the card builder, one posting under their longest
            # list as its budget, so every shard carries the forward index and impact chunks
            post = [torch.from_numpy(arrays[a]).to(dev) for a in ("offsets", "doc_rows", "tfs", "doc_len_g",
                                                                  "frame_ids_g", "active_g")]
            lex = sh.shard_lex_postings(mesh, N_1M, *post, postings_budget=int(post[0].diff().max()) - 1)
            t_lex = time.perf_counter() - t0
            dense = dense_over(shard_rows(mesh, emb))
        fv0, ff0 = sh.sharded_hybrid_topk(q0, tids0, dense, lex, k, mesh)  # warm-up
        for x in devs:
            torch.cuda.synchronize(x)
        reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
        ev[0].record()
        for i in range(iters):
            sh.sharded_hybrid_topk(q0, (tids0 + i) % n_terms, dense, lex, k, mesh)
            ev[i + 1].record()
        torch.cuda.synchronize()
        launches = launch_counts()
        want = {"K3": n, "K4": n, "K6": n, "K7": n} if n == 2 else {"K1": n, "K3": n, "K4": n}
        per_call = {kid: c / iters for kid, c in launches.items() if c}
        check(per_call == {kid: float(c) for kid, c in want.items()},
              f"{phase} {label}: launches a call {per_call}, expected {want}")
        for kid, c in launches.items():
            total[kid] += c
        times = [ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]
        med = statistics.median(times)
        prof = device_profile(f"{phase} {label}", lambda: sh.sharded_hybrid_topk(q0, tids0, dense, lex, k, mesh))
        busy = "not measured" if prof["busy"] is None else f"{100 * prof['busy']:.1f}%"
        answers[label] = (fv0, ff0)
        split = "" if label == "2 x 2" else f"; postings split in {t_lex:.2f} s"
        log(phase, f"{label} ({how}{split}, {dense.local_rows} rows a shard): per call median {med:.3f} ms over "
            f"{iters} calls (term ids perturbed per call; min {min(times):.3f}, max {max(times):.3f}) = "
            f"{b / (med / 1e3):.1f} queries/s; launches a call {per_call}; busy {busy}")
        if label == "2 x 2":
            check(torch.equal(fv0, answers["S 4"][0]) and torch.equal(ff0, answers["S 4"][1]),
                  f"{phase}: the 2 x 2 mesh differs from 4 shards")
            continue
        # the fused ids against the same program on a CPU copy (32 queries); a fused
        # list may differ only through a near-tie of some shard's dense lane
        dense_cpu, lex_cpu, cpu_mesh = _cpu_copy(dense), _cpu_copy(lex), data_mesh(["cpu"] * n)
        cv, cf = sh.sharded_hybrid_topk(q0[:nq].cpu(), tids0[:nq].cpu(), dense_cpu, lex_cpu, k, cpu_mesh,
                                        lex_backend="candidates_pallas")
        lane = chunkmax_scan_topk if takes_chunkmax(dense.local_rows, 20, dense.contiguous) else packed_sel_scan_topk
        lane_same = torch.ones(nq, dtype=torch.bool)
        for s_ in range(n):
            e, _, bi = dense.shard(s_)
            ec, _, bc = dense_cpu.shard(s_)
            with torch.cuda.device(e.device):
                _, gr = lane(q0[:nq].to(e.device), e, bi, 20)
            _, cr = lane(q0[:nq].cpu(), ec, bc, 20)
            lane_same &= (gr.cpu() == cr).all(dim=1)
        same = [torch.equal(ff0[i].cpu(), cf[i]) for i in range(nq)]
        for i in range(nq):
            check(same[i] or not bool(lane_same[i]), f"{phase} {label}: query {i} fused ids differ")
        check(sum(same) / nq >= 0.9, f"{phase} {label}: fused ids equal for only {sum(same)}/{nq} queries")
        check(bool(torch.isfinite(fv0).all()) and bool((ff0[:, 0] >= 0).all()), f"{phase} {label}: malformed output")
        log(phase, f"{label} checks: fused ids equal to the plain program on a CPU copy for {sum(same)}/{nq} "
            f"queries (the rest through a dense-lane near-tie)")
    log(phase, f"checks: the 2 x 2 mesh equals 4 shards bit for bit; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase seconds {time.perf_counter() - t_phase:.1f}")
    return total



ORCH_BUDGET = 4096  # the budgeted reopen's manual lex_postings_budget
N_ORCH_QUERIES = 64  # [orch_100k]'s searches and recalls (cut from 256, then 128, for the run's time limit)
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


def _orch_lanes(orch, requests):
    """(BM25 lane, vector lane) lists of each request, as unified_search runs them."""
    from wax_tpu_torch.search.unified import _bm25_lane, _vector_lane

    bm = [_bm25_lane(orch.engine, r.query, FETCH_K)[0] for r in requests]
    ve = [_vector_lane(orch.engine, r, FETCH_K) for r in requests]
    return bm, ve


def _k1_b1_case(phase: str, dev, snap, embedding, label: str) -> dict:
    """K1 at an orchestrator's own shape (B 1 over its dense snapshot, k 24) against
    its plain twin, timed beside its bound and torch.matmul f32."""
    import numpy as np
    import torch

    q1 = torch.from_numpy(embedding / np.linalg.norm(embedding))[None, :].to(dev)
    return _k1_snap_case(phase, snap, q1, FETCH_K, label)


def _k1_snap_case(phase: str, snap, q, k: int, label: str) -> dict:
    """K1 over a live engine's dense snapshot at the queries `q` [B, d] (normalised,
    f32, on the snapshot's device) and `k`, against its plain twin; kernel, plain and
    torch.matmul f32 times queued behind a sleep kernel, and the bound."""
    import torch

    from wax_tpu_torch.ops import flat_scan as fs

    (n, d), b = snap.emb.shape, q.shape[0]
    bias, tn = fs._index_bias(snap), fs._pick_tn(n)

    def run_kernel():
        return fs.packed_sel_tiles(q, snap.emb, bias, k, tn)

    def run_plain():
        return fs._packed_sel_topk_plain(q, snap.emb, bias, k, tn)

    kv, kr = fs._merge_tiles(*fs._decode_packed(run_kernel(), k, tn), k)
    pv, pr = fs._merge_tiles(*fs._decode_packed(run_plain(), k, tn), k)
    err, overlap = _topk_agree(phase, f"K1 B {b} ({label})", kv, kr, pv, pr,
                               fs.scores_f32(q, snap.emb) + bias[None, :], k, False, TRUNC_REL)
    out_bytes = b * (n // tn) * k * 4
    nbytes = 4 * (b * d + n * d) + 4 * n + out_bytes
    rec = {"ms": queued_ms(run_kernel), "plain_ms": queued_ms(run_plain), "max_abs_err": err}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * 2 * b * n * d, "tf32")
    rec["library_ms"] = queued_ms(lambda: torch.matmul(q, snap.emb.t()))
    log(phase, f"K1 at B {b} x {n} x {d} {snap.emb.dtype}, k {k} (tn {tn}): agree (max_abs_err={err:.3g}, "
        f"overlap={overlap:.4f}); kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes} bytes), library (torch.matmul f32) "
        f"{rec['library_ms']:.4f} ms (each queued behind a sleep kernel, CUDA events)")
    return rec


def orch_100k_phase(dev, seed: int, results: dict, tmp: Path) -> dict:
    """path (f): the MemoryOrchestrator a user calls, over the smoke corpus's 102,400
    documents with the full-width MiniLM (random weights, bf16) in a temporary
    directory: remember_batch in calls of 1,024, flush, 128 search and 128 recall
    calls, a profiled window, a cold reopen (bit-identical answers), a read-only
    reopen with a manual postings budget (the candidate lane and K3), the same
    requests on the CPU, and K1 timed at the orchestrator's own B 1 shape. The store
    stays in `tmp` for [orch_maint]."""
    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMEmbedder
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.types import SearchRequest
    from wax_tpu_torch.utils.profiling import reset_spans, span_stats

    phase = "orch_100k"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, docs, queries = make_corpus(seed)
    qs = queries[0][:N_ORCH_QUERIES]
    path = tmp / "memory.mv2s"

    def spans(prefix: str) -> str:
        return "; ".join(f"{k} n={v['count']} total={v['total_ms']:.1f} p50={v['p50_ms']:.3f} p95={v['p95_ms']:.3f} ms"
                         for k, v in sorted(span_stats().items()) if k.startswith(prefix))

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
        bm_card, vec_card = _orch_lanes(orch, reqs)

        # 3. profile: 32 fresh searches (encoder included) in the window
        batches = iter([queries[1][:32], queries[1][32:64]])
        prof = device_profile(phase, lambda: [orch.search(q, top_k=10) for q in next(batches)], iters=1)
        check(prof["launched"].get("K1", 0) == 32,
              f"{phase}: the profiled window launched K1 {prof['launched'].get('K1', 0)} times for 32 searches")

        # 4. K1 at the orchestrator's own shape: B 1 over the live engine's snapshot, k 24
        snap = orch.engine.vector.snapshot()
        n, d = snap.emb.shape
        check(n == 131_072 and snap.emb.dtype == torch.float32, f"{phase}: dense snapshot {n} x {d} {snap.emb.dtype}")
        rec = _k1_b1_case(phase, dev, snap, reqs[0].embedding, "orch_100k")
        results["K1"]["orch_b1"] = rec
        results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], rec["max_abs_err"])

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
        bm_card_b, vec_card_b = _orch_lanes(orch, bq)
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
            bm_cpu, vec_cpu = _orch_lanes(orch, reqs_c)
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
    log(phase, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"K1": serve_launches["K1"], "K3": budget_launches["K3"], "queries": qs}


# --------------------------------------------------------------------------- maintenance

N_MAINT_FORGET = 10_240  # [orch_maint]: 10% of [orch_100k]'s documents
N_MAINT_QUERIES = 64


def _document_ids(orch) -> list:
    from wax_tpu_torch.types import FrameKind, FrameStatus

    return [fid for fid in range(orch.store.frame_count())
            if (m := orch.store.frame_meta(fid)) is not None and m.kind == FrameKind.DOCUMENT.value
            and m.status == FrameStatus.ACTIVE.value]


def _forget(phase: str, orch, fids) -> float:
    """Forget `fids` one call at a time; the host seconds."""
    import torch

    t0 = time.perf_counter()
    for fid in fids:
        check(orch.forget(fid), f"{phase}: forget({fid}) found nothing to forget")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def orch_maint_phase(dev, seed: int, results: dict, tmp: Path, qs: list) -> dict:
    """[orch_maint]: maintenance on [orch_100k]'s store in `tmp` (102,400 documents,
    full-width MiniLM, the default auto engine on K1 at B 1, exact BM25): forget 10%,
    searches with no forgotten id in any lane, dead_bytes, compact_indexes (K1 held at
    the compacted shape), rewrite_live_set (answers equal the compacted ones under the
    id remap, bit for bit), verify(deep=True), a cold reopen answering bit for bit and
    the rewritten file read-only on the CPU against the card."""
    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMEmbedder
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.types import SearchRequest
    from wax_tpu_torch.utils.profiling import reset_spans, span_stats

    phase = "orch_maint"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    path = tmp / "memory.mv2s"
    cfg = OrchestratorConfig()
    embedder = MiniLMEmbedder(dtype=torch.bfloat16, batch_size=256, seed=0, device=dev)
    k1_launches = 0
    orch = None
    try:
        engine_cache.clear()
        orch = MemoryOrchestrator(path, embedder, cfg, device=dev)
        docs = _document_ids(orch)
        n_docs = len(docs)
        check(n_docs == len(orch.engine.lex) == len(orch.engine.vector),
              f"{phase}: the store holds {n_docs} documents, {len(orch.engine.lex)} lex rows, "
              f"{len(orch.engine.vector)} vectors")
        gone = sorted(np.random.default_rng(seed + 13).choice(docs, N_MAINT_FORGET, replace=False).tolist())
        t_forget = _forget(phase, orch, gone)
        gone_set, live = set(gone), n_docs - len(gone)
        log(phase, f"forgot {len(gone)} of {n_docs} documents (drawn from --seed) in {t_forget:.2f} s = "
            f"{1e3 * t_forget / len(gone):.3f} ms a forget (host clock ending in a sync)")
        reqs = [SearchRequest(query=q, top_k=10, embedding=orch.engine.embed_query(q)) for q in qs[:N_MAINT_QUERIES]]

        def answers(label: str, forgotten=gone_set):
            """The requests one at a time (K1 counted over them), then their lanes; no
            forgotten frame id may appear in a hit or a lane."""
            nonlocal k1_launches
            reset_spans()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = [orch.search(r) for r in reqs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1 = launch_counts()["K1"]
            vec_calls = span_stats()["search.vector_lane"]["count"]
            check(k1 == vec_calls == len(reqs), f"{phase}: {label}: K1 launched {k1} times for {vec_calls} "
                  f"vector-lane calls of {len(reqs)} searches")
            k1_launches += k1
            bm, ve = _orch_lanes(orch, reqs)
            for r, resp, b, v in zip(reqs, out, bm, ve):
                ids = {h.frame_id for h in resp.hits} | {f for f, _ in b} | {f for f, _ in v}
                check(not ids & forgotten, f"{phase}: {label}: forgotten frames {sorted(ids & forgotten)[:4]} "
                      f"answer {r.query!r}")
                check(len(resp.hits) == 10 and all(np.isfinite(h.score) for h in resp.hits),
                      f"{phase}: {label}: search({r.query!r}) gave {len(resp.hits)} hits or a bad score")
            log(phase, f"{label}: {len(reqs)} searches in {wall:.2f} s (p50 of the host clock not taken), K1 "
                f"{k1} launches; no forgotten id in any hit or lane")
            return out, (bm, ve)

        answers("after the forget")
        t0 = time.perf_counter()
        dead = orch.maintainer.dead_bytes()
        log(phase, f"dead_bytes() {dead} ({time.perf_counter() - t0:.2f} s); file {path.stat().st_size} bytes")
        check(dead > 0, f"{phase}: dead_bytes() is 0 after {len(gone)} forgets")

        t0 = time.perf_counter()
        orch.maintainer.compact_indexes()
        torch.cuda.synchronize()
        t_compact = time.perf_counter() - t0
        lex, vstate = orch.engine.lex, orch.engine.vector.builder.state_arrays()
        check(len(lex) == len(lex._doc_len) == live and len(vstate["frame_ids"]) == live and vstate["active"].all(),
              f"{phase}: compaction left {len(lex._doc_len)} lex rows and {len(vstate['frame_ids'])} vector rows "
              f"for {live} live documents")
        log(phase, f"compact_indexes() {t_compact:.2f} s (host clock ending in a sync, the flush included): lex and "
            f"vector rows {live}")
        compacted, _ = answers("compacted")
        snap = orch.engine.vector.snapshot()
        rec = _k1_b1_case(phase, dev, snap, reqs[0].embedding, "compacted")
        results["K1"]["orch_maint"] = rec
        results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], rec["max_abs_err"])

        remaps = []
        orch.maintainer.remap_listeners.append(remaps.append)
        t0 = time.perf_counter()
        rep = orch.maintainer.rewrite_live_set()
        torch.cuda.synchronize()
        t_rewrite = time.perf_counter() - t0
        check(rep.executed and rep.frames_after < rep.frames_before and rep.bytes_after < rep.bytes_before
              and len(remaps) == 1, f"{phase}: rewrite {rep}")
        (remap,) = remaps
        log(phase, f"rewrite_live_set() {t_rewrite:.2f} s (its own elapsed {rep.elapsed_ms / 1e3:.2f} s): frames "
            f"{rep.frames_before} -> {rep.frames_after}, bytes {rep.bytes_before} -> {rep.bytes_after}")
        moved = {remap[f] for f in gone_set if f in remap}
        check(not moved, f"{phase}: the remap keeps {len(moved)} forgotten frames")
        rewritten, _ = answers("rewritten", set())
        for r, a, b in zip(reqs, compacted, rewritten):
            check([(remap[f], s_, p_) for f, s_, p_ in _hit_keys(a)] == _hit_keys(b),
                  f"{phase}: the rewritten store answers {r.query!r} otherwise than the compacted one under the "
                  "remap")
        log(phase, f"the {len(reqs)} rewritten answers equal the compacted ones under the remap (ids mapped; scores, "
            "previews and order bit for bit)")

        t0 = time.perf_counter()
        verified = orch.store.verify(deep=True)
        check(verified["ok"], f"{phase}: verify(deep=True) {verified}")
        t_verify = time.perf_counter() - t0
        orch.close()
        orch = None
        engine_cache.clear()
        t0 = time.perf_counter()
        orch = MemoryOrchestrator(path, embedder, cfg, device=dev)
        t_open = time.perf_counter() - t0
        reopened, (bm_card, vec_card) = answers("cold reopen", set())
        check(all(_hit_keys(a) == _hit_keys(b) for a, b in zip(rewritten, reopened)),
              f"{phase}: the cold reopen answers otherwise than the rewritten store")
        log(phase, f"verify(deep=True) ok in {t_verify:.2f} s; cold reopen {t_open:.3f} s, {len(reqs)} searches "
            "bit-identical")
        orch.close()
        orch = None

        engine_cache.clear()
        t0 = time.perf_counter()
        orch = MemoryOrchestrator(path, embedder, cfg, readonly=True, device="cpu")
        cpu = [orch.search(r) for r in reqs]
        bm_cpu, vec_cpu = _orch_lanes(orch, reqs)
        _lanes_agree(phase, "BM25", [r.query for r in reqs], bm_card, bm_cpu)
        vec = _vector_lanes_agree(phase, "vector", reqs, vec_card, vec_cpu, orch.engine.vector.snapshot())
        fdiff = _fused_agree(phase, "rewritten", orch, reqs, reopened, cpu, vec_card, vec_cpu)
        orch.close()
        orch = None
        equal = (len(reqs) - fdiff) / len(reqs)
        log(phase, f"CPU cross-check of the rewritten file ({len(reqs)} requests, {time.perf_counter() - t0:.1f} s): "
            f"BM25 lanes equal; vector lanes equal on {len(reqs) - vec['differ']}, the rest near-ties (id overlap "
            f"{vec['overlap']:.4f}); fused top-10 equal on {len(reqs) - fdiff} ({100 * equal:.1f}%)")
        check(equal >= ORCH_FUSED_FLOOR, f"{phase}: fused top-10 equal on {100 * equal:.1f}% of queries, under the "
              f"floor {100 * ORCH_FUSED_FLOOR:.0f}%")
    finally:
        if orch is not None:
            orch.close()
        engine_cache.clear()
    log(phase, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"K1": k1_launches}


# ---------------------------------------------------------------------------------- HNSW

N_HNSW = 102_400  # BASELINE config 3: 100K x 384, M 16, efSearch 16-256 against the exact scan
HNSW_DIM = 384
HNSW_EFS = (16, 64, 128, 256)
HNSW_SCORE_TOL = 3e-5  # a listed score against its id's float64 score
# recall@10 at ef 256: docs/benchmarks.md records 0.986 (0.958 at ef 128) for the same
# builder and beam on 100K x 384 hard-clustered rows; recall belongs to the algorithm
HNSW_RECALL_FLOOR = 0.95
N_ORCH_HNSW = 10_240
N_ORCH_HNSW_QUERIES = 64  # [orch_hnsw]'s searches
N_GRID = 4_096  # [hnsw_100k]'s 1/8-grid graph rows


def hard_clustered(n: int, rng, d: int = HNSW_DIM):
    """[n, d] f32 unit rows of `scripts/hnsw_parity.py`'s "hard" set (its
    `make_dataset("hard", n, rng)`): 200 normal centres plus noise 0.15, drawn from
    numpy generator `rng`."""
    import numpy as np

    c = rng.standard_normal((200, d)).astype(np.float32)
    a = rng.integers(0, 200, n)
    v = c[a] + 0.15 * rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def _k2_case(phase, q, snap, k) -> dict:
    """K2 against its plain twin at the arguments `flat_scan_topk(backend="pallas")`
    passes it for (q, snap, k): tile values within F32_TOL, merged ids equal but for
    near-ties; kernel, plain and torch.matmul f32 times (CUDA events) and the bound."""
    import torch

    from wax_tpu_torch.ops import flat_scan as fs

    emb, bias = snap.emb, fs._index_bias(snap)
    (b, d), n = q.shape, emb.shape[0]
    tn = fs._pick_tn(n)

    def run_kernel():
        return fs.scan_topk_tiles(q, emb, bias, k, tn)

    def run_plain():
        return fs._scan_topk_plain(q, emb, bias, k, tn)

    (gv, gr), (rv, rr) = run_kernel(), run_plain()
    check(float((gv - rv).abs().max()) <= F32_TOL, f"{phase}: K2 tile values beyond {F32_TOL}")
    scores = fs.scores_f32(q, emb) + bias[None, :]
    err, overlap = _topk_agree(phase, "K2", *fs._merge_tiles(gv, gr, k), *fs._merge_tiles(rv, rr, k), scores, k,
                               False, 0.0)
    del scores
    out_bytes = b * (n // tn) * k * 8
    nbytes = 4 * (b * d + n * d) + 4 * n + out_bytes
    rec = {"ms": cuda_ms(run_kernel), "plain_ms": cuda_ms(run_plain), "max_abs_err": err}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * 2 * b * n * d, "tf32")
    rec["library_ms"] = cuda_ms(lambda: torch.matmul(q, emb.t()))
    log(phase, f"K2 at B {b} x {n} x {d} f32, k {k} (tn {tn}): agrees with its twin (max_abs_err={err:.3g}, "
        f"overlap={overlap:.4f}); kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), library (torch.matmul f32) {rec['library_ms']:.4f} ms")
    return rec


def _hnsw_checks(phase, what, vals, fids, q64, emb64, row_of, live):
    """Every returned id of a [B, k] answer is live, no row repeats an id, and every
    score lies within HNSW_SCORE_TOL of its id's float64 score. Returns the largest
    score gap."""
    import numpy as np

    check(bool((fids >= 0).all()), f"{phase}: {what} returned {int((fids < 0).sum())} empty slots")
    check(bool(live[fids].all()), f"{phase}: {what} returned a dead id")
    check(all(len(set(r)) == len(r) for r in fids.tolist()), f"{phase}: {what} repeats an id in a row")
    exact = np.einsum("bd,bkd->bk", q64, emb64[row_of[fids]])
    gap = float(np.abs(vals.astype(np.float64) - exact).max())
    check(gap <= HNSW_SCORE_TOL, f"{phase}: {what} lists a score {gap:.3g} from its id's exact score")
    return gap


def start_hnsw_build(dev, seed: int) -> dict:
    """Start [hnsw_100k]'s native build in a background thread: make_vector_engine(
    "hnsw", dim=384) over 102,400 hard-clustered unit rows. The build is one call into
    the native library, which releases the interpreter lock, so it runs on a host core
    of its own while the earlier phases run; `hnsw_100k_phase` joins it. Returns the
    engine, the rows, the thread and (once joined) the build's seconds or its error."""
    import threading

    import numpy as np

    from wax_tpu_torch.search.vector_engines import make_vector_engine

    job = {"vecs": hard_clustered(N_HNSW, np.random.default_rng(seed)),
           "eng": make_vector_engine("hnsw", dim=HNSW_DIM, device=dev)}

    def build():
        t0 = time.perf_counter()
        try:
            job["eng"].add_batch(np.arange(N_HNSW), job["vecs"])
        except Exception as e:  # noqa: BLE001 — raised again by the phase that joins
            job["error"] = e
        job["seconds"] = time.perf_counter() - t0

    job["thread"] = threading.Thread(target=build, name="hnsw-100k-build", daemon=True)
    job["thread"].start()
    return job


def hnsw_100k_phase(dev, seed: int, results: dict, job: dict) -> dict:
    """BASELINE config 3: make_vector_engine("hnsw", dim=384) (CppHNSWBuilder, M 16,
    efConstruction 100) over 102,400 hard-clustered unit rows, built by
    `start_hnsw_build` in the background (`job`); 256 queries at ef 16,
    64, 128 and 256 through `hnsw_search` on the card against the exact top-10 of K2
    (`flat_scan_topk(backend="pallas")`, held against its twin here); the card against
    the CPU on the same graph, bit for bit on a 1/8-grid graph, and with TF32 on.
    Returns this phase's launches."""
    import numpy as np
    import torch

    from wax_tpu_torch.index.dense import DenseIndexBuilder
    from wax_tpu_torch.index.graph import HNSWBuilder
    from wax_tpu_torch.index.graph_cpp import CppHNSWBuilder
    from wax_tpu_torch.ops import flat_scan as fs
    from wax_tpu_torch.ops.beam_search import hnsw_search
    from wax_tpu_torch.search.vector_engines import AutoVectorEngine

    phase = "hnsw_100k"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    k = 10
    vecs, eng = job["vecs"], job["eng"]
    qn = hard_clustered(N_QUERIES, np.random.default_rng(seed + 1))
    q = torch.from_numpy(qn).to(dev)

    # 1. the build on the host (started in the background), flattened onto the card
    check(type(eng.builder) is CppHNSWBuilder,
          f"{phase}: the engine built with {type(eng.builder).__name__}, not CppHNSWBuilder (no native library)")
    check((eng.builder.m, eng.builder.ef_construction, eng.ef_search) == (16, 100, 64),
          f"{phase}: engine M {eng.builder.m}, efConstruction {eng.builder.ef_construction}, ef {eng.ef_search}")
    t0 = time.perf_counter()
    job["thread"].join()
    t_wait = time.perf_counter() - t0
    if "error" in job:
        raise job["error"]
    t_build = job["seconds"]
    check(len(eng) == N_HNSW, f"{phase}: the background build holds {len(eng)} rows")
    t0 = time.perf_counter()
    graph = eng.snapshot()
    torch.cuda.synchronize()
    t_snap = time.perf_counter() - t0
    check(graph.device == dev and graph.max_degree == 48 and graph.capacity == N_HNSW,
          f"{phase}: snapshot on {graph.device}, degree {graph.max_degree}, capacity {graph.capacity}")
    graph_bytes = sum(t.numel() * t.element_size()
                      for t in (graph.adjacency, graph.emb, graph.frame_ids, graph.bias, graph.entries))
    log(phase, f"CppHNSWBuilder (M 16, efConstruction 100) over {N_HNSW} x {HNSW_DIM} hard-clustered unit rows: "
        f"build {t_build:.2f} s = {N_HNSW / t_build:.1f} rows/s (host, a background thread beside the earlier "
        f"phases; {t_wait:.2f} s waited for it here); snapshot {t_snap:.2f} s (state export, "
        f"flattening, copy to the card); GraphIndex on the card {graph_bytes} bytes (adjacency "
        f"{tuple(graph.adjacency.shape)} int32, rows {tuple(graph.emb.shape)} f32, {graph.entries.shape[0]} entry seeds)")

    # 2. the exact top-10 through K2 on the same rows
    dense = DenseIndexBuilder(dim=HNSW_DIM)
    dense.add_batch(np.arange(N_HNSW), vecs)
    dsnap = dense.snapshot(device=dev)
    reset_launch_counts()
    _, _, truth = fs.flat_scan_topk(q, dsnap, k, backend="pallas")
    torch.cuda.synchronize()
    gt = launch_counts()
    check(gt["K2"] >= 1 and sum(gt.values()) == gt["K2"], f"{phase}: the exact ground truth launched {gt}")
    truth = truth.cpu().numpy()
    rec2 = _k2_case(phase, q, dsnap, k)
    rec2["launches"] = gt["K2"]
    results["K2"]["hnsw_100k"] = rec2
    results["K2"]["max_abs_err"] = max(results["K2"]["max_abs_err"], rec2["max_abs_err"])
    del dense, dsnap

    # 3. the ef sweep on the card
    emb64 = graph.emb.cpu().numpy().astype(np.float64)
    fids_all = graph.frame_ids.cpu().numpy()
    row_of = np.full(N_HNSW, -1, np.int64)
    row_of[fids_all[fids_all >= 0]] = np.nonzero(fids_all >= 0)[0]
    live = (graph.bias.cpu().numpy() == 0.0)[row_of.clip(min=0)] & (row_of >= 0)
    q64 = qn.astype(np.float64)
    sweep, answers = {}, {}
    for ef in HNSW_EFS:
        def run(ef=ef):
            return hnsw_search(q, graph, k=k, ef=ef)

        reset_launch_counts()
        vals, fids = run()
        torch.cuda.synchronize()
        check(not any(launch_counts().values()), f"{phase}: the beam search launched port kernels {launch_counts()}")
        answers[ef] = (vals, fids)
        v, f = vals.cpu().numpy(), fids.cpu().numpy()
        check(v.shape == f.shape == (N_QUERIES, k) and v.dtype == np.float32 and f.dtype == np.int32,
              f"{phase}: ef {ef} answer {v.shape} {v.dtype} {f.dtype}")
        gap = _hnsw_checks(phase, f"ef {ef}", v, f, q64, emb64, row_of, live)
        recall = AutoVectorEngine._recall(truth, f)
        ms = median_call_ms(run, iters=10)
        prof = device_profile(f"{phase} ef {ef}", run, iters=1)
        sweep[ef] = {"recall": recall, "ms": ms, "kernels": prof["events"], "busy": prof["busy"], "gap": gap}
        log(phase, f"ef {ef}, B {N_QUERIES}, k {k}: recall@{k} {recall:.4f} against K2's exact top-{k}; "
            f"{ms:.3f} ms a batch (median of 10 calls, CUDA events) = {N_QUERIES * 1e3 / ms:.1f} queries/s; "
            f"{prof['events']} kernels a search ({ef} steps); device busy "
            + (f"{100 * prof['busy']:.1f}%" if prof["busy"] is not None else "not measured")
            + f"; ids live and unique, scores within {gap:.3g} of float64")
    for lo, hi in zip(HNSW_EFS, HNSW_EFS[1:]):
        check(sweep[hi]["recall"] >= sweep[lo]["recall"] - 0.01,
              f"{phase}: recall falls from {sweep[lo]['recall']:.4f} at ef {lo} to {sweep[hi]['recall']:.4f} at ef {hi}")
    check(sweep[256]["recall"] >= HNSW_RECALL_FLOOR,
          f"{phase}: recall@{k} at ef 256 {sweep[256]['recall']:.4f} < {HNSW_RECALL_FLOOR}")
    ev, ef_ids = eng.search(qn, k)  # the engine's own entry at its ef_search 64
    check(np.array_equal(ef_ids, answers[64][1].cpu().numpy()) and np.array_equal(ev, answers[64][0].cpu().numpy()),
          f"{phase}: HNSWVectorEngine.search differs from hnsw_search at ef 64")

    # 4. TF32 on: the same bits, and the caller's setting restored
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = hnsw_search(q, graph, k=k, ef=64)
        flag_after = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(flag_after is True, f"{phase}: hnsw_search left allow_tf32 at {flag_after}, not the caller's True")
    check(all(torch.equal(a, b) for a, b in zip(on, answers[64])), f"{phase}: TF32 on changes the ef 64 answers")

    # 5. the same graph on the CPU: 32 queries at ef 64
    gcpu = _cpu_copy(graph)
    _, cf = hnsw_search(q[:32].cpu(), gcpu, k=k, ef=64)
    card_f = answers[64][1][:32].cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(card_f.tolist(), cf.numpy().tolist())]))
    same_rows = int((card_f == cf.numpy()).all(axis=1).sum())
    check(overlap >= 0.98, f"{phase}: card and CPU top-{k} overlap {overlap:.4f} < 0.98")
    del gcpu

    # 6. exact arithmetic: a 1/8-grid graph (numpy builder, normalize=False), card = CPU
    rng = np.random.default_rng(seed + 2)
    grid = (rng.integers(-8, 9, (N_GRID, 64)) / 8.0).astype(np.float32)
    gq = torch.from_numpy((rng.integers(-8, 9, (N_QUERIES, 64)) / 8.0).astype(np.float32))
    t0 = time.perf_counter()
    pb = HNSWBuilder(dim=64, m=8, ef_construction=40, normalize=False)
    pb.add_batch(np.arange(N_GRID), grid)
    t_py = time.perf_counter() - t0
    g_card, g_cpu = pb.snapshot(device=dev), pb.snapshot(device="cpu")
    for ef in (16, 64):
        got, want = hnsw_search(gq.to(dev), g_card, k=k, ef=ef), hnsw_search(gq, g_cpu, k=k, ef=ef)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"{phase}: the grid graph's ids or scores differ between the card and the CPU at ef {ef}")
    log(phase, f"checks: TF32 on gives the same bits at ef 64 (the setting restored); the CPU on the same graph "
        f"(32 queries, ef 64) overlaps the card's top-{k} {overlap:.4f}, {same_rows} of 32 rows equal; the {N_GRID:,} x "
        f"64 grid graph (numpy builder, M 8, efConstruction 40, {t_py:.1f} s) answers bit for bit as the CPU at ef 16 "
        f"and 64; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase seconds "
        f"{time.perf_counter() - t_phase:.1f}")
    return {"K2": gt["K2"], "sweep": sweep, "build_s": t_build, "snapshot_s": t_snap}


def orch_hnsw_phase(dev, seed: int, tmp: Path) -> dict:
    """The MemoryOrchestrator with OrchestratorConfig(vector_engine="hnsw") over the
    first N_ORCH_HNSW smoke documents (full-width MiniLM, bf16, random weights): ingest,
    N_ORCH_HNSW_QUERIES searches and 16 recalls one at a time, a profiled window, the vector lane's
    recall@10 against a flat engine over the same embeddings (reported), flush, close
    and a cold reopen answering bit for bit; then a WaxSession (open_session, hnsw) over
    the same documents and their embeddings: put_batch, commit, reopen, equal
    searches. The store stays in `tmp` for [orch_maint_hnsw]."""
    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMEmbedder
    from wax_tpu_torch.index.graph_cpp import CppHNSWBuilder
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.search.vector_engines import AutoVectorEngine, FlatVectorEngine
    from wax_tpu_torch.session import open_session
    from wax_tpu_torch.types import SearchRequest

    phase = "orch_hnsw"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, docs, queries = make_corpus(seed)
    docs, qs = docs[:N_ORCH_HNSW], queries[0][:N_ORCH_HNSW_QUERIES]
    cfg = OrchestratorConfig(vector_engine="hnsw")
    orch = sess = None
    try:
        embedder = MiniLMEmbedder(dtype=torch.bfloat16, batch_size=256, seed=0, device=dev)
        orch = MemoryOrchestrator(tmp / "memory.mv2s", embedder, cfg, device=dev)
        check(type(orch.engine.vector.builder) is CppHNSWBuilder,
              f"{phase}: the engine built with {type(orch.engine.vector.builder).__name__}, not CppHNSWBuilder")
        t0 = time.perf_counter()
        for i in range(0, N_ORCH_HNSW, 1024):
            orch.remember_batch(docs[i : i + 1024])
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        check(len(orch.engine.vector) == N_ORCH_HNSW, f"{phase}: {len(orch.engine.vector)} vectors after ingest")
        t0 = time.perf_counter()
        orch.warmup(background=False)  # the graph snapshot and one search on it
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0

        reset_launch_counts()
        lat_s, served = [], []
        for q in qs:
            t0 = time.perf_counter()
            served.append(orch.search(q, top_k=10))
            torch.cuda.synchronize()
            lat_s.append(time.perf_counter() - t0)
        lat_r = []
        for q in qs[:16]:
            t0 = time.perf_counter()
            ctx = orch.recall(q)
            torch.cuda.synchronize()
            lat_r.append(time.perf_counter() - t0)
            check(ctx.items and ctx.render(), f"{phase}: recall({q!r}) assembled no context")
        serve_launches = launch_counts()
        check(not any(serve_launches.values()),
              f"{phase}: serving launched port kernels {serve_launches} (the hnsw lane and the scatter BM25 lane "
              "launch none)")
        check(all(len(r.hits) == 10 and all(np.isfinite(h.score) for h in r.hits) for r in served),
              f"{phase}: a search returned fewer than 10 hits or a bad score")
        check(sum(r.lane_counts.get("vector", 0) > 0 for r in served) == len(qs),
              f"{phase}: a search had an empty vector lane")
        log(phase, f"{N_ORCH_HNSW} docs through remember_batch (calls of 1,024) in {t_ingest:.2f} s = "
            f"{N_ORCH_HNSW / t_ingest:.1f} docs/s (host clock ending in a sync); warmup (snapshot + one search) "
            f"{t_warm:.2f} s")
        for what, lat in (("search", lat_s), ("recall", lat_r)):
            p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
            log(phase, f"{what}: {len(lat)} calls one at a time, p50 {p50:.3f} ms, p99 {p99:.3f} ms "
                "(host clock ending in a device sync)")
        batches = iter([queries[1][:8], queries[1][8:16]])
        prof = device_profile(phase, lambda: [orch.search(q, top_k=10) for q in next(batches)], iters=1)
        log(phase, f"profiled window: {prof['events']} kernels over 8 fresh searches")

        # the vector lane against a flat engine over the same embeddings (reported)
        state = orch.engine.vector.builder.state_arrays()
        flat = FlatVectorEngine(dim=HNSW_DIM, device=dev)
        flat.add_batch(state["frame_ids"][state["active"]], state["vecs"][state["active"]])
        qv = np.stack([orch.engine.embed_query(q) for q in qs])
        _, hf = orch.engine.vector.search(qv, 10)
        _, ff = flat.search(qv, 10)
        lane_recall = AutoVectorEngine._recall(ff, hf)
        del flat

        t0 = time.perf_counter()
        orch.flush()
        t_flush = time.perf_counter() - t0
        orch.close()
        orch = None
        engine_cache.clear()
        t0 = time.perf_counter()
        orch = MemoryOrchestrator(tmp / "memory.mv2s", embedder, cfg, device=dev)
        t_open = time.perf_counter() - t0
        check(engine_cache.cache_stats()["hits"] == 0, f"{phase}: the cold reopen reclaimed a parked engine")
        stats = orch.runtime_stats()
        check(stats["vector_engine"] == "hnsw" and type(orch.engine.vector.builder) is CppHNSWBuilder,
              f"{phase}: reopened on {stats['vector_engine']} / {type(orch.engine.vector.builder).__name__}")
        again = [orch.search(q, top_k=10) for q in qs]
        same = sum(_hit_keys(a) == _hit_keys(b) for a, b in zip(served, again))
        check(same == len(qs), f"{phase}: the cold reopen answers {len(qs) - same} of {len(qs)} searches differently")
        orch.close()
        orch = None
        log(phase, f"vector lane recall@10 against a flat engine over the same {N_ORCH_HNSW} embeddings "
            f"{lane_recall:.4f} (reported, not gated); flush {t_flush:.2f} s; cold reopen {t_open:.3f} s, "
            f"stats vector_engine {stats['vector_engine']!r}, CppHNSWBuilder, {len(qs)} searches bit-identical")

        # 2. WaxSession over the same documents and their embeddings
        embs = np.concatenate([embedder.embed_batch(docs[i : i + 256]) for i in range(0, N_ORCH_HNSW, 256)])
        reqs = [SearchRequest(query=q, top_k=10, embedding=embedder.embed(q)) for q in qs[:16]]
        sess = open_session(tmp / "session.wxs", dim=HNSW_DIM, vector_preference="hnsw", device=dev)
        t0 = time.perf_counter()
        sess.put_batch(docs, embeddings=embs)
        t_put = time.perf_counter() - t0
        before = [sess.search(r) for r in reqs]
        t0 = time.perf_counter()
        sess.commit()
        t_commit = time.perf_counter() - t0
        sess.close()
        sess = open_session(tmp / "session.wxs", dim=HNSW_DIM, vector_preference="hnsw", device=dev)
        check(sess.engine.vector.kind == "hnsw" and type(sess.engine.vector.builder) is CppHNSWBuilder
              and len(sess.engine.vector) == N_ORCH_HNSW and sess.engine.vector.device == dev,
              f"{phase}: the session reopened on {sess.engine.vector.kind} with {len(sess.engine.vector)} vectors")
        after = [sess.search(r) for r in reqs]
        check(all(r.lane_counts.get("vector", 0) > 0 and len(r.hits) == 10 for r in before),
              f"{phase}: a session search had an empty vector lane or fewer than 10 hits")
        check(all(_hit_keys(a) == _hit_keys(b) for a, b in zip(before, after)),
              f"{phase}: the reopened session answers differently")
        log(phase, f"session: put_batch of {N_ORCH_HNSW} documents with their embeddings {t_put:.2f} s, commit "
            f"{t_commit:.2f} s; reopened on hnsw (CppHNSWBuilder), {len(reqs)} searches bit-identical")
    finally:
        for o in (orch, sess):
            if o is not None:
                o.close()
        engine_cache.clear()
    log(phase, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase seconds "
        f"{time.perf_counter() - t_phase:.1f}")
    return {"search_p50_ms": float(np.percentile(np.array(lat_s) * 1e3, 50)), "lane_recall": lane_recall,
            "queries": qs}


N_PHOTOS = 1_024  # [orch_maint_hnsw]'s photo assets, 4 OCR blocks each
N_VIDEOS = 256  # [orch_maint_hnsw]'s videos, 16 transcript segments each
# Video recalls ask the inner search for max(64, top_k x 4 x max(top_k, 4)) hits: 256 at
# the default top_k 8, which the flat lane serves on its plain product (k > 128, as the
# JAX package's "auto" backend does). At top_k 4 it asks for 64, and K1 serves it.
VIDEO_TOP_K = 4
MM_DIM = 384


class ChipMultimodalEmbedder:
    """A seeded deterministic multimodal embedder (tests/test_multimodal.py's
    DeterministicMultimodalEmbedder at width 384): texts hash to vectors, an image to
    the vector of its reference, or of its pixels' digest."""

    def __init__(self, seed: int, dim: int = MM_DIM):
        from wax_tpu_torch.embed.hash_embedder import HashEmbedder

        self._h = HashEmbedder(dim, seed=f"chip-smoke-{seed}")

    @property
    def dimensions(self):
        return self._h.dimensions

    @property
    def identity(self):
        return "chip-smoke-multimodal"

    def embed_text(self, text):
        return self._h.embed(text)

    def embed_image(self, image):
        import hashlib

        import numpy as np

        key = image if isinstance(image, str) else hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()
        return self._h.embed(f"image:{key}")


class _Stub:
    """An OCR and transcript provider handing back whatever was set last."""

    def __init__(self):
        self.items = []

    def ocr(self, image):
        return self.items

    def transcript(self, video_ref):
        return self.items


def _mm_round(phase: str, wrapper, what: str, forget_ids, recall_fn, key_fn) -> dict:
    """Recall, forget 10% of the wrapper's items, compact, recall, rewrite, recall: the
    roots follow the remap and the recalls equal the compacted ones under it. K1
    launches counted over the recalls."""
    import torch

    reset_launch_counts()
    first = recall_fn()
    k1 = launch_counts()["K1"]
    check(all(first), f"{phase}: {what}: a recall found nothing")
    check(k1 > 0, f"{phase}: {what}: the recalls launched K1 {k1} times")
    roots = dict(wrapper._ingested)
    inner = wrapper.inner
    t0 = time.perf_counter()
    for item in forget_ids:
        check(wrapper.forget(item), f"{phase}: {what}: forget({item!r}) found nothing")
    inner.maintainer.compact_indexes()
    t_compact = time.perf_counter() - t0
    reset_launch_counts()
    compacted = recall_fn()
    k1 += launch_counts()["K1"]
    gone = {roots[i][0] for i in forget_ids}
    remaps = []
    inner.maintainer.remap_listeners.append(remaps.append)
    t0 = time.perf_counter()
    rep = inner.maintainer.rewrite_live_set()
    torch.cuda.synchronize()
    t_rewrite = time.perf_counter() - t0
    (remap,) = remaps
    check(set(wrapper._ingested) == set(roots) - set(forget_ids), f"{phase}: {what}: the wrapper lost or kept items")
    for item, (root, ver) in wrapper._ingested.items():
        check((root, ver) == (remap[roots[item][0]], roots[item][1]),
              f"{phase}: {what}: the root of {item!r} did not follow the remap")
    check(not any(g in remap for g in gone), f"{phase}: {what}: a forgotten root survived the rewrite")
    reset_launch_counts()
    rewritten = recall_fn()
    k1 += launch_counts()["K1"]
    for a, b in zip(compacted, rewritten):
        check([key_fn(h, remap) for h in a] == [key_fn(h, None) for h in b],
              f"{phase}: {what}: a recall after the rewrite differs from the compacted one under the remap")
    check(inner.engine.vector.snapshot().emb.is_cuda, f"{phase}: {what}: the rebuilt snapshot is not on the card")
    log(phase, f"{what}: forgot {len(forget_ids)} of {len(roots)}, compaction {t_compact:.2f} s (forgets included), "
        f"rewrite {t_rewrite:.2f} s: frames {rep.frames_before} -> {rep.frames_after}, bytes {rep.bytes_before} -> "
        f"{rep.bytes_after}; roots follow the remap; {len(rewritten)} recalls equal the compacted ones under it; K1 "
        f"{k1} launches over the recalls")
    return {"K1": k1}


def orch_maint_hnsw_phase(dev, seed: int, tmp: Path, hnsw: dict) -> dict:
    """[orch_maint_hnsw]: surrogates, a forget of 10% and the live-set rewrite on
    [orch_hnsw]'s store in `tmp` (the graph rebuilt by the native builder onto the
    card), then the photo and video orchestrators on the card: ingest, recall through
    K1, forget, compact, rewrite with their roots remapped."""
    import numpy as np
    import torch

    from wax_tpu_torch.embed.hash_embedder import HashEmbedder
    from wax_tpu_torch.embed.minilm import MiniLMEmbedder
    from wax_tpu_torch.index.graph_cpp import CppHNSWBuilder
    from wax_tpu_torch.multimodal.photo import PhotoRAGOrchestrator
    from wax_tpu_torch.multimodal.protocols import OCRBlock, TranscriptSpan
    from wax_tpu_torch.multimodal.video import VideoRAGOrchestrator
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.search.vector_engines import AutoVectorEngine, FlatVectorEngine

    phase = "orch_maint_hnsw"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = OrchestratorConfig(vector_engine="hnsw")
    qs = hnsw["queries"]
    embedder = MiniLMEmbedder(dtype=torch.bfloat16, batch_size=256, seed=0, device=dev)
    rng = np.random.default_rng(seed + 29)
    orch = photo = video = None
    launched = {"K1": 0}
    try:
        engine_cache.clear()
        orch = MemoryOrchestrator(tmp / "memory.mv2s", embedder, cfg, device=dev)
        t0 = time.perf_counter()
        first = orch.maintainer.optimize_surrogates()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = orch.maintainer.optimize_surrogates()
        t_second = time.perf_counter() - t0
        check(first.surrogates_created > 0 and second.surrogates_created == 0
              and second.surrogates_current == first.surrogates_created
              and second.frames_scanned == first.frames_scanned,
              f"{phase}: optimize_surrogates gave {first}, then {second}")
        log(phase, f"optimize_surrogates(): {first.frames_scanned} frames scanned, {first.surrogates_created} "
            f"created in {t_first:.2f} s; again: {second.surrogates_current} current, 0 created in {t_second:.2f} s")

        docs = _document_ids(orch)
        gone = sorted(rng.choice(docs, len(docs) // 10, replace=False).tolist())
        t_forget = _forget(phase, orch, gone)
        remaps = []
        orch.maintainer.remap_listeners.append(remaps.append)
        t0 = time.perf_counter()
        rep = orch.maintainer.rewrite_live_set()
        torch.cuda.synchronize()
        t_rewrite = time.perf_counter() - t0
        (remap,) = remaps
        vec = orch.engine.vector
        check(type(vec.builder) is CppHNSWBuilder and len(vec) == len(docs) - len(gone),
              f"{phase}: the rewrite rebuilt {type(vec.builder).__name__} with {len(vec)} rows")
        t0 = time.perf_counter()
        snap = vec.snapshot()
        torch.cuda.synchronize()
        t_snap = time.perf_counter() - t0
        check(snap.emb.is_cuda and snap.adjacency.is_cuda, f"{phase}: the rebuilt graph is not on the card")
        state = vec.builder.state_arrays()
        flat = FlatVectorEngine(dim=HNSW_DIM, device=dev)
        flat.add_batch(state["frame_ids"][state["active"]], state["vecs"][state["active"]])
        qv = np.stack([orch.engine.embed_query(q) for q in qs])
        _, hf = vec.search(qv, 10)
        _, ff = flat.search(qv, 10)
        lane_recall = AutoVectorEngine._recall(ff, hf)
        del flat
        check(abs(lane_recall - hnsw["lane_recall"]) <= 0.02,
              f"{phase}: the rebuilt graph's recall@10 {lane_recall:.4f} is not within 0.02 of [orch_hnsw]'s "
              f"{hnsw['lane_recall']:.4f}")
        served = [orch.search(q, top_k=10) for q in qs]
        old_of = {new: old for old, new in remap.items()}
        check(all(len(r.hits) == 10 and not any(old_of[h.frame_id] in set(gone) for h in r.hits) for r in served),
              f"{phase}: a search after the rewrite gave fewer than 10 hits or a forgotten document")
        log(phase, f"forgot {len(gone)} of {len(docs)} in {t_forget:.2f} s; rewrite_live_set() {t_rewrite:.2f} s "
            f"(frames {rep.frames_before} -> {rep.frames_after}, bytes {rep.bytes_before} -> {rep.bytes_after}); "
            f"graph rebuilt by CppHNSWBuilder, snapshot onto the card {t_snap:.2f} s; vector lane recall@10 against "
            f"a flat engine {lane_recall:.4f} ([orch_hnsw] {hnsw['lane_recall']:.4f})")
        orch.close()
        orch = None
        engine_cache.clear()
        orch = MemoryOrchestrator(tmp / "memory.mv2s", embedder, cfg, device=dev)
        again = [orch.search(q, top_k=10) for q in qs]
        check(all(_hit_keys(a) == _hit_keys(b) for a, b in zip(served, again)),
              f"{phase}: the cold reopen of the rewritten store answers differently")
        orch.close()
        orch = None
        log(phase, f"cold reopen of the rewritten store: {len(qs)} searches bit-identical")

        # the photo orchestrator on the card
        words = [w for q in qs for w in q.split()]
        mm = ChipMultimodalEmbedder(seed)
        ocr = _Stub()
        photo = PhotoRAGOrchestrator(tmp / "photo.mv2s", embedder=mm, ocr_provider=ocr, device=dev)
        captions = []
        t0 = time.perf_counter()
        for i in range(N_PHOTOS):
            w = rng.choice(words, 12)
            ocr.items = [OCRBlock(f"{w[2 * j]} {w[2 * j + 1]}", (0.05 + 0.24 * j, 0.1, 0.2, 0.1), 0.9)
                         for j in range(4)]
            captions.append(f"a photo of {w[8]} {w[9]} near {w[10]} {w[11]}")
            photo.ingest(f"asset{i}", rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
                         taken_at_ms=1_700_000_000_000 + i * 60_000, caption_text=captions[-1])
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        rows = len(photo.inner.engine.vector)
        check(rows > 2_048, f"{phase}: the photo store holds {rows} vectors, not above 2,048")
        log(phase, f"PhotoRAGOrchestrator: {N_PHOTOS} assets ingested in {t_ingest:.2f} s, {rows} inner vectors, "
            f"{photo.inner.store.frame_count()} frames")
        picks = rng.choice(N_PHOTOS, 64, replace=False)
        out = _mm_round(
            phase, photo, "photo", [f"asset{i}" for i in sorted(rng.choice(N_PHOTOS, N_PHOTOS // 10, replace=False))],
            lambda: [photo.recall(captions[i]) for i in picks],
            lambda h, m: (h.asset_id, m[h.frame_id] if m else h.frame_id, h.score, h.kind, h.text, h.summary,
                          h.evidence, h.regions))
        launched["K1"] += out["K1"]
        photo.close()
        photo = None

        # the video orchestrator on the card
        stub = _Stub()
        video = VideoRAGOrchestrator(tmp / "video.mv2s", HashEmbedder(MM_DIM, seed=f"chip-smoke-{seed}"),
                                     device=dev)
        t0 = time.perf_counter()
        lines = []
        for i in range(N_VIDEOS):
            segs = [" ".join(rng.choice(words, 8)) for _ in range(16)]
            lines.append(segs)
            stub.items = [TranscriptSpan(10_000 * j, 10_000 * j + 9_500, t) for j, t in enumerate(segs)]
            res = video.ingest(f"vid{i}", 160_000, stub, taken_at_ms=1_700_000_000_000 + i * 60_000)
            check(len(res.segment_frames) == 16, f"{phase}: video {i} gave {len(res.segment_frames)} segments")
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        rows = len(video.inner.engine.vector)
        check(rows > 2_048, f"{phase}: the video store holds {rows} vectors, not above 2,048")
        log(phase, f"VideoRAGOrchestrator: {N_VIDEOS} videos of 16 segments ingested in {t_ingest:.2f} s, {rows} "
            "inner vectors")
        picks = [(int(i), int(j)) for i, j in zip(rng.choice(N_VIDEOS, 64), rng.integers(0, 16, 64))]
        out = _mm_round(
            phase, video, "video", [f"vid{i}" for i in sorted(rng.choice(N_VIDEOS, N_VIDEOS // 10, replace=False))],
            lambda: [video.recall(lines[i][j], top_k=VIDEO_TOP_K) for i, j in picks],
            lambda h, m: (h.video_id, h.segment_index, m[h.frame_id] if m else h.frame_id, h.score, h.text,
                          h.start_ms, h.end_ms, h.evidence))
        launched["K1"] += out["K1"]
    finally:
        for o in (orch, photo, video):
            if o is not None:
                o.close()
        engine_cache.clear()
    log(phase, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase seconds "
        f"{time.perf_counter() - t_phase:.1f}")
    return launched


# ------------------------------------------------------------------------------- train

TRAIN_STEPS = 600  # fixed in PERF.md's prediction before the first run on the card
TRAIN_BATCH = 256  # query/document pairs a step
TRAIN_LEN = 64
TRAIN_LR = 1e-4
BERT_INIT_STD = 0.02  # BERT's initializer range (HF BertConfig.initializer_range)
N_CONCEPTS, CONCEPTS_PER_PAIR = 8_192, 12
CONCEPT_DOC_BASE, CONCEPT_QUERY_BASE, FILLER_BASE = 1_000, 10_000, 20_000  # fillers: [20,000, vocab) in halves
N_EVAL_DOCS, N_EVAL_QUERIES = 10_240, 256
RESUME_AT, RESUME_STEPS = 3, 3


def synth_pairs(rng, n: int, vocab: int = 30_522) -> dict:
    """`n` query/document pairs that share no token: each pair holds 12 distinct
    concepts of 8,192; the document writes concept c as token CONCEPT_DOC_BASE + c, the
    query as CONCEPT_QUERY_BASE + c, each side padded to a length drawn from 16-64 with
    filler tokens of its own half of [FILLER_BASE, vocab), in shuffled order. Int32 [n,
    TRAIN_LEN] ids and masks (0 past the length)."""
    import numpy as np

    concepts = rng.integers(0, N_CONCEPTS, (n, CONCEPTS_PER_PAIR))
    srt = np.sort(concepts, axis=1)
    for i in np.nonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))[0]:  # about 0.8% of rows repeat one
        concepts[i] = rng.choice(N_CONCEPTS, CONCEPTS_PER_PAIR, replace=False)
    mid = (FILLER_BASE + vocab) // 2
    out = {}
    for side, base, lo, hi in (("d", CONCEPT_DOC_BASE, FILLER_BASE, mid), ("q", CONCEPT_QUERY_BASE, mid, vocab)):
        lengths = rng.integers(16, TRAIN_LEN + 1, n)
        toks = rng.integers(lo, hi, (n, TRAIN_LEN)).astype(np.int32)
        toks[:, :CONCEPTS_PER_PAIR] = base + concepts
        mask = np.arange(TRAIN_LEN)[None, :] < lengths[:, None]
        # shuffle each row's first `length` tokens: sort random keys, the padding last
        order = np.argsort(np.where(mask, rng.random((n, TRAIN_LEN)), 2.0), axis=1)
        ids = np.take_along_axis(toks, order, axis=1)
        out[f"{side}_ids"] = np.where(mask, ids, 0).astype(np.int32)
        out[f"{side}_mask"] = mask.astype(np.int32)
    return out


def bert_init(model, seed: int) -> None:
    """BERT's initialisation from a seeded generator: every matrix (the dense kernels
    and the embedding tables) N(0, 0.02^2), LayerNorm scales 1, biases 0. From the
    encoder's serving init (dense kernels N(0, 1/fan_in), token table N(0, 1)) the
    trainer drives every query and document onto one vector within a few hundred steps
    at these shapes, and the loss stays at ln(256)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g) * BERT_INIT_STD)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def train_step_flops(cfg, batch: int, length: int) -> float:
    """Model FLOPs of one training step on the padded shapes: forward and backward are
    three times the forward's products. A token of a layer multiplies by the four
    attention projections (4 h^2), the two MLP matrices (2 h i) and attends over the
    sequence (2 L h for the scores and the context), 2 FLOPs a multiply-add; queries
    and documents are 2 x batch sequences; the logits add 2 B^2 h."""
    h, inter = cfg.hidden, cfg.intermediate
    per_token = cfg.layers * 2 * (4 * h * h + 2 * h * inter + 2 * length * h)
    return 3.0 * (per_token * 2 * batch * length + 2 * batch * batch * h)


def train_phase(dev, seed: int, results: dict, tmp: Path) -> dict:
    """[train]: the contrastive Trainer at MiniLMConfig()'s full width (BERT's random
    initialisation from the seed, f32 parameters, bf16 compute), TRAIN_STEPS steps of TRAIN_BATCH
    synthetic pairs of length 64 that share no token; recall@10 of N_EVAL_QUERIES
    held-out queries over N_EVAL_DOCS held-out documents through the flat engine (K1)
    before and after; a checkpoint resumed bit for bit under deterministic algorithms;
    K1 held and timed at the retrieval check's shape."""
    import warnings

    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEncoder, mean_pool
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.train import Trainer
    from wax_tpu_torch.search.vector_engines import FlatVectorEngine

    phase = "train"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = MiniLMConfig()
    model = MiniLMEncoder(cfg, dtype=torch.bfloat16)
    bert_init(model, seed)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    trainer = Trainer(model, data_mesh(dev), learning_rate=TRAIN_LR)
    t0 = time.perf_counter()
    batches = train_batches(seed, TRAIN_STEPS, cfg.vocab_size, dev)
    held = {k: torch.from_numpy(v).to(dev)
            for k, v in synth_pairs(np.random.default_rng(seed + 1), N_EVAL_DOCS, cfg.vocab_size).items()}
    log(phase, f"MiniLMConfig() ({cfg.layers} layers, hidden {cfg.hidden}, {cfg.heads} heads, intermediate "
        f"{cfg.intermediate}, vocab {cfg.vocab_size}), {sum(t.numel() for t in init.values())} f32 parameters, bf16 "
        f"compute; {TRAIN_STEPS} steps of {TRAIN_BATCH} pairs x {TRAIN_LEN} (data made in "
        f"{time.perf_counter() - t0:.2f} s), lr {TRAIN_LR}")

    def encode(params, ids, mask):
        enc = MiniLMEncoder(cfg, dtype=torch.bfloat16)
        enc.load_state_dict(params)
        enc.to(dev).eval()
        with torch.no_grad():
            return torch.cat([mean_pool(enc(ids[i : i + 1024], mask[i : i + 1024]), mask[i : i + 1024])
                              for i in range(0, ids.shape[0], 1024)])

    def retrieval(params):
        """recall@10 of each held-out query's own document through the flat engine."""
        docs = encode(params, held["d_ids"], held["d_mask"])
        qs = encode(params, held["q_ids"][:N_EVAL_QUERIES], held["q_mask"][:N_EVAL_QUERIES])
        eng = FlatVectorEngine(cfg.hidden, device=dev)
        eng.add_batch(np.arange(N_EVAL_DOCS), docs.cpu().numpy())
        _, fids = eng.search(qs, 10)
        return float((fids == np.arange(N_EVAL_QUERIES)[:, None]).any(axis=1).mean()), eng, qs

    # the main path: retrieval, training, retrieval
    reset_launch_counts()
    recall_before, _, _ = retrieval(init)
    state = trainer.init_state(init)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    for batch in batches:
        t0 = time.perf_counter()
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))  # the fetch synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    t_train = time.perf_counter() - t_train
    recall_after, eng, qs = retrieval(state.params)
    launched = launch_counts()
    check(launched["K1"] == 2 and sum(launched.values()) == 2,
          f"{phase}: the retrieval checks launched {launched}, not K1 twice")
    check(all(np.isfinite(losses)), f"{phase}: a loss is not finite: {[x for x in losses if not np.isfinite(x)][:4]}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"{phase}: the mean of the last 10 losses {last:.4f} is not below the first 10's {first:.4f}")
    # every query and document on one vector gives ln(B) exactly, and ties then put the
    # lowest document ids first, which lifts recall@10 without training
    check(last < np.log(TRAIN_BATCH) - 1.0, f"{phase}: the last losses {last:.4f} sit at ln({TRAIN_BATCH}) = "
          f"{np.log(TRAIN_BATCH):.4f}: the encoder maps every input onto one vector")
    check(recall_after > recall_before, f"{phase}: recall@10 after training {recall_after:.4f} is not above "
          f"{recall_before:.4f} before")
    timed = np.array(step_ms[3:])  # the first steps set up cuBLAS and the allocator
    p10, p50, p90 = np.percentile(timed, [10, 50, 90])
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_LEN)
    tokens = 2 * TRAIN_BATCH * TRAIN_LEN
    real = float(np.mean([float(b["q_mask"].sum() + b["d_mask"].sum()) for b in batches]))
    mfu = flops / (p50 / 1e3 * PEAK_OPS_PER_S["bf16"])
    log(phase, f"loss {losses[0]:.4f} (step 1) -> {losses[-1]:.4f} (step {TRAIN_STEPS}); mean of the first 10 "
        f"{first:.4f}, of the last 10 {last:.4f}; {TRAIN_STEPS} steps in {t_train:.2f} s")
    log(phase, f"step ms (host clock ending in the loss fetch, steps 4-{TRAIN_STEPS}): p50 {p50:.3f}, p10 {p10:.3f}, "
        f"p90 {p90:.3f}, min {timed.min():.3f}, max {timed.max():.3f}; first three {[round(x, 1) for x in step_ms[:3]]}")
    log(phase, f"{tokens / (p50 / 1e3):.0f} tokens/s at p50 ({tokens} padded tokens a step, {real:.0f} unpadded); "
        f"model FLOPs a step {flops:.4e} (bound {flops / PEAK_OPS_PER_S['bf16'] * 1e3:.4f} ms at bf16 "
        f"{PEAK_OPS_PER_S['bf16'] / 1e12:.0f} TFLOP/s); train_mfu {mfu:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(phase, f"recall@10 of {N_EVAL_QUERIES} held-out queries over {N_EVAL_DOCS} held-out documents (flat engine, "
        f"auto -> K1, k 10): before {recall_before:.4f}, after {recall_after:.4f}; K1 launches {launched['K1']}")

    # where a step's time goes
    prof_batches = iter(batches[:4])
    device_profile(phase, lambda: trainer.step(state, next(prof_batches)), iters=3)

    # K1 at the retrieval check's shape
    rec = _k1_snap_case(phase, eng.snapshot(), qs.float().contiguous(), 10, "train eval")
    results["K1"]["train_eval"] = rec
    results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], rec["max_abs_err"])

    # resume: a checkpoint saved at step RESUME_AT continues as the uninterrupted run
    ck = tmp / "train_ck.npz"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            s = trainer.init_state(init)
            for b in batches[:RESUME_AT]:
                s, _ = trainer.step(s, b)
            trainer.save_checkpoint(s, ck)
            cont = []
            for b in batches[RESUME_AT : RESUME_AT + RESUME_STEPS]:
                s, loss = trainer.step(s, b)
                cont.append(float(loss))
            r = trainer.load_checkpoint(trainer.init_state(init), ck)
            check(int(r.step) == RESUME_AT and int(r.opt_state.count) == RESUME_AT,
                  f"{phase}: the checkpoint resumed at step {int(r.step)}")
            resumed = []
            for b in batches[RESUME_AT : RESUME_AT + RESUME_STEPS]:
                r, loss = trainer.step(r, b)
                resumed.append(float(loss))
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0] for w in caught if "deterministic" in str(w.message)})
    same_params = all(torch.equal(s.params[n], r.params[n]) for n in s.params)
    if nondet:
        log(phase, f"resume: ops without a deterministic CUDA form: {nondet}; losses held within rtol 1e-5")
        check(np.allclose(resumed, cont, rtol=1e-5, atol=0), f"{phase}: resumed losses {resumed} != {cont}")
    else:
        check(resumed == cont and same_params, f"{phase}: resumed losses {resumed} differ from the uninterrupted "
              f"run's {cont} (parameters equal: {same_params})")
    log(phase, f"resume under torch.use_deterministic_algorithms(True): saved at step {RESUME_AT} "
        f"({ck.stat().st_size} bytes, 305 leaves), {RESUME_STEPS} steps resumed: losses {resumed} "
        f"{'==' if resumed == cont else '!='} the uninterrupted run's, parameters bit-equal {same_params}")
    t_mesh = time.perf_counter()
    meshes, how = train_meshes(dev)
    train_mesh_f32(dev, cfg, init, batches, meshes, how, tmp)
    train_mesh_bf16(dev, cfg, init, batches, meshes, how)
    log(phase, f"sharded steps {time.perf_counter() - t_mesh:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"K1": launched["K1"]}


TRAIN_MESH_STEPS = 3  # f32 steps on each mesh against one device's, then as many after the resume
TRAIN_MESH_TIMED = 10  # bf16 steps timed on each mesh
# A gradient element below this at some step is rounding noise against Adam's eps 1e-8:
# Adam moves it by up to the learning rate whatever its size, so two summation orders
# move it apart by up to that (the attention key biases' case, element by element)
GRAD_NOISE_FLOOR = 1e-6


def train_batches(seed: int, n: int, vocab: int, dev) -> list:
    """[train]'s first n batches of TRAIN_BATCH pairs, on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(v).to(dev) for k, v in synth_pairs(rng, TRAIN_BATCH, vocab).items()}
            for _ in range(n)]


def train_meshes(dev):
    """([(label, mesh)], what they run on): [train]'s sharded meshes, data 4 and data 2
    x tp 2, over `mesh_devices(dev)`."""
    from wax_tpu_torch.parallel.mesh import data_mesh, make_mesh

    devs, how = mesh_devices(dev)
    return [("data 4", data_mesh(devs)), ("data 2 x tp 2", make_mesh(devs, tp=2))], how


def _train_steps(trainer, state, batches):
    losses = []
    for b in batches:
        state, loss = trainer.step(state, b)
        losses.append(float(loss))
    return state, losses


def _leaves_near(what: str, params: dict, ref: dict, steps: int, noise: dict) -> tuple:
    """Leaves after `steps` steps against a reference run's at the CPU tests' bounds:
    atol 1e-6, plus the learning rate a step on the attention key biases (their
    gradient is zero in exact arithmetic) and on each element whose reference gradient
    fell below GRAD_NOISE_FLOOR at some step (`noise`: masks by leaf). Returns (the
    largest difference of the other elements, the elements past 1e-6 within the wider
    bound)."""
    import torch

    worst, wide = 0.0, 0
    for n, p in params.items():
        mask = torch.ones_like(p, dtype=torch.bool) if n.endswith("attention.key.bias") else noise[n]
        err = (p - ref[n]).abs()
        loose = float(err[mask].max()) if bool(mask.any()) else 0.0
        tight = float(err[~mask].max()) if bool((~mask).any()) else 0.0
        check(tight <= 1e-6 and loose <= 1e-6 + 2 * steps * TRAIN_LR,
              f"train: {what}: leaf {n} differs by {tight:.3g} (bound 1e-6), by {loose:.3g} where its gradient is "
              f"noise (bound {1e-6 + 2 * steps * TRAIN_LR:.3g})")
        worst, wide = max(worst, tight), wide + int((err[mask] > 1e-6).sum())
    return worst, wide


def train_mesh_f32(dev, cfg, init, batches, meshes, how, tmp: Path) -> None:
    """[train]'s sharded checks in f32 compute with TF32 off, from [train]'s init and
    batches, under torch.use_deterministic_algorithms: TRAIN_MESH_STEPS steps on each
    mesh against one device's (losses within rtol 1e-5, leaves within the CPU tests'
    bounds); the loss and gradients of one step with TF32 turned on, bit for bit as
    with it off, on one device and on data 2 x tp 2; a checkpoint saved on data 2 x tp
    2 resumed on one device (losses within rtol 1e-5) and on the same mesh (bit for
    bit)."""
    import warnings

    import numpy as np
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMEncoder
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.train import Trainer

    phase = "train"
    t0 = time.perf_counter()
    model = MiniLMEncoder(cfg, dtype=torch.float32)
    one = Trainer(model, data_mesh(dev), learning_rate=TRAIN_LR)
    first, after = batches[:TRAIN_MESH_STEPS], batches[TRAIN_MESH_STEPS : 2 * TRAIN_MESH_STEPS]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ref, ref_losses, noise = one.init_state(init), [], {}
            for b in first:
                for n, g in one.loss_and_grads(ref.params, b)[1].items():
                    noise[n] = noise.get(n, False) | (g.abs() < GRAD_NOISE_FLOOR)
                ref, loss = one.step(ref, b)
                ref_losses.append(float(loss))
            sharded = {}
            for label, mesh in meshes:
                t = Trainer(model, mesh, learning_rate=TRAIN_LR)
                s, losses = _train_steps(t, t.init_state(init), first)
                rel = float(np.max(np.abs(np.subtract(losses, ref_losses)) / np.abs(ref_losses)))
                check(rel <= 1e-5, f"{phase}: f32 losses on {label} {losses} against one device's {ref_losses}")
                worst, wide = _leaves_near(f"f32 {label} after {TRAIN_MESH_STEPS} steps", s.params, ref.params,
                                           TRAIN_MESH_STEPS, noise)
                log(phase, f"f32 {label} ({how}; mesh {mesh.axis_names} {mesh.axis_sizes}), {TRAIN_MESH_STEPS} "
                    f"steps: losses {losses} against one device's {ref_losses} (largest relative gap {rel:.3g}, "
                    f"bound 1e-5); leaves within atol 1e-6 (largest gap {worst:.3g}) but {wide} elements of the "
                    f"attention key biases or of gradient below {GRAD_NOISE_FLOOR:g} at some step, within the "
                    f"learning rate a step more")
                sharded[label] = (t, s)
            for label, t in (("one device", one), ("data 2 x tp 2", sharded["data 2 x tp 2"][0])):
                params = t.init_state(init).params
                off = t.loss_and_grads(params, batches[0])
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    on = t.loss_and_grads(params, batches[0])
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                grads_equal = all(torch.equal(on[1][n], off[1][n]) for n in on[1])
                check(torch.equal(on[0], off[0]) and grads_equal, f"{phase}: f32 on {label}: TF32 on gives loss "
                      f"{float(on[0])!r} against {float(off[0])!r} off (gradients equal: {grads_equal})")
                log(phase, f"f32 on {label} with torch.backends.cuda.matmul.allow_tf32 = True: loss {float(on[0])!r} "
                    f"and every gradient bit for bit as with it off")
            t22, s22 = sharded["data 2 x tp 2"]
            ck = tmp / "train_mesh_ck.npz"
            t22.save_checkpoint(s22, ck)
            cont_state, cont = _train_steps(t22, s22, after)
            _, on_one = _train_steps(one, one.load_checkpoint(one.init_state(init), ck), after)
            again_state, again = _train_steps(t22, t22.load_checkpoint(t22.init_state(init), ck), after)
        finally:
            torch.use_deterministic_algorithms(False)
    with np.load(ck) as data:
        n_leaves = len(data.files)
    check(n_leaves == 305, f"{phase}: the data 2 x tp 2 checkpoint holds {n_leaves} leaves, not 305")
    rel = float(np.max(np.abs(np.subtract(on_one, cont)) / np.abs(cont)))
    check(rel <= 1e-5, f"{phase}: resumed on one device {on_one} against data 2 x tp 2's {cont}")
    nondet = sorted({str(w.message).split(" does not have")[0] for w in caught if "deterministic" in str(w.message)})
    same = again == cont and all(torch.equal(again_state.params[n], cont_state.params[n]) for n in cont_state.params)
    check(same or bool(nondet), f"{phase}: resumed on data 2 x tp 2 {again} differs from the uninterrupted {cont}")
    log(phase, f"f32 checkpoint saved on data 2 x tp 2 at step {TRAIN_MESH_STEPS} ({n_leaves} leaves): resumed on "
        f"one device {on_one} against the uninterrupted {cont} (largest relative gap {rel:.3g}, bound 1e-5); on "
        f"data 2 x tp 2 under torch.use_deterministic_algorithms(True): {again}, bit for bit {same}"
        + (f"; ops without a deterministic CUDA form: {nondet}" if nondet else "")
        + f"; {time.perf_counter() - t0:.1f} s")


def train_mesh_bf16(dev, cfg, init, batches, meshes, how) -> dict:
    """[train]'s sharded steps in bf16 compute, from [train]'s init and batches, on one
    device and on each mesh: the loss at the init (the first step's) against one
    device's, step ms p50 (median of TRAIN_MESH_TIMED steps, CUDA events), busy share
    and device launches a step over 3 profiled steps (torch.profiler), and synchronising
    calls a step, which must not grow with the shard count."""
    import itertools

    import torch

    from wax_tpu_torch.embed.minilm import MiniLMEncoder
    from wax_tpu_torch.parallel.mesh import data_mesh
    from wax_tpu_torch.parallel.train import Trainer

    phase = "train"
    model = MiniLMEncoder(cfg, dtype=torch.bfloat16)
    out = {}
    for label, mesh in [("one device", data_mesh(dev))] + list(meshes):
        t0 = time.perf_counter()
        t = Trainer(model, mesh, learning_rate=TRAIN_LR)
        state, loss0 = t.step(t.init_state(init), batches[0])
        box, loss0 = [state], float(loss0)
        feed = itertools.cycle(batches[1:8])

        def step():
            box[0] = t.step(box[0], next(feed))[0]

        ms = median_call_ms(step, iters=TRAIN_MESH_TIMED, warmup=1)
        prof = device_profile(phase, step, iters=3)
        n_sync, msgs = sync_calls(step)
        gap = abs(loss0 - out["one device"]["loss0"]) / out["one device"]["loss0"] if out else 0.0
        launches = None if prof["events"] is None else prof["events"] / 3
        out[label] = {"loss0": loss0, "ms": ms, "busy": prof["busy"], "launches": launches, "sync": n_sync}
        busy = "not measured" if prof["busy"] is None else f"{100 * prof['busy']:.1f}%"
        log(phase, f"bf16 {label} ({'the card' if label == 'one device' else how}): loss at the init {loss0!r} "
            f"(relative gap to one device's {gap:.3g}); step ms p50 {ms:.3f} (median of {TRAIN_MESH_TIMED}, CUDA "
            f"events); busy {busy}; device launches a step {launches}; synchronising calls a step {n_sync}"
            + (f" {msgs}" if msgs else "") + f"; {time.perf_counter() - t0:.1f} s")
    for label, _ in meshes:
        check(out[label]["sync"] <= out["one device"]["sync"], f"{phase}: {label} makes {out[label]['sync']} "
              f"synchronising calls a step, one device {out['one device']['sync']}")
    return out


def train_sharded_phase(dev, seed: int) -> dict:
    """[train]'s bf16 sharded steps alone (scripts/sharded_phases.py): BERT's init from
    the seed and [train]'s first 8 batches."""
    import torch

    from wax_tpu_torch.embed.minilm import MiniLMConfig, MiniLMEncoder

    cfg = MiniLMConfig()
    model = MiniLMEncoder(cfg, dtype=torch.bfloat16)
    bert_init(model, seed)
    meshes, how = train_meshes(dev)
    return train_mesh_bf16(dev, cfg, model.state_dict(), train_batches(seed, 8, cfg.vocab_size, dev), meshes, how)


# --------------------------------------------------------------------------------- mcp

N_MCP_NOTES = 256  # wax_remember calls of the session; each round also searches and recalls
MCP_STDIO_NOTE = 200  # the note the stdio server must find (never forgotten)


def _mcp_call(mid, name: str, args: dict) -> dict:
    return {"jsonrpc": "2.0", "id": mid, "method": "tools/call", "params": {"name": name, "arguments": args}}


def _mcp_note(i: int, words, rng) -> str:
    return f"agent note {i} zq{i:04d}marker: " + " ".join(rng.choice(words, 12))


def build_mcp_store(path: str, seed: int, device: str) -> None:
    """[mcp]'s store: the smoke corpus's 102,400 documents through remember_batch
    (HashEmbedder(384), calls of 1,024) on `device`, flushed and closed; prints its
    seconds and the file's bytes. `start_mcp_store` runs it in a process of its own."""
    from wax_tpu_torch.embed.hash_embedder import HashEmbedder
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig

    _, docs, _ = make_corpus(seed)
    t0 = time.perf_counter()
    orch = MemoryOrchestrator(Path(path), HashEmbedder(384), OrchestratorConfig(), device=device)
    try:
        for i in range(0, len(docs), 1024):
            orch.remember_batch(docs[i : i + 1024])
        orch.flush()
    finally:
        orch.close()
    print(f"{len(docs)} docs through remember_batch (HashEmbedder(384), calls of 1,024) and flush in "
          f"{time.perf_counter() - t0:.2f} s; file {Path(path).stat().st_size} bytes", flush=True)


def start_mcp_store(tmp: Path, seed: int, dev):
    """Build [mcp]'s store on `dev` in a process of its own (`build_mcp_store`), which
    runs on the host beside [train]; `mcp_phase` waits for it. Returns (path,
    process)."""
    path = tmp / "mcp" / "memory.mv2s"
    path.parent.mkdir(parents=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.build_mcp_store(sys.argv[2], int(sys.argv[3]), sys.argv[4])")
    proc = subprocess.Popen([sys.executable, "-c", code, str(REPO), str(path), str(seed), str(dev)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return path, proc


def mcp_phase(dev, seed: int, tmp: Path, store) -> dict:
    """[mcp]: the MCP server over a store of the smoke corpus's 102,400 documents
    (HashEmbedder(384): the card has no MiniLM weights, and `_select_embedder` keeps
    the store's hash embedder), built by `start_mcp_store` (`store`: its path and
    process). build_server in process: a profiled window of 32 searches (K1 at B 1 over
    the reopened store's snapshot), then an agent session of 1,024 JSON-RPC messages
    (p50/p99 per tool; K1 launched by each vector-lane call until the remembers grow
    the snapshot past K1's 131,072 rows), 64 searches of a server reopened over the
    flushed store held against a CPU server over its copy (the doctor runs meanwhile); `python -m wax_tpu_torch.surfaces.mcp_server` over stdio finds a
    flushed note; `python -m wax_tpu_torch.surfaces.cli mcp doctor` names the card."""
    import numpy as np
    import torch

    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.surfaces.mcp_server import build_server
    from wax_tpu_torch.types import SearchRequest
    from wax_tpu_torch.utils.profiling import reset_spans, span_stats

    phase = "mcp"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    words, _, queries = make_corpus(seed)

    # 1. the store, built in a process of its own beside [train]
    path, proc = store
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"{phase}: the store's build exited {proc.returncode}: "
          f"{err.strip().splitlines()[-5:]}")
    log(phase, f"store (a process of its own, beside [train]; {time.perf_counter() - t0:.2f} s waited for it "
        f"here): {out.strip()}")

    # 2. the server, in process, on the card
    t0 = time.perf_counter()
    srv = build_server(path)
    cpu_srv = doctor = stdio = None
    try:
        check(srv.orch.device.type == "cuda", f"{phase}: build_server serves on {srv.orch.device}")
        ident = srv.orch.memoizer.provider.identity
        check(ident.startswith("hash-embedder"), f"{phase}: _select_embedder chose {ident}")
        warm = srv.orch.wait_for_warmup(timeout=300)
        cap0 = srv.orch.engine.vector.snapshot().capacity
        log(phase, f"build_server: {time.perf_counter() - t0:.3f} s to a warm server (warmup done: {warm}); "
            f"embedder {ident}, {len(srv.orch.engine.vector)} vectors in a dense snapshot of {cap0} rows")

        # where the time goes on the reopened store: 32 searches through the server (K1)
        batches = iter([queries[3][128:160], queries[3][160:192]])
        prof_k1 = device_profile(phase, lambda: [srv.handle(_mcp_call(0, "wax_search", {"query": q}))
                                                 for q in next(batches)], iters=1)
        check(prof_k1["launched"].get("K1", 0) == 32,
              f"{phase}: the profiled window launched K1 {prof_k1['launched'].get('K1', 0)} times for 32 searches")

        # 3. the agent session
        rng = np.random.default_rng(seed + 7)
        lat: dict = collections.defaultdict(list)
        ids = itertools.count(1)
        n_msgs = 0

        def send(label, msg):
            nonlocal n_msgs
            t0 = time.perf_counter()
            resp = srv.handle(msg)
            torch.cuda.synchronize()
            lat[label].append((time.perf_counter() - t0) * 1e3)
            n_msgs += 1
            if "id" not in msg:
                check(resp is None, f"{phase}: a notification got {resp}")
                return None
            check(resp is not None and resp.get("jsonrpc") == "2.0" and resp.get("id") == msg["id"]
                  and "result" in resp and "error" not in resp, f"{phase}: {label} answered {str(resp)[:300]}")
            if msg.get("method") != "tools/call":
                return resp["result"]
            return json.loads(resp["result"]["content"][0]["text"])

        reset_spans()
        reset_launch_counts()
        t_session = time.perf_counter()
        send("initialize", {"jsonrpc": "2.0", "id": next(ids), "method": "initialize", "params": {}})
        send("notifications/initialized", {"jsonrpc": "2.0", "method": "notifications/initialized"})
        tools = send("tools/list", {"jsonrpc": "2.0", "id": next(ids), "method": "tools/list"})["tools"]
        check(len(tools) == 22, f"{phase}: tools/list lists {len(tools)} tools")
        send("wax_session_start", _mcp_call(next(ids), "wax_session_start", {"name": "chip-smoke"}))
        # the agent looks things up, then writes its notes
        for i in range(N_MCP_NOTES):
            hits = send("wax_search", _mcp_call(next(ids), "wax_search", {"query": queries[0][i]}))["hits"]
            check(len(hits) == 10, f"{phase}: wax_search {queries[0][i]!r} returned {len(hits)} hits")
            ctx = send("wax_recall", _mcp_call(next(ids), "wax_recall", {"query": queries[1][i]}))
            check(ctx["items"] and ctx["total_tokens"] > 0, f"{phase}: wax_recall {queries[1][i]!r} found nothing")
        lookup_k1, lookup_vec = launch_counts()["K1"], span_stats()["search.vector_lane"]["count"]
        note_ids = []
        for i in range(N_MCP_NOTES):
            note = {"content": _mcp_note(i, words, rng), "tags": ["agent"]}
            note_ids.append(send("wax_remember", _mcp_call(next(ids), "wax_remember", note))["document_id"])
        cap1 = srv.orch.engine.vector.snapshot().capacity
        for j in range(22):
            send("wax_entity_upsert", _mcp_call(next(ids), "wax_entity_upsert",
                                                {"name": f"project {j}", "kind": "project", "aliases": [f"p{j}"]}))
        for j in range(21):
            send("wax_fact_assert", _mcp_call(next(ids), "wax_fact_assert", {
                "subject": f"project {j}", "predicate": "status", "value": str(rng.choice(words)),
                "evidence_frames": [note_ids[j]]}))
        for j in range(21):
            facts = send("wax_facts_query", _mcp_call(next(ids), "wax_facts_query", {"subject": f"project {j}"}))
            check(len(facts["facts"]) == 1, f"{phase}: facts of project {j}: {facts}")
        for j in range(16):
            send("wax_handoff", _mcp_call(next(ids), "wax_handoff", {
                "content": f"handoff {j}: " + " ".join(rng.choice(words, 8)), "project": "chip-smoke",
                "pending_tasks": [f"task {j}"]}))
            got = send("wax_handoff_latest", _mcp_call(next(ids), "wax_handoff_latest", {"project": "chip-smoke"}))
            check(got["found"] and got["content"].startswith(f"handoff {j}:"), f"{phase}: handoff_latest {got}")
        variants = [{"mode": "text"}, {"mode": "vector"}, {"include_diagnostics": True},
                    {"frame_ids": note_ids[:32]}]
        for j in range(88):
            send("wax_search (options)", _mcp_call(next(ids), "wax_search",
                                                   {"query": queries[2][j], **variants[j % 4]}))
        tl = send("wax_timeline", _mcp_call(next(ids), "wax_timeline", {"limit": 50}))
        check(len(tl["frames"]) == 50, f"{phase}: wax_timeline listed {len(tl['frames'])} frames")
        stats = send("wax_stats", _mcp_call(next(ids), "wax_stats", {}))
        forgotten = [fid for i, fid in enumerate(note_ids) if i != MCP_STDIO_NOTE][:64]
        for fid in forgotten:
            check(send("wax_forget", _mcp_call(next(ids), "wax_forget", {"frame_id": fid}))["deleted"],
                  f"{phase}: wax_forget {fid} deleted nothing")
        gen = send("wax_flush", _mcp_call(next(ids), "wax_flush", {}))["generation"]
        send("wax_session_end", _mcp_call(next(ids), "wax_session_end", {}))
        t_session = time.perf_counter() - t_session
        launched = launch_counts()
        vec_calls = span_stats()["search.vector_lane"]["count"]
        check(n_msgs == 1024, f"{phase}: the session sent {n_msgs} messages")
        grown = cap1 > 131_072  # flat_scan's `auto` serves K1 up to 131,072 rows, the blockmax scan above
        check(launched["K1"] > 0 and lookup_k1 == lookup_vec and launched["K1"] == (lookup_vec if grown else vec_calls),
              f"{phase}: K1 launched {launched['K1']} times, {lookup_k1} of them for the {lookup_vec} vector-lane "
              "calls before the remembers")
        log(phase, f"session: {n_msgs} JSON-RPC messages in {t_session:.2f} s ({n_msgs / t_session:.1f} messages/s; "
            f"host clock around McpServer.handle ending in a device sync); flush generation {gen}; "
            f"{stats['vector_count']} vectors, {stats['lex_docs']} lex docs before the forgets")
        for label, ms in sorted(lat.items(), key=lambda kv: -len(kv[1])):
            p50, p99 = np.percentile(ms, [50, 99])
            log(phase, f"  {label}: {len(ms)} calls, p50 {p50:.3f} ms, p99 {p99:.3f} ms")
        log(phase, f"launches over the session: K1 {launched['K1']} (= the {lookup_vec} vector-lane calls of the "
            f"searches and recalls over the reopened store's {cap0}-row snapshot); the remembers grew it to {cap1} "
            f"rows, so the other {vec_calls - lookup_vec} vector-lane calls ran "
            f"{'the plain blockmax scan (K1 serves up to 131,072 rows)' if grown else 'K1'}; other port kernels "
            f"{({k: v for k, v in launched.items() if v and k != 'K1'})}")

        # 4. the same 64 searches on the card and on the CPU, each server just opened over the
        # flushed store (a copy for the CPU), so both serve the same snapshot on the same route
        reqs = [SearchRequest(query=q, top_k=10, embedding=srv.orch.engine.embed_query(q)) for q in queries[3][:64]]
        srv.close()
        srv = None
        engine_cache.clear()
        cpu_dir = tmp / "mcp_cpu"
        shutil.copytree(path.parent, cpu_dir)
        t0 = time.perf_counter()
        srv = build_server(path)
        cap2 = srv.orch.engine.vector.snapshot().capacity
        json_card = [srv.handle(_mcp_call(i, "wax_search", {"query": r.query})) for i, r in enumerate(reqs)]
        card = [srv.orch.search(r) for r in reqs]
        bm_card, vec_card = _orch_lanes(srv.orch, reqs)
        srv.close()
        srv = None
        engine_cache.clear()
        # 5. meanwhile, in processes of their own: the stdio server over the flushed store,
        # and the doctor (its store check on a path of its own: a read-only open of the
        # served store would wait on the stdio server's writer lease)
        marker = f"zq{MCP_STDIO_NOTE:04d}marker"
        lines = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
                 {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                 _mcp_call(3, "wax_recall", {"query": marker})]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        t_children = time.perf_counter()
        stdio = subprocess.Popen([sys.executable, "-m", "wax_tpu_torch.surfaces.mcp_server"], cwd=REPO,
                                 env=dict(env, WAX_TPU_STORE=str(path)), stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        doctor = subprocess.Popen([sys.executable, "-m", "wax_tpu_torch.surfaces.cli", "mcp", "doctor", "--store",
                                   str(tmp / "mcp_doctor" / "memory.mv2s")], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        cpu_srv = build_server(cpu_dir / path.name, device="cpu")
        json_cpu = [cpu_srv.handle(_mcp_call(i, "wax_search", {"query": r.query})) for i, r in enumerate(reqs)]
        cpu = [cpu_srv.orch.search(r) for r in reqs]
        bm_cpu, vec_cpu = _orch_lanes(cpu_srv.orch, reqs)
        _lanes_agree(phase, "BM25", [r.query for r in reqs], bm_card, bm_cpu)
        vec = _vector_lanes_agree(phase, "vector", reqs, vec_card, vec_cpu, cpu_srv.orch.engine.vector.snapshot())
        fdiff = _fused_agree(phase, "mcp", cpu_srv.orch, reqs, card, cpu, vec_card, vec_cpu)
        json_equal = sum(a == b for a, b in zip(json_card, json_cpu))
        cpu_srv.close()
        cpu_srv = None
        equal = (len(reqs) - fdiff) / len(reqs)
        log(phase, f"CPU cross-check (64 searches, the card's server and a CPU server each just opened over the "
            f"flushed store ({cap2}-row dense snapshot) or its copy, {time.perf_counter() - t0:.1f} s): BM25 lanes equal; vector lanes equal on {len(reqs) - vec['differ']}, "
            f"the rest near-ties by exact score (id overlap {vec['overlap']:.4f}); fused top-10 equal on "
            f"{len(reqs) - fdiff} ({100 * equal:.1f}%), JSON-RPC responses equal on {json_equal}")
        check(equal >= ORCH_FUSED_FLOOR, f"{phase}: fused top-10 equal on {100 * equal:.1f}% of queries, under the "
              f"floor {100 * ORCH_FUSED_FLOOR:.0f}%")
        doc_out, doc_err = doctor.communicate(timeout=300)
        # its start (imports, the store's open, warmup) ran meanwhile; now the messages, then EOF
        io_out, io_err = stdio.communicate(input="".join(json.dumps(m) + "\n" for m in lines), timeout=600)
        t_children = time.perf_counter() - t_children
    finally:
        for s_ in (srv, cpu_srv):
            if s_ is not None:
                s_.close()
        engine_cache.clear()
        for child in (doctor, stdio):
            if child is not None and child.poll() is None:
                child.kill()
                child.communicate()
    dev_line = next((ln for ln in doc_out.splitlines() if "devices:" in ln), "")
    check(doctor.returncode == 0 and dev_line.startswith("[ok]") and torch.cuda.get_device_name(0) in dev_line,
          f"{phase}: mcp doctor exited {doctor.returncode}: {doc_out.strip()[-400:]} {doc_err.strip()[-400:]}")
    log(phase, f"mcp doctor (beside the CPU cross-check): exit 0; {dev_line}")

    # 6. the stdio server's replies
    err_tail = io_err.strip().splitlines()[-5:]
    check(stdio.returncode == 0, f"{phase}: the stdio server exited {stdio.returncode}: {err_tail}")
    replies = []
    for line in io_out.splitlines():
        try:
            replies.append(json.loads(line))
        except json.JSONDecodeError:
            fail(f"{phase}: the stdio server wrote a line that is not JSON: {line[:200]!r}")
    check([r.get("id") for r in replies] == [1, 2, 3] and all(r.get("jsonrpc") == "2.0" and "result" in r
                                                              for r in replies),
          f"{phase}: stdio replies {str(replies)[:300]}")
    recalled = json.loads(replies[2]["result"]["content"][0]["text"])
    check(marker in recalled["context"], f"{phase}: the stdio server's wax_recall did not find note "
          f"{MCP_STDIO_NOTE}: {recalled['context'][:200]!r}")
    log(phase, f"stdio: python -m wax_tpu_torch.surfaces.mcp_server over the flushed store answered initialize, "
        f"tools/list and a wax_recall that found note {MCP_STDIO_NOTE}; exit code 0 on closed stdin, "
        f"{len(replies)} replies, all JSON-RPC; it and the doctor, beside the CPU cross-check, in {t_children:.2f} s; "
        f"its stderr: {err_tail}")

    log(phase, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase seconds "
        f"{time.perf_counter() - t_phase:.1f}")
    return {"K1": launched["K1"]}


# ------------------------------------------------------------------------ orch_sharded

N_ORCH_SHARDED = 64  # [orch_sharded]'s searches and recalls on each mesh


def _bm25_lanes_near(phase, what, qs, card, ref) -> int:
    """BM25 lane lists [(frame_id, score)] against a reference lane summed in another
    order: scores within rtol 1e-6 place by place, ids equal but for near-tie swaps.
    Returns the queries whose ids differ."""
    import numpy as np

    differ = 0
    for q, a, b in zip(qs, card, ref):
        check(len(a) == len(b), f"{phase}: {what} lane lengths differ for {q!r}: {len(a)} vs {len(b)}")
        if not a:
            continue
        differ += _near_tie_agree(phase, f"{what} lane of {q!r}", np.array([[s for _, s in a]]),
                                  np.array([[f for f, _ in a]]), np.array([[s for _, s in b]]),
                                  np.array([[f for f, _ in b]]))
    return differ


@contextlib.contextmanager
def bm25_lane_as_on_card():
    """The sharded BM25 lane's `auto` backend resolved on CPU postings as on the card:
    the kernels' plain twins (K8's on an exact store) where `kernels_take` passes the
    shard's snapshot, instead of the plain merge harness, so a CPU orchestrator's lane
    can equal the card's bit for bit."""
    from wax_tpu_torch.ops.bm25_candidates_pallas import kernels_take
    from wax_tpu_torch.parallel import sharded_hybrid as sh

    real = sh._resolve_lex_backend

    def as_on_card(lex, backend, q2=16):
        if backend == "auto" and kernels_take(lex.shard(0), q2):
            return "candidates_pallas"
        return real(lex, backend, q2)

    sh._resolve_lex_backend = as_on_card
    try:
        yield
    finally:
        sh._resolve_lex_backend = real


def orch_sharded_phase(dev, seed: int, path: Path, results: dict) -> dict:
    """[orch_sharded]: [mcp]'s flushed store (102,400 documents and the session's notes,
    HashEmbedder(384), exact postings) reopened read-only as
    OrchestratorConfig(sharded_lanes=True) over 4 shards, then with mesh_slices=2:
    N_ORCH_SHARDED searches and recalls one at a time (the BM25 lane through K8 on each
    shard; the store's `auto` vector segment keeps its engine, K1 at B 1 on the lead
    card); the two-level answers equal the flat mesh's, the BM25 lane the unsharded
    reopen's, and the fused top-10 a CPU orchestrator's of the same config over the
    same file (gated at ORCH_FUSED_FLOOR); K8 held and timed at the lane's first call on
    4 shards ("orch_sharded" under K8). Returns the launches of the served calls."""
    import numpy as np
    import torch

    from wax_tpu_torch.embed.hash_embedder import HashEmbedder
    from wax_tpu_torch.orchestrator import MemoryOrchestrator, OrchestratorConfig
    from wax_tpu_torch.ops import bm25_lane
    import wax_tpu_torch.search.unified as unified
    from wax_tpu_torch.search import engine_cache
    from wax_tpu_torch.types import SearchRequest

    phase = "orch_sharded"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, _, queries = make_corpus(seed)
    devs, how = mesh_devices(dev)
    emb = HashEmbedder(384)
    n = N_ORCH_SHARDED
    reqs = [SearchRequest(query=q, top_k=10, embedding=emb.embed(q)) for q in queries[2][:64]]
    out, k8_args = {}, {}
    total = {kid: 0 for kid in KERNEL_IDS}
    for label, cfg in (("4 shards", OrchestratorConfig(sharded_lanes=True)),
                       ("2 x 2", OrchestratorConfig(sharded_lanes=True, mesh_slices=2))):
        engine_cache.clear()
        t0 = time.perf_counter()
        o = MemoryOrchestrator(path, emb, cfg, readonly=True, device=devs)
        t_open = time.perf_counter() - t0
        try:
            o.warmup(background=False)
            t_warm = time.perf_counter() - t0
            mesh = o.engine.mesh
            check(o.engine.lex_sharded and mesh.corpus_shards == N_SHARDS and o.engine.device == dev,
                  f"{phase} {label}: the orchestrator serves on {mesh} from {o.engine.device}")
            reset_launch_counts()
            lat = {"search": [], "recall": []}
            sharded_calls = [0]
            real = unified.sharded_bm25_topk
            lane_args = []

            def counted(*a, **kw):  # the lane's device runs (a query's primary and OR fallback)
                sharded_calls[0] += 1
                lane_args[:] = lane_args or [a, kw]
                return real(*a, **kw)

            unified.sharded_bm25_topk = counted
            try:
                with first_call_args(bm25_lane, "candidate_scores_pallas", k8_args):
                    for i in range(n):
                        t1 = time.perf_counter()
                        resp = o.search(SearchRequest(query=queries[0][i], top_k=10))
                        torch.cuda.synchronize()
                        lat["search"].append((time.perf_counter() - t1) * 1e3)
                        check(len(resp.hits) == 10, f"{phase} {label}: search {queries[0][i]!r} gave {len(resp.hits)} "
                              "hits")
                        t1 = time.perf_counter()
                        ctx = o.recall(queries[1][i])
                        torch.cuda.synchronize()
                        lat["recall"].append((time.perf_counter() - t1) * 1e3)
                        check(ctx.items, f"{phase} {label}: recall {queries[1][i]!r} found nothing")
            finally:
                unified.sharded_bm25_topk = real
            launches = launch_counts()
            runs = sharded_calls[0]
            if label == "4 shards":  # one lane run's device time by kernel: K8, wide_topk's sorts, the merge
                device_profile(f"{phase} bm25 lane", lambda: real(*lane_args[0], **lane_args[1]), top=12)
            check(launches["K8"] == N_SHARDS * runs and runs > 0,
                  f"{phase} {label}: K8 launched {launches['K8']} times for {runs} sharded BM25 runs on "
                  f"{N_SHARDS} shards")
            for kid, c in launches.items():
                total[kid] += c
            p = {key: np.percentile(v, [50, 99]) for key, v in lat.items()}
            log(phase, f"{label} ({how}; mesh {mesh.axis_names} {mesh.axis_sizes}; vector engine "
                f"{o.engine.vector.kind}): cold read-only open {t_open:.3f} s, warm {t_warm:.3f} s; {n} searches p50 "
                f"{p['search'][0]:.3f} ms p99 {p['search'][1]:.3f} ms, {n} recalls p50 {p['recall'][0]:.3f} ms p99 "
                f"{p['recall'][1]:.3f} ms (host clock, each ending in a device sync); launches {launches} "
                f"(K8 = {N_SHARDS} shards x {runs} sharded BM25 runs: each lane call's primary query and, "
                "where it found fewer than the fetch depth, its OR fallback)")
            out[label] = ([o.search(r) for r in reqs], *_orch_lanes(o, reqs))
        finally:
            o.close()
    engine_cache.clear()
    results["K8"]["orch_sharded"] = _k8_call_case(phase, k8_args["candidate_scores_pallas"],
                                                  k8_args["candidate_scores_pallas kwargs"])
    flat, two = out["4 shards"], out["2 x 2"]
    check(all(_hit_keys(a) == _hit_keys(c) for a, c in zip(flat[0], two[0])) and flat[1] == two[1]
          and flat[2] == two[2], f"{phase}: the 2 x 2 mesh answers differently from the flat 4-shard mesh")
    # the BM25 lane against the unsharded reopen (one device, the exact lane)
    o = MemoryOrchestrator(path, emb, OrchestratorConfig(), readonly=True, device=dev)
    try:
        bm_one, _ = _orch_lanes(o, reqs)
        state = {key: a.copy() for key, a in o.engine.vector.builder.state_arrays().items()}
    finally:
        o.close()
    engine_cache.clear()
    sharded_engine_check(phase, dev, devs, state, reqs)
    d_one = _bm25_lanes_near(phase, "BM25 (4 shards, K8) vs unsharded", [r.query for r in reqs], flat[1], bm_one)
    # the fused top-10 against a CPU orchestrator of the same config over the same file,
    # its sharded BM25 lane on K8's plain twin (what `auto` picks on the card)
    cpu = MemoryOrchestrator(path, emb, OrchestratorConfig(sharded_lanes=True), readonly=True, device=["cpu"] * N_SHARDS)
    try:
        with bm25_lane_as_on_card():
            answers_cpu = [cpu.search(r) for r in reqs]
            bm_cpu, vec_cpu = _orch_lanes(cpu, reqs)
            _lanes_agree(phase, "BM25 (card vs CPU)", [r.query for r in reqs], flat[1], bm_cpu)
            vec = _vector_lanes_agree(phase, "vector", reqs, flat[2], vec_cpu, cpu.engine.vector.snapshot())
            fdiff = _fused_agree(phase, "orch_sharded", cpu, reqs, flat[0], answers_cpu, flat[2], vec_cpu)
    finally:
        cpu.close()
    engine_cache.clear()
    equal = (len(reqs) - fdiff) / len(reqs)
    check(equal >= ORCH_FUSED_FLOOR, f"{phase}: fused top-10 equal on {100 * equal:.1f}% of queries, under the floor "
          f"{100 * ORCH_FUSED_FLOOR:.0f}%")
    log(phase, f"checks ({len(reqs)} searches): 2 x 2 answers, BM25 and vector lanes equal to the flat mesh's; the "
        f"sharded BM25 lane against the unsharded reopen: scores within rtol 1e-6, ids equal on "
        f"{len(reqs) - d_one} (the rest near-tie swaps); against a CPU orchestrator over 4 CPU shards (its BM25 lane "
        f"on K8's plain twin): BM25 lanes equal, vector lanes equal on {len(reqs) - vec['differ']} (id overlap "
        f"{vec['overlap']:.4f}), fused top-10 equal on {len(reqs) - fdiff} ({100 * equal:.1f}%, floor "
        f"{100 * ORCH_FUSED_FLOOR:.0f}%); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return total


def sharded_engine_check(phase, dev, devs, state, reqs) -> None:
    """`make_vector_engine("sharded", mesh=...)` over a dense builder's vectors
    (`state`: its state arrays) on 4 shards over `devs`: the snapshot's added device
    memory per card against that card's shards; its answers to `reqs`' embeddings
    against the same engine on one shard; its `sharded` segment loaded on the 2 x 2
    mesh, bit for bit; an added row as a new generation; B 1 search p50."""
    import numpy as np
    import torch

    from wax_tpu_torch.orchestrator.serialization import deserialize_vector_engine, serialize_vector_engine
    from wax_tpu_torch.parallel.mesh import data_mesh, make_two_level_mesh
    from wax_tpu_torch.search.vector_engines import make_vector_engine

    live = state["active"] & (state["frame_ids"] >= 0)
    fids, vecs = state["frame_ids"][live], state["emb"][live]
    mesh4, mesh22 = data_mesh(devs), make_two_level_mesh(2, devices=devs)
    eng = make_vector_engine("sharded", dim=vecs.shape[1], mesh=mesh4)
    one = make_vector_engine("sharded", dim=vecs.shape[1], device=dev)
    for e in (eng, one):
        e.add_batch(fids, vecs)
    cards = sorted(set(devs), key=str)
    for c in cards:
        torch.cuda.synchronize(c)
    before = {c: torch.cuda.memory_allocated(c) for c in cards}
    t0 = time.perf_counter()
    snap = eng.snapshot()
    for c in cards:
        torch.cuda.synchronize(c)
    t_snap = time.perf_counter() - t0
    held = {c: torch.cuda.memory_allocated(c) - before[c] for c in cards}
    shard_bytes = sum(t.numel() * t.element_size() for t in snap.shard(0))
    for c in cards:
        mine = sum(1 for x in mesh4.shard_devices if x == c)
        check(held[c] <= mine * (shard_bytes + (1 << 20)), f"{phase}: the sharded engine's snapshot holds {held[c]} "
              f"bytes on {c}, more than its {mine} shard(s) of {shard_bytes}")
    qv = np.stack([np.asarray(r.embedding, np.float32) for r in reqs])
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    v4, f4 = eng.search(qv, 10)
    v1, f1 = one.search(qv, 10)
    check(v4.shape == (len(qv), 10) and bool(np.isfinite(v4).all()) and bool((f4 >= 0).all()),
          f"{phase}: the sharded engine's answers are malformed")
    differ = _near_tie_agree(phase, "sharded engine, 4 shards vs one", v4, f4, v1, f1)
    blob, attrs = serialize_vector_engine(eng)
    e22 = deserialize_vector_engine(blob, attrs, device=dev, mesh=mesh22)
    check(e22.kind == "sharded" and e22.mesh == mesh22, f"{phase}: the sharded segment loaded as {e22.kind} on "
          f"{getattr(e22, 'mesh', None)}")
    v22, f22 = e22.search(qv, 10)
    check(np.array_equal(v22, v4) and np.array_equal(f22, f4), f"{phase}: the sharded segment on 2 x 2 answers "
          "otherwise than the engine on 4 shards")
    lat = {}
    for label, e in (("4 shards", eng), ("one shard", one)):
        lat[label] = []
        for i in range(len(qv)):  # `search` returns numpy: each call ends in a sync
            t1 = time.perf_counter()
            e.search(qv[i:i + 1], 10)
            lat[label].append((time.perf_counter() - t1) * 1e3)
    n_snap, new_id = eng.snapshot_count, int(fids.max()) + 1
    x = np.random.default_rng(7).standard_normal((1, vecs.shape[1])).astype(np.float32)
    x /= np.linalg.norm(x)
    eng.add_batch(np.array([new_id]), x)
    v, f = eng.search(x, 1)
    check(int(f[0, 0]) == new_id and eng.snapshot_count == n_snap + 1,
          f"{phase}: the sharded engine's next generation answered {f[0, 0]} (snapshots {eng.snapshot_count})")
    log(phase, f"make_vector_engine(\"sharded\") over the store's {len(fids)} x {vecs.shape[1]} vectors on 4 shards "
        f"({snap.local_rows} rows, {shard_bytes} bytes a shard, {snap.emb[0].dtype}): snapshot {t_snap:.3f} s, adding "
        + ", ".join(f"{held[c]} bytes on {c}" for c in cards) + f"; B {len(qv)} k 10 against one shard: scores within "
        f"rtol 1e-6, ids equal on {len(qv) - differ} (the rest near-ties); its segment on 2 x 2 bit-equal; an added "
        f"row found by the next search (a new snapshot); B 1 search p50 {np.percentile(lat['4 shards'], 50):.3f} ms "
        f"on 4 shards, {np.percentile(lat['one shard'], 50):.3f} ms on one (host clock, {len(qv)} calls)")


# -------------------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed for all generated data")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    # [train]'s resume check runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's fixed workspace; it is read when cuBLAS starts, so it is set first
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev, smi = device_phase()
    sys.path.insert(0, str(REPO))
    import wax_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    lex_job = start_engine_1m_lex(Path(tempfile.mkdtemp(prefix="wax-engine-1m-")), args.seed)
    try:
        return _main_phases(args, dev, smi, t_start, lex_job)
    finally:
        if lex_job[1].poll() is None:  # a phase before [engine_1m] failed
            lex_job[1].kill()
            lex_job[1].communicate()
        shutil.rmtree(lex_job[0], ignore_errors=True)


def _main_phases(args, dev, smi, t_start, lex_job) -> int:
    build_phase()
    hnsw_job = start_hnsw_build(dev, args.seed)  # [hnsw_100k]'s host build, beside the phases before it
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
    path_a = engine_1m_phase(dev, args.seed, results, lex_job)
    torch.cuda.empty_cache()
    kept = {}
    path_b = hybrid_1m_phase(dev, results, keep=kept)
    torch.cuda.empty_cache()
    path_bs = hybrid_1m_sharded_phase(dev, kept)
    kept.clear()
    torch.cuda.empty_cache()
    path_c = exact_30k_phase(dev, args.seed, results)
    torch.cuda.empty_cache()
    path_d = ivf_1m_phase(dev, args.seed, results, keep=kept)
    torch.cuda.empty_cache()
    shard_10m_phase(dev, args.seed, kept)
    kept.clear()
    torch.cuda.empty_cache()
    path_e = auto_2m_phase(dev, args.seed, results)
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="wax-orch-100k-"))
    try:
        path_f = orch_100k_phase(dev, args.seed, results, tmp)
        torch.cuda.empty_cache()
        path_m = orch_maint_phase(dev, args.seed, results, tmp, path_f["queries"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    path_g = hnsw_100k_phase(dev, args.seed, results, hnsw_job)
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="wax-orch-hnsw-"))
    try:
        path_h = orch_hnsw_phase(dev, args.seed, tmp)
        torch.cuda.empty_cache()
        path_mh = orch_maint_hnsw_phase(dev, args.seed, tmp, path_h)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="wax-train-"))
    store = None
    try:
        store = start_mcp_store(tmp, args.seed, dev)  # [mcp]'s store, built beside [train]
        path_t = train_phase(dev, args.seed, results, tmp)
        torch.cuda.empty_cache()
        path_p = mcp_phase(dev, args.seed, tmp, store)
        torch.cuda.empty_cache()
        path_os = orch_sharded_phase(dev, args.seed, store[0], results)
    finally:
        if store is not None and store[1].poll() is None:
            store[1].kill()
            store[1].communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    launches["K1"] += (path_f["K1"] + path_m["K1"] + path_mh["K1"] + path_t["K1"] + path_p["K1"] + path_bs["K1"]
                       + path_os["K1"])
    launches["K2"] += path_g["K2"]
    launches["K3"] = path_a["K3"] + path_b["K3"] + path_f["K3"] + path_bs["K3"]
    launches["K4"] = path_a["K4"] + path_b["K4"] + path_bs["K4"]
    for kern in ("K6", "K7"):
        launches[kern] = path_a[kern] + path_b[kern] + path_d[kern] + path_e[kern] + path_bs[kern]
    launches["K5"] = path_a["K5"]
    launches["K8"], launches["K9"] = path_c["K8"] + path_os["K8"], path_c["K9"]

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
                                       "auto_2m_flat", "orch_b1", "orch_maint", "hnsw_100k", "train_eval",
                                       "orch_sharded") if key in r},
        })
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
