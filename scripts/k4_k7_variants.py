#!/usr/bin/env python3
"""Build variants of the port's K4 and K7 kernels and time them on one NVIDIA GPU.

    python3 scripts/k4_k7_variants.py [--kernels k4,k7] [--sass] [--out DIR] [--extra NAME=DIR ...]

K4 (wax_tpu_torch/csrc/bm25_chunked.cu, 32 slots) variants are copies of the source with
one thing changed: 512 threads of 64 values in place of 1024 of 32 (`v64`), or the
stages 32 <= d < 1024 as lane shuffles on the blocked layout (`shfl`, the first
version) in place of registers of the warp-columnar layout. Ablations
(`abl_*`) leave parts out to time the rest: the gather alone, the merge alone (registers
filled from a hash, no reads), gather and merge (no column walk), and the column walk
alone (`abl_walk`: the gather reads planes that are already sorted and the merge is
skipped, so its output still equals the plain twin's).

K7 (wax_tpu_torch/csrc/ivf_kernel.cu) variants change the ring's depth or the slab's rows;
its ablations time the copies alone (no scores, no selection), copies and scores (no
selection) and the selection alone (scores from a hash, no copies).

`--extra NAME=DIR` adds another bm25_chunked.cu or ivf_kernel.cu as it stands in DIR
(for example a parent commit's, unpacked with git archive into a git-ignored directory),
called through the same C entry. Each variant is built with nvcc into its own library
under DIR (default wax_tpu_torch/_build/k4_k7_variants), checked bit for bit against the
plain twin (except ablations that compute something else), and timed with CUDA events
beside the built kernel: K4 on hybrid_1m's inputs (the bench's Zipf 0.7 postings over
1,048,576 documents, budget 3,072, 256 queries of 16 terms: 32 slots), K7 at the
slice shape (1,048,576 x 384 bf16, B 256, 20 probes of 128 rows, k 20) and at x 768
(24 probes, k 24). ptxas's registers and spills are printed per variant. Times move by a
few percent with their place in a run: compare within one run.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "wax_tpu_torch" / "csrc"
SASS = False  # --sass: print opcode counts per variant

# ------------------------------------------------------------------------------- K4

K4_GATHER = "  gather<V>(v, win + (size_t)b * 32, pk, tid);\n"
K4_MERGE = "  merge<V>(v, plane, tid);\n"
K4_WALK = "  walk<V>(plane, tid, qb, seg_log2, count_mode, sel, out_rows + o, out_keys + o);\n"
K4_KERNEL = "template <int V>\n__global__ void __launch_bounds__(N32 / V, 1)\n"
# keeps the registers live where the walk is left out: one word per thread
K4_SINK = """template <int V>
__device__ __forceinline__ void sink(const int (&v)[V], int32_t* out, int tid) {
  int h = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) h ^= v[c] * (2 * c + 1);
  out[tid] = h;
}

"""
K4_HASH = """  {
    const unsigned h0 = (unsigned)(blockIdx.x * 40503u + tid) * 2654435761u;
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = (int)((h0 ^ (c * 2246822519u)) >> 1);
  }
"""
# the stages 32 <= d < 1024 (V 32) as lane shuffles on the blocked layout, as the first
# version ran them (that version also XOR-swizzled an unpadded plane and took a
# predicated min or max per value for its runtime direction)
K4_WARP = """#pragma unroll
  for (int r = 0; r < V; ++r) v[r] = plane[wbase + r * 33] ^ flip;
#pragma unroll
  for (int s = 0; s < ilog2(V); ++s)  // warp-columnar, d = 16 V .. 32: registers r and r ^ d / 32
#pragma unroll
    for (int r = 0; r < V; ++r)
      if (!(r & (V / 2 >> s))) cas_asc(v[r], v[r | (V / 2 >> s)]);
#pragma unroll
  for (int r = 0; r < V; ++r) plane[wbase + r * 33] = v[r];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < V; ++r) v[r] = plane[bbase + r + (r >> 5)];
"""
K4_SHFL = """#pragma unroll
  for (int r = 0; r < V; ++r) v[r] = plane[bbase + r + (r >> 5)] ^ flip;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int m = 16 >> s;
    const bool keep_min = ((tid & 31) & m) == 0;
#pragma unroll
    for (int r = 0; r < V; ++r) {
      const int o = __shfl_xor_sync(0xFFFFFFFFu, v[r], m);
      v[r] = keep_min ? min(v[r], o) : max(v[r], o);
    }
  }
"""
# name: changes ("v64": 64 values a thread; "shfl": lane shuffles for 32 <= d < 1024;
# "sink": no walk, registers to a sink;
# "hash": no gather, registers from a hash; "nomerge": no merge; "presorted": the
# input is sorted already, so the merge is skipped and the columnar store kept)
K4_VARIANTS = {
    "v32": "",
    "v64": "v64",
    "shfl": "shfl",
    "abl_gather": "nomerge+sink",
    "abl_merge": "hash+sink",
    "abl_gather_merge": "sink",
    "abl_walk": "presorted",
}


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"variant edit does not apply: {old!r}")
    return text.replace(old, new)


def _const(text: str, name: str, value: int) -> str:
    out, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text, count=1)
    if n != 1:
        raise RuntimeError(f"variant edit does not apply: constexpr int {name}")
    return out


def k4_source(changes: str) -> str:
    src = (SRC / "bm25_chunked.cu").read_text()
    for part in filter(None, changes.split("+")):
        if part == "v64":
            src = _const(src, "VALUES", 64)
        elif part == "shfl":
            src = _sub(src, K4_WARP, K4_SHFL)
        elif part == "sink":
            src = _sub(src, K4_KERNEL, K4_SINK + K4_KERNEL)
            src = _sub(src, K4_WALK, "  sink<V>(v, out_keys + o, tid);\n")
        elif part == "hash":
            src = _sub(src, K4_GATHER, K4_HASH)
        elif part == "nomerge":
            src = _sub(src, K4_MERGE, "")
        elif part == "presorted":
            src = _sub(src, K4_MERGE, "  store_columnar<V>(v, plane, tid);\n  __syncthreads();\n")
    return src


# ------------------------------------------------------------------------------- K7

K7_COPY = ("          mbar_arrive_expect_tx(&full[st], bytes);\n"
           "          bulk_copy(ring + st * stage_elems, emb + ((size_t)__ldg(pr + p) * S + r0) * D, bytes, &full[st]);\n")
K7_SCORE = "      score_rows(ring + st * stage_elems, q_s, D, rows, warp, lane, vec != 0, acc);\n"
K7_SELECT = "      select_rows<KR>(acc, lv, kth, p, r0, rows, __ldg(counts + __ldg(pr + p)), S, warp, kr, kl, lane);\n"
# the consumers' stand-in for scores in "abl_selection": hashed values in [0, 1)
K7_HASH = """      {
        unsigned h = (unsigned)(j * 40503 + warp * 977 + blockIdx.x) * 2654435761u;
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          h = h * 1664525u + 1013904223u;
          acc[i] = (float)(h >> 8) * (1.0f / 16777216.0f);
        }
      }
"""
# name: (STAGES, SLAB_BYTES, changes). Ablations ("abl_") compute something else:
# "nocopy" copies nothing (the producer arrives on an empty slab), "noscore" takes no
# products, "hashed" hands the selection hashed scores, "nosel" selects nothing.
K7_VARIANTS = {
    "s2_24k": (2, 24576, ""),
    "s4_24k": (4, 24576, ""),
    "s3_24k": (3, 24576, ""),
    "s6_24k": (6, 24576, ""),
    "s4_12k": (4, 12288, ""),
    "s8_12k": (8, 12288, ""),
    "s3_48k": (3, 49152, ""),
    "abl_copies": (2, 24576, "noscore+nosel"),
    "abl_copies_scores": (2, 24576, "nosel"),
    "abl_selection": (2, 24576, "nocopy+hashed"),
}


def k7_source(spec) -> str:
    stages, slab, changes = spec
    src = _const((SRC / "ivf_kernel.cu").read_text(), "STAGES", stages)
    src = _const(src, "SLAB_BYTES", slab)
    for part in filter(None, changes.split("+")):
        if part == "nocopy":
            src = _sub(src, K7_COPY, "          mbar_arrive(&full[st]);\n")
        elif part == "noscore":
            src = _sub(src, K7_SCORE, "      float acc[ROWS_PER_WARP] = {};\n")
            src = _sub(src, "      float acc[ROWS_PER_WARP];\n      float acc", "      float acc")
        elif part == "hashed":
            src = _sub(src, K7_SCORE, K7_HASH)
        elif part == "nosel":
            src = _sub(src, K7_SELECT, "      if (acc[0] == 1234.5f) kth = 1ull;\n")
    return src


# ------------------------------------------------------------------ build and time


def print_ptxas(label: str, log: str, fragments=("k4_", "k7_")) -> None:
    """Registers and spill bytes of each K4/K7 kernel in an nvcc -Xptxas=-v log."""
    import chip_smoke

    for fn, (regs, st, ld) in chip_smoke.ptxas_functions(log).items():
        if any(f in fn for f in fragments):
            print(f"{label}: {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads", flush=True)


def print_sass(label: str, lib: Path, nvcc: str, fragments=("k4_", "k7_"), top: int = 14) -> None:
    """The commonest SASS opcodes (static counts) of each K4/K7 kernel in a library."""
    from collections import Counter

    text = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if m := re.search(r"Function : (\S+)", ln):
            cur = m.group(1) if any(f in m.group(1) for f in fragments) else None
            if cur:
                counts[cur] = Counter()
        elif cur and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)):
            counts[cur][m.group(1)] += 1
    for fn, c in counts.items():
        print(f"{label}: sass {fn}: {sum(c.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in c.most_common(top)), flush=True)


def build_all(sources: dict, out: Path, fname: str, nvcc: str, fragments=("k4_", "k7_")) -> dict:
    """{name: (text, header dir)} -> {name: ctypes library}; prints ptxas per variant for
    the kernels whose names hold one of `fragments`."""
    jobs = {}
    for name, (text, hdr_dir) in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / fname).write_text(text)
        for h in hdr_dir.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-shared", "-o", str(d / "lib.so"), str(d / fname)]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print_ptxas(f"{fname} {name}", log, fragments)
        if SASS:
            print_sass(f"{fname} {name}", d / "lib.so", nvcc, fragments)
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def ms(f, iters=20):
    import torch

    for _ in range(3):
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k4_inputs(dev):
    """hybrid_1m's K4 inputs: (win [256, 32], pk, qb, seg_log2)."""
    import numpy as np
    import torch

    import chip_smoke
    from wax_tpu_torch.index.lex import PK_CHUNK
    from wax_tpu_torch.ops import bm25_chunked_pallas as ck

    lex = chip_smoke.synth_sharded_lex(chip_smoke.N_1M, 16_384, 3072, dev)
    tids = torch.from_numpy(np.random.default_rng(7).integers(0, 16_384, (256, 16)).astype(np.int32)).to(dev)
    pk = lex.pk_chunks[0]
    win = ck.pack_query_chunks(tids, lex.chunk_base[0], lex.chunk_counts[0], 32, lex.pk_max_chunks,
                               pk.shape[0] // PK_CHUNK - 1)
    return win, pk, lex.pk_qb, 5


def run_k4(libs: dict, dev) -> None:
    import torch

    from wax_tpu_torch.index.lex import PK_CHUNK
    from wax_tpu_torch.ops import bm25_chunked_pallas as ck
    from wax_tpu_torch.ops._build import _SIGNATURES

    win, pk, qb, seg = k4_inputs(dev)
    b = win.shape[0]
    # the same planes, sorted, as abl_walk reads them: odd chunks stored reversed
    plane = torch.sort(pk.reshape(-1, PK_CHUNK)[win.long()].reshape(b, -1), dim=-1).values.reshape(b, 32, PK_CHUNK)
    plane[:, 1::2] = plane[:, 1::2].flip(-1)
    pk_sorted = plane.reshape(-1).contiguous()
    win_sorted = torch.arange(b * 32, dtype=torch.int32, device=dev).reshape(b, 32)
    for lib in libs.values():
        fn = lib.wax_k4_chunked_sel
        fn.argtypes, fn.restype = _SIGNATURES["wax_k4_chunked_sel"], ctypes.c_int

    def run(name, mode, sorted_input=False):
        w, p = (win_sorted, pk_sorted) if sorted_input else (win, pk)
        rows = torch.empty((b, 3 * PK_CHUNK), dtype=torch.int32, device=dev)
        keys = torch.empty_like(rows)
        err = libs[name].wax_k4_chunked_sel(w.data_ptr(), p.data_ptr(), rows.data_ptr(), keys.data_ptr(), 0, b, 32,
                                            qb, seg, int(mode == "count"), 3, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K4 {name}: launch failed, CUDA error {err}")
        return rows, keys

    for mode in ("any", "count"):
        want = ck._chunked_sel_plain(win, pk, qb, seg, mode, 3)
        got = ck.chunked_sel(win, pk, qb=qb, seg_log2=seg, mode=mode)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"K4 built ({mode}): differs from the plain twin")
        for name in libs:
            if name.startswith("abl_") and name != "abl_walk":
                continue
            got = run(name, mode, name == "abl_walk")
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"K4 {name} ({mode}): differs from the plain twin")
    parts = [f"built {ms(lambda: ck.chunked_sel(win, pk, qb=qb, seg_log2=seg)):.4f}"]
    for name in libs:
        parts.append(f"{name} {ms(lambda: run(name, 'any', name == 'abl_walk')):.4f}")
    parts.append(f"built {ms(lambda: ck.chunked_sel(win, pk, qb=qb, seg_log2=seg)):.4f}")
    parts.append(f"plain {ms(lambda: ck._chunked_sel_plain(win, pk, qb, seg, 'any', 3), iters=5):.4f}")
    print(f"K4 hybrid_1m B={b} 16 terms 32 slots seg_log2={seg} (ms): " + "; ".join(parts), flush=True)


def run_k7(libs: dict, dev) -> None:
    import torch

    from wax_tpu_torch.ops import ivf_kernel as ivf
    from wax_tpu_torch.ops._build import _SIGNATURES
    from wax_tpu_torch.ops.flat_scan import normalize_rows

    for lib in libs.values():
        fn = lib.wax_k7_bucket_rescore
        fn.argtypes, fn.restype = _SIGNATURES["wax_k7_bucket_rescore"], ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(11)
    n, b = 1_048_576, 256
    for d, nprobe, k in ((384, 20, 20), (768, 24, 24), (384, 20, 100)):
        emb = normalize_rows(torch.randn((n, d), generator=g, device=dev)).to(torch.bfloat16).view(-1, 128, d)
        q = normalize_rows(torch.randn((b, d), generator=g, device=dev))
        ex = (torch.randint(-8, 9, (n // 128, 128, d), generator=g, device=dev) / 8.0).to(torch.bfloat16)
        qx = torch.randint(-8, 9, (b, d), generator=g, device=dev) / 8.0
        probes = torch.stack([torch.randperm(n // 128, generator=g, device=dev)[:nprobe] for _ in range(b)])
        probes = probes.to(torch.int32).contiguous()
        counts = torch.full((n // 128,), 128, dtype=torch.int32, device=dev)
        counts[-8:] = 60

        def run(name, qq, e3):
            vals = torch.empty((b, k), dtype=torch.float32, device=dev)
            pos = torch.empty((b, k), dtype=torch.int32, device=dev)
            err = libs[name].wax_k7_bucket_rescore(qq.data_ptr(), probes.data_ptr(), counts.data_ptr(), e3.data_ptr(),
                                                   vals.data_ptr(), pos.data_ptr(), b, d, 128, nprobe, k, 1,
                                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K7 {name}: launch failed, CUDA error {err}")
            return vals, pos

        want = ivf._bucket_rescore_plain(qx, probes, counts, ex, k)
        got = ivf.bucket_rescore(qx, probes, counts, ex, k)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"K7 built d {d}: differs from the plain twin on exact data")
        for name in libs:
            if not name.startswith("abl_"):
                got = run(name, qx, ex)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"K7 {name} d {d}: differs from the plain twin on exact data")
        parts = [f"built {ms(lambda: ivf.bucket_rescore(q, probes, counts, emb, k)):.4f}"]
        for name in libs:
            parts.append(f"{name} {ms(lambda: run(name, q, emb)):.4f}")
        parts.append(f"built {ms(lambda: ivf.bucket_rescore(q, probes, counts, emb, k)):.4f}")
        parts.append(f"plain {ms(lambda: ivf._bucket_rescore_plain(q, probes, counts, emb, k), iters=5):.4f}")
        print(f"K7 {n}x{d} bf16 B={b} probes={nprobe} k={k} (ms): " + "; ".join(parts), flush=True)
        del emb, ex
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="k4,k7")
    ap.add_argument("--out", default=str(REPO / "wax_tpu_torch" / "_build" / "k4_k7_variants"))
    ap.add_argument("--sass", action="store_true", help="print each kernel's commonest SASS opcodes")
    ap.add_argument("--extra", action="append", default=[],
                    help="NAME=DIR holding another bm25_chunked.cu and/or ivf_kernel.cu")
    args = ap.parse_args(argv)
    global SASS
    SASS = args.sass
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from wax_tpu_torch.ops._build import _nvcc, build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    path, _, log = build()
    print_ptxas("built", log or path.with_suffix(".log").read_text())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out, nvcc = Path(args.out), _nvcc()
    for kern in args.kernels.split(","):
        fname, variants, source, runner = {
            "k4": ("bm25_chunked.cu", K4_VARIANTS, k4_source, run_k4),
            "k7": ("ivf_kernel.cu", K7_VARIANTS, k7_source, run_k7),
        }[kern]
        sources = {name: (source(spec), SRC) for name, spec in variants.items()}
        for spec in args.extra:
            name, path = spec.split("=", 1)
            if (Path(path) / fname).exists():
                sources[name] = ((Path(path) / fname).read_text(), Path(path))
        runner(build_all(sources, out / kern, fname, nvcc), dev)
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
