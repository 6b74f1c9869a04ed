#!/usr/bin/env python3
"""Build variants of the port's K6 kernel (wax_tpu_torch/csrc/chunkmax.cu) and time
them against the built K6 on one NVIDIA GPU.

    python3 scripts/k6_variants.py [--out DIR] [--extra NAME=PATH ...] [--profile]

Each variant is a copy of chunkmax.cu with one thing changed in its bf16 tensor-core
path: the depth (BK) and number (STAGES) of the `cp.async` ring's stages, or 128
queries per CTA in place of 256 at B 256 (the corpus then leaves device memory twice
per batch). Variants named `*_prof` also read clock64 counters: a consumer thread's
cycles in all and waiting for a full stage, and the producer's cycles waiting for an
empty one. Ablations (`abl_*`) leave a part out to time the rest: the copies, the
products, or the query rows' copies. `--extra NAME=PATH` adds another chunkmax.cu as it stands (for example a
parent commit's, unpacked with git archive), built and timed the same way. Each is built
with nvcc into its own library under DIR (default wax_tpu_torch/_build/k6_variants),
checked bit for bit against the plain twin on exact-arithmetic data, and timed with
CUDA events on random unit vectors at the serving shapes (1,048,576 x 384 and x 768
bf16, B 256), beside the built K6 and torch.matmul bf16; ptxas's registers and spills
are printed per variant. `--profile` also counts the K6 device events that
torch.profiler records in windows of 1 and 3 launches.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "wax_tpu_torch" / "csrc" / "chunkmax.cu"
PLAN = "cudaError_t plan(int B, int NC, MmaPlan& p) { return B > Tile<1>::BQ ? plan_mma<2>(B, NC, p) : plan_mma<1>(B, NC, p); }"
PLAN_128 = "cudaError_t plan(int B, int NC, MmaPlan& p) { return plan_mma<1>(B, NC, p); }"
FILL_START = "  if (vec) {\n    constexpr int CPR = BK / 8, RSTEP"
PRODUCTS = "      uint32_t a[MT][4];\n"
QUERY_COPY = "      cp_async16(dst, r < nq ? src : q, r < nq ? 16 : 0);\n"
CONSUMER_START = "  const int g = lane >> 2, t = lane & 3;\n"
FULL_WAIT = "    mbar_wait(&full[k], (s / STAGES) & 1);\n"
CONSUMER_END = "    mbar_arrive(&empty[k]);  // after the epilogue: the producer may refill the bias slot too\n  }\n}"
EMPTY_WAIT = "      if (s >= STAGES) mbar_wait(&empty[k], (s / STAGES - 1) & 1);  // slice s - STAGES is read\n"
PRODUCER_END = "    return;\n  }\n"
PROF_COUNTERS = ("// summed over CTAs: consumer thread 0's cycles in all and waiting for a full stage,\n"
                 "// producer thread 0's cycles waiting for an empty stage\n"
                 "__device__ unsigned long long prof_cycles[3];\n")
PROF_READ = """
extern "C" int read_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, prof_cycles, sizeof(prof_cycles));
  const unsigned long long z[3] = {0, 0, 0};
  cudaMemcpyToSymbol(prof_cycles, z, sizeof(z));
  return (int)e;
}
"""
# name: (depth per stage BK, STAGES, change). Ablations ("abl_") compute something else:
# "noload" copies nothing into the ring (products and epilogues only), "nomma" takes
# no products (copies and epilogues only), "noquery" copies no query rows (the corpus
# part of the copies only). Not ablations: "rot" starts chunk c's depth slices at slice
# c % (D / BK), so CTAs working at the same time read different query slices; "qrep4"
# reads the queries from QREP copies of them (the script passes the copies), CTA x
# from copy x % QREP: both spread the query block's L2 lines over more of L2.
VARIANTS = {
    "bk64_s2": (64, 2, ""),
    "bk64_s3": (64, 3, ""),
    "bk64_s4": (64, 4, ""),
    "bk128_s2": (128, 2, ""),
    "bk64_s3_bq128": (64, 3, "bq128"),
    "bk64_s3_rot": (64, 3, "rot"),
    "bk64_s3_qrep4": (64, 3, "qrep4"),
    "bk64_s3_prof": (64, 3, "prof"),
    "abl_bk64_s3_noload": (64, 3, "noload"),
    "abl_bk64_s3_nomma": (64, 3, "nomma"),
    "abl_bk64_s3_rot_nomma": (64, 3, "rot+nomma"),
    "abl_bk64_s3_qrep4_nomma": (64, 3, "qrep4+nomma"),
    "abl_bk64_s3_noquery": (64, 3, "noquery"),
}
QREP = 4  # query copies for "qrep4": CTA x reads copy x % QREP
SLICE = "      const int k = s % STAGES, j = s / nk, d0 = (s % nk) * BK;\n"
QBASE = "    const uint16_t* qb = q + (size_t)q0 * D;\n"
N, B = 1_048_576, 256


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"variant edit does not apply: {old!r}")
    return text.replace(old, new)


def variant_source(bk: int, stages: int, change: str) -> str:
    src = SRC.read_text()
    src = re.sub(r"constexpr int BK = \d+;", f"constexpr int BK = {bk};", src, count=1)
    src = re.sub(r"constexpr int STAGES = \d+;", f"constexpr int STAGES = {stages};", src, count=1)
    for part in change.split("+"):
        src = _apply(src, part)
    return src


def _apply(src: str, change: str) -> str:
    if change == "":
        pass
    elif change == "bq128":
        src = _sub(src, PLAN, PLAN_128)
    elif change == "rot":
        src = _sub(src, SLICE, "      const int k = s % STAGES, j = s / nk;\n"
                   "      const int d0 = (int)((s % nk + (blockIdx.x + (size_t)j * G) % nk) % nk) * BK;\n")
    elif change == "qrep4":
        src = _sub(src, QBASE, f"    const uint16_t* qb = q + ((size_t)(blockIdx.x % {QREP}) * B + q0) * D;\n")
    elif change == "noload":
        src = _sub(src, FILL_START, "  if (d0 >= 0) {\n    mbar_arrive(full);\n    return;\n  }\n" + FILL_START)
    elif change == "nomma":
        src = _sub(src, PRODUCTS, PRODUCTS + "      if (kk >= 0) continue;\n")
    elif change == "noquery":
        src = _sub(src, QUERY_COPY, "      ;\n")
    elif change == "prof":  # clock64 counters
        src = _sub(src, "}  // namespace\n", "}  // namespace\n" + PROF_READ)
        src = _sub(src, "template <int MT>\n__global__", PROF_COUNTERS + "template <int MT>\n__global__")
        src = _sub(src, CONSUMER_START, CONSUMER_START + "  const long long t_start = clock64();\n  long long t_wait = 0;\n")
        src = _sub(src, FULL_WAIT, "    const long long tw = clock64();\n" + FULL_WAIT + "    t_wait += clock64() - tw;\n")
        src = _sub(src, CONSUMER_END, CONSUMER_END[:-1] +
                   "  if (threadIdx.x == 0) {\n"
                   "    atomicAdd(&prof_cycles[0], (unsigned long long)(clock64() - t_start));\n"
                   "    atomicAdd(&prof_cycles[1], (unsigned long long)t_wait);\n  }\n}")
        src = _sub(src, "    for (int s = 0; s < total; ++s) {\n      const int k = s % STAGES, j = s / nk",
                   "    long long t_empty = 0;\n"
                   "    for (int s = 0; s < total; ++s) {\n      const int k = s % STAGES, j = s / nk")
        src = _sub(src, EMPTY_WAIT, "      const long long te = clock64();\n" + EMPTY_WAIT + "      t_empty += clock64() - te;\n")
        src = _sub(src, PRODUCER_END, "    if (p == 0) atomicAdd(&prof_cycles[2], (unsigned long long)t_empty);\n" + PRODUCER_END)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "wax_tpu_torch" / "_build" / "k6_variants"))
    ap.add_argument("--extra", action="append", default=[], help="NAME=PATH of another chunkmax.cu")
    ap.add_argument("--profile", action="store_true", help="count K6 events under torch.profiler")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from wax_tpu_torch.ops import chunkmax_scan as cm
    from wax_tpu_torch.ops._build import _SIGNATURES, _nvcc
    from wax_tpu_torch.ops.flat_scan import normalize_rows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sources = {name: variant_source(*spec) for name, spec in VARIANTS.items()}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    out = Path(args.out)
    jobs = {}
    for name, text in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "chunkmax.cu").write_text(text)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-shared", "-o", str(d / "lib.so"), str(d / "chunkmax.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels, profs = {}, {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            return 1
        usage = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(f"{name}: ptxas {usage} {spills}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.wax_k6_chunk_maxima
        fn.argtypes, fn.restype = _SIGNATURES["wax_k6_chunk_maxima"], ctypes.c_int
        kernels[name] = fn
        if name.endswith("_prof"):
            lib.read_prof.argtypes, lib.read_prof.restype = [ctypes.c_void_p], ctypes.c_int
            profs[name] = lib.read_prof

    def run(fn, q, e, bias, b=B):  # q: [b, d], or QREP copies of it stacked for "qrep" variants
        d, n = q.shape[1], e.shape[0]
        cmax = torch.empty((b, n // 128), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), e.data_ptr(), bias.data_ptr(), cmax.data_ptr(), b, n, d, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return cmax

    def ms(f, iters=20):
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

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for d in (384, 768):
        ex = (torch.randint(-8, 9, (N, d), generator=g, device=dev, dtype=torch.int8).to(torch.bfloat16) / 8)
        qx = (torch.randint(-8, 9, (B, d), generator=g, device=dev, dtype=torch.int8).to(torch.bfloat16) / 8)
        bias = torch.zeros(N, device=dev)
        bias[N - 1000:] = cm.NEG_INF
        want = cm._chunk_maxima_plain(qx, ex, bias)
        e = normalize_rows(torch.randn((N, d), generator=g, device=dev)).to(torch.bfloat16)
        q = normalize_rows(torch.randn((B, d), generator=g, device=dev)).to(torch.bfloat16)
        ref = cm._chunk_maxima_plain(q, e, bias)
        parts = [f"built K6 {ms(lambda: cm.chunk_maxima(q, e, bias)):.4f}"]
        for name, fn in kernels.items():
            rep = QREP if "qrep" in name else 1
            qv, qxv = q.repeat(rep, 1), qx.repeat(rep, 1)
            if name.startswith("abl_"):
                parts.append(f"{name} {ms(lambda: run(fn, qv, e, bias)):.4f}")
                continue
            if not torch.equal(run(fn, qxv, ex, bias), want):
                print(f"{N}x{d} {name}: differs from the plain twin on exact data", flush=True)
                return 1
            parts.append(f"{name} {ms(lambda: run(fn, qv, e, bias)):.4f} "
                         f"(max_abs_err {float((run(fn, qv, e, bias) - ref).abs().max()):.3g})")
            if name in profs:
                buf = np.zeros(3, dtype=np.uint64)
                profs[name](buf.ctypes.data)
                run(fn, qv, e, bias)
                torch.cuda.synchronize()
                profs[name](buf.ctypes.data)
                ctas = cm.mma_plan(B, N)["grid_x"]
                parts.append(f"{name} cycles per CTA {buf[0] / ctas:.0f}: consumer waiting for a full stage "
                             f"{buf[1] / ctas:.0f} ({100 * buf[1] / max(buf[0], 1):.1f}%), producer waiting for "
                             f"an empty one {buf[2] / ctas:.0f} ({100 * buf[2] / max(buf[0], 1):.1f}%)")
        parts.append(f"built K6 {ms(lambda: cm.chunk_maxima(q, e, bias)):.4f}")
        parts.append(f"torch.matmul bf16 {ms(lambda: torch.matmul(q, e.t())):.4f}")
        print(f"{N}x{d} bf16 B={B} (ms): " + "; ".join(parts), flush=True)
        del e, q, ref, want, ex, qx
        torch.cuda.empty_cache()

    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        e = normalize_rows(torch.randn((N, 384), generator=g, device=dev)).to(torch.bfloat16)
        q = normalize_rows(torch.randn((B, 384), generator=g, device=dev)).to(torch.bfloat16)
        bias = torch.zeros(N, device=dev)
        for label, f in (("chunk_maxima", lambda: cm.chunk_maxima(q, e, bias)),
                         ("chunkmax_scan_topk", lambda: cm.chunkmax_scan_topk(q.float(), e, bias, 20))):
            for iters in (1, 3):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        f()
                    torch.cuda.synchronize()
                k6 = [e_ for e_ in prof.events() if e_.device_type == DeviceType.CUDA and "k6_chunk" in e_.name]
                print(f"profile {label} x{iters}: {len(k6)} K6 device events recorded", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
