#!/usr/bin/env python3
"""Build variants of the port's K1 and K2 kernels (wax_tpu_torch/csrc/flat_scan.cu) and
time them against the built kernels on one NVIDIA GPU.

    python3 scripts/k1_variants.py [--out DIR] [--extra NAME=DIR ...]

Each variant is a copy of flat_scan.cu (with its headers) with one thing changed: the
warp roles and CTAs per SM (selector warps over two score buffers, or consumers that
select between their products with two CTAs sharing an SM), the number of producer
warps, the ring's depth, or the selection as K9 runs it (every block with more than
three winners sorts all 128 keys). Ablations (`abl_*`) leave parts out to time the rest:
products alone (no copies, no selection), copies alone (no products, no selection),
selection alone (no copies, no products: the consumers hand the selection hashed
scores, which the selection treats like random data), and copies plus products (no
selection). `--extra NAME=DIR` adds another flat_scan.cu as it stands in DIR (with the
headers beside it; for example a parent commit's, unpacked with git archive into a
git-ignored directory), called with that source's own C signature. Each is built with
nvcc into its own library under DIR (default wax_tpu_torch/_build/k1_variants), checked
bit for bit against the plain twins on exact-arithmetic data (except the ablations, which
compute something else), and timed with CUDA events on random unit vectors at the slice
shape (131,072 x 384, B 256, k 24, f32; K1 also in bf16), at exact_30k's capacity
(32,768, k 24) and at the headline shape (10,240, k 10), beside the built K1 and K2 and
torch.matmul f32. The built kernels are also timed with the cluster split forced to 1,
2, 4 and 8 at 10,240 and 32,768 rows. ptxas's registers and spills are printed per
variant. Times move by a few percent with their place in a run: compare within one run.
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
HEADERS = ("flat_scan_keys.cuh", "tf32x3_tile.cuh")
FILL = ("      fill_stage<T>(ring + k * S::ELEMS, &full[k], qb, nq, eb + (size_t)(s / nk) * BN * D, D, (s % nk) * BK, "
        "vec != 0, p);\n")
PRODUCTS = "      tf32x3::mma_stage(ring + k * S::ELEMS, acc, wm, wn, lane);\n"
SELECT = "      merge_rows<Key, true>(sc, SC_LD, lists, KP, K, r0, nr, c0 + j * BN, lane);\n"
# The selector arrangement ("sel"): SELECTORS warps beside the consumers merge block j
# from one of two score buffers while the consumers take block j + 1's products, the
# buffers handed over by mbarriers (sc_full, sc_empty); consumers no longer select.
SEL_EDITS = [
    ("constexpr int WARPS = CONSUMERS + PRODUCERS;",
     "constexpr int SELECTORS = {sel};\nconstexpr int WARPS = CONSUMERS + SELECTORS + PRODUCERS;"),
    ("sizeof(float) * BQ * SC_LD + key_bytes * BQ * KP +\n         sizeof(uint64_t) * 2 * STAGES;",
     "sizeof(float) * BQ * SC_LD * 2 + key_bytes * BQ * KP +\n         sizeof(uint64_t) * (2 * STAGES + 4);"),
    ("  KT* lists = reinterpret_cast<KT*>(sc + BQ * SC_LD);              // [BQ][KP]\n",
     "  KT* lists = reinterpret_cast<KT*>(sc + 2 * BQ * SC_LD);\n"),
    ("  uint64_t* empty = full + STAGES;\n",
     "  uint64_t* empty = full + STAGES;\n  uint64_t* sc_full = empty + STAGES;\n  uint64_t* sc_empty = sc_full + 2;\n"),
    ('    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n  }\n  for (int i',
     "    for (int b = 0; b < 2; ++b) {\n      mbar_init(&sc_full[b], CONSUMERS * 32);\n"
     "      mbar_init(&sc_empty[b], SELECTORS * 32);\n    }\n"
     '    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n  }\n  for (int i'),
    ("  if (warp >= CONSUMERS) {  // producers\n    const int p = threadIdx.x - CONSUMERS * 32;",
     "  if (warp >= CONSUMERS + SELECTORS) {\n    const int p = threadIdx.x - (CONSUMERS + SELECTORS) * 32;"),
    ("  } else {  // consumers\n",
     "  } else if (warp >= CONSUMERS) {\n"
     "    constexpr int QS = BQ / SELECTORS;\n"
     "    const int r0 = (warp - CONSUMERS) * QS, nr = max(0, min(QS, nq - r0));\n"
     "    for (int j = 0; j < nblocks; ++j) {\n"
     "      mbar_wait(&sc_full[j & 1], (j >> 1) & 1);\n"
     "      merge_rows<Key, true>(sc + (j & 1) * BQ * SC_LD, SC_LD, lists, KP, K, r0, nr, c0 + j * BN, lane);\n"
     "      mbar_arrive(&sc_empty[j & 1]);\n"
     "    }\n"
     "  } else {\n"),
    ("      tf32x3::store_scores(acc, bias + row0 + (size_t)j * BN, sc, SC_LD, wm, wn, lane);\n"
     "      consumers_sync();  // the block's scores are in sc\n" + SELECT +
     "      consumers_sync();  // sc may be written again\n",
     "      if (j >= 2) mbar_wait(&sc_empty[j & 1], ((j >> 1) - 1) & 1);\n"
     "      tf32x3::store_scores(acc, bias + row0 + (size_t)j * BN, sc + (j & 1) * BQ * SC_LD, SC_LD, wm, wn, lane);\n"
     "      mbar_arrive(&sc_full[j & 1]);\n"),
]
# the consumers' stand-in for products in "abl_selection": hashed scores in [0, 1)
HASHED = """      {
        unsigned h = (unsigned)s * 2654435761u ^ threadIdx.x * 40503u ^ (blockIdx.z * 97u + blockIdx.y * 31u + blockIdx.x);
#pragma unroll
        for (int mt = 0; mt < tf32x3::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < tf32x3::NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              h = h * 1664525u + 1013904223u;
              acc[mt][nt][i] = (float)(h >> 8) * (1.0f / 16777216.0f);
            }
      }
"""
# name: (selector warps (0: the consumers select), PRODUCERS, STAGES, MIN_CTAS, changes).
# "fullsort": merge_rows as K9 runs it (every block with more than three winners sorts
# all 128 keys). Ablations ("abl_") compute something else: "nocopy" copies nothing into
# the ring, "noproducts" takes no products, "hashed" hands the selection hashed scores
# in place of products, "nosel" selects nothing.
VARIANTS = {
    "cta2_p4_s2": (0, 4, 2, 2, ""),
    "cta2_p4_s2_fullsort": (0, 4, 2, 2, "fullsort"),
    "cta2_p3_s2": (0, 3, 2, 2, ""),
    "cta2_p2_s2": (0, 2, 2, 2, ""),
    "sel4_p4_s3": (4, 4, 3, 1, ""),
    "sel8_p4_s3": (8, 4, 3, 1, ""),
    "abl_products": (0, 4, 2, 2, "nocopy+nosel"),
    "abl_copies": (0, 4, 2, 2, "noproducts+nosel"),
    "abl_selection": (0, 4, 2, 2, "nocopy+hashed"),
    "abl_copies_products": (0, 4, 2, 2, "nosel"),
    "abl_sel4_selection": (4, 4, 3, 1, "nocopy+hashed"),
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


def variant_source(selectors: int, producers: int, stages: int, min_ctas: int, changes: str) -> str:
    src = (SRC / "flat_scan.cu").read_text()
    for name, value in (("PRODUCERS", producers), ("STAGES", stages), ("MIN_CTAS", min_ctas)):
        src = _const(src, name, value)
    for old, new in SEL_EDITS if selectors else ():
        src = _sub(src, old, new.replace("{sel}", str(selectors)))
    for part in filter(None, changes.split("+")):
        if part == "nocopy":
            src = _sub(src, FILL, "      mbar_arrive(&full[k]);\n")
        elif part == "noproducts":
            src = _sub(src, PRODUCTS, "")
        elif part == "hashed":
            src = _sub(src, PRODUCTS, HASHED)
        elif part == "nosel":
            src = _sub(src, SELECT, "")
        elif part == "fullsort":
            src = _sub(src, "merge_rows<Key, true>", "merge_rows<Key>")
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "wax_tpu_torch" / "_build" / "k1_variants"))
    ap.add_argument("--extra", action="append", default=[], help="NAME=DIR holding another flat_scan.cu")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from wax_tpu_torch.ops import flat_scan as fs
    from wax_tpu_torch.ops._build import _SIGNATURES, _nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sources = {name: (variant_source(*spec), SRC) for name, spec in VARIANTS.items()}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = ((Path(path) / "flat_scan.cu").read_text(), Path(path))
    out = Path(args.out)
    jobs = {}
    for name, (text, hdr_dir) in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flat_scan.cu").write_text(text)
        for h in HEADERS:
            if (hdr_dir / h).exists():
                (d / h).write_text((hdr_dir / h).read_text())
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-shared", "-o", str(d / "lib.so"), str(d / "flat_scan.cu")]
        jobs[name] = (d, "int split" in text, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                                text=True))
    kernels = {}
    for name, (d, has_split, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            return 1
        usage = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln and "registers" in ln]
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
        print(f"{name}: ptxas {usage} {spills}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fns = {}
        for entry in ("wax_k1_packed_sel", "wax_k2_scan_topk"):
            fn = getattr(lib, entry)
            sig = _SIGNATURES[entry]
            fn.argtypes, fn.restype = (sig if has_split else sig[:-2] + sig[-1:]), ctypes.c_int
            fns[entry] = fn
        kernels[name] = (fns, has_split)

    def run(name, kern, q, e, bias, k, tn):
        fns, has_split = kernels[name]
        b, (n, d) = q.shape[0], e.shape
        split = (fs.scan_plan(b, n, tn, k, torch.cuda.get_device_properties(0).multi_processor_count)["split"],) \
            if has_split else ()
        bf16, stream = int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream
        if kern == "K1":
            res = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
            err = fns["wax_k1_packed_sel"](q.data_ptr(), e.data_ptr(), bias.data_ptr(), res.data_ptr(), b, n, d, tn,
                                           k, bf16, *split, stream)
        else:
            res = (torch.empty((b, n // tn * k), dtype=torch.float32, device=q.device),
                   torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device))
            err = fns["wax_k2_scan_topk"](q.data_ptr(), e.data_ptr(), bias.data_ptr(), res[0].data_ptr(),
                                          res[1].data_ptr(), b, n, d, tn, k, bf16, *split, stream)
        if err:
            raise RuntimeError(f"{name} {kern} launch failed: CUDA error {err}")
        return res

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

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    b, d, tn = 256, 384, 2048
    # label, rows, k, dtype, kernels timed
    shapes = [("slice 131072x384 B=256 k=24 f32", 131072, 24, torch.float32, ("K1", "K2")),
              ("exact_30k 32768x384 B=256 k=24 f32", 32768, 24, torch.float32, ("K1", "K2")),
              ("headline 10240x384 B=256 k=10 f32", 10240, 10, torch.float32, ("K1", "K2")),
              ("slice 131072x384 B=256 k=24 bf16", 131072, 24, torch.bfloat16, ("K1",))]
    built = {"K1": fs.packed_sel_tiles, "K2": fs.scan_topk_tiles}
    plain = {"K1": fs._packed_sel_topk_plain, "K2": fs._scan_topk_plain}
    for label, n, k, dt, kerns in shapes:
        qx = (torch.randint(-8, 9, (b, d), generator=g) / 8.0).to(dev, dt).contiguous()
        ex = (torch.randint(-8, 9, (n, d), generator=g) / 8.0).to(dev, dt).contiguous()
        q = fs.normalize_rows(torch.randn((b, d), generator=g)).to(dev, dt).contiguous()
        e = fs.normalize_rows(torch.randn((n, d), generator=g)).to(dev, dt).contiguous()
        bias = torch.zeros(n, device=dev)
        for kern in kerns:
            want = plain[kern](qx, ex, bias, k, tn)
            parts = [f"built {kern} {ms(lambda: built[kern](q, e, bias, k, tn)):.4f}"]
            for name in kernels:
                if not name.startswith("abl_") and not same(run(name, kern, qx, ex, bias, k, tn), want):
                    print(f"{label} {kern} {name}: differs from the plain twin on exact data", flush=True)
                    return 1
                parts.append(f"{name} {ms(lambda: run(name, kern, q, e, bias, k, tn)):.4f}")
            parts.append(f"built {kern} {ms(lambda: built[kern](q, e, bias, k, tn)):.4f}")
            parts.append(f"torch.matmul f32 {ms(lambda: torch.matmul(q.float(), e.float().t())):.4f}")
            print(f"{label} {kern} (ms): " + "; ".join(parts), flush=True)
            if n in (10240, 32768) and dt == torch.float32:
                forced = []
                for split in (1, 2, 4, 8):
                    if not same(built[kern](qx, ex, bias, k, tn, split), want):
                        print(f"{label} {kern} split {split}: differs from the plain twin on exact data", flush=True)
                        return 1
                    forced.append(f"S {split} {ms(lambda: built[kern](q, e, bias, k, tn, split)):.4f}")
                print(f"{label} {kern} split forced (ms; plan S {fs.launch_plan(b, n, tn, k)['split']}): "
                      + "; ".join(forced), flush=True)
        del qx, ex, q, e
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
