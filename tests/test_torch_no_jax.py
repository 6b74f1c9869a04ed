"""The port stands without JAX: every wax_tpu_torch module imports with `jax` and
`flax` blocked, and none of them loads jax, flax or the wax_tpu package. chip_smoke.py,
which drives the port on a GPU, imports no JAX either, and without a CUDA device it
exits non-zero and prints no result line."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import wax_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(wax_tpu_torch.__path__, "wax_tpu_torch."))
for m in mods:
    importlib.import_module(m)
for name in wax_tpu_torch.__all__:
    getattr(wax_tpu_torch, name)
import chip_smoke
loaded = [m for m, v in sys.modules.items() if v is not None]
bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "wax_tpu")]
print(json.dumps({"mods": mods, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    expected = {
        "ops.topk", "ops.flat_scan", "ops._build", "ops.bm25", "ops.fusion",
        "index.dense", "index.lex", "search.vector_engines", "search.engine",
        "text.wordpiece", "text.unicode61_tables", "embed.provider", "embed.minilm",
        "utils.concurrency", "utils.device", "ops.bm25_candidates", "ops.bm25_rescore",
        "ops.bm25_chunked_pallas", "ops.chunkmax_scan", "ops.ivf_kernel", "parallel.mesh",
        "parallel.merge", "parallel.sharded_scan", "parallel.sharded_hybrid", "search.unified",
        "index.ivf", "index.graph", "index.graph_cpp", "ops.beam_search", "session",
        "orchestrator.serialization", "orchestrator.orchestrator",
    }
    assert {f"wax_tpu_torch.{m}" for m in expected} <= set(res["mods"])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Here there is no CUDA device: the script must fail and print no result line,
    from the repo root and from a directory holding nothing but the script."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
