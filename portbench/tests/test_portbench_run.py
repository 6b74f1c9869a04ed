"""Runs of the cells at small sizes on the CPU, through the same harness code as
on the card: discovery by name, the last line's keys, the check (sound runs pass, the
control and each fault a cell can have fail it), the CLI's refusals and the JAX guard.
The card test at the end runs the committed command on the card."""
from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import core
from portbench.tests.portbench_tiny import OVERRIDES, SEED, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = core.load_json(core.BENCH_FILE)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_file_names_files_that_exist():
    assert set(OVERRIDES) == set(CELLS)  # every cell has a small size for these tests
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    cells = 2 + 14 * 24
    assert cells * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"])
    for c in BENCH["configs"]:
        cfg = core.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
        assert set(entry.CHECKS) == set(cfg["limits"]) and hasattr(entry, "Entry") and hasattr(entry, "TAPS")
    for w in BENCH["workloads"]:
        wl = core.load_json(ROOT / "portbench" / "workloads" / f"{w['name']}.json")
        assert wl["config"] == w["config"] and w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct_and_reports_its_keys(cell, trace):
    r = run(cell, trace=trace)
    assert list(r)[:3] == ["correct", "attempted", "failed"] and list(r)[-1] == "checks"
    assert {"metrics", "device"} <= set(r) and r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0 and r["device"]["count"] == (4 if "shard" in cell else 1)
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "host_call_ms" in r["metrics"] and "batch_mfu" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_same_seed_same_traffic():
    from portbench.traffic import make_batch

    cfg, wl = core.load_cell("flat_msmarco1.b256")[1:]
    a, b = make_batch(wl, cfg, SEED, 7, "cpu"), make_batch(wl, cfg, SEED, 7, "cpu")
    c = make_batch(wl, cfg, SEED + 1, 7, "cpu")
    assert torch.equal(a["queries"], b["queries"]) and not torch.equal(a["queries"], c["queries"])
    q = a["queries"]
    assert q.shape == (256, 768) and torch.equal(q, q.to(torch.bfloat16).float())
    assert torch.allclose(q.norm(dim=1), torch.ones(256), atol=1e-2)


def test_corpus_rows_do_not_depend_on_the_block_that_holds_them():
    from portbench.data import ROW_CHUNK, unit_rows

    whole = unit_rows(2 * ROW_CHUNK, 4, SEED, "cpu", capacity=2 * ROW_CHUNK + 100)
    second = unit_rows(ROW_CHUNK, 4, SEED, "cpu", first_row=ROW_CHUNK)
    assert torch.equal(whole[ROW_CHUNK:2 * ROW_CHUNK], second) and not whole[2 * ROW_CHUNK:].any()
    with pytest.raises(ValueError):
        unit_rows(10, 4, SEED, "cpu", first_row=5)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    """The reference in the program's place, one precision below (bf16), fails one of
    the cell's numbers."""
    r = run(cell, control=True)
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(v > limits[k] for k, v in r["control"].items()), r["control"]


def _altered(fn, mutate):
    def broken(*args, **kwargs):
        return mutate(fn(*args, **kwargs))
    return broken


def _alter_first_id(out):
    out = list(out)
    ids = out[-1].clone()
    ids[:, 0] = (ids[:, 0] + 1) % 4096
    out[-1] = ids
    return tuple(out)


def _half_batch(fn):
    """The answers of the first half of the batch given to both halves."""
    def broken(q, *args, **kwargs):
        h = q.shape[0] // 2
        out = fn(q[:h], *args, **kwargs)
        return tuple(torch.cat([o, o], 0) for o in out)
    return broken


FAULTS = {
    ("flat_msmarco1.b256", "answer altered"): ("wax_tpu_torch.ops.chunkmax_scan", "chunkmax_scan_topk",
                                               lambda f: _altered(f, _alter_first_id)),
    ("flat_msmarco1.b256", "half the batch left out"): ("wax_tpu_torch.ops.chunkmax_scan", "chunkmax_scan_topk",
                                                        _half_batch),
    ("shard_msmarco2.b64", "answer altered"): ("wax_tpu_torch.parallel.sharded_scan", "blockmax_topk",
                                               lambda f: _altered(f, _alter_first_id)),
    ("shard_msmarco2.b64", "half the batch left out"): ("wax_tpu_torch.parallel.sharded_scan", "blockmax_topk",
                                                        lambda f: lambda s, k: tuple(
                                                            torch.cat([o[: s.shape[0] // 2]] * 2, 0) for o in f(s, k))),
    ("shard_msmarco2.b64", "exchange between cards left out"): (
        "wax_tpu_torch.parallel.merge", "_gather_merge", lambda f: lambda v, i, k: f(v[:1], i[:1], k)),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_in_the_timed_path_fails_the_check(cell, fault, monkeypatch):
    module, attr, make = FAULTS[(cell, fault)]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    r = run(cell)
    assert r["correct"] is False, r["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert core.forbidden_modules() == []  # wax_tpu_torch is loaded here and is not wax_tpu
    monkeypatch.setitem(sys.modules, "wax_tpu.fake", types.ModuleType("wax_tpu.fake"))
    assert core.forbidden_modules() == ["wax_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import json; from portbench.tests.portbench_tiny import run; "
            "from portbench import core; "
            "[run(c, trace=True) for c in %r]; print(json.dumps(core.forbidden_modules()))") % (str(ROOT), CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cli_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for where in (ROOT, tmp_path):
        if where == tmp_path:  # only BENCHMARK.json and the benchmark's files
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__", ".cache"))
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "flat_msmarco1.b256", "--seed",
                              str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                             timeout=300, cwd=where)
        assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    chips = next(w["chips"] for w in BENCH["workloads"] if w["name"] == cell)
    if card < chips:
        pytest.skip(f"needs {chips} cards")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
