"""wax_tpu_torch's agent and operator surfaces against wax_tpu's.

The MCP servers: one JSON-RPC message sequence (tests/test_surfaces.py's cycles and
tests/test_mcp_errors.py's bad arguments, in an agent session's order) goes to JAX's
`McpServer` and to the port's (`device="cpu"`), each over a fresh store with
`HashEmbedder(384)` and the config's injectable clock. The responses must be equal
once these fields are set aside:

  * `wax_stats` `spans`: wall-clock times of each step (the spans' names differ too:
    each package records its own steps);
  * `wax_search` diagnostics `lane_scores`: each lane's f32 score (a BM25 sum, the
    vector product), summed in another order by each package, held within rtol 1e-5
    as tests/test_torch_orchestrator.py holds them (their lanes, the fused scores,
    ranks and lists are equal).

No response holds a path. The photo and video stores keep wall-clock time: every photo
of the session carries its `taken_at_ms`, so no response holds one of their readings. Then stores cross: each server serves the
other's flushed store as its writer serves it. The CLI runs through `main(argv,
device="cpu")`, the repo memory and its headless TUI on tests/test_repo_and_fixtures.py's
synthetic git repo, and the crash harness's child on the port's store, recovered by
both packages' `WaxStore.open`.
"""
import curses
import io
import itertools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import pytest

import wax_tpu.embed.hash_embedder as jax_hash
import wax_tpu.orchestrator.config as jax_config
import wax_tpu.orchestrator.orchestrator as jax_orch
import wax_tpu.storage.store as jax_store
import wax_tpu.surfaces.cli as jax_cli
import wax_tpu.surfaces.license as jax_license
import wax_tpu.surfaces.mcp_server as jax_mcp
import wax_tpu.surfaces.repo as jax_repo
import wax_tpu.surfaces.repo_tui as jax_tui
import wax_tpu_torch.embed.hash_embedder as port_hash
import wax_tpu_torch.orchestrator.config as port_config
import wax_tpu_torch.orchestrator.orchestrator as port_orch
import wax_tpu_torch.storage.store as port_store
import wax_tpu_torch.surfaces.cli as port_cli
import wax_tpu_torch.surfaces.crash_harness as port_crash
import wax_tpu_torch.surfaces.license as port_license
import wax_tpu_torch.surfaces.mcp_server as port_mcp
import wax_tpu_torch.surfaces.repo as port_repo
import wax_tpu_torch.surfaces.repo_tui as port_tui
import wax_tpu_torch.utils.backend as port_backend
from wax_tpu_torch.search import engine_cache as port_cache

PKGS = {
    "jax": (jax_orch, jax_config, jax_hash, jax_store, jax_mcp, {}),
    "port": (port_orch, port_config, port_hash, port_store, port_mcp, {"device": "cpu"}),
}
T0 = 1_700_000_000_000
VOLATILE = {"wax_stats": ("spans",)}
LANE_SCORE_RTOL = 1e-5


def _clock():
    ticks = itertools.count(T0, 1000)
    return lambda: next(ticks)


def _server(pkg: str, path: Path, **cfg_kw):
    orch_mod, config, hashing, store, mcp, dev = PKGS[pkg]
    path.parent.mkdir(parents=True, exist_ok=True)
    cfg = config.OrchestratorConfig(clock_ms=_clock(), store=store.StoreOptions(wal_size=512 * 1024), **cfg_kw)
    orch = orch_mod.MemoryOrchestrator(path, hashing.HashEmbedder(384), cfg, **dev)
    return mcp.McpServer(orch, structured_enabled=cfg.enable_structured_memory)


def _call(mid, name, args):
    return {"jsonrpc": "2.0", "id": mid, "method": "tools/call", "params": {"name": name, "arguments": args}}


def _session() -> list:
    """An agent session: handshake, notes, searches and recalls, structured memory,
    a handoff, forget/timeline, filters and diagnostics, tool errors, photo and video."""
    ids = itertools.count(2)
    msgs = [{"jsonrpc": "2.0", "id": 0, "method": "initialize", "params": {}},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 1, "method": "tools/list"}]
    notes = ["The launch code is bravo-seven.", "Rex belongs to Ana.", "deploy notes for api",
             "deploy notes for web", "ephemeral note to forget", "a memory about the lake house",
             "日本語のメモ 🚀 café naïve"]
    for n in notes:
        meta = {"metadata": {"team": n.split()[-1]}} if n.startswith("deploy") else {}
        msgs.append(_call(next(ids), "wax_remember", {"content": n, **meta, "tags": ["note"]}))
    for q in ("launch code", "deploy notes", "who owns Rex", "café"):
        msgs.append(_call(next(ids), "wax_search", {"query": q}))
        msgs.append(_call(next(ids), "wax_recall", {"query": q}))
    msgs += [
        _call(next(ids), "wax_search", {"query": "deploy notes", "metadata_filter": {"team": "api"},
                                        "include_diagnostics": True}),
        _call(next(ids), "wax_search", {"query": "deploy notes", "frame_ids": [2]}),
        _call(next(ids), "wax_search", {"query": "deploy notes", "mode": "text"}),
        _call(next(ids), "wax_search", {"query": "deploy notes", "mode": "vector", "top_k": 3}),
        _call(next(ids), "wax_search", {"query": "lake", "after_ms": T0, "before_ms": T0 + 10_000}),
        _call(next(ids), "wax_recall", {"query": "lake house", "top_k": 2}),
        _call(next(ids), "wax_entity_upsert", {"name": "Rex", "kind": "pet", "aliases": ["the dog"]}),
        _call(next(ids), "wax_entity_upsert", {"name": "Aurora Station", "aliases": ["the station"]}),
        _call(next(ids), "wax_entity_resolve", {"name": "the dog"}),
        _call(next(ids), "wax_entity_resolve", {"name": "no such thing"}),
        _call(next(ids), "wax_fact_assert", {"subject": "Rex", "predicate": "owner", "value": "Ana",
                                             "evidence_frames": [1]}),
        _call(next(ids), "wax_fact_assert", {"subject": "Rex", "predicate": "age", "value": "4",
                                             "value_kind": "int", "valid_from_ms": T0}),
        _call(next(ids), "wax_facts_query", {"subject": "Rex"}),
        _call(next(ids), "wax_fact_retract", {"fact_id": 0}),
        _call(next(ids), "wax_facts_query", {"subject": "Rex", "as_of_ms": T0 + 50_000}),
        _call(next(ids), "wax_search", {"query": "Rex owner", "as_of_ms": T0 + 50_000}),
        _call(next(ids), "wax_session_start", {"name": "s1"}),
        _call(next(ids), "wax_remember", {"content": "tagged during session s1"}),
        _call(next(ids), "wax_handoff", {"content": "state snapshot", "pending_tasks": ["a", "b"]}),
        _call(next(ids), "wax_handoff", {"content": "project scoped", "project": "wax"}),
        _call(next(ids), "wax_handoff_latest", {}),
        _call(next(ids), "wax_handoff_latest", {"project": "wax"}),
        _call(next(ids), "wax_session_end", {}),
        _call(next(ids), "wax_timeline", {}),
        _call(next(ids), "wax_timeline", {"limit": 3}),
        _call(next(ids), "wax_forget", {"frame_id": 4}),
        _call(next(ids), "wax_forget", {"frame_id": 999_999}),
        _call(next(ids), "wax_search", {"query": "ephemeral note"}),
        _call(next(ids), "wax_flush", {}),
        _call(next(ids), "wax_stats", {}),
        # tool errors (tests/test_mcp_errors.py)
        _call(next(ids), "wax_nonexistent", {}),
        _call("string-id-42", "wax_no_such_tool", {}),
        _call(next(ids), "wax_remember", {}),
        _call(next(ids), "wax_search", {}),
        _call(next(ids), "wax_search", {"query": "x", "top_k": "lots"}),
        _call(next(ids), "wax_recall", {"query": "x", "top_k": "many"}),
        _call(next(ids), "wax_recall", {"query": "x", "max_tokens": "ignored"}),
        _call(next(ids), "wax_fact_assert", {"entity": "only-entity"}),
        _call(next(ids), "wax_photo_ingest", {}),
        _call(next(ids), "wax_video_forget", {"video_id": "nope"}),
        _call(next(ids), "wax_video_recall", {"query": "anything"}),
        {"jsonrpc": "2.0", "id": next(ids), "method": "tools/call", "params": None},
        {"jsonrpc": "2.0", "id": next(ids), "method": "bogus/method"},
        {"jsonrpc": "2.0", "method": "bogus/notification"},
        {"jsonrpc": "2.0", "id": next(ids), "method": "ping"},
        # photo and video
        _call(next(ids), "wax_video_ingest", {"video_id": "v1", "duration_ms": 20_000, "transcript": [
            {"start_ms": 0, "end_ms": 9_000, "text": "intro to gardening"},
            {"start_ms": 10_000, "end_ms": 19_000, "text": "pruning roses properly"}]}),
        _call(next(ids), "wax_video_ingest", {"video_id": "vdel", "duration_ms": 10_000, "transcript": [
            {"start_ms": 0, "end_ms": 9_000, "text": "deletable clip"}], "keyframe_refs": ["k0"]}),
        _call(next(ids), "wax_video_recall", {"query": "pruning roses"}),
        _call(next(ids), "wax_video_forget", {"video_id": "vdel"}),
        _call(next(ids), "wax_video_forget", {"video_id": "vdel"}),
        _call(next(ids), "wax_video_recall", {"query": "deletable clip", "top_k": 4}),
        _call(next(ids), "wax_photo_ingest", {"asset_id": "p1", "caption": "sunset over the harbor with sailboats",
                                              "ocr_texts": ["PIER 39"], "gps": [37.80, -122.41],
                                              "taken_at_ms": T0}),
        _call(next(ids), "wax_photo_ingest", {"asset_id": "pdel", "caption": "deletable photo",
                                              "taken_at_ms": T0 + 5_000}),
        _call(next(ids), "wax_photo_recall", {"query": "harbor sailboats sunset"}),
        _call(next(ids), "wax_photo_recall", {"query": "pier sign", "near": [37.8001, -122.4102]}),
        _call(next(ids), "wax_photo_recall", {"query": "sunset", "after_ms": T0 - 1, "before_ms": T0 + 1}),
        _call(next(ids), "wax_photo_forget", {"asset_id": "pdel"}),
        _call(next(ids), "wax_photo_recall", {"query": "deletable photo"}),
    ]
    return msgs


def _followup() -> list:
    """Reads sent to a reopened store (the store crossing)."""
    ids = itertools.count(1000)
    return [_call(next(ids), "wax_search", {"query": q}) for q in ("launch code", "deploy notes", "café")] + [
        _call(next(ids), "wax_recall", {"query": "who owns Rex"}),
        _call(next(ids), "wax_timeline", {}),
        _call(next(ids), "wax_facts_query", {"subject": "Rex"}),
        _call(next(ids), "wax_entity_resolve", {"name": "the station"}),
        _call(next(ids), "wax_handoff_latest", {}),
        _call(next(ids), "wax_video_recall", {"query": "pruning roses"}),
        _call(next(ids), "wax_photo_recall", {"query": "harbor sailboats sunset"}),
    ]


def _normal(msg, resp):
    """The response with its tool result parsed, the volatile fields removed, and the
    lanes' diagnostic scores taken out (returned apart, for the tolerance)."""
    if resp is None:
        return None, []
    tool = (msg.get("params") or {}).get("name")
    resp = json.loads(json.dumps(resp))
    lane_scores = []
    content = resp.get("result", {}).get("content") if isinstance(resp.get("result"), dict) else None
    if content:
        body = json.loads(content[0]["text"])
        content[0]["text"] = body
        if isinstance(body, dict):
            for key in VOLATILE.get(tool, ()):
                body.pop(key)
            for hit in body.get("hits", ()):
                scores = hit.get("diagnostics", {}).get("lane_scores", {})
                lane_scores += [(lane, scores.pop(lane)) for lane in sorted(scores)]
    return resp, lane_scores


def _agree(msgs, a, b):
    for m, ra, rb in zip(msgs, a, b):
        na, va = _normal(m, ra)
        nb, vb = _normal(m, rb)
        assert na == nb, m
        assert [lane for lane, _ in va] == [lane for lane, _ in vb], m
        np.testing.assert_allclose([v for _, v in vb], [v for _, v in va], rtol=LANE_SCORE_RTOL, atol=0, err_msg=str(m))


def _drive(server, msgs):
    return [server.handle(m) for m in msgs]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both servers through the session, flushed and closed: (messages, responses by
    package, store directory by package)."""
    msgs = _session()
    out, dirs = {}, {}
    for pkg in PKGS:
        d = tmp_path_factory.mktemp(f"mcp-{pkg}")
        srv = _server(pkg, d / "memory.wxs")
        out[pkg] = _drive(srv, msgs)
        srv.close()
        dirs[pkg] = d
    return msgs, out, dirs


def test_session_responses_equal(sessions):
    msgs, out, _ = sessions
    assert sum(r is not None for r in out["port"]) == len(msgs) - 2  # two notifications
    _agree(msgs, out["jax"], out["port"])


def test_session_covers_every_tool(sessions):
    msgs, out, _ = sessions
    called = {m["params"]["name"] for m in msgs if m.get("method") == "tools/call" and m.get("params")}
    listed = {t["name"] for t in out["port"][2]["result"]["tools"]}
    assert listed <= called


def test_session_errors_are_jsonrpc_errors(sessions):
    msgs, out, _ = sessions
    by_id = {m.get("id"): r for m, r in zip(msgs, out["port"]) if r is not None}
    assert by_id["string-id-42"]["error"]["code"] == -32603
    assert "unknown tool" in by_id["string-id-42"]["error"]["message"]
    errors = [r for r in out["port"] if r is not None and "error" in r]
    assert {r["error"]["code"] for r in errors} == {-32601, -32603}
    assert len(errors) >= 9


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_stores_cross_servers(sessions, tmp_path, writer, reader):
    """The writer's flushed store (and its photo and video stores), served by the other
    package, answers as the writer's package does on a reopen."""
    _, _, dirs = sessions
    msgs = _followup()
    answers = {}
    for pkg in (writer, reader):
        d = tmp_path / pkg
        shutil.copytree(dirs[writer], d)
        port_cache.clear()
        srv = _server(pkg, d / "memory.wxs")
        answers[pkg] = _drive(srv, msgs)
        srv.close()
    assert all(r is not None and "error" not in r for r in answers[writer])
    _agree(msgs, answers[writer], answers[reader])


def test_serve_stdio_round_trip(tmp_path):
    msgs = _session()[:12]
    lines = ["this is not json", '{"jsonrpc": "2.0"', ""] + [json.dumps(m) for m in msgs]
    outs = {}
    for pkg in PKGS:
        srv = _server(pkg, tmp_path / pkg / "memory.wxs")
        buf = io.StringIO()
        srv.serve_stdio(stdin=io.StringIO("\n".join(lines) + "\n"), stdout=buf)
        srv.close()
        outs[pkg] = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
    assert len(outs["port"]) == len(msgs) - 1  # one notification
    assert all(r["jsonrpc"] == "2.0" and ("result" in r or "error" in r) for r in outs["port"])
    _agree(msgs, outs["jax"], outs["port"])


# ------------------------------------------------------------ the port's server alone


def _port_call(srv, tool, args, mid=7):
    return srv.handle(_call(mid, tool, args))


def test_structured_tools_disabled(tmp_path):
    srv = _server("port", tmp_path / "ns.wxs", enable_structured_memory=False)
    try:
        names = {t["name"] for t in srv.handle({"jsonrpc": "2.0", "id": 1, "method": "tools/list"})["result"]["tools"]}
        assert not any(n.startswith(("wax_entity", "wax_fact")) for n in names)
        resp = _port_call(srv, "wax_entity_upsert", {"name": "Ada"})
        assert "disabled" in resp["error"]["message"]
    finally:
        srv.close()


def test_call_after_close_is_an_error(tmp_path):
    srv = _server("port", tmp_path / "c.wxs")
    srv.orch.remember("persisted before close")
    srv.orch.flush()
    srv.orch.close()
    for tool, args in (("wax_remember", {"content": "too late"}), ("wax_search", {"query": "persisted"})):
        assert _port_call(srv, tool, args)["error"]["code"] == -32603


def test_notifications_produce_no_output(tmp_path):
    srv = _server("port", tmp_path / "n.wxs")
    try:
        lines = [json.dumps({"jsonrpc": "2.0", "method": "notifications/initialized"}),
                 json.dumps({"jsonrpc": "2.0", "method": "tools/call",
                             "params": {"name": "wax_no_such_tool", "arguments": {}}})]
        buf = io.StringIO()
        srv.serve_stdio(stdin=io.StringIO("\n".join(lines) + "\n"), stdout=buf)
        assert buf.getvalue().strip() == ""
    finally:
        srv.close()


def test_first_call_waits_for_warmup(tmp_path):
    import threading
    import time

    srv = _server("port", tmp_path / "w.wxs")
    done = []
    t = threading.Thread(target=lambda: (time.sleep(0.3), done.append(True)), daemon=True)
    t.start()
    srv.orch._warmup_thread = t
    try:
        assert "result" in srv.handle({"jsonrpc": "2.0", "id": 1, "method": "initialize"})
        assert done == []
        assert "result" in _port_call(srv, "wax_stats", {})
        assert done == [True]
    finally:
        srv.close()


# ---------------------------------------------------------------- build_server, license


@pytest.fixture()
def hash_env(monkeypatch):
    for var in ("WAX_TPU_FEATURE_LICENSE", "WAX_TPU_LICENSE", "WAX_TPU_LICENSE_SECRET", "WAX_TPU_SHARDED_LANES",
                "WAX_TPU_MESH_SLICES", "WAX_TPU_MESH_TP", "WAX_TPU_POSTINGS_BUDGET", "WAX_TPU_MINILM_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WAX_TPU_EMBEDDER", "hash")
    return monkeypatch


def test_build_server_on_cpu(tmp_path, hash_env):
    srv = port_mcp.build_server(tmp_path / "b.wxs", device="cpu")
    try:
        assert str(srv.orch.device) == "cpu"
        assert srv.handle({"jsonrpc": "2.0", "id": 1, "method": "ping"})["result"] == {}
        assert "error" not in _port_call(srv, "wax_remember", {"content": "built on the cpu"})
    finally:
        srv.close()


@pytest.mark.parametrize("case", ["missing", "bad_signature", "valid", "expired"])
def test_license_gate(tmp_path, hash_env, case):
    hash_env.setenv("WAX_TPU_FEATURE_LICENSE", "1")
    token, secret, raises = {
        "missing": (None, "s", "malformed token"),
        "bad_signature": (port_license.issue_license("mallory", "wrong-secret"), "real-secret", "signature"),
        "valid": (jax_license.issue_license("alice", "s3cret"), "s3cret", None),
        "expired": (port_license.issue_license("bob", "k", expires_ms=1), "k", "expired"),
    }[case]
    if token is not None:
        hash_env.setenv("WAX_TPU_LICENSE", token)
    hash_env.setenv("WAX_TPU_LICENSE_SECRET", secret)
    if raises:
        with pytest.raises(PermissionError, match=f"license check failed: {raises}"):
            port_mcp.build_server(tmp_path / "lic.wxs", device="cpu")
        return
    srv = port_mcp.build_server(tmp_path / "lic.wxs", device="cpu")
    try:
        assert "error" not in _port_call(srv, "wax_remember", {"content": "licensed memory"})
    finally:
        srv.close()


@pytest.mark.parametrize("slices,tp", [(2, 1), (2, 2), (3, 1)], ids=["two_slices", "two_slices_tp2", "three_slices"])
def test_sharded_lanes_on_more_than_one_slice_raise(tmp_path, hash_env, slices, tp):
    """WAX_TPU_SHARDED_LANES / WAX_TPU_MESH_SLICES / WAX_TPU_MESH_TP reach the port's
    orchestrator as they reach JAX's: over four logical CPU shards two slices serve
    (with tp 2 too) on the two-level mesh shared by both lanes; three slices do not
    divide four devices and raise ValueError, as in JAX."""
    hash_env.setenv("WAX_TPU_SHARDED_LANES", "1")
    hash_env.setenv("WAX_TPU_MESH_SLICES", str(slices))
    hash_env.setenv("WAX_TPU_MESH_TP", str(tp))
    if slices == 3:
        with pytest.raises(ValueError, match="does not divide"):
            port_mcp.build_server(tmp_path / "scale.wxs", device=["cpu"] * 4)
        return
    srv = port_mcp.build_server(tmp_path / "scale.wxs", device=["cpu"] * 4)
    try:
        cfg, eng = srv.orch.config, srv.orch.engine
        assert cfg.sharded_lanes and (cfg.mesh_slices, cfg.mesh_tp) == (slices, tp)
        assert eng.mesh.shape["slice"] == slices and eng.mesh.shape.get("tp", 1) == tp
        assert eng.vector.kind == "sharded" and eng.vector.mesh is eng.mesh and eng.lex_sharded
        assert srv.orch.device == torch.device("cpu")
        assert "error" not in _port_call(srv, "wax_remember", {"content": "a sharded memory about the river"})
        found = json.loads(_port_call(srv, "wax_search", {"query": "sharded river memory"})["result"]["content"][0]["text"])
        assert found["hits"]
    finally:
        srv.close()


def test_scale_knobs_reach_the_config(tmp_path, hash_env):
    hash_env.setenv("WAX_TPU_MESH_SLICES", "4")  # ignored without WAX_TPU_SHARDED_LANES
    hash_env.setenv("WAX_TPU_POSTINGS_BUDGET", "4096")
    srv = port_mcp.build_server(tmp_path / "budget.wxs", device="cpu")
    try:
        cfg = srv.orch.config
        assert not cfg.sharded_lanes and cfg.mesh_slices == 1 and cfg.lex_postings_budget == 4096
    finally:
        srv.close()


def test_embedder_auto_keeps_a_hash_store(tmp_path, hash_env):
    """A store built with the hash embedder keeps it once MiniLM weights appear."""
    p = tmp_path / "auto.wxs"
    srv = port_mcp.build_server(p, device="cpu")
    _port_call(srv, "wax_remember", {"content": "built under hash"})
    _port_call(srv, "wax_flush", {})
    srv.close()
    fake = tmp_path / "minilm"
    fake.mkdir()
    hash_env.setenv("WAX_TPU_EMBEDDER", "auto")
    hash_env.setenv("WAX_TPU_MINILM_DIR", str(fake))
    srv = port_mcp.build_server(p, device="cpu")
    try:
        assert srv.orch.memoizer.provider.identity.startswith("hash-embedder")
        assert "error" not in _port_call(srv, "wax_search", {"query": "built under hash"})
    finally:
        srv.close()


def test_embedder_selection_matches_jax(tmp_path, hash_env, capsys):
    """The same choice and the same stderr line as the JAX server, by each env value;
    a forced MiniLM without weights is the port's encoder with random weights."""
    for choice in ("hash", "auto", "minilm"):
        hash_env.setenv("WAX_TPU_EMBEDDER", choice)
        got = port_mcp._select_embedder(tmp_path / f"{choice}.wxs", "cpu")
        port_err = capsys.readouterr().err
        if choice != "minilm":
            ref = jax_mcp._select_embedder(tmp_path / f"{choice}.wxs")
            assert capsys.readouterr().err == port_err
            assert type(got).__name__ == type(ref).__name__ == "HashEmbedder"
            assert got.identity == ref.identity
        else:
            assert type(got).__name__ == "MiniLMEmbedder" and str(got.device) == "cpu"
            assert port_err.startswith("[wax-tpu] WARNING: embedder: MiniLM with RANDOM-INIT weights")


@pytest.mark.parametrize("case", ["roundtrip", "wrong_secret", "expired", "malformed", "required"])
def test_license_tokens_cross_packages(case, monkeypatch):
    if case == "roundtrip":
        for issue, validate in ((jax_license, port_license), (port_license, jax_license)):
            tok = issue.issue_license("acme", "secret1", expires_ms=2_000_000_000_000)
            assert tok == (jax_license if issue is port_license else port_license).issue_license(
                "acme", "secret1", expires_ms=2_000_000_000_000)
            info = validate.validate_license(tok, "secret1", now_ms=1_000)
            assert info.valid and info.licensee == "acme"
    elif case == "wrong_secret":
        assert not port_license.validate_license(jax_license.issue_license("acme", "secret1"), "secret2").valid
    elif case == "expired":
        info = port_license.validate_license(jax_license.issue_license("acme", "s", expires_ms=1_000), "s", 2_000)
        assert not info.valid and info.reason == "expired"
    elif case == "malformed":
        assert not port_license.validate_license("garbage", "s").valid
        assert not port_license.validate_license("a.b.c.d", "s").valid
    else:
        monkeypatch.delenv("WAX_TPU_FEATURE_LICENSE", raising=False)
        assert not port_license.license_required()
        monkeypatch.setenv("WAX_TPU_FEATURE_LICENSE", "1")
        assert port_license.license_required()


# --------------------------------------------------------------------------- backend


class _Run:
    def __init__(self, rc, out, err):
        self.returncode, self.stdout, self.stderr = rc, out, err


def test_probe_backend_timeout(monkeypatch):
    def runner(*a, **kw):
        raise subprocess.TimeoutExpired(cmd="x", timeout=5.0)

    monkeypatch.setattr(port_backend.subprocess, "run", runner)
    devices, err = port_backend.probe_backend(5.0)
    assert devices is None and "exceeded 5s" in err and "wedged" in err


def test_probe_backend_nonzero_rc(monkeypatch):
    monkeypatch.setattr(port_backend.subprocess, "run",
                        lambda *a, **kw: _Run(1, "", "Traceback ...\nRuntimeError: no CUDA device"))
    assert port_backend.probe_backend(5.0) == (None, "RuntimeError: no CUDA device")


def test_probe_backend_success(monkeypatch):
    seen = {}

    def runner(cmd, **kw):
        seen["cmd"] = cmd
        return _Run(0, "some preamble\n['NVIDIA H100 80GB HBM3']\n", "")

    monkeypatch.setattr(port_backend.subprocess, "run", runner)
    assert port_backend.probe_backend(5.0) == ("['NVIDIA H100 80GB HBM3']", None)
    assert "torch.cuda" in seen["cmd"][-1] and "jax" not in seen["cmd"][-1]


def test_probe_backend_child_without_a_card():
    """The real child, here where torch has no CUDA device: a diagnosis, no device."""
    devices, err = port_backend.probe_backend(120.0)
    assert devices is None and "no CUDA device" in err


# ------------------------------------------------------------------------------- CLI


def _cli(pkg, argv, capsys):
    rc = port_cli.main(argv, device="cpu") if pkg == "port" else jax_cli.main(argv)
    return rc, capsys.readouterr().out


def test_cli_remember_search_verify_stats(tmp_path, capsys):
    outs = {}
    for pkg in PKGS:
        store = str(tmp_path / f"{pkg}.wxs")
        got = [_cli(pkg, ["remember", "the cli stores this memory", "--store", store], capsys),
               _cli(pkg, ["remember", "a second memory about lakes", "--store", store], capsys),
               _cli(pkg, ["search", "cli memory", "--store", store], capsys),
               _cli(pkg, ["recall", "lakes", "--store", store], capsys),
               _cli(pkg, ["verify", "--deep", "--store", store], capsys)]
        rc, stats = _cli(pkg, ["stats", "--store", store], capsys)
        outs[pkg] = got
        assert rc == 0 and json.loads(stats)["store"]["frame_count"] == 2
    assert outs["port"] == outs["jax"]
    assert all(rc == 0 for rc, _ in outs["port"])
    assert json.loads(outs["port"][2][1].splitlines()[0])["frame_id"] == 0
    assert json.loads(outs["port"][4][1])["ok"]


def test_cli_mcp_install_uninstall(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert port_cli.main(["mcp", "install", "--store", str(tmp_path / "s.wxs")], device="cpu") == 0
    entry = json.loads((tmp_path / ".mcp.json").read_text())["mcpServers"]["wax-tpu"]
    assert entry["args"] == ["-m", "wax_tpu_torch.surfaces.mcp_server"]
    assert entry["env"]["WAX_TPU_STORE"] == str((tmp_path / "s.wxs").resolve())
    assert port_cli.main(["mcp", "uninstall"], device="cpu") == 0
    assert "wax-tpu" not in json.loads((tmp_path / ".mcp.json").read_text())["mcpServers"]
    assert port_cli.main(["mcp", "uninstall"], device="cpu") == 1


def test_cli_mcp_doctor_on_cpu(tmp_path, capsys):
    assert port_cli.main(["mcp", "doctor", "--store", str(tmp_path / "s.wxs")], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[ok] torch" in out and "[ok] devices: ['cpu']" in out and "jax" not in out


def test_cli_mcp_doctor_failing_probe(tmp_path, monkeypatch, capsys):
    """Without a device asked for, doctor probes CUDA in a bounded child; a failed
    probe fails the devices check with its diagnosis, and doctor exits 1."""
    monkeypatch.setattr(port_backend, "probe_backend",
                        lambda timeout_s: (None, f"backend init exceeded {timeout_s:.0f}s (device wedged)"))
    assert port_cli.main(["mcp", "doctor", "--store", str(tmp_path / "s.wxs")]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] devices" in out and "device wedged" in out


def test_cli_mcp_doctor_names_the_probed_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_backend, "probe_backend", lambda timeout_s: ("['NVIDIA H100 80GB HBM3']", None))
    assert port_cli.main(["mcp", "doctor", "--store", str(tmp_path / "s.wxs")]) == 0
    assert "[ok] devices: ['NVIDIA H100 80GB HBM3']" in capsys.readouterr().out


# ------------------------------------------------------------------------ repo memory


@pytest.fixture(scope="module")
def git_repo(tmp_path_factory):
    repo = tmp_path_factory.mktemp("gitrepo")
    for c in (["git", "init", "-q"], ["git", "config", "user.email", "t@example.com"],
              ["git", "config", "user.name", "Tester"]):
        subprocess.run(c, cwd=repo, check=True, capture_output=True)
    for fname, msg in (("auth.py", "add login endpoint with JWT token validation"),
                       ("db.py", "fix race condition in connection pool shutdown"),
                       ("search.py", "implement fuzzy search over product catalog")):
        (repo / fname).write_text(f"# {msg}\n")
        subprocess.run(["git", "add", fname], cwd=repo, check=True, capture_output=True)
        subprocess.run(["git", "commit", "-q", "-m", msg], cwd=repo, check=True, capture_output=True)
    return repo


def _indexers(git_repo, tmp_path):
    j = jax_repo.RepoIndexer(tmp_path / "jax.wxs", jax_hash.HashEmbedder(64))
    t = port_repo.RepoIndexer(tmp_path / "port.wxs", port_hash.HashEmbedder(64), device="cpu")
    assert j.index(git_repo) == t.index(git_repo) == 3
    return j, t


def test_repo_index_and_search(git_repo, tmp_path):
    j, t = _indexers(git_repo, tmp_path)
    try:
        assert [vars(c) for c in port_repo.parse_git_log(git_repo)] == [
            vars(c) for c in jax_repo.parse_git_log(git_repo)]
        for q in ("race condition connection pool", "fuzzy search", "login token"):
            assert t.search(q) == j.search(q)
        hits = t.search("race condition connection pool")
        assert hits and "[race] [condition]" in hits[0]["preview"] and len(hits[0]["sha"]) == 40
        assert t.index(git_repo) == 0
        assert t.stats()["commits"] == 3
    finally:
        j.close()
        t.close()


def test_repo_cli_commands(git_repo, tmp_path, capsys):
    outs = {}
    for pkg, store in (("jax", str(tmp_path / "j.wxs")), ("port", str(tmp_path / "p.wxs"))):
        outs[pkg] = [_cli(pkg, ["repo", "index", str(git_repo), "--store", store], capsys),
                     _cli(pkg, ["repo", "search", "fuzzy search", "--store", store], capsys),
                     _cli(pkg, ["repo", "stats", "--store", store], capsys)]
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][0][1]) == {"indexed": 3, "total": 3}


class _FakeScreen:
    """Headless curses-screen stand-in: scripted keys, captured draw calls."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.drawn: list[str] = []

    def timeout(self, ms):
        pass

    def erase(self):
        self.drawn.append("<erase>")

    def refresh(self):
        pass

    def getmaxyx(self):
        return (24, 100)

    def addnstr(self, y, x, s, n, *a):
        self.drawn.append(s[:n])

    def getch(self):
        return self.keys.pop(0) if self.keys else 27


def test_repo_tui_headless(git_repo, tmp_path):
    """Both TUIs draw the same frames for the same keys (the status line's search
    milliseconds aside)."""
    import re

    j, t = _indexers(git_repo, tmp_path)
    keys = [ord(c) for c in "race condition"] + [10, curses.KEY_DOWN, curses.KEY_UP, 27]
    drawn = {}
    try:
        for name, mod, idx in (("jax", jax_tui, j), ("port", port_tui, t)):
            scr = _FakeScreen(keys)
            mod.run_tui(idx, scr)
            drawn[name] = [re.sub(r"hits in \d+ ms", "hits in _ ms", s) for s in scr.drawn]
        assert drawn["port"] == drawn["jax"]
        blob = "\n".join(drawn["port"])
        assert "sift> race condition" in blob and "hits in" in blob
        m = port_tui.RepoTuiModel(t, debounce_s=0.0)
        for ch in "fuzzy search":
            m.type_char(ch)
        assert m.tick(now=1e18) and m.results and "fuzzy" in m.results[0]["preview"]
        assert m.preview_lines()[0].startswith("commit ")
    finally:
        j.close()
        t.close()


# ---------------------------------------------------------------------- crash harness


def _crash_child(path: Path, checkpoint: str, committed: int, pending: int, wrap: bool) -> int:
    proc = subprocess.run([sys.executable, "-m", "wax_tpu_torch.surfaces.crash_harness", port_crash.CHILD_FLAG,
                           str(path), str(committed), str(pending), checkpoint, "wrap" if wrap else "nowrap"],
                          capture_output=True, timeout=120)
    return proc.returncode


def _recovered(store_mod, path: Path, wrap: bool) -> dict:
    opts = (store_mod.StoreOptions(wal_size=16 * 1024, auto_commit_fill=0.99) if wrap
            else store_mod.StoreOptions(wal_size=256 * 1024))
    s = store_mod.WaxStore.open(path, opts)
    try:
        return {"frame_count": s.frame_count(), "generation": s.toc.generation, "verify_ok": s.verify(deep=True)["ok"],
                "contents": [s.frame_content(i) for i in range(s.frame_count())]}
    finally:
        s.close()


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("checkpoint", list(port_crash.SCENARIOS))
def test_crashed_port_store_recovers_in_both_packages(tmp_path, checkpoint, wrap):
    import signal

    committed, pending = (90, 30) if wrap else (3, 2)
    path = tmp_path / "crash.wxs"
    assert _crash_child(path, checkpoint, committed, pending, wrap) == -signal.SIGKILL
    shutil.copy(path, tmp_path / "copy.wxs")
    port = _recovered(port_store, path, wrap)
    jax = _recovered(jax_store, tmp_path / "copy.wxs", wrap)
    assert port == jax
    assert port["verify_ok"] and port["frame_count"] == committed + pending
    assert port["generation"] in port_crash.SCENARIOS[checkpoint]["expect_gen"]


def test_run_scenario_reports_recovery(tmp_path):
    rep = port_crash.run_scenario(port_crash.CrashCheckpoint.FSYNC_DONE, tmp_path)
    assert rep["child_killed"] and rep["verify_ok"] and rep["frame_count"] == 5 and rep["generation"] == 2
