# Copy of wax_tpu/surfaces/cli.py with these changes: `main(argv, device)` hands
# `device` (None: the current CUDA device, raising without one; "cpu" on request) to
# every command that opens a store's orchestrator or the MCP server; `mcp doctor`
# checks torch and lists the CUDA devices through the port's `probe_backend`; the
# program is `wax-tpu-torch`; `mcp install --global` writes ~/.wax-tpu/mcp_servers.json
# and the help texts name the MCP client's config generically. Keep the two in step.
"""wax-tpu command-line interface.

Mirrors the reference's WaxCLI (reference: Sources/WaxCLI/main.swift:20-346 —
`wax mcp serve|install|doctor|uninstall` registering the MCP server into an MCP
client's config) plus direct engine commands for operators (remember/recall/search/stats/
verify/bench-smoke).

Run it as `wax-tpu-torch ...` or `python -m wax_tpu_torch.surfaces.cli ...`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from wax_tpu_torch.version import __version__


def _add_store_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--store", default=None, help="store path (default ~/.wax-tpu/memory.wxs)")


def _orchestrator(args):
    from wax_tpu_torch.orchestrator.orchestrator import MemoryOrchestrator
    from wax_tpu_torch.surfaces.mcp_server import default_store_path

    path = Path(args.store) if args.store else default_store_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    return MemoryOrchestrator(path, device=args.device)


def cmd_mcp_serve(args) -> int:
    from wax_tpu_torch.surfaces.mcp_server import build_server

    server = build_server(args.store, device=args.device)
    try:
        server.serve_stdio()
    finally:
        try:
            server.orch.flush()
        except Exception:  # noqa: BLE001
            pass
        server.orch.close()
    return 0


def _mcp_config_path(project: bool) -> Path:
    return Path(".mcp.json") if project else Path.home() / ".wax-tpu" / "mcp_servers.json"


def cmd_mcp_install(args) -> int:
    """Register the server in an MCP client's config (project .mcp.json by default)."""
    cfg_path = _mcp_config_path(project=not args.global_)
    entry = {
        "command": sys.executable,
        "args": ["-m", "wax_tpu_torch.surfaces.mcp_server"],
    }
    if args.store:
        entry["env"] = {"WAX_TPU_STORE": str(Path(args.store).resolve())}
    data = {}
    if cfg_path.exists():
        try:
            data = json.loads(cfg_path.read_text())
        except json.JSONDecodeError:
            data = {}
    data.setdefault("mcpServers", {})["wax-tpu"] = entry
    cfg_path.parent.mkdir(parents=True, exist_ok=True)
    cfg_path.write_text(json.dumps(data, indent=2) + "\n")
    print(f"registered wax-tpu MCP server in {cfg_path}")
    return 0


def cmd_mcp_uninstall(args) -> int:
    cfg_path = _mcp_config_path(project=not args.global_)
    if not cfg_path.exists():
        print(f"no config at {cfg_path}")
        return 1
    data = json.loads(cfg_path.read_text())
    if data.get("mcpServers", {}).pop("wax-tpu", None) is None:
        print("wax-tpu was not registered")
        return 1
    cfg_path.write_text(json.dumps(data, indent=2) + "\n")
    print(f"removed wax-tpu from {cfg_path}")
    return 0


def cmd_mcp_doctor(args) -> int:
    """Environment/readiness checks (reference: `wax mcp doctor`)."""
    checks: list[tuple[str, bool, str]] = []

    def check(name, fn):
        try:
            detail = fn()
            checks.append((name, True, str(detail)))
        except Exception as e:  # noqa: BLE001
            checks.append((name, False, f"{type(e).__name__}: {e}"))

    check("python", lambda: sys.version.split()[0])
    check("torch", lambda: f"{__import__('torch').__version__} (CUDA {__import__('torch').version.cuda})")

    def devices_check():
        # bounded subprocess probe: a hung GPU can stall CUDA's init for many
        # minutes; doctor must diagnose that, not reproduce it. A caller that asked
        # for the CPU (tests) is answered in-process.
        import os

        if args.device is not None and str(args.device) == "cpu":
            return "['cpu'] (device='cpu' requested)"
        from wax_tpu_torch.utils.backend import DOCTOR_TIMEOUT_ENV, probe_backend

        timeout_s = float(os.environ.get(DOCTOR_TIMEOUT_ENV, "60"))
        devices, err = probe_backend(timeout_s)
        if err is not None:
            raise RuntimeError(err)
        return devices

    check("devices", devices_check)
    check(
        "cl100k vocab",
        lambda: __import__("wax_tpu_torch.text.bpe", fromlist=["find_cl100k_vocab"]).find_cl100k_vocab()
        or "byte-fallback (approximate budgets)",
    )

    def store_check():
        from wax_tpu_torch.surfaces.mcp_server import default_store_path

        p = Path(args.store) if args.store else default_store_path()
        if p.exists():
            from wax_tpu_torch.storage.store import StoreOptions, WaxStore

            s = WaxStore.open(p, readonly=True)
            try:
                return f"{p} gen={s.toc.generation} frames={s.frame_count()}"
            finally:
                s.close()
        return f"{p} (will be created on first use)"

    check("store", store_check)

    ok = all(c[1] for c in checks)
    for name, passed, detail in checks:
        print(f"[{'ok' if passed else 'FAIL'}] {name}: {detail}")
    return 0 if ok else 1


def cmd_remember(args) -> int:
    with _orchestrator(args) as o:
        content = args.content if args.content else sys.stdin.read()
        res = o.remember(content)
        o.flush()
        print(json.dumps({"document_id": res.document_id, "chunk_ids": list(res.chunk_ids)}))
    return 0


def cmd_recall(args) -> int:
    with _orchestrator(args) as o:
        ctx = o.recall(args.query, args.top_k)
        print(ctx.render())
    return 0


def cmd_search(args) -> int:
    with _orchestrator(args) as o:
        resp = o.search(args.query, top_k=args.top_k)
        for h in resp.hits:
            print(json.dumps({"frame_id": h.frame_id, "score": round(h.score, 6), "preview": h.preview[:120]}))
    return 0


def cmd_stats(args) -> int:
    with _orchestrator(args) as o:
        print(json.dumps(o.runtime_stats(), indent=2, default=str))
    return 0


def cmd_verify(args) -> int:
    from wax_tpu_torch.storage.store import WaxStore
    from wax_tpu_torch.surfaces.mcp_server import default_store_path

    path = Path(args.store) if args.store else default_store_path()
    s = WaxStore.open(path, readonly=True)
    try:
        report = s.verify(deep=args.deep)
    finally:
        s.close()
    print(json.dumps(report))
    return 0 if report["ok"] else 1


def main(argv: list[str] | None = None, device=None) -> int:
    """Run one command. `device` holds the store's index snapshots (None: the current
    CUDA device, which raises without one; "cpu" on request)."""
    ap = argparse.ArgumentParser(prog="wax-tpu-torch", description="TPU-native retrieval & AI-memory engine")
    ap.add_argument("--version", action="version", version=f"wax-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mcp = sub.add_parser("mcp", help="MCP server management")
    mcp_sub = mcp.add_subparsers(dest="mcp_cmd", required=True)
    p = mcp_sub.add_parser("serve", help="run the stdio MCP server")
    _add_store_arg(p)
    p.set_defaults(fn=cmd_mcp_serve)
    p = mcp_sub.add_parser("install", help="register in the MCP client's config")
    _add_store_arg(p)
    p.add_argument("--global", dest="global_", action="store_true")
    p.set_defaults(fn=cmd_mcp_install)
    p = mcp_sub.add_parser("uninstall", help="remove from the MCP client's config")
    p.add_argument("--global", dest="global_", action="store_true")
    p.set_defaults(fn=cmd_mcp_uninstall)
    p = mcp_sub.add_parser("doctor", help="environment/readiness checks")
    _add_store_arg(p)
    p.set_defaults(fn=cmd_mcp_doctor)

    p = sub.add_parser("remember", help="store a memory (arg or stdin)")
    p.add_argument("content", nargs="?")
    _add_store_arg(p)
    p.set_defaults(fn=cmd_remember)

    p = sub.add_parser("recall", help="build a RAG context for a query")
    p.add_argument("query")
    p.add_argument("--top-k", type=int, default=None)
    _add_store_arg(p)
    p.set_defaults(fn=cmd_recall)

    p = sub.add_parser("search", help="hybrid search")
    p.add_argument("query")
    p.add_argument("--top-k", type=int, default=10)
    _add_store_arg(p)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("stats", help="runtime statistics")
    _add_store_arg(p)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("verify", help="store integrity check")
    p.add_argument("--deep", action="store_true")
    _add_store_arg(p)
    p.set_defaults(fn=cmd_verify)

    from wax_tpu_torch.surfaces.repo import add_repo_commands

    add_repo_commands(sub)

    args = ap.parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
