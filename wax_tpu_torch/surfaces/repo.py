# Copy of wax_tpu/surfaces/repo.py with one change: `RepoIndexer` takes `device` (None:
# the current CUDA device, raising without one; "cpu" on request) for its orchestrator,
# and the `repo` commands pass the CLI's. Keep the two in step.
"""Semantic git-history search ("Sift").

Mirrors the reference's WaxRepo surface (reference: Sources/WaxRepo/main.swift:7-14,
Commands/, Git/GitLogParser.swift — `index` parses git log into frames + embeddings,
`search` runs hybrid retrieval over commits, `stats` reports corpus counters; the
SwiftTUI front-end maps to plain CLI output here).
"""
from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass
from pathlib import Path

from wax_tpu_torch.orchestrator.config import OrchestratorConfig
from wax_tpu_torch.orchestrator.orchestrator import MemoryOrchestrator
from wax_tpu_torch.types import SearchRequest

__all__ = ["GitCommit", "parse_git_log", "RepoIndexer"]

COMMIT_KIND = "wax.repo.commit"
_SEP = "\x1e"  # record separator
_FIELD = "\x1f"


@dataclass(frozen=True)
class GitCommit:
    sha: str
    author: str
    email: str
    timestamp_ms: int
    subject: str
    body: str
    files: tuple[str, ...]

    def document(self) -> str:
        parts = [self.subject]
        if self.body.strip():
            parts.append(self.body.strip())
        if self.files:
            parts.append("files: " + " ".join(self.files))
        return "\n".join(parts)


def parse_git_log(repo_path: str | Path, max_commits: int | None = None) -> list[GitCommit]:
    """Parse `git log` into structured commits (reference: Git/GitLogParser.swift)."""
    fmt = _SEP + _FIELD.join(["%H", "%an", "%ae", "%at", "%s", "%b"])
    cmd = ["git", "-C", str(repo_path), "log", f"--pretty=format:{fmt}", "--name-only"]
    if max_commits:
        cmd.append(f"-n{max_commits}")
    out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    commits: list[GitCommit] = []
    for record in out.split(_SEP):
        if not record.strip():
            continue
        head, _, tail = record.partition("\n")
        fields = head.split(_FIELD)
        if len(fields) < 6:
            continue
        sha, author, email, at, subject, body_first = fields[:6]
        # body may continue until the file list; file names are the trailing
        # non-empty lines after a blank separator
        lines = tail.splitlines()
        body_lines, files = [body_first], []
        for ln in lines:
            if ln.strip() and "/" not in ln and "." not in ln and not files:
                body_lines.append(ln)
            elif ln.strip():
                files.append(ln.strip())
        commits.append(
            GitCommit(
                sha=sha,
                author=author,
                email=email,
                timestamp_ms=int(at) * 1000,
                subject=subject,
                body="\n".join(body_lines).strip(),
                files=tuple(files),
            )
        )
    return commits


class RepoIndexer:
    """Index + search a git repository's history."""

    def __init__(
        self, store_path: str | Path, embedder=None, config: OrchestratorConfig | None = None, device=None
    ):
        self.orch = MemoryOrchestrator(store_path, embedder, config or OrchestratorConfig(), device=device)
        self._indexed_shas: set[str] = {
            m.metadata["sha"]
            for m in self.orch.store.timeline(include_superseded=True)
            if m.kind == COMMIT_KIND and "sha" in m.metadata
        }

    def index(self, repo_path: str | Path, max_commits: int | None = None) -> int:
        """Incremental: already-indexed commits are skipped by sha."""
        added = 0
        for c in parse_git_log(repo_path, max_commits):
            if c.sha in self._indexed_shas:
                continue
            self.orch.remember(
                c.document(),
                metadata={
                    "sha": c.sha,
                    "author": c.author,
                    "email": c.email,
                    "files": ",".join(c.files[:50]),
                },
                timestamp_ms=c.timestamp_ms,
                kind=COMMIT_KIND,
            )
            self._indexed_shas.add(c.sha)
            added += 1
        if added:
            self.orch.flush()
        return added

    def search(self, query: str, top_k: int = 10) -> list[dict]:
        resp = self.orch.search(SearchRequest(query=query, top_k=top_k))
        out = []
        for h in resp.hits:
            m = self.orch.store.frame_meta(h.frame_id)
            if m is None or m.kind != COMMIT_KIND:
                # chunk of a long commit message: resolve to its parent commit frame
                if m is not None and m.parent_id is not None:
                    m = self.orch.store.frame_meta(m.parent_id)
                if m is None or m.kind != COMMIT_KIND:
                    continue
            out.append(
                {
                    "sha": m.metadata.get("sha", ""),
                    "author": m.metadata.get("author", ""),
                    "timestamp_ms": m.timestamp_ms,
                    "score": round(h.score, 6),
                    "preview": h.preview[:160],
                }
            )
        return out

    def stats(self) -> dict:
        return {"commits": len(self._indexed_shas), **self.orch.runtime_stats()}

    def close(self) -> None:
        self.orch.close()


def add_repo_commands(sub) -> None:
    """Wire `wax-tpu repo ...` subcommands into the CLI parser."""
    repo = sub.add_parser("repo", help="semantic git-history search (Sift)")
    repo_sub = repo.add_subparsers(dest="repo_cmd", required=True)

    p = repo_sub.add_parser("index", help="index a git repository's history")
    p.add_argument("path", nargs="?", default=".")
    p.add_argument("--max-commits", type=int, default=None)
    p.add_argument("--store", default=None)
    p.set_defaults(fn=_cmd_index)

    p = repo_sub.add_parser("search", help="search indexed commits")
    p.add_argument("query")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--store", default=None)
    p.set_defaults(fn=_cmd_search)

    p = repo_sub.add_parser("stats", help="index statistics")
    p.add_argument("--store", default=None)
    p.set_defaults(fn=_cmd_stats)

    p = repo_sub.add_parser("tui", help="interactive search TUI (live query, result list, preview)")
    p.add_argument("path", nargs="?", default=None, help="git repo to (re)index before launching")
    p.add_argument("--max-commits", type=int, default=None)
    p.add_argument("--store", default=None)
    p.set_defaults(fn=_cmd_tui)


def _store_path(args) -> Path:
    if args.store:
        return Path(args.store)
    return Path.home() / ".wax-tpu" / "repo.wxs"


def _cmd_index(args) -> int:
    path = _store_path(args)
    path.parent.mkdir(parents=True, exist_ok=True)
    idx = RepoIndexer(path, device=args.device)
    try:
        added = idx.index(args.path, args.max_commits)
        print(json.dumps({"indexed": added, "total": idx.stats()["commits"]}))
    finally:
        idx.close()
    return 0


def _cmd_search(args) -> int:
    idx = RepoIndexer(_store_path(args), device=args.device)
    try:
        for hit in idx.search(args.query, args.top_k):
            print(json.dumps(hit))
    finally:
        idx.close()
    return 0


def _cmd_stats(args) -> int:
    idx = RepoIndexer(_store_path(args), device=args.device)
    try:
        print(json.dumps({"commits": idx.stats()["commits"]}))
    finally:
        idx.close()
    return 0


def _cmd_tui(args) -> int:
    """Launch the interactive TUI (reference: SwiftTUI WaxRepo app,
    Sources/WaxRepo/Views/)."""
    from wax_tpu_torch.surfaces.repo_tui import run_tui

    path = _store_path(args)
    path.parent.mkdir(parents=True, exist_ok=True)
    idx = RepoIndexer(path, device=args.device)
    try:
        if args.path:
            added = idx.index(args.path, args.max_commits)
            print(f"indexed {added} new commits", flush=True)
        run_tui(idx)
    finally:
        idx.close()
    return 0
