# Copy of wax_tpu/utils/backend.py with two changes: the child lists torch's CUDA devices
# by name (`torch.cuda.get_device_name`) where the JAX module's lists `jax.devices()`, and
# the bench pre-flight's PROBE_TIMEOUT_ENV is left out (the port has no bench yet); the
# `(devices, error)` contract and DOCTOR_TIMEOUT_ENV are the same. Keep the two in step.
"""Bounded backend-liveness probe.

A hung GPU can make device initialisation stall with no way to interrupt
it in-process. Probing the CUDA devices in a child process with a hard timeout lets
callers (`wax-tpu-torch mcp doctor`) report a hung backend on a bounded clock instead
of hanging. (reference: the `wax mcp doctor` readiness checks,
Sources/WaxCLI/main.swift — every check there is bounded too.)
"""
from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["probe_backend", "DOCTOR_TIMEOUT_ENV"]

DOCTOR_TIMEOUT_ENV = "WAX_TPU_DOCTOR_TIMEOUT"  # `wax-tpu-torch mcp doctor` (default 60s)

_CHILD = (
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit('no CUDA device')\n"
    "print([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])\n"
)


def probe_backend(timeout_s: float) -> tuple[str | None, str | None]:
    """Probe CUDA initialisation in a subprocess with a hard timeout.

    Returns ``(devices, error)`` — exactly one is non-None. ``devices`` is the
    child's list of device names on success; ``error`` is a one-line diagnosis on
    timeout, on failed init or when the child finds no CUDA device. The parent's own
    (unbounded) device init is only safe AFTER a success here.
    """
    try:
        r = subprocess.run(
            [sys.executable, "-c", _CHILD],
            capture_output=True,
            timeout=timeout_s,
            text=True,
            env=os.environ.copy(),
        )
    except subprocess.TimeoutExpired:
        return None, f"backend init exceeded {timeout_s:.0f}s (device wedged)"
    if r.returncode != 0:
        tail = (r.stderr or "").strip().splitlines()
        return None, (tail[-1] if tail else f"backend init failed (rc={r.returncode})")
    out = (r.stdout or "").strip().splitlines()
    if not out:
        return None, "backend probe produced no output (rc=0)"
    return out[-1], None
