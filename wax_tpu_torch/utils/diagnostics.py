# Verbatim copy of wax_tpu/utils/diagnostics.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Diagnostics: swallowed-error logging + lightweight counters.

Mirrors the reference's WaxDiagnostics (reference:
Sources/Wax/Utilities/WaxDiagnostics.swift — logSwallowed for intentionally-swallowed
errors so they stay observable) with Python logging.
"""
from __future__ import annotations

import logging
from collections import Counter

__all__ = ["log_swallowed", "swallowed_counts", "reset_swallowed"]

_logger = logging.getLogger("wax_tpu")
_swallowed: Counter[str] = Counter()


def log_swallowed(context: str, error: BaseException) -> None:
    """Record an intentionally-swallowed error (never raises)."""
    try:
        _swallowed[context] += 1
        _logger.warning("swallowed error in %s: %s: %s", context, type(error).__name__, error)
    except Exception:  # noqa: BLE001 — diagnostics must never throw
        pass


def swallowed_counts() -> dict[str, int]:
    return dict(_swallowed)


def reset_swallowed() -> None:
    _swallowed.clear()
