# Verbatim copy of wax_tpu/surfaces/license.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Offline license validation (disabled by default).

Mirrors the reference's LicenseValidator (reference:
Sources/WaxMCPServer/LicenseValidator.swift:52 — offline HMAC-format check, disabled by
default per docs/wax-mcp-setup.md:28-30). Format: `wax-tpu-v1.<payload_b64>.<hmac_hex>`
where the HMAC-SHA256 of the payload is keyed by a deployment secret; the payload is
JSON {licensee, expires_ms?}.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from dataclasses import dataclass

__all__ = ["LicenseInfo", "validate_license", "issue_license", "license_required"]

_PREFIX = "wax-tpu-v1"


@dataclass(frozen=True)
class LicenseInfo:
    valid: bool
    licensee: str = ""
    expires_ms: int | None = None
    reason: str = ""


def license_required() -> bool:
    """Disabled by default (reference parity)."""
    return os.environ.get("WAX_TPU_FEATURE_LICENSE", "0") == "1"


def issue_license(licensee: str, secret: str, expires_ms: int | None = None) -> str:
    payload = json.dumps({"licensee": licensee, "expires_ms": expires_ms}, sort_keys=True)
    b64 = base64.urlsafe_b64encode(payload.encode()).decode().rstrip("=")
    mac = hmac.new(secret.encode(), b64.encode(), hashlib.sha256).hexdigest()
    return f"{_PREFIX}.{b64}.{mac}"


def validate_license(token: str, secret: str, now_ms: int | None = None) -> LicenseInfo:
    try:
        prefix, b64, mac = token.strip().split(".")
    except ValueError:
        return LicenseInfo(False, reason="malformed token")
    if prefix != _PREFIX:
        return LicenseInfo(False, reason="unknown format")
    expected = hmac.new(secret.encode(), b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(mac, expected):
        return LicenseInfo(False, reason="signature mismatch")
    pad = "=" * (-len(b64) % 4)
    try:
        payload = json.loads(base64.urlsafe_b64decode(b64 + pad))
    except Exception:  # noqa: BLE001
        return LicenseInfo(False, reason="bad payload")
    expires = payload.get("expires_ms")
    now = now_ms if now_ms is not None else int(time.time() * 1000)
    if expires is not None and now > expires:
        return LicenseInfo(False, payload.get("licensee", ""), expires, "expired")
    return LicenseInfo(True, payload.get("licensee", ""), expires)
