# Verbatim copy of wax_tpu/storage/fdfile.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""File descriptor IO with fault-injection plans, plus flock-based file locking.

Mirrors the reference's FDFile + FileLock pair (reference:
Sources/WaxCore/IO/FDFile.swift:43-487 — pread/pwrite/fsync/truncate wrapper whose
fault plans inject EINTR/EIO/short reads/short writes for durability tests — and
IO/FileLock.swift:8-150 — flock exclusive/shared with upgrade/downgrade).
"""
from __future__ import annotations

import errno
import fcntl
import os
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["FDFile", "FaultPlan", "FaultKind", "FileLock", "IOFault"]


class IOFault(OSError):
    """Raised by injected faults (distinguishable from genuine OS errors in tests)."""


class FaultKind:
    EINTR = "eintr"  # transient; retried ops succeed afterwards
    EIO = "eio"  # hard error
    SHORT_READ = "short_read"
    SHORT_WRITE = "short_write"


@dataclass
class FaultPlan:
    """Deterministic fault schedule: fire `kind` on the Nth matching op.

    op is one of "read" | "write" | "fsync". `remaining` counts matching calls down;
    when it hits zero the fault fires once (EINTR faults then clear, EIO persists).
    """

    op: str
    kind: str
    countdown: int = 0
    fired: bool = False
    sticky: bool = False
    short_by: int = 1

    def should_fire(self) -> bool:
        if self.fired and not self.sticky:
            return False
        if self.countdown > 0:
            self.countdown -= 1
            return False
        return True


class FDFile:
    """pread/pwrite/fsync wrapper over an fd with optional fault injection."""

    def __init__(self, path: str | Path, create: bool = False, readonly: bool = False):
        flags = os.O_RDONLY if readonly else os.O_RDWR
        if create:
            flags |= os.O_CREAT
        self.path = Path(path)
        self.fd = os.open(str(path), flags, 0o644)
        self.fault_plans: list[FaultPlan] = []
        self.stats = {"reads": 0, "writes": 0, "fsyncs": 0, "faults": 0}
        self._closed = False

    # -- fault machinery ---------------------------------------------------------------
    def inject(self, plan: FaultPlan) -> None:
        self.fault_plans.append(plan)

    def clear_faults(self) -> None:
        self.fault_plans.clear()

    def _maybe_fault(self, op: str, size: int) -> int | None:
        """Returns an adjusted size for short ops, raises for error faults."""
        for plan in self.fault_plans:
            if plan.op != op or not plan.should_fire():
                continue
            plan.fired = True
            self.stats["faults"] += 1
            if plan.kind == FaultKind.EINTR:
                raise IOFault(errno.EINTR, "injected EINTR")
            if plan.kind == FaultKind.EIO:
                raise IOFault(errno.EIO, "injected EIO")
            if plan.kind in (FaultKind.SHORT_READ, FaultKind.SHORT_WRITE):
                return max(0, size - plan.short_by)
        return None

    # -- IO ----------------------------------------------------------------------------
    def pread(self, offset: int, length: int) -> bytes:
        self.stats["reads"] += 1
        adj = self._maybe_fault("read", length)
        if adj is not None:
            length = adj
        out = b""
        while len(out) < length:
            chunk = os.pread(self.fd, length - len(out), offset + len(out))
            if not chunk:
                break
            out += chunk
        return out

    def pread_exact(self, offset: int, length: int) -> bytes:
        b = self.pread(offset, length)
        if len(b) != length:
            raise IOFault(errno.EIO, f"short read: wanted {length}, got {len(b)}")
        return b

    def pwrite(self, offset: int, data: bytes) -> int:
        self.stats["writes"] += 1
        length = len(data)
        adj = self._maybe_fault("write", length)
        if adj is not None:
            data = data[:adj]
        written = 0
        while written < len(data):
            written += os.pwrite(self.fd, data[written:], offset + written)
        return written

    def pwrite_exact(self, offset: int, data: bytes) -> None:
        n = self.pwrite(offset, data)
        if n != len(data):
            raise IOFault(errno.EIO, f"short write: wanted {len(data)}, wrote {n}")

    def fsync(self) -> None:
        self.stats["fsyncs"] += 1
        self._maybe_fault("fsync", 0)
        os.fsync(self.fd)

    def truncate(self, size: int) -> None:
        os.ftruncate(self.fd, size)

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def close(self) -> None:
        if not self._closed:
            os.close(self.fd)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class FileLock:
    """flock-based advisory lock with exclusive/shared modes and upgrade/downgrade."""

    path: Path
    _fd: int | None = field(default=None, repr=False)
    mode: str | None = None

    def acquire(self, exclusive: bool = True, blocking: bool = True) -> bool:
        if self._fd is None:
            self._fd = os.open(str(self.path), os.O_RDWR | os.O_CREAT, 0o644)
        op = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
        if not blocking:
            op |= fcntl.LOCK_NB
        try:
            fcntl.flock(self._fd, op)
        except BlockingIOError:
            return False
        self.mode = "exclusive" if exclusive else "shared"
        return True

    def downgrade(self) -> None:
        if self._fd is not None and self.mode == "exclusive":
            fcntl.flock(self._fd, fcntl.LOCK_SH)
            self.mode = "shared"

    def upgrade(self, blocking: bool = True) -> bool:
        if self._fd is None:
            return self.acquire(True, blocking)
        op = fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB)
        try:
            fcntl.flock(self._fd, op)
        except BlockingIOError:
            return False
        self.mode = "exclusive"
        return True

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
            self.mode = None
