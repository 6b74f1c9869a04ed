# Verbatim copy of wax_tpu/utils/concurrency.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Host-side concurrency primitives.

The TPU build's device path is functional (immutable snapshots + pure jitted
queries), so the reference's actor isolation mostly disappears; what remains is the
HOST-side mutable state (builders, caches, stats). `RWLock` mirrors the reference's
writer-preferring read/write phases (reference:
WaxCore/Concurrency/ReadWriteLock.swift:79-156 — AsyncReadWriteLock with FIFO
writer preference): many concurrent readers, exclusive writers, writers never
starved by a reader stream.

Semantics:
  * reentrant reads: a thread already holding a read (or THE write) may acquire
    more reads without blocking — required because public read entry points call
    each other (recall -> search).
  * reentrant writes: the writer may re-enter write() and read().
  * read -> write upgrade raises (classic deadlock shape; the codebase has no such
    path, and raising keeps it that way).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["RWLock", "FreshLockOnCopyMixin"]

_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))


class FreshLockOnCopyMixin:
    """deepcopy support for objects carrying plain locks: lock attributes are
    replaced with FRESH locks instead of failing the copy (locks are not
    deepcopy-able, and a copied object must not share its original's lock anyway).
    Needed by the process-wide engine cache, whose reclaim() deep-copies parked
    engines for exclusive ownership."""

    def __deepcopy__(self, memo):
        import copy

        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if isinstance(v, _LOCK_TYPES):
                fresh = threading.RLock() if isinstance(v, _LOCK_TYPES[1]) else threading.Lock()
                setattr(new, k, fresh)
            else:
                setattr(new, k, copy.deepcopy(v, memo))
        return new


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._active_readers = 0  # threads holding >=1 read (each counted once)
        self._writer: int | None = None
        self._writer_depth = 0
        self._writers_waiting = 0
        # FIFO tickets between writers: without them a tight writer loop (e.g. a
        # flush cycle) can BARGE — re-acquiring before a notified peer writer wakes
        # — and starve other writers indefinitely
        self._w_next_ticket = 0
        self._w_serving = 0
        # tickets abandoned by waiters that raised out of wait() (KeyboardInterrupt
        # etc.) — the serving counter must skip them or every later writer deadlocks
        self._w_abandoned: set[int] = set()
        self._local = threading.local()

    def _rdepth(self) -> int:
        return getattr(self._local, "rdepth", 0)

    # ------------------------------------------------------------------- read ----
    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me or self._rdepth() > 0:
                self._local.rdepth = self._rdepth() + 1
                return
            # writer preference: fresh readers queue behind waiting writers
            while self._writer is not None or self._writers_waiting > 0:
                self._cond.wait()
            self._active_readers += 1
            self._local.rdepth = 1
            self._local.counted = True

    def release_read(self) -> None:
        with self._cond:
            depth = self._rdepth()
            if depth <= 0:
                raise RuntimeError("release_read without acquire_read")
            self._local.rdepth = depth - 1
            if depth == 1 and getattr(self._local, "counted", False):
                self._local.counted = False
                self._active_readers -= 1
                if self._active_readers == 0:
                    self._cond.notify_all()

    # ------------------------------------------------------------------ write ----
    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_depth += 1
                return
            if self._rdepth() > 0:
                raise RuntimeError("read->write lock upgrade is not supported")
            ticket = self._w_next_ticket
            self._w_next_ticket += 1
            self._writers_waiting += 1
            acquired = False
            try:
                while (
                    self._w_serving != ticket
                    or self._writer is not None
                    or self._active_readers > 0
                ):
                    self._cond.wait()
                self._writer = me
                self._writer_depth = 1
                acquired = True
            finally:
                self._writers_waiting -= 1
                if not acquired:
                    # an exception escaped wait(): retire this ticket so the FIFO
                    # never stalls on it
                    if self._w_serving == ticket:
                        self._advance_serving()
                    else:
                        self._w_abandoned.add(ticket)
                    self._cond.notify_all()

    def _advance_serving(self) -> None:
        self._w_serving += 1
        while self._w_serving in self._w_abandoned:
            self._w_abandoned.discard(self._w_serving)
            self._w_serving += 1

    def release_write(self) -> None:
        with self._cond:
            if self._writer != threading.get_ident():
                raise RuntimeError("release_write by non-writer")
            self._writer_depth -= 1
            if self._writer_depth == 0:
                self._writer = None
                self._advance_serving()
                self._cond.notify_all()

    # ------------------------------------------------------------- contextmgrs ----
    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
