"""Host-side concurrency primitives.

Copy of `FreshLockOnCopyMixin` from wax_tpu/utils/concurrency.py (the JAX package's
`__init__` imports jax eagerly, so the port keeps its own copy). `RWLock` comes with
the orchestrator slice.
"""
from __future__ import annotations

import threading

__all__ = ["FreshLockOnCopyMixin"]

_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))


class FreshLockOnCopyMixin:
    """deepcopy support for objects carrying plain locks: lock attributes are
    replaced with FRESH locks instead of failing the copy (locks are not
    deepcopy-able, and a copied object must not share its original's lock anyway)."""

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
