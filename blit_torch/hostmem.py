"""Persistent host staging memory: page-aligned or pinned slabs in a
process-wide pool.

Counterpart of ``blit/hostmem.py``.  Every leg of the plane stages bytes
through large host buffers: the chunk rotation's int8 voltage slots
(:mod:`blit_torch.pipeline`), the readback ring of the output plane
(:mod:`blit_torch.outplane`), the search's window slots and the antenna
feeds' window slots.  Allocating them per stream puts first-touch page
faults, and on a CUDA device the page-locking of ``cudaHostAlloc``,
inside every timed stream; the pool keeps them across streams.

- A :class:`HostSlab` is one allocation handed out with two views of
  the same bytes: ``tensor``, a torch tensor of the slab's dtype and
  shape, and ``array``, its numpy view.  ``pinned=True`` allocates with
  ``torch.empty(..., pin_memory=True)`` (the CUDA host allocator), so a
  host→device copy from it, or a device→host copy into it, is a direct
  DMA that can run ``non_blocking``; otherwise the bytes are a
  page-aligned numpy array (:func:`aligned_empty`).
- :class:`SlabPool` is a free list keyed by ``(shape, dtype, pinned)``
  under a byte budget: :meth:`SlabPool.take` reuses a free slab of
  exactly that key, else allocates (timed into the caller's Timeline as
  ``staging.alloc``); :meth:`SlabPool.give` returns one, dropping it
  when it alone exceeds the budget and evicting the oldest shape class
  first when the pool would.  The budget is ``BLIT_STAGING_BYTES``, else
  ``SiteConfig.staging_pool_bytes``, else 2 GiB (``0`` disables pooling,
  the A/B lever).
  A dropped pinned slab goes back to torch's host allocator.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_ALIGN = 4096  # the page size

_DEFAULT_BUDGET = 2 << 30

_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype with the same bytes as the torch ``dtype``."""
    for k, v in _TORCH_DTYPES.items():
        if v == dtype:
            return k
    raise ValueError(f"no host staging for torch dtype {dtype}")


def aligned_empty(shape, dtype, align: int = _ALIGN) -> np.ndarray:
    """An uninitialized C-contiguous array whose data pointer is
    ``align``-byte aligned."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    raw = np.empty(nbytes + align, np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes].view(dtype).reshape(shape)


class HostSlab:
    """One staging allocation: ``tensor`` (torch, the slab's dtype and
    shape) and ``array`` (numpy) view the same bytes; ``bytes`` is the
    flat uint8 tensor over them.  ``pinned`` slabs are page-locked."""

    __slots__ = ("tensor", "array", "bytes", "pinned", "key")

    def __init__(self, shape, dtype, pinned: bool):
        dtype = np.dtype(dtype)
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if pinned:
            self.bytes = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.array = self.bytes.numpy().view(dtype).reshape(shape)
        else:
            self.array = aligned_empty(shape, dtype)
            self.bytes = torch.from_numpy(self.array.reshape(-1).view(np.uint8))
        self.tensor = self.bytes.view(_TORCH_DTYPES[dtype]).view(shape)
        self.pinned = pinned
        self.key = (shape, dtype.str, pinned)

    @property
    def nbytes(self) -> int:
        return self.array.nbytes


class SlabPool:
    """The process-wide staging free list (module docstring).

    Thread-safe: producers, readback threads and consumers take and give
    concurrently; a taken slab is the caller's until given back."""

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is None:
            # BLIT_STAGING_BYTES, else SiteConfig.staging_pool_bytes, else
            # the built-in default.
            env = os.environ.get("BLIT_STAGING_BYTES")
            if env is not None:
                budget_bytes = int(env)
            else:
                from blit_torch.config import DEFAULT

                cfg = DEFAULT.staging_pool_bytes
                budget_bytes = _DEFAULT_BUDGET if cfg is None else int(cfg)
        self.budget_bytes = budget_bytes
        self._lock = threading.Lock()
        self._free: "OrderedDict[Tuple, List[HostSlab]]" = OrderedDict()
        self._free_bytes = 0
        self.reused = 0
        self.allocated = 0
        self.dropped = 0
        self.alloc_seconds = 0.0

    def take(self, shape, dtype=np.int8, pinned: bool = False,
             timeline=None) -> HostSlab:
        """A free slab of exactly ``(shape, dtype, pinned)``, else a new
        one; a new allocation is timed into ``timeline`` as the stage
        ``staging.alloc`` (bytes: its size)."""
        key = (tuple(int(s) for s in shape), np.dtype(dtype).str, pinned)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                slab = lst.pop()
                if not lst:
                    del self._free[key]
                self._free_bytes -= slab.nbytes
                self.reused += 1
                return slab
        t0 = time.perf_counter()
        slab = HostSlab(shape, dtype, pinned)
        dt = time.perf_counter() - t0
        with self._lock:
            self.allocated += 1
            self.alloc_seconds += dt
        if timeline is not None:
            st = timeline.stages["staging.alloc"]
            st.calls += 1
            st.seconds += dt
            st.bytes += slab.nbytes
        return slab

    def give(self, slab: Optional[HostSlab]) -> None:
        """Return a slab (dropped when over budget)."""
        if slab is None:
            return
        with self._lock:
            if self.budget_bytes <= 0 or slab.nbytes > self.budget_bytes:
                self.dropped += 1
                return
            self._free.setdefault(slab.key, []).append(slab)
            self._free_bytes += slab.nbytes
            while self._free_bytes > self.budget_bytes and self._free:
                k, lst = next(iter(self._free.items()))
                old = lst.pop(0)
                if not lst:
                    del self._free[k]
                self._free_bytes -= old.nbytes
                self.dropped += 1

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "free_bytes": self._free_bytes,
                "free_slabs": sum(len(v) for v in self._free.values()),
                "reused": self.reused,
                "allocated": self.allocated,
                "dropped": self.dropped,
                "alloc_seconds": self.alloc_seconds,
                "budget_bytes": self.budget_bytes,
            }

    def clear(self) -> None:
        """Drop every free slab (the counters stay)."""
        with self._lock:
            self._free.clear()
            self._free_bytes = 0


_POOL: Optional[SlabPool] = None
_POOL_LOCK = threading.Lock()


def slab_pool() -> SlabPool:
    """The process-wide pool (built on first use, so the budget is read
    from the environment then, not at import)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = SlabPool()
        return _POOL
