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
- :class:`BlockRegistry` page-locks a live feed's recycled host blocks in
  place (a recorder's RAM ring is a fixed set of buffers), so the card
  can read a block's rows straight into its chunk (:func:`copy_rows`)
  with no copy into a slab.  It keys a block by its buffer's address and
  length and registers it on its **second** sighting, timed as the stage
  ``ingest.register``: a source that hands a fresh array every block
  never registers anything.  Memory already page-locked counts as
  registered, with no call.  A registration the runtime refuses leaves
  the block on the copy path, is counted (``ingest.register_failed``)
  and logged once; a fault of the build or of the runtime raises, as
  the kernels' do.  A sighting ends with its array: a finalizer unregisters the
  block when the last array seen over it dies; whoever queues a DMA from
  a block holds the array until the DMA has completed.  The registry
  owns no memory; :func:`host_blocks` is the process-wide one.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from blit_torch import kernels

log = logging.getLogger("blit_torch.hostmem")

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


# -- recycled host blocks, read by the card in place ----------------------

def _dma_lib() -> ctypes.CDLL:
    """``csrc/host_dma.cu``, built on first use."""
    lib = kernels.load("host_dma")
    if lib.blit_copy_rows.argtypes is None:
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        lib.blit_host_register.argtypes = [vp, sz]
        lib.blit_host_unregister.argtypes = [vp]
        lib.blit_host_is_pinned.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
        lib.blit_copy_rows.argtypes = [vp, sz, vp, sz, sz, sz, ctypes.c_int, vp]
        lib.blit_zero_rows.argtypes = [vp, sz, sz, sz, ctypes.c_int, vp]
        for fn in (lib.blit_host_register, lib.blit_host_unregister,
                   lib.blit_host_is_pinned, lib.blit_zero_rows,
                   lib.blit_copy_rows):
            fn.restype = ctypes.c_int
    return lib


class CudaHostRegistrar:
    """Page-locking through the CUDA runtime (:class:`BlockRegistry`'s
    default): ``is_pinned(ptr, nbytes)``, ``register(ptr, nbytes)`` (0 or
    the CUDA error code) and ``unregister(ptr)``."""

    def is_pinned(self, ptr: int, nbytes: int) -> bool:
        lib = _dma_lib()
        for p in (ptr, ptr + nbytes - 1):
            out = ctypes.c_int(0)
            kernels.check(lib, lib.blit_host_is_pinned(p, ctypes.byref(out)),
                          "is_pinned")
            if not out.value:
                return False
        return True

    def register(self, ptr: int, nbytes: int) -> int:
        return _dma_lib().blit_host_register(ptr, nbytes)

    def unregister(self, ptr: int) -> None:
        _dma_lib().blit_host_unregister(ptr)


_SEEN, _BUSY, _REGISTERED, _PINNED, _FAILED = range(5)


class _Sighting:
    __slots__ = ("state", "owners")

    def __init__(self):
        self.state = _SEEN
        self.owners: Dict[int, weakref.finalize] = {}


class BlockRegistry:
    """The registry of recycled host blocks (module docstring).

    Thread-safe: every bank's producer sights its blocks concurrently,
    and a finalizer runs on whichever thread drops an array's last
    reference."""

    def __init__(self, registrar=None):
        self._registrar = registrar
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[int, int], _Sighting] = {}
        self.registered = 0
        self.pinned = 0
        self.failed = 0
        self.unregistered = 0

    @property
    def registrar(self):
        if self._registrar is None:
            self._registrar = CudaHostRegistrar()
        return self._registrar

    def _own(self, e: _Sighting, key: Tuple[int, int], block) -> None:
        fin = weakref.finalize(block, self._release, key, id(block))
        fin.atexit = False  # the process's end frees the memory anyway
        e.owners[id(block)] = fin

    def sight(self, block: np.ndarray, timeline=None) -> bool:
        """Note a sighting of ``block`` (a C-contiguous array); True when
        its bytes are page-locked, so a DMA may read them in place."""
        key = (block.ctypes.data, block.nbytes)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _Sighting()
                self._own(e, key, block)
                return False
            if id(block) not in e.owners:
                self._own(e, key, block)
            if e.state != _SEEN:
                return e.state in (_REGISTERED, _PINNED)
            e.state = _BUSY
        t0 = time.perf_counter()
        err = 0
        try:
            if self.registrar.is_pinned(*key):
                state = _PINNED
            else:
                err = self.registrar.register(*key)
                state = _REGISTERED if err == 0 else _FAILED
        except BaseException:
            with self._lock:
                e.state = _SEEN  # a build or CUDA fault raises, as kernels do
            raise
        dt = time.perf_counter() - t0
        with self._lock:
            e.state = state
            if state == _REGISTERED:
                self.registered += 1
            elif state == _PINNED:
                self.pinned += 1
            else:
                self.failed += 1
                first = self.failed == 1
        if timeline is not None:
            st = timeline.stages["ingest.register"]
            st.calls += 1
            st.seconds += dt
            if state == _FAILED:
                timeline.count("ingest.register_failed")
        if state == _FAILED and first:
            log.warning("page-locking a %d-byte host block failed (CUDA "
                        "error %d); blocks that fail stay on the copy path",
                        key[1], err)
        return state != _FAILED

    def _release(self, key: Tuple[int, int], oid: int) -> None:
        """Finalizer of an array seen over ``key``: the last one to die
        ends the sighting and unregisters what this registry locked."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.owners.pop(oid, None) is None or e.owners:
                return
            del self._entries[key]
            owned = e.state == _REGISTERED
            if owned:
                self.unregistered += 1
        if owned:
            self.registrar.unregister(key[0])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"blocks": len(self._entries),
                    "registered": self.registered, "pinned": self.pinned,
                    "failed": self.failed, "unregistered": self.unregistered}


_BLOCKS: Optional[BlockRegistry] = None


def host_blocks() -> BlockRegistry:
    """The process-wide block registry."""
    global _BLOCKS
    with _POOL_LOCK:
        if _BLOCKS is None:
            _BLOCKS = BlockRegistry()
        return _BLOCKS


def _rows(a: Union[np.ndarray, torch.Tensor], t: int, n: int):
    """(address of sample ``t`` of row 0, row pitch, bytes a sample) of a
    ``(rows, samples, ...)`` array or tensor whose rows are dense,
    checking that samples ``[t, t+n)`` exist."""
    if isinstance(a, torch.Tensor):
        es = a.element_size()
        ptr, shape, strides = a.data_ptr(), tuple(a.shape), [s * es for s in a.stride()]
    else:
        es = a.itemsize
        ptr, shape, strides = a.ctypes.data, a.shape, list(a.strides)
    sample, dense = es, len(shape) >= 2
    for k in range(len(shape) - 1, 1, -1):
        dense = dense and (shape[k] == 1 or strides[k] == sample)
        sample *= shape[k]
    if not dense or strides[1] != sample or t < 0 or t + n > shape[1]:
        raise ValueError(f"copy_rows: samples [{t}, {t + n}) of an array of "
                         f"shape {tuple(shape)}, strides {strides}")
    return ptr + t * sample, strides[0], sample


def copy_rows(dst: torch.Tensor, dst_t: int, src, src_t: int, n: int) -> None:
    """Copy samples ``[src_t, src_t+n)`` of every row of ``src`` (a host
    array, page-locked, or a device tensor) to samples ``[dst_t,
    dst_t+n)`` of the device tensor ``dst``, one ``cudaMemcpy2DAsync`` on
    ``dst``'s current stream.  Rows are the first axis (coarse channels)
    and must agree; so must the bytes a sample."""
    dp, dpitch, ds = _rows(dst, dst_t, n)
    sp, spitch, ss = _rows(src, src_t, n)
    if ds != ss or dst.shape[0] != src.shape[0]:
        raise ValueError(f"copy_rows: {tuple(src.shape)} into {tuple(dst.shape)}")
    if n == 0 or dst.shape[0] == 0:
        return
    lib = _dma_lib()
    ctx, stream = kernels.launch_stream(dst.device)
    with ctx:
        rc = lib.blit_copy_rows(dp, dpitch, sp, spitch, n * ds, dst.shape[0],
                                dst.device.index or 0, stream)
    kernels.check(lib, rc, "copy_rows")


def zero_rows(dst: torch.Tensor, dst_t: int, n: int) -> None:
    """Zero samples ``[dst_t, dst_t+n)`` of every row of the device tensor
    ``dst``, one ``cudaMemset2DAsync`` on its current stream."""
    dp, dpitch, ds = _rows(dst, dst_t, n)
    if n == 0 or dst.shape[0] == 0:
        return
    lib = _dma_lib()
    ctx, stream = kernels.launch_stream(dst.device)
    with ctx:
        rc = lib.blit_zero_rows(dp, dpitch, n * ds, dst.shape[0],
                                dst.device.index or 0, stream)
    kernels.check(lib, rc, "zero_rows")
