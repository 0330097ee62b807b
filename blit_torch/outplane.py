"""The asynchronous output plane: device→host readback on a thread of
its own, write-behind product sinks, and the lag bookkeeping of the
on-device folds.

Counterpart of ``blit/outplane.py``.  The ingest rotation
(:class:`blit_torch.pipeline.BufferRotation`) keeps the host read off the
dispatch thread; this module does the same for the result side, so the
host read, the device's work, the device→host copy and the disk write
run at once instead of one after another.

- :class:`OutputRotation` keeps up to ``depth`` dispatched device
  outputs in flight.  Its readback thread takes them in put order:
  it waits on each one's ``torch.cuda.Event`` (recorded by the dispatch
  thread right after the launches; the wait is the ``device`` stage),
  fires ``on_consumed`` (the dispatch's inputs are free now: release the
  ingest slot), then copies the output to the host on the thread's own
  CUDA stream, after ``wait_event``, so the copy does not queue behind
  the next dispatch's kernels on the default stream (``readback``).
  The output tensor stays referenced until that copy has synchronized,
  so the caching allocator cannot hand its memory to a later dispatch
  while the copy still reads it.  :meth:`OutputRotation.put` blocks
  while ``depth`` outputs are pending (timed as ``dispatch.put_wait``,
  the dispatch thread's wait); the thread blocks while every ring slab
  is held downstream.
- ``reuse=True`` copies into a ring of at most ``depth + 1`` host slabs
  from the staging pool (:mod:`blit_torch.hostmem`; pinned on a CUDA
  device, so the copy is a ``non_blocking`` DMA), released by the
  consumer and recycled.  ``reuse=False`` emits arrays the caller keeps:
  on a CUDA device a fresh pageable allocation the copy lands in (CUDA
  stages it through pinned memory of its own), on the CPU the output's
  own memory, no copy.
- :class:`AsyncSink` runs a slab writer's ``append`` on a thread behind
  a bounded queue, with :meth:`AsyncSink.flush` barriers and writer
  errors re-raised on the caller's side.  Each append fires the
  ``sink.write`` and each barrier the ``sink.flush`` injection point of
  :mod:`blit_torch.faults` on the sink's thread, keyed by the writer's
  path, as ``blit``'s does.
- :class:`FoldInFlight`: the lag-``depth`` release of windows consumed
  by on-device folds (``beamform_accumulate``, ``correlate_stream``).

On the CPU there is no event (the output is ready when the dispatch
returns); the threads, the ring and the sink run all the same.  Outputs
are byte-identical to the synchronous path: the same tensors are
copied, in order, and appended in order.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from blit_torch import faults, hostmem
from blit_torch.observability import StallWatchdog, Timeline

log = logging.getLogger("blit_torch.outplane")

_EOF = object()

# The output plane's per-chunk histograms (blit's), as the tune command
# and the online tuner read them: readback lag (put to the readback
# thread picking the output up), per-chunk service latency (the event
# wait and the host copy) and per-append write time.
INGEST_HISTS = ("out.chunk_latency_s", "out.readback_lag_s", "out.write_s")


def readback_extra_slots(out_depth: int, prefetch_depth: int) -> int:
    """Slots an ingest rotation needs beyond ``prefetch_depth`` when an
    :class:`OutputRotation` of ``out_depth`` pins un-synchronized inputs:
    the difference, plus one read-ahead slot."""
    return 1 + max(0, max(2, out_depth) - max(2, prefetch_depth))


def record_event(out: torch.Tensor) -> Optional[torch.cuda.Event]:
    """An event on ``out``'s device's current stream, recorded now (None
    on the CPU, where a dispatch is done when it returns)."""
    if out.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    return ev


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 tensor."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class OutputSlab:
    """A completed readback: ``data`` is the host product.  The consumer
    must :meth:`release` every slab once nothing reads ``data`` any more;
    in ring mode the storage is then recycled (idempotent)."""

    __slots__ = ("data", "payload", "_release")

    def __init__(self, data: np.ndarray, payload, release) -> None:
        self.data = data
        self.payload = payload
        self._release = release

    def release(self) -> None:
        if self._release is not None:
            rel, self._release = self._release, None
            rel()


class OutputRotation:
    """The readback thread (module docstring).

    - :meth:`put` hands a dispatched output and its event to the thread
      and returns the slabs completed so far, in stream order; it blocks
      while ``depth`` outputs are pending.
    - ``on_consumed`` fires on the readback thread once the event has
      completed, before the copy.
    - :meth:`drain` ends the stream and yields the remaining slabs.
      Readback errors re-raise in the consumer from :meth:`put` and
      :meth:`drain`, every time they are called.
    - :meth:`close` stops and joins the thread, bounded: a thread wedged
      in a device wait is abandoned with a warning."""

    def __init__(self, depth: int = 1, *, timeline: Optional[Timeline] = None,
                 reuse: bool = False, name: str = "blit-readback",
                 stall_timeout_s: Optional[float] = None):
        self.depth = max(1, depth)
        self.reuse = reuse
        self.stall_timeout_s = stall_timeout_s
        self._tl = timeline if timeline is not None else Timeline()
        self._in: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0
        self._done: deque = deque()
        self._exc: Optional[BaseException] = None
        self._eof = False
        self._stop = threading.Event()
        self._free: List[hostmem.HostSlab] = []
        self._nslabs = 0
        self._streams = {}
        self._wd = StallWatchdog(
            stall_timeout_s, name,
            what="a wedged device wait would otherwise hang the stream")
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # -- readback thread ---------------------------------------------------
    def _run(self) -> None:
        try:
            while True:
                try:
                    item = self._in.get(timeout=0.2)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
                if item is _EOF:
                    with self._cv:
                        self._eof = True
                        self._cv.notify_all()
                    return
                out, event, nbytes, payload, on_consumed, t_enq, seq = item
                del item
                t_got = time.perf_counter()
                self._tl.observe("out.readback_lag_s", t_got - t_enq)
                self._wd.beat()
                with self._tl.stage("device", nbytes=nbytes or 0,
                                    byte_free=nbytes is None, seq=seq):
                    if event is not None:
                        event.synchronize()
                if on_consumed is not None:
                    on_consumed()
                self._wd.beat()
                if out is None:
                    # An ordering-only put: nothing to copy.
                    with self._cv:
                        self._pending -= 1
                        self._cv.notify_all()
                    continue
                with self._tl.stage("readback", seq=seq):
                    host, slab = self._fetch(out, event)
                    if host is None:
                        return  # closed while waiting for a ring slab
                self._tl.stages["readback"].bytes += host.nbytes
                del out
                self._wd.beat()
                release = None if slab is None else (
                    lambda s=slab: self._release_slab(s))
                self._tl.observe("out.chunk_latency_s",
                                 time.perf_counter() - t_got)
                with self._cv:
                    self._pending -= 1
                    self._done.append(OutputSlab(host, payload, release))
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            with self._cv:
                self._exc = e
                self._cv.notify_all()

    def _stream(self, dev: torch.device):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _fetch(self, out: torch.Tensor, event):
        """``(host array, ring slab or None)``: the output's bytes on the
        host."""
        shape, dtype = tuple(out.shape), hostmem.numpy_dtype(out.dtype)
        if out.device.type != "cuda":
            if not self.reuse:
                return _as_bytes(out).numpy().view(dtype).reshape(shape), None
            slab = self._take_slab(shape, dtype, pinned=False)
            if slab is None:
                return None, None
            slab.bytes.copy_(_as_bytes(out))
            return slab.array, slab
        dev = out.device
        # Without an event, the default stream orders the copy after the
        # dispatch (and holds it behind the next one).
        stream = (self._stream(dev) if event is not None
                  else torch.cuda.default_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if event is not None:
                stream.wait_event(event)
            if self.reuse:
                slab = self._take_slab(shape, dtype, pinned=True)
                if slab is None:
                    return None, None
                slab.bytes.copy_(_as_bytes(out), non_blocking=True)
                stream.synchronize()
                return slab.array, slab
            host = np.empty(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize,
                            np.uint8)
            torch.from_numpy(host).copy_(_as_bytes(out))
            stream.synchronize()
            return host.view(dtype).reshape(shape), None

    def _take_slab(self, shape, dtype, pinned: bool):
        """A free ring slab of ``(shape, dtype)``: allocating up to
        ``depth + 1``, replacing a free slab of another shape at the
        limit (the short last chunk), else waiting for a release (that
        wait is back-pressure, and beats).  None if closed meanwhile."""
        key = (tuple(shape), np.dtype(dtype).str, pinned)
        evicted = None
        with self._cv:
            while True:
                for i, s in enumerate(self._free):
                    if s.key == key:
                        return self._free.pop(i)
                if self._nslabs <= self.depth:
                    self._nslabs += 1
                    break
                if self._free:
                    evicted = self._free.pop()
                    break
                if self._stop.is_set():
                    return None
                self._wd.beat()
                self._cv.wait(timeout=0.2)
        pool = hostmem.slab_pool()
        if evicted is not None:
            pool.give(evicted)
        return pool.take(shape, dtype, pinned=pinned, timeline=self._tl)

    def _release_slab(self, slab) -> None:
        with self._cv:
            if not self._stop.is_set():
                self._free.append(slab)
                self._cv.notify_all()
                return
        # Released after close() swept the ring (the sink's write-behind
        # tail): straight to the staging pool.
        hostmem.slab_pool().give(slab)

    # -- consumer side -----------------------------------------------------
    def _check(self) -> None:
        if self._exc is not None:
            raise self._exc
        if self._pending > 0:
            self._wd.check("readback stalled", active=self._thread.is_alive())

    def put(self, out: Optional[torch.Tensor], *, event=None,
            nbytes: Optional[int] = None, payload=None,
            on_consumed: Optional[Callable[[], None]] = None,
            seq: Optional[int] = None) -> List[OutputSlab]:
        """Hand a dispatched output to the readback thread; return the
        slabs completed so far, blocking while ``depth`` are pending (the
        stage ``dispatch.put_wait``).  ``event`` is waited on before
        ``on_consumed`` and the copy (None: the output is ready; any
        object with ``synchronize()`` serves for an ordering-only put);
        ``nbytes`` (the dispatch's input bytes) lands on the ``device``
        stage; ``seq`` (the chunk's sequence number) on the spans of the
        put and of its ``device`` and ``readback`` stages.  ``out=None``
        copies nothing and yields no slab: the put only orders
        ``on_consumed`` after the event and back-pressures like any
        other."""
        with self._tl.stage("dispatch.put_wait", byte_free=True, seq=seq):
            with self._cv:
                self._check()
                self._pending += 1
            self._in.put((out, event, nbytes, payload, on_consumed,
                          time.perf_counter(), seq))
            ready: List[OutputSlab] = []
            poll = self._wd.poll_s(0.2)
            with self._cv:
                while True:
                    while self._done:
                        ready.append(self._done.popleft())
                    self._check()
                    if self._pending < self.depth:
                        return ready
                    self._cv.wait(timeout=poll)

    def drain(self) -> Iterator[OutputSlab]:
        """End the stream: yield every remaining slab in order."""
        self._in.put(_EOF)
        poll = self._wd.poll_s(0.2)
        while True:
            batch: List[OutputSlab] = []
            finished = False
            with self._cv:
                while True:
                    while self._done:
                        batch.append(self._done.popleft())
                    self._check()
                    if self._eof:
                        finished = True
                        break
                    if batch:
                        break
                    self._cv.wait(timeout=poll)
            # Outside the lock: releases re-enter it.
            yield from batch
            if finished:
                return

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop and join the readback thread (idempotent, bounded), then
        retire the free ring slabs to the staging pool."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=join_timeout_s)
        if self._thread.is_alive():
            log.warning("%s: readback thread did not exit within %.1fs of "
                        "close; abandoning the daemon thread",
                        self._thread.name, join_timeout_s)
            return
        pool = hostmem.slab_pool()
        with self._cv:
            free, self._free = self._free, []
        for s in free:
            pool.give(s)


class _FlushBarrier:
    __slots__ = ("event",)

    def __init__(self) -> None:
        self.event = threading.Event()


_SINK_STOP = object()


class AsyncSink:
    """A bounded-queue write-behind writer around any slab writer with
    ``append(slab)`` / ``close()`` / ``abort()`` (and optionally
    ``flush()``): :meth:`append` enqueues and returns, the write runs on
    the sink's thread, timed as the stage ``stage``; the queue holds
    ``depth`` slabs, so a slow disk back-pressures the plane.

    A writer-thread error is held and re-raised on the caller's side at
    the next :meth:`append`, :meth:`flush` or :meth:`close`; slabs queued
    after it are skipped but still released, and the thread drains to
    its stop sentinel.  :meth:`close` flushes, joins and finalizes the
    writer on the calling thread (not after a failure); :meth:`abort`
    joins and aborts it, never raising.  ``key`` (default: the writer's
    ``path``) keys the ``sink.write`` / ``sink.flush`` fault points."""

    def __init__(self, writer, *, depth: int = 2,
                 timeline: Optional[Timeline] = None, name: str = "blit-sink",
                 stall_timeout_s: Optional[float] = None, stage: str = "write",
                 key=None):
        self._writer = writer
        self._key = key if key is not None else getattr(writer, "path", None)
        self._stage = stage
        self._tl = timeline if timeline is not None else Timeline()
        self.stall_timeout_s = stall_timeout_s
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[BaseException] = None
        self._stopped = False
        self._stop_ev = threading.Event()
        self._wd = StallWatchdog(
            stall_timeout_s, name,
            what="a wedged disk append would otherwise hang the plane")
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # -- writer thread -----------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop_ev.is_set():
                    return
                continue
            if item is _SINK_STOP:
                return
            self._wd.beat()
            if isinstance(item, _FlushBarrier):
                if self._exc is None:
                    fl = getattr(self._writer, "flush", None)
                    try:
                        faults.fire("sink.flush", key=self._key)
                        if fl is not None:
                            with self._tl.stage("flush", byte_free=True):
                                fl()
                    except BaseException as e:  # noqa: BLE001 — consumer re-raises
                        self._exc = e
                item.event.set()
                continue
            slab, release = item
            if self._exc is None:
                try:
                    faults.fire("sink.write", key=self._key)
                    t0 = time.perf_counter()
                    with self._tl.stage(self._stage, nbytes=slab.nbytes):
                        self._writer.append(slab)
                    self._tl.observe("out.write_s", time.perf_counter() - t0)
                except BaseException as e:  # noqa: BLE001 — consumer re-raises
                    self._exc = e
            if release is not None:
                release()
            self._wd.beat()

    # -- consumer side -----------------------------------------------------
    def _check(self) -> None:
        if self._exc is not None:
            raise self._exc

    def _put(self, item) -> None:
        poll = self._wd.poll_s(0.2)
        while True:
            try:
                self._q.put(item, timeout=poll)
                return
            except queue.Full:
                self._check()
                self._wd.check("writer stalled", active=self._thread.is_alive())

    def append(self, slab, release: Optional[Callable[[], None]] = None) -> None:
        """Enqueue a slab; ``release`` fires on the sink thread once it
        is written (or skipped after a failure)."""
        self._check()
        self._put((slab, release))

    def flush(self) -> None:
        """Barrier: every earlier append has been applied (and the
        writer's own ``flush`` run) when this returns."""
        self._check()
        barrier = _FlushBarrier()
        self._put(barrier)
        poll = self._wd.poll_s(0.5)
        while not barrier.event.wait(timeout=poll):
            self._wd.check("writer stalled inside flush barrier",
                           active=self._thread.is_alive())
            if not self._thread.is_alive():
                break
        self._check()

    def _join(self, join_timeout_s: float) -> bool:
        if not self._stopped:
            self._stopped = True
            self._stop_ev.set()
            try:
                self._q.put_nowait(_SINK_STOP)
            except queue.Full:
                pass
        self._thread.join(timeout=join_timeout_s)
        if self._thread.is_alive():
            log.warning("%s: writer thread did not exit within %.1fs; "
                        "abandoning the daemon thread (writer left "
                        "un-finalized)", self._thread.name, join_timeout_s)
            return False
        return True

    def close(self, join_timeout_s: float = 10.0) -> None:
        self.flush()
        joined = self._join(join_timeout_s)
        self._check()
        if joined:
            self._writer.close()

    def abort(self, join_timeout_s: float = 10.0) -> None:
        joined = self._join(join_timeout_s)
        if joined:
            try:
                self._writer.abort()
            except Exception:  # noqa: BLE001 — must not mask the cause
                log.exception("async sink: writer abort failed")

    @property
    def nsamps(self) -> int:
        return self._writer.nsamps


class FoldInFlight:
    """Lag-``depth`` bookkeeping for on-device folds: each admitted window
    carries the event after the fold that consumed it (None on the CPU).
    :meth:`make_room`, called before the next fold's dispatch, waits for
    and releases the oldest windows down to ``depth`` in flight;
    :meth:`drain` waits for and releases the rest."""

    def __init__(self, timeline: Optional[Timeline] = None, depth: int = 1):
        self._tl = timeline if timeline is not None else Timeline()
        self.depth = max(1, depth)
        self._pending: deque = deque()

    def _release_oldest(self) -> None:
        win, token = self._pending.popleft()
        with self._tl.stage("device", byte_free=True):
            if token is not None:
                token.synchronize()
        win.release()

    def make_room(self) -> None:
        while len(self._pending) >= self.depth:
            self._release_oldest()

    def admit(self, win, token) -> None:
        self._pending.append((win, token))

    def drain(self) -> None:
        while self._pending:
            self._release_oldest()
