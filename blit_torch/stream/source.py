"""Chunk sources of the live plane.

Counterpart of ``blit/stream/source.py``.  A :class:`ChunkSource`
delivers a recorder's output as :class:`StreamChunk` s, one GUPPI RAW
block each, tagged with its stream sequence number:

- :class:`FileTailSource` follows a RAW file (or a growing ``.NNNN.raw``
  sequence) while the recorder appends to it: a block is delivered once
  its header parses and all ``BLOCSIZE`` bytes are on disk, never
  half-written, and the tail moves on to the next member when it
  appears.  The session ends at a ``<stem>.done`` marker, or after
  ``idle_timeout_s`` without growth.
- :class:`ReplaySource` replays an at-rest recording at its TBIN cadence
  times ``rate``: block ``i`` is due when a recorder would have finished
  writing it; ``late={seq: extra_s}`` defers single chunks.
- :class:`QueueSource` is the in-memory source the tests push chunks
  into, in any order.

The contract is pull-based: ``get(timeout)`` returns the next chunk or
``None``; ``finished`` turns True once everything was delivered, and
``total`` then gives the chunk count when the source knows it.  Order,
gaps and duplicates are the assembler's to repair
(:class:`blit_torch.stream.plane.LiveRawStream`).  A source that
recycles its buffers (a recorder's RAM ring) gives each chunk an
``on_release`` hook (:class:`StreamChunk`) and refills a buffer only
once it fired: the assembler releases a chunk it drops at once and a
fed one once the reducer is done with it.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from blit_torch import observability
from blit_torch.io.guppi import (
    SEQ_RE,
    block_ntime,
    read_raw_header,
)

log = logging.getLogger("blit_torch.stream")


class StreamChunk:
    """One recorder chunk: a GUPPI RAW block plus its stream identity.
    ``t_arrival`` (monotonic-clock) is stamped by the assembler at
    receipt — the timestamp every latency/watermark decision keys on.
    ``masked`` chunks are watermark placeholders for data that never
    arrived: ``data`` is None and the feed zero-fills their samples.

    ``on_release(chunk)`` is a recycling source's hook: it fires once,
    when nothing reads ``data`` any more, and only then may the source
    refill the buffer.  The delivery is one hold; a reader that keeps
    reading ``data`` after its holder let go (a reducer's chunk plan,
    until the card has read it) takes one more with :meth:`hold`, and
    every hold ends with one :meth:`release`."""

    __slots__ = ("seq", "header", "data", "t_arrival", "masked",
                 "_on_release", "_holds")

    def __init__(self, seq: int, header: Dict,
                 data: Optional[np.ndarray],
                 t_arrival: Optional[float] = None,
                 masked: bool = False,
                 on_release: Optional[Callable[["StreamChunk"], None]] = None
                 ) -> None:
        self.seq = seq
        self.header = header
        self.data = data
        self.t_arrival = t_arrival
        self.masked = masked
        self._on_release = on_release
        self._holds = 1

    def hold(self) -> None:
        with _HOLDS:
            if self._holds <= 0:
                raise RuntimeError(f"stream chunk {self.seq} was released")
            self._holds += 1

    def release(self) -> None:
        with _HOLDS:
            self._holds -= 1
            if self._holds != 0:
                return
            hook, self._on_release = self._on_release, None
        if hook is not None:
            hook(self)


_HOLDS = threading.Lock()


class ChunkSource:
    """The pull contract (module docstring).  Subclasses implement
    :meth:`get` and keep :attr:`finished` / :attr:`total` honest."""

    path: str = "<stream>"
    finished: bool = False
    total: Optional[int] = None

    def get(self, timeout: float) -> Optional[StreamChunk]:
        raise NotImplementedError

    def close(self) -> None:
        """Release any held resources (idempotent)."""

    def stop(self) -> None:
        """Graceful drain: deliver nothing more —
        the session ends cleanly with the chunks that already arrived
        (the assembler totals what was delivered), so a draining serve
        process finishes its in-flight live product, releases its
        capacity hold, and — with ``resume=True`` — leaves a rejoinable
        cursor for the consumer that takes over."""
        self.finished = True


class QueueSource(ChunkSource):
    """In-memory source: :meth:`push` chunks from the test (any order),
    then :meth:`finish` — optionally declaring the stream's true chunk
    count so never-pushed sequence numbers read as gaps to mask rather
    than an early end."""

    _EOS = object()

    def __init__(self, path: str = "<queue>"):
        self.path = path
        self._q: "queue.Queue" = queue.Queue()
        self.finished = False
        self.total: Optional[int] = None
        self._declared: Optional[int] = None

    def push(self, chunk: StreamChunk) -> None:
        self._q.put(chunk)

    def finish(self, total: Optional[int] = None) -> None:
        self._declared = total
        self._q.put(self._EOS)

    def get(self, timeout: float) -> Optional[StreamChunk]:
        if self.finished:
            return None
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._EOS:
            self.finished = True
            self.total = self._declared
            return None
        return item


def chunks_of(raw) -> List[StreamChunk]:
    """An at-rest recording's blocks as a chunk list (QueueSource feed
    for tests): ``chunks_of(open_raw(path))``."""
    return [
        StreamChunk(i, raw.header(i), raw.read_block(i))
        for i in range(raw.nblocks)
    ]


class ReplaySource(ChunkSource):
    """Replay an at-rest recording at recording cadence (module
    docstring).  ``rate`` multiplies wall-clock speed (1.0 = exactly as
    recorded, per TBIN); chunk ``i`` is due once the recorder would have
    finished writing block ``i``.  ``late`` defers individual chunks
    past their natural slot — delivery stays in *due-time* order, so a
    deferred chunk genuinely arrives after its successors (the seeded
    late-chunk drill)."""

    def __init__(self, raw, rate: float = 1.0,
                 late: Optional[Dict[int, float]] = None,
                 clock=time.monotonic, sleep=time.sleep):
        from blit_torch.io.guppi import open_raw

        self.raw = raw if hasattr(raw, "nblocks") else open_raw(raw)
        self.path = getattr(self.raw, "path", "<replay>")
        if rate <= 0:
            raise ValueError(f"replay rate must be > 0, got {rate}")
        self.rate = rate
        self._clock = clock
        self._sleep = sleep
        self.total = None  # published at finish, the source contract
        self._nblocks = self.raw.nblocks
        tbin = float(self.raw.header(0).get("TBIN", 0.0) or 0.0)
        late = late or {}
        cum = 0
        sched: List[Tuple[float, int]] = []
        for i in range(self._nblocks):
            cum += self.raw.block_ntime_kept(i)
            due = cum * tbin / rate + late.get(i, 0.0)
            sched.append((due, i))
        # Due-time order IS delivery order: a deferred chunk arrives
        # after whatever overtook it.
        self._sched = sorted(sched)
        self._pos = 0
        self._t0: Optional[float] = None

    def get(self, timeout: float) -> Optional[StreamChunk]:
        if self.finished:
            return None  # stop() mid-replay: drain with what arrived
        if self._pos >= len(self._sched):
            self.finished = True
            self.total = self._nblocks
            return None
        if self._t0 is None:
            self._t0 = self._clock()
        due, seq = self._sched[self._pos]
        wait = due - (self._clock() - self._t0)
        if wait > 0:
            if wait > timeout:
                self._sleep(timeout)
                return None
            self._sleep(wait)
        self._pos += 1
        return StreamChunk(seq, self.raw.header(seq),
                           self.raw.read_block(seq))


class FileTailSource(ChunkSource):
    """Follow a GUPPI RAW recording as the recorder appends (module
    docstring).  A block is delivered only once COMPLETE on disk — its
    header parses through ``END`` and all ``BLOCSIZE`` payload bytes
    exist — so a half-written tail is simply "not yet", never a
    truncated read.  With ``follow_sequence`` (default) the tailer
    advances into ``<stem>.NNNN+1.raw`` when it appears, treating any
    partial trailing block of the finished member as the recorder's
    truncation (warned, skipped) — the ``GuppiRaw`` constructor's rule.

    End of session: the ``done_path`` marker file (default
    ``<stem>.done``), or ``idle_timeout_s`` without file growth — the
    timeout path flight-dumps once (a recorder that died without its
    ``.done`` marker is an incident, not a clean end) and the current
    idle age is published as the ``stream.tail.idle_s`` gauge, so a
    silently dead recorder shows on a dashboard BEFORE the timeout
    fires.  Delivery is strictly in-order, so the assembler's watermark
    never masks behind this source — its job here is purely
    latency/liveness accounting."""

    def __init__(self, path: str, poll_s: Optional[float] = None,
                 idle_timeout_s: Optional[float] = None,
                 done_path: Optional[str] = None,
                 follow_sequence: bool = True,
                 timeline=None,
                 clock=time.monotonic, sleep=time.sleep,
                 config=None):
        from blit_torch.config import DEFAULT, stream_defaults

        d = stream_defaults(DEFAULT if config is None else config)
        self.path = path
        self.poll_s = d["poll_s"] if poll_s is None else poll_s
        self.idle_timeout_s = (d["idle_timeout_s"] if idle_timeout_s is None
                               else idle_timeout_s)
        m = SEQ_RE.match(path)
        self._stem = m.group("stem") if m else path
        self._member = int(m.group("seq")) if m else None
        self.done_path = (done_path if done_path is not None
                          else self._stem + ".done")
        self.follow_sequence = follow_sequence and m is not None
        self._clock = clock
        self._sleep = sleep
        self._cur = path
        self._offset = 0
        self._seq = 0
        self._last_size = -1
        self._last_growth = clock()
        self.total = None
        self._timeline = timeline

    def _next_member(self) -> Optional[str]:
        if not self.follow_sequence:
            return None
        nxt = f"{self._stem}.{self._member + 1:04d}.raw"
        return nxt if os.path.exists(nxt) else None

    def _gauge_idle(self, idle_s: float) -> None:
        """Publish how long the tail has seen no growth — the liveness
        signal a dashboard reads while the recorder runs (and the
        early warning before ``idle_timeout_s`` ends the session)."""
        if self._timeline is None:
            self._timeline = observability.process_timeline()
        self._timeline.gauge("stream.tail.idle_s", idle_s)

    def _try_block(self) -> Optional[StreamChunk]:
        """One complete block at the current offset, else None."""
        try:
            size = os.path.getsize(self._cur)
        except OSError:
            size = 0  # recorder has not created the file yet
        if size != self._last_size:
            self._last_size = size
            self._last_growth = self._clock()
        if size <= self._offset:
            return None
        with open(self._cur, "rb") as f:
            f.seek(self._offset)
            try:
                hdr, data_off = read_raw_header(f)
            except (EOFError, ValueError):
                return None  # header still being written
        if hdr.get("NBITS", 8) != 8:
            raise NotImplementedError(
                f"NBITS={hdr['NBITS']} not supported (GBT uses 8)")
        if data_off + hdr["BLOCSIZE"] > size:
            return None  # payload still being written
        npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
        shape = (hdr["OBSNCHAN"], block_ntime(hdr), npol, 2)
        data = np.memmap(self._cur, dtype=np.int8, mode="r",
                         offset=data_off, shape=shape)
        self._offset = data_off + hdr["BLOCSIZE"]
        seq = self._seq
        self._seq += 1
        return StreamChunk(seq, hdr, data)

    def get(self, timeout: float) -> Optional[StreamChunk]:
        if self.finished:
            return None
        deadline = self._clock() + timeout
        while True:
            c = self._try_block()
            if c is not None:
                self._last_growth = self._clock()
                return c
            nxt = self._next_member()
            done_mark = os.path.exists(self.done_path)
            if nxt is not None or done_mark:
                # The marker/member postdates every byte of the current
                # file (the recorder closes it first), but it may have
                # appeared AFTER the poll above saw the final block
                # incomplete — drain once more before treating this as
                # a boundary, or that block would be silently lost.
                c = self._try_block()
                if c is not None:
                    self._last_growth = self._clock()
                    return c
            if nxt is not None:
                # The finished member's leftover bytes are a truncated
                # trailing block (the recorder was killed mid-write, or
                # padding): skip them, exactly as GuppiRaw's index scan
                # would.
                if self._last_size > self._offset:
                    log.warning(
                        "%s: skipping %d trailing bytes (truncated "
                        "block) at member boundary", self._cur,
                        self._last_size - self._offset)
                self._cur = nxt
                self._member += 1
                self._offset = 0
                self._last_size = -1
                self._last_growth = self._clock()
                continue
            if done_mark:
                if self._last_size > self._offset:
                    log.warning(
                        "%s: %d trailing bytes do not form a complete "
                        "block; dropped (truncated recording)",
                        self._cur, self._last_size - self._offset)
                self.finished = True
                self.total = self._seq
                return None
            now = self._clock()
            self._gauge_idle(now - self._last_growth)
            if (self.idle_timeout_s is not None
                    and now - self._last_growth > self.idle_timeout_s):
                log.warning(
                    "%s: no growth for %.1fs and no done marker at %s; "
                    "ending the tail (recorder gone?)", self._cur,
                    now - self._last_growth, self.done_path)
                observability.flight_recorder().dump(
                    f"tail idle: {self._cur} grew nothing for "
                    f"{now - self._last_growth:.1f}s with no done "
                    f"marker at {self.done_path} — recorder presumed "
                    "dead, ending the session at block "
                    f"{self._seq}", force=True)
                self.finished = True
                self.total = self._seq
                return None
            if now >= deadline:
                return None
            self._sleep(min(self.poll_s, deadline - now))
