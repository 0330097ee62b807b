"""Per-stage timing and byte accounting of a reduction, the stall
watchdog and the flight recorder of the threaded planes.

Counterpart of the ``Timeline`` / ``StallWatchdog`` / ``FlightRecorder``
parts of ``blit/observability.py``.  The reducer records the stages
``ingest`` (file bytes read into a host chunk slot, on the producer
thread), ``state`` (the PFB overlap copied between slots), ``dispatch``
(host→device copy and the channelizer's launches, asynchronous),
``device`` (the wait on a dispatch's event, on the readback thread;
the whole synchronous device call on the ``async_output=False`` path),
``readback`` (device→host copy of a product, bytes), ``write`` (product
bytes written, on the sink thread) and ``staging.alloc`` (host slot and
ring slab allocations, pinned on a CUDA device), plus ``stream`` (the
wall clock of the whole streaming loop).  End-to-end RAW GB/s is
``ingest`` bytes over ``stream`` seconds; :meth:`Timeline.overlap_efficiency`
is the work stages' seconds over that wall.  The search adds the stages
``search.window_fill`` (spectra copied into a window slot) and
``search.write`` (``.hits`` lines written), and the per-window
observations ``search.tree_s`` (from the dispatch of the window's H2D
copy to its packed hits on the host: the drift transform, SNR and top-k
between; on the asynchronous plane the wait behind earlier windows too)
and ``search.hits_per_window``.

Counters (:meth:`Timeline.count`, e.g. ``block.masked`` for a RAW
block that failed its digest) are byte-free stages.  The flight
recorder's ring also takes fault and mask events
(:func:`blit_torch.faults.incr`), and :func:`process_timeline` holds
what code outside a reducer records (retry backoffs, verification
times).

Stages are timed from several threads (producer, dispatch, readback,
sink), so readers copy the stage dict before iterating it, never the
live one.  Spans, ``profile_trace`` and monitor publishing are not
ported (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional

log = logging.getLogger("blit_torch.observability")


@dataclass
class StageStats:
    """Accumulated wall time and bytes of one stage."""

    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    # True for stages whose bytes are not meaningful (waits, counters).
    byte_free: bool = False

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class GaugeStats:
    """Last, lowest and highest value of a sampled level."""

    last: float = 0.0
    lo: float = 0.0
    hi: float = 0.0
    n: int = 0

    def sample(self, value: float) -> None:
        self.lo = value if self.n == 0 else min(self.lo, value)
        self.hi = value if self.n == 0 else max(self.hi, value)
        self.last = value
        self.n += 1


@dataclass
class Timeline:
    """A registry of named stage timings, per-event observations and
    gauges (one per reducer)."""

    stages: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))
    observations: Dict[str, List[float]] = field(
        default_factory=lambda: defaultdict(list))
    gauges: Dict[str, GaugeStats] = field(
        default_factory=lambda: defaultdict(GaugeStats))

    def observe(self, name: str, value: float) -> None:
        """Record one value of the per-event metric ``name``."""
        self.observations[name].append(value)

    def gauge(self, name: str, value: float) -> None:
        """Sample the level ``name`` (kept apart from the stage table)."""
        self.gauges[name].sample(value)

    def count(self, name: str, n: int = 1) -> None:
        """Count an event as a byte-free stage (``calls`` holds the
        count): masks and degradations show in the stage table."""
        s = self.stages[name]
        s.calls += n
        s.byte_free = True
        _FLIGHT.event("count", name, n=n)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0,
              byte_free: bool = False) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stages[name]
            s.calls += 1
            s.seconds += dt
            s.bytes += nbytes
            if byte_free:
                s.byte_free = True
            _FLIGHT.stage_event(name, dt, nbytes)

    def overlap_efficiency(self, wall: str = "stream",
                           work: Iterable[str] = ("device", "readback",
                                                  "write")) -> float:
        """Record (gauge ``overlap.<wall>``) and return the seconds of the
        ``work`` stages per second of the ``wall`` stage: ~1.0 when the
        legs ran one after another, towards N when N legs hid behind each
        other, below 1.0 when the wall went to something the work stages
        do not time (the host read, dispatch gaps).  0.0 when the wall
        stage never ran."""
        stages = dict(self.stages)
        wall_s = stages[wall].seconds if wall in stages else 0.0
        work_s = sum(stages[k].seconds for k in work if k in stages)
        eff = work_s / wall_s if wall_s > 0 else 0.0
        self.gauge(f"overlap.{wall}", eff)
        return eff


# -- flight recorder --------------------------------------------------------


class FlightRecorder:
    """A fixed-size ring of recent stage events, dumped to a
    JSON file when a watchdog or a starved rotation trips.  Recording is
    a deque append; dumps are rate-limited per reason class (the text
    before the first ":" or "—") so a storm writes one incident file."""

    def __init__(self, capacity: int = 512, min_interval_s: float = 60.0):
        self._ring: deque = deque(maxlen=capacity)
        self.min_interval_s = min_interval_s
        self._last_dump: Dict[str, float] = {}
        self._seq = 0
        self._lock = threading.Lock()

    def stage_event(self, name: str, seconds: float, nbytes: int) -> None:
        self._ring.append({"t": time.time(), "kind": "stage", "name": name,
                           "s": seconds, "bytes": nbytes})

    def event(self, kind: str, name: str, **fields) -> None:
        """Record a fault, mask or integrity event."""
        e = {"t": time.time(), "kind": kind, "name": name}
        e.update(fields)
        self._ring.append(e)

    def events(self) -> List[Dict]:
        return list(self._ring)

    def dump(self, reason: str, path: Optional[str] = None,
             force: bool = False) -> Optional[str]:
        """Write the incident (reason, recent events) to ``path`` (else a
        file in ``BLIT_FLIGHT_DIR`` or the temp directory) and return the
        path.  Never raises; returns None when rate-limited or when
        ``BLIT_FLIGHT_DISABLE`` is set."""
        if os.environ.get("BLIT_FLIGHT_DISABLE"):
            return None
        try:
            key = reason.split("—", 1)[0].split(":", 1)[0].strip()[:64] or "dump"
            now = time.monotonic()
            with self._lock:
                last = self._last_dump.get(key, float("-inf"))
                if not force and now - last < self.min_interval_s:
                    return None
                self._last_dump[key] = now
                self._seq += 1
                seq = self._seq
            doc = {"reason": reason, "t": time.time(), "pid": os.getpid(),
                   "events": self.events()}
            if path is None:
                import tempfile

                d = os.environ.get("BLIT_FLIGHT_DIR") or tempfile.gettempdir()
                path = os.path.join(
                    d, f"blit-torch-flight-{os.getpid()}-{int(doc['t'])}-{seq}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            log.error("flight recorder dumped to %s (%s)", path, reason)
            return path
        except Exception:  # noqa: BLE001 — never mask the real incident
            log.warning("flight recorder dump failed", exc_info=True)
            return None


_FLIGHT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder."""
    return _FLIGHT


_PROCESS_TL = Timeline()


def process_timeline() -> Timeline:
    """The process-wide :class:`Timeline` that code outside a reducer
    records on (retry backoffs, integrity verification times)."""
    return _PROCESS_TL


class StallWatchdog:
    """The progress discipline of every threaded plane: the thread that
    owns progress calls :meth:`beat` (back-pressure waits count as
    progress); the waiting side sizes its polls with :meth:`poll_s` and
    calls :meth:`check` on every empty poll.  When no beat landed for
    ``timeout_s`` while the watched thread is ``active``, the flight
    recorder dumps and a ``RuntimeError`` ends the wait.  ``timeout_s=None``
    disarms it.

    Users: :class:`blit_torch.pipeline.BufferRotation` (the producer),
    :class:`blit_torch.outplane.OutputRotation` (the readback thread) and
    :class:`blit_torch.outplane.AsyncSink` (the writer thread)."""

    def __init__(self, timeout_s: Optional[float], name: str,
                 what: str = "a wedged producer would otherwise hang"):
        self.timeout_s = timeout_s
        self.name = name
        self.what = what
        self._beat = time.monotonic()

    def beat(self) -> None:
        self._beat = time.monotonic()

    def poll_s(self, base: float = 0.2) -> float:
        """``base`` when disarmed, else short enough to trip within about
        half a timeout."""
        if self.timeout_s is None:
            return base
        return min(base, max(0.05, self.timeout_s / 2))

    def stalled(self, active: bool = True) -> bool:
        return (self.timeout_s is not None and active
                and time.monotonic() - self._beat > self.timeout_s)

    def trip(self, detail: str) -> None:
        msg = (f"{self.name}: {detail} — no progress for > {self.timeout_s}s "
               f"(stall watchdog; {self.what})")
        flight_recorder().dump(msg)
        raise RuntimeError(msg)

    def check(self, detail: str, active: bool = True) -> None:
        if self.stalled(active):
            self.trip(detail)
