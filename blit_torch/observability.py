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
live one.

Spans (:class:`Tracer`, :func:`span`) trace the worker fan-out: the
pool records each dispatch as a span, ships its ``{"trace", "span"}``
context to a remote agent, and the agent's span parents onto it.
:func:`configure_logging` stamps host and worker into every
``blit_torch`` log record (:class:`HostContextFilter`), as JSON lines on
request (:class:`JsonLineFormatter`).  The Chrome trace export, the
fleet harvest (``telemetry_snapshot`` / ``merge_fleet``),
``profile_trace`` and monitor publishing are not ported (ROADMAP.md
Queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import socket
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional

log = logging.getLogger("blit_torch.observability")

_HOSTNAME: Optional[str] = None

# Worker id stamped into spans (0: the main process, by the pool's
# convention); set by configure_logging(worker=...) at worker start-up.
_WORKER = 0


def hostname() -> str:
    """This process's host name (cached: span creation must stay cheap)."""
    global _HOSTNAME
    if _HOSTNAME is None:
        _HOSTNAME = socket.gethostname()
    return _HOSTNAME


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

    def span_event(self, sp: "Span") -> None:
        self._ring.append({"t": sp.t0, "kind": "span", "name": sp.name,
                           "dur_s": round(sp.duration_s, 6),
                           "span": sp.span_id, "parent": sp.parent_id})

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


# -- spans ------------------------------------------------------------------

_id_counter = itertools.count(1)
# Per-process id prefix: spans of N worker processes must not collide.
# pid alone recycles; two random bytes are added.
_ID_PREFIX = f"{os.getpid():x}{os.urandom(2).hex()}"
_ID_PID = os.getpid()


def _new_id() -> str:
    global _ID_PREFIX, _ID_PID
    pid = os.getpid()
    if pid != _ID_PID:
        # A forked child inherits the prefix and the counter's position:
        # re-key the prefix per process.
        _ID_PREFIX = f"{pid:x}{os.urandom(2).hex()}"
        _ID_PID = pid
    return f"{_ID_PREFIX}.{next(_id_counter):x}"


def new_id() -> str:
    """A fresh process-unique id in the span-id format."""
    return _new_id()


class Span:
    """One finished traced operation: name, wall start (epoch seconds),
    duration, host / worker / thread, trace id, span id, parent span id
    and small free-form attrs."""

    __slots__ = ("name", "t0", "duration_s", "trace_id", "span_id",
                 "parent_id", "host", "worker", "tid", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Optional[Dict]):
        self.name = name
        self.t0 = time.time()
        self.duration_s = 0.0
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.host = hostname()
        self.worker = _WORKER
        self.tid = threading.get_ident() & 0x7FFFFFFF
        self.attrs = attrs

    def as_dict(self) -> Dict:
        d = {"name": self.name, "t0": self.t0,
             "duration_s": self.duration_s, "trace": self.trace_id,
             "span": self.span_id, "parent": self.parent_id,
             "host": self.host, "worker": self.worker, "tid": self.tid}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Tracer:
    """Span recorder with an ambient (thread-local) trace context.

    A :meth:`span` opened with no ambient context starts a new trace; one
    opened inside another span of the same thread, or under
    :meth:`activate` (a context adopted from another thread or process),
    becomes its child.  :meth:`context` exports the current ``{"trace",
    "span"}`` pair, which the pool ships to its workers.  Finished spans
    land in a bounded deque (oldest dropped) and in the flight recorder.
    ``enabled=False`` (or ``BLIT_SPANS=0``) makes :meth:`span` a no-op."""

    def __init__(self, max_spans: int = 16384, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("BLIT_SPANS", "1").lower() not in (
                "0", "false", "off", "")
        self.enabled = enabled
        self._spans: deque = deque(maxlen=max_spans)
        self._span_lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> List:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Optional[Span]]:
        """Time a traced operation; yields the live :class:`Span` (None
        when tracing is off).  Keyword args become span attrs."""
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        if stack:
            trace_id, parent_id = stack[-1]
        else:
            trace_id, parent_id = _new_id(), None
        sp = Span(name, trace_id, _new_id(), parent_id, attrs or None)
        stack.append((trace_id, sp.span_id))
        p0 = time.perf_counter()
        try:
            yield sp
        finally:
            sp.duration_s = time.perf_counter() - p0
            stack.pop()
            with self._span_lock:
                self._spans.append(sp)
            _FLIGHT.span_event(sp)

    @contextlib.contextmanager
    def activate(self, ctx: Optional[Dict]) -> Iterator[None]:
        """Adopt a ``{"trace", "span"}`` context exported by
        :meth:`context` elsewhere: spans opened inside become its
        children."""
        if not ctx or not self.enabled:
            yield
            return
        stack = self._stack()
        stack.append((str(ctx.get("trace", "")), str(ctx.get("span", ""))))
        try:
            yield
        finally:
            stack.pop()

    def context(self) -> Optional[Dict]:
        """The ambient ``{"trace", "span"}`` pair (None outside any span
        or with tracing off)."""
        if not self.enabled:
            return None
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return None
        trace_id, span_id = stack[-1]
        return {"trace": trace_id, "span": span_id}

    def spans(self) -> List[Span]:
        with self._span_lock:
            return list(self._spans)

    def span_dicts(self) -> List[Dict]:
        return [s.as_dict() for s in self.spans()]

    def reset(self) -> None:
        with self._span_lock:
            self._spans.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER


def span(name: str, **attrs):
    """``with observability.span("leg"): ...`` on the process tracer."""
    return _TRACER.span(name, **attrs)


def span_dicts() -> List[Dict]:
    """The process tracer's finished spans as dicts.  A pool reads its
    agents' with ``pool.broadcast(span_dicts)``: each agent's
    ``agent.<fn>`` span names the pool's ``pool.<fn>`` dispatch span as
    its parent, so a fan-out's tree spans the processes."""
    return _TRACER.span_dicts()


# -- structured logging -----------------------------------------------------


class HostContextFilter(logging.Filter):
    """Adds ``host`` and ``worker`` to every record so the fan-out's logs
    stay attributable."""

    def __init__(self, worker: int = 0):
        super().__init__()
        self.host = socket.gethostname()
        self.worker = worker

    def filter(self, record: logging.LogRecord) -> bool:
        record.host = self.host
        record.worker = self.worker
        return True


class JsonLineFormatter(logging.Formatter):
    """One JSON object per record (ts, level, host, worker, name, msg)."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "host": getattr(record, "host", hostname()),
            "worker": getattr(record, "worker", 0),
            "name": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def configure_logging(level: int = logging.INFO, worker: int = 0,
                      json_lines: bool = False, stream=None) -> None:
    """Structured stderr logging with host / worker context for every
    ``blit_torch`` logger.  Idempotent: a second call replaces the first
    handler.  ``json_lines=True`` emits :class:`JsonLineFormatter` lines
    (the agent sets it from ``BLIT_LOG_JSON``); ``stream`` overrides the
    handler's target (default stderr)."""
    global _WORKER
    _WORKER = worker
    root = logging.getLogger("blit_torch")
    for h in list(root.handlers):
        if getattr(h, "_blit_torch_handler", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream)
    handler._blit_torch_handler = True
    handler.addFilter(HostContextFilter(worker))
    if json_lines:
        handler.setFormatter(JsonLineFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(host)s/w%(worker)d %(name)s: %(message)s"))
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
