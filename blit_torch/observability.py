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
wall clock of the whole streaming loop).  Its threads' waits are stages
of their own: ``ingest.feed_wait`` (the producer waiting for the next
block from its feed: the live assembler, or the file feed),
``ingest.slot_wait`` (the producer waiting for a free chunk slot),
``dispatch.chunk_wait`` (the dispatch thread waiting for a filled
chunk) and ``dispatch.put_wait`` (the dispatch thread blocked in the
output rotation behind readback); ``dispatch.h2d`` (the host→device
copy call) and ``dispatch.launch`` (the channelizer's launches and the
event) are the children of ``dispatch``.  End-to-end RAW GB/s is
``ingest`` bytes over ``stream`` seconds; :meth:`Timeline.overlap_efficiency`
is the work stages' seconds over that wall.

The span store (:meth:`Timeline.open_spans`, off by default) also keeps
each ``stage()`` call as a span: the stage, the native thread id, its
start and end in ns on the epoch clock (the clock of a
``torch.profiler`` Chrome trace's ``ts`` plus ``baseTimeNanoseconds``),
its bytes and the chunk's sequence number; it is bounded
(:data:`SPAN_CAPACITY`) and counts what it drops (``spans.dropped``).
:func:`profile_trace` with a ``timeline`` opens it and writes the spans
into the trace it exports (category ``blit.stage``).

The search adds the stages ``search.window_fill`` (spectra copied into
a window slot) and ``search.write`` (``.hits`` lines written), and the
per-window histograms ``search.tree_s`` (from the dispatch of the
window's H2D copy to its packed hits on the host: the drift transform,
SNR and top-k between; on the asynchronous plane the wait behind
earlier windows too) and ``search.hits_per_window``.

Per-event values go into log-bucketed histograms
(:class:`HistogramStats`, ``blit``'s: 64 buckets from 1 µs, exact
``min`` / ``max`` / ``sum``, quantiles good to a factor of 2):
the output plane's ``out.readback_lag_s`` / ``out.chunk_latency_s`` /
``out.write_s``, the live plane's ``stream.chunk_to_product_s``, the
packet plane's ``packet.assembly_s``.  :meth:`Timeline.report`,
:meth:`Timeline.merge`, :meth:`Timeline.state` /
:meth:`Timeline.from_state` and :func:`merge_fleet` /
:func:`render_prometheus` are ``blit``'s, so the metrics publisher
(:mod:`blit_torch.monitor`) spools samples either package reads.

Counters (:meth:`Timeline.count`, e.g. ``block.masked`` for a RAW
block that failed its digest) are byte-free stages.  The flight
recorder's ring also takes fault and mask events
(:func:`blit_torch.faults.incr`), and :func:`process_timeline` holds
what code outside a reducer records (retry backoffs, verification
times).

Stages are timed, and histograms observed, from several threads
(producer, dispatch, readback, sink), so readers copy the dicts before
iterating them, never the live ones.  As in ``blit``, no lock guards
the updates: each histogram is observed from one thread (the sink's
``stream.chunk_to_product_s``, the readback thread's
``out.readback_lag_s``), and a report read meanwhile may be one sample
behind.

Spans (:class:`Tracer`, :func:`span`) trace the worker fan-out: the
pool records each dispatch as a span, ships its ``{"trace", "span"}``
context to a remote agent, and the agent's span parents onto it.
:func:`configure_logging` stamps host and worker into every
``blit_torch`` log record (:class:`HostContextFilter`), as JSON lines on
request (:class:`JsonLineFormatter`).  The serve plane writes one
access record a request through :class:`RequestLog`
(:func:`request_log_for`, ``BLIT_REQUEST_LOG``) and serves
:func:`telemetry_snapshot` as its ``/snapshot`` body.  The Chrome trace
export (:meth:`Tracer.export_chrome`, with harvested spans adopted by
:meth:`Tracer.ingest`), the stitched-trace readers (:func:`trace_summary`,
:func:`cross_process_pairs`, :func:`render_trace_tree`), the fleet
report (:func:`local_fleet_report`, :func:`render_fleet_text`; the pool's
``harvest_telemetry`` folds every worker's :func:`telemetry_snapshot`)
and :func:`render_flight_dump` are ``blit``'s.  :func:`profile_trace` is
a ``torch.profiler`` trace (CPU, plus CUDA on a card) where ``blit``'s is
JAX's.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import os
import socket
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

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


# Log-bucketed histogram geometry (blit's): bucket i covers
# (base·2^(i-1), base·2^i] with base = 1 µs, 64 buckets.
_HIST_BASE = 1e-6
_HIST_NBUCKETS = 64
_LOG2 = math.log(2.0)

# Per-bucket trace-id exemplars (the trace of the most recent sample of
# each bucket, taken from the ambient span); BLIT_EXEMPLARS=0 turns them
# off.
_EXEMPLARS = os.environ.get("BLIT_EXEMPLARS", "1").lower() not in (
    "0", "false", "off", "")


def set_exemplars(enabled: bool) -> None:
    """Turn per-bucket trace-id exemplars on or off process-wide."""
    global _EXEMPLARS
    _EXEMPLARS = bool(enabled)


def exemplars_enabled() -> bool:
    return _EXEMPLARS

# Captured once at import: this process's (epoch, monotonic) clock pair,
# shipped beside every spool sample so readers can align processes.
_WALL_ANCHOR = {"epoch": round(time.time(), 6),
                "mono": round(time.monotonic(), 6)}


def wall_anchor() -> Dict[str, float]:
    """This process's ``{"epoch", "mono"}`` clock pair, taken at import."""
    return dict(_WALL_ANCHOR)


def hist_bucket_edges() -> List[float]:
    """The upper edge of every histogram bucket, in order: the ``le``
    labels of :func:`render_prometheus` and the SLO bad-sample cut
    (:func:`blit_torch.monitor.bad_fraction`) both derive from it."""
    return [_HIST_BASE * 2.0 ** i for i in range(_HIST_NBUCKETS)]


class HistogramStats:
    """Log-bucketed value distribution (``blit``'s): 64 counters, so
    bounded memory; mergeable across threads and processes; quantiles
    good to one bucket (a factor of 2), with exact ``min`` / ``max`` /
    ``sum`` beside them.  Updates take no lock, as in ``blit``: the
    reducer's threads each observe their own histograms (the sink thread
    ``stream.chunk_to_product_s``, the readback thread
    ``out.readback_lag_s``), and a report read while one updates may be
    one sample behind."""

    __slots__ = ("counts", "n", "total", "vmin", "vmax", "exemplars")

    def __init__(self):
        self.counts = [0] * _HIST_NBUCKETS
        self.n = 0
        self.total = 0.0
        self.vmin = 0.0
        self.vmax = 0.0
        # bucket -> [trace_id, value, epoch seconds], None until one lands.
        self.exemplars: Optional[Dict[int, List]] = None

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        v = float(value)
        if v <= _HIST_BASE:
            i = 0
        else:
            i = min(_HIST_NBUCKETS - 1,
                    int(math.ceil(math.log(v / _HIST_BASE) / _LOG2)))
        self.counts[i] += 1
        if self.n == 0:
            self.vmin = self.vmax = v
        else:
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
        self.n += 1
        self.total += v
        if trace_id is None and _EXEMPLARS:
            ctx = _TRACER.context()
            if ctx:
                trace_id = ctx["trace"]
        if trace_id:
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[i] = [trace_id, v, time.time()]

    def tail_exemplar(self) -> Optional[Dict]:
        """The exemplar of the HIGHEST bucket that has one — the trace
        behind the tail latency an operator is chasing.  Returns
        ``{"bucket", "le", "trace", "value", "t"}`` or None."""
        if not self.exemplars:
            return None
        i = max(self.exemplars)
        trace, v, t = self.exemplars[i]
        return {"bucket": i, "le": _HIST_BASE * 2.0 ** i,
                "trace": trace, "value": v, "t": t}

    def percentile(self, p: float) -> float:
        """Nearest-rank quantile (0.0 when empty): the midpoint of the
        rank's bucket, clamped to the observed [min, max]."""
        if self.n == 0:
            return 0.0
        rank = min(self.n - 1, max(0, int(math.ceil(p * self.n)) - 1))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if c and acc > rank:
                lo = _HIST_BASE * 2.0 ** (i - 1) if i else 0.0
                hi = _HIST_BASE * 2.0 ** i
                return min(max((lo + hi) / 2.0, self.vmin), self.vmax)
        return self.vmax

    def merge(self, other: "HistogramStats") -> "HistogramStats":
        """Fold ``other`` into self (bucket counts and totals sum, the
        envelope widens; the newer exemplar of a bucket wins)."""
        if other.n:
            if self.n == 0:
                self.vmin, self.vmax = other.vmin, other.vmax
            else:
                self.vmin = min(self.vmin, other.vmin)
                self.vmax = max(self.vmax, other.vmax)
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.n += other.n
        self.total += other.total
        if other.exemplars:
            if self.exemplars is None:
                self.exemplars = {}
            for i, rec in other.exemplars.items():
                if i not in self.exemplars or rec[2] >= self.exemplars[i][2]:
                    self.exemplars[i] = list(rec)
        return self

    def reset(self) -> None:
        """Zero in place (the object may be held by another thread)."""
        for i in range(_HIST_NBUCKETS):
            self.counts[i] = 0
        self.n = 0
        self.total = 0.0
        self.vmin = self.vmax = 0.0
        self.exemplars = None

    def report(self) -> Dict[str, float]:
        mean = self.total / self.n if self.n else 0.0
        return {"n": self.n, "mean": round(mean, 6),
                "p50": round(self.percentile(0.50), 6),
                "p90": round(self.percentile(0.90), 6),
                "p99": round(self.percentile(0.99), 6),
                "max": round(self.vmax, 6)}

    def state(self) -> Dict:
        """The raw, unrounded state as JSON (``blit``'s wire format)."""
        st = {"counts": list(self.counts), "n": self.n,
              "total": self.total, "vmin": self.vmin, "vmax": self.vmax}
        if self.exemplars:
            st["exemplars"] = {str(i): list(rec)
                               for i, rec in self.exemplars.items()}
        return st

    def since(self, st: Dict) -> "HistogramStats":
        """A new histogram of the samples observed after ``st`` (a prior
        :meth:`state`): counts, n and total subtract exactly; the
        envelope and the exemplars stay the cumulative ones."""
        h = HistogramStats()
        old = st.get("counts", [])
        for i in range(_HIST_NBUCKETS):
            prev = old[i] if i < len(old) else 0
            h.counts[i] = max(0, self.counts[i] - prev)
        h.n = max(0, self.n - int(st.get("n", 0)))
        h.total = max(0.0, self.total - float(st.get("total", 0.0)))
        h.vmin, h.vmax = self.vmin, self.vmax
        if self.exemplars:
            h.exemplars = {i: list(rec) for i, rec in self.exemplars.items()}
        return h

    @classmethod
    def from_state(cls, st: Dict) -> "HistogramStats":
        h = cls()
        counts = list(st.get("counts", []))[:_HIST_NBUCKETS]
        h.counts[:len(counts)] = [int(c) for c in counts]
        h.n = int(st.get("n", 0))
        h.total = float(st.get("total", 0.0))
        h.vmin = float(st.get("vmin", 0.0))
        h.vmax = float(st.get("vmax", 0.0))
        for i, rec in (st.get("exemplars") or {}).items():
            try:
                bucket = int(i)
                trace, v, t = rec
            except (TypeError, ValueError):
                continue
            if h.exemplars is None:
                h.exemplars = {}
            h.exemplars[bucket] = [str(trace), float(v), float(t)]
        return h


# Records a span store keeps before it counts the rest as dropped.  A
# live reducer at ~4 GB/s records ~7,000 a minute: a block's feed wait
# and copy, a chunk's ten or so stages.
SPAN_CAPACITY = 1 << 16

# The Chrome-trace category of the stage spans profile_trace writes.
STAGE_SPAN_CAT = "blit.stage"


class SpanStore:
    """The bounded record of a :class:`Timeline`'s stages while it is open
    (:meth:`Timeline.open_spans`): one record a ``stage()`` call, with
    the stage's name, the native thread id (the ``tid`` of the
    profiler's CPU events), its start and end in ns on the epoch
    clock (``time.time_ns()``, the clock a ``torch.profiler`` Chrome
    trace's ``ts`` plus ``baseTimeNanoseconds`` reads), its bytes, and
    the chunk's sequence number where the stage handles one chunk (else
    None).  ``threads`` names each thread that recorded one: its name
    and its ``threading.get_ident()`` (the ``pthread_t`` that a CUDA
    runtime event's thread id derives from where the profiler traced no
    CPU activity).  Past ``capacity`` records the rest are counted in
    ``dropped``.  Threads append without a lock: each draws its ticket
    from an atomic counter."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = max(0, int(capacity))
        self.dropped = 0
        self._records: List[tuple] = []
        self._tickets = itertools.count()
        self._drop_lock = threading.Lock()
        self.threads: Dict[int, Dict] = {}

    def add(self, name: str, t0_ns: int, t1_ns: int, nbytes: int,
            seq: Optional[int]) -> None:
        if next(self._tickets) >= self.capacity:
            with self._drop_lock:
                self.dropped += 1
            return
        tid = threading.get_native_id()
        if tid not in self.threads:
            self.threads[tid] = {"name": threading.current_thread().name,
                                 "ident": threading.get_ident()}
        self._records.append((name, tid, t0_ns, t1_ns, nbytes, seq))

    def __len__(self) -> int:
        return len(self._records)

    def spans(self) -> List[Dict]:
        """The records so far as dicts, in the order they ended."""
        return [{"name": n, "tid": tid, "t0_ns": t0, "t1_ns": t1,
                 "bytes": b, "seq": seq}
                for n, tid, t0, t1, b, seq in list(self._records)]


def add_stage_spans(path: str, spans: Iterable[Dict],
                    threads: Optional[Dict[int, Dict]] = None) -> None:
    """Write stage spans into the Chrome trace at ``path``: each a
    complete event of category :data:`STAGE_SPAN_CAT` on its native
    thread, on the trace's own time base (``ts`` in µs after its
    ``baseTimeNanoseconds``), with the thread's name where it has none
    there."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    named = {e.get("tid") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for s in spans:
        args = {"bytes": s["bytes"]}
        if s["seq"] is not None:
            args["seq"] = s["seq"]
        events.append({"ph": "X", "cat": STAGE_SPAN_CAT, "name": s["name"],
                       "pid": pid, "tid": s["tid"],
                       "ts": (s["t0_ns"] - base) / 1e3,
                       "dur": (s["t1_ns"] - s["t0_ns"]) / 1e3, "args": args})
    for tid, th in sorted((threads or {}).items()):
        if tid not in named:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": th["name"]}})
    with open(path, "w") as f:
        json.dump(doc, f)


@dataclass
class Timeline:
    """A registry of named stage timings, latency histograms and gauges
    (one per reducer), and an optional span store
    (:meth:`open_spans`) that also records each stage as a span."""

    stages: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))
    gauges: Dict[str, GaugeStats] = field(
        default_factory=lambda: defaultdict(GaugeStats))
    hists: Dict[str, HistogramStats] = field(
        default_factory=lambda: defaultdict(HistogramStats))
    # Off (None) unless open_spans() opened it.
    spans: Optional[SpanStore] = field(default=None, repr=False,
                                       compare=False)

    def open_spans(self, capacity: int = SPAN_CAPACITY) -> SpanStore:
        """Open the span store, or return the one already open: from now
        on every :meth:`stage` call is also kept as a span."""
        if self.spans is None:
            self.spans = SpanStore(capacity)
        return self.spans

    def close_spans(self) -> Optional[SpanStore]:
        """Close the span store and return it (None if none was open);
        the spans it dropped are counted under ``spans.dropped``."""
        store, self.spans = self.spans, None
        if store is not None and store.dropped:
            self.count("spans.dropped", store.dropped)
        return store

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the histogram ``name``."""
        self.hists[name].observe(value)

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
    def stage(self, name: str, nbytes: int = 0, byte_free: bool = False,
              seq: Optional[int] = None) -> Iterator[None]:
        """Time the block as one call of stage ``name``; with the span
        store open, keep it as a span too (``seq``: the chunk it
        handles)."""
        t0 = time.perf_counter()
        store = self.spans
        if store is not None:
            w0 = time.time_ns()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if store is not None:
                store.add(name, w0, time.time_ns(), nbytes, seq)
            s = self.stages[name]
            s.calls += 1
            s.seconds += dt
            s.bytes += nbytes
            if byte_free:
                s.byte_free = True
            _FLIGHT.stage_event(name, dt, nbytes)

    def reset(self) -> None:
        """Zero every stage, gauge and histogram in place (objects other
        threads hold keep counting into what the report reads)."""
        for s in list(self.stages.values()):
            s.calls = 0
            s.seconds = 0.0
            s.bytes = 0
        for g in list(self.gauges.values()):
            g.last = g.lo = g.hi = 0.0
            g.n = 0
        for h in list(self.hists.values()):
            h.reset()

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

    def report(self, include_faults: bool = False) -> Dict[str, Dict]:
        """``blit``'s report: a row per stage, then ``gauges``, ``hists``
        and, with ``include_faults``, the process-wide fault counters."""
        out = {}
        for k, v in sorted(list(self.stages.items())):
            row = {"calls": v.calls, "seconds": round(v.seconds, 6),
                   "bytes": v.bytes, "gbps": round(v.gbps, 3)}
            if v.byte_free:
                row["byte_free"] = True
            out[k] = row
        if self.gauges:
            out["gauges"] = {
                k: {"last": round(g.last, 6), "lo": round(g.lo, 6),
                    "hi": round(g.hi, 6), "n": g.n}
                for k, g in sorted(list(self.gauges.items()))
            }
        if self.hists:
            out["hists"] = {k: h.report()
                            for k, h in sorted(list(self.hists.items()))}
        if include_faults:
            from blit_torch import faults

            c = faults.counters()
            if c:
                out["faults"] = c
        return out

    def snapshot(self) -> Dict[str, tuple]:
        """Point-in-time stage counters, for :meth:`since`."""
        return {k: (v.calls, v.seconds, v.bytes)
                for k, v in list(self.stages.items())}

    def since(self, snap: Dict[str, tuple]) -> Dict[str, Dict]:
        """Per-stage deltas since a :meth:`snapshot`."""
        out = {}
        for k, v in list(self.stages.items()):
            c0, s0, b0 = snap.get(k, (0, 0.0, 0))
            if v.calls != c0 or v.bytes != b0 or v.seconds != s0:
                out[k] = {"calls": v.calls - c0,
                          "seconds": round(v.seconds - s0, 6),
                          "bytes": v.bytes - b0}
        return out

    def hist_quantiles(self, names: Optional[Iterable[str]] = None
                       ) -> Dict[str, Dict]:
        """``n`` / ``p50`` / ``p99`` / ``max`` of each named histogram
        with samples (every one for ``names=None``)."""
        keys = list(self.hists) if names is None else list(names)
        out = {}
        for k in keys:
            h = self.hists.get(k)
            if h is None or h.n == 0:
                continue
            rep = h.report()
            out[k] = {f: rep[f] for f in ("n", "p50", "p99", "max")}
        return out

    def merge(self, other: "Timeline") -> "Timeline":
        """Fold ``other`` into self: stages and histograms sum, gauges
        keep the widened envelope and the count (``last`` stays self's
        unless self never sampled)."""
        for k, s in list(other.stages.items()):
            d = self.stages[k]
            d.calls += s.calls
            d.seconds += s.seconds
            d.bytes += s.bytes
            if s.byte_free:
                d.byte_free = True
        for k, g in list(other.gauges.items()):
            d = self.gauges[k]
            if g.n:
                if d.n == 0:
                    d.last, d.lo, d.hi = g.last, g.lo, g.hi
                else:
                    d.lo = min(d.lo, g.lo)
                    d.hi = max(d.hi, g.hi)
                d.n += g.n
        for k, h in list(other.hists.items()):
            self.hists[k].merge(h)
        return self

    def state(self) -> Dict:
        """The full raw state as JSON (unrounded, so :meth:`from_state`
        and :meth:`merge` are exact): ``blit``'s spool format."""
        return {
            "stages": {
                k: {"calls": v.calls, "seconds": v.seconds,
                    "bytes": v.bytes, "byte_free": v.byte_free}
                for k, v in list(self.stages.items())
            },
            "gauges": {
                k: {"last": g.last, "lo": g.lo, "hi": g.hi, "n": g.n}
                for k, g in list(self.gauges.items())
            },
            "hists": {k: h.state() for k, h in list(self.hists.items())},
        }

    @classmethod
    def from_state(cls, st: Dict) -> "Timeline":
        tl = cls()
        for k, v in (st.get("stages") or {}).items():
            s = tl.stages[k]
            s.calls = int(v.get("calls", 0))
            s.seconds = float(v.get("seconds", 0.0))
            s.bytes = int(v.get("bytes", 0))
            s.byte_free = bool(v.get("byte_free", False))
        for k, v in (st.get("gauges") or {}).items():
            g = tl.gauges[k]
            g.last = float(v.get("last", 0.0))
            g.lo = float(v.get("lo", 0.0))
            g.hi = float(v.get("hi", 0.0))
            g.n = int(v.get("n", 0))
        for k, v in (st.get("hists") or {}).items():
            tl.hists[k] = HistogramStats.from_state(v)
        return tl


    def log(self, logger: Optional[logging.Logger] = None) -> None:
        (logger or logging.getLogger("blit_torch.timeline")).info(
            "timeline %s", json.dumps(self.report())
        )

_TRACE_SEQ = itertools.count(1)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str], device=None,
                  timeline: Optional[Timeline] = None) -> Iterator[None]:
    """``torch.profiler`` trace around a region, written as a Chrome trace
    (Perfetto / ``chrome://tracing`` readable) into ``logdir``:
    ``blit-torch-<host>-<pid>-<n>.pt.trace.json``.  CPU activity always;
    CUDA activity (kernels, copies) when ``device`` is a CUDA device, or
    when ``device`` is None and a GPU is present.  With a ``timeline``,
    its span store is open for the region (:meth:`Timeline.open_spans`)
    and its stages' spans land in the trace beside the profiler's events
    (:func:`add_stage_spans`, category ``blit.stage``), so the waits of
    the reducer's threads show next to the kernels and copies.
    ``logdir=None`` is a no-op, so call sites need no conditionals."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    opened = timeline is not None and timeline.spans is None
    store = timeline.open_spans() if timeline is not None else None
    t_open = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            yield
            if cuda:
                torch.cuda.synchronize()
    finally:
        if opened:
            timeline.close_spans()
    path = os.path.join(
        logdir, f"blit-torch-{hostname()}-{os.getpid()}-"
                f"{next(_TRACE_SEQ)}.pt.trace.json")
    prof.export_chrome_trace(path)
    if store is not None:
        add_stage_spans(path, [s for s in store.spans()
                               if s["t1_ns"] >= t_open],
                        store.threads)
    log.info("profiler trace written to %s", path)

# -- flight recorder --------------------------------------------------------


class FlightRecorder:
    """A fixed-size ring of recent span/stage/fault events, dumped to JSON
    when something trips: a rotation stall watchdog,
    an opened circuit breaker, a dead agent.  Recording must be cheap
    enough to leave on (bounded deque appends, no locks — CPython deque
    appends are atomic); dumping is rate-limited so a retry storm writes
    one incident file, not hundreds.  ``python -m blit_torch trace-view``
    renders a dump into an incident summary."""

    # Bound on distinct rate-limit clocks: reasons
    # carry per-instance detail, so the keyed dict must not grow without
    # bound under adversarial reason churn.
    _MAX_DUMP_KEYS = 64

    def __init__(self, capacity: int = 512, min_interval_s: float = 60.0):
        self._ring: deque = deque(maxlen=capacity)
        self.min_interval_s = min_interval_s
        # Rate limiting is PER REASON CLASS, not
        # one global clock: an SLO-breach dump must not starve a
        # first-of-kind stall dump that lands seconds later.  Keys are
        # the reason's leading "name" segment (before the first ":" or
        # "—"), or an explicit dump(key=...).
        self._last_dump: Dict[str, float] = {}
        self._dump_seq = 0
        self._dump_lock = threading.Lock()

    @staticmethod
    def _reason_key(reason: str) -> str:
        head = reason.split("—", 1)[0].split(":", 1)[0].strip()
        return head[:64] or "dump"

    # -- recording (hot paths) --------------------------------------------
    def event(self, kind: str, name: str, **fields) -> None:
        e = {"t": time.time(), "kind": kind, "name": name}
        if fields:
            e.update(fields)
        self._ring.append(e)

    def span_event(self, sp: Span) -> None:
        self._ring.append({"t": sp.t0, "kind": "span", "name": sp.name,
                           "dur_s": round(sp.duration_s, 6),
                           "span": sp.span_id, "parent": sp.parent_id})

    def stage_event(self, name: str, seconds: float, nbytes: int) -> None:
        self._ring.append({"t": time.time(), "kind": "stage", "name": name,
                           "s": round(seconds, 6), "bytes": nbytes})

    def events(self) -> List[Dict]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    # -- dumping (incident path) ------------------------------------------
    def dump(self, reason: str, path: Optional[str] = None,
             force: bool = False, key: Optional[str] = None) -> Optional[str]:
        """Write the incident JSON (ring + fault counters + process
        timeline + recent spans) and return its path.  Never raises (the
        caller is already mid-incident); returns None when rate-limited
        (``force=True`` overrides) or when ``BLIT_FLIGHT_DISABLE`` is
        set.  The rate limit is per reason CLASS (``key``, default the
        reason's leading name segment) — distinct incident kinds never
        starve each other."""
        if os.environ.get("BLIT_FLIGHT_DISABLE"):
            return None
        try:
            now = time.monotonic()
            k = key if key is not None else self._reason_key(reason)
            with self._dump_lock:
                last = self._last_dump.get(k, float("-inf"))
                if not force and now - last < self.min_interval_s:
                    return None
                if (k not in self._last_dump
                        and len(self._last_dump) >= self._MAX_DUMP_KEYS):
                    # Evict the stalest clock: new incident kinds keep
                    # their own limiter without unbounded growth.
                    self._last_dump.pop(
                        min(self._last_dump, key=self._last_dump.get))
                self._last_dump[k] = now
            from blit_torch import faults

            doc = {
                "reason": reason,
                "t": time.time(),
                "host": hostname(),
                "pid": os.getpid(),
                "worker": _WORKER,
                "anchor": wall_anchor(),
                "events": self.events(),
                "faults": faults.counters(),
                "timeline": process_timeline().report(),
                "spans": [s.as_dict() for s in _TRACER.spans()[-64:]],
            }
            # Correlate the incident with the request that tripped it:
            # when a span is active on the dumping thread, its trace /
            # span ids land in the dump, so a flight record and a
            # stitched fleet trace are greppable by one token.
            ctx = _TRACER.context()
            if ctx:
                doc["trace"] = ctx.get("trace")
                doc["span"] = ctx.get("span")
            if path is None:
                d = os.environ.get("BLIT_FLIGHT_DIR")
                if not d:
                    import tempfile

                    d = tempfile.gettempdir()
                # The per-process sequence number keeps two same-second
                # dumps (now possible: rate limiting is per REASON) from
                # overwriting each other's file.
                with self._dump_lock:
                    self._dump_seq += 1
                    seq = self._dump_seq
                path = os.path.join(
                    d, f"blit-flight-{hostname()}-{os.getpid()}-"
                       f"{int(doc['t'])}-{seq}.json")
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


def telemetry_snapshot(reset: bool = False, spans: bool = True) -> Dict:
    """This process's telemetry as plain builtins (the ``/snapshot``
    body): host / pid / worker, the wall anchor, the process timeline's
    state, the fault counters and the finished spans.  ``reset=True``
    zeroes the process timeline and drains the spans afterwards."""
    from blit_torch import faults

    out = {
        "host": hostname(),
        "pid": os.getpid(),
        "worker": _WORKER,
        "anchor": wall_anchor(),
        "timeline": _PROCESS_TL.state(),
        "faults": faults.counters(),
        "spans": _TRACER.span_dicts() if spans else [],
    }
    if reset:
        _PROCESS_TL.reset()
        _TRACER.reset()
    return out


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

    def age_s(self) -> float:
        """Seconds since the last beat."""
        return time.monotonic() - self._beat

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


def render_flight_dump(doc: Dict, tail: int = 40) -> str:
    """A flight-recorder dump as a readable incident summary (the
    ``python -m blit_torch trace-view`` body): what tripped, where, the fault
    counters, and the last events before the trip."""
    lines = []
    t = doc.get("t", 0.0)
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(t)) if t else "?"
    lines.append("=== blit flight record ===")
    lines.append(f"reason : {doc.get('reason', '?')}")
    lines.append(f"where  : {doc.get('host', '?')}/w{doc.get('worker', 0)} "
                 f"pid {doc.get('pid', '?')}")
    lines.append(f"when   : {when} UTC")
    anchor = doc.get("anchor") or {}
    if anchor:
        # epoch - mono = the dumping process's monotonic origin on the
        # wall clock — what cross-process bundle timelines align on.
        origin = anchor.get("epoch", 0.0) - anchor.get("mono", 0.0)
        lines.append(f"anchor : epoch={anchor.get('epoch')} "
                     f"mono={anchor.get('mono')} "
                     f"(mono origin {origin:.3f})")
    if doc.get("trace"):
        # The ambient trace at dump time: follow it into the
        # stitched fleet trace (`blit trace-view --fleet ... --trace`).
        lines.append(f"trace  : {doc['trace']} "
                     f"(span {doc.get('span', '?')})")
    faults_c = doc.get("faults") or {}
    if faults_c:
        lines.append("fault counters:")
        for k, v in sorted(faults_c.items()):
            lines.append(f"  {k:<32} {v}")
    tl = doc.get("timeline") or {}
    stages = {k: v for k, v in tl.items()
              if isinstance(v, dict) and "calls" in v}
    if stages:
        lines.append("process timeline (stages):")
        for k, v in sorted(stages.items()):
            lines.append(
                f"  {k:<20} calls={v.get('calls', 0):<8} "
                f"s={v.get('seconds', 0.0):<12} bytes={v.get('bytes', 0)}")
    events = doc.get("events") or []
    lines.append(f"last {min(tail, len(events))} of {len(events)} recorded "
                 "events (oldest first):")
    for e in events[-tail:]:
        ts = time.strftime("%H:%M:%S", time.gmtime(e.get("t", 0.0)))
        kind = e.get("kind", "?")
        name = e.get("name", "?")
        rest = {k: v for k, v in e.items()
                if k not in ("t", "kind", "name")}
        detail = " ".join(f"{k}={v}" for k, v in rest.items())
        lines.append(f"  {ts} [{kind:<5}] {name} {detail}".rstrip())
    return "\n".join(lines)


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

    @classmethod
    def from_dict(cls, d: Dict) -> "Span":
        sp = cls(d.get("name", "?"), d.get("trace", ""), d.get("span", ""),
                 d.get("parent"), d.get("attrs") or None)
        sp.t0 = float(d.get("t0", 0.0))
        sp.duration_s = float(d.get("duration_s", 0.0))
        sp.host = d.get("host", sp.host)
        sp.worker = int(d.get("worker", 0))
        sp.tid = int(d.get("tid", 0))
        return sp


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
        self._total = 0  # spans ever recorded: the spans_since cursor
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
                self._total += 1
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

    def spans_since(self, cursor: int) -> Tuple[int, List[Dict]]:
        """``(new cursor, span dicts)`` of the spans recorded after a
        prior cursor (the publisher ships them per tick).  Spans that
        aged out of the bounded deque between two reads are lost."""
        with self._span_lock:
            total = self._total
            new = total - int(cursor)
            if new <= 0:
                return total, []
            recent = list(self._spans)
        if new < len(recent):
            recent = recent[-new:]
        return total, [s.as_dict() for s in recent]

    def ingest(self, span_dicts: Iterable[Dict]) -> None:
        """Adopt foreign spans (a fleet harvest) into this tracer so one
        :meth:`export_chrome` covers the caller and its workers."""
        for d in span_dicts:
            try:
                sp = Span.from_dict(d)
            except (TypeError, ValueError):  # malformed harvest entry
                continue
            with self._span_lock:
                self._spans.append(sp)
                self._total += 1

    def reset(self) -> None:
        with self._span_lock:
            self._spans.clear()

    def export_chrome(self, path: Optional[str] = None,
                      extra: Optional[Iterable[Dict]] = None):
        """Render the recorded spans as Chrome trace events (Perfetto /
        ``chrome://tracing`` loadable).  ``extra`` takes harvested span
        dicts to merge in.  Returns the event document; writes JSON to
        ``path`` when given and returns the path instead."""
        spans = self.spans()
        if extra:
            spans = spans + [Span.from_dict(d) for d in extra]
        # Dedupe by span id: with the in-process pool backends a harvest
        # returns the caller's own spans, so recorded + ``extra`` overlap.
        seen, unique = set(), []
        for sp in spans:
            if sp.span_id in seen:
                continue
            seen.add(sp.span_id)
            unique.append(sp)
        spans = unique
        # Stable pid per (host, worker) so each worker renders as its own
        # process track, named.
        pids: Dict = {}
        events: List[Dict] = []
        for sp in spans:
            key = (sp.host, sp.worker)
            pid = pids.get(key)
            if pid is None:
                pid = pids[key] = len(pids) + 1
                events.append({"ph": "M", "pid": pid, "tid": 0,
                               "name": "process_name",
                               "args": {"name": f"{sp.host}/w{sp.worker}"}})
            ev = {"name": sp.name, "cat": "blit", "ph": "X",
                  "ts": sp.t0 * 1e6, "dur": max(sp.duration_s, 1e-7) * 1e6,
                  "pid": pid, "tid": sp.tid,
                  "args": {"trace": sp.trace_id, "span": sp.span_id,
                           "parent": sp.parent_id}}
            if sp.attrs:
                ev["args"].update(sp.attrs)
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is None:
            return doc
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


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


# -- fleet report and Prometheus text ------------------------------------


# -- per-request access records -----------------------------------------------


class RequestLog:
    """A bounded JSON-lines log of per-request access records: one line
    per request (request and trace id, fingerprint, client, priority,
    tier, queue wait, routed peer, hedge, bytes, status), which the
    ``requests`` command tails, filters and aggregates.

    When the live file passes ``max_bytes`` it rotates to ``<path>.1`` ..
    ``<path>.<max_files-1>`` and the oldest rolls off, so a log holds at
    most ``max_bytes * max_files``.  :meth:`record` never raises."""

    def __init__(self, path: str, *, max_bytes: int = 8 << 20,
                 max_files: int = 4):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self.max_files = max(1, int(max_files))
        self._lock = threading.Lock()
        self._f = None
        self._size = 0

    def _open(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")
        self._size = self._f.tell()

    def _rotate_locked(self) -> None:
        self._f.close()
        self._f = None
        if self.max_files == 1:
            os.remove(self.path)
        else:
            for i in range(self.max_files - 1, 0, -1):
                src = self.path if i == 1 else f"{self.path}.{i - 1}"
                dst = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, dst)
        self._open()

    def record(self, **fields) -> None:
        """Append one record, stamped with ``t``; None fields are
        dropped."""
        try:
            doc = {"t": round(time.time(), 6)}
            doc.update({k: v for k, v in fields.items() if v is not None})
            line = json.dumps(doc) + "\n"
            with self._lock:
                if self._f is None:
                    self._open()
                self._f.write(line)
                self._f.flush()
                self._size += len(line)
                if self._size >= self.max_bytes:
                    self._rotate_locked()
        except Exception:  # noqa: BLE001 — logging must not fail requests
            log.warning("request log append failed", exc_info=True)

    def files(self) -> List[str]:
        """Every rotation member that exists, oldest first."""
        out = [f"{self.path}.{i}"
               for i in range(self.max_files - 1, 0, -1)
               if os.path.exists(f"{self.path}.{i}")]
        if os.path.exists(self.path):
            out.append(self.path)
        return out

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                with contextlib.suppress(OSError):
                    self._f.close()
                self._f = None


def request_log_for(role: str, config=None) -> Optional[RequestLog]:
    """The configured :class:`RequestLog` of a serving component
    (``requests-<role>-<host>-<pid>.jsonl`` under the configured
    directory), or None when request logging is off.  Also applies the
    config's ``exemplars`` knob process-wide."""
    from blit_torch.config import DEFAULT, request_log_defaults

    d = request_log_defaults(DEFAULT if config is None else config)
    set_exemplars(d["exemplars"])
    if not d["dir"]:
        return None
    path = os.path.join(
        d["dir"], f"requests-{role}-{hostname()}-{os.getpid()}.jsonl")
    return RequestLog(path, max_bytes=d["max_bytes"],
                      max_files=d["files"])


def merge_fleet(snapshots: Iterable[Optional[Dict]],
                errors: Optional[Dict[str, str]] = None) -> Dict:
    """Fold telemetry snapshots (``{"host", "pid", "worker", "timeline":
    Timeline.state(), "faults", "spans"}``) into ``blit``'s per-host
    report: each host's merged stage table, raw histogram state and
    fault counters, and the whole run's fold under ``fleet``.  One
    snapshot per (host, pid) counts, the richest."""
    hosts: Dict[str, Dict] = {}
    fleet = Timeline()
    fleet_faults: Dict[str, int] = {}
    spans: List[Dict] = []
    best: Dict = {}
    for snap in snapshots:
        if not isinstance(snap, dict) or "host" not in snap:
            continue
        key = (snap["host"], snap.get("pid"))
        richness = (len((snap.get("timeline") or {}).get("stages") or {})
                    + len(snap.get("spans") or []))
        if key not in best or richness > best[key][0]:
            best[key] = (richness, snap)
    for _, snap in best.values():
        entry = hosts.setdefault(
            snap["host"], {"workers": [], "tl": Timeline(), "faults": {}})
        entry["workers"].append(
            {"pid": snap.get("pid"), "worker": snap.get("worker", 0)})
        tl = Timeline.from_state(snap.get("timeline") or {})
        entry["tl"].merge(tl)
        fleet.merge(tl)
        for k, v in (snap.get("faults") or {}).items():
            entry["faults"][k] = entry["faults"].get(k, 0) + v
            fleet_faults[k] = fleet_faults.get(k, 0) + v
        spans.extend(snap.get("spans") or [])
    report = {
        "hosts": {
            h: {"workers": e["workers"], "stages": e["tl"].report(),
                "hist_state": {k: hh.state()
                               for k, hh in list(e["tl"].hists.items())},
                "faults": e["faults"]}
            for h, e in sorted(hosts.items())
        },
        "fleet": fleet.report(),
        "faults": fleet_faults,
        "spans": spans,
    }
    if errors:
        report["errors"] = dict(errors)
    return report


def local_fleet_report() -> Dict:
    """The degenerate single-process fleet report (this process only) — what a
    run with no pool, or the tier-1 CI job, publishes."""
    return merge_fleet([telemetry_snapshot()])


def maybe_write_report(path: Optional[str] = None) -> Optional[str]:
    """Write :func:`local_fleet_report` JSON to ``path`` (default: the
    ``BLIT_TELEMETRY_OUT`` environment variable; no-op when unset).  The
    CI artifact hook — never raises."""
    path = path or os.environ.get("BLIT_TELEMETRY_OUT")
    if not path:
        return None
    try:
        with open(path, "w") as f:
            json.dump(local_fleet_report(), f)
        return path
    except Exception:  # noqa: BLE001 — reporting must not fail the run
        log.warning("telemetry report write to %s failed", path,
                    exc_info=True)
        return None


# -- fleet trace stitching ----------------------------------------------------


def span_process(span_id: str) -> str:
    """The process prefix of a span/trace id (everything before the
    counter): ids are minted as ``<pid-hex + 2 random bytes>.<n>``, so
    two spans share a prefix iff one process recorded them."""
    return str(span_id).split(".", 1)[0]


def cross_process_pairs(span_dicts: Iterable[Dict]) -> int:
    """How many parent→child span edges CROSS a process boundary — the
    stitched-trace acceptance metric: a fleet request whose
    peer-side spans parent onto the front-door span contributes at
    least one."""
    spans = list(span_dicts)
    by_id = {s.get("span"): s for s in spans if s.get("span")}
    pairs = 0
    for s in spans:
        parent = s.get("parent")
        if not parent or parent not in by_id:
            continue
        if span_process(parent) != span_process(s.get("span", "")):
            pairs += 1
    return pairs


def trace_summary(span_dicts: Iterable[Dict]) -> Dict:
    """Shape of a stitched span set: totals, distinct traces/processes,
    and the cross-process edge count."""
    spans = list(span_dicts)
    traces = {s.get("trace") for s in spans if s.get("trace")}
    procs = {span_process(s.get("span", "")) for s in spans
             if s.get("span")}
    return {"spans": len(spans), "traces": len(traces),
            "processes": len(procs),
            "cross_process_pairs": cross_process_pairs(spans)}


def render_trace_tree(span_dicts: Iterable[Dict], trace_id: str,
                      max_spans: int = 200) -> str:
    """One trace as an indented parent→child tree (the ``blit_torch
    trace-view --fleet --trace`` body): every span's name, duration,
    host/process and hedge tag, children under parents, orphans (their
    parent aged out of a bounded buffer) at the root."""
    spans = [s for s in span_dicts if s.get("trace") == trace_id]
    spans.sort(key=lambda s: s.get("t0", 0.0))
    spans = spans[:max_spans]
    ids = {s.get("span") for s in spans}
    children: Dict[str, List[Dict]] = {}
    roots: List[Dict] = []
    for s in spans:
        parent = s.get("parent")
        if parent and parent in ids:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    lines = [f"trace {trace_id}: {len(spans)} span(s)"]

    def walk(s: Dict, depth: int) -> None:
        attrs = s.get("attrs") or {}
        tag = " hedge=1" if attrs.get("hedge") else ""
        where = f"{s.get('host', '?')}/{span_process(s.get('span', ''))}"
        lines.append(
            f"  {'  ' * depth}{s.get('name', '?'):<24} "
            f"{s.get('duration_s', 0.0) * 1e3:9.3f} ms  [{where}]{tag}")
        for c in children.get(s.get("span"), []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


def prom_escape(value) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


PROM_CTYPE = "text/plain; version=0.0.4"
OPENMETRICS_CTYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def wants_openmetrics(accept: Optional[str]) -> bool:
    """Did the scraper ask for OpenMetrics (the exemplar-carrying form)?"""
    return bool(accept) and "application/openmetrics-text" in accept


def render_prometheus(report: Dict, *, openmetrics: bool = False) -> str:
    """A :func:`merge_fleet` report as Prometheus exposition text, line
    for line ``blit``'s: host-labelled stage, gauge and fault series;
    each histogram as native cumulative ``_bucket`` counts at
    :func:`hist_bucket_edges` with ``_sum`` / ``_count``, plus the
    p50/p90/p99 gauges.  ``openmetrics=True`` adds the per-bucket
    exemplars and the ``# EOF`` line."""
    lines: List[str] = []

    def head(metric: str, mtype: str, help_: str) -> None:
        lines.append(f"# HELP {metric} {help_}")
        lines.append(f"# TYPE {metric} {mtype}")

    head("blit_stage_seconds_total", "counter",
         "Accumulated wall seconds per pipeline stage")
    head("blit_stage_calls_total", "counter", "Stage invocations")
    head("blit_stage_bytes_total", "counter", "Bytes moved per stage")
    head("blit_gauge", "gauge", "Last sampled level")
    head("blit_latency_seconds", "histogram",
         "Log-bucketed latency distribution (64 log2 buckets from 1 us)")
    head("blit_latency_quantile", "gauge",
         "Precomputed latency quantiles (seconds; bucket-midpoint "
         "estimates)")
    head("blit_fault_total", "counter", "Failure/recovery counters")
    edges = hist_bucket_edges()
    for host, e in (report.get("hosts") or {}).items():
        hl = prom_escape(host)
        stages = e.get("stages") or {}
        for k, row in stages.items():
            if k in ("gauges", "hists", "faults") or not isinstance(row, dict):
                continue
            lab = f'{{host="{hl}",stage="{prom_escape(k)}"}}'
            lines.append(f"blit_stage_seconds_total{lab} {row.get('seconds', 0)}")
            lines.append(f"blit_stage_calls_total{lab} {row.get('calls', 0)}")
            lines.append(f"blit_stage_bytes_total{lab} {row.get('bytes', 0)}")
        for k, g in (stages.get("gauges") or {}).items():
            lines.append(f'blit_gauge{{host="{hl}",name="{prom_escape(k)}"}} '
                         f'{g.get("last", 0)}')
        hist_state = e.get("hist_state") or {}
        for k, h in (stages.get("hists") or {}).items():
            nl = prom_escape(k)
            st = hist_state.get(k)
            if st:
                exemplars = st.get("exemplars") or {}
                acc = 0
                for i, c in enumerate(st.get("counts") or []):
                    if not c:
                        continue
                    acc += int(c)
                    line = (f'blit_latency_seconds_bucket{{host="{hl}",'
                            f'name="{nl}",le="{edges[i]:.10g}"}} {acc}')
                    ex = (exemplars.get(str(i)) or exemplars.get(i)
                          if openmetrics else None)
                    if ex:
                        trace, v, t = ex
                        line += (f' # {{trace_id="{prom_escape(trace)}"}}'
                                 f' {float(v):.9g} {float(t):.3f}')
                    lines.append(line)
                lines.append(f'blit_latency_seconds_bucket{{host="{hl}",'
                             f'name="{nl}",le="+Inf"}} {int(st.get("n", 0))}')
                lines.append(f'blit_latency_seconds_sum{{host="{hl}",name="{nl}"}} '
                             f'{st.get("total", 0.0)}')
                lines.append(f'blit_latency_seconds_count{{host="{hl}",'
                             f'name="{nl}"}} {int(st.get("n", 0))}')
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lines.append(f'blit_latency_quantile{{host="{hl}",name="{nl}",'
                             f'quantile="{q}"}} {h.get(key, 0)}')
        for k, v in (e.get("faults") or {}).items():
            lines.append(f'blit_fault_total{{host="{hl}",'
                         f'counter="{prom_escape(k)}"}} {v}')
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_fleet_text(report: Dict) -> str:
    """A fleet report as a human-readable per-host summary (the default
    ``python -m blit_torch telemetry`` output)."""
    lines: List[str] = []
    for host, e in (report.get("hosts") or {}).items():
        workers = e.get("workers") or []
        lines.append(f"host {host} ({len(workers)} worker"
                     f"{'s' if len(workers) != 1 else ''})")
        stages = e.get("stages") or {}
        rows = [(k, v) for k, v in stages.items()
                if isinstance(v, dict) and "calls" in v]
        if rows:
            lines.append(f"  {'stage':<22} {'calls':>8} {'seconds':>12} "
                         f"{'bytes':>16} {'GB/s':>8}")
            for k, v in sorted(rows):
                lines.append(
                    f"  {k:<22} {v.get('calls', 0):>8} "
                    f"{v.get('seconds', 0.0):>12} {v.get('bytes', 0):>16} "
                    f"{v.get('gbps', 0.0):>8}")
        for k, h in sorted((stages.get("hists") or {}).items()):
            lines.append(
                f"  hist {k:<18} n={h.get('n', 0):<7} "
                f"p50={h.get('p50', 0)} p99={h.get('p99', 0)} "
                f"max={h.get('max', 0)}")
        for k, v in sorted((e.get("faults") or {}).items()):
            lines.append(f"  fault {k:<20} {v}")
    errs = report.get("errors") or {}
    for host, msg in sorted(errs.items()):
        lines.append(f"host {host}: HARVEST FAILED — {msg}")
    fleet = report.get("fleet") or {}
    nstages = sum(1 for v in fleet.values()
                  if isinstance(v, dict) and "calls" in v)
    lines.append(f"fleet: {len(report.get('hosts') or {})} hosts, "
                 f"{nstages} stages, "
                 f"{len(report.get('spans') or [])} spans")
    return "\n".join(lines)


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
