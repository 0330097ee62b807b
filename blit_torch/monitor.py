"""The metrics publisher, the SLO layer and the operator's readers:
``blit/monitor.py`` on the port.

- :class:`MetricsPublisher`: a thread that samples every watched
  :class:`~blit_torch.observability.Timeline` (the process timeline and
  each reducer under :func:`publishing`) on an interval, appends one
  JSON line per sample to a per-process spool file (``blit``'s sample
  schema: cumulative ``timeline`` state, the interval's ``delta``,
  ``gauges``, ``slo``, ``alerts``, ``faults``), and serves ``/metrics``
  (Prometheus text, :func:`~blit_torch.observability.render_prometheus`),
  ``/healthz`` and ``/snapshot`` over a stdlib HTTP server.  Each sample
  carries the card's memory gauges (:func:`device_gauges`, from
  ``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info``).  With a
  history dir (``BLIT_HISTORY_DIR``) every tick folds into
  :class:`blit_torch.history.HistoryStore` and the
  :class:`~blit_torch.history.AnomalyDetector` scores it; with an
  incident dir (``BLIT_INCIDENT_DIR``) every page writes a bundle.
- The SLO layer: :class:`SLObjective` from
  :func:`blit_torch.config.slo_defaults`, :func:`bad_fraction` and the
  multi-window :class:`BurnRateEvaluator` over each interval's deltas
  (a breach: an alert, a flight dump, the shed hooks).
- :func:`ensure_publisher` / :func:`install_publisher` /
  :func:`shutdown_publisher`, :func:`publishing` / :func:`published`,
  the ``/healthz`` hooks, and :func:`read_spool` / :func:`merge_spool`.
- The operator's readers: :func:`render_top` / :func:`watch_loop` (the
  ``top`` and ``telemetry --watch`` frames), :func:`parse_prometheus` /
  :func:`parse_prometheus_exemplars`, :func:`gather_trace_sources`
  (``trace-view --fleet``), the ``bench-diff`` gate
  (:func:`bench_metrics`, :func:`bench_diff`, :func:`render_bench_diff`),
  :func:`fold_health`, and the access-record readers of the
  ``requests`` command (:func:`read_requests`, :func:`filter_requests`,
  :func:`aggregate_requests`, :func:`render_requests`).

Monitoring is off unless a spool dir, a port or a history dir is
configured (``BLIT_MONITOR_SPOOL`` / ``BLIT_MONITOR_PORT`` /
``BLIT_HISTORY_DIR``), as in ``blit``.

Imports only the standard library, :mod:`blit_torch.config` and
:mod:`blit_torch.observability` at module scope, and torch never.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import glob
import json
import logging
import os
import re
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from blit_torch.config import (
    DEFAULT,
    SiteConfig,
    history_defaults,
    monitor_defaults,
    slo_defaults,
)
from blit_torch.observability import (
    OPENMETRICS_CTYPE,
    PROM_CTYPE,
    HistogramStats,
    Timeline,
    flight_recorder,
    hist_bucket_edges,
    hostname,
    merge_fleet,
    process_timeline,
    render_prometheus,
    wall_anchor,
    wants_openmetrics,
)

log = logging.getLogger("blit_torch.monitor")

# Clear the terminal and home the cursor (the top / telemetry --watch loop).
ANSI_CLEAR = "\x1b[2J\x1b[H"


# -- SLO objectives + burn-rate evaluation ----------------------------------


@dataclass(frozen=True)
class SLObjective:
    """One service-level objective over a live metric.

    ``kind="latency"``: ``metric`` names a Timeline histogram
    (``sched.wait_s``, ``stream.chunk_to_product_s``, ...) and
    ``threshold`` is the per-sample ceiling in seconds — a sample above
    it is "bad", and the error budget allows a ``budget`` fraction of
    bad samples (budget 0.01 == a p99 ceiling).

    ``kind="throughput"``: ``metric`` names a Timeline STAGE and
    ``threshold`` is a GB/s floor — an interval where the stage ran
    below the floor is one bad observation (intervals where the stage
    was idle observe nothing: a paused pipeline is not a slow one)."""

    name: str
    metric: str
    threshold: float
    kind: str = "latency"
    budget: float = 0.01

    def __post_init__(self):
        if self.kind not in ("latency", "throughput"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.budget <= 0:
            raise ValueError("SLO budget must be > 0")

    @classmethod
    def from_dict(cls, d: Dict) -> "SLObjective":
        return cls(name=str(d["name"]), metric=str(d["metric"]),
                   threshold=float(d["threshold"]),
                   kind=str(d.get("kind", "latency")),
                   budget=float(d.get("budget", 0.01)))


def objectives_for(config: SiteConfig = DEFAULT) -> List[SLObjective]:
    """The configured objective list (:func:`blit_torch.config.slo_defaults`
    dicts adopted as :class:`SLObjective`)."""
    return [SLObjective.from_dict(d) for d in slo_defaults(config)]


def bad_fraction(hist: HistogramStats, threshold: float) -> Tuple[int, int]:
    """``(bad, total)`` samples of a histogram (usually an interval
    DELTA) relative to a latency ceiling: a sample is bad when its whole
    bucket sits above ``threshold`` (bucket LOWER edge >= threshold —
    conservative by up to one log2 bucket, never spuriously bad)."""
    bad = 0
    edges = hist_bucket_edges()
    for i, c in enumerate(hist.counts):
        if not c:
            continue
        lower = 0.0 if i == 0 else edges[i - 1]
        if lower >= threshold:
            bad += c
    return bad, hist.n


class BurnRateEvaluator:
    """Multi-window error-budget burn over live metric deltas.

    Each evaluation round (one publisher interval) contributes one
    ``(bad, total)`` observation per objective; the burn rate over a
    window of recent rounds is ``(bad fraction) / (error budget)`` —
    burn 1.0 spends the budget exactly, burn 14 torches it.  An
    objective BREACHES when the burn exceeds ``fast_burn`` over the last
    ``fast_window`` rounds AND ``slow_burn`` over the last
    ``slow_window`` rounds (the SRE multi-window page rule: the short
    window reacts fast, the long window stops flapping).

    Breach actions: an alert record (bounded ``alerts`` deque + flight
    ring event + ``slo.breach.<name>`` counter on the process timeline),
    a flight dump (FORCED on an objective's first breach; later breaches
    ride the recorder's rate limit — an alert storm writes one incident
    file, not hundreds, and never blocks the hot path), and the
    registered shed hooks: while any objective is breached the hooks run
    with ``shed_level`` (tightening scheduler admission,
    :meth:`blit_torch.serve.scheduler.Scheduler.shed`); when every burn
    clears they run with 0.0."""

    def __init__(self, objectives: Iterable[SLObjective] = (), *,
                 fast_window: int = 5, slow_window: int = 30,
                 fast_burn: float = 14.0, slow_burn: float = 2.0,
                 shed_level: float = 0.5, recorder=None,
                 clock: Callable[[], float] = time.time):
        self.objectives = [o if isinstance(o, SLObjective)
                           else SLObjective.from_dict(o)
                           for o in objectives]
        self.fast_window = max(1, int(fast_window))
        self.slow_window = max(self.fast_window, int(slow_window))
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.shed_level = float(shed_level)
        self.recorder = recorder
        self.clock = clock
        self._rings: Dict[str, List[Tuple[int, int]]] = {
            o.name: [] for o in self.objectives}
        self._state: Dict[str, Dict] = {
            o.name: {"metric": o.metric, "kind": o.kind,
                     "threshold": o.threshold, "burn_fast": 0.0,
                     "burn_slow": 0.0, "breached": False}
            for o in self.objectives}
        self._dumped: set = set()
        self._shed_hooks: List[Callable[[float], None]] = []
        self._shed = 0.0
        self.alerts: List[Dict] = []
        # The last round's per-objective (bad, total) observations —
        # what blit's history store folds (it folds them
        # into bucket records so slo-report sums the same cut the live
        # evaluator made).
        self.last_obs: Dict[str, Tuple[int, int]] = {}

    @classmethod
    def for_config(cls, config: SiteConfig = DEFAULT, **kw
                   ) -> "BurnRateEvaluator":
        return cls(objectives_for(config),
                   fast_window=config.slo_fast_window,
                   slow_window=config.slo_slow_window,
                   fast_burn=config.slo_fast_burn,
                   slow_burn=config.slo_slow_burn, **kw)

    # -- shed hooks --------------------------------------------------------
    def add_shed_hook(self, hook: Callable[[float], None]) -> None:
        self._shed_hooks.append(hook)

    def attach_scheduler(self, scheduler) -> None:
        """Register ``scheduler.shed`` as a breach action
        (:meth:`blit_torch.serve.scheduler.Scheduler.shed`)."""
        self.add_shed_hook(scheduler.shed)

    def detach_scheduler(self, scheduler) -> None:
        with contextlib.suppress(ValueError):
            self._shed_hooks.remove(scheduler.shed)

    # -- evaluation --------------------------------------------------------
    def burn(self, name: str, window: int) -> float:
        ring = self._rings.get(name) or []
        tail = ring[-max(1, window):]
        total = sum(t for _, t in tail)
        if total == 0:
            return 0.0
        bad = sum(b for b, _ in tail)
        o = next(x for x in self.objectives if x.name == name)
        return (bad / total) / o.budget

    def observe(self, delta: Timeline, interval_s: float) -> List[Dict]:
        """Fold one interval's Timeline DELTA into every objective's
        burn window and fire breach actions.  Returns the alerts raised
        this round.  Cheap and non-blocking by design: bucket sums, a
        bounded ring, and a rate-limited dump."""
        fired: List[Dict] = []
        breached_any = False
        for o in self.objectives:
            if o.kind == "latency":
                h = delta.hists.get(o.metric)
                bad, total = (bad_fraction(h, o.threshold)
                              if h is not None and h.n else (0, 0))
            else:
                s = delta.stages.get(o.metric)
                if s is not None and s.seconds > 0:
                    gbps = s.bytes / s.seconds / 1e9
                    bad, total = (1, 1) if gbps < o.threshold else (0, 1)
                else:
                    bad, total = 0, 0
            ring = self._rings[o.name]
            ring.append((bad, total))
            del ring[:-self.slow_window]
            self.last_obs[o.name] = (bad, total)
            bf = self.burn(o.name, self.fast_window)
            bs = self.burn(o.name, self.slow_window)
            breach = bf >= self.fast_burn and bs >= self.slow_burn
            st = self._state[o.name]
            st.update(burn_fast=round(bf, 3), burn_slow=round(bs, 3),
                      breached=breach)
            if not breach:
                continue
            breached_any = True
            alert = {"t": self.clock(), "class": "slo",
                     "objective": o.name,
                     "kind": o.kind, "metric": o.metric,
                     "threshold": o.threshold, "burn_fast": round(bf, 3),
                     "burn_slow": round(bs, 3), "bad": bad,
                     "total": total}
            rec = self.recorder if self.recorder is not None \
                else flight_recorder()
            rec.event("slo", o.name, burn_fast=round(bf, 2),
                      burn_slow=round(bs, 2))
            process_timeline().count(f"slo.breach.{o.name}")
            # First breach per objective FORCES its incident dump (the
            # triage trail must exist); every later one rides the
            # recorder's rate limit — the LiveRawStream._incident rule.
            path = rec.dump(
                f"SLO breach: {o.name} burning {bf:.1f}x its error "
                f"budget over the last {self.fast_window} samples "
                f"({o.kind} {o.metric!r}, threshold {o.threshold})",
                force=o.name not in self._dumped)
            self._dumped.add(o.name)
            if path:
                alert["flight_dump"] = path
            self.alerts.append(alert)
            del self.alerts[:-256]
            fired.append(alert)
            log.warning("SLO breach: %s (burn fast=%.1f slow=%.1f)",
                        o.name, bf, bs)
        target = self.shed_level if breached_any else 0.0
        if target != self._shed:
            self._shed = target
            for hook in list(self._shed_hooks):
                try:
                    hook(target)
                except Exception:  # noqa: BLE001 — one bad hook must not
                    log.warning("SLO shed hook failed", exc_info=True)
        return fired

    def breached(self) -> List[str]:
        return [n for n, st in self._state.items() if st["breached"]]

    def report(self) -> Dict[str, Dict]:
        """Current burn/breach state per objective (the sample's ``slo``
        block and a dashboard's SLO row)."""
        return {n: dict(st) for n, st in self._state.items()}


# -- device / derived gauges ------------------------------------------------


def device_gauges(timeline: Timeline) -> int:
    """Sample the card's memory onto ``timeline``: per device
    ``dev.hbm_in_use_bytes.<i>`` (``torch.cuda.memory_stats``'
    ``allocated_bytes.all.current``), ``dev.hbm_peak_bytes.<i>``
    (``.peak``) and ``dev.hbm_free_bytes.<i>`` (``torch.cuda.mem_get_info``),
    and their sums.  Touches CUDA only when this process already
    initialized it (a CPU run, or ``top`` reading a spool, must not), and
    never imports torch.  Returns the number of devices sampled."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return 0
        count = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — monitoring must not break the run
        return 0
    n = in_use = peak = 0
    for i in range(count):
        try:
            st = torch.cuda.memory_stats(i)
            free, _ = torch.cuda.mem_get_info(i)
        except Exception:  # noqa: BLE001
            continue
        bi = int(st.get("allocated_bytes.all.current", 0))
        pk = int(st.get("allocated_bytes.all.peak", bi))
        timeline.gauge(f"dev.hbm_in_use_bytes.{i}", bi)
        timeline.gauge(f"dev.hbm_peak_bytes.{i}", pk)
        timeline.gauge(f"dev.hbm_free_bytes.{i}", int(free))
        in_use += bi
        peak += pk
        n += 1
    if n:
        timeline.gauge("dev.hbm_in_use_bytes", in_use)
        timeline.gauge("dev.hbm_peak_bytes", peak)
    return n


def _delta_timeline(merged: Timeline, last_state: Optional[Dict]
                    ) -> Timeline:
    """The increment between a merged cumulative Timeline and a prior
    :meth:`Timeline.state` — stages subtract exactly, histograms go
    through ``HistogramStats.since`` (bucket-exact), gauges copy their
    latest level (a level has no meaningful delta)."""
    d = Timeline()
    last_stages = (last_state or {}).get("stages") or {}
    for k, s in list(merged.stages.items()):
        p = last_stages.get(k) or {}
        calls = s.calls - int(p.get("calls", 0))
        seconds = s.seconds - float(p.get("seconds", 0.0))
        nbytes = s.bytes - int(p.get("bytes", 0))
        if calls or nbytes or seconds > 1e-12:
            ds = d.stages[k]
            ds.calls = max(0, calls)
            ds.seconds = max(0.0, seconds)
            ds.bytes = max(0, nbytes)
            ds.byte_free = s.byte_free
    last_hists = (last_state or {}).get("hists") or {}
    for k, h in list(merged.hists.items()):
        dh = h.since(last_hists.get(k) or {})
        if dh.n:
            d.hists[k] = dh
    for k, g in list(merged.gauges.items()):
        if g.n:
            d.gauge(k, g.last)
    return d


# -- the publisher -----------------------------------------------------------


def _make_http_server(publisher, port: int):
    """Lazily built so spool-only publishers never import http.server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — stdlib contract
            try:
                if self.path.startswith("/healthz"):
                    body = json.dumps(publisher.health()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    # Exemplars only in the negotiated OpenMetrics
                    # exposition: the legacy text parser rejects them.
                    om = wants_openmetrics(self.headers.get("Accept"))
                    body = render_prometheus(
                        publisher.fleet_report(),
                        openmetrics=om).encode()
                    ctype = OPENMETRICS_CTYPE if om else PROM_CTYPE
                elif self.path.startswith("/snapshot"):
                    sample = publisher.last_sample or publisher.tick()
                    body = json.dumps(sample).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
            except Exception as e:  # noqa: BLE001 — scrape must not kill
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet scrape traffic
            log.debug("http: " + fmt, *args)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.daemon_threads = True
    return server


class MetricsPublisher:
    """Continuous telemetry publishing for one process (module
    docstring): interval snapshots of every WATCHED Timeline (merged;
    the process-wide ambient timeline is always in the set), each sample
    carrying the cumulative state (the fleet-merge wire format) plus the
    interval's stage/histogram DELTAS, appended to a per-process spool
    file and served over HTTP.  ``tick()`` takes one sample
    synchronously — tests and the SLO drills drive it directly;
    ``start()`` runs it on a daemon thread every ``interval_s``."""

    def __init__(self, *, interval_s: Optional[float] = None,
                 spool_dir: Optional[str] = None,
                 port: Optional[int] = None,
                 timeline: Optional[Timeline] = None,
                 objectives: Optional[Iterable] = None,
                 config: SiteConfig = DEFAULT,
                 spans: Optional[bool] = None,
                 clock: Callable[[], float] = time.time):
        d = monitor_defaults(config)
        self.interval_s = (d["interval_s"] if interval_s is None
                           else float(interval_s))
        self.spool_dir = spool_dir if spool_dir is not None \
            else d["spool_dir"]
        # Span batches per sample: each tick
        # ships the spans finished since the last, so the spool doubles
        # as a fleet trace source (BLIT_MONITOR_SPANS / ctor arg).
        self.spans = d["spans"] if spans is None else bool(spans)
        self._span_cursor = 0
        self.clock = clock
        # Publisher-owned gauges (device HBM, derived ICI rate) live on
        # their own timeline so sampling never mutates a caller's.
        self._own = Timeline()
        self._watch_lock = threading.Lock()
        self._watched: List[Timeline] = [
            self._own, timeline if timeline is not None
            else process_timeline()]
        if objectives is None:
            self.slo = BurnRateEvaluator.for_config(config, clock=clock)
        else:
            self.slo = BurnRateEvaluator(
                objectives, fast_window=config.slo_fast_window,
                slow_window=config.slo_slow_window,
                fast_burn=config.slo_fast_burn,
                slow_burn=config.slo_slow_burn, clock=clock)
        # History & forensics plane: a durable tiered store
        # fed per tick, a median/MAD anomaly baseline scored per tick,
        # and the incident bundler behind every page.  All lazy and all
        # optional — with BLIT_HISTORY_DIR unset the tick path pays one
        # dict lookup and three Nones.
        self._config = config
        self.history = None
        self.anomaly = None
        self._bundler = None
        hd = history_defaults(config)
        if hd["enabled"]:
            from blit_torch import history as _history

            try:
                self.history = _history.HistoryStore(
                    hd["dir"], config=config, clock=clock)
            except (OSError, ValueError):
                log.warning("history store unavailable", exc_info=True)
        if hd["anomaly"] and (hd["enabled"] or hd["incident_dir"]):
            from blit_torch import history as _history

            self.anomaly = _history.AnomalyDetector.for_config(
                config, clock=clock)
        if hd["incident_dir"]:
            from blit_torch import history as _history

            self._bundler = _history.incident_bundler(config)
        self.seq = 0
        self.last_sample: Optional[Dict] = None
        self._last_state: Optional[Dict] = None
        self._last_mono: Optional[float] = None
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._spool_f = None
        self.spool_path: Optional[str] = None
        if self.spool_dir:
            os.makedirs(self.spool_dir, exist_ok=True)
            self.spool_path = os.path.join(
                self.spool_dir, f"{hostname()}-{os.getpid()}.jsonl")
            self._spool_f = open(self.spool_path, "a")
        self._server = None
        self._server_thread = None
        self.port: Optional[int] = None
        if port is None:
            port = d["port"]
        elif int(port) < 0:
            # The planes' -1 "disabled" encoding, honored for EXPLICIT
            # ctor args too: an embedding server (the fleet PeerServer
            # reuses this class for its health/metrics bodies) can pin
            # the endpoint off however the environment is set.
            port = None
        if port is not None:
            self._server = _make_http_server(self, int(port))
            self.port = self._server.server_address[1]

    # -- watch set ---------------------------------------------------------
    def watch(self, timeline: Timeline) -> None:
        """Add a Timeline to the merged sample (refcounted list append —
        nested :func:`publishing` scopes over the same timeline
        balance)."""
        with self._watch_lock:
            self._watched.append(timeline)

    def unwatch(self, timeline: Timeline) -> None:
        with self._watch_lock:
            for i in range(len(self._watched) - 1, 1, -1):
                if self._watched[i] is timeline:
                    del self._watched[i]
                    return

    def merged_timeline(self) -> Timeline:
        """One cumulative fold of every CURRENTLY watched timeline
        (deduped by identity — a timeline watched from two nested scopes
        counts once).  A workload that unwatches leaves the merged view:
        the publisher is a live surface, and a scraper sees the drop as
        an ordinary counter reset (Prometheus ``rate()``/``increase()``
        handle those natively); the workload's full history stays in the
        spool lines it published while attached."""
        with self._watch_lock:
            tls = list(self._watched)
        merged, seen = Timeline(), set()
        for tl in tls:
            if id(tl) in seen:
                continue
            seen.add(id(tl))
            merged.merge(Timeline.from_state(tl.state()))
        return merged

    # -- sampling ----------------------------------------------------------
    def tick(self) -> Dict:
        """Take one sample NOW: merge the watch set, compute the
        interval delta, sample device/derived gauges, evaluate the SLOs,
        spool the record, and return it."""
        with self._tick_lock:
            now_mono = time.monotonic()
            interval = (self.interval_s if self._last_mono is None
                        else max(1e-9, now_mono - self._last_mono))
            self._last_mono = now_mono
            device_gauges(self._own)
            merged = self.merged_timeline()
            delta = _delta_timeline(merged, self._last_state)
            # ICI byte-rate, derived from the mesh.*_ici_bytes hists
            # (each sample in those is one collective's payload).
            ici = sum(h.total for k, h in delta.hists.items()
                      if k.endswith("_ici_bytes"))
            if ici:
                self._own.gauge("mesh.ici_gbps", ici / interval / 1e9)
                merged.gauge("mesh.ici_gbps", ici / interval / 1e9)
            alerts = self.slo.observe(delta, interval)
            now = self.clock()
            anomaly_state: Dict[str, Dict] = {}
            if self.anomaly is not None:
                from blit_torch import history as _history

                gauges_now = {k: g.last
                              for k, g in merged.gauges.items() if g.n}
                alerts = alerts + self.anomaly.observe(
                    _history.series_values(delta, gauges_now), now)
                anomaly_state = self.anomaly.report()
            if self.history is not None:
                try:
                    self.history.append(
                        now, interval, delta,
                        gauges={k: g.last
                                for k, g in merged.gauges.items() if g.n},
                        burn=dict(self.slo.last_obs))
                except Exception:  # noqa: BLE001 — durability is best-
                    log.warning("history append failed", exc_info=True)
            if self._bundler is not None:
                for alert in alerts:
                    kind = (f"slo:{alert['objective']}"
                            if alert.get("objective")
                            else f"anomaly:{alert.get('metric', '?')}")
                    self._bundler.snapshot(
                        kind,
                        f"page: {kind} "
                        f"(flight={alert.get('flight_dump', '-')})",
                        alert=alert, publisher=self, timeline=merged,
                        history=self.history)
            self._last_state = merged.state()
            from blit_torch import faults

            sample = {
                "t": now,
                "seq": self.seq,
                "host": hostname(),
                "pid": os.getpid(),
                "worker": 0,
                "anchor": wall_anchor(),
                "interval_s": round(interval, 6),
                "timeline": self._last_state,
                "faults": faults.counters(),
                "delta": {
                    "stages": {
                        k: {"calls": s.calls,
                            "seconds": round(s.seconds, 6),
                            "bytes": s.bytes,
                            "gbps": round(s.gbps, 4)}
                        for k, s in sorted(delta.stages.items())
                    },
                    "hists": {k: h.report()
                              for k, h in sorted(delta.hists.items())},
                },
                "gauges": {k: round(g.last, 6)
                           for k, g in sorted(merged.gauges.items())},
                "slo": self.slo.report(),
                "alerts": alerts,
            }
            if anomaly_state:
                sample["anomaly"] = anomaly_state
            if self.spans:
                from blit_torch import observability

                self._span_cursor, new_spans = (
                    observability.tracer().spans_since(self._span_cursor))
                sample["spans"] = new_spans
            self.seq += 1
            self.last_sample = sample
            if self._spool_f is not None:
                try:
                    self._spool_f.write(json.dumps(sample) + "\n")
                    self._spool_f.flush()
                except OSError:
                    log.warning("monitor spool write failed",
                                exc_info=True)
            return sample

    def snapshot_dict(self) -> Dict:
        """This process's cumulative telemetry in the fleet-harvest wire
        shape (:func:`~blit_torch.observability.merge_fleet` input) — the
        merged watch set as ONE snapshot, so per-reducer timelines
        cannot collapse into each other through the (host, pid) dedupe."""
        from blit_torch import faults

        return {"host": hostname(), "pid": os.getpid(), "worker": 0,
                "timeline": self.merged_timeline().state(),
                "faults": faults.counters(), "spans": []}

    def fleet_report(self) -> Dict:
        return merge_fleet([self.snapshot_dict()])

    def health(self) -> Dict:
        """The ``/healthz`` body — and it degrades honestly: ``status`` is ``"degraded"`` (with machine-readable
        ``reasons``) whenever a circuit breaker is not fully closed, a
        recovery supervisor is mid-recovery (health hooks), or an SLO is
        in fast-burn; ``"ok"`` otherwise.  ``ok`` stays the boolean twin
        of ``status`` so existing probes keep working."""
        reasons: List[str] = []
        breached = self.slo.breached()
        for name in breached:
            reasons.append(f"slo-fast-burn:{name}")
        if self.anomaly is not None:
            for metric in self.anomaly.breached():
                reasons.append(f"anomaly:{metric}")
        try:
            # Lazy import (monitor's import discipline): the pool module
            # imports no torch at module scope.
            from blit_torch.parallel.pool import current_pool

            pool = current_pool()
        except Exception:  # noqa: BLE001 — health must not raise
            pool = None
        if pool is not None:
            for row in pool.health():
                if row.get("state") != "closed":
                    reasons.append(
                        f"breaker-{row['state'].replace('-', '_')}:"
                        f"{row.get('host')}")
        status_override: Optional[str] = None
        for name, hook in list(_HEALTH_HOOKS.items()):
            try:
                state = hook()
            except Exception:  # noqa: BLE001 — one bad hook must not
                continue
            if state and state.get("degraded"):
                reasons.append(
                    f"{name}:{state.get('reason', 'degraded')}")
                # A hook may name the degradation mode — the elastic
                # controller answers "resizing" mid-flip, a
                # more truthful probe verdict than a generic
                # "degraded".
                if state.get("status"):
                    status_override = str(state["status"])
        status = (status_override or "degraded") if reasons else "ok"
        return {"ok": not reasons, "status": status, "reasons": reasons,
                "t": self.clock(), "host": hostname(),
                "pid": os.getpid(), "seq": self.seq,
                "interval_s": self.interval_s,
                "watching": len(self._watched),
                "breached": breached,
                "alerts": len(self.slo.alerts)}

    @property
    def url(self) -> Optional[str]:
        return (f"http://127.0.0.1:{self.port}"
                if self.port is not None else None)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MetricsPublisher":
        if self._server is not None and self._server_thread is None:
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, name="blit-monitor-http",
                daemon=True)
            self._server_thread.start()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="blit-monitor", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — publishing must not die
                log.warning("monitor tick failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._server_thread = None
        if self._spool_f is not None:
            with contextlib.suppress(OSError):
                self._spool_f.close()
            self._spool_f = None
        if self.history is not None:
            self.history.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def fold_health(own_reasons: Iterable[str],
                peer_health: Dict[str, Optional[Dict]], *,
                clock: Callable[[], float] = time.time) -> Dict:
    """Fold per-peer health documents into one fleet ``{ok, status,
    reasons}`` answer: the front door's ``/healthz`` body, so a single
    probe answers "is the fleet serving".

    ``own_reasons`` are the door's local degradations (draining, open
    breakers, ejected peers); ``peer_health`` maps peer name → its last
    fetched ``/healthz`` body (None = unreachable/never fetched).  A
    peer's own reasons fold in prefixed with its name; ``status`` is
    ``"ok"`` only when nothing anywhere is degraded, ``"degraded"``
    while any peer (or the door) carries a reason but the fleet can
    still serve, and the caller may override to ``"down"`` when no
    peers remain routable."""
    reasons: List[str] = list(own_reasons)
    peers_ok = 0
    for name, doc in sorted(peer_health.items()):
        if doc is None:
            reasons.append(f"peer-unreachable:{name}")
            continue
        if doc.get("ok"):
            peers_ok += 1
            continue
        peers_ok += 1  # degraded but answering — still serving
        for r in doc.get("reasons") or ["degraded"]:
            reasons.append(f"peer:{name}:{r}")
    status = "ok" if not reasons else ("degraded" if peers_ok else "down")
    return {"ok": not reasons, "status": status, "reasons": reasons,
            "peers": len(peer_health), "peers_ok": peers_ok,
            "t": clock()}


# -- health hooks -----------------------------------------------------------

# Named callables other planes register so /healthz can degrade honestly
# without this module importing them: each returns None/{} when healthy,
# or {"degraded": True, "reason": "...", ...} while not (in ``blit``,
# the recovery supervisors register here for a supervised run).
_HEALTH_HOOKS: Dict[str, Callable[[], Optional[Dict]]] = {}


def register_health_hook(name: str,
                         hook: Callable[[], Optional[Dict]]) -> None:
    """Register (or replace) a named /healthz contributor."""
    _HEALTH_HOOKS[name] = hook


def unregister_health_hook(name: str) -> None:
    _HEALTH_HOOKS.pop(name, None)


# -- the process-wide auto-publisher ----------------------------------------

_PUB: Optional[MetricsPublisher] = None
_PUB_LOCK = threading.Lock()


def ensure_publisher(config: SiteConfig = DEFAULT
                     ) -> Optional[MetricsPublisher]:
    """The process-wide publisher, started on first use when monitoring
    is enabled (``BLIT_MONITOR_SPOOL`` / ``BLIT_MONITOR_PORT`` or the
    SiteConfig fields — :func:`blit.config.monitor_defaults`) or a
    publisher was installed explicitly (:func:`install_publisher` — the
    CLI ``--monitor-*`` flags); ``None`` when disabled.  Every
    long-running entry point (reduce/scan/stream/serve, via
    :func:`publishing`) calls this, so flipping one env var turns
    continuous publishing on for any workload with no code changes."""
    global _PUB
    with _PUB_LOCK:
        if _PUB is not None:
            return _PUB
    # BLIT_HISTORY_DIR alone also arms the loop: the
    # durable store is fed by ticks, so a history-only config still
    # needs the publisher running even with no spool and no port.
    if not (monitor_defaults(config)["enabled"]
            or history_defaults(config)["enabled"]):
        return None
    with _PUB_LOCK:
        if _PUB is None:
            _PUB = MetricsPublisher(config=config).start()
            atexit.register(shutdown_publisher)
        return _PUB


def install_publisher(pub: MetricsPublisher) -> MetricsPublisher:
    """Install ``pub`` (started) as the process-wide publisher — the
    flag-driven twin of the env gate, so CLI ``--monitor-*`` flags reach
    every :func:`publishing` hook without mutating the environment.
    Replaces (and closes) any previous singleton."""
    global _PUB
    with _PUB_LOCK:
        old, _PUB = _PUB, pub
    if old is not None and old is not pub:
        old.close()
    atexit.register(shutdown_publisher)
    return pub


def shutdown_publisher() -> None:
    """Stop and forget the process-wide publisher (tests; atexit)."""
    global _PUB
    with _PUB_LOCK:
        pub, _PUB = _PUB, None
    if pub is not None:
        pub.close()


@contextlib.contextmanager
def publishing(timeline: Optional[Timeline] = None,
               config: SiteConfig = DEFAULT):
    """Scope a workload under the process-wide publisher: when
    monitoring is enabled, ``timeline`` joins the publisher's watch set
    for the duration (so a reducer's private Timeline shows up on
    ``/metrics`` and in the spool while it streams).  Disabled = a
    no-op costing two env reads."""
    pub = ensure_publisher(config)
    if pub is None or timeline is None:
        yield pub
        return
    seq0 = pub.seq
    pub.watch(timeline)
    try:
        yield pub
    finally:
        # A workload that finished between two interval ticks would
        # otherwise leave NO sample carrying its timeline — force one,
        # but only when the background loop didn't already cover it
        # (a busy serve process must not spool one line per request).
        try:
            if pub.seq == seq0:
                pub.tick()
        except Exception:  # noqa: BLE001 — publishing must not fail work
            log.warning("publishing exit tick failed", exc_info=True)
        pub.unwatch(timeline)


def published(fn):
    """Decorator form of :func:`publishing` for entry points with a
    ``timeline=`` kwarg (the scan planes)."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with publishing(kw.get("timeline")):
            return fn(*args, **kw)

    return wrapper


# -- spool reading / fleet merge --------------------------------------------


# How many trailing bytes of a spool file one dashboard frame reads: a
# spool grows without bound over a long session, and a dashboard must
# stay O(1) per frame, not O(session length).
_SPOOL_TAIL_BYTES = 2 << 20


def read_spool(spool_dir: str, tail: int = 1) -> List[Dict]:
    """The newest ``tail`` parseable samples from every per-process
    spool file, flattened oldest→newest per file.  Reads only the last
    ``_SPOOL_TAIL_BYTES`` of each file, so a frame over a multi-hour
    spool costs the same as over a fresh one.

    Torn-tail hardening: a publisher SIGKILLed
    mid-``write`` leaves a truncated trailing line — it HEALS (skipped)
    and COUNTS (``monitor.torn_lines`` on the process timeline), the
    so ``blit top`` over the spool keeps rendering while
    the damage stays visible."""
    samples = []
    torn = 0
    for path in sorted(glob.glob(os.path.join(spool_dir, "*.jsonl"))):
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - _SPOOL_TAIL_BYTES))
                blob = f.read()
        except OSError:
            continue
        lines = blob.decode("utf-8", errors="replace").splitlines()
        if size > _SPOOL_TAIL_BYTES and lines:
            lines = lines[1:]  # the seek likely landed mid-line
        got: List[Dict] = []
        for line in reversed(lines):
            line = line.strip()
            if not line:
                continue
            try:
                got.append(json.loads(line))
            except ValueError:
                torn += 1
                continue
            if len(got) >= tail:
                break
        samples.extend(reversed(got))
    if torn:
        process_timeline().count("monitor.torn_lines", torn)
    return samples


def merge_spool(spool_dir: str) -> Tuple[Dict, List[Dict]]:
    """Merge a spool dir's per-process samples into one fleet report
    plus the newest per-process samples for the rate/SLO panel.

    The report folds the recent spool TAIL, not just the newest line —
    samples carry the cumulative ``timeline`` state so they ARE
    :func:`~blit_torch.observability.merge_fleet` snapshots — selecting ONE
    per (host, pid) by (richness, seq): richest first, so a workload
    that already detached from the live publisher (its final lines are
    quiet) still renders the full stage table it spooled while
    running, and NEWEST among equally-rich lines, so a steady-state
    run's dashboard shows current counters, not the oldest line of the
    tail (merge_fleet's own dedupe is first-wins on richness ties —
    right for harvest duplicates, stale for a time-ordered spool)."""
    samples = read_spool(spool_dir, tail=1000)
    best: Dict[Tuple, Tuple] = {}
    latest: Dict[Tuple, Dict] = {}
    for s in samples:
        key = (s.get("host"), s.get("pid"))
        rank = (len((s.get("timeline") or {}).get("stages") or {}),
                s.get("seq", 0))
        if key not in best or rank >= best[key][0]:
            best[key] = (rank, s)
        if key not in latest or s.get("seq", 0) >= \
                latest[key].get("seq", 0):
            latest[key] = s
    report = merge_fleet([s for _, s in best.values()])
    return report, list(latest.values())


# -- rendering ---------------------------------------------------------------


def _fmt_rate(gbps: float) -> str:
    return f"{gbps:8.3f}" if gbps else f"{'-':>8}"


def render_top(report: Dict, samples: Iterable[Dict] = (), *,
               title: str = "blit top",
               now: Optional[float] = None) -> str:
    """One ``top`` frame over a fleet report (+ optional live
    per-process samples): per-stage throughput (run-cumulative and
    this-interval), stage-tail p50/p99, SLO burn, and host health."""
    now = time.time() if now is None else now
    samples = list(samples)
    by_proc = {(s.get("host"), s.get("pid")): s for s in samples}
    lines: List[str] = []
    hosts = report.get("hosts") or {}
    nproc = sum(len(e.get("workers") or []) for e in hosts.values())
    breached = sorted({n for s in samples
                       for n, st in (s.get("slo") or {}).items()
                       if st.get("breached")})
    state = (f"SLO BREACH: {', '.join(breached)}" if breached else "ok")
    lines.append(
        f"{title} — {time.strftime('%H:%M:%S', time.gmtime(now))} UTC | "
        f"{len(hosts)} host(s), {nproc} process(es) | {state}")
    for host, e in sorted(hosts.items()):
        procs = [s for (h, _), s in sorted(by_proc.items())
                 if h == host]
        age = min((now - s.get("t", now) for s in procs), default=None)
        age_s = f"  age {age:.1f}s" if age is not None else ""
        lines.append(f"host {host} "
                     f"({len(e.get('workers') or [])} proc){age_s}")
        # Per-stage table: cumulative GB/s beside the newest interval's.
        deltas: Dict[str, Dict] = {}
        for s in procs:
            for k, row in ((s.get("delta") or {}).get("stages")
                           or {}).items():
                d = deltas.setdefault(
                    k, {"bytes": 0, "seconds": 0.0, "calls": 0})
                d["bytes"] += row.get("bytes", 0)
                d["seconds"] += row.get("seconds", 0.0)
                d["calls"] += row.get("calls", 0)
        stages = e.get("stages") or {}
        rows = [(k, v) for k, v in stages.items()
                if isinstance(v, dict) and "calls" in v]
        if rows:
            lines.append(f"  {'stage':<22} {'calls':>8} {'GB/s(run)':>10} "
                         f"{'GB/s(now)':>10}")
            for k, v in sorted(rows):
                d = deltas.get(k)
                now_gbps = (d["bytes"] / d["seconds"] / 1e9
                            if d and d["seconds"] > 0 else 0.0)
                lines.append(
                    f"  {k:<22} {v.get('calls', 0):>8} "
                    f"{_fmt_rate(v.get('gbps', 0.0))} "
                    f"{_fmt_rate(round(now_gbps, 3))}")
        for k, h in sorted((stages.get("hists") or {}).items()):
            lines.append(
                f"  tail {k:<19} n={h.get('n', 0):<7} "
                f"p50={h.get('p50', 0)}s p99={h.get('p99', 0)}s "
                f"max={h.get('max', 0)}s")
        gauges = {}
        for s in procs:
            gauges.update(s.get("gauges") or {})
        if not procs:
            gauges = {k: g.get("last", 0)
                      for k, g in (stages.get("gauges") or {}).items()}
        if gauges:
            shown = " ".join(f"{k}={v}" for k, v in sorted(gauges.items()))
            lines.append(f"  gauges {shown}")
        for k, v in sorted((e.get("faults") or {}).items()):
            lines.append(f"  fault {k:<20} {v}")
    for (host, pid), s in sorted(by_proc.items()):
        slo = s.get("slo") or {}
        if not slo:
            continue
        for name, st in sorted(slo.items()):
            mark = "BREACH" if st.get("breached") else "ok"
            lines.append(
                f"slo {host}/{pid} {name:<20} burn "
                f"{st.get('burn_fast', 0.0):>7.2f}/"
                f"{st.get('burn_slow', 0.0):<7.2f} [{mark}] "
                f"({st.get('kind')} {st.get('metric')} "
                f"@ {st.get('threshold')})")
    alerts = [a for s in samples for a in (s.get("alerts") or [])]
    for a in alerts[-5:]:
        lines.append(f"ALERT {a.get('objective')} burn_fast="
                     f"{a.get('burn_fast')} dump="
                     f"{a.get('flight_dump', '-')}")
    if not hosts:
        lines.append("(no samples yet)")
    return "\n".join(lines)


def watch_loop(render: Callable[[], str], interval_s: float,
               count: Optional[int] = None, out=None,
               clear: bool = True,
               sleep: Callable[[float], None] = time.sleep) -> int:
    """The shared refresh loop behind ``top`` and ``telemetry
    --watch``: render a frame, clear the terminal (ANSI), repeat.
    ``count`` bounds the frames (tests; None = until interrupted).
    Returns frames rendered."""
    out = sys.stdout if out is None else out
    n = 0
    try:
        while True:
            text = render()
            if clear:
                out.write(ANSI_CLEAR)
            out.write(text if text.endswith("\n") else text + "\n")
            out.flush()
            n += 1
            if count is not None and n >= count:
                return n
            sleep(max(0.01, interval_s))
    except KeyboardInterrupt:
        return n


# -- Prometheus exposition parsing ------------------------------------------

# A sample line, with an optional OpenMetrics exemplar suffix
# (`value # {trace_id="..."} exemplar-value [timestamp]`) —
# the exemplar is captured (group 4) but optional, so pre-exemplar
# scrape bodies parse unchanged.
_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*?)\})?\s+(\S+)"
    r"(?:\s+#\s+\{(.*?)\}\s+(\S+)(?:\s+(\S+))?)?$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return re.sub(r"\\(.)",
                  lambda m: {"n": "\n"}.get(m.group(1), m.group(1)),
                  value)


def parse_prometheus(text: str
                     ) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse a Prometheus exposition body into ``(name, labels, value)``
    samples — the round-trip check behind the native-histogram
    exposition (tests) and the CI monitor smoke's "parseable /metrics"
    assertion.  OpenMetrics exemplar suffixes on ``_bucket`` lines
    are tolerated and dropped — use
    :func:`parse_prometheus_exemplars` to read them.  Raises
    ``ValueError`` on an unparseable sample line."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labels_s, value = m.groups()[:3]
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labels_s or "")}
        out.append((name, labels, float(value)))
    return out


def parse_prometheus_exemplars(
        text: str) -> List[Tuple[str, Dict[str, str], Dict]]:
    """The exemplars of an exposition body: every sample
    line carrying an OpenMetrics ``# {...} value [ts]`` suffix, as
    ``(metric name, labels, {"labels", "value", "t"})``."""
    out: List[Tuple[str, Dict[str, str], Dict]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None or m.group(4) is None:
            continue
        name, labels_s, _, ex_labels, ex_value, ex_t = m.groups()
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labels_s or "")}
        ex = {"labels": {k: _unescape(v)
                         for k, v in _LABEL_RE.findall(ex_labels or "")},
              "value": float(ex_value)}
        if ex_t is not None:
            ex["t"] = float(ex_t)
        out.append((name, labels, ex))
    return out


# -- per-request access records: read / filter / aggregate ---------------


def read_requests(src: str, tail: Optional[int] = None) -> List[Dict]:
    """Access records from a request-log spool: ``src`` is a directory
    (every ``requests-*.jsonl`` member, rotations included), a single
    ``.jsonl`` file, or a rotated member.  Records come back
    time-ordered; a torn line (a process SIGKILLed mid-write) HEALS
    (skipped) and COUNTS (``monitor.torn_lines``) — the spool-reader
    rule.  ``tail`` keeps only the newest N."""
    paths: List[str] = []
    if os.path.isdir(src):
        paths = sorted(glob.glob(os.path.join(src, "requests-*.jsonl*")))
        if not paths:
            paths = sorted(glob.glob(os.path.join(src, "*.jsonl*")))
    else:
        paths = [src]
    records: List[Dict] = []
    torn = 0
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        torn += 1
                        continue
                    if isinstance(doc, dict):
                        records.append(doc)
        except OSError:
            continue
    if torn:
        process_timeline().count("monitor.torn_lines", torn)
    records.sort(key=lambda r: r.get("t", 0.0))
    if tail is not None:
        records = records[-max(0, int(tail)):]
    return records


def filter_requests(records: Iterable[Dict], *,
                    slow_ms: Optional[float] = None,
                    status: Optional[str] = None,
                    client: Optional[str] = None,
                    role: Optional[str] = None,
                    since: Optional[float] = None,
                    until: Optional[float] = None) -> List[Dict]:
    """The ``requests`` command's filter: keep records at least
    ``slow_ms`` slow, matching a status (name like ``overloaded`` or
    HTTP code like ``503``), a client, a role (door/peer/serve), and/or
    inside a ``[since, until]`` epoch window (``--since/--until`` go
    through :func:`blit_torch.history.parse_when`)."""
    out = []
    for r in records:
        if slow_ms is not None and r.get("duration_s", 0.0) * 1e3 < slow_ms:
            continue
        if since is not None and float(r.get("t", 0.0)) < since:
            continue
        if until is not None and float(r.get("t", 0.0)) > until:
            continue
        if status is not None and not (
                str(r.get("status")) == status
                or str(r.get("code")) == status):
            continue
        if client is not None and r.get("client") != client:
            continue
        if role is not None and r.get("role") != role:
            continue
        out.append(r)
    return out


def aggregate_requests(records: Iterable[Dict],
                       slowest: int = 5) -> Dict:
    """One summary over a record set: counts by status/tier/role —
    and, for catalog-addressed asks (door records carry
    ``session``/``scan``), by ``session/scan`` — latency p50/p99/max
    (via the bounded histogram), total bytes, and the slowest records
    (each carrying its trace id — the page → record → trace pivot)."""
    records = list(records)
    by_status: Dict[str, int] = {}
    by_tier: Dict[str, int] = {}
    by_role: Dict[str, int] = {}
    by_scan: Dict[str, int] = {}
    lat = HistogramStats()
    total_bytes = 0
    hedges = hedge_wins = 0
    for r in records:
        by_status[str(r.get("status"))] = (
            by_status.get(str(r.get("status")), 0) + 1)
        if r.get("tier"):
            by_tier[str(r["tier"])] = by_tier.get(str(r["tier"]), 0) + 1
        by_role[str(r.get("role"))] = by_role.get(str(r.get("role")), 0) + 1
        if r.get("session"):
            key = (f"{r['session']}/{r['scan']}" if r.get("scan")
                   else str(r["session"]))
            by_scan[key] = by_scan.get(key, 0) + 1
        lat.observe(float(r.get("duration_s", 0.0)))
        total_bytes += int(r.get("bytes", 0) or 0)
        if r.get("hedged"):
            hedges += 1
            if r.get("hedge_won"):
                hedge_wins += 1
    slow = sorted(records, key=lambda r: r.get("duration_s", 0.0),
                  reverse=True)[:max(0, int(slowest))]
    return {
        "records": len(records),
        "by_status": by_status,
        "by_tier": by_tier,
        "by_role": by_role,
        "by_scan": by_scan,
        "p50_s": round(lat.percentile(0.50), 6),
        "p99_s": round(lat.percentile(0.99), 6),
        "max_s": round(lat.vmax, 6),
        "bytes": total_bytes,
        "hedged": hedges,
        "hedge_won": hedge_wins,
        "slowest": [
            {k: r.get(k) for k in ("t", "rid", "trace", "role", "client",
                                   "fp", "tier", "peer", "status",
                                   "session", "scan",
                                   "duration_s") if r.get(k) is not None}
            for r in slow
        ],
    }


def render_requests(records: Iterable[Dict]) -> str:
    """Access records as a readable table (the ``requests`` default)."""
    lines = [f"{'when':<8} {'role':<5} {'status':<10} {'tier':<9} "
             f"{'ms':>9} {'client':<10} {'peer':<8} trace"]
    for r in records:
        when = time.strftime("%H:%M:%S", time.gmtime(r.get("t", 0.0)))
        lines.append(
            f"{when:<8} {str(r.get('role', '-')):<5} "
            f"{str(r.get('status', '-')):<10} "
            f"{str(r.get('tier') or '-'):<9} "
            f"{r.get('duration_s', 0.0) * 1e3:>9.2f} "
            f"{str(r.get('client', '-')):<10} "
            f"{str(r.get('peer') or '-'):<8} {r.get('trace', '-')}")
    return "\n".join(lines)


# -- fleet trace gathering ----------------------------


def gather_trace_sources(sources: Iterable[str], *,
                         timeout: float = 10.0
                         ) -> Tuple[List[Dict], Dict[str, HistogramStats]]:
    """Span dicts + merged histograms from heterogeneous fleet sources
    — what ``trace-view --fleet`` stitches.  Each source is:

    - an ``http://...`` base URL → its ``/snapshot`` body (a peer/door
      :class:`~blit_torch.serve.http.PeerServer` or monitor endpoint);
    - a directory → every ``*.jsonl`` monitor-spool file in it (span
      batches per sample, newest cumulative timeline per process) plus
      every ``*.snapshot.json`` saved snapshot;
    - a ``.jsonl`` file → one spool file;
    - any other file → a saved snapshot / fleet report / flight dump
      (anything carrying ``spans`` and optionally a timeline).

    Returns ``(spans, hists)`` with hists merged across processes
    (exemplars keep the newest per bucket)."""
    spans: List[Dict] = []
    hists: Dict[str, HistogramStats] = {}

    def fold_hists(hist_states: Optional[Dict]) -> None:
        for name, st in (hist_states or {}).items():
            if not isinstance(st, dict):
                continue
            h = HistogramStats.from_state(st)
            if name in hists:
                hists[name].merge(h)
            else:
                hists[name] = h

    def fold_doc(doc: Dict) -> None:
        if not isinstance(doc, dict):
            return
        spans.extend(s for s in (doc.get("spans") or [])
                     if isinstance(s, dict))
        tl = doc.get("timeline")
        if isinstance(tl, dict):
            fold_hists(tl.get("hists"))
        fold_hists(doc.get("hists"))
        # A merge_fleet report: per-host raw hist_state blocks.
        for e in (doc.get("hosts") or {}).values():
            if isinstance(e, dict):
                fold_hists(e.get("hist_state"))

    def fold_spool_file(path: str) -> None:
        last_tl: Optional[Dict] = None
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        sample = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(sample, dict):
                        continue
                    spans.extend(s for s in (sample.get("spans") or [])
                                 if isinstance(s, dict))
                    if isinstance(sample.get("timeline"), dict):
                        last_tl = sample["timeline"]
        except OSError:
            return
        if last_tl:
            fold_hists(last_tl.get("hists"))

    for src in sources:
        if src.startswith("http://") or src.startswith("https://"):
            from blit_torch.serve.http import http_json

            try:
                status, _, body = http_json(
                    "GET", src.rstrip("/"), "/snapshot", timeout=timeout)
            except OSError as e:
                log.warning("trace source %s unreachable: %s", src, e)
                continue
            if status == 200 and isinstance(body, dict):
                fold_doc(body)
        elif os.path.isdir(src):
            for path in sorted(glob.glob(os.path.join(src, "*.jsonl"))):
                fold_spool_file(path)
            for path in sorted(glob.glob(
                    os.path.join(src, "*.snapshot.json"))):
                try:
                    with open(path) as f:
                        fold_doc(json.load(f))
                except (OSError, ValueError):
                    continue
        elif src.endswith(".jsonl"):
            fold_spool_file(src)
        else:
            try:
                with open(src) as f:
                    fold_doc(json.load(f))
            except (OSError, ValueError) as e:
                log.warning("trace source %s unreadable: %s", src, e)
    # Dedupe by span id (a /snapshot and a spool may overlap).
    seen, unique = set(), []
    for s in spans:
        sid = s.get("span")
        if sid and sid in seen:
            continue
        if sid:
            seen.add(sid)
        unique.append(s)
    return unique, hists


# -- bench-diff: the CI perf-regression gate --------------------------------

# Higher-is-better scalar metrics worth tracking across BENCH rounds.
_METRIC_KEY_RE = re.compile(
    r"(_gbps|_per_s|_speedup|^async_speedup$|_efficiency|^hit_rate$"
    r"|_hit_rate$|_attained$)",
)
# Lower-is-better scalars (request latency quantiles) — the noise band inverts for these.
_LOWER_METRIC_KEY_RE = re.compile(r"_p\d+_s$")


def metric_lower_is_better(key: str) -> bool:
    """Is ``key`` a lower-is-better metric (a latency quantile)?  Such
    metrics regress when the fresh value rises ABOVE the noise band."""
    return _LOWER_METRIC_KEY_RE.search(key) is not None


def load_bench_json(path: str) -> Dict:
    """Load a bench record: either a plain ``bench.py`` /
    ``ingest-bench`` JSON document, or a checked-in ``BENCH_*.json``
    wrapper (``{"n", "cmd", "rc", "tail"}`` — the recorded stdout tail,
    whose last JSON line is the bench record)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "tail" in doc and "cmd" in doc:
        if isinstance(doc.get("parsed"), dict):
            return doc["parsed"]
        for line in reversed(str(doc["tail"]).strip().splitlines()):
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                return json.loads(line)
            except ValueError:
                continue
        # A failed round (rc != 0, no record line) is part of history —
        # callers skip it, it must not poison the trajectory.
        raise ValueError(f"no JSON bench record in the tail of {path}")
    if not isinstance(doc, dict):
        raise ValueError(f"{path} is not a bench JSON document")
    return doc


def bench_metrics(doc: Dict) -> Dict[str, float]:
    """Extract the comparable higher-is-better scalars from a bench
    record: for ``ingest-bench`` documents the per-leg ingest rate /
    overlap efficiency and the async speedup; for ``bench.py`` records
    the headline ``value`` (keyed by its ``metric`` name) plus every
    top-level ``*_gbps`` / ``*_per_s`` / speedup / efficiency scalar;
    for serve-bench records (``serve-bench --archive-day``)
    the flat ``metrics`` dict — fleet hit rate, wire GB/s, and the
    request/serialize latency quantiles (``*_pNN_s``, which compare
    lower-is-better).  ``slo-report --json`` documents ride the
    same ``metrics`` branch (``slo.<name>_attained`` matches
    ``_attained$``), so ``bench-diff`` gates attainment like any
    other bench scalar."""
    out: Dict[str, float] = {}

    def num(v) -> Optional[float]:
        return (float(v) if isinstance(v, (int, float))
                and not isinstance(v, bool) else None)

    if isinstance(doc.get("metrics"), dict):
        for k, v in doc["metrics"].items():
            f = num(v)
            if f is None:
                continue
            if _METRIC_KEY_RE.search(k) or metric_lower_is_better(k):
                out[k] = f
        return out
    if "legs" in doc:
        for leg in doc.get("legs") or []:
            name = "async" if leg.get("async_output") else "sync"
            for k in ("ingest_gbps", "overlap_efficiency"):
                v = num(leg.get(k))
                if v is not None:
                    out[f"{name}.{k}"] = v
        v = num(doc.get("async_speedup"))
        if v is not None:
            out["async_speedup"] = v
        v = num((doc.get("dedoppler") or {}).get("drift_rates_per_s"))
        if v is not None:
            out["dedoppler.drift_rates_per_s"] = v
        # The live leg's latency tails (the --packets run is the
        # sustained-capture gate) — *_pNN_s keys compare
        # lower-is-better in bench_diff, like the serve quantiles.
        live = doc.get("live") or {}
        for k in ("chunk_to_product_p50_s", "chunk_to_product_p99_s"):
            v = num(live.get(k))
            if v is not None:
                out[f"live.{k}"] = v
        pk = live.get("packet") or {}
        for k in ("assembly_p50_s", "assembly_p99_s"):
            v = num(pk.get(k))
            if v is not None:
                out[f"packet.{k}"] = v
        return out
    metric = doc.get("metric")
    for k, v in doc.items():
        f = num(v)
        if f is None:
            continue
        if k == "value" and metric:
            out[str(metric)] = f
        elif _METRIC_KEY_RE.search(k):
            out[k] = f
    return out


def bench_rig(doc: Dict) -> Optional[str]:
    """The rig a bench record measured (its ``config.backend``; None
    when unrecorded — ingest-bench documents)."""
    return (doc.get("config") or {}).get("backend")


def bench_diff(fresh: Dict, baselines: List[Dict], *,
               rel_tol: float = 0.35,
               metrics: Optional[Iterable[str]] = None,
               cross_rig: bool = False) -> Dict:
    """Compare a fresh bench record against a baseline trajectory with
    noise bands: per metric, the band is ``[min·(1-rel_tol),
    max·(1+rel_tol)]`` over the trajectory — a fresh value below the
    band REGRESSES (throughput-style scalars are higher-is-better),
    above it IMPROVES, inside it is ok.  Latency quantiles
    (:func:`metric_lower_is_better`) invert: rising ABOVE the band
    regresses, dropping below it improves.  The verdict is
    ``"regress"`` iff any tracked metric regressed.  Metrics with no
    baseline datapoint are reported as ``"new"`` and never gate.

    Baselines recorded on a DIFFERENT rig than the fresh record
    (``config.backend`` — the checked-in trajectory mixes TPU and CPU
    rounds) are excluded unless ``cross_rig=True``: a CPU run regressing
    against a TPU number is noise, not signal."""
    fresh_m = bench_metrics(fresh)
    want = set(metrics) if metrics else None
    rig = bench_rig(fresh)
    skipped_rigs = 0
    kept = []
    for b in baselines:
        brig = bench_rig(b)
        if (not cross_rig and rig is not None and brig is not None
                and brig != rig):
            skipped_rigs += 1
            continue
        kept.append(b)
    baselines = kept
    traj: Dict[str, List[float]] = {}
    for b in baselines:
        for k, v in bench_metrics(b).items():
            traj.setdefault(k, []).append(v)
    rows: Dict[str, Dict] = {}
    regressed = []
    for k in sorted(fresh_m):
        if want is not None and k not in want:
            continue
        v = fresh_m[k]
        hist = traj.get(k)
        if not hist:
            rows[k] = {"fresh": v, "status": "new", "n": 0}
            continue
        lo, hi = min(hist), max(hist)
        band_lo = lo * (1.0 - rel_tol)
        band_hi = hi * (1.0 + rel_tol)
        if metric_lower_is_better(k):
            status = ("regress" if v > band_hi
                      else "improved" if v < band_lo else "ok")
        else:
            status = ("regress" if v < band_lo
                      else "improved" if v > band_hi else "ok")
        if status == "regress":
            regressed.append(k)
        rows[k] = {"fresh": v, "lo": lo, "hi": hi,
                   "band_lo": round(band_lo, 6),
                   "band_hi": round(band_hi, 6),
                   "status": status, "n": len(hist)}
    return {
        "verdict": "regress" if regressed else "pass",
        "rel_tol": rel_tol,
        "rig": rig,
        "baselines": len(baselines),
        "baselines_skipped_other_rig": skipped_rigs,
        "regressed": regressed,
        "metrics": rows,
    }


def render_bench_diff(verdict: Dict) -> str:
    """``bench-diff``'s human table."""
    lines = [f"bench-diff: {verdict['verdict'].upper()} "
             f"({verdict['baselines']} baseline(s), "
             f"noise ±{verdict['rel_tol'] * 100:.0f}%)"]
    lines.append(f"{'metric':<44} {'fresh':>12} {'band_lo':>12} "
                 f"{'band_hi':>12} status")
    for k, row in verdict["metrics"].items():
        def band(key):
            v = row.get(key)
            return f"{v:>12.4g}" if v is not None else f"{'-':>12}"

        lines.append(
            f"{k:<44} {row['fresh']:>12.4g} {band('band_lo')} "
            f"{band('band_hi')} {row['status']}")
    return "\n".join(lines)
