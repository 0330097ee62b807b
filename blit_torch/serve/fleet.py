"""Failure-domain-tolerant fleet front door.

ROADMAP item 3's missing half: `blit/serve` coalesces, caches and
admission-controls — in ONE process.  This module puts a front door in
front of N cache/compute peers (:class:`blit_torch.serve.http.PeerServer`
processes) and makes the resulting service survive its hosts:

- **Consistent-hash routing** (:class:`~blit_torch.serve.ring.HashRing`):
  every request's content-addressed fingerprint maps to an OWNER
  peer plus ``replicas - 1`` successors.  Fingerprints are
  order-insensitive over the raw members, so two doors (or one across
  restarts) agree on ownership with no coordination and cross-host
  dedupe is structural — identical requests, however their globs
  ordered the members, always land on the same owner's cache, where
  the peer's own single-flight machinery coalesces them.
- **Failure-domain tolerance**: peer liveness is judged by heartbeat
  leases (:class:`blit_torch.recover.LeaseWatch` — the scan supervisor's
  staleness discipline applied to serving peers); a silent peer is
  EJECTED from the ring within the lease TTL and its key range
  re-routes to the replicas, rejoining when beats resume.  Per-peer
  :class:`~blit_torch.faults.CircuitBreaker`\\ s fail fast on a flapping peer
  between lease verdicts, and hot entries are CACHE-WARMED onto
  replicas (``hot_hits`` threshold + drain-time hints), so losing the
  owner degrades hit-rate, not correctness.
- **Hedged reads**: when the owner has not answered within its own
  LIVE p99 (per-peer :class:`~blit_torch.observability.HistogramStats`, the
  telemetry discipline — never a guessed constant once history exists), the
  request is duplicated to the next replica and the first answer wins.
  At most ONE hedge per request bounds duplicate compute at 2x on the
  hedged slice; ``fleet.hedge`` / ``fleet.hedge.win`` /
  ``fleet.hedge.dup_done`` ride ``/metrics``.
- **Deadline propagation**: the caller's ``deadline_s`` is checked at
  the door before EVERY dispatch (an already-dead request never
  reaches a peer — the acceptance pin) and travels on the wire into
  the peer :class:`~blit_torch.serve.scheduler.Scheduler`'s deadline-aware
  admission and dispatch-time expiry, so no layer computes work whose
  requester has already given up.
- **Graceful drain**: :meth:`FleetFrontDoor.drain` refuses new
  requests, lets in-flight ones finish, and hands the hottest
  fingerprints' recipes to their owner/replica peers as ``/warm``
  hints, so a door restart does not cold-start the fleet's working
  set.

The door is deliberately CACHE-LESS and QUEUE-LESS: peers own the
two-tier caches and the admission-controlled schedulers; the door owns
placement, liveness and retries.  That keeps its failure mode boring —
a restarted door re-derives the whole routing state from config plus
the lease dir in one poll interval.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from blit_torch import faults, observability
from blit_torch.config import DEFAULT, SiteConfig, fleet_defaults
from blit_torch.faults import CircuitBreaker
from blit_torch.observability import (
    HistogramStats,
    StallWatchdog,
    Timeline,
    flight_recorder,
    hostname,
    merge_fleet,
    render_prometheus,
)
from blit_torch.serve.http import (
    TIER_HEADER,
    WIRE_CTYPE,
    ConnectionPool,
    decode_product,
    decode_product_wire,
    http_json,
    http_request,
    retry_after_from,
    trace_headers,
    wire_request,
)
from blit_torch.serve.ring import HashRing
from blit_torch.serve.scheduler import DeadlineExpired, Overloaded

log = logging.getLogger("blit_torch.serve.fleet")

# The fleet plane's latency histograms (the MESH_HISTS convention).
# serialize_s lands on the PEER's timeline (it encodes), the rest on
# the door's; wire_bytes is a histogram so .total carries the exact
# byte sum the bench's GB/s needs.  catalog.lookup_s times the door's
# archive-catalog resolutions and document asks — the
# archive-day bench's catalog-lookup p50/p99 source.
FLEET_HISTS = ("fleet.request_s", "fleet.peer_s", "fleet.detect_s",
               "fleet.serialize_s", "fleet.deserialize_s",
               "fleet.wire_bytes", "catalog.lookup_s")


class FleetError(RuntimeError):
    """Every routable replica failed (or none exist) for a request."""


class PeerHTTPError(OSError):
    """A peer answered outside the serve contract (HTTP 5xx that is not
    an Overloaded/deadline mapping) — an ``OSError`` so breakers and
    transient-retry classification treat it like a failing host."""


class _HttpWatch:
    """Liveness fallback when no lease dir is shared with the peers:
    the :class:`~blit_torch.observability.StallWatchdog` beaten by successful
    ``/healthz`` fetches — same staleness contract, HTTP as the beat
    transport."""

    def __init__(self, name: str, ttl_s: float):
        self.wd = StallWatchdog(ttl_s, f"blit-fleet-{name}",
                                what="a dead peer stops answering "
                                     "/healthz")
        self.seen = False

    def observe(self) -> None:  # the LeaseWatch poll surface
        pass

    def note_health(self, ok: bool) -> None:
        if ok:
            self.wd.beat()
            self.seen = True

    def stalled(self) -> bool:
        return self.seen and self.wd.stalled()

    def fresh(self) -> bool:
        """Beating and not stale (the LeaseWatch surface)."""
        return self.seen and not self.wd.stalled()

    def age_s(self) -> float:
        return self.wd.age_s()


class _Peer:
    """One peer's routing state: breaker, live latency histogram,
    lease/HTTP liveness watch, last fetched health document.

    ``standby`` marks an elastic-capacity peer: process up,
    lease beating, deliberately NOT in the ring until the controller
    admits it.  ``retired`` marks a peer scaled in on purpose — neither
    is a casualty, so the liveness loop must not auto-rejoin them and
    the health document must not count them degraded."""

    def __init__(self, name: str, url: str, watch, *,
                 breaker_threshold: int, breaker_cooldown_s: float):
        self.name = name
        self.url = url
        self.watch = watch
        self.breaker = CircuitBreaker(threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s)
        self.hist = HistogramStats()
        self.in_ring = True
        self.standby = False
        self.retired = False
        self.last_health: Optional[Dict] = None
        self.requests = 0
        self.failures = 0

    def snapshot(self) -> Dict:
        return {
            "url": self.url,
            "in_ring": self.in_ring,
            "standby": self.standby,
            "retired": self.retired,
            "breaker": self.breaker.snapshot()["state"],
            "requests": self.requests,
            "failures": self.failures,
            "p50_s": round(self.hist.percentile(0.50), 6),
            "p99_s": round(self.hist.percentile(0.99), 6),
            "n": self.hist.n,
            "lease_age_s": round(self.watch.age_s(), 3),
        }


class FleetFrontDoor:
    """The fleet's routing/liveness brain (module docstring).  Drive it
    directly (``get()``) or serve it over HTTP with
    :class:`blit_torch.serve.http.FrontDoorServer`.

    ``peers`` maps peer name → base URL.  ``lease_dir`` (shared with
    the peers) switches liveness to heartbeat-lease files; without it,
    successful ``/healthz`` fetches are the beat.  ``proc_of`` maps
    peer name → its lease proc index (default: enumeration order).
    ``start()`` runs the liveness loop; ``close()`` stops it."""

    def __init__(self, peers: Dict[str, str], *,
                 lease_dir: Optional[str] = None,
                 proc_of: Optional[Dict[str, int]] = None,
                 config: SiteConfig = DEFAULT,
                 timeline: Optional[Timeline] = None,
                 replicas: Optional[int] = None,
                 peer_ttl_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 health_poll_s: Optional[float] = None,
                 hedge_floor_s: Optional[float] = None,
                 hedge_min_n: Optional[int] = None,
                 hot_hits: Optional[int] = None,
                 request_timeout_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic,
                 catalog=None):
        d = fleet_defaults(config)
        self.replicas = int(replicas if replicas is not None
                            else d["replicas"])
        self.peer_ttl_s = float(peer_ttl_s if peer_ttl_s is not None
                                else d["peer_ttl_s"])
        self.poll_s = float(poll_s if poll_s is not None else d["poll_s"])
        self.health_poll_s = float(
            health_poll_s if health_poll_s is not None
            else d["health_poll_s"])
        self.hedge_floor_s = float(
            hedge_floor_s if hedge_floor_s is not None
            else d["hedge_floor_s"])
        self.hedge_min_n = int(hedge_min_n if hedge_min_n is not None
                               else d["hedge_min_n"])
        self.hot_hits = int(hot_hits if hot_hits is not None
                            else d["hot_hits"])
        # Hot-path data plane: which product wire to ask
        # peers for ("binary" | "json" — SiteConfig.fleet_wire /
        # BLIT_FLEET_WIRE), whether to advertise deflate, and the
        # bounded per-peer keep-alive pool every hop rides.
        self.wire = str(d["wire"])
        self._wire_deflate = bool(d["wire_deflate"])
        self.request_timeout_s = float(request_timeout_s)
        self.clock = clock
        self.timeline = timeline if timeline is not None else Timeline()
        self.pool = ConnectionPool(max_per_peer=d["pool_conns"],
                                   timeline=self.timeline)
        self.lease_dir = lease_dir
        self.ring = HashRing(peers, vnodes=d["vnodes"],
                             replicas=self.replicas)
        self._breaker_threshold = config.breaker_threshold
        self._breaker_cooldown_s = config.breaker_cooldown_s
        self._peers: Dict[str, _Peer] = {}
        for i, (name, url) in enumerate(peers.items()):
            proc = (proc_of or {}).get(name, i)
            self._peers[name] = _Peer(
                name, url, self._make_watch(name, proc),
                breaker_threshold=self._breaker_threshold,
                breaker_cooldown_s=self._breaker_cooldown_s)
        # Elastic resize state: set by the FleetController
        # around a membership flip; health() answers "resizing" while
        # it is non-None.
        self.resize_reason: Optional[str] = None
        self._lock = threading.Lock()
        self._drain_cond = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        # Hotness: fp -> (hits, recipe), LRU-bounded — the cache-warm
        # replication trigger and the drain-hint source.
        self._hot: "OrderedDict[str, Tuple[int, Dict]]" = OrderedDict()
        self._hot_max = 4096
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_health_fetch = 0.0
        # Per-request access records: the door
        # writes exactly one line per request — served, refused at the
        # drain latch, deadline-expired or failed — with the routing
        # outcome a peer-side record cannot know (routed peer, hedge
        # verdict).  None (one attribute test per request) unless
        # BLIT_REQUEST_LOG / SiteConfig.request_log_dir is set.
        # (request_log_for also applies the config's exemplars knob.)
        self.request_log = observability.request_log_for("door", config)
        # Door-side archive catalog: resolves
        # by-(session, scan) logical asks into the explicit member-path
        # recipe BEFORE ring routing — so a logical ask fingerprints
        # (and routes, dedupes, coalesces) identically to its explicit
        # twin.  Built when BLIT_CATALOG_ROOT / SiteConfig.catalog_root
        # names a tree, or passed in ready-made.
        self.catalog = catalog
        if self.catalog is None:
            from blit_torch.config import catalog_defaults

            if catalog_defaults(config)["enabled"]:
                from blit_torch.serve.catalog import CatalogIndex

                self.catalog = CatalogIndex(config=config,
                                            timeline=self.timeline)

    def _make_watch(self, name: str, proc: int):
        if self.lease_dir is not None:
            from blit_torch.recover import LeaseWatch

            return LeaseWatch(self.lease_dir, proc, self.peer_ttl_s,
                              grace_s=self.peer_ttl_s)
        return _HttpWatch(name, self.peer_ttl_s)

    # -- liveness ----------------------------------------------------------
    def start(self) -> "FleetFrontDoor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._watch_loop, name="blit-fleet-watch",
                daemon=True)
            self._thread.start()
        return self

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.observe()
            except Exception:  # noqa: BLE001 — liveness must not die
                log.warning("fleet watch tick failed", exc_info=True)

    def observe(self) -> None:
        """One liveness tick (the watch loop's body; tests drive it
        directly): observe every lease, eject stale peers, rejoin
        recovered ones, refresh health documents on their own
        cadence."""
        fetch_health = False
        now = time.monotonic()
        if now - self._last_health_fetch >= self.health_poll_s:
            self._last_health_fetch = now
            fetch_health = True
        for p in self._peers.values():
            p.watch.observe()
            if fetch_health:
                self._fetch_health(p)
            if p.in_ring and p.watch.stalled():
                self._eject(p, f"lease stale {p.watch.age_s():.2f}s")
            elif (not p.in_ring and not p.standby and not p.retired
                  and p.watch.seen and not p.watch.stalled()):
                # Standby and retired peers are out of the ring ON
                # PURPOSE — only the elastic controller
                # admits them; a fresh lease alone must not.
                self._rejoin(p)

    def _fetch_health(self, p: _Peer) -> None:
        try:
            status, _, body = http_json("GET", p.url, "/healthz",
                                        timeout=2.0, pool=self.pool)
            ok = status == 200 and isinstance(body, dict)
            p.last_health = body if ok else None
        except OSError:
            ok = False
            p.last_health = None
        if isinstance(p.watch, _HttpWatch):
            p.watch.note_health(ok)

    def _eject(self, p: _Peer, reason: str) -> None:
        """Remove a failed peer from the ring: its key range re-routes
        to the replica successors ON THE NEXT LOOKUP (consistent
        hashing makes re-routing a no-op for everyone else)."""
        if not self.ring.remove(p.name):
            return
        p.in_ring = False
        # Sever the idle keep-alives to the departed peer: a pooled socket to a dead host would eat one
        # failed write per request until the LIFO stack drained.
        self.pool.evict_peer(p.url)
        self.timeline.count("fleet.eject")
        # Detection latency (the chaos drill's budget assertion): how
        # stale the lease was when we acted — age at detection, the
        # recover-plane convention.
        self.timeline.observe("fleet.detect_s", p.watch.age_s())
        flight_recorder().event("fleet", "eject", peer=p.name,
                                reason=reason)
        log.warning("fleet: ejected peer %s (%s); %d peer(s) remain",
                    p.name, reason, len(self.ring))

    def _rejoin(self, p: _Peer) -> None:
        if not self.ring.add(p.name):
            return
        p.in_ring = True
        p.breaker.record_success()  # fresh start: the lease vouches
        self.timeline.count("fleet.rejoin")
        flight_recorder().event("fleet", "rejoin", peer=p.name)
        log.warning("fleet: peer %s rejoined the ring", p.name)

    # -- elastic membership -------------------------------------
    def add_standby(self, name: str, url: str, *,
                    proc: Optional[int] = None) -> _Peer:
        """Pre-register an elastic standby: lease-watched like any peer
        (its beats are observed, its health fetched) but NOT in the
        ring — no request routes to it until :meth:`admit_peer`.
        ``proc`` is its lease proc index (default: registration
        order)."""
        with self._lock:
            idx = proc if proc is not None else len(self._peers)
            p = _Peer(name, url.rstrip("/"), self._make_watch(name, idx),
                      breaker_threshold=self._breaker_threshold,
                      breaker_cooldown_s=self._breaker_cooldown_s)
            p.in_ring = False
            p.standby = True
            self._peers[name] = p
        self.timeline.count("fleet.standby")
        flight_recorder().event("fleet", "standby", peer=name)
        return p

    def admit_peer(self, name: str) -> bool:
        """Flip a standby (or retired) peer INTO the ring — the elastic
        scale-out membership flip, called by the FleetController only
        after the warm handoff acked or its deadline burned."""
        p = self._peers[name]
        p.standby = False
        p.retired = False
        if not self.ring.add(name):
            return False
        p.in_ring = True
        p.breaker.record_success()  # fresh start: the controller vouches
        self.timeline.count("fleet.admit")
        flight_recorder().event("fleet", "admit", peer=name)
        log.warning("fleet: peer %s admitted to the ring (scale-out); "
                    "%d peer(s)", name, len(self.ring))
        return True

    def retire_peer(self, name: str) -> bool:
        """Remove a drained peer from the ring ON PURPOSE — the elastic
        scale-in flip.  Unlike ejection this is not a casualty: the
        peer is marked ``retired`` so a still-beating lease cannot
        auto-rejoin it, and its pooled keep-alives are severed so no
        later request is written to a departed peer's dead socket."""
        p = self._peers[name]
        p.retired = True
        p.standby = False
        removed = self.ring.remove(name)
        p.in_ring = False
        self.pool.evict_peer(p.url)
        if removed:
            self.timeline.count("fleet.retire")
            flight_recorder().event("fleet", "retire", peer=name)
            log.warning("fleet: peer %s retired from the ring "
                        "(scale-in); %d peer(s) remain", name,
                        len(self.ring))
        return removed

    # -- routing -----------------------------------------------------------
    def _remaining(self, t0: float,
                   deadline_s: Optional[float]) -> Optional[float]:
        if deadline_s is None:
            return None
        return float(deadline_s) - (self.clock() - t0)

    def _fetch_timeout(self, t0: float,
                       deadline_s: Optional[float]) -> float:
        rem = self._remaining(t0, deadline_s)
        if rem is None:
            return self.request_timeout_s
        return max(0.05, min(self.request_timeout_s, rem))

    def _hedge_delay(self, p: _Peer) -> float:
        """When to try a second replica: the peer's LIVE p99 once
        enough history exists (the telemetry-hist discipline),
        else the configured floor — never a guess dressed as a
        measurement."""
        if p.hist.n >= self.hedge_min_n:
            return max(self.hedge_floor_s, p.hist.percentile(0.99))
        return self.hedge_floor_s

    def get(self, request, *, priority: int = 1, client: str = "anon",
            deadline_s: Optional[float] = None
            ) -> Tuple[Dict, np.ndarray]:
        """Serve one product request through the fleet: route to the
        fingerprint's owner, hedge to a replica past the live p99, fail
        over on refusal/death, propagate the deadline every hop.
        Raises :class:`~blit_torch.serve.scheduler.Overloaded` /
        :class:`~blit_torch.serve.scheduler.DeadlineExpired` /
        :class:`FleetError` (every replica failed).

        The whole request runs inside a ``fleet.request`` span: peer dispatches become child spans carried across
        the wire, the hedge verdict lands on this span's attrs, and one
        access record is written per call whatever the outcome."""
        t0 = self.clock()
        t_req = time.perf_counter()
        rid = observability.new_id()
        tr = observability.tracer()
        status, code, fp, nbytes = "error", 500, None, 0
        trace_id: Optional[str] = None
        outcome: Dict = {}
        # The LOGICAL address: captured before resolution
        # rewrites the request, so access records group archive traffic
        # by (session, scan) even though the wire carries member paths.
        sess = getattr(request, "session", None)
        scan = getattr(request, "scan", None)
        is_catalog = getattr(request, "kind", None) == "catalog"
        try:
            with tr.span("fleet.request", client=client) as sp:
                if sp is not None:
                    trace_id = sp.trace_id
                with self._lock:
                    if self._draining:
                        self.timeline.count("fleet.rejected")
                        raise Overloaded(
                            "front door is draining; retry against "
                            "the replacement", retry_after_s=1.0)
                    self._inflight += 1
                try:
                    if sess is not None:
                        request = self._resolve(request)
                    wire = wire_request(request, priority=priority,
                                        client=client,
                                        deadline_s=deadline_s)
                    if is_catalog:
                        from blit_torch.serve.catalog import catalog_fingerprint

                        fp = catalog_fingerprint(
                            (request.raw or "").strip("/"))
                    else:
                        fp = request.fingerprint()
                    self.timeline.count("fleet.requests")
                    header, data = self._fetch(fp, wire, t0, deadline_s,
                                               rid=rid, outcome=outcome)
                    # Observed INSIDE the request span: the tail
                    # bucket's exemplar is this request's trace id
                    #.
                    self.timeline.observe("fleet.request_s",
                                          time.perf_counter() - t_req)
                    if is_catalog:
                        # A catalog ask's whole round-trip IS the
                        # lookup — the archive-day bench's p50/p99.
                        self.timeline.observe(
                            "catalog.lookup_s",
                            time.perf_counter() - t_req)
                    nbytes = data.nbytes
                    status, code = "ok", 200
                    if sp is not None:
                        sp.attrs = dict(
                            sp.attrs or {}, fp=fp[:16],
                            **{k: v for k, v in outcome.items()
                               if v is not None})
                    if not is_catalog:
                        # Catalog documents are query-addressed and
                        # regenerate on every ask — never warm-hinted.
                        self._note_hot(fp, wire["recipe"])
                    return header, data
                finally:
                    with self._drain_cond:
                        self._inflight -= 1
                        self._drain_cond.notify_all()
        except BaseException as e:
            from blit_torch.serve.scheduler import classify_failure

            status, code = classify_failure(e)
            raise
        finally:
            if self.request_log is not None:
                dt = time.perf_counter() - t_req
                self.request_log.record(
                    rid=rid, trace=trace_id,
                    role="door", client=client, priority=priority,
                    fp=(fp[:16] if fp else None),
                    session=sess, scan=scan,
                    tier=outcome.get("tier"),
                    peer=outcome.get("peer"),
                    hedged=outcome.get("hedged"),
                    hedge_won=outcome.get("hedge_won"),
                    deadline_s=deadline_s,
                    deadline_left_s=(round(deadline_s - dt, 6)
                                     if deadline_s is not None else None),
                    status=status, code=code, bytes=nbytes,
                    duration_s=round(dt, 6))

    def _resolve(self, request):
        """Resolve a by-(session, scan) logical ask into its explicit
        member-path twin AT THE DOOR — before
        ring routing, so both spellings of one logical product share a
        fingerprint, an owner and a single-flight group.  Misses raise
        :class:`~blit_torch.serve.catalog.CatalogMiss` (the 404-class
        outcome); the lookup's latency feeds ``catalog.lookup_s``."""
        if self.catalog is None:
            raise FleetError(
                "session=/scan= addressing needs a door catalog "
                "(BLIT_CATALOG_ROOT / SiteConfig.catalog_root)")
        import dataclasses

        t = time.perf_counter()
        try:
            members = self.catalog.resolve(
                request.session, request.scan,
                band=request.band, bank=request.bank)
        finally:
            self.timeline.observe("catalog.lookup_s",
                                  time.perf_counter() - t)
        self.timeline.count("fleet.resolved")
        return dataclasses.replace(
            request, raw=tuple(members),
            session=None, scan=None, band=None, bank=None)

    def targets_for(self, fp: str) -> List[_Peer]:
        return [self._peers[n] for n in self.ring.owners(fp)]

    def _fetch(self, fp: str, wire: Dict, t0: float,
               deadline_s: Optional[float], rid: Optional[str] = None,
               outcome: Optional[Dict] = None
               ) -> Tuple[Dict, np.ndarray]:
        targets = self.targets_for(fp)
        if not targets:
            raise FleetError("no live peers in the ring")
        # The caller's ambient context (the fleet.request span): every
        # dispatch thread reactivates it so its fleet.dispatch span — and
        # the peer-side spans parented onto it across the wire — belong
        # to THIS request's trace.
        ctx = observability.tracer().context()
        q: "queue.Queue" = queue.Queue()
        done = threading.Event()

        def run(p: _Peer, hedge: bool) -> None:
            try:
                res = self._fetch_one(p, wire, fp, t0, deadline_s,
                                      ctx=ctx, hedge=hedge, rid=rid)
                ok = True
            except BaseException as e:  # noqa: BLE001 — delivered below
                res, ok = e, False
            if ok and done.is_set():
                # The duplicate finished after the winner: its work ran
                # to completion (and warmed that peer's cache) — counted
                # so the bench can bound duplicate compute on the
                # hedged slice.
                self.timeline.count("fleet.hedge.dup_done")
            q.put((p, hedge, ok, res))

        idx = 0
        pending = 0

        def launch(hedge: bool) -> Optional[_Peer]:
            nonlocal idx, pending
            while idx < len(targets):
                p = targets[idx]
                idx += 1
                rem = self._remaining(t0, deadline_s)
                if rem is not None and rem <= 0:
                    return None  # the waiter raises DeadlineExpired
                if not p.breaker.allow():
                    self.timeline.count("fleet.skip_breaker")
                    continue
                if hedge:
                    self.timeline.count("fleet.hedge")
                pending += 1
                threading.Thread(target=run, args=(p, hedge),
                                 name=f"blit-fleet-{p.name}",
                                 daemon=True).start()
                return p
            return None

        rem = self._remaining(t0, deadline_s)
        if rem is not None and rem <= 0:
            # The acceptance pin: a request already dead at the front
            # door is REJECTED here — no peer is ever dispatched.
            self.timeline.count("fleet.deadline_expired")
            raise DeadlineExpired(
                f"deadline {deadline_s:.3f}s expired at the front door "
                f"after {self.clock() - t0:.3f}s; never dispatched")
        first = launch(hedge=False)
        if first is None:
            rem = self._remaining(t0, deadline_s)
            if rem is not None and rem <= 0:
                self.timeline.count("fleet.deadline_expired")
                raise DeadlineExpired(
                    f"deadline {deadline_s:.3f}s expired at the front "
                    "door; never dispatched")
            raise FleetError(
                f"no routable peer for {fp[:16]}… "
                f"({len(targets)} in ring, all breaker-blocked)")
        hedged = False
        last_exc: Optional[BaseException] = None
        hedge_delay = self._hedge_delay(first)
        while True:
            rem = self._remaining(t0, deadline_s)
            if not hedged and idx < len(targets):
                wait = (hedge_delay if rem is None
                        else min(hedge_delay, max(0.0, rem)))
            else:
                wait = (self.request_timeout_s if rem is None
                        else max(0.0, rem)) + 1.0
            try:
                p, was_hedge, ok, res = q.get(timeout=max(0.005, wait))
            except queue.Empty:
                if not hedged and idx < len(targets):
                    hedged = True
                    launch(hedge=True)  # first-wins from here on
                    continue
                if rem is not None and rem <= 0:
                    self.timeline.count("fleet.deadline_expired")
                    raise DeadlineExpired(
                        f"deadline {deadline_s:.3f}s expired waiting on "
                        "replicas") from last_exc
                raise FleetError(
                    f"no replica answered {fp[:16]}… within "
                    f"{self.request_timeout_s}s") from last_exc
            pending -= 1
            if ok:
                done.set()
                if was_hedge:
                    self.timeline.count("fleet.hedge.win")
                header, data, tier = res
                if outcome is not None:
                    # The routing verdict for the parent span + access
                    # record: who answered, from which tier, and
                    # whether the hedge won.
                    outcome.update(peer=p.name, tier=tier,
                                   hedged=1 if hedged else None,
                                   hedge_won=(1 if was_hedge else 0)
                                   if hedged else None)
                return header, data
            last_exc = res
            rem = self._remaining(t0, deadline_s)
            if isinstance(res, DeadlineExpired) and (rem is None
                                                    or rem > 0):
                # The PEER judged the deadline unmeetable — an
                # admission ESTIMATE over its own backlog, not a global
                # verdict: a replica holding the cache-warmed product
                # answers in milliseconds regardless of queue depth.
                # Only the door's own burned budget is terminal.
                res = Overloaded(str(res), retry_after_s=0.1)
                last_exc = res
            if isinstance(res, DeadlineExpired):
                raise res  # the budget itself is gone
            if type(res).__name__ == "CatalogMiss":
                raise res  # the ASK is wrong — no replica can fix that
            if isinstance(res, Overloaded):
                # Alive but refusing — the breaker stays untouched;
                # another replica may have capacity (or the cache).
                self.timeline.count("fleet.failover")
            else:
                if self._record_peer_failure(p):
                    log.warning("fleet: breaker tripped for peer %s "
                                "(%s)", p.name, res)
                self.timeline.count("fleet.failover")
            nxt = launch(hedge=False)
            if nxt is None and pending == 0:
                if rem is not None and rem <= 0:
                    # Out of replicas BECAUSE the budget burned during
                    # failover: that is a deadline verdict (504, final),
                    # not a fleet failure (500/503, retryable).
                    self.timeline.count("fleet.deadline_expired")
                    raise DeadlineExpired(
                        f"deadline {deadline_s:.3f}s expired during "
                        "failover") from last_exc
                if isinstance(last_exc, Overloaded):
                    raise last_exc
                raise FleetError(
                    f"every replica failed for {fp[:16]}…: "
                    f"{last_exc}") from last_exc

    def _record_peer_failure(self, p: _Peer) -> bool:
        p.failures += 1
        tripped = p.breaker.record_failure()
        if tripped:
            self.timeline.count("fleet.breaker_trip")
            flight_recorder().event("fleet", "breaker_trip", peer=p.name)
        return tripped

    def _fetch_one(self, p: _Peer, wire: Dict, fp: str, t0: float,
                   deadline_s: Optional[float], ctx: Optional[Dict] = None,
                   hedge: bool = False, rid: Optional[str] = None
                   ) -> Tuple[Dict, np.ndarray, Optional[str]]:
        """One peer round-trip → ``(header, data, tier)`` with the
        remaining deadline propagated ON THE WIRE (the peer's scheduler
        re-checks it at admission and dispatch), the live latency
        histogram fed either way, and the trace context carried as
        headers: the dispatch runs in its own
        ``fleet.dispatch`` span — hedges are sibling spans tagged
        ``hedge=1`` — whose context the peer reactivates, so peer-side
        spans parent onto this request across the process boundary."""
        tr = observability.tracer()
        with tr.activate(ctx), \
                tr.span("fleet.dispatch", peer=p.name,
                        hedge=1 if hedge else 0):
            faults.fire("fleet.route", key=p.name)
            doc = dict(wire)
            rem = self._remaining(t0, deadline_s)
            if rem is not None:
                doc["deadline_s"] = max(0.0, rem)
            p.requests += 1
            self.timeline.count("fleet.route")
            req_hdrs = trace_headers(hedge=hedge, rid=rid)
            req_hdrs["Content-Type"] = "application/json"
            if self.wire == "binary":
                # Negotiate the binary product wire: a peer
                # that can't speak it answers legacy JSON — decoded
                # below either way, bit-identically.
                req_hdrs["Accept"] = (
                    f"{WIRE_CTYPE}, application/json")
                if self._wire_deflate:
                    req_hdrs["Accept-Encoding"] = "deflate"
            t = time.perf_counter()
            try:
                status, hdrs, payload = http_request(
                    "POST", p.url, "/product",
                    body=json.dumps(doc).encode(),
                    timeout=self._fetch_timeout(t0, deadline_s),
                    headers=req_hdrs, pool=self.pool)
            finally:
                dt = time.perf_counter() - t
                p.hist.observe(dt)
                self.timeline.observe("fleet.peer_s", dt)
            if status == 200:
                p.breaker.record_success()
                self.timeline.observe("fleet.wire_bytes", len(payload))
                ctype = (hdrs.get("content-type") or "").lower()
                t_dec = time.perf_counter()
                if ctype.startswith(WIRE_CTYPE):
                    header, data = decode_product_wire(
                        payload, encoding=hdrs.get("content-encoding"))
                    self.timeline.count("fleet.wire.binary")
                else:
                    header, data = decode_product(json.loads(payload))
                    self.timeline.count("fleet.wire.json")
                self.timeline.observe("fleet.deserialize_s",
                                      time.perf_counter() - t_dec)
                return header, data, hdrs.get(TIER_HEADER.lower())
            try:
                body = json.loads(payload)
            except ValueError:
                body = payload.decode("utf-8", "replace")
            msg = (body.get("error") if isinstance(body, dict)
                   else str(body)[:200])
            if status == 503:
                raise Overloaded(
                    f"peer {p.name}: {msg}",
                    retry_after_s=retry_after_from(hdrs, body))
            if status == 504:
                raise DeadlineExpired(f"peer {p.name}: {msg}")
            if status == 404:
                # A catalog miss: the CALLER named a
                # session/scan the archive does not hold — terminal and
                # breaker-neutral, never a host failure.
                from blit_torch.serve.catalog import CatalogMiss

                p.breaker.record_success()
                raise CatalogMiss(f"peer {p.name}: {msg}")
            raise PeerHTTPError(
                f"peer {p.name} answered HTTP {status}: {msg}")

    # -- cache-warm replication --------------------------------------------
    def _note_hot(self, fp: str, recipe: Dict) -> None:
        with self._lock:
            hits, _ = self._hot.get(fp, (0, None))
            hits += 1
            self._hot[fp] = (hits, recipe)
            self._hot.move_to_end(fp)
            while len(self._hot) > self._hot_max:
                self._hot.popitem(last=False)
        if hits != self.hot_hits:
            return
        # Crossing the hotness threshold: warm the REPLICAS now, so
        # losing the owner later degrades hit-rate, not correctness —
        # and the degradation recovers from a warm disk tier, not a
        # recompute storm.
        replicas = self.ring.owners(fp)[1:]
        if replicas:
            self.timeline.count("fleet.warm")
            threading.Thread(
                target=self._send_warm,
                args=([self._peers[n] for n in replicas], [recipe],
                      observability.tracer().context()),
                name="blit-fleet-warm", daemon=True).start()

    def warm_hints(self, in_range=None, limit: int = 32
                   ) -> List[Tuple[str, Dict]]:
        """The hottest ``(fp, recipe)`` pairs the door knows, hottest
        first, restricted to the fingerprints ``in_range`` accepts (a
        predicate; None = all) — the drain-time hint source,
        range-scoped for elastic warm handoff so a joiner is
        streamed exactly its incoming key range."""
        with self._lock:
            items = sorted(self._hot.items(), key=lambda kv: kv[1][0],
                           reverse=True)
        out: List[Tuple[str, Dict]] = []
        for fp, (_, recipe) in items:
            if recipe is None:
                continue
            if in_range is not None and not in_range(fp):
                continue
            out.append((fp, recipe))
            if len(out) >= max(0, int(limit)):
                break
        return out

    def _send_warm(self, peers: List[_Peer], recipes: List[Dict],
                   ctx: Optional[Dict] = None) -> None:
        # Warm hints carry the hot request's trace: the
        # replication work a request triggers stays attributable to it.
        tr = observability.tracer()
        with tr.activate(ctx), tr.span("fleet.warm", peers=len(peers)):
            hdrs = trace_headers()
            for p in peers:
                try:
                    http_json("POST", p.url, "/warm",
                              {"recipes": recipes}, timeout=5.0,
                              headers=hdrs, pool=self.pool)
                except OSError:
                    pass  # warming is best-effort by definition

    # -- surfaces ----------------------------------------------------------
    def health(self) -> Dict:
        """The aggregated fleet ``/healthz``: one
        probe answers "is the fleet serving" — the door's own state
        (draining, ejections, breakers) folded with every peer's last
        health document via :func:`blit_torch.monitor.fold_health`."""
        from blit_torch.monitor import fold_health

        own: List[str] = []
        with self._lock:
            if self._draining:
                own.append("draining")
            resizing = self.resize_reason
        standbys: List[str] = []
        peer_health: Dict[str, Optional[Dict]] = {}
        for name, p in sorted(self._peers.items()):
            if not p.in_ring:
                if p.standby:
                    standbys.append(name)  # capacity, not a casualty
                elif not p.retired:  # retired = deliberate scale-in
                    own.append(f"peer-ejected:{name}")
                continue
            state = p.breaker.snapshot()["state"]
            if state != "closed":
                own.append(f"breaker-{state.replace('-', '_')}:{name}")
            peer_health[name] = p.last_health
        if resizing:
            own.append(f"resizing:{resizing}")
        doc = fold_health(own, peer_health)
        doc["ring"] = self.ring.peers()
        doc["peers_total"] = len(self._peers)
        doc["standbys"] = standbys
        if resizing:
            # Honest mid-flip status: routing is
            # transiently degraded while membership flips — "ok" here
            # would lie to the probe that decides where traffic goes.
            doc["ok"] = False
            doc["status"] = "resizing"
        if not len(self.ring):
            doc["ok"] = False
            doc["status"] = "down"
        return doc

    def stats(self) -> Dict:
        with self._lock:
            hot = sorted(((fp, h) for fp, (h, _) in self._hot.items()),
                         key=lambda kv: kv[1], reverse=True)[:8]
            inflight = self._inflight
        rep = self.timeline.report()
        counters = {k: row["calls"] for k, row in rep.items()
                    if k.startswith(("fleet.", "elastic.", "catalog."))
                    and isinstance(row, dict) and "calls" in row}
        return {
            "catalog": (self.catalog.stats()
                        if self.catalog is not None else None),
            "peers": {n: p.snapshot()
                      for n, p in sorted(self._peers.items())},
            "ring": self.ring.peers(),
            "replicas": self.replicas,
            "wire": self.wire,
            "pool": self.pool.stats(),
            "inflight": inflight,
            "draining": self._draining,
            "hot": [[fp[:16], h] for fp, h in hot],
            "counters": counters,
            "hists": {k: v for k, v in (rep.get("hists") or {}).items()
                      if k in FLEET_HISTS},
        }

    def history(self, since: float, until: float, *,
                tier: Optional[str] = None) -> Dict:
        """Fleet-wide history range query: fan ``GET
        /history`` out to every in-ring peer and fold the answers with
        :func:`blit_torch.history.merge_buckets` — the same commutative
        hist-state/stage/burn fold the stores use locally, so the
        merged series read exactly as one peer's would.  Peers that
        fail or answer without a store are skipped and named."""
        from blit_torch.history import merge_buckets

        q = f"/history?since={since}&until={until}"
        if tier:
            q += f"&tier={tier}"
        lists: List[List[Dict]] = []
        answered: List[str] = []
        skipped: List[str] = []
        with self._lock:
            peers = [(n, p) for n, p in sorted(self._peers.items())
                     if p.in_ring]
        for name, p in peers:
            try:
                status, _, body = http_json("GET", p.url, q,
                                            timeout=10.0, pool=self.pool)
            except OSError:
                skipped.append(name)
                continue
            if status == 200 and isinstance(body, dict) \
                    and body.get("enabled"):
                lists.append(body.get("buckets") or [])
                answered.append(name)
            else:
                skipped.append(name)
        return {"t0": since, "t1": until, "peers": answered,
                "skipped": skipped,
                "buckets": merge_buckets(lists)}

    def metrics_prometheus(self, openmetrics: bool = False) -> str:
        snapshot = {"host": hostname(), "pid": os.getpid(), "worker": 0,
                    "timeline": self.timeline.state(),
                    "faults": faults.counters(), "spans": []}
        return render_prometheus(merge_fleet([snapshot]),
                                 openmetrics=openmetrics)

    # -- drain / teardown --------------------------------------------------
    def drain(self, timeout: Optional[float] = 30.0,
              hints: int = 32) -> Dict[str, int]:
        """Graceful front-door shutdown (tentpole #5): refuse new
        requests NOW, wait for in-flight ones to finish, then hand the
        ``hints`` hottest fingerprints' recipes to their current
        owner+replica peers as ``/warm`` hints — the door's working-set
        knowledge outlives the door."""
        with self._drain_cond:
            self._draining = True
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while self._inflight > 0:
                if deadline is not None and time.monotonic() >= deadline:
                    log.warning("fleet drain timed out with %d in-flight",
                                self._inflight)
                    break
                self._drain_cond.wait(timeout=0.1)
        per_peer: Dict[str, List[Dict]] = {}
        for fp, recipe in self.warm_hints(limit=hints):
            for name in self.ring.owners(fp):
                per_peer.setdefault(name, []).append(recipe)
        sent = 0
        for name, recipes in per_peer.items():
            try:
                http_json("POST", self._peers[name].url, "/warm",
                          {"recipes": recipes}, timeout=5.0,
                          pool=self.pool)
                sent += len(recipes)
            except OSError:
                pass
        self.timeline.count("fleet.drain.hints", sent)
        log.info("fleet drain: %d hot-entry hints handed to %d peer(s)",
                 sent, len(per_peer))
        return {"hints": sent, "peers_hinted": len(per_peer)}

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.pool.close()
        if self.request_log is not None:
            self.request_log.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def peers_from_spec(spec: Iterable[str]) -> Dict[str, str]:
    """Parse ``name=url`` (or bare ``url`` → ``peer<i>``) peer specs —
    the CLI's ``--peer`` flag grammar."""
    out: Dict[str, str] = {}
    for i, s in enumerate(spec):
        if "=" in s:
            name, url = s.split("=", 1)
        else:
            name, url = f"peer{i}", s
        out[name] = url.rstrip("/")
    return out


__all__ = ["FLEET_HISTS", "FleetError", "FleetFrontDoor",
           "PeerHTTPError", "peers_from_spec"]
