"""``ProductService`` — the multi-tenant front door.

Turns blit from a one-caller library into a product service: callers
``submit()`` product requests and get tickets; identical requests share
work at every level —

- **completed** requests hit the two-tier content-addressed
  :class:`~blit_torch.serve.cache.ProductCache` (RAM, then disk) and return
  without touching the GUPPI layer at all;
- **in-flight** requests COALESCE: a single-flight group per reduction
  fingerprint means N concurrent callers asking for the same product run
  ONE reduction, and every caller gets the same (byte-identical,
  read-only) result array;
- **new** requests are admitted through the
  :class:`~blit_torch.serve.scheduler.Scheduler` (bounded queues, fair share,
  health-aware concurrency budget) onto the existing reduction machinery
  (:func:`blit_torch.pipeline.reducer_for_product` /
  :class:`~blit_torch.pipeline.RawReducer`), whose kernels run on the
  service's device: ``ProductService(device=None)`` is the card and
  raises without one; ``device="cpu"`` runs the plain versions.  The
  device is the service's, not the request's, so recipes and
  fingerprints are ``blit``'s byte for byte.

Failures propagate the pool error taxonomy per ticket
(``RemoteError(etype="HostDegraded")``, ``TimeoutError``,
``InjectedFault``, ...) and a failed flight is REMOVED from the
single-flight table — later identical requests start a fresh reduction
instead of being poisoned by a stale error.  Cancelling the last ticket
of a still-queued flight releases its scheduler slot.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from blit_torch import observability
from blit_torch.config import DEFAULT, SiteConfig
from blit_torch.observability import Timeline
from blit_torch.serve.cache import ProductCache, fingerprint_for
from blit_torch.serve.scheduler import Cancelled, Job, Overloaded, Scheduler

log = logging.getLogger("blit_torch.serve.service")


@dataclass(frozen=True)
class ProductRequest:
    """One product ask: which raw recording, reduced how.

    ``product`` selects a rawspec preset ("0000"/"0001"/"0002",
    :data:`blit_torch.pipeline.PRODUCT_PRESETS`); otherwise ``nfft``/``nint``
    configure the reduction directly (exactly the
    :func:`blit_torch.workers.reduce_raw` contract).  ``raw`` may be a single
    path or a multi-file sequence member list — member ORDER does not
    change the request's identity (fingerprints normalize it).

    ``kind="hits"`` asks for a drift-rate search product instead of a
    filterbank: the reduction runs a
    :class:`blit_torch.search.dedoppler.DedopplerReducer` and the result array
    is the dense hit-table encoding
    (:func:`blit_torch.search.hits.hits_from_array` decodes it under the
    returned header).  The search knobs join the fingerprint, so cached
    ``.hits`` and ``.fil`` products of the same recording never collide,
    and identical concurrent searches single-flight like any other
    request.

    ``kind="catalog"`` asks for the archive catalog document instead of
    a product: ``raw`` carries the query string (``""``
    lists sessions, ``"<session>"`` one session's scans,
    ``"<session>/<scan>"`` one scan's membership) and the answer rides
    the header of an empty result array — served from the process's
    :class:`~blit_torch.serve.catalog.CatalogIndex`, never cached or reduced.

    ``session``/``scan`` address a product LOGICALLY: leave
    ``raw`` empty and the front door (or a catalog-configured service)
    resolves the pair into the explicit member-path recipe via the
    catalog BEFORE fingerprinting — so the logical ask and the
    equivalent explicit-path ask are the same request (same ring
    owner, same single-flight group, byte-identical product).

    ``kind="stream"`` admits a LIVE job: ``raw`` names a recording still being written, ``out`` the
    product path, and the job runs :func:`blit_torch.stream.stream_reduce`
    (rejoinable, ``resume=True``) for the SESSION's duration.
    The scheduler admits the job under a capacity HOLD — it pins a
    concurrency slot but is excluded from the EWMA/deadline model,
    which assumes bounded jobs; ``session_s`` declares the expected
    session length, reported through ``stats()["held_declared_s"]`` so
    operators see how long the pin expects to last.  Live sessions are
    never cached or coalesced, and a second ask for an in-flight
    ``out`` is rejected (the bytes are still growing; the product
    lands on disk at ``out``) — the result tuple is ``(header, empty
    array)``."""

    raw: Union[str, Tuple[str, ...]]
    product: Optional[str] = None
    nfft: int = 1024
    nint: int = 1
    stokes: str = "I"
    fqav_by: int = 1
    dtype: str = "float32"
    # Product kind: "filterbank" (default) | "hits" (drift search) |
    # "stream" (live session, capacity-held).
    kind: str = "filterbank"
    # Search knobs (kind="hits" only; None -> SiteConfig/env defaults).
    window_spectra: Optional[int] = None
    snr_threshold: Optional[float] = None
    top_k: Optional[int] = None
    max_drift_bins: Optional[int] = None
    # Live-job knobs (kind="stream" only): product path, declared
    # session length (capacity-hold accounting), and the tail/replay
    # shaping passed through to stream_reduce's source.
    out: Optional[str] = None
    session_s: Optional[float] = None
    replay_rate: Optional[float] = None
    idle_timeout_s: Optional[float] = None
    # Logical archive addressing: resolved into member paths
    # through the catalog before fingerprinting; ``raw`` stays empty.
    session: Optional[str] = None
    scan: Optional[str] = None
    band: Optional[int] = None
    bank: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.raw, list):
            object.__setattr__(self, "raw", tuple(self.raw))
        if self.product is not None and (self.nfft != 1024 or self.nint != 1):
            raise ValueError(
                "pass either product= or explicit nfft/nint, not both"
            )
        if self.kind not in ("filterbank", "hits", "stream", "catalog"):
            raise ValueError(f"unknown product kind {self.kind!r}")
        if self.kind == "catalog":
            if not isinstance(self.raw, str):
                raise ValueError("a catalog ask carries its query string "
                                 "in raw= (\"\", \"<session>\" or "
                                 "\"<session>/<scan>\")")
            if self.session is not None or self.scan is not None:
                raise ValueError("kind='catalog' queries via raw=; "
                                 "session=/scan= address PRODUCTS")
        if (self.session is None) != (self.scan is None):
            raise ValueError("logical addressing needs BOTH session= "
                             "and scan=")
        if self.session is not None:
            if self.kind not in ("filterbank", "hits"):
                raise ValueError("session=/scan= addressing applies to "
                                 "derivable products (filterbank/hits)")
            if self.raw not in ("", ()):
                raise ValueError("pass either raw= member paths or "
                                 "session=/scan=, not both")
        elif self.band is not None or self.bank is not None:
            raise ValueError("band=/bank= qualify session=/scan= "
                             "addressing")
        if self.kind != "hits" and any(
            v is not None for v in (self.window_spectra, self.snr_threshold,
                                    self.top_k, self.max_drift_bins)
        ):
            raise ValueError("search knobs require kind='hits'")
        if self.kind == "hits" and (self.stokes != "I" or self.fqav_by != 1):
            raise ValueError(
                "hits products search the Stokes-I stream un-averaged "
                "(stokes='I', fqav_by=1)"
            )
        if self.kind == "stream":
            if self.out is None:
                raise ValueError("kind='stream' needs out= (the live "
                                 "product's path)")
            if isinstance(self.raw, tuple):
                raise ValueError("a live session tails ONE growing "
                                 "recording (a .NNNN.raw member path)")
        elif any(v is not None for v in (self.out, self.session_s,
                                         self.replay_rate,
                                         self.idle_timeout_s)):
            raise ValueError("out/session_s/replay_rate/idle_timeout_s "
                             "require kind='stream'")

    def reducer(self, device=None):
        """The configured reducer for this ask on ``device`` (None: the
        card): a :class:`blit_torch.pipeline.RawReducer` for
        filterbanks, a :class:`blit_torch.search.dedoppler.DedopplerReducer`
        for hits — both expose ``reduce(raw) -> (header, array)`` and the
        fingerprint knob surface, so the service treats them alike."""
        if self.kind == "catalog":
            raise ValueError("catalog asks are answered from the "
                             "CatalogIndex, not reduced")
        if self.kind == "stream":
            # The live job's reducer is a plain RawReducer (the stream
            # plane feeds the unchanged batch reducers); constructed
            # here so the service treats its knobs like any other's.
            from blit_torch.pipeline import RawReducer, reducer_for_product

            kw = dict(stokes=self.stokes, fqav_by=self.fqav_by,
                      dtype=self.dtype, device=device)
            if self.product is not None:
                return reducer_for_product(self.product, **kw)
            return RawReducer(nfft=self.nfft, nint=self.nint, **kw)
        if self.kind == "hits":
            from blit_torch.pipeline import PRODUCT_PRESETS
            from blit_torch.search import DedopplerReducer

            nfft, nint = (
                PRODUCT_PRESETS[self.product] if self.product is not None
                else (self.nfft, self.nint)
            )
            return DedopplerReducer(
                nfft=nfft, nint=nint, dtype=self.dtype,
                window_spectra=self.window_spectra,
                snr_threshold=self.snr_threshold, top_k=self.top_k,
                max_drift_bins=self.max_drift_bins, device=device,
            )
        from blit_torch.pipeline import RawReducer, reducer_for_product

        kw = dict(stokes=self.stokes, fqav_by=self.fqav_by, dtype=self.dtype,
                  device=device)
        if self.product is not None:
            return reducer_for_product(self.product, **kw)
        return RawReducer(nfft=self.nfft, nint=self.nint, **kw)

    def fingerprint(self) -> str:
        """The content address of this ask (:func:`fingerprint_for` over
        its reducer's knobs; the device does not enter it, so the
        knobs are read off a CPU reducer that never runs)."""
        return fingerprint_for(self.reducer(device="cpu"), self.raw_source)

    @property
    def raw_source(self):
        return list(self.raw) if isinstance(self.raw, tuple) else self.raw

    # Recipe fields a cache meta records: enough to rebuild
    # the request — and hence re-derive the entry — after a quarantine.
    _RECIPE_FIELDS = ("product", "nfft", "nint", "stokes", "fqav_by",
                     "dtype", "kind", "window_spectra", "snr_threshold",
                     "top_k", "max_drift_bins", "session", "scan",
                     "band", "bank")

    def recipe(self) -> Dict:
        """The JSON-able re-derivation recipe of this ask — stored in the
        disk cache's meta sidecar next to the fingerprint, so ``blit
        fsck --repair`` can rebuild a quarantined entry through the same
        reduce path the serve layer takes on a miss (the fingerprint is
        already a content-addressed recipe KEY; this makes it
        executable).  Live sessions are never cached, so never carry
        recipes."""
        d: Dict = {"raw": self.raw_source}
        for k in self._RECIPE_FIELDS:
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if d.get("product") is not None:
            # product= and explicit nfft/nint are mutually exclusive at
            # construction; the preset carries the pair.
            d.pop("nfft", None)
            d.pop("nint", None)
        return d

    @classmethod
    def from_recipe(cls, recipe: Dict) -> "ProductRequest":
        """Rebuild a request from a cache meta's recipe (unknown keys
        ignored so older blits can read newer recipes)."""
        kw = {k: recipe[k] for k in cls._RECIPE_FIELDS if k in recipe}
        return cls(raw=recipe["raw"], **kw)


class _Flight:
    """One single-flight group: every ticket for the same fingerprint
    submitted while the reduction is in flight rides this object."""

    __slots__ = ("fingerprint", "tickets", "job", "result", "exc", "done",
                 "source")

    def __init__(self, fingerprint: str):
        self.fingerprint = fingerprint
        self.tickets: List["Ticket"] = []
        self.job: Optional[Job] = None
        self.result: Optional[Tuple[Dict, np.ndarray]] = None
        self.exc: Optional[BaseException] = None
        self.done = threading.Event()
        # Live sessions only (kind="stream"): the ChunkSource feeding the
        # in-flight stream_reduce, kept so drain() can stop it gracefully
        # — the session finishes with what arrived
        # and its capacity hold releases instead of leaking.
        self.source = None


@dataclass
class Ticket:
    """A claim on one submitted request.  ``source`` records how it was
    (or will be) satisfied: ``"ram"``/``"disk"``/``"cold"`` cache hits
    and ``"catalog"`` answers complete at submit time; ``"scheduled"``
    started the reduction; ``"coalesced"`` joined one already in
    flight — both rewrite to ``"derive"`` once the reduction lands, so
    access records report the serving TIER."""

    fingerprint: str
    client: str
    source: str
    submitted_at: float = field(default_factory=time.monotonic)
    _flight: Optional[_Flight] = None
    _result: Optional[Tuple[Dict, np.ndarray]] = None
    cancelled: bool = False

    @property
    def done(self) -> bool:
        return (self._result is not None
                or self._flight is None
                or self._flight.done.is_set())

    def queue_wait_s(self) -> float:
        """Seconds this ticket's reduction sat queued (0.0 for cache
        hits and not-yet-dispatched flights) — the access record's
        queue-wait field."""
        f = self._flight
        if f is None or f.job is None:
            return 0.0
        return f.job.wait_s or 0.0


class ProductService:
    """The serving front door (module docstring).  One instance per
    process; all methods are thread-safe.

    ``pool`` (optional) is the :class:`~blit_torch.parallel.pool.WorkerPool`
    whose health shrinks the scheduler's concurrency budget; the
    reductions themselves run in the scheduler's job threads (the heavy
    lifting releases the GIL in NumPy/HDF5 and the card's launches).
    ``device`` is where misses reduce: None is the card (raising
    without one), ``"cpu"`` the plain versions."""

    def __init__(
        self,
        *,
        cache: Optional[ProductCache] = None,
        scheduler: Optional[Scheduler] = None,
        config: SiteConfig = DEFAULT,
        pool=None,
        timeline: Optional[Timeline] = None,
        catalog=None,
        device=None,
    ):
        from blit_torch.config import archive_defaults, catalog_defaults
        from blit_torch.device import resolve_device

        self.device = resolve_device(device)

        self.timeline = timeline if timeline is not None else Timeline()
        self.cache = cache if cache is not None else ProductCache(
            config.cache_dir, ram_bytes=config.cache_ram_bytes,
            timeline=self.timeline,
            cold_dir=archive_defaults(config)["cold_dir"],
        )
        # Archive catalog: serves kind="catalog" asks and
        # resolves session=/scan= logical addressing.  Built when
        # BLIT_CATALOG_ROOT / SiteConfig.catalog_root names a tree (or
        # passed in ready-made); None otherwise — catalog asks then
        # fail loudly as caller errors.
        self.catalog = catalog
        if self.catalog is None and catalog_defaults(config)["enabled"]:
            from blit_torch.serve.catalog import CatalogIndex

            self.catalog = CatalogIndex(config=config,
                                        timeline=self.timeline)
        self.scheduler = scheduler if scheduler is not None else Scheduler(
            max_concurrency=config.serve_max_concurrency,
            queue_depth=config.serve_queue_depth,
            pool=pool, timeline=self.timeline,
        )
        self._lock = threading.Lock()
        self._flights: Dict[str, _Flight] = {}
        # Graceful-drain latch: once set, submissions are
        # REFUSED with Overloaded (the HTTP layer answers 503 so a fleet
        # front door fails over to a replica) while in-flight work
        # finishes and live-session holds release.
        self._draining = False
        # In-flight live sessions' DECLARED lengths (kind="stream"
        # session_s; None = undeclared) — the operator-facing view of
        # how long the held capacity expects to stay pinned (stats()).
        self._live_declared: Dict[str, Optional[float]] = {}
        self.counts: Dict[str, int] = {
            "requests": 0, "coalesced": 0, "cache_hits": 0,
            "scheduled": 0, "rejected": 0,
        }
        # Per-request access records: library/bench callers
        # going through get() write one bounded JSON line per request —
        # None (one attribute test per request) unless BLIT_REQUEST_LOG
        # / SiteConfig.request_log_dir enables it.  The fleet peer's
        # HTTP handler keeps its OWN log (it submits tickets directly),
        # so one request never double-records.
        self.request_log = observability.request_log_for("serve", config)
        # Live monitoring: when the process-wide publisher is
        # enabled (BLIT_MONITOR_* / SiteConfig monitor_* knobs), this
        # service's timeline joins its watch set — queue depth, wait
        # tails and cache counters stream to the spool/endpoint while
        # requests flow — and SLO breaches shed THIS scheduler's
        # admission (Scheduler.shed) until the burn clears.
        from blit_torch import monitor

        self._publisher = monitor.ensure_publisher(config)
        if self._publisher is not None:
            self._publisher.watch(self.timeline)
            self._publisher.slo.attach_scheduler(self.scheduler)
        # Background integrity scrubbing: opt-in via
        # BLIT_SCRUB_INTERVAL / SiteConfig.scrub_interval_s — samples
        # disk-tier entries between requests under a bytes/s budget,
        # quarantining what fails and publishing integrity.scrub.*
        # through the monitor plane.
        from blit_torch.config import scrub_defaults

        self._scrubber = None
        sd = scrub_defaults(config)
        if sd["enabled"] and self.cache.root is not None:
            from blit_torch.integrity import Scrubber

            self._scrubber = Scrubber(
                self.cache, interval_s=sd["interval_s"],
                bytes_per_s=sd["bytes_per_s"],
                timeline=self.timeline).start()

    # -- submission --------------------------------------------------------
    def submit(
        self,
        request: ProductRequest,
        *,
        priority: int = 1,
        client: str = "anon",
        deadline_s: Optional[float] = None,
    ) -> Ticket:
        """Admit one request.  Returns a :class:`Ticket` (possibly already
        complete — cache hits never enter the queue); raises
        :class:`~blit_torch.serve.scheduler.Overloaded` when admission control
        refuses, and ``OSError`` when the raw input does not exist (an
        address over unknown bytes is a caller bug, found at the door)."""
        if self._draining:
            with self._lock:
                self.counts["rejected"] += 1
            raise Overloaded("service is draining (shutdown in "
                             "progress); retry another replica",
                             retry_after_s=self.scheduler._retry_after_s(
                                 1.0))
        if request.kind == "stream":
            if deadline_s is not None:
                # The deadline estimator models BOUNDED jobs; silently
                # queueing a session past a caller's deadline would be
                # the un-honored contract, so refuse loudly instead.
                raise ValueError(
                    "deadline_s does not apply to kind='stream' live "
                    "sessions (they run for the recording's duration)")
            return self._submit_stream(request, priority, client)
        if request.kind == "catalog":
            return self._submit_catalog(request, client)
        if request.session is not None:
            request = self.resolve_request(request)
        fp = request.fingerprint()
        with self._lock:
            self.counts["requests"] += 1
        # Completed products serve straight from the cache — the hot path
        # never touches the GUPPI layer (acceptance: the guppi.read
        # injection point stays cold on hits).
        hit = self.cache.get(fp)
        if hit is not None:
            header, data, tier = hit
            with self._lock:
                self.counts["cache_hits"] += 1
            return Ticket(fp, client, tier, _result=(header, data))
        with self._lock:
            flight = self._flights.get(fp)
            if flight is not None:
                # Single-flight coalescing: ride the running reduction.
                t = Ticket(fp, client, "coalesced", _flight=flight)
                flight.tickets.append(t)
                self.counts["coalesced"] += 1
                self.timeline.count("serve.coalesced")
                return t
            flight = _Flight(fp)
            t = Ticket(fp, client, "scheduled", _flight=flight)
            flight.tickets.append(t)
            self._flights[fp] = flight
            # Capture the submitter's trace context NOW: the reduction
            # runs later on a scheduler job thread, and its span must
            # parent onto the request that scheduled it — N
            # coalesced callers all point at this one flight span tree.
            ctx = observability.tracer().context()
            try:
                flight.job = self.scheduler.submit(
                    lambda: self._reduce_and_publish(fp, request, flight,
                                                     ctx),
                    priority=priority, client=client, deadline_s=deadline_s,
                    # Dispatch-time deadline expiry DROPS the job
                    # without running fn — the flight must still fail,
                    # or waiters hang and later identical requests
                    # coalesce onto a dead group forever.
                    on_drop=lambda e: self._finish(fp, flight, exc=e),
                )
            except BaseException as e:
                # ANY admission failure (Overloaded, a closed scheduler,
                # ...) must drop the flight from the table — a leaked
                # jobless flight would make every later identical request
                # coalesce onto it and hang forever.
                del self._flights[fp]
                if isinstance(e, Overloaded):
                    self.counts["rejected"] += 1
                raise
            self.counts["scheduled"] += 1
        return t

    def wire_for(self, request: ProductRequest
                 ) -> Optional[Tuple[str, bytes, str]]:
        """The already-encoded binary wire body for ``request`` when
        the cache retains one: ``(fingerprint, frame bytes,
        tier)``, or ``None`` — a miss here is NOT a cache miss; the
        caller falls back to :meth:`submit`, which counts and serves.
        A draining service answers ``None`` too, so the refusal runs
        through submit's :class:`Overloaded` → 503 contract unchanged.
        """
        if self._draining or request.kind in ("stream", "catalog"):
            return None
        if request.session is not None:
            try:
                request = self.resolve_request(request)
            except Exception:
                # submit() is the authoritative error surface; a wire
                # miss just falls back to it.
                return None
        fp = request.fingerprint()
        hit = self.cache.get_wire(fp)
        if hit is None:
            return None
        body, tier = hit
        with self._lock:
            self.counts["requests"] += 1
            self.counts["cache_hits"] += 1
        return fp, body, tier

    def resolve_request(self, request: ProductRequest) -> ProductRequest:
        """Substitute ``session=``/``scan=`` logical addressing with the
        catalog's member-path list.  Identity-preserving by
        construction: the result IS the equivalent explicit-member-path
        request — same fingerprint, same ring owner, same single-flight
        group, byte-identical product."""
        if request.session is None:
            return request
        if self.catalog is None:
            raise ValueError(
                "session=/scan= addressing needs a catalog "
                "(BLIT_CATALOG_ROOT / SiteConfig.catalog_root)")
        import dataclasses

        members = self.catalog.resolve(
            request.session, request.scan,
            band=request.band, bank=request.bank)
        return dataclasses.replace(
            request, raw=tuple(members),
            session=None, scan=None, band=None, bank=None)

    def _submit_catalog(self, request: ProductRequest,
                        client: str) -> Ticket:
        """Answer a ``kind="catalog"`` ask from the process's
        :class:`~blit_torch.serve.catalog.CatalogIndex` — synchronous (an
        in-RAM index read; a ticket keeps the caller surface uniform),
        never cached, never coalesced, never queued."""
        from blit_torch.serve.catalog import catalog_fingerprint

        with self._lock:
            self.counts["requests"] += 1
        if self.catalog is None:
            raise ValueError(
                "no catalog configured (BLIT_CATALOG_ROOT / "
                "SiteConfig.catalog_root)")
        header, data = self.catalog.serve(request.raw)
        fp = catalog_fingerprint((request.raw or "").strip("/"))
        self.timeline.count("serve.catalog")
        return Ticket(fp, client, "catalog", _result=(header, data))

    def _submit_stream(self, request: ProductRequest, priority: int,
                       client: str) -> Ticket:
        """Admit a LIVE job: no cache hit is
        possible over still-growing bytes and no coalescing is safe —
        two live consumers of one session would interleave appends on
        ONE product path and its rejoin sidecar — so a second ask for
        an in-flight ``out`` is REJECTED with :class:`Overloaded`
        (retry once the session ends; a crashed session's restart goes
        through `blit_torch.recover.StreamSupervisor`, not a duplicate
        submit).  Admitted sessions go straight to the scheduler under
        a session-length capacity hold."""
        fp = f"live:{request.out}"
        with self._lock:
            self.counts["requests"] += 1
            if fp in self._flights:
                self.counts["rejected"] += 1
                raise Overloaded(
                    f"live session already in flight for {request.out}; "
                    "retry after it ends")
            flight = _Flight(fp)
            t = Ticket(fp, client, "scheduled", _flight=flight)
            flight.tickets.append(t)
            self._flights[fp] = flight
            ctx = observability.tracer().context()
            try:
                flight.job = self.scheduler.submit(
                    lambda: self._run_stream(request, flight, ctx),
                    priority=priority, client=client, hold=True,
                )
            except BaseException as e:
                del self._flights[fp]  # the bounded-path leak rule
                if isinstance(e, Overloaded):
                    self.counts["rejected"] += 1
                raise
            self._live_declared[fp] = request.session_s
            self.counts["scheduled"] += 1
            self.timeline.count("serve.live_sessions")
        return t

    def _run_stream(self, request: ProductRequest, flight: _Flight,
                    ctx=None) -> Tuple[Dict, np.ndarray]:
        tr = observability.tracer()
        try:
            with tr.activate(ctx), \
                    tr.span("serve.stream", out=request.out), \
                    self.timeline.stage("serve.stream", byte_free=True):
                from blit_torch.stream import (
                    FileTailSource,
                    ReplaySource,
                    stream_reduce,
                )

                reducer = request.reducer(self.device)
                if request.replay_rate:
                    src = ReplaySource(request.raw,
                                       rate=request.replay_rate)
                else:
                    src = FileTailSource(
                        request.raw,
                        idle_timeout_s=request.idle_timeout_s)
                flight.source = src  # drain() stops it gracefully
                hdr = stream_reduce(src, request.out, reducer=reducer,
                                    resume=True)
            data = np.zeros(
                (0, int(hdr.get("nifs", 1)), int(hdr.get("nchans", 0))),
                np.float32)
            data.setflags(write=False)
            self._finish(flight.fingerprint, flight, result=(hdr, data))
            return hdr, data
        except BaseException as e:  # noqa: BLE001 — per-ticket delivery
            self._finish(flight.fingerprint, flight, exc=e)
            raise

    def _reduce_and_publish(
        self, fp: str, request: ProductRequest, flight: _Flight, ctx=None
    ) -> Tuple[Dict, np.ndarray]:
        """The scheduled job body: run the reduction, publish to the
        cache, fulfill (or fail) every ticket on the flight.  ``ctx`` is
        the submitter's trace context — the job thread adopts it so the
        reduction's spans parent onto the request."""
        tr = observability.tracer()
        try:
            with tr.activate(ctx), \
                    tr.span("serve.reduce", fp=fp[:16]) as sp, \
                    self.timeline.stage("serve.reduce", byte_free=True):
                # Construct INSIDE the span/stage: reducer construction
                # (tuning-profile lookup, and at hi-res nfft the PFB
                # coefficient build) is request work — it must show in
                # the request's timing and parent onto its trace.  The
                # resolved profile key lands on the live span so a trace
                # names which knob set served the request.
                reducer = request.reducer(self.device)
                prov_fn = getattr(reducer, "tuning_provenance", None)
                prov = prov_fn() if prov_fn is not None else {}
                tuned = prov.get("profile", {}).get("key", "")[:16]
                if sp is not None and tuned:
                    sp.attrs = dict(sp.attrs or {}, tuned=tuned)
                header, data = reducer.reduce(request.raw_source)
            data = self.cache.put(fp, header, data,
                                  recipe=request.recipe())
            # Tier accounting: this request was satisfied by
            # DERIVATION — every ticket on the flight (scheduler and
            # coalescers alike) reports tier "derive", completing the
            # {ram, wire, disk, cold, derive} per-request tier story.
            self.cache.note_derive()
            with self._lock:
                for t in flight.tickets:
                    t.source = "derive"
            self._finish(fp, flight, result=(header, data))
            return header, data
        except BaseException as e:  # noqa: BLE001 — per-ticket delivery
            # Fail THIS flight's tickets but drop the group from the
            # table: a later identical request must start fresh, not be
            # poisoned by a stale error (transient faults recover).
            self._finish(fp, flight, exc=e)
            raise

    def _finish(
        self,
        fp: str,
        flight: _Flight,
        result: Optional[Tuple[Dict, np.ndarray]] = None,
        exc: Optional[BaseException] = None,
    ) -> None:
        with self._lock:
            if self._flights.get(fp) is flight:
                del self._flights[fp]
            self._live_declared.pop(fp, None)
            flight.result = result
            flight.exc = exc
        flight.done.set()

    # -- results -----------------------------------------------------------
    def result(
        self, ticket: Ticket, timeout: Optional[float] = None
    ) -> Tuple[Dict, np.ndarray]:
        """Block until the ticket's product is ready → ``(header, data)``
        with ``data`` read-only ``(nsamps, nif, nchans)`` float32.  Raises
        the flight's failure for this ticket, :class:`Cancelled` for a cancelled ticket, and the
        builtin ``TimeoutError`` past ``timeout``."""
        if ticket.cancelled:
            raise Cancelled("ticket was cancelled")
        if ticket._result is not None:
            return ticket._result
        flight = ticket._flight
        if flight is None or not flight.done.wait(timeout):
            raise TimeoutError(
                f"product {ticket.fingerprint[:16]}… not ready within "
                f"{timeout}s"
            )
        if ticket.cancelled:
            raise Cancelled("ticket was cancelled")
        if flight.exc is not None:
            raise flight.exc
        ticket._result = flight.result
        return flight.result

    def get(
        self,
        request: ProductRequest,
        *,
        timeout: Optional[float] = None,
        priority: int = 1,
        client: str = "anon",
        deadline_s: Optional[float] = None,
    ) -> Tuple[Dict, np.ndarray]:
        """Synchronous convenience: ``submit`` + ``result``.  When
        request logging is enabled, every call — served,
        refused or failed — appends exactly one access record."""
        if self.request_log is None:
            return self.result(
                self.submit(request, priority=priority, client=client,
                            deadline_s=deadline_s),
                timeout=timeout,
            )
        t0 = time.perf_counter()
        ctx = observability.tracer().context()
        status, code, ticket, nbytes = "error", 500, None, 0
        try:
            ticket = self.submit(request, priority=priority,
                                 client=client, deadline_s=deadline_s)
            header, data = self.result(ticket, timeout=timeout)
            nbytes = data.nbytes
            status, code = "ok", 200
            return header, data
        except BaseException as e:
            from blit_torch.serve.scheduler import classify_failure

            status, code = classify_failure(e)
            raise
        finally:
            dt = time.perf_counter() - t0
            self.request_log.record(
                rid=observability.new_id(),
                trace=(ctx or {}).get("trace"), role="serve",
                client=client, priority=priority,
                fp=(ticket.fingerprint[:16] if ticket else None),
                tier=(ticket.source if ticket else None),
                queue_wait_s=(round(ticket.queue_wait_s(), 6)
                              if ticket else None),
                deadline_s=deadline_s,
                deadline_left_s=(round(deadline_s - dt, 6)
                                 if deadline_s is not None else None),
                status=status, code=code, bytes=nbytes,
                duration_s=round(dt, 6))

    def cancel(self, ticket: Ticket) -> bool:
        """Withdraw a ticket.  The LAST ticket of a still-queued flight
        cancels the underlying job and releases its queue slot; a flight
        whose reduction is already running completes anyway (its product
        is cached for the next asker).  Returns True when the ticket was
        withdrawn before completion."""
        with self._lock:
            if ticket.cancelled or ticket._result is not None:
                return False
            flight = ticket._flight
            if flight is None or flight.done.is_set():
                return False
            ticket.cancelled = True
            if ticket in flight.tickets:
                flight.tickets.remove(ticket)
            if flight.tickets or flight.job is None:
                return True
            job = flight.job
        if self.scheduler.cancel(job):
            self._finish(ticket.fingerprint, flight,
                         exc=Cancelled("all tickets cancelled"))
        return True

    # -- reporting / teardown ---------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Serving counters + cache counters + queue-wait percentiles —
        the ``serve-bench`` CLI's report body."""
        with self._lock:
            out: Dict[str, object] = dict(self.counts)
            out["inflight"] = len(self._flights)
        cache = self.cache.stats()
        out["cache"] = cache
        served = (cache["hit.ram"] + cache["hit.disk"]
                  + cache.get("hit.cold", 0))
        total = served + cache["miss"]
        out["hit_rate"] = round(served / total, 4) if total else 0.0
        if self.catalog is not None:
            out["catalog"] = self.catalog.stats()
        out["queue_wait"] = self.scheduler.wait_percentiles()
        out["budget"] = self.scheduler.effective_budget()
        out["shed"] = self.scheduler.shed_level()
        # Capacity pinned by live sessions: the
        # held slots are budget the bounded-job estimator cannot use;
        # held_declared_s totals the in-flight sessions' DECLARED
        # lengths (session_s) so an operator sees how long that pin
        # expects to last.
        out["held"] = self.scheduler.held()
        with self._lock:
            out["held_declared_s"] = sum(
                s for s in self._live_declared.values() if s)
        return out

    def drain(self, timeout: Optional[float] = 30.0) -> Dict[str, int]:
        """Graceful shutdown:

        1. refuse new submissions (:class:`Overloaded`; the HTTP layer
           answers 503 so a fleet front door fails over to a replica),
        2. STOP every in-flight live session's chunk source — the
           session finishes cleanly with the chunks that arrived, its
           resumable cursor stays rejoinable, and its ``kind="stream"``
           capacity hold RELEASES instead of leaking on interpreter
           exit,
        3. cancel still-queued jobs and wait for running ones
           (:meth:`Scheduler.drain`).

        Returns ``{"cancelled": queued jobs cancelled, "stopped": live
        sources stopped}``.  Idempotent; ``close()`` afterwards is
        still the teardown."""
        self._draining = True
        # Live flights whose job was just dispatched may not have built
        # their source yet (the submit→_run_stream window) — poll
        # briefly so a drain racing a fresh session still stops it.
        deadline = time.monotonic() + 2.0
        while True:
            with self._lock:
                live = [f for fp, f in self._flights.items()
                        if fp.startswith("live:") and not f.done.is_set()]
                sources = [f.source for f in live if f.source is not None]
            if len(sources) == len(live) or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        stopped = 0
        for src in sources:
            try:
                src.stop()
                stopped += 1
            except Exception:  # noqa: BLE001 — drain must not die mid-way
                log.warning("drain: stopping a live source failed",
                            exc_info=True)
        self.timeline.count("serve.drain")
        cancelled = self.scheduler.drain(timeout)
        # Flights whose job was cancelled while queued never reached
        # _reduce_and_publish — deliver Cancelled to their tickets so no
        # waiter blocks on a drained service forever.
        with self._lock:
            orphaned = [(fp, f) for fp, f in list(self._flights.items())
                        if f.job is not None and f.job.state == "cancelled"]
        for fp, flight in orphaned:
            self._finish(fp, flight,
                         exc=Cancelled("service drained while queued"))
        return {"cancelled": cancelled, "stopped": stopped}

    def draining(self) -> bool:
        return self._draining

    def close(self, timeout: Optional[float] = 30.0) -> None:
        if self.request_log is not None:
            self.request_log.close()
        if self._scrubber is not None:
            self._scrubber.close()
            self._scrubber = None
        if self._publisher is not None:
            self._publisher.unwatch(self.timeline)
            self._publisher.slo.detach_scheduler(self.scheduler)
            self._publisher = None
        self.scheduler.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
