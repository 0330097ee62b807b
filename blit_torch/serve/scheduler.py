"""Priority job scheduler with admission control.

The queueing discipline between many callers and the bounded reduction
machinery.  Design points, in the order a request meets them:

- **Admission control** — each priority level has a BOUNDED queue
  (``SiteConfig.serve_queue_depth``).  A submission that would overflow
  it, or whose deadline provably cannot be met given the current backlog,
  is rejected immediately with :class:`Overloaded` carrying a
  ``retry_after_s`` hint — overload must surface as a fast, explicit
  signal, never as unbounded queue growth or a silent hang (the
  serving-stack shape the SNIPPETS dispatch-overhead benchmarks argue
  for: per-request cost stays flat under load).
- **Fair share** — within a priority, queues are PER CLIENT and service
  is round-robin across clients, so one caller fanning out thousands of
  requests cannot starve everyone else; across priorities, lower numbers
  always dispatch first.
- **Concurrency budget** — at most ``budget`` jobs run at once.  With a
  :class:`~blit_torch.parallel.pool.WorkerPool` attached the budget shrinks
  proportionally with degraded hosts (tripped circuit breakers,
  ``pool.health()``): a half-degraded cluster admits half the work
  instead of piling the same load onto the surviving hosts.
- **Observability** — queue-depth and per-job wait gauges land on the
  :class:`~blit_torch.observability.Timeline` (``sched.queue_depth`` /
  ``sched.wait_s``), the wait distribution lives in a bounded
  :class:`~blit_torch.observability.HistogramStats` (p50/p99 at fixed memory
  for the life of the scheduler), and the
  ``sched.dispatch`` fault-injection point covers the dispatch path so
  drills (blit/faults.py) reach the serving layer.

Jobs run on daemon threads (one per running job, capped by the budget —
the work itself releases the GIL in NumPy/HDF5 and the card, same reasoning as the
pool's thread backend).  ``clock`` is injectable so tests steer time.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional

from blit_torch import faults
from blit_torch.observability import HistogramStats, Timeline

log = logging.getLogger("blit_torch.serve.sched")


class Overloaded(RuntimeError):
    """Admission refused: queue full or deadline unmeetable.  Callers
    should back off at least ``retry_after_s`` before resubmitting.

    ``retry_after_s`` carries seeded JITTER: the
    raw estimate is deterministic, so a burst of simultaneously rejected
    clients obeying it verbatim would all come back in the same instant
    — the thundering herd the rejection was shedding.  The scheduler
    spreads them with the :class:`blit_torch.faults.RetryPolicy` jitter
    discipline (uniform in ``est * (1 ± jitter)``, a pure function of
    ``(seed, rejection index)`` when seeded), and the HTTP front door
    honors the jittered value as the 503 ``Retry-After`` header."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExpired(Overloaded):
    """The job's deadline burned before it could run (rejected at
    admission, or dropped at dispatch time after queueing past it) —
    the work was never computed.  An :class:`Overloaded` subclass so
    existing back-off handling applies."""


class Cancelled(RuntimeError):
    """The job was cancelled while still queued."""


def classify_failure(e: BaseException):
    """The access-record ``(status, code)`` of a serve-path failure —
    ONE mapping shared by the fleet door, the peer HTTP handler and
    ``ProductService.get``, so one failure shape never
    yields three different record shapes in one spool.  Success is the
    caller's ``("ok", 200)``; order matters (DeadlineExpired ⊂
    Overloaded).  A bare ``TimeoutError`` (the caller's wait budget
    burned with no declared deadline) records as ``timeout``/504 — a
    deadline-class outcome for the requester."""
    if isinstance(e, DeadlineExpired):
        return "deadline", 504
    if isinstance(e, Overloaded):
        return "overloaded", 503
    if isinstance(e, TimeoutError):
        return "timeout", 504
    # Archive catalog misses are the caller naming a
    # session/scan the tree does not hold — not-found, not a fault.
    if type(e).__name__ == "CatalogMiss":
        return "notfound", 404
    return "error", 500


class Job:
    """One scheduled unit of work.  ``wait()``/``result()`` block on
    completion; queue/run timings hang off the instance for reporting."""

    __slots__ = ("fn", "priority", "client", "deadline_s", "submitted_at",
                 "started_at", "finished_at", "state", "_result", "_exc",
                 "_done", "held", "on_drop")

    def __init__(self, fn: Callable[[], object], priority: int, client: str,
                 deadline_s: Optional[float], now: float,
                 held: bool = False,
                 on_drop: Optional[Callable[[BaseException], None]] = None):
        self.fn = fn
        # Called (on its own thread, like fn would have been) when the
        # scheduler DROPS the job without running it — dispatch-time
        # deadline expiry.  The service layer uses it to fail the
        # single-flight group, so waiters and later coalescers are not
        # left hanging on a job whose fn never ran.
        self.on_drop = on_drop
        self.priority = priority
        self.client = client
        self.deadline_s = deadline_s
        # Session-length capacity hold: a live job
        # that runs for the recording's duration, not a bounded
        # reduction — it consumes a concurrency slot but is EXCLUDED
        # from the EWMA service model and the deadline estimator's
        # work-ahead count (an unbounded job would poison both).
        self.held = held
        self.submitted_at = now
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.state = "queued"  # queued | running | done | cancelled
        self._result: object = None
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()

    @property
    def wait_s(self) -> Optional[float]:
        """Seconds spent queued (None until dispatch)."""
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> object:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job for client {self.client!r} not done within {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self._result


class Scheduler:
    """Bounded, fair-share, health-aware job scheduler (module docstring).

    ``max_concurrency`` is the base budget; ``pool`` (optional) shrinks it
    with degraded hosts; ``queue_depth`` bounds EACH priority's queue.
    """

    def __init__(
        self,
        *,
        max_concurrency: int = 4,
        queue_depth: int = 64,
        pool=None,
        timeline: Optional[Timeline] = None,
        clock: Callable[[], float] = time.monotonic,
        wait_est_floor: int = 32,
        retry_jitter: float = 0.5,
        retry_seed: Optional[int] = None,
    ):
        self.max_concurrency = max(1, int(max_concurrency))
        self.queue_depth = max(1, int(queue_depth))
        # Thundering-herd spread on rejection: the
        # RetryPolicy jitter discipline applied to retry_after_s.  With
        # retry_seed set, rejection k's jitter is a pure function of
        # (seed, k) — deterministic across runs, different across
        # rejections, so a drill replays the exact same spread.
        self.retry_jitter = max(0.0, float(retry_jitter))
        self.retry_seed = retry_seed
        self._reject_seq = 0
        self._retry_lock = threading.Lock()
        # Admission estimator regime switch: below this many recorded waits the
        # EWMA model estimates, at/above it the REAL wait_hist p99 does.
        self.wait_est_floor = max(1, int(wait_est_floor))
        # Load-shed level in [0, 0.9] (SLO breach hook, blit/monitor.py):
        # scales the concurrency budget and the admitted queue depth
        # down while an objective burns.
        self._shed = 0.0
        self.pool = pool
        self.timeline = timeline if timeline is not None else Timeline()
        self.clock = clock
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        # priority -> client -> FIFO of queued jobs; _rr keeps the
        # round-robin pick order of clients with queued work.
        self._queues: Dict[int, Dict[str, Deque[Job]]] = {}
        self._rr: Dict[int, Deque[str]] = {}
        self._queued: Dict[int, int] = {}
        self._running = 0
        # Capacity currently held by session-length (unbounded) jobs —
        # a subset of _running, reported via held()/stats so operators
        # see how much budget live sessions pin.
        # _held_queued tracks hold jobs still WAITING for a slot, PER
        # PRIORITY: they too must stay out of the deadline estimator's
        # work-ahead (a queued session is not "one EWMA-length job
        # ahead of you"), and the subtraction must follow the same
        # priority filter as the queue sum it corrects.
        self._held = 0
        self._held_queued: Dict[int, int] = {}
        self._closed = False
        # EWMA of job service seconds — the wait estimator's unit cost.
        self._svc_ewma = 0.0
        self._svc_n = 0
        # Bounded wait distribution: the old per-sample
        # list grew for the life of the scheduler; HistogramStats holds 64
        # counters forever, merges into fleet reports, and keeps the
        # {"p50","p99","n"} report shape.
        self.wait_hist = HistogramStats()
        self.counts: Dict[str, int] = {
            "submitted": 0, "dispatched": 0, "rejected": 0,
            "cancelled": 0, "failed": 0,
        }

    # -- capacity ----------------------------------------------------------
    def shed(self, fraction: float) -> None:
        """Tighten (or relax) admission by a load-shed fraction in
        ``[0, 0.9]`` — the SLO breach action
        (:meth:`blit_torch.monitor.BurnRateEvaluator.attach_scheduler`): the
        concurrency budget and the admitted queue depth both scale by
        ``1 - fraction`` while shed, so an overloaded service refuses
        work at the door instead of queueing latency it already cannot
        serve.  ``shed(0.0)`` restores full admission."""
        f = min(0.9, max(0.0, float(fraction)))
        changed = f != self._shed
        self._shed = f
        self.timeline.gauge("sched.shed", f)
        if changed:
            self.timeline.count("sched.shed_change")
            if f:
                log.warning("load shed engaged: admission scaled to "
                            "%.0f%%", (1.0 - f) * 100)
            else:
                log.info("load shed released: full admission restored")

    def shed_level(self) -> float:
        return self._shed

    def _shed_queue_depth(self) -> int:
        """The per-priority queue bound under the current shed level."""
        return max(1, int(self.queue_depth * (1.0 - self._shed)))

    def effective_budget(self) -> int:
        """The concurrency budget RIGHT NOW: the base budget scaled down
        by the current load-shed level (SLO breach hook) and by the
        fraction of degraded (breaker-open) hosts when a pool is
        attached; never below 1 (a fully degraded cluster still probes
        forward instead of wedging the queue)."""
        base = max(1, int(self.max_concurrency * (1.0 - self._shed)))
        if self.pool is None:
            return base
        health = self.pool.health()
        total = len(health)
        if total == 0:
            return base
        # Only a fully CLOSED breaker restores budget: a half-open host
        # is still degraded (one probe call is deciding its fate), so a
        # recovered-then-flaky host re-trips without ever having flapped
        # the budget back up.
        healthy = sum(1 for h in health if h.get("state") == "closed")
        return max(1, (base * healthy) // total)

    def depth(self) -> int:
        """Total queued jobs across every priority."""
        with self._lock:
            return sum(self._queued.values())

    def running(self) -> int:
        with self._lock:
            return self._running

    def held(self) -> int:
        """Concurrency slots pinned by session-length capacity holds
        (running jobs submitted with ``hold=True``)."""
        with self._lock:
            return self._held

    def est_wait_s(self, priority: int) -> float:
        """Expected queue wait for a NEW job at ``priority``.

        Two regimes:
        once ``wait_hist`` holds at least ``wait_est_floor`` recorded
        waits, the estimate is the REAL observed p99 queue wait (the
        tail the caller would actually risk — telemetry-hist-driven
        admission); below the floor it falls back to the EWMA model
        (work ahead x mean service time / budget), which is all a cold
        scheduler has.  Zero either way when nothing is ahead — an
        empty scheduler's history predicts nothing about an empty
        queue."""
        with self._lock:
            # Session-length holds are NOT work ahead — they never
            # finish "soon", so counting them (running OR still queued)
            # would reject every deadline the moment a live session
            # attaches.  They do pin capacity, which the budget term
            # below accounts.
            ahead = max(
                0,
                (self._running - self._held) + sum(
                    n for p, n in self._queued.items() if p <= priority
                ) - sum(n for p, n in self._held_queued.items()
                        if p <= priority),
            )
            held = self._held
            svc = self._svc_ewma
            n = self.wait_hist.n
            p99 = (self.wait_hist.percentile(0.99)
                   if n >= self.wait_est_floor else None)
        budget_free = self.effective_budget() - held
        if budget_free <= 0:
            # EVERY slot is pinned by session-length holds: bounded
            # work cannot start until a session ends, which the
            # estimator cannot bound — infinite, so deadline admission
            # rejects at the door instead of queueing a dead promise.
            return float("inf")
        if ahead == 0:
            return 0.0
        if p99 is not None:
            return p99
        return (ahead * svc) / budget_free

    def _retry_after_s(self, est: float) -> float:
        """The jittered ``retry_after_s`` for one rejection: the
        deterministic estimate spread by the RetryPolicy jitter rule
        (``est * (1 ± jitter)``) so simultaneously rejected clients do
        not return simultaneously.  Its own tiny lock, not the
        scheduler's: the service layer calls this for its own refusals
        (draining) while the scheduler lock may be held elsewhere."""
        base = max(0.1, est)
        if not self.retry_jitter:
            return base
        with self._retry_lock:
            k = self._reject_seq
            self._reject_seq += 1
        u = (random.Random(self.retry_seed * 1_000_003 + k).random()
             if self.retry_seed is not None else random.random())
        return max(0.05, base * (1.0 + self.retry_jitter * (2.0 * u - 1.0)))

    # -- submission --------------------------------------------------------
    def submit(
        self,
        fn: Callable[[], object],
        *,
        priority: int = 1,
        client: str = "anon",
        deadline_s: Optional[float] = None,
        hold: bool = False,
        on_drop: Optional[Callable[[BaseException], None]] = None,
    ) -> Job:
        """Admit ``fn`` for execution, or raise :class:`Overloaded`.

        ``deadline_s`` is the caller's patience: a job whose estimated
        queue wait already exceeds it is rejected at the door (the caller
        finds out NOW, not after the deadline burned in a queue).

        ``hold=True`` declares a session-length capacity hold (a LIVE
        job): the job consumes a concurrency slot
        for as long as the session records, but its (unbounded) service
        time never feeds the EWMA model and it is excluded from the
        deadline estimator's work-ahead count — the scheduler stops
        assuming bounded jobs.  ``held()``/``stats()`` report the
        pinned capacity."""
        if self._closed:
            raise RuntimeError("scheduler is closed")
        now = self.clock()
        est = self.est_wait_s(priority)
        with self._lock:
            depth_cap = self._shed_queue_depth()
            if self._queued.get(priority, 0) >= depth_cap:
                self.counts["rejected"] += 1
                self.timeline.count("sched.rejected")
                shed = (f", shedding {self._shed * 100:.0f}%"
                        if self._shed else "")
                raise Overloaded(
                    f"priority-{priority} queue full "
                    f"({depth_cap} jobs{shed}); try later",
                    retry_after_s=self._retry_after_s(est),
                )
            if deadline_s is not None and est > deadline_s:
                self.counts["rejected"] += 1
                self.timeline.count("sched.rejected")
                raise DeadlineExpired(
                    f"deadline {deadline_s:.3f}s unmeetable: estimated "
                    f"queue wait {est:.3f}s",
                    retry_after_s=self._retry_after_s(est),
                )
            job = Job(fn, priority, client, deadline_s, now, held=hold,
                      on_drop=on_drop)
            per_client = self._queues.setdefault(priority, {})
            q = per_client.get(client)
            if q is None:
                q = per_client[client] = deque()
                self._rr.setdefault(priority, deque())
            if client not in self._rr[priority]:
                self._rr[priority].append(client)
            q.append(job)
            self._queued[priority] = self._queued.get(priority, 0) + 1
            if job.held:
                self._held_queued[priority] = (
                    self._held_queued.get(priority, 0) + 1)
            self.counts["submitted"] += 1
            self.timeline.gauge("sched.queue_depth",
                                sum(self._queued.values()))
            self._dispatch_locked()
        return job

    # -- dispatch ----------------------------------------------------------
    def _pop_next_locked(self) -> Optional[Job]:
        """The next job by (priority asc, round-robin across clients)."""
        for priority in sorted(self._queues):
            rr = self._rr.get(priority)
            per_client = self._queues[priority]
            while rr:
                client = rr.popleft()
                q = per_client.get(client)
                if not q:
                    per_client.pop(client, None)
                    continue
                job = q.popleft()
                if q:
                    rr.append(client)  # more queued: back of the RR ring
                else:
                    per_client.pop(client, None)
                self._queued[priority] -= 1
                return job
        return None

    def _dispatch_locked(self) -> None:
        # One budget snapshot per dispatch round: effective_budget() walks
        # pool.health() (a breaker-lock acquisition per worker), too heavy
        # to re-evaluate per drained job while holding the scheduler lock.
        budget = self.effective_budget()
        while self._running < budget:
            job = self._pop_next_locked()
            if job is None:
                return
            if (job.deadline_s is not None
                    and self.clock() - job.submitted_at > job.deadline_s):
                # The deadline burned while the job sat queued: an already-dead request is NEVER computed
                # — it is failed here, at dispatch, without a slot or
                # (fleet path) a peer ever touching it.
                if job.held:
                    self._held_queued[job.priority] -= 1
                job.state = "done"
                job.finished_at = self.clock()
                exc = DeadlineExpired(
                    f"deadline {job.deadline_s:.3f}s expired after "
                    f"{self.clock() - job.submitted_at:.3f}s in queue")
                job._exc = exc
                self.counts["expired"] = self.counts.get("expired", 0) + 1
                self.timeline.count("sched.expired")
                job._done.set()
                if job.on_drop is not None:
                    # On its own thread, exactly as fn would have run:
                    # the hook reaches back into the service layer
                    # (its lock), which may be held by whoever called
                    # submit() into this dispatch round.
                    threading.Thread(
                        target=self._run_drop, args=(job, exc),
                        name=f"blit-serve-drop-{job.client}",
                        daemon=True).start()
                continue
            job.state = "running"
            job.started_at = self.clock()
            self._running += 1
            if job.held:
                self._held_queued[job.priority] -= 1
                self._held += 1
                self.timeline.gauge("sched.held", self._held)
            self.counts["dispatched"] += 1
            wait = job.started_at - job.submitted_at
            self.wait_hist.observe(wait)
            self.timeline.gauge("sched.wait_s", wait)
            self.timeline.observe("sched.wait_s", wait)
            self.timeline.gauge("sched.running", self._running)
            threading.Thread(
                target=self._run, args=(job,),
                name=f"blit-serve-{job.client}", daemon=True,
            ).start()

    def _run_drop(self, job: Job, exc: BaseException) -> None:
        try:
            job.on_drop(exc)
        except Exception:  # noqa: BLE001 — a drop hook must not wedge
            log.warning("on_drop hook for client %r failed", job.client,
                        exc_info=True)

    def _run(self, job: Job) -> None:
        t0 = time.perf_counter()
        try:
            faults.fire("sched.dispatch", key=job.client)
            with self.timeline.stage("sched.run", byte_free=True):
                job._result = job.fn()
        except BaseException as e:  # noqa: BLE001 — delivered via result()
            job._exc = e
            with self._lock:
                self.counts["failed"] += 1
            self.timeline.count("sched.failed")
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                if job.held:
                    # A session's duration is the RECORDING's, not the
                    # machinery's: folding it into the EWMA would make
                    # the deadline estimator reject every bounded job
                    # after one long session.
                    self._held -= 1
                    self.timeline.gauge("sched.held", self._held)
                else:
                    # EWMA toward recent service times (alpha 0.3),
                    # seeded by the first observation — the wait
                    # estimator's unit cost.
                    self._svc_n += 1
                    self._svc_ewma = (
                        dt if self._svc_n == 1
                        else 0.7 * self._svc_ewma + 0.3 * dt
                    )
                self._running -= 1
                self.timeline.gauge("sched.running", self._running)
                job.state = "done"
                job.finished_at = self.clock()
                self._dispatch_locked()
                self._idle.notify_all()
            job._done.set()

    # -- cancellation / teardown ------------------------------------------
    def cancel(self, job: Job) -> bool:
        """Cancel a still-QUEUED job, releasing its queue slot (True).
        Running jobs are not interrupted (False) — Python offers no safe
        preemption; the caller simply stops waiting."""
        with self._lock:
            if job.state != "queued":
                return False
            q = self._queues.get(job.priority, {}).get(job.client)
            if q is None or job not in q:
                return False
            q.remove(job)
            self._queued[job.priority] -= 1
            if job.held:
                self._held_queued[job.priority] -= 1
            job.state = "cancelled"
            self.counts["cancelled"] += 1
            self.timeline.count("sched.cancelled")
        job._exc = Cancelled("cancelled while queued")
        job._done.set()
        return True

    def wait_percentiles(self) -> Dict[str, float]:
        """p50/p99 of the recorded queue waits (seconds; 0 when empty) —
        bucket estimates from the bounded histogram (good to a factor of
        2), same ``{"p50","p99","n"}`` shape as the old exact-sample
        report."""
        with self._lock:
            # Under the lock: observe() runs inside _dispatch_locked, so
            # the counts/envelope pair stays consistent for the walk.
            h = self.wait_hist
            return {"p50": h.percentile(0.50), "p99": h.percentile(0.99),
                    "n": h.n}

    def drain(self, timeout: Optional[float] = 30.0,
              cancel_queued: bool = True) -> int:
        """Graceful shutdown:
        refuse new work NOW, optionally cancel everything still queued
        (delivering :class:`Cancelled` — a drain has no future in which
        to run them), and wait for the running jobs to finish.  Returns
        the number of queued jobs cancelled.  In-flight work always
        completes — drain never interrupts a running reduction; live
        sessions (``hold=True``) end when their SOURCES are closed,
        which is :meth:`blit_torch.serve.service.ProductService.drain`'s job
        before it calls here."""
        self._closed = True
        cancelled = 0
        if cancel_queued:
            with self._lock:
                jobs: list = []
                for per_client in self._queues.values():
                    for q in per_client.values():
                        jobs.extend(q)
            for job in jobs:
                if self.cancel(job):
                    cancelled += 1
        self.close(timeout)
        return cancelled

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Refuse new work and wait for queued+running jobs to drain."""
        self._closed = True
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._running > 0 or sum(self._queued.values()) > 0:
                if deadline is not None and time.monotonic() >= deadline:
                    log.warning(
                        "scheduler close timed out with %d running / "
                        "%d queued jobs", self._running,
                        sum(self._queued.values()),
                    )
                    return
                self._idle.wait(timeout=None if deadline is None else 0.1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
