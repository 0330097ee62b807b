"""Host-side worker pool — the control plane.

Counterpart of ``blit/parallel/pool.py``: the reference's
``Distributed.addprocs``-over-ssh star topology (``GBT.setupworkers``,
src/gbt.jl:12-46) as a pluggable pool:

- ``local``   — synchronous in-process calls (debugging, tests);
- ``thread``  — one thread per worker (the default: crawls and reads
  release the GIL in NumPy, and reductions on the card run their
  producer, readback and sink threads underneath);
- ``process`` — a process pool, started with ``spawn``: a child forked
  from a parent that holds a CUDA context cannot use CUDA, and the pool
  cannot know whether a later call will touch the card;
- ``remote``  — one ``python -m blit_torch.agent`` subprocess per host
  over ssh (:mod:`blit_torch.parallel.remote`), calls routed to the host
  that owns the files.  Each agent holds its own CUDA context.

Differences from the reference, by design (SURVEY.md §5 "Failure detection"):

- ``setup_workers`` with a live pool returns *the live pool* (the reference
  warns and returns an empty list — src/gbt.jl:20-22, listed as a wart);
- every fan-out supports ``on_error="capture"`` returning ``WorkerError``
  placeholders instead of aborting the whole broadcast on one bad worker
  (the reference's ``fetch.`` raises on the first RemoteException).
"""

from __future__ import annotations

import logging
import multiprocessing
import threading
import time
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from blit_torch import faults, observability
from blit_torch.config import DEFAULT, SiteConfig

log = logging.getLogger("blit_torch.pool")


def _traced_call(ctx, wid: int, host: str, fn: Callable, args, kw):
    """Executor-side wrapper for the in-process backends: adopt the
    caller's trace context (thread-locals do not flow into pool threads)
    and record the dispatch as a child span.  Module-level so the process
    backend can pickle it."""
    tr = observability.tracer()
    with tr.activate(ctx):
        with tr.span(f"pool.{getattr(fn, '__name__', 'call')}",
                     worker=wid, host=host):
            return fn(*args, **kw)

# Distinguishes "not given" (inherit SiteConfig) from an explicit None
# (disable the deadline — the reference's blocking behavior).
_UNSET = object()


def _remaining(deadline: Optional[float]) -> Optional[float]:
    """Seconds left until a shared ``time.monotonic()`` deadline (0 once
    past — ``Future.result`` treats 0 as an immediate-expiry poll)."""
    return None if deadline is None else max(0.0, deadline - time.monotonic())


@dataclass
class WorkerError:
    """Captured per-worker failure (returned, not raised, under
    ``on_error='capture'``)."""

    worker: int
    host: str
    error: Exception

    def __bool__(self):
        return False


@dataclass
class _Worker:
    wid: int
    host: str
    remote: Optional[object] = None  # RemoteWorker for backend="remote"
    # Per-host failure circuit (consulted on the remote call path only):
    # repeated AgentDied/CallTimeout trips the host into "degraded" and
    # calls fail fast instead of hammering it.
    breaker: Optional[faults.CircuitBreaker] = None


class WorkerPool:
    """A pool with one logical worker per host, ordered 1:1 with ``hosts``
    (reference contract: README.md:58-64 — worker i serves hosts[i])."""

    def __init__(
        self,
        hosts: Sequence[str],
        backend: str = "thread",
        config: SiteConfig = DEFAULT,
        transport: Optional[Callable[[str], Sequence[str]]] = None,
        agent_env: Optional[dict] = None,
        call_timeout=_UNSET,
        ping_timeout=_UNSET,
    ):
        """``transport``/``agent_env`` apply to ``backend="remote"`` only:
        ``transport(host)`` returns the agent-spawning command (default:
        ``remote.ssh_command``); tests pass a local-subprocess transport.

        ``call_timeout``/``ping_timeout`` (remote backend) override the
        site config's worker liveness deadlines
        (:class:`blit_torch.parallel.remote.RemoteWorker`); an explicit ``None``
        DISABLES the deadline (blocking ``fetch``, the reference's
        behavior) — omit them to inherit the config."""
        if backend not in ("local", "thread", "process", "remote"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.config = config
        self.call_timeout = (
            config.call_timeout if call_timeout is _UNSET else call_timeout
        )
        self.ping_timeout = (
            config.ping_timeout if ping_timeout is _UNSET else ping_timeout
        )
        # Worker ids start at 1; id 0 is "the main process" by convention,
        # mirroring Distributed.jl's pid-1 master.
        self.workers: List[_Worker] = [
            _Worker(i + 1, h, breaker=faults.CircuitBreaker(
                config.breaker_threshold, config.breaker_cooldown_s))
            for i, h in enumerate(hosts)
        ]
        # Remote-call re-dispatch policy (AgentDied/CallTimeout retries
        # through the existing agent respawn; seeded jitter, injectable
        # sleep — see blit_torch/faults.py).  The policy is the ONE source of
        # truth for both the attempt count and the backoff curve.
        self.retry_policy = config.call_retry_policy()
        self._exec = None
        if backend in ("thread", "remote"):
            self._exec = ThreadPoolExecutor(
                max_workers=max(1, len(self.workers)), thread_name_prefix="blit-w"
            )
        elif backend == "process":
            # spawn, not fork: see the module docstring.
            self._exec = ProcessPoolExecutor(
                mp_context=multiprocessing.get_context("spawn"))
        if backend == "remote":
            import os

            from blit_torch.parallel.remote import RemoteWorker, ssh_command

            make_cmd = transport or ssh_command
            for w in self.workers:
                # Stamp the agent's identity so its log records and
                # spans carry the worker id (blit_torch/agent.py main
                # reads BLIT_WORKER_ID).  Two
                # routes, because sshd does NOT forward the client's
                # environment: transports that accept ``remote_env``
                # (ssh_command) splice an ``env K=V`` prefix into the
                # remote command line; the local subprocess env below
                # covers direct transports (tests, same-host agents).
                stamp = {"BLIT_WORKER_ID": str(w.wid)}
                if os.environ.get("BLIT_LOG_JSON"):
                    stamp["BLIT_LOG_JSON"] = os.environ["BLIT_LOG_JSON"]
                try:
                    cmd = make_cmd(w.host, remote_env=stamp)
                except TypeError:  # transport without remote_env support
                    cmd = make_cmd(w.host)
                env = dict(agent_env if agent_env is not None else os.environ)
                env.update(stamp)
                w.remote = RemoteWorker(
                    w.host, cmd, env=env,
                    call_timeout=self.call_timeout,
                    ping_timeout=self.ping_timeout,
                )

    # -- introspection ----------------------------------------------------
    @property
    def worker_ids(self) -> List[int]:
        return [w.wid for w in self.workers]

    @property
    def hosts(self) -> List[str]:
        return [w.host for w in self.workers]

    def host_of(self, wid: int) -> str:
        return self.workers[wid - 1].host

    def __len__(self):
        return len(self.workers)

    def health(self) -> List[Dict[str, object]]:
        """Per-worker circuit state for the run report: a degraded run
        must SAY so (``state == "open"`` means the host is degraded and
        calls fail fast until the cooldown probe re-closes it;
        ``half_open`` marks the probe phase — ONE call is in flight
        deciding whether the host re-closes or re-trips, and capacity
        consumers must keep treating it as degraded until it closes,
        or a recovered-then-flaky host flaps the budget)."""
        out = []
        for w in self.workers:
            snap = w.breaker.snapshot()
            snap["half_open"] = snap["state"] == "half-open"
            out.append({"worker": w.wid, "host": w.host, **snap})
        return out

    # -- execution --------------------------------------------------------
    def _remote_call(self, w: _Worker, fn: Callable, ctx, /, *args, **kw):
        """One remote dispatch under the recovery policy: retry transient
        worker-loss failures (``AgentDied``/``CallTimeout`` — the next
        ``RemoteWorker.call`` respawns the agent) with jittered backoff,
        feeding the per-host circuit breaker.  A tripped breaker fails
        fast with ``RemoteError(etype="HostDegraded")`` until its cooldown
        probe — repeated failures must degrade the host, not hammer it.

        ``ctx`` is the caller's trace context captured at submit time:
        the whole dispatch (attempts included) records as one child span,
        and :meth:`blit_torch.parallel.remote.RemoteWorker.call` ships the
        span's context over the wire so the agent's spans parent onto it."""
        tr = observability.tracer()
        with tr.activate(ctx), tr.span(
            f"pool.{getattr(fn, '__name__', 'call')}",
            worker=w.wid, host=w.host,
        ):
            return self._remote_call_inner(w, fn, *args, **kw)

    def _remote_call_inner(self, w: _Worker, fn: Callable, /, *args, **kw):
        from blit_torch.parallel.remote import RemoteError

        br = w.breaker
        if not br.allow():
            faults.incr("breaker.fastfail")
            raise RemoteError(
                w.host, "HostDegraded",
                f"circuit open after {br.failures} consecutive failures; "
                f"next probe within {br.cooldown_s}s", "",
            )
        attempts = max(1, self.retry_policy.attempts)
        for attempt in range(attempts):
            try:
                result = w.remote.call(fn, *args, **kw)
            except RemoteError as e:
                if e.etype == "AgentDied":
                    # One of the flight recorder's trip conditions: the
                    # incident evidence — the recent span/stage/fault
                    # ring — is dumped while it is still recent.
                    # Rate-limited inside dump().
                    observability.flight_recorder().dump(
                        f"agent for worker {w.wid} ({w.host}) died: {e}"
                    )
                if br.record_failure():
                    faults.incr("breaker.trip")
                    log.error(
                        "worker %d (%s) tripped its circuit breaker after "
                        "%d consecutive failures (%s); host degraded for "
                        "%.0fs", w.wid, w.host, br.failures, e.etype,
                        br.cooldown_s,
                    )
                    observability.flight_recorder().dump(
                        f"circuit breaker tripped for worker {w.wid} "
                        f"({w.host}) after {br.failures} consecutive "
                        f"failures ({e.etype})"
                    )
                transient = e.etype in ("AgentDied", "CallTimeout")
                # br.closed() is the non-consuming check: once the breaker
                # tripped mid-loop, stop re-dispatching to the sick host.
                if (not transient or attempt == attempts - 1
                        or not br.closed()):
                    raise
                faults.incr("retry.remote")
                log.warning(
                    "worker %d (%s): %s; re-dispatch %d/%d after backoff",
                    w.wid, w.host, e.etype, attempt + 1, attempts - 1,
                )
                self.retry_policy.backoff(attempt)
            else:
                br.record_success()
                return result
        raise AssertionError("unreachable")

    def _submit(self, worker: _Worker, fn: Callable, /, *args, **kw) -> Future:
        """Dispatch one call for ``worker``.  Shared-filesystem backends run
        it anywhere; the remote backend routes it to that worker's host —
        the reference's ``@spawnat worker`` placement (src/gbt.jl:54-57).

        The caller's ambient trace context is captured HERE (the submit
        thread) and re-activated executor-side, so every backend's
        dispatch records as a child span of the operation that
        fanned it out."""
        ctx = observability.tracer().context()
        if worker.remote is not None:
            return self._exec.submit(
                self._remote_call, worker, fn, ctx, *args, **kw)
        if self._exec is None:
            f: Future = Future()
            try:
                f.set_result(
                    _traced_call(ctx, worker.wid, worker.host, fn, args, kw))
            except Exception as e:  # noqa: BLE001 - captured per-call
                f.set_exception(e)
            return f
        return self._exec.submit(
            _traced_call, ctx, worker.wid, worker.host, fn, args, kw)

    def run_on(
        self,
        wids: Sequence[int],
        fn: Callable,
        argtuples: Sequence[tuple],
        kwargs: Optional[dict] = None,
        on_error: str = "raise",
        timeout: Optional[float] = None,
    ) -> List[Any]:
        """One call per (worker, argtuple) pair — the reference's
        ``@spawnat worker fn(args...)`` + ``fetch.`` fan-out/fan-in
        (src/gbt.jl:54-57, 75-78).  Results are ordered like ``wids``.

        ``timeout`` bounds the WHOLE fan-in (seconds, one shared deadline
        across the ordered waits — the calls run concurrently, so waiting
        per-future would let worst-case wall clock grow to
        ``len(wids) * timeout``); a late worker raises ``TimeoutError``
        (or becomes a ``WorkerError`` under ``on_error="capture"``).  The
        remote backend's own call deadline also KILLS the wedged agent
        (blit_torch/parallel/remote.py); for the thread/process backends the
        abandoned call keeps running to completion in the background —
        Python offers no safe cancel."""
        if len(wids) != len(argtuples):
            raise ValueError("wids and argtuples must have the same length")
        bad = [w for w in wids if not 1 <= w <= len(self.workers)]
        if bad:
            # wid 0 is the main process and negative/oversized ids are
            # caller bugs — never let them alias a worker via indexing.
            raise ValueError(f"invalid worker ids {bad}; valid range is "
                             f"1..{len(self.workers)}")
        kwargs = kwargs or {}
        futures = [
            self._submit(self.workers[wid - 1], fn, *args, **kwargs)
            for wid, args in zip(wids, argtuples)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        results: List[Any] = []
        for i, (wid, fut) in enumerate(zip(wids, futures)):
            try:
                results.append(fut.result(timeout=_remaining(deadline)))
            except Exception as e:  # noqa: BLE001
                if isinstance(e, _FutTimeout) and not fut.done():
                    # A pending future past the deadline is OUR fan-in
                    # timeout: normalize to the builtin with the worker
                    # named (on Py < 3.11 concurrent.futures.TimeoutError
                    # is not even the builtin; on 3.11+ it is, but arrives
                    # message-less).  A TimeoutError RAISED BY the worker
                    # fn leaves fut.done() true and passes through as-is.
                    e = TimeoutError(
                        f"worker {wid} ({self.host_of(wid)}): fan-in "
                        f"deadline of {timeout}s exceeded"
                    )
                if on_error == "capture":
                    log.warning("worker %d (%s) failed: %s", wid, self.host_of(wid), e)
                    results.append(WorkerError(wid, self.host_of(wid), e))
                else:
                    # Aborting the fan-in must not leak the rest of the
                    # broadcast as orphaned background work: cancel every
                    # future the executor has not started yet (started
                    # ones run to completion — Python offers no safe
                    # cancel; the timed-out fut itself is in this range).
                    for later in futures[i:]:
                        later.cancel()
                    raise e
        return results

    def broadcast(
        self,
        fn: Callable,
        kwargs_per_worker: Optional[Callable[[_Worker], dict]] = None,
        on_error: str = "raise",
        timeout: Optional[float] = None,
    ) -> List[Any]:
        """Call ``fn`` once on every worker (reference: the getinventories
        fan-out, src/gbt.jl:54-57).  ``timeout`` bounds the whole fan-in
        (one shared deadline) as in :meth:`run_on`."""
        futures = []
        for w in self.workers:
            kw = kwargs_per_worker(w) if kwargs_per_worker else {}
            futures.append(self._submit(w, fn, **kw))
        deadline = None if timeout is None else time.monotonic() + timeout
        results = []
        for i, (w, fut) in enumerate(zip(self.workers, futures)):
            try:
                results.append(fut.result(timeout=_remaining(deadline)))
            except Exception as e:  # noqa: BLE001
                if isinstance(e, _FutTimeout) and not fut.done():
                    e = TimeoutError(  # as in run_on: one catchable type
                        f"worker {w.wid} ({w.host}): fan-in deadline of "
                        f"{timeout}s exceeded"
                    )
                if on_error == "capture":
                    log.warning("worker %d (%s) failed: %s", w.wid, w.host, e)
                    results.append(WorkerError(w.wid, w.host, e))
                else:
                    for later in futures[i:]:  # as in run_on: no orphans
                        later.cancel()
                    raise e
        return results

    def harvest_telemetry(self, timeout: Optional[float] = None,
                          reset: bool = False) -> Dict[str, object]:
        """Pull every worker's telemetry (Timeline state, fault counters,
        spans — :func:`blit_torch.observability.telemetry_snapshot`) and
        fold it with this process's own into ONE per-host-keyed fleet
        report.

        Harvest failures degrade, never abort: a host that cannot answer
        lands under ``report["errors"]`` and the rest of the fleet still
        reports.  ``reset=True`` zeroes each worker's telemetry after
        snapshotting (interval-scrape mode).  The report also carries
        :meth:`health` so a degraded run says so in the same document."""
        results = self.broadcast(
            observability.telemetry_snapshot,
            kwargs_per_worker=lambda w: {"reset": reset},
            on_error="capture", timeout=timeout,
        )
        errors: Dict[str, str] = {}
        snaps = []
        for w, r in zip(self.workers, results):
            if isinstance(r, WorkerError):
                errors[w.host] = repr(r.error)
            else:
                snaps.append(r)
        # This process's own telemetry rides along; with the in-process
        # backends it is the same (host, pid) as the workers' answers and
        # merge_fleet's dedupe counts it once.
        snaps.append(observability.telemetry_snapshot())
        report = observability.merge_fleet(snaps, errors=errors or None)
        report["health"] = self.health()
        return report

    def shutdown(self):
        # Drain in-flight calls BEFORE closing agents — a queued remote call
        # would otherwise respawn an agent nobody closes.
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
        for w in self.workers:
            if w.remote is not None:
                try:
                    w.remote.close()
                except Exception as e:  # noqa: BLE001 — close the rest anyway
                    log.warning("closing agent for %s failed: %s", w.host, e)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


_current: Optional[WorkerPool] = None
# Guards the read-modify-write on _current: two racing setup_workers calls
# must get the SAME pool, not each build (and one leak) a full pool of
# threads/agents.
_current_lock = threading.Lock()


def setup_workers(
    hosts: Optional[Sequence[str]] = None,
    backend: Optional[str] = None,
    config: SiteConfig = DEFAULT,
) -> WorkerPool:
    """Create (or return) the process-wide worker pool.  Thread-safe.

    Reference: ``GBT.setupworkers`` (src/gbt.jl:12-46).  Where the reference
    refuses to run twice and returns an *empty* pid list, blit returns the
    live pool (``blit``'s fix for that wart)."""
    global _current
    with _current_lock:
        if _current is not None:
            log.warning("workers already set up; returning the live pool")
            return _current
        if hosts is None:
            hosts = config.hosts
        _current = WorkerPool(
            hosts, backend=backend or config.backend, config=config
        )
        return _current


def current_pool() -> Optional[WorkerPool]:
    return _current


def reset_pool():
    """Tear down the process-wide pool (tests; elastic re-spawn).
    Thread-safe; the (possibly slow) shutdown happens outside the lock."""
    global _current
    with _current_lock:
        pool, _current = _current, None
    if pool is not None:
        pool.shutdown()
