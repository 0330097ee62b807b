"""Deterministic fault injection and the recovery-policy primitives.

Counterpart of ``blit/faults.py``, with the same rules, modes, spec
grammar and counters, so a drill written for one package fires on the
same hit counts in the other.

- **Injection** (:class:`FaultRule`, :func:`fire`): a seeded registry of
  named points threaded through the port's I/O: ``guppi.open`` (the
  block index of a RAW file), ``guppi.read`` (every block read, inside
  the retry loop), ``sink.write`` / ``sink.flush`` (each write-behind
  append and flush barrier of :class:`blit_torch.outplane.AsyncSink`,
  keyed by the product path) and ``fbh5.write`` (each ``.h5`` dataset
  write).  Modes: ``fail`` (raise :class:`InjectedFault`, an
  ``OSError``, so retry paths treat it as a flaky read), ``delay``,
  ``truncate`` (a short read), ``corrupt`` (bit-flip the delivered
  frame), ``drop`` / ``dup`` / ``reorder`` (returned for the caller to
  apply), ``kill`` (SIGKILL the process) and ``hang``.  Rules fire on
  exact hit counts (``after`` / ``times``).  ``BLIT_FAULTS`` in the
  environment arms rules at import time.
- **Recovery** (:class:`RetryPolicy`, :func:`retry_call`,
  :func:`retry_io`, :class:`CircuitBreaker`): bounded jittered
  exponential backoff with seeded jitter and an injectable ``sleep``,
  and a per-host circuit breaker.
- **Counters** (:func:`incr` / :func:`counters`): process-wide
  retry / mask / fault totals, each bump also an event of the flight
  recorder.

Imports nothing of the rest of the package at module scope: every layer
may depend on it.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

log = logging.getLogger("blit_torch.faults")

MODES = ("fail", "delay", "truncate", "corrupt", "drop", "dup",
         "kill", "hang", "reorder")


class InjectedFault(OSError):
    """The default injected failure: an ``OSError``, so the transient-I/O
    retry paths classify it exactly like a flaky NFS read."""


# -- counters ---------------------------------------------------------------

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


def incr(name: str, n: int = 1) -> None:
    """Bump a process-wide failure/recovery counter (thread-safe); the
    bump is also an event of the flight recorder's ring."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n
    try:
        from blit_torch.observability import flight_recorder

        flight_recorder().event("fault", name, n=n)
    except Exception:  # noqa: BLE001 — counters must never fail the caller
        pass


def counters() -> Dict[str, int]:
    """Snapshot of all nonzero counters (``retry.io``, ``mask.block``,
    ``fault.<point>.<mode>`` ...)."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


# -- injection registry -----------------------------------------------------


@dataclass
class FaultRule:
    """One armed injection: fire ``mode`` at ``point`` for matching hits
    ``(after, after + times]`` (``times=-1``: every matching hit).

    ``match`` filters by substring of the call site's key (a file path);
    ``sleep`` makes ``delay`` and ``hang`` observable in tests;
    ``amount`` is the samples cut by ``truncate`` (0: half the request);
    ``kill`` replaces the SIGKILL of a ``kill`` rule by a callable."""

    point: str
    mode: str = "fail"
    times: int = 1
    after: int = 0
    match: Optional[str] = None
    exc: type = InjectedFault
    message: str = "injected fault"
    delay_s: float = 0.1
    hang_s: float = 3600.0
    amount: int = 0
    sleep: Callable[[float], None] = time.sleep
    kill: Optional[Callable[[], None]] = None
    # Bookkeeping, under the registry lock.
    hits: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; one of {MODES}")


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.rules: List[FaultRule] = []

    def install(self, *rules: FaultRule) -> None:
        with self._lock:
            self.rules = self.rules + list(rules)

    def clear(self) -> None:
        with self._lock:
            self.rules = []

    def fire(self, point: str, key=None) -> Optional[FaultRule]:
        """Count the hit on every armed rule of ``point``, apply delays,
        raise failures, or return the first destructive rule for the
        caller to apply to its data."""
        todo: List[FaultRule] = []
        with self._lock:
            for r in self.rules:
                if r.point != point:
                    continue
                if r.match is not None and (key is None or r.match not in str(key)):
                    continue
                r.hits += 1
                if r.hits <= r.after:
                    continue
                if r.times >= 0 and r.hits > r.after + r.times:
                    continue
                r.fired += 1
                incr(f"fault.{point}.{r.mode}")
                todo.append(r)
                if r.mode != "delay":
                    break  # the first destructive rule wins
        act = None
        for r in todo:  # applied outside the lock (sleep / raise / kill)
            if r.mode == "delay":
                log.warning("injected delay %.3fs @ %s [%s]", r.delay_s, point, key)
                r.sleep(r.delay_s)
            elif r.mode == "hang":
                log.error("injected hang %.1fs @ %s [%s]", r.hang_s, point, key)
                r.sleep(r.hang_s)
            elif r.mode == "kill":
                log.error("injected SIGKILL @ %s [%s]", point, key)
                if r.kill is not None:
                    r.kill()
                else:
                    import signal

                    os.kill(os.getpid(), signal.SIGKILL)
            elif r.mode == "fail":
                raise r.exc(f"{r.message} @ {point}" + (f" [{key}]" if key else ""))
            else:
                act = r
        return act


_REGISTRY = _Registry()


def install(*rules: FaultRule) -> None:
    """Arm injection rules (appended to any already armed)."""
    _REGISTRY.install(*rules)


def clear() -> None:
    """Disarm every rule (tests pair it with :func:`reset_counters`)."""
    _REGISTRY.clear()


def active() -> List[FaultRule]:
    return list(_REGISTRY.rules)


def fire(point: str, key=None) -> Optional[FaultRule]:
    """The injection call sites' entry point; with no rule armed, one
    attribute read.  May raise (``fail``), sleep (``delay``) or return a
    rule whose ``mode`` the caller applies to its data."""
    if not _REGISTRY.rules:
        return None
    return _REGISTRY.fire(point, key)


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse the ``BLIT_FAULTS`` grammar: semicolon-separated
    ``point:mode[:times][:k=v...]`` with ``k`` in
    ``match/after/times/delay/hang/amount/message``, e.g.
    ``"guppi.read:fail:2:match=ant1;sink.write:fail:after=1"``."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"BLIT_FAULTS entry needs point:mode — {part!r}")
        kw: Dict[str, object] = {"point": fields[0], "mode": fields[1]}
        for f in fields[2:]:
            if "=" not in f:
                kw["times"] = int(f)
                continue
            k, v = f.split("=", 1)
            if k in ("times", "after", "amount"):
                kw[k] = int(v)
            elif k == "delay":
                kw["delay_s"] = float(v)
            elif k == "hang":
                kw["hang_s"] = float(v)
            elif k in ("match", "message"):
                kw[k] = v
            else:
                raise ValueError(f"BLIT_FAULTS: unknown key {k!r} in {part!r}")
        rules.append(FaultRule(**kw))
    return rules


def install_spec(spec: str) -> List[FaultRule]:
    rules = parse_spec(spec)
    install(*rules)
    return rules


if os.environ.get("BLIT_FAULTS"):
    try:
        install_spec(os.environ["BLIT_FAULTS"])
        log.warning("BLIT_FAULTS armed: %s", os.environ["BLIT_FAULTS"])
    except Exception as e:  # noqa: BLE001 — a bad drill spec must be loud
        raise ValueError(
            f"malformed BLIT_FAULTS={os.environ['BLIT_FAULTS']!r}: {e}") from e


# -- retry policy -----------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with bounded attempts.

    ``attempts`` is the total number of tries (1: no retry).  The delay
    of attempt ``k`` is ``min(max_s, base_s * multiplier**k)`` times a
    jitter uniform in ``1 ± jitter``, a pure function of ``(seed, k)``
    when ``seed`` is set.  ``sleep`` is injectable."""

    attempts: int = 3
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep

    def delay_s(self, attempt: int) -> float:
        d = min(self.max_s, self.base_s * self.multiplier ** attempt)
        if self.jitter:
            u = (random.Random(self.seed * 1_000_003 + attempt).random()
                 if self.seed is not None else random.random())
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)

    def backoff(self, attempt: int) -> None:
        d = self.delay_s(attempt)
        try:
            from blit_torch.observability import process_timeline

            process_timeline().observe("retry.backoff_s", d)
        except Exception:  # noqa: BLE001 — telemetry must not break retry
            pass
        self.sleep(d)


# A missing or forbidden file is a caller's fault, never retried.
_NON_TRANSIENT = (FileNotFoundError, PermissionError, IsADirectoryError,
                  NotADirectoryError)


def transient_io(e: BaseException) -> bool:
    """The default transience rule: any ``OSError`` that is not a
    deterministic refusal of the file system."""
    return isinstance(e, OSError) and not isinstance(e, _NON_TRANSIENT)


def retry_call(fn: Callable[[], object], *, policy: RetryPolicy,
               describe: str = "call",
               transient: Callable[[BaseException], bool] = transient_io,
               counter: str = "retry.io"):
    """Run ``fn`` under ``policy``: transient failures back off and
    retry; anything else, and the last attempt's failure, raises."""
    for attempt in range(max(1, policy.attempts)):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if not transient(e) or attempt >= policy.attempts - 1:
                raise
            incr(counter)
            log.warning("%s failed (%s: %s); retry %d/%d in %.3fs", describe,
                        type(e).__name__, e, attempt + 1, policy.attempts - 1,
                        policy.delay_s(attempt))
            policy.backoff(attempt)
    raise AssertionError("unreachable")


_io_policy: Optional[RetryPolicy] = None
_io_policy_lock = threading.Lock()


def io_policy() -> RetryPolicy:
    """The process-wide retry policy of file I/O, from the environment
    (``BLIT_IO_RETRIES`` attempts, ``BLIT_IO_BACKOFF_S``,
    ``BLIT_IO_BACKOFF_MAX_S``) unless :func:`set_io_policy` set one."""
    global _io_policy
    with _io_policy_lock:
        if _io_policy is None:
            _io_policy = RetryPolicy(
                attempts=int(os.environ.get("BLIT_IO_RETRIES", 3)),
                base_s=float(os.environ.get("BLIT_IO_BACKOFF_S", 0.05)),
                max_s=float(os.environ.get("BLIT_IO_BACKOFF_MAX_S", 2.0)),
            )
        return _io_policy


def set_io_policy(policy: Optional[RetryPolicy]) -> None:
    """Install the process-wide I/O retry policy (None: back to the
    environment's)."""
    global _io_policy
    with _io_policy_lock:
        _io_policy = policy


def retry_io(fn: Callable[[], object], describe: str = "io"):
    """Transient-I/O retry under the process-wide policy."""
    return retry_call(fn, policy=io_policy(), describe=describe)


# -- circuit breaker --------------------------------------------------------


class CircuitBreaker:
    """Per-host failure circuit: ``threshold`` consecutive failures open
    it (callers fail fast); after ``cooldown_s`` one probe is let through
    (``half-open``), whose success closes the circuit and whose failure
    opens it again.  ``clock`` is injectable."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, threshold)
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0  # consecutive
        self.trips = 0
        self._opened_at = 0.0
        self._probing = False

    def allow(self) -> bool:
        """May a call go out now?  (Takes the half-open probe slot when
        it grants one.)"""
        with self._lock:
            if self.state == "closed":
                return True
            if (self.state == "open"
                    and self.clock() - self._opened_at >= self.cooldown_s):
                self.state = "half-open"
                self._probing = False
            if self.state == "half-open" and not self._probing:
                self._probing = True
                return True
            return False

    def closed(self) -> bool:
        """Is the circuit fully closed?  (Takes no probe slot.)"""
        with self._lock:
            return self.state == "closed"

    def record_success(self) -> None:
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self._probing = False

    def record_failure(self) -> bool:
        """Count a failure; True when this one opened the circuit."""
        with self._lock:
            self.failures += 1
            if self.state == "half-open" or (
                    self.state == "closed" and self.failures >= self.threshold):
                self.state = "open"
                self._opened_at = self.clock()
                self._probing = False
                self.trips += 1
                return True
            return False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self.state, "consecutive_failures": self.failures,
                    "trips": self.trips}
