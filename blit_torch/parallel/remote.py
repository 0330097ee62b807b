"""Remote worker transport: one ``blit_torch.agent`` subprocess per host
over ssh.

Counterpart of ``blit/parallel/remote.py``: the reference's
``Distributed.addprocs(hosts; tunnel=true)`` star topology
(src/gbt.jl:28-34).  The main process starts one agent per host, ships
``(function, args)`` requests, and gathers pickled results; ssh provides
the authenticated byte stream as it does for Distributed.jl, and there
are no worker↔worker channels.

``RemoteWorker`` is used by :class:`blit_torch.parallel.pool.WorkerPool`
with ``backend="remote"``.  Tests and single-machine runs use a local
``python -m blit_torch.agent`` transport (:func:`local_agent_command`,
no sshd needed); production uses :func:`ssh_command`.  On a GPU host
each agent holds its own CUDA context and runs the worker functions on
its card.
"""

from __future__ import annotations

import logging
import os
import pickle
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

from blit_torch import faults, observability
from blit_torch.agent import MAGIC, _SAFE_GLOBALS_RESPONSE, read_msg, write_msg

log = logging.getLogger("blit_torch.remote")

# Max bytes of ssh/rc banner noise tolerated before the agent's handshake.
_BANNER_SCAN_LIMIT = 1 << 16


def _await_banner(stream, host: str) -> None:
    """Consume bytes until the agent's MAGIC handshake appears (discarding
    any login-shell banner a remote rc file printed), or fail loudly."""
    window = b""
    scanned = 0
    while True:
        b = stream.read(1)
        if not b:
            raise RemoteError(
                host, "AgentDied",
                f"agent stream closed before handshake (scanned {scanned}B)",
                "",
            )
        scanned += 1
        window = (window + b)[-len(MAGIC):]
        if window == MAGIC:
            if scanned > len(MAGIC):
                log.info("%s: skipped %dB of pre-handshake banner",
                         host, scanned - len(MAGIC))
            return
        if scanned > _BANNER_SCAN_LIMIT:
            raise RemoteError(
                host, "NoHandshake",
                f"no agent handshake within {_BANNER_SCAN_LIMIT}B — is "
                "blit_torch importable on the remote host?", "",
            )


class RemoteError(RuntimeError):
    """A worker-side exception, carrying the remote type/message/traceback."""

    def __init__(self, host: str, etype: str, msg: str, tb: str):
        super().__init__(f"[{host}] {etype}: {msg}")
        self.host = host
        self.etype = etype
        self.remote_traceback = tb


def ssh_command(
    host: str,
    python: str = "python3",
    ssh_opts: Sequence[str] = ("-o", "BatchMode=yes"),
    remote_env: Optional[dict] = None,
) -> List[str]:
    """The production transport: ``ssh <host> <python> -m blit_torch.agent``.

    blit_torch must be importable on the remote host (the packaged
    install, pyproject.toml, is the analog of the reference's shared
    ``@BLDistributedDataProducts`` project environment, src/gbt.jl:17);
    :func:`agent_env_with_repo` covers uninstalled checkouts.

    ``remote_env`` entries are injected as an ``env K=V ...`` prefix in
    the REMOTE command — sshd does not forward arbitrary client
    environment variables, so identity stamps like ``BLIT_WORKER_ID``
    must ride the command line to reach the agent."""
    prefix: List[str] = []
    if remote_env:
        prefix = ["env"] + [f"{k}={v}" for k, v in sorted(remote_env.items())]
    return ["ssh", *ssh_opts, host, *prefix, python, "-m", "blit_torch.agent"]


def local_agent_command() -> List[str]:
    """In-host transport (tests; single-machine use): the same agent,
    spawned directly."""
    return [sys.executable, "-m", "blit_torch.agent"]


class RemoteWorker:
    """One agent subprocess + the request/response framing to talk to it.

    One outstanding call at a time (guarded by a lock), matching the
    reference's one-``@spawnat``-per-worker usage; the pool's thread
    executor provides cross-worker concurrency.

    Liveness is bounded two ways (SURVEY.md §5 "health-checked worker
    pool" — the reference's blocking ``fetch`` has neither):

    - every call runs under a ``call_timeout`` deadline enforced by a
      watchdog that KILLS the agent when it fires (the only way to unblock
      a read from a wedged-but-alive transport: hung NFS under the worker
      fn, a stuck ssh, a partitioned network).  The caller gets a
      ``RemoteError(etype="CallTimeout")`` and the next use respawns.
    - reusing a live agent first round-trips a ``blit_torch.agent.ping`` under
      the (much shorter) ``ping_timeout``; an agent that cannot answer is
      killed and respawned BEFORE the real request is committed to it.

    ``call_timeout=None`` (the default — the reference's blocking behavior)
    disables the deadline: worker functions legitimately stream multi-GB
    files for hours, so kill-on-deadline is opt-in, sized by the caller
    above their largest sanctioned workload.  The reuse-time ping still
    applies either way.
    """

    def __init__(self, host: str, command: Optional[Sequence[str]] = None,
                 env: Optional[dict] = None,
                 call_timeout: Optional[float] = None,
                 ping_timeout: Optional[float] = 30.0,
                 ping_min_idle: float = 5.0):
        self.host = host
        self.command = list(command) if command else ssh_command(host)
        self.call_timeout = call_timeout
        self.ping_timeout = ping_timeout
        # Skip the reuse-time ping when the agent answered this recently —
        # a chatty fan-out must not pay 2x the WAN round trips; the ping is
        # for agents that have sat idle long enough to have wedged.
        self.ping_min_idle = ping_min_idle
        self._last_ok = float("-inf")  # monotonic time of last good reply
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._env = env

    def _spawn(self) -> subprocess.Popen:
        proc = subprocess.Popen(
            self.command,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=self._env,
        )
        try:
            _await_banner(proc.stdout, self.host)
        except BaseException:
            # A live-but-unframed process (ssh stuck at a prompt, rc noise
            # past the scan limit) must not be left as self._proc — the
            # next call would waste a full ping_timeout probing it.
            proc.kill()
            proc.wait()
            self._proc = None
            raise
        self._proc = proc
        log.info("agent for %s started (pid %d)", self.host, proc.pid)
        return proc

    def _kill_reap(self, proc: subprocess.Popen) -> None:
        proc.kill()
        proc.wait()
        self._proc = None

    def _ensure(self) -> subprocess.Popen:
        if self._proc is None or self._proc.poll() is not None:
            return self._spawn()
        # Reused agent that has sat idle past ping_min_idle: health-check it
        # with the cheapest full-path round trip before committing the real
        # request.  A fresh spawn needs no ping — the banner handshake just
        # proved the path — and a recently-responsive agent skips it too.
        if self.ping_timeout and (
            time.monotonic() - self._last_ok > self.ping_min_idle
        ):
            proc = self._proc
            try:
                reply = self._transact(
                    proc, ("blit_torch.agent.ping", (), {}), "ping",
                    self.ping_timeout,
                )
                # ANY well-formed reply proves the agent alive and framed —
                # including ("err", ...) from an older remote agent without
                # agent.ping() (killing+respawning there would degrade every
                # call to a full ssh round trip forever).
                alive = (
                    isinstance(reply, tuple) and reply
                    and reply[0] in ("ok", "err")
                )
                if alive and self._proc is proc:
                    if reply[0] == "err":
                        log.info(
                            "%s: remote agent lacks ping (%s); agent "
                            "alive, continuing", self.host, reply[1],
                        )
                    return proc
                log.warning("%s: unexpected ping reply %r; respawning",
                            self.host, reply)
            except RemoteError as e:
                log.warning("%s: agent failed health check (%s); respawning",
                            self.host, e.etype)
            if self._proc is proc:  # _transact may already have reaped it
                self._kill_reap(proc)
            return self._spawn()
        return self._proc

    def _transact(self, proc: subprocess.Popen, request: tuple,
                  fn_path: str, timeout: Optional[float]):
        """One write+read exchange under a kill-on-deadline watchdog.

        Blocking pipe reads cannot be cancelled portably; killing the agent
        makes them fail with EOF/BrokenPipe, which is mapped to
        ``CallTimeout`` when the watchdog fired (vs ``AgentDied`` when the
        agent really died on its own)."""
        timed_out = threading.Event()
        done = threading.Event()
        # Serializes the reply-landed / deadline-fired decision: exactly one
        # of {done, timed_out} is set first, and the other side observes it
        # (a bare check-then-kill would let a preempted _fire kill a healthy
        # agent AFTER the success path declared no timeout).
        verdict = threading.Lock()
        timer = None
        if timeout is not None:
            def _fire(p=proc):
                with verdict:
                    if done.is_set():  # reply landed first; stand down
                        return
                    timed_out.set()
                if fn_path == "ping":
                    # Routine self-healing: _ensure logs the respawn at
                    # WARNING and the remedy knob is ping_timeout, not
                    # call_timeout — don't raise a spurious ERROR here.
                    log.debug("%s: ping watchdog fired after %ss",
                              self.host, timeout)
                else:
                    # Prominent by design: a deadline sized
                    # below a legitimate long call would otherwise kill
                    # healthy work with only an exception in some caller's
                    # future to show for it.
                    log.error(
                        "%s: call watchdog fired after %ss during %s — "
                        "killing agent (raise call_timeout if this call "
                        "was healthy)",
                        self.host, timeout, fn_path,
                    )
                try:
                    p.kill()
                except OSError:
                    pass

            timer = threading.Timer(timeout, _fire)
            timer.daemon = True
            timer.start()
        try:
            write_msg(proc.stdin, request)
            # Responses get the narrower allow-list: no ``re._compile``
            # (a compromised peer must not hand the client a pathological
            # regex; results are arrays/records/dicts only).  No drain on
            # oversize either — the refusal below kills the worker, so
            # pulling a multi-GiB body through the ssh pipe first would
            # be pure waste.
            reply = read_msg(
                proc.stdout,
                safe_globals=_SAFE_GLOBALS_RESPONSE,
                drain_oversized=False,
            )
            with verdict:
                done.set()
                fired = timed_out.is_set()
            if fired:
                # The watchdog fired while the reply was mid-flight: the
                # reply is whole (the frame read completed) but the agent
                # is dead — reap it so the next use respawns instead of
                # surfacing a spurious AgentDied.
                self._kill_reap(proc)
            else:
                self._last_ok = time.monotonic()
            return reply
        except (BrokenPipeError, EOFError, OSError) as e:
            try:
                rc = proc.wait(timeout=5)  # reap; no zombie
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            self._proc = None
            if timed_out.is_set():
                raise RemoteError(
                    self.host, "CallTimeout",
                    f"no reply to {fn_path} within {timeout}s; agent killed "
                    "(will respawn on next use)", "",
                ) from e
            raise RemoteError(
                self.host, "AgentDied",
                f"agent exited (rc={rc}) during {fn_path}: {e}", "",
            ) from e
        except pickle.UnpicklingError as e:
            # A refused response (oversized / disallowed global) means
            # the peer is misbehaving or compromised; don't trust the
            # stream again — kill and respawn on next use.
            self._kill_reap(proc)
            raise RemoteError(
                self.host, "WireRefused",
                f"response refused during {fn_path}: {e}", "",
            ) from e
        finally:
            if timer is not None:
                timer.cancel()

    def call(self, fn: Callable, *args, **kwargs):
        """Invoke ``fn`` (a blit_torch callable) on the remote host,
        bounded by ``call_timeout``.

        Trace propagation: when the calling thread is inside a
        span, its ``{"trace", "span"}`` context rides the request as the
        reserved ``_blit_trace`` kwarg — :func:`blit_torch.agent.serve` strips
        it before invoking the worker function and opens the worker-side
        span under it, so the fan-out's remote spans parent onto the
        caller's."""
        fn_path = f"{fn.__module__}.{fn.__qualname__}"
        ctx = observability.tracer().context()
        if ctx is not None:
            kwargs = dict(kwargs)
            kwargs["_blit_trace"] = ctx
        try:
            # Transport-level injection point: a "fail" rule here looks to
            # the pool exactly like the agent dying mid-call (the retry /
            # circuit-breaker path); a "delay" rule models a slow dispatch
            # (it runs BEFORE the _transact watchdog is armed, so it can
            # never fire call_timeout — drill CallTimeout with a wedged
            # agent instead).
            faults.fire("remote.call", key=self.host)
        except Exception as e:  # noqa: BLE001 — injected
            raise RemoteError(
                self.host, "AgentDied", f"injected fault: {e}", ""
            ) from e
        with self._lock:
            proc = self._ensure()
            reply = self._transact(
                proc, (fn_path, args, kwargs), fn_path, self.call_timeout
            )
        if reply[0] == "ok":
            return reply[1]
        _tag, etype, msg, tb = reply
        raise RemoteError(self.host, etype, msg, tb)

    def close(self) -> None:
        with self._lock:
            if self._proc is not None:
                try:
                    if self._proc.stdin:
                        self._proc.stdin.close()  # EOF → agent loop returns
                    self._proc.wait(timeout=10)
                except (subprocess.TimeoutExpired, OSError):
                    # A wedged transport (e.g. partitioned ssh) must not
                    # block or abort shutdown — kill and reap.
                    self._proc.kill()
                    self._proc.wait()
                finally:
                    self._proc = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def agent_env_with_repo() -> dict:
    """Subprocess env whose PYTHONPATH can import this checkout's
    blit_torch (local agents in tests and on a GPU host; installed
    deployments don't need it)."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env
