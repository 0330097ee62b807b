"""The crash-recovery plane: supervised sharded scans, degrade and
resume, live-session rejoin, chaos drills.

Counterpart of ``blit/recover.py``.  A sharded scan is one program over
a pod whose collectives wait forever for a dead peer, and a live
consumer that restarts would lose its session; this module carries the
fault-tolerance contract over to both:

- **detection**: every supervised process refreshes a :class:`Lease`
  file between windows (the ``heartbeat=`` hook of the sharded entry
  points), so a peer that dies (SIGKILL, no farewell) or wedges (a hung
  collective, an injected ``hang``) stops beating and the
  :class:`ScanSupervisor` sees it from outside the pod within the lease
  TTL.  A lease is a :class:`~blit_torch.observability.StallWatchdog`
  whose beat crosses the process boundary through a file's mtime.
- **degrade and resume**: on detection the supervisor SIGKILLs the rest
  of the attempt (the resumable writers fsync data before their cursors
  claim it, so files and cursors are the restart state), re-plans with
  :func:`replan` (a smaller pod over the survivors while every process
  can own whole band rows, else the pool path) and resumes from the
  cursors, byte-identical to an uninterrupted run.
- **live rejoin**: :class:`StreamSupervisor` restarts a killed or hung
  live consumer against the still-recording session with ``resume=True``
  (the :class:`~blit_torch.stream.cursor.StreamCursor`), the same bytes as
  a never-restarted consumer.
- **chaos drills**: the ``kill`` / ``hang`` fault modes
  (:mod:`blit_torch.faults`) at the ``mesh.window`` / ``stream.chunk``
  points, driven by ``python -m blit_torch chaos``.

Children are ``python -m blit_torch.recover <spec.json>`` processes that
import this checkout's ``blit_torch`` and seat their players on the
supervisor's device; a pod of several children on one card runs
``backend="gloo"`` (NCCL seats one rank a card).  Telemetry: the
``recover.detect_s`` / ``recover.resume_s`` histograms and ``recover.*``
counters on the supervisor's Timeline; a supervisor mid-recovery
degrades ``/healthz``.  This module imports no torch in the parent's
watch loop: planning, leases and supervision stay light.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from blit_torch.config import DEFAULT, SiteConfig, recover_defaults
from blit_torch.observability import StallWatchdog, Timeline, hostname

log = logging.getLogger("blit_torch.recover")

# Detection latency (death or wedge → noticed) and recovery latency
# (detection → the re-planned attempt's first progress).
RECOVER_HISTS = ("recover.detect_s", "recover.resume_s")


# -- leases ------------------------------------------------------------------


class Lease:
    """One process's heartbeat lease: a small JSON file refreshed between
    windows whose mtime is the liveness signal (the content is
    diagnostics: pid, host, window).  Written to a temporary and renamed,
    so a reader never parses a torn lease; a SIGKILLed process simply
    stops refreshing it."""

    def __init__(self, lease_dir: str, proc: int):
        os.makedirs(lease_dir, exist_ok=True)
        self.path = self.path_for(lease_dir, proc)
        self.proc = proc
        self._n = 0

    @staticmethod
    def path_for(lease_dir: str, proc: int) -> str:
        return os.path.join(lease_dir, f"proc{proc}.lease")

    def beat(self, window: int = -1) -> None:
        self._n += 1
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"proc": self.proc, "pid": os.getpid(),
                       "host": hostname(), "window": int(window),
                       "n": self._n}, f)
        os.replace(tmp, self.path)


def lease_age_s(lease_dir: str, proc: int,
                now: Optional[float] = None) -> Optional[float]:
    """Seconds since ``proc`` last beat; None before its first beat."""
    try:
        mtime = os.stat(Lease.path_for(lease_dir, proc)).st_mtime
    except OSError:
        return None
    return (time.time() if now is None else now) - mtime


def read_lease(lease_dir: str, proc: int) -> Optional[Dict]:
    try:
        with open(Lease.path_for(lease_dir, proc)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# Two supervisors sharing an output directory never share lease files.
_RUN_SEQ = itertools.count()


def _unique_lease_dir(base: str) -> str:
    return os.path.join(base, ".blit-lease",
                        f"run-{os.getpid()}-{next(_RUN_SEQ)}")


class _LeaseWatch:
    """One child's liveness: a :class:`StallWatchdog` beaten by each
    observed change of the lease's mtime.  The TTL is armed only after
    ``_WARM_BEATS`` beats (the bring-up beat and the first windows, whose
    kernel builds and first allocations are judged against the grace
    budget, like the process group's bring-up); before that the grace
    budget applies.  The beats are counted from the lease's own counter,
    so beats that land between two polls still count.  Size
    ``lease_ttl_s`` above the worst window and the final drain and
    close."""

    _WARM_BEATS = 3

    def __init__(self, lease_dir: str, proc: int, ttl_s: float,
                 grace_s: Optional[float] = None):
        self.lease_dir = lease_dir
        self.proc = proc
        self._ttl_s = ttl_s
        self._grace_s = max(grace_s or ttl_s, ttl_s)
        self.wd = StallWatchdog(
            self._grace_s, f"blit-recover-proc{proc}",
            what="a dead or wedged pod peer stops refreshing its lease")
        self._mtime: Optional[float] = None
        self._beats = 0
        self.seen = False

    def observe(self) -> None:
        """One supervisor poll: stat the lease, beat on change."""
        try:
            m = os.stat(Lease.path_for(self.lease_dir, self.proc)).st_mtime
        except OSError:
            return
        if m != self._mtime:
            self._mtime = m
            self.wd.beat()
            self.seen = True
            lease = read_lease(self.lease_dir, self.proc) or {}
            self._beats = max(self._beats + 1, int(lease.get("n", 0)))
            if self._beats >= self._WARM_BEATS:
                self.wd.timeout_s = self._ttl_s

    def stalled(self) -> bool:
        return self.seen and self.wd.stalled()

    def fresh(self) -> bool:
        return self.seen and not self.wd.stalled()

    def age_s(self) -> float:
        return self.wd.age_s()


LeaseWatch = _LeaseWatch


# -- planning ----------------------------------------------------------------


@dataclass(frozen=True)
class ScanPlan:
    """One attempt's shape: ``mode="sharded"`` runs the scan as an
    ``nprocs``-process pod of ``devices_per_proc`` players each (whole
    band rows a process); ``mode="pool"`` falls back to the pool path."""

    mode: str  # "sharded" | "pool"
    nprocs: int = 0
    devices_per_proc: int = 0


def replan(nband: int, nbank: int, devices_per_proc: Optional[int],
           alive_procs: int) -> ScanPlan:
    """Re-plan a ``(nband, nbank)`` scan over ``alive_procs`` surviving
    hosts of ``devices_per_proc`` players each: the largest process count
    ``p <= alive_procs`` that divides the mesh, gives each process whole
    band rows and fits its share on a host; else the pool path."""
    need = nband * nbank
    cap = devices_per_proc if devices_per_proc else need
    for p in range(min(max(alive_procs, 0), need), 0, -1):
        if need % p:
            continue
        share = need // p
        if share % nbank:
            continue  # a process would split a band row
        if share > cap:
            continue  # more players than a surviving host has
        return ScanPlan("sharded", p, share)
    return ScanPlan("pool")


# -- /healthz ----------------------------------------------------------------

_ACTIVE: Dict[int, Dict] = {}
_ACTIVE_LOCK = threading.Lock()


def _health_state() -> Optional[Dict]:
    """The health hook: degraded while any supervisor of this process is
    mid-recovery."""
    with _ACTIVE_LOCK:
        recovering = [s for s in _ACTIVE.values()
                      if s.get("phase") == "recovering"]
        if not recovering:
            return None
        s = recovering[0]
        return {"degraded": True,
                "reason": f"attempt{s.get('attempt')}-{s.get('plan', '?')}",
                "supervisors": len(recovering)}


def active_supervisors() -> List[Dict]:
    """Every live supervisor's state (the ``/healthz`` detail)."""
    with _ACTIVE_LOCK:
        return [dict(s) for s in _ACTIVE.values()]


def _register(state: Dict) -> int:
    from blit_torch import monitor

    with _ACTIVE_LOCK:
        key = id(state)
        _ACTIVE[key] = state
        monitor.register_health_hook("recover", _health_state)
    return key


def _unregister(key: int) -> None:
    from blit_torch import monitor

    # Under the lock: a finishing supervisor never unhooks a new one.
    with _ACTIVE_LOCK:
        _ACTIVE.pop(key, None)
        if not _ACTIVE:
            monitor.unregister_health_hook("recover")


# -- child processes ---------------------------------------------------------


def _free_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return str(port)


def _spawn_child(spec: Dict, spec_path: str, env: Dict[str, str],
                 log_stem: str) -> subprocess.Popen:
    """One supervised child, ``python -m blit_torch.recover <spec.json>``,
    its output sent to files (a chatty bring-up could fill a pipe and
    wedge it).  The child imports this checkout's ``blit_torch``."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    import blit_torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(blit_torch.__file__)))
    env = dict(env)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    fo = open(log_stem + ".out", "w")
    fe = open(log_stem + ".err", "w")
    p = subprocess.Popen([sys.executable, "-m", "blit_torch.recover", spec_path],
                         env=env, stdout=fo, stderr=fe, text=True)
    fo.close()
    fe.close()
    return p


def _kill(p: subprocess.Popen) -> None:
    """SIGKILL one child and reap it: the abort contract is the crash
    contract (fsync-before-claim), and a graceful path would hide faults
    in it."""
    if p.poll() is None:
        try:
            p.send_signal(signal.SIGKILL)
        except OSError:
            pass
    try:
        p.wait(timeout=10)
    except subprocess.TimeoutExpired:  # pragma: no cover — the kernel's job
        pass


def _device_str(device) -> str:
    from blit_torch.device import resolve_device

    return str(resolve_device(device))


# -- the scan supervisor -----------------------------------------------------


class ScanSupervisor:
    """Supervise a sharded whole-scan reduction or search to completion
    across peer death and hangs (module docstring).

    ``raw_paths`` is the explicit ``[band][bank]`` grid; ``kind`` is
    ``"reduce"`` (a ``.fil`` / ``.h5`` a band) or ``"search"`` (a
    ``.hits`` a player, ``search`` the search knobs).  ``nprocs`` is the
    first attempt's pod size; ``devices_per_proc`` what a surviving host
    offers a re-plan.  ``device`` is where every child seats its players
    (the CUDA device by default); a pod of several children runs gloo,
    since they share the device.  ``faults`` maps a proc
    id to a ``BLIT_FAULTS`` spec armed in that child on attempt 0 only
    (``{"1": "mesh.window:kill:after=1"}``).  :meth:`run` returns the
    drill report: attempts, plans, latencies, products."""

    def __init__(
        self,
        raw_paths: Sequence[Sequence[str]],
        *,
        out_dir: Optional[str] = None,
        out_paths=None,
        kind: str = "reduce",
        nfft: int,
        ntap: int = 4,
        nint: int = 1,
        stokes: str = "I",
        fqav_by: int = 1,
        window: str = "hamming",
        despike: bool = True,
        dtype: str = "float32",
        window_frames: Optional[int] = None,
        max_frames: Optional[int] = None,
        compression: Optional[str] = None,
        search: Optional[Dict] = None,
        nprocs: int = 1,
        devices_per_proc: Optional[int] = None,
        lease_ttl_s: Optional[float] = None,
        poll_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
        grace_s: Optional[float] = None,
        lease_dir: Optional[str] = None,
        faults: Optional[Dict] = None,
        child_env: Optional[Dict[str, str]] = None,
        timeline: Optional[Timeline] = None,
        config: SiteConfig = DEFAULT,
        device=None,
    ):
        if kind not in ("reduce", "search"):
            raise ValueError(f"unknown scan kind {kind!r}")
        self.grid = [list(row) for row in raw_paths]
        self.nband = len(self.grid)
        self.nbank = len(self.grid[0])
        if any(len(r) != self.nbank for r in self.grid):
            raise ValueError("raw_paths must be rectangular")
        self.kind = kind
        self.knobs = dict(
            nfft=nfft, ntap=ntap, nint=nint, stokes=stokes, fqav_by=fqav_by,
            window=window, despike=despike, dtype=dtype,
            max_frames=max_frames, compression=compression)
        self.search = dict(search or {})
        d = recover_defaults(config)
        self.lease_ttl_s = (d["lease_ttl_s"] if lease_ttl_s is None
                            else float(lease_ttl_s))
        self.poll_s = d["poll_s"] if poll_s is None else float(poll_s)
        self.max_attempts = (d["max_attempts"] if max_attempts is None
                             else int(max_attempts))
        self.grace_s = d["grace_s"] if grace_s is None else float(grace_s)
        self.nprocs = max(1, int(nprocs))
        need = self.nband * self.nbank
        self.devices_per_proc = devices_per_proc if devices_per_proc else need
        self.faults = {int(k): v for k, v in (faults or {}).items()}
        self.child_env = dict(child_env or {})
        self.timeline = timeline if timeline is not None else Timeline()
        self.config = config
        self.device = _device_str(device)
        self.wf = self._effective_window_frames(window_frames)
        if out_paths is None:
            if out_dir is None:
                raise ValueError("pass out_dir= or out_paths=")
            os.makedirs(out_dir, exist_ok=True)
            if kind == "search":
                out_paths = [[os.path.join(out_dir, f"band{b}bank{k}.hits")
                              for k in range(self.nbank)]
                             for b in range(self.nband)]
            else:
                ext = "h5" if compression else "fil"
                out_paths = [os.path.join(out_dir, f"band{b}.{ext}")
                             for b in range(self.nband)]
        self.out_paths = out_paths
        if lease_dir is None:
            base = out_dir if out_dir is not None else (
                os.path.dirname(self._flat_out_paths()[0]) or ".")
            lease_dir = _unique_lease_dir(base)
        self.lease_dir = lease_dir
        self._state: Dict = {"kind": kind, "phase": "idle", "attempt": 0,
                             "plan": None}

    # -- planning helpers ---------------------------------------------------
    def _flat_out_paths(self) -> List[str]:
        if self.kind == "search":
            return [p for row in self.out_paths for p in row]
        return list(self.out_paths)

    def _effective_window_frames(self, wf: Optional[int]) -> int:
        """The window every attempt (sharded and pool) shares: the
        dispatch shape is part of the byte-identity contract, so it is
        resolved once, here."""
        from blit_torch.config import default_window_frames, search_defaults

        nint = self.knobs["nint"]
        if wf is None:
            wf = default_window_frames(self.knobs["nfft"])
        wf = max((wf // nint) * nint, nint)
        if self.kind == "search":
            T = self.search.get("window_spectra")
            if not T:
                T = search_defaults(self.config)["window_spectra"]
                self.search["window_spectra"] = T
            unit = T * nint
            wf = max((wf // unit) * unit, unit)
        return wf

    def state(self) -> Dict:
        return dict(self._state)

    # -- execution ----------------------------------------------------------
    def run(self) -> Dict:
        from blit_torch.monitor import publishing

        key = _register(self._state)
        report: Dict = {"kind": self.kind, "attempts": [],
                        "window_frames": self.wf}
        alive = self.nprocs
        pending_detect: Optional[float] = None
        # A previous run's attempt files are noise in this run's report.
        if os.path.isdir(self.lease_dir):
            for name in os.listdir(self.lease_dir):
                if name.endswith((".result.json", ".spec.json", ".out", ".err")):
                    try:
                        os.unlink(os.path.join(self.lease_dir, name))
                    except OSError:
                        pass
        try:
            with publishing(self.timeline, config=self.config):
                for attempt in range(self.max_attempts):
                    plan = replan(self.nband, self.nbank, self.devices_per_proc,
                                  alive)
                    self._state.update(attempt=attempt, plan=plan.mode,
                                       nprocs=plan.nprocs,
                                       phase="recovering" if attempt else "running")
                    self.timeline.count("recover.attempts")
                    rec = self._windows_recomputed() if attempt else 0
                    if rec:
                        self.timeline.count("recover.windows_recomputed", rec)
                    entry = {"attempt": attempt, "plan": plan.mode,
                             "nprocs": plan.nprocs, "windows_recomputed": rec}
                    report["attempts"].append(entry)
                    if plan.mode == "pool":
                        if pending_detect is not None:
                            resume_s = time.monotonic() - pending_detect
                            self.timeline.observe("recover.resume_s", resume_s)
                            entry["resume_s"] = round(resume_s, 4)
                            pending_detect = None
                        log.warning("scan re-planned onto the pool path (%d/%d "
                                    "hosts survive, no mesh forms)", alive,
                                    self.nprocs)
                        report["result"] = self._run_pool()
                        entry["ok"] = True
                        break
                    ok, failure, first_beat = self._run_sharded(plan, attempt)
                    if pending_detect is not None and first_beat:
                        resume_s = first_beat - pending_detect
                        self.timeline.observe("recover.resume_s", resume_s)
                        entry["resume_s"] = round(resume_s, 4)
                        pending_detect = None
                    if ok:
                        entry["ok"] = True
                        report["result"] = self._collect_results(attempt)
                        break
                    entry.update(ok=False, failure=failure)
                    self.timeline.observe("recover.detect_s", failure["detect_s"])
                    self.timeline.count("recover.peer_hung" if failure["why"] == "hung"
                                        else "recover.peer_lost")
                    self._state["phase"] = "recovering"
                    pending_detect = time.monotonic()
                    alive -= 1
                    log.error("pod proc %d %s (detected in %.2fs); re-planning "
                              "on %d surviving host(s)", failure["proc"],
                              failure["why"], failure["detect_s"], alive)
                else:
                    self._state["phase"] = "failed"
                    raise RuntimeError(
                        f"scan not recovered within {self.max_attempts} "
                        f"attempts; see {self.lease_dir} child logs")
            self._state["phase"] = "done"
            report["recovered"] = len(report["attempts"]) > 1
            return report
        finally:
            _unregister(key)

    # -- one sharded attempt -----------------------------------------------
    def _child_env(self, plan: ScanPlan, proc: int, attempt: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.child_env)
        env.pop("BLIT_FAULTS", None)  # only the schedule below arms
        if attempt == 0 and proc in self.faults:
            env["BLIT_FAULTS"] = self.faults[proc]
        return env

    def _run_sharded(self, plan: ScanPlan, attempt: int
                     ) -> Tuple[bool, Optional[Dict], Optional[float]]:
        os.makedirs(self.lease_dir, exist_ok=True)
        for proc in range(plan.nprocs):  # stale leases confuse the aging
            try:
                os.unlink(Lease.path_for(self.lease_dir, proc))
            except OSError:
                pass
        port = _free_port() if plan.nprocs > 1 else ""
        children: Dict[int, subprocess.Popen] = {}
        spec_base = dict(
            kind=self.kind, grid=self.grid, out_paths=self.out_paths,
            mesh_shape=[self.nband, self.nbank], window_frames=self.wf,
            knobs=self.knobs, search=self.search, lease_dir=self.lease_dir,
            nprocs=plan.nprocs, devices_per_proc=plan.devices_per_proc,
            port=port, device=self.device)
        t_launch = time.monotonic()
        first_beat: Optional[float] = None
        try:
            for proc in range(plan.nprocs):
                spec = dict(spec_base, proc=proc, result=os.path.join(
                    self.lease_dir, f"a{attempt}p{proc}.result.json"))
                children[proc] = _spawn_child(
                    spec, os.path.join(self.lease_dir, f"a{attempt}p{proc}.spec.json"),
                    self._child_env(plan, proc, attempt),
                    os.path.join(self.lease_dir, f"a{attempt}p{proc}"))
            watches = {proc: _LeaseWatch(self.lease_dir, proc, self.lease_ttl_s,
                                         self.grace_s)
                       for proc in range(plan.nprocs)}
            done: set = set()
            while True:
                time.sleep(self.poll_s)
                for proc, p in children.items():
                    if proc in done:
                        continue
                    w = watches[proc]
                    w.observe()
                    if w.seen and first_beat is None:
                        first_beat = time.monotonic()
                    rc = p.poll()
                    if rc == 0:
                        done.add(proc)
                        continue
                    if rc is not None:
                        # A dead peer: its lease's age bounds when it died.
                        return False, self._fail(
                            children, proc, "died",
                            w.age_s() if w.seen else time.monotonic() - t_launch,
                            rc=rc), first_beat
                    if w.stalled():
                        # Alive but silent past the lease: wedged.
                        return False, self._fail(children, proc, "hung",
                                                 w.age_s()), first_beat
                    if not w.seen and time.monotonic() - t_launch > self.grace_s:
                        return False, self._fail(
                            children, proc, "hung",
                            time.monotonic() - t_launch), first_beat
                if len(done) == plan.nprocs:
                    return True, None, first_beat
        finally:
            for p in children.values():
                _kill(p)

    def _fail(self, children: Dict[int, subprocess.Popen], proc: int, why: str,
              detect_s: float, rc: Optional[int] = None) -> Dict:
        """Abort the attempt: SIGKILL every peer (their cursors are
        crash-safe) and describe the failure."""
        from blit_torch.observability import flight_recorder

        for other, p in children.items():
            if other != proc:
                _kill(p)
        _kill(children[proc])
        flight_recorder().dump(
            f"supervised scan peer proc{proc} {why} (detected after "
            f"{detect_s:.2f}s); aborting the attempt to degrade and resume")
        return {"proc": proc, "why": why, "detect_s": round(float(detect_s), 4),
                "rc": rc}

    # -- resume bookkeeping -------------------------------------------------
    def _windows_recomputed(self) -> int:
        """Windows the next attempt re-runs: each product's claimed
        progress beyond the pod-agreed, window-aligned restart."""
        nint = self.knobs["nint"]
        if self.kind == "search":
            from blit_torch.search.dedoppler import SearchCursor

            done = []
            for row in self.out_paths:
                for p in row:
                    cur = SearchCursor.load(p)
                    done.append(cur.windows_done if cur else 0)
            if not done:
                return 0
            unit = self.search["window_spectra"] * nint
            swin = self.wf // unit
            agreed = (min(done) // swin) * swin
            return sum(d - agreed for d in done)
        from blit_torch.pipeline import ReductionCursor

        done = []
        for p in self.out_paths:
            cur = ReductionCursor.load(p)
            done.append(cur.frames_done if cur else 0)
        if not done:
            return 0
        agreed = (min(done) // self.wf) * self.wf
        return sum((d - agreed + self.wf - 1) // self.wf for d in done)

    def _collect_results(self, attempt: int) -> Dict:
        """The successful attempt's per-process result files, folded."""
        out: Dict = {}
        prefix = f"a{attempt}p"
        for name in sorted(os.listdir(self.lease_dir)):
            if name.startswith(prefix) and name.endswith(".result.json"):
                try:
                    with open(os.path.join(self.lease_dir, name)) as f:
                        out.update(json.load(f))
                except (OSError, ValueError):
                    continue
        return out

    # -- the pool path ------------------------------------------------------
    def _run_pool(self) -> Dict:
        """The pool path as the last degrade: a reducer a player, no mesh,
        products byte-identical to the sharded plane's at the shared
        ``window_frames``.  The search resumes each player's cursor; the
        reduction re-runs whole bands and clears the stale cursors."""
        k = self.knobs
        if self.kind == "search":
            from blit_torch.search.dedoppler import DedopplerReducer

            out: Dict = {}
            for b, row in enumerate(self.grid):
                for bank, rp in enumerate(row):
                    red = DedopplerReducer(
                        nfft=k["nfft"], ntap=k["ntap"], nint=k["nint"],
                        window=k["window"], dtype=k["dtype"],
                        chunk_frames=self.wf, timeline=self.timeline,
                        device=self.device,
                        **{kk: vv for kk, vv in self.search.items()
                           if kk in ("window_spectra", "top_k",
                                     "snr_threshold", "max_drift_bins")})
                    hdr = red.search_resumable(rp, self.out_paths[b][bank])
                    out[f"{b},{bank}"] = {"path": self.out_paths[b][bank],
                                          "windows": hdr.get("search_windows"),
                                          "nhits": hdr.get("search_nhits")}
            return out
        from blit_torch.parallel.scan import reduce_scan_pool_to_files
        from blit_torch.pipeline import ReductionCursor

        written = reduce_scan_pool_to_files(
            self.grid, out_paths=self.out_paths, nfft=k["nfft"], ntap=k["ntap"],
            nint=k["nint"], stokes=k["stokes"], fqav_by=k["fqav_by"],
            window=k["window"], despike=k["despike"], dtype=k["dtype"],
            max_frames=k["max_frames"], window_frames=self.wf,
            compression=k["compression"], timeline=self.timeline,
            device=self.device)
        for p in self.out_paths:
            try:
                os.unlink(ReductionCursor.path_for(p))
            except OSError:
                pass
        return {str(b): {"path": path, "nsamps": hdr.get("nsamps")}
                for b, (path, hdr) in written.items()}


# -- the stream supervisor ---------------------------------------------------


class StreamSupervisor:
    """Supervise one live consumer (``stream_reduce`` /
    ``stream_search``) to completion across crash and wedge: the consumer
    runs as a child with ``resume=True`` and a lease beat on every
    append; a dead or hung consumer is killed and restarted against the
    still-recording session, rejoining through its
    :class:`~blit_torch.stream.cursor.StreamCursor` (the same bytes as a
    never-restarted consumer).  ``faults`` arms a ``BLIT_FAULTS`` spec in
    the first attempt only; ``device`` is the consumer's (the CUDA device
    by default)."""

    def __init__(self, raw: str, out_path: str, *, kind: str = "reduce",
                 knobs: Optional[Dict] = None, search: Optional[Dict] = None,
                 replay_rate: Optional[float] = None,
                 lateness_s: Optional[float] = None,
                 idle_timeout_s: Optional[float] = None,
                 done_path: Optional[str] = None,
                 source: Optional[Dict] = None,
                 lease_ttl_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 grace_s: Optional[float] = None,
                 lease_dir: Optional[str] = None,
                 faults: Optional[str] = None,
                 child_env: Optional[Dict[str, str]] = None,
                 timeline: Optional[Timeline] = None,
                 config: SiteConfig = DEFAULT, device=None):
        if kind not in ("reduce", "search"):
            raise ValueError(f"unknown stream kind {kind!r}")
        self.raw = raw
        self.out_path = out_path
        self.kind = kind
        self.knobs = dict(knobs or {})
        self.knobs.setdefault("device", _device_str(device))
        self.search = dict(search or {})
        self.replay_rate = replay_rate
        self.lateness_s = lateness_s
        self.idle_timeout_s = idle_timeout_s
        self.done_path = done_path
        # A source spec overrides raw / replay_rate / the tail knobs.
        self.source = dict(source) if source else None
        d = recover_defaults(config)
        self.lease_ttl_s = (d["lease_ttl_s"] if lease_ttl_s is None
                            else float(lease_ttl_s))
        self.poll_s = d["poll_s"] if poll_s is None else float(poll_s)
        self.max_attempts = (d["max_attempts"] if max_attempts is None
                             else int(max_attempts))
        self.grace_s = d["grace_s"] if grace_s is None else float(grace_s)
        self.faults = faults
        self.child_env = dict(child_env or {})
        self.timeline = timeline if timeline is not None else Timeline()
        self.config = config
        self.lease_dir = (lease_dir if lease_dir is not None
                          else _unique_lease_dir(os.path.dirname(out_path) or "."))
        self._state: Dict = {"kind": f"stream-{kind}", "phase": "idle",
                             "attempt": 0}

    def state(self) -> Dict:
        return dict(self._state)

    def run(self) -> Dict:
        from blit_torch.monitor import publishing

        key = _register(self._state)
        report: Dict = {"kind": f"stream-{self.kind}", "attempts": []}
        pending_detect: Optional[float] = None
        try:
            with publishing(self.timeline, config=self.config):
                for attempt in range(self.max_attempts):
                    self._state.update(attempt=attempt,
                                       phase="recovering" if attempt else "running")
                    self.timeline.count("recover.attempts")
                    entry: Dict = {"attempt": attempt}
                    report["attempts"].append(entry)
                    ok, failure, first_beat = self._run_attempt(attempt)
                    if pending_detect is not None and first_beat:
                        resume_s = first_beat - pending_detect
                        self.timeline.observe("recover.resume_s", resume_s)
                        entry["resume_s"] = round(resume_s, 4)
                        pending_detect = None
                    if ok:
                        entry["ok"] = True
                        result = os.path.join(self.lease_dir,
                                              f"a{attempt}s.result.json")
                        try:
                            with open(result) as f:
                                report["result"] = json.load(f)
                        except (OSError, ValueError):
                            pass
                        break
                    entry.update(ok=False, failure=failure)
                    self.timeline.observe("recover.detect_s", failure["detect_s"])
                    self.timeline.count("recover.consumer_hung"
                                        if failure["why"] == "hung"
                                        else "recover.consumer_lost")
                    self._state["phase"] = "recovering"
                    pending_detect = time.monotonic()
                    log.error("live consumer %s (detected in %.2fs); rejoining "
                              "the session", failure["why"], failure["detect_s"])
                else:
                    self._state["phase"] = "failed"
                    raise RuntimeError(f"live consumer not recovered within "
                                       f"{self.max_attempts} attempts")
            self._state["phase"] = "done"
            report["recovered"] = len(report["attempts"]) > 1
            return report
        finally:
            _unregister(key)

    def _run_attempt(self, attempt: int
                     ) -> Tuple[bool, Optional[Dict], Optional[float]]:
        os.makedirs(self.lease_dir, exist_ok=True)
        try:
            os.unlink(Lease.path_for(self.lease_dir, 0))
        except OSError:
            pass
        env = dict(os.environ)
        env.update(self.child_env)
        env.pop("BLIT_FAULTS", None)
        if attempt == 0 and self.faults:
            env["BLIT_FAULTS"] = self.faults
        spec = dict(
            kind=f"stream-{self.kind}", raw=self.raw, out_path=self.out_path,
            knobs=self.knobs, search=self.search, replay_rate=self.replay_rate,
            lateness_s=self.lateness_s, idle_timeout_s=self.idle_timeout_s,
            done_path=self.done_path, source=self.source,
            lease_dir=self.lease_dir, proc=0,
            result=os.path.join(self.lease_dir, f"a{attempt}s.result.json"))
        p = _spawn_child(spec, os.path.join(self.lease_dir, f"a{attempt}s.spec.json"),
                         env, os.path.join(self.lease_dir, f"a{attempt}s"))
        t_launch = time.monotonic()
        first_beat: Optional[float] = None
        w = _LeaseWatch(self.lease_dir, 0, self.lease_ttl_s, self.grace_s)
        try:
            while True:
                time.sleep(self.poll_s)
                w.observe()
                if w.seen and first_beat is None:
                    first_beat = time.monotonic()
                rc = p.poll()
                if rc == 0:
                    return True, None, first_beat
                if rc is not None:
                    return False, {
                        "proc": 0, "why": "died", "rc": rc,
                        "detect_s": round(w.age_s() if w.seen
                                          else time.monotonic() - t_launch, 4),
                    }, first_beat
                if w.stalled():
                    _kill(p)
                    return False, {"proc": 0, "why": "hung",
                                   "detect_s": round(w.age_s(), 4)}, first_beat
                if not w.seen and time.monotonic() - t_launch > self.grace_s:
                    _kill(p)
                    return False, {"proc": 0, "why": "hung",
                                   "detect_s": round(time.monotonic() - t_launch, 4),
                                   }, first_beat
        finally:
            _kill(p)


# -- the supervised child ----------------------------------------------------


def _child_scan(spec: Dict) -> Dict:
    from blit_torch.parallel import mesh as M
    from blit_torch.parallel import multihost

    dev = spec["device"]
    # A rendezvous port means a pod: one process with a port still
    # builds its group, and its collectives run.  The supervisor's pods
    # are gloo; a spec written by hand may name "nccl" (one rank a card).
    if spec.get("port"):
        multihost.init_multihost(
            coordinator_address=f"127.0.0.1:{spec['port']}",
            num_processes=spec["nprocs"], process_id=spec["proc"],
            backend=spec.get("backend", "gloo"), device=dev)
    nband, nbank = spec["mesh_shape"]
    mesh = M.make_mesh(nband, nbank, devices=[dev] * spec["devices_per_proc"])
    lease = Lease(spec["lease_dir"], spec["proc"])
    lease.beat(-1)  # bring-up marker: the process group is up
    k = spec["knobs"]
    tl = Timeline()
    common = dict(out_paths=spec["out_paths"], nfft=k["nfft"], ntap=k["ntap"],
                  nint=k["nint"], dtype=k["dtype"], max_frames=k["max_frames"],
                  window_frames=spec["window_frames"], mesh=mesh, resume=True,
                  heartbeat=lease.beat, timeline=tl)
    if spec["kind"] == "search":
        from blit_torch.parallel.sharded import search_scan_sharded_to_files

        s = spec["search"]
        written = search_scan_sharded_to_files(
            spec["grid"], window=k["window"],
            window_spectra=s.get("window_spectra"), top_k=s.get("top_k"),
            snr_threshold=s.get("snr_threshold"),
            max_drift_bins=s.get("max_drift_bins"), **common)
        out = {f"{b},{bank}": {"path": path, "windows": hdr.get("search_windows")}
               for (b, bank), (path, hdr) in written.items()}
    else:
        from blit_torch.parallel.sharded import reduce_scan_sharded_to_files

        written = reduce_scan_sharded_to_files(
            spec["grid"], stokes=k["stokes"], fqav_by=k["fqav_by"],
            window=k["window"], despike=k["despike"],
            compression=k["compression"], **common)
        out = {str(b): {"path": path, "nsamps": hdr.get("nsamps")}
               for b, (path, hdr) in written.items()}
    rep = tl.report()
    out[f"proc{spec['proc']}"] = {
        "backend": multihost.backend(), "players": len(mesh.local_players()),
        "hists": {h: v for h, v in rep.get("hists", {}).items()
                  if h.startswith("mesh.")},
        "host_stage_bytes": tl.stages["mesh.host_stage"].bytes}
    multihost.shutdown()
    return out


def _child_stream(spec: Dict) -> Dict:
    from blit_torch.stream import FileTailSource, ReplaySource
    from blit_torch.stream.session import source_from_spec

    lease = Lease(spec["lease_dir"], spec["proc"])
    lease.beat(-1)
    if spec.get("source"):
        src = source_from_spec(spec["source"])
    elif spec.get("replay_rate"):
        src = ReplaySource(spec["raw"], rate=spec["replay_rate"])
    else:
        src = FileTailSource(spec["raw"], idle_timeout_s=spec.get("idle_timeout_s"),
                             done_path=spec.get("done_path"))
    hb = lease.beat
    k = dict(spec["knobs"])
    if spec["kind"] == "stream-search":
        from blit_torch.stream import stream_search

        hdr = stream_search(src, spec["out_path"], resume=True, heartbeat=hb,
                            lateness_s=spec.get("lateness_s"), **k,
                            **spec["search"])
        out = {"out": spec["out_path"], "windows": hdr.get("search_windows"),
               "nhits": hdr.get("search_nhits"),
               "masked": hdr.get("stream_masked_chunks")}
    else:
        from blit_torch.stream import stream_reduce

        hdr = stream_reduce(src, spec["out_path"], resume=True, heartbeat=hb,
                            lateness_s=spec.get("lateness_s"), **k)
        out = {"out": spec["out_path"], "nsamps": hdr.get("nsamps"),
               "masked": hdr.get("stream_masked_chunks")}
    if hasattr(src, "packet_report"):
        out["packet"] = src.packet_report()
    return out


def _child_main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["kind"].startswith("stream"):
        result = _child_stream(spec)
    else:
        result = _child_scan(spec)
    tmp = spec["result"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, spec["result"])
    print("RECOVER-CHILD-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1]))
