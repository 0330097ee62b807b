"""SLO-driven elastic fleet membership.

The fleet serve plane (blit/serve/fleet.py) survives peer death and the
SLO plane (blit/monitor.py) knows when the fleet is melting — but
capacity was a fixed N: the front door could shed load, never add it.
:class:`FleetController` closes that loop, the way the BL@GBT archive
deployment this repo reproduces rides its diurnal observing/release
cycle:

- **Scale-out**: standby peers (``blit fleet-peer --standby`` — process
  up, lease beating, NOT in the ring) are admitted when the burn-rate
  evaluator pages, but only after a **warm handoff**.  The controller
  computes the joiner's incoming key range from the ring delta
  (:meth:`~blit_torch.serve.ring.HashRing.incoming_keys` — by minimal
  movement, the ONLY keys that move), streams the hot entries in
  exactly that range as ``/warm`` hints with a ``wait_s`` ack, and
  flips membership only once the joiner acks warm completion or the
  handoff deadline burns (fail-open: flip anyway — elastic capacity
  NOW beats a warm cache — counting ``elastic.warm_timeout``).
- **Scale-in**: sustained idle — ``idle_windows`` consecutive
  observation ticks under ``idle_rps`` — drains the COLDEST peer
  through the existing deadline-aware drain before retiring it from
  the ring; in-flight requests complete, the leaver's hot range is
  pre-warmed onto its successors, and its pooled keep-alives are
  severed (:meth:`~blit_torch.serve.http.ConnectionPool.evict_peer`).
- **Flap guard**: any resize arms a ``hysteresis_s`` cooldown during
  which further actions are SUPPRESSED (counted
  ``elastic.flap_suppressed``) and the idle counter is reset by any
  page — so a page→idle→page cycle cannot thrash membership (pinned
  by tests/test_elastic.py's hysteresis drill).

While a flip is in progress the door's ``/healthz`` answers an honest
``"resizing"`` status (and :func:`blit_torch.monitor.register_health_hook`
carries the same reason onto every publisher health document) — a
probe that reads "ok" mid-flip would route traffic on stale
membership.  ``elastic.*`` counters and histograms
(:data:`ELASTIC_HISTS`) ride the door's timeline onto ``/metrics`` and
``fleet stats``.

The controller is deliberately single-threaded per tick and mostly
pure over door state: drive :meth:`observe` from tests with a fake
clock, or :meth:`start` the background loop in a deployment.
:meth:`scale_out` / :meth:`scale_in` double as the manual-resize
surface the WORKFLOWS.md runbook reaches for when the operator knows
better than the evaluator.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from blit_torch.config import DEFAULT, SiteConfig, elastic_defaults
from blit_torch.observability import Timeline, flight_recorder
from blit_torch.serve.http import http_json

log = logging.getLogger("blit_torch.serve.elastic")

# The elastic plane's histograms (the FLEET_HISTS convention):
# resize_s is the whole flip — handoff included — per action;
# warm_bytes the product bytes the joiner completed during handoff.
ELASTIC_HISTS = ("elastic.resize_s", "elastic.warm_bytes")


class FleetController:
    """The burn-rate→membership loop (module docstring).

    ``door`` is the :class:`~blit_torch.serve.fleet.FleetFrontDoor` whose
    ring this controller resizes; ``evaluator`` the
    :class:`~blit_torch.monitor.BurnRateEvaluator` whose pages trigger
    scale-out (None = manual/idle-only).  ``feed``, when set to a
    :class:`~blit_torch.observability.Timeline` (usually the door's), makes
    the controller feed the evaluator that timeline's per-tick deltas —
    leave it None when a MetricsPublisher already owns the evaluator's
    diet, or the same interval would be counted twice.  ``terminate``
    is an optional ``(peer_name) -> None`` callable run after a
    scale-in flip — the CLI rig passes SIGTERM-the-child here, matching
    the deadline-aware drain handler peers install."""

    def __init__(self, door, evaluator=None, *,
                 config: SiteConfig = DEFAULT,
                 timeline: Optional[Timeline] = None,
                 feed: Optional[Timeline] = None,
                 terminate: Optional[Callable[[str], None]] = None,
                 idle_rps: Optional[float] = None,
                 idle_windows: Optional[int] = None,
                 hysteresis_s: Optional[float] = None,
                 warm_timeout_s: Optional[float] = None,
                 warm_hints: Optional[int] = None,
                 min_peers: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        d = elastic_defaults(config)
        self.door = door
        self.evaluator = evaluator
        # Default onto the DOOR's timeline so elastic.* counters land
        # on the same /metrics and `fleet stats` surface as fleet.*.
        self.timeline = timeline if timeline is not None else door.timeline
        self.idle_rps = float(idle_rps if idle_rps is not None
                              else d["idle_rps"])
        self.idle_windows = int(idle_windows if idle_windows is not None
                                else d["idle_windows"])
        self.hysteresis_s = float(hysteresis_s if hysteresis_s is not None
                                  else d["hysteresis_s"])
        self.warm_timeout_s = float(
            warm_timeout_s if warm_timeout_s is not None
            else d["warm_timeout_s"])
        self.warm_hints = int(warm_hints if warm_hints is not None
                              else d["warm_hints"])
        self.min_peers = int(min_peers if min_peers is not None
                             else d["min_peers"])
        self.poll_s = float(poll_s if poll_s is not None else d["poll_s"])
        self.drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else d["drain_timeout_s"])
        self.clock = clock
        self._feed = feed
        self._feed_state: Optional[Dict] = None
        self._terminate = terminate
        self._lock = threading.Lock()
        self._resizing: Optional[str] = None
        self._cooldown_until = 0.0
        self._idle_ticks = 0
        self._last_tick: Optional[float] = None
        self._last_requests = self._requests_total()
        self._actions: List[Dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The honest-health satellite: every publisher health document
        # in this process carries the resize phase while a flip runs.
        from blit_torch import monitor

        monitor.register_health_hook("elastic", self._health_hook)

    # -- the observation tick ----------------------------------------------
    def observe(self, interval_s: Optional[float] = None
                ) -> Optional[Dict]:
        """One controller tick (the loop's body; tests and the diurnal
        bench drive it directly): feed the evaluator, judge paging vs
        idle, and resize — unless the flap guard is armed.  Returns the
        action record when a resize happened, else None."""
        now = self.clock()
        if interval_s is not None:
            dt = float(interval_s)
        elif self._last_tick is not None:
            dt = now - self._last_tick
        else:
            dt = self.poll_s
        dt = max(dt, 1e-9)
        self._last_tick = now
        if self._feed is not None and self.evaluator is not None:
            from blit_torch.monitor import _delta_timeline

            delta = _delta_timeline(self._feed, self._feed_state)
            self._feed_state = self._feed.state()
            self.evaluator.observe(delta, dt)
        paging = bool(self.evaluator.breached()) if self.evaluator else False
        reqs = self._requests_total()
        rps = max(0, reqs - self._last_requests) / dt
        self._last_requests = reqs
        if paging or rps > self.idle_rps:
            # Any page — or any real traffic — resets the idle run:
            # scale-in needs SUSTAINED idle, never one quiet tick.
            self._idle_ticks = 0
        else:
            self._idle_ticks += 1
        guarded = now < self._cooldown_until
        if paging and self._pick_standby() is not None:
            if guarded:
                self.timeline.count("elastic.flap_suppressed")
                return None
            return self.scale_out()
        if (self._idle_ticks >= self.idle_windows
                and len(self.door.ring) > self.min_peers):
            if guarded:
                self.timeline.count("elastic.flap_suppressed")
                return None
            self._idle_ticks = 0
            return self.scale_in()
        return None

    def _requests_total(self) -> int:
        row = self.door.timeline.report().get("fleet.requests")
        return int(row["calls"]) if isinstance(row, dict) else 0

    # -- scale-out ---------------------------------------------------------
    def scale_out(self, name: Optional[str] = None) -> Optional[Dict]:
        """Admit one standby after a warm handoff (also the manual
        "the fleet is melting" lever).  ``name`` picks the standby
        (default: first lease-fresh one); returns the action record, or
        None when no admissible standby exists."""
        cand = name if name is not None else self._pick_standby()
        if cand is None:
            return None
        t0 = self.clock()
        self._set_resizing(f"scale-out:{cand}")
        try:
            warm = self._warm_handoff(cand)
            self.door.admit_peer(cand)
        finally:
            self._set_resizing(None)
            self._arm_guard()
        dt = self.clock() - t0
        self.timeline.count("elastic.scale_out")
        self.timeline.observe("elastic.resize_s", dt)
        flight_recorder().event("elastic", "scale_out", peer=cand,
                                hinted=warm["hinted"],
                                completed=warm["completed"],
                                acked=warm["acked"])
        rec = {"action": "scale-out", "peer": cand,
               "resize_s": round(dt, 6), **warm}
        with self._lock:
            self._actions.append(rec)
        log.warning("elastic: scaled OUT %s (%d/%d warm hints "
                    "completed%s)", cand, warm["completed"],
                    warm["hinted"], "" if warm["acked"]
                    else "; handoff timed out, flipped fail-open")
        return rec

    def _warm_handoff(self, joiner: str) -> Dict:
        """Stream the joiner's incoming hot range and wait for its ack:
        the ring delta names exactly the keys that will move, the
        range-scoped hints carry their recipes, and ``wait_s`` makes
        the ``/warm`` answer a completion ack the flip gates on."""
        hints = self.door.warm_hints(limit=self.warm_hints)
        incoming = set(self.door.ring.incoming_keys(
            joiner, [fp for fp, _ in hints]))
        recipes = [r for fp, r in hints if fp in incoming]
        out = {"hinted": len(recipes), "completed": 0, "warm_bytes": 0,
               "acked": True}
        if not recipes:
            return out
        url = self.door._peers[joiner].url
        try:
            status, _, body = http_json(
                "POST", url, "/warm",
                {"recipes": recipes, "wait_s": self.warm_timeout_s,
                 "priority": 2},
                timeout=self.warm_timeout_s + 10.0, pool=self.door.pool)
            doc = body if isinstance(body, dict) else {}
            out["completed"] = int(doc.get("completed", 0) or 0)
            out["warm_bytes"] = int(doc.get("bytes", 0) or 0)
            out["acked"] = (
                status == 202 and not doc.get("timed_out")
                and out["completed"] + int(doc.get("rejected", 0) or 0)
                >= len(recipes))
        except OSError:
            out["acked"] = False
        if out["warm_bytes"]:
            self.timeline.observe("elastic.warm_bytes",
                                  float(out["warm_bytes"]))
        if not out["acked"]:
            # Fail-open (the tentpole contract): a cold joiner serving
            # is strictly better than a paging fleet waiting on warmth.
            self.timeline.count("elastic.warm_timeout")
        return out

    def _pick_standby(self) -> Optional[str]:
        for nm, p in sorted(self.door._peers.items()):
            if p.standby and p.watch.fresh():
                return nm
        return None

    # -- scale-in ----------------------------------------------------------
    def scale_in(self, name: Optional[str] = None) -> Optional[Dict]:
        """Drain and retire one peer (also the manual "the fleet is
        idle" lever).  ``name`` picks the leaver (default: the coldest
        in-ring peer by hot-entry ownership); refuses to go below
        ``min_peers``.  In-flight requests complete inside the drain
        deadline; the leaver's hot range is pre-warmed onto its
        successors; its pooled sockets are severed by
        :meth:`~blit_torch.serve.fleet.FleetFrontDoor.retire_peer`."""
        if name is None:
            victim = self._pick_coldest()
        else:
            victim = name if len(self.door.ring) > self.min_peers else None
        if victim is None:
            return None
        t0 = self.clock()
        self._set_resizing(f"scale-in:{victim}")
        try:
            hinted = self._prewarm_successors(victim)
            drained = self._drain_leaver(victim)
            self.door.retire_peer(victim)
            if self._terminate is not None:
                try:
                    self._terminate(victim)
                except Exception:  # noqa: BLE001 — the flip already won
                    log.warning("elastic: terminate(%s) failed", victim,
                                exc_info=True)
        finally:
            self._set_resizing(None)
            self._arm_guard()
        dt = self.clock() - t0
        self.timeline.count("elastic.scale_in")
        self.timeline.observe("elastic.resize_s", dt)
        flight_recorder().event("elastic", "scale_in", peer=victim,
                                drained=drained, hinted=hinted)
        rec = {"action": "scale-in", "peer": victim, "drained": drained,
               "hinted": hinted, "resize_s": round(dt, 6)}
        with self._lock:
            self._actions.append(rec)
        log.warning("elastic: scaled IN %s (drained=%s, %d hot hints "
                    "handed to successors)", victim, drained, hinted)
        return rec

    def _pick_coldest(self) -> Optional[str]:
        members = self.door.ring.peers()
        if len(members) <= self.min_peers:
            return None
        heat = {nm: 0 for nm in members}
        with self.door._lock:
            hot = list(self.door._hot.items())
        for fp, (hits, _) in hot:
            o = self.door.ring.owner(fp)
            if o in heat:
                heat[o] += hits
        return min(sorted(heat), key=lambda nm: heat[nm])

    def _prewarm_successors(self, victim: str) -> int:
        """Hand the leaver's hot range to its clockwise successors
        BEFORE the drain — the drain-hint machinery aimed at exactly
        the departing keys, so retiring the peer degrades nothing."""
        hints = self.door.warm_hints(limit=self.warm_hints)
        departing = set(self.door.ring.departing_keys(
            victim, [fp for fp, _ in hints]))
        per_peer: Dict[str, List[Dict]] = {}
        for fp, recipe in hints:
            if fp not in departing:
                continue
            heirs = self.door.ring.owners(fp, exclude=(victim,))
            if heirs:
                per_peer.setdefault(heirs[0], []).append(recipe)
        sent = 0
        for nm, recipes in per_peer.items():
            try:
                http_json("POST", self.door._peers[nm].url, "/warm",
                          {"recipes": recipes}, timeout=5.0,
                          pool=self.door.pool)
                sent += len(recipes)
            except OSError:
                pass  # best-effort, like every warm
        return sent

    def _drain_leaver(self, victim: str) -> bool:
        """Deadline-bounded graceful drain: tell the peer to refuse new
        work, then poll its in-flight count to zero.  An unreachable
        peer is as drained as it gets — the flip proceeds."""
        url = self.door._peers[victim].url
        deadline = time.monotonic() + self.drain_timeout_s
        try:
            http_json("POST", url, "/drain", {}, timeout=5.0,
                      pool=self.door.pool)
        except OSError:
            return False
        while time.monotonic() < deadline:
            try:
                st, _, body = http_json("GET", url, "/stats",
                                        timeout=2.0, pool=self.door.pool)
            except OSError:
                return False
            if st != 200 or not isinstance(body, dict):
                return False
            if int(body.get("inflight", 0) or 0) <= 0:
                return True
            time.sleep(min(0.2, max(0.01, self.poll_s / 5)))
        log.warning("elastic: drain of %s timed out after %.1fs",
                    victim, self.drain_timeout_s)
        return False

    # -- flap guard / health -----------------------------------------------
    def _arm_guard(self) -> None:
        self._cooldown_until = self.clock() + self.hysteresis_s
        self.timeline.gauge("elastic.cooldown_s", self.hysteresis_s)

    def _guard_remaining(self) -> float:
        return max(0.0, self._cooldown_until - self.clock())

    def _set_resizing(self, reason: Optional[str]) -> None:
        with self._lock:
            self._resizing = reason
        self.door.resize_reason = reason
        self.timeline.gauge("elastic.resizing",
                            0.0 if reason is None else 1.0)

    def _health_hook(self) -> Dict:
        with self._lock:
            reason = self._resizing
        if reason:
            return {"degraded": True, "reason": reason,
                    "status": "resizing"}
        return {"degraded": False,
                "cooldown_s": round(self._guard_remaining(), 3)}

    # -- surfaces / lifecycle ----------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            resizing = self._resizing
            actions = list(self._actions[-16:])
        return {
            "resizing": resizing,
            "cooldown_s": round(self._guard_remaining(), 3),
            "idle_ticks": self._idle_ticks,
            "idle_windows": self.idle_windows,
            "min_peers": self.min_peers,
            "standbys": [nm for nm, p in sorted(self.door._peers.items())
                         if p.standby],
            "actions": actions,
        }

    def start(self) -> "FleetController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="blit-elastic", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.observe()
            except Exception:  # noqa: BLE001 — the loop must not die
                log.warning("elastic tick failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        from blit_torch import monitor

        monitor.unregister_health_hook("elastic")

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["ELASTIC_HISTS", "FleetController"]
