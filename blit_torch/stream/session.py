"""Whole-session live orchestration, and source specs.

Counterpart of ``blit/stream/session.py``.  One observing session is many
recorder seats (at GBT, 64 ``blc`` nodes, each catching one band's
stream).  A :class:`~blit_torch.recover.StreamSupervisor` keeps one
seat's consumer alive across crash and wedge; :class:`SessionSupervisor`
fans a whole session out: one supervised consumer a seat, each with its
own lease directory and its own
:class:`~blit_torch.stream.cursor.StreamCursor` rejoin (a restarted seat
resumes mid-product, byte-identical to a never-restarted run), all
recording into one session timeline.  While it runs a ``session`` health
hook degrades ``/healthz`` whenever a seat is mid-recovery; the
``session.seats`` / ``session.seats_recovering`` gauges ride the
timeline.

A seat's source is a spec (a JSON-able dict), rebuilt in the consumer
child by :func:`source_from_spec`, with ``blit``'s kinds and keys::

    {"kind": "tail",   "raw": ..., "idle_timeout_s": ..., "done_path": ...}
    {"kind": "replay", "raw": ..., "rate": ...}
    {"kind": "packet", "host": ..., "port": ..., "rcvbuf": ...,
     "horizon": ...}
    {"kind": "packet-replay", "raw": ..., "rate": ..., "packet_ntime":
     ..., "drop": ..., "drop_blocks": [...], "reorder": ...,
     "dup": ..., "seed": ..., "horizon": ...}
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from blit_torch.config import DEFAULT, SiteConfig
from blit_torch.observability import Timeline

log = logging.getLogger("blit_torch.stream")

SOURCE_KINDS = ("tail", "replay", "packet", "packet-replay")


def source_from_spec(spec: Dict, *, timeline: Optional[Timeline] = None,
                     config: SiteConfig = DEFAULT):
    """Build a :class:`~blit_torch.stream.source.ChunkSource` from its spec
    dict (module docstring), so a seat's source survives the trip
    through a JSON spec file or the worker wire."""
    kind = spec.get("kind", "tail")
    if kind == "tail":
        from blit_torch.stream.source import FileTailSource

        return FileTailSource(
            spec["raw"], idle_timeout_s=spec.get("idle_timeout_s"),
            done_path=spec.get("done_path"), config=config)
    if kind == "replay":
        from blit_torch.stream.source import ReplaySource

        return ReplaySource(spec["raw"], rate=spec.get("rate", 1.0))
    if kind == "packet":
        from blit_torch.stream.packet import PacketSource

        return PacketSource(
            spec.get("host"), spec.get("port"),
            rcvbuf=spec.get("rcvbuf"),
            reorder_horizon=spec.get("horizon"),
            timeline=timeline, config=config)
    if kind == "packet-replay":
        from blit_torch.stream.packet import PacketReplaySource

        return PacketReplaySource(
            spec["raw"], rate=spec.get("rate", 1.0),
            packet_ntime=spec.get("packet_ntime"),
            packet_nchan=spec.get("packet_nchan"),
            drop=spec.get("drop"),
            drop_blocks=spec.get("drop_blocks"),
            reorder=spec.get("reorder", 0.0),
            reorder_depth=spec.get("reorder_depth", 4),
            dup=spec.get("dup", 0.0),
            seed=spec.get("seed", 0),
            reorder_horizon=spec.get("horizon"),
            timeline=timeline, config=config)
    raise ValueError(
        f"unknown source kind {kind!r} (one of {SOURCE_KINDS})")


class SessionSupervisor:
    """Run one live session to completion: one supervised consumer a
    seat, concurrently, each rejoinable (module docstring).

    ``seats`` is a list of dicts::

        {"name": "blc00", "out": ".../blc00.fil",
         "source": <source spec>,                  # source_from_spec
         "kind": "reduce" | "search",              # default reduce
         "knobs": {...}, "search": {...},          # consumer knobs
         "lateness_s": ..., "faults": "..."}       # optional

    ``device`` is where the consumers run (the CUDA device by default; a
    seat's ``knobs["device"]`` wins).  Reports ``{"seats": {name:
    report}, "ok", "recovered_seats", "masked_total", "wall_s"}``."""

    def __init__(self, seats: List[Dict], *, work_dir: str,
                 lease_ttl_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 faults: Optional[str] = None,
                 timeline: Optional[Timeline] = None,
                 config: SiteConfig = DEFAULT, device=None):
        if not seats:
            raise ValueError("a session needs at least one seat")
        names = [s.get("name", f"seat{i}") for i, s in enumerate(seats)]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate seat names: {sorted(names)}")
        self.seats = [dict(s, name=n) for s, n in zip(seats, names)]
        self.work_dir = work_dir
        self.lease_ttl_s = lease_ttl_s
        self.poll_s = poll_s
        self.max_attempts = max_attempts
        self.faults = faults
        self.timeline = timeline if timeline is not None else Timeline()
        self.config = config
        self.device = device
        self._phase: Dict[str, str] = {n: "idle" for n in names}
        self._lock = threading.Lock()

    def _health(self) -> Optional[Dict]:
        with self._lock:
            bad = sorted(n for n, p in self._phase.items()
                         if p in ("recovering", "failed"))
        if not bad:
            return None
        return {"degraded": True,
                "reason": f"session seats recovering: {','.join(bad)}"}

    def _seat_supervisor(self, seat: Dict):
        from blit_torch.recover import StreamSupervisor

        src = dict(seat.get("source") or {"kind": "tail"})
        raw = seat.get("raw") or src.get("raw") or ""
        return StreamSupervisor(
            raw, seat["out"], kind=seat.get("kind", "reduce"),
            knobs=seat.get("knobs"), search=seat.get("search"), source=src,
            lateness_s=seat.get("lateness_s"), lease_ttl_s=self.lease_ttl_s,
            poll_s=self.poll_s, max_attempts=self.max_attempts,
            faults=seat.get("faults", self.faults),
            lease_dir=os.path.join(self.work_dir, "leases", seat["name"]),
            timeline=self.timeline, config=self.config, device=self.device)

    def run(self) -> Dict:
        from blit_torch import monitor

        os.makedirs(self.work_dir, exist_ok=True)
        reports: Dict[str, Dict] = {}
        errors: Dict[str, str] = {}

        def seat_main(seat: Dict) -> None:
            name = seat["name"]
            stop = threading.Event()
            t = None
            try:
                sup = self._seat_supervisor(seat)

                def track() -> None:
                    while not stop.is_set():
                        with self._lock:
                            self._phase[name] = sup.state()["phase"]
                        self._gauge_phases()
                        stop.wait(0.1)

                t = threading.Thread(target=track, daemon=True,
                                     name=f"seat-{name}-phase")
                t.start()
                reports[name] = sup.run()
            except Exception as e:  # noqa: BLE001 — folded into the report
                errors[name] = str(e)
                log.error("seat %s failed permanently: %s", name, e)
            finally:
                stop.set()
                if t is not None:
                    t.join(timeout=1.0)
                with self._lock:
                    self._phase[name] = "failed" if name in errors else "done"
                self._gauge_phases()

        monitor.register_health_hook("session", self._health)
        t0 = time.monotonic()
        try:
            with monitor.publishing(self.timeline, config=self.config):
                self.timeline.gauge("session.seats", len(self.seats))
                threads = [threading.Thread(target=seat_main, args=(s,),
                                            daemon=True, name=f"seat-{s['name']}")
                           for s in self.seats]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        finally:
            monitor.unregister_health_hook("session")
        report = self._fold(reports, errors)
        report["wall_s"] = round(time.monotonic() - t0, 3)
        return report

    def _gauge_phases(self) -> None:
        with self._lock:
            rec = sum(1 for p in self._phase.values()
                      if p in ("recovering", "failed"))
        self.timeline.gauge("session.seats_recovering", rec)

    def _fold(self, reports: Dict[str, Dict], errors: Dict[str, str]) -> Dict:
        seats: Dict[str, Dict] = {}
        masked_total = 0
        recovered: List[str] = []
        for s in self.seats:
            name = s["name"]
            rep = reports.get(name)
            if rep is None:
                seats[name] = {"ok": False, "error": errors.get(name, "no report")}
                continue
            res = rep.get("result") or {}
            masked_total += int(res.get("masked") or 0)
            if rep.get("recovered"):
                recovered.append(name)
            seats[name] = {"ok": bool(rep.get("result")),
                           "attempts": len(rep.get("attempts", [])),
                           "recovered": bool(rep.get("recovered")),
                           "result": res}
        ok = all(v.get("ok") for v in seats.values())
        return {"kind": "session", "ok": ok, "seats": seats,
                "recovered_seats": recovered, "masked_total": masked_total}
