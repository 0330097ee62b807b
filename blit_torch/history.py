"""The history store and incident forensics (``blit``'s plane, host code).

- :class:`HistoryStore`: tiered rings fed by
  :class:`~blit_torch.monitor.MetricsPublisher` ticks.  A tier is one
  fixed-size file of fixed-width slots (raw interval, minute and hour
  buckets); a bucket folds the tick deltas of its window (stage calls /
  seconds / bytes, raw histogram states, gauge envelopes, per-objective
  SLO ``(bad, total)``).  Slots are addressed by time, so the oldest
  bucket is overwritten in place, the disk budget is fixed at creation,
  a reader can tail the rings while the writer runs, and a restarted
  process re-adopts its partial bucket.  The ring format is ``blit``'s:
  a ring written by either package reads back equal in the other.
- :class:`AnomalyDetector`: a rolling median / MAD baseline a stored
  series; a robust z-score past the sensitivity for N consecutive ticks
  pages through the flight recorder as an ``"anomaly"`` breach.
  ``BLIT_HISTORY_ANOMALY=0`` switches it off,
  ``BLIT_HISTORY_SENSITIVITY=metric=z,...`` sets a z a metric.
- :class:`IncidentBundler`: on a page (an SLO breach, an anomaly, a fleet
  eject, a peer's death) one bundle directory: manifest, the history
  window, the matching request records, the exemplar trace, a flight
  dump, ``/healthz`` and the config / tuning provenance.
  ``python -m blit_torch incidents`` lists bundles, ``incident show``
  renders their merged timeline, aligned on the
  :func:`~blit_torch.observability.wall_anchor` of every artifact.
- :func:`slo_report`: attainment and error-budget spend an objective
  over day / week windows from the store; its JSON's flat ``metrics``
  (``*_attained`` keys) is what :func:`blit_torch.monitor.bench_metrics`
  reads, so ``bench-diff`` gates attainment like any other scalar.

:func:`parse_when` is the time grammar of ``/history`` and the
``--since`` / ``--until`` flags; :func:`merge_buckets` folds several
stores' bucket records (the front door's fleet ``/history``).

The module imports the standard library, :mod:`blit_torch.config` and
:mod:`blit_torch.observability`; :mod:`blit_torch.monitor` only inside
functions (the two planes reference each other), and never torch.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from blit_torch.config import DEFAULT, SiteConfig, history_defaults
from blit_torch.observability import (
    HistogramStats,
    Timeline,
    flight_recorder,
    hostname,
    process_timeline,
    wall_anchor,
)

log = logging.getLogger("blit_torch.history")

_MAGIC = "blh1"
# One padded header line per ring file; slots start right after it.
_HDR_BYTES = 256


# -- window grammar ----------------------------------------------------------

_WINDOW_RE = re.compile(r"^([0-9]*\.?[0-9]+)\s*(s|m|h|d|w)$", re.IGNORECASE)
_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
                 "w": 604800.0}


def window_seconds(spec: str) -> float:
    """A window spec as seconds: ``"90"``/``"90s"``/``"15m"``/``"2h"``/
    ``"1d"``/``"1w"`` — the one grammar shared by ``incident
    show``, ``requests --since/--until``, ``slo-report
    --window`` and ``top --history``."""
    s = str(spec).strip()
    m = _WINDOW_RE.match(s)
    if m:
        return float(m.group(1)) * _WINDOW_UNITS[m.group(2).lower()]
    return float(s)


def parse_when(spec: str, now: Optional[float] = None) -> float:
    """A point in time: ``"now"``, an absolute epoch (values >= 1e9 —
    no window is 31 years long), or a window spec meaning "that long
    AGO" (``--since 15m`` = 15 minutes before now)."""
    now = time.time() if now is None else now
    s = str(spec).strip().lower()
    if s == "now":
        return now
    try:
        v = float(s)
        if v >= 1e9:
            return v
    except ValueError:
        pass
    return now - window_seconds(spec)


# -- bucket records and their folds ------------------------------------------
#
# A bucket record is plain JSON:
#   {"t0": <bucket start epoch>, "bucket_s": <width>, "n": <ticks>,
#    "seconds": <covered interval seconds>,
#    "stages": {name: {"calls", "seconds", "bytes"}},
#    "hists":  {name: HistogramStats.state() minus exemplars},
#    "gauges": {name: {"last", "lo", "hi", "n"}},
#    "burn":   {objective: {"bad", "total"}}}
# Every fold below is commutative and associative (sums / envelope
# widening), so tier downsampling, restart re-adoption and the fleet
# merge all conserve counts and sums exactly.


def _norm_hist_state(st: Dict) -> Dict:
    """A hist state stripped to its mergeable core (exemplars are
    "most recent", not summable — they stay in spools/flight dumps)."""
    return {"counts": [int(c) for c in (st.get("counts") or [])],
            "n": int(st.get("n", 0)), "total": float(st.get("total", 0.0)),
            "vmin": float(st.get("vmin", 0.0)),
            "vmax": float(st.get("vmax", 0.0))}


def _merge_hist_state(a: Optional[Dict], b: Optional[Dict]
                      ) -> Optional[Dict]:
    if b is None:
        return a
    b = _norm_hist_state(b)
    if a is None or not a.get("n"):
        return b if b["n"] else (b if a is None else a)
    if not b["n"]:
        return a
    counts = list(a.get("counts") or [])
    bc = b["counts"]
    if len(counts) < len(bc):
        counts.extend([0] * (len(bc) - len(counts)))
    for i, c in enumerate(bc):
        counts[i] += c
    return {"counts": counts, "n": a["n"] + b["n"],
            "total": float(a.get("total", 0.0)) + b["total"],
            "vmin": min(float(a.get("vmin", 0.0)), b["vmin"]),
            "vmax": max(float(a.get("vmax", 0.0)), b["vmax"])}


def _new_bucket(t0: float, bucket_s: float) -> Dict:
    return {"t0": t0, "bucket_s": bucket_s, "n": 0, "seconds": 0.0,
            "stages": {}, "hists": {}, "gauges": {}, "burn": {}}


def _fold_bucket(acc: Dict, *, interval_s: float = 0.0,
                 stages: Optional[Dict] = None,
                 hists: Optional[Dict] = None,
                 gauges: Optional[Dict] = None,
                 burn: Optional[Dict] = None, n: int = 1) -> Dict:
    """Fold one tick's (or one peer bucket's) contributions into
    ``acc`` in place.  ``stages``/``burn`` values are plain dicts;
    ``hists`` values are hist-state dicts; ``gauges`` values are either
    plain floats (a tick's level sample) or envelope dicts (a peer
    bucket's)."""
    acc["n"] = int(acc.get("n", 0)) + int(n)
    acc["seconds"] = float(acc.get("seconds", 0.0)) + float(interval_s)
    for k, row in (stages or {}).items():
        d = acc["stages"].setdefault(
            k, {"calls": 0, "seconds": 0.0, "bytes": 0})
        d["calls"] += int(row.get("calls", 0))
        d["seconds"] += float(row.get("seconds", 0.0))
        d["bytes"] += int(row.get("bytes", 0))
    for k, st in (hists or {}).items():
        acc["hists"][k] = _merge_hist_state(acc["hists"].get(k), st)
    for k, v in (gauges or {}).items():
        g = acc["gauges"].get(k)
        if isinstance(v, dict):
            lo, hi = float(v.get("lo", 0.0)), float(v.get("hi", 0.0))
            last, gn = float(v.get("last", 0.0)), int(v.get("n", 0))
        else:
            lo = hi = last = float(v)
            gn = 1
        if not gn:
            continue
        if g is None or not g.get("n"):
            acc["gauges"][k] = {"last": last, "lo": lo, "hi": hi, "n": gn}
        else:
            g["last"] = last
            g["lo"] = min(float(g["lo"]), lo)
            g["hi"] = max(float(g["hi"]), hi)
            g["n"] = int(g["n"]) + gn
    for name, row in (burn or {}).items():
        b = acc["burn"].setdefault(name, {"bad": 0, "total": 0})
        if isinstance(row, dict):
            b["bad"] += int(row.get("bad", 0))
            b["total"] += int(row.get("total", 0))
        else:
            bad, total = row
            b["bad"] += int(bad)
            b["total"] += int(total)
    return acc


def merge_buckets(bucket_lists: Iterable[Iterable[Dict]]) -> List[Dict]:
    """Fold bucket records from several stores (two peers' rings, a
    door's fan-out) by ``(bucket_s, t0)`` — the fleet series fold.
    Commutative: counts, sums and burn observations add; gauge
    envelopes widen.  Returns records sorted by (bucket_s, t0)."""
    out: Dict[Tuple[float, float], Dict] = {}
    for recs in bucket_lists:
        for rec in recs or []:
            if not isinstance(rec, dict) or "t0" not in rec:
                continue
            key = (float(rec.get("bucket_s", 0.0)), float(rec["t0"]))
            acc = out.get(key)
            if acc is None:
                acc = out[key] = _new_bucket(key[1], key[0])
            _fold_bucket(acc, interval_s=float(rec.get("seconds", 0.0)),
                         stages=rec.get("stages"), hists=rec.get("hists"),
                         gauges=rec.get("gauges"), burn=rec.get("burn"),
                         n=int(rec.get("n", 0)))
    return [out[k] for k in sorted(out)]


def bucket_point(rec: Dict, metric: str) -> Optional[Dict]:
    """Project one bucket record onto one metric — the query/sparkline
    value: a stage yields its bucket GB/s (calls for byte-free
    counters), a histogram its p99 (+ n/total), a gauge its envelope,
    ``slo.<objective>`` its bad fraction."""
    t0 = float(rec.get("t0", 0.0))
    base = {"t0": t0, "bucket_s": float(rec.get("bucket_s", 0.0))}
    st = (rec.get("stages") or {}).get(metric)
    if st is not None:
        secs = float(st.get("seconds", 0.0))
        nbytes = int(st.get("bytes", 0))
        gbps = nbytes / secs / 1e9 if secs > 0 and nbytes else 0.0
        base.update(kind="stage", calls=int(st.get("calls", 0)),
                    seconds=secs, bytes=nbytes, gbps=round(gbps, 4),
                    value=round(gbps, 4) if nbytes else
                    float(st.get("calls", 0)))
        return base
    hs = (rec.get("hists") or {}).get(metric)
    if hs is not None:
        h = HistogramStats.from_state(hs)
        base.update(kind="hist", n=h.n, total=h.total,
                    p50=round(h.percentile(0.50), 6),
                    p99=round(h.percentile(0.99), 6),
                    max=round(h.vmax, 6),
                    value=round(h.percentile(0.99), 6))
        return base
    g = (rec.get("gauges") or {}).get(metric)
    if g is not None:
        base.update(kind="gauge", last=float(g.get("last", 0.0)),
                    lo=float(g.get("lo", 0.0)), hi=float(g.get("hi", 0.0)),
                    n=int(g.get("n", 0)), value=float(g.get("last", 0.0)))
        return base
    if metric.startswith("slo."):
        b = (rec.get("burn") or {}).get(metric[4:])
        if b is not None:
            total = int(b.get("total", 0))
            frac = int(b.get("bad", 0)) / total if total else 0.0
            base.update(kind="slo", bad=int(b.get("bad", 0)), total=total,
                        value=round(frac, 6))
            return base
    return None


# -- the tiered slot-ring files ----------------------------------------------


class TierSpec:
    """One ring tier: ``slots`` fixed-width buckets of ``bucket_s``
    seconds, so the tier retains ``slots * bucket_s`` seconds and its
    file occupies ``_HDR_BYTES + slots * slot_bytes`` forever."""

    __slots__ = ("name", "bucket_s", "slots")

    def __init__(self, name: str, bucket_s: float, slots: int):
        self.name = str(name)
        self.bucket_s = float(bucket_s)
        self.slots = max(2, int(slots))
        if self.bucket_s <= 0:
            raise ValueError(f"tier {name}: bucket_s must be > 0")

    @property
    def retention_s(self) -> float:
        return self.bucket_s * self.slots


def history_tiers(d: Dict) -> List[TierSpec]:
    """The configured raw → mid → slow tier ladder
    (:func:`blit_torch.config.history_defaults` dict in, specs out)."""
    return [TierSpec("raw", d["raw_s"], d["raw_slots"]),
            TierSpec("mid", d["mid_s"], d["mid_slots"]),
            TierSpec("slow", d["slow_s"], d["slow_slots"])]


def _encode_slot(rec: Dict, slot_bytes: int) -> Tuple[bytes, bool]:
    """One slot image: compact JSON, space-padded, newline at the slot
    boundary (the rings stay line-oriented for emergency ``grep``).
    Records too big for a slot shed their largest blocks (hists, then
    gauges) and mark ``overflow`` — a partial bucket beats a torn
    one."""
    overflow = False
    data = json.dumps(rec, separators=(",", ":")).encode()
    if len(data) >= slot_bytes:
        overflow = True
        slim = dict(rec)
        slim["hists"] = {}
        slim["overflow"] = True
        data = json.dumps(slim, separators=(",", ":")).encode()
        if len(data) >= slot_bytes:
            slim["gauges"] = {}
            slim["stages"] = {}
            data = json.dumps(slim, separators=(",", ":")).encode()
    buf = data + b" " * (slot_bytes - len(data) - 1) + b"\n"
    return buf, overflow


def _parse_slot(blob: bytes):
    """``(record, torn)``: an all-zero/blank slot is empty (never
    written — not an error); a non-empty unparseable one is TORN (a
    writer died mid-``pwrite``) and heals to None, counted by the
    caller (the backfill ledger's rule)."""
    s = blob.decode("utf-8", errors="replace").strip("\x00 \r\n\t")
    if not s:
        return None, False
    try:
        rec = json.loads(s)
    except ValueError:
        return None, True
    if not isinstance(rec, dict) or "t0" not in rec:
        return None, True
    return rec, False


def _read_header(f) -> Optional[Dict]:
    blob = f.read(_HDR_BYTES)
    if len(blob) < _HDR_BYTES:
        return None
    try:
        hdr = json.loads(blob.decode("utf-8", errors="replace").strip())
    except ValueError:
        return None
    if not isinstance(hdr, dict) or hdr.get("magic") != _MAGIC:
        return None
    return hdr


def read_ring(path: str, t0: Optional[float] = None,
              t1: Optional[float] = None) -> Tuple[Dict, List[Dict], int]:
    """Read one ring file: ``(header, records, torn_slots)``.  With a
    ``[t0, t1]`` window, only the slots whose time-addressed indices
    can hold it are visited (a ``top`` frame over a 2-hour raw
    ring reads a few KB, not the whole file); records are filtered to
    the window either way and come back t0-sorted.  Opens its own
    descriptor — safe to call while the owning publisher writes."""
    with open(path, "rb") as f:
        hdr = _read_header(f)
        if hdr is None:
            raise ValueError(f"{path} is not a blit history ring")
        bucket_s = float(hdr["bucket_s"])
        slots = int(hdr["slots"])
        slot_bytes = int(hdr["slot_bytes"])
        recs: List[Dict] = []
        torn = 0
        if t0 is not None and t1 is not None and \
                (t1 - t0) / bucket_s < slots - 1:
            first = int(t0 // bucket_s)
            last = int(t1 // bucket_s)
            indices = sorted({b % slots for b in range(first, last + 1)})
        else:
            indices = range(slots)
        for i in indices:
            f.seek(_HDR_BYTES + i * slot_bytes)
            rec, is_torn = _parse_slot(f.read(slot_bytes))
            if is_torn:
                torn += 1
                continue
            if rec is None:
                continue
            rt0 = float(rec.get("t0", 0.0))
            if t0 is not None and rt0 + bucket_s <= t0:
                continue
            if t1 is not None and rt0 > t1:
                continue
            recs.append(rec)
    recs.sort(key=lambda r: r.get("t0", 0.0))
    return hdr, recs, torn


class HistoryStore:
    """The durable tiered metric store (module docstring).  One
    instance is the single WRITER for its directory (the publisher
    holds it); readers use :meth:`buckets`/:meth:`series` on any
    instance (``create=False`` never touches disk layout) or the
    module-level :func:`read_history`.

    Every tick folds into ALL tiers' current buckets and writes each
    tier's partial bucket through to its slot — readers always see
    data at most one tick stale, a tick never costs more than three
    slot writes, and same-source folding makes tier-boundary
    counts/sums conservation exact (tests pin it)."""

    def __init__(self, dir: str, *, config: SiteConfig = DEFAULT,
                 tiers: Optional[List[TierSpec]] = None,
                 slot_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.time,
                 create: bool = True):
        d = history_defaults(config)
        self.dir = dir
        self.clock = clock
        self.tiers = list(tiers) if tiers is not None else history_tiers(d)
        self.slot_bytes = max(2048, int(slot_bytes if slot_bytes is not None
                                        else d["slot_bytes"]))
        self._lock = threading.Lock()
        self._f: Dict[str, object] = {}
        self._geom: Dict[str, Tuple[float, int, int]] = {}
        self._acc: Dict[str, Dict] = {}
        self.torn_slots = 0
        self.overflow_slots = 0
        if create:
            os.makedirs(self.dir, exist_ok=True)

    # -- tier files --------------------------------------------------------
    def _tier_path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.ring")

    def _ensure_tier(self, tier: TierSpec) -> None:
        if tier.name in self._f:
            return
        path = self._tier_path(tier.name)
        if not os.path.exists(path):
            hdr = json.dumps({
                "magic": _MAGIC, "tier": tier.name,
                "bucket_s": tier.bucket_s, "slots": tier.slots,
                "slot_bytes": self.slot_bytes, "v": 1}).encode()
            buf = hdr + b" " * (_HDR_BYTES - len(hdr) - 1) + b"\n"
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(buf)
                # The full budget is claimed up front: the file NEVER
                # grows after creation, whatever lands in it.
                f.truncate(_HDR_BYTES + tier.slots * self.slot_bytes)
            os.replace(tmp, path)
        f = open(path, "r+b")
        hdr = _read_header(f)
        if hdr is None:
            # Unrecognizable file at the tier path: refuse to write
            # through it (it may be someone else's data).
            f.close()
            raise ValueError(f"{path} exists but is not a history ring")
        # The FILE's geometry wins over the configured one (a restart
        # under different env must keep addressing old slots correctly).
        self._geom[tier.name] = (float(hdr["bucket_s"]), int(hdr["slots"]),
                                 int(hdr["slot_bytes"]))
        self._f[tier.name] = f

    def _write_slot(self, name: str, rec: Dict) -> None:
        bucket_s, slots, slot_bytes = self._geom[name]
        i = int(rec["t0"] // bucket_s) % slots
        buf, overflow = _encode_slot(rec, slot_bytes)
        if overflow:
            self.overflow_slots += 1
            process_timeline().count("history.slot_overflow")
        f = self._f[name]
        f.seek(_HDR_BYTES + i * slot_bytes)
        f.write(buf)
        f.flush()

    def _read_own_slot(self, name: str, t0: float) -> Optional[Dict]:
        bucket_s, slots, slot_bytes = self._geom[name]
        i = int(t0 // bucket_s) % slots
        f = self._f[name]
        f.seek(_HDR_BYTES + i * slot_bytes)
        rec, torn = _parse_slot(f.read(slot_bytes))
        if torn:
            self.torn_slots += 1
            process_timeline().count("history.torn_slot")
        if rec is not None and float(rec.get("t0", -1.0)) == float(t0):
            return rec
        return None

    # -- writing -----------------------------------------------------------
    def append(self, t: float, interval_s: float, delta: Timeline, *,
               gauges: Optional[Dict[str, float]] = None,
               burn: Optional[Dict[str, Tuple[int, int]]] = None) -> None:
        """Fold one publisher tick into every tier: ``delta`` is the
        interval's Timeline delta (stages + hists), ``gauges`` the
        current levels, ``burn`` the tick's per-objective ``(bad,
        total)`` SLO observations.  Each tier's live bucket is written
        through immediately (read-while-write freshness); a bucket
        whose window closed gets its final image flushed first."""
        stages = {k: {"calls": s.calls, "seconds": s.seconds,
                      "bytes": s.bytes}
                  for k, s in list(delta.stages.items())}
        hists = {k: _norm_hist_state(h.state())
                 for k, h in list(delta.hists.items()) if h.n}
        with self._lock:
            for tier in self.tiers:
                try:
                    self._ensure_tier(tier)
                except (OSError, ValueError):
                    log.warning("history tier %s unavailable", tier.name,
                                exc_info=True)
                    continue
                bucket_s = self._geom[tier.name][0]
                t0 = (t // bucket_s) * bucket_s
                acc = self._acc.get(tier.name)
                if acc is None or float(acc["t0"]) != t0:
                    if acc is not None:
                        self._write_slot(tier.name, acc)
                    # Restart mid-bucket: adopt the partial bucket the
                    # previous process wrote for this same window, so
                    # its ticks aren't zeroed by ours.
                    acc = (self._read_own_slot(tier.name, t0)
                           or _new_bucket(t0, bucket_s))
                    self._acc[tier.name] = acc
                _fold_bucket(acc, interval_s=interval_s, stages=stages,
                             hists=hists, gauges=gauges, burn=burn)
                self._write_slot(tier.name, acc)

    def merge_in(self, buckets: Iterable[Dict]) -> int:
        """Fold EXTERNAL bucket records (a peer's ``/history`` answer)
        into matching-width tiers — how a door materializes a fleet
        store.  Records whose width matches no local tier are skipped;
        returns the number folded."""
        folded = 0
        with self._lock:
            for rec in buckets:
                if not isinstance(rec, dict) or "t0" not in rec:
                    continue
                width = float(rec.get("bucket_s", 0.0))
                tier = next((tr for tr in self.tiers
                             if abs(tr.bucket_s - width) < 1e-9), None)
                if tier is None:
                    continue
                try:
                    self._ensure_tier(tier)
                except (OSError, ValueError):
                    continue
                t0 = float(rec["t0"])
                acc = self._acc.get(tier.name)
                if acc is not None and float(acc["t0"]) == t0:
                    target = acc
                else:
                    target = (self._read_own_slot(tier.name, t0)
                              or _new_bucket(t0, tier.bucket_s))
                _fold_bucket(target,
                             interval_s=float(rec.get("seconds", 0.0)),
                             stages=rec.get("stages"),
                             hists=rec.get("hists"),
                             gauges=rec.get("gauges"),
                             burn=rec.get("burn"),
                             n=int(rec.get("n", 0)))
                self._write_slot(tier.name, target)
                folded += 1
        return folded

    # -- reading -----------------------------------------------------------
    def _ring_headers(self) -> List[Tuple[str, Dict]]:
        out = []
        for path in sorted(glob.glob(os.path.join(self.dir, "*.ring"))):
            try:
                with open(path, "rb") as f:
                    hdr = _read_header(f)
            except OSError:
                continue
            if hdr is not None:
                out.append((path, hdr))
        return out

    def pick_tier(self, t0: float, now: Optional[float] = None
                  ) -> Optional[str]:
        """The FINEST tier whose retention still covers ``t0`` (the
        coarsest when none does) — query resolution degrades with age
        exactly the way the rings store it."""
        now = self.clock() if now is None else now
        rings = self._ring_headers()
        if not rings:
            return None
        rings.sort(key=lambda ph: float(ph[1]["bucket_s"]))
        for _, hdr in rings:
            if float(hdr["bucket_s"]) * int(hdr["slots"]) >= now - t0:
                return str(hdr["tier"])
        return str(rings[-1][1]["tier"])

    def buckets(self, t0: float, t1: Optional[float] = None, *,
                tier: Optional[str] = None) -> List[Dict]:
        """Raw bucket records over ``[t0, t1]`` from one tier (auto:
        :meth:`pick_tier`).  Torn slots heal and count."""
        t1 = self.clock() if t1 is None else t1
        name = tier or self.pick_tier(t0, now=t1)
        if name is None:
            return []
        path = self._tier_path(name)
        try:
            _, recs, torn = read_ring(path, t0, t1)
        except (OSError, ValueError):
            return []
        if torn:
            self.torn_slots += torn
            process_timeline().count("history.torn_slot", torn)
        return recs

    def series(self, metric: str, t0: float,
               t1: Optional[float] = None, *,
               tier: Optional[str] = None) -> List[Dict]:
        """The ``(metric, window)`` query surface: one point per bucket
        (:func:`bucket_point`), t0-sorted."""
        out = []
        for rec in self.buckets(t0, t1, tier=tier):
            p = bucket_point(rec, metric)
            if p is not None:
                out.append(p)
        return out

    def metrics(self, window_s: float = 3600.0) -> List[str]:
        """Names with data in the finest tier's recent window."""
        now = self.clock()
        names = set()
        for rec in self.buckets(now - window_s, now):
            names.update(rec.get("stages") or {})
            names.update(rec.get("hists") or {})
            names.update(rec.get("gauges") or {})
            names.update(f"slo.{k}" for k in rec.get("burn") or {})
        return sorted(names)

    def disk_usage(self) -> int:
        """Bytes the ring files occupy — fixed at creation, whatever
        gets written (the budget test pins this across a simulated
        week)."""
        total = 0
        for path, _ in self._ring_headers():
            try:
                total += os.path.getsize(path)
            except OSError:
                continue
        return total

    def close(self) -> None:
        with self._lock:
            for name, acc in list(self._acc.items()):
                if name in self._f:
                    try:
                        self._write_slot(name, acc)
                    except OSError:
                        pass
            for f in self._f.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._f.clear()
            self._acc.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_history(dir: str, metric: str, t0: float,
                 t1: Optional[float] = None,
                 tier: Optional[str] = None) -> List[Dict]:
    """Read-only one-shot query over a store directory (the CLI's
    path: never creates files)."""
    return HistoryStore(dir, create=False).series(metric, t0, t1,
                                                  tier=tier)


# -- anomaly baselines -------------------------------------------------------


def _robust_scale(base: List[float], med: float) -> float:
    """1.4826·MAD — the σ-consistent robust spread — floored at 5% of
    the median's magnitude.  The floor keeps quantized series honest:
    log2-bucket p99s collapse to a handful of interpolated values, so
    their MAD is near zero and any adjacent-bucket wobble would score
    as hundreds of sigmas.  Sub-5%-of-level deviations are never worth
    a page; a genuine step still clears the floor by orders of
    magnitude (and a dead-zero baseline keeps the 1e-9 epsilon)."""
    dev = sorted(abs(x - med) for x in base)
    n = len(dev)
    mad = (dev[n // 2] if n % 2 else (dev[n // 2 - 1] + dev[n // 2]) / 2.0)
    return max(1.4826 * mad, abs(med) * 0.05, 1e-9)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def series_values(delta: Timeline,
                  gauges: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
    """One tick's scoreable series: per-stage GB/s (``<stage>.gbps``),
    per-histogram p99 (``<hist>.p99_s``), raw gauge levels.  Idle
    series contribute nothing (a paused pipeline is not an anomalous
    one — the SLO throughput rule)."""
    vals: Dict[str, float] = {}
    for k, s in list(delta.stages.items()):
        if s.seconds > 0 and s.bytes:
            vals[f"{k}.gbps"] = s.bytes / s.seconds / 1e9
    for k, h in list(delta.hists.items()):
        if h.n:
            vals[f"{k}.p99_s"] = h.percentile(0.99)
    for k, v in (gauges or {}).items():
        vals[k] = float(v)
    return vals


def _anomalous_sign(metric: str) -> float:
    """Which direction is bad: throughput series (``.gbps``) page on a
    DROP; latency/level series page on a RISE."""
    return -1.0 if metric.endswith(".gbps") else 1.0


class AnomalyDetector:
    """Rolling median/MAD baseline per series (module docstring).
    Each tick: score the incoming value against the PRIOR window
    (median ± 1.4826·MAD), then admit it.  A breach needs
    ``min_n`` history, a robust z past the metric's sensitivity in its
    bad direction, and ``consecutive`` such ticks in a row — one noisy
    sample never pages.  While a series stays in breach it does not
    re-page; recovery re-arms it.  Pages ride the existing flight-dump
    machinery (event + ``anomaly.breach.<metric>`` counter + dump,
    first-per-metric forced) as alert class ``"anomaly"``."""

    def __init__(self, *, z: float = 6.0, window: int = 120,
                 min_n: int = 30, consecutive: int = 3,
                 overrides: Optional[Dict[str, float]] = None,
                 recorder=None,
                 clock: Callable[[], float] = time.time):
        self.z = float(z)
        self.window = max(4, int(window))
        self.min_n = max(3, int(min_n))
        self.consecutive = max(1, int(consecutive))
        self.overrides = dict(overrides or {})
        self.recorder = recorder
        self.clock = clock
        self._hist: Dict[str, deque] = {}
        self._streak: Dict[str, int] = {}
        self._breached: Dict[str, Dict] = {}
        self._dumped: set = set()
        self.alerts: List[Dict] = []

    @classmethod
    def for_config(cls, config: SiteConfig = DEFAULT, **kw
                   ) -> "AnomalyDetector":
        d = history_defaults(config)
        return cls(z=d["anomaly_z"], window=d["anomaly_window"],
                   min_n=d["anomaly_min_n"],
                   consecutive=d["anomaly_consecutive"],
                   overrides=d["anomaly_overrides"], **kw)

    def threshold_for(self, metric: str) -> float:
        return float(self.overrides.get(metric, self.z))

    def observe(self, values: Dict[str, float],
                t: Optional[float] = None) -> List[Dict]:
        """Score one tick's series values; returns the alerts raised."""
        t = self.clock() if t is None else t
        fired: List[Dict] = []
        for metric in sorted(values):
            v = float(values[metric])
            dq = self._hist.get(metric)
            if dq is None:
                dq = self._hist[metric] = deque(maxlen=self.window)
            base = list(dq)
            dq.append(v)
            if len(base) < self.min_n:
                continue
            med = _median(base)
            scale = _robust_scale(base, med)
            z = _anomalous_sign(metric) * (v - med) / scale
            thr = self.threshold_for(metric)
            if z < thr:
                self._streak[metric] = 0
                if metric in self._breached:
                    self._breached.pop(metric, None)
                    log.info("anomaly cleared: %s", metric)
                continue
            # Over threshold: a breached series stays breached without
            # re-paging (and without poisoning its own baseline — the
            # anomalous value was already admitted to the window, but
            # the window is long enough that recovery wins).
            if metric in self._breached:
                continue
            streak = self._streak.get(metric, 0) + 1
            self._streak[metric] = streak
            if streak < self.consecutive:
                continue
            self._streak[metric] = 0
            alert = {"t": t, "class": "anomaly", "metric": metric,
                     "value": round(v, 6), "baseline": round(med, 6),
                     "scale": round(scale, 6), "z": round(z, 2),
                     "threshold": thr, "window": len(base),
                     "consecutive": self.consecutive}
            self._breached[metric] = alert
            rec = self.recorder if self.recorder is not None \
                else flight_recorder()
            rec.event("anomaly", metric, z=round(z, 2),
                      baseline=round(med, 6), value=round(v, 6))
            process_timeline().count(f"anomaly.breach.{metric}")
            path = rec.dump(
                f"anomaly: {metric} at {v:.6g} is {z:.1f} robust sigmas "
                f"past its rolling median {med:.6g} for "
                f"{self.consecutive} consecutive ticks",
                force=metric not in self._dumped,
                key=f"anomaly:{metric}")
            self._dumped.add(metric)
            if path:
                alert["flight_dump"] = path
            self.alerts.append(alert)
            del self.alerts[:-256]
            fired.append(alert)
            log.warning("anomaly breach: %s z=%.1f (baseline %.6g, "
                        "value %.6g)", metric, z, med, v)
        return fired

    def breached(self) -> List[str]:
        return sorted(self._breached)

    def report(self) -> Dict[str, Dict]:
        """Currently-breached series (the sample's ``anomaly`` block —
        compact: quiet baselines ship nothing)."""
        return {k: dict(a) for k, a in self._breached.items()}


# -- incident bundles --------------------------------------------------------

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _slug(s: str) -> str:
    return (_SLUG_RE.sub("-", str(s)).strip("-") or "incident")[:48]


class IncidentBundler:
    """One self-contained bundle directory per page (module
    docstring).  Rate-limited per incident KIND (first per kind
    forced — the FlightRecorder discipline), so an alert storm writes
    one bundle, not hundreds.  :meth:`snapshot` never raises: the
    caller is already mid-incident."""

    def __init__(self, dir: str, *, window_s: float = 900.0,
                 cooldown_s: float = 300.0,
                 config: SiteConfig = DEFAULT,
                 clock: Callable[[], float] = time.time):
        self.dir = dir
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.config = config
        self.clock = clock
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}
        self._seq = 0

    def _resolve_trace(self, timeline: Optional[Timeline],
                       alert: Optional[Dict]) -> Optional[str]:
        """The exemplar trace id the bundle pivots on: the breached
        metric's tail exemplar when the alert names one, else the
        newest tail exemplar of any request-ish histogram, else the
        newest finished span's trace."""
        candidates: List[Tuple[float, int, str]] = []
        if timeline is not None:
            metric = (alert or {}).get("metric", "")
            for k, h in list(timeline.hists.items()):
                ex = h.tail_exemplar()
                if not ex:
                    continue
                pri = 2 if (metric and metric.startswith(k)) else (
                    1 if "request" in k else 0)
                candidates.append((float(ex.get("t", 0.0)), pri,
                                   str(ex["trace"])))
        if candidates:
            candidates.sort(key=lambda c: (c[1], c[0]))
            return candidates[-1][2]
        from blit_torch import observability

        spans = observability.tracer().span_dicts()
        for sp in reversed(spans):
            if sp.get("trace"):
                return str(sp["trace"])
        return None

    def snapshot(self, kind: str, reason: str, *,
                 alert: Optional[Dict] = None,
                 publisher=None,
                 timeline: Optional[Timeline] = None,
                 history: Optional[HistoryStore] = None,
                 force: bool = False) -> Optional[str]:
        """Write one bundle; returns its directory path, or None when
        rate-limited/disabled.  ``publisher`` (a MetricsPublisher)
        supplies ``/healthz`` + the merged timeline; a bare
        ``timeline`` works for publisher-less callers (the fleet
        door)."""
        if os.environ.get("BLIT_FLIGHT_DISABLE"):
            return None
        try:
            now = self.clock()
            kslug = _slug(kind)
            with self._lock:
                last = self._last.get(kslug)
                if (last is not None and not force
                        and now - last < self.cooldown_s):
                    return None
                self._last[kslug] = now
                self._seq += 1
                seq = self._seq
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))
            path = os.path.join(
                self.dir, f"incident-{stamp}-{kslug}-{hostname()}-"
                          f"{os.getpid()}-{seq}")
            os.makedirs(path, exist_ok=True)
            tl = timeline
            if tl is None and publisher is not None:
                tl = publisher.merged_timeline()
            if tl is None:
                tl = process_timeline()
            trace = self._resolve_trace(tl, alert)
            t0 = now - self.window_s
            # Flight dump FIRST (forced, explicit path): the ring's
            # recent events are the most perishable evidence.
            flight_recorder().dump(reason,
                                   path=os.path.join(path, "flight.json"),
                                   force=True)
            self._write_json(path, "healthz.json",
                             publisher.health() if publisher is not None
                             else {"t": now, "host": hostname(),
                                   "pid": os.getpid(), "ok": False,
                                   "status": "incident",
                                   "reasons": [kind]})
            self._write_history(path, history, t0, now)
            n_req = self._write_requests(path, t0, now)
            self._write_trace(path, trace)
            manifest = {
                "kind": kind, "reason": reason, "t": now,
                "t0": t0, "window_s": self.window_s,
                "host": hostname(), "pid": os.getpid(),
                "anchor": wall_anchor(),
                "alert": alert, "trace": trace,
                "requests": n_req,
                "files": sorted(os.listdir(path)) + ["incident.json"],
                "provenance": self._provenance(),
            }
            # The manifest lands LAST — a bundle without incident.json
            # is in-progress/aborted and `incidents` skips it.
            self._write_json(path, "incident.json", manifest)
            log.error("incident bundle written to %s (%s)", path, reason)
            return path
        except Exception:  # noqa: BLE001 — never mask the real incident
            log.warning("incident bundle failed", exc_info=True)
            return None

    # -- bundle members ----------------------------------------------------
    @staticmethod
    def _write_json(path: str, name: str, doc) -> None:
        tmp = os.path.join(path, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(path, name))

    def _write_history(self, path: str, history: Optional[HistoryStore],
                       t0: float, t1: float) -> None:
        buckets: List[Dict] = []
        metrics: List[str] = []
        if history is not None:
            try:
                buckets = history.buckets(t0, t1)
                metrics = history.metrics(window_s=t1 - t0)
            except Exception:  # noqa: BLE001 — partial bundle beats none
                log.warning("incident history read failed", exc_info=True)
        self._write_json(path, "history.json",
                         {"t0": t0, "t1": t1, "buckets": buckets,
                          "metrics": metrics})

    def _write_requests(self, path: str, t0: float, t1: float) -> int:
        from blit_torch.config import request_log_defaults
        from blit_torch.monitor import read_requests

        d = request_log_defaults(self.config)["dir"]
        records: List[Dict] = []
        if d and os.path.isdir(d):
            try:
                records = [r for r in read_requests(d)
                           if t0 <= float(r.get("t", 0.0)) <= t1 + 1.0]
            except Exception:  # noqa: BLE001
                log.warning("incident request read failed", exc_info=True)
        tmp = os.path.join(path, "requests.jsonl.tmp")
        with open(tmp, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        os.replace(tmp, os.path.join(path, "requests.jsonl"))
        return len(records)

    def _write_trace(self, path: str, trace: Optional[str]) -> None:
        from blit_torch import observability

        spans = observability.tracer().span_dicts()[-512:]
        self._write_json(path, "trace.json",
                         {"trace": trace,
                          "spans": spans,
                          "trace_spans": [s for s in spans
                                          if s.get("trace") == trace]})

    def _provenance(self) -> Dict:
        """Config/tuning provenance: which knobs shaped the paging
        process — the effective defaults dicts plus every BLIT_* env
        override and the tuner's state."""
        from blit_torch.config import monitor_defaults, slo_defaults

        prov: Dict = {
            "history": {k: v for k, v in
                        history_defaults(self.config).items()},
            "monitor": monitor_defaults(self.config),
            "slo": slo_defaults(self.config),
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith("BLIT_")},
        }
        try:
            from blit_torch import tune

            prov["tune"] = {"enabled": tune.enabled(),
                            "dir": tune.profile_dir(self.config)}
        except Exception:  # noqa: BLE001
            pass
        return prov


# -- the process-wide bundler + page hook ------------------------------------

_BUNDLER: Optional[IncidentBundler] = None
_BUNDLER_LOCK = threading.Lock()


def incident_bundler(config: SiteConfig = DEFAULT
                     ) -> Optional[IncidentBundler]:
    """The process-wide bundler (None while ``BLIT_INCIDENT_DIR`` /
    ``SiteConfig.incident_dir`` is unset — disabled costs one dict
    lookup)."""
    global _BUNDLER
    d = history_defaults(config)
    if not d["incident_dir"]:
        return None
    with _BUNDLER_LOCK:
        if _BUNDLER is None or _BUNDLER.dir != d["incident_dir"]:
            _BUNDLER = IncidentBundler(
                d["incident_dir"], window_s=d["incident_window_s"],
                cooldown_s=d["incident_cooldown_s"], config=config)
        return _BUNDLER


def reset_bundler() -> None:
    """Forget the process-wide bundler (tests flip the env per run)."""
    global _BUNDLER
    with _BUNDLER_LOCK:
        _BUNDLER = None


def maybe_incident(kind: str, reason: str, *,
                   alert: Optional[Dict] = None,
                   publisher=None,
                   timeline: Optional[Timeline] = None,
                   history: Optional[HistoryStore] = None,
                   config: SiteConfig = DEFAULT,
                   force: bool = False) -> Optional[str]:
    """The one page hook every plane calls (fleet eject, recover
    abort, SLO/anomaly breach): bundle if bundling is on.  Never
    raises."""
    try:
        b = incident_bundler(config)
        if b is None:
            return None
        return b.snapshot(kind, reason, alert=alert, publisher=publisher,
                          timeline=timeline, history=history, force=force)
    except Exception:  # noqa: BLE001 — paging must not break the plane
        log.warning("maybe_incident failed", exc_info=True)
        return None


# -- bundle reading / rendering ----------------------------------------------


def list_incidents(dir: str) -> List[Dict]:
    """Bundle manifests under ``dir``, oldest first.  Directories
    without a committed ``incident.json`` (in-progress/aborted) are
    skipped; unreadable manifests are skipped and counted."""
    out: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(dir, "incident-*"))):
        mpath = os.path.join(path, "incident.json")
        if not os.path.isfile(mpath):
            continue
        try:
            with open(mpath) as f:
                m = json.load(f)
        except (OSError, ValueError):
            process_timeline().count("history.torn_manifest")
            continue
        if isinstance(m, dict):
            m["path"] = path
            out.append(m)
    out.sort(key=lambda m: m.get("t", 0.0))
    return out


def load_incident(path: str) -> Dict:
    """Everything in one bundle, reading ONLY inside its directory
    (the self-containment contract the CI drill pins): manifest,
    flight dump, history window, request records (torn lines heal and
    count), trace doc, healthz."""
    def read_json(name):
        try:
            with open(os.path.join(path, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    requests: List[Dict] = []
    torn = 0
    try:
        with open(os.path.join(path, "requests.jsonl")) as f:
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
                    requests.append(doc)
    except OSError:
        pass
    if torn:
        process_timeline().count("monitor.torn_lines", torn)
    return {"path": path,
            "manifest": read_json("incident.json") or {},
            "flight": read_json("flight.json"),
            "history": read_json("history.json"),
            "trace": read_json("trace.json"),
            "healthz": read_json("healthz.json"),
            "requests": requests,
            "torn_lines": torn}


def render_incidents(manifests: List[Dict]) -> str:
    lines = [f"{'when (UTC)':<20} {'kind':<16} {'reqs':>5} "
             f"{'trace':<18} reason"]
    for m in manifests:
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.gmtime(m.get("t", 0.0)))
        lines.append(
            f"{when:<20} {str(m.get('kind', '?')):<16} "
            f"{m.get('requests', 0):>5} "
            f"{str(m.get('trace') or '-'):<18} "
            f"{str(m.get('reason', ''))[:60]}")
        lines.append(f"  {m.get('path', '')}")
    if not manifests:
        lines.append("(no incident bundles)")
    return "\n".join(lines)


def incident_timeline(bundle: Dict,
                      window: Optional[Tuple[float, float]] = None
                      ) -> List[Tuple[float, str, str]]:
    """The merged cross-source event list of one bundle: flight-ring
    events, request records, trace spans and the triggering alert,
    each as ``(epoch t, source, text)``, wall-clock sorted.  All
    sources already stamp epoch seconds; the manifest/flight anchors
    tell the reader how much to trust cross-process alignment
    (rendered by :func:`render_incident`)."""
    events: List[Tuple[float, str, str]] = []
    m = bundle.get("manifest") or {}
    if m.get("t"):
        events.append((float(m["t"]), "page",
                       f"{m.get('kind')}: {m.get('reason', '')}"))
    alert = m.get("alert")
    if isinstance(alert, dict) and alert.get("t"):
        desc = " ".join(f"{k}={alert[k]}" for k in
                        ("class", "objective", "metric", "z", "burn_fast")
                        if alert.get(k) is not None)
        events.append((float(alert["t"]), "alert", desc))
    for e in ((bundle.get("flight") or {}).get("events") or []):
        rest = {k: v for k, v in e.items()
                if k not in ("t", "kind", "name")}
        detail = " ".join(f"{k}={v}" for k, v in rest.items())
        events.append((float(e.get("t", 0.0)), f"flight/{e.get('kind')}",
                       f"{e.get('name', '?')} {detail}".rstrip()))
    for r in bundle.get("requests") or []:
        events.append((
            float(r.get("t", 0.0)), "request",
            f"{r.get('role', '?')} {r.get('status', '?')} "
            f"{r.get('duration_s', 0.0) * 1e3:.1f}ms "
            f"client={r.get('client', '-')} trace={r.get('trace', '-')}"))
    for s in ((bundle.get("trace") or {}).get("trace_spans") or []):
        events.append((
            float(s.get("t0", 0.0)), "span",
            f"{s.get('name', '?')} {s.get('duration_s', 0.0) * 1e3:.1f}ms "
            f"span={s.get('span', '-')}"))
    if window is not None:
        t0, t1 = window
        events = [e for e in events if t0 <= e[0] <= t1]
    events.sort(key=lambda e: e[0])
    return events


def render_incident(bundle: Dict,
                    window: Optional[Tuple[float, float]] = None) -> str:
    """``incident show``'s body: the manifest header (anchor
    included — the cross-process alignment evidence), the breached
    metric's history sparkline, and the merged timeline."""
    m = bundle.get("manifest") or {}
    lines = ["=== blit incident bundle ==="]
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(m.get("t", 0.0)))
    lines.append(f"kind   : {m.get('kind', '?')}")
    lines.append(f"reason : {m.get('reason', '?')}")
    lines.append(f"when   : {when} UTC  (window {m.get('window_s', 0)}s)")
    lines.append(f"where  : {m.get('host', '?')} pid {m.get('pid', '?')}")
    anchor = m.get("anchor") or {}
    if anchor:
        origin = anchor.get("epoch", 0.0) - anchor.get("mono", 0.0)
        lines.append(f"anchor : epoch={anchor.get('epoch')} "
                     f"mono={anchor.get('mono')} "
                     f"(mono origin {origin:.3f})")
        flight_anchor = (bundle.get("flight") or {}).get("anchor") or {}
        if flight_anchor:
            skew = ((flight_anchor.get("epoch", 0.0)
                     - flight_anchor.get("mono", 0.0)) - origin)
            lines.append(f"         flight-dump anchor skew {skew:+.3f}s")
    if m.get("trace"):
        n_spans = len((bundle.get("trace") or {}).get("trace_spans") or [])
        n_req = sum(1 for r in bundle.get("requests") or []
                    if r.get("trace") == m["trace"])
        lines.append(f"trace  : {m['trace']} ({n_spans} span(s), "
                     f"{n_req} request record(s) in bundle)")
    alert = m.get("alert")
    if isinstance(alert, dict):
        desc = " ".join(f"{k}={v}" for k, v in sorted(alert.items())
                        if k not in ("t",) and not isinstance(v, (dict,
                                                                  list)))
        lines.append(f"alert  : {desc}")
    metric = (alert or {}).get("metric") if isinstance(alert, dict) \
        else None
    hist_doc = bundle.get("history") or {}
    buckets = hist_doc.get("buckets") or []
    if metric and buckets:
        # The alert metric may be a derived series name
        # (<hist>.p99_s / <stage>.gbps) — strip the suffix back to the
        # stored name.
        stored = re.sub(r"\.(p99_s|gbps)$", "", metric)
        vals = [p["value"] for p in
                (bucket_point(r, stored) for r in buckets) if p]
        if vals:
            lines.append(f"history: {stored} {sparkline(vals)} "
                         f"lo={min(vals):.6g} hi={max(vals):.6g}")
    events = incident_timeline(bundle, window)
    lines.append(f"timeline ({len(events)} event(s)):")
    for t, src, text in events:
        ts = time.strftime("%H:%M:%S", time.gmtime(t))
        lines.append(f"  {ts} [{src:<14}] {text}")
    if bundle.get("torn_lines"):
        lines.append(f"({bundle['torn_lines']} torn request line(s) "
                     "healed)")
    return "\n".join(lines)


# -- long-horizon SLO reports ------------------------------------------------


def slo_report(store: Optional[HistoryStore] = None, *,
               objectives: Optional[Iterable] = None,
               window_s: float = 86400.0,
               now: Optional[float] = None,
               buckets: Optional[List[Dict]] = None,
               config: SiteConfig = DEFAULT) -> Dict:
    """Attainment + error-budget spend per objective over a window,
    straight from stored buckets (``store`` or an explicit ``buckets``
    list — a door's merged fan-out works too).

    Per objective: the stored per-bucket ``burn`` observations sum
    (exact — they were measured per tick); buckets that predate the
    burn feed fall back to recomputing from the stored histogram
    state / stage rate, the same :func:`~blit_torch.monitor.bad_fraction`
    cut the live evaluator uses.  ``attainment = 1 - bad/total``
    (1.0 over an empty window — no traffic spends no budget);
    ``budget_spent = (bad/total) / budget`` (1.0 = the whole error
    budget, the SRE burn integral).  The ``metrics`` block carries
    flat ``slo.<name>_attained`` keys so
    :func:`blit_torch.monitor.bench_metrics` ingests the report unchanged
    and ``bench-diff`` gates attainment."""
    from blit_torch.monitor import bad_fraction, objectives_for

    objs = list(objectives) if objectives is not None \
        else objectives_for(config)
    now = (store.clock() if store is not None else time.time()) \
        if now is None else now
    t0 = now - float(window_s)
    if buckets is None:
        buckets = store.buckets(t0, now) if store is not None else []
    if objectives is None:
        # The store outranks the reader's config: burn counts recorded
        # under an objective name this host doesn't declare (another
        # peer's config, a since-removed objective) still report —
        # bad/total sums need no threshold, only the name and budget.
        known = {getattr(o, "name", None) or o["name"] for o in objs}
        recorded = sorted({name for rec in buckets
                           for name in (rec.get("burn") or {})
                           if name not in known})
        for name in recorded:
            objs.append({"name": name, "metric": name, "kind": "burn",
                         "threshold": 0.0, "budget": config.slo_budget})
    out_objs: Dict[str, Dict] = {}
    metrics: Dict[str, float] = {}
    for o in objs:
        name = getattr(o, "name", None) or o["name"]
        kind = getattr(o, "kind", None) or o.get("kind", "latency")
        metric = getattr(o, "metric", None) or o["metric"]
        threshold = float(getattr(o, "threshold", None)
                          if hasattr(o, "threshold") else o["threshold"])
        budget = float(getattr(o, "budget", None)
                       if hasattr(o, "budget") else o.get("budget", 0.01))
        bad = total = 0
        worst: Optional[Dict] = None
        for rec in buckets:
            b = (rec.get("burn") or {}).get(name)
            if b is not None:
                rb, rt = int(b.get("bad", 0)), int(b.get("total", 0))
            elif kind == "latency":
                hs = (rec.get("hists") or {}).get(metric)
                if hs is None:
                    continue
                h = HistogramStats.from_state(hs)
                rb, rt = bad_fraction(h, threshold)
            else:
                st = (rec.get("stages") or {}).get(metric)
                if st is None or float(st.get("seconds", 0.0)) <= 0:
                    continue
                gbps = (int(st.get("bytes", 0))
                        / float(st["seconds"]) / 1e9)
                rb, rt = (1, 1) if gbps < threshold else (0, 1)
            bad += rb
            total += rt
            if rt and (worst is None
                       or rb / rt > worst["bad"] / max(1, worst["total"])):
                worst = {"t0": rec.get("t0"), "bad": rb, "total": rt}
        frac = bad / total if total else 0.0
        attainment = 1.0 - frac
        out_objs[name] = {
            "kind": kind, "metric": metric, "threshold": threshold,
            "budget": budget, "bad": bad, "total": total,
            "attainment": round(attainment, 6),
            "budget_spent": round(frac / budget, 4),
            "worst_bucket": worst,
        }
        metrics[f"slo.{name}_attained"] = round(attainment, 6)
    return {"t0": t0, "t1": now, "window_s": float(window_s),
            "buckets": len(buckets), "objectives": out_objs,
            "metrics": metrics}


def render_slo_report(doc: Dict) -> str:
    """``slo-report``'s human table."""
    days = doc.get("window_s", 0.0) / 86400.0
    lines = [f"slo-report over {days:.2g} day(s) "
             f"({doc.get('buckets', 0)} bucket(s))"]
    lines.append(f"{'objective':<24} {'attainment':>11} {'budget%':>9} "
                 f"{'bad':>8} {'total':>10} worst bucket")
    for name, o in sorted((doc.get("objectives") or {}).items()):
        worst = o.get("worst_bucket")
        wtxt = "-"
        if worst and worst.get("total"):
            wt = time.strftime("%m-%d %H:%M",
                               time.gmtime(worst.get("t0", 0.0)))
            wtxt = f"{wt} ({worst['bad']}/{worst['total']})"
        lines.append(
            f"{name:<24} {o.get('attainment', 0.0):>11.6f} "
            f"{o.get('budget_spent', 0.0) * 100:>8.1f}% "
            f"{o.get('bad', 0):>8} {o.get('total', 0):>10} {wtxt}")
    if not doc.get("objectives"):
        lines.append("(no objectives configured — set BLIT_SLO_* or "
                     "SiteConfig.slo_*)")
    return "\n".join(lines)


# -- sparklines / `top --history` --------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 32) -> str:
    """A min–max-normalized unicode sparkline of the LAST ``width``
    values (flat series render as a low bar, not noise)."""
    vals = [float(v) for v in values][-max(1, int(width)):]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return _SPARK[0] * len(vals)
    idx = [int((v - lo) / (hi - lo) * (len(_SPARK) - 1)) for v in vals]
    return "".join(_SPARK[i] for i in idx)


def render_history_panel(store: HistoryStore,
                         metrics: Optional[List[str]] = None, *,
                         buckets: int = 32, max_rows: int = 12,
                         now: Optional[float] = None) -> str:
    """The ``top --history`` panel: one sparkline row per metric
    over the store's last ``buckets`` finest-tier buckets."""
    now = store.clock() if now is None else now
    rings = store._ring_headers()
    if not rings:
        return "history: (no store)"
    rings.sort(key=lambda ph: float(ph[1]["bucket_s"]))
    bucket_s = float(rings[0][1]["bucket_s"])
    tier = str(rings[0][1]["tier"])
    t0 = now - buckets * bucket_s
    names = metrics if metrics else store.metrics(
        window_s=buckets * bucket_s)[:max_rows]
    lines = [f"history ({tier} tier, {bucket_s:g}s buckets, "
             f"last {buckets})"]
    for name in names:
        pts = store.series(name, t0, now, tier=tier)
        vals = [p["value"] for p in pts]
        if not vals:
            continue
        lines.append(f"  {name:<28} {sparkline(vals, buckets):<{buckets}} "
                     f"lo={min(vals):.4g} hi={max(vals):.4g} "
                     f"now={vals[-1]:.4g}")
    if len(lines) == 1:
        lines.append("  (no series in window)")
    return "\n".join(lines)
