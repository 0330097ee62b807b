"""The two pure functions of ``blit``'s history plane that the serve
plane needs: :func:`parse_when`, the time grammar of ``/history`` and
``requests --since/--until`` queries, and :func:`merge_buckets`, the
fold of several stores' bucket records that the fleet front door uses
on its peers' ``/history`` answers.

The durable store itself is not ported: a peer without one answers
``/history`` with ``"enabled": false``, as ``blit``'s does.

A bucket record is plain JSON::

    {"t0": <bucket start epoch>, "bucket_s": <width>, "n": <ticks>,
     "seconds": <covered interval seconds>,
     "stages": {name: {"calls", "seconds", "bytes"}},
     "hists":  {name: HistogramStats.state() minus exemplars},
     "gauges": {name: {"last", "lo", "hi", "n"}},
     "burn":   {objective: {"bad", "total"}}}

Every fold is commutative and associative (sums and envelope widening).
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

_WINDOW_RE = re.compile(r"^([0-9]*\.?[0-9]+)\s*(s|m|h|d|w)$", re.IGNORECASE)
_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
                 "w": 604800.0}


def window_seconds(spec: str) -> float:
    """A window spec as seconds: ``"90"``/``"90s"``/``"15m"``/``"2h"``/
    ``"1d"``/``"1w"``."""
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
