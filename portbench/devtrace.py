"""The benchmark's own device trace of the measured window.

``torch.profiler`` with CUDA activity (CUPTI: kernels, copies, sets and
the CUDA runtime calls of every thread, including the kernels the port
launches through ``ctypes``), exported as a Chrome trace into the run's
temporary directory and reduced to one summary:

- ``busy_s``: the union of the intervals in which a kernel, copy or set
  ran on the device; ``window_s``: the traced window on the host clock;
- ``device_ops``: device time by operation name, largest first;
- ``idle_gaps``: each gap between busy intervals named by the runtime
  call that overlaps it most (``_no_host_event_`` where none does),
  summed by name, largest first;
- ``htod_bytes`` / ``htod_s``: host-to-device copies' bytes and device
  time; ``kernel_s``: device time of every compute kernel (copies and
  sets excluded).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class DeviceTrace:
    def __init__(self, outdir: str):
        self.outdir = outdir
        self.window_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.monotonic() - self._t0
        self._prof.stop()

    def summary(self) -> Dict:
        path = os.path.join(self.outdir, "device_trace.json")
        self._prof.export_chrome_trace(path)
        del self._prof
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.unlink(path)
        out = summarize(events)
        out["window_s"] = self.window_s
        return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[Dict]) -> Dict:
    """Reduce Chrome trace events (microseconds) to the summary above."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append(e)
        elif e.get("cat") in HOST_CATS:
            host.append(e)
    by_name: Dict[str, float] = defaultdict(float)
    htod_bytes = htod_us = kernel_us = 0.0
    for e in dev:
        by_name[e["name"]] += e["dur"]
        if e["cat"] == "kernel":
            kernel_us += e["dur"]
        elif "HtoD" in e["name"]:
            htod_us += e["dur"]
            htod_bytes += float(e.get("args", {}).get("bytes", 0))
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    longest = max((e["dur"] for e in host), default=0.0)
    by_gap: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        best, name = 0.0, "_no_host_event_"
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g1)
        for e in host[lo:hi]:
            ov = min(g1, e["ts"] + e["dur"]) - max(g0, e["ts"])
            if ov > best:
                best, name = ov, e["name"]
        by_gap[name] += (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": [[n, s * 1e-6] for n, s in top],
        "idle_gaps": [[n, s * 1e-6] for n, s in idle],
        "htod_bytes": htod_bytes,
        "htod_s": htod_us * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "device_events": len(dev),
        "host_events": len(host),
    }
