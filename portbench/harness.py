"""The harness: one cell of ``BENCHMARK.json``, end to end.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``BENCHMARK.json`` names the configuration's file
and the cell's traffic; the configuration's ``kind`` names
``portbench/kinds/<kind>.py`` (how a bank is reduced and how its
product is judged); ``portbench/traffic/<traffic>.json`` holds the
traffic's parameters; each metric is ``portbench/metrics/<name>.py``,
whose ``read(run)`` returns the metric's value from the run, or None
where the run holds nothing to read.

A run: draw every bank's RAM pool on the device from the seed, stream
``warmup_blocks`` blocks through every bank (kernels loaded, pinned
slots allocated), then open the window: every bank's live stream starts
at once, fed by its RAM ring; at ``seconds`` the sources stop, each
stream drains and finalizes its product, and the window closes when the
last bank's product is complete.  Then the memory peak is read, the
program's state freed, and the products judged against the plain
reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "blit")
# The largest realistic drain after stop(): every bank's last chunks.
JOIN_TIMEOUT_S = 120.0


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def plugin(folder: str, name: str):
    """``portbench/<folder>/<name>.py``, loaded by path."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {folder} module named {name!r} "
                         f"({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its
    traffic and the metrics it reports."""

    def __init__(self, bench: Dict, workload: str, root: str = ROOT):
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise SystemExit(f"portbench: no workload {workload!r} in "
                             "BENCHMARK.json")
        w = found[0]
        self.name, self.chips = w["name"], int(w["chips"])
        entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
        self.config = read_json(os.path.join(root, entry["file"]))
        self.traffic = read_json(
            os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        self.kind = plugin("kinds", self.config["kind"])

        def mine(m):
            return "workloads" not in m or self.name in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


class Run:
    """What a finished window leaves for the metric readers."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.raw_bytes = 0
        self.banks: List[Dict] = []
        self.trace: Optional[Dict] = None
        self.work_bytes = 0.0
        self.work_flops = 0.0


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _stream_banks(cell: Cell, reducers, pools, headers, out_dir: str, tag: str,
                  *, limit: Optional[int], seconds: float,
                  on_open=None) -> Dict:
    """Run every bank's live stream at once, each on a thread of its own.
    ``limit`` blocks a bank, or until ``seconds`` after the start.
    Returns the start time, each bank's end time, header and samples."""
    from portbench.ringsource import RamRing
    from portbench.synth import block_ntime

    go = threading.Event()
    sources = [RamRing(pool, hdr, go, limit=limit,
                       bank_gbps=cell.traffic.get("bank_gbps"),
                       path=f"{tag}-bank{b}")
               for b, (pool, hdr) in enumerate(zip(pools, headers))]
    out = [None] * len(reducers)
    errors: List[str] = []

    def bank(b: int) -> None:
        path = os.path.join(out_dir, f"{tag}.bank{b}{cell.kind.SUFFIX}")
        try:
            hdr = cell.kind.run(reducers[b], sources[b], path)
            out[b] = {"header": hdr, "end": time.monotonic(), "product": path}
        except BaseException:  # noqa: BLE001 — reported by the caller
            errors.append(f"bank {b}:\n{traceback.format_exc()}")
            for s in sources:
                s.stop()

    threads = [threading.Thread(target=bank, args=(b,), name=f"bank{b}")
               for b in range(len(reducers))]
    for t in threads:
        t.start()
    if on_open is not None:
        on_open()
    t0 = time.monotonic()
    go.set()
    if limit is None:
        deadline = t0 + seconds
        while time.monotonic() < deadline and not errors:
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
        for s in sources:
            s.stop()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        errors.append(f"streams still running {JOIN_TIMEOUT_S} s after "
                      f"stop: {alive}")
    if errors:
        raise RuntimeError("\n".join(errors))
    ntime = block_ntime(cell.config)
    for b, s in enumerate(sources):
        out[b]["samples"] = s.delivered * ntime
    return {"start": t0, "banks": out}


def _stages(timeline) -> Dict:
    return {k: {"seconds": v.seconds, "bytes": v.bytes, "calls": v.calls}
            for k, v in timeline.stages.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str, t_start: float, control: bool = False) -> Dict:
    """One run of ``cell``; returns the result record (the last line's
    object) and the compared numbers."""
    import numpy as np
    import torch

    from blit_torch.observability import Timeline
    from portbench import synth

    cfg, traffic = cell.config, cell.traffic
    dtype = cfg["control_dtype"] if control else cfg["product"]["dtype"]
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        headers = [synth.bank_header(cfg, b) for b in range(cfg["banks"])]
        pools = [synth.bank_pool(cfg, traffic["signal"], seed, b, device)
                 for b in range(cfg["banks"])]
        log(f"pools drawn at {time.monotonic() - t_start:.2f} s")
        warm = [cell.kind.make(cfg, device, Timeline(), dtype)
                for _ in headers]
        _stream_banks(cell, warm, pools, headers, tmp, "warmup",
                      limit=traffic["warmup_blocks"], seconds=0.0)
        del warm
        log(f"warm-up done at {time.monotonic() - t_start:.2f} s")
        reducers = [cell.kind.make(cfg, device, Timeline(), dtype)
                    for _ in headers]
        for b, red in enumerate(reducers):
            prov = red.tuning_provenance()
            log(f"bank {b} tuning_provenance {json.dumps(prov, sort_keys=True)}")
            if "profile" in prov["sources"].values():
                raise RuntimeError("a knob came from a tuning profile on disk; "
                                   "the benchmark runs the port's defaults")
        dtrace = None
        if trace and on_card:
            from portbench.devtrace import DeviceTrace

            dtrace = DeviceTrace(tmp)
        window = _stream_banks(
            cell, reducers, pools, headers, tmp, "window", limit=None,
            seconds=seconds, on_open=dtrace.start if dtrace else None)
        if dtrace is not None:
            dtrace.stop()
        run = Run()
        run.setup_s = window["start"] - t_start
        run.window_s = max(b["end"] for b in window["banks"]) - window["start"]
        nchan = cfg["obsnchan"]
        raw_per_sample = nchan * cfg["npol"] * 2 * cfg["nbits"] // 8
        nfft = cfg["product"]["nfft"]
        for b, w in enumerate(window["banks"]):
            frames = cell.kind.frames_done(cfg, w["header"])
            nbytes = frames * nfft * raw_per_sample
            run.raw_bytes += nbytes
            run.banks.append({"bytes": nbytes,
                              "seconds": w["end"] - window["start"],
                              "stages": _stages(reducers[b].timeline)})
            run.work_bytes += frames * nfft * nchan * cfg["work"]["bytes_per_sample"]
            run.work_flops += frames * nfft * nchan * cfg["work"]["flops_per_sample"]
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if dtrace is not None:
            run.trace = dtrace.summary()
        del reducers
        from blit_torch import hostmem

        hostmem.slab_pool().clear()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_judge = time.monotonic()
        rng = np.random.default_rng(seed)
        judged = cell.kind.judge(
            cfg, [{"pool": pools[b], "raw_header": headers[b],
                   "product": w["product"], "samples": w["samples"]}
                  for b, w in enumerate(window["banks"])],
            rng, device)
        del pools
        log(f"judged in {time.monotonic() - t_judge:.2f} s")
        compared = {k: {"value": v, "limit": cfg["limits"].get(k)}
                    for k, v in judged["numbers"].items()}
        correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                      for c in compared.values())
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            v = plugin("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
               "count": cell.chips if on_card else 1,
               "memory_peak_bytes": int(memory_peak)}
        result = {"correct": bool(correct),
                  "attempted": int(judged["attempted"]),
                  "failed": int(judged["failed"]),
                  "metrics": metrics, "device": dev}
        if run.trace is not None:
            dev["busy_s"] = run.trace["busy_s"]
            dev["window_s"] = run.trace["window_s"]
            result["breakdown"] = {"device_ops": run.trace["device_ops"],
                                   "idle_gaps": run.trace["idle_gaps"]}
            log(f"trace: {run.trace['device_events']} device events, "
                f"{run.trace['host_events']} runtime calls")
        stages = {}
        for bk in run.banks:
            for k, v in bk["stages"].items():
                stages[k] = stages.get(k, 0.0) + v["seconds"]
        log("stage seconds summed over banks "
            + json.dumps({k: round(v, 3) for k, v in sorted(stages.items())}))
        realtime = run.raw_bytes / run.window_s / 1e9 / cell.config["banks"] / 0.75
        log(f"window {run.window_s:.3f} s, {run.raw_bytes} RAW bytes finished, "
            f"real-time factor per bank {realtime:.3f} (0.75 GB/s a bank)")
        result["compared"] = compared
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def emit(result: Dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output."""
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(bench, args.workload)

    import torch

    import blit_torch  # noqa: F401  (the system under test: fail here without it)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}; the benchmark measures blit_torch alone")
        return 3
    emit(result)
    return 0
