"""Readings for the limits of ``correct``: the program, and the control
(the program's own lower-precision path, the configuration's
``control_dtype``), on many seeds in one process at the cell's own
size and load, each over a short window.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <a,b,...> --control-seeds <x,y,...>

Prints one JSON line a run: its side, seed, compared numbers and
``raw_gbps``.  The benchmark's own runs never run the control.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
for _k in [k for k in os.environ if k.startswith("BLIT_")]:
    del os.environ[_k]


def main(argv=None) -> int:
    import argparse

    from portbench import harness

    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.read_json(os.path.join(ROOT, "BENCHMARK.json")),
                        args.workload)
    runs = [(False, int(s)) for s in args.seeds.split(",") if s] + \
           [(True, int(s)) for s in args.control_seeds.split(",") if s]
    for control, seed in runs:
        t0 = time.monotonic()
        r = harness.run_cell(cell, seed, args.seconds, False,
                             device="cuda", t_start=t0, control=control)
        print(json.dumps({
            "side": "control" if control else "program", "seed": seed,
            "numbers": {k: c["value"] for k, c in r["compared"].items()},
            "raw_gbps": r["metrics"].get("raw_gbps", {}).get("value"),
            "attempted": r["attempted"],
            "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
