"""CPU rehearsals of the benchmark at tiny shapes.

Each rehearsal runs in a subprocess, from a copy of ``portbench/`` that
holds tiny configurations (the cells' own, cut to 2 banks of 4 coarse
channels and 32 KiB blocks, with the cells' own limits) and a tiny
traffic mix, so a test can also add files to its copy.  The subprocess
skips the harness's look for a card (``run_cell`` on ``cpu``), may plant
a fault in the program first, and prints the run's lines as a run on the
card would.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORTBENCH = os.path.join(REPO, "portbench")
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # the tests import ``portbench`` and the port
SEED = (1 << 31) + 977  # past 32 signed bits: seeds that large must work
TINY = {"banks": 2, "obsnchan": 4, "block_bytes": 4 * 2 * 2 * 8192,
        "pool_blocks": 3}


def _tiny_config(name: str, product: dict) -> dict:
    with open(os.path.join(PORTBENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["name"] = "tiny_" + name
    cfg["product"] = dict(cfg["product"], **product)
    return cfg


def make_tree(root: str) -> str:
    """A copy of the benchmark under ``root`` with the tiny cell
    ``tiny.0002`` in its ``BENCHMARK.json``."""
    shutil.copytree(PORTBENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    configs = {
        "tiny_0002": _tiny_config("gbt_band_0002", {"nfft": 64, "nint": 8}),
    }
    for name, cfg in configs.items():
        with open(os.path.join(root, "portbench", "configs", name + ".json"),
                  "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(PORTBENCH, "traffic", "ram.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny", warmup_blocks=4)
    traffic["signal"] = dict(traffic["signal"], tone_chan=1)
    with open(os.path.join(root, "portbench", "traffic", "tiny.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {"tiny.0002": "tiny_0002"}
    real = {"gbt_band_0002.ram": "tiny.0002"}
    bench["configs"] = [{"name": n, "file": f"portbench/configs/{n}.json"}
                        for n in configs]
    bench["workloads"] = [{"name": w, "config": c, "traffic": "tiny",
                           "chips": 1} for w, c in cells.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"] if w in real]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def rehearse(tree: str, workload: str, *, trace: bool = False,
             control: bool = False, fault: str = "", seconds: float = 1.0):
    """Run ``workload`` of ``tree`` on the CPU; returns ``(returncode,
    last stdout line as a dict or None, stderr)``."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{tree!r}, {REPO!r}]
    """) + textwrap.dedent(fault) + textwrap.dedent(f"""
        from portbench import harness
        cell = harness.Cell(harness.read_json("BENCHMARK.json"), {workload!r},
                            root={tree!r})
        r = harness.run_cell(cell, {SEED}, {seconds}, {trace}, device="cpu",
                             t_start=time.monotonic(), control={control})
        harness.emit(r)
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLIT_")}
    p = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, last, p.stderr


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("portbench_tree")))
