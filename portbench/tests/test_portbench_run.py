"""The harness end to end on the CPU at tiny shapes, and ``run.py``'s
refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, rehearse

DEVICE_METRICS = ("device.idle_pct", "h2d.gbps", "kernels_roofline")


def test_last_line_schema(tree):
    rc, last, err = rehearse(tree, "tiny.0002")
    assert rc == 0, err
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "compared"
    assert last["correct"] is True, err
    assert last["attempted"] > 0 and last["failed"] == 0
    assert set(last["metrics"]) == {"raw_gbps", "setup_s"}
    for m in last["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in last["compared"].values():
        assert c["limit"] is not None and c["value"] <= c["limit"]
    tail = err.strip().splitlines()[-len(last["compared"]):]
    assert all(line.startswith("compared ") for line in tail)


def test_cpu_rehearsal_names_the_cpu_and_no_device_metric(tree):
    rc, last, err = rehearse(tree, "tiny.0002", trace=True)
    assert rc == 0, err
    assert last["device"]["platform"] == "cpu"
    assert "busy_s" not in last["device"] and "breakdown" not in last
    assert not set(DEVICE_METRICS) & set(last["metrics"])
    assert "fanout.straggler_ratio" in last["metrics"]
    assert "ingest.gbps" in last["metrics"]


def test_run_py_refuses_without_cuda():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "gbt_band_0002.ram",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in p.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "gbt_band_0002.ram",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "blit_torch" in p.stderr


def test_benchmark_json_names_every_plugin():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(REPO, "portbench")
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(pb, "kinds", cfg["kind"] + ".py"))
        assert all(v is not None for v in cfg["limits"].values())
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(pb, "traffic", w["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(pb, "metrics", m["name"] + ".py"))


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card (skips without one)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "gbt_band_0002.ram",
         "--seed", str((1 << 31) + 5), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["platform"] == "gpu"
