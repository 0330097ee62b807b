"""The operator plane's commands of ``python -m blit_torch`` held against
``blit``'s: the two argparse trees, ``ingest-bench`` and
``testing.sync_compare_verdict``, ``serve-bench`` in one process,
``chaos --fault corrupt`` and the drills' refusals, and ``telemetry
--demo`` (the fleet commands: ``tests/test_torch_operator_fleet.py``).

Every command runs at a tiny shape on the CPU; the JSON it prints has
``blit``'s key set at the same flags (the port's chaos reports add its
``device``), and each drill's verdict passes.  Every test runs under a
SIGALRM deadline.
"""

import argparse
import json
import os
import signal
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import blit.__main__ as bcli  # noqa: E402
import blit_torch.__main__ as tcli  # noqa: E402
from blit.testing import sync_compare_verdict as bverdict  # noqa: E402
from blit_torch.testing import sync_compare_verdict, synth_fil  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120
# The subcommands that compute: each takes the port's one flag of its own.
COMPUTING = {"reduce", "search", "stream", "session", "scan", "ingest-bench",
             "tune", "serve-bench", "fleet-peer", "chaos", "fsck",
             "backfill", "telemetry"}


@pytest.fixture(autouse=True)
def deadline(tmp_path, monkeypatch):
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep +
                       os.environ.get("PYTHONPATH", ""))
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class _Parser(Exception):
    def __init__(self, parser):
        self.parser = parser


def _tree(mod):
    """{subcommand: {option strings: (nargs, default, choices, action)}}
    of a package's command line, read off the parser ``main`` builds."""
    def grab(self, *a, **k):
        raise _Parser(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        mod.main(["info", "x"])
    except _Parser as e:
        parser = e.parser
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {tuple(a.option_strings) or (a.dest,):
                   (a.nargs, a.default, tuple(a.choices or ()),
                    type(a).__name__)
                   for a in sp._actions}
            for name, sp in sub.choices.items()}


def test_every_blit_subcommand_and_flag_has_a_counterpart():
    port, ref = _tree(tcli), _tree(bcli)
    assert len(ref) == 22 and set(port) == set(ref)
    for cmd, flags in ref.items():
        extra = set(port[cmd]) - set(flags)
        assert extra == ({("--device",)} if cmd in COMPUTING else set()), cmd
        for opt, spec in flags.items():
            assert port[cmd][opt] == spec, (cmd, opt)
        if cmd in COMPUTING:
            assert port[cmd][("--device",)][1] == "cuda"
    assert set(port["chaos"][("--fault",)][2]) == {
        "kill", "hang", "corrupt", "partition", "resize", "reorder"}


def _json_out(main, argv, capsys):
    rc = main(argv)
    text = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(text[-1])


def _keys(doc, sections):
    out = {"": sorted(doc)}
    for s in sections:
        v = doc[s]
        out[s] = sorted(v[0] if isinstance(v, list) else v)
    return out


def test_ingest_bench_keys_and_verdict_equal_blit(capsys):
    argv = ["ingest-bench", "--nfft", "64", "--nchan", "2", "--chunk-frames",
            "4", "--chunks", "4", "--blocks", "2", "--sync-compare",
            "--dedoppler", "--dedoppler-window", "4", "--live",
            "--live-seconds", "0.3", "--spans-compare", "--spans-reps", "1",
            "--history-compare", "--digests"]
    rc, doc = _json_out(tcli.main, argv + ["--device", "cpu"], capsys)
    brc, bdoc = _json_out(bcli.main, argv, capsys)
    assert rc == brc == 0
    sections = ("legs", "dedoppler", "live", "ingest_config")
    assert _keys(doc, sections) == _keys(bdoc, sections)
    assert doc["products_identical"] is True is bdoc["products_identical"]
    assert doc["file_bytes"] == bdoc["file_bytes"]
    assert [g["product_bytes"] for g in doc["legs"]] == \
        [g["product_bytes"] for g in bdoc["legs"]]
    assert doc["ingest_config"]["digests"] is True
    assert doc["live"]["stalls"] == 0


def test_ingest_bench_drill_legs(capsys):
    rc, doc = _json_out(tcli.main, [
        "ingest-bench", "--device", "cpu", "--nfft", "64", "--nchan", "2",
        "--chunk-frames", "4", "--chunks", "4", "--blocks", "2",
        "--live-drill", "--live", "--packets", "--packet-drop", "0.05",
        "--chaos"], capsys)
    assert rc == 0
    assert doc["chaos"]["recovered"] and doc["chaos"]["products_identical"]
    assert doc["chaos"]["cursor_removed"]
    assert doc["live"]["stalls"] == 0 and "packet" in doc["live"]
    assert doc["live_drill"]["stalls"] == 0


def test_sync_compare_verdict_equals_blit(tmp_path):
    a, b, c = (str(tmp_path / f"{n}.fil") for n in "abc")
    synth_fil(a, seed=1)
    synth_fil(b, seed=1)
    synth_fil(c, seed=2)
    for x, y in ((a, b), (a, c)):
        got = sync_compare_verdict(x, y, async_wall_s=0.5, sync_wall_s=0.8)
        assert got == bverdict(x, y, async_wall_s=0.5, sync_wall_s=0.8)
    assert sync_compare_verdict(a, b, 0.5, 0.8) == \
        {"async_speedup": 1.6, "products_identical": True}
    assert sync_compare_verdict(a, c, 0.0, 1.0)["products_identical"] is False


def test_serve_bench_keys_equal_blit(capsys):
    argv = ["serve-bench", "--nfft", "64", "--requests", "16", "--distinct",
            "3", "--clients", "2", "--request-log-compare"]
    rc, doc = _json_out(tcli.main, argv + ["--device", "cpu"], capsys)
    brc, bdoc = _json_out(bcli.main, argv, capsys)
    assert rc == brc == 0
    assert _keys(doc, ("off", "on")) == _keys(bdoc, ("off", "on"))
    assert sorted(doc["on"]["cache"]) == sorted(bdoc["on"]["cache"])
    assert doc["off_records"] == 0 and doc["on_records"] > 0
    assert doc["on"]["errors"] == doc["off"]["errors"] == []


def _chaos(main, argv, capsys, device):
    extra = ["--device", "cpu"] if device else []
    return _json_out(main, argv + extra, capsys)


def test_chaos_refusals_and_corrupt_equal_blit(tmp_path, capsys):
    for argv in (["chaos", "--fleet", "--fault", "corrupt"],
                 ["chaos", "--fault", "partition"],
                 ["chaos", "--fault", "resize"],
                 ["chaos", "--fault", "reorder"]):
        assert tcli.main(argv + ["--device", "cpu"]) == 2 == bcli.main(argv)
    argv = ["chaos", "--fault", "corrupt", "--nfft", "32"]
    rc, doc = _chaos(tcli.main, argv + ["--work-dir", str(tmp_path / "t")],
                     capsys, True)
    brc, bdoc = _chaos(bcli.main, argv + ["--work-dir", str(tmp_path / "b")],
                       capsys, False)
    assert rc == brc == 0
    assert set(doc) - set(bdoc) == {"device"}
    assert doc["byte_identical"] and doc["recovered"]
    assert doc["masked_blocks"] == bdoc["masked_blocks"] == [2]
    assert doc["integrity"] == bdoc["integrity"]


def test_telemetry_demo_and_watch(tmp_path, capsys):
    from blit_torch import observability

    # The demo reports this process's timeline: start it from zero.
    observability.process_timeline().reset()
    trace = str(tmp_path / "t.json")
    rc, doc = _json_out(tcli.main, [
        "telemetry", "--demo", "--workers", "2", "--backend", "thread",
        "--nfft", "64", "--trace-out", trace, "--format", "json",
        "--device", "cpu"], capsys)
    assert rc == 0
    (entry,) = doc["hosts"].values()
    assert entry["stages"]["stream"]["calls"] == 2
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert tcli.main(["telemetry", "--watch", "0.01", "--iterations", "2",
                      "--format", "json"]) == 0
    frames = capsys.readouterr().out
    assert frames.count("\x1b[2J") == 2


def test_operator_commands_refuse_without_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for argv in (["ingest-bench", "--nfft", "64", "--nchan", "2"],
                 ["telemetry", "--demo", "--nfft", "64"],
                 ["serve-bench", "--nfft", "64", "--requests", "2"]):
        out = subprocess.run([sys.executable, "-m", "blit_torch", *argv],
                             cwd=str(tmp_path), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0, argv
        assert "CUDA" in out.stderr, argv
        lines = out.stdout.strip().splitlines()
        assert not lines or not lines[-1].startswith("{"), argv
