"""``serve-bench --diurnal`` and ``--archive-day`` of ``python -m
blit_torch`` held against ``blit``'s: at a tiny shape on the CPU, over
real ``fleet-peer --device cpu`` subprocesses, each passes its own
verdict and prints ``blit``'s key set.  Every test runs under a SIGALRM
deadline, and the commands reap their peers on every exit.
"""

import json
import os
import signal

import pytest

pytest.importorskip("jax")

import blit.__main__ as bcli  # noqa: E402
import blit_torch.__main__ as tcli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120


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


def test_serve_bench_diurnal_recovers_and_keys_equal_blit(tmp_path):
    argv = ["serve-bench", "--diurnal", "--peers", "2", "--cycles", "1",
            "--requests", "24", "--distinct", "6", "--clients", "3",
            "--nfft", "128", "--hysteresis", "1.0", "--idle-windows", "2"]
    docs = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (bcli.main, [])):
        out = tmp_path / f"{len(docs)}.json"
        assert main(argv + ["--out", str(out)] + extra) == 0
        docs.append(json.loads(out.read_text()))
    doc, bdoc = docs
    assert doc["ok"] and doc["scale_outs"] == 1 and doc["scale_ins"] == 1
    assert doc["requests_to_departed"] == 0 and doc["slo"]["ok"]
    assert _keys(doc, ("slo", "cycles_detail")) == \
        _keys(bdoc, ("slo", "cycles_detail"))


def test_serve_bench_archive_day_keys_equal_blit(tmp_path, capsys):
    argv = ["serve-bench", "--archive-day", "--peers", "2", "--sessions",
            "2", "--distinct", "2", "--requests", "20", "--nfft", "64"]
    rc, doc = _json_out(tcli.main, argv + ["--device", "cpu"], capsys)
    brc, bdoc = _json_out(bcli.main, argv, capsys)
    assert rc == brc == 0 and doc["errors"] == []
    assert doc["ab"]["byte_identical"] and doc["ab"]["addressing_byte_identical"]
    assert _keys(doc, ("ab", "metrics", "config")) == \
        _keys(bdoc, ("ab", "metrics", "config"))
    assert doc["config"]["backend"] == "cpu"
