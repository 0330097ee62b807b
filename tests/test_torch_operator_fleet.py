"""The fleet commands of ``python -m blit_torch`` held against
``blit``'s: ``serve-bench --fleet`` and ``chaos --fleet --fault kill``,
each over real ``fleet-peer --device cpu`` subprocesses (each imports
torch, a few seconds).  The other drills and serve-bench modes:
``tests/test_torch_operator_drills.py``,
``tests/test_torch_operator_serve_modes.py``.

Every command runs at a tiny shape on the CPU; the JSON it prints has
``blit``'s key set at the same flags (the port's chaos reports add its
``device``), and each drill's verdict passes.  Every test runs under a
SIGALRM deadline, and the commands reap their peers on every exit.
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


def _chaos(main, argv, capsys, device):
    extra = ["--device", "cpu"] if device else []
    return _json_out(main, argv + extra, capsys)


def test_serve_bench_fleet_keys_equal_blit(tmp_path, capsys):
    argv = ["serve-bench", "--fleet", "--peers", "2", "--nfft", "64",
            "--requests", "16", "--distinct", "3", "--clients", "2",
            "--trace-out", str(tmp_path / "fleet.json")]
    rc, doc = _json_out(tcli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0 and doc["errors"] == []
    assert doc["wire"]["compat"]["byte_identical"] is True
    assert doc["request_log"]["by_status"] == {"ok": 16}
    assert doc["trace"]["cross_process_pairs"] >= 1
    argv[-1] = str(tmp_path / "bfleet.json")
    brc, bdoc = _json_out(bcli.main, argv, capsys)
    assert brc == 0
    sections = ("wire", "hedge", "request_log", "trace", "slo")
    assert _keys(doc, sections) == _keys(bdoc, sections)


def test_chaos_fleet_kill_keys_equal_blit(tmp_path, capsys):
    # blit's default replay (150 asks over 6 products): the hit-rate
    # windows around the kill need enough asks to be steady.
    argv = ["chaos", "--fleet", "--fault", "kill", "--peers", "3",
            "--lease-ttl", "1.5", "--poll", "0.05", "--nfft", "32"]
    rc, doc = _chaos(tcli.main, argv + ["--work-dir", str(tmp_path / "t")],
                     capsys, True)
    assert rc == 0 and doc["ok"] and doc["byte_identical"] and \
        doc["detected"], json.dumps(doc)
    brc, bdoc = _chaos(bcli.main, argv + ["--work-dir", str(tmp_path / "b")],
                       capsys, False)
    assert brc == 0, json.dumps(bdoc)
    assert set(doc) - set(bdoc) == {"device"} and set(bdoc) <= set(doc)
    assert sorted(doc["healthz"]) == sorted(bdoc["healthz"])
