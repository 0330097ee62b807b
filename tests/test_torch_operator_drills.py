"""``chaos --fleet --fault partition`` and ``--fault resize`` of
``python -m blit_torch`` at ``blit``'s own drill shape, over three real
``fleet-peer --device cpu`` subprocesses: every served product
byte-identical to the one-process oracle, the peer ejected (and, after a
partition, rejoined; during a resize, the membership flip completed),
and the eject's incident bundle written.  Every test runs under a
SIGALRM deadline, and the command reaps its peers on every exit.
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


@pytest.mark.parametrize("fault", ["partition", "resize"])
def test_chaos_fleet_partition_and_resize_recover(tmp_path, capsys, fault):
    inc = tmp_path / "incidents"
    os.environ["BLIT_INCIDENT_DIR"] = str(inc)
    try:
        # blit's default replay (150 asks over 6 products): the hit-rate
        # windows around the fault need enough asks to be steady.
        rc, doc = _chaos(tcli.main, [
            "chaos", "--fleet", "--fault", fault, "--peers", "3",
            "--fleet-requests", "150", "--fleet-distinct", "6",
            "--lease-ttl", "2.0", "--nfft", "32",
            "--work-dir", str(tmp_path / "w")], capsys, True)
    finally:
        del os.environ["BLIT_INCIDENT_DIR"]
    assert rc == 0 and doc["ok"] and doc["byte_identical"], json.dumps(doc)
    if fault == "partition":
        assert doc["rejoined"] is True
    else:
        assert doc["flip_completed"] and doc["resizing_status"] == "resizing"
    # The door's eject wrote an incident bundle.
    assert any("fleet-eject" in d for d in os.listdir(inc))
