"""blit_torch's SessionSupervisor (``blit/stream/session.py``), on the CPU.

A session of two recorder seats, each a supervised live consumer
(``python -m blit_torch.recover`` children on ``cpu``) fed by a replay
source spec; one seat is killed mid-stream by a seeded fault and rejoins
through its StreamCursor.  Both seats' products are byte-identical to
the batch reductions; the session report folds as blit's does, and the
``session`` command line runs the same spec.  SIGALRM deadline on every
test.
"""

import json
import signal

import pytest

from blit_torch.observability import Timeline
from blit_torch.pipeline import RawReducer
from blit_torch.stream import SessionSupervisor
from blit_torch.testing import synth_raw

NFFT, WF = 32, 4
CPU = "cpu"
DEADLINE_S = 150
KNOBS = dict(nfft=NFFT, chunk_frames=WF, tune_online=False)


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _seats(tmp_path, kill_seat=None):
    seats, oracles = [], {}
    for i in range(2):
        raw = str(tmp_path / f"blc0{i}.raw")
        synth_raw(raw, nblocks=4, obsnchan=2, ntime_per_block=512, seed=40 + i)
        oracle = str(tmp_path / f"oracle{i}.fil")
        RawReducer(device=CPU, **KNOBS).reduce_to_file(raw, oracle)
        seat = {"name": f"blc0{i}", "out": str(tmp_path / f"blc0{i}.fil"),
                "source": {"kind": "replay", "raw": raw, "rate": 500.0},
                "knobs": dict(KNOBS)}
        if i == kill_seat:
            seat["faults"] = "stream.chunk:kill:after=2"
        seats.append(seat)
        oracles[seat["name"]] = oracle
    return seats, oracles


def _same(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


class TestSessionSupervisor:
    def test_a_killed_seat_rejoins_and_every_product_matches(self, tmp_path):
        seats, oracles = _seats(tmp_path, kill_seat=1)
        tl = Timeline()
        rep = SessionSupervisor(seats, work_dir=str(tmp_path / "work"),
                                lease_ttl_s=3.0, poll_s=0.05, max_attempts=3,
                                timeline=tl, device=CPU).run()
        assert rep["ok"] is True and rep["kind"] == "session"
        assert rep["recovered_seats"] == ["blc01"]
        assert rep["seats"]["blc01"]["attempts"] == 2
        assert rep["seats"]["blc00"]["attempts"] == 1
        assert rep["masked_total"] == 0 and rep["wall_s"] > 0
        for s in seats:
            assert _same(s["out"], oracles[s["name"]]), s["name"]
        assert tl.gauges["session.seats"].last == 2
        assert tl.gauges["session.seats_recovering"].last == 0

    def test_a_seat_that_cannot_recover_fails_the_session(self, tmp_path):
        seats, _ = _seats(tmp_path)
        seats[0]["source"]["raw"] = str(tmp_path / "missing.raw")
        rep = SessionSupervisor(seats, work_dir=str(tmp_path / "work"),
                                lease_ttl_s=3.0, poll_s=0.05, max_attempts=1,
                                device=CPU).run()
        assert rep["ok"] is False
        assert rep["seats"]["blc00"]["ok"] is False
        assert rep["seats"]["blc01"]["ok"] is True

    def test_health_degrades_while_a_seat_recovers(self, tmp_path):
        sup = SessionSupervisor([{"name": "a", "out": "x"}, {"name": "b", "out": "y"}],
                                work_dir=str(tmp_path), device=CPU)
        assert sup._health() is None
        sup._phase["b"] = "recovering"
        h = sup._health()
        assert h["degraded"] is True and "b" in h["reason"]

    def test_refusals(self, tmp_path):
        with pytest.raises(ValueError, match="at least one seat"):
            SessionSupervisor([], work_dir=str(tmp_path))
        with pytest.raises(ValueError, match="duplicate seat names"):
            SessionSupervisor([{"name": "a"}, {"name": "a"}], work_dir=str(tmp_path))

    def test_session_command_line(self, tmp_path, capsys):
        from blit_torch.__main__ import main

        seats, oracles = _seats(tmp_path)
        spec = tmp_path / "session.json"
        spec.write_text(json.dumps({"seats": seats, "lease_ttl_s": 3.0,
                                    "poll_s": 0.05}))
        json_out = str(tmp_path / "rep.json")
        rc = main(["session", str(spec), "--work-dir", str(tmp_path / "w"),
                   "--json-out", json_out, "--device", CPU])
        assert rc == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["ok"] is True and rep["work_dir"] == str(tmp_path / "w")
        for s in seats:
            assert _same(s["out"], oracles[s["name"]]), s["name"]
        with open(json_out) as f:
            assert json.load(f)["ok"] is True
