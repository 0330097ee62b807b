"""blit_torch's crash-recovery plane, on the CPU.

Unit legs against blit (``blit/recover.py``): ``replan`` over a grid of
inputs, the leases, the lease watch, the ``/healthz`` hook.  Drills: real
supervised pods (children ``python -m blit_torch.recover``, seated on
``cpu``, gloo) under seeded ``kill`` / ``hang`` faults: detection within
the lease budget, the re-plan (a smaller pod or the pool path), and
products byte-identical to the pool oracle; the live-consumer rejoin;
``python -m blit_torch chaos``.  Every test has a SIGALRM deadline; the
supervisors kill their children on every exit path.
"""

import json
import os
import signal
import time

import pytest

from blit_torch.observability import Timeline
from blit_torch.recover import (
    RECOVER_HISTS,
    Lease,
    LeaseWatch,
    ScanPlan,
    ScanSupervisor,
    StreamSupervisor,
    active_supervisors,
    lease_age_s,
    read_lease,
    replan,
)
from blit_torch.testing import synth_raw

NFFT, WF = 32, 4
CPU = "cpu"
DEADLINE_S = 150


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _grid(tmp_path, nband=2, nbank=2, nchan=2):
    bank_bw = -187.5 / nbank
    grid = []
    for b in range(nband):
        row = []
        for k in range(nbank):
            p = str(tmp_path / f"blc{b}{k}.raw")
            synth_raw(p, nblocks=2, obsnchan=nchan, ntime_per_block=512,
                      seed=b * 8 + k, tone_chan=k % nchan, obsbw=bank_bw,
                      obsfreq=8000.0 + b * 500.0 + (k + 0.5) * bank_bw)
            row.append(p)
        grid.append(row)
    return grid


def _pool_oracle(grid, tmp_path):
    from blit_torch.parallel.scan import reduce_scan_pool_to_files

    d = tmp_path / "oracle"
    d.mkdir(exist_ok=True)
    return reduce_scan_pool_to_files(grid, out_dir=str(d), nfft=NFFT,
                                     despike=False, window_frames=WF, device=CPU)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


class TestReplan:
    @pytest.mark.parametrize("nband,nbank", [(1, 1), (1, 8), (2, 2), (2, 4),
                                             (4, 8), (3, 2)])
    def test_equal_to_blits_over_a_grid(self, nband, nbank):
        from blit.recover import replan as r_replan

        for dpp in (None, 1, 2, 4, 8, 16, 64):
            for alive in range(-1, 10):
                got, want = (replan(nband, nbank, dpp, alive),
                             r_replan(nband, nbank, dpp, alive))
                assert (got.mode, got.nprocs, got.devices_per_proc) == \
                    (want.mode, want.nprocs, want.devices_per_proc), \
                    (nband, nbank, dpp, alive)

    def test_ladder(self):
        assert replan(2, 2, 4, 2) == ScanPlan("sharded", 2, 2)
        assert replan(2, 2, 4, 1) == ScanPlan("sharded", 1, 4)
        assert replan(2, 2, 2, 1) == ScanPlan("pool")
        assert replan(1, 8, 4, 2) == ScanPlan("pool")  # rows would split
        assert replan(2, 2, 4, 0) == ScanPlan("pool")


class TestLease:
    def test_beat_refreshes_and_reads_back(self, tmp_path):
        lease = Lease(str(tmp_path), 3)
        assert lease_age_s(str(tmp_path), 3) is not None or True
        lease.beat(7)
        rec = read_lease(str(tmp_path), 3)
        assert rec["proc"] == 3 and rec["window"] == 7 and rec["n"] == 1
        assert rec["pid"] == os.getpid()
        assert lease_age_s(str(tmp_path), 3) < 5

    def test_missing_lease_has_no_age(self, tmp_path):
        assert lease_age_s(str(tmp_path), 0) is None
        assert read_lease(str(tmp_path), 0) is None

    def test_watch_arms_the_ttl_after_the_warm_beats(self, tmp_path):
        lease = Lease(str(tmp_path), 0)
        w = LeaseWatch(str(tmp_path), 0, ttl_s=0.2, grace_s=30.0)
        w.observe()
        assert not w.seen and not w.stalled()
        for i in range(3):  # three beats between two polls still count
            lease.beat(i)
        w.observe()
        assert w.seen and w.fresh()
        time.sleep(0.4)
        assert w.stalled() and w.age_s() >= 0.2

    def test_watch_holds_the_grace_before_warm(self, tmp_path):
        Lease(str(tmp_path), 0).beat(-1)
        w = LeaseWatch(str(tmp_path), 0, ttl_s=0.1, grace_s=30.0)
        w.observe()
        time.sleep(0.3)
        assert not w.stalled()


class TestHealth:
    def test_mid_recovery_degrades_healthz(self):
        from blit_torch import monitor
        from blit_torch.recover import _register, _unregister

        pub = monitor.MetricsPublisher(interval_s=60, spool_dir=None, port=None)
        try:
            assert pub.health()["status"] == "ok"
            key = _register({"kind": "reduce", "phase": "recovering",
                             "attempt": 1, "plan": "pool"})
            try:
                assert any(s["phase"] == "recovering" for s in active_supervisors())
                h = pub.health()
                assert h["status"] == "degraded" and h["ok"] is False
                assert any(r.startswith("recover:") for r in h["reasons"])
            finally:
                _unregister(key)
            assert pub.health()["status"] == "ok"
        finally:
            pub.close()

    def test_hist_names_unchanged(self):
        from blit.recover import RECOVER_HISTS as R

        assert RECOVER_HISTS == R


class TestScanSupervisorDrills:
    def _sup(self, grid, out_dir, *, devices_per_proc, faults, tl=None, **kw):
        return ScanSupervisor(
            grid, out_dir=str(out_dir), kind="reduce", nfft=NFFT, despike=False,
            window_frames=WF, nprocs=2, devices_per_proc=devices_per_proc,
            lease_ttl_s=3.0, poll_s=0.05, max_attempts=3, faults=faults,
            timeline=tl if tl is not None else Timeline(), device=CPU, **kw)

    def test_kill_reshapes_the_pod_and_resumes_byte_identical(self, tmp_path):
        grid = _grid(tmp_path)
        oracle = _pool_oracle(grid, tmp_path)
        tl = Timeline()
        rep = self._sup(grid, tmp_path / "prod", devices_per_proc=4,
                        faults={0: "mesh.window:kill:after=2"}, tl=tl).run()
        assert rep["recovered"] is True
        assert rep["attempts"][0]["failure"]["why"] == "died"
        assert rep["attempts"][0]["failure"]["rc"] == -9
        assert rep["attempts"][1]["plan"] == "sharded"
        assert rep["attempts"][1]["nprocs"] == 1
        for b, (opath, _) in oracle.items():
            got = str(tmp_path / "prod" / os.path.basename(opath))
            assert _bytes(got) == _bytes(opath), f"band {b} differs"
        hists = tl.report().get("hists", {})
        for h in RECOVER_HISTS:
            assert hists.get(h, {}).get("n", 0) >= 1, h
        assert not [p for p in os.listdir(tmp_path / "prod") if p.endswith(".cursor")]
        assert rep["result"]["proc0"]["backend"] is None  # one process: no group

    def test_kill_without_capacity_falls_back_to_the_pool(self, tmp_path):
        grid = _grid(tmp_path)
        oracle = _pool_oracle(grid, tmp_path)
        rep = self._sup(grid, tmp_path / "prod", devices_per_proc=2,
                        faults={1: "mesh.window:kill:after=1"}).run()
        assert rep["recovered"] is True
        assert rep["attempts"][1]["plan"] == "pool"
        for b, (opath, _) in oracle.items():
            got = str(tmp_path / "prod" / os.path.basename(opath))
            assert _bytes(got) == _bytes(opath), f"band {b} differs"
        assert not [p for p in os.listdir(tmp_path / "prod") if p.endswith(".cursor")]

    def test_hang_detected_by_lease_expiry(self, tmp_path):
        grid = _grid(tmp_path)
        oracle = _pool_oracle(grid, tmp_path)
        rep = self._sup(grid, tmp_path / "prod", devices_per_proc=4,
                        faults={0: "mesh.window:hang:after=2:hang=120"}).run()
        assert rep["recovered"] is True
        fail = rep["attempts"][0]["failure"]
        assert fail["why"] == "hung" and fail["detect_s"] < 3.0 + 2.0
        for b, (opath, _) in oracle.items():
            got = str(tmp_path / "prod" / os.path.basename(opath))
            assert _bytes(got) == _bytes(opath), f"band {b} differs"

    def test_clean_two_process_pod_reports_its_group(self, tmp_path):
        grid = _grid(tmp_path)
        oracle = _pool_oracle(grid, tmp_path)
        rep = self._sup(grid, tmp_path / "prod", devices_per_proc=2,
                        faults=None).run()
        assert rep["recovered"] is False and len(rep["attempts"]) == 1
        assert rep["result"]["proc0"]["backend"] == "gloo"
        assert rep["result"]["proc1"]["players"] == 2
        for b, (opath, _) in oracle.items():
            got = str(tmp_path / "prod" / os.path.basename(opath))
            assert _bytes(got) == _bytes(opath), f"band {b} differs"

    def test_refusals(self, tmp_path):
        with pytest.raises(ValueError, match="unknown scan kind"):
            ScanSupervisor([["a"]], out_dir=str(tmp_path), kind="x", nfft=32,
                           device=CPU)
        with pytest.raises(ValueError, match="rectangular"):
            ScanSupervisor([["a", "b"], ["c"]], out_dir=str(tmp_path), nfft=32,
                           device=CPU)
        with pytest.raises(ValueError, match="out_dir"):
            ScanSupervisor([["a"]], nfft=32, device=CPU)


class TestStreamSupervisorDrill:
    def test_killed_consumer_rejoins_byte_identical(self, tmp_path):
        from blit_torch.pipeline import RawReducer
        from blit_torch.stream import StreamCursor

        raw = str(tmp_path / "live.raw")
        synth_raw(raw, nblocks=4, obsnchan=2, ntime_per_block=512, seed=3)
        oracle = str(tmp_path / "oracle.fil")
        RawReducer(nfft=NFFT, chunk_frames=WF, tune_online=False,
                   device=CPU).reduce_to_file(raw, oracle)
        out = str(tmp_path / "live.fil")
        tl = Timeline()
        rep = StreamSupervisor(
            raw, out, kind="reduce",
            knobs=dict(nfft=NFFT, chunk_frames=WF, tune_online=False),
            replay_rate=500.0, faults="stream.chunk:kill:after=2",
            lease_ttl_s=3.0, poll_s=0.05, max_attempts=3, timeline=tl,
            device=CPU).run()
        assert rep["recovered"] is True
        assert rep["attempts"][0]["failure"]["rc"] == -9
        assert _bytes(out) == _bytes(oracle)
        assert StreamCursor.load(out) is None
        assert tl.report()["hists"]["recover.detect_s"]["n"] >= 1


class TestChaosCLI:
    @pytest.mark.parametrize("workload,extra", [
        ("stream", ()),
        ("scan", ("--devices-per-proc", "4")),
        ("scan-search", ()),
    ])
    def test_chaos_drill_recovers_identically(self, tmp_path, capsys, workload,
                                              extra):
        from blit_torch.__main__ import main

        json_out = str(tmp_path / "chaos.json")
        rc = main(["chaos", "--workload", workload, "--lease-ttl", "3",
                   "--poll", "0.05", "--work-dir", str(tmp_path / "work"),
                   "--json-out", json_out, "--device", CPU, *extra])
        with open(json_out) as f:
            rep = json.load(f)
        assert rc == 0, rep
        assert rep["recovered"] is True and rep["byte_identical"] is True
        assert rep["recover"]["recover.detect_s"].get("n", 0) >= 1
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line)["byte_identical"] is True

    def test_reorder_needs_the_stream_workload(self, tmp_path, capsys):
        from blit_torch.__main__ import main

        assert main(["chaos", "--workload", "scan", "--fault", "reorder",
                     "--work-dir", str(tmp_path), "--device", CPU]) == 2
