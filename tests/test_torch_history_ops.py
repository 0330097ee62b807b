"""The port's history store, anomaly baselines, incident bundles and SLO
report held against ``blit``'s.

A ring written by either package reads back equal in the other; both
detectors page on the same tick of the same series; ``slo_report`` and
its rendering are equal; both packages' bundles carry the same files
and manifest keys; the config's history knobs resolve alike; a peer
with a store answers ``/history`` enabled; the front door's eject and
the scan supervisor's peer death write bundles.  Tests that start a
thread or a server run under a SIGALRM deadline.
"""

import json
import os
import random
import signal
import subprocess
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

from blit import history as BH  # noqa: E402
from blit import monitor as bmonitor  # noqa: E402
from blit import observability as bobs  # noqa: E402
from blit.config import SiteConfig as BSiteConfig  # noqa: E402
from blit.config import history_defaults as bhistory_defaults  # noqa: E402
from blit_torch import history as TH  # noqa: E402
from blit_torch import monitor as tmonitor  # noqa: E402
from blit_torch import observability as tobs  # noqa: E402
from blit_torch.config import SiteConfig, history_defaults  # noqa: E402

# A minute-aligned start two minutes back: the one-shot readers query
# against the wall clock.
T0 = float(int(time.time()) // 64 * 64 - 128)
DEADLINE_S = 60


@pytest.fixture(autouse=True)
def isolate(tmp_path, monkeypatch):
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    for var in list(os.environ):
        if var.startswith(("BLIT_HISTORY", "BLIT_INCIDENT", "BLIT_SLO",
                           "BLIT_MONITOR", "BLIT_REQUEST_LOG")):
            monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path))
    TH.reset_bundler()
    BH.reset_bundler()
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    TH.reset_bundler()
    BH.reset_bundler()
    tmonitor.shutdown_publisher()


class Clock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _delta(obs, calls=2, nbytes=1 << 20, lat=0.02, gauge=None):
    tl = obs.Timeline()
    s = tl.stages["ingest.chunks"]
    s.calls += calls
    s.seconds += 0.01
    s.bytes += nbytes
    tl.count("ingest.retries", 1)
    tl.observe("serve.request_s", lat)
    if gauge is not None:
        tl.gauge("sched.depth", gauge)
    return tl


def _tiers(H):
    return [H.TierSpec("raw", 1.0, 32), H.TierSpec("mid", 8.0, 32),
            H.TierSpec("slow", 64.0, 8)]


def _fill(H, obs, path, nticks=24, t0=T0):
    clock = Clock(t0)
    store = H.HistoryStore(path, tiers=_tiers(H), slot_bytes=4096,
                           clock=clock)
    for i in range(nticks):
        store.append(clock(), 1.0, _delta(obs, calls=1 + i % 3,
                                          lat=0.01 * (1 + i % 4)),
                     gauges={"sched.depth": float(i % 5)},
                     burn={"api": (i % 2, 10)})
        clock.advance(1.0)
    store.close()
    return clock


@pytest.mark.parametrize("writer", ["port", "blit"])
def test_rings_cross_read(tmp_path, writer):
    W, wobs = (TH, tobs) if writer == "port" else (BH, bobs)
    path = str(tmp_path / "h")
    clock = _fill(W, wobs, path)
    stores = [TH.HistoryStore(path, create=False, clock=clock),
              BH.HistoryStore(path, create=False, clock=clock)]
    for tier in ("raw", "mid", "slow"):
        a, b = (s.buckets(T0 - 1, clock(), tier=tier) for s in stores)
        assert a == b and a, tier
    assert stores[0].metrics(window_s=60.0) == stores[1].metrics(window_s=60.0)
    names = stores[0].metrics(window_s=3600.0)
    assert {"ingest.chunks", "serve.request_s", "slo.api"} <= set(names)
    for metric in names:
        got = TH.read_history(path, metric, T0 - 1, clock())
        assert got == BH.read_history(path, metric, T0 - 1, clock())
    assert TH.read_history(path, "ingest.chunks", T0 - 1, clock())
    for name in sorted(os.listdir(path)):
        assert TH.read_ring(os.path.join(path, name)) == \
            BH.read_ring(os.path.join(path, name))
    for s in stores:
        s.close()


def test_tiers_points_and_series_equal_blit():
    d = history_defaults(SiteConfig(history_dir="x", history_raw_s=2.0))
    bd = bhistory_defaults(BSiteConfig(history_dir="x", history_raw_s=2.0))
    assert d == bd
    assert [(t.name, t.bucket_s, t.slots) for t in TH.history_tiers(d)] == \
        [(t.name, t.bucket_s, t.slots) for t in BH.history_tiers(bd)]
    tl, btl = _delta(tobs, gauge=3.0), _delta(bobs, gauge=3.0)
    assert TH.series_values(tl, {"g": 1.0}) == BH.series_values(btl, {"g": 1.0})
    rec = {"t0": T0, "bucket_s": 1.0, "n": 1, "seconds": 1.0,
           "stages": {"ingest": {"calls": 2, "seconds": 1.0, "bytes": 10 ** 9}},
           "hists": {"serve.request_s": tl.hists["serve.request_s"].state()},
           "gauges": {}, "burn": {"api": {"bad": 1, "total": 4}}}
    for name in ("ingest", "ingest.gbps", "serve.request_s.p99_s", "burn.api",
                 "nope"):
        assert TH.bucket_point(rec, name) == BH.bucket_point(rec, name)
    assert TH.sparkline([1, 5, 2, 8, 0]) == BH.sparkline([1, 5, 2, 8, 0])


def test_config_history_fields_and_env_equal_blit(monkeypatch):
    import dataclasses

    names = {f.name for f in dataclasses.fields(SiteConfig)}
    bnames = {f.name for f in dataclasses.fields(BSiteConfig)}
    assert names == bnames
    monkeypatch.setenv("BLIT_HISTORY_DIR", "/h")
    monkeypatch.setenv("BLIT_INCIDENT_DIR", "/i")
    monkeypatch.setenv("BLIT_HISTORY_ANOMALY", "0")
    monkeypatch.setenv("BLIT_HISTORY_SENSITIVITY", "a=3,b=x,c=4.5")
    monkeypatch.setenv("BLIT_HISTORY_RAW_SLOTS", "9")
    assert history_defaults() == bhistory_defaults()


def _detect(H, obs, seed):
    clock = Clock()
    det = H.AnomalyDetector(z=5.0, window=40, min_n=10, consecutive=3,
                            recorder=obs.FlightRecorder(), clock=clock)
    rng = random.Random(seed)
    fired = []
    for tick in range(80):
        v = rng.gauss(0.05, 0.004) if tick < 60 else 0.25
        for a in det.observe({"serve.request_s.p99_s": v}, clock.advance(1.0)):
            fired.append((tick, a["metric"], round(a["z"], 6)))
    return fired, det.breached(), det.report()


def test_anomaly_detector_pages_on_the_same_tick():
    got, want = _detect(TH, tobs, 7), _detect(BH, bobs, 7)
    assert got[0] == want[0] and len(got[0]) == 1 and got[0][0][0] == 62
    assert got[1] == want[1] == ["serve.request_s.p99_s"]
    assert got[2] == want[2]


def test_slo_report_equal_blit(tmp_path):
    path = str(tmp_path / "h")
    clock = _fill(TH, tobs, path)
    objs = [tmonitor.SLObjective(name="api", metric="serve.request_s",
                                 threshold=0.1, budget=0.1)]
    bobjs = [bmonitor.SLObjective(name="api", metric="serve.request_s",
                                  threshold=0.1, budget=0.1)]
    t = TH.HistoryStore(path, create=False, clock=clock)
    b = BH.HistoryStore(path, create=False, clock=clock)
    doc = TH.slo_report(t, objectives=objs, window_s=120.0, now=clock())
    bdoc = BH.slo_report(b, objectives=bobjs, window_s=120.0, now=clock())
    assert doc == bdoc and doc["objectives"]["api"]["total"] == 240
    assert TH.render_slo_report(doc) == BH.render_slo_report(bdoc)
    assert TH.render_history_panel(t, buckets=16) == \
        BH.render_history_panel(b, buckets=16)
    assert tmonitor.bench_metrics(doc) == bmonitor.bench_metrics(bdoc)


def _page(H, obs, mon, tmp_path, tag):
    """A publisher with a store, baselines and a bundler, driven through
    a 20x latency step → the bundle's directory."""
    cfg_cls = SiteConfig if H is TH else BSiteConfig
    cfg = cfg_cls(history_dir=str(tmp_path / f"h-{tag}"), history_raw_s=1.0,
                  history_anomaly_window=16, history_anomaly_min_n=5,
                  history_anomaly_consecutive=2, history_anomaly_z=5.0,
                  incident_dir=str(tmp_path / f"inc-{tag}"))
    tl = obs.Timeline()
    pub = mon.MetricsPublisher(interval_s=0.05, spool_dir="", port=-1,
                               timeline=tl, config=cfg)
    rng = random.Random(3)
    alerts = []
    try:
        for _ in range(10):
            tl.hists["serve.request_s"].observe(rng.gauss(0.02, 0.001),
                                                trace_id="tr-b")
            pub.tick()
        for _ in range(4):
            tl.hists["serve.request_s"].observe(0.4, trace_id="tr-b")
            alerts += pub.tick()["alerts"]
        health = pub.health()
    finally:
        pub.close()
    bundles = H.list_incidents(str(tmp_path / f"inc-{tag}"))
    return alerts, health, bundles


def test_incident_bundles_have_blits_keys(tmp_path):
    ta, th, tb = _page(TH, tobs, tmonitor, tmp_path, "port")
    ba, bh, bb = _page(BH, bobs, bmonitor, tmp_path, "blit")
    assert [a["class"] for a in ta] == [a["class"] for a in ba] == ["anomaly"]
    assert th["reasons"] == bh["reasons"] and not th["ok"]
    assert len(tb) == len(bb) == 1
    assert set(tb[0]) == set(bb[0])
    tl_, bl_ = TH.load_incident(tb[0]["path"]), BH.load_incident(bb[0]["path"])
    assert set(tl_) == set(bl_)
    assert set(tl_["manifest"]) == set(bl_["manifest"])
    assert sorted(os.listdir(tb[0]["path"])) == sorted(os.listdir(bb[0]["path"]))
    assert tl_["manifest"]["trace"] == "tr-b"
    # Each package renders the other's bundle.
    assert "=== blit incident bundle ===" in BH.render_incident(tl_)
    assert "anomaly" in TH.render_incident(bl_)
    assert TH.render_incidents(tb).splitlines()[0] == \
        BH.render_incidents(bb).splitlines()[0]
    assert TH.incident_timeline(tl_)


def test_peer_history_reports_enabled(tmp_path):
    from blit_torch.serve.http import _history_doc

    clock = _fill(TH, tobs, str(tmp_path / "h"), nticks=4)
    pub = SimpleNamespace(history=TH.HistoryStore(str(tmp_path / "h"),
                                                  create=False, clock=clock))
    doc = _history_doc(pub, f"/history?since={T0 - 10}&until={T0 + 10}&tier=raw")
    assert doc["enabled"] is True and doc["buckets"]
    assert _history_doc(SimpleNamespace(history=None), "/history")["enabled"] is False


def test_peer_server_arms_its_store(tmp_path, monkeypatch):
    from blit_torch.serve import PeerServer, ProductService

    monkeypatch.setenv("BLIT_HISTORY_DIR", str(tmp_path / "h"))
    monkeypatch.setenv("BLIT_MONITOR_INTERVAL", "0.05")
    svc = ProductService(device="cpu")
    ps = PeerServer(svc, name="p0").start()
    try:
        from blit_torch.serve.http import http_json

        st, _, body = http_json("GET", ps.url, "/history?since=1h")
        assert st == 200 and body["enabled"] is True
    finally:
        ps.close()
        svc.close()


def test_eject_and_peer_death_write_bundles(tmp_path, monkeypatch):
    from blit_torch.recover import ScanSupervisor
    from blit_torch.serve.fleet import FleetFrontDoor

    inc = tmp_path / "inc"
    monkeypatch.setenv("BLIT_INCIDENT_DIR", str(inc))
    door = FleetFrontDoor({"peer0": "http://127.0.0.1:9", "peer1":
                           "http://127.0.0.1:9"}, peer_ttl_s=1.0)
    try:
        door._eject(door._peers["peer0"], "lease stale")
    finally:
        door.close()
    kinds = [m["kind"] for m in TH.list_incidents(str(inc))]
    assert kinds == ["fleet-eject"]
    child = subprocess.Popen(["sleep", "30"])
    sup = SimpleNamespace()
    rep = ScanSupervisor._fail(sup, {0: child}, 0, "died", 0.5, rc=-9)
    assert rep == {"proc": 0, "why": "died", "detect_s": 0.5, "rc": -9}
    assert child.poll() is not None
    kinds = sorted(m["kind"] for m in TH.list_incidents(str(inc)))
    assert kinds == ["fleet-eject", "recover"]


def test_history_cli_reads_back(tmp_path, capsys):
    from blit_torch.__main__ import main

    path = str(tmp_path / "h")
    _fill(TH, tobs, path, t0=time.time() - 60.0)
    assert main(["slo-report", path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "objectives" in doc and doc["buckets"] >= 1
    _, _, bundles = _page(TH, tobs, tmonitor, tmp_path, "cli")
    assert main(["incidents", "--dir", str(tmp_path / "inc-cli"),
                 "--json"]) == 0
    manifests = [json.loads(x) for x in
                 capsys.readouterr().out.strip().splitlines()]
    assert [m["kind"] for m in manifests] == [bundles[0]["kind"]]
    assert main(["incident", "show", bundles[0]["path"], "--window",
                 "15m"]) == 0
    assert "=== blit incident bundle ===" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no incident dir"):
        main(["incidents"])
