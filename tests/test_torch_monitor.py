"""The port's histogram Timeline and metrics publisher
(blit_torch.observability, blit_torch.monitor) held against blit's on
the CPU, after tests/test_monitor.py and tests/test_telemetry.py.

On the same observations: histogram quantiles, state, since, merge and
report equal blit's exactly; Timeline state / merge / report too; the
Prometheus text of the same fleet report is line for line blit's (and
parses with blit's parser); the burn-rate evaluator gives the same
verdicts, alerts and shed calls; a publisher tick writes a spool sample
of blit's schema, and each package's merge_spool reads the other's
spool.  A configured history store or incident dir makes the port's
publisher raise NotImplementedError.  Every test runs under a SIGALRM
deadline.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from blit import faults as bfaults
from blit import monitor as bmonitor
from blit import observability as bobs
from blit_torch import faults, monitor, observability
from blit_torch.monitor import BurnRateEvaluator, MetricsPublisher, SLObjective
from blit_torch.observability import (
    FlightRecorder,
    HistogramStats,
    Timeline,
    merge_fleet,
    render_prometheus,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60
SAMPLES = {
    "empty": [],
    "one": [0.25],
    "spread": [1e-7, 3e-6, 0.001, 0.002, 0.0021, 0.5, 0.75, 3.0, 120.0],
    "many": [((i * 7919) % 1000 + 1) * 1e-4 for i in range(400)],
}


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def clean_monitor(monkeypatch, tmp_path):
    for var in ("BLIT_MONITOR_SPOOL", "BLIT_MONITOR_PORT",
                "BLIT_MONITOR_INTERVAL", "BLIT_SLO_SERVE_WAIT_P99",
                "BLIT_SLO_STREAM_P99", "BLIT_SLO_INGEST_GBPS_FLOOR",
                "BLIT_HISTORY_DIR", "BLIT_INCIDENT_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path / "flight"))
    (tmp_path / "flight").mkdir()
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    monitor.shutdown_publisher()
    bmonitor.shutdown_publisher()
    yield
    monitor.shutdown_publisher()
    bmonitor.shutdown_publisher()


def _hists(values):
    h, b = HistogramStats(), bobs.HistogramStats()
    for v in values:
        h.observe(v)
        b.observe(v)
    return h, b


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_histogram_matches_blit(case):
    h, b = _hists(SAMPLES[case])
    assert h.report() == b.report()
    assert h.state() == b.state()
    for p in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.percentile(p) == b.percentile(p)
    st, bst = h.state(), b.state()
    h2, b2 = _hists(SAMPLES["spread"])
    assert h.merge(h2).state() == b.merge(b2).state()
    assert h.since(st).state() == b.since(bst).state()
    assert HistogramStats.from_state(b.state()).state() == b.state()
    assert observability.hist_bucket_edges() == bobs.hist_bucket_edges()


def _fill(tl, seconds=0.25):
    """The same stage, gauge, counter and histogram history on a port or
    a blit Timeline (stage times set, not measured)."""
    s = tl.stages["ingest"]
    s.calls, s.seconds, s.bytes = 3, seconds, 3 << 20
    tl.count("block.masked", 2)
    for v in (1.0, 4.0, 2.0):
        tl.gauge("stream.watermark_lag_s", v)
    for v in SAMPLES["spread"]:
        tl.observe("stream.chunk_to_product_s", v)
    tl.observe("out.write_s", 0.003)
    return tl


def test_timeline_state_merge_report_match_blit():
    tl, btl = _fill(Timeline()), _fill(bobs.Timeline())
    assert tl.state() == btl.state()
    assert tl.report() == btl.report()
    assert tl.hist_quantiles() == btl.hist_quantiles()
    snap, bsnap = tl.snapshot(), btl.snapshot()
    tl.merge(_fill(Timeline(), 0.5))
    btl.merge(_fill(bobs.Timeline(), 0.5))
    assert tl.state() == btl.state() and tl.report() == btl.report()
    assert tl.since(snap) == btl.since(bsnap)
    assert Timeline.from_state(btl.state()).state() == btl.state()
    tl.reset()
    btl.reset()
    assert tl.state() == btl.state()


def _snapshot(tl, host="blc07", pid=4242):
    return {"host": host, "pid": pid, "worker": 0, "timeline": tl.state(),
            "faults": {"retry.io": 2}, "spans": []}


@pytest.mark.parametrize("openmetrics", [False, True])
def test_prometheus_text_matches_blit(openmetrics):
    snaps = [_snapshot(_fill(Timeline())),
             _snapshot(_fill(Timeline(), 0.5), host='odd"host\\')]
    rep = merge_fleet(snaps)
    brep = bobs.merge_fleet(snaps)
    assert rep == brep
    text = render_prometheus(rep, openmetrics=openmetrics)
    assert text == bobs.render_prometheus(brep, openmetrics=openmetrics)
    if not openmetrics:
        names = {n for n, _, _ in bmonitor.parse_prometheus(text)}
        assert {"blit_stage_bytes_total",
                "blit_latency_seconds_bucket"} <= names


def _delta(values, metric="sched.wait_s", mod=observability):
    d = mod.Timeline()
    for v in values:
        d.observe(metric, v)
    return d


ROUNDS = {
    "breach": [[0.5] * 10],
    "within_budget": [[0.001, 0.001, 0.5]] * 10,
    "spike_on_good_history": [[0.001]] * 7 + [[0.5]],
    "recovery": [[0.5] * 4, [], [], []],
    "storm": [[0.5] * 3] * 20,
}


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_burn_rate_verdicts_match_blit(case):
    objs = [{"name": "w", "metric": "sched.wait_s", "threshold": 0.01,
             "budget": 0.5 if case in ("within_budget",
                                       "spike_on_good_history") else 0.01}]
    kw = dict(fast_window=1 if case != "breach" else 3,
              slow_window=8 if case == "spike_on_good_history" else 6,
              fast_burn=2.0, slow_burn=2.0)
    ev = BurnRateEvaluator(
        objs, recorder=FlightRecorder(min_interval_s=3600.0), **kw)
    bev = bmonitor.BurnRateEvaluator(
        objs, recorder=bobs.FlightRecorder(min_interval_s=3600.0), **kw)
    shed, bshed = [], []
    ev.add_shed_hook(shed.append)
    bev.add_shed_hook(bshed.append)
    strip = lambda a: {k: v for k, v in a.items()  # noqa: E731
                       if k not in ("t", "flight_dump")}
    for values in ROUNDS[case]:
        got = ev.observe(_delta(values), 1.0)
        want = bev.observe(_delta(values, mod=bobs), 1.0)
        assert [strip(a) for a in got] == [strip(a) for a in want]
        assert ev.report() == bev.report()
    assert shed == bshed and ev.breached() == bev.breached()
    assert ev.last_obs == bev.last_obs


def test_bad_fraction_and_objectives_match_blit(monkeypatch):
    h, b = _hists(SAMPLES["many"])
    for thr in (1e-4, 0.01, 0.05, 1.0):
        assert monitor.bad_fraction(h, thr) == bmonitor.bad_fraction(b, thr)
    monkeypatch.setenv("BLIT_SLO_STREAM_P99", "0.5")
    monkeypatch.setenv("BLIT_SLO_INGEST_GBPS_FLOOR", "0.75")
    assert [o.__dict__ for o in monitor.objectives_for()] == \
        [o.__dict__ for o in bmonitor.objectives_for()]
    with pytest.raises(ValueError):
        SLObjective(name="x", metric="m", threshold=1.0, kind="nope")


def _publish(mod, obs_mod, spool, seconds):
    tl = obs_mod.Timeline()
    pub = mod.MetricsPublisher(interval_s=999.0, spool_dir=str(spool),
                               timeline=tl)
    s1 = pub.tick()
    _fill(tl, seconds)
    s2 = pub.tick()
    tl.observe("stream.chunk_to_product_s", 0.5)
    s3 = pub.tick()
    pub.close()
    return s1, s2, s3


def test_spool_samples_match_blit_schema_and_interchange(tmp_path):
    got = _publish(monitor, observability, tmp_path / "p", 0.25)
    want = _publish(bmonitor, bobs, tmp_path / "b", 0.25)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert set(g["delta"]) == set(w["delta"])
        assert g["delta"]["hists"] == w["delta"]["hists"]
        assert g["slo"] == w["slo"] and g["alerts"] == w["alerts"]
        assert g["seq"] == w["seq"]
    assert got[1]["delta"]["stages"]["ingest"]["bytes"] == 3 << 20
    assert "ingest" not in got[2]["delta"]["stages"]
    assert got[2]["delta"]["hists"]["stream.chunk_to_product_s"]["n"] == 1
    assert got[2]["timeline"]["hists"]["stream.chunk_to_product_s"] == \
        want[2]["timeline"]["hists"]["stream.chunk_to_product_s"]
    # Each package reads the other's spool into the same fleet report.
    host = observability.hostname()
    for spool in (tmp_path / "p", tmp_path / "b"):
        rep, samples = monitor.merge_spool(str(spool))
        brep, bsamples = bmonitor.merge_spool(str(spool))
        assert rep == brep and samples == bsamples
        assert rep["hosts"][host]["stages"]["ingest"]["calls"] == 3
    assert monitor.read_spool(str(tmp_path / "b"), tail=3) == \
        bmonitor.read_spool(str(tmp_path / "b"), tail=3)


def test_http_endpoints_serve_parseable_metrics(tmp_path):
    tl = _fill(Timeline())
    with MetricsPublisher(interval_s=999.0, port=0, timeline=tl) as pub:
        health = json.load(urllib.request.urlopen(pub.url + "/healthz",
                                                  timeout=10))
        assert health["ok"] is True and health["status"] == "ok"
        text = urllib.request.urlopen(pub.url + "/metrics",
                                      timeout=10).read().decode()
        names = {n for n, _, _ in bmonitor.parse_prometheus(text)}
        assert {"blit_stage_bytes_total", "blit_latency_seconds_bucket"} <= names
        snap = json.load(urllib.request.urlopen(pub.url + "/snapshot",
                                                timeout=10))
        assert snap["host"] == observability.hostname()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(pub.url + "/nope", timeout=10)


def test_health_hooks_degrade(tmp_path):
    pub = MetricsPublisher(interval_s=999.0)
    monitor.register_health_hook("seat", lambda: {"degraded": True,
                                                  "reason": "rejoining"})
    try:
        h = pub.health()
        assert h["status"] == "degraded" and "seat:rejoining" in h["reasons"]
    finally:
        monitor.unregister_health_hook("seat")
        pub.close()
    assert pub.health()["ok"] is True


@pytest.mark.parametrize("var", ["BLIT_HISTORY_DIR", "BLIT_INCIDENT_DIR"])
def test_history_configured_raises(tmp_path, monkeypatch, var):
    monkeypatch.setenv(var, str(tmp_path / "h"))
    with pytest.raises(NotImplementedError, match="not ported"):
        MetricsPublisher(interval_s=999.0, spool_dir=str(tmp_path / "s"))
    with pytest.raises(NotImplementedError):
        monitor.ensure_publisher()


def test_monitoring_off_unless_configured_and_reduce_publishes(
        tmp_path, monkeypatch):
    from blit_torch.pipeline import RawReducer
    from blit_torch.testing import synth_raw

    assert monitor.ensure_publisher() is None
    with monitor.publishing(Timeline()) as pub:
        assert pub is None
    raw = str(tmp_path / "r.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=1000)
    spool = tmp_path / "spool"
    monkeypatch.setenv("BLIT_MONITOR_SPOOL", str(spool))
    monkeypatch.setenv("BLIT_MONITOR_INTERVAL", "999")
    red = RawReducer(nfft=64, nint=2, chunk_frames=4, device="cpu")
    red.reduce_to_file(raw, str(tmp_path / "o.fil"))
    samples = monitor.read_spool(str(spool), tail=5)
    assert samples and "ingest" in samples[-1]["timeline"]["stages"]
    assert samples[-1]["timeline"]["hists"]["out.write_s"]["n"] >= 1
    monitor.shutdown_publisher()


def test_device_gauges_leave_cuda_alone_on_the_cpu():
    code = (
        "import json, torch\n"
        "from blit_torch import monitor\n"
        "from blit_torch.observability import Timeline\n"
        "tl = Timeline()\n"
        "n = monitor.device_gauges(tl)\n"
        "print(json.dumps({'n': n, 'init': torch.cuda.is_initialized(), "
        "'gauges': sorted(tl.gauges)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc == {"n": 0, "init": False, "gauges": []}
