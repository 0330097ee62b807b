"""The port's operator readers in ``monitor`` held against ``blit``'s:
the Prometheus parsers, the ``top`` frame and its refresh loop, the
fleet trace gatherer, and the ``bench-diff`` gate, with the ``top``,
``bench-diff`` and ``trace-view`` commands.

Every bench record here is one the port wrote (an ``ingest-bench`` run
on the CPU, then scaled copies in ``tmp_path``), never a TPU record.
"""

import contextlib
import io
import json
import signal

import pytest

pytest.importorskip("jax")

from blit import monitor as bmonitor  # noqa: E402
from blit import observability as bobs  # noqa: E402
from blit.__main__ import main as bmain  # noqa: E402
from blit_torch import monitor as tmonitor  # noqa: E402
from blit_torch import observability as tobs  # noqa: E402
from blit_torch.__main__ import main as tmain  # noqa: E402

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = main(argv)
    return rc, buf.getvalue()


def _report(obs, exemplars=True):
    snaps = []
    for w in range(2):
        tl = obs.Timeline()
        tl.stages["ingest"].calls = 4
        tl.stages["ingest"].seconds = 0.5 + w
        tl.stages["ingest"].bytes = 3 * 10 ** 9
        tl.count("block.masked", w)
        tl.gauge("dev.hbm_in_use_bytes.0", 1e9 * (w + 1))
        for v in (1e-3, 2e-2, 0.3):
            tl.hists["serve.request_s"].observe(
                v, trace_id=f"tr{w}" if exemplars else None)
        st = tl.state()
        for h in st["hists"].values():   # one exemplar clock for both
            for rec in (h.get("exemplars") or {}).values():
                rec[2] = 1.0
        snaps.append({"host": f"h{w}", "pid": 100 + w, "worker": w,
                      "timeline": st, "faults": {"retry.io": w},
                      "spans": []})
    return obs.merge_fleet(snaps)


@pytest.mark.parametrize("openmetrics", [False, True])
def test_parse_prometheus_equals_blits_parse(openmetrics):
    text = tobs.render_prometheus(_report(tobs), openmetrics=openmetrics)
    assert text == bobs.render_prometheus(_report(bobs), openmetrics=openmetrics)
    assert tmonitor.parse_prometheus(text) == bmonitor.parse_prometheus(text)
    assert tmonitor.parse_prometheus_exemplars(text) == \
        bmonitor.parse_prometheus_exemplars(text)
    assert tmonitor.parse_prometheus(text)
    with pytest.raises(ValueError):
        tmonitor.parse_prometheus("not a sample line at all {")


def test_render_top_and_watch_loop_equal_blit():
    report = _report(tobs)
    samples = [{"host": "h0", "pid": 100, "t": 50.0,
                "delta": {"stages": {"ingest": {"bytes": 10 ** 9,
                                                "seconds": 0.5, "calls": 1}}},
                "gauges": {"dev.hbm_in_use_bytes.0": 5.0},
                "slo": {"ingest-floor": {"breached": True, "burn_fast": 20.0,
                                         "burn_slow": 3.0, "kind": "floor",
                                         "metric": "ingest",
                                         "threshold": 1.0}},
                "alerts": [{"objective": "ingest-floor", "burn_fast": 20.0}]}]
    for smp in ([], samples):
        assert tmonitor.render_top(report, smp, now=60.0) == \
            bmonitor.render_top(report, smp, now=60.0)
    outs = []
    for mon in (tmonitor, bmonitor):
        buf = io.StringIO()
        frames = iter(["a", "b\n", "c"])
        n = mon.watch_loop(lambda: next(frames), 0.0, count=3, out=buf,
                           sleep=lambda s: None)
        outs.append((n, buf.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == 3
    assert tmonitor.ANSI_CLEAR == bmonitor.ANSI_CLEAR


def test_gather_trace_sources_equal_blit(tmp_path):
    spans = [{"name": "door.get", "t0": 1.0, "duration_s": 0.1,
              "trace": "a.1", "span": "a.1", "parent": None, "host": "h",
              "worker": 0, "tid": 1},
             {"name": "peer.product", "t0": 1.01, "duration_s": 0.05,
              "trace": "a.1", "span": "b.1", "parent": "a.1", "host": "h",
              "worker": 1, "tid": 1}]
    snap = tmp_path / "x.snapshot.json"
    snap.write_text(json.dumps({"spans": spans,
                                "timeline": _report(tobs)["hosts"]["h0"]
                                .get("hist_state") and {}}))
    spool = tmp_path / "s.jsonl"
    tl = tobs.Timeline()
    tl.hists["serve.request_s"].observe(0.25, trace_id="a.1")
    spool.write_text(json.dumps({"spans": spans[1:], "timeline": tl.state()})
                     + "\n{torn\n")
    rep = tmp_path / "fleet.json"
    rep.write_text(json.dumps(_report(tobs)))
    srcs = [str(tmp_path), str(spool), str(rep)]
    ts, th = tmonitor.gather_trace_sources(srcs)
    bs, bh = bmonitor.gather_trace_sources(srcs)
    assert ts == bs and len(ts) == 2
    assert {k: h.state() for k, h in th.items()} == \
        {k: h.state() for k, h in bh.items()}
    assert th["serve.request_s"].tail_exemplar()["trace"] in ("a.1", "tr0", "tr1")


def _bench_records(tmp_path, capsys):
    """An ingest-bench record the port wrote, and scaled copies of it: a
    baseline trajectory, a fresh run inside its band and one far below."""
    rc = tmain(["ingest-bench", "--device", "cpu", "--nfft", "64", "--nchan",
                "2", "--chunk-frames", "4", "--chunks", "4", "--blocks", "2",
                "--sync-compare"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    paths = {}
    for name, scale in (("BENCH_r01.json", 1.0), ("BENCH_r02.json", 1.05),
                        ("fresh_ok.json", 1.02), ("fresh_bad.json", 0.2)):
        d = json.loads(json.dumps(doc))
        for leg in d["legs"]:
            leg["ingest_gbps"] = 1.0 * scale
            leg["overlap_efficiency"] = 0.9 * scale
        d["async_speedup"] = 1.2 * scale
        p = tmp_path / name
        if name.startswith("BENCH_"):
            # The recorded-run wrapper: the record is the tail's last line.
            p.write_text(json.dumps({"n": 1, "cmd": "ingest-bench", "rc": 0,
                                     "tail": "# log\n" + json.dumps(d)}))
        else:
            p.write_text(json.dumps(d))
        paths[name] = str(p)
    return paths


def test_bench_diff_verdicts_equal_blit(tmp_path, capsys):
    paths = _bench_records(tmp_path, capsys)
    base = [tmonitor.load_bench_json(paths[n])
            for n in ("BENCH_r01.json", "BENCH_r02.json")]
    bbase = [bmonitor.load_bench_json(paths[n])
             for n in ("BENCH_r01.json", "BENCH_r02.json")]
    assert base == bbase
    for fresh, want in (("fresh_ok.json", "pass"), ("fresh_bad.json", "regress")):
        f = tmonitor.load_bench_json(paths[fresh])
        assert tmonitor.bench_metrics(f) == bmonitor.bench_metrics(f)
        v = tmonitor.bench_diff(f, base, rel_tol=0.1)
        assert v == bmonitor.bench_diff(f, bbase, rel_tol=0.1)
        assert v["verdict"] == want
        assert tmonitor.render_bench_diff(v) == bmonitor.render_bench_diff(v)
        assert tmonitor.bench_rig(f) == bmonitor.bench_rig(f)
        outs = []
        for main in (tmain, bmain):
            rc, out = _run(main, ["bench-diff", paths[fresh], "--baseline-dir",
                                  str(tmp_path), "--noise", "0.1", "--json"])
            outs.append((rc, json.loads(out)))
        assert outs[0] == outs[1]
        assert outs[0][0] == (0 if want == "pass" else 2)
    for key in ("a_p99_s", "x_gbps", "hit_rate"):
        assert tmonitor.metric_lower_is_better(key) == \
            bmonitor.metric_lower_is_better(key)
    with pytest.raises(SystemExit, match="baseline"):
        tmain(["bench-diff", paths["fresh_ok.json"]])


def test_top_and_trace_view_commands_equal_blit(tmp_path):
    spool = tmp_path / "spool"
    spool.mkdir()
    # No "t": the frame's "age" of the sample is then 0 in both frames.
    sample = {"host": "h0", "pid": 7,
              "timeline": tobs.Timeline().state(), "gauges": {}, "slo": {},
              "alerts": [], "faults": {}, "delta": {"stages": {}}}
    (spool / "h0-7.jsonl").write_text(json.dumps(sample) + "\n")
    frames = []
    for main in (tmain, bmain):
        rc, out = _run(main, ["top", "--spool", str(spool), "--once"])
        assert rc == 0
        frames.append(out.split("\n", 1)[1])   # the clock line differs
    assert frames[0] == frames[1]
    fr = tobs.FlightRecorder()
    fr.event("fault", "sink.write", mode="raise")
    dump = fr.dump("stall: probe", path=str(tmp_path / "dump.json"))
    outs = [_run(main, ["trace-view", dump, "--events", "5"])
            for main in (tmain, bmain)]
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert "sink.write" in outs[0][1]
    with pytest.raises(SystemExit, match="flight dump"):
        tmain(["trace-view"])
