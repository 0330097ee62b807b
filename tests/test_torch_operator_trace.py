"""The port's tracing, flight recorder and fleet harvest held against
``blit``'s.

The same span dicts go through both packages' Chrome export, trace
summary, cross-process pair count and trace tree; ``profile_trace``
writes a ``torch.profiler`` trace on the CPU (``None`` is a no-op) and
a traced reduction writes the same bytes as an untraced one; a flight
dump of one incident has ``blit``'s key set and ``blit``'s renderer
reads it; ``WorkerPool.harvest_telemetry`` folds every worker of the
thread, process and remote backends; ``render_fleet_text`` and
``telemetry --from`` print what ``blit``'s print.  Tests that start a
thread or a process run under a SIGALRM deadline.
"""

import contextlib
import filecmp
import io
import json
import logging
import os
import signal

import pytest

pytest.importorskip("jax")

from blit import observability as bobs  # noqa: E402
from blit.__main__ import main as bmain  # noqa: E402
from blit_torch import observability as tobs  # noqa: E402
from blit_torch import workers  # noqa: E402
from blit_torch.__main__ import main as tmain  # noqa: E402
from blit_torch.parallel.pool import WorkerPool  # noqa: E402
from blit_torch.parallel.remote import (  # noqa: E402
    agent_env_with_repo,
    local_agent_command,
)
from blit_torch.pipeline import RawReducer  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

DEADLINE_S = 90
NFFT = 64


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _spans():
    """A stitched two-process trace: a door span in process ``a1b2``, a
    peer's child in ``c3d4`` (hedged), its grandchild, an orphan whose
    parent aged out, and a second trace."""
    def sp(name, span, parent, trace="a1b2.1", t0=100.0, dur=0.01, **attrs):
        d = {"name": name, "t0": t0, "duration_s": dur, "trace": trace,
             "span": span, "parent": parent, "host": "h0" if
             span.startswith("a1b2") else "h1",
             "worker": 0 if span.startswith("a1b2") else 1, "tid": 7}
        if attrs:
            d["attrs"] = attrs
        return d

    return [sp("door.get", "a1b2.1", None, dur=0.05),
            sp("peer.product", "c3d4.1", "a1b2.1", t0=100.01, hedge=1),
            sp("service.derive", "c3d4.2", "c3d4.1", t0=100.02, dur=0.02),
            sp("orphan", "c3d4.9", "c3d4.8", t0=100.03),
            sp("door.get", "a1b2.5", None, trace="a1b2.5", t0=101.0)]


def test_chrome_export_summary_pairs_and_tree_equal_blit(tmp_path):
    spans = _spans()
    assert tobs.trace_summary(spans) == bobs.trace_summary(spans)
    assert tobs.cross_process_pairs(spans) == bobs.cross_process_pairs(spans) == 1
    for tid in ("a1b2.1", "a1b2.5", "nope"):
        assert tobs.render_trace_tree(spans, tid) == bobs.render_trace_tree(spans, tid)
    assert tobs.span_process("c3d4.17") == bobs.span_process("c3d4.17")
    docs = []
    for mod in (tobs, bobs):
        tr = mod.Tracer(max_spans=64, enabled=True)
        tr.ingest(spans + [{"t0": "x"}, {"worker": "w"}])  # malformed
        assert len(tr.spans()) == len(spans)
        docs.append(tr.export_chrome(extra=spans))
        path = str(tmp_path / f"{mod.__name__}.json")
        assert tr.export_chrome(path) == path
        with open(path) as f:
            assert json.load(f)["traceEvents"]
    assert docs[0] == docs[1]
    assert [tobs.Span.from_dict(d).as_dict() for d in spans] == \
        [bobs.Span.from_dict(d).as_dict() for d in spans]


def test_tail_exemplar_and_timeline_log_equal_blit(caplog):
    h, bh = tobs.HistogramStats(), bobs.HistogramStats()
    assert h.tail_exemplar() is None and bh.tail_exemplar() is None
    for v, tr in ((1e-4, "t1"), (3e-2, "t2"), (2e-3, "t3")):
        h.observe(v, trace_id=tr)
        bh.observe(v, trace_id=tr)
    a, b = h.tail_exemplar(), bh.tail_exemplar()
    assert {k: a[k] for k in ("bucket", "le", "trace", "value")} == \
        {k: b[k] for k in ("bucket", "le", "trace", "value")}
    assert a["trace"] == "t2"
    tl = tobs.Timeline()
    with tl.stage("ingest", nbytes=10):
        pass
    with caplog.at_level(logging.INFO, logger="blit_torch.timeline"):
        tl.log()
    rec = [r for r in caplog.records if r.name == "blit_torch.timeline"]
    assert rec and json.loads(rec[-1].getMessage().split(" ", 1)[1]) == \
        tl.report()


def test_profile_trace_writes_a_cpu_trace_and_none_is_a_no_op(tmp_path):
    import torch

    with tobs.profile_trace(None):
        pass
    d = tmp_path / "trace"
    with tobs.profile_trace(str(d), device="cpu"):
        torch.ones(64).sum()
    files = list(d.glob("blit-torch-*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert not list(tmp_path.glob("*.json"))


@pytest.mark.parametrize("async_output", [True, False])
def test_traced_reduction_is_byte_identical(tmp_path, async_output):
    raw = str(tmp_path / "r.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=(8 + 3) * NFFT,
              seed=3, tone_chan=1)
    plain, traced = str(tmp_path / "plain.fil"), str(tmp_path / "traced.fil")
    kw = dict(nfft=NFFT, nint=2, chunk_frames=4, async_output=async_output,
              device="cpu")
    RawReducer(**kw).reduce_to_file(raw, plain)
    tdir = tmp_path / "trace"
    red = RawReducer(trace_logdir=str(tdir), **kw)
    red.reduce_to_file(raw, traced)
    assert filecmp.cmp(plain, traced, shallow=False)
    assert len(list(tdir.glob("*.pt.trace.json"))) == 1
    # stream and drain take blit's ``raw`` keyword and trace too.
    slabs = list(red.stream(raw=raw))
    assert sum(s.shape[0] for s in slabs) > 0
    assert red.drain(raw=raw) == RawReducer(**kw).drain(raw)
    assert len(list(tdir.glob("*.pt.trace.json"))) == 3


def test_flight_dump_is_blits_document(tmp_path, monkeypatch):
    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path))
    docs = []
    for mod in (tobs, bobs):
        fr = mod.FlightRecorder(capacity=8)
        fr.event("fault", "guppi.read", mode="corrupt")
        fr.stage_event("ingest", 0.25, 1024)
        with mod.span("incident.probe", k=1):
            path = fr.dump("stall: a wedged producer")
        name = os.path.basename(path)
        assert name.startswith(f"blit-flight-{mod.hostname()}-{os.getpid()}-")
        with open(path) as f:
            docs.append(json.load(f))
        assert fr.dump("stall: again") is None            # rate-limited
        assert fr.dump("stall: again", key="other") is not None
        fr.clear()
        assert fr.events() == []
    assert set(docs[0]) == set(docs[1])
    assert {"host", "worker", "anchor", "faults", "timeline", "spans",
            "trace", "span"} <= set(docs[0])
    assert docs[0]["trace"] and len(docs[0]["spans"]) <= 64
    text = bobs.render_flight_dump(docs[0])
    assert text.startswith("=== blit flight record ===") and \
        "guppi.read" in text
    assert tobs.render_flight_dump(docs[0], tail=5) == \
        bobs.render_flight_dump(docs[0], tail=5)


def test_flight_limiter_is_bounded(tmp_path, monkeypatch):
    monkeypatch.delenv("BLIT_FLIGHT_DISABLE", raising=False)
    fr = tobs.FlightRecorder()
    fr.min_interval_s = 3600.0
    for i in range(3 * tobs.FlightRecorder._MAX_DUMP_KEYS):
        assert fr.dump(f"kind{i}: x", path=str(tmp_path / "d.json"))
    assert len(fr._last_dump) == tobs.FlightRecorder._MAX_DUMP_KEYS
    assert tobs.FlightRecorder._MAX_DUMP_KEYS == bobs.FlightRecorder._MAX_DUMP_KEYS


def _demo_inputs(tmp_path, n):
    args = []
    for i in range(n):
        raw = str(tmp_path / f"demo{i}.raw")
        synth_raw(raw, nblocks=1, obsnchan=2, ntime_per_block=(8 + 3) * NFFT,
                  seed=i)
        args.append((raw, str(tmp_path / f"demo{i}.fil")))
    return args


@pytest.mark.parametrize("backend", ["thread", "process", "remote"])
def test_harvest_telemetry_covers_every_worker(tmp_path, backend):
    n = 2
    tobs.tracer().reset()
    tobs.process_timeline().reset()
    kw = {}
    if backend == "remote":
        kw = dict(transport=lambda host: local_agent_command(),
                  agent_env=agent_env_with_repo(), call_timeout=60.0)
    with WorkerPool([f"w{i + 1}" for i in range(n)], backend=backend,
                    **kw) as pool:
        pool.run_on([1, 2], workers.reduce_raw, _demo_inputs(tmp_path, n),
                    kwargs={"nfft": NFFT, "device": "cpu"})
        report = pool.harvest_telemetry(timeout=60.0)
    assert not report.get("errors")
    assert report["health"]
    procs = {(h, w["pid"]) for h, e in report["hosts"].items()
             for w in e["workers"]}
    stream_calls = sum(e["stages"].get("stream", {}).get("calls", 0)
                       for e in report["hosts"].values())
    if backend == "thread":
        # One process: both workers' reductions fold into its table.
        assert len(procs) == 1 and stream_calls == n
    elif backend == "remote":
        # An agent a worker, each asked for its own telemetry, beside
        # the pool's own process.
        assert len(procs) == n + 1 and stream_calls == n
    else:
        # One shared pool of spawned processes (as in blit): a worker's
        # call, and its harvest, land on any of them, so the report holds
        # this process and at least one child that reduced.
        assert len(procs) >= 2 and stream_calls >= 1
    names = [s["name"] for s in report["spans"]]
    # The process backend records a dispatch's span in the child that ran
    # it, which its harvest may not reach (see above).
    assert names.count("pool.reduce_raw") == n or (
        backend == "process" and names.count("pool.reduce_raw") >= 1)


def test_render_fleet_text_and_telemetry_from_equal_blit(tmp_path, capsys):
    snaps = []
    for w, pid in ((0, 11), (1, 12)):
        tl = tobs.Timeline()
        tl.stages["ingest"].calls = 3 + w
        tl.stages["ingest"].seconds = 0.5
        tl.stages["ingest"].bytes = 10 ** 9
        tl.observe("out.write_s", 0.01 * (w + 1))
        snaps.append({"host": "h0", "pid": pid, "worker": w,
                      "timeline": tl.state(), "faults": {"retry.io": w},
                      "spans": _spans()[:2]})
    report = tobs.merge_fleet(snaps, errors={"h9": "down"})
    assert report == bobs.merge_fleet(snaps, errors={"h9": "down"})
    assert tobs.render_fleet_text(report) == bobs.render_fleet_text(report)
    saved = str(tmp_path / "fleet.json")
    with open(saved, "w") as f:
        json.dump(report, f)
    outs = []
    for main, extra in ((tmain, ["--device", "cpu"]), (bmain, [])):
        for fmt in ("text", "prom", "json"):
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                assert main(["telemetry", "--from", saved, "--format", fmt,
                             *extra]) == 0
            outs.append(buf.getvalue())
    assert outs[:3] == outs[3:]


def test_local_fleet_report_and_maybe_write_report(tmp_path, monkeypatch):
    rep = tobs.local_fleet_report()
    assert set(rep) == set(bobs.local_fleet_report())
    assert tobs.maybe_write_report(None) is None
    out = str(tmp_path / "t.json")
    monkeypatch.setenv("BLIT_TELEMETRY_OUT", out)
    assert tobs.maybe_write_report() == out
    with open(out) as f:
        assert "hosts" in json.load(f)
