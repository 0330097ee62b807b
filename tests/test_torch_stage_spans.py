"""The Timeline's span store: every ``stage()`` call kept as a span with
its native thread id and its bounds on the epoch clock, while the store
is open.

The store is off by default; a streaming reduction with it open records
each of the reducer's stages (the producer's and the dispatch thread's
waits included) as spans that cover those threads' time; a span agrees
with a ``torch.profiler`` range around the same work once the trace's
``ts`` is put on the span clock; the store is bounded and counts what it
drops; the products do not change; and a reduction with ``trace_logdir``
writes one Chrome trace that holds the profiler's events and the stage
spans on one time base.  Tests that start threads run under a SIGALRM
deadline.
"""

import collections
import json
import signal
import threading
import time

import pytest

from blit_torch.io.guppi import open_raw
from blit_torch.observability import (
    STAGE_SPAN_CAT,
    SpanStore,
    Timeline,
    profile_trace,
)
from blit_torch.pipeline import RawReducer
from blit_torch.stream import stream_reduce
from blit_torch.stream.source import QueueSource, chunks_of
from blit_torch.testing import synth_raw

NFFT = 256
CHUNK_FRAMES = 16
DEADLINE_S = 90
# The stages of a live reduction on the asynchronous plane.
PRODUCER = ("ingest.feed_wait", "ingest.slot_wait", "state", "ingest")
DISPATCH = ("dispatch.chunk_wait", "dispatch", "dispatch.h2d",
            "dispatch.launch", "dispatch.put_wait")
PER_CHUNK = ("ingest.slot_wait", "state", "ingest", "dispatch.chunk_wait",
             "dispatch", "dispatch.h2d", "dispatch.launch",
             "dispatch.put_wait", "device", "readback")
ALL_STAGES = PRODUCER + DISPATCH + ("device", "readback", "write", "stream")


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def raw(tmp_path):
    path = str(tmp_path / "r.raw")
    synth_raw(path, nblocks=8, obsnchan=8,
              ntime_per_block=(CHUNK_FRAMES + 3) * NFFT, seed=3, tone_chan=1)
    return path


def _reducer(**kw):
    kw.setdefault("timeline", Timeline())
    return RawReducer(nfft=NFFT, nint=2, chunk_frames=CHUNK_FRAMES,
                      device="cpu", **kw)


def _live(raw_path, out, red):
    src = QueueSource()
    for c in chunks_of(open_raw(raw_path)):
        src.push(c)
    src.finish()
    return stream_reduce(src, out, reducer=red)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _covered(intervals):
    """The share of [first start, last end] that the intervals cover."""
    iv = sorted(intervals)
    lo, hi = iv[0][0], max(b for _, b in iv)
    covered, a0, b0 = 0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a <= b0:
            b0 = max(b0, b)
        else:
            covered += b0 - a0
            a0, b0 = a, b
    covered += b0 - a0
    return covered / (hi - lo)


def test_the_store_is_off_by_default_and_records_nothing(raw, tmp_path):
    tl = Timeline()
    assert tl.spans is None
    with tl.stage("ingest", nbytes=4):
        pass
    assert tl.spans is None and tl.close_spans() is None
    red = _reducer(timeline=tl)
    _live(raw, str(tmp_path / "p.fil"), red)
    assert tl.spans is None
    assert tl.stages["dispatch.chunk_wait"].calls > 0
    assert "spans.dropped" not in tl.stages


def test_a_live_reduction_records_every_stage_as_a_span(raw, tmp_path):
    tl = Timeline()
    store = tl.open_spans()
    t_before = time.time_ns()
    _live(raw, str(tmp_path / "p.fil"), _reducer(timeline=tl))
    t_after = time.time_ns()
    assert tl.close_spans() is store and tl.spans is None
    spans = store.spans()
    assert store.dropped == 0 and len(spans) == len(store)
    names = collections.Counter(s["name"] for s in spans)
    assert set(ALL_STAGES) <= set(names)
    # The span store keeps one span a stage call: the stage table agrees.
    for name, n in names.items():
        assert tl.stages[name].calls == n, name
    for s in spans:
        assert isinstance(s["tid"], int) and s["tid"] > 0
        assert t_before <= s["t0_ns"] <= s["t1_ns"] <= t_after
        if s["name"] in PER_CHUNK:
            assert isinstance(s["seq"], int) and s["seq"] >= 0, s
    chunks = tl.stages["dispatch"].calls
    assert sorted(s["seq"] for s in spans if s["name"] == "dispatch.h2d") \
        == list(range(chunks))
    # One producer thread and one dispatch thread, each covered by its
    # spans (the ``stream`` wall aside) from its first span to its last.
    for group in (PRODUCER, DISPATCH):
        tids = {s["tid"] for s in spans if s["name"] in group}
        assert len(tids) == 1, group
        mine = [(s["t0_ns"], s["t1_ns"]) for s in spans
                if s["tid"] in tids and s["name"] != "stream"]
        assert _covered(mine) >= 0.95, group
    producer = store.threads[next(s["tid"] for s in spans
                                  if s["name"] == "ingest")]
    assert producer["name"] == "blit-ingest"
    dispatch = store.threads[threading.get_native_id()]
    assert dispatch == {"name": threading.current_thread().name,
                        "ident": threading.get_ident()}


def test_a_span_agrees_with_a_profiler_range_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    tl = Timeline()
    tl.open_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("blit.warm"):
            pass  # the first range of a session pays the profiler's set-up
        with record_function("blit.probe"), tl.stage("probe"):
            time.sleep(0.02)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    ev = [e for e in doc["traceEvents"] if e.get("name") == "blit.probe"]
    assert len(ev) == 1
    t0 = base + ev[0]["ts"] * 1e3
    t1 = t0 + ev[0]["dur"] * 1e3
    (span,) = tl.close_spans().spans()
    assert span["tid"] == ev[0]["tid"] == threading.get_native_id()
    assert abs(span["t0_ns"] - t0) < 1e6
    assert abs(span["t1_ns"] - t1) < 1e6


def test_the_store_is_bounded_and_counts_what_it_drops():
    tl = Timeline()
    tl.open_spans(capacity=3)
    for _ in range(5):
        with tl.stage("ingest", nbytes=1):
            pass
    store = tl.close_spans()
    assert len(store) == 3 and store.dropped == 2
    assert tl.stages["spans.dropped"].calls == 2
    assert tl.stages["ingest"].calls == 5

    store = SpanStore(capacity=1000)

    def record(n):
        for i in range(n):
            store.add("x", i, i + 1, 0, None)

    threads = [threading.Thread(target=record, args=(500,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(store) == 1000 and store.dropped == 1000


@pytest.mark.parametrize("path", ["live", "batch"])
def test_products_are_byte_identical_with_the_store_open(raw, tmp_path, path):
    outs = []
    for store_open in (False, True):
        tl = Timeline()
        if store_open:
            tl.open_spans()
        red = _reducer(timeline=tl)
        out = str(tmp_path / f"{path}-{store_open}.fil")
        if path == "live":
            _live(raw, out, red)
        else:
            red.reduce_to_file(raw, out)
        outs.append(_read(out))
        if store_open:
            assert len(tl.close_spans()) > 0
    assert outs[0] == outs[1]


def test_the_operator_trace_holds_profiler_events_and_stage_spans(raw, tmp_path):
    tdir = tmp_path / "trace"
    red = _reducer(trace_logdir=str(tdir))
    red.reduce_to_file(raw, str(tmp_path / "t.fil"))
    assert red.timeline.spans is None  # closed again with the trace
    (path,) = tdir.glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stage = [e for e in events if e.get("cat") == STAGE_SPAN_CAT]
    assert set(ALL_STAGES) - {"ingest.feed_wait"} <= {e["name"] for e in stage}
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops
    # One time base: the channelizer's operators ran inside the launch
    # spans of the same thread.
    launches = [e for e in stage if e["name"] == "dispatch.launch"]
    assert launches
    for sp in launches:
        inside = [e for e in ops if e["tid"] == sp["tid"]
                  and sp["ts"] <= e["ts"] and
                  e["ts"] + e["dur"] <= sp["ts"] + sp["dur"]]
        assert inside, sp
    named = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "blit-ingest" in named.values()


def test_profile_trace_leaves_an_open_store_open(tmp_path):
    tl = Timeline()
    store = tl.open_spans()
    with profile_trace(str(tmp_path / "trace"), device="cpu", timeline=tl):
        with tl.stage("probe"):
            pass
    assert tl.spans is store and len(store) == 1
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    with open(path) as f:
        stage = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == STAGE_SPAN_CAT]
    assert [e["name"] for e in stage] == ["probe"]
