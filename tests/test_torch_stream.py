"""The port's live plane (blit_torch.stream) held against blit.stream on
the CPU, case for case after tests/test_stream.py.

The same seeded synth_raw recording goes through both packages.  Inside
the port every streamed product is byte-identical to the port's batch
reduction of the same recording (the plane's contract); across the
packages the products' header bytes are identical, the f32 data agree
to blit's f32 bound (rtol 1e-4, atol 1e-2 of the noise-only coarse
channel's peak, tests/test_channelize.py), the nbits=8 bytes are
identical, the .hits lines agree cell for cell, and the masked seats,
degraded rows and stream_report counts are equal.  Every test runs
under a SIGALRM deadline.
"""

import contextlib
import io
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from blit import faults as bfaults
from blit import stream as bstream
from blit import workers as bworkers
from blit.io.guppi import open_raw as bopen_raw
from blit.io.guppi import write_raw as bwrite_raw
from blit.observability import Timeline as BTimeline
from blit.pipeline import RawReducer as BRawReducer
from blit.search import DedopplerReducer as BDedoppler
from blit.testing import synth_raw
from blit_torch import faults, observability
from blit_torch import stream as tstream
from blit_torch import workers as tworkers
from blit_torch.config import stream_defaults
from blit_torch.io.guppi import open_raw
from blit_torch.io.sigproc import read_fil, read_fil_header
from blit_torch.observability import StallWatchdog, Timeline
from blit_torch.pipeline import RawReducer
from blit_torch.search import DedopplerReducer

NFFT = 256
NINT = 2
CHUNK_FRAMES = 4
DEADLINE_S = 60
REPORT_KEYS = ("stream_chunks", "stream_late_chunks", "stream_dup_chunks",
               "stream_masked_chunks", "_masked_chunks", "nsamps",
               "stream_degraded_spectra")


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
def _clean(tmp_path, monkeypatch):
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path / "flight"))
    os.makedirs(str(tmp_path / "flight"), exist_ok=True)
    yield
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()


def _synth(path, nblocks=4, overlap=NFFT, seed=1):
    return synth_raw(str(path), nblocks=nblocks, obsnchan=2,
                     ntime_per_block=(8 + 3) * NFFT, overlap=overlap,
                     seed=seed, tone_chan=1)


def _port(**kw):
    kw.setdefault("timeline", Timeline())
    return RawReducer(nfft=NFFT, nint=NINT, chunk_frames=CHUNK_FRAMES,
                      device="cpu", **kw)


def _blit(**kw):
    kw.setdefault("timeline", BTimeline())
    return BRawReducer(nfft=NFFT, nint=NINT, chunk_frames=CHUNK_FRAMES, **kw)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _head(path):
    _, off = read_fil_header(str(path))
    return _read(path)[:off]


def _match_fil(port_path, blit_path, nbits=32):
    """Header bytes identical; nbits 8 bytes identical, f32 data within
    blit's f32 bound."""
    if nbits != 32:
        assert _read(port_path) == _read(blit_path)
        return
    assert _head(port_path) == _head(blit_path)
    (_, got), (_, want) = read_fil(str(port_path)), read_fil(str(blit_path))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-2 * np.abs(want[..., :NFFT]).max())


def _report(hdr):
    return {k: hdr.get(k) for k in REPORT_KEYS}


def _both(tmp_path, name, port_fn, blit_fn, suffix=".fil"):
    """Run a scenario in both packages: (port hdr, port path, blit hdr,
    blit path)."""
    p, b = tmp_path / f"p_{name}{suffix}", tmp_path / f"b_{name}{suffix}"
    return port_fn(str(p)), p, blit_fn(str(b)), b


def _zeroed(tmp_path, hdr0, blocks, masked):
    """The recording with the masked blocks zero-filled: what zero-weight
    masking must equal."""
    zb = [b.copy() for b in blocks]
    for i in masked:
        zb[i][:] = 0
    zraw = tmp_path / "zeroed.raw"
    bwrite_raw(str(zraw), hdr0, zb)
    return zraw


# -- replay equals batch ------------------------------------------------------

KNOBS = {"fil": {}, "sync": {"async_output": False},
         "nbits8": {"nbits": 8, "quant_scale": 0.5, "quant_offset": 3.0}}


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_replay_identical_to_batch_and_to_blit(tmp_path, case):
    raw = tmp_path / "r.raw"
    _synth(raw)
    kw = KNOBS[case]
    ref = tmp_path / "ref.fil"
    _port(**kw).reduce_to_file(str(raw), str(ref))
    ph, p, bh, b = _both(
        tmp_path, case,
        lambda o: tstream.stream_reduce(tstream.ReplaySource(str(raw), rate=1e6),
                                        o, reducer=_port(**kw)),
        lambda o: bstream.stream_reduce(bstream.ReplaySource(str(raw), rate=1e6),
                                        o, reducer=_blit(**kw)))
    assert _read(p) == _read(ref)
    _match_fil(p, b, kw.get("nbits", 32))
    assert _report(ph) == _report(bh)
    assert ph["stream_chunks"] == 4 and ph["stream_masked_chunks"] == 0
    assert ph["stream_tuning"]["sources"] == bh["stream_tuning"]["sources"]


def test_replay_h5_identical_to_batch_and_to_blit(tmp_path):
    pytest.importorskip("h5py")
    from blit_torch.io.fbh5 import read_fbh5_data, read_fbh5_header

    raw = tmp_path / "r.raw"
    _synth(raw)
    ref = tmp_path / "ref.h5"
    _port().reduce_to_file(str(raw), str(ref))
    ph, p, bh, b = _both(
        tmp_path, "h5",
        lambda o: tstream.stream_reduce(tstream.ReplaySource(str(raw), rate=1e6),
                                        o, reducer=_port()),
        lambda o: bstream.stream_reduce(bstream.ReplaySource(str(raw), rate=1e6),
                                        o, reducer=_blit()),
        suffix=".h5")
    assert _read(p) == _read(ref)
    assert read_fbh5_header(str(p)) == read_fbh5_header(str(b))
    want = read_fbh5_data(str(b))
    np.testing.assert_allclose(read_fbh5_data(str(p)), want, rtol=1e-4,
                               atol=1e-2 * np.abs(want[..., :NFFT]).max())
    assert _report(ph) == _report(bh)


def _searchers():
    kw = dict(nfft=NFFT, nint=NINT, chunk_frames=CHUNK_FRAMES,
              window_spectra=8, snr_threshold=2.0, top_k=4)
    return (lambda: DedopplerReducer(device="cpu", timeline=Timeline(), **kw),
            lambda: BDedoppler(kernel="reference", timeline=BTimeline(), **kw))


def _hits(path):
    with open(path) as f:
        head = f.readline()
        rows = [json.loads(line) for line in f]
    return head, rows


def test_stream_search_hits_identical_to_batch_and_to_blit(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    port_s, blit_s = _searchers()
    ref = tmp_path / "ref.hits"
    port_s().search_to_file(str(raw), str(ref))
    ph, p, bh, b = _both(
        tmp_path, "hits",
        lambda o: tstream.stream_search(tstream.ReplaySource(str(raw), rate=1e6),
                                        o, searcher=port_s()),
        lambda o: bstream.stream_search(bstream.ReplaySource(str(raw), rate=1e6),
                                        o, searcher=blit_s()),
        suffix=".hits")
    assert _read(p) == _read(ref)
    (hp, rp), (hb, rb) = _hits(p), _hits(b)
    assert hp == hb
    cells = ("window", "drift_bins", "chan", "band")
    assert [[r[k] for k in cells] for r in rp] == [[r[k] for k in cells] for r in rb]
    np.testing.assert_allclose([r["snr"] for r in rp], [r["snr"] for r in rb],
                               rtol=1e-4)
    assert ph["search_windows"] == bh["search_windows"] >= 2
    assert ph["search_nhits"] == bh["search_nhits"] > 0
    assert ph["stream_degraded_windows"] == bh["stream_degraded_windows"] == 0


# -- repair and masking -------------------------------------------------------


def _queue(pkg, chunks, order, total=4):
    qs = pkg.QueueSource()
    for i in order:
        qs.push(chunks[i])
    qs.finish(total=total)
    return qs


def test_reordered_and_duplicated_chunks_repair(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    ref = tmp_path / "ref.fil"
    _port().reduce_to_file(str(raw), str(ref))
    order = (1, 0, 2, 2, 3, 0)
    tc = tstream.chunks_of(open_raw(str(raw)))
    bc = bstream.chunks_of(bopen_raw(str(raw)))
    ph, p, bh, b = _both(
        tmp_path, "reorder",
        lambda o: tstream.stream_reduce(_queue(tstream, tc, order), o,
                                        reducer=_port(), lateness_s=10.0),
        lambda o: bstream.stream_reduce(_queue(bstream, bc, order), o,
                                        reducer=_blit(), lateness_s=10.0))
    assert _read(p) == _read(ref)
    _match_fil(p, b)
    assert ph["stream_dup_chunks"] == 2 and ph["stream_masked_chunks"] == 0
    assert _report(ph) == _report(bh)


@pytest.mark.parametrize("case", ["dropped", "missing_tail"])
def test_missing_chunk_masks_zero_weight(tmp_path, case):
    raw = tmp_path / "r.raw"
    hdr0, blocks = _synth(raw)
    masked, order = {"dropped": (2, (0, 1, 3)),
                     "missing_tail": (3, (0, 1, 2))}[case]
    zref = tmp_path / "zref.fil"
    _port().reduce_to_file(str(_zeroed(tmp_path, hdr0, blocks, [masked])),
                           str(zref))
    tc = tstream.chunks_of(open_raw(str(raw)))
    bc = bstream.chunks_of(bopen_raw(str(raw)))
    ph, p, bh, b = _both(
        tmp_path, case,
        lambda o: tstream.stream_reduce(_queue(tstream, tc, order), o,
                                        reducer=_port(), lateness_s=0.1),
        lambda o: bstream.stream_reduce(_queue(bstream, bc, order), o,
                                        reducer=_blit(), lateness_s=0.1))
    assert _read(p) == _read(zref)
    _match_fil(p, b)
    assert ph["_masked_chunks"] == [masked]
    assert _report(ph) == _report(bh)
    assert 0 < ph["stream_degraded_spectra"] < ph["nsamps"]
    assert faults.counters().get("mask.chunk") == 1
    with open(ph["stream_flight_dump"]) as f:
        assert "masked" in json.load(f)["reason"]


def _straggler(pkg, chunks):
    qs = pkg.QueueSource()
    qs.push(chunks[0])
    qs.push(chunks[2])  # proof that chunk 1 is missing

    def late():
        time.sleep(0.5)  # well past the 0.1 s budget
        qs.push(chunks[1])
        qs.push(chunks[3])
        qs.finish(total=4)

    t = threading.Thread(target=late)
    t.start()
    return qs, t


def test_late_chunk_after_mask_is_dropped(tmp_path):
    raw = tmp_path / "r.raw"
    hdr0, blocks = _synth(raw)
    zref = tmp_path / "zref.fil"
    _port().reduce_to_file(str(_zeroed(tmp_path, hdr0, blocks, [1])), str(zref))
    reports = []
    for pkg, chunks, red in (
            (tstream, tstream.chunks_of(open_raw(str(raw))), _port()),
            (bstream, bstream.chunks_of(bopen_raw(str(raw))), _blit())):
        qs, t = _straggler(pkg, chunks)
        out = tmp_path / f"{pkg.__name__}.fil"
        reports.append((pkg.stream_reduce(qs, str(out), reducer=red,
                                          lateness_s=0.1), out))
        t.join()
    (ph, p), (bh, b) = reports
    assert _read(p) == _read(zref)
    _match_fil(p, b)
    assert ph["stream_late_chunks"] == 1 and ph["_masked_chunks"] == [1]
    assert _report(ph) == _report(bh)


def test_injected_drop_and_dup_fault_modes(tmp_path):
    raw = tmp_path / "r.raw"
    hdr0, blocks = _synth(raw)
    zref = tmp_path / "zref.fil"
    _port().reduce_to_file(str(_zeroed(tmp_path, hdr0, blocks, [1])), str(zref))
    faults.install(faults.FaultRule("stream.chunk", "drop", times=1, after=1),
                   faults.FaultRule("stream.chunk", "dup", times=1, after=2))
    bfaults.install(bfaults.FaultRule("stream.chunk", "drop", times=1, after=1),
                    bfaults.FaultRule("stream.chunk", "dup", times=1, after=2))
    ph, p, bh, b = _both(
        tmp_path, "faults",
        lambda o: tstream.stream_reduce(tstream.ReplaySource(str(raw), rate=1e6),
                                        o, reducer=_port(), lateness_s=0.1),
        lambda o: bstream.stream_reduce(bstream.ReplaySource(str(raw), rate=1e6),
                                        o, reducer=_blit(), lateness_s=0.1))
    assert _read(p) == _read(zref)
    _match_fil(p, b)
    assert _report(ph) == _report(bh)
    assert ph["stream_masked_chunks"] == 1 and ph["stream_dup_chunks"] == 1
    for f in (faults, bfaults):
        c = f.counters()
        assert c.get("fault.stream.chunk.drop") == c.get("fault.stream.chunk.dup") == 1


def test_empty_stream_rejected():
    qs = tstream.QueueSource()
    qs.finish(total=0)
    with pytest.raises(ValueError, match="empty stream"):
        tstream.LiveRawStream(qs, lateness_s=0.1).header(0)


# -- the growing file ---------------------------------------------------------


def _write_slowly(src_path, dst_path, done_path, parts=6, dt=0.02):
    data = _read(src_path)
    step = -(-len(data) // parts)

    def run():
        with open(dst_path, "wb") as f:
            for i in range(0, len(data), step):
                f.write(data[i:i + step])
                f.flush()
                time.sleep(dt)
        with open(done_path, "w"):
            pass

    t = threading.Thread(target=run)
    t.start()
    return t


def test_tail_growing_file_identical_to_batch_and_to_blit(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    ref = tmp_path / "ref.fil"
    _port().reduce_to_file(str(raw), str(ref))
    outs = []
    for pkg, red, tag in ((tstream, _port(), "p"), (bstream, _blit(), "b")):
        live = str(tmp_path / f"{tag}live.0000.raw")
        t = _write_slowly(str(raw), live, str(tmp_path / f"{tag}live.done"))
        out = tmp_path / f"{tag}.fil"
        outs.append((pkg.stream_reduce(pkg.FileTailSource(live, poll_s=0.005),
                                       str(out), reducer=red), out))
        t.join()
    (ph, p), (bh, b) = outs
    assert _read(p) == _read(ref)
    _match_fil(p, b)
    assert ph["stream_chunks"] == 4 and _report(ph) == _report(bh)


def test_tail_follows_sequence_members(tmp_path):
    raw = tmp_path / "r.raw"
    hdr0, blocks = _synth(raw)
    m0, m1 = str(tmp_path / "seq.0000.raw"), str(tmp_path / "seq.0001.raw")
    bwrite_raw(m0, hdr0, blocks[:2])
    h1 = dict(hdr0)
    h1["PKTIDX"] = sum(b.shape[1] - hdr0.get("OVERLAP", 0) for b in blocks[:2])
    bwrite_raw(m1, h1, blocks[2:])
    ref = tmp_path / "ref.fil"
    _port().reduce_to_file([m0, m1], str(ref))
    bref = tmp_path / "bref.fil"
    _blit().reduce_to_file([m0, m1], str(bref))
    with open(str(tmp_path / "seq.done"), "w"):
        pass
    out = tmp_path / "s.fil"
    hdr = tstream.stream_reduce(tstream.FileTailSource(m0, poll_s=0.005),
                                str(out), reducer=_port())
    assert _read(out) == _read(ref)
    _match_fil(out, bref)
    assert hdr["stream_chunks"] == 4


def test_idle_timeout_ends_session(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    ref = tmp_path / "ref.fil"
    _port().reduce_to_file(str(raw), str(ref))
    live = str(tmp_path / "live.0000.raw")
    with open(live, "wb") as f:
        f.write(_read(raw))
    out = tmp_path / "s.fil"
    hdr = tstream.stream_reduce(
        tstream.FileTailSource(live, poll_s=0.01, idle_timeout_s=0.15),
        str(out), reducer=_port())
    assert hdr["stream_chunks"] == 4
    assert _read(out) == _read(ref)


@pytest.mark.parametrize("pkg", [tstream, bstream], ids=["port", "blit"])
def test_half_written_block_not_delivered(tmp_path, pkg):
    raw = tmp_path / "r.raw"
    _synth(raw, nblocks=2)
    data = _read(raw)
    live = str(tmp_path / "live.0000.raw")
    with open(live, "wb") as f:
        f.write(data[:len(data) - 100])  # the last block torn
    src = pkg.FileTailSource(live, poll_s=0.005)
    c = src.get(timeout=0.05)
    assert c is not None and c.seq == 0
    assert src.get(timeout=0.05) is None
    with open(live, "ab") as f:
        f.write(data[len(data) - 100:])
    c = src.get(timeout=0.05)
    assert c is not None and c.seq == 1
    assert c.data.shape == bopen_raw(str(raw)).read_block(1).shape


# -- metrics, watchdog, config -------------------------------------------------


def test_chunk_to_product_histogram_and_gauges(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    red, bred = _port(), _blit()
    tstream.stream_reduce(tstream.ReplaySource(str(raw), rate=1e6),
                          str(tmp_path / "p.fil"), reducer=red)
    bstream.stream_reduce(bstream.ReplaySource(str(raw), rate=1e6),
                          str(tmp_path / "b.fil"), reducer=bred)
    rep, brep = red.timeline.report(), bred.timeline.report()
    lat = rep["hists"]["stream.chunk_to_product_s"]
    blat = brep["hists"]["stream.chunk_to_product_s"]
    assert lat["n"] == blat["n"] >= 4  # one sample per product append
    assert lat["p99"] >= lat["p50"] >= 0.0
    assert "stream.watermark_lag_s" in rep["gauges"]
    assert rep["stream.chunks"]["calls"] == brep["stream.chunks"]["calls"] == 4
    # The output plane's histograms are there, as in blit.
    assert {"out.chunk_latency_s", "out.readback_lag_s", "out.write_s"} <= set(rep["hists"])


def test_default_reducer_records_on_process_timeline(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    tl = observability.process_timeline()
    before = tl.hists["stream.chunk_to_product_s"].n
    tstream.stream_reduce(tstream.ReplaySource(str(raw), rate=1e6),
                          str(tmp_path / "s.fil"), nfft=NFFT, nint=NINT,
                          chunk_frames=CHUNK_FRAMES, device="cpu")
    assert tl.hists["stream.chunk_to_product_s"].n > before


def test_stall_watchdog_semantics():
    wd = StallWatchdog(None, "x")
    assert wd.poll_s(0.3) == 0.3
    wd.check("never trips")
    wd = StallWatchdog(0.2, "x", what="test stall")
    assert wd.poll_s(0.5) == 0.1
    wd._beat -= 1.0
    assert wd.stalled() and not wd.stalled(active=False)
    with pytest.raises(RuntimeError, match="stalled here"):
        wd.check("stalled here")


def test_wedged_source_trips_feed_watchdog(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    qs = tstream.QueueSource()
    qs.push(tstream.chunks_of(open_raw(str(raw)))[0])  # then the source wedges
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stall"):
        tstream.stream_reduce(qs, str(tmp_path / "s.fil"), reducer=_port(),
                              lateness_s=0.05, stall_timeout_s=0.3)
    assert time.monotonic() - t0 < 10


def test_quiet_source_without_watchdog_is_patient(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw)
    cs = tstream.chunks_of(open_raw(str(raw)))
    qs = tstream.QueueSource()

    def trickle():
        for c in cs:
            time.sleep(0.05)
            qs.push(c)
        qs.finish(total=4)

    t = threading.Thread(target=trickle)
    t.start()
    hdr = tstream.stream_reduce(qs, str(tmp_path / "s.fil"), reducer=_port(),
                                lateness_s=5.0)
    t.join()
    assert hdr["stream_masked_chunks"] == 0


def test_stream_config_env_overrides_match_blit(monkeypatch, tmp_path):
    from blit.config import stream_defaults as bstream_defaults

    monkeypatch.setenv("BLIT_STREAM_LATENESS", "7.5")
    monkeypatch.setenv("BLIT_STREAM_POLL", "0.25")
    monkeypatch.setenv("BLIT_STREAM_IDLE_TIMEOUT", "12")
    monkeypatch.setenv("BLIT_STREAM_STALL_TIMEOUT", "-1")
    d = stream_defaults()
    assert d == bstream_defaults()
    assert d["stall_timeout_s"] is None and d["idle_timeout_s"] == 12.0
    assert tstream.LiveRawStream(tstream.QueueSource()).lateness_s == 7.5
    assert tstream.FileTailSource(str(tmp_path / "x.0000.raw")).idle_timeout_s == 12.0


def test_live_entry_points_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    raw = tmp_path / "r.raw"
    _synth(raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.stream_reduce(tstream.ReplaySource(str(raw), rate=1e6),
                              str(tmp_path / "s.fil"), nfft=NFFT, nint=NINT)


# -- workers.stream_raw and the command line -----------------------------------


@pytest.mark.parametrize("spec", [None, "replay", "packet-replay"])
def test_workers_stream_raw(tmp_path, spec):
    raw = tmp_path / "r.raw"
    _synth(raw)
    ref = tmp_path / "ref.fil"
    _port().reduce_to_file(str(raw), str(ref))
    source = None if spec is None else {"kind": spec, "rate": 1e6}
    kw = dict(nfft=NFFT, nint=NINT, chunk_frames=CHUNK_FRAMES)
    ph, p, bh, b = _both(
        tmp_path, str(spec),
        lambda o: tworkers.stream_raw(str(raw), o, replay_rate=1e6,
                                      source=source, device="cpu", **kw),
        lambda o: bworkers.stream_raw(str(raw), o, replay_rate=1e6,
                                      source=source, **kw))
    assert _read(p) == _read(ref)
    _match_fil(p, b)
    assert ph["stream_chunks"] == 4 and _report(ph) == _report(bh)
    untimed = lambda rep: {k: v for k, v in (rep or {}).items()  # noqa: E731
                           if not k.endswith("_s")}
    assert untimed(ph.get("_packet_report")) == untimed(bh.get("_packet_report"))


def _main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_stream_matches_blit(tmp_path):
    from blit.__main__ import main as bmain
    from blit_torch.__main__ import main as tmain

    raw = tmp_path / "r.raw"
    _synth(raw)
    args = [str(raw), "--nfft", str(NFFT), "--nint", str(NINT),
            "--replay-rate", "1000"]
    p, b = str(tmp_path / "p.fil"), str(tmp_path / "b.fil")
    rc, rep = _main(tmain, ["stream", *args, "-o", p, "--device", "cpu"])
    brc, brep = _main(bmain, ["stream", *args, "-o", b])
    assert rc == brc == 0
    assert set(rep) == set(brep)
    assert {k: rep[k] for k in rep if "_s" not in k and k != "output"} == \
        {k: brep[k] for k in brep if "_s" not in k and k != "output"}
    assert rep["chunk_to_product_p99_s"] >= rep["chunk_to_product_p50_s"] >= 0.0
    _match_fil(p, b)
