"""Live-session rejoin in the port (blit_torch.stream.StreamCursor and
the resume legs of stream_reduce / stream_search), held against
blit's, after tests/test_stream_rejoin.py.

A consumer stopped by an injected sink.write fault mid-session and
restarted with resume=True finishes a product byte-identical to the
batch reduction (.fil and .hits), re-masking the seats the stopped run
masked.  Cursor sidecars written by either package load in the other
and match the other's reducer of the same knobs; an nbits=8 session
stopped in one package rejoins in the other, byte-identical.  Every
test runs under a SIGALRM deadline.
"""

import os
import signal

import pytest

from blit import faults as bfaults
from blit import stream as bstream
from blit.pipeline import RawReducer as BRawReducer
from blit.testing import synth_raw
from blit_torch import faults
from blit_torch import stream as tstream
from blit_torch.io.guppi import open_raw
from blit_torch.pipeline import RawReducer
from blit_torch.search import DedopplerReducer
from blit_torch.stream import ReplaySource, StreamCursor, stream_reduce, stream_search

NFFT, CF = 32, 4
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


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    yield
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()


def _recording(tmp_path, name="r.raw", nblocks=4, seed=1):
    p = str(tmp_path / name)
    synth_raw(p, nblocks=nblocks, obsnchan=2, ntime_per_block=512, seed=seed)
    return p


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _kw(**extra):
    return dict(nfft=NFFT, chunk_frames=CF, tune_online=False, **extra)


def _port(**extra):
    return RawReducer(device="cpu", **_kw(**extra))


def test_cursor_round_trip_and_identity():
    cur = StreamCursor(path="sess.raw", kind="filterbank", nfft=NFFT,
                       frames_done=12, masked_chunks=[1, 3])
    red = _port()
    fresh = StreamCursor.fresh(red, "sess.raw", "filterbank")
    assert fresh.matches(red, "sess.raw", "filterbank")
    assert not fresh.matches(red, "other.raw", "filterbank")
    assert not fresh.matches(red, "sess.raw", "hits")
    assert not fresh.matches(RawReducer(nfft=2 * NFFT, chunk_frames=CF,
                                        device="cpu"), "sess.raw", "filterbank")
    assert cur.__dict__ == bstream.StreamCursor(**cur.__dict__).__dict__


@pytest.mark.parametrize("kind", ["filterbank", "hits"])
@pytest.mark.parametrize("writer", ["port", "blit"])
def test_cursor_sidecars_cross_load(tmp_path, kind, writer):
    out = str(tmp_path / "x.out")
    knobs = dict(nbits=8, quant_scale=0.5, quant_offset=3.0) \
        if kind == "filterbank" else {}
    if kind == "hits":
        sk = dict(nfft=NFFT, window_spectra=4, top_k=4, snr_threshold=2.0)
        red = DedopplerReducer(device="cpu", **sk)
        from blit.search import DedopplerReducer as BDedoppler

        bred = BDedoppler(**sk)
    else:
        red, bred = _port(**knobs), BRawReducer(**_kw(**knobs))
    src, dst = ((tstream.StreamCursor, bstream.StreamCursor)
                if writer == "port" else
                (bstream.StreamCursor, tstream.StreamCursor))
    cur = src.fresh(red if writer == "port" else bred, "sess.raw", kind)
    cur.frames_done, cur.masked_chunks = 8, [2]
    cur.save(out)
    back = dst.load(out)
    assert back is not None and back.__dict__ == cur.__dict__
    assert back.matches(red, "sess.raw", kind)
    assert back.matches(bred, "sess.raw", kind)


def test_crash_and_rejoin_byte_identical_to_batch(tmp_path):
    raw = _recording(tmp_path)
    oracle = str(tmp_path / "o.fil")
    _port().reduce_to_file(raw, oracle)
    out = str(tmp_path / "s.fil")
    faults.install_spec("sink.write:fail:after=2")
    with pytest.raises(OSError):
        stream_reduce(ReplaySource(raw, rate=10000), out, resume=True,
                      reducer=_port())
    faults.clear()
    cur = StreamCursor.load(out)
    assert cur is not None and cur.frames_done > 0
    hdr = stream_reduce(ReplaySource(raw, rate=10000), out, resume=True,
                        reducer=_port())
    assert hdr["nsamps"] * 1 >= cur.frames_done
    assert _bytes(out) == _bytes(oracle)
    assert StreamCursor.load(out) is None


def test_identity_mismatch_and_claim_past_eof_restart_fresh(tmp_path):
    raw = _recording(tmp_path)
    oracle = str(tmp_path / "o.fil")
    _port().reduce_to_file(raw, oracle)
    out = str(tmp_path / "s.fil")
    StreamCursor(path=raw, kind="filterbank", nfft=NFFT * 2,
                 frames_done=8).save(out)
    with open(out, "wb") as f:
        f.write(b"junk")
    stream_reduce(ReplaySource(raw, rate=10000), out, resume=True,
                  reducer=_port())
    assert _bytes(out) == _bytes(oracle)
    faults.install_spec("sink.write:fail:after=2")
    with pytest.raises(OSError):
        stream_reduce(ReplaySource(raw, rate=10000), out, resume=True,
                      reducer=_port())
    faults.clear()
    with open(out, "r+b") as f:
        f.truncate(os.path.getsize(out) - 64)  # eat claimed bytes
    stream_reduce(ReplaySource(raw, rate=10000), out, resume=True,
                  reducer=_port())
    assert _bytes(out) == _bytes(oracle)


def _queue(raw, seqs, total):
    src = tstream.QueueSource(path=raw)
    for c in tstream.chunks_of(open_raw(raw)):
        if c.seq in seqs:
            src.push(c)
    src.finish(total)
    return src


def test_premasked_seat_stays_masked_when_data_appears(tmp_path):
    raw = _recording(tmp_path)
    total = 4
    missing_1 = set(range(total)) - {1}
    oracle = str(tmp_path / "never_restarted.fil")
    hdr_a = stream_reduce(_queue(raw, missing_1, total), oracle,
                          lateness_s=0.01, reducer=_port())
    assert hdr_a["stream_masked_chunks"] == 1
    out = str(tmp_path / "rejoined.fil")
    faults.install_spec("sink.write:fail:after=4")
    with pytest.raises(OSError):
        stream_reduce(_queue(raw, missing_1, total), out, lateness_s=0.01,
                      resume=True, reducer=_port())
    faults.clear()
    assert StreamCursor.load(out).masked_chunks == [1]
    hdr_b = stream_reduce(_queue(raw, set(range(total)), total), out,
                          lateness_s=5.0, resume=True, reducer=_port())
    assert hdr_b["stream_masked_chunks"] == 1
    assert hdr_b["stream_late_chunks"] >= 1
    assert _bytes(out) == _bytes(oracle)


def test_hits_crash_and_rejoin_byte_identical_to_batch(tmp_path):
    sk = dict(nfft=NFFT, window_spectra=4, top_k=4, snr_threshold=2.0,
              chunk_frames=CF, device="cpu")
    raw = _recording(tmp_path, seed=7)
    oracle = str(tmp_path / "o.hits")
    DedopplerReducer(**sk).search_to_file(raw, oracle)
    out = str(tmp_path / "s.hits")
    faults.install_spec("sink.write:fail:after=2")
    with pytest.raises(OSError):
        stream_search(ReplaySource(raw, rate=10000), out, resume=True,
                      searcher=DedopplerReducer(**sk))
    faults.clear()
    cur = StreamCursor.load(out)
    assert cur is not None and cur.windows_done > 0
    hdr = stream_search(ReplaySource(raw, rate=10000), out, resume=True,
                        searcher=DedopplerReducer(**sk))
    assert hdr["search_windows"] > cur.windows_done
    assert _bytes(out) == _bytes(oracle)
    assert StreamCursor.load(out) is None


@pytest.mark.parametrize("first", ["blit", "port"])
def test_rejoin_across_packages_nbits8(tmp_path, first):
    q = dict(nbits=8, quant_scale=0.5, quant_offset=3.0)
    raw = _recording(tmp_path)
    oracle = str(tmp_path / "o.fil")
    _port(**q).reduce_to_file(raw, oracle)
    out = str(tmp_path / "s.fil")
    runs = {
        "port": lambda: tstream.stream_reduce(
            tstream.ReplaySource(raw, rate=10000), out, resume=True,
            reducer=_port(**q)),
        "blit": lambda: bstream.stream_reduce(
            bstream.ReplaySource(raw, rate=10000), out, resume=True,
            reducer=BRawReducer(**_kw(**q))),
    }
    (faults if first == "port" else bfaults).install_spec(
        "sink.write:fail:after=2")
    with pytest.raises(OSError):
        runs[first]()
    faults.clear()
    bfaults.clear()
    claimed = StreamCursor.load(out).frames_done
    assert claimed > 0
    runs["blit" if first == "port" else "port"]()
    assert _bytes(out) == _bytes(oracle)
    assert StreamCursor.load(out) is None
