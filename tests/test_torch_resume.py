"""Crash-resumable reductions and searches inside the port.

A run interrupted by an injected fault (the write-behind sink's
``sink.write`` point on the asynchronous plane; a ``guppi.read`` failure
with retries off on the synchronous one) leaves the product and its
cursor; the re-run must finish a product byte-identical to an
uninterrupted run, for ``.fil`` (f32 and nbits 8), ``.h5`` (none, gzip,
bitshuffle) and ``.hits``.  The cases of tests/test_resume_fbh5.py
follow: a tampered recording, a compression flip, a chunks flip, a
corrupt ``.h5`` target and a cursor claiming more than the file holds
each restart fresh.  Small shapes: nfft 64, nint 2, 2 channels, chunks
of 4 frames and a short tail chunk.
"""

import contextlib
import dataclasses
import logging
import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from blit_torch import faults  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.io import bshuf  # noqa: E402
from blit_torch.io.fbh5 import (  # noqa: E402
    ResumableFBH5Writer,
    _cursor_path,
    read_fbh5_data,
    resume_target_ok,
    write_fbh5,
)
from blit_torch.pipeline import RawReducer, ReductionCursor  # noqa: E402
from blit_torch.search import DedopplerReducer, SearchCursor  # noqa: E402

HDR = {"fch1": 8000.0, "foff": -0.1, "tsamp": 1.0, "nbits": 32,
       "source_name": "SYNTH"}


class Boom(Exception):
    pass


def make_red(**kw):
    return RawReducer(nfft=64, nint=2, chunk_frames=4, device="cpu",
                      output_stall_timeout_s=30.0, **kw)


@pytest.fixture
def raw(tmp_path):
    p = str(tmp_path / "x.raw")
    # 4 blocks of 1000 samples: 59 frames, 29 spectra of nint 2 in chunks
    # of 4 frames and a short tail chunk.
    ttesting.synth_raw(p, nblocks=4, obsnchan=2, ntime_per_block=1000,
                       tone_chan=1)
    return p


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    faults.reset_counters()
    yield
    faults.clear()
    faults.reset_counters()
    faults.set_io_policy(None)


@contextlib.contextmanager
def crash_after(n_slabs):
    """Fail every append after the first ``n_slabs`` at the sink."""
    faults.install(faults.FaultRule(point="sink.write", mode="fail",
                                    after=n_slabs, times=-1, exc=Boom))
    try:
        yield
    finally:
        faults.clear()


@contextlib.contextmanager
def read_fails_after(n_reads):
    """Fail every block read after the first ``n_reads``, no retries."""
    faults.set_io_policy(faults.RetryPolicy(attempts=1))
    faults.install(faults.FaultRule(point="guppi.read", mode="fail",
                                    after=n_reads, times=-1))
    try:
        yield
    finally:
        faults.clear()
        faults.set_io_policy(None)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_cursor_sidecar_paths_in_lockstep():
    assert _cursor_path("/x/y.h5") == ReductionCursor.path_for("/x/y.h5")


def test_cursor_matches_is_member_order_insensitive(tmp_path):
    paths, _ = ttesting.synth_raw_sequence(str(tmp_path / "s"), nfiles=3,
                                           blocks_per_file=1, obsnchan=2)
    size, mtime = ReductionCursor.stat_raw(paths)
    cur = ReductionCursor(paths, 64, 4, 2, "I", raw_size=size, raw_mtime_ns=mtime)
    red = RawReducer(nfft=64, nint=2, device="cpu")
    assert cur.matches(red, list(reversed(paths)))
    assert not cur.matches(red, paths[:2])
    assert not cur.matches(RawReducer(nfft=64, nint=4, device="cpu"), paths)


@pytest.mark.parametrize("plane", ["async", "sync"])
@pytest.mark.parametrize("nbits", [32, 8])
def test_fil_resume_is_byte_identical(raw, tmp_path, plane, nbits):
    kw = dict(nbits=nbits, quant_scale=2.0, async_output=plane == "async")
    ref = str(tmp_path / "ref.fil")
    make_red(**kw).reduce_to_file(raw, ref)
    out = str(tmp_path / "x.fil")
    crash = crash_after(2) if plane == "async" else read_fails_after(2)
    with crash, pytest.raises((Boom, OSError)):
        make_red(**kw).reduce_resumable(raw, out)
    cur = ReductionCursor.load(out)
    assert cur is not None and cur.frames_done > 0 and cur.nbits == nbits
    hdr = make_red(**kw).reduce_resumable(raw, out)
    assert _bytes(out) == _bytes(ref)
    assert hdr["nsamps"] == 29
    assert not os.path.exists(ReductionCursor.path_for(out))


@pytest.mark.parametrize("compression", [None, "gzip", "bitshuffle"])
def test_h5_resume_is_byte_identical(raw, tmp_path, compression):
    if compression == "bitshuffle" and not bshuf.available():
        pytest.skip(f"bitshuffle codec unavailable (g++ or liblz4.so.1 "
                    f"missing): {bshuf.unavailable_reason()}")
    # Two-row chunks: each 2-row slab completes a bitshuffle chunk, so
    # the claim is non-zero after one slab for every codec.
    chunks = (2, 1, 128)
    ref = str(tmp_path / "ref.h5")
    make_red().reduce_to_file(raw, ref, compression=compression, chunks=chunks)
    out = str(tmp_path / "x.h5")
    with crash_after(1), pytest.raises(Boom):
        make_red().reduce_resumable(raw, out, compression=compression,
                                    chunks=chunks)
    cur = ReductionCursor.load(out)
    assert cur.frames_done == 4 and cur.compression == (compression or "none")
    make_red().reduce_resumable(raw, out, compression=compression, chunks=chunks)
    want = read_fbh5_data(ref)
    assert want.shape == (29, 1, 128)
    np.testing.assert_array_equal(read_fbh5_data(out), want)
    assert not os.path.exists(ReductionCursor.path_for(out))
    # The same payload as the .fil product.
    _, fil = make_red().reduce(raw)
    np.testing.assert_array_equal(want, fil)


def test_bitshuffle_default_chunks_resume_restarts_clean(raw, tmp_path):
    if not bshuf.available():
        pytest.skip(f"bitshuffle codec unavailable: {bshuf.unavailable_reason()}")
    out = str(tmp_path / "x.h5")
    with crash_after(1), pytest.raises(Boom):
        make_red().reduce_resumable(raw, out, compression="bitshuffle")
    assert ReductionCursor.load(out).frames_done == 0
    make_red().reduce_resumable(raw, out, compression="bitshuffle")
    _, want = make_red().reduce(raw)
    np.testing.assert_array_equal(read_fbh5_data(out), want)


@pytest.mark.parametrize("case", ["compression", "chunks", "raw"])
def test_identity_change_restarts_fresh(raw, tmp_path, case):
    out = str(tmp_path / "x.h5")
    first = dict(chunks=(2, 1, 128)) if case == "chunks" else {}
    with crash_after(1), pytest.raises(Boom):
        make_red().reduce_resumable(raw, out, **first)
    assert ReductionCursor.load(out).frames_done > 0
    again = {}
    if case == "compression":
        again = dict(compression="gzip")
    elif case == "raw":
        # A different valid recording: new mtime and payload.
        ttesting.synth_raw(raw, nblocks=4, obsnchan=2, ntime_per_block=1000,
                           tone_chan=0, seed=7)
    make_red().reduce_resumable(raw, out, **again)
    _, want = make_red().reduce(raw)
    np.testing.assert_array_equal(read_fbh5_data(out), want)
    with h5py.File(out, "r") as f:
        assert f["data"].compression == again.get("compression")


def test_corrupt_h5_target_restarts_fresh(raw, tmp_path, caplog):
    out = str(tmp_path / "x.h5")
    with crash_after(1), pytest.raises(Boom):
        make_red().reduce_resumable(raw, out)
    assert ReductionCursor.load(out).frames_done > 0
    with open(out, "r+b") as f:
        f.write(b"\xde\xad\xbe\xef" * 128)
    with caplog.at_level(logging.WARNING, logger="blit_torch.pipeline"):
        make_red().reduce_resumable(raw, out)
    assert "starting fresh" in caplog.text
    _, want = make_red().reduce(raw)
    np.testing.assert_array_equal(read_fbh5_data(out), want)


def test_resume_probe_rejects_garbage_and_accepts_good(tmp_path):
    good = str(tmp_path / "good.h5")
    data = np.random.default_rng(0).standard_normal((6, 1, 8)).astype(np.float32)
    write_fbh5(good, HDR, data)
    assert resume_target_ok(good, 1, 8, 6)
    assert not resume_target_ok(good, 1, 8, 7)
    assert not resume_target_ok(good, 2, 8, 4)
    bad = str(tmp_path / "bad.h5")
    with open(bad, "wb") as f:
        f.write(b"\x00not hdf5 at all" * 64)
    assert not resume_target_ok(bad, 1, 8, 1)
    assert not resume_target_ok(str(tmp_path / "absent.h5"), 1, 8, 1)


@pytest.mark.parametrize("fmt", ["fil", "h5"])
def test_cursor_claiming_more_than_the_file_restarts_fresh(raw, tmp_path, fmt,
                                                           caplog):
    out = str(tmp_path / f"x.{fmt}")
    with crash_after(2), pytest.raises(Boom):
        make_red().reduce_resumable(raw, out)
    cur = ReductionCursor.load(out)
    cur.frames_done += 40  # more than the product holds
    cur.save(out)
    with caplog.at_level(logging.WARNING, logger="blit_torch.pipeline"):
        make_red().reduce_resumable(raw, out)
    assert "starting fresh" in caplog.text
    _, want = make_red().reduce(raw)
    got = read_fbh5_data(out) if fmt == "h5" else None
    if fmt == "fil":
        ref = str(tmp_path / "ref.fil")
        make_red().reduce_to_file(raw, ref)
        assert _bytes(out) == _bytes(ref)
    else:
        np.testing.assert_array_equal(got, want)


def test_torn_fil_claim_restarts_fresh(raw, tmp_path):
    # A flipped byte inside the claimed region fails the manifest's
    # digest: the resume starts fresh instead of splicing onto it.
    out, ref = str(tmp_path / "x.fil"), str(tmp_path / "ref.fil")
    make_red().reduce_to_file(raw, ref)
    with crash_after(2), pytest.raises(Boom):
        make_red().reduce_resumable(raw, out)
    with open(out, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    make_red().reduce_resumable(raw, out)
    assert _bytes(out) == _bytes(ref)


class TestWriterDurability:
    def test_plain_checkpoints_every_append(self, tmp_path):
        out = str(tmp_path / "w.h5")
        cur = ReductionCursor("x.raw", 64, 4, 2, "I")
        w = ResumableFBH5Writer(out, HDR, 1, 8, 0, 2, cur)
        w.append(np.ones((3, 1, 8), np.float32))
        assert ReductionCursor.load(out).frames_done == 6
        w.abort()
        assert os.path.exists(out) and ReductionCursor.load(out).frames_done == 6

    def test_bitshuffle_claims_only_flushed_chunks(self, tmp_path):
        if not bshuf.available():
            pytest.skip(f"bitshuffle codec unavailable: {bshuf.unavailable_reason()}")
        out = str(tmp_path / "w.h5")
        cur = ReductionCursor("x.raw", 64, 4, 2, "I")
        w = ResumableFBH5Writer(out, HDR, 1, 8, 0, 2, cur,
                                compression="bitshuffle", chunks=(4, 1, 8))
        w.append(np.ones((3, 1, 8), np.float32))
        assert ReductionCursor.load(out).frames_done == 0
        w.append(np.ones((3, 1, 8), np.float32))
        assert ReductionCursor.load(out).frames_done == 8
        w.abort()
        with pytest.raises(ValueError, match="not aligned"):
            ResumableFBH5Writer(out, HDR, 1, 8, 3, 2, cur,
                                compression="bitshuffle", chunks=(4, 1, 8))

    def test_resume_truncates_unclaimed_tail_and_refuses_filter_mismatch(
            self, tmp_path):
        out = str(tmp_path / "w.h5")
        cur = ReductionCursor("x.raw", 64, 4, 2, "I")
        w = ResumableFBH5Writer(out, HDR, 1, 8, 0, 2, cur)
        w.append(np.arange(40, dtype=np.float32).reshape(5, 1, 8))
        w.abort()
        w = ResumableFBH5Writer(out, HDR, 1, 8, 2, 2, cur)
        assert ReductionCursor.load(out).frames_done == 4
        w.append(np.full((1, 1, 8), -1, np.float32))
        w.close()
        got = read_fbh5_data(out)
        np.testing.assert_array_equal(got[:2].ravel(), np.arange(16))
        np.testing.assert_array_equal(got[2], -1)
        assert not os.path.exists(ReductionCursor.path_for(out))
        if bshuf.available():
            with pytest.raises(ValueError, match="bitshuffle"):
                ResumableFBH5Writer(out, HDR, 1, 8, 2, 2, cur,
                                    compression="bitshuffle", chunks=(16, 1, 8))


# -- the search --------------------------------------------------------------


def make_search(**kw):
    kw = {"top_k": 4, **kw}
    return DedopplerReducer(nfft=64, nint=1, window_spectra=8,
                            snr_threshold=3.0, chunk_frames=8, device="cpu",
                            output_stall_timeout_s=30.0, **kw)


@pytest.fixture
def search_raw(tmp_path):
    p = str(tmp_path / "s.raw")
    ttesting.synth_raw(p, nblocks=6, obsnchan=2, ntime_per_block=1024,
                       tone_chan=1, tone_drift=ttesting.tone_drift_for(64, 8, 3.0),
                       seed=5)
    return p


@pytest.mark.parametrize("plane", ["async", "sync"])
def test_hits_resume_is_byte_identical(search_raw, tmp_path, plane):
    kw = dict(async_output=plane == "async")
    ref = str(tmp_path / "ref.hits")
    hdr_ref = make_search(**kw).search_to_file(search_raw, ref)
    assert hdr_ref["search_windows"] == 11 and hdr_ref["search_nhits"] > 0
    out = str(tmp_path / "x.hits")
    crash = crash_after(3) if plane == "async" else read_fails_after(3)
    with crash, pytest.raises((Boom, OSError)):
        make_search(**kw).search_resumable(search_raw, out)
    cur = SearchCursor.load(out)
    assert cur is not None and 0 < cur.windows_done < 11
    assert cur.window_claims[-1] == [cur.windows_done, cur.byte_offset,
                                     cur.hits_done]
    hdr = make_search(**kw).search_resumable(search_raw, out)
    assert _bytes(out) == _bytes(ref)
    assert (hdr["search_windows"], hdr["search_nhits"]) == (
        hdr_ref["search_windows"], hdr_ref["search_nhits"])
    assert not os.path.exists(SearchCursor.path_for(out))


def test_hits_cursor_claiming_more_than_the_file_restarts_fresh(search_raw,
                                                                  tmp_path):
    ref, out = str(tmp_path / "ref.hits"), str(tmp_path / "x.hits")
    make_search().search_to_file(search_raw, ref)
    with crash_after(3), pytest.raises(Boom):
        make_search().search_resumable(search_raw, out)
    cur = SearchCursor.load(out)
    cur.byte_offset += 10_000
    cur.save(out)
    make_search().search_resumable(search_raw, out)
    assert _bytes(out) == _bytes(ref)


def test_search_cursor_identity(search_raw, tmp_path):
    out = str(tmp_path / "x.hits")
    with crash_after(3), pytest.raises(Boom):
        make_search().search_resumable(search_raw, out)
    cur = SearchCursor.load(out)
    assert cur.matches(make_search(), search_raw)
    assert not cur.matches(make_search(top_k=5), search_raw)
    assert cur.claim_at(cur.windows_done) == (cur.byte_offset, cur.hits_done)
    assert cur.claim_at(10_000) is None
    assert dataclasses.asdict(SearchCursor.load(out)) == dataclasses.asdict(cur)
