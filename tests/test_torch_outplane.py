"""The port's asynchronous ingest and output plane: the readback rotation
(OutputRotation), the write-behind sink (AsyncSink), the fold bookkeeping
(FoldInFlight), the prefetch rotation (BufferRotation) and, above all,
that products through the plane are byte-identical to the synchronous
path's.  Mirrors tests/test_outplane.py; the search is also held against
blit's hits.

Every threaded test bounds itself (a stall_timeout_s, a join timeout or
a timed wait), so a hang fails that test and not the suite.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from blit.search.dedoppler import DedopplerReducer as BlitDedoppler  # noqa: E402
from blit_torch import hostmem  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.outplane import (  # noqa: E402
    AsyncSink,
    FoldInFlight,
    OutputRotation,
    readback_extra_slots,
)
from blit_torch.parallel import antenna as TA  # noqa: E402
from blit_torch.parallel import beamform as TB  # noqa: E402
from blit_torch.parallel import correlator as TC  # noqa: E402
from blit_torch.pipeline import BufferRotation, RawReducer  # noqa: E402
from blit_torch.search import DedopplerReducer  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

CPU = "cpu"
PLANE_THREADS = ("blit-readback", "blit-sink", "blit-bf-readback",
                 "blit-search-readback", "blit-ingest", "blit-search-feed",
                 "blit-antenna-feed", "blit-correlator-feed")


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path))


def no_plane_threads() -> bool:
    """No plane thread may outlive the call that started it (bounded wait)."""
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate()
                if t.name in PLANE_THREADS and t.is_alive()]:
            return True
        time.sleep(0.02)
    return False


class _Event:
    """An event stand-in: ``synchronize`` waits on a threading.Event (or
    raises)."""

    def __init__(self, gate=None, error=None):
        self.gate, self.error = gate, error

    def synchronize(self):
        if self.error is not None:
            raise self.error
        if self.gate is not None:
            assert self.gate.wait(timeout=10.0)


# -- OutputRotation ---------------------------------------------------------


class TestOutputRotation:
    @pytest.mark.parametrize("reuse", [False, True])
    def test_order_and_values_preserved(self, reuse):
        tl = Timeline()
        rot = OutputRotation(depth=2, timeline=tl, reuse=reuse)
        got = []

        def take(slabs):
            for slab in slabs:  # a ring slab is released once read
                got.append(slab.data.copy())
                slab.release()

        try:
            for i in range(7):
                take(rot.put(torch.full((4, 3), float(i)), nbytes=48))
            take(rot.drain())
        finally:
            rot.close()
        assert len(got) == 7
        for i, data in enumerate(got):
            np.testing.assert_array_equal(data, np.full((4, 3), float(i), np.float32))
        assert tl.stages["readback"].calls == 7
        assert tl.stages["readback"].bytes == 7 * 4 * 3 * 4
        assert tl.stages["device"].bytes == 7 * 48
        assert no_plane_threads()

    def test_ring_mode_reuses_bounded_slabs(self):
        rot = OutputRotation(depth=2, reuse=True)
        try:
            seen = set()
            for i in range(10):
                for slab in rot.put(torch.full((8,), float(i))):
                    seen.add(slab.data.ctypes.data)
                    assert float(slab.data[0]) == float(slab.data[-1])
                    slab.release()
            for slab in rot.drain():
                seen.add(slab.data.ctypes.data)
                slab.release()
            assert len(seen) <= 3  # depth + 1 resident slabs
        finally:
            rot.close()

    def test_reuse_false_emits_caller_owned_arrays(self):
        rot = OutputRotation(depth=2, reuse=False)
        try:
            kept = []
            for i in range(6):
                kept.extend(s.data for s in rot.put(torch.full((5,), float(i))))
            kept.extend(s.data for s in rot.drain())
        finally:
            rot.close()
        # Nothing recycled a kept array under the caller.
        assert [float(k[0]) for k in kept] == [float(i) for i in range(6)]
        assert len({k.ctypes.data for k in kept}) == 6

    def test_late_release_retires_slab_to_staging_pool(self):
        pool = hostmem.slab_pool()
        rot = OutputRotation(depth=2, reuse=True)
        held = []
        try:
            held.extend(rot.put(torch.full((4099,), 7.0)))
            held.extend(rot.drain())
        finally:
            rot.close()
        assert held
        before = pool.stats()["free_bytes"]
        for slab in held:
            slab.release()
        assert pool.stats()["free_bytes"] >= before + 4099 * 4

    def test_on_consumed_fires_before_emission(self):
        events = []
        rot = OutputRotation(depth=1)
        try:
            done = rot.put(torch.zeros(4),
                           on_consumed=lambda: events.append("consumed"))
            for slab in list(done) + list(rot.drain()):
                events.append("slab")
                slab.release()
        finally:
            rot.close()
        assert events == ["consumed", "slab"]

    def test_put_blocks_at_depth(self):
        gate = threading.Event()
        rot = OutputRotation(depth=2)
        returned = []
        try:
            rot.put(torch.zeros(2), event=_Event(gate))

            def second():
                returned.extend(rot.put(torch.ones(2), event=_Event(gate)))
                returned.append("returned")

            t = threading.Thread(target=second, daemon=True)
            t.start()
            time.sleep(0.3)
            assert returned == []  # two pending: put waits
            gate.set()
            t.join(timeout=5.0)
            assert not t.is_alive() and returned[-1] == "returned"
            list(rot.drain())
        finally:
            gate.set()
            rot.close()

    def test_readback_error_reraises_in_consumer(self):
        rot = OutputRotation(depth=1)
        try:
            with pytest.raises(RuntimeError, match="device fell over"):
                rot.put(torch.zeros(2), event=_Event(error=RuntimeError("device fell over")))
                list(rot.drain())
            # ... and again on every later call.
            with pytest.raises(RuntimeError, match="device fell over"):
                rot.put(torch.zeros(2))
        finally:
            rot.close()
        assert no_plane_threads()

    def test_readback_stall_watchdog(self):
        never = threading.Event()
        rot = OutputRotation(depth=1, stall_timeout_s=0.3,
                             name="blit-readback-wedged")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="stall"):
            rot.put(torch.zeros(2), event=_Event(never))
        assert time.monotonic() - t0 < 5.0
        t0 = time.monotonic()
        rot.close(join_timeout_s=0.2)  # the wedged thread is abandoned
        assert time.monotonic() - t0 < 5.0
        never.set()

    def test_close_is_idempotent_and_joins(self):
        rot = OutputRotation(depth=1)
        rot.put(torch.zeros(2))
        list(rot.drain())
        rot.close()
        rot.close()
        assert no_plane_threads()

    def test_narrow_dtypes_read_back_bytewise(self):
        rot = OutputRotation(depth=2, reuse=True)
        try:
            u16 = torch.tensor([0, 1, 40000, 65535], dtype=torch.int32).to(
                torch.int16).view(torch.uint16)
            got = rot.put(u16) + list(rot.drain())
            assert got[0].data.dtype == np.uint16
            np.testing.assert_array_equal(got[0].data, [0, 1, 40000, 65535])
            got[0].release()
        finally:
            rot.close()

    def test_extra_slots_rule(self):
        assert readback_extra_slots(2, 2) == 1
        assert readback_extra_slots(4, 2) == 3
        assert readback_extra_slots(2, 5) == 1


# -- AsyncSink --------------------------------------------------------------


class _ListWriter:
    def __init__(self):
        self.slabs, self.flushes = [], 0
        self.closed = self.aborted = False

    def append(self, slab):
        self.slabs.append(np.array(slab, copy=True))

    def flush(self):
        self.flushes += 1

    def close(self):
        self.closed = True

    def abort(self):
        self.aborted = True

    @property
    def nsamps(self):
        return sum(s.shape[0] for s in self.slabs)


class TestAsyncSink:
    def test_writes_in_order_and_finalizes(self):
        tl = Timeline()
        w = _ListWriter()
        sink = AsyncSink(w, depth=2, timeline=tl)
        for i in range(6):
            sink.append(np.full((2, 1, 4), float(i), np.float32))
        sink.close()
        assert w.closed and not w.aborted
        assert [float(s[0, 0, 0]) for s in w.slabs] == [float(i) for i in range(6)]
        assert tl.stages["write"].calls == 6
        assert tl.stages["write"].bytes == 6 * 2 * 4 * 4
        assert sink.nsamps == 12
        assert no_plane_threads()

    def test_flush_is_a_barrier(self):
        w = _ListWriter()
        sink = AsyncSink(w, depth=4)
        for _ in range(3):
            sink.append(np.zeros((1, 1, 4), np.float32))
        sink.flush()
        assert len(w.slabs) == 3 and w.flushes == 1
        sink.close()
        assert no_plane_threads()

    def test_release_fires_after_write(self):
        w = _ListWriter()
        released = []
        sink = AsyncSink(w, depth=2)
        sink.append(np.zeros((1, 1, 4), np.float32),
                    release=lambda: released.append(len(w.slabs)))
        sink.flush()
        assert released == [1]
        sink.close()

    def test_writer_error_reraises_and_refuses_to_finalize(self):
        class Broken(_ListWriter):
            def append(self, slab):
                raise OSError("disk full")

        released = []
        w = Broken()
        sink = AsyncSink(w, depth=1)
        with pytest.raises(OSError, match="disk full"):
            for _ in range(10):
                sink.append(np.zeros((1, 1, 4), np.float32),
                            release=lambda: released.append(1))
            sink.flush()
        with pytest.raises(OSError, match="disk full"):
            sink.close()
        assert not w.closed
        sink.abort()
        assert w.aborted and released  # skipped slabs were still released
        assert no_plane_threads()

    def test_writer_stall_watchdog(self):
        never = threading.Event()

        class Wedged(_ListWriter):
            def append(self, slab):
                never.wait(timeout=30.0)

        sink = AsyncSink(Wedged(), depth=1, stall_timeout_s=0.3,
                         name="blit-sink-wedged")
        sink.append(np.zeros((1, 1, 4), np.float32))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="stall"):
            for _ in range(10):
                sink.append(np.zeros((1, 1, 4), np.float32))
        assert time.monotonic() - t0 < 5.0
        t0 = time.monotonic()
        sink.abort(join_timeout_s=0.2)
        assert time.monotonic() - t0 < 5.0
        never.set()


# -- FoldInFlight -----------------------------------------------------------


class _FakeWin:
    def __init__(self, log, i):
        self.log, self.i = log, i

    def release(self):
        self.log.append(self.i)


class TestFoldInFlight:
    def test_lag_release_order(self):
        tl = Timeline()
        fl = FoldInFlight(tl, depth=1)
        log = []
        for i in range(4):
            fl.make_room()
            fl.admit(_FakeWin(log, i), None)
        assert log == [0, 1, 2]  # lag 1: the last window still admitted
        assert tl.stages["device"].calls == 3
        fl.drain()
        assert log == [0, 1, 2, 3]
        assert tl.stages["device"].calls == 4

    def test_waits_on_the_token_before_release(self):
        gate = threading.Event()
        fl = FoldInFlight(depth=1)
        log = []
        fl.admit(_FakeWin(log, 0), _Event(gate))
        t = threading.Thread(target=fl.make_room, daemon=True)
        t.start()
        time.sleep(0.2)
        assert log == []
        gate.set()
        t.join(timeout=5.0)
        assert not t.is_alive() and log == [0]


# -- BufferRotation ---------------------------------------------------------


class TestBufferRotation:
    def test_starvation_error_when_every_slot_is_held(self):
        def fill(rot):
            for i in range(10):
                slot = rot.acquire()
                if slot is None:
                    return
                rot.emit(slot, i)

        rot = BufferRotation(2, fill, name="blit-feed-starve")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="starved"):
            for _ in rot.slots():
                pass  # never released
        assert time.monotonic() - t0 < 10.0

    def test_producer_exception_reraises_in_consumer(self):
        def fill(rot):
            slot = rot.acquire()
            rot.emit(slot, 0)
            raise ValueError("bad block")

        rot = BufferRotation(2, fill)
        got = []
        with pytest.raises(ValueError, match="bad block"):
            for slot, payload in rot.slots():
                got.append(payload)
                rot.release(slot)
        assert got == [0]

    def test_watchdog_fires_within_its_bound(self):
        never = threading.Event()

        def fill(rot):
            rot.emit(rot.acquire(), 0)
            never.wait(timeout=1.5)  # a read wedged far past the timeout

        rot = BufferRotation(2, fill, name="blit-feed-wedged",
                             stall_timeout_s=0.3)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="stall"):
            for slot, _ in rot.slots():
                rot.release(slot)
        assert time.monotonic() - t0 < 5.0
        never.set()

    def test_release_from_another_thread(self):
        def fill(rot):
            for i in range(20):
                slot = rot.acquire()
                if slot is None:
                    return
                rot.emit(slot, i)

        rot = BufferRotation(2, fill)
        got = []
        for slot, payload in rot.slots():
            got.append(payload)
            t = threading.Thread(target=rot.release, args=(slot,))
            t.start()
            t.join(timeout=5.0)
        assert got == list(range(20))


# -- async against sync, inside the port -------------------------------------


def _synth(tmp_path, name="x.raw", **kw):
    p = str(tmp_path / name)
    kw.setdefault("nblocks", 3)
    kw.setdefault("obsnchan", 2)
    kw.setdefault("ntime_per_block", 1024)
    kw.setdefault("tone_chan", 1)
    synth_raw(p, **kw)
    return p


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


class TestAsyncSyncEquivalence:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("fqav_by", [1, 4])
    def test_fil_products_byte_identical(self, tmp_path, dtype, fqav_by):
        raw = _synth(tmp_path)
        kw = dict(nfft=64, nint=2, chunk_frames=4, dtype=dtype, fqav_by=fqav_by,
                  device=CPU)
        a, s = str(tmp_path / "a.fil"), str(tmp_path / "s.fil")
        ha = RawReducer(**kw).reduce_to_file(raw, a)
        hs = RawReducer(async_output=False, **kw).reduce_to_file(raw, s)
        assert ha == hs and ha["nsamps"] > 0
        assert _bytes(a) == _bytes(s)
        assert no_plane_threads()

    @pytest.mark.parametrize("depths", [(2, None), (3, 5)])
    def test_stream_slabs_identical_and_kept(self, tmp_path, depths):
        raw = _synth(tmp_path)
        prefetch, out_depth = depths
        kw = dict(nfft=64, nint=2, chunk_frames=4, device=CPU)
        a = list(RawReducer(prefetch_depth=prefetch, out_depth=out_depth,
                            **kw).stream(raw))
        s = list(RawReducer(async_output=False, **kw).stream(raw))
        assert len(a) == len(s) > 2
        for x, y in zip(a, s):  # every kept slab still holds its chunk
            np.testing.assert_array_equal(x, y)

    def test_skip_frames_replay_identical(self, tmp_path):
        raw = _synth(tmp_path)
        kw = dict(nfft=64, nint=2, chunk_frames=4, device=CPU)
        full = np.concatenate(list(RawReducer(**kw).stream(raw)))
        for skip in (2, 6):
            a = np.concatenate(list(RawReducer(**kw).stream(raw, skip_frames=skip)))
            s = np.concatenate(list(RawReducer(async_output=False, **kw).stream(
                raw, skip_frames=skip)))
            np.testing.assert_array_equal(a, s)
            tail = full[skip // 2:]
            assert a.shape == tail.shape
            np.testing.assert_allclose(a, tail, rtol=1e-5,
                                       atol=1e-5 * np.abs(tail).max())

    def test_env_switch_selects_the_sync_path(self, tmp_path, monkeypatch):
        raw = _synth(tmp_path)
        kw = dict(nfft=64, nint=2, chunk_frames=4, device=CPU)
        a = str(tmp_path / "a.fil")
        RawReducer(**kw).reduce_to_file(raw, a)
        monkeypatch.setenv("BLIT_SYNC_OUTPUT", "1")
        red = RawReducer(**kw)
        assert red.async_output is False
        assert DedopplerReducer(nfft=64, window_spectra=4, device=CPU).async_output is False
        s = str(tmp_path / "s.fil")
        red.reduce_to_file(raw, s)
        assert "readback" not in red.timeline.stages  # no readback thread ran
        assert _bytes(a) == _bytes(s)

    def test_stage_accounting_of_the_plane(self, tmp_path):
        raw = _synth(tmp_path)
        red = RawReducer(nfft=64, nint=2, chunk_frames=4, device=CPU)
        hdr = red.reduce_to_file(raw, str(tmp_path / "a.fil"))
        st = red.timeline.stages
        chunks = st["dispatch"].calls
        assert chunks == st["device"].calls == st["readback"].calls > 1
        assert st["write"].calls == chunks
        assert st["write"].bytes == st["readback"].bytes == hdr["nsamps"] * 128 * 4
        assert st["ingest"].bytes == red.stats.input_bytes > 0
        assert red.timeline.gauges["overlap.stream"].n == 1
        assert red.timeline.overlap_efficiency() > 0

    def test_staging_slots_reused_across_reducers(self, tmp_path):
        raw = _synth(tmp_path)
        pool = hostmem.slab_pool()
        kw = dict(nfft=64, nint=2, chunk_frames=4, device=CPU)
        RawReducer(**kw).reduce_to_file(raw, str(tmp_path / "one.fil"))
        reused = pool.stats()["reused"]
        RawReducer(**kw).reduce_to_file(raw, str(tmp_path / "two.fil"))
        assert pool.stats()["reused"] > reused

    def test_drain_sums_the_product(self, tmp_path):
        raw = _synth(tmp_path)
        kw = dict(nfft=64, nint=2, chunk_frames=4, device=CPU)
        _, data = RawReducer(**kw).reduce(raw)
        total = RawReducer(**kw).drain(raw)
        assert total == pytest.approx(float(data.sum(dtype=np.float64)), rel=1e-5)

    def test_writer_failure_aborts_the_product(self, tmp_path, monkeypatch):
        raw = _synth(tmp_path)
        from blit_torch.io import sigproc

        def broken(self, slab):
            raise OSError("disk full")

        monkeypatch.setattr(sigproc.FilWriter, "append", broken)
        out = str(tmp_path / "a.fil")
        with pytest.raises(OSError, match="disk full"):
            RawReducer(nfft=64, nint=2, chunk_frames=4, device=CPU).reduce_to_file(raw, out)
        assert not os.path.exists(out) and not os.path.exists(out + ".partial")
        assert no_plane_threads()

    def test_search_hits_identical_and_equal_to_blit(self, tmp_path):
        raw = _synth(tmp_path, nblocks=4, ntime_per_block=64 * 70)
        knobs = dict(nfft=64, window_spectra=16, top_k=4, snr_threshold=6.0)
        a, s, b = (str(tmp_path / f"{n}.hits") for n in "asb")
        red = DedopplerReducer(device=CPU, **knobs)
        ha = red.search_to_file(raw, a)
        hs = DedopplerReducer(device=CPU, async_output=False,
                              **knobs).search_to_file(raw, s)
        BlitDedoppler(kernel="reference", async_output=False,
                      **knobs).search_to_file(raw, b)
        assert ha == hs and ha["search_windows"] == 17
        assert _bytes(a) == _bytes(s)
        with open(a) as f, open(b) as g:
            assert f.readline() == g.readline()  # the header line
        obs = red.timeline.observations
        assert len(obs["search.tree_s"]) == 17
        assert red.timeline.stages["search.write"].calls == 17
        # The hits, against blit's on the same recording.
        _, hits = DedopplerReducer(device=CPU, **knobs).search(raw)
        _, bh = BlitDedoppler(kernel="reference", async_output=False,
                              **knobs).search(raw)
        assert [(h.window, h.drift_bins, h.chan, h.band) for h in hits] == [
            (h.window, h.drift_bins, h.chan, h.band) for h in bh]
        np.testing.assert_allclose([h.snr for h in hits], [h.snr for h in bh],
                                   rtol=1e-4)
        assert no_plane_threads()


# -- the antenna feeds and the array streams --------------------------------

NANT, NCHAN, NPOL = 4, 2, 2
NSAMP = 2048


@pytest.fixture(scope="module")
def ant_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ants")
    paths = []
    for a in range(NANT):
        p = str(d / f"a{a}.raw")
        synth_raw(p, nblocks=2, obsnchan=NCHAN, ntime_per_block=NSAMP // 2,
                  seed=50 + a, tone_chan=a % NCHAN)
        paths.append(p)
    return paths


def _weights(layout):
    rng = np.random.default_rng(5)
    w = TB.delay_weights_planar(rng.uniform(0, 1e-9, (3, NANT)),
                                np.linspace(1e9, 1.1e9, NCHAN), device=CPU)
    if layout == "chan":
        from blit_torch.ops.beamform import pack_weights

        w = pack_weights(*w)
    return w


class TestFeeds:
    @pytest.mark.parametrize("window", [256, 300])
    def test_antenna_windows_equal_at_every_depth(self, ant_files, window):
        ref = None
        for depth in (1, 2, 3):
            feed = TA.AntennaStream(ant_files, window_samples=window,
                                    prefetch_depth=depth, device=CPU)
            wins = [(w.index, w.start, w.ntime, w.arrays[0].clone(),
                     w.arrays[1].clone()) for w in feed]
            if ref is None:
                ref = wins
                assert len(ref) == feed.nwindows
                continue
            assert len(wins) == len(ref)
            for g, r in zip(wins, ref):
                assert g[:3] == r[:3]
                assert torch.equal(g[3], r[3]) and torch.equal(g[4], r[4])
        assert no_plane_threads()

    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_beamform_stream_through_the_plane_equals_one_shot(
            self, ant_files, layout, depth):
        w = _weights(layout)
        feed = TA.AntennaStream(ant_files, window_samples=512, layout=layout,
                                prefetch_depth=depth, device=CPU)
        slabs = list(TB.beamform_stream(feed, w, nint=8, layout=layout,
                                        timeline=feed.timeline, device=CPU))
        axis = 2 if layout == "antenna" else 3
        _, v = TA.load_antennas(ant_files, layout=layout, device=CPU)
        one = TB.beamform(v, w, nint=8, layout=layout, device=CPU)
        assert torch.equal(torch.cat(slabs, dim=axis), one)
        st = feed.timeline.stages
        assert st["dispatch"].calls == st["device"].calls == len(slabs) == 4
        acc = TB.beamform_accumulate(
            TA.AntennaStream(ant_files, window_samples=512, layout=layout,
                             prefetch_depth=depth, device=CPU),
            w, layout=layout, device=CPU)
        total = TB.beamform(v, w, nint=NSAMP, layout=layout, device=CPU)
        np.testing.assert_allclose(acc.numpy(), total.numpy(), rtol=1e-5, atol=1e-5)
        assert no_plane_threads()

    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_correlate_stream_at_every_depth(self, ant_files, depth):
        from blit_torch.ops.channelize import pfb_coeffs

        nfft, ntap, wf = 64, 4, 5
        h = torch.from_numpy(pfb_coeffs(ntap, nfft))
        feed = TA.CorrelatorStream(ant_files, nfft=nfft, ntap=ntap, window_frames=wf,
                                   prefetch_depth=depth, device=CPU)
        got = TC.correlate_stream(feed, h, nfft=nfft, ntap=ntap, device=CPU,
                                  timeline=feed.timeline)
        _, v = TA.load_correlator(ant_files, nfft=nfft, ntap=ntap, device=CPU)
        one = TC.correlate(v, h, nfft=nfft, ntap=ntap, acc_frames=wf, device=CPU)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
        st = feed.timeline.stages
        assert st["state"].calls == feed.nwindows - 1
        assert st["device"].calls == feed.nwindows
        assert no_plane_threads()

    def test_unreleased_windows_do_not_starve_the_feed(self, ant_files):
        feed = TA.AntennaStream(ant_files, window_samples=128, prefetch_depth=2,
                                device=CPU)
        held = list(feed)  # never released by the consumer
        assert len(held) == NSAMP // 128
        for w in held:
            w.release()  # idempotent after the feed's own release
        assert no_plane_threads()

    def test_feed_watchdog_trips_on_a_wedged_read(self, ant_files, monkeypatch):
        never = threading.Event()
        real = TA._Recordings.read

        def wedged(self, staged, offset, n):
            if offset > 0:
                never.wait(timeout=1.5)  # far past the timeout
            return real(self, staged, offset, n)

        monkeypatch.setattr(TA._Recordings, "read", wedged)
        feed = TA.AntennaStream(ant_files, window_samples=256, prefetch_depth=2,
                                stall_timeout_s=0.3, device=CPU)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="stall"):
            for w in feed:
                w.release()
        assert time.monotonic() - t0 < 5.0
        never.set()

    def test_producer_error_reraises_in_the_consumer(self, ant_files, monkeypatch):
        real = TA._Recordings.read

        def failing(self, staged, offset, n):
            if offset > 0:
                raise OSError("antenna 1 went away")
            return real(self, staged, offset, n)

        monkeypatch.setattr(TA._Recordings, "read", failing)
        feed = TA.AntennaStream(ant_files, window_samples=256, device=CPU)
        with pytest.raises(OSError, match="went away"):
            list(feed)
        assert no_plane_threads()

    def test_window_release_is_thread_safe(self):
        n = []
        win = TA.Window(0, 0, 1, None, (torch.zeros(1), torch.zeros(1)), None,
                        lambda: n.append(1))
        ts = [threading.Thread(target=win.release) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=5.0)
        assert n == [1]
