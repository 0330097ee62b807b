"""The live feed's direct path: recycled RAM blocks page-locked once
(``blit_torch.hostmem.BlockRegistry``) and read by the card in place
through chunk plans (``blit_torch.pipeline.ChunkPlan``).

On the CPU: the registry against a fake registrar; the producer's plans,
applied with numpy, byte for byte against the pinned-slot chunks the
producer fills without a registry; a forced plan stream end to end
against the slot stream, from a ring that refills a buffer as soon as
its chunk is released.  Tests marked ``cuda`` run the real path on the
card: ``python -m pytest tests/test_torch_direct_ingest.py -m cuda``.
"""

import gc
import logging
import queue
import signal
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from blit_torch import hostmem
from blit_torch.io.sigproc import read_fil
from blit_torch.observability import Timeline
from blit_torch.pipeline import RawReducer
from blit_torch.stream import stream_reduce
from blit_torch.stream.plane import LiveRawStream
from blit_torch.stream.source import ChunkSource, QueueSource, StreamChunk
from blit_torch.testing import make_raw_header, make_voltages

NFFT, NTAP, NINT, FRAMES, NCHAN = 16, 4, 2, 4, 3
CHUNK = (FRAMES + NTAP - 1) * NFFT
STATE = (NTAP - 1) * NFFT
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


class FakeRegistrar:
    """Records the page-locking calls; ``pinned`` addresses read as
    already locked, ``fail`` makes every registration fail."""

    def __init__(self, pinned=(), fail=False):
        self.pinned = set(pinned)
        self.fail = fail
        self.calls = []

    def is_pinned(self, ptr, nbytes):
        return ptr in self.pinned

    def register(self, ptr, nbytes):
        self.calls.append(("register", ptr, nbytes))
        return 1 if self.fail else 0

    def unregister(self, ptr):
        self.calls.append(("unregister", ptr))


def _block(ntime, seed=0, nchan=NCHAN):
    return make_voltages(nchan, ntime, seed=seed)


# -- the registry -----------------------------------------------------------

def test_a_block_registers_on_its_second_sighting_not_its_first():
    fake, tl = FakeRegistrar(), Timeline()
    reg = hostmem.BlockRegistry(fake)
    blk = _block(50)
    assert reg.sight(blk, tl) is False
    assert fake.calls == [] and "ingest.register" not in tl.stages
    assert reg.sight(blk, tl) is True
    assert fake.calls == [("register", blk.ctypes.data, blk.nbytes)]
    assert reg.sight(blk, tl) is True
    assert len(fake.calls) == 1
    assert tl.stages["ingest.register"].calls == 1
    assert reg.stats()["registered"] == 1


def test_a_source_of_fresh_arrays_never_registers():
    fake, tl = FakeRegistrar(), Timeline()
    reg = hostmem.BlockRegistry(fake)
    for k in range(20):
        blk = _block(40, seed=k)
        assert reg.sight(blk, tl) is False
        del blk
    assert fake.calls == []
    assert reg.stats()["blocks"] == 0
    assert "ingest.register" not in tl.stages


def test_the_finalizer_unregisters_a_block_when_its_last_array_dies():
    fake = FakeRegistrar()
    reg = hostmem.BlockRegistry(fake)
    blk = _block(30)
    view = blk[:]  # a second array over the same bytes
    ptr = blk.ctypes.data
    reg.sight(blk)
    assert reg.sight(view) is True
    del blk
    gc.collect()
    assert ("unregister", ptr) not in fake.calls  # the view still lives
    del view
    gc.collect()
    assert fake.calls[-1] == ("unregister", ptr)
    assert reg.stats() == {"blocks": 0, "registered": 1, "pinned": 0,
                           "failed": 0, "unregistered": 1}


def test_an_already_page_locked_buffer_counts_as_registered_without_a_call():
    blk = _block(30)
    fake = FakeRegistrar(pinned=[blk.ctypes.data])
    reg = hostmem.BlockRegistry(fake)
    assert reg.sight(blk) is False
    assert reg.sight(blk) is True
    del blk
    gc.collect()
    assert fake.calls == []  # neither locked nor unlocked by the registry
    assert reg.stats()["pinned"] == 1


def test_a_failed_registration_stays_on_the_copy_path_counted_and_logged_once(
        caplog):
    fake, tl = FakeRegistrar(fail=True), Timeline()
    reg = hostmem.BlockRegistry(fake)
    a, b = _block(30, seed=1), _block(30, seed=2)
    with caplog.at_level(logging.WARNING, logger="blit_torch.hostmem"):
        for _ in range(3):
            assert reg.sight(a, tl) is False
            assert reg.sight(b, tl) is False
    assert [c[0] for c in fake.calls] == ["register", "register"]
    assert reg.failed == 2 and tl.stages["ingest.register_failed"].calls == 2
    assert len([r for r in caplog.records if "page-locking" in r.message]) == 1
    # The failed blocks' segments are copied into the slot: no direct bytes.
    specs = [0, 1, 0, 1, 0, 1]
    pool = [a, b]
    got, tl2 = _plan_chunks(specs, pool, 0, reg)
    assert got == _slot_chunks(specs, pool, 0)[0]
    assert "ingest.direct" not in tl2.stages
    assert tl2.stages["ingest"].bytes > 0


def test_the_registry_is_one_per_process():
    assert hostmem.host_blocks() is hostmem.host_blocks()


# -- the segment planner ----------------------------------------------------

def _reducer():
    return RawReducer(nfft=NFFT, ntap=NTAP, nint=NINT, chunk_frames=FRAMES,
                      prefetch_depth=2, out_depth=2, device="cpu",
                      timeline=Timeline(), tune_online=False)


class _Rotation:
    """The producer's side of a BufferRotation, inline: free slots in a
    FIFO; each emitted chunk is captured at once and its slot freed."""

    def __init__(self, nslots, capture):
        self.free = deque(range(nslots))
        self.capture = capture

    def acquire(self):
        return self.free.popleft()

    def emit(self, slot, payload):
        self.capture(slot, payload)
        self.free.append(slot)


def _items(specs, pool, overlap=0):
    """The live feed's items for ``specs``: a pool index (a recycled
    block), ``("fresh", ntime)`` or ``"masked"`` (a seat of the pool's
    first length); every block but the last drops its ``overlap``."""
    live = LiveRawStream(QueueSource())
    for i, spec in enumerate(specs):
        if spec == "masked":
            nt, data = pool[0].shape[1], None
        elif isinstance(spec, tuple):
            nt, data = spec[1], _block(spec[1], seed=100 + i)
        else:
            nt, data = pool[spec].shape[1], pool[spec]
        hdr = make_raw_header(obsnchan=NCHAN, overlap=overlap)
        hdr["BLOCSIZE"] = NCHAN * nt * 4
        c = StreamChunk(i, hdr, data, t_arrival=0.0, masked=data is None)
        yield from live._feed_one(c, last=i == len(specs) - 1)


def _slot_chunks(specs, pool, skip, overlap=0):
    """What the producer writes into its pinned slots (no registry)."""
    red, out = _reducer(), []
    bufs = [None] * 3

    def capture(j, payload):
        frames, samps, plan = payload
        assert plan is None
        out.append((frames, samps, bufs[j].array[:, :samps].tobytes()))

    red._fill_rotation(_items(specs, pool, overlap), skip, bufs,
                       _Rotation(3, capture))
    return out, red.timeline


def _plan_chunks(specs, pool, skip, registry, overlap=0):
    """The producer's plans, applied with numpy into fresh chunks (bytes
    never written read 0x5a), the overlap from the previous chunk."""
    red, out, tail = _reducer(), [], [None]
    bufs = [None] * 3

    def capture(j, payload):
        frames, samps, plan = payload
        assert plan.shape == (NCHAN, CHUNK, 2, 2)
        v = np.full(plan.shape, 0x5A, np.int8)
        if plan.overlap:
            v[:, :STATE] = tail[0]
        for src, t0, take, dst in plan.segments:
            v[:, dst:dst + take] = 0 if src is None else src[:, t0:t0 + take]
        tail[0] = v[:, CHUNK - STATE:].copy()
        out.append((frames, samps, v[:, :samps].tobytes()))
        plan.release()

    red._fill_rotation(_items(specs, pool, overlap), skip, bufs,
                       _Rotation(3, capture), registry)
    return out, red.timeline


LENGTHS = (37, 90, 61)
CASES = {
    # id: (pool lengths, feed, skip_frames, OVERLAP)
    "random_lengths": (LENGTHS, [0, 1, 2, 0, 1, 2, 0, 1, 2, 0], 0, 0),
    "overlap": ((80, 72), [0, 1, 0, 1, 0, 1, 0], 0, 16),
    "masked": (LENGTHS, [0, 1, "masked", 0, 1, "masked", 2, 0, 1, 2], 0, 0),
    "skip_frames": (LENGTHS, [0, 1, 2, 0, 1, 2, 0, 1, 2], 5, 0),
    "skip_past_a_block": (LENGTHS, [0, 1, 2, 0, 1, 2, 0, 1, 2], 4, 8),
    "straddles_chunks": ((300, 45), [0, 1, 0, 1, 0], 0, 0),
    "short_flush": ((CHUNK, 40), [0, 0, 1, 0, 1], 0, 0),
    "a_ring_of_one_block": ((30,), [0] * 9, 0, 0),
    "fresh_and_recycled": (LENGTHS, [0, ("fresh", 55), 1, 0, ("fresh", 70),
                                     1, 2, 0, 2], 0, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_write_the_bytes_the_pinned_slots_hold(case):
    lengths, specs, skip, overlap = CASES[case]
    pool = [_block(n, seed=k) for k, n in enumerate(lengths)]
    want, slot_tl = _slot_chunks(specs, pool, skip, overlap)
    reg = hostmem.BlockRegistry(FakeRegistrar())
    got, tl = _plan_chunks(specs, pool, skip, reg, overlap)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g[2] == w[2], f"chunk {k} differs"
    assert len(want) >= 2
    if case == "short_flush":
        assert want[-1][1] < CHUNK
    st = tl.stages
    # Recycled blocks go in place from their second sighting on; the
    # first sightings (and fresh arrays) are read on the host as before,
    # and the two stages share the slot path's input bytes.
    assert st["ingest.direct"].bytes > 0 and st["ingest"].bytes > 0
    assert (st["ingest.direct"].bytes + st["ingest"].bytes
            == slot_tl.stages["ingest"].bytes)


def test_fresh_arrays_only_are_copied_as_before():
    specs = [("fresh", 50 + k) for k in range(8)]
    reg = hostmem.BlockRegistry(FakeRegistrar())
    got, tl = _plan_chunks(specs, [_block(10)], 0, reg)
    want, slot_tl = _slot_chunks(specs, [_block(10)], 0)
    assert got == want
    assert "ingest.direct" not in tl.stages
    assert tl.stages["ingest"].bytes == slot_tl.stages["ingest"].bytes
    assert reg.registrar.calls == []


def test_every_feed_on_a_cuda_device_is_planned(monkeypatch):
    seen = []

    def record(self, feed, skip, bufs, rot, blocks=None):
        seen.append(blocks)

    monkeypatch.setattr(RawReducer, "_fill_rotation", record)

    class Live:
        def feed_blocks(self):
            return iter(())

    class File:
        nblocks = 0

    red = _reducer()
    for raw in (Live(), File()):
        assert list(red._chunks(raw)) == []
    red.device = torch.device("cuda")
    for raw in (Live(), File()):
        assert list(red._chunks(raw)) == []
    assert seen == [None, None, hostmem.host_blocks(), hostmem.host_blocks()]


# -- end to end -------------------------------------------------------------

def _ring(pool, nblocks, header, missing=()):
    """A QueueSource fed from a recycled pool (block i is pool[i % n]),
    every seq in ``missing`` left out (the watermark masks it)."""
    src = QueueSource("<ring>")
    for i in range(nblocks):
        if i not in missing:
            src.push(StreamChunk(i, dict(header), pool[i % len(pool)]))
    src.finish(nblocks)
    return src


class RefillRing(ChunkSource):
    """A recorder's RAM ring: ``len(bufs)`` buffers, each block of
    ``blocks`` written into a free one as it is delivered; a buffer is
    free again once its chunk is released.  A seq in ``missing`` is never
    delivered (the watermark masks it)."""

    def __init__(self, bufs, blocks, header, missing=()):
        self.path = "<refill-ring>"
        self.finished = False
        self.total = None
        self.bufs = bufs
        self._free = queue.Queue()
        for b in bufs:
            self._free.put(b)
        self._blocks = blocks
        self._header = header
        self._missing = set(missing)
        self._next = 0
        self.delivered = 0
        self.released = 0
        self._lock = threading.Lock()

    def _refill(self, chunk):
        with self._lock:
            self.released += 1
        self._free.put(chunk.data)

    def get(self, timeout):
        while self._next in self._missing:
            self._next += 1
        if self._next >= len(self._blocks):
            self.finished = True
            self.total = len(self._blocks)
            return None
        try:
            buf = self._free.get(timeout=timeout)
        except queue.Empty:
            return None
        buf[...] = self._blocks[self._next]  # the recorder writes the block
        c = StreamChunk(self._next, dict(self._header), buf,
                        on_release=self._refill)
        self._next += 1
        self.delivered += 1
        return c


def test_the_assembler_releases_what_it_drops_and_what_it_fed():
    nt = 2 * NFFT
    hdr = make_raw_header(obsnchan=NCHAN)
    hdr["BLOCSIZE"] = NCHAN * nt * 4
    released = []

    def chunk(seq):
        return StreamChunk(seq, dict(hdr), _block(nt, seed=seq),
                           on_release=lambda c: released.append(c.seq))

    src = QueueSource()
    for seq in (0, 1, 1, 3, 4):  # a second delivery of 1; 2 comes late
        src.push(chunk(seq))

    def late():
        time.sleep(0.3)
        src.push(chunk(2))
        src.finish(5)

    pusher = threading.Thread(target=late)
    pusher.start()
    live = LiveRawStream(src, lateness_s=0.05)
    fed = []
    for item in live.feed_blocks():
        fed.append(None if item[3] is None else item[3].seq)
        assert item[3] is None or item[3].seq not in released
    pusher.join()
    assert fed == [0, 1, None, 3, 4]  # seat 2 masked
    assert (live.dup_chunks, live.late_chunks) == (1, 1)
    assert sorted(released) == [0, 1, 1, 2, 3, 4]


def _stream_to(path, red, src):
    stream_reduce(src, str(path), reducer=red, lateness_s=0.05)
    with open(path, "rb") as f:
        return f.read()


def _planned_on_the_cpu(monkeypatch, reg):
    """Force plans on the CPU, their rows copied with numpy at dispatch,
    when the card would read them."""
    fill = RawReducer._fill_rotation

    def planned(self, feed, skip, bufs, rot, blocks=None):
        return fill(self, feed, skip, bufs, rot, reg)

    def copy_rows(dst, dst_t, src, src_t, n):
        s = src if isinstance(src, np.ndarray) else src.numpy()
        dst.numpy()[:, dst_t:dst_t + n] = s[:, src_t:src_t + n]

    def zero_rows(dst, dst_t, n):
        dst.numpy()[:, dst_t:dst_t + n] = 0

    monkeypatch.setattr(RawReducer, "_fill_rotation", planned)
    monkeypatch.setattr(hostmem, "copy_rows", copy_rows)
    monkeypatch.setattr(hostmem, "zero_rows", zero_rows)


def test_a_planned_stream_equals_the_slot_stream_on_the_cpu(tmp_path,
                                                             monkeypatch):
    nt = 3 * NFFT + 5
    pool = [_block(nt, seed=k) for k in range(3)]
    hdr = make_raw_header(obsnchan=NCHAN)
    hdr["BLOCSIZE"] = NCHAN * nt * 4
    want = _stream_to(tmp_path / "slot.fil", _reducer(),
                      _ring(pool, 14, hdr, missing=[6]))
    reg = hostmem.BlockRegistry(FakeRegistrar())
    _planned_on_the_cpu(monkeypatch, reg)
    warm = _reducer()
    assert _stream_to(tmp_path / "warm.fil", warm,
                      _ring(pool, 14, hdr, missing=[6])) == want
    red = _reducer()
    assert _stream_to(tmp_path / "plan.fil", red,
                      _ring(pool, 14, hdr, missing=[6])) == want
    st = red.timeline.stages
    masked = NCHAN * nt * 4
    assert st["ingest"].bytes == masked  # the masked seat's zeros alone
    assert st["ingest.direct"].bytes == 13 * masked
    assert red.stats.input_bytes == 14 * masked
    assert "ingest.register" not in st  # the warm-up registered the pool
    assert reg.stats()["registered"] == 3


@pytest.mark.parametrize("nbuf", [4, 6])
def test_a_refilling_ring_is_read_before_its_buffers_are_refilled(
        tmp_path, monkeypatch, nbuf):
    nt = 3 * NFFT + 5
    blocks = [_block(nt, seed=10 + k) for k in range(24)]
    hdr = make_raw_header(obsnchan=NCHAN)
    hdr["BLOCSIZE"] = NCHAN * nt * 4
    fresh = QueueSource("<fresh>")
    for k, b in enumerate(blocks):
        if k != 9:
            fresh.push(StreamChunk(k, dict(hdr), b.copy()))
    fresh.finish(len(blocks))
    want = _stream_to(tmp_path / "slot.fil", _reducer(), fresh)
    reg = hostmem.BlockRegistry(FakeRegistrar())
    _planned_on_the_cpu(monkeypatch, reg)
    ring = RefillRing([np.empty_like(blocks[0]) for _ in range(nbuf)],
                      blocks, hdr, missing=[9])
    red = _reducer()
    assert _stream_to(tmp_path / "ring.fil", red, ring) == want
    st, blk = red.timeline.stages, NCHAN * nt * 4
    # Each buffer's first block is read on the host, and the masked seat.
    assert st["ingest.direct"].bytes == (len(blocks) - 1 - nbuf) * blk
    assert st["ingest"].bytes == (nbuf + 1) * blk
    assert reg.stats()["registered"] == nbuf
    assert ring.released == ring.delivered == len(blocks) - 1


def test_a_stream_left_early_releases_every_chunk(monkeypatch):
    nt = 3 * NFFT + 5
    blocks = [_block(nt, seed=k) for k in range(40)]
    hdr = make_raw_header(obsnchan=NCHAN)
    hdr["BLOCSIZE"] = NCHAN * nt * 4
    reg = hostmem.BlockRegistry(FakeRegistrar())
    _planned_on_the_cpu(monkeypatch, reg)
    ring = RefillRing([np.empty_like(blocks[0]) for _ in range(8)],
                      blocks, hdr)
    red = _reducer()
    slabs = red._stream(LiveRawStream(ring, lateness_s=0.05))
    next(slabs)
    next(slabs)
    slabs.close()
    assert 0 < ring.delivered < len(blocks)
    assert ring.released == ring.delivered


# -- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the direct path runs only there)")
    return torch.device("cuda")


def _page_block(nchan, ntime, seed):
    """A block on pages of its own (no other allocation shares them)."""
    blk = hostmem.aligned_empty((nchan, ntime, 2, 2), np.int8)
    blk[...] = make_voltages(nchan, ntime, seed=seed)
    return blk


@pytest.mark.cuda
def test_rows_copy_in_place_from_a_registered_block(dev):
    reg = hostmem.BlockRegistry()
    blk = _page_block(4, 4096, seed=3)
    assert reg.sight(blk) is False and reg.sight(blk) is True
    assert reg.stats()["registered"] == 1
    v = torch.full((4, 3000, 2, 2), 7, dtype=torch.int8, device=dev)
    hostmem.copy_rows(v, 100, blk, 1000, 2500)
    hostmem.zero_rows(v, 2600, 300)
    tail = torch.empty((4, 200, 2, 2), dtype=torch.int8, device=dev)
    hostmem.copy_rows(tail, 0, v, 2800, 200)
    torch.cuda.synchronize()
    want = np.full((4, 3000, 2, 2), 7, np.int8)
    want[:, 100:2600] = blk[:, 1000:3500]
    want[:, 2600:2900] = 0
    np.testing.assert_array_equal(v.cpu().numpy(), want)
    np.testing.assert_array_equal(tail.cpu().numpy(), want[:, 2800:])
    pinned = torch.empty(4096, dtype=torch.int8, pin_memory=True).numpy()
    assert reg.sight(pinned) is False and reg.sight(pinned) is True
    assert reg.stats()["pinned"] == 1
    del blk
    gc.collect()
    assert reg.stats()["unregistered"] == 1


class _NeverRegistry(hostmem.BlockRegistry):
    """The registry forced empty: every segment is copied."""

    def sight(self, block, timeline=None):
        return False


@pytest.mark.cuda
def test_direct_stream_is_byte_identical_to_the_copy_path(dev, tmp_path,
                                                          monkeypatch):
    nchan, nt = 4, 4096
    blocks = [make_voltages(nchan, nt, seed=k) for k in range(16)]
    hdr = make_raw_header(obsnchan=nchan)
    hdr["BLOCSIZE"] = nchan * nt * 4

    def red():
        return RawReducer(nfft=1024, nint=2, chunk_frames=4, prefetch_depth=2,
                          out_depth=2, device="cuda", timeline=Timeline(),
                          tune_online=False)

    def ring(missing=()):
        return RefillRing(bufs, blocks, hdr, missing=missing)

    bufs = [_page_block(nchan, nt, seed=0) for _ in range(5)]
    _stream_to(tmp_path / "warm.fil", red(), ring())
    direct, src = red(), ring(missing=[5])
    got = _stream_to(tmp_path / "direct.fil", direct, src)
    assert src.released == src.delivered == len(blocks) - 1
    st = direct.timeline.stages
    assert st["ingest"].bytes == nchan * nt * 4  # the masked seat alone
    assert st["ingest.direct"].bytes == (len(blocks) - 1) * nchan * nt * 4
    monkeypatch.setattr(hostmem, "host_blocks", lambda: _NeverRegistry())
    copied = red()
    want = _stream_to(tmp_path / "copied.fil", copied, ring(missing=[5]))
    assert "ingest.direct" not in copied.timeline.stages
    assert got == want
    _, data = read_fil(str(tmp_path / "direct.fil"))
    assert data.shape[0] > 0 and np.isfinite(data).all()
