"""Multi-file ``.NNNN.raw`` scans and the native reader.

- ``synth_raw_sequence`` writes the same members as blit's.
- The port's :class:`GuppiScan` reads bitwise equal to blit's (whole
  blocks, windows inside blocks, complex blocks), and ``open_raw`` takes
  a member, a stem or a list as blit's does.
- A three-member scan reduces bitwise equal to one file holding the same
  blocks, with chunks that straddle member boundaries, through
  ``reduce_to_file``, ``reduce_resumable`` and the search.
- The native reader and the Python reader deliver identical bytes; the
  native one is taken by default where it builds, and ``native=True``
  raises where it cannot.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from blit import testing as btesting  # noqa: E402
from blit.io import guppi as bguppi  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.io import guppi as tguppi  # noqa: E402
from blit_torch.io import native  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402
from blit_torch.search import DedopplerReducer  # noqa: E402

SEQ = dict(nfiles=3, blocks_per_file=2, obsnchan=2, ntime_per_block=1000,
           overlap=24, seed=9, tone_chan=1)


def _native_or_skip():
    if native.guppi_lib() is None:
        pytest.skip(f"native reader unavailable: {native.build_error('guppi')}")


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    paths, stream = ttesting.synth_raw_sequence(str(d / "guppi_1_2_SRC_0001"), **SEQ)
    # One file with the same six blocks.
    raw = tguppi.open_raw(paths, native=False)
    blocks = [raw.read_block(i) for i in range(raw.nblocks)]
    single = str(d / "single.raw")
    tguppi.write_raw(single, raw.header(0), blocks)
    return paths, stream, single


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_sequence_files_identical_to_blit(scan, tmp_path):
    paths, stream, _ = scan
    bpaths, bstream = btesting.synth_raw_sequence(str(tmp_path / "b"), **SEQ)
    np.testing.assert_array_equal(stream, bstream)
    assert [_bytes(p) for p in paths] == [_bytes(p) for p in bpaths]


@pytest.mark.parametrize("native_flag", [False, True])
def test_scan_reads_equal_blit(scan, native_flag):
    if native_flag:
        _native_or_skip()
    paths, stream, _ = scan
    mine = tguppi.GuppiScan(paths, native=native_flag)
    ref = bguppi.GuppiScan(paths, native=False)
    assert mine.native is native_flag and mine.nblocks == ref.nblocks == 6
    assert [mine.block_ntime_kept(i) for i in range(6)] == [
        ref.block_ntime_kept(i) for i in range(6)]
    for i in range(6):
        assert mine.header(i) == ref.header(i)
        np.testing.assert_array_equal(mine.read_block(i), ref.read_block(i))
        dst = np.zeros((2, 400, 2, 2), np.int8)
        mine.read_block_into(i, dst, t0=300, ntime_keep=350)
        np.testing.assert_array_equal(dst[:, :350], ref.read_block(i)[:, 300:650])
    np.testing.assert_array_equal(mine.read_block_complex(5),
                                  ref.read_block_complex(5))
    kept = np.concatenate([b for _, b in mine.iter_blocks(drop_overlap=True)], axis=1)
    np.testing.assert_array_equal(kept, stream)
    assert mine.time_span_s() == ref.time_span_s()
    mine.close()


def test_open_raw_takes_member_stem_and_list(scan):
    paths, _, _ = scan
    stem = paths[0][:-len(".0000.raw")]
    assert tguppi.scan_files(stem) == bguppi.scan_files(stem) == paths
    assert tguppi.scan_files(paths[1]) == paths
    assert isinstance(tguppi.open_raw(stem), tguppi.GuppiScan)
    assert isinstance(tguppi.open_raw(paths), tguppi.GuppiScan)
    assert isinstance(tguppi.open_raw(paths[0]), tguppi.GuppiRaw)
    assert isinstance(tguppi.open_raw([paths[0]]), tguppi.GuppiRaw)
    with pytest.raises(FileNotFoundError):
        tguppi.open_raw(stem + "_missing")
    with pytest.raises(ValueError, match="duplicate"):
        tguppi.GuppiScan([paths[0], paths[0]], strict=True)
    with pytest.raises(ValueError, match="missing sequence"):
        tguppi.GuppiScan([paths[0], paths[2]], strict=True)


@pytest.mark.parametrize("async_output", [True, False])
def test_scan_reduces_bitwise_equal_to_one_file(scan, tmp_path, async_output):
    paths, _, single = scan
    # 5880 kept samples → 88 frames → 44 spectra.  Chunks of 6 frames
    # (384 samples) straddle both member boundaries (1976 and 3952).
    kw = dict(nfft=64, nint=2, chunk_frames=6, device="cpu",
              async_output=async_output)
    one, many = str(tmp_path / "one.fil"), str(tmp_path / "many.fil")
    h1 = RawReducer(**kw).reduce_to_file(single, one)
    h2 = RawReducer(**kw).reduce_to_file(paths, many)
    assert h1 == h2 and h1["nsamps"] == 44
    assert _bytes(one) == _bytes(many)
    stem = str(tmp_path / "stem.fil")
    RawReducer(**kw).reduce_to_file(paths[0][:-len(".0000.raw")], stem)
    assert _bytes(stem) == _bytes(one)


def test_scan_resumes_across_a_member_boundary(scan, tmp_path):
    from blit_torch import faults

    paths, _, single = scan
    kw = dict(nfft=64, nint=2, chunk_frames=6, device="cpu",
              output_stall_timeout_s=30.0)
    ref = str(tmp_path / "ref.fil")
    RawReducer(**kw).reduce_to_file(single, ref)
    out = str(tmp_path / "x.fil")
    faults.install(faults.FaultRule("sink.write", after=5, times=-1))
    try:
        with pytest.raises(faults.InjectedFault):
            RawReducer(**kw).reduce_resumable(paths, out)
    finally:
        faults.clear()
    from blit_torch.pipeline import ReductionCursor

    cur = ReductionCursor.load(out)
    # 30 frames claimed: the restart's first chunk (samples 1920-2304)
    # straddles the first member boundary at 1976.
    assert cur.frames_done == 30 and cur.raw_path == paths
    RawReducer(**kw).reduce_resumable(paths[0][:-len(".0000.raw")], out)
    assert _bytes(out) == _bytes(ref)


def test_scan_search_equals_one_file(scan, tmp_path):
    paths, _, single = scan
    kw = dict(nfft=64, window_spectra=8, top_k=4, snr_threshold=3.0,
              chunk_frames=8, device="cpu")
    a, b = str(tmp_path / "a.hits"), str(tmp_path / "b.hits")
    ha = DedopplerReducer(**kw).search_to_file(single, a)
    hb = DedopplerReducer(**kw).search_to_file(paths, b)
    assert ha == hb and ha["search_windows"] == 11
    assert _bytes(a) == _bytes(b)


def test_native_and_python_readers_deliver_identical_bytes(scan, tmp_path):
    _native_or_skip()
    paths, _, single = scan
    nat, py = tguppi.GuppiRaw(single), tguppi.GuppiRaw(single, native=False)
    assert nat.native is True and py.native is False
    for i in range(nat.nblocks):
        np.testing.assert_array_equal(nat.read_block(i), py.read_block(i))
        a = np.zeros((2, 1000, 2, 2), np.int8)
        b = np.ones((2, 1000, 2, 2), np.int8)
        nat.read_block_into(i, a[:, 13:], t0=7, ntime_keep=900)
        py.read_block_into(i, b[:, 13:], t0=7, ntime_keep=900)
        np.testing.assert_array_equal(a[:, 13:913], b[:, 13:913])
    kw = dict(nfft=64, nint=2, chunk_frames=6, device="cpu")
    one, two = str(tmp_path / "nat.fil"), str(tmp_path / "py.fil")
    RawReducer(**kw).reduce_to_file(nat, one)
    RawReducer(**kw).reduce_to_file(py, two)
    assert _bytes(one) == _bytes(two)


def test_native_true_raises_when_the_reader_cannot_build(scan, monkeypatch):
    _, _, single = scan
    monkeypatch.setitem(native._LOADED, "guppi", None)
    monkeypatch.setitem(native._ERRORS, "guppi", "g++ not found")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tguppi.GuppiRaw(single, native=True)
    assert tguppi.GuppiRaw(single).native is False


def test_native_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    if native.shutil.which("g++") is None:
        pytest.skip("g++ not found")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LOADED", {})
    p = native._build("guppi")
    assert os.path.dirname(p) == str(tmp_path / "build")
    assert os.path.basename(p).startswith("libblit_torch_guppi-")
    assert native._build("guppi") == p  # cached: same source and flags
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")]
    assert native.load("guppi") is not None
