"""The port's ``.h5`` products and bitshuffle codec held against blit's.

One seeded recording (2 coarse channels, nfft 64, nint 4, chunk_frames 8
so the last chunk is a short tail) is reduced by both packages to FBH5
with no compression and with gzip: the file and dataset attributes, the
dataset's shape, dtype, chunks and filter must be identical, the data
within the f32 bound of tests/test_torch_pipeline.py (rtol 1e-4, atol
1e-2 of the product's peak; the recording holds noise only, so the peak
is a noise bin).  Bitshuffle runs through the port's own codec: blit's
is not built here.  Its tests skip only when g++ or liblz4.so.1 is
missing, and say which.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from blit.io import bshuf as bbshuf  # noqa: E402
from blit.io import fbh5 as bfbh5  # noqa: E402
from blit.pipeline import RawReducer as BlitReducer  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.io import bshuf, fbh5  # noqa: E402
from blit_torch.io.sigproc import read_fil  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402

NFFT, NINT, CHUNK = 64, 4, 8


def _red(**kw):
    return RawReducer(nfft=NFFT, nint=NINT, chunk_frames=CHUNK, device="cpu", **kw)


def _blit_red(**kw):
    return BlitReducer(nfft=NFFT, nint=NINT, chunk_frames=CHUNK,
                       async_output=False, **kw)


def _codec():
    """Skip, naming what is missing, when the port's codec cannot build."""
    if not bshuf.available():
        pytest.skip(f"bitshuffle codec unavailable (g++ or liblz4.so.1 "
                    f"missing): {bshuf.unavailable_reason()}")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("raw") / "x.raw")
    # 6 blocks of 512 samples sharing 16: 2992 samples → 43 frames → 10
    # spectra of nint 4, in chunks of 8 frames and a short tail.
    ttesting.synth_raw(p, nblocks=6, obsnchan=2, ntime_per_block=512,
                       overlap=16, seed=3)
    return p


@pytest.fixture(scope="module")
def fil(raw, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fil") / "p.fil")
    _red().reduce_to_file(raw, out)
    return read_fil(out)[1]


def _attrs(obj):
    return {k: (type(v).__name__, getattr(v, "dtype", None), np.asarray(v).tolist())
            for k, v in obj.attrs.items()}


@pytest.mark.parametrize("compression", [None, "gzip"])
def test_h5_layout_identical_to_blit(raw, tmp_path, compression):
    b, p = str(tmp_path / "b.h5"), str(tmp_path / "p.h5")
    bh = _blit_red().reduce_to_file(raw, b, compression=compression)
    ph = _red().reduce_to_file(raw, p, compression=compression)
    assert ph == bh
    with h5py.File(b, "r") as fb, h5py.File(p, "r") as fp:
        assert _attrs(fp) == _attrs(fb)
        db, dp = fb["data"], fp["data"]
        assert _attrs(dp) == _attrs(db)
        assert (dp.shape, dp.dtype, dp.chunks, dp.maxshape) == (
            db.shape, db.dtype, db.chunks, db.maxshape) == (
            (10, 1, 2 * NFFT), np.float32, (16, 1, 2 * NFFT), (None, 1, 2 * NFFT))
        assert (dp.compression, dp.compression_opts) == (
            db.compression, db.compression_opts)
        want = db[()]
        np.testing.assert_allclose(dp[()], want, rtol=1e-4,
                                   atol=1e-2 * np.abs(want).max())
    assert fbh5.read_fbh5_header(p).keys() == bfbh5.read_fbh5_header(b).keys()
    assert not os.path.exists(p + ".partial")


@pytest.mark.parametrize("compression", [None, "gzip", "bitshuffle"])
def test_h5_payload_equals_fil(raw, fil, tmp_path, compression):
    if compression == "bitshuffle":
        _codec()
    p = str(tmp_path / "p.h5")
    hdr = _red().reduce_to_file(raw, p, compression=compression)
    assert hdr["nsamps"] == 10
    np.testing.assert_array_equal(fbh5.read_fbh5_data(p), fil)
    np.testing.assert_array_equal(
        fbh5.read_fbh5_data(p, (slice(3, 9), slice(None), slice(5, 70))),
        fil[3:9, :, 5:70])


@pytest.mark.parametrize("suffix", [".out", ""])
def test_other_suffix_writes_fil_as_blit(raw, tmp_path, suffix):
    # blit writes .fil for any path but .h5 / .hdf5.  The quantized
    # product's bytes agree across the packages; the f32 product's
    # header bytes agree and its data to the f32 bound (the two
    # channelizers differ by float rounding, ~1e-7 of the peak).
    kw = dict(nbits=8, quant_scale=4.0)
    b, p = str(tmp_path / f"b{suffix}"), str(tmp_path / f"p{suffix}")
    _blit_red(**kw).reduce_to_file(raw, b)
    _red(**kw).reduce_to_file(raw, p)
    with open(b, "rb") as fb, open(p, "rb") as fp:
        want = fb.read()
        assert fp.read() == want and len(want) > 0
    b32, p32 = str(tmp_path / f"b32{suffix}"), str(tmp_path / f"p32{suffix}")
    _blit_red().reduce_to_file(raw, b32)
    _red().reduce_to_file(raw, p32)
    (hb, db), (hp, dp) = read_fil(b32), read_fil(p32)
    assert hp == hb and os.path.getsize(p32) == os.path.getsize(b32)
    np.testing.assert_allclose(dp, db, rtol=1e-4, atol=1e-2 * np.abs(db).max())
    _red().reduce_to_file(raw, str(tmp_path / "p.fil"))
    with open(p32, "rb") as f1, open(tmp_path / "p.fil", "rb") as f2:
        assert f1.read() == f2.read()


def test_output_knob_refusals_match_blit(raw, tmp_path):
    cases = [
        (dict(nbits=8), "x.h5", {}, "nbits=8/16"),
        ({}, "x.fil", dict(compression="gzip"), "compression"),
        ({}, "x.fil", dict(chunks=(2, 1, 128)), "chunks"),
        ({}, "x.h5", dict(compression="zstd"), "unknown compression"),
    ]
    for red_kw, name, kw, msg in cases:
        for make in (_red, _blit_red):
            with pytest.raises(ValueError, match=msg):
                make(**red_kw).reduce_to_file(raw, str(tmp_path / name), **kw)
            with pytest.raises(ValueError, match=msg):
                make(**red_kw).reduce_resumable(raw, str(tmp_path / name), **kw)


def test_bitshuffle_refused_without_codec(raw, tmp_path, monkeypatch):
    from blit_torch.io import native

    monkeypatch.setitem(native._LOADED, "bitshuffle", None)
    monkeypatch.setitem(native._ERRORS, "bitshuffle", "liblz4.so.1 not found")
    assert not bshuf.available()
    with pytest.raises(RuntimeError, match="bitshuffle codec unavailable"):
        _red().reduce_to_file(raw, str(tmp_path / "x.h5"), compression="bitshuffle")
    assert not os.path.exists(tmp_path / "x.h5.partial")


@pytest.mark.parametrize("dtype,n", [(np.float32, 64), (np.float32, 1000),
                                     (np.uint8, 8), (np.uint16, 136),
                                     (np.float64, 24)])
def test_bitshuffle_matches_blit_numpy_model(dtype, n):
    _codec()
    a = (np.random.default_rng(n).standard_normal(n) * 1000).astype(dtype)
    want = bbshuf.bitshuffle_np(a)
    np.testing.assert_array_equal(bshuf.bitshuffle_np(a), want)
    np.testing.assert_array_equal(bshuf.bitshuffle(a), want)
    np.testing.assert_array_equal(bshuf.bitunshuffle(want, dtype, n), a)
    assert bshuf.filter_cd_values(a.itemsize) == bbshuf.filter_cd_values(a.itemsize)
    assert bshuf.BITSHUFFLE_FILTER_ID == bbshuf.BITSHUFFLE_FILTER_ID


def test_bitshuffle_chunk_codec_round_trip():
    _codec()
    a = np.random.default_rng(1).standard_normal((16, 1, 100)).astype(np.float32)
    payload = bshuf.compress_chunk(a)
    np.testing.assert_array_equal(
        bshuf.decompress_chunk(payload, np.float32, a.size).reshape(a.shape), a)


def test_bitshuffle_dataset_carries_the_standard_filter(raw, tmp_path):
    _codec()
    p = str(tmp_path / "p.h5")
    _red().reduce_to_file(raw, p, compression="bitshuffle")
    with h5py.File(p, "r") as f:
        cd = fbh5._bitshuffle_cd_values(f["data"])
        assert f["data"].chunks == (16, 1, 2 * NFFT)
    assert cd == bbshuf.filter_cd_values(4)


def test_write_fbh5_and_streamed_writer_agree(tmp_path):
    hdr = {"fch1": 8000.0, "foff": -0.1, "tsamp": 1.0, "source_name": "SYNTH"}
    data = np.random.default_rng(0).standard_normal((37, 1, 24)).astype(np.float32)
    comps = [None, "gzip"] + (["bitshuffle"] if bshuf.available() else [])
    for comp in comps:
        a, b = str(tmp_path / f"a{comp}.h5"), str(tmp_path / f"b{comp}.h5")
        fbh5.write_fbh5(a, hdr, data, compression=comp)
        with fbh5.FBH5Writer(b, hdr, nifs=1, nchans=24, compression=comp,
                             chunks=(8, 1, 24)) as w:
            for s in range(0, 37, 5):
                w.append(data[s:s + 5])
        np.testing.assert_array_equal(fbh5.read_fbh5_data(a), data)
        np.testing.assert_array_equal(fbh5.read_fbh5_data(b), data)
        hb = fbh5.read_fbh5_header(b)
        assert hb["nsamps"] == 37 and hb["nfpc"] == 29


@pytest.mark.parametrize("shape", [(1, 128, 4), (4, 1 << 20, 4), (1, 1 << 26, 4),
                                   (4, 1 << 29, 4)])
def test_default_chunks_match_blit(shape):
    assert fbh5.default_chunks(*shape) == bfbh5.default_chunks(*shape)
    with pytest.raises(ValueError):
        fbh5.default_chunks(4, 1 << 29, 4, whole_spectrum=True)
