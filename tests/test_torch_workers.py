"""The port's worker functions and host-side ops held against blit's on
the CPU.

Tolerances, each blit's own:
- kurtosis: the NumPy path bitwise; the torch path in f32 on
  device="cpu" at rtol 2e-3 / atol 2e-3 (blit's device-against-host bound,
  tests/test_stats.py:55), in f64 at rtol 1e-10 (tests/test_stats.py:24);
- despike: bitwise, on NumPy arrays and torch tensors;
- fqav with np.mean / np.max: rtol 1e-6 (tests/test_workers.py:60-67);
  the default sum bitwise;
- read_fil_data: the same arrays, and it raises where blit raises;
- get_header / get_data / get_kurtosis on .fil and .h5: equal to blit's
  (headers and data exactly; get_kurtosis(device="cpu") at the f32 bound);
- reduce_raw at 4 channels, nfft 16, nint 2, device="cpu": header bytes
  identical, data within the f32 bound of tests/test_torch_pipeline.py
  (rtol 1e-4, atol 1e-2 of the noise-only channel's peak), and the
  nbits=8 product byte-identical;
- search_raw: the header and the hits' cells exactly, SNR and power at
  rtol 1e-4 (tests/test_torch_dedoppler.py's end-to-end bound);
- is_hdf5 equal to h5py.is_hdf5.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from blit import testing as btesting  # noqa: E402
from blit import workers as bworkers  # noqa: E402
from blit.io import sigproc as bsigproc  # noqa: E402
from blit.ops import despike as bdespike  # noqa: E402
from blit.ops.fqav import fqav as bfqav  # noqa: E402
from blit.ops.stats import kurtosis as bkurtosis  # noqa: E402
from blit_torch import faults  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch import workers as tworkers  # noqa: E402
from blit_torch.io import fbh5 as tfbh5  # noqa: E402
from blit_torch.io import sigproc as tsigproc  # noqa: E402
from blit_torch.ops.despike import despike  # noqa: E402
from blit_torch.ops.fqav import fqav  # noqa: E402
from blit_torch.ops.stats import kurtosis  # noqa: E402

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    fil, h5 = str(d / "x.fil"), str(d / "x.h5")
    _, data = btesting.synth_fil(fil, nsamps=64, nifs=2, nchans=64, seed=3)
    btesting.synth_fbh5(h5, nsamps=64, nifs=2, nchans=64, seed=3)
    return {"fil": fil, "h5": h5, "data": data}


# -- kurtosis ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kurtosis_numpy_bitwise(dtype):
    x = np.random.default_rng(7).normal(size=(500, 2, 8)).astype(dtype)
    got, want = kurtosis(x, axis=0), bkurtosis(x, axis=0)
    assert got.dtype == want.dtype and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_kurtosis_torch_f32_within_blit_device_bound():
    x = np.random.default_rng(8).chisquare(4, size=(512, 2, 16)).astype(np.float32)
    got = kurtosis(torch.from_numpy(x), axis=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16)
    np.testing.assert_allclose(got.numpy(), bkurtosis(x, axis=0), rtol=2e-3, atol=2e-3)


def test_kurtosis_torch_f64_matches_scipy_and_blit():
    import scipy.stats

    x = np.random.default_rng(42).normal(size=(500, 2, 8))
    got = kurtosis(torch.from_numpy(x), axis=0).numpy()
    np.testing.assert_allclose(got, bkurtosis(x, axis=0), rtol=1e-10)
    np.testing.assert_allclose(
        got, scipy.stats.kurtosis(x, axis=0, fisher=True, bias=True), rtol=1e-10)


# -- despike ----------------------------------------------------------------

@pytest.mark.parametrize("nfpc", [2, 4, 8, 16])
def test_despike_bitwise(nfpc):
    x = np.random.default_rng(nfpc).normal(size=(3, 2, 64)).astype(np.float32)
    keep = x.copy()
    want = bdespike.despike(x, nfpc)
    got = despike(x, nfpc)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(x, keep)  # input untouched
    t = torch.from_numpy(x.copy())
    got_t = despike(t, nfpc)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), keep)


def test_despike_refuses_what_blit_refuses():
    for nfpc, n in ((4, 10), (1, 8), (0, 8)):
        with pytest.raises(ValueError):
            bdespike.despike(np.zeros((1, 1, n)), nfpc)
        with pytest.raises(ValueError):
            despike(np.zeros((1, 1, n)), nfpc)
        with pytest.raises(ValueError):
            despike(torch.zeros((1, 1, n)), nfpc)


# -- fqav -------------------------------------------------------------------

@pytest.mark.parametrize("f", [np.mean, np.max, np.min, np.median])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_fqav_numpy_reductions(f, n):
    x = np.random.default_rng(n).chisquare(4, size=(8, 2, 64)).astype(np.float32)
    np.testing.assert_allclose(fqav(x, n, f=f), bfqav(x, n, f=f), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
def test_fqav_numpy_default_sum_bitwise(dtype):
    x = (np.random.default_rng(1).chisquare(4, size=(8, 2, 64)) * 10).astype(dtype)
    got, want = fqav(x, 8), bfqav(x, 8)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        fqav(x, 5)


def test_fqav_torch_sums_the_last_dim():
    x = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    assert torch.equal(fqav(x, 8), x.reshape(2, 8, 8).sum(-1))
    assert fqav(x, 1) is x


# -- read_fil_data ----------------------------------------------------------

@pytest.mark.parametrize("mmap", [True, False])
def test_read_fil_data_equals_blit(files, mmap):
    th, td = tsigproc.read_fil_data(files["fil"], mmap=mmap)
    bh, bd = bsigproc.read_fil_data(files["fil"], mmap=mmap)
    assert th == bh
    assert td.dtype == bd.dtype and td.shape == bd.shape
    np.testing.assert_array_equal(td, bd)
    # An explicit header drives the shape, as in blit.
    th2, td2 = tsigproc.read_fil_data(files["fil"], header=dict(bh), mmap=mmap)
    np.testing.assert_array_equal(td2, bd)


@pytest.mark.parametrize("cut", [1, 3, 255])
def test_read_fil_data_payload_check_raises_where_blit_raises(files, tmp_path, cut):
    p = str(tmp_path / "torn.fil")
    with open(files["fil"], "rb") as f:
        b = f.read()
    with open(p, "wb") as f:
        f.write(b[:-cut])
    with pytest.raises(ValueError, match="not a whole number"):
        bsigproc.read_fil_data(p)
    with pytest.raises(ValueError, match="not a whole number"):
        tsigproc.read_fil_data(p)
    # The header alone still reads, as blit's does (nsamps floored).
    assert tworkers.get_header(p) == bworkers.get_header(p)
    with pytest.raises(ValueError):
        tworkers.get_data(p)
    # A header claiming a wider spectrum than the bytes hold raises too.
    hdr, _ = bsigproc.read_fil_header(files["fil"])
    wide = dict(hdr, nchans=hdr["nchans"] * 3)
    for mod in (bsigproc, tsigproc):
        with pytest.raises(ValueError, match="not a whole number"):
            mod.read_fil_data(files["fil"], header=wide)


# -- is_hdf5 ----------------------------------------------------------------

def test_is_hdf5_equals_h5py(files, tmp_path):
    empty = str(tmp_path / "empty.h5")
    open(empty, "wb").close()
    raw = str(tmp_path / "x.0000.raw")
    ttesting.synth_raw(raw, nblocks=1, obsnchan=2, ntime_per_block=256)
    ub = str(tmp_path / "userblock.h5")
    with h5py.File(ub, "w", userblock_size=1024) as f:
        f["data"] = np.zeros(3)
    short = str(tmp_path / "short.bin")
    with open(short, "wb") as f:
        f.write(b"\x89HDF\r\n")
    paths = [files["h5"], files["fil"], empty, raw, ub, short,
             str(tmp_path / "missing.h5"), str(tmp_path)]
    got = [tfbh5.is_hdf5(p) for p in paths]
    assert got == [h5py.is_hdf5(p) for p in paths]
    assert got == [True, False, False, False, True, False, False, False]


# -- worker functions -------------------------------------------------------

@pytest.mark.parametrize("kind", ["fil", "h5"])
def test_get_header_equals_blit(files, kind):
    assert tworkers.get_header(files[kind]) == bworkers.get_header(files[kind])


ALL = (slice(None), slice(None), slice(None))
# (idxs, fqav_by, fqav_func): ints become length-1 slices; averaging
# needs whole groups of the selected channels.
GET_DATA_CASES = [
    (ALL, 1, None), (ALL, 8, None), (ALL, 4, np.mean), (ALL, 16, np.max),
    ((5, 0, slice(None)), 1, None), ((5, 0, slice(None)), 8, None),
    ((5, 0, slice(None)), 4, np.mean),
    ((slice(2, 40, 3), slice(None), slice(8, 40)), 1, None),
    ((slice(2, 40, 3), slice(None), slice(8, 40)), 8, np.max),
    ((slice(2, 40, 3), slice(None), slice(8, 40)), 4, np.mean),
    ((np.int64(7), 1, 3), 1, None),
]


@pytest.mark.parametrize("kind", ["fil", "h5"])
@pytest.mark.parametrize("case", range(len(GET_DATA_CASES)))
def test_get_data_equals_blit(files, kind, case):
    idxs, fqav_by, f = GET_DATA_CASES[case]
    got = tworkers.get_data(files[kind], idxs, fqav_by=fqav_by, fqav_func=f)
    want = bworkers.get_data(files[kind], idxs, fqav_by=fqav_by, fqav_func=f)
    assert got.shape == want.shape and got.dtype == want.dtype and got.ndim == 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["fil", "h5"])
def test_get_kurtosis_equals_blit(files, kind):
    want = bworkers.get_kurtosis(files[kind])
    got = tworkers.get_kurtosis(files[kind], device=False)
    assert got.shape == (64, 2)
    np.testing.assert_array_equal(got, want)
    dev = tworkers.get_kurtosis(files[kind], device="cpu")
    assert dev.shape == (64, 2) and dev.dtype == np.float32
    np.testing.assert_allclose(dev, want, rtol=2e-3, atol=2e-3)
    sub = (slice(0, 32), 0, slice(None))
    np.testing.assert_allclose(tworkers.get_kurtosis(files[kind], sub, device="cpu"),
                               bworkers.get_kurtosis(files[kind], sub),
                               rtol=2e-3, atol=2e-3)


def test_get_kurtosis_device_true_means_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    # The card is the default: True, None and no argument all ask for it.
    for kw in ({"device": True}, {"device": None}, {}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tworkers.get_kurtosis(files["fil"], **kw)


def test_sanitize_idxs_and_freq_axis(files):
    idxs = (3, slice(None), np.int32(1))
    assert tworkers.sanitize_idxs(idxs) == bworkers.sanitize_idxs(idxs)
    hdr = bworkers.get_header(files["h5"])
    for n in (1, 2, 8):
        assert tworkers.get_freq_axis(hdr, n) == bworkers.get_freq_axis(hdr, n)
    with pytest.raises(ValueError, match="three"):
        tworkers.get_fb_data(files["fil"], (slice(None),))


def test_read_fault_point_retries(files):
    faults.clear()
    faults.set_io_policy(faults.RetryPolicy(attempts=3, base_s=0.0, jitter=0.0))
    try:
        faults.install(faults.FaultRule("workers.read", times=1))
        before = faults.counters().get("retry.io", 0)
        got = tworkers.get_data(files["fil"], fqav_by=4)
        assert faults.counters().get("retry.io", 0) == before + 1
        np.testing.assert_array_equal(got, bworkers.get_data(files["fil"], fqav_by=4))
        faults.install(faults.FaultRule("workers.read", times=-1))
        with pytest.raises(OSError, match="injected"):
            tworkers.get_data(files["h5"])
    finally:
        faults.clear()
        faults.set_io_policy(None)


# -- reduce_raw -------------------------------------------------------------

NCHAN, NFFT, NINT = 4, 16, 2


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("raw") / "bank.0000.raw")
    ttesting.synth_raw(p, nblocks=3, obsnchan=NCHAN, ntime_per_block=1024,
                       seed=11, tone_chan=1, tone_freq=0.25)
    return p


def _header_bytes(path):
    _, off = bsigproc.read_fil_header(path)
    with open(path, "rb") as f:
        return f.read(off)


@pytest.mark.parametrize("nbits", [32, 8])
def test_reduce_raw_to_file_equals_blit(raw, tmp_path, nbits):
    kw = dict(nfft=NFFT, nint=NINT, nbits=nbits)
    if nbits == 8:
        kw.update(quant_scale=0.01, quant_offset=3.0)
    b, t = str(tmp_path / "b.fil"), str(tmp_path / "t.fil")
    bh = bworkers.reduce_raw(raw, b, async_output=False, **kw)
    th = tworkers.reduce_raw(raw, t, device="cpu", **kw)
    assert th["nchans"] == bh["nchans"] == NCHAN * NFFT
    assert th["nsamps"] == bh["nsamps"] > 0
    assert _header_bytes(t) == _header_bytes(b)
    if nbits == 8:
        with open(b, "rb") as fb, open(t, "rb") as ft:
            assert ft.read() == fb.read()
        return
    _, want = bsigproc.read_fil_data(b)
    _, got = bsigproc.read_fil_data(t)
    peak = np.abs(want[..., :NFFT]).max()  # coarse channel 0: noise only
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2 * peak)


def test_reduce_raw_in_memory_and_presets(raw):
    th, td = tworkers.reduce_raw(raw, nfft=NFFT, nint=NINT, device="cpu")
    bh, bd = bworkers.reduce_raw(raw, nfft=NFFT, nint=NINT, async_output=False)
    assert {k: th[k] for k in ("nchans", "nsamps", "fch1", "foff", "nfpc")} == \
        {k: bh[k] for k in ("nchans", "nsamps", "fch1", "foff", "nfpc")}
    np.testing.assert_allclose(td, bd, rtol=1e-4, atol=1e-2 * np.abs(bd[..., :NFFT]).max())
    with pytest.raises(ValueError, match="not both"):
        tworkers.reduce_raw(raw, product="0000", nint=16, device="cpu")
    with pytest.raises(ValueError, match="requires"):
        tworkers.reduce_raw(raw, resume=True, nfft=NFFT, device="cpu")
    h = tworkers.reduce_raw(raw, product="0001", device="cpu", chunk_frames=128)[0]
    assert (h["nchans"], h["nfpc"]) == (NCHAN * 8, 8)


def test_reduce_raw_resume_equals_plain(raw, tmp_path):
    a, b = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    tworkers.reduce_raw(raw, a, nfft=NFFT, nint=NINT, device="cpu")
    tworkers.reduce_raw(raw, b, nfft=NFFT, nint=NINT, device="cpu", resume=True)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert not os.path.exists(b + ".cursor")


def test_search_raw_equals_a_direct_search(tmp_path):
    from blit_torch.search import DedopplerReducer

    p = str(tmp_path / "s.raw")
    ttesting.synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=64 * 68,
                       seed=4, tone_chan=1, tone_freq=0.25)
    kw = dict(nfft=64, nint=1, window_spectra=16, device="cpu")
    hdr, recs = tworkers.search_raw(p, **kw)
    want_hdr, hits = DedopplerReducer(**kw).search(p)
    assert hdr == want_hdr
    assert recs == [h.record() for h in hits] and len(recs) > 0
    out, direct = str(tmp_path / "w.hits"), str(tmp_path / "d.hits")
    tworkers.search_raw(p, out, **kw)
    DedopplerReducer(**kw).search_to_file(p, direct)
    with open(out, "rb") as fa, open(direct, "rb") as fb:
        assert fa.read() == fb.read()


def _same_hit_records(got, want):
    # Cells, frequency, drift rate and start exactly; SNR and power at the
    # end-to-end f32 bound of tests/test_torch_dedoppler.py (rtol 1e-4:
    # torch and XLA sum the band's mean and std in another order).
    exact = ("window", "drift_bins", "chan", "band", "t_start", "freq_mhz", "drift_hz_s")
    assert [{k: r[k] for k in exact} for r in got] == \
        [{k: r[k] for k in exact} for r in want]
    for key in ("snr", "power"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=1e-4)


def test_search_raw_equals_blit(tmp_path):
    from blit.io import hits as bhits
    from blit_torch.io import hits as thits

    p = str(tmp_path / "s.raw")
    btesting.synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=64 * 68,
                       seed=4, tone_chan=1, tone_freq=0.25)
    kw = dict(nfft=64, nint=1, window_spectra=16, top_k=4, snr_threshold=6.0)
    blit_kw = dict(kw, kernel="reference", async_output=False)
    # Over the wire: the header and the hits as plain records.
    hdr, recs = tworkers.search_raw(p, device="cpu", **kw)
    bhdr, brecs = bworkers.search_raw(p, **blit_kw)
    assert hdr == bhdr and len(recs) == len(brecs) > 0
    _same_hit_records(recs, brecs)
    # To a .hits product: the same header line, and each package reads
    # the other's hits alike.
    out, bout = str(tmp_path / "port.hits"), str(tmp_path / "blit.hits")
    assert tworkers.search_raw(p, out, device="cpu", **kw) == \
        bworkers.search_raw(p, bout, **blit_kw)
    with open(out) as f, open(bout) as g:
        assert f.readline() == g.readline()
    th, thit = thits.read_hits(out)
    bh, bhit = bhits.read_hits(bout)
    assert th == bh
    _same_hit_records([h.record() for h in thit], [h.record() for h in bhit])
    _same_hit_records([h.record() for h in bhits.read_hits(out)[1]],
                      [h.record() for h in thits.read_hits(bout)[1]])
