"""The port's search plane (blit_torch.ops.dedoppler, blit_torch.search,
blit_torch.io.hits) held against blit's.

On the CPU the port's Taylor tree is its plain version, which repeats
blit's per-element add sequence, so the tree, the both-sign transform
and the brute force agree with blit's reference and its interpreted
Pallas kernel BITWISE (tests/test_dedoppler.py:74-126 holds blit's own
paths to the same).  The SNR is a mean and a std over the band, summed
in another order by torch than by XLA: SNR within rtol 1e-5 for the
same window, 1e-4 end to end (the spectra themselves agree to blit's f32
bound, tests/test_pallas_detect.py:150-198).  Decoded hits, (window,
drift, chan, band), must be identical and in the same order; where a
row is a sentinel, only the decoded hits are compared (torch and XLA may
pick different cells below the threshold).  Inputs are made from numpy
seeds.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit import config as bconfig  # noqa: E402
from blit import testing as btesting  # noqa: E402
from blit.io import hits as bhits_io  # noqa: E402
from blit.ops import pallas_dedoppler as bpd  # noqa: E402
from blit.search import DedopplerReducer as BlitDedoppler  # noqa: E402
from blit.search import hits as bhits  # noqa: E402
from blit_torch import config as tconfig  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.io import hits as thits_io  # noqa: E402
from blit_torch.ops import dedoppler as tpd  # noqa: E402
from blit_torch.search import DedopplerReducer  # noqa: E402
from blit_torch.search import hits as thits  # noqa: E402

NFFT = 128
T = 8  # window_spectra of the end-to-end tests


def _power(T, F, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 200, size=(T, F)).astype(np.float32)
    return rng.normal(50.0, 5.0, size=(T, F)).astype(np.float32)


# -- the tree ---------------------------------------------------------------

@pytest.mark.parametrize("Tw", [2, 4, 8, 16, 32, 64])
def test_tree_bitwise_equal_to_blit_reference(Tw):
    # F = 203 is a multiple of no tile width of either package.
    x = _power(Tw, 203, Tw)
    want = np.asarray(bpd.taylor_tree(x, kernel="reference"))
    plain = tpd.taylor_tree_plain(torch.from_numpy(x))
    assert plain.dtype == torch.float32 and plain.shape == (Tw, 203)
    assert np.array_equal(plain.numpy(), want)
    # The dispatcher takes the plain version for a CPU tensor.
    n0 = tpd.taylor_tree.launches
    assert np.array_equal(tpd.taylor_tree(torch.from_numpy(x)).numpy(), want)
    assert tpd.taylor_tree.launches == n0


@pytest.mark.parametrize("Tw", [4, 8])
def test_tree_bitwise_equal_to_blit_pallas_interpret(Tw):
    x = _power(Tw, 200, 10 + Tw)
    want = np.asarray(bpd.taylor_tree(x, kernel="pallas", interpret=True, tile=64))
    assert np.array_equal(tpd.taylor_tree_plain(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("Tw,F", [(4, 37), (16, 96), (32, 64), (8, 16)])
def test_tree_bitwise_equal_to_brute_force_on_integers(Tw, F):
    # Integer-valued f32 sums are exact in any order.
    x = _power(Tw, F, F, integer=True)
    brute = tpd.brute_force_dedoppler(x)
    assert np.array_equal(brute, bpd.brute_force_dedoppler(x))
    assert np.array_equal(tpd.taylor_tree_plain(torch.from_numpy(x)).numpy(),
                          brute.astype(np.float32))


def test_tree_path_shift_matches_blit():
    for Tw in (2, 8, 32, 128):
        for d in range(Tw):
            assert [tpd.tree_path_shift(d, t, Tw) for t in range(Tw)] == [
                bpd.tree_path_shift(d, t, Tw) for t in range(Tw)]


@pytest.mark.parametrize("Tw,F", [(2, 5), (8, 203), (16, 100), (64, 77)])
def test_drift_spectra_bitwise_equal_to_blit(Tw, F):
    x = _power(Tw, F, 100 + Tw)
    want = np.asarray(bpd.drift_spectra(x, kernel="reference"))
    got = tpd.drift_spectra(torch.from_numpy(x))
    assert got.shape == (2 * Tw - 1, F)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tpd.drift_spectra_plain(torch.from_numpy(x)).numpy(), want)
    assert np.array_equal(tpd.drift_rates(Tw), bpd.drift_rates(Tw))


@pytest.mark.parametrize("Tw", [1, 3, 6, 2048])
def test_window_validation(Tw):
    x = torch.zeros((Tw, 8))
    for fn in (tpd.taylor_tree, tpd.drift_spectra, tpd.taylor_tree_plain,
               tpd.kernel_route):
        with pytest.raises(ValueError):
            fn(Tw if fn is tpd.kernel_route else x)


def test_kernel_route_takes_every_window():
    # No window from 2 to 1024 falls back to the plain version on the
    # card: T <= 8 in one launch of register subtrees, T <= 64 in one
    # launch through a shared-memory tile, larger T with one global pass
    # per three stages past the sixth (T = 1024: two).
    want = {1: ("registers", 1), 2: ("registers", 1), 3: ("registers", 1),
            4: ("shared", 1), 5: ("shared", 1), 6: ("shared", 1),
            7: ("shared+passes", 2), 8: ("shared+passes", 2),
            9: ("shared+passes", 2), 10: ("shared+passes", 3)}
    for k in range(1, 11):
        assert tpd.kernel_route(1 << k) == want[k]


# -- hit extraction ---------------------------------------------------------

def _decoded(packed):
    snr, power, drift, chan, band = bpd.unpack_hits(np.asarray(packed))
    return snr, power, list(zip(drift.tolist(), chan.tolist(), band.tolist()))


@pytest.mark.parametrize("nbands", [1, 2])
@pytest.mark.parametrize("max_drift", [None, 3])
def test_dedoppler_hits_match_blit(nbands, max_drift):
    Tw, F, k = 8, 96, 6
    x = _power(Tw, F, 7)
    # A drifting tone in band 0 and a weaker one in the last band; the
    # threshold sentinels most of the noise cells.
    for t in range(Tw):
        x[t, 10 + tpd.tree_path_shift(2, t, Tw)] += 40.0
        x[t, F - 20 + tpd.tree_path_shift(5, t, Tw)] += 15.0
    thr = 4.0
    want = np.asarray(bpd.dedoppler_hits(
        x, np.float32(thr), top_k=k, nbands=nbands, max_drift_bins=max_drift,
        kernel="reference"))
    got = tpd.dedoppler_hits(torch.from_numpy(x), thr, top_k=k, nbands=nbands,
                             max_drift_bins=max_drift)
    assert got.dtype == torch.int32 and got.shape == (nbands, k, tpd.HIT_PACK_COLS)
    ws, wp, wcells = _decoded(want)
    gs, gp, gcells = _decoded(got.numpy())
    assert gcells == wcells
    assert 0 < len(gcells) < nbands * k  # some rows live, some sentinels
    assert np.array_equal(gp, wp)  # the same cells of a bitwise-equal tree
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    if max_drift is not None:
        assert all(abs(d) <= max_drift for d, _, _ in gcells)
    # The unpack is blit's.
    for a, b in zip(tpd.unpack_hits(got.numpy()), bpd.unpack_hits(got.numpy())):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("batch", [tpd._TIE_BATCH, 60])
def test_top_k_ties_take_the_lower_index_like_jax(monkeypatch, batch):
    # Integer values tie a lot, -inf rows (a drift mask) tie everywhere,
    # and so does a constant row (a blanked band: SNR 0 in every cell).
    # A batch of 60 elements repairs the tied rows one at a time.
    monkeypatch.setattr(tpd, "_TIE_BATCH", batch)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, size=(6, 60)).astype(np.float32)
    x[2] = -np.inf
    x[3, :55] = -np.inf
    x[4] = 0.0
    x[5, 7] = 9.0
    x[5, 40:] = 9.0
    for k in (1, 4, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tpd._top_k(torch.from_numpy(x), k)
        assert np.array_equal(gv.numpy(), np.asarray(wv))
        assert np.array_equal(gi.numpy(), np.asarray(wi))


# -- records and the .hits product -----------------------------------------

def _hits(cls, n=3, big=False):
    return [cls(snr=10.0 + i, power=5.25, drift_bins=i - 1,
                chan=(1 << 26) + 12345 + i if big else 100 + i, band=i % 2,
                window=i, t_start=8 * i, freq_mhz=8000.5 - i * 1e-6,
                drift_hz_s=0.25 * i)
            for i in range(n)]


@pytest.mark.parametrize("big", [False, True])
def test_hits_to_array_byte_identical_to_blit(big):
    arr = thits.hits_to_array(_hits(thits.Hit, big=big))
    want = bhits.hits_to_array(_hits(bhits.Hit, big=big))
    assert arr.dtype == np.float32 and arr.tobytes() == want.tobytes()
    hdr = {"fch1": 8437.5, "foff": -1e-6, "tsamp": 0.5,
           "search_window_spectra": 16}
    got = [h.record() for h in thits.hits_from_array(arr, hdr)]
    assert got == [h.record() for h in bhits.hits_from_array(want, hdr)]


def test_hits_from_packed_matches_blit():
    x = _power(8, 64, 9)
    packed = np.asarray(bpd.dedoppler_hits(x, np.float32(2.0), top_k=4,
                                           nbands=2, kernel="reference"))
    hdr = {"fch1": 8437.5, "foff": -1e-3, "tsamp": 0.25,
           "search_window_spectra": 8}
    got = [h.record() for h in thits.hits_from_packed(packed, 3, hdr)]
    assert got and got == [h.record() for h in bhits.hits_from_packed(packed, 3, hdr)]


def test_hits_file_round_trip_across_packages(tmp_path):
    hdr = {"nchans": 256, "search_window_spectra": T, "fch1": np.float64(1.5),
           "nbits": np.int32(32)}
    a, b = str(tmp_path / "port.hits"), str(tmp_path / "blit.hits")
    thits_io.write_hits(a, hdr, _hits(thits.Hit))
    bhits_io.write_hits(b, hdr, _hits(bhits.Hit))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert thits_io.header_line(hdr) == bhits_io.header_line(hdr)
    rh, rhits = thits_io.read_hits(b)
    assert rh["nchans"] == 256 and rhits == _hits(thits.Hit)
    assert not os.path.exists(a + ".partial")


def test_hits_writer_abort_publishes_nothing(tmp_path):
    path = str(tmp_path / "x.hits")
    w = thits_io.HitsWriter(path, {"search_window_spectra": T})
    w.append(thits_io.WindowHits(0, _hits(thits.Hit)))
    assert not os.path.exists(path) and os.path.exists(path + ".partial")
    w.abort()
    assert not os.path.exists(path + ".partial")
    (tmp_path / "y.hits").write_text(json.dumps({"kind": "x"}) + "\n")
    with pytest.raises(ValueError, match="not a blit.hits"):
        thits_io.read_hits(str(tmp_path / "y.hits"))


# -- knobs ------------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {},
    {"BLIT_SEARCH_WINDOW": "16", "BLIT_SEARCH_TOP_K": "3"},
    {"BLIT_SEARCH_SNR": "6.5", "BLIT_SEARCH_MAX_DRIFT": "4"},
    {"BLIT_SEARCH_MAX_DRIFT": "-1"},
], ids=["site", "window+top_k", "snr+drift", "unlimited"])
def test_search_defaults_match_blit(monkeypatch, env):
    for k in ("BLIT_SEARCH_WINDOW", "BLIT_SEARCH_TOP_K", "BLIT_SEARCH_SNR",
              "BLIT_SEARCH_MAX_DRIFT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tconfig.search_defaults() == bconfig.search_defaults()
    red = DedopplerReducer(nfft=NFFT, device="cpu")
    assert red.fingerprint_extra() == BlitDedoppler(nfft=NFFT).fingerprint_extra()


# -- the reducer end to end ------------------------------------------------

def _synth(path, drift_bins, windows=2, obsnchan=2, ntap=4, tone_chan=1, seed=1):
    """tests/test_dedoppler.py's recording: exactly ``windows`` search
    windows plus the PFB tail, a drifting tone in ``tone_chan``."""
    ntime = (T * windows + ntap - 1) * NFFT
    tone_drift = btesting.tone_drift_for(NFFT, T, drift_bins)
    assert tone_drift == ttesting.tone_drift_for(NFFT, T, drift_bins)
    return ttesting.synth_raw(
        str(path), nblocks=2, obsnchan=obsnchan, ntime_per_block=-(-ntime // 2),
        seed=seed, tone_chan=tone_chan, tone_drift=tone_drift, tone_amp=30.0)


def test_synth_raw_with_drift_bitwise_equal_to_blit(tmp_path):
    kw = dict(nblocks=2, obsnchan=2, ntime_per_block=1000, seed=4, tone_chan=1,
              tone_drift=btesting.tone_drift_for(NFFT, T, 3))
    ttesting.synth_raw(str(tmp_path / "t.raw"), **kw)
    btesting.synth_raw(str(tmp_path / "b.raw"), **kw)
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "b.raw").read_bytes()


KNOBS = dict(nfft=NFFT, window_spectra=T, top_k=4, snr_threshold=6.0)


@pytest.mark.parametrize("drift_bins", [0, 3, -3])
def test_search_matches_blit(tmp_path, drift_bins):
    raw = tmp_path / "tone.raw"
    _synth(raw, drift_bins)
    red = DedopplerReducer(device="cpu", **KNOBS)
    hdr, hits = red.search(str(raw))
    bred = BlitDedoppler(kernel="reference", async_output=False, **KNOBS)
    bhdr, bh = bred.search(str(raw))
    assert hdr == bhdr
    assert hdr["search_windows"] == 2 and hits
    cells = [(h.window, h.drift_bins, h.chan, h.band) for h in hits]
    assert cells == [(h.window, h.drift_bins, h.chan, h.band) for h in bh]
    np.testing.assert_allclose([h.snr for h in hits], [h.snr for h in bh], rtol=1e-4)
    np.testing.assert_allclose([h.power for h in hits], [h.power for h in bh],
                               rtol=1e-4)
    assert [(h.freq_mhz, h.drift_hz_s, h.t_start) for h in hits] == [
        (h.freq_mhz, h.drift_hz_s, h.t_start) for h in bh]
    # The tone is found within one drift step, in its coarse channel.
    top = max(hits, key=lambda h: h.snr)
    assert abs(top.drift_bins - drift_bins) <= 1 and top.band == 1
    hists = red.timeline.hists
    assert hists["search.tree_s"].n == 2
    assert hists["search.hits_per_window"].total == len(hits)
    fill = red.timeline.stages["search.window_fill"]
    assert fill.bytes == 2 * T * hdr["nchans"] * 4


def test_search_to_file_matches_blit_and_reads_across(tmp_path):
    raw = tmp_path / "tone.raw"
    _synth(raw, 3, windows=3)
    red = DedopplerReducer(device="cpu", **KNOBS)
    out, bout = str(tmp_path / "port.hits"), str(tmp_path / "blit.hits")
    hdr = red.search_to_file(str(raw), out)
    bhdr = BlitDedoppler(kernel="reference", async_output=False,
                         **KNOBS).search_to_file(str(raw), bout)
    assert hdr == bhdr and hdr["search_windows"] == 3
    assert not os.path.exists(out + ".partial")
    with open(out) as f, open(bout) as g:
        line, bline = f.readline(), g.readline()
    assert line == bline
    from blit_torch.io.guppi import GuppiRaw

    assert line == thits_io.header_line(red.header_for(GuppiRaw(str(raw))))
    # Each package reads the other's product.
    ph, phits = bhits_io.read_hits(out)
    th, thits_ = thits_io.read_hits(bout)
    assert ph == th
    assert [(h.window, h.drift_bins, h.chan, h.band) for h in phits] == [
        (h.window, h.drift_bins, h.chan, h.band) for h in thits_]
    np.testing.assert_allclose([h.snr for h in phits], [h.snr for h in thits_],
                               rtol=1e-4)
    assert red.timeline.stages["search.write"].calls == 3


def test_reduce_dense_array(tmp_path):
    raw = tmp_path / "tone.raw"
    _synth(raw, 0)
    red = DedopplerReducer(device="cpu", **KNOBS)
    hdr, arr = red.reduce(str(raw))
    bhdr, barr = BlitDedoppler(kernel="reference", async_output=False,
                               **KNOBS).reduce(str(raw))
    assert hdr == bhdr
    assert arr.shape == barr.shape == (hdr["nsamps"], 1, thits.HIT_COLS)
    assert np.array_equal(arr[..., 2:], barr[..., 2:])
    np.testing.assert_allclose(arr[..., :2], barr[..., :2], rtol=1e-4)


def test_reducer_knobs(monkeypatch):
    monkeypatch.setenv("BLIT_SEARCH_MAX_DRIFT", "-1")
    red = DedopplerReducer(nfft=NFFT, device="cpu", max_drift_bins=-5)
    assert red.max_drift_bins is None
    with pytest.raises(ValueError, match="power of two"):
        DedopplerReducer(nfft=NFFT, device="cpu", window_spectra=12)
    with pytest.raises(ValueError, match="1024"):
        DedopplerReducer(nfft=NFFT, device="cpu", window_spectra=2048)


def test_empty_recording_rejected(tmp_path):
    p = tmp_path / "empty.raw"
    p.write_bytes(b"")
    with pytest.raises(ValueError):
        DedopplerReducer(device="cpu", **KNOBS).search(str(p))
