"""The plain reference against hand-computed values and against the
port's CPU path at tiny shapes."""

import numpy as np
import pytest
import torch

from conftest import REPO  # noqa: F401  (puts the repo on the path)
from portbench.reference import filterbank


def _volts(nchan, ntime, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-40, 40, size=(nchan, ntime, 2, 2)).astype(np.int8)


def test_prototype_has_unit_dc_gain_and_peaks_mid_filter():
    h = filterbank.prototype(4, 16)
    assert h.shape == (4, 16)
    assert h.sum() == pytest.approx(1.0, abs=1e-14)
    flat = h.reshape(-1)
    assert flat.argmax() == flat.size // 2  # the sinc's centre


def test_frame_against_a_hand_computed_dft():
    nfft, ntap = 8, 4
    v = _volts(1, nfft * (ntap + 1), 3)
    h = filterbank.prototype(ntap, nfft)
    got = filterbank.stokes_i_frames(torch.from_numpy(v), torch.from_numpy(h))
    assert got.shape == (1, 2, nfft)
    z = v[0, :, :, 0].astype(np.float64) + 1j * v[0, :, :, 1]
    for f in range(2):
        want = np.zeros(nfft)
        for pol in range(2):
            x = sum(h[k] * z[(f + k) * nfft:(f + k + 1) * nfft, pol]
                    for k in range(ntap))
            for j in range(nfft):
                # Zero frequency in the middle: bin j holds frequency j - nfft/2.
                k_ = (j - nfft // 2) % nfft
                s = sum(x[n] * np.exp(-2j * np.pi * k_ * n / nfft)
                        for n in range(nfft))
                want[j] += abs(s) ** 2
        np.testing.assert_allclose(got[0, f].numpy(), want, rtol=1e-12)


def test_product_row_against_the_port_on_the_cpu():
    from blit_torch.ops.channelize import channelize, pfb_coeffs

    nfft, ntap, nint, nchan = 32, 4, 4, 3
    ntime = 2048
    pool = [_volts(nchan, ntime, s) for s in (1, 2)]
    rows = 2
    n = (rows * nint + ntap - 1) * nfft
    v = filterbank.samples(pool, 0, n)
    port = channelize(torch.from_numpy(v), torch.from_numpy(pfb_coeffs(ntap, nfft)),
                      nfft=nfft, ntap=ntap, nint=nint, stokes="I",
                      device="cpu").numpy()
    for r in range(rows):
        want = filterbank.product_row(pool, r, nfft=nfft, ntap=ntap, nint=nint,
                                      window="hamming", device="cpu")
        np.testing.assert_allclose(port[r, 0], want, rtol=2e-5)


def test_samples_cross_the_pool_cyclically():
    pool = [np.full((1, 4, 2, 2), i, np.int8) for i in range(3)]
    s = filterbank.samples(pool, 10, 6)  # blocks 2, 3 (= pool 0), 4 (= pool 1)
    assert s[0, :, 0, 0].tolist() == [2, 2, 0, 0, 0, 0]
    assert filterbank.samples(pool, 14, 3)[0, :, 0, 0].tolist() == [0, 0, 1]


def test_period_rows_matches_the_samples_rows_read():
    pool = [np.full((1, 24, 2, 2), i, np.int8) for i in range(7)]
    nfft, nint, ntap = 4, 4, 2
    n = (nint + ntap - 1) * nfft
    period = filterbank.period_rows(7 * 24, nfft, nint)
    assert period == 21  # 168 samples / gcd(168, 16)
    row = [filterbank.samples(pool, r * nint * nfft, n) for r in range(2 * period)]
    for r in range(period):
        np.testing.assert_array_equal(row[r], row[r + period])
        assert all(not np.array_equal(row[r], row[q])
                   for q in range(period) if q != r)
    assert filterbank.period_rows(7 << 19, 1024, 2048) == 7
    assert filterbank.period_rows(7 << 19, 1024, 3072) == 7


def test_header_fields():
    raw = {"OBSNCHAN": 64, "OBSBW": -187.5, "OBSFREQ": 6000.0,
           "TBIN": 1 / 2.9296875e6}
    h = filterbank.header(raw, nfft=1024, nint=2048)
    assert h["nchans"] == 65536
    assert h["foff"] == pytest.approx(-187.5 / 64 / 1024)
    # Fine channel 512 of coarse channel 0 sits at that channel's centre.
    assert h["fch1"] + 512 * h["foff"] == pytest.approx(6000 + 93.75 - 187.5 / 128)
    assert h["tsamp"] == pytest.approx(1024 * 2048 / 2.9296875e6)
    assert filterbank.header_off(dict(h), h) == 0
    assert filterbank.header_off(dict(h, fch1=h["fch1"] + 1e-6), h) == 1
    assert filterbank.header_off({k: v for k, v in h.items() if k != "nifs"}, h) == 1
