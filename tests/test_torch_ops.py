"""The port's kernel ops (blit_torch.ops) held against blit's.

The plain PyTorch twins of the two Hopper kernels run here on the CPU
against blit's Pallas functions in interpret mode, on the same numpy-
seeded inputs, at the tolerances blit's own tests use:

- pfb_dft1: f32 rtol 1e-4 / atol 1e-2·max (tests/test_pallas_pfb.py:105),
  bf16 rtol 0.05 / atol 0.05·max (tests/test_pallas_detect.py:147).
- tail2_detect: f32 rtol 1e-5 / atol 1e-4·max (tests/test_pallas_detect.py
  :104, :130), bf16 as above.
- pfb_dequant: |err| / max(peak, 1) below 1e-6 (f32) and 3e-2 (bf16)
  (tests/test_pallas_pfb.py:24-42); every int8 value exactly.
- dft_last, dft_stage, dft_tail2 and the port's dft(use_pallas=True):
  rtol 1e-4 / atol 1e-3 on unit-variance input (tests/test_pallas_dft.py
  :22-33, :86-100).

The kernels themselves run only on a CUDA device; tests/test_torch_cuda.py
compares them with these twins there.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import channelize as bch  # noqa: E402
from blit.ops import dft as bdft  # noqa: E402
from blit.ops import pallas_detect, pallas_dft, pallas_pfb  # noqa: E402
from blit_torch.ops import channelize as tch  # noqa: E402
from blit_torch.ops import detect as tdet  # noqa: E402
from blit_torch.ops import dft as tdft  # noqa: E402
from blit_torch.ops import pfb as tpfb  # noqa: E402

BOUNDS = {"float32": (1e-4, 1e-2), "bfloat16": (0.05, 0.05)}


def _pfb_inputs(nfft, n1, nchan=2, nblk=6, ntap=4, seed=0):
    rng = np.random.default_rng(seed)
    # The full int8 range, as tests/test_pallas_pfb.py:44 draws it.
    v = rng.integers(-128, 128, (nchan, nblk * nfft, 2, 2), np.int8)
    sign = np.where(np.arange(nfft) % 2 == 0, 1.0, -1.0).astype(np.float32)
    h = bch.pfb_coeffs(ntap, nfft) * sign
    mats = bdft.dft_matrices(n1) + bdft.twiddles(n1, nfft // n1)
    return v, h, mats


def _assert_close(got, want, rtol, atol_frac):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nfft,n1", [(512, 16), (8192, 128), (6144, 64),
                                     (12288, 96)])
def test_pfb_dft1_plain_matches_pallas(nfft, n1, dtype):
    v, h, mats = _pfb_inputs(nfft, n1)
    want = pallas_pfb.pfb_dft1(jnp.asarray(v), jnp.asarray(h),
                               *(jnp.asarray(m) for m in mats),
                               dtype=dtype, interpret=True)
    got = tpfb.pfb_dft1(torch.from_numpy(v), torch.from_numpy(h),
                        *(torch.from_numpy(m) for m in mats), dtype=dtype)
    assert got[0].dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    rtol, atol = BOUNDS[dtype]
    for g, w in zip(got, want):
        _assert_close(g.float().numpy(), w, rtol, atol)


def test_pfb_dft1_every_int8_value():
    # Every byte value -128..127 in every lane (re/im of both pols),
    # through a pass-through tap: sign extension is exact.
    nfft, n1 = 512, 16
    ramp = np.tile(np.arange(-128, 128, dtype=np.int8), 12)  # 3072 = 6 blocks
    block = np.stack([ramp, -ramp - 1], axis=-1)
    block = np.stack([block, block[::-1]], axis=-2)[None]  # (1, 3072, 2, 2)
    h = np.zeros((4, nfft), np.float32)
    h[0] = 1.0
    mats = bdft.dft_matrices(n1) + bdft.twiddles(n1, nfft // n1)
    want = pallas_pfb.pfb_dft1(jnp.asarray(block), jnp.asarray(h),
                               *(jnp.asarray(m) for m in mats), interpret=True)
    got = tpfb.pfb_dft1_plain(torch.from_numpy(block), torch.from_numpy(h),
                              *(torch.from_numpy(m) for m in mats))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w, *BOUNDS["float32"])


def _tail_inputs(factors, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f1, f2, f3 = factors
    shape = (2, 2, 3, f1, f2 * f3)
    ur = rng.standard_normal(shape).astype(np.float32)
    ui = rng.standard_normal(shape).astype(np.float32)
    jr, ji = jnp.asarray(ur), jnp.asarray(ui)
    tr, ti = torch.from_numpy(ur), torch.from_numpy(ui)
    if dtype == "bfloat16":
        jr, ji = jr.astype(jnp.bfloat16), ji.astype(jnp.bfloat16)
        tr, ti = tr.bfloat16(), ti.bfloat16()
    return (jr, ji), (tr, ti)


@pytest.mark.parametrize("stokes", ["I", "XX", "YY", "XXYY", "full", "IQUV"])
@pytest.mark.parametrize("factors", [(8, 32, 4), (8, 4, 4), (16, 8, 8)])
def test_tail2_detect_plain_matches_pallas(factors, stokes):
    (jr, ji), (tr, ti) = _tail_inputs(factors, "float32")
    f1, f2, f3 = factors
    want = pallas_detect.tail2_detect(jr, ji, f2, f3, stokes=stokes,
                                      interpret=True)
    got = tdet.tail2_detect(tr, ti, f2, f3, stokes=stokes)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, 1e-5, 1e-4)


@pytest.mark.parametrize("stokes", ["I", "IQUV"])
def test_tail2_detect_plain_bf16_matches_pallas(stokes):
    (jr, ji), (tr, ti) = _tail_inputs((8, 32, 4), "bfloat16", seed=1)
    want = pallas_detect.tail2_detect(jr, ji, 32, 4, stokes=stokes,
                                      interpret=True)
    got = tdet.tail2_detect(tr, ti, 32, 4, stokes=stokes)
    _assert_close(got.numpy(), want, *BOUNDS["bfloat16"])


def test_tail2_detect_i_is_stokes_i_plane():
    (jr, ji), (tr, ti) = _tail_inputs((8, 32, 4), "float32", seed=2)
    want = pallas_detect.tail2_detect_i(jr, ji, 32, 4, interpret=True)
    got = tdet.tail2_detect_i(tr, ti, 32, 4)
    _assert_close(got.numpy(), want, 1e-5, 1e-4)


def test_tail2_detect_single_pol_guard():
    ur = torch.zeros((1, 1, 1, 8, 128))
    with pytest.raises(ValueError, match="2 pols"):
        tdet.tail2_detect(ur, ur, 32, 4, stokes="IQUV")


@pytest.mark.parametrize("n", [16, 64, 128, 4096])
def test_dft_matrices_bitwise(n):
    for a, b in zip(tdft.dft_matrices(n), bdft.dft_matrices(n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n1,n2", [(128, 8192), (128, 64), (16, 32)])
def test_twiddles_bitwise(n1, n2):
    for a, b in zip(tdft.twiddles(n1, n2), bdft.twiddles(n1, n2)):
        np.testing.assert_array_equal(a, b)


def test_default_factors_match():
    for n in (64, 4096, 8192, 1 << 19, 1 << 20, 1 << 22, 3 * 4096):
        assert tdft.default_factors(n) == bdft.default_factors(n)
    assert tdft.default_factors(1 << 20) == (128, 128, 64)


@pytest.mark.parametrize("window", ["hamming", "hanning", "rect"])
def test_pfb_coeffs_bitwise(window):
    np.testing.assert_array_equal(tch.pfb_coeffs(4, 1024, window),
                                  bch.pfb_coeffs(4, 1024, window))


def test_dft_matrix_is_a_table_of_its_first_row():
    # The Hopper kernels read W[k, j] as W[1, (k*j) mod n].
    for n in (64, 128):
        wr, wi = tdft.dft_matrices(n)
        k = np.arange(n)
        idx = (k[:, None] * k[None, :]) % n
        np.testing.assert_array_equal(wr, wr[1][idx])
        np.testing.assert_array_equal(wi, wi[1][idx])


def test_hopper_fit_gates():
    assert tpfb.fits(1 << 20, 128)
    # Any n1 whose tile fits shared memory (8192 = 64·128 too), but one
    # that divides nfft, and two pols.
    assert not tpfb.fits(8192, 96)
    assert not tpfb.fits(1 << 20, 1024)  # the tile of n1 = 1024 does not fit
    assert not tpfb.fits(1 << 20, 128, npol=1)
    for stokes in ("I", "XX", "YY", "XXYY", "full", "IQUV"):
        assert tdet.fits((128, 128, 64), 2, stokes)
    assert not tdet.fits((128, 4096), 2, "I")
    assert not tdet.fits((128, 128, 128), 2, "I")
    assert not tdet.fits((128, 128, 64), 1, "I")
    # dft_tail2 takes the three-factor tails blit's VMEM gate passes
    # (2^20 to 2^23: f3 64 to 512), not 2^24's f3 = 1024.
    for f3 in (64, 128, 256, 512):
        assert tdft.tail2_fits(128, f3)
        assert pallas_dft.tail2_fits(2 * 128, 128, f3)
    assert not tdft.tail2_fits(128, 1024)
    assert not pallas_dft.tail2_fits(2 * 128, 128, 1024)
    assert not tdft.tail2_fits(4, 128)  # fewer rows than the row level's lanes
    assert not tdft.tail2_fits(96, 128)  # not a power of two


def _sign_folded(ntap, nfft):
    sign = np.where(np.arange(nfft) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return bch.pfb_coeffs(ntap, nfft) * sign


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nfft,ntap,nblk", [(8, 4, 40), (256, 4, 6),
                                            (1024, 4, 7), (64, 3, 5)])
def test_pfb_dequant_plain_matches_pallas(nfft, ntap, nblk, dtype):
    rng = np.random.default_rng(nfft)
    v = rng.integers(-128, 128, (3, nblk * nfft, 2, 2), np.int8)
    h = _sign_folded(ntap, nfft)
    want = pallas_pfb.pfb_dequant(jnp.asarray(v), jnp.asarray(h), dtype=dtype,
                                  interpret=True)
    got = tpfb.pfb_dequant(torch.from_numpy(v), torch.from_numpy(h), dtype=dtype)
    scale = max(np.abs(np.asarray(want[0], np.float32)).max(), 1.0)
    tol = 3e-2 if dtype == "bfloat16" else 1e-6
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == w.shape == (3, 2, nblk - ntap + 1, nfft)
        err = np.abs(g.float().numpy() - np.asarray(w, np.float32))
        assert err.max() / scale < tol


def test_pfb_dequant_every_int8_value():
    # tests/test_pallas_pfb.py:44-59: every byte value in every lane
    # through a tap-0 passthrough decodes exactly.
    ramp = np.tile(np.arange(-128, 128, dtype=np.int8), 8)  # 2048 samples
    block = np.stack([ramp, -ramp - 1], axis=-1)
    block = np.stack([block, block[::-1]], axis=-2)[None]  # (1, 2048, 2, 2)
    h = np.zeros((4, 256), np.float32)
    h[0] = 1.0
    fr, fi = tpfb.pfb_dequant_plain(torch.from_numpy(block), torch.from_numpy(h))
    want = block.reshape(1, 8, 256, 2, 2).astype(np.float32)
    for p in (0, 1):
        np.testing.assert_array_equal(fr[0, p].numpy(), want[0, :5, :, p, 0])
        np.testing.assert_array_equal(fi[0, p].numpy(), want[0, :5, :, p, 1])
    jr, ji = pallas_pfb.pfb_dequant(jnp.asarray(block), jnp.asarray(h),
                                    interpret=True)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ji))


def test_pfb_dequant_guards():
    h = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="npol=2"):
        tpfb.pfb_dequant(torch.zeros((1, 64, 1, 2), dtype=torch.int8), h)
    with pytest.raises(ValueError, match="need >= 4 blocks"):
        tpfb.pfb_dequant(torch.zeros((1, 24, 2, 2), dtype=torch.int8), h)
    with pytest.raises(ValueError, match="dtype"):
        tpfb.pfb_dequant(torch.zeros((1, 64, 2, 2), dtype=torch.int8), h,
                         dtype="float16")


def _planar(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _close_dft(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("n,batch", [(8, (4, 3)), (64, (5,)), (96, (3,)),
                                     (1024, (2, 3))])
def test_dft_last_plain_matches_pallas(n, batch):
    xr, xi = _planar(batch + (n,), n)
    w = bdft.dft_matrices(n)
    want = pallas_dft.dft_last(jnp.asarray(xr), jnp.asarray(xi),
                               *(jnp.asarray(a) for a in w), interpret=True)
    got = tdft.dft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                        *(torch.from_numpy(a) for a in w))
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == batch + (n,)
    _close_dft(got, want)


@pytest.mark.parametrize("twiddle", [False, True], ids=["plain", "twiddle"])
@pytest.mark.parametrize("b,n,m", [(3, 16, 256), (2, 8, 96), (2, 128, 64)])
def test_dft_stage_plain_matches_pallas(b, n, m, twiddle):
    xr, xi = _planar((b, n, m), n + m)
    mats = bdft.dft_matrices(n) + (bdft.twiddles(n, m) if twiddle else ())
    want = pallas_dft.dft_stage(jnp.asarray(xr), jnp.asarray(xi),
                                *(jnp.asarray(a) for a in mats), interpret=True)
    got = tdft.dft_stage(torch.from_numpy(xr), torch.from_numpy(xi),
                         *(torch.from_numpy(a) for a in mats))
    _close_dft(got, want)


@pytest.mark.parametrize("f2,f3,batch", [(8, 4, (2, 3)), (16, 8, (3,)),
                                         (32, 128, (2,)), (128, 128, (2,))])
def test_dft_tail2_plain_matches_pallas(f2, f3, batch):
    xr, xi = _planar(batch + (f2 * f3,), f2 + f3)
    want = pallas_dft.dft_tail2(jnp.asarray(xr), jnp.asarray(xi), f2, f3,
                                interpret=True)
    got = tdft.dft_tail2(torch.from_numpy(xr), torch.from_numpy(xi), f2, f3)
    assert got[0].dtype == torch.float32
    assert tuple(got[0].shape) == batch + (f2 * f3,)
    _close_dft(got, want)
    z = np.fft.fft(xr.astype(np.float64) + 1j * xi)  # natural order
    np.testing.assert_allclose(got[0].numpy(), z.real, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), z.imag, rtol=1e-4, atol=1e-3)


def test_dft_tail2_twin_takes_bf16_input_in_f32():
    xr, xi = (torch.from_numpy(a).bfloat16() for a in _planar((2, 512), 9))
    got = tdft.dft_tail2_plain(xr, xi, 16, 32)
    want = tdft.dft_tail2_plain(xr.float(), xi.float(), 16, 32)
    for g, h in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, h, rtol=0, atol=0)
    with pytest.raises(ValueError, match="last axis"):
        tdft.dft_tail2(xr, xi, 16, 16)


def test_dft_plain_twins_take_bf16_input_in_f32():
    # The kernels widen bf16 input to f32 as they load it; so do the twins.
    xr, xi = (torch.from_numpy(a).bfloat16() for a in _planar((3, 16), 5))
    w = tuple(torch.from_numpy(a) for a in bdft.dft_matrices(16))
    got = tdft.dft_last_plain(xr, xi, *w)
    want = tdft.dft_last_plain(xr.float(), xi.float(), *w)
    for g, h in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, h, rtol=0, atol=0)


@pytest.mark.parametrize("n,factors", [(8192, None), (6144, None),
                                       (4096, (8, 16, 32)), (1024, None)],
                         ids=["2-factor", "2-factor-non-pow2", "3-factor",
                              "1-factor"])
def test_dft_kernel_route_matches_blit(n, factors):
    xr, xi = _planar((3, n), n)
    want = bdft.dft(jnp.asarray(xr), jnp.asarray(xi), factors=factors,
                    use_pallas=True)
    got = tdft.dft(torch.from_numpy(xr), torch.from_numpy(xi),
                   factors=factors, use_pallas=True)
    _close_dft(got, want)
    z = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    np.testing.assert_allclose(got[0].numpy(), z.real, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), z.imag, rtol=1e-4, atol=1e-3)


def test_dft_tail_kernel_route_matches_blit():
    # Levels 2.. of a (16, 8, 8) DFT after stage 1: dft_stage then dft_last.
    ur, ui = _planar((2, 16, 64), 11)
    want = bdft.dft_tail(jnp.asarray(ur), jnp.asarray(ui), (16, 8, 8))
    got = tdft.dft_tail(torch.from_numpy(ur), torch.from_numpy(ui), (16, 8, 8),
                        use_pallas=True)
    _close_dft(got, want)
    with pytest.raises(ValueError, match="bf16"):
        tdft.dft_tail(torch.from_numpy(ur), torch.from_numpy(ui), (16, 8, 8),
                      bf16=True, use_pallas=True)


def test_dft_guards():
    x = torch.zeros((2, 12))
    with pytest.raises(ValueError, match="multiply"):
        tdft.dft(x, x, factors=(3, 3))
    with pytest.raises(NotImplementedError, match="factor"):
        tdft.dft(torch.zeros((1, 8194)), torch.zeros((1, 8194)),
                 factors=(2, 4097))
    with pytest.raises(ValueError, match="twiddle"):
        tdft.dft_stage(x.reshape(2, 3, 4), x.reshape(2, 3, 4),
                       *(torch.from_numpy(a) for a in bdft.dft_matrices(3)),
                       tr=torch.zeros((3, 4)))
