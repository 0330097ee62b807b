"""The port's kernel ops (blit_torch.ops) held against blit's.

The plain PyTorch twins of the two Hopper kernels run here on the CPU
against blit's Pallas functions in interpret mode, on the same numpy-
seeded inputs, at the tolerances blit's own tests use:

- pfb_dft1: f32 rtol 1e-4 / atol 1e-2·max (tests/test_pallas_pfb.py:105),
  bf16 rtol 0.05 / atol 0.05·max (tests/test_pallas_detect.py:147).
- tail2_detect: f32 rtol 1e-5 / atol 1e-4·max (tests/test_pallas_detect.py
  :104, :130), bf16 as above.

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
from blit.ops import pallas_detect, pallas_pfb  # noqa: E402
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
@pytest.mark.parametrize("nfft,n1", [(512, 16), (8192, 128)])
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
    assert not tpfb.fits(8192, 64)
    assert not tpfb.fits(1 << 20, 128, npol=1)
    for stokes in ("I", "XX", "YY", "XXYY", "full", "IQUV"):
        assert tdet.fits((128, 128, 64), 2, stokes)
    assert not tdet.fits((128, 4096), 2, "I")
    assert not tdet.fits((128, 128, 128), 2, "I")
    assert not tdet.fits((128, 128, 64), 1, "I")
