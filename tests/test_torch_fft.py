"""The shared-memory FFTs of dft_last and dft_tail2, their plans and gates,
held on the CPU.

The CUDA kernels (blit_torch/csrc/dft.cu, dft_tail2.cu, fft_smem.cuh) run
only on the card (tests/test_torch_cuda.py).  Here a torch transcription
of their schedule, used only by these tests, follows the same steps: the
radices of ``fft_plan(n)`` in pass order, Stockham passes whose input q of
butterfly j takes the root T[q·(j mod Ns)·n/(Ns·R)], the R-point DFT with
roots T[(r·q mod R)·n/R], output r written to (j div Ns)·Ns·R + j mod Ns
+ r·Ns; every root an entry of row 1 of ``dft_matrices(n)``, taken by
index; f32 (complex64) arithmetic as on the card.  It is held against
``np.fft.fft`` in float64 and against blit's dft_last / dft_tail2 run with
interpret=True, at blit's bound (tests/test_pallas_dft.py:22-33: rtol
1e-4, atol 1e-3 on unit-variance input).  Also: fft_plan covers every
n <= 4096, the widened tail2_fits agrees with blit's gate on every
three-factor default_factors shape, and channelize's "auto" takes
torch.fft for an nfft default_factors cannot split (2 × 4099), held
against blit's channelize at tests/test_channelize.py:106's rtol 1e-4 /
atol 1e-2.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import channelize as bch  # noqa: E402
from blit.ops import dft as bdft  # noqa: E402
from blit.ops import pallas_dft  # noqa: E402
from blit_torch.ops import channelize as tch  # noqa: E402
from blit_torch.ops import dft as tdft  # noqa: E402

NTAP = 4


def _roots(n):
    """Row 1 of the n-point DFT matrix, the kernels' root table."""
    wr, wi = tdft.dft_matrices(n)
    return torch.complex(torch.from_numpy(wr[1].copy()),
                         torch.from_numpy(wi[1].copy()))


def stockham(x, n, plan):
    """The kernels' pass schedule on complex64 ``x`` (..., n) → the
    natural-order DFT along the last axis."""
    T = _roots(n)
    ns = 1
    for R in plan:
        L = n // R
        tstep = n // (ns * R)
        v = x.reshape(x.shape[:-1] + (R, L))  # v[q, j] = x[j + q L]
        j = torch.arange(L)
        q = torch.arange(R)[:, None]
        v = v * T[q * (j % ns) * tstep]
        r = torch.arange(R)
        y = torch.einsum("rq,...qj->...rj", T[(r[:, None] * r % R) * L], v)
        # Output r of butterfly j = a·Ns + s lands at a·Ns·R + r·Ns + s.
        x = (y.reshape(x.shape[:-1] + (R, L // ns, ns)).transpose(-3, -2)
             .reshape(x.shape))
        ns *= R
    return x


def tail2_schedule(x, f2, f3):
    """dft_tail2's schedule on complex64 panels ``(..., f2·f3)``: the
    f2-point FFT down each column, the (f2, f3) twiddle, the f3-point FFT
    along each row, stored at k3·f2 + k2."""
    p = x.reshape(x.shape[:-1] + (f2, f3))
    u = stockham(p.transpose(-1, -2), f2, tdft.fft_plan(f2)).transpose(-1, -2)
    tr, ti = tdft.twiddles(f2, f3)
    u = u * torch.complex(torch.from_numpy(tr), torch.from_numpy(ti))
    v = stockham(u, f3, tdft.fft_plan(f3))
    return v.transpose(-1, -2).reshape(x.shape)


def _planar(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _close(got, want):
    np.testing.assert_allclose(np.real(got), np.real(want), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.imag(got), np.imag(want), rtol=1e-4, atol=1e-3)


LAST_N = [4, 6, 8, 16, 64, 80, 96, 512, 1024, 2049, 4096]


@pytest.mark.parametrize("n", LAST_N)
def test_schedule_matches_numpy_and_blit_dft_last(n):
    rows = 3 if n > 1024 else 8
    xr, xi = _planar((rows, n), n)
    got = stockham(torch.complex(torch.from_numpy(xr), torch.from_numpy(xi)),
                   n, tdft.fft_plan(n)).numpy()
    _close(got, np.fft.fft(xr.astype(np.float64) + 1j * xi))
    w = bdft.dft_matrices(n)
    want = pallas_dft.dft_last(jnp.asarray(xr), jnp.asarray(xi),
                               *(jnp.asarray(a) for a in w), interpret=True)
    _close(got, np.asarray(want[0]) + 1j * np.asarray(want[1]))


@pytest.mark.parametrize("f2,f3", [(128, 64), (128, 128), (128, 256)])
def test_schedule_matches_numpy_and_blit_dft_tail2(f2, f3):
    xr, xi = _planar((2, f2 * f3), f2 + f3)
    got = tail2_schedule(torch.complex(torch.from_numpy(xr),
                                       torch.from_numpy(xi)), f2, f3).numpy()
    _close(got, np.fft.fft(xr.astype(np.float64) + 1j * xi))
    want = pallas_dft.dft_tail2(jnp.asarray(xr), jnp.asarray(xi), f2, f3,
                                interpret=True)
    _close(got, np.asarray(want[0]) + 1j * np.asarray(want[1]))


def test_fft_plan_covers_every_n_to_direct_dft_max():
    register = {2, 3, 4, 5, 7, 8, 16}
    top = tdft.DIRECT_DFT_MAX
    sieve = np.ones(top + 1, bool)
    sieve[:2] = False
    for p in range(2, int(top ** 0.5) + 1):
        sieve[p * p::p] = False
    for n in range(2, top + 1):
        plan = tdft.fft_plan(n)
        assert int(np.prod(plan)) == n, n
        pow2 = [r for r in plan if r & (r - 1) == 0]
        # Powers of two first, largest first, none above 16, as few
        # passes as 16 allows.
        assert plan[:len(pow2)] == tuple(sorted(pow2, reverse=True)), n
        assert all(r <= 16 for r in pow2)
        k = (n & -n).bit_length() - 1
        assert len(pow2) == -(-k // 4), n
        # The rest: primes in increasing order, 3, 5, 7 in registers.
        odd = plan[len(pow2):]
        assert list(odd) == sorted(odd), n
        assert all(r in register or sieve[r] for r in odd)
    assert tdft.fft_plan(1024) == (16, 8, 8)
    assert tdft.fft_plan(96) == (8, 4, 3)
    assert tdft.fft_plan(2049) == (3, 683)
    with pytest.raises(ValueError):
        tdft.fft_plan(1)


def test_dft_last_designs_and_geometry():
    assert tdft.dft_last_design(8) in ("rows", "fft")
    for n in (2, 4, 6, 16, 96, 1024, 2049, 4096):
        assert tdft.dft_last_design(n) == "fft"
        rows, nstage, smem = tdft.last_fft_geometry(n, 4)
        assert rows == max(1, 4096 // n) and rows * n <= 4096
        assert nstage == 2 and smem <= tdft.SMEM_MAX
        # bf16 stages half the bytes and adds an f32 work buffer.
        assert tdft.last_fft_geometry(n, 2)[2] <= tdft.SMEM_MAX
    assert tdft.dft_last_design(1) == "tiled"


def test_widened_tail2_gate_agrees_with_blit_on_default_factors():
    shapes = [tdft.default_factors(1 << k) for k in range(20, 27)]
    assert [s[2] for s in shapes] == [64, 128, 256, 512, 1024, 2048, 4096]
    for f1, f2, f3 in shapes:
        for dtype in ("float32", "bfloat16"):
            assert tdft.tail2_fits(f2, f3) == pallas_dft.tail2_fits(
                2 * f1, f2, f3, dtype), (f2, f3, dtype)
    assert tdft.tail2_fits(128, 64) and not tdft.tail2_fits(128, 1024)


@pytest.mark.parametrize("f2,f3", [(128, 64), (128, 128), (128, 256),
                                   (128, 512), (8, 512), (1024, 128), (16, 128)])
def test_tail2_geometry(f2, f3):
    for esize in (4, 2):
        geo = tdft.tail2_geometry(f2, f3, esize)
        assert geo["plans"] == (tdft.fft_plan(f2), tdft.fft_plan(f3))
        assert all(s <= tdft.SMEM_MAX for s in geo["smem"])
        if geo["launches"] == 1:
            assert (geo["ct"], geo["rt"]) == (f3, f2)
            assert f2 * f3 <= tdft.TAIL2_ONE_PASS
        else:
            assert f3 % geo["ct"] == 0 and f2 % geo["rt"] == 0
            assert geo["ct"] * f2 <= 8192 and geo["rt"] * f3 <= 8192
    # 2^20 and 2^21 read each panel once; 2^22 and 2^23 go through a
    # scratch panel.
    assert tdft.tail2_geometry(128, 128, 4)["launches"] == 1
    assert tdft.tail2_geometry(128, 256, 4)["launches"] == 2
    with pytest.raises(ValueError, match="Hopper geometry"):
        tdft.tail2_geometry(128, 1024, 4)


@pytest.mark.parametrize("npol", [1, 2])
def test_auto_takes_torch_fft_where_default_factors_cannot_split(npol):
    # ROADMAP Queue 3 item 1: 2 × a prime above DIRECT_DFT_MAX.  blit off
    # the TPU resolves "auto" to "four_step" above 8192; so does the port.
    nfft, nint = 2 * 4099, 2
    rng = np.random.default_rng(8 + npol)
    v = rng.integers(-40, 40, (2, (NTAP - 1 + 2 * nint) * nfft, npol, 2), np.int8)
    h = bch.pfb_coeffs(NTAP, nfft)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["tail_kernel"]) == ("four_step", "torch")
    assert plan["pfb_kernel"] == ("pallas" if npol == 2 else "torch")
    want = np.asarray(bch.channelize(v, h, nfft=nfft, ntap=NTAP, nint=nint))
    assert bch.last_kernel_plan()["fft_method"] == "four_step"
    assert got.shape == want.shape == (2, 1, 2 * nfft)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    with pytest.raises(NotImplementedError, match="factorization"):
        tch.channelize(v, h, nfft=nfft, nint=nint, fft_method="matmul",
                       device="cpu")


def test_resolve_fft_method_off_the_tpu_sizes():
    assert tch.resolve_fft_method("auto") == "matmul"
    assert tch.resolve_fft_method("auto", 1 << 20) == "matmul"
    assert tch.resolve_fft_method("auto", 2 * 4099) == "four_step"
    assert tch.resolve_fft_method("auto", 2 * 4093) == "matmul"  # (2, 4093)
    assert tch.resolve_fft_method("auto", 4099) == "direct"  # prime, <= 8192
    assert tch.resolve_fft_method("matmul", 2 * 4099) == "matmul"
    with pytest.raises(ValueError, match="fft method"):
        tch.resolve_fft_method("bluestein", 64)
