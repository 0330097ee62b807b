"""pfb_dft1 and tail2_detect as shared-memory FFTs, and pfb_dft1's widened
Hopper gate, held on the CPU.

The CUDA kernels (blit_torch/csrc/pfb_dft1.cu, tail2_detect.cu) run only
on the card (tests/test_torch_cuda.py).  Here a torch transcription of
their schedules, used only by these tests, follows the same steps:

- pfb_dft1: tiles of ``kernel_geometry(n1)`` (groups of up to 4 frames,
  ``tc`` columns, the last column tile ragged and zero-filled), the FIR
  of every tap in f32 (rounded to bf16 in bf16 mode), the n1-point
  Stockham passes of ``fft_plan(n1)`` down every column with roots taken
  by index from row 1 of ``dft_matrices(n1)``, the twiddle, the store
  of the columns that exist;
- tail2_detect: per panel pair, the f2-point passes down each column,
  the twiddle (rounded to bf16 for bf16 input), the f3-point passes
  along each row, the detect, and the cluster's store: rank r of the 8
  blocks on consecutive k1 writes positions q = k2 + f2·k3 in its eighth
  of the panel for all 8 k1, at q·f1 + k1.

Both are held against blit's Pallas functions run with interpret=True,
at the bounds of tests/test_torch_ops.py (pfb_dft1 f32 rtol 1e-4 / atol
1e-2·max, tail2_detect f32 rtol 1e-5 / atol 1e-4·max, bf16 rtol 0.05 /
atol 0.05·max).  In bf16 the contract also rounds the DFT matrices to
bf16, which an FFT cannot; the transcription keeps f32 roots, and the
bf16 bound holds it.  Also: ``pfb.fits`` admits every (nfft, n1) that
blit's ``fused1_fits`` admits at 7, 19 and 35 blocks; ``detect.fits``
equals blit's ``tail2_detect_fits`` for two pols; and channelize's
"auto" at 6144 resolves pfb_dft1 + dft_last and agrees with blit's
channelize at tests/test_channelize.py:106's rtol 1e-4 / atol 1e-2.
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

NTAP = 4
NFFTS = [1 << k for k in range(13, 25)] + [6144, 12288, 24576, 49152]
STOKES = ["I", "XX", "YY", "XXYY", "full", "IQUV"]
BOUNDS = {"float32": (1e-4, 1e-2), "bfloat16": (0.05, 0.05)}


def _roots(n):
    """Row 1 of the n-point DFT matrix, the kernels' root table."""
    wr, wi = tdft.dft_matrices(n)
    return torch.complex(torch.from_numpy(wr[1].copy()),
                         torch.from_numpy(wi[1].copy()))


def stockham(x, n, plan):
    """fft_smem.cuh's passes on complex64 ``x`` (..., n) → the natural-
    order DFT along the last axis (input q of butterfly j times
    T[q·(j mod Ns)·n/(Ns·R)], the R-point DFT, output r of butterfly j
    to (j div Ns)·Ns·R + j mod Ns + r·Ns)."""
    T = _roots(n)
    ns = 1
    for R in plan:
        L = n // R
        v = x.reshape(x.shape[:-1] + (R, L))
        j = torch.arange(L)
        q = torch.arange(R)[:, None]
        v = v * T[q * (j % ns) * (n // (ns * R))]
        r = torch.arange(R)
        y = torch.einsum("rq,...qj->...rj", T[(r[:, None] * r % R) * L], v)
        x = (y.reshape(x.shape[:-1] + (R, L // ns, ns)).transpose(-3, -2)
             .reshape(x.shape))
        ns *= R
    return x


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def pfb_schedule(v, h, n1, bf16=False):
    """csrc/pfb_dft1.cu's tile schedule on int8 ``v`` (nchan, ntime, 2, 2)
    and the f32 window ``h`` (ntap, nfft) → complex64 (nchan, 2, nframes,
    n1, m)."""
    v = torch.from_numpy(v)
    h = torch.from_numpy(h)
    ntap, nfft = h.shape
    m = nfft // n1
    nchan = v.shape[0]
    nblk = v.shape[1] // nfft
    nframes = nblk - ntap + 1
    geo = tpfb.kernel_geometry(n1, ntap)
    tc, fg = geo["tc"], geo["fg"]
    tr, ti = (torch.from_numpy(a) for a in tdft.twiddles(n1, m))
    tw = torch.complex(tr, ti)
    out = torch.zeros((nchan, 2, nframes, n1, m), dtype=torch.complex64)
    w = h.reshape(ntap, n1, m)
    for c in range(nchan):
        blocks = v[c].reshape(nblk, n1, m, 2, 2).to(torch.float32)
        for f0 in range(0, nframes, fg):
            nf = min(fg, nframes - f0)
            for c0 in range(0, m, tc):
                cols = min(tc, m - c0)
                x = torch.zeros((nf + ntap - 1, n1, tc, 2, 2))
                x[:, :, :cols] = blocks[f0:f0 + nf + ntap - 1, :, c0:c0 + cols]
                wt = torch.zeros((ntap, n1, tc))
                wt[:, :, :cols] = w[:, :, c0:c0 + cols]
                fir = sum(wt[k][:, :, None, None] * x[k:k + nf]
                          for k in range(ntap))  # (nf, n1, tc, pol, re/im)
                if bf16:
                    fir = _bf16(fir)
                z = torch.complex(fir[..., 0], fir[..., 1])  # (nf, n1, tc, pol)
                z = stockham(z.permute(3, 0, 2, 1), n1, geo["plan"])
                z = z.transpose(-1, -2)[..., :cols] * tw[:, c0:c0 + cols]
                out[c, :, f0:f0 + nf, :, c0:c0 + cols] = z
    return out


def detect_schedule(ur, ui, f2, f3, stokes, bf16=False):
    """csrc/tail2_detect.cu's schedule on stage-1 spectra (nchan, 2,
    nframes, f1, f2·f3) → f32 (nframes, nif, nchan, f1·f2·f3), written as
    the cluster writes it."""
    nchan, _, nframes, f1, _ = ur.shape
    x = torch.complex(ur.float(), ui.float()).reshape(
        nchan, 2, nframes, f1, f2, f3)
    y = stockham(x.transpose(-1, -2), f2, tdft.fft_plan(f2)).transpose(-1, -2)
    tr, ti = (torch.from_numpy(a) for a in tdft.twiddles(f2, f3))
    y = y * torch.complex(tr, ti)
    if bf16:
        y = torch.complex(_bf16(y.real), _bf16(y.imag))
    z = stockham(y, f3, tdft.fft_plan(f3))  # z[..., k2, k3]
    # z[k2][k3] read along q = k2 + f2·k3, as the row level stores it.
    z = z.transpose(-1, -2).reshape(nchan, 2, nframes, f1 * f2 * f3)
    planes = tdet.detect_stokes_planar(z.real, z.imag, stokes)
    nif = planes.shape[1]
    q = planes.reshape(nchan, nif, nframes, f1, f2 * f3)
    out = torch.empty((nframes, nif, nchan, f1 * f2 * f3))
    cl, part = 8, f2 * f3 // 8
    for g in range(f1 // cl):
        for rank in range(cl):
            qs = torch.arange(rank * part, (rank + 1) * part)
            for kr in range(cl):
                k1 = g * cl + kr
                out[:, :, :, qs * f1 + k1] = q[:, :, :, k1, qs].permute(2, 1, 0, 3)
    return out


def _pfb_inputs(nfft, n1, nchan=2, nblk=6, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.integers(-128, 128, (nchan, nblk * nfft, 2, 2), np.int8)
    sign = np.where(np.arange(nfft) % 2 == 0, 1.0, -1.0).astype(np.float32)
    h = bch.pfb_coeffs(NTAP, nfft) * sign
    return v, h, bdft.dft_matrices(n1) + bdft.twiddles(n1, nfft // n1)


def _close(got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nfft,n1,nblk", [
    (6144, 64, 9), (12288, 96, 6), (49152, 192, 5), (8192, 128, 4),
    (6400, 64, 5)],
    ids=["6144", "12288", "49152", "8192", "m100-ragged"])
def test_pfb_schedule_matches_blit_pfb_dft1(nfft, n1, nblk, dtype):
    # 9 blocks at 6144: 6 frames, a group of 4 and a group of 2; m = 100
    # at 6400 leaves a last column tile of 4.
    v, h, mats = _pfb_inputs(nfft, n1, nblk=nblk, seed=n1)
    want = pallas_pfb.pfb_dft1(jnp.asarray(v), jnp.asarray(h),
                               *(jnp.asarray(m) for m in mats), dtype=dtype,
                               interpret=True)
    got = pfb_schedule(v, h, n1, bf16=dtype == "bfloat16")
    if dtype == "bfloat16":
        got = torch.complex(_bf16(got.real), _bf16(got.imag))
    rtol, atol = BOUNDS[dtype]
    _close(got.real, want[0].astype(np.float32), rtol, atol)
    _close(got.imag, want[1].astype(np.float32), rtol, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stokes", ["I", "IQUV"])
def test_detect_schedule_matches_blit_tail2_detect(stokes, dtype):
    rng = np.random.default_rng(3)
    shape = (2, 2, 2, 8, 128 * 64)
    ur = rng.standard_normal(shape).astype(np.float32)
    ui = rng.standard_normal(shape).astype(np.float32)
    jr, ji = jnp.asarray(ur), jnp.asarray(ui)
    tr, ti = torch.from_numpy(ur), torch.from_numpy(ui)
    if dtype == "bfloat16":
        jr, ji = jr.astype(jnp.bfloat16), ji.astype(jnp.bfloat16)
        tr, ti = tr.bfloat16(), ti.bfloat16()
    want = pallas_detect.tail2_detect(jr, ji, 128, 64, stokes=stokes,
                                      tile_f1=8, interpret=True)
    got = detect_schedule(tr, ti, 128, 64, stokes, bf16=dtype == "bfloat16")
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else BOUNDS[dtype]
    _close(got, want, rtol, atol)
    # The twin (the CPU path) agrees with the schedule at the same bound.
    _close(got, tdet.tail2_detect(tr, ti, 128, 64, stokes=stokes), rtol, atol)


@pytest.mark.parametrize("nblk", [7, 19, 35])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pfb_gate_admits_every_n1_blit_fused1_admits(nblk, dtype):
    admitted = set()
    for nfft in NFFTS:
        factors = bdft.default_factors(nfft)
        assert tdft.default_factors(nfft) == factors
        n1 = factors[0]
        if pallas_pfb.fused1_fits(nfft, nblk, NTAP, n1, dtype):
            assert tpfb.fits(nfft, n1, 2, NTAP), (nfft, n1)
            admitted.add(n1)
    assert 128 in admitted
    if nblk == 7:
        assert admitted == {64, 96, 128, 192}


def test_detect_gate_equals_blit_tail2_detect_fits():
    shapes = {bdft.default_factors(n) for n in NFFTS}
    shapes |= {(8, 128, 64), (16, 128, 64)}
    admitted = 0
    for factors in sorted(shapes):
        for stokes in STOKES:
            for esize in (4, 2):
                want = pallas_detect.tail2_detect_fits(factors, 2, esize,
                                                       stokes=stokes)
                assert tdet.fits(factors, 2, stokes) == want, (factors, stokes)
                admitted += want
    assert admitted == 6 * 2 * 3  # (128, 128, 64), (8, ...), (16, ...)


def test_pfb_gate_and_geometry():
    geo = tpfb.kernel_geometry(128)
    assert (geo["tc"], geo["fg"], geo["nstage"], geo["plan"]) == (
        16, 4, 1, (16, 8))
    assert geo["per_round"] * 128 <= tpfb.KERNEL_ROUND
    assert geo["smem"] <= tpfb.HOPPER_SMEM_MAX
    for n1 in (2, 6, 64, 96, 192, 592):
        geo = tpfb.kernel_geometry(n1)
        assert geo["smem"] <= tpfb.HOPPER_SMEM_MAX
        assert 1 <= geo["per_round"] <= geo["fg"] * 2 * geo["tc"]
        assert geo["per_round"] * n1 <= tpfb.KERNEL_ROUND
    assert tpfb.kernel_geometry(593) is None
    assert tpfb.kernel_geometry(1) is None
    # More taps stage more int8 blocks: the widest n1 narrows.
    assert tpfb.kernel_geometry(300, ntap=16) is None
    assert tpfb.fits(6144, 64) and tpfb.fits(12288, 96)
    assert not tpfb.fits(6144, 100)  # does not divide nfft
    assert not tpfb.fits(6144, 64, npol=1)


def test_6144_resolves_pfb_dft1():
    route, factors, rec = tch._resolve_plan(6144, 2, "I")
    assert (route, factors) == ("fused1", (64, 96))
    assert (rec["pfb_kernel"], rec["tail_kernel"]) == ("fused1", "dft_last")
    route, _, rec = tch._resolve_plan(6144, 2, "I", pfb_kernel="fused1")
    assert rec["pfb_kernel"] == "fused1"
    # Route (b) is twisted: fused1 emits natural order, so pfb_dequant.
    _, _, rec = tch._resolve_plan(6144, 2, "I", dft_order="twisted")
    assert (rec["pfb_kernel"], rec["dft_order"]) == ("pallas", "twisted")


@pytest.mark.parametrize("stokes", ["I", "IQUV"])
def test_channelize_6144_auto_matches_blit(stokes):
    nfft, nint = 6144, 2
    rng = np.random.default_rng(61)
    v = rng.integers(-128, 128, (2, (NTAP - 1 + 2 * nint) * nfft, 2, 2),
                     np.int8)
    h = bch.pfb_coeffs(NTAP, nfft)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["tail_kernel"]) == ("fused1", "dft_last")
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h),
                                     nfft=nfft, nint=nint, stokes=stokes,
                                     fft_method="matmul",
                                     pfb_kernel="fused1"))
    assert bch.last_kernel_plan()["pfb_kernel"] == "fused1"
    assert got.shape == want.shape == (2, 4 if stokes == "IQUV" else 1,
                                       2 * nfft)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-2 * np.abs(want).max())
