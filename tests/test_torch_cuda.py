"""The Hopper kernels against their plain twins, on a CUDA device.

Each test is marked ``cuda`` and skips without a GPU.  On the card:
``python -m pytest tests/test_torch_cuda.py -m cuda -s`` (``-s`` shows
the compiler's register and shared-memory report).  Bounds as
tests/test_torch_ops.py: pfb_dft1 f32 rtol 1e-4 / atol 1e-2·max,
tail2_detect f32 rtol 1e-5 / atol 1e-4·max, bf16 rtol 0.05 / atol
0.05·max; pfb_dequant atol 1e-6 (f32) / 3e-2 (bf16) of max(peak, 1)
(tests/test_pallas_pfb.py:24-42); dft_last and dft_stage rtol 1e-4 /
atol 1e-3 on unit-variance input (tests/test_pallas_dft.py:22-33), and
dft_tail2 the same (:86-100) with atol grown as sqrt(f2·f3 / 128);
channelize against its plan run through the twins, rtol 1e-4 / atol
1e-2·max (tests/test_pallas_detect.py:150-198); taylor_tree bitwise
(torch.equal) against its plain version, as blit holds its Pallas kernel
to its reference (tests/test_dedoppler.py:85).  f32 twins run with TF32
off.
"""

import numpy as np
import pytest
import torch

from blit_torch import kernels
from blit_torch.ops import channelize as tch
from blit_torch.ops import dedoppler as tpd
from blit_torch.ops import detect as tdet
from blit_torch.ops import dft as tdft
from blit_torch.ops import pfb as tpfb

NFFT = 1 << 20
BOUNDS = {"float32": (1e-4, 1e-2), "bfloat16": (0.05, 0.05)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol, atol_frac):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    atol = atol_frac * want.abs().max().item()
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), err.max().item()


def _inputs(dev, nchan=2, nblk=6, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.integers(-128, 128, (nchan, nblk * NFFT, 2, 2), np.int8)
    sign = np.where(np.arange(NFFT) % 2 == 0, 1.0, -1.0).astype(np.float32)
    h = tch.pfb_coeffs(4, NFFT) * sign
    mats = tdft.dft_matrices(128) + tdft.twiddles(128, NFFT // 128)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (v, h) + mats]


@pytest.mark.cuda
def test_kernels_build(dev):
    for name, log in kernels.build_all().items():
        print(f"--- {name}\n{log}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pfb_dft1_matches_plain(dev, dtype):
    args = _inputs(dev)
    n0 = tpfb.pfb_dft1.launches
    got = tpfb.pfb_dft1(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert tpfb.pfb_dft1.launches == n0 + 1
    want = tpfb.pfb_dft1_plain(*args, dtype=dtype)
    for g, w in zip(got, want):
        _close(g, w, *BOUNDS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stokes", ["I", "XX", "YY", "XXYY", "full", "IQUV"])
def test_tail2_detect_matches_plain(dev, stokes, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (2, 2, 3, 128, 128 * 64)
    ur = torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
    ui = torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
    got = tdet.tail2_detect(ur, ui, 128, 64, stokes=stokes)
    torch.cuda.synchronize()
    want = tdet.tail2_detect_plain(ur, ui, 128, 64, stokes=stokes)
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else BOUNDS[dtype]
    _close(got, want, rtol, atol)


@pytest.mark.cuda
def test_channelize_runs_the_kernels(dev):
    v, h = _inputs(dev, nchan=2, nblk=5)[:2]
    coeffs = torch.from_numpy(tch.pfb_coeffs(4, NFFT)).to(dev)
    out = tch.channelize(v, coeffs, nfft=NFFT, stokes="IQUV", device=dev)
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["tail_kernel"], plan["impl"]) == (
        "fused1", "tail2_detect", "cuda")
    assert out.shape == (2, 4, 2 * NFFT) and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tch.channelize(v[:, : 5 * 1024, :1], coeffs[:, :1024], nfft=1024,
                       device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nfft,ntap,nblk", [
    (8, 4, 700), (1024, 4, 40), (8, 1, 50), (64, 9, 30), (96, 3, 20)])
def test_pfb_dequant_matches_plain(dev, nfft, ntap, nblk, dtype):
    rng = np.random.default_rng(nfft + ntap)
    v = torch.from_numpy(rng.integers(-128, 128, (3, nblk * nfft, 2, 2),
                                      np.int8)).to(dev)
    h = torch.from_numpy(tch.pfb_coeffs(ntap, nfft)).to(dev)
    n0 = tpfb.pfb_dequant.launches
    got = tpfb.pfb_dequant(v, h, dtype=dtype)
    torch.cuda.synchronize()
    assert tpfb.pfb_dequant.launches == n0 + 1
    want = tpfb.pfb_dequant_plain(v, h, dtype=dtype)
    tol = 1e-6 if dtype == "float32" else 3e-2
    scale = max(max(w.float().abs().max().item() for w in want), 1.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() / scale < tol


def _planar(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,rows", [(4, 1000), (8, 5000), (16, 999),
                                    (64, 4097), (80, 130), (1024, 300),
                                    (6, 333), (2049, 70)])
def test_dft_last_matches_plain(dev, n, rows, dtype):
    xr, xi = _planar(dev, (rows, n), dtype, n)
    w = tdft.as_tensors(tdft.dft_matrices(n), dev)
    n0 = tdft.dft_last.launches
    got = tdft.dft_last(xr, xi, *w)
    torch.cuda.synchronize()
    assert tdft.dft_last.launches == n0 + 1
    for g, want in zip(got, tdft.dft_last_plain(xr, xi, *w)):
        _close(g, want, 1e-4, 1e-3 / want.abs().max().item())


@pytest.mark.cuda
def test_dft_last_row_kernel_and_tile_agree_at_n8(dev):
    # n = 8 takes the row kernel; the tiled GEMM (timed beside it by
    # chip_smoke.py) computes the same function.
    xr, xi = _planar(dev, (5000, 8), torch.float32, 8)
    w = tdft.as_tensors(tdft.dft_matrices(8), dev)
    rows = tdft.dft_last_cuda(xr, xi, *w)
    tiled = tdft.dft_last_cuda(xr, xi, *w, tiled=True)
    for a, b, want in zip(rows, tiled, tdft.dft_last_plain(xr, xi, *w)):
        _close(a, want, 1e-4, 1e-3 / want.abs().max().item())
        _close(b, want, 1e-4, 1e-3 / want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f2,f3", [(40, 128, 128), (3, 128, 256),
                                     (5, 128, 512), (7, 32, 128),
                                     (2, 1024, 128), (4, 8, 512)])
def test_dft_tail2_matches_plain(dev, b, f2, f3, dtype):
    xr, xi = _planar(dev, (b, f2 * f3), dtype, f2 + f3)
    n0 = tdft.dft_tail2.launches
    got = tdft.dft_tail2(xr, xi, f2, f3)
    torch.cuda.synchronize()
    assert tdft.dft_tail2.launches == n0 + 1
    # blit's bound holds for its tests' panels (m = f2·f3 <= 128 points of
    # unit variance); an m-point DFT's outputs, and the f32 rounding of
    # their sums, grow as sqrt(m), and so does the atol here.
    atol = 1e-3 * (f2 * f3 / 128) ** 0.5
    for g, want in zip(got, tdft.dft_tail2_plain(xr, xi, f2, f3)):
        assert g.dtype == torch.float32
        _close(g, want, 1e-4, atol / want.abs().max().item())
    with pytest.raises(ValueError, match="Hopper kernel"):
        tdft.dft_tail2(xr[:, :16 * 128].contiguous(),
                       xi[:, :16 * 128].contiguous(), 16, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("twiddle", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m", [(40, 128, 128), (3, 75, 80), (5, 16, 256),
                                   (3, 2, 2049)])
def test_dft_stage_matches_plain(dev, b, n, m, dtype, twiddle):
    xr, xi = _planar(dev, (b, n, m), dtype, n + m)
    mats = tdft.as_tensors(tdft.dft_matrices(n), dev)
    if twiddle:
        mats += tdft.as_tensors(tdft.twiddles(n, m), dev)
    n0 = tdft.dft_stage.launches
    got = tdft.dft_stage(xr, xi, *mats)
    torch.cuda.synchronize()
    assert tdft.dft_stage.launches == n0 + 1
    for g, want in zip(got, tdft.dft_stage_plain(xr, xi, *mats)):
        _close(g, want, 1e-4, 1e-3 / want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,nint,nchan,plan", [
    (8, 128, 4, ("pallas", "dft_last")),
    (1024, 16, 4, ("pallas", "dft_last")),
    (1 << 13, 1, 2, ("fused1", "dft_last")),
    (6144, 2, 2, ("pallas", "dft_stage+dft_last")),
    (4098, 1, 1, ("pallas", "dft_stage+dft_last")),
    (1 << 21, 1, 1, ("fused1", "dft_tail2")),
    (1 << 24, 1, 1, ("fused1", "dft_stage+dft_last")),
], ids=["0001", "nfft1024", "2^13", "6144", "4098", "2^21", "2^24"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channelize_new_plans_run_the_kernels(dev, nfft, nint, nchan, plan,
                                              dtype):
    rng = np.random.default_rng(nfft)
    v = torch.from_numpy(rng.integers(-128, 128, (nchan, (3 + 2 * nint) * nfft,
                                                  2, 2), np.int8)).to(dev)
    h = torch.from_numpy(tch.pfb_coeffs(4, nfft)).to(dev)
    wrappers = (tpfb.pfb_dequant, tdft.dft_stage, tdft.dft_last,
                tdft.dft_tail2)
    counts = [fn.launches for fn in wrappers]
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes="IQUV",
                         dtype=dtype, device=dev)
    torch.cuda.synchronize()
    p = tch.last_kernel_plan()
    assert (p["pfb_kernel"], p["tail_kernel"], p["impl"]) == plan + ("cuda",)
    ran = [fn.launches - c for fn, c in zip(wrappers, counts)]
    assert ran[0] == (plan[0] == "pallas")
    assert ran[1] > 0 if "dft_stage" in plan[1] else ran[1] == 0
    assert ran[2:] == ([0, 1] if plan[1] == "dft_tail2" else [1, 0])
    want = tch.channelize_twins(v, h, nfft=nfft, nint=nint, stokes="IQUV",
                                dtype=dtype, device=dev)
    assert tch.last_kernel_plan()["impl"] == "plain"
    assert got.shape == want.shape == (2, 4, nchan * nfft)
    _close(got, want, 1e-4, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [257, 70001])
@pytest.mark.parametrize("T", [1 << k for k in range(1, 11)])
def test_taylor_tree_bitwise_equal_to_plain(dev, T, F):
    # Every window blit allows, on both kernel routes, at a width that is
    # a multiple of no tile; both signs through drift_spectra.
    rng = np.random.default_rng(T + F)
    x = torch.from_numpy(rng.normal(50.0, 5.0, (T, F)).astype(np.float32)).to(dev)
    launches = tpd.kernel_route(T)[1]
    n0 = tpd.taylor_tree.launches
    got = tpd.taylor_tree(x)
    both = tpd.drift_spectra(x)
    torch.cuda.synchronize()
    assert tpd.taylor_tree.launches == n0 + 2 * launches
    assert torch.equal(got, tpd.taylor_tree_plain(x))
    assert both.shape == (2 * T - 1, F)
    assert torch.equal(both, tpd.drift_spectra_plain(x))


@pytest.mark.cuda
def test_taylor_tree_refuses_windows_no_route_takes(dev):
    for T in (1, 3, 2048):
        with pytest.raises(ValueError, match="window_spectra"):
            tpd.drift_spectra(torch.zeros((T, 64), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("nbands,max_drift", [(1, None), (4, 5), (64, None)])
def test_dedoppler_hits_on_the_card_match_the_cpu(dev, nbands, max_drift):
    T, F = 64, 1 << 14
    rng = np.random.default_rng(nbands)
    x = rng.normal(50.0, 5.0, (T, F)).astype(np.float32)
    for t in range(T):
        x[t, 300 + tpd.tree_path_shift(3, t, T)] += 60.0
    n0 = tpd.taylor_tree.launches
    got = tpd.dedoppler_hits(torch.from_numpy(x).to(dev), 5.0, top_k=8,
                             nbands=nbands, max_drift_bins=max_drift)
    assert tpd.taylor_tree.launches == n0 + 1
    want = tpd.dedoppler_hits(torch.from_numpy(x), 5.0, top_k=8, nbands=nbands,
                              max_drift_bins=max_drift)
    g = tpd.unpack_hits(got.cpu().numpy())
    w = tpd.unpack_hits(want.numpy())
    assert len(g[0]) > 0
    for a, b in zip(g[2:], w[2:]):  # drift, chan, band
        assert np.array_equal(a, b)
    assert np.array_equal(g[1], w[1])  # power: the same cells of equal trees
    np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
