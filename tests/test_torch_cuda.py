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
1e-2·max (tests/test_pallas_detect.py:150-198); detect_untwist_i rtol
1e-6 / atol 1e-5 (tests/test_pallas_detect.py:22-39: the same squares
and adds in the same order); taylor_tree bitwise
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


def _inputs(dev, nchan=2, nblk=6, seed=0, nfft=NFFT, n1=128, ntap=4):
    rng = np.random.default_rng(seed)
    v = rng.integers(-128, 128, (nchan, nblk * nfft, 2, 2), np.int8)
    sign = np.where(np.arange(nfft) % 2 == 0, 1.0, -1.0).astype(np.float32)
    h = tch.pfb_coeffs(ntap, nfft) * sign
    mats = tdft.dft_matrices(n1) + tdft.twiddles(n1, nfft // n1)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (v, h) + mats]


@pytest.mark.cuda
def test_kernels_build(dev):
    for name, log in kernels.build_all().items():
        print(f"--- {name}\n{log}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nfft,n1,nblk,ntap", [
    (NFFT, 128, 6, 4), (128 * 100, 128, 6, 4), (6144, 64, 9, 4),
    (64 * 100, 64, 6, 4), (12288, 96, 6, 4), (96 * 100, 96, 6, 4),
    (49152, 192, 6, 4), (192 * 100, 192, 6, 4), (6 * 1367, 6, 6, 4),
    (8192, 128, 6, 3), (6144, 64, 4, 1)],
    ids=["2^20", "128-ragged", "6144", "64-ragged", "12288", "96-ragged",
         "49152", "192-ragged", "6-odd-m", "3-taps", "1-tap"])
def test_pfb_dft1_matches_plain(dev, dtype, nfft, n1, nblk, ntap):
    # m = 100 leaves a ragged last column tile; 9 blocks make 6 frames, a
    # group of 4 and one of 2; m = 1367 is odd (4-byte copies); other tap
    # counts than 4 take the FIR whose taps are read at run time.
    args = _inputs(dev, nblk=nblk, nfft=nfft, n1=n1, ntap=ntap)
    assert tpfb.fits(nfft, n1, ntap=ntap)
    n0 = tpfb.pfb_dft1.launches
    got = tpfb.pfb_dft1(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert tpfb.pfb_dft1.launches == n0 + 1
    want = tpfb.pfb_dft1_plain(*args, dtype=dtype)
    for g, w in zip(got, want):
        _close(g, w, *BOUNDS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("f1", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stokes", ["I", "XX", "YY", "XXYY", "full", "IQUV"])
def test_tail2_detect_matches_plain(dev, stokes, dtype, f1):
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (2, 2, 3, f1, 128 * 64)
    ur = torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
    ui = torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
    n0 = tdet.tail2_detect.launches
    got = tdet.tail2_detect(ur, ui, 128, 64, stokes=stokes)
    torch.cuda.synchronize()
    assert tdet.tail2_detect.launches == n0 + 1
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
    # One pol: the FIR in torch ops, then dft_last (no longer refused).
    one = v[:, : 5 * 1024, :1].contiguous()
    h1 = torch.from_numpy(tch.pfb_coeffs(4, 1024)).to(dev)
    n0 = tdft.dft_last.launches
    out = tch.channelize(one, h1, nfft=1024, device=dev)
    assert tdft.dft_last.launches == n0 + 1
    assert tch.last_kernel_plan()["pfb_kernel"] == "torch"
    _close(out, tch.channelize_twins(one, h1, nfft=1024, device=dev), 1e-4, 1e-2)


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
                                    (6, 333), (2049, 70), (96, 1000),
                                    (512, 37), (1024, 301), (4096, 9),
                                    (4093, 5)])
def test_dft_last_matches_plain(dev, n, rows, dtype):
    # Row counts that are not a multiple of the FFT's row group (4096 // n
    # rows) leave a partial last group; 4093 is prime (one dense pass).
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
    # n = 8: the row kernel, the FFT and the tiled GEMM (each timed beside
    # the others by chip_smoke.py) compute the same function.
    xr, xi = _planar(dev, (5000, 8), torch.float32, 8)
    w = tdft.as_tensors(tdft.dft_matrices(8), dev)
    want = tdft.dft_last_plain(xr, xi, *w)
    for got in (tdft.dft_last_cuda(xr, xi, *w, design="rows"),
                tdft.dft_last_cuda(xr, xi, *w, design="fft"),
                tdft.dft_last_cuda(xr, xi, *w, tiled=True)):
        for g, ref in zip(got, want):
            _close(g, ref, 1e-4, 1e-3 / ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dft_last_tiled_gemm_matches_plain_at_n1024(dev, dtype):
    xr, xi = _planar(dev, (300, 1024), dtype, 1024)
    w = tdft.as_tensors(tdft.dft_matrices(1024), dev)
    got = tdft.dft_last_cuda(xr, xi, *w, tiled=True)
    for g, want in zip(got, tdft.dft_last_plain(xr, xi, *w)):
        _close(g, want, 1e-4, 1e-3 / want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 64, 96, 1024, 2049])
def test_dft_last_rows_do_not_depend_on_the_call(dev, n, dtype):
    # A row's output depends only on that row: the same rows at another
    # position of a call, or in a call of another row count, give bitwise
    # equal outputs (the pins of correlate_stream, route (a) and the
    # search rest on this).
    xr, xi = _planar(dev, (301, n), dtype, n + 1)
    w = tdft.as_tensors(tdft.dft_matrices(n), dev)
    whole = tdft.dft_last(xr, xi, *w)
    for k0, k1 in ((0, 1), (3, 40), (17, 301), (299, 301)):
        part = tdft.dft_last(xr[k0:k1].clone(), xi[k0:k1].clone(), *w)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[k0:k1])
    shifted = [torch.cat([x[:5], x]) for x in (xr, xi)]
    for a, b in zip(tdft.dft_last(*shifted, *w), whole):
        assert torch.equal(a[5:], b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f2,f3", [(40, 128, 128), (3, 128, 256),
                                     (5, 128, 512), (7, 32, 128),
                                     (2, 1024, 128), (4, 8, 512),
                                     (9, 128, 64)])
def test_dft_tail2_matches_plain(dev, b, f2, f3, dtype):
    # (128, 64) and (128, 128) run whole panels in one launch; (128, 256),
    # (128, 512) and (1024, 128) the column level, then the row level
    # through a scratch panel.
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
        tdft.dft_tail2(xr[:, :4 * 128].contiguous(),
                       xi[:, :4 * 128].contiguous(), 4, 128)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m", [(300, 64, 96), (40, 128, 64),
                                   (3, 128, 1024), (20, 6, 683)])
def test_dft_stage_fft_at_the_main_paths_shapes(dev, b, n, m, dtype):
    # 6144's first level, route (a) 2^20's (128, 64), 2^24's middle level
    # and 4098's (6, 683), with the twiddle: the column FFT with its plan
    # and tile compiled in; the dense design (tiled=True) agrees too.
    assert tdft.dft_stage_design(n, m) == "fft"
    xr, xi = _planar(dev, (b, n, m), dtype, 7 * n + m)
    mats = tdft.as_tensors(tdft.dft_matrices(n) + tdft.twiddles(n, m), dev)
    want = tdft.dft_stage_plain(xr, xi, *mats)
    for got in (tdft.dft_stage(xr, xi, *mats),
                tdft.dft_stage_cuda(xr, xi, *mats, tiled=True)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g, w, 1e-4, 1e-3 / w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,design", [
    (5, 176, 40, "fft"),     # 16·11: a dense pass of 11, n >= 8p
    (3, 333, 40, "fft"),     # 3·3·37: a dense pass of 37
    (7, 127, 33, "tiled"),   # prime: the GEMM
    (9, 48, 96, "tiled"),    # timed faster as the GEMM
    (2, 1383, 3, "tiled"),   # 3·461
], ids=lambda x: str(x))
def test_dft_stage_designs_agree_where_the_rule_splits(dev, b, n, m, design,
                                                       dtype):
    # dft_stage_design's pick by shape, and both designs (the run-time
    # plan's column FFT with its dense prime pass, the tiled GEMM) within
    # the plain version's bounds there.
    assert tdft.dft_stage_design(n, m) == design
    xr, xi = _planar(dev, (b, n, m), dtype, 5 * n + m)
    mats = tdft.as_tensors(tdft.dft_matrices(n) + tdft.twiddles(n, m), dev)
    want = tdft.dft_stage_plain(xr, xi, *mats)
    for got in (tdft.dft_stage(xr, xi, *mats),
                tdft.dft_stage_cuda(xr, xi, *mats, design="fft"),
                tdft.dft_stage_cuda(xr, xi, *mats, design="tiled")):
        for g, w in zip(got, want):
            _close(g, w, 1e-4, 1e-3 / w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", [(64, 96), (6, 683), (75, 80)])
def test_dft_stage_columns_do_not_depend_on_the_call(dev, n, m, dtype):
    # A column's output depends only on that column: the same panel at
    # another place of a call, in a call of another panel count, or
    # shifted by columns (another tile, another staging offset) gives
    # bitwise equal outputs (route (b)'s twisted order rests on this).
    xr, xi = _planar(dev, (9, n, m), dtype, n + 3 * m)
    mats = tdft.as_tensors(tdft.dft_matrices(n) + tdft.twiddles(n, m), dev)
    whole = tdft.dft_stage(xr, xi, *mats)
    part = tdft.dft_stage(xr[4:6].clone(), xi[4:6].clone(), *mats)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[4:6])
    # Columns 5 .. m-1 of each panel as the first m-5 of a narrower call.
    narrow = [x[..., 5:].contiguous() for x in (xr, xi)]
    tw = [t[:, 5:].contiguous() for t in mats[2:]]
    sub = tdft.dft_stage(*narrow, *mats[:2], *tw)
    for a, b in zip(sub, whole):
        assert torch.equal(a, b[..., 5:])


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,nint,nchan,plan", [
    (8, 128, 4, ("pallas", "dft_last")),
    (1024, 16, 4, ("pallas", "dft_last")),
    (1 << 13, 1, 2, ("fused1", "dft_last")),
    (6144, 2, 2, ("fused1", "dft_last")),
    (4098, 1, 1, ("fused1", "dft_last")),
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
@pytest.mark.parametrize("F", [3, 257, 4100, 70001])
@pytest.mark.parametrize("T", [1 << k for k in range(1, 11)])
def test_taylor_tree_bitwise_equal_to_plain(dev, T, F):
    # Every window blit allows, on every kernel route, at widths that are
    # a multiple of no tile (odd: 4-byte loads; 4100: 16-byte loads and a
    # ragged last tile); both signs through drift_spectra.
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


@pytest.mark.cuda
def test_hires_search_window_matches_the_plain_run(dev, tmp_path):
    # One hi-res window (8 spectra of nfft 2^20, 2 coarse channels) through
    # pfb_dft1 + tail2_detect + taylor_tree on the card and through the
    # plain twins and tree on the CPU: the same hit cells in the same
    # order, SNR and power within rtol 1e-4 (chip_smoke.py (h)'s check).
    from blit_torch import testing as ttesting
    from blit_torch.search import DedopplerReducer

    T, nfft = 8, NFFT
    raw = str(tmp_path / "hires.raw")
    ttesting.synth_raw(raw, nblocks=2, obsnchan=2,
                       ntime_per_block=(T + 3) * nfft // 2, seed=3,
                       tone_chan=1, tone_amp=30.0)
    kw = dict(nfft=nfft, window_spectra=T, chunk_frames=4, top_k=4,
              snr_threshold=6.0)
    counts = [tpfb.pfb_dft1.launches, tdet.tail2_detect.launches]
    _, hits = DedopplerReducer(device=dev, **kw).search(raw)
    assert tch.last_kernel_plan()["tail_kernel"] == "tail2_detect"
    assert tpfb.pfb_dft1.launches > counts[0]
    assert tdet.tail2_detect.launches > counts[1]
    _, ref = DedopplerReducer(device="cpu", **kw).search(raw)
    assert hits and max(hits, key=lambda h: h.snr).band == 1
    cells = [(h.window, h.drift_bins, h.chan, h.band) for h in hits]
    assert cells == [(h.window, h.drift_bins, h.chan, h.band) for h in ref]
    np.testing.assert_allclose([h.snr for h in hits], [h.snr for h in ref],
                               rtol=1e-4)
    np.testing.assert_allclose([h.power for h in hits],
                               [h.power for h in ref], rtol=1e-4)


# -- the antenna-array plane: fused_beamform_detect and xengine_packed -------
# Bounds as blit's: beamform rtol 1e-4 / atol 1e-3·max
# (tests/test_pallas_beamform.py:43-46), the X-engine rtol 1e-4 / atol 1e-3
# on unit-variance spectra (tests/test_pallas_xengine.py:40-43).

def _beam_case(dev, nchan, nant, nbeam, npol, ntime, dtype, seed=0,
               integer=True):
    # Integer voltages as RAW holds them (exact in tf32: the f32 kernel
    # skips their low pass), or not (all three passes).
    rng = np.random.default_rng(seed)
    v = (rng.integers(-40, 41, (2, nchan, nant, npol, ntime)) if integer else
         rng.standard_normal((2, nchan, nant, npol, ntime)) * 20).astype(np.float32)
    w = rng.standard_normal((2, nchan, nbeam, nant)).astype(np.float32)
    vr, vi = (torch.from_numpy(x).to(dev, dtype) for x in v)
    wr, wi = (torch.from_numpy(x).to(dev, dtype) for x in w)
    return vr, vi, wr, wi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nchan,nant,nbeam,npol,ntime,nint", [
    (3, 64, 64, 2, 1024, 8),     # the array shape, odd channel count
    (2, 17, 65, 2, 136, 8),      # ragged antenna slice, beam tile, time tile
    (1, 5, 3, 1, 256, 1),        # one pol, nint 1
    (2, 16, 64, 2, 384, 2),
    (2, 16, 64, 2, 512, 16),     # nint across 2 threads
    (1, 8, 70, 2, 1024, 128),    # the gate's largest nint
], ids=lambda x: str(x))
def test_fused_beamform_detect_matches_plain(dev, nchan, nant, nbeam, npol,
                                             ntime, nint, dtype):
    from blit_torch.ops import beamform as tbf

    args = _beam_case(dev, nchan, nant, nbeam, npol, ntime, dtype)
    assert tbf.fits(nant, nbeam, npol, ntime, nint, args[0].element_size())
    n0 = tbf.fused_beamform_detect.launches
    got = tbf.fused_beamform_detect(*args, nint=nint)
    torch.cuda.synchronize()
    assert tbf.fused_beamform_detect.launches == n0 + 1
    want = tbf.fused_beamform_detect_plain(*args, nint=nint)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("nint", [8, 32])
def test_fused_beamform_detect_windows_equal_one_shot_bitwise(dev, nint):
    from blit_torch.ops import beamform as tbf

    vr, vi, wr, wi = _beam_case(dev, 2, 64, 64, 2, 4096, torch.float32, seed=1)
    whole = tbf.fused_beamform_detect(vr, vi, wr, wi, nint=nint)
    parts = [tbf.fused_beamform_detect(vr[..., t:t + 1024].contiguous(),
                                       vi[..., t:t + 1024].contiguous(), wr, wi,
                                       nint=nint) for t in range(0, 4096, 1024)]
    assert torch.equal(whole, torch.cat(parts, dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nbeam", [1, 3, 17, 65, 130])
@pytest.mark.parametrize("nant", [1, 3, 17, 65, 130])
def test_fused_beamform_detect_pads_every_nint(dev, nant, nbeam, dtype):
    # Antennas and beams off the MMA tiles (zero-padded to them), every
    # nint the gate admits, integer voltages or not; four windows bitwise
    # equal to the one-shot call.
    from blit_torch.ops import beamform as tbf

    vr, vi, wr, wi = _beam_case(dev, 2, nant, nbeam, 2, 1024, dtype,
                                seed=nant * 131 + nbeam,
                                integer=(nant + nbeam) % 2 == 0)
    for nint in [1 << k for k in range(8)]:
        whole = tbf.fused_beamform_detect(vr, vi, wr, wi, nint=nint)
        _close(whole, tbf.fused_beamform_detect_plain(vr, vi, wr, wi, nint=nint),
               1e-4, 1e-3)
        parts = [tbf.fused_beamform_detect(vr[..., t:t + 256].contiguous(),
                                           vi[..., t:t + 256].contiguous(), wr,
                                           wi, nint=nint)
                 for t in range(0, 1024, 256)]
        assert torch.equal(whole, torch.cat(parts, dim=-1)), nint


@pytest.mark.cuda
def test_fused_beamform_detect_refuses_shapes_outside_the_gate(dev):
    from blit_torch.ops import beamform as tbf

    args = _beam_case(dev, 1, 4, 4, 2, 768, torch.float32)
    for nint in (3, 256):
        assert not tbf.fits(4, 4, 2, 768, nint)
        with pytest.raises(ValueError, match="Hopper kernel"):
            tbf.fused_beamform_detect(*args, nint=nint)


def _spectra(dev, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, dtype) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nant,nchan,npol,nframes,nfft", [
    (64, 3, 2, 13, 64),    # nap 128, the gate's edge; odd channel count
    (64, 1, 2, 61, 512),   # the array shape, one channel
    (65, 2, 2, 5, 40),     # nap 130: ragged tiles; nfft not a multiple of 32
    (8, 3, 1, 7, 16),      # below the gate: the kernel still computes it
], ids=lambda x: str(x))
def test_xengine_packed_matches_plain(dev, nant, nchan, npol, nframes, nfft,
                                      dtype):
    from blit_torch.ops import xengine as txe

    sr, si = _spectra(dev, (nant, nchan, npol, nframes, nfft), dtype, nant + nfft)
    n0 = txe.xengine_packed.launches
    got = txe.xengine_packed(sr, si)
    torch.cuda.synchronize()
    assert txe.xengine_packed.launches == n0 + 1
    want = txe.xengine_packed_plain(sr, si)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-4, 1e-3 / w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nant,nchan,npol,nframes,nfft", [
    (128, 2, 2, 9, 16),    # nap 256: 8 tile rows, several items a channel
    (64, 2, 2, 15, 64),    # one correlate_stream window of 15 frames
    (65, 1, 2, 17, 8),     # nap 130: a ragged tile row and column
], ids=lambda x: str(x))
def test_xengine_packed_is_exactly_hermitian(dev, nant, nchan, npol, nframes,
                                             nfft, dtype):
    # Within the bounds of the plain version, and the half below the
    # diagonal exactly the conjugate transpose of the half above it (the
    # kernel computes one and mirrors it).
    from blit_torch.ops import xengine as txe

    sr, si = _spectra(dev, (nant, nchan, npol, nframes, nfft), dtype, nant + 9)
    want = txe.xengine_packed_plain(sr, si)
    vr, vi = txe.xengine_packed(sr, si)
    assert torch.equal(vr, vr.mT) and torch.equal(vi, -vi.mT)
    for g, w in zip((vr, vi), want):
        _close(g, w, 1e-4, 1e-3 / w.abs().max().item())


@pytest.mark.cuda
def test_xengine_packed_reads_a_frame_slice_in_place(dev):
    # A tile of frames (correlate's acc_frames) is read through its strides
    # and equals the same frames made contiguous, bitwise.
    from blit_torch.ops import xengine as txe

    sr, si = _spectra(dev, (64, 2, 2, 61, 64), torch.float32, 3)
    a = txe.xengine_packed(sr[..., 15:30, :], si[..., 15:30, :])
    b = txe.xengine_packed(sr[..., 15:30, :].contiguous(),
                           si[..., 15:30, :].contiguous())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert txe.eligible(128, 2, 64) and not txe.eligible(120, 2, 64)


@pytest.mark.cuda
def test_xengine_packed_addresses_spectra_past_2_31_elements(dev):
    # 64-bit offsets: the second antenna's spectra lie 2^31 elements into
    # the buffer; the result equals that of the same spectra made compact.
    from blit_torch.ops import xengine as txe

    shape = (2, 1, 2, 5, 64)
    sr, si = _spectra(dev, shape, torch.bfloat16, 4)
    per = sr[0].numel()
    buf = torch.zeros(2 ** 31 + 2 * per, dtype=torch.bfloat16, device=dev)
    strides = (2 ** 31, 2 * 5 * 64, 5 * 64, 64, 1)
    far = [buf.as_strided(shape, strides, k * per) for k in range(2)]
    for f, x in zip(far, (sr, si)):
        f.copy_(x)
    got = txe.xengine_packed(*far)
    want = txe.xengine_packed(sr, si)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_array_entry_points_run_the_kernels(dev, tmp_path):
    # The array plane on the card at a small shape the gates admit:
    # beamform(layout="chan") fused, correlate(packed) through the X-engine
    # and dft_last, and both streams bitwise equal to their one-shot forms.
    from blit_torch.ops import beamform as tbf
    from blit_torch.ops import xengine as txe
    from blit_torch.parallel import antenna as A
    from blit_torch.parallel import beamform as B
    from blit_torch.parallel import correlator as C
    from blit_torch.testing import synth_raw

    paths = []
    for a in range(64):
        p = str(tmp_path / f"a{a}.raw")
        synth_raw(p, nblocks=2, obsnchan=3, ntime_per_block=2048, seed=a,
                  tone_chan=a % 3)
        paths.append(p)
    w = B.delay_weights_planar(np.random.default_rng(0).uniform(0, 1e-9, (64, 64)),
                               np.linspace(1e9, 1.1e9, 3), device=dev)
    wc = tbf.pack_weights(*w)
    _, v = A.load_antennas(paths, layout="chan", device=dev)
    n0 = tbf.fused_beamform_detect.launches
    one = B.beamform(v, wc, nint=8, layout="chan", device=dev)
    assert B.last_beamform_plan() == {"layout": "chan", "fused": True, "impl": "cuda"}
    _close(one, tbf.fused_beamform_detect_plain(*v, *wc, nint=8), 1e-4, 1e-3)
    feed = A.AntennaStream(paths, window_samples=1024, layout="chan", device=dev)
    slabs = list(B.beamform_stream(feed, wc, nint=8, layout="chan", device=dev))
    assert tbf.fused_beamform_detect.launches == n0 + 1 + feed.nwindows
    assert torch.equal(torch.cat(slabs, dim=-1), one.cpu())

    h = torch.from_numpy(tch.pfb_coeffs(4, 64)).to(dev)
    _, cv = A.load_correlator(paths, nfft=64, device=dev)
    x0, d0 = txe.xengine_packed.launches, tdft.dft_last.launches
    vis = C.correlate(cv, h, nfft=64, vis_layout="packed", acc_frames=15, device=dev)
    assert C.last_xengine_plan() == {"layout": "packed", "engine": "cuda", "impl": "cuda"}
    assert tdft.dft_last.launches == d0 + 1
    assert txe.xengine_packed.launches == x0 + -(-(4096 // 64 - 3) // 15)
    feed = A.CorrelatorStream(paths, nfft=64, window_frames=15, device=dev)
    svis = C.correlate_stream(feed, h, nfft=64, vis_layout="packed", device=dev)
    assert torch.equal(vis[0], svis[0]) and torch.equal(vis[1], svis[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("npol", [2, 1])
@pytest.mark.parametrize("factors", [(8, 4), (8, 4, 4), (16,), (8, 32, 4),
                                     (128, 4096), (128, 128, 128),
                                     (128, 128, 64)], ids=str)
def test_detect_untwist_i_matches_plain(dev, factors, npol, dtype):
    n = int(np.prod(factors))
    sr, si = _planar(dev, (2, npol, 3, n), dtype, n + npol)
    n0 = tdet.detect_untwist_i.launches
    got = tdet.detect_untwist_i(sr, si, factors)
    torch.cuda.synchronize()
    assert tdet.detect_untwist_i.launches == n0 + 1
    want = tdet.detect_untwist_i_plain(sr, si, factors)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 3, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_detect_untwist_i_refuses_more_than_3_factors(dev):
    sr, si = _planar(dev, (1, 2, 1, 64), torch.float32, 0)
    n0 = tdet.detect_untwist_i.launches
    with pytest.raises(ValueError, match="at most 3"):
        tdet.detect_untwist_i(sr, si, (2, 2, 4, 4))
    assert tdet.detect_untwist_i.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (nfft, npol, nint, knobs, plan (fft, pfb, tail, detect, order), kernels)
    (NFFT, 2, 1, dict(detect_kernel="pallas", tail_kernel="xla"),
     ("matmul", "fused1", "dft_stage+dft_last", "detect_untwist_i", "natural"),
     ("pfb_dft1", "dft_stage", "dft_last", "detect_untwist_i")),
    (1 << 13, 2, 2, dict(detect_kernel="pallas"),
     ("matmul", "fused1", "dft_last", "detect_untwist_i", "natural"),
     ("pfb_dft1", "dft_last", "detect_untwist_i")),
    (6144, 2, 2, dict(dft_order="twisted"),
     ("matmul", "pallas", "dft_stage+dft_last", "torch", "twisted"),
     ("pfb_dequant", "dft_stage", "dft_last")),
    (1024, 1, 2, dict(),
     ("matmul", "torch", "dft_last", "torch", "natural"), ("dft_last",)),
    (1 << 13, 1, 1, dict(pfb_kernel="xla"),
     ("matmul", "torch", "dft_stage+dft_last", "torch", "natural"),
     ("dft_stage", "dft_last")),
    (1024, 1, 2, dict(fft_method="direct"),
     ("direct", "torch", "torch", "torch", "natural"), ()),
    (NFFT, 2, 1, dict(tail_kernel="pallas", detect_kernel="xla"),
     ("matmul", "fused1", "dft_tail2", "torch", "natural"),
     ("pfb_dft1", "dft_tail2")),
    (2 * 4099, 2, 1, dict(),
     ("four_step", "pallas", "torch", "torch", "natural"), ("pfb_dequant",)),
], ids=["a-2^20", "a-2^13", "b-6144", "c-1pol", "c-xla-2^13", "d-direct",
        "tail2-2^20", "auto-8198"])
def test_channelize_opt_in_routes_run_the_kernels(dev, case):
    nfft, npol, nint, knobs, plan, names = case
    rng = np.random.default_rng(nfft + npol)
    v = torch.from_numpy(rng.integers(-128, 128, (2, (3 + 2 * nint) * nfft,
                                                  npol, 2), np.int8)).to(dev)
    h = torch.from_numpy(tch.pfb_coeffs(4, nfft)).to(dev)
    wrappers = {"pfb_dft1": tpfb.pfb_dft1, "pfb_dequant": tpfb.pfb_dequant,
                "dft_stage": tdft.dft_stage, "dft_last": tdft.dft_last,
                "dft_tail2": tdft.dft_tail2, "tail2_detect": tdet.tail2_detect,
                "detect_untwist_i": tdet.detect_untwist_i}
    counts = {k: fn.launches for k, fn in wrappers.items()}
    got = tch.channelize(v, h, nfft=nfft, nint=nint, device=dev, **knobs)
    torch.cuda.synchronize()
    p = tch.last_kernel_plan()
    assert (p["fft_method"], p["pfb_kernel"], p["tail_kernel"],
            p["detect_kernel"], p["dft_order"], p["impl"]) == plan + ("cuda",)
    ran = {k for k, fn in wrappers.items() if fn.launches > counts[k]}
    assert ran == set(names)
    want = tch.channelize_twins(v, h, nfft=nfft, nint=nint, device=dev, **knobs)
    assert got.shape == want.shape == (2, 1, 2 * nfft)
    _close(got, want, 1e-4, 1e-2)
    if "detect_untwist_i" in names:
        # The default plan computes the same product through other kernels.
        default = tch.channelize(v, h, nfft=nfft, nint=nint, device=dev)
        _close(got, default, 1e-4, 1e-2)


# -- the asynchronous plane on the card -------------------------------------


@pytest.mark.cuda
def test_host_slabs_are_pinned_views_of_one_allocation(dev):
    from blit_torch import hostmem

    slab = hostmem.HostSlab((64, 33), np.uint16, pinned=True)
    assert slab.tensor.is_pinned() and slab.bytes.is_pinned()
    assert slab.tensor.dtype == torch.uint16 and slab.array.dtype == np.uint16
    slab.array[...] = np.arange(64 * 33, dtype=np.uint16).reshape(64, 33)
    assert slab.bytes.data_ptr() == slab.array.ctypes.data
    back = slab.bytes.to(dev, non_blocking=True).cpu()
    assert torch.equal(back, slab.bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("reuse", [False, True])
def test_output_rotation_reads_back_through_events(dev, reuse):
    # Each output is dropped by the caller right after put and its memory
    # is asked for again at once: if the readback did not hold the output
    # until its copy synchronized, or copied before the event, a slab
    # would read the -1 fill or a half-written value.
    from blit_torch.outplane import OutputRotation, record_event

    shape = (1 << 20,)
    rot = OutputRotation(depth=2, reuse=reuse)
    got = []

    def take(slabs):
        for s in slabs:
            got.append((float(s.data.min()), float(s.data.max()),
                        s.data.ctypes.data))
            s.release()

    try:
        x = torch.ones(shape, device=dev)
        for i in range(12):
            out = x * float(i)
            for _ in range(20):  # enough work that the event matters
                out = out * 1.0
            ev = record_event(out)
            slabs = rot.put(out, event=ev, nbytes=out.numel() * 4)
            del out
            junk = torch.full(shape, -1.0, device=dev)
            take(slabs)
            del junk
        take(rot.drain())
    finally:
        rot.close()
    assert [(lo, hi) for lo, hi, _ in got] == [(float(i), float(i)) for i in range(12)]
    if reuse:
        assert len({p for _, _, p in got}) <= 3  # the pinned ring


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [8, 16])
def test_narrow_device_bitwise_on_the_card(dev, nbits):
    from blit_torch.ops.narrow import narrow_device, narrow_host

    rng = np.random.default_rng(nbits)
    x = rng.normal(100.0, 80.0, (257, 1031)).astype(np.float32)
    x[0, :10] = [0.5, 1.5, 2.5, -0.5, 254.5, 255.5, 65534.5, 65535.5, 1e9, -1e9]
    for scale, offset in ((1.0, 0.0), (0.5, 2.0), (0.1, -7.0), (300.0, 0.5)):
        got = narrow_device(torch.from_numpy(x).to(dev), nbits, scale, offset)
        want = narrow_host(x, nbits, scale, offset)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [32, 8, 16])
def test_reducer_plane_async_equals_sync_on_the_card(dev, tmp_path, nbits):
    from blit_torch.pipeline import RawReducer
    from blit_torch.testing import synth_raw

    raw = str(tmp_path / "x.raw")
    synth_raw(raw, nblocks=3, obsnchan=4, ntime_per_block=1 << 15, tone_chan=1)
    kw = dict(nfft=1024, nint=4, chunk_frames=16, nbits=nbits,
              quant_scale=1e-3, quant_offset=0.5, device=dev)
    files = []
    for mode in (True, False, True):
        p = str(tmp_path / f"{len(files)}.fil")
        tpfb.pfb_dequant.launches = 0
        RawReducer(async_output=mode, **kw).reduce_to_file(raw, p)
        assert tpfb.pfb_dequant.launches > 0
        with open(p, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1] == files[2]


@pytest.mark.cuda
def test_search_plane_async_equals_sync_on_the_card(dev, tmp_path):
    from blit_torch.search import DedopplerReducer
    from blit_torch.testing import synth_raw

    raw = str(tmp_path / "x.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=1024 * 80, tone_chan=1)
    out = []
    for mode in (True, False):
        p = str(tmp_path / f"{mode}.hits")
        tpd.taylor_tree.launches = 0
        hdr = DedopplerReducer(nfft=1024, window_spectra=16, async_output=mode,
                               device=dev).search_to_file(raw, p)
        assert hdr["search_windows"] > 2 and tpd.taylor_tree.launches > 0
        with open(p) as f:
            out.append(f.read())
    assert out[0] == out[1]


@pytest.mark.cuda
def test_antenna_feeds_through_pinned_slots(dev, tmp_path):
    from blit_torch.ops.channelize import pfb_coeffs
    from blit_torch.parallel import antenna as A
    from blit_torch.parallel import beamform as B
    from blit_torch.parallel import correlator as C
    from blit_torch.testing import synth_raw

    paths = []
    for a in range(8):
        p = str(tmp_path / f"a{a}.raw")
        synth_raw(p, nblocks=2, obsnchan=4, ntime_per_block=2048, seed=a,
                  tone_chan=a % 4)
        paths.append(p)
    rng = np.random.default_rng(1)
    w = B.delay_weights_planar(rng.uniform(0, 1e-9, (5, 8)),
                               np.linspace(1e9, 1.1e9, 4), device=dev)
    _, v = A.load_antennas(paths, device=dev)
    one = B.beamform(v, w, nint=8, device=dev).cpu()
    h = torch.from_numpy(pfb_coeffs(4, 64)).to(dev)
    _, vc = A.load_correlator(paths, nfft=64, device=dev)
    acc = C.correlate(vc, h, nfft=64, acc_frames=7, device=dev)
    for depth in (1, 2, 3):
        feed = A.AntennaStream(paths, window_samples=512, prefetch_depth=depth,
                               device=dev)
        slabs = list(B.beamform_stream(feed, w, nint=8, device=dev))
        assert torch.equal(torch.cat(slabs, dim=2), one)
        feed = A.CorrelatorStream(paths, nfft=64, window_frames=7,
                                  prefetch_depth=depth, device=dev)
        got = C.correlate_stream(feed, h, nfft=64, device=dev)
        assert torch.equal(got[0], acc[0]) and torch.equal(got[1], acc[1])


@pytest.mark.cuda
def test_get_kurtosis_on_the_card_matches_the_host(dev, tmp_path):
    # blit's device-against-host bound (tests/test_stats.py:55).
    from blit_torch import workers
    from blit_torch.testing import synth_fil

    p = str(tmp_path / "k.fil")
    synth_fil(p, nsamps=512, nifs=2, nchans=256, seed=3)
    host = workers.get_kurtosis(p, device=False)
    for idxs in ((slice(None),) * 3, (slice(0, 256), 0, slice(None))):
        card = workers.get_kurtosis(p, idxs, device=True)
        want = workers.get_kurtosis(p, idxs, device=False)
        assert card.shape == want.shape
        np.testing.assert_allclose(card, want, rtol=2e-3, atol=2e-3)
        # The card is the default.
        np.testing.assert_array_equal(workers.get_kurtosis(p, idxs), card)
    assert host.shape == (256, 2)


@pytest.mark.cuda
def test_thread_fanout_of_reduce_raw_is_byte_identical_to_serial(dev, tmp_path):
    # Two reducers at once on one card (their producer, readback and sink
    # threads, the shared staging pool and process timeline) must write
    # what one reducer writes alone.
    import filecmp

    from blit_torch import gbt, workers
    from blit_torch.parallel.pool import WorkerPool
    from blit_torch.testing import synth_raw

    raws = []
    for k in range(2):
        p = str(tmp_path / f"b{k}.raw")
        synth_raw(p, nblocks=4, obsnchan=8, ntime_per_block=1 << 15, seed=k,
                  tone_chan=k)
        raws.append(p)
    outs = [str(tmp_path / f"f{k}.fil") for k in range(2)]
    with WorkerPool(["blc00", "blc01"], backend="thread") as pool:
        gbt.reduce_raw([1, 2], raws, outs, pool=pool, nfft=1024, nint=4)
    for raw, out in zip(raws, outs):
        serial = out + ".serial.fil"
        workers.reduce_raw(raw, serial, nfft=1024, nint=4)
        assert filecmp.cmp(out, serial, shallow=False)
