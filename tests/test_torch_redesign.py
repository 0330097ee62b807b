"""The geometry of the redesigned dft_stage and xengine_packed kernels,
and their plain twins against blit at the shapes the kernels are tuned
for, on the CPU.

- ``dft_stage_design`` / ``stage_fft_geometry`` (blit_torch/ops/dft.py):
  the column FFT takes the main paths' shapes, its tiles cover every
  column once and fit in shared memory, the compiled-in tiles of
  csrc/dft.cu (n = 64 and 128 at 32 columns, n = 6 at 352) are the ones
  the geometry picks, and the dense tiled GEMM keeps only what the FFT's
  tiles refuse;
- ``tile_pairs`` (blit_torch/ops/xengine.py): the upper-triangle tile
  schedule of csrc/xengine.cu writes every (ap, bq) exactly once,
  directly or as a mirror;
- ``dft_stage_plain`` at (64, 96) (6144's first level) and (6, 683)
  (4098's) against blit's ``dft_stage`` in interpret mode, and
  ``xengine_packed_plain`` at nap 130 and on a 15-frame slice against
  blit's ``xengine_packed`` in interpret mode, at blit's tolerances
  (rtol 1e-4 / atol 1e-3 on unit-variance input,
  tests/test_pallas_dft.py:22-33, tests/test_pallas_xengine.py:40-43).

The kernels themselves run only on a CUDA device (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import dft as bdft  # noqa: E402
from blit.ops import pallas_dft, pallas_xengine  # noqa: E402
from blit_torch.ops import dft as tdft  # noqa: E402
from blit_torch.ops import xengine as txe  # noqa: E402

# (n, m) of the main paths' dft_stage levels and the tile compiled into
# csrc/dft.cu for each: 6144 = 64·96, 2^24's middle level after pfb_dft1,
# route (a) 2^20's (128, 64), 4098 = 6·683.
MAIN_STAGES = [((64, 96), 32), ((128, 1024), 32), ((128, 64), 32),
               ((6, 683), 352)]


def _planar(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("nm,tc", MAIN_STAGES, ids=lambda x: str(x))
def test_stage_design_takes_the_fft_on_the_main_paths(nm, tc, esize):
    n, m = nm
    assert tdft.dft_stage_design(n, m) == "fft"
    geo = tdft.stage_fft_geometry(n, m, esize)
    assert geo["plan"] == tdft.fft_plan(n)
    # The tile compiled into csrc/dft.cu, one round of passes, two stage
    # buffers (the next tile loads while this one's passes run).
    assert geo["tc"] == tc and geo["per_round"] == tc
    assert geo["nstage"] == 2 and geo["smem"] <= tdft.SMEM_MAX


@pytest.mark.parametrize("n,m", [(2, 2049), (3, 5), (16, 256), (75, 80),
                                 (96, 64), (333, 40), (512, 512),
                                 (1024, 1024), (1383, 3)])
def test_stage_fft_tiles_cover_the_panel(n, m):
    # The FFT's tiles fit for any n up to 1383: a tile is a multiple of 8
    # columns, a round of passes holds at most 4096 values, and the tiles
    # of a panel cover its m columns with less than one tile of padding.
    for esize in (4, 2):
        geo = tdft.stage_fft_geometry(n, m, esize)
        tc, pr = geo["tc"], geo["per_round"]
        assert tc % 8 == 0 and 1 <= pr <= tc and pr * n <= 4096
        assert 0 <= -(-m // tc) * tc - m < tc
        assert int(np.prod(geo["plan"])) == n
        assert geo["smem"] <= tdft.SMEM_MAX


@pytest.mark.parametrize("n,m", [(1, 64), (1384, 3), (2048, 8), (4096, 2),
                                 (4096, 96)])
def test_stage_design_keeps_the_tiled_gemm_where_the_fft_does_not_fit(n, m):
    assert tdft.dft_stage_design(n, m) == "tiled"


# The design chip_smoke.py's sweep timed faster (m = 96 and 1024, f32 and
# bf16, NVIDIA H100 80GB HBM3): the GEMM where the FFT's plan has a dense
# pass of a prime p > 7 with n < 8p, and at n = 48; the FFT elsewhere
# (88 = 8·11 and 248 = 8·31 sit at the crossing, where the two are even).
SWEEP_TILED = (11, 13, 22, 31, 44, 48, 62, 124, 127, 641, 1383)
SWEEP_FFT = (2, 3, 5, 6, 12, 24, 64, 80, 88, 96, 100, 112, 128, 144, 160, 176,
             208, 248, 256, 333, 352, 384, 496, 512, 704, 768, 992, 1000,
             1024)


@pytest.mark.parametrize("m", [96, 1024])
@pytest.mark.parametrize("n", SWEEP_TILED + SWEEP_FFT)
def test_stage_design_follows_the_sweep(n, m):
    want = "tiled" if n in SWEEP_TILED else "fft"
    assert tdft.dft_stage_design(n, m) == want
    dense = [r for r in tdft.fft_plan(n) if r > 7 and r % 2]
    if want == "fft":
        assert all(n >= 8 * p for p in dense)


@pytest.mark.parametrize("nap", [128, 130, 256, 8, 33])
def test_xengine_tile_schedule_writes_every_baseline_once(nap):
    count = np.zeros((nap, nap), np.int64)
    pairs = txe.tile_pairs(nap)
    ntiles = -(-nap // 32)
    assert len(pairs) == ntiles * (ntiles + 1) // 2
    for i0, j0 in pairs:
        assert i0 <= j0 and i0 % 32 == 0 and j0 % 32 == 0
        rows = np.arange(i0, min(i0 + 32, nap))
        cols = np.arange(j0, min(j0 + 32, nap))
        if i0 == j0:  # the upper half and the diagonal, and their mirror
            for r in rows:
                count[r, cols[cols >= r]] += 1
                count[cols[cols > r], r] += 1
        else:  # the tile and its conjugate transpose
            count[np.ix_(rows, cols)] += 1
            count[np.ix_(cols, rows)] += 1
    assert (count == 1).all()


def _close_dft(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("twiddle", [False, True], ids=["plain", "twiddle"])
@pytest.mark.parametrize("b,n,m", [(3, 64, 96), (2, 6, 683)])
def test_dft_stage_plain_matches_pallas_at_the_tuned_shapes(b, n, m, twiddle):
    xr, xi = _planar((b, n, m), n + m)
    mats = bdft.dft_matrices(n) + (bdft.twiddles(n, m) if twiddle else ())
    want = pallas_dft.dft_stage(jnp.asarray(xr), jnp.asarray(xi),
                                *(jnp.asarray(a) for a in mats), interpret=True)
    got = tdft.dft_stage(torch.from_numpy(xr), torch.from_numpy(xi),
                         *(torch.from_numpy(a) for a in mats))
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (b, n, m)
    _close_dft(got, want)


def _xengine_case(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    sr, si = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = pallas_xengine.xengine_packed(jnp.asarray(sr).astype(dtype),
                                         jnp.asarray(si).astype(dtype),
                                         interpret=True)
    return sr, si, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xengine_plain_matches_pallas_at_nap_130(dtype):
    # nap 130 = 65 antennas x 2 pols: five tiles of 32 rows, the last one
    # with two; 15 frames, one correlate_stream window.
    sr, si, want = _xengine_case((65, 2, 2, 15, 16), dtype)
    got = txe.xengine_packed(*(torch.from_numpy(x).to(getattr(torch, dtype))
                               for x in (sr, si)))
    assert tuple(got[0].shape) == (2, 16, 130, 130)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xengine_plain_matches_pallas_on_a_frame_slice(dtype):
    # A 15-frame window read in place through the spectra's strides, as
    # correlate(acc_frames=15) and correlate_stream hand it over.
    shape = (64, 1, 2, 61, 16)
    rng = np.random.default_rng(7)
    full = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(getattr(torch, dtype)) for _ in range(2)]
    win = [x[:, :, :, 15:30] for x in full]
    assert not win[0].is_contiguous()
    want = pallas_xengine.xengine_packed(
        *(jnp.asarray(x.float().contiguous().numpy()).astype(dtype) for x in win),
        interpret=True)
    got = txe.xengine_packed(*win)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)
