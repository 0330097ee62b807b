"""The Hopper kernels against their plain twins, on a CUDA device.

Each test is marked ``cuda`` and skips without a GPU.  On the card:
``python -m pytest tests/test_torch_cuda.py -m cuda -s`` (``-s`` shows
the compiler's register and shared-memory report).  Bounds as
tests/test_torch_ops.py: pfb_dft1 f32 rtol 1e-4 / atol 1e-2·max,
tail2_detect f32 rtol 1e-5 / atol 1e-4·max, bf16 rtol 0.05 / atol
0.05·max.  f32 twins run with TF32 off.
"""

import numpy as np
import pytest
import torch

from blit_torch import kernels
from blit_torch.ops import channelize as tch
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
        tch.channelize(v[:, : 5 * 1024], coeffs[:, :1024], nfft=1024, device=dev)
