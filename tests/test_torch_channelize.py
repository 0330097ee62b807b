"""The port's channelize (blit_torch.ops.channelize) held against blit's.

At the 0000 shape (nfft = 2^20, factors 128·128·64) the port's CPU path
runs the fused plan — the plain twins of pfb_dft1 and tail2_detect —
and is compared with blit's channelize on its fused Pallas plan
(pfb_kernel="fused1", tail/detect "pallas", interpret mode on the CPU)
and with blit's numpy golden channelize_np, at the bounds of
tests/test_pallas_detect.py:150-198 (rtol 1e-4, atol 1e-2·max) and, for
bf16, tests/test_channelize.py:225-246 (atol 2e-2 of the peak).
Every other two-pol nfft takes the plan's other rows (pfb_dequant or
pfb_dft1, then dft_stage/dft_last, then torch detect), held against
blit's channelize on the plan the TPU resolves for that shape (matmul
DFT; pfb_kernel "pallas" where blit's VMEM gate passes, else "xla") at
the same f32 bound, with the scale from noise-only data, and for bf16
at tests/test_channelize.py:225-246's atol 2e-2 of the peak.  One-pol
input takes the port's unfused plain path, held against channelize_np
at tests/test_channelize.py:106's rtol 1e-4 / atol 1e-2.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import channelize as bch  # noqa: E402
from blit_torch.ops import channelize as tch  # noqa: E402

NFFT = 1 << 20
NTAP = 4
FUSED = dict(fft_method="matmul", pfb_kernel="fused1", tail_kernel="pallas",
             detect_kernel="pallas")


def _volts(nchan, nblk, nfft=NFFT, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-40, 40, (nchan, nblk * nfft, 2, 2), np.int8)


def _close(got, want, rtol=1e-4, atol_frac=1e-2):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


@pytest.mark.parametrize("case", [
    dict(nchan=1, nblk=NTAP + 1, stokes="I", nint=2),
    dict(nchan=1, nblk=NTAP + 2, stokes="IQUV", nint=1),
    dict(nchan=2, nblk=NTAP + 1, stokes="XXYY", nint=1, fqav_by=4,
         channel_block=1),
], ids=["I-nint2", "IQUV", "XXYY-fqav4-blocked"])
def test_fused_plan_matches_blit_fused_and_numpy(case):
    case = dict(case)
    nchan, nblk = case.pop("nchan"), case.pop("nblk")
    fqav_by = case.get("fqav_by", 1)
    channel_block = case.pop("channel_block", 0)
    v = _volts(nchan, nblk, seed=nblk)
    h = bch.pfb_coeffs(NTAP, NFFT)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h), nfft=NFFT,
                                     **case, **FUSED))
    assert bch.last_kernel_plan()["tail_kernel"] == "tail2_detect"
    got = tch.channelize(v, h, nfft=NFFT, channel_block=channel_block,
                         device="cpu", **case)
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["tail_kernel"], plan["impl"]) == (
        "fused1", "tail2_detect", "plain")
    got = got.numpy()
    _close(got, want)
    gold = bch.channelize_np(v, h, nfft=NFFT, ntap=NTAP, nint=case["nint"],
                             stokes=case["stokes"])
    if fqav_by > 1:
        gold = gold.reshape(gold.shape[:-1] + (-1, fqav_by)).sum(-1)
    _close(got, gold)


def test_fused_plan_bf16_matches_blit_and_golden():
    v = _volts(1, NTAP + 1, seed=9)
    h = bch.pfb_coeffs(NTAP, NFFT)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h), nfft=NFFT,
                                     dtype="bfloat16", **FUSED))
    got = tch.channelize(v, h, nfft=NFFT, dtype="bfloat16", device="cpu").numpy()
    assert got.dtype == np.float32
    _close(got, want, rtol=0.05, atol_frac=0.05)
    gold = bch.channelize_np(v, h, nfft=NFFT, ntap=NTAP)
    np.testing.assert_allclose(got / gold.max(), gold / gold.max(), atol=2e-2)


@pytest.mark.parametrize("stokes", ["I", "XX", "YY", "XXYY", "full", "IQUV"])
def test_unfused_plain_path_matches_numpy(stokes):
    nfft, nint = 64, 2
    v = _volts(3, NTAP - 1 + 2 * nint, nfft=nfft, seed=3)
    h = bch.pfb_coeffs(NTAP, nfft)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["tail_kernel"], plan["detect_kernel"]) == (
        "pallas", "dft_last", "torch")
    want = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint, stokes=stokes)
    assert got.shape == want.shape == (2, bch.STOKES_NIF[stokes], 3 * nfft)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_unfused_matches_blit_default_path():
    nfft = 1024
    v = _volts(2, NTAP + 3, nfft=nfft, seed=4)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h), nfft=nfft,
                                     nint=4, fqav_by=8))
    got = tch.channelize(v, h, nfft=nfft, nint=4, fqav_by=8, device="cpu").numpy()
    _close(got, want)


def test_header_and_frame_accounting_match_blit():
    raw = dict(OBSNCHAN=64, OBSFREQ=8437.5, OBSBW=-187.5, TBIN=3.4e-7,
               SRC_NAME="SYNTH", STT_IMJD=59897, STT_SMJD=21221, STT_OFFS=0.5)
    for stokes in ("I", "IQUV"):
        assert tch.output_header(raw, nfft=NFFT, nint=2, stokes=stokes) == \
            bch.output_header(raw, nfft=NFFT, nint=2, stokes=stokes)
    for args in ((11 * NFFT, NFFT, 4, 1), (8 * 64 + 5, 64, 4, 2), (100, 64, 4, 1)):
        assert tch.usable_frames(*args) == bch.usable_frames(*args)


def test_guards():
    v = np.zeros((1, 6 * 64, 2, 2), np.int8)
    h = bch.pfb_coeffs(NTAP, 64)
    with pytest.raises(ValueError, match="dtype"):
        tch.channelize(v, h, nfft=64, dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="fqav_by"):
        tch.channelize(v, h, nfft=64, fqav_by=3, device="cpu")
    with pytest.raises(ValueError, match="nint"):
        tch.channelize(v, h, nfft=64, nint=2, device="cpu")
    assert isinstance(tch.channelize(torch.from_numpy(v), h, nfft=64,
                                     device="cpu"), torch.Tensor)


# rawspec's 0001 and 0002 presets (blit/pipeline.py PRODUCT_PRESETS) and
# the pfb_dequant front end blit's TPU plan takes for each chunk: 0001's
# 131 blocks of 8 pass pallas_pfb.fits; 0002's 2051 blocks of 1024 do not.
SMALL = {"0001": (8, 128, "pallas"), "0002": (1024, 2048, "xla")}


def _blit_small(v, h, product, **kw):
    nfft, nint, front = SMALL[product]
    out = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h), nfft=nfft,
                                    nint=nint, fft_method="matmul",
                                    pfb_kernel=front, **kw))
    assert bch.last_kernel_plan()["pfb_kernel"] == front
    return out


@pytest.mark.parametrize("stokes", ["I", "XX", "YY", "XXYY", "full", "IQUV"])
@pytest.mark.parametrize("product", ["0001", "0002"])
def test_small_nfft_products_match_blit(product, stokes):
    nfft, nint, _ = SMALL[product]
    v = _volts(2, NTAP - 1 + nint, nfft=nfft, seed=nint + len(stokes))
    h = bch.pfb_coeffs(NTAP, nfft)
    want = _blit_small(v, h, product, stokes=stokes)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["tail_kernel"], plan["detect_kernel"],
            plan["impl"]) == ("pallas", "dft_last", "torch", "plain")
    assert got.shape == want.shape == (1, bch.STOKES_NIF[stokes], 2 * nfft)
    _close(got, want)


@pytest.mark.parametrize("product", ["0001", "0002"])
def test_small_nfft_products_bf16_within_blit_bound(product):
    nfft, nint, _ = SMALL[product]
    v = _volts(2, NTAP - 1 + nint, nfft=nfft, seed=5)
    h = bch.pfb_coeffs(NTAP, nfft)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, dtype="bfloat16",
                         device="cpu").numpy()
    assert got.dtype == np.float32
    gold = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint)
    want = _blit_small(v, h, product, dtype="bfloat16")
    for ref in (gold, want):
        scale = ref.max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=2e-2)


@pytest.mark.parametrize("nfft,nchan,nint,plan,blit_kw", [
    (1 << 13, 2, 2, ("fused1", "dft_last"), dict(pfb_kernel="fused1")),
    (6144, 2, 2, ("fused1", "dft_last"), dict(pfb_kernel="fused1")),
    # 2^21: blit's plan on the TPU, pfb_dft1 then dft_tail2 (interpreted).
    (1 << 21, 1, 1, ("fused1", "dft_tail2"),
     dict(pfb_kernel="fused1", tail_kernel="pallas")),
], ids=["2^13", "6144", "2^21"])
def test_multi_factor_plan_rows_match_blit(nfft, nchan, nint, plan, blit_kw):
    v = _volts(nchan, NTAP - 1 + nint, nfft=nfft, seed=nfft % 97)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(
        jnp.asarray(v), jnp.asarray(h), nfft=nfft, nint=nint, stokes="IQUV",
        fft_method="matmul", **{"tail_kernel": "xla", "detect_kernel": "xla",
                                **blit_kw}))
    if nfft == 1 << 21:
        assert bch.last_kernel_plan()["tail_kernel"] == "dft_tail2"
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes="IQUV",
                         device="cpu").numpy()
    p = tch.last_kernel_plan()
    assert (p["pfb_kernel"], p["tail_kernel"], p["detect_kernel"]) == plan + (
        "torch",)
    _close(got, want)
    gold = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint, stokes="IQUV")
    _close(got, gold)


def test_channelize_twins_repeat_the_plan():
    v = _volts(2, NTAP + 1, nfft=6144, seed=8)
    h = bch.pfb_coeffs(NTAP, 6144)
    got = tch.channelize(v, h, nfft=6144, nint=2, stokes="XXYY", device="cpu")
    plan = tch.last_kernel_plan()
    twins = tch.channelize_twins(v, h, nfft=6144, nint=2, stokes="XXYY",
                                 device="cpu")
    assert tch.last_kernel_plan() == plan
    torch.testing.assert_close(got, twins, rtol=0, atol=0)


@pytest.mark.parametrize("stokes", ["I", "XX"])
def test_one_pol_takes_the_unfused_path_on_cpu(stokes):
    # One pol under "auto": the FIR in torch ops (blit's "xla" front, as
    # its pol_ok gate sends one-pol input on the TPU), then the matmul
    # DFT through dft_last's route.
    nfft, nint = 64, 2
    v = _volts(2, NTAP - 1 + 2 * nint, nfft=nfft, seed=6)[:, :, :1]
    h = bch.pfb_coeffs(NTAP, nfft)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["pfb_kernel"], plan["tail_kernel"]) == (
        "matmul", "torch", "dft_last")
    want = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint, stokes=stokes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("stokes", ["I", "XX"])
def test_one_pol_direct_method_takes_torch_fft(stokes):
    nfft, nint = 64, 2
    v = _volts(2, NTAP - 1 + 2 * nint, nfft=nfft, seed=6)[:, :, :1]
    h = bch.pfb_coeffs(NTAP, nfft)
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         fft_method="direct", device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["pfb_kernel"], plan["tail_kernel"]) == (
        "direct", "torch", "torch")
    want = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint, stokes=stokes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_unfactorable_nfft_raises():
    # 2 × a prime above DIRECT_DFT_MAX: the matmul DFT has no
    # factorization, so an explicit fft_method="matmul" raises, as in
    # blit; "auto" takes torch.fft as blit does off the TPU ("four_step"
    # above 8192) and returns blit's product.
    nfft = 2 * 4099
    v = _volts(1, 5, nfft=nfft, seed=9)
    h = bch.pfb_coeffs(NTAP, nfft)
    with pytest.raises(NotImplementedError, match="factorization"):
        tch.channelize(v, h, nfft=nfft, fft_method="matmul", device="cpu")
    got = tch.channelize(v, h, nfft=nfft, nint=2, device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["pfb_kernel"], plan["tail_kernel"]) == (
        "four_step", "pallas", "torch")
    want = np.asarray(bch.channelize(v, h, nfft=nfft, ntap=NTAP, nint=2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
