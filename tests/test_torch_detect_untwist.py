"""The port's twisted DFT order, detect_untwist_i and channelize's kernel
knobs held against blit's.

- untwist: exactly blit's (np.array_equal).
- The twisted order: untwist(dft(x, order="twisted")) == dft(x) and the
  same for dft_tail, bitwise (the levels compute the same values; only
  the swaps differ); the port's twisted dft against blit's
  dft(order="twisted", precision=HIGHEST) at tests/test_dft.py:107-121's
  rtol 1e-5 / atol 1e-4.
- detect_untwist_i_plain against blit's detect_untwist_i(interpret=True)
  at tests/test_pallas_detect.py:22-39's cases and bounds (rtol 1e-6,
  atol 1e-5), f32 and bf16 input.
- The routes: (a) detect_kernel="pallas" (pfb_dft1, twisted tail,
  detect_untwist_i), (b) dft_order="twisted" without pfb_dft1, (c) one
  pol / pfb_kernel="xla", (d) fft_method="direct" and "four_step", held
  against blit's channelize on the same explicit knobs (Pallas kernels
  interpreted, fft_method="matmul") at tests/test_pallas_detect.py:41-52's
  rtol 1e-4 / atol 1e-2 of the peak — on noise-only data, so the peak is
  the noise's — and against channelize_np; route (a) also at a
  noise-floor atol of 1e-3 of the mean bin.
- The knob table: for explicit knob values the port raises iff blit
  raises, naming the same knob, and where both run their plan records
  agree under the name map (port "torch" / "dft_last" /
  "dft_stage+dft_last" ↔ blit "xla").  blit's plan record describes its
  most recent TRACE, so each blit plan is read from a fresh trace
  (jax.clear_caches(), then channelize.lower on abstract shapes).
  pfb_kernel="auto" is left out: blit off the TPU resolves it to "xla",
  the port to blit's TPU plan, by design.
"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import channelize as bch  # noqa: E402
from blit.ops import dft as bD  # noqa: E402
from blit.ops import pallas_detect as bpd  # noqa: E402
from blit.pipeline import RawReducer as BlitReducer  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.ops import channelize as tch  # noqa: E402
from blit_torch.ops import detect as tdet  # noqa: E402
from blit_torch.ops import dft as tD  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402

NTAP = 4


def _volts(nchan, nblk, nfft, npol=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-40, 40, (nchan, nblk * nfft, npol, 2), np.int8)


def _close(got, want, rtol=1e-4, atol_frac=1e-2):
    """blit's f32 channelize bound: rtol 1e-4, atol 1e-2 of the peak."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


def _close_floor(got, want):
    """The noise floor: rtol 1e-4, atol 1e-3 of the mean bin."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-3 * np.abs(want).mean())


def _planar(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- untwist and the twisted order -------------------------------------------

@pytest.mark.parametrize("factors", [(8, 4), (8, 4, 4), (16,), (8, 32, 4),
                                     (128, 128, 64)], ids=str)
def test_untwist_equals_blit(factors):
    n = int(np.prod(factors))
    x = np.random.default_rng(1).standard_normal((2, 3, n)).astype(np.float32)
    want = np.asarray(bD.untwist(jnp.asarray(x), factors))
    got = tD.untwist(torch.from_numpy(x), factors).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["twins", "kernels"])
@pytest.mark.parametrize("factors", [(16, 8), (8, 4, 4), (128, 64), (64, 96),
                                     (128, 128, 64)], ids=str)
def test_twisted_dft_untwists_to_natural_bitwise(factors, use_pallas):
    n = int(np.prod(factors))
    xr, xi = _t(*_planar((2, n), seed=n % 13))
    nat = tD.dft(xr, xi, factors=factors, use_pallas=use_pallas)
    twi = tD.dft(xr, xi, factors=factors, use_pallas=use_pallas,
                 order="twisted")
    for a, b in zip(twi, nat):
        assert torch.equal(tD.untwist(a, factors), b)


@pytest.mark.parametrize("factors", [(16, 8), (8, 4, 4), (128, 128, 64)],
                         ids=str)
def test_twisted_dft_tail_untwists_to_natural_bitwise(factors):
    n1, m = factors[0], int(np.prod(factors[1:]))
    ur, ui = _t(*_planar((2, 2, n1, m), seed=m))
    nat = tD.dft_tail(ur, ui, factors)
    twi = tD.dft_tail(ur, ui, factors, order="twisted")
    for a, b in zip(twi, nat):
        assert a.shape == b.shape == (2, 2, n1 * m)
        assert torch.equal(tD.untwist(a, factors), b)


@pytest.mark.parametrize("factors", [(16, 8), (8, 4, 4), (8, 32, 4)], ids=str)
def test_twisted_dft_matches_blit(factors):
    n = int(np.prod(factors))
    xr, xi = _planar((3, n), seed=5)
    want = bD.dft(jnp.asarray(xr), jnp.asarray(xi), factors=factors,
                  precision=jax.lax.Precision.HIGHEST, order="twisted")
    got = tD.dft(*_t(xr, xi), factors=factors, order="twisted")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_bad_order_raises():
    xr, xi = _t(*_planar((1, 64), seed=0))
    with pytest.raises(ValueError, match="order"):
        tD.dft(xr, xi, order="reversed")
    with pytest.raises(ValueError, match="order"):
        tD.dft_tail(xr.reshape(1, 8, 8), xi.reshape(1, 8, 8), (8, 8),
                    order="reversed")


# -- detect_untwist_i's plain version and gate --------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factors,tile_mid,npol", [
    ((8, 4), 16, 2), ((8, 4, 4), 16, 2), ((16,), 16, 2),
    ((8, 32, 4), 16, 2), ((8, 32, 4), 2, 2), ((8, 4, 4), 16, 1),
], ids=["8x4", "8x4x4", "16", "8x32x4", "8x32x4-tile2", "8x4x4-1pol"])
def test_plain_matches_blit_interpreted_kernel(factors, tile_mid, npol, dtype):
    n = int(np.prod(factors))
    sr, si = _planar((2, npol, 3, n), seed=0)
    jr = jnp.asarray(sr).astype(dtype)
    ji = jnp.asarray(si).astype(dtype)
    want = np.asarray(bpd.detect_untwist_i(jr, ji, factors, tile_mid=tile_mid,
                                           interpret=True))
    tdtype = getattr(torch, dtype)
    got = tdet.detect_untwist_i(*[t.to(tdtype) for t in _t(sr, si)], factors)
    assert got.dtype == torch.float32 and got.shape == (2, 3, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(
        got, tdet.detect_untwist_i_plain(*[t.to(tdtype) for t in _t(sr, si)],
                                         factors), rtol=0, atol=0)


def test_untwist_gate():
    assert tdet.untwist_fits((128, 128, 64))
    assert tdet.untwist_fits((128, 128, 64), npol=1)
    assert tdet.untwist_fits((16,))
    # f1 and flast are tiled here: the square 1M split fits, unlike blit's.
    assert tdet.untwist_fits((1000, 1000)) and not bpd.fits((1000, 1000))
    assert not tdet.untwist_fits((8, 4, 4, 2))
    assert not tdet.untwist_fits((128, 128, 64), npol=3)
    assert not tdet.untwist_fits(())
    # The tail2_detect gate keeps its name and meaning.
    assert tdet.fits((128, 128, 64)) and not tdet.fits((128, 64))


def test_detect_untwist_refuses_bad_factors():
    sr, si = _t(*_planar((1, 2, 1, 64), seed=0))
    with pytest.raises(ValueError, match="at most 3"):
        tdet.detect_untwist_i(sr, si, (2, 2, 4, 4))
    with pytest.raises(ValueError, match="multiply"):
        tdet.detect_untwist_i(sr, si, (8, 4))


# -- route (a): pfb_dft1 → twisted tail → detect_untwist_i --------------------

ROUTE_A = dict(fft_method="matmul", pfb_kernel="fused1", detect_kernel="pallas")


def test_route_a_2pow13_matches_blit_and_numpy():
    # blit's own case (tests/test_pallas_detect.py:41-52): 2 channels,
    # 7 blocks, nint 2; two factors (128, 64), so mid = 1.
    nfft, nint = 1 << 13, 2
    v = _volts(2, 7, nfft, seed=4)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h),
                                     nfft=nfft, nint=nint, **ROUTE_A))
    assert bch.last_kernel_plan()["detect_kernel"] == "detect_untwist_i"
    for kw in (dict(detect_kernel="pallas"), ROUTE_A):
        got = tch.channelize(v, h, nfft=nfft, nint=nint, device="cpu", **kw)
        plan = tch.last_kernel_plan()
        assert (plan["pfb_kernel"], plan["tail_kernel"], plan["detect_kernel"],
                plan["dft_order"]) == ("fused1", "dft_last", "detect_untwist_i",
                                       "natural")
        got = got.numpy()
        _close(got, want)
        _close_floor(got, want)
    gold = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint)
    _close(got, gold)
    default = tch.channelize(v, h, nfft=nfft, nint=nint, device="cpu").numpy()
    _close_floor(got, default)


@pytest.mark.parametrize("nframes", [1, 2])
def test_route_a_2pow20_matches_blit_and_numpy(nframes):
    nfft = 1 << 20
    v = _volts(1, NTAP - 1 + nframes, nfft, seed=nframes)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h),
                                     nfft=nfft, nint=nframes,
                                     tail_kernel="xla", **ROUTE_A))
    assert bch.last_kernel_plan()["detect_kernel"] == "detect_untwist_i"
    got = tch.channelize(v, h, nfft=nfft, nint=nframes, tail_kernel="xla",
                         detect_kernel="pallas", device="cpu")
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["tail_kernel"], plan["detect_kernel"]) == (
        "fused1", "dft_stage+dft_last", "detect_untwist_i")
    got = got.numpy()
    _close(got, want)
    _close_floor(got, want)
    gold = bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nframes)
    _close(got, gold)


# -- route (b): dft_order="twisted" without pfb_dft1 --------------------------

@pytest.mark.parametrize("nfft,stokes", [(1024, "I"), (1 << 13, "I"),
                                         (6144, "I"), (1 << 13, "IQUV")],
                         ids=["1024", "2^13", "6144", "2^13-IQUV"])
def test_route_b_matches_blit_and_numpy(nfft, stokes):
    nint = 2
    v = _volts(2, NTAP - 1 + 2 * nint, nfft, seed=nfft % 89)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(
        jnp.asarray(v), jnp.asarray(h), nfft=nfft, nint=nint, stokes=stokes,
        fft_method="matmul", pfb_kernel="pallas", dft_order="twisted"))
    assert bch.last_kernel_plan()["dft_order"] == "twisted"
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         dft_order="twisted", device="cpu")
    plan = tch.last_kernel_plan()
    assert (plan["pfb_kernel"], plan["dft_order"], plan["detect_kernel"]) == (
        "pallas", "twisted", "torch")
    got = got.numpy()
    _close(got, want)
    _close(got, bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint,
                                  stokes=stokes))
    # Only transposes differ from the natural route: bitwise equal.
    natural = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                             device="cpu").numpy()
    assert np.array_equal(got, natural)


# -- routes (c) and (d): one pol, the torch FIR, torch.fft --------------------

@pytest.mark.parametrize("nfft,tail", [(1024, "dft_last"),
                                       (1 << 13, "dft_stage+dft_last")])
@pytest.mark.parametrize("stokes", ["I", "XX"])
def test_one_pol_matches_blit_matmul_and_numpy(nfft, tail, stokes):
    nint = 2
    v = _volts(2, NTAP - 1 + 2 * nint, nfft, npol=1, seed=nfft % 31)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h),
                                     nfft=nfft, nint=nint, stokes=stokes,
                                     fft_method="matmul"))
    assert bch.last_kernel_plan()["pfb_kernel"] == "xla"
    got = tch.channelize(v, h, nfft=nfft, nint=nint, stokes=stokes,
                         device="cpu")
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["pfb_kernel"], plan["tail_kernel"],
            plan["detect_kernel"]) == ("matmul", "torch", tail, "torch")
    got = got.numpy()
    assert got.shape == (2, 1, 2 * nfft)
    _close(got, want)
    _close(got, bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint,
                                  stokes=stokes))


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("method", ["direct", "four_step"])
def test_fft_methods_match_blit(method, npol):
    nfft, nint = 1 << 13, 1
    v = _volts(2, NTAP + 1, nfft, npol=npol, seed=npol)
    h = bch.pfb_coeffs(NTAP, nfft)
    want = np.asarray(bch.channelize(jnp.asarray(v), jnp.asarray(h),
                                     nfft=nfft, nint=nint, fft_method=method))
    got = tch.channelize(v, h, nfft=nfft, nint=nint, fft_method=method,
                         device="cpu")
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["tail_kernel"], plan["pfb_kernel"]) == (
        method, "torch", "pallas" if npol == 2 else "torch")
    _close(got.numpy(), want)
    matmul = tch.channelize(v, h, nfft=nfft, nint=nint, device="cpu").numpy()
    _close_floor(got.numpy(), matmul)


def test_fft_four_step_matches_numpy():
    z = np.random.default_rng(2).standard_normal((3, 4096)) * (1 + 1j)
    z = z.astype(np.complex64)
    got = tch.fft(torch.from_numpy(z), method="four_step").numpy()
    want = np.fft.fft(z)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    with pytest.raises(ValueError, match="fft method"):
        tch.fft(torch.from_numpy(z), method="bluestein")


def test_one_pol_reducer_matches_blit(tmp_path):
    path = str(tmp_path / "onepol.raw")
    nfft = 1024
    ttesting.synth_raw(path, nblocks=3, obsnchan=2, ntime_per_block=8 * nfft,
                       npol=1, seed=11, tone_chan=1, tone_freq=0.25)
    bhdr, want = BlitReducer(nfft=nfft, nint=2, chunk_frames=6,
                             async_output=False).reduce(path)
    for method in ("auto", "direct"):
        red = RawReducer(nfft=nfft, nint=2, chunk_frames=6, fft_method=method,
                         device="cpu")
        hdr, got = red.reduce(path)
        assert tch.last_kernel_plan()["fft_method"] == (
            "matmul" if method == "auto" else "direct")
        assert hdr == bhdr
        assert got.shape == want.shape == (10, 1, 2 * nfft)
        # atol from the noise-only coarse channel 0 (the tone is in 1).
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-2 * np.abs(want[..., :nfft]).max())


@pytest.mark.parametrize("method", ["auto", "direct", "four_step"])
def test_one_pol_unfactorable_nfft_needs_a_torch_fft_method(method):
    # The matmul DFT has no factorization for 2 × a prime above
    # DIRECT_DFT_MAX; torch.fft does.  "auto" resolves to it as blit does
    # off the TPU ("four_step" above 8192); an explicit "matmul" raises.
    nfft, nint = 2 * 4099, 1
    v = _volts(1, NTAP, nfft, npol=1, seed=8)
    h = bch.pfb_coeffs(NTAP, nfft)
    if method == "auto":
        with pytest.raises(NotImplementedError, match="factorization"):
            tch.channelize(v, h, nfft=nfft, nint=nint, fft_method="matmul",
                           device="cpu")
    got = tch.channelize(v, h, nfft=nfft, nint=nint, fft_method=method,
                         device="cpu").numpy()
    plan = tch.last_kernel_plan()
    assert (plan["fft_method"], plan["pfb_kernel"], plan["tail_kernel"]) == (
        "four_step" if method == "auto" else method, "torch", "torch")
    _close(got, bch.channelize_np(v, h, nfft=nfft, ntap=NTAP, nint=nint))
    if method == "auto":
        want = np.asarray(bch.channelize(v, h, nfft=nfft, ntap=NTAP, nint=nint))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


# -- channelize_blocked --------------------------------------------------------

@pytest.mark.parametrize("nfft,npol,kw", [
    (1 << 13, 2, dict(detect_kernel="pallas")),
    (1024, 1, dict()),
    (1024, 2, dict(dft_order="twisted", stokes="XXYY")),
], ids=["route-a", "one-pol", "route-b"])
def test_channelize_blocked_equals_channelize(nfft, npol, kw):
    v = _volts(4, NTAP + 1, nfft, npol=npol, seed=3)
    h = bch.pfb_coeffs(NTAP, nfft)
    whole = tch.channelize(v, h, nfft=nfft, nint=2, device="cpu", **kw)
    blocked = tch.channelize_blocked(torch.from_numpy(v), h, channel_block=2,
                                     nfft=nfft, nint=2, device="cpu", **kw)
    assert torch.equal(blocked, whole)
    with pytest.raises(ValueError, match="channel_block"):
        tch.channelize_blocked(v, h, channel_block=3, nfft=nfft,
                               device="cpu", **kw)


# -- the knob table --------------------------------------------------------------

KNOBS = ("pfb_kernel", "tail_kernel", "detect_kernel", "dft_order",
         "fft_method")
_TO_BLIT = {"pfb_kernel": {"torch": "xla"},
            "tail_kernel": {"torch": "xla", "dft_last": "xla",
                            "dft_stage+dft_last": "xla"},
            "detect_kernel": {"torch": "xla"}}


def _knob(msg: str) -> str:
    """The first knob an error message names."""
    found = re.search("|".join(KNOBS), msg)
    assert found, msg
    return found.group(0)


def _blit_plan(nfft, stokes, kw):
    """blit's plan record from a fresh trace, or the ValueError it raises."""
    jax.clear_caches()
    try:
        bch.channelize.lower(
            jax.ShapeDtypeStruct((1, NTAP * nfft, 2, 2), jnp.int8),
            jax.ShapeDtypeStruct((NTAP, nfft), jnp.float32),
            nfft=nfft, stokes=stokes, **kw)
    except ValueError as e:
        return e
    return bch.last_kernel_plan()


def _port_as_blit(plan):
    rec = {k: _TO_BLIT.get(k, {}).get(v, v) for k, v in plan.items()}
    rec.pop("impl")
    return rec


def _hold(want, port, kw, stokes):
    """Port and blit agree on this knob combination: both raise naming
    the same knob, or both run with matching plans."""
    try:
        got = port()
    except ValueError as e:
        assert isinstance(want, ValueError), (kw, stokes, str(e))
        assert _knob(str(e)) == _knob(str(want)), (kw, stokes, str(e), str(want))
        return "raised"
    assert not isinstance(want, ValueError), (kw, stokes, str(want))
    assert _port_as_blit(got) == want, (kw, stokes)
    return "ran"


TAIL_DETECT = [(t, d) for t in ("auto", "xla", "pallas")
               for d in ("auto", "xla", "pallas")]


@pytest.mark.parametrize("pfb", ["xla", "pallas", "fused1"])
@pytest.mark.parametrize("tail,detect", TAIL_DETECT,
                         ids=[f"{t}-{d}" for t, d in TAIL_DETECT])
def test_knob_table_2pow13_matches_blit(pfb, tail, detect):
    nfft = 1 << 13
    v = _volts(1, NTAP, nfft, seed=0)
    h = bch.pfb_coeffs(NTAP, nfft)
    outcomes = []
    for method in ("matmul", "direct"):
        for order in ("auto", "natural", "twisted"):
            for stokes in ("I", "IQUV"):
                kw = dict(fft_method=method, pfb_kernel=pfb, tail_kernel=tail,
                          detect_kernel=detect, dft_order=order)

                def port():
                    tch.channelize(v, h, nfft=nfft, stokes=stokes,
                                   device="cpu", **kw)
                    return tch.last_kernel_plan()

                outcomes.append(_hold(_blit_plan(nfft, stokes, kw), port,
                                      kw, stokes))
    # Both outcomes occur in most rows; none is only a refusal when the
    # knobs ask for nothing of pfb_dft1.
    if tail != "pallas" and detect != "pallas":
        assert "ran" in outcomes


@pytest.mark.parametrize("tail,detect", TAIL_DETECT,
                         ids=[f"{t}-{d}" for t, d in TAIL_DETECT])
def test_knob_table_2pow20_matches_blit(tail, detect):
    # Three factors (128, 128, 64): tail2_detect is eligible, so the
    # tail and detect knobs pick between it, detect_untwist_i and
    # dft_tail2.  The port's side is its resolution (what channelize runs
    # first).  dft_tail2's Hopper gate takes f3 = 64 as blit's VMEM gate
    # does, so every row equals blit's traced plan.
    nfft = 1 << 20
    assert tD.tail2_fits(128, 64)
    for stokes in ("I", "IQUV"):
        kw = dict(fft_method="matmul", pfb_kernel="fused1", tail_kernel=tail,
                  detect_kernel=detect, dft_order="auto")
        want = _blit_plan(nfft, stokes, kw)

        def port():
            return dict(tch._resolve_plan(nfft, 2, stokes, **kw)[2],
                        dtype="float32", impl="plain")

        _hold(want, port, kw, stokes)


def test_explicit_kernels_the_hopper_gates_refuse_raise():
    # 2^28 has four factors: pfb_dft1's gate passes, detect_untwist_i's
    # refuses.  6144 = 64·96: pfb_dft1's gate takes n1 = 64, as blit's
    # fused1_fits does; it refuses one pol, and fused1 refuses the twisted
    # order.  An n1 whose tile does not fit in shared memory (a window of
    # 64 taps at 2^20) raises naming the gate.
    with pytest.raises(ValueError, match="detect_kernel.*untwist_fits"):
        tch._resolve_plan(1 << 28, 2, "I", detect_kernel="pallas")
    rec = tch._resolve_plan(6144, 2, "I", pfb_kernel="fused1")[2]
    assert (rec["pfb_kernel"], rec["tail_kernel"]) == ("fused1", "dft_last")
    with pytest.raises(ValueError, match="pfb_kernel.*npol=2"):
        tch._resolve_plan(6144, 1, "I", pfb_kernel="fused1")
    with pytest.raises(ValueError, match="pfb_kernel.*twisted"):
        tch._resolve_plan(6144, 2, "I", pfb_kernel="fused1",
                          dft_order="twisted")
    with pytest.raises(ValueError, match="pfb_kernel.*pfb.fits"):
        tch._resolve_plan(1 << 20, 2, "I", ntap=64, pfb_kernel="fused1")
    with pytest.raises(ValueError, match="fft method"):
        tch._resolve_plan(1024, 2, "I", fft_method="bluestein")
    route, _, rec = tch._resolve_plan(1024, 1, "I")
    assert route == "front" and rec["tail_kernel"] == "dft_last"
