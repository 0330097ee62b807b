"""GUPPI RAW voltages → high-resolution filterbank: the channelizer.

Counterpart of ``blit/ops/channelize.py``::

    int8 voltages (nchan_coarse, ntime, npol, 2)
      → dequant → ntap-tap polyphase FIR (fftshift folded into the window)
      → nfft-point DFT per coarse channel → Stokes detect
      → integrate by nint → fqav epilogue
      → (ntime_out, nif, nchan_coarse*nfft) float32, channel fastest

The plan follows ``blit``'s rules, in ``blit``'s order, with the Hopper
kernels' fit gates in place of the TPU's VMEM gates; ``"auto"`` means the
plan ``blit`` resolves on the TPU (``fft_method="matmul"``), and for an
nfft :func:`default_factors` cannot split the one ``blit`` resolves off
it (``torch.fft``: ``"direct"`` up to 8192, ``"four_step"`` above).
Under ``"auto"``, for two-pol input and every nfft
:func:`default_factors` splits:

- ``pfb_dft1`` (dequant + PFB + DFT stage 1, :mod:`blit_torch.ops.pfb`)
  when nfft has >= 2 factors and its gate passes; then ``tail2_detect``
  (levels 2 and 3 + detect, :mod:`blit_torch.ops.detect`) when the
  factors are ``(f1, 128, 64)``, else ``dft_tail2`` (levels 2 and 3 +
  the inner untwist, :mod:`blit_torch.ops.dft`) for three factors inside
  its gate (2^21 to 2^23), else the remaining levels through
  ``dft_stage``/``dft_last``; detection in torch ops after either;
- otherwise ``pfb_dequant`` (dequant + PFB), then the whole DFT through
  ``dft_stage``/``dft_last`` (one factor: ``dft_last`` alone — the
  ``0001`` and ``0002`` products) and detection in torch ops.

One-pol input takes the FIR in torch ops (``pfb_kernel="xla"``), then
the DFT levels through the kernels, as ``blit``'s ``pol_ok`` gate sends
it on the TPU.  The opt-in knobs add the other routes of ``blit``:
``detect_kernel="pallas"`` (``pfb_dft1``, the remaining levels in
twisted order, then ``detect_untwist_i``, which detects and untwists in
one pass), ``dft_order="twisted"`` without ``pfb_dft1`` (detect the
twisted spectra, untwist the power), ``pfb_kernel="xla"``, and
``fft_method="direct"``/``"four_step"`` (``torch.fft``, as ``blit`` runs
``jnp.fft``).  A combination ``blit`` refuses raises ``ValueError``
naming the same knob, and so does an explicit kernel a Hopper gate
refuses.

On a CUDA device every kernel of these routes is a hand-written Hopper
kernel; on the CPU the same plan runs through the kernels' plain twins.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from blit_torch.device import resolve_device
from blit_torch.ops import detect as detect_mod
from blit_torch.ops import dft as dft_mod
from blit_torch.ops import pfb as pfb_mod
from blit_torch.ops.detect import (  # noqa: F401  (re-exported names)
    STOKES_NIF,
    detect_stokes_planar,
)
from blit_torch.ops.dft import (
    default_factors,
    dft_matrices_on,
    twiddles_on,
    untwist,
)
from blit_torch.ops.fqav import fqav as _fqav


def usable_frames(nsamps: int, nfft: int, ntap: int, nint: int) -> int:
    """Whole PFB frames a gap-free span of ``nsamps`` samples yields,
    rounded down to the integration length."""
    frames = nsamps // nfft - ntap + 1
    return (frames // nint) * nint if frames > 0 else 0


def pfb_coeffs(ntap: int, nfft: int, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc prototype filter ``(ntap, nfft)`` f32, unit DC gain —
    built in float64 and cast, bitwise equal to ``blit``'s."""
    n = np.arange(ntap * nfft, dtype=np.float64)
    x = n / nfft - ntap / 2.0
    sinc = np.sinc(x)
    if window == "hamming":
        win = np.hamming(ntap * nfft)
    elif window == "hanning":
        win = np.hanning(ntap * nfft)
    elif window == "rect":
        win = np.ones(ntap * nfft)
    else:
        raise ValueError(f"unknown window {window!r}")
    h = sinc * win
    h /= h.sum()
    return h.reshape(ntap, nfft).astype(np.float32)


def dequantize(voltages: torch.Tensor, dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 ``(..., 2)`` (re, im) → real and imaginary float planes."""
    v = voltages.to(dtype)
    return v[..., 0], v[..., 1]


def pfb_frontend(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Polyphase FIR: ``(..., ntime)`` → tap-weighted frame sums
    ``(..., nframes, nfft)``, ``nframes = ntime//nfft - ntap + 1``."""
    ntap, nfft = coeffs.shape
    ntime = x.shape[-1]
    if ntime % nfft:
        raise ValueError(f"pfb_frontend: ntime={ntime} not a multiple of nfft={nfft}")
    nblk = ntime // nfft
    nframes = nblk - ntap + 1
    if nframes < 1:
        raise ValueError(f"pfb_frontend: need >= {ntap} blocks of {nfft}, got {nblk}")
    blocks = x.reshape(x.shape[:-1] + (nblk, nfft))
    acc = coeffs[0] * blocks[..., 0:nframes, :]
    for k in range(1, ntap):
        acc = acc + coeffs[k] * blocks[..., k:k + nframes, :]
    return acc


# Largest FFT blit runs as one FFT call off the TPU; above it, four-step
# (blit/ops/channelize.py _DIRECT_FFT_MAX).
_DIRECT_FFT_MAX = 8192


def resolve_fft_method(method: str, n: Optional[int] = None) -> str:
    """``"auto"`` → ``"matmul"``: the planar matmul DFT of ``blit``'s TPU
    plan, run through the DFT kernels on CUDA and their twins on the CPU
    — except for an ``n`` that :func:`default_factors` cannot split,
    where it resolves as ``blit`` does off the TPU: ``"direct"`` up to
    8192 (``blit``'s ``_DIRECT_FFT_MAX``), ``"four_step"`` above
    (``torch.fft``).  ``"matmul"``, ``"direct"`` and ``"four_step"`` pass
    through."""
    if method == "auto":
        if n is not None:
            try:
                default_factors(n)
            except NotImplementedError:
                return "direct" if n <= _DIRECT_FFT_MAX else "four_step"
        return "matmul"
    if method not in ("matmul", "direct", "four_step"):
        raise ValueError(f"unknown fft method {method!r}")
    return method


def _four_step_factors(n: int) -> Tuple[int, int]:
    """Split n = n1*n2 with n1, n2 as close as possible (prefer powers of 2)."""
    if n & (n - 1) == 0:
        p = n.bit_length() - 1
        n1 = 1 << (p // 2)
        return n1, n // n1
    n1 = math.isqrt(n)
    while n % n1:
        n1 -= 1
    return n1, n // n1


def fft(z: torch.Tensor, *, method: str) -> torch.Tensor:
    """Complex FFT along the last axis through ``torch.fft``, as
    ``blit.ops.channelize.fft`` through ``jnp.fft``: ``"direct"`` is one
    call, ``"four_step"`` the N = N1·N2 split (two batched FFTs, the
    twiddle, the swap)."""
    n = z.shape[-1]
    if method == "direct":
        return torch.fft.fft(z, dim=-1)
    if method != "four_step":
        raise ValueError(f"unknown fft method {method!r}")
    n1, n2 = _four_step_factors(n)
    if n1 == 1:
        return torch.fft.fft(z, dim=-1)
    # x[j] with j = n2*j1 + j2 → (n1, n2): rows index j1.
    x = z.reshape(z.shape[:-1] + (n1, n2))
    a = torch.fft.fft(x, dim=-2)
    a = a * _four_step_twiddle(n1, n2, z.device)
    # X[k1 + n1*k2] = b[k1, k2].
    b = torch.fft.fft(a, dim=-1)
    return b.transpose(-1, -2).reshape(z.shape)


def fft_planar(fr: torch.Tensor, fi: torch.Tensor, *, method: str = "auto",
               order: str = "natural", use_pallas: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar FFT along the last axis, f32 out: the dispatch point of
    ``blit.ops.channelize.fft_planar``.  ``method="matmul"`` (what
    ``"auto"`` resolves to) is the planar matmul DFT, each level through
    the kernels (``dft(..., use_pallas=True)``: one ``dft_last`` launch
    for n <= 4096) — ``use_pallas=None`` means on CUDA tensors, False
    runs the plain twins; ``order="twisted"`` skips the levels' swaps
    (:func:`blit_torch.ops.dft.untwist` restores them).  ``"direct"`` and
    ``"four_step"`` go through :func:`fft` (``torch.fft``, bf16 planes
    widened to f32) and always emit natural order."""
    method = resolve_fft_method(method, fr.shape[-1])
    if method == "matmul":
        if use_pallas is None:
            use_pallas = fr.device.type == "cuda"
        return dft_mod.dft(fr.contiguous(), fi.contiguous(),
                           use_pallas=use_pallas, order=order)
    z = fft(torch.complex(fr.to(torch.float32), fi.to(torch.float32)),
            method=method)
    return z.real.contiguous(), z.imag.contiguous()


def integrate(power: torch.Tensor, nint: int) -> torch.Tensor:
    """Sum groups of ``nint`` consecutive frames (axis -2)."""
    if nint <= 1:
        return power
    nframes = power.shape[-2]
    if nframes % nint:
        raise ValueError(f"integrate: nint={nint} does not divide nframes={nframes}")
    shape = power.shape[:-2] + (nframes // nint, nint, power.shape[-1])
    return power.reshape(shape).sum(dim=-2)


# Plan of the most recent channelize call (read via last_kernel_plan()).
_LAST_PLAN: dict = {}


def last_kernel_plan() -> dict:
    """The plan the most recent :func:`channelize` call ran, under
    ``blit``'s keys and values where the two agree: ``fft_method`` is the
    resolved ``"matmul"``, ``"direct"`` or ``"four_step"``;
    ``pfb_kernel`` is ``"fused1"`` (``pfb_dft1``), ``"pallas"``
    (``pfb_dequant``, ``blit``'s name for it) or ``"torch"`` (the FIR in
    torch ops, ``blit``'s ``"xla"``); ``tail_kernel`` is
    ``"tail2_detect"``, ``"dft_tail2"``, ``"dft_last"``,
    ``"dft_stage+dft_last"`` (the levels through the DFT kernels) or
    ``"torch"`` (``torch.fft``); ``detect_kernel`` is ``"tail2_detect"``,
    ``"detect_untwist_i"`` or ``"torch"``; ``dft_order`` is
    ``"twisted"`` only where the power is untwisted after detection
    (``blit``'s meaning); ``impl`` is ``"cuda"`` (the Hopper kernels) or
    ``"plain"`` (their PyTorch twins)."""
    return dict(_LAST_PLAN)


_KNOBS = {
    "dft_order": ("auto", "twisted", "natural"),
    "pfb_kernel": ("auto", "xla", "pallas", "fused1"),
    "detect_kernel": ("auto", "xla", "pallas"),
    "tail_kernel": ("auto", "xla", "pallas"),
}


def _levels(factors) -> str:
    return "dft_last" if len(factors) == 1 else "dft_stage+dft_last"


def _resolve_plan(nfft: int, npol: int, stokes: str, *, ntap: int = 4,
                  fft_method: str = "auto", dft_order: str = "auto",
                  pfb_kernel: str = "auto", tail_kernel: str = "auto",
                  detect_kernel: str = "auto"):
    """→ (route, factors, plan record): ``blit``'s resolution
    (``blit/ops/channelize.py:410-563``) in its order, with the Hopper
    gates — ``pfb.fits`` for ``fused1``, ``detect.fits`` for
    ``tail2_detect``, ``detect.untwist_fits`` for ``detect_untwist_i``,
    ``dft.tail2_fits`` for ``dft_tail2`` — in place of the VMEM gates.
    Raises ``ValueError`` naming the knob where ``blit`` refuses, or
    where a gate refuses an explicit kernel; ``NotImplementedError``
    where an explicit ``fft_method="matmul"`` has no factorization
    (``"auto"`` then takes ``torch.fft``, see :func:`resolve_fft_method`)."""
    for knob, value in (("dft_order", dft_order), ("pfb_kernel", pfb_kernel),
                        ("detect_kernel", detect_kernel),
                        ("tail_kernel", tail_kernel)):
        if value not in _KNOBS[knob]:
            raise ValueError(f"bad {knob} {value!r}")
    method = resolve_fft_method(fft_method, nfft)
    twisted = method == "matmul" and dft_order == "twisted"
    factors = None
    if method == "matmul":
        try:
            factors = default_factors(nfft)
        except NotImplementedError:
            raise NotImplementedError(
                f"channelize: no supported DFT factorization for nfft={nfft}")

    # The front: the fullest fusion whose gate passes, as blit on the TPU.
    two_pol = npol == 2
    if pfb_kernel == "auto":
        pfb_kernel = "xla"
        if two_pol:
            fused = (method == "matmul" and len(factors) >= 2
                     and not twisted  # fused1 emits natural order
                     and pfb_mod.fits(nfft, factors[0], npol, ntap))
            pfb_kernel = "fused1" if fused else "pallas"
    elif pfb_kernel in ("pallas", "fused1"):
        if not two_pol:
            raise ValueError(
                f"pfb_kernel={pfb_kernel!r} needs npol=2 complex int8")
        if pfb_kernel == "fused1":
            if method != "matmul":
                raise ValueError(
                    "pfb_kernel='fused1' fuses the matmul-DFT's first "
                    "stage; it needs fft_method='matmul'")
            if len(factors) < 2:
                raise ValueError(
                    "pfb_kernel='fused1' needs a multi-factor nfft "
                    f"(> {dft_mod.DIRECT_DFT_MAX})")
            if twisted:
                raise ValueError(
                    "pfb_kernel='fused1' emits natural order; it does not "
                    "combine with dft_order='twisted'")
            if not pfb_mod.fits(nfft, factors[0], npol, ntap):
                raise ValueError(
                    f"pfb_kernel='fused1': the Hopper gate (pfb.fits) takes "
                    f"an n1 whose tile of {ntap} taps fits in shared memory "
                    f"(got factors {factors})")

    # The tail and the detection after pfb_dft1.
    fused1 = pfb_kernel == "fused1"
    untwist_ok = td_ok = tail2_ok = False
    if fused1:
        untwist_ok = stokes == "I" and detect_mod.untwist_fits(factors, npol)
        td_ok = detect_mod.fits(factors, npol, stokes)
        tail2_ok = (len(factors) == 3
                    and dft_mod.tail2_fits(factors[1], factors[2]))
    use_td = td_ok and detect_kernel != "xla" and tail_kernel != "xla"
    if detect_kernel == "pallas" and tail_kernel == "pallas" and not use_td:
        raise ValueError(
            "tail_kernel='pallas' with detect_kernel='pallas' (the fused "
            "tail+detect) needs pfb_kernel='fused1', a known stokes "
            "product, and tail2_detect's Hopper gate (detect.fits: factors "
            "(f1, 128, 64), two pols)")
    use_untwist = not use_td and detect_kernel == "pallas" and untwist_ok
    if detect_kernel == "pallas" and not (use_td or use_untwist):
        raise ValueError(
            "detect_kernel='pallas' (without tail_kernel='pallas') needs "
            "pfb_kernel='fused1', stokes='I', and detect_untwist_i's Hopper "
            "gate (detect.untwist_fits: <= 3 DFT factors)")
    use_tail2 = (not use_td and not use_untwist and tail_kernel != "xla"
                 and tail2_ok)
    if tail_kernel == "pallas" and not (use_td or use_tail2):
        raise ValueError(
            "tail_kernel='pallas' needs pfb_kernel='fused1', exactly 3 "
            "DFT factors, and dft_tail2's Hopper gate (dft.tail2_fits)")

    rec = dict(fft_method=method,
               pfb_kernel="torch" if pfb_kernel == "xla" else pfb_kernel,
               detect_kernel="torch",
               dft_order="twisted" if twisted else "natural")
    if use_td:
        route = "tail2_detect"
        rec.update(tail_kernel="tail2_detect", detect_kernel="tail2_detect")
    elif use_untwist:
        route = "untwist"
        rec.update(tail_kernel=_levels(factors[1:]),
                   detect_kernel="detect_untwist_i")
    elif use_tail2:
        route = "fused1_tail2"
        rec.update(tail_kernel="dft_tail2")
    elif fused1:
        route = "fused1"
        rec.update(tail_kernel=_levels(factors[1:]))
    else:
        route = "front"
        rec.update(tail_kernel=_levels(factors) if method == "matmul"
                   else "torch")
    return route, factors, rec


def channelize(
    voltages: Union[np.ndarray, torch.Tensor],
    coeffs: Union[np.ndarray, torch.Tensor],
    *,
    nfft: int,
    ntap: int = 4,
    nint: int = 1,
    stokes: str = "I",
    fft_method: str = "auto",
    dtype: str = "float32",
    fqav_by: int = 1,
    channel_block: int = 0,
    dft_order: str = "auto",
    pfb_kernel: str = "auto",
    detect_kernel: str = "auto",
    tail_kernel: str = "auto",
    device=None,
) -> torch.Tensor:
    """The single-device reduction: int8 voltage block → filterbank slab.

    Args:
      voltages: int8 ``(nchan_coarse, ntime, npol, 2)`` with ``ntime`` a
        multiple of ``nfft`` and ``ntime//nfft >= ntap + nint - 1``;
        npol 1 or 2.
      coeffs: ``(ntap, nfft)`` PFB prototype from :func:`pfb_coeffs`.
      nint: spectra integrated per output sample.
      stokes: detection product (see ``detect_stokes_planar``).
      fft_method: "auto" (= "matmul", or torch.fft where nfft has no
        factorization) | "matmul" | "direct" | "four_step" (see
        :func:`fft_planar` and :func:`resolve_fft_method`).
      dtype: working dtype of the PFB output / stage-1 spectra
        ("float32" | "bfloat16"); the DFT levels after it, detection and
        integration are f32 either way.
      fqav_by: sum every ``fqav_by`` consecutive fine channels (must
        divide ``nfft``); callers map the axis with ``fqav_range``.
      channel_block: if > 0 and < nchan, run groups of this many coarse
        channels one after another (bounded device memory).
      dft_order, pfb_kernel, detect_kernel, tail_kernel: ``blit``'s
        kernel knobs, with its values ("auto" everywhere is its TPU
        plan; see the module docstring and :func:`_resolve_plan`).
      device: where to compute; ``None`` is the CUDA device.

    Returns f32 ``(ntime_out, nif, nchan_coarse*nfft)`` on ``device``,
    fine channels fftshifted within each coarse channel.
    """
    return _channelize(voltages, coeffs, nfft=nfft, ntap=ntap, nint=nint,
                       stokes=stokes, fft_method=fft_method, dtype=dtype,
                       fqav_by=fqav_by, channel_block=channel_block,
                       dft_order=dft_order, pfb_kernel=pfb_kernel,
                       detect_kernel=detect_kernel, tail_kernel=tail_kernel,
                       device=device, twins=False)


def channelize_twins(voltages, coeffs, **kw) -> torch.Tensor:
    """:func:`channelize`'s plan run through the kernels' plain twins on
    any device, the CUDA one included: the reference that checks the
    kernels on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
    No entry point of the port calls it."""
    return _channelize(voltages, coeffs, twins=True, **kw)


def channelize_blocked(voltages, coeffs, *, channel_block: int, **kw
                       ) -> torch.Tensor:
    """``blit``'s name for host-looped channel blocking: :func:`channelize`
    with ``channel_block``, which runs the coarse channels in groups of
    that many, one after another, and joins the products along the
    channel axis."""
    return channelize(voltages, coeffs, channel_block=channel_block, **kw)


@functools.lru_cache(maxsize=32)
def _shift_sign(nfft: int, device: torch.device) -> torch.Tensor:
    """The fftshift folded into the window, on ``device`` (uploaded once):
    multiplying frame sample j by (-1)^j rolls the spectrum by nfft/2;
    nfft is even, so the sign pattern is tap-independent."""
    return torch.from_numpy(
        np.where(np.arange(nfft) % 2 == 0, 1.0, -1.0).astype(np.float32)
    ).to(device)


@functools.lru_cache(maxsize=32)
def _four_step_twiddle(n1: int, n2: int, device: torch.device) -> torch.Tensor:
    """The complex64 four-step twiddles ``exp(-2πi k1 j2 / n)`` on
    ``device`` (uploaded once)."""
    k1 = np.arange(n1).reshape(n1, 1)
    j2 = np.arange(n2).reshape(1, n2)
    tw = np.exp(-2j * np.pi * (k1 * j2) / (n1 * n2)).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _channelize(voltages, coeffs, *, nfft, ntap=4, nint=1, stokes="I",
                fft_method="auto", dtype="float32", fqav_by=1,
                channel_block=0, dft_order="auto", pfb_kernel="auto",
                detect_kernel="auto", tail_kernel="auto", device=None,
                twins=False) -> torch.Tensor:
    dev = resolve_device(device)
    if isinstance(voltages, np.ndarray):
        voltages = torch.from_numpy(voltages)
    if isinstance(coeffs, np.ndarray):
        coeffs = torch.from_numpy(coeffs)
    nchan, ntime, npol, _ = voltages.shape
    if nfft % 2:
        raise ValueError("channelize: nfft must be even")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    if stokes not in STOKES_NIF:
        raise ValueError(f"unknown stokes {stokes!r}")
    if fqav_by > 1 and nfft % fqav_by:
        raise ValueError(f"fqav_by={fqav_by} does not divide nfft={nfft}")
    if tuple(coeffs.shape) != (ntap, nfft):
        raise ValueError(f"coeffs shape {tuple(coeffs.shape)} != ({ntap}, {nfft})")
    route, factors, plan = _resolve_plan(
        nfft, npol, stokes, ntap=ntap, fft_method=fft_method,
        dft_order=dft_order, pfb_kernel=pfb_kernel, tail_kernel=tail_kernel,
        detect_kernel=detect_kernel)
    if npol == 1 and stokes not in ("I", "XX"):
        raise ValueError(f"stokes={stokes!r} needs 2 pols, got 1")
    voltages = voltages.to(dev)
    coeffs = coeffs.to(device=dev, dtype=torch.float32)
    shifted = (coeffs * _shift_sign(nfft, dev)[None, :]).contiguous()

    _LAST_PLAN.clear()
    _LAST_PLAN.update(plan)
    _LAST_PLAN.update(dtype=dtype,
                      impl="cuda" if dev.type == "cuda" and not twins
                      else "plain")

    if channel_block and channel_block < nchan:
        if nchan % channel_block:
            raise ValueError(
                f"channel_block={channel_block} does not divide nchan={nchan}")
        groups = [voltages[c:c + channel_block]
                  for c in range(0, nchan, channel_block)]
    else:
        groups = [voltages]
    run = _ROUTES[route]
    if route == "front":
        run = functools.partial(run, dequant=plan["pfb_kernel"] == "pallas",
                                method=plan["fft_method"],
                                order=plan["dft_order"])
    outs = []
    for v in groups:
        power = run(v.contiguous(), shifted, factors, nint, stokes, dtype,
                    twins)
        outs.append(power.reshape(power.shape[0], power.shape[1], -1))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    if fqav_by > 1:
        out = _fqav(out, fqav_by)
    return out


def _integrate_frames(power, nint):
    """Sum ``nint`` consecutive frames of frame-major ``(t, ...)`` power."""
    if nint <= 1:
        return power
    if power.shape[0] % nint:
        raise ValueError(f"integrate: nint={nint} does not divide "
                         f"nframes={power.shape[0]}")
    return power.reshape((power.shape[0] // nint, nint)
                         + power.shape[1:]).sum(dim=1)


def _detect_integrate(sr, si, nint, stokes) -> torch.Tensor:
    """Natural-order spectra ``(cb, npol, frames, nfft)`` → integrated
    power ``(t, nif, cb, nfft)``."""
    power = detect_stokes_planar(sr, si, stokes)  # (cb, nif, frames, nfft)
    return integrate(power, nint).permute(2, 1, 0, 3)


def _stage1(v, shifted, factors, dtype, twins):
    f1 = factors[0]
    nfft = shifted.shape[1]
    mats = dft_matrices_on(f1, v.device) + twiddles_on(f1, nfft // f1, v.device)
    dft1 = pfb_mod.pfb_dft1_plain if twins else pfb_mod.pfb_dft1
    return dft1(v, shifted, *mats, dtype=dtype)


def _tail2_detect(v, shifted, factors, nint, stokes, dtype, twins):
    """pfb_dft1 + tail2_detect; returns ``(t, nif, cb, nfft)``."""
    ur, ui = _stage1(v, shifted, factors, dtype, twins)
    tail = detect_mod.tail2_detect_plain if twins else detect_mod.tail2_detect
    power = tail(ur, ui, factors[1], factors[2], stokes=stokes)
    del ur, ui
    return _integrate_frames(power, nint)


def _fused1(v, shifted, factors, nint, stokes, dtype, twins, *,
            untwist_detect=False):
    """pfb_dft1 + the remaining levels (dft_stage..., dft_last), then torch
    detect — or, with ``untwist_detect``, the levels in twisted order and
    detect_untwist_i (Stokes I); returns ``(t, nif, cb, nfft)``."""
    ur, ui = _stage1(v, shifted, factors, dtype, twins)
    sr, si = dft_mod.dft_tail(ur, ui, factors, use_pallas=not twins,
                              order="twisted" if untwist_detect else "natural")
    del ur, ui
    if not untwist_detect:
        return _detect_integrate(sr, si, nint, stokes)
    detect = (detect_mod.detect_untwist_i_plain if twins
              else detect_mod.detect_untwist_i)
    power = detect(sr, si, factors)  # (cb, frames, nfft)
    del sr, si
    return integrate(power, nint)[:, None].permute(2, 1, 0, 3)


def _fused1_tail2(v, shifted, factors, nint, stokes, dtype, twins):
    """pfb_dft1 + dft_tail2 + the level-0 swap + torch detect; returns
    ``(t, nif, cb, nfft)``."""
    ur, ui = _stage1(v, shifted, factors, dtype, twins)
    tail = dft_mod.dft_tail2_plain if twins else dft_mod.dft_tail2
    vr, vi = tail(ur, ui, factors[1], factors[2])  # (cb, npol, frames, f1, m)
    del ur, ui
    batch = vr.shape[:3]
    sr = vr.transpose(-1, -2).reshape(batch + (-1,))
    si = vi.transpose(-1, -2).reshape(batch + (-1,))
    del vr, vi
    return _detect_integrate(sr, si, nint, stokes)


def _front(v, shifted, factors, nint, stokes, dtype, twins, *, dequant,
           method, order):
    """pfb_dequant (``dequant``) or the FIR in torch ops, the whole FFT
    (:func:`fft_planar`: the DFT levels, natural or twisted, or
    torch.fft), torch detect and integrate, then the untwist of the power
    in twisted order; returns ``(t, nif, cb, nfft)``."""
    if dequant:
        front = pfb_mod.pfb_dequant_plain if twins else pfb_mod.pfb_dequant
        fr, fi = front(v, shifted, dtype=dtype)
    else:
        work = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        re, im = dequantize(v, work)  # (cb, ntime, npol)
        wc = shifted.to(work)
        fr = pfb_frontend(re.movedim(-1, 1), wc)  # (cb, npol, frames, nfft)
        fi = pfb_frontend(im.movedim(-1, 1), wc)
        del re, im
    sr, si = fft_planar(fr, fi, method=method, order=order,
                        use_pallas=not twins)
    del fr, fi
    power = _detect_integrate(sr, si, nint, stokes)
    return untwist(power, factors) if order == "twisted" else power


_ROUTES = {"tail2_detect": _tail2_detect,
           "untwist": functools.partial(_fused1, untwist_detect=True),
           "fused1_tail2": _fused1_tail2, "fused1": _fused1,
           "front": _front}


def output_header(raw_header: dict, *, nfft: int, nint: int,
                  stokes: str = "I") -> dict:
    """Filterbank header of the channelized product, from a GUPPI RAW
    block header (the same keys, values and order as ``blit``'s, so the
    ``.fil`` header bytes agree)."""
    obsnchan = int(raw_header["OBSNCHAN"])
    obsfreq = float(raw_header["OBSFREQ"])
    obsbw = float(raw_header["OBSBW"])
    tbin = float(raw_header.get("TBIN", 0.0) or 0.0)
    chan_bw = obsbw / obsnchan
    foff = chan_bw / nfft
    c0 = obsfreq - obsbw / 2 + chan_bw / 2
    fch1 = c0 - (nfft / 2) * foff
    return {
        "fch1": fch1,
        "foff": foff,
        "nchans": obsnchan * nfft,
        "nifs": STOKES_NIF[stokes],
        "tsamp": tbin * nfft * nint,
        "nbits": 32,
        "nfpc": nfft,
        "source_name": raw_header.get("SRC_NAME", ""),
        "tstart": _raw_tstart_mjd(raw_header),
    }


def _raw_tstart_mjd(hdr: dict) -> float:
    imjd = float(hdr.get("STT_IMJD", 0))
    smjd = float(hdr.get("STT_SMJD", 0))
    offs = float(hdr.get("STT_OFFS", 0))
    return imjd + (smjd + offs) / 86400.0
