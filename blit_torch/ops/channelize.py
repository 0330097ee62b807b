"""GUPPI RAW voltages → high-resolution filterbank: the channelizer.

Counterpart of ``blit/ops/channelize.py``::

    int8 voltages (nchan_coarse, ntime, npol, 2)
      → dequant → ntap-tap polyphase FIR (fftshift folded into the window)
      → nfft-point DFT per coarse channel → Stokes detect
      → integrate by nint → fqav epilogue
      → (ntime_out, nif, nchan_coarse*nfft) float32, channel fastest

On a CUDA device the plan is ``blit``'s fused one: ``fused1`` (dequant +
PFB + DFT stage 1, :func:`blit_torch.ops.pfb.pfb_dft1`) then
``tail2_detect`` (DFT levels 2 and 3 + detect,
:func:`blit_torch.ops.detect.tail2_detect`), both hand-written Hopper
kernels.  It needs ``default_factors(nfft)`` to have exactly three
factors and both kernels' fit gates to pass; any other shape raises on
CUDA.  On the CPU the same plan runs through the plain twins, and other
shapes take the unfused plain path (dequant → FIR → ``torch.fft`` →
detect), as ``blit`` does off the TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from blit_torch.device import resolve_device
from blit_torch.ops import detect as detect_mod
from blit_torch.ops import pfb as pfb_mod
from blit_torch.ops.detect import (  # noqa: F401  (re-exported names)
    STOKES_NIF,
    detect_stokes_planar,
)
from blit_torch.ops.dft import as_tensors, default_factors, dft_matrices, twiddles
from blit_torch.ops.fqav import fqav as _fqav

# ROADMAP item that ports the shapes the CUDA plan does not take yet.
_ROADMAP_NEXT = ("ROADMAP.md Queue 1: 'pfb_dequant and the small-nfft "
                 "presets (0001/0002) on CUDA'")


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
    """The plan the most recent :func:`channelize` call ran: ``blit``'s
    plan names plus ``impl`` — ``"cuda"`` (the Hopper kernels) or
    ``"plain"`` (the PyTorch twins / unfused path)."""
    return dict(_LAST_PLAN)


def _factors_or_none(nfft: int) -> Optional[Tuple[int, ...]]:
    try:
        return default_factors(nfft)
    except NotImplementedError:
        return None


def channelize(
    voltages: Union[np.ndarray, torch.Tensor],
    coeffs: Union[np.ndarray, torch.Tensor],
    *,
    nfft: int,
    ntap: int = 4,
    nint: int = 1,
    stokes: str = "I",
    dtype: str = "float32",
    fqav_by: int = 1,
    channel_block: int = 0,
    device=None,
) -> torch.Tensor:
    """The single-device reduction: int8 voltage block → filterbank slab.

    Args:
      voltages: int8 ``(nchan_coarse, ntime, npol, 2)`` with ``ntime`` a
        multiple of ``nfft`` and ``ntime//nfft >= ntap + nint - 1``.
      coeffs: ``(ntap, nfft)`` PFB prototype from :func:`pfb_coeffs`.
      nint: spectra integrated per output sample.
      stokes: detection product (see ``detect_stokes_planar``).
      dtype: working dtype of the stage-1 spectra ("float32" |
        "bfloat16"); detection and integration are f32 either way.
      fqav_by: sum every ``fqav_by`` consecutive fine channels (must
        divide ``nfft``); callers map the axis with ``fqav_range``.
      channel_block: if > 0 and < nchan, run groups of this many coarse
        channels one after another (bounded device memory).
      device: where to compute; ``None`` is the CUDA device.

    Returns f32 ``(ntime_out, nif, nchan_coarse*nfft)`` on ``device``,
    fine channels fftshifted within each coarse channel.
    """
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
    factors = _factors_or_none(nfft)
    fused = (factors is not None and len(factors) == 3 and npol == 2)
    if dev.type == "cuda":
        if not (fused and pfb_mod.fits(nfft, factors[0], npol)
                and detect_mod.fits(factors, npol, stokes)):
            raise NotImplementedError(
                f"channelize on CUDA runs the fused1 + tail2_detect kernels, "
                f"which need nfft with 3 DFT factors (f1, 128, 64) and 2 pols "
                f"(got nfft={nfft}, factors={factors}, npol={npol}); other "
                f"shapes are {_ROADMAP_NEXT}")
    voltages = voltages.to(dev)
    coeffs = coeffs.to(device=dev, dtype=torch.float32)
    # Fold the fftshift into the window (shift theorem: multiplying frame
    # sample j by (-1)^j rolls the spectrum by nfft/2; nfft is even, so
    # the sign pattern is tap-independent).
    sign = torch.from_numpy(
        np.where(np.arange(nfft) % 2 == 0, 1.0, -1.0).astype(np.float32)
    ).to(dev)
    shifted = (coeffs * sign[None, :]).contiguous()

    _LAST_PLAN.clear()
    if fused:
        _LAST_PLAN.update(fft_method="matmul", pfb_kernel="fused1",
                          tail_kernel="tail2_detect",
                          detect_kernel="tail2_detect")
    else:
        _LAST_PLAN.update(fft_method="fft", pfb_kernel="xla",
                          tail_kernel="xla", detect_kernel="xla")
    _LAST_PLAN.update(impl="cuda" if dev.type == "cuda" else "plain",
                      dtype=dtype)

    if channel_block and channel_block < nchan:
        if nchan % channel_block:
            raise ValueError(
                f"channel_block={channel_block} does not divide nchan={nchan}")
        groups = [voltages[c:c + channel_block]
                  for c in range(0, nchan, channel_block)]
    else:
        groups = [voltages]
    outs = []
    for v in groups:
        v = v.contiguous()
        if fused:
            power = _fused(v, shifted, factors, nint, stokes, dtype)
        else:
            power = _unfused(v, shifted, nint, stokes, dtype)
        outs.append(power.reshape(power.shape[0], power.shape[1], -1))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    if fqav_by > 1:
        out = _fqav(out, fqav_by)
    return out


def _fused(v, shifted, factors, nint, stokes, dtype) -> torch.Tensor:
    """fused1 + tail2_detect; returns ``(t, nif, cb, nfft)``."""
    f1, f2, f3 = factors
    nfft = f1 * f2 * f3
    dev = v.device
    w1r, w1i = as_tensors(dft_matrices(f1), dev)
    t1r, t1i = as_tensors(twiddles(f1, nfft // f1), dev)
    ur, ui = pfb_mod.pfb_dft1(v, shifted, w1r, w1i, t1r, t1i, dtype=dtype)
    power = detect_mod.tail2_detect(ur, ui, f2, f3, stokes=stokes)
    del ur, ui
    if nint > 1:
        if power.shape[0] % nint:
            raise ValueError(f"integrate: nint={nint} does not divide "
                             f"nframes={power.shape[0]}")
        power = power.reshape((power.shape[0] // nint, nint)
                              + power.shape[1:]).sum(dim=1)
    return power


def _unfused(v, shifted, nint, stokes, dtype) -> torch.Tensor:
    """The plain unfused path (CPU only): dequant → FIR → torch.fft →
    detect → integrate; returns ``(t, nif, cb, nfft)``."""
    work = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    re, im = dequantize(v, work)  # (cb, ntime, npol)
    wc = shifted.to(work)
    fr = pfb_frontend(re.movedim(-1, 1), wc).to(torch.float32)
    fi = pfb_frontend(im.movedim(-1, 1), wc).to(torch.float32)
    z = torch.fft.fft(torch.complex(fr, fi), dim=-1)
    power = detect_stokes_planar(z.real, z.imag, stokes)  # (cb, nif, t, nfft)
    power = integrate(power, nint)
    return power.permute(2, 1, 0, 3)


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
