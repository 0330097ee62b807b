"""GUPPI RAW voltages → high-resolution filterbank: the channelizer.

Counterpart of ``blit/ops/channelize.py``::

    int8 voltages (nchan_coarse, ntime, npol, 2)
      → dequant → ntap-tap polyphase FIR (fftshift folded into the window)
      → nfft-point DFT per coarse channel → Stokes detect
      → integrate by nint → fqav epilogue
      → (ntime_out, nif, nchan_coarse*nfft) float32, channel fastest

The plan follows ``blit``'s "fullest fusion first" order, with the Hopper
kernels' fit gates in place of the TPU's VMEM gates.  For two-pol input
and every nfft that :func:`default_factors` splits:

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

On a CUDA device every step of these rows is a hand-written Hopper
kernel; on the CPU the same plan runs through the kernels' plain twins.
One-pol input runs only on the CPU, through the unfused plain path
(dequant → FIR → ``torch.fft`` → detect), as ``blit`` does off the TPU.
"""

from __future__ import annotations

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
from blit_torch.ops.dft import as_tensors, default_factors, dft_matrices, twiddles
from blit_torch.ops.fqav import fqav as _fqav

# ROADMAP item that ports the input the CUDA plan does not take yet.
_ROADMAP_NEXT = "ROADMAP.md Queue 1: 'one-pol input on CUDA'"


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


def fft_planar(fr: torch.Tensor, fi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar DFT along the last axis, natural order, f32 out: the matmul
    DFT of ``blit.ops.channelize.fft_planar`` (``method="matmul"``), which
    ``blit`` runs as XLA matmuls (``use_pallas=False``).  On CUDA tensors
    the port runs each level through its own kernels (``dft(...,
    use_pallas=True)``: one ``dft_last`` launch for n <= 4096); on CPU
    tensors the same levels run through their plain twins."""
    return dft_mod.dft(fr.contiguous(), fi.contiguous(),
                       use_pallas=fr.device.type == "cuda")


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
    ``blit``'s keys: ``pfb_kernel`` is ``"fused1"`` (``pfb_dft1``),
    ``"pallas"`` (``pfb_dequant``, ``blit``'s name for it) or ``"torch"``;
    ``tail_kernel`` is ``"tail2_detect"``, ``"dft_tail2"``, ``"dft_last"``,
    ``"dft_stage+dft_last"`` or ``"torch"``; ``detect_kernel`` is
    ``"tail2_detect"`` or ``"torch"``; ``impl`` is ``"cuda"`` (the Hopper
    kernels) or ``"plain"`` (their PyTorch twins / the unfused path)."""
    return dict(_LAST_PLAN)


def _factors_or_none(nfft: int) -> Optional[Tuple[int, ...]]:
    try:
        return default_factors(nfft)
    except NotImplementedError:
        return None


def _resolve_plan(nfft: int, npol: int, stokes: str, cuda: bool):
    """→ (route, factors, plan record) for this shape, raising where no
    route exists on the device."""
    if npol != 2:
        if cuda:
            raise NotImplementedError(
                f"channelize on CUDA takes two-pol input (got npol={npol}); "
                f"one pol is {_ROADMAP_NEXT}")
        return "unfused", None, dict(fft_method="fft", pfb_kernel="torch",
                                     tail_kernel="torch", detect_kernel="torch")
    factors = _factors_or_none(nfft)
    if factors is None:
        raise NotImplementedError(
            f"channelize: no supported DFT factorization for nfft={nfft}")

    def levels(fs):
        return "dft_last" if len(fs) == 1 else "dft_stage+dft_last"

    if len(factors) >= 2 and pfb_mod.fits(nfft, factors[0], npol):
        if detect_mod.fits(factors, npol, stokes):
            return "tail2_detect", factors, dict(
                fft_method="matmul", pfb_kernel="fused1",
                tail_kernel="tail2_detect", detect_kernel="tail2_detect")
        if len(factors) == 3 and dft_mod.tail2_fits(factors[1], factors[2]):
            return "fused1_tail2", factors, dict(
                fft_method="matmul", pfb_kernel="fused1",
                tail_kernel="dft_tail2", detect_kernel="torch")
        return "fused1", factors, dict(
            fft_method="matmul", pfb_kernel="fused1",
            tail_kernel=levels(factors[1:]), detect_kernel="torch")
    return "dequant", factors, dict(
        fft_method="matmul", pfb_kernel="pallas", tail_kernel=levels(factors),
        detect_kernel="torch")


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
      dtype: working dtype of the PFB output / stage-1 spectra
        ("float32" | "bfloat16"); the DFT levels after it, detection and
        integration are f32 either way.
      fqav_by: sum every ``fqav_by`` consecutive fine channels (must
        divide ``nfft``); callers map the axis with ``fqav_range``.
      channel_block: if > 0 and < nchan, run groups of this many coarse
        channels one after another (bounded device memory).
      device: where to compute; ``None`` is the CUDA device.

    Returns f32 ``(ntime_out, nif, nchan_coarse*nfft)`` on ``device``,
    fine channels fftshifted within each coarse channel.
    """
    return _channelize(voltages, coeffs, nfft=nfft, ntap=ntap, nint=nint,
                       stokes=stokes, dtype=dtype, fqav_by=fqav_by,
                       channel_block=channel_block, device=device,
                       twins=False)


def channelize_twins(voltages, coeffs, **kw) -> torch.Tensor:
    """:func:`channelize`'s plan run through the kernels' plain twins on
    any device, the CUDA one included: the reference that checks the
    kernels on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
    No entry point of the port calls it."""
    return _channelize(voltages, coeffs, twins=True, **kw)


def _channelize(voltages, coeffs, *, nfft, ntap=4, nint=1, stokes="I",
                dtype="float32", fqav_by=1, channel_block=0, device=None,
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
    route, factors, plan = _resolve_plan(nfft, npol, stokes,
                                         dev.type == "cuda")
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
    _LAST_PLAN.update(plan)
    _LAST_PLAN.update(dft_order="natural", dtype=dtype,
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
    mats = as_tensors(dft_matrices(f1) + twiddles(f1, nfft // f1), v.device)
    dft1 = pfb_mod.pfb_dft1_plain if twins else pfb_mod.pfb_dft1
    return dft1(v, shifted, *mats, dtype=dtype)


def _tail2_detect(v, shifted, factors, nint, stokes, dtype, twins):
    """pfb_dft1 + tail2_detect; returns ``(t, nif, cb, nfft)``."""
    ur, ui = _stage1(v, shifted, factors, dtype, twins)
    tail = detect_mod.tail2_detect_plain if twins else detect_mod.tail2_detect
    power = tail(ur, ui, factors[1], factors[2], stokes=stokes)
    del ur, ui
    return _integrate_frames(power, nint)


def _fused1(v, shifted, factors, nint, stokes, dtype, twins):
    """pfb_dft1 + the remaining levels (dft_stage..., dft_last) + torch
    detect; returns ``(t, nif, cb, nfft)``."""
    ur, ui = _stage1(v, shifted, factors, dtype, twins)
    sr, si = dft_mod.dft_tail(ur, ui, factors, use_pallas=not twins)
    del ur, ui
    return _detect_integrate(sr, si, nint, stokes)


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


def _dequant(v, shifted, factors, nint, stokes, dtype, twins):
    """pfb_dequant + the whole DFT (dft_stage..., dft_last) + torch
    detect; returns ``(t, nif, cb, nfft)``."""
    front = pfb_mod.pfb_dequant_plain if twins else pfb_mod.pfb_dequant
    fr, fi = front(v, shifted, dtype=dtype)
    sr, si = dft_mod.dft(fr, fi, factors=factors, use_pallas=not twins)
    del fr, fi
    return _detect_integrate(sr, si, nint, stokes)


def _unfused(v, shifted, factors, nint, stokes, dtype, twins):
    """The plain unfused path (CPU, one pol): dequant → FIR → torch.fft →
    detect → integrate; returns ``(t, nif, cb, nfft)``."""
    work = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    re, im = dequantize(v, work)  # (cb, ntime, npol)
    wc = shifted.to(work)
    fr = pfb_frontend(re.movedim(-1, 1), wc).to(torch.float32)
    fi = pfb_frontend(im.movedim(-1, 1), wc).to(torch.float32)
    z = torch.fft.fft(torch.complex(fr, fi), dim=-1)
    return _detect_integrate(z.real, z.imag, nint, stokes)


_ROUTES = {"tail2_detect": _tail2_detect, "fused1_tail2": _fused1_tail2,
           "fused1": _fused1, "dequant": _dequant, "unfused": _unfused}


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
