"""Carry a ``blit`` reduction's configuration and weights into the port.

The PFB prototype filter (and the DFT/twiddle matrices, which both
packages build the same way from numpy float64) and the beamformer's
phasors are this system's weights.  :func:`reducer_from_reference` builds
the port's :class:`~blit_torch.pipeline.RawReducer` from a ``blit``
``RawReducer``'s fields and its coefficient bank as numpy, so both reduce
with bitwise the same window; :func:`beam_weights_from_reference` and
:func:`coeffs_from_reference` do the same for the array plane's beam
weights and F-engine prototype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from blit_torch.device import resolve_device
from blit_torch.ops.beamform import pack_weights
from blit_torch.ops.dft import Planar
from blit_torch.pipeline import RawReducer

# Fields the port's reducer takes over as they are.
_PORTED = ("nfft", "ntap", "nint", "stokes", "window", "fqav_by", "dtype",
           "chunk_frames", "nbits", "quant_scale", "quant_offset")
# Execution knobs taken over where the blit reducer has a value for them
# (blit leaves prefetch_depth/out_depth None until a tuning profile or its
# default resolves them).
_EXECUTION = ("prefetch_depth", "out_depth", "async_output")


def reducer_from_reference(fields: Dict, coeffs: np.ndarray, *,
                           device=None) -> RawReducer:
    """A port reducer equivalent to the ``blit`` reducer with ``fields``
    (e.g. ``dataclasses.asdict``-style, or a hand-made dict) whose PFB
    bank is ``coeffs`` (``np.asarray(red._coeffs)``).  The product
    fields, quantization included, are taken over; so are
    ``prefetch_depth``, ``out_depth`` and ``async_output`` where given.
    Fields that only steer ``blit``'s tuning or its FFT method are
    ignored."""
    kw = {k: fields[k] for k in _PORTED if k in fields}
    kw.update({k: fields[k] for k in _EXECUTION
               if fields.get(k) is not None})
    red = RawReducer(device=device, **kw)
    coeffs = np.asarray(coeffs)
    if coeffs.dtype != np.float32 or coeffs.shape != (red.ntap, red.nfft):
        raise ValueError(f"coeffs must be float32 ({red.ntap}, {red.nfft}), "
                         f"got {coeffs.dtype} {coeffs.shape}")
    red._pfb_coeffs = torch.from_numpy(coeffs.copy()).to(red.device)
    return red


def beam_weights_from_reference(wr: np.ndarray, wi: np.ndarray, *,
                                layout: str = "antenna",
                                device=None) -> Planar:
    """``blit``'s planar beam weights ``(nbeam, nant, nchan)`` (from
    ``delay_weights_planar``, as numpy) → the port's f32 pair on
    ``device``, packed ``(nchan, nbeam, nant)`` for ``layout="chan"``.
    The values are bitwise ``blit``'s."""
    if layout not in ("antenna", "chan"):
        raise ValueError(f"bad layout {layout!r}")
    wr, wi = np.asarray(wr), np.asarray(wi)
    if wr.dtype != np.float32 or wi.dtype != np.float32 or wr.ndim != 3 \
            or wi.shape != wr.shape:
        raise ValueError(f"weights must be a float32 (nbeam, nant, nchan) "
                         f"pair, got {wr.dtype} {wr.shape} / {wi.dtype} {wi.shape}")
    dev = resolve_device(device)
    pair = (torch.from_numpy(wr.copy()).to(dev), torch.from_numpy(wi.copy()).to(dev))
    return pack_weights(*pair) if layout == "chan" else pair


def coeffs_from_reference(h: np.ndarray, device=None) -> torch.Tensor:
    """``blit``'s ``(ntap, nfft)`` f32 PFB prototype (the correlator's
    ``coeffs``, as numpy) → the same values as a tensor on ``device``."""
    h = np.asarray(h)
    if h.dtype != np.float32 or h.ndim != 2:
        raise ValueError(f"coeffs must be float32 (ntap, nfft), got {h.dtype} {h.shape}")
    return torch.from_numpy(h.copy()).to(resolve_device(device))
