"""Carry a ``blit`` reduction's configuration and weights into the port.

The PFB prototype filter (and the DFT/twiddle matrices, which both
packages build the same way from numpy float64) are this system's
weights.  :func:`reducer_from_reference` builds the port's
:class:`~blit_torch.pipeline.RawReducer` from a ``blit`` ``RawReducer``'s
fields and its coefficient bank as numpy, so both reduce with bitwise
the same window.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from blit_torch.pipeline import RawReducer

# Fields the port's reducer takes over as they are.
_PORTED = ("nfft", "ntap", "nint", "stokes", "window", "fqav_by", "dtype",
           "chunk_frames")
# blit fields that change the product's bytes and are not ported yet,
# with the only value the port reproduces.
_PRODUCT_FIELDS = {"nbits": 32, "quant_scale": 1.0, "quant_offset": 0.0}


def reducer_from_reference(fields: Dict, coeffs: np.ndarray, *,
                           device=None) -> RawReducer:
    """A port reducer equivalent to the ``blit`` reducer with ``fields``
    (e.g. ``dataclasses.asdict``-style, or a hand-made dict) whose PFB
    bank is ``coeffs`` (``np.asarray(red._coeffs)``).  Fields that only
    steer ``blit``'s execution (prefetch depth, output plane, tuning,
    FFT method) are ignored; product-changing ones the port cannot
    reproduce raise."""
    for name, neutral in _PRODUCT_FIELDS.items():
        if name in fields and fields[name] != neutral:
            raise NotImplementedError(
                f"blit field {name}={fields[name]!r} is not ported yet "
                f"(the port writes {name}={neutral!r} products)")
    kw = {k: fields[k] for k in _PORTED if k in fields}
    red = RawReducer(device=device, **kw)
    coeffs = np.asarray(coeffs)
    if coeffs.dtype != np.float32 or coeffs.shape != (red.ntap, red.nfft):
        raise ValueError(f"coeffs must be float32 ({red.ntap}, {red.nfft}), "
                         f"got {coeffs.dtype} {coeffs.shape}")
    red._pfb_coeffs = torch.from_numpy(coeffs.copy()).to(red.device)
    return red
