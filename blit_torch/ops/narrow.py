"""Quantized product narrowing: one rule, a host and a device form.

Counterpart of ``blit/ops/narrow.py``.  SIGPROC ``.fil`` products may
carry ``nbits=8/16`` samples, 4x/2x smaller than the float32 the
reduction computes.  The rule is

    y = clip(rint(x * scale + offset), 0, 2^nbits - 1)  →  uint8 / uint16

- :func:`narrow_host` applies it in numpy (the synchronous path);
- :func:`narrow_device` applies it in torch ops to the reduction's
  output on the device, before the device→host copy, so the readback
  moves the narrow bytes.

The two agree bitwise: ``x * scale`` and ``+ offset`` are two separately
rounded f32 operations on both sides (two torch ops, never fused into an
FMA; the scalars are the f32 values of ``scale`` and ``offset``),
``torch.round`` rounds half to even like ``np.rint``, and the clip to
``[0, 2^nbits - 1]`` comes before an exact cast of small integers.  The
16-bit cast goes through int32 and keeps the low half (``int16`` bits
viewed as ``uint16``), which every device's cast supports.  Not a TPU
kernel (``blit`` computes it in ``jnp``), so torch ops are the port.
"""

from __future__ import annotations

import numpy as np
import torch

NARROW_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.float32}


def check_quant(nbits: int) -> None:
    if nbits not in NARROW_DTYPES:
        raise ValueError(f"nbits={nbits} unsupported (SIGPROC quantized "
                         f"products are 8/16/32)")


def narrow_host(slab: np.ndarray, nbits: int, scale: float = 1.0,
                offset: float = 0.0) -> np.ndarray:
    """Quantize a float32 slab to ``nbits`` (identity for 32)."""
    check_quant(nbits)
    if nbits == 32:
        return np.asarray(slab, np.float32)
    lo, hi = np.float32(0.0), np.float32(2.0 ** nbits - 1)
    y = np.rint(np.asarray(slab, np.float32) * np.float32(scale)
                + np.float32(offset))
    return np.clip(y, lo, hi).astype(NARROW_DTYPES[nbits])


def narrow_device(out: torch.Tensor, nbits: int, scale: float = 1.0,
                  offset: float = 0.0) -> torch.Tensor:
    """The same rule in torch ops on ``out``'s device (identity for
    32): a uint8 or uint16 tensor bitwise equal to :func:`narrow_host`."""
    check_quant(nbits)
    if nbits == 32:
        return out
    y = out.to(torch.float32) * float(np.float32(scale))
    y = y + float(np.float32(offset))
    y = torch.round(y).clamp_(0.0, 2.0 ** nbits - 1)
    if nbits == 8:
        return y.to(torch.uint8)
    return y.to(torch.int32).to(torch.int16).view(torch.uint16)
