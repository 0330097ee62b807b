"""Planar (real/imag) DFT helpers: the matrices, twiddles and factor
policy the channelizer's kernels are defined in, plus a plain matmul DFT
tail for the kernels' plain twins.

Counterpart of ``blit/ops/dft.py``.  The matrices are built in float64
with numpy and then cast, exactly as there, so they are bitwise equal to
``blit``'s: the PFB window and these matrices are this system's weights.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

# Largest DFT applied as a single matmul; larger sizes decompose.
DIRECT_DFT_MAX = 4096


@functools.lru_cache(maxsize=32)
def dft_matrices(n: int, dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """(Wr, Wi): the n-point DFT matrix ``W[k, j] = exp(-2πi k j / n)``
    (symmetric).  Entries depend only on ``(k·j) mod n``."""
    k = np.arange(n).reshape(n, 1).astype(np.float64)
    j = np.arange(n).reshape(1, n).astype(np.float64)
    ang = -2.0 * np.pi * ((k * j) % n) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=32)
def twiddles(n1: int, n2: int, dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """(Tr, Ti): four-step twiddles ``exp(-2πi k1 j2 / (n1 n2))`` shaped
    (n1, n2) — k1 indexes stage-1 output rows, j2 the columns."""
    n = n1 * n2
    k1 = np.arange(n1).reshape(n1, 1).astype(np.float64)
    j2 = np.arange(n2).reshape(1, n2).astype(np.float64)
    ang = -2.0 * np.pi * ((k1 * j2) % n) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def default_factors(n: int) -> Tuple[int, ...]:
    """Factorization policy: peel factors of 128 while the remainder
    exceeds DIRECT_DFT_MAX, so 2^20 → (128, 128, 64).  Non-powers of two
    take an as-square-as-possible two-factor split."""
    if n <= DIRECT_DFT_MAX:
        return (n,)
    if n & (n - 1) == 0:
        factors = []
        while n > DIRECT_DFT_MAX:
            f = min(128, n)
            factors.append(f)
            n //= f
        factors.append(n)
        return tuple(factors)
    n1 = int(math.isqrt(n))
    while n % n1:
        n1 -= 1
    if n1 == 1 or max(n1, n // n1) > DIRECT_DFT_MAX:
        raise NotImplementedError(f"dft: no supported factorization for n={n}")
    return (n1, n // n1)


def as_tensors(arrays, device) -> Tuple[torch.Tensor, ...]:
    """numpy constants → float32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 precision, keeping the f32 dtype — the
    operand rounding a bf16 dot with f32 accumulation applies."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dft_rec(xr, xi, factors, bf16: bool):
    """Planar DFT along the last axis over ``factors``; output in the
    (k_first, ..., k_last) digit order flattened row-major only at the
    leaf — callers assemble natural order."""
    n = xr.shape[-1]
    dev = xr.device
    if len(factors) == 1:
        wr, wi = as_tensors(dft_matrices(n), dev)
        if bf16:
            wr, wi = round_bf16(wr), round_bf16(wi)
        return xr @ wr - xi @ wi, xr @ wi + xi @ wr
    n1 = factors[0]
    n2 = n // n1
    batch = xr.shape[:-1]
    xr_ = xr.reshape(batch + (n1, n2))
    xi_ = xi.reshape(batch + (n1, n2))
    wr, wi = as_tensors(dft_matrices(n1), dev)
    tr, ti = as_tensors(twiddles(n1, n2), dev)
    if bf16:
        wr, wi = round_bf16(wr), round_bf16(wi)
    sr = torch.matmul(wr, xr_) - torch.matmul(wi, xi_)
    si = torch.matmul(wi, xr_) + torch.matmul(wr, xi_)
    ur = sr * tr - si * ti
    ui = sr * ti + si * tr
    if bf16:
        ur, ui = round_bf16(ur), round_bf16(ui)
    vr, vi = _dft_rec(ur, ui, factors[1:], bf16)
    # Output index k = k1 + n1*k2: (k1, k2) → (k2, k1), then flatten.
    vr = vr.transpose(-1, -2).reshape(batch + (n,))
    vi = vi.transpose(-1, -2).reshape(batch + (n,))
    return vr, vi


def dft_tail(ur: torch.Tensor, ui: torch.Tensor, factors: Tuple[int, ...],
             *, bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finish a DFT whose first stage (``n1``-point matmul + twiddle) was
    computed already, as by :func:`blit_torch.ops.pfb.pfb_dft1`: run
    ``factors[1:]`` along the last axis and assemble natural order.

    ``ur, ui``: f32 ``(..., n1, m)``.  Returns f32 ``(..., n1*m)``.
    ``bf16=True`` applies the bf16 operand rounding of the fused tail
    kernel (matrices and post-twiddle intermediates rounded, sums f32);
    the input is taken as already rounded.
    """
    n1, m = ur.shape[-2], ur.shape[-1]
    if factors[0] != n1 or int(np.prod(factors[1:])) != m:
        raise ValueError(f"dft_tail: factors {factors} mismatch ({n1}, {m})")
    batch = ur.shape[:-2]
    vr, vi = _dft_rec(ur, ui, tuple(factors[1:]), bf16)
    vr = vr.transpose(-1, -2).reshape(batch + (n1 * m,))
    vi = vi.transpose(-1, -2).reshape(batch + (n1 * m,))
    return vr, vi
