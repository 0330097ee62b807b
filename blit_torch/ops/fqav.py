"""Frequency averaging with the reference's semantics.

Counterpart of ``blit/ops/fqav.py``.  Channel is the fastest-varying
(last) axis of the canonical ``(time, pol, channel)`` layout, so ``fqav``
reduces groups of ``n`` along the last axis.  It takes torch tensors
(the reducer's on-device averaging) and NumPy arrays (the workers'
host-side averaging of ``get_data`` slabs, with a user's reduction such
as ``np.mean`` or ``np.max``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def fqav(a, n: int, f: Optional[Callable] = None):
    """Reduce every ``n`` consecutive elements of the last axis of ``a``
    with ``f`` (default: sum).  ``n <= 1`` returns ``a``; ``n`` must
    divide the channel count.

    ``f`` is any reduction taking ``(array, axis=...)``, e.g. ``np.sum``,
    ``np.mean``, ``np.max``.  The default sum of a NumPy array is
    ``blit``'s, bit for bit; a torch tensor sums along its last dim."""
    if n <= 1:
        return a
    nchan = a.shape[-1]
    if nchan % n:
        raise ValueError(f"fqav: n={n} does not divide channel count {nchan}")
    grouped = a.reshape(tuple(a.shape[:-1]) + (nchan // n, n))
    if f is not None:
        return f(grouped, axis=-1)
    if isinstance(grouped, np.ndarray):
        return _default_sum(grouped, -1)
    return grouped.sum(dim=-1)


def _default_sum(a: np.ndarray, axis: int) -> np.ndarray:
    if (
        a.dtype in (np.float32, np.float64)
        and axis in (-1, a.ndim - 1)
        # The dot accumulates sequentially (error ~O(n)) where np.sum is
        # pairwise (~O(log n)); huge groups keep the pairwise reduce.
        and a.shape[-1] <= 1024
    ):
        # One BLAS pass over the contiguous group axis instead of numpy's
        # slow small-last-axis reduce; the same bits as blit's.
        return a @ np.ones(a.shape[-1], a.dtype)
    return a.sum(axis=axis)


def fqav_range(fch1: float, foff: float, nchans: int, n: int
               ) -> Tuple[float, float, int]:
    """The ``(fch1, foff, nchans)`` of the channel axis after ``fqav`` by
    ``n``: first frequency ``fch1 + (n-1)*foff/2``, step ``n*foff``
    (always the mean of the first group, whatever the reduction)."""
    if n <= 1:
        return (fch1, foff, nchans)
    return (fch1 + (n - 1) * foff / 2, n * foff, nchans // n)
