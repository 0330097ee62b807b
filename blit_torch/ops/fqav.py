"""Frequency averaging with the reference's semantics.

Counterpart of ``blit/ops/fqav.py``.  Channel is the fastest-varying
(last) axis of the canonical ``(time, pol, channel)`` layout, so ``fqav``
reduces groups of ``n`` along the last axis.
"""

from __future__ import annotations

from typing import Tuple

import torch


def fqav(a: torch.Tensor, n: int) -> torch.Tensor:
    """Sum every ``n`` consecutive elements of the last axis.  ``n <= 1``
    returns ``a``; ``n`` must divide the channel count."""
    if n <= 1:
        return a
    nchan = a.shape[-1]
    if nchan % n:
        raise ValueError(f"fqav: n={n} does not divide channel count {nchan}")
    return a.reshape(a.shape[:-1] + (nchan // n, n)).sum(dim=-1)


def fqav_range(fch1: float, foff: float, nchans: int, n: int
               ) -> Tuple[float, float, int]:
    """The ``(fch1, foff, nchans)`` of the channel axis after ``fqav`` by
    ``n``: first frequency ``fch1 + (n-1)*foff/2``, step ``n*foff``."""
    if n <= 1:
        return (fch1, foff, nchans)
    return (fch1 + (n - 1) * foff / 2, n * foff, nchans // n)
