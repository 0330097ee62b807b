"""Sample statistics over the time axis.

Counterpart of ``blit/ops/stats.py``: the reference's
``WorkerFunctions.getkurtosis`` takes ``StatsBase.kurtosis``, the
*excess* kurtosis with biased (divide-by-n) central moments.  ``blit``
runs it on the device as a ``jax.jit`` of the same function; here the
same function runs as torch ops on whichever device holds the tensor.
"""

from __future__ import annotations

import numpy as np


def kurtosis(data, axis: int = 0):
    """Excess kurtosis ``m4/m2**2 - 3`` with biased central moments,
    reduced over ``axis`` (default: the time axis of a ``(time, pol,
    chan)`` array, which leaves ``(pol, chan)``).

    Works on NumPy arrays and on torch tensors, in the same arithmetic:
    the mean, the centred squares, their mean and the mean of their
    squares."""
    if isinstance(data, np.ndarray) or not hasattr(data, "dim"):
        mu = data.mean(axis=axis, keepdims=True)
        d = data - mu
        d2 = d * d
        m2 = d2.mean(axis=axis)
        m4 = (d2 * d2).mean(axis=axis)
        return m4 / (m2 * m2) - 3.0
    mu = data.mean(dim=axis, keepdim=True)
    d = data - mu
    d2 = d * d
    m2 = d2.mean(dim=axis)
    m4 = (d2 * d2).mean(dim=axis)
    return m4 / (m2 * m2) - 3.0
