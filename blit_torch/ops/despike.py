"""DC-spike repair.

Counterpart of ``blit/ops/despike.py``: each coarse channel's centre fine
channel carries the FFT's DC artifact, and the repair copies its lower
neighbour over it (the reference's commented-out ``loadscan``,
``src/gbt.jl:101-111``).  In the ``(time, pol, chan)`` layout the spike
sits at ``nfpc//2`` within each coarse channel of the last axis.
"""

from __future__ import annotations

import numpy as np


def despike(data, nfpc: int):
    """Return ``data`` with every coarse channel's DC fine channel
    replaced by its lower neighbour along the last (channel) axis.

    NumPy arrays are copied, torch tensors cloned; the input is never
    changed.  ``nfpc`` must divide the channel count and be >= 2."""
    nchan = data.shape[-1]
    if nfpc < 2 or nchan % nfpc:
        raise ValueError(f"despike: nfpc={nfpc} invalid for {nchan} channels")
    spike = nfpc // 2
    src = slice(spike - 1, None, nfpc)
    dst = slice(spike, None, nfpc)
    out = data.copy() if isinstance(data, np.ndarray) else data.clone()
    out[..., dst] = data[..., src]
    return out
