"""Site defaults of the search plane and their environment overrides.

Counterpart of the search part of ``blit/config.py``: the four
``SiteConfig.search_*`` knobs with the same defaults,
:func:`search_defaults` with the same ``BLIT_SEARCH_*`` overrides, and
:func:`nfpc_from_foff`, which the ``.h5`` reader needs.  The rest of
``blit``'s ``SiteConfig`` (I/O, serving, streaming) comes with the
planes that read it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

# One GBT coarse channel: 187.5 MHz over 64 channels.
COARSE_MHZ = 187.5 / 64

# Taylor-tree integration window: spectra per drift transform, a power of
# two (the drift resolution is one bin per window).
SEARCH_WINDOW_SPECTRA = 64
# Hits kept per band per window.
SEARCH_TOP_K = 8
# The device-side SNR cut.
SEARCH_SNR_THRESHOLD = 10.0
# Clamp on the searched drift range; None: the full ±(window-1) bins the
# tree computes.
SEARCH_MAX_DRIFT_BINS: Optional[int] = None


def search_defaults() -> Dict:
    """The effective search knobs: the site defaults above with the
    per-process overrides ``BLIT_SEARCH_WINDOW``, ``BLIT_SEARCH_TOP_K``,
    ``BLIT_SEARCH_SNR`` and ``BLIT_SEARCH_MAX_DRIFT`` applied.  Read when
    a reducer is built, not at import.  A negative drift limit means no
    limit: headers encode "unlimited" as -1, and reading that back must
    not turn into a mask that rejects every drift row."""
    max_drift = os.environ.get("BLIT_SEARCH_MAX_DRIFT")
    max_drift = int(max_drift) if max_drift else SEARCH_MAX_DRIFT_BINS
    if max_drift is not None and max_drift < 0:
        max_drift = None
    return {
        "window_spectra": int(os.environ.get(
            "BLIT_SEARCH_WINDOW", SEARCH_WINDOW_SPECTRA)),
        "top_k": int(os.environ.get("BLIT_SEARCH_TOP_K", SEARCH_TOP_K)),
        "snr_threshold": float(os.environ.get(
            "BLIT_SEARCH_SNR", SEARCH_SNR_THRESHOLD)),
        "max_drift_bins": max_drift,
    }


def nfpc_from_foff(foff_mhz: float) -> int:
    """Fine channels per coarse channel implied by a filterbank's channel
    width: ``round(COARSE_MHZ / |foff|)``."""
    return int(round(COARSE_MHZ / abs(foff_mhz)))
