"""Site configuration with BL@GBT defaults.

Counterpart of the parts of ``blit/config.py`` that the port reads:
:class:`SiteConfig` with its data-tree fields (``root``, ``extra``, the
session / player / file regexes, ``hosts``, ``host_prefix``,
``backend``), the worker liveness deadlines, the retry and breaker knobs
with :meth:`SiteConfig.io_retry_policy` /
:meth:`SiteConfig.call_retry_policy`, and the four ``search_*`` knobs;
:data:`DEFAULT`, :func:`datahosts`, :func:`search_defaults` with the same
``BLIT_SEARCH_*`` overrides, and :func:`nfpc_from_foff`, which the
``.h5`` reader needs.  ``blit``'s serving, streaming, mesh and monitor
fields come with the planes that read them.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Pattern

from blit_torch import naming


def datahosts(prefix: str = "") -> List[str]:
    """The 64 BL@GBT host names ``blc00``..``blc77`` (8 bands × 8 banks),
    optionally prefixed for ssh aliases."""
    return [f"{prefix}blc{band}{bank}" for band in range(8) for bank in range(8)]


# GBT BL backend constants: a band of 8 banks covers 1500 MHz, a bank
# 187.5 MHz in 64 coarse channels.
BAND_MHZ = 1500.0
BANK_MHZ = BAND_MHZ / 8
COARSE_PER_BANK = 64
COARSE_MHZ = BANK_MHZ / COARSE_PER_BANK

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


def nfpc_from_foff(foff_mhz: float) -> int:
    """Fine channels per coarse channel implied by a filterbank's channel
    width: ``round(COARSE_MHZ / |foff|)``."""
    return int(round(COARSE_MHZ / abs(foff_mhz)))


@dataclass
class SiteConfig:
    """Everything site-specific, with BL@GBT defaults (the fields of
    ``blit``'s ``SiteConfig`` that the port reads, same names and
    defaults)."""

    root: str = "/datax/dibas"
    extra: str = "GUPPI"
    session_re: Pattern = naming.SESSION_RE
    player_re: Pattern = naming.PLAYER_RE
    file_re: Pattern = naming.DEFAULT_FILE_RE
    # None derives the 64 default hosts from host_prefix.
    hosts: Optional[List[str]] = None
    host_prefix: str = ""
    # Worker-pool backend: "local" | "thread" | "process" | "remote".
    backend: str = "thread"
    # Remote-worker liveness: the per-call reply deadline (opt-in: a
    # whole-scan reduce_raw can run for hours, and a deadline that fires
    # on healthy work kills the agent mid-write; None blocks) and the
    # deadline of the ping that precedes reuse of an idle agent.
    call_timeout: Optional[float] = None
    ping_timeout: Optional[float] = 30.0
    # io_retries: total attempts of worker-side file reads; call_retries:
    # re-dispatches of a remote call after AgentDied / CallTimeout.
    # Jittered exponential backoff; retry_seed pins the jitter.
    io_retries: int = 3
    io_backoff_s: float = 0.05
    io_backoff_max_s: float = 2.0
    call_retries: int = 2
    call_backoff_s: float = 0.5
    call_backoff_max_s: float = 10.0
    retry_jitter: float = 0.5
    retry_seed: Optional[int] = None
    # Per-worker circuit breaker: breaker_threshold consecutive remote
    # failures mark the host degraded (calls fail fast); after
    # breaker_cooldown_s one probe call may close it again.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 60.0
    # The search plane's site defaults (see search_defaults).
    search_window_spectra: int = SEARCH_WINDOW_SPECTRA
    search_top_k: int = SEARCH_TOP_K
    search_snr_threshold: float = SEARCH_SNR_THRESHOLD
    search_max_drift_bins: Optional[int] = SEARCH_MAX_DRIFT_BINS

    def io_retry_policy(self):
        """The :class:`blit_torch.faults.RetryPolicy` of worker-side file
        reads; install it with ``faults.set_io_policy(...)``."""
        from blit_torch import faults

        return faults.RetryPolicy(
            attempts=max(1, self.io_retries), base_s=self.io_backoff_s,
            max_s=self.io_backoff_max_s, jitter=self.retry_jitter,
            seed=self.retry_seed,
        )

    def call_retry_policy(self):
        """The :class:`blit_torch.faults.RetryPolicy` of a pool's remote
        re-dispatch (``attempts = call_retries + 1``)."""
        from blit_torch import faults

        return faults.RetryPolicy(
            attempts=max(0, self.call_retries) + 1,
            base_s=self.call_backoff_s, max_s=self.call_backoff_max_s,
            jitter=self.retry_jitter, seed=self.retry_seed,
        )

    def __post_init__(self):
        if self.hosts is None:
            self.hosts = datahosts(self.host_prefix)

    def with_(self, **kw) -> "SiteConfig":
        from dataclasses import replace

        if "host_prefix" in kw and "hosts" not in kw:
            kw["hosts"] = None  # re-derived from the new prefix
        return replace(self, **kw)


DEFAULT = SiteConfig()


def search_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The effective search knobs: ``config``'s values with the
    per-process overrides ``BLIT_SEARCH_WINDOW``, ``BLIT_SEARCH_TOP_K``,
    ``BLIT_SEARCH_SNR`` and ``BLIT_SEARCH_MAX_DRIFT`` applied.  Read when
    a reducer is built, not at import.  A negative drift limit means no
    limit: headers encode "unlimited" as -1, and reading that back must
    not turn into a mask that rejects every drift row."""
    max_drift = os.environ.get("BLIT_SEARCH_MAX_DRIFT")
    max_drift = int(max_drift) if max_drift else config.search_max_drift_bins
    if max_drift is not None and max_drift < 0:
        max_drift = None
    return {
        "window_spectra": int(os.environ.get(
            "BLIT_SEARCH_WINDOW", config.search_window_spectra)),
        "top_k": int(os.environ.get("BLIT_SEARCH_TOP_K", config.search_top_k)),
        "snr_threshold": float(os.environ.get(
            "BLIT_SEARCH_SNR", config.search_snr_threshold)),
        "max_drift_bins": max_drift,
    }


def _compile(p) -> Pattern:
    """Accept a str or a compiled pattern for every regex option."""
    return re.compile(p) if isinstance(p, str) else p
