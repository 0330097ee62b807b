"""Rejoin state of a live product: :class:`StreamCursor`.

Counterpart of ``blit/stream/cursor.py``, with the same fields and
sidecar (``<product>.stream-cursor``, JSON, written through a temporary,
fsync and rename; removed on completion), so either package rejoins a
session the other started.  A live consumer that restarts mid-session
re-attaches to the still-recording session and finishes a product
byte-identical to one that never restarted:

- the identity is the session's path and every output-affecting knob
  (the recording still grows, so its size and mtime cannot be);
- every masked seat persists, and the restarted
  :class:`~blit_torch.stream.plane.LiveRawStream` re-masks it
  (``premasked=``), counting data that has arrived since as late;
- the claim (``frames_done``; for ``.hits`` ``windows_done`` /
  ``byte_offset`` and the ``window_claims`` ledger) counts output made
  durable before the cursor was saved, so a restart truncates any
  unclaimed tail and replays it from the session's bytes.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

log = logging.getLogger("blit_torch.stream")


@dataclass
class StreamCursor:
    """Rejoin state for one live product (module docstring)."""

    path: str                 # the SESSION's path (source.path)
    kind: str                 # "filterbank" | "hits"
    nfft: int
    ntap: int = 4
    nint: int = 1
    stokes: str = "I"
    window: str = "hamming"
    fqav_by: int = 1
    dtype: str = "float32"
    nbits: int = 32
    # The affine quantize rule changes every nbits<32 product byte —
    # identity, like nbits itself (the ReductionCursor rule).
    quant_scale: float = 1.0
    quant_offset: float = 0.0
    compression: str = "none"
    # Search identity (kind="hits"; -1 = not applicable).
    window_spectra: int = -1
    top_k: int = -1
    snr_threshold: float = -1.0
    max_drift_bins: int = -1
    # Progress claims (fsync-before-claim — see module docstring).
    frames_done: int = 0      # filterbank: raw PFB frames written
    windows_done: int = 0     # hits: search windows written
    hits_done: int = 0
    byte_offset: int = 0
    window_claims: Optional[List[List[int]]] = None
    # The degradation ledger: every seat the watermark masked, in seq
    # order — re-masked verbatim on rejoin.
    masked_chunks: List[int] = field(default_factory=list)

    @staticmethod
    def path_for(out_path: str) -> str:
        return out_path + ".stream-cursor"

    def save(self, out_path: str) -> None:
        tmp = self.path_for(out_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.__dict__, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path_for(out_path))

    @classmethod
    def load(cls, out_path: str) -> Optional["StreamCursor"]:
        try:
            with open(cls.path_for(out_path)) as f:
                return cls(**json.load(f))
        except (OSError, ValueError, TypeError):
            return None

    def claim_at(self, windows: int) -> Optional[Tuple[int, int]]:
        """``(byte_offset, hits_done)`` after ``windows`` full windows —
        :func:`blit_torch.io.hits.ledger_claim_at`, the one ledger-resolution
        rule shared with :class:`blit_torch.search.dedoppler.SearchCursor`."""
        from blit_torch.io.hits import ledger_claim_at

        return ledger_claim_at(windows, self.windows_done,
                               self.byte_offset, self.hits_done,
                               self.window_claims)

    def matches(self, red, session_path: str, kind: str,
                compression: Optional[str] = None) -> bool:
        """Does this cursor describe the same session reduced the same
        way?  ``red`` is the configured reducer (RawReducer or
        DedopplerReducer); every output-affecting knob must match — a
        mismatch splices different spectra into one product."""
        if self.path != session_path or self.kind != kind:
            return False
        if self.compression != (compression or "none"):
            return False
        same = (
            self.nfft == red.nfft
            and self.ntap == red.ntap
            and self.nint == red.nint
            and self.stokes == getattr(red, "stokes", "I")
            and self.window == red.window
            and self.fqav_by == getattr(red, "fqav_by", 1)
            and self.dtype == red.dtype
            and self.nbits == getattr(red, "nbits", 32)
            and self.quant_scale == getattr(red, "quant_scale", 1.0)
            and self.quant_offset == getattr(red, "quant_offset", 0.0)
        )
        if not same:
            return False
        if kind == "hits":
            return (
                self.window_spectra == red.window_spectra
                and self.top_k == red.top_k
                and self.snr_threshold == float(red.snr_threshold)
                and self.max_drift_bins == (
                    -1 if red.max_drift_bins is None
                    else int(red.max_drift_bins)
                )
            )
        return True

    @classmethod
    def fresh(cls, red, session_path: str, kind: str,
              compression: Optional[str] = None) -> "StreamCursor":
        """A zero-progress cursor for ``red`` over ``session_path``."""
        kw = dict(
            path=session_path, kind=kind, nfft=red.nfft, ntap=red.ntap,
            nint=red.nint, stokes=getattr(red, "stokes", "I"),
            window=red.window, fqav_by=getattr(red, "fqav_by", 1),
            dtype=red.dtype, nbits=getattr(red, "nbits", 32),
            quant_scale=getattr(red, "quant_scale", 1.0),
            quant_offset=getattr(red, "quant_offset", 0.0),
            compression=compression or "none",
        )
        if kind == "hits":
            kw.update(
                window_spectra=int(red.window_spectra),
                top_k=int(red.top_k),
                snr_threshold=float(red.snr_threshold),
                max_drift_bins=(
                    -1 if red.max_drift_bins is None
                    else int(red.max_drift_bins)
                ),
                window_claims=[],
            )
        return cls(**kw)
