"""``DedopplerReducer``: GUPPI RAW → filterbank spectra → Taylor-tree
drift search → ``.hits`` products, on one device.

Counterpart of ``blit/search/dedoppler.py``, synchronous path (``blit``
under ``async_output=False``):

- the inner reduction is a plain :class:`blit_torch.pipeline.RawReducer`
  (Stokes I, no fqav) streaming spectra slabs to the host;
- the window feed re-chunks that stream into fixed ``(window_spectra,
  nchans)`` windows in a host buffer (pinned on a CUDA device).  Window
  ``w`` covers spectra ``[w·T, (w+1)·T)``; a trailing partial window is
  dropped;
- each window goes up to the device and through
  :func:`blit_torch.ops.dedoppler.dedoppler_hits` (the Taylor tree for
  both drift signs through the Hopper kernel, per-row SNR, threshold and
  per-band top-k); only the packed hit records come back;
- hits are written to the ``.hits`` product (``blit_torch/io/hits.py``)
  window by window.

Search knobs left ``None`` resolve from
:func:`blit_torch.config.search_defaults` (``BLIT_SEARCH_*`` overrides).
``blit``'s ``kernel=`` / ``interpret=`` knobs are gone: the device picks
the path, and the paths agree bitwise.  The async window feed and
readback, ``search_resumable`` with its cursor, and the worker
entry point are later slices (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from blit_torch.config import search_defaults
from blit_torch.io.guppi import GuppiRaw, RawSource, open_raw
from blit_torch.io.hits import HitsWriter, WindowHits
from blit_torch.observability import Timeline
from blit_torch.ops.dedoppler import _check_window, dedoppler_hits
from blit_torch.pipeline import RawReducer
from blit_torch.search.hits import HIT_COLS, Hit, hits_from_packed, hits_to_array


@dataclass
class DedopplerReducer:
    """Configured RAW → ``.hits`` drift search on one device.

    The filterbank knobs (``nfft``/``ntap``/``nint``/``window``/
    ``dtype``/``chunk_frames``) configure the inner reduction exactly as
    on :class:`~blit_torch.pipeline.RawReducer`; the search knobs bound
    the drift transform and hit extraction.  ``device=None`` runs on the
    CUDA device and raises when there is none.
    """

    nfft: int
    ntap: int = 4
    nint: int = 1
    window: str = "hamming"
    dtype: str = "float32"
    # None → blit_torch.config.search_defaults().
    window_spectra: Optional[int] = None
    top_k: Optional[int] = None
    snr_threshold: Optional[float] = None
    max_drift_bins: Optional[int] = None
    chunk_frames: Optional[int] = None
    device: Optional[str] = None
    timeline: Timeline = field(default_factory=Timeline)

    def __post_init__(self):
        d = search_defaults()
        if self.window_spectra is None:
            self.window_spectra = d["window_spectra"]
        if self.top_k is None:
            self.top_k = d["top_k"]
        if self.snr_threshold is None:
            self.snr_threshold = d["snr_threshold"]
        if self.max_drift_bins is None:
            self.max_drift_bins = d["max_drift_bins"]
        if self.max_drift_bins is not None and self.max_drift_bins < 0:
            # -1 is the header's "no limit"; a literal negative limit
            # would mask every drift row.
            self.max_drift_bins = None
        _check_window(self.window_spectra)
        self._red = RawReducer(
            nfft=self.nfft, ntap=self.ntap, nint=self.nint, stokes="I",
            window=self.window, dtype=self.dtype,
            chunk_frames=self.chunk_frames, device=self.device,
            timeline=self.timeline,
        )
        self.device = self._red.device
        self.chunk_frames = self._red.chunk_frames

    # -- identity ----------------------------------------------------------
    def fingerprint_extra(self) -> Dict:
        """The search-specific components of the product identity
        (``blit``'s, merged into a product's content address)."""
        return {
            "product_kind": "hits",
            "window_spectra": int(self.window_spectra),
            "top_k": int(self.top_k),
            "snr_threshold": float(self.snr_threshold),
            "max_drift_bins": (
                None if self.max_drift_bins is None
                else int(self.max_drift_bins)
            ),
        }

    # -- headers -----------------------------------------------------------
    def header_for(self, raw: GuppiRaw) -> Dict:
        """The search product header: the inner filterbank header plus
        the search knobs.  Which path computed the tree is not in it: the
        paths agree bitwise."""
        hdr = self._red.header_for(raw)
        hdr.update(
            search_window_spectra=int(self.window_spectra),
            search_top_k=int(self.top_k),
            search_snr_threshold=float(self.snr_threshold),
            search_max_drift_bins=(
                -1 if self.max_drift_bins is None
                else int(self.max_drift_bins)
            ),
            search_nbands=self._nbands(hdr["nchans"]),
        )
        return hdr

    def _nbands(self, nchans: int) -> int:
        """One band per coarse channel; a channel count that is not
        coarse-aligned searches as a single band."""
        return nchans // self.nfft if nchans % self.nfft == 0 else 1

    def _open_validated(self, raw_src: RawSource) -> Tuple[GuppiRaw, Dict]:
        raw = open_raw(raw_src)
        if raw.nblocks == 0:
            raise ValueError(f"empty or fully truncated RAW file: {raw.path}")
        return raw, self.header_for(raw)

    # -- window feed -------------------------------------------------------
    def _windows(self, raw: GuppiRaw,
                 nchans: int) -> Iterator[Tuple[int, torch.Tensor]]:
        """Yield ``(window index, host window)`` in stream order.  The
        window aliases one host buffer: the consumer is done with it
        before asking for the next."""
        T = self.window_spectra
        buf = torch.empty((T, nchans), dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        filled = 0
        widx = 0
        for slab in self._red.stream(raw):
            data = slab[:, 0, :]  # Stokes-I plane: (nspectra, nchans)
            pos, n = 0, data.shape[0]
            while pos < n:
                take = min(T - filled, n - pos)
                with self.timeline.stage("search.window_fill",
                                         nbytes=take * nchans * 4):
                    host[filled:filled + take] = data[pos:pos + take]
                filled += take
                pos += take
                if filled == T:
                    yield widx, buf
                    widx += 1
                    filled = 0

    # -- the search stream -------------------------------------------------
    def _search_stream(self, raw: GuppiRaw,
                       hdr: Dict) -> Iterator[Tuple[int, List[Hit]]]:
        """Yield ``(window index, hits)`` in stream order."""
        nbands = self._nbands(hdr["nchans"])
        for widx, win in self._windows(raw, hdr["nchans"]):
            t0 = time.perf_counter()
            power = win.to(self.device, non_blocking=True)
            packed = dedoppler_hits(
                power, self.snr_threshold, top_k=self.top_k, nbands=nbands,
                max_drift_bins=self.max_drift_bins)
            packed = packed.cpu().numpy()
            del power
            self.timeline.observe("search.tree_s", time.perf_counter() - t0)
            hits = hits_from_packed(packed, widx, hdr)
            self.timeline.observe("search.hits_per_window", len(hits))
            yield widx, hits

    # -- whole-recording entry points --------------------------------------
    def search(self, raw_src: RawSource) -> Tuple[Dict, List[Hit]]:
        """Search a whole RAW recording in memory → ``(header, hits)``
        in window order."""
        raw, hdr = self._open_validated(raw_src)
        hits: List[Hit] = []
        windows = 0
        try:
            for _, hs in self._search_stream(raw, hdr):
                hits.extend(hs)
                windows += 1
        finally:
            if raw is not raw_src:
                raw.close()
        hdr["search_windows"] = windows
        hdr["search_nhits"] = len(hits)
        return hdr, hits

    def reduce(self, raw_src: RawSource) -> Tuple[Dict, np.ndarray]:
        """Like :meth:`search`, but the hits come back as the dense
        float32 encoding (:func:`blit_torch.search.hits.hits_to_array`)
        under a slab-shaped header, as ``blit``'s product service takes
        them: the real channel count moves to ``search_nchans``."""
        hdr, hits = self.search(raw_src)
        arr = hits_to_array(hits)
        hdr = dict(hdr)
        hdr["search_nchans"] = hdr["nchans"]
        hdr.update(nchans=HIT_COLS, nifs=1, nsamps=len(hits))
        return hdr, arr

    def search_to_file(self, raw_src: RawSource, out_path: str) -> Dict:
        """Search and write a ``.hits`` product (published by renaming
        its ``.partial`` sibling).  Returns the header."""
        raw, hdr = self._open_validated(raw_src)
        w = HitsWriter(out_path, hdr)
        try:
            for widx, hits in self._search_stream(raw, hdr):
                wh = WindowHits(widx, hits)
                with self.timeline.stage("search.write", nbytes=wh.nbytes):
                    w.append(wh)
            with self.timeline.stage("search.close"):  # fsync, rename
                w.close()
        except BaseException:
            w.abort()
            raise
        finally:
            if raw is not raw_src:
                raw.close()
        hdr["search_nhits"] = w.nsamps
        hdr["search_windows"] = w.nwindows
        return hdr
