"""``DedopplerReducer``: GUPPI RAW → filterbank spectra → Taylor-tree
drift search → ``.hits`` products, on one device.

Counterpart of ``blit/search/dedoppler.py``:

- the inner reduction is a :class:`blit_torch.pipeline.RawReducer`
  (Stokes I, no fqav) streaming spectra slabs to the host;
- a producer thread (:class:`blit_torch.pipeline.BufferRotation`)
  re-chunks that stream into fixed ``(window_spectra, nchans)`` window
  slots from the staging pool (pinned on a CUDA device).  Window ``w``
  covers spectra ``[w·T, (w+1)·T)``; a trailing partial window is
  dropped;
- each window goes up to the device (``non_blocking``) and through
  :func:`blit_torch.ops.dedoppler.dedoppler_hits` (the Taylor tree for
  both drift signs through the Hopper kernel, per-row SNR, threshold and
  per-band top-k); an :class:`blit_torch.outplane.OutputRotation` thread
  reads the packed hits back while the next window is dispatched, and
  frees the window's slot once its event has completed;
- hits are written to the ``.hits`` product (``blit_torch/io/hits.py``)
  through a write-behind :class:`blit_torch.outplane.AsyncSink`.

``async_output=False`` (or ``BLIT_SYNC_OUTPUT=1``) runs each window's
device step and readback on the consumer thread, and the inner reducer
synchronously: the hits are identical.  Search knobs left ``None``
resolve from :func:`blit_torch.config.search_defaults`
(``BLIT_SEARCH_*`` overrides).  ``blit``'s ``kernel=`` / ``interpret=``
knobs are gone: the device picks the path, and the paths agree bitwise.
:meth:`DedopplerReducer.search_resumable` writes the ``.hits`` product
crash-resumably: a :class:`SearchCursor` sidecar claims each window after
its lines are durable, and a re-run restarts at the claimed window
through the inner reducer's ``skip_frames`` replay.  The worker entry
point is a later slice (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from blit_torch import hostmem, integrity
from blit_torch.config import search_defaults
from blit_torch.io.guppi import GuppiRaw, RawSource, open_raw
from blit_torch.io.hits import (
    HitsWriter,
    ResumableHitsWriter,
    WindowHits,
    ledger_claim_at,
)
from blit_torch.observability import Timeline
from blit_torch.ops.dedoppler import _check_window, dedoppler_hits
from blit_torch.outplane import (
    AsyncSink,
    OutputRotation,
    readback_extra_slots,
    record_event,
)
from blit_torch.pipeline import BufferRotation, RawReducer, ReductionCursor
from blit_torch.search.hits import HIT_COLS, Hit, hits_from_packed, hits_to_array

log = logging.getLogger("blit_torch.search.dedoppler")


class _Window:
    """A filled window slot: ``slab`` is its :class:`HostSlab`, valid
    until :meth:`release`."""

    __slots__ = ("slab", "index", "_idx", "_free")

    def __init__(self, slab, index: int, idx: int, free) -> None:
        self.slab = slab
        self.index = index
        self._idx = idx
        self._free = free

    def release(self) -> None:
        if self._free is not None:
            free, self._free = self._free, None
            free(self._idx)


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
    # The planes' knobs, as on RawReducer (the inner reducer takes them).
    prefetch_depth: int = 2
    out_depth: Optional[int] = None
    async_output: bool = True
    output_stall_timeout_s: Optional[float] = None
    device: Optional[str] = None
    timeline: Timeline = field(default_factory=Timeline)

    def __post_init__(self):
        if os.environ.get("BLIT_SYNC_OUTPUT"):
            self.async_output = False
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
            chunk_frames=self.chunk_frames, prefetch_depth=self.prefetch_depth,
            out_depth=self.out_depth, async_output=self.async_output,
            output_stall_timeout_s=self.output_stall_timeout_s,
            device=self.device, timeline=self.timeline,
        )
        self.device = self._red.device
        self.chunk_frames = self._red.chunk_frames
        self.out_depth = self._red.out_depth

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
    def _producer(self, raw: GuppiRaw, skip_windows: int, nchans: int,
                  bufs: List[Optional[hostmem.HostSlab]],
                  rot: BufferRotation) -> None:
        """Fill the window rotation from the inner reducer's spectra
        stream (producer thread), starting at window ``skip_windows``."""
        T = self.window_spectra
        pinned = self.device.type == "cuda"
        cur: Optional[int] = None
        filled = 0
        widx = skip_windows
        skip_frames = skip_windows * T * self.nint
        for slab in self._red._stream(raw, skip_frames):
            data = slab[:, 0, :]  # Stokes-I plane: (nspectra, nchans)
            pos, n = 0, data.shape[0]
            while pos < n:
                if cur is None:
                    cur = rot.acquire()
                    if cur is None:
                        return  # the consumer abandoned the stream
                    if bufs[cur] is None:
                        bufs[cur] = hostmem.slab_pool().take(
                            (T, nchans), np.float32, pinned=pinned,
                            timeline=self.timeline)
                    filled = 0
                take = min(T - filled, n - pos)
                with self.timeline.stage("search.window_fill",
                                         nbytes=take * nchans * 4):
                    bufs[cur].array[filled:filled + take] = data[pos:pos + take]
                filled += take
                pos += take
                if filled == T:
                    rot.emit(cur, widx)
                    widx += 1
                    cur = None

    def _windows(self, raw: GuppiRaw, skip_windows: int, nchans: int,
                 bufs: List[Optional[hostmem.HostSlab]]) -> Iterator[_Window]:
        """The pipelined window feed over ``len(bufs)`` slots (filled in
        as the producer needs them): the consumer must release every
        window once nothing reads its slot."""
        rot = BufferRotation(
            len(bufs),
            lambda r: self._producer(raw, skip_windows, nchans, bufs, r),
            name="blit-search-feed")
        try:
            for idx, widx in rot.slots():
                yield _Window(bufs[idx], widx, idx, rot.release)
        finally:
            rot.close()

    def _slots(self, extra_slots: int = 0) -> List[Optional[hostmem.HostSlab]]:
        return [None] * (max(2, self.prefetch_depth) + max(0, extra_slots))

    @staticmethod
    def _retire(bufs) -> None:
        """Window slots back to the staging pool, once every window's
        dispatch has completed."""
        pool = hostmem.slab_pool()
        for b in bufs:
            pool.give(b)

    def _dispatch(self, win: _Window, nbands: int):
        """The window's H2D copy and search step, launched."""
        power = win.slab.tensor.to(self.device, non_blocking=True)
        return dedoppler_hits(power, self.snr_threshold, top_k=self.top_k,
                              nbands=nbands, max_drift_bins=self.max_drift_bins)

    # -- the search stream -------------------------------------------------
    def _search_stream(self, raw: GuppiRaw, hdr: Dict, skip_windows: int = 0
                       ) -> Iterator[Tuple[int, List[Hit]]]:
        """Yield ``(window index, hits)`` in stream order from window
        ``skip_windows`` on."""
        nchans = hdr["nchans"]
        nbands = self._nbands(nchans)

        def decode(packed: np.ndarray, widx: int) -> List[Hit]:
            hits = hits_from_packed(packed, widx, hdr)
            self.timeline.observe("search.hits_per_window", len(hits))
            return hits

        if not self.async_output:
            bufs = self._slots()
            for win in self._windows(raw, skip_windows, nchans, bufs):
                try:
                    t0 = time.perf_counter()
                    packed = self._dispatch(win, nbands).cpu().numpy()
                    self.timeline.observe("search.tree_s", time.perf_counter() - t0)
                finally:
                    win.release()
                yield win.index, decode(packed, win.index)
            self._retire(bufs)
            return
        def emit(slab) -> Tuple[int, List[Hit]]:
            widx, t0 = slab.payload
            self.timeline.observe("search.tree_s", time.perf_counter() - t0)
            return widx, decode(slab.data, widx)

        depth = max(2, self.out_depth)
        rot = OutputRotation(depth=depth, timeline=self.timeline, reuse=False,
                             name="blit-search-readback",
                             stall_timeout_s=self.output_stall_timeout_s)
        try:
            bufs = self._slots(readback_extra_slots(depth, self.prefetch_depth))
            for win in self._windows(raw, skip_windows, nchans, bufs):
                t0 = time.perf_counter()
                with self.timeline.stage("dispatch", byte_free=True):
                    packed = self._dispatch(win, nbands)
                    ev = record_event(packed)
                slabs = rot.put(packed, event=ev, nbytes=win.slab.nbytes,
                                payload=(win.index, t0), on_consumed=win.release)
                del packed
                for slab in slabs:
                    yield emit(slab)
            for slab in rot.drain():
                yield emit(slab)
            self._retire(bufs)
        finally:
            rot.close()

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

    def _pump(self, raw: GuppiRaw, hdr: Dict, writer,
              skip_windows: int = 0) -> int:
        """Drive the search stream into a ``.hits`` writer (write-behind
        through an :class:`AsyncSink` on the asynchronous plane) and
        finalize it.  Returns the writer's hit count; on error the writer
        is aborted and the error re-raised."""
        if not self.async_output:
            try:
                for widx, hits in self._search_stream(raw, hdr, skip_windows):
                    wh = WindowHits(widx, hits)
                    with self.timeline.stage("search.write", nbytes=wh.nbytes):
                        writer.append(wh)
                with self.timeline.stage("search.close"):  # fsync, rename
                    writer.close()
            except BaseException:
                writer.abort()
                raise
            return writer.nsamps
        sink = AsyncSink(writer, depth=max(2, self.out_depth),
                         timeline=self.timeline,
                         stall_timeout_s=self.output_stall_timeout_s,
                         stage="search.write")
        try:
            for widx, hits in self._search_stream(raw, hdr, skip_windows):
                sink.append(WindowHits(widx, hits))
            with self.timeline.stage("search.close"):  # flush, fsync, rename
                sink.close()
        except BaseException:
            sink.abort()
            raise
        return sink.nsamps

    def search_to_file(self, raw_src: RawSource, out_path: str) -> Dict:
        """Search and write a ``.hits`` product (published by renaming
        its ``.partial`` sibling; byte-identical between the synchronous
        and asynchronous planes).  Returns the header."""
        raw, hdr = self._open_validated(raw_src)
        try:
            w = HitsWriter(out_path, hdr)
            hdr["search_nhits"] = self._pump(raw, hdr, w)
        finally:
            if raw is not raw_src:
                raw.close()
        hdr["search_windows"] = w.nwindows
        return hdr

    def search_resumable(self, raw_src: RawSource, out_path: str) -> Dict:
        """Search to a ``.hits`` product that survives a crash: a
        :class:`SearchCursor` sidecar claims each window after its lines
        are durable; a re-run with the same configuration and RAW bytes
        truncates to the claimed window (verified against the manifest's
        ledger) and replays from there, so the finished product equals an
        uninterrupted run's, byte for byte."""
        raw, hdr = self._open_validated(raw_src)
        try:
            return self._search_resumable(raw, hdr, out_path)
        finally:
            if raw is not raw_src:
                raw.close()

    def _search_resumable(self, raw: GuppiRaw, hdr: Dict, out_path: str) -> Dict:
        paths = getattr(raw, "paths", None) or raw.path
        cur = SearchCursor.load(out_path)
        resuming = (cur is not None and cur.matches(self, paths)
                    and os.path.exists(out_path))
        if resuming and os.path.getsize(out_path) < cur.byte_offset:
            # Truncating a shorter file would extend it with zeros.
            log.warning("resume target %s is shorter than the cursor's "
                        "claimed %d bytes; starting fresh", out_path,
                        cur.byte_offset)
            resuming = False
        if resuming and integrity.verify_claim(out_path, cur.windows_done,
                                               fmt="hits") is False:
            log.warning("resume target %s fails its claimed-region digest; "
                        "starting fresh", out_path)
            resuming = False
        if resuming:
            log.info("resuming %s at window %d", out_path, cur.windows_done)
        else:
            size, mtime_ns = ReductionCursor.stat_raw(paths)
            cur = SearchCursor(
                paths, self.nfft, self.ntap, self.nint, window=self.window,
                dtype=self.dtype, window_spectra=self.window_spectra,
                top_k=self.top_k, snr_threshold=float(self.snr_threshold),
                max_drift_bins=(-1 if self.max_drift_bins is None
                                else int(self.max_drift_bins)),
                raw_size=size, raw_mtime_ns=mtime_ns)
        skip = cur.windows_done if resuming else 0
        w = ResumableHitsWriter(out_path, hdr, skip, cur)
        self._pump(raw, hdr, w, skip_windows=skip)
        hdr["search_windows"] = w.nwindows
        hdr["search_nhits"] = w.nsamps
        return hdr


@dataclass
class SearchCursor:
    """Restart state of a resumable search, a JSON sidecar beside the
    ``.hits`` product with ``blit``'s field names and defaults.

    ``windows_done`` counts windows extracted and durable;
    ``byte_offset`` is the file length they claim; ``window_claims`` the
    ``[window, byte_offset, hits]`` ledger (windows are ragged: a window
    with no hit writes no line), bounded by
    :data:`blit_torch.io.hits.CLAIM_LEDGER_MAX`.  Identity covers the RAW
    bytes and every output-affecting knob."""

    raw_path: Union[str, List[str]]
    nfft: int
    ntap: int
    nint: int
    window: str = "hamming"
    dtype: str = "float32"
    window_spectra: int = 64
    top_k: int = 8
    snr_threshold: float = 10.0
    max_drift_bins: int = -1
    windows_done: int = 0
    hits_done: int = 0
    byte_offset: int = 0
    raw_size: Union[int, List[int]] = -1
    raw_mtime_ns: Union[int, List[int]] = -1
    window_claims: Optional[List[List[int]]] = None

    def claim_at(self, windows: int) -> Optional[Tuple[int, int]]:
        """``(byte_offset, hits_done)`` after ``windows`` windows, where
        this cursor recorded it (:func:`blit_torch.io.hits.ledger_claim_at`)."""
        return ledger_claim_at(windows, self.windows_done, self.byte_offset,
                               self.hits_done, self.window_claims)

    # The reduction cursor's sidecar protocol.
    path_for = staticmethod(ReductionCursor.path_for)
    save = ReductionCursor.save
    load = classmethod(ReductionCursor.load.__func__)

    def matches(self, red: DedopplerReducer,
                raw_path: Union[str, Sequence[str]]) -> bool:
        try:
            size, mtime_ns = ReductionCursor.stat_raw(raw_path)
        except OSError:
            return False
        return (
            ReductionCursor.normalized_members(
                self.raw_path, self.raw_size, self.raw_mtime_ns)
            == ReductionCursor.normalized_members(raw_path, size, mtime_ns)
            and self.nfft == red.nfft
            and self.ntap == red.ntap
            and self.nint == red.nint
            and self.window == red.window
            and self.dtype == red.dtype
            and self.window_spectra == red.window_spectra
            and self.top_k == red.top_k
            and self.snr_threshold == float(red.snr_threshold)
            and self.max_drift_bins == (
                -1 if red.max_drift_bins is None else int(red.max_drift_bins))
        )
