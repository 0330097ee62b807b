"""Per-antenna GUPPI RAW recordings → planar voltages on one card.

Counterpart of ``blit/parallel/antenna.py`` without the mesh: one RAW
recording per antenna, opened together, their common gap-free span
agreed, and the samples delivered as planar ``(vr, vi)`` tensors on the
device in the beamformer's layout (``"antenna"``: ``(nant, nchan, ntime,
npol)``; ``"chan"``: packed ``(nchan, nant, npol, ntime)``) or the
correlator's (``(nant, nchan, ntime, npol)``).

- One-shot loaders: :func:`load_antennas` and :func:`load_correlator`
  (``blit``'s ``load_antennas_mesh`` / ``load_correlator_mesh``).
- Windowed feeds: :class:`AntennaStream` (windows of ``window_samples``,
  the last one smaller when the span is ragged) and
  :class:`CorrelatorStream` (windows of ``window_frames`` F-engine
  frames that overlap by the ``(ntap-1)·nfft``-sample PFB tail, carried
  from one window to the next, so windowed spectra equal a one-shot
  F-engine pass over the whole span).

Each window is read into an int8 host slot (from the staging pool,
pinned when the device is CUDA), copied to the device as int8
(``non_blocking``), and dequantized and packed there: the Timeline
records ``ingest`` (RAW bytes read), ``transfer`` (int8 bytes moved to
the device), ``pack`` (planar bytes written) and, for the correlator,
``state`` (the PFB tail carried).  With ``prefetch_depth > 1`` (the
default is 2, as in ``blit``) or a ``stall_timeout_s``, a producer thread
(:class:`blit_torch.pipeline.BufferRotation`, with its watchdog) reads
windows into a rotation of slots ahead of the consumer;
``prefetch_depth=1`` reads each window on the consumer's thread when it
is asked for.  A window's slot is free once its copy to the device has
completed: the consumer may :meth:`Window.release` it (the streaming
entry points do, after the compute that read it synchronized, ``blit``'s
rule), and the feed releases it itself, after waiting on the window's
``ready`` event, when the next window is asked for.  ``blit``'s degraded
continuation (``on_antenna_error="mask"``) comes with the mesh (Queue 1
item 6) and raises until then.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blit_torch import faults, hostmem
from blit_torch.device import resolve_device
from blit_torch.io.guppi import GuppiRaw, open_raw
from blit_torch.observability import Timeline
from blit_torch.ops.dft import Planar
from blit_torch.outplane import record_event
from blit_torch.pipeline import BufferRotation

log = logging.getLogger("blit_torch.parallel.antenna")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _kept_samples(raw: GuppiRaw) -> int:
    """Gap-free samples the file yields (header arithmetic only)."""
    return sum(raw.block_ntime_kept(i) for i in range(raw.nblocks))


def _gapless(raw: GuppiRaw, max_samples: Optional[int], skip: int = 0,
             out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gap-free samples ``[skip, skip + max_samples)`` of a RAW file read
    once into ``(nchan, total, npol, 2)`` int8 (``out``, a caller's
    scratch of at least that many samples, or a new array), each block's
    kept prefix only.  Returns the filled view; a short read (a truncated
    recording) returns what landed, and the caller checks the length."""
    hdr = raw.header(0)
    nchan = hdr["OBSNCHAN"]
    npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
    total = max(_kept_samples(raw) - skip, 0)
    if max_samples is not None:
        total = min(total, max_samples)
    if out is not None:
        if (out.dtype != np.int8 or out.shape[0] != nchan
                or out.shape[1] < total or out.shape[2:] != (npol, 2)):
            raise ValueError(
                f"_gapless: scratch shape {out.shape}/{out.dtype} cannot "
                f"hold (nchan={nchan}, total={total}, npol={npol}, 2) int8")
        out = out[:, :total]
    else:
        out = np.empty((nchan, total, npol, 2), np.int8)
    filled = 0
    to_skip = skip
    for i in range(raw.nblocks):
        if filled >= total:
            break
        kept = raw.block_ntime_kept(i)
        if to_skip >= kept:
            to_skip -= kept
            continue
        nt = min(kept - to_skip, total - filled)
        got = raw.read_block_into(i, out[:, filled:], t0=to_skip, ntime_keep=nt)
        to_skip = 0
        filled += got
        if got < nt:
            break
    return out[:, :filled]


def _span_from(min_samps: int, start_sample: int,
               max_samples: Optional[int]) -> int:
    """Usable samples from ``start_sample`` given the common span."""
    if start_sample < 0:
        raise ValueError(f"start_sample must be >= 0, got {start_sample}")
    avail = min_samps - start_sample
    if max_samples is not None:
        avail = min(avail, max_samples)
    return avail


def record_mask(masked: set, ident, reason: str, *, header: Dict,
                timeline: Timeline, kind: str = "antenna") -> bool:
    """The one zero-weight mask bookkeeping rule (``blit``'s): add
    ``ident`` to ``masked``, mirror the sorted set into the product
    header (``_masked_<kind>s``), count ``<kind>.masked`` on the timeline
    and ``mask.<kind>`` in :mod:`blit_torch.faults`, and log it, so a
    degraded product says so.  The reducer uses it with
    ``kind="block"`` for RAW blocks that failed their digest.  True when
    ``ident`` was newly masked."""
    if ident in masked:
        return False
    masked.add(ident)
    header[f"_masked_{kind}s"] = sorted(masked)
    timeline.count(f"{kind}.masked")
    faults.incr(f"mask.{kind}")
    log.warning("%s %s %s; masking it (zero weight) and continuing degraded",
                kind, ident, reason)
    return True


def _unported(on_antenna_error: str) -> None:
    """Raise for ``blit``'s feed options the port does not have yet."""
    if on_antenna_error not in ("raise", "mask"):
        raise ValueError(f"on_antenna_error must be 'raise' or 'mask', "
                         f"got {on_antenna_error!r}")
    if on_antenna_error == "mask":
        raise NotImplementedError(
            "on_antenna_error='mask' (degraded continuation) comes with the "
            "torch.distributed mesh, ROADMAP.md Queue 1 item 6")


class _Recordings:
    """The antennas' recordings opened together: their common span from
    ``start_sample``, the (nchan, npol) they agree on, the first
    antenna's header, and the read/transfer/pack steps of a window."""

    def __init__(self, raw_paths: Sequence, *, start_sample: int,
                 max_samples: Optional[int], dtype, device,
                 timeline: Optional[Timeline]):
        if len(raw_paths) == 0:
            raise ValueError("no antenna recordings given")
        if dtype not in _DTYPES and dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = _DTYPES.get(dtype, dtype)
        self.device = resolve_device(device)
        self.timeline = timeline if timeline is not None else Timeline()
        self.start_sample = start_sample
        self.raws: List[GuppiRaw] = []
        errs = []
        for a, src in enumerate(raw_paths):
            try:
                r = open_raw(src)
                if r.nblocks == 0:
                    raise ValueError(f"empty RAW file: {r.path}")
                self.raws.append(r)
            except (OSError, ValueError) as e:
                errs.append(f"antenna {a}: {type(e).__name__}: {e}")
        if errs:
            self.close()
            raise ValueError("antenna recordings failed to open: "
                             + "; ".join(errs))
        geos = set()
        for r in self.raws:
            h = r.header(0)
            geos.add((h["OBSNCHAN"], 2 if h["NPOL"] > 2 else h["NPOL"]))
        if len(geos) != 1:
            self.close()
            raise ValueError(f"antennas disagree on (nchan, npol): {sorted(geos)}")
        (self.nchan, self.npol), = geos
        self.nant = len(self.raws)
        self.min_samples = min(_kept_samples(r) for r in self.raws)
        self.total = _span_from(self.min_samples, start_sample, max_samples)
        self.header = dict(self.raws[0].header(0))
        self.header["_nant"] = self.nant

    def staging(self, nsamples: int) -> hostmem.HostSlab:
        """An int8 ``(nant, nchan, nsamples, npol, 2)`` host slab from the
        staging pool, pinned when the device is CUDA."""
        return hostmem.slab_pool().take(
            (self.nant, self.nchan, nsamples, self.npol, 2), np.int8,
            pinned=self.device.type == "cuda", timeline=self.timeline)

    def read(self, staged: np.ndarray, offset: int, n: int) -> None:
        """Samples ``[start_sample + offset, +n)`` of every antenna into
        ``staged[a, :, :n]`` (``staged``: a numpy view of a slot, possibly
        starting inside it)."""
        tl = self.timeline
        for a, raw in enumerate(self.raws):
            with tl.stage("ingest", nbytes=self.nchan * n * self.npol * 2):
                v = _gapless(raw, n, skip=self.start_sample + offset,
                             out=staged[a])
            if v.shape[1] < n:
                raise ValueError(f"{raw.path}: {v.shape[1]} samples from offset "
                                 f"{self.start_sample + offset}, need {n}")

    def planes(self, slot: torch.Tensor, n: int, layout: str) -> Planar:
        """The first ``n`` samples of an int8 ``(nant, nchan, *, npol, 2)``
        host slot → planar voltages on the device in ``layout``: the slot
        is copied to the device as int8 (``non_blocking``; whole, then
        trimmed there, so the copy stays one DMA from pinned memory),
        then dequantized (exact in f32 and bf16) and packed there.
        Returns without waiting for the device."""
        tl = self.timeline
        nbytes = slot[:, :, :n].numel()
        with tl.stage("transfer", nbytes=nbytes):
            x = slot.to(self.device, non_blocking=True)
            if n < slot.shape[2]:
                x = x[:, :, :n]
        nplane = nbytes // 2 * self.dtype.itemsize
        with tl.stage("pack", nbytes=2 * nplane):
            vr, vi = x[..., 0].to(self.dtype), x[..., 1].to(self.dtype)
            if layout == "chan":
                vr = vr.permute(1, 0, 3, 2)
                vi = vi.permute(1, 0, 3, 2)
            return vr.contiguous(), vi.contiguous()

    def load(self, n: int, layout: str) -> Planar:
        """The first ``n`` samples of the span as planar voltages, the
        one-shot loaders' read: complete when it returns."""
        slab = self.staging(n)
        self.read(slab.array, 0, n)
        arrays = self.planes(slab.tensor, n, layout)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        hostmem.slab_pool().give(slab)
        return arrays

    def close(self) -> None:
        for r in self.raws:
            r.close()


@dataclass
class Window:
    """One window of a feed: planar ``arrays`` on the feed's device.

    ``ready`` is the event recorded after the window's copy to the device
    and its pack (None on the CPU).  :meth:`release` hands the window's
    host slot back to the feed (idempotent, from any thread); a window
    the consumer has not released is released by the feed, after
    ``ready``, when the next window is asked for."""

    index: int             # window ordinal in the stream
    start: int             # gap-free sample (AntennaStream) / first frame
    #                        (CorrelatorStream) of the window
    ntime: int             # samples in ``arrays``
    frames: Optional[int]  # F-engine frames it contributes (CorrelatorStream)
    arrays: Planar
    ready: Optional[torch.cuda.Event] = None
    _free: Optional[Callable[[], None]] = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def release(self) -> None:
        with self._lock:
            free, self._free = self._free, None
        if free is not None:
            free()

    def settle(self) -> None:
        """Wait until the window's copy has completed, then release it."""
        if self.ready is not None:
            self.ready.synchronize()
        self.release()


class _Feed:
    """The window rotation shared by :class:`AntennaStream` and
    :class:`CorrelatorStream`.  ``_fill(slab, prev_slab, prev_payload, w,
    span)`` reads window ``w`` into ``slab`` (``prev_slab``: the previous
    window's slot, for the correlator's PFB tail) and returns its payload
    ``(index, start, ntime, frames, used)``; ``used`` samples of the slot
    go to the device."""

    _rec: "_Recordings"
    spans: List[Tuple[int, int]]
    prefetch_depth: int
    stall_timeout_s: Optional[float]
    _name: str
    # Whether _fill reads the previous slot (the correlator's PFB tail).
    _carries_tail = False

    def _layout(self) -> str:
        return "antenna"

    def _window(self, slab, payload, free) -> Window:
        w, start, ntime, frames, used = payload
        arrays = self._rec.planes(slab.tensor, used, self._layout())
        return Window(w, start, ntime, frames, arrays, record_event(arrays[0]),
                      free)

    def _threaded(self) -> bool:
        return self.prefetch_depth > 1 or self.stall_timeout_s is not None

    def _iter_windows(self, width: int) -> Iterator[Window]:
        rec = self._rec
        done = False
        rot: Optional[BufferRotation] = None
        bufs: List[Optional[hostmem.HostSlab]] = []
        prev_win: Optional[Window] = None
        try:
            if not self._threaded():
                bufs.append(rec.staging(width))
                payload = None
                for w, span in enumerate(self.spans):
                    if prev_win is not None:
                        prev_win.settle()
                    payload = self._fill(bufs[0], bufs[0], payload, w, span)
                    prev_win = self._window(bufs[0], payload, None)
                    yield prev_win
            else:
                bufs.extend([None] * max(2, self.prefetch_depth))

                def produce(r: BufferRotation) -> None:
                    prev = payload = None
                    for w, span in enumerate(self.spans):
                        j = r.acquire()
                        if j is None:
                            return  # the consumer abandoned the stream
                        if self._carries_tail and j == prev:
                            raise RuntimeError(
                                f"{self._name}: window released out of order "
                                "(the producer re-acquired its PFB-tail slot)")
                        if bufs[j] is None:
                            bufs[j] = rec.staging(width)
                        payload = self._fill(
                            bufs[j], None if prev is None else bufs[prev],
                            payload, w, span)
                        r.emit(j, payload)
                        prev = j

                rot = BufferRotation(len(bufs), produce, name=self._name,
                                     stall_timeout_s=self.stall_timeout_s)
                for j, payload in rot.slots():
                    if prev_win is not None:
                        prev_win.settle()
                    prev_win = self._window(bufs[j], payload,
                                            lambda j=j: rot.release(j))
                    yield prev_win
            if prev_win is not None:
                prev_win.settle()
            done = True
        finally:
            if rot is not None:
                rot.close()
            rec.close()
            if done:  # every copy completed: the slots may be reused
                pool = hostmem.slab_pool()
                for b in bufs:
                    pool.give(b)


def _check_layout(layout: str) -> None:
    if layout not in ("antenna", "chan"):
        raise ValueError(f"bad layout {layout!r}")


def load_antennas(raw_paths: Sequence, *, start_sample: int = 0,
                  max_samples: Optional[int] = None, dtype="float32",
                  layout: str = "antenna", device=None
                  ) -> Tuple[Dict, Planar]:
    """Load per-antenna RAW recordings as planar voltages on the device:
    ``(nant, nchan, ntime, npol)`` (``layout="antenna"``) or packed
    ``(nchan, nant, npol, ntime)`` (``"chan"``, for
    ``beamform(layout="chan")`` and its fused kernel), f32 or bf16 (8-bit
    samples are exact in both).  The span is the antennas' common
    gap-free span from ``start_sample``, capped at ``max_samples``.
    Returns ``(header, (vr, vi))``: the first antenna's header plus
    ``_ntime`` and ``_nant``."""
    _check_layout(layout)
    rec = _Recordings(raw_paths, start_sample=start_sample,
                      max_samples=max_samples, dtype=dtype, device=device,
                      timeline=None)
    try:
        if rec.total <= 0:
            raise ValueError(f"no common samples across {rec.nant} antennas "
                             f"from offset {start_sample} (common span "
                             f"{rec.min_samples})")
        arrays = rec.load(rec.total, layout)
    finally:
        rec.close()
    hdr = dict(rec.header, _ntime=rec.total)
    return hdr, arrays


def _correlator_segment(rec: _Recordings, nfft: int, ntap: int) -> int:
    """The span trimmed to whole ``nfft`` blocks, at least ``ntap``."""
    seg = rec.total // nfft * nfft if rec.total > 0 else 0
    if seg // nfft < ntap:
        raise ValueError(
            f"correlator needs >= {ntap} nfft-blocks; have {seg // nfft} "
            f"({rec.total} samples from offset {rec.start_sample})")
    return seg


def load_correlator(raw_paths: Sequence, *, nfft: int, ntap: int = 4,
                    start_sample: int = 0, max_samples: Optional[int] = None,
                    dtype="float32", device=None) -> Tuple[Dict, Planar]:
    """Load per-antenna RAW recordings for the FX correlator: planar
    ``(nant, nchan, ntime, npol)`` voltages on the device, the span
    trimmed to whole ``nfft`` blocks (at least ``ntap`` of them) — one
    band segment, as ``blit``'s loader on a single-band mesh."""
    rec = _Recordings(raw_paths, start_sample=start_sample,
                      max_samples=max_samples, dtype=dtype, device=device,
                      timeline=None)
    try:
        seg = _correlator_segment(rec, nfft, ntap)
        arrays = rec.load(seg, "antenna")
    finally:
        rec.close()
    return dict(rec.header, _ntime=seg), arrays


class AntennaStream(_Feed):
    """Windowed feed of per-antenna RAW recordings in the beamformer's
    layout: the streaming form of :func:`load_antennas`.

    Iterating yields :class:`Window`\\ s over gap-free samples
    ``[start_sample + i·window_samples, ...)`` in order; every sample of
    the span lands in exactly one window, and the last window is smaller
    when the span is ragged.  Stage timings land in ``timeline``
    (module docstring)."""

    def __init__(self, raw_paths: Sequence, *, window_samples: int,
                 start_sample: int = 0, max_samples: Optional[int] = None,
                 dtype="float32", layout: str = "antenna",
                 prefetch_depth: int = 2, timeline: Optional[Timeline] = None,
                 on_antenna_error: str = "raise",
                 stall_timeout_s: Optional[float] = None, device=None):
        if window_samples <= 0:
            raise ValueError(f"window_samples must be > 0, got {window_samples}")
        _check_layout(layout)
        _unported(on_antenna_error)
        self._rec = _Recordings(raw_paths, start_sample=start_sample,
                                max_samples=max_samples, dtype=dtype,
                                device=device, timeline=timeline)
        rec = self._rec
        if rec.total <= 0:
            rec.close()
            raise ValueError(f"no common samples across {rec.nant} antennas "
                             f"from offset {start_sample} (common span "
                             f"{rec.min_samples})")
        self.layout = layout
        self.window_samples = window_samples
        self.start_sample = start_sample
        self.prefetch_depth = prefetch_depth
        self.stall_timeout_s = stall_timeout_s
        self._name = "blit-antenna-feed"
        self.timeline = rec.timeline
        self.nant, self.nchan, self.npol = rec.nant, rec.nchan, rec.npol
        self.total_samples = rec.total
        # (sample offset within the span, samples) of each window.
        self.spans: List[Tuple[int, int]] = [
            (w0, min(window_samples, rec.total - w0))
            for w0 in range(0, rec.total, window_samples)]
        self.header = dict(rec.header, _ntime=rec.total)

    @property
    def nwindows(self) -> int:
        return len(self.spans)

    def _layout(self) -> str:
        return self.layout

    def _fill(self, slab, prev, prev_payload, w, span):
        w0, wt = span
        self._rec.read(slab.array, w0, wt)
        return w, self.start_sample + w0, wt, None, wt

    def __iter__(self) -> Iterator[Window]:
        return self._iter_windows(min(self.window_samples, self._rec.total))


class CorrelatorStream(_Feed):
    """Windowed feed in the FX correlator's layout: the streaming form of
    :func:`load_correlator`.

    The span from ``start_sample`` is trimmed to whole ``nfft`` blocks;
    its ``total_frames`` F-engine frames stream in windows of
    ``window_frames``.  Window ``w`` carries frames ``[w·window_frames,
    ...)`` as ``(nant, nchan, (frames + ntap - 1)·nfft, npol)`` voltages;
    consecutive windows overlap by the ``(ntap-1)·nfft``-sample PFB tail,
    copied on the host from the previous window's slot (every other
    sample is read from disk once), so each window's spectra equal the
    matching frames of a one-shot F-engine pass."""

    _carries_tail = True

    def __init__(self, raw_paths: Sequence, *, nfft: int, ntap: int = 4,
                 window_frames: int, start_sample: int = 0,
                 max_samples: Optional[int] = None, dtype="float32",
                 prefetch_depth: int = 2, timeline: Optional[Timeline] = None,
                 on_antenna_error: str = "raise",
                 stall_timeout_s: Optional[float] = None, device=None):
        if window_frames <= 0:
            raise ValueError(f"window_frames must be > 0, got {window_frames}")
        _unported(on_antenna_error)
        self._rec = _Recordings(raw_paths, start_sample=start_sample,
                                max_samples=max_samples, dtype=dtype,
                                device=device, timeline=timeline)
        rec = self._rec
        try:
            self.seg = _correlator_segment(rec, nfft, ntap)
        except ValueError:
            rec.close()
            raise
        self.nfft, self.ntap = nfft, ntap
        self.window_frames = window_frames
        self.start_sample = start_sample
        self.prefetch_depth = prefetch_depth
        self.stall_timeout_s = stall_timeout_s
        self._name = "blit-correlator-feed"
        self.timeline = rec.timeline
        self.nant, self.nchan, self.npol = rec.nant, rec.nchan, rec.npol
        self.total_frames = self.seg // nfft - ntap + 1
        self.spans: List[Tuple[int, int]] = [
            (f0, min(window_frames, self.total_frames - f0))
            for f0 in range(0, self.total_frames, window_frames)]
        self.header = dict(rec.header, _ntime=self.seg)

    @property
    def nwindows(self) -> int:
        return len(self.spans)

    def _fill(self, slab, prev, prev_payload, w, span):
        """Window ``w``'s fresh samples read into ``slab``, its PFB tail
        copied from ``prev`` (the previous window's slot; the same slot
        when the feed has one, where numpy copies the overlap right)."""
        f0, fw = span
        nfft, ov = self.nfft, (self.ntap - 1) * self.nfft
        used = (fw + self.ntap - 1) * nfft
        fresh0 = 0 if w == 0 else ov
        host = slab.array
        if fresh0:
            prev_used = prev_payload[4]
            with self.timeline.stage("state", nbytes=host[:, :, :ov].nbytes):
                host[:, :, :ov] = prev.array[:, :, prev_used - ov:prev_used]
        self._rec.read(host[:, :, fresh0:], f0 * nfft + fresh0, used - fresh0)
        return w, f0, used, fw, used

    def __iter__(self) -> Iterator[Window]:
        return self._iter_windows(
            (min(self.window_frames, self.total_frames) + self.ntap - 1) * self.nfft)
