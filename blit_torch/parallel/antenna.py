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
``ready`` event, when the next window is asked for.

Over a ``(band, bank)`` mesh (``mesh=``, :mod:`blit_torch.parallel.mesh`)
the same feeds deliver :class:`~blit_torch.parallel.mesh.MeshArray`
planes: :class:`AntennaStream` and :func:`load_antennas_mesh` split the
antenna axis over ``axis`` and each process opens only its own
antennas; :class:`CorrelatorStream` and :func:`load_correlator_mesh`
split channels over ``bank`` and time over ``band`` (one segment a band
row), and each process reads its band rows' segments of every antenna.
The common span is agreed across the pod, symmetric errors included.

Degraded continuation (``on_antenna_error="mask"``,
:class:`_DegradedContinuation`): a hard mid-stream failure of one
antenna's recording zero-weights that antenna from the failing window
on instead of ending the stream; the window says so (``masked``), and so
do the feed's ``masked_antennas``, the header (``_masked_antennas``) and
the ``antenna.masked`` counter.
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


# Marks an antenna its opener failed on in the pod-wide agreement; the
# antennas nobody opened ride _UNOPENED (both above any real count).
_ERR = 1 << 60
_UNOPENED = (1 << 62) - 1


class _Recordings:
    """The antennas' recordings opened together: their common span from
    ``start_sample``, the (nchan, npol) they agree on, the first opened
    antenna's header, and the read/transfer/pack steps of a window.

    ``ants`` are the antennas (indices into ``raw_paths``) this process
    opens, in slot order (default: all).  With ``pod`` the span, the
    geometry and every failure are agreed across the pod's processes, so
    every process raises together.  ``on_fail(antenna, error)``, when
    set, takes a hard read failure instead of raising (the degraded
    continuation)."""

    def __init__(self, raw_paths: Sequence, *, start_sample: int,
                 max_samples: Optional[int], dtype, device,
                 timeline: Optional[Timeline], ants: Optional[Sequence[int]] = None,
                 pod: bool = False):
        if len(raw_paths) == 0:
            raise ValueError("no antenna recordings given")
        if dtype not in _DTYPES and dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = _DTYPES.get(dtype, dtype)
        self.device = resolve_device(device)
        self.timeline = timeline if timeline is not None else Timeline()
        self.start_sample = start_sample
        self.nant_total = len(raw_paths)
        self.ants = list(range(self.nant_total)) if ants is None else list(ants)
        self.on_fail: Optional[Callable[[int, BaseException], None]] = None
        self.masked: set = set()
        self.raws: List[GuppiRaw] = []
        errs: Dict[int, BaseException] = {}
        for a in self.ants:
            try:
                r = open_raw(raw_paths[a])
                if r.nblocks == 0:
                    raise ValueError(f"empty RAW file: {r.path}")
                self.raws.append(r)
            except (OSError, ValueError) as e:
                errs[a] = e
        if pod:
            self._agree(errs)
        else:
            if errs:
                self.close()
                raise ValueError("antenna recordings failed to open: " + "; ".join(
                    f"antenna {a}: {type(e).__name__}: {e}"
                    for a, e in sorted(errs.items())))
            geos = set()
            for r in self.raws:
                h = r.header(0)
                geos.add((h["OBSNCHAN"], 2 if h["NPOL"] > 2 else h["NPOL"]))
            if len(geos) != 1:
                self.close()
                raise ValueError(
                    f"antennas disagree on (nchan, npol): {sorted(geos)}")
            (self.nchan, self.npol), = geos
            self.min_samples = min(_kept_samples(r) for r in self.raws)
        self.nant = len(self.raws)
        self.total = _span_from(self.min_samples, start_sample, max_samples)
        self.header = dict(self.raws[0].header(0))
        self.header["_nant"] = self.nant_total

    def _agree(self, errs: Dict[int, BaseException]) -> None:
        """The pod-wide agreement of span, geometry and failures (the
        scan loader's player agreement, per antenna)."""
        from blit_torch.parallel.scan import _gather_int64

        geo = (0, 0)
        if self.raws:
            h = self.raws[0].header(0)
            geo = (h["OBSNCHAN"], 2 if h["NPOL"] > 2 else h["NPOL"])
        samps = np.full(self.nant_total, _UNOPENED, np.int64)
        opened = [a for a in self.ants if a not in errs]
        for a, r in zip(opened, self.raws):
            samps[a] = _kept_samples(r)
        for a in errs:
            samps[a] = _ERR
        gathered = _gather_int64(np.concatenate([samps, geo]))
        samps = gathered[:, :-2].min(axis=0)
        failed = [int(a) for a in np.argwhere(samps == _ERR).ravel()]
        if failed:
            mine = "; ".join(f"antenna {a}: {type(e).__name__}: {e}"
                             for a, e in sorted(errs.items()))
            self.close()
            raise ValueError(f"antennas {failed} failed to open on their owning "
                             "process" + (f" (this process: {mine})" if mine else "")
                             ) from next(iter(errs.values()), None)
        geos = gathered[:, -2:]
        geos = geos[(geos != 0).any(axis=1)]
        if not (geos == geos[0]).all():
            self.close()
            raise ValueError("processes disagree on (nchan, npol): "
                             f"{[tuple(int(x) for x in g) for g in geos]}")
        mine_geo = set()
        for r in self.raws:
            h = r.header(0)
            mine_geo.add((h["OBSNCHAN"], 2 if h["NPOL"] > 2 else h["NPOL"]))
        if len(mine_geo) > 1:
            self.close()
            raise ValueError(f"antennas disagree on (nchan, npol): {sorted(mine_geo)}")
        self.nchan, self.npol = int(geos[0][0]), int(geos[0][1])
        self.min_samples = int(samps.min())

    def staging(self, nsamples: int, rows: Optional[int] = None) -> hostmem.HostSlab:
        """An int8 ``(nant, nchan, nsamples, npol, 2)`` host slab (with a
        leading ``rows`` axis when given) from the staging pool, pinned
        when the device is CUDA."""
        shape = (self.nant, self.nchan, nsamples, self.npol, 2)
        if rows is not None:
            shape = (rows,) + shape
        return hostmem.slab_pool().take(
            shape, np.int8, pinned=self.device.type == "cuda",
            timeline=self.timeline)

    def read(self, staged: np.ndarray, offset: int, n: int) -> None:
        """Samples ``[start_sample + offset, +n)`` of every opened antenna
        into ``staged[i, :, :n]`` (``staged``: a numpy view of a slot,
        possibly starting inside it).  A masked antenna's rows are zeroed;
        a hard failure goes to ``on_fail`` when it is set."""
        tl = self.timeline
        for i, raw in enumerate(self.raws):
            a = self.ants[i]
            if a in self.masked:
                staged[i, :, :n] = 0
                continue
            try:
                faults.fire("antenna.produce", key=raw.path)
                with tl.stage("ingest", nbytes=self.nchan * n * self.npol * 2):
                    v = _gapless(raw, n, skip=self.start_sample + offset,
                                 out=staged[i])
                if v.shape[1] < n:
                    raise ValueError(f"{raw.path}: {v.shape[1]} samples from "
                                     f"offset {self.start_sample + offset}, "
                                     f"need {n}")
            except Exception as e:  # noqa: BLE001 — classified by on_fail
                if self.on_fail is None:
                    raise
                self.on_fail(a, e)
                staged[i, :, :n] = 0

    def planes(self, slot: torch.Tensor, n: int, layout: str) -> Planar:
        """The first ``n`` samples of an int8 ``(..., nant, nchan, *, npol,
        2)`` host slot → planar voltages on the device in ``layout``: the
        slot is copied to the device as int8 (``non_blocking``; whole,
        then trimmed there, so the copy stays one DMA from pinned memory),
        then dequantized (exact in f32 and bf16) and packed there.
        Returns without waiting for the device."""
        tl = self.timeline
        nbytes = slot[..., :n, :, :].numel()
        with tl.stage("transfer", nbytes=nbytes):
            x = slot.to(self.device, non_blocking=True)
            if n < slot.shape[-3]:
                x = x[..., :n, :, :]
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
    """One window of a feed: planar ``arrays`` on the feed's device (a
    pair of :class:`~blit_torch.parallel.mesh.MeshArray` over a mesh).

    ``ready`` is the event recorded after the window's copy to the device
    and its pack (None on the CPU).  ``masked`` names the antennas
    zero-weighted in this window (the degraded continuation).
    :meth:`release` hands the window's host slot back to the feed
    (idempotent, from any thread); a window the consumer has not released
    is released by the feed, after ``ready``, when the next window is
    asked for."""

    index: int             # window ordinal in the stream
    start: int             # gap-free sample (AntennaStream) / first frame
    #                        (CorrelatorStream) of the window
    ntime: int             # samples in ``arrays`` (all band segments)
    frames: Optional[int]  # F-engine frames it contributes (CorrelatorStream)
    arrays: Planar
    ready: Optional[torch.cuda.Event] = None
    _free: Optional[Callable[[], None]] = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    masked: Tuple[int, ...] = ()

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


class _DegradedContinuation:
    """The degraded-antenna state of the windowed feeds: with
    ``on_antenna_error="mask"`` a hard mid-stream failure of an antenna
    (a truncated recording, retries exhausted) zero-weights it from the
    failing window on instead of ending the stream.  Zeroed planes add
    nothing to the beam sums and baseline products, so the compute needs
    no change; the mask rides every later :class:`Window` (``masked``),
    the feed's ``masked_antennas``, the header (``_masked_antennas``)
    and the ``antenna.masked`` counter.  In a pod each process masks the
    antennas it reads."""

    def _init_degraded(self, on_antenna_error: str,
                       stall_timeout_s: Optional[float]) -> None:
        if on_antenna_error not in ("raise", "mask"):
            raise ValueError(f"on_antenna_error must be 'raise' or 'mask', "
                             f"got {on_antenna_error!r}")
        self.on_antenna_error = on_antenna_error
        self.stall_timeout_s = stall_timeout_s

    def _arm_degraded(self) -> None:
        self.masked_antennas = self._rec.masked
        if self.on_antenna_error == "mask":
            self._rec.on_fail = self._mask

    def _mask(self, a: int, err: BaseException) -> None:
        record_mask(self.masked_antennas, a,
                    f"hard-failed mid-stream ({type(err).__name__}: {err})",
                    header=self.header, timeline=self.timeline, kind="antenna")


class _Feed(_DegradedContinuation):
    """The window rotation shared by :class:`AntennaStream` and
    :class:`CorrelatorStream`.  ``_fill(slab, prev_slab, prev_payload, w,
    span)`` reads window ``w`` into ``slab`` (``prev_slab``: the previous
    window's slot, for the correlator's PFB tail) and returns its payload
    ``(index, start, ntime, frames, used, masked)``; ``used`` samples of
    the slot go to the device."""

    _rec: "_Recordings"
    spans: List[Tuple[int, int]]
    prefetch_depth: int
    stall_timeout_s: Optional[float]
    _name: str
    mesh = None
    # Whether _fill reads the previous slot (the correlator's PFB tail).
    _carries_tail = False

    def _layout(self) -> str:
        return "antenna"

    def _arrays(self, slab, used: int):
        return self._rec.planes(slab.tensor, used, self._layout())

    def _window(self, slab, payload, free) -> Window:
        w, start, ntime, frames, used, masked = payload
        arrays = self._arrays(slab, used)
        ready = record_event(arrays[0])
        if self.mesh is not None:
            arrays = self._to_mesh(arrays, used)
        return Window(w, start, ntime, frames, arrays, ready, free,
                      masked=masked)

    def _threaded(self) -> bool:
        return self.prefetch_depth > 1 or self.stall_timeout_s is not None

    def _staging(self, width: int) -> hostmem.HostSlab:
        return self._rec.staging(width)

    def _iter_windows(self, width: int) -> Iterator[Window]:
        rec = self._rec
        done = False
        rot: Optional[BufferRotation] = None
        bufs: List[Optional[hostmem.HostSlab]] = []
        prev_win: Optional[Window] = None
        try:
            if not self._threaded():
                bufs.append(self._staging(width))
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
                            bufs[j] = self._staging(width)
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


def _correlator_segment(rec: _Recordings, nfft: int, ntap: int,
                        nband: int = 1) -> int:
    """Each band row's time segment: the span split into ``nband``
    segments, each trimmed to whole ``nfft`` blocks, at least ``ntap``."""
    seg = (rec.total // nband) // nfft * nfft if rec.total > 0 else 0
    if seg // nfft < ntap:
        per = " per band segment" if nband > 1 else ""
        raise ValueError(
            f"correlator needs >= {ntap} nfft-blocks{per}; have {seg // nfft} "
            f"({rec.total} samples over {nband} band(s) from offset "
            f"{rec.start_sample})")
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


def _antenna_plan(mesh, axis: str, nant: int) -> Tuple[int, Dict]:
    """The beamform split: ``(per, {player: first antenna})`` for this
    process's players; player ``p`` holds antennas ``[lo, lo + per)``,
    its block along ``axis``."""
    ax = mesh.shape[axis]
    if nant % ax:
        raise ValueError(f"nant={nant} must divide over the {ax}-way "
                         f"{axis!r} axis")
    per = nant // ax
    pos = 0 if axis == "band" else 1
    return per, {p: p[pos] * per for p in mesh.local_players()}


def _mesh_device(mesh, device):
    if device is not None:
        raise ValueError("pass mesh= or device=, not both: the mesh seats "
                         "the players on their devices")
    return mesh.devices[mesh.local_players()[0]]


class AntennaStream(_Feed):
    """Windowed feed of per-antenna RAW recordings in the beamformer's
    layout: the streaming form of :func:`load_antennas`.

    Iterating yields :class:`Window`\\ s over gap-free samples
    ``[start_sample + i·window_samples, ...)`` in order; every sample of
    the span lands in exactly one window, and the last window is smaller
    when the span is ragged.  With ``mesh`` the antenna axis splits over
    ``axis`` (each process opens only its own antennas, the span agreed
    across the pod) and the window's arrays are mesh arrays.  Stage
    timings land in ``timeline`` (module docstring)."""

    def __init__(self, raw_paths: Sequence, *, window_samples: int,
                 start_sample: int = 0, max_samples: Optional[int] = None,
                 dtype="float32", layout: str = "antenna",
                 prefetch_depth: int = 2, timeline: Optional[Timeline] = None,
                 on_antenna_error: str = "raise",
                 stall_timeout_s: Optional[float] = None, device=None,
                 mesh=None, axis: str = "bank"):
        if window_samples <= 0:
            raise ValueError(f"window_samples must be > 0, got {window_samples}")
        _check_layout(layout)
        self._init_degraded(on_antenna_error, stall_timeout_s)
        self.mesh, self.axis = mesh, axis
        ants = None
        if mesh is not None:
            device = _mesh_device(mesh, device)
            self.per, self._plan = _antenna_plan(mesh, axis, len(raw_paths))
            ants = sorted({a for lo in self._plan.values()
                           for a in range(lo, lo + self.per)})
        self._rec = _Recordings(raw_paths, start_sample=start_sample,
                                max_samples=max_samples, dtype=dtype,
                                device=device, timeline=timeline, ants=ants,
                                pod=mesh is not None)
        rec = self._rec
        if rec.total <= 0:
            rec.close()
            raise ValueError(f"no common samples across {rec.nant_total} "
                             f"antennas from offset {start_sample} (common "
                             f"span {rec.min_samples})")
        self.layout = layout
        self.window_samples = window_samples
        self.start_sample = start_sample
        self.prefetch_depth = prefetch_depth
        self._name = "blit-antenna-feed"
        self.timeline = rec.timeline
        self.nant, self.nchan, self.npol = rec.nant_total, rec.nchan, rec.npol
        self.total_samples = rec.total
        # (sample offset within the span, samples) of each window.
        self.spans: List[Tuple[int, int]] = [
            (w0, min(window_samples, rec.total - w0))
            for w0 in range(0, rec.total, window_samples)]
        self.header = dict(rec.header, _ntime=rec.total)
        self._arm_degraded()

    @property
    def nwindows(self) -> int:
        return len(self.spans)

    def _layout(self) -> str:
        return self.layout

    def _fill(self, slab, prev, prev_payload, w, span):
        w0, wt = span
        self._rec.read(slab.array, w0, wt)
        return (w, self.start_sample + w0, wt, None, wt,
                tuple(sorted(self.masked_antennas)))

    def _to_mesh(self, arrays: Planar, n: int):
        """This process's antennas → one shard a local player."""
        from blit_torch.parallel import mesh as M

        chan = self.layout == "chan"
        dim = 1 if chan else 0
        shape = ((self.nchan, self.nant, self.npol, n) if chan
                 else (self.nant, self.nchan, n, self.npol))
        spec = M.P(None, self.axis) if chan else M.P(self.axis)
        out = []
        for plane in arrays:
            shards = {}
            for p, lo in sorted(self._plan.items()):
                i0 = self._rec.ants.index(lo)
                blk = plane.narrow(dim, i0, self.per)
                shards[p] = blk.to(self.mesh.devices[p], non_blocking=True)
            out.append(M.MeshArray(self.mesh, spec, shape, shards))
        return tuple(out)

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
    matching frames of a one-shot F-engine pass.

    With ``mesh`` the span splits into one time segment a band row
    (``blit``'s ``correlator_sharding``: channels over ``bank``, time over
    ``band``); window ``w`` carries frames ``[w·window_frames, ...)`` of
    every segment, its arrays ``(nant, nchan, nband·wsamps, npol)`` mesh
    arrays, and each process reads its band rows' segments of every
    antenna."""

    _carries_tail = True

    def __init__(self, raw_paths: Sequence, *, nfft: int, ntap: int = 4,
                 window_frames: int, start_sample: int = 0,
                 max_samples: Optional[int] = None, dtype="float32",
                 prefetch_depth: int = 2, timeline: Optional[Timeline] = None,
                 on_antenna_error: str = "raise",
                 stall_timeout_s: Optional[float] = None, device=None,
                 mesh=None):
        if window_frames <= 0:
            raise ValueError(f"window_frames must be > 0, got {window_frames}")
        self._init_degraded(on_antenna_error, stall_timeout_s)
        self.mesh = mesh
        self.nband = self.nbank = 1
        self.rows = [0]
        if mesh is not None:
            device = _mesh_device(mesh, device)
            self.nband, self.nbank = mesh.shape["band"], mesh.shape["bank"]
            self.rows = sorted({b for b, _ in mesh.local_players()})
        self._rec = _Recordings(raw_paths, start_sample=start_sample,
                                max_samples=max_samples, dtype=dtype,
                                device=device, timeline=timeline,
                                pod=mesh is not None)
        rec = self._rec
        try:
            if rec.nchan % self.nbank:
                raise ValueError(f"nchan={rec.nchan} must divide over "
                                 f"{self.nbank} banks")
            self.seg = _correlator_segment(rec, nfft, ntap, self.nband)
        except ValueError:
            rec.close()
            raise
        self.cper = rec.nchan // self.nbank
        self.nfft, self.ntap = nfft, ntap
        self.window_frames = window_frames
        self.start_sample = start_sample
        self.prefetch_depth = prefetch_depth
        self._name = "blit-correlator-feed"
        self.timeline = rec.timeline
        self.nant, self.nchan, self.npol = rec.nant, rec.nchan, rec.npol
        self.total_frames = self.seg // nfft - ntap + 1
        self.spans: List[Tuple[int, int]] = [
            (f0, min(window_frames, self.total_frames - f0))
            for f0 in range(0, self.total_frames, window_frames)]
        self.header = dict(rec.header, _ntime=self.seg * self.nband)
        self._arm_degraded()

    @property
    def nwindows(self) -> int:
        return len(self.spans)

    def _staging(self, width: int) -> hostmem.HostSlab:
        return self._rec.staging(width, rows=len(self.rows))

    def _fill(self, slab, prev, prev_payload, w, span):
        """Window ``w``'s fresh samples of each band row read into
        ``slab``, its PFB tail copied from ``prev`` (the previous window's
        slot; the same slot when the feed has one, where numpy copies the
        overlap right).  A masked antenna is zeroed over the whole window,
        tail and every row included."""
        f0, fw = span
        nfft, ov = self.nfft, (self.ntap - 1) * self.nfft
        used = (fw + self.ntap - 1) * nfft
        fresh0 = 0 if w == 0 else ov
        for ri, b in enumerate(self.rows):
            host = slab.array[ri]
            if fresh0:
                prev_used = prev_payload[4]
                with self.timeline.stage("state", nbytes=host[:, :, :ov].nbytes):
                    host[:, :, :ov] = prev.array[ri][:, :, prev_used - ov:prev_used]
            self._rec.read(host[:, :, fresh0:],
                           b * self.seg + f0 * nfft + fresh0, used - fresh0)
        for a in self.masked_antennas:
            slab.array[:, a, :, :used] = 0
        return (w, f0, self.nband * used, fw, used,
                tuple(sorted(self.masked_antennas)))

    def _arrays(self, slab, used: int):
        vr, vi = self._rec.planes(slab.tensor, used, "antenna")
        if self.mesh is None:
            return vr[0], vi[0]
        return vr, vi

    def _to_mesh(self, arrays: Planar, used: int):
        """The local rows → one shard a local player: its band row's
        segment, its bank's channels."""
        from blit_torch.parallel import mesh as M

        shape = (self.nant, self.nchan, self.nband * used, self.npol)
        out = []
        for plane in arrays:
            shards = {}
            for b, k in self.mesh.local_players():
                blk = plane[self.rows.index(b), :, k * self.cper:(k + 1) * self.cper]
                shards[(b, k)] = blk.to(self.mesh.devices[b, k], non_blocking=True)
            out.append(M.MeshArray(self.mesh, M.P(None, "bank", "band"), shape,
                                   shards))
        return tuple(out)

    def __iter__(self) -> Iterator[Window]:
        return self._iter_windows(
            (min(self.window_frames, self.total_frames) + self.ntap - 1) * self.nfft)


def load_antennas_mesh(raw_paths: Sequence, *, mesh, axis: str = "bank",
                       start_sample: int = 0, max_samples: Optional[int] = None,
                       dtype="float32", layout: str = "antenna"
                       ) -> Tuple[Dict, Planar]:
    """Load per-antenna RAW recordings onto the beamform split: planar
    ``(nant, nchan, ntime, npol)`` (or packed ``(nchan, nant, npol,
    ntime)``, ``layout="chan"``) mesh arrays with the antenna axis split
    over ``axis``.  Each process opens only the antennas of its own
    players; the common span is agreed across the pod.  Returns
    ``(header, (vr, vi))``: the first local antenna's header plus
    ``_ntime`` and ``_nant``."""
    feed = AntennaStream(raw_paths, window_samples=1 << 62,
                         start_sample=start_sample, max_samples=max_samples,
                         dtype=dtype, layout=layout, prefetch_depth=1,
                         mesh=mesh, axis=axis)
    (win,) = list(feed)
    return feed.header, win.arrays


def load_correlator_mesh(raw_paths: Sequence, *, mesh, nfft: int, ntap: int = 4,
                         start_sample: int = 0, max_samples: Optional[int] = None,
                         dtype="float32") -> Tuple[Dict, Planar]:
    """Load per-antenna RAW recordings onto the correlator split: planar
    ``(nant, nchan, ntime, npol)`` mesh arrays, channels over ``bank``
    and time over ``band``, each band row's segment trimmed to whole
    ``nfft`` blocks (at least ``ntap``), ``correlate``'s segment
    semantics.  Every process reads every antenna, only its band rows'
    segments."""
    feed = CorrelatorStream(raw_paths, nfft=nfft, ntap=ntap,
                            window_frames=1 << 40, start_sample=start_sample,
                            max_samples=max_samples, dtype=dtype,
                            prefetch_depth=1, mesh=mesh)
    (win,) = list(feed)
    return feed.header, win.arrays
