"""Streaming GUPPI RAW → filterbank reduction driver.

Counterpart of ``blit/pipeline.py``'s :class:`RawReducer`.  The reducer
reads voltage blocks into host chunk slots, carries the PFB state from
one slot to the next, feeds fixed-shape chunks to
:func:`blit_torch.ops.channelize.channelize` on the device, and writes
SIGPROC ``.fil`` products.  Every rawspec preset runs on the card:
``0000`` through ``pfb_dft1`` + ``tail2_detect``, ``0001`` and ``0002``
through ``pfb_dequant`` + ``dft_last`` (the channelizer picks the plan);
a one-pol recording through the FIR in torch ops + the DFT kernels.

- A chunk of ``chunk_frames + ntap - 1`` blocks of ``nfft`` samples
  yields ``chunk_frames`` PFB frames; consecutive chunks share a
  ``(ntap-1)*nfft``-sample overlap, so frames are continuous across
  chunks and the product does not depend on ``chunk_frames``.
- ``chunk_frames`` is a multiple of ``nint``.  The last, short chunk
  keeps the whole frames left, rounded down to ``nint``
  (:func:`usable_frames`); trailing samples that cannot fill an
  integration are dropped, as rawspec does.
- Ingest is pipelined (:class:`BufferRotation`): a producer thread fills
  a rotation of chunk slots from the file while the device works on
  earlier chunks.  Each slot's first ``(ntap-1)*nfft`` samples are
  copied from the previous slot's tail (the filter state, on the
  producer thread); every other byte is read from disk once, into its
  final place.  Slots come from the staging pool
  (:mod:`blit_torch.hostmem`), pinned on a CUDA device, so the
  host→device copy is a ``non_blocking`` DMA.
- Output is asynchronous by default (:mod:`blit_torch.outplane`): each
  chunk is dispatched, an event recorded after its launches, and the
  output handed to a readback thread that waits on the event, frees the
  chunk's slot, and copies the product to the host on a stream of its
  own; ``.fil`` appends run on a write-behind sink.  ``async_output=False``
  (or ``BLIT_SYNC_OUTPUT=1`` in the environment) runs each chunk's
  device call and readback on the consumer thread instead, the A/B path;
  the products are byte-identical.
- ``nbits=8/16`` writes quantized products
  (:mod:`blit_torch.ops.narrow`): narrowed on the device before the
  readback on the asynchronous path, on the host on the synchronous one,
  bitwise the same.

- Products: :meth:`RawReducer.reduce_to_file` writes ``.h5`` / ``.hdf5``
  through :class:`blit_torch.io.fbh5.FBH5Writer` (``compression`` None,
  ``"gzip"`` or ``"bitshuffle"``; ``chunks``) and ``.fil`` for any other
  path; :meth:`RawReducer.reduce_resumable` writes either crash-resumably
  (a :class:`ReductionCursor` sidecar, restart through the
  ``skip_frames`` replay).  Every product gets a manifest sidecar
  (:mod:`blit_torch.integrity`); RAW blocks that failed their digest are
  zero-filled by the reader and listed in the header
  (``_masked_blocks``).  A source is a file, a ``.NNNN.raw`` scan (a
  path list or a stem) or an open :class:`GuppiRaw` / :class:`GuppiScan`:
  a scan streams across its members as one recording.

``blit``'s tuning profiles and online tuner, the live ``feed_blocks()``
source, spans and ``profile_trace`` are later items (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from blit_torch import hostmem, integrity
from blit_torch.device import resolve_device
from blit_torch.io.guppi import GuppiRaw, RawSource, open_raw
from blit_torch.io.sigproc import (
    FilWriter,
    read_fil_header,
    validate_slab,
    write_fil,
)
from blit_torch.observability import StallWatchdog, Timeline, flight_recorder
from blit_torch.ops.channelize import (
    STOKES_NIF,
    channelize,
    output_header,
    pfb_coeffs,
    usable_frames,
)
from blit_torch.ops.fqav import fqav_range
from blit_torch.ops.narrow import (
    NARROW_DTYPES,
    check_quant,
    narrow_device,
    narrow_host,
)
from blit_torch.outplane import (
    AsyncSink,
    OutputRotation,
    readback_extra_slots,
    record_event,
)

log = logging.getLogger("blit_torch.pipeline")

# rawspec-equivalent product presets: name → (nfft, nint).
PRODUCT_PRESETS = {
    "0000": (1 << 20, 1),        # hi-res: ~3 Hz channels
    "0001": (1 << 3, 128),       # mid-res time product
    "0002": (1 << 10, 1 << 11),  # low-res survey product
}


@dataclass
class ReductionStats:
    """Aggregate throughput view derived from the reducer's timeline."""

    input_bytes: int = 0
    output_frames: int = 0
    device_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def gbps(self) -> float:
        return self.input_bytes / self.wall_seconds / 1e9 if self.wall_seconds else 0.0


class _Chunk:
    """A filled chunk slot handed to the consumer: ``view`` (numpy) is
    its first ``samps`` samples, ``slot`` the whole slot's torch tensor.
    Both stay valid until :meth:`release`, after which the producer may
    refill the slot."""

    __slots__ = ("view", "slot", "samps", "frames", "_idx", "_free")

    def __init__(self, view: np.ndarray, slot: torch.Tensor, samps: int,
                 frames: int, idx: int, free) -> None:
        self.view = view
        self.slot = slot
        self.samps = samps
        self.frames = frames
        self._idx = idx
        self._free = free

    def release(self) -> None:
        if self._free is not None:
            free, self._free = self._free, None
            free(self._idx)


_ROT_ERR = object()  # producer-exception marker on the filled queue


class BufferRotation:
    """The prefetch rotation behind every pipelined host feed: one
    producer thread fills slots it acquires from a free ring and emits
    ``(slot, payload)``; the consumer iterates :meth:`slots` and must
    :meth:`release` every slot once nothing (host or device) still reads
    it.  Slots are indices: their storage belongs to the fill callback.

    - ``fill(rot)`` runs in a daemon thread: ``rot.acquire()`` a slot
      (None: the consumer is gone, return), fill it, ``rot.emit(slot,
      payload)``.  Returning ends the stream; an exception re-raises in
      the consumer.
    - A slot is refilled only after its release; reading an emitted slot
      concurrently (the filter-state copy) is safe.
    - A consumer holding every slot while asking for more gets an error,
      not a deadlock.
    - ``stall_timeout_s`` arms a watchdog: a live producer that neither
      acquires nor emits for that long raises in the consumer (waits for
      a free slot count as progress).
    """

    def __init__(self, nslots: int, fill, *, name: str = "blit-feed",
                 stall_timeout_s: Optional[float] = None):
        self.nslots = max(2, nslots)
        self.stall_timeout_s = stall_timeout_s
        self._free: "queue.Queue[int]" = queue.Queue()
        for j in range(self.nslots):
            self._free.put(j)
        self._filled: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._fill = fill
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = False
        # Slots yielded and not released; releases arrive from the
        # readback thread too.
        self._held = 0
        self._held_lock = threading.Lock()
        self._wd = StallWatchdog(stall_timeout_s, name,
                                 what="a wedged read would otherwise hang the stream")

    def _run(self) -> None:
        try:
            self._fill(self)
            self._filled.put(None)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            self._filled.put((_ROT_ERR, e))

    # -- producer side ----------------------------------------------------
    def acquire(self) -> Optional[int]:
        """Next free slot; None once the consumer is gone."""
        while not self._stop.is_set():
            try:
                slot = self._free.get(timeout=0.2)
            except queue.Empty:
                self._wd.beat()  # back-pressure, not a stall
                continue
            self._wd.beat()
            return slot
        return None

    def emit(self, slot: int, payload) -> None:
        self._wd.beat()
        self._filled.put((slot, payload))

    # -- consumer side ----------------------------------------------------
    def release(self, slot: int) -> None:
        with self._held_lock:
            self._held -= 1
        self._free.put(slot)

    def slots(self) -> Iterator[Tuple[int, object]]:
        """Yield ``(slot, payload)`` in stream order, starting the
        producer on first use; re-raises producer exceptions."""
        self._wd.beat()
        self._thread.start()
        self._started = True
        poll = self._wd.poll_s(0.5)
        try:
            while True:
                try:
                    item = self._filled.get(timeout=poll)
                except queue.Empty:
                    if self._held >= self.nslots:
                        msg = (f"BufferRotation starved: all {self.nslots} slots "
                               "are held unreleased by the consumer — release() "
                               "earlier chunks/windows before requesting more, "
                               "or raise prefetch_depth")
                        flight_recorder().dump(msg)
                        raise RuntimeError(msg)
                    self._wd.check("producer stalled",
                                   active=self._thread.is_alive())
                    continue
                if item is None:
                    return
                slot, payload = item
                if slot is _ROT_ERR:
                    raise payload
                with self._held_lock:
                    self._held += 1
                yield slot, payload
        finally:
            self.close()

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop the producer and join it (idempotent), bounded: a producer
        wedged inside a fill is abandoned with a warning."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=join_timeout_s)
            if self._thread.is_alive():
                log.warning("%s: producer did not exit within %.1fs of close; "
                            "abandoning the daemon thread", self._thread.name,
                            join_timeout_s)


def raw_block_feed(raw: GuppiRaw):
    """The block feed of an indexed recording, one file or a scan:
    ``(header, kept_samples, read_into)`` in stream order, the producer's
    input.  A scan's blocks are numbered across its members, so the feed
    crosses member boundaries as it crosses blocks."""
    for i in range(raw.nblocks):
        yield (raw.header(i), raw.block_ntime_kept(i),
               lambda dst, t0, n, i=i: raw.read_block_into(i, dst, t0, n))


@dataclass
class RawReducer:
    """Configured RAW → filterbank reduction on one device.

    ``device=None`` runs on the CUDA device and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch path.
    """

    nfft: int
    ntap: int = 4
    nint: int = 1
    stokes: str = "I"
    window: str = "hamming"
    # channelize's FFT: "auto" (= "matmul", the DFT kernels), "direct" or
    # "four_step" (torch.fft).
    fft_method: str = "auto"
    # On-device frequency averaging of every fqav_by fine channels.
    fqav_by: int = 1
    # Working dtype of the stage-1 spectra ("float32" | "bfloat16").
    dtype: str = "float32"
    # Output frames per device call; rounded up to a multiple of nint.
    # The default (~8M samples per coarse channel, at most 64 frames,
    # blit's) gives 0002 2048 frames and 0001 only 128.
    chunk_frames: Optional[int] = None
    # Chunk slots in the ingest rotation (>= 2): the producer reads chunk
    # i+1 while the device works on chunk i.
    prefetch_depth: int = 2
    # Outputs in readback flight and write-behind queue slots; None =
    # max(2, prefetch_depth).
    out_depth: Optional[int] = None
    # The asynchronous output plane; False (or BLIT_SYNC_OUTPUT=1) runs
    # the synchronous path, byte-identical.
    async_output: bool = True
    # Watchdog of the readback and writer threads (None: wait forever).
    output_stall_timeout_s: Optional[float] = None
    # Quantized .fil products: clip(rint(x*quant_scale + quant_offset),
    # 0, 2^nbits - 1) as uint8/uint16 (32: float32, no quantization).
    nbits: int = 32
    quant_scale: float = 1.0
    quant_offset: float = 0.0
    device: Optional[str] = None
    timeline: Timeline = field(default_factory=Timeline)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if os.environ.get("BLIT_SYNC_OUTPUT"):
            self.async_output = False
        check_quant(self.nbits)
        if self.stokes not in STOKES_NIF:
            raise ValueError(f"unknown stokes {self.stokes!r}")
        if self.out_depth is None:
            self.out_depth = max(2, self.prefetch_depth)
        self.out_depth = max(2, self.out_depth)
        if self.chunk_frames is None:
            # ~8M samples per coarse channel per device call (blit's
            # budget): few frames for the 1M-point product.
            budget = max(1, (1 << 23) // self.nfft)
            self.chunk_frames = self.nint * max(1, min(64, budget) // self.nint)
        if self.chunk_frames % self.nint:
            self.chunk_frames += self.nint - self.chunk_frames % self.nint
        if self.fqav_by > 1 and self.nfft % self.fqav_by:
            raise ValueError(f"fqav_by={self.fqav_by} does not divide nfft={self.nfft}")
        self._pfb_coeffs: Optional[torch.Tensor] = None
        self._output_frames = 0
        # Chunk slots kept across streams of this reducer; retired to the
        # staging pool after a stream that ended synchronized.
        self._buf_cache: List[hostmem.HostSlab] = []

    @property
    def coeffs(self) -> torch.Tensor:
        """The PFB coefficient bank on the device, built on first use."""
        if self._pfb_coeffs is None:
            self._pfb_coeffs = torch.from_numpy(
                pfb_coeffs(self.ntap, self.nfft, self.window)).to(self.device)
        return self._pfb_coeffs

    @property
    def stats(self) -> ReductionStats:
        st = self.timeline.stages
        return ReductionStats(
            input_bytes=st["ingest"].bytes,
            output_frames=self._output_frames,
            device_seconds=st["device"].seconds,
            wall_seconds=st["stream"].seconds,
        )

    def header_for(self, raw: GuppiRaw) -> Dict:
        hdr = output_header(raw.header(0), nfft=self.nfft, nint=self.nint,
                            stokes=self.stokes)
        if self.fqav_by > 1:
            fch1, foff, nchans = fqav_range(hdr["fch1"], hdr["foff"],
                                            hdr["nchans"], self.fqav_by)
            hdr.update(fch1=fch1, foff=foff, nchans=nchans,
                       nfpc=self.nfft // self.fqav_by)
        return hdr

    # -- ingest ------------------------------------------------------------
    def _fill_rotation(self, feed, skip_frames: int,
                       bufs: List[Optional[hostmem.HostSlab]],
                       rot: BufferRotation) -> None:
        """Fill the chunk rotation from ``(header, kept_samples,
        read_into)`` triples (producer thread).  Slot ``j``'s first
        ``(ntap-1)*nfft`` samples are copied from the previously filled
        slot's tail; the rest is read once, into place
        (``read_into(dst, t0, n)`` copies samples ``[t0, t0+n)`` of the
        block into ``dst[:, :n]``).  ``skip_frames`` skips the first
        frames exactly: frame N's window starts at sample ``N*nfft``."""
        nfft, ntap, nint = self.nfft, self.ntap, self.nint
        chunk_samps = (self.chunk_frames + ntap - 1) * nfft
        advance = self.chunk_frames * nfft
        state = (ntap - 1) * nfft
        to_skip = skip_frames * nfft
        pinned = self.device.type == "cuda"
        cur: Optional[int] = None
        prev: Optional[int] = None
        filled = 0
        for hdr, nt, read_into in feed:
            if to_skip >= nt:
                to_skip -= nt
                continue
            t0, nt = to_skip, nt - to_skip
            to_skip = 0
            nchan = hdr["OBSNCHAN"]
            npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
            while nt > 0:
                if cur is None:
                    # Waiting for a free slot is back-pressure, not ingest.
                    cur = rot.acquire()
                    if cur is None:
                        return  # the consumer abandoned the stream
                    if bufs[cur] is None:
                        key = ((nchan, chunk_samps, npol, 2),
                               np.dtype(np.int8).str, pinned)
                        for j, b in enumerate(self._buf_cache):
                            if b.key == key:
                                bufs[cur] = self._buf_cache.pop(j)
                                break
                        else:
                            bufs[cur] = hostmem.slab_pool().take(
                                key[0], np.int8, pinned=pinned,
                                timeline=self.timeline)
                    if prev is not None:
                        with self.timeline.stage(
                                "state", nbytes=nchan * state * npol * 2):
                            bufs[cur].array[:, :state] = \
                                bufs[prev].array[:, advance:]
                        filled = state
                    else:
                        filled = 0
                take = min(nt, chunk_samps - filled)
                with self.timeline.stage("ingest", nbytes=nchan * take * npol * 2):
                    read_into(bufs[cur].array[:, filled:], t0, take)
                filled += take
                t0 += take
                nt -= take
                if filled == chunk_samps:
                    rot.emit(cur, (self.chunk_frames, chunk_samps))
                    prev, cur = cur, None
        if cur is not None and filled > (state if prev is not None else 0):
            # Flush: whole frames left, rounded down to the integration.
            frames = usable_frames(filled, nfft, ntap, nint)
            if frames > 0:
                rot.emit(cur, (frames, (frames + ntap - 1) * nfft))

    def _chunks(self, raw: GuppiRaw, skip_frames: int = 0,
                extra_slots: int = 0) -> Iterator[_Chunk]:
        """The pipelined chunker: :class:`_Chunk` handles in stream order.
        The caller must release every chunk once nothing reads its slot.
        ``extra_slots`` widens the rotation beyond ``prefetch_depth`` for
        the chunks the output plane keeps in flight."""
        nbufs = max(2, self.prefetch_depth) + max(0, extra_slots)
        bufs: List[Optional[hostmem.HostSlab]] = [None] * nbufs
        rot = BufferRotation(
            nbufs,
            lambda r: self._fill_rotation(raw_block_feed(raw), skip_frames,
                                          bufs, r),
            name="blit-ingest")
        with self.timeline.stage("stream"):
            try:
                for idx, (frames, samps) in rot.slots():
                    view = bufs[idx].array[:, :samps]
                    self.timeline.stages["stream"].bytes += view.nbytes
                    yield _Chunk(view, bufs[idx].tensor, samps, frames, idx,
                                 rot.release)
            finally:
                rot.close()
                # Keep the (faulted, pinned) slots for the next stream.
                self._buf_cache = [b for b in bufs if b is not None][:nbufs]

    def _retire_staging(self) -> None:
        """Hand the stream's chunk slots to the staging pool: only after a
        terminal synchronization (no dispatch can still read them)."""
        pool = hostmem.slab_pool()
        for b in self._buf_cache:
            pool.give(b)
        self._buf_cache = []

    # -- device step -------------------------------------------------------
    def _dispatch(self, chunk: _Chunk, narrow: bool) -> torch.Tensor:
        """Copy the chunk to the device (``non_blocking`` from its pinned
        slot; the short last chunk uploads its whole slot and is trimmed
        on the device) and launch the channelizer (and, with ``narrow``,
        the quantization).  Returns without waiting."""
        v = chunk.slot.to(self.device, non_blocking=True)
        if chunk.samps < chunk.slot.shape[1]:
            v = v[:, :chunk.samps].contiguous()
        out = channelize(v, self.coeffs, nfft=self.nfft, ntap=self.ntap,
                         nint=self.nint, stokes=self.stokes,
                         fft_method=self.fft_method, dtype=self.dtype,
                         fqav_by=self.fqav_by, device=self.device)
        if narrow and self.nbits < 32:
            out = narrow_device(out, self.nbits, self.quant_scale,
                                self.quant_offset)
        return out

    def _run_chunk(self, chunk: _Chunk) -> np.ndarray:
        """The synchronous device step: dispatch and read back."""
        with self.timeline.stage("device", nbytes=chunk.view.nbytes):
            return self._dispatch(chunk, narrow=False).cpu().numpy()

    def _narrow_host(self, slab: np.ndarray) -> np.ndarray:
        if self.nbits == 32:
            return np.ascontiguousarray(slab)
        return narrow_host(slab, self.nbits, self.quant_scale, self.quant_offset)

    # -- streaming ---------------------------------------------------------
    def _stream_async(self, raw: GuppiRaw, skip_frames: int, reuse: bool,
                      narrow: bool = False) -> Iterator:
        """The overlapped core of :meth:`stream` and :meth:`_pump`:
        dispatch each chunk, record an event, hand the output to an
        :class:`OutputRotation` and yield its slabs in stream order.
        With readback depth ``d``, ``put(chunk w)`` returns once chunk
        ``w-(d-1)`` is on the host, so chunk ``w`` computes while ``w+1``
        is dispatched; an un-synchronized chunk keeps its slot (released
        by the readback thread after the event), hence the wider
        rotation."""
        depth = max(2, self.out_depth)
        rot = OutputRotation(depth=depth, timeline=self.timeline, reuse=reuse,
                             name="blit-readback",
                             stall_timeout_s=self.output_stall_timeout_s)
        try:
            extra = readback_extra_slots(depth, self.prefetch_depth)
            for chunk in self._chunks(raw, skip_frames, extra_slots=extra):
                with self.timeline.stage("dispatch", byte_free=True):
                    out = self._dispatch(chunk, narrow)
                    ev = record_event(out)
                self._output_frames += chunk.frames
                slabs = rot.put(out, event=ev, nbytes=chunk.view.nbytes,
                                on_consumed=chunk.release)
                del out
                yield from slabs
            # The readback tail is streaming wall time too.
            t0 = time.perf_counter()
            yield from rot.drain()
            self.timeline.stages["stream"].seconds += time.perf_counter() - t0
        finally:
            rot.close()

    def _stream(self, raw: GuppiRaw, skip_frames: int = 0) -> Iterator[np.ndarray]:
        if not self.async_output:
            for chunk in self._chunks(raw, skip_frames):
                try:
                    out = self._run_chunk(chunk)
                finally:
                    chunk.release()
                self._output_frames += chunk.frames
                yield self._narrow_host(out)
            self._retire_staging()
            return
        for slab in self._stream_async(raw, skip_frames, reuse=False, narrow=True):
            slab.release()
            yield slab.data
        self._retire_staging()

    def stream(self, raw_src: RawSource, skip_frames: int = 0) -> Iterator[np.ndarray]:
        """Yield slabs ``(nspectra, nif, nchans)`` covering the recording
        gap-free, one per chunk: float32, or the ``nbits`` integer form
        :meth:`reduce_to_file` writes.  ``skip_frames`` skips the first N
        output frames exactly.  The slabs are the caller's to keep."""
        raw = open_raw(raw_src)
        try:
            yield from self._stream(raw, skip_frames)
        finally:
            if raw is not raw_src:
                raw.close()

    def drain(self, raw_src: RawSource) -> float:
        """Run the streaming reduction with a device-side sink: each
        chunk's product reduces to a sum on the device, waited on once
        ``prefetch_depth - 1`` newer chunks are in flight (then its slot
        is released).  Returns the sum over all products."""
        raw = open_raw(raw_src)
        try:
            total = 0.0
            pending: deque = deque()
            for chunk in self._chunks(raw):
                with self.timeline.stage("dispatch", byte_free=True):
                    pending.append((chunk, self._dispatch(chunk, False).sum()))
                self._output_frames += chunk.frames
                while len(pending) >= max(2, self.prefetch_depth):
                    done, s = pending.popleft()
                    with self.timeline.stage("device", nbytes=done.view.nbytes):
                        total += float(s)
                    done.release()
            while pending:
                done, s = pending.popleft()
                with self.timeline.stage("device", nbytes=done.view.nbytes):
                    total += float(s)
                done.release()
            self._retire_staging()
            return total
        finally:
            if raw is not raw_src:
                raw.close()

    def _pump(self, raw: GuppiRaw, writer, skip_frames: int = 0) -> int:
        """Drive the reduction into a slab writer and finalize it: host
        read, H2D and compute, readback and the disk write each on a
        thread of their own (producer, dispatch, readback, sink), with
        back-pressure end to end.  Returns the spectra written; on error
        the writer is aborted and the error re-raised."""
        if not self.async_output:
            try:
                for slab in self._stream(raw, skip_frames):
                    with self.timeline.stage("write", nbytes=slab.nbytes):
                        writer.append(slab)
                writer.close()
            except BaseException:
                writer.abort()
                raise
            return writer.nsamps
        sink = AsyncSink(writer, depth=max(2, self.out_depth),
                         timeline=self.timeline,
                         stall_timeout_s=self.output_stall_timeout_s)
        try:
            for slab in self._stream_async(raw, skip_frames, reuse=True,
                                           narrow=True):
                sink.append(slab.data, release=slab.release)
            t0 = time.perf_counter()
            sink.close()
            self.timeline.stages["stream"].seconds += time.perf_counter() - t0
        except BaseException:
            sink.abort()
            raise
        self.timeline.overlap_efficiency()
        self._retire_staging()
        return sink.nsamps

    # -- whole-recording entry points ---------------------------------------
    def _open_validated(self, raw_src: RawSource) -> Tuple[GuppiRaw, Dict]:
        raw = open_raw(raw_src)
        if raw.nblocks == 0:
            raise ValueError(f"empty or fully truncated RAW file: {raw.path}")
        return raw, self.header_for(raw)

    def _surface_integrity(self, raw, hdr: Dict) -> None:
        """Record the blocks the reader zero-filled after a failed digest
        in the product header (``_masked_blocks``), through the one mask
        rule (:func:`blit_torch.parallel.antenna.record_mask`)."""
        bad = sorted(getattr(raw, "bad_blocks", None) or ())
        if not bad:
            return
        from blit_torch.parallel.antenna import record_mask

        masked: set = set()
        for b in bad:
            record_mask(masked, b, "failed digest verification", header=hdr,
                        timeline=self.timeline, kind="block")

    def reduce(self, raw_src: RawSource) -> Tuple[Dict, np.ndarray]:
        """Reduce a whole RAW recording (a file or a scan) in memory →
        ``(header, data)`` with data ``(nsamps, nif, nchans)`` in the
        product's dtype."""
        raw, hdr = self._open_validated(raw_src)
        try:
            slabs = list(self._stream(raw))
        finally:
            if raw is not raw_src:
                raw.close()
        if slabs:
            data = np.concatenate(slabs, axis=0)
        else:
            data = np.zeros((0, STOKES_NIF[self.stokes], hdr["nchans"]),
                            NARROW_DTYPES[self.nbits])
        hdr["nbits"] = self.nbits
        hdr["nsamps"] = data.shape[0]
        self._surface_integrity(raw, hdr)
        return hdr, data

    def _check_format(self, out_path: str, compression: Optional[str],
                      chunks) -> bool:
        """``blit``'s refusals of the output knobs; True for ``.h5``."""
        if out_path.endswith((".h5", ".hdf5")):
            if self.nbits != 32:
                raise ValueError("nbits=8/16 quantized output is a SIGPROC "
                                 ".fil feature; FBH5 products are float32")
            return True
        if compression is not None:
            raise ValueError(".fil products are uncompressed; compression "
                             "applies to .h5 output")
        if chunks is not None:
            raise ValueError("chunks applies to .h5 output")
        return False

    def reduce_to_file(self, raw_src: RawSource, out_path: str,
                       compression: Optional[str] = None,
                       chunks: Optional[Tuple[int, int, int]] = None) -> Dict:
        """Reduce and stream a product to ``out_path`` through a
        ``.partial`` sibling renamed on success: FBH5 for a path ending in
        ``.h5`` / ``.hdf5`` (``compression`` None | ``"gzip"`` |
        ``"bitshuffle"``, ``chunks`` the HDF5 chunk shape), SIGPROC
        ``.fil`` for any other path.  Returns the header."""
        is_h5 = self._check_format(out_path, compression, chunks)
        raw, hdr = self._open_validated(raw_src)
        try:
            nif = STOKES_NIF[self.stokes]
            if is_h5:
                from blit_torch.io.fbh5 import FBH5Writer

                w = FBH5Writer(out_path, hdr, nifs=nif, nchans=hdr["nchans"],
                               compression=compression, chunks=chunks)
            else:
                w = FilWriter(out_path, hdr, nif, hdr["nchans"],
                              dtype=NARROW_DTYPES[self.nbits])
            hdr["nsamps"] = self._pump(raw, w)
        finally:
            if raw is not raw_src:
                raw.close()
        self._surface_integrity(raw, hdr)
        return hdr

    def reduce_resumable(self, raw_src: RawSource, out_path: str,
                         compression: Optional[str] = None,
                         chunks: Optional[Tuple[int, int, int]] = None) -> Dict:
        """Reduce to a ``.fil`` or ``.h5`` product that survives a crash.

        A :class:`ReductionCursor` sidecar (``<out>.cursor``) records the
        frames durably written; a re-run with the same configuration and
        the same RAW bytes truncates any unclaimed tail and continues
        from the last claim through the ``skip_frames`` replay, so the
        finished product equals an uninterrupted run's.  The claim is
        verified against the product's manifest first; a cursor that does
        not match, or a target that does not hold what it claims, starts
        afresh.  The cursor is removed on completion.  On the
        asynchronous plane the cursor may lag slabs that were queued but
        not written; the replay reduces them again, identically."""
        is_h5 = self._check_format(out_path, compression, chunks)
        raw, hdr = self._open_validated(raw_src)
        try:
            return self._reduce_resumable(raw, hdr, out_path, is_h5,
                                          compression, chunks)
        finally:
            if raw is not raw_src:
                raw.close()

    def _reduce_resumable(self, raw, hdr: Dict, out_path: str, is_h5: bool,
                          compression: Optional[str], chunks) -> Dict:
        # The cursor's identity of a scan is its member list.
        paths = getattr(raw, "paths", None) or raw.path
        nif = STOKES_NIF[self.stokes]
        comp_id = compression or "none"
        chunks_id = list(chunks) if chunks is not None else None
        cur = ReductionCursor.load(out_path)
        resuming = (cur is not None and cur.matches(self, paths)
                    and cur.compression == comp_id and cur.chunks == chunks_id
                    and os.path.exists(out_path))
        if resuming:
            rows = cur.frames_done // self.nint
            if is_h5:
                from blit_torch.io.fbh5 import resume_target_ok

                ok = resume_target_ok(out_path, nif, hdr["nchans"], rows)
            else:
                ok = resume_fil_ok(out_path, nif, hdr["nchans"], rows,
                                   dtype=NARROW_DTYPES[self.nbits])
            if not ok:
                log.warning("resume target %s does not hold the cursor's "
                            "claimed %d frames (crash-corrupted?); starting "
                            "fresh", out_path, cur.frames_done)
                resuming = False
        if resuming:
            log.info("resuming %s at frame %d", out_path, cur.frames_done)
        else:
            size, mtime_ns = ReductionCursor.stat_raw(paths)
            cur = ReductionCursor(
                paths, self.nfft, self.ntap, self.nint, self.stokes, 0,
                window=self.window, raw_size=size, raw_mtime_ns=mtime_ns,
                fqav_by=self.fqav_by, dtype=self.dtype, compression=comp_id,
                chunks=chunks_id, nbits=self.nbits,
                quant_scale=self.quant_scale, quant_offset=self.quant_offset)
        start_rows = cur.frames_done // self.nint if resuming else 0
        if is_h5:
            from blit_torch.io.fbh5 import ResumableFBH5Writer

            w = ResumableFBH5Writer(out_path, hdr, nif, hdr["nchans"],
                                    start_rows, self.nint, cur,
                                    compression=compression, chunks=chunks)
        else:
            w = ResumableFilWriter(out_path, hdr, nif, hdr["nchans"],
                                   start_rows, self.nint, cur,
                                   dtype=NARROW_DTYPES[self.nbits])
        # _pump aborts the writer on an error: file and cursor stay as
        # the resume point.
        hdr["nsamps"] = self._pump(raw, w, skip_frames=start_rows * self.nint)
        self._surface_integrity(raw, hdr)
        return hdr


def resume_fil_ok(path: str, nif: int, nchans: int, rows: int,
                  dtype=np.float32) -> bool:
    """May a ``.fil`` resume target honour a cursor claiming ``rows``
    spectra?  It must parse as SIGPROC and hold at least the claimed
    bytes (truncating a shorter file would extend it with zeros), and
    where a manifest exists, the claimed region's digest must match its
    ledger."""
    try:
        _, off = read_fil_header(path)
        size = os.path.getsize(path)
    except (OSError, ValueError):
        return False
    row_bytes = nif * nchans * np.dtype(dtype).itemsize
    if size < off + rows * row_bytes:
        return False
    return integrity.verify_claim(path, rows, fmt="fil",
                                  row_bytes=row_bytes) is not False


class ResumableFilWriter:
    """Append-directly ``.fil`` writer whose incompleteness marker is a
    :class:`ReductionCursor` sidecar, not a ``.partial`` rename: each
    slab is fsync'd, then the manifest's ledger saved, then the cursor's
    claim, so a crash leaves a resumable prefix and never a cursor ahead
    of the bytes.  ``start_rows`` > 0 resumes: the product is truncated
    to that many spectra and the cursor set to match; 0 (or a missing
    file) starts fresh."""

    def __init__(self, path: str, header: Dict, nif: int, nchans: int,
                 start_rows: int, nint: int, cursor: "ReductionCursor",
                 dtype=np.float32):
        self.path = path
        self._nint = nint
        self._nif = nif
        self._nchans = nchans
        self.dtype = np.dtype(dtype)
        self.cursor = cursor
        row_bytes = nif * nchans * self.dtype.itemsize
        self._mf = integrity.ManifestWriter(path, "fil", row_bytes=row_bytes,
                                            writer=type(self).__name__)
        if start_rows > 0 and os.path.exists(path):
            _, off = read_fil_header(path)
            with open(path, "r+b") as f:
                f.truncate(off + start_rows * row_bytes)
            cursor.frames_done = start_rows * nint
            cursor.save(path)
            # The running digest over the truncated (verified) claim.
            self._mf.data_offset = off
            self._mf.fold_path(path)
            self._mf.claim(start_rows)
            self._mf.save()
        else:
            start_rows = 0
            write_fil(path, header, np.zeros((0, nif, nchans), self.dtype))
            cursor.frames_done = 0
            cursor.save(path)
            self._mf.data_offset = os.path.getsize(path)
            self._mf.fold_path(path)
            self._mf.save()
        self._f = open(path, "ab")
        self.nsamps = start_rows

    def append(self, slab: np.ndarray) -> None:
        slab = validate_slab(slab, self._nif, self._nchans, self.dtype)
        slab.tofile(self._f)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.nsamps += slab.shape[0]
        self._mf.fold(slab)
        self._mf.claim(self.nsamps)
        self._mf.save()
        self.cursor.frames_done = self.nsamps * self._nint
        self.cursor.save(self.path)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        """Finish: the manifest turns complete and stays; the cursor
        sidecar goes, and its absence marks the product complete."""
        self._f.close()
        self._mf.publish()
        sidecar = self.cursor.path_for(self.path)
        if os.path.exists(sidecar):
            os.unlink(sidecar)

    def abort(self) -> None:
        # The file and the cursor are the resume point: keep both.
        self._f.close()


@dataclass
class ReductionCursor:
    """Restart state of a resumable reduction, a JSON sidecar beside the
    product with ``blit``'s field names and defaults, so either package
    resumes a cursor the other wrote.

    ``frames_done`` counts PFB frames reduced and durably written, a
    multiple of ``nint``.  :meth:`matches` guards the identity: every
    output-affecting knob, and the RAW input's bytes (size and mtime of
    each member, in any order).  ``compression`` and ``chunks`` are
    compared by the caller; ``despike_nfpc`` and ``window_rows`` belong to
    ``blit``'s mesh writer (-1: not used)."""

    raw_path: Union[str, List[str]]
    nfft: int
    ntap: int
    nint: int
    stokes: str
    frames_done: int = 0
    window: str = "hamming"
    raw_size: Union[int, List[int]] = -1
    raw_mtime_ns: Union[int, List[int]] = -1
    fqav_by: int = 1
    dtype: str = "float32"
    despike_nfpc: int = -1
    compression: str = "none"
    window_rows: int = -1
    chunks: Optional[List[int]] = None
    nbits: int = 32
    quant_scale: float = 1.0
    quant_offset: float = 0.0

    @staticmethod
    def stat_raw(raw_path: Union[str, Sequence[str]]) -> Tuple:
        """(size, mtime_ns) of a path, or parallel lists for a list."""
        if isinstance(raw_path, str):
            st = os.stat(raw_path)
            return st.st_size, st.st_mtime_ns
        stats = [os.stat(p) for p in raw_path]
        return [s.st_size for s in stats], [s.st_mtime_ns for s in stats]

    @staticmethod
    def path_for(out_path: str) -> str:
        return out_path + ".cursor"

    def save(self, out_path: str) -> None:
        """Publish atomically: write a temporary, fsync, rename."""
        tmp = self.path_for(out_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.__dict__, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path_for(out_path))

    @classmethod
    def load(cls, out_path: str):
        try:
            with open(cls.path_for(out_path)) as f:
                return cls(**json.load(f))
        except (OSError, ValueError, TypeError):
            return None

    @staticmethod
    def normalized_members(raw_path, raw_size, raw_mtime_ns
                           ) -> List[Tuple[str, int, int]]:
        """The RAW identity as ``(path, size, mtime_ns)`` triples sorted
        by path: a scan is the same recording in any listing order."""

        def norm(x):
            return list(x) if isinstance(x, (list, tuple)) else [x]

        return sorted(zip(norm(raw_path), norm(raw_size), norm(raw_mtime_ns)))

    def matches(self, red: "RawReducer",
                raw_path: Union[str, Sequence[str]]) -> bool:
        try:
            size, mtime_ns = self.stat_raw(raw_path)
        except OSError:
            return False
        return (
            self.normalized_members(self.raw_path, self.raw_size,
                                    self.raw_mtime_ns)
            == self.normalized_members(raw_path, size, mtime_ns)
            and self.nfft == red.nfft
            and self.ntap == red.ntap
            and self.nint == red.nint
            and self.stokes == red.stokes
            and self.window == red.window
            and self.fqav_by == red.fqav_by
            and self.dtype == red.dtype
            and self.despike_nfpc == getattr(red, "despike_nfpc", -1)
            and self.nbits == getattr(red, "nbits", 32)
            and self.quant_scale == getattr(red, "quant_scale", 1.0)
            and self.quant_offset == getattr(red, "quant_offset", 0.0)
        )


def reducer_for_product(product: str, **kw) -> RawReducer:
    """A :class:`RawReducer` configured like rawspec's standard product
    ``product`` ("0000" | "0001" | "0002")."""
    nfft, nint = PRODUCT_PRESETS[product]
    return RawReducer(nfft=nfft, nint=nint, **kw)
