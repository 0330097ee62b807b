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
  earlier chunks; every byte is read from disk once, into its final
  place.  On the CPU each slot's first ``(ntap-1)*nfft`` samples are
  copied from the previous slot's tail (the filter state, on the
  producer thread).  On a CUDA device the producer emits a
  :class:`ChunkPlan` a chunk and the dispatch thread assembles it on
  the card: the filter state copied on the device from the previous
  chunk's tail, then one 2-D DMA a segment from the slot's pinned slab
  (slots come from the staging pool, :mod:`blit_torch.hostmem`).
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

- Tuning (:mod:`blit_torch.tune`): ``chunk_frames``, ``prefetch_depth``
  and ``out_depth`` left ``None`` come from this rig's profile when one
  exists (keyed by the reducer's device), else from the defaults;
  :meth:`RawReducer.tuning_provenance` names the source of each.  With
  ``tune_online`` the asynchronous plane feeds an
  :class:`~blit_torch.tune.OnlineTuner` once per dispatched chunk.
- A source with ``feed_blocks()`` (the live
  :class:`blit_torch.stream.LiveRawStream`) feeds the producer in place
  of the file's blocks, through the same chunk framing, so a stream of
  a completed recording is byte-identical to its batch reduction.  On a
  CUDA device the producer does not copy a live block the block
  registry has page-locked (:class:`blit_torch.hostmem.BlockRegistry`:
  a recorder's recycled ring buffer, locked on its second sighting):
  the plan's segment points at the block, and the dispatch thread
  copies its channel rows straight into the device chunk.  The plan
  holds the block's stream chunk until the chunk is consumed, so a
  recycling source refills the buffer only after the card read it.
- Every ``_pump`` runs under :func:`blit_torch.monitor.publishing`.
- The threads' waits are stages of the reducer's Timeline: the
  producer's ``ingest.feed_wait`` (the next block from the feed) and
  ``ingest.slot_wait`` (a free chunk slot), the dispatch thread's
  ``dispatch.chunk_wait`` (a filled chunk) and ``dispatch.put_wait``
  (the output rotation, behind readback); ``dispatch`` holds
  ``dispatch.h2d`` (the copy calls, and the short last chunk's trim) and
  ``dispatch.launch`` (the channelizer's launches and the event).  The
  direct path adds ``ingest.direct`` (the bytes the card reads in place,
  apart from ``ingest``'s host reads; it times a plan's appends) and
  ``ingest.register`` (page-locking a block).  The stages of one chunk
  carry its sequence number into the Timeline's span store when that is
  open.
- ``trace_logdir`` wraps :meth:`RawReducer.stream`, :meth:`RawReducer.drain`
  and the pump in :func:`blit_torch.observability.profile_trace`: a
  ``torch.profiler`` Chrome trace (CUDA kernels included on the card)
  written into that directory, with the Timeline's span store open and
  its stage spans written into the trace (category ``blit.stage``), the
  products unchanged.
"""

from __future__ import annotations

import itertools
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

from blit_torch import hostmem, integrity, observability
from blit_torch.device import resolve_device
from blit_torch.io.guppi import GuppiRaw, RawSource, open_raw
from blit_torch.io.sigproc import (
    FilWriter,
    check_payload,
    read_fil_header,
    validate_slab,
    write_fil,
)
from blit_torch.observability import (
    StallWatchdog,
    Timeline,
    flight_recorder,
    profile_trace,
)
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


class ChunkPlan:
    """A chunk as the producer leaves it on a CUDA device: where each
    span of its samples comes from, for the dispatch thread to assemble
    on the card (:meth:`RawReducer._assemble`).

    - ``shape``: the device chunk, ``(nchan, chunk_samps, npol, 2)`` int8;
    - ``overlap``: its first ``(ntap-1)*nfft`` samples are the previous
      chunk's last ones (the PFB state), copied on the device;
    - ``segments``: ``(src, t0, take, dst)``, samples ``[t0, t0+take)`` of
      the host array ``src`` go to samples ``[dst, dst+take)``: ``src`` is
      a page-locked recorder block (read in place), or the chunk slot's
      pinned slab the producer read a block into (then ``t0 == dst``),
      or None for zeros (a masked block).

    A block read in place is held (its stream chunk's
    :meth:`~blit_torch.stream.source.StreamChunk.hold`) until
    :meth:`release`, once the card has read the chunk."""

    __slots__ = ("shape", "overlap", "segments", "_held")

    def __init__(self, shape: Tuple[int, ...], overlap: bool):
        self.shape = shape
        self.overlap = overlap
        self.segments: List[Tuple[Optional[np.ndarray], int, int, int]] = []
        self._held: List = []

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def add(self, src: Optional[np.ndarray], t0: int, take: int,
            dst: int, hold=None) -> None:
        """Append a segment, merged into the last one where both continue
        each other (a slab filled by several blocks: one copy); ``hold``,
        the stream chunk ``src`` belongs to, is held until :meth:`release`."""
        if hold is not None:
            hold.hold()
            self._held.append(hold)
        if self.segments:
            s, a, n, d = self.segments[-1]
            if s is src and d + n == dst and (src is None or a + n == t0):
                self.segments[-1] = (s, a, n + take, d)
                return
        self.segments.append((src, t0, take, dst))

    def release(self) -> None:
        """Nothing reads the plan's blocks any more (idempotent)."""
        held, self._held = self._held, []
        self.segments = []
        for c in held:
            c.release()


class _Chunk:
    """A filled chunk handed to the consumer: on the CPU ``slot``, the
    whole chunk slot's torch tensor, of which the first ``samps`` samples
    are the chunk; on a CUDA device ``plan`` (a :class:`ChunkPlan`,
    ``slot`` None), assembled on the card.  Both stay valid until
    :meth:`release`, after which the producer may refill the slot and a
    source its blocks; ``nbytes`` is the chunk's bytes."""

    __slots__ = ("slot", "plan", "samps", "frames", "nbytes", "seq", "_idx",
                 "_free")

    def __init__(self, slot: Optional[torch.Tensor], plan: Optional[ChunkPlan],
                 samps: int, frames: int, nbytes: int, idx: int, free,
                 seq: int) -> None:
        self.slot = slot
        self.plan = plan
        self.samps = samps
        self.frames = frames
        self.nbytes = nbytes
        self.seq = seq
        self._idx = idx
        self._free = free

    def release(self) -> None:
        if self._free is not None:
            free, self._free = self._free, None
            plan, self.plan = self.plan, None
            if plan is not None:
                plan.release()
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

    def leftovers(self) -> List:
        """After :meth:`close`: the payloads emitted and never yielded,
        for the fill's owner to let go of."""
        out = []
        while True:
            try:
                item = self._filled.get_nowait()
            except queue.Empty:
                return out
            if item is not None and item[0] is not _ROT_ERR:
                out.append(item[1])

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
    # i+1 while the device works on chunk i.  None: the tuning profile,
    # else 2.
    prefetch_depth: Optional[int] = None
    # Outputs in readback flight and write-behind queue slots; None = the
    # tuning profile, else max(2, prefetch_depth).
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
    # A torch.profiler trace of stream / drain / the pump, written as a
    # Chrome trace into this directory (None: no trace).
    trace_logdir: Optional[str] = None
    # The online tuner: a knob recommendation from the first chunks'
    # stages (tune.rec_* gauges; a profile with BLIT_TUNE_ONLINE=1).
    tune_online: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if os.environ.get("BLIT_SYNC_OUTPUT"):
            self.async_output = False
        check_quant(self.nbits)
        if self.stokes not in STOKES_NIF:
            raise ValueError(f"unknown stokes {self.stokes!r}")
        # Knobs left unset resolve from this rig's tuning profile.
        self._tuning_profile = None
        self._stream_nchan: Optional[int] = None
        self._profile_nchan_mismatch: Optional[int] = None
        self._knob_sources = {
            k: "explicit" if getattr(self, k) is not None else "default"
            for k in ("chunk_frames", "prefetch_depth", "out_depth")}
        if None in (self.chunk_frames, self.prefetch_depth, self.out_depth):
            from blit_torch import tune

            prof = tune.lookup(**self._tune_fingerprint_kw())
            if prof is not None:
                self._tuning_profile = prof
                for knob, value in prof.knobs().items():
                    if getattr(self, knob) is None:
                        setattr(self, knob, value)
                        self._knob_sources[knob] = "profile"
        if self.prefetch_depth is None:
            self.prefetch_depth = 2
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
        # The last assembled chunk's PFB overlap on the device (the live
        # feed on a CUDA device), for the next chunk's head.
        self._tail: Optional[torch.Tensor] = None

    def _tune_fingerprint_kw(self) -> Dict:
        """What this reduction's tuning profile is keyed under
        (:func:`blit_torch.tune.rig_fingerprint`)."""
        return dict(
            nfft=self.nfft, ntap=self.ntap, nint=self.nint,
            stokes=self.stokes, window=self.window, fqav_by=self.fqav_by,
            dtype=self.dtype, fft_method=self.fft_method, nbits=self.nbits,
            workload="reduce", device=self.device,
        )

    def tuning_provenance(self) -> Dict:
        """Where the ingest knobs came from (``blit``'s block): their
        values, each one's source (explicit, profile or default), the
        profile's provenance and a channel-count mismatch, if any."""
        prov = {
            "chunk_frames": self.chunk_frames,
            "prefetch_depth": self.prefetch_depth,
            "out_depth": self.out_depth,
            "sources": dict(self._knob_sources),
        }
        if self._tuning_profile is not None:
            prov["profile"] = self._tuning_profile.provenance()
        if self._profile_nchan_mismatch is not None:
            prov["profile_nchan_mismatch"] = {
                "tuned": self._profile_nchan_mismatch,
                "stream": self._stream_nchan,
            }
        return prov

    def _note_stream_nchan(self, nchan: int) -> None:
        """Warn once a stream when the loaded profile was measured on a
        recording of another channel count (the fingerprint leaves it
        out, but per-chunk cost scales with it)."""
        if self._stream_nchan == nchan:
            return
        self._stream_nchan = nchan
        prof = self._tuning_profile
        tuned = int(getattr(prof, "tuned_nchan", 0) or 0) if prof else 0
        if tuned and tuned != nchan:
            self._profile_nchan_mismatch = tuned
            log.warning(
                "tuning profile %s was measured on a %d-channel recording "
                "but this stream has %d channels; re-run the tune command "
                "on a matching recording (or set the knobs) if ingest "
                "underperforms", prof.key[:12], tuned, nchan)

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
        direct = st["ingest.direct"].bytes if "ingest.direct" in st else 0
        return ReductionStats(
            input_bytes=st["ingest"].bytes + direct,
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
    def _slot(self, bufs: List[Optional[hostmem.HostSlab]], j: int,
              shape: Tuple[int, ...]) -> hostmem.HostSlab:
        """Chunk slot ``j``'s slab, taken on first use from the slots kept
        across streams, else from the staging pool (pinned on a CUDA
        device)."""
        if bufs[j] is None:
            key = (shape, np.dtype(np.int8).str, self.device.type == "cuda")
            for i, b in enumerate(self._buf_cache):
                if b.key == key:
                    bufs[j] = self._buf_cache.pop(i)
                    break
            else:
                bufs[j] = hostmem.slab_pool().take(
                    shape, np.int8, pinned=key[2], timeline=self.timeline)
        return bufs[j]

    def _fill_rotation(self, feed, skip_frames: int,
                       bufs: List[Optional[hostmem.HostSlab]],
                       rot: BufferRotation,
                       blocks: Optional[hostmem.BlockRegistry] = None) -> None:
        """Fill the chunk rotation from the feed's ``(header,
        kept_samples, read_into)`` items (producer thread): each block is
        read once, into place (``read_into(dst, t0, n)`` copies samples
        ``[t0, t0+n)`` of the block into ``dst[:, :n]``; stage
        ``ingest``).  ``skip_frames`` skips the first frames exactly:
        frame N's window starts at sample ``N*nfft``.

        Without ``blocks`` (the CPU) slot ``j``'s first ``(ntap-1)*nfft``
        samples are copied from the previously filled slot's tail and the
        slot is the chunk.  With ``blocks`` (a CUDA device) each chunk is
        emitted as a :class:`ChunkPlan` with the same framing, its
        overlap taken on the card.  A live item carries its stream chunk
        as a fourth element (None for a masked seat, a zero segment): a
        block the registry has page-locked is a segment read in place,
        held until the chunk is consumed (stage ``ingest.direct`` times
        the append, apart from ``ingest``); any other block is read into
        the slot's pinned slab, which the plan points at."""
        nfft, ntap, nint = self.nfft, self.ntap, self.nint
        chunk_samps = (self.chunk_frames + ntap - 1) * nfft
        advance = self.chunk_frames * nfft
        state = (ntap - 1) * nfft
        to_skip = skip_frames * nfft
        tl = self.timeline
        cur: Optional[int] = None
        prev: Optional[int] = None
        plan: Optional[ChunkPlan] = None
        filled = 0
        seq = 0  # the chunk being filled, in stream order
        feed = iter(feed)
        try:
            while True:
                with tl.stage("ingest.feed_wait", byte_free=True):
                    item = next(feed, None)
                if item is None:
                    break
                hdr, nt, read_into = item[:3]
                if to_skip >= nt:
                    to_skip -= nt
                    continue
                t0, nt = to_skip, nt - to_skip
                to_skip = 0
                nchan = hdr["OBSNCHAN"]
                self._note_stream_nchan(nchan)
                npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
                shape = (nchan, chunk_samps, npol, 2)
                live = item[3] if len(item) > 3 else None
                zero = blocks is not None and len(item) > 3 and live is None
                block = live.data if live is not None else None
                direct = (blocks is not None and block is not None
                          and block.dtype == np.int8
                          and block.flags.c_contiguous and block.ndim == 4
                          and block.shape[0] == nchan
                          and block.shape[2:] == (npol, 2)
                          and blocks.sight(block, tl))
                while nt > 0:
                    if cur is None:
                        # Waiting for a free slot is back-pressure, timed
                        # apart from ingest.
                        with tl.stage("ingest.slot_wait", byte_free=True,
                                      seq=seq):
                            cur = rot.acquire()
                        if cur is None:
                            return  # the consumer abandoned the stream
                        filled = state if prev is not None else 0
                        if blocks is not None:
                            plan = ChunkPlan(shape, prev is not None)
                        elif prev is not None:
                            slab = self._slot(bufs, cur, shape)
                            with tl.stage("state",
                                          nbytes=nchan * state * npol * 2,
                                          seq=seq):
                                slab.array[:, :state] = \
                                    bufs[prev].array[:, advance:]
                    take = min(nt, chunk_samps - filled)
                    nbytes = nchan * take * npol * 2
                    if direct:
                        with tl.stage("ingest.direct", nbytes=nbytes, seq=seq):
                            plan.add(block, t0, take, filled, hold=live)
                    elif zero:
                        with tl.stage("ingest", nbytes=nbytes, seq=seq):
                            plan.add(None, t0, take, filled)
                    else:
                        dst = self._slot(bufs, cur, shape).array
                        with tl.stage("ingest", nbytes=nbytes, seq=seq):
                            read_into(dst[:, filled:], t0, take)
                        if plan is not None:
                            plan.add(dst, filled, take, filled)
                    filled += take
                    t0 += take
                    nt -= take
                    if filled == chunk_samps:
                        rot.emit(cur, (self.chunk_frames, chunk_samps, plan))
                        prev, cur, plan = cur, None, None
                        seq += 1
            if cur is not None and filled > (state if prev is not None else 0):
                # Flush: whole frames left, rounded down to the integration.
                frames = usable_frames(filled, nfft, ntap, nint)
                if frames > 0:
                    rot.emit(cur, (frames, (frames + ntap - 1) * nfft, plan))
                    plan = None
        finally:
            if plan is not None:  # never emitted: its blocks are free
                plan.release()
            close = getattr(feed, "close", None)
            if close is not None:
                close()

    def _chunks(self, raw: GuppiRaw, skip_frames: int = 0,
                extra_slots: int = 0) -> Iterator[_Chunk]:
        """The pipelined chunker: :class:`_Chunk` handles in stream order.
        The caller must release every chunk once nothing reads its slot.
        ``extra_slots`` widens the rotation beyond ``prefetch_depth`` for
        the chunks the output plane keeps in flight.  A source with
        ``feed_blocks()`` (a live stream) feeds the producer in place of
        its file's blocks; on a CUDA device every chunk is a
        :class:`ChunkPlan`, assembled on the card."""
        nbufs = max(2, self.prefetch_depth) + max(0, extra_slots)
        bufs: List[Optional[hostmem.HostSlab]] = [None] * nbufs
        live = hasattr(raw, "feed_blocks")
        blocks = hostmem.host_blocks() if self.device.type == "cuda" else None

        def fill(r):
            feed = raw.feed_blocks() if live else raw_block_feed(raw)
            self._fill_rotation(feed, skip_frames, bufs, r, blocks)

        rot = BufferRotation(nbufs, fill, name="blit-ingest")
        tl = self.timeline
        self._tail = None
        with tl.stage("stream"):
            try:
                slots = rot.slots()
                for seq in itertools.count():
                    with tl.stage("dispatch.chunk_wait", byte_free=True,
                                  seq=seq):
                        item = next(slots, None)
                    if item is None:
                        break
                    idx, (frames, samps, plan) = item
                    shape = plan.shape if plan is not None else bufs[idx].array.shape
                    nbytes = shape[0] * samps * shape[2] * shape[3]
                    tl.stages["stream"].bytes += nbytes
                    yield _Chunk(None if plan is not None else bufs[idx].tensor,
                                 plan, samps, frames, nbytes, idx, rot.release,
                                 seq)
            finally:
                rot.close()
                for _, _, plan in rot.leftovers():
                    if plan is not None:
                        plan.release()
                self._tail = None
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
    def _assemble(self, plan: ChunkPlan) -> torch.Tensor:
        """The device chunk of ``plan``, on the current stream: the PFB
        overlap from the previous chunk's tail (a device-to-device copy),
        then one ``cudaMemcpy2DAsync`` (or memset) a segment; the tail of
        this chunk is kept for the next one."""
        v = torch.empty(plan.shape, dtype=torch.int8, device=self.device)
        state = (self.ntap - 1) * self.nfft
        if plan.overlap:
            hostmem.copy_rows(v, 0, self._tail, 0, state)
        for src, t0, take, dst in plan.segments:
            if src is None:
                hostmem.zero_rows(v, dst, take)
            else:
                hostmem.copy_rows(v, dst, src, t0, take)
        tail = torch.empty((plan.shape[0], state) + plan.shape[2:],
                           dtype=torch.int8, device=self.device)
        hostmem.copy_rows(tail, 0, v, plan.shape[1] - state, state)
        self._tail = tail
        return v

    def _dispatch(self, chunk: _Chunk, narrow: bool, event: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Put the chunk on the device (on the card assembled from its
        plan, on the CPU its slot as it is; the short last chunk is
        trimmed on the device; stage ``dispatch.h2d``) and launch the
        channelizer (and, with ``narrow``, the quantization; with
        ``event``, record an event after the launches; stage
        ``dispatch.launch``).  Returns the output and the event (None
        without ``event``), without waiting."""
        tl, seq, plan = self.timeline, chunk.seq, chunk.plan
        nbytes = chunk.slot.nbytes if plan is None else plan.nbytes
        with tl.stage("dispatch.h2d", nbytes=nbytes, seq=seq):
            v = chunk.slot if plan is None else self._assemble(plan)
            if chunk.samps < v.shape[1]:
                v = v[:, :chunk.samps].contiguous()
        with tl.stage("dispatch.launch", byte_free=True, seq=seq):
            out = channelize(v, self.coeffs, nfft=self.nfft, ntap=self.ntap,
                             nint=self.nint, stokes=self.stokes,
                             fft_method=self.fft_method, dtype=self.dtype,
                             fqav_by=self.fqav_by, device=self.device)
            if narrow and self.nbits < 32:
                out = narrow_device(out, self.nbits, self.quant_scale,
                                    self.quant_offset)
            ev = record_event(out) if event else None
        return out, ev

    def _run_chunk(self, chunk: _Chunk) -> np.ndarray:
        """The synchronous device step: dispatch and read back."""
        with self.timeline.stage("device", nbytes=chunk.nbytes):
            return self._dispatch(chunk, narrow=False)[0].cpu().numpy()

    def _narrow_host(self, slab: np.ndarray) -> np.ndarray:
        if self.nbits == 32:
            return np.ascontiguousarray(slab)
        return narrow_host(slab, self.nbits, self.quant_scale, self.quant_offset)

    # -- streaming ---------------------------------------------------------
    def _stream_async(self, raw: GuppiRaw, skip_frames: int, reuse: bool,
                      narrow: bool = False, tuner=None) -> Iterator:
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
                with self.timeline.stage("dispatch", byte_free=True,
                                         seq=chunk.seq):
                    out, ev = self._dispatch(chunk, narrow, event=True)
                self._output_frames += chunk.frames
                if tuner is not None:
                    tuner.observe_chunk()
                slabs = rot.put(out, event=ev, nbytes=chunk.nbytes,
                                on_consumed=chunk.release, seq=chunk.seq)
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

    def stream(self, raw: RawSource, skip_frames: int = 0) -> Iterator[np.ndarray]:
        """Yield slabs ``(nspectra, nif, nchans)`` covering the recording
        gap-free, one per chunk: float32, or the ``nbits`` integer form
        :meth:`reduce_to_file` writes.  ``skip_frames`` skips the first N
        output frames exactly.  The slabs are the caller's to keep."""
        src = open_raw(raw)
        try:
            with profile_trace(self.trace_logdir, self.device,
                               timeline=self.timeline), \
                    observability.span("reduce.stream", nfft=self.nfft,
                                       path=getattr(src, "path", "")):
                yield from self._stream(src, skip_frames)
        finally:
            if src is not raw:
                src.close()

    def drain(self, raw: RawSource) -> float:
        """Run the streaming reduction with a device-side sink: each
        chunk's product reduces to a sum on the device, waited on once
        ``prefetch_depth - 1`` newer chunks are in flight (then its slot
        is released).  Returns the sum over all products.  The last waits
        stay inside the profiler's window."""
        src = open_raw(raw)
        try:
            with profile_trace(self.trace_logdir, self.device,
                               timeline=self.timeline):
                total = 0.0
                pending: deque = deque()
                for chunk in self._chunks(src):
                    with self.timeline.stage("dispatch", byte_free=True,
                                             seq=chunk.seq):
                        pending.append((chunk,
                                        self._dispatch(chunk, False)[0].sum()))
                    self._output_frames += chunk.frames
                    while len(pending) >= max(2, self.prefetch_depth):
                        done, s = pending.popleft()
                        with self.timeline.stage("device",
                                                 nbytes=done.nbytes):
                            total += float(s)
                        done.release()
                while pending:
                    done, s = pending.popleft()
                    with self.timeline.stage("device", nbytes=done.nbytes):
                        total += float(s)
                    done.release()
                self._retire_staging()
            return total
        finally:
            if src is not raw:
                src.close()

    def _pump(self, raw: GuppiRaw, writer, skip_frames: int = 0) -> int:
        """Drive the reduction into a slab writer and finalize it: host
        read, H2D and compute, readback and the disk write each on a
        thread of their own (producer, dispatch, readback, sink), with
        back-pressure end to end.  Returns the spectra written; on error
        the writer is aborted and the error re-raised.  Runs under
        :func:`blit_torch.monitor.publishing` (a no-op unless monitoring
        is configured)."""
        from blit_torch.monitor import publishing

        with publishing(self.timeline), \
                profile_trace(self.trace_logdir, self.device,
                              timeline=self.timeline), \
                observability.span("reduce.pump", nfft=self.nfft,
                                   out=str(getattr(writer, "path", ""))):
            return self._pump_impl(raw, writer, skip_frames)

    def _pump_impl(self, raw: GuppiRaw, writer, skip_frames: int) -> int:
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
        tuner = None
        if self.tune_online:
            from blit_torch.tune import OnlineTuner

            tuner = OnlineTuner(
                self.timeline,
                {"chunk_frames": self.chunk_frames,
                 "prefetch_depth": self.prefetch_depth,
                 "out_depth": self.out_depth},
                nint=self.nint)
        sink = AsyncSink(writer, depth=max(2, self.out_depth),
                         timeline=self.timeline,
                         stall_timeout_s=self.output_stall_timeout_s)
        try:
            for slab in self._stream_async(raw, skip_frames, reuse=True,
                                           narrow=True, tuner=tuner):
                sink.append(slab.data, release=slab.release)
            t0 = time.perf_counter()
            sink.close()
            self.timeline.stages["stream"].seconds += time.perf_counter() - t0
        except BaseException:
            sink.abort()
            raise
        self.timeline.overlap_efficiency()
        self._retire_staging()
        if tuner is not None:
            tuner.maybe_persist(tuned_nchan=self._stream_nchan or 0,
                                **self._tune_fingerprint_kw())
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
        hdr, off = read_fil_header(path)
        check_payload(path, hdr, off)
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
