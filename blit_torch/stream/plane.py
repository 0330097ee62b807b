"""The watermark assembler and the live entry points.

Counterpart of ``blit/stream/plane.py``.  :class:`LiveRawStream` sits
between a :class:`~blit_torch.stream.source.ChunkSource` and the
reducers: it reorders arrivals within the lateness budget, drops
duplicates and post-mask stragglers, and offers the result as
``feed_blocks()``, the ``(header, kept_samples, read_into, chunk)`` items
the reducer's producer consumes in place of the file's blocks
(:meth:`blit_torch.pipeline.RawReducer._fill_rotation`).  Both paths feed
the same gap-free samples through the same chunk framing, so a stream of
a completed recording is byte-identical to its batch reduction.

The watermark trails the earliest evidence that the head chunk is
missing (a pending newer chunk, or the end of the stream) by
``lateness_s``; a seat it passes is masked: its samples feed as zeros
(zero weight, :func:`blit_torch.parallel.antenna.record_mask`), and a
chunk arriving after that is counted late and dropped.  The first
incident of a stream forces a flight-recorder dump.  A packet source's
``gapped`` set masks a seat at once.

Latency: :class:`_LatencyTap` wraps the product writer and records, per
append, ``stream.chunk_to_product_s`` (the arrival of the newest sample a
product row depends on, to that row handed to its writer) into the
reducer's Timeline histogram; the feed samples the
``stream.watermark_lag_s`` gauge; ``stream.chunk.*`` count the repairs.
The producer's wait on the feed (this assembler's reordering and the
source's ``get``) is the reducer's ``ingest.feed_wait`` stage, timed
around each step of ``feed_blocks()``.

Entry points: :func:`stream_reduce` (``.fil`` / ``.h5``, ``nbits``,
``resume=True`` rejoin through a
:class:`~blit_torch.stream.cursor.StreamCursor`, ``heartbeat``) and
:func:`stream_search` (``.hits``) drive
:class:`~blit_torch.pipeline.RawReducer` /
:class:`~blit_torch.search.dedoppler.DedopplerReducer` unchanged, under
:func:`blit_torch.monitor.publishing` for the whole session.
"""

from __future__ import annotations

import bisect
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

from blit_torch import faults, observability
from blit_torch.config import DEFAULT, SiteConfig, stream_defaults
from blit_torch.io.guppi import block_ntime
from blit_torch.observability import Timeline
from blit_torch.stream.source import ChunkSource, StreamChunk

log = logging.getLogger("blit_torch.stream")


class LiveRawStream:
    """A recording still being written, as the block feed the streaming
    reducers consume (module docstring).  Duck-types the slice of the
    ``GuppiRaw`` surface the pipelined producer touches: ``path``,
    ``header(0)`` (blocks until the first chunk arrives) and
    ``feed_blocks()`` (the watermark-ordered producer feed).

    One pass per instance: the feed is consumed on the ingest rotation's
    producer thread while ``arrival_for`` is read from the sink side —
    the marks list is append-only, so the cross-thread reads need no
    lock."""

    def __init__(self, source: ChunkSource, *,
                 lateness_s: Optional[float] = None,
                 stall_timeout_s: Optional[float] = None,
                 timeline: Optional[Timeline] = None,
                 premasked=None,
                 clock=time.monotonic, sleep=time.sleep,
                 config: SiteConfig = DEFAULT):
        d = stream_defaults(config)
        self.source = source
        self.lateness_s = (d["lateness_s"] if lateness_s is None
                           else lateness_s)
        self.timeline = timeline if timeline is not None else Timeline()
        self.path = getattr(source, "path", "<stream>")
        self._clock = clock
        self._sleep = sleep
        self._poll = max(0.005, min(0.05, self.lateness_s / 4 or 0.05))
        self._wd = observability.StallWatchdog(
            (d["stall_timeout_s"] if stall_timeout_s is None
             else stall_timeout_s),
            f"blit-stream[{self.path}]",
            what="a wedged chunk source would otherwise hang the live "
                 "feed; late data is the watermark's job, silence this "
                 "long is not",
        )
        self.header0: Optional[Dict] = None
        self._pending: Dict[int, StreamChunk] = {}
        self._next = 0
        self._total: Optional[int] = None
        self._eos_t: Optional[float] = None
        # Degradation ledger: masked seqs mirror into
        # mask_header["_masked_chunks"] via record_mask, and the
        # stream_report() merge puts them on the product header.
        self.masked_chunks: set = set()
        self.mask_header: Dict = {}
        # Rejoin state: seats a PREVIOUS consumer's watermark
        # already masked (persisted in the StreamCursor).  They were
        # folded as zeros into rows the product already claims, so a
        # restarted consumer must re-mask them unconditionally — even if
        # the recorder's bytes exist on disk by now; such data counts
        # late, exactly as a straggler after a live mask would.
        self._premasked: set = set(premasked or ())
        self.late_chunks = 0
        self.dup_chunks = 0
        self.chunks_in = 0
        self.flight_dump: Optional[str] = None
        # Arrival marks: (cumulative kept samples, arrival time) of
        # each fed block — ONE tuple append per block, so the sink
        # thread's reads race only against whole entries (append-only;
        # see class docstring).  Masked spans feed degraded_rows().
        self._marks: List[tuple] = []
        self.masked_spans: List[tuple] = []
        # (seq, sample_a, sample_b) per masked seat, append-only like
        # _marks — the sink-thread-safe view the rejoin cursor persists
        # (reading the masked_chunks SET cross-thread would race its
        # producer-side mutation).
        self._masked_log: List[tuple] = []
        self._cum = 0

    # -- receipt + watermark ----------------------------------------------
    def _recv(self, timeout: float) -> bool:
        """Pull one chunk from the source; admit or reject it.  Returns
        True when a chunk was consumed (admitted or not)."""
        c = self.source.get(timeout)
        if c is None:
            if self.source.finished and self._total is None:
                total = self.source.total
                if total is None:
                    total = max(
                        [self._next - 1, *self._pending.keys()]) + 1
                self._total = total
                self._eos_t = self._clock()
            return False
        self._wd.beat()
        now = self._clock()
        act = faults.fire("stream.chunk", key=f"{self.path}#{c.seq}")
        copies = 1
        if act is not None:
            if act.mode == "drop":
                log.warning("injected drop of stream chunk %d", c.seq)
                c.release()
                return True
            if act.mode == "dup":
                copies = 2
        for _ in range(copies):
            self._admit(c, now)
        return True

    def _admit(self, c: StreamChunk, now: float) -> None:
        self.chunks_in += 1
        if c.seq in self._pending or (
                c.seq < self._next and c.seq not in self.masked_chunks):
            # The seat was already filled on time: a duplicate delivery.
            self.dup_chunks += 1
            self.timeline.count("stream.chunk.dup")
            observability.flight_recorder().event(
                "stream", "chunk.dup", seq=c.seq)
            if self._pending.get(c.seq) is not c:  # not a second admission
                c.release()
            return
        if c.seq < self._next:
            # The watermark already masked this seat: the chunk is LATE —
            # counted and dropped (re-opening an emitted window would
            # re-reduce history; bounded latency means never doing that).
            self.late_chunks += 1
            self.timeline.count("stream.chunk.late")
            rec = observability.flight_recorder()
            rec.event("stream", "chunk.late", seq=c.seq)
            self._incident(
                f"stream chunk {c.seq} of {self.path} arrived after its "
                f"{self.lateness_s}s lateness budget (already masked)")
            c.release()
            return
        c.t_arrival = now
        self._pending[c.seq] = c
        self.timeline.count("stream.chunks")
        self.timeline.gauge("stream.pending_chunks", len(self._pending))

    def _overdue_since(self) -> Optional[float]:
        """The earliest evidence that the head chunk is missing: the
        oldest pending newer arrival, or end-of-stream.  (Every pending
        seq is > ``_next`` by construction.)  None = no evidence — a
        quiet source is a slow recorder, not a gap."""
        ts = [c.t_arrival for c in self._pending.values()]
        if self._total is not None and self._next < self._total:
            ts.append(self._eos_t)
        return min(ts) if ts else None

    def _mask_next(self, now: float) -> StreamChunk:
        """Give up the head seat: emit a zero-fill placeholder (the
        zero-weight antenna discipline applied to time)."""
        from blit_torch.parallel.antenna import record_mask

        seq = self._next
        self._next += 1
        if self._pending:
            template = self._pending[min(self._pending)].header
        else:
            template = self.header0
        record_mask(
            self.masked_chunks, seq,
            f"never arrived within the {self.lateness_s}s lateness "
            f"budget", header=self.mask_header, timeline=self.timeline,
            kind="chunk",
        )
        rec = observability.flight_recorder()
        rec.event("stream", "chunk.masked", seq=seq)
        self._incident(
            f"stream chunk {seq} of {self.path} missing past the "
            f"{self.lateness_s}s watermark; masked (zero weight) — "
            "product degraded, pipeline continuing")
        return StreamChunk(seq, dict(template), None, t_arrival=now,
                           masked=True)

    def _incident(self, reason: str) -> None:
        """One FORCED flight dump per stream (the first incident is the
        triage trail; later ones ride the recorder's own rate limit)."""
        rec = observability.flight_recorder()
        if self.flight_dump is None:
            self.flight_dump = rec.dump(reason, force=True)
        else:
            rec.dump(reason)

    def _ordered(self) -> Iterator[StreamChunk]:
        """Chunks in sequence order — arrivals reordered within the
        lateness budget, overdue seats masked, duplicates/stragglers
        dropped — until end-of-stream."""
        while True:
            if self._next in self._premasked:
                # A seat the pre-crash consumer already masked: re-mask
                # it without waiting out the watermark (the decision was
                # made — and claimed into the product — last run), and
                # drop any now-available data as late.
                c = self._pending.pop(self._next, None)
                if c is not None:
                    c.release()
                    self.late_chunks += 1
                    self.timeline.count("stream.chunk.late")
                    observability.flight_recorder().event(
                        "stream", "chunk.late", seq=c.seq, remask=True)
                self.timeline.count("stream.chunk.remask")
                yield self._mask_next(self._clock())
                continue
            if self._next in self._pending:
                c = self._pending.pop(self._next)
                self._next += 1
                yield c
                continue
            gapped = getattr(self.source, "gapped", None)
            if gapped is not None and self._next in gapped:
                # The packet assembler PROVED this seat is a gap (its
                # block was abandoned past the reorder horizon — see
                # blit_torch/stream/packet.py): mask it now instead of
                # waiting out the lateness budget.  Same zero-weight
                # bytes as a watermark mask, lower latency — the
                # assembler's evidence (packets far past the block)
                # is strictly stronger than a timer.
                self.timeline.count("stream.chunk.gap_fastpath")
                yield self._mask_next(self._clock())
                continue
            if (self._total is not None and self._next >= self._total
                    and not self._pending):
                return
            got = self._recv(self._poll)
            now = self._clock()
            since = self._overdue_since()
            if since is not None and now - since > self.lateness_s:
                yield self._mask_next(now)
            elif not got:
                if self.source.finished:
                    # Waiting out the lateness budget for a trailing
                    # gap: a finished source returns instantly, so pace
                    # the loop (and don't call it a stall — this wait
                    # is the watermark working as designed).
                    self._sleep(self._poll)
                else:
                    self._wd.check("live chunk feed stalled")

    # -- the GuppiRaw-shaped surface ---------------------------------------
    def header(self, i: int = 0) -> Dict:
        """The stream's first available block header (blocks until the
        recorder has produced one) — what the product headers derive
        from, exactly as on the batch path."""
        if i != 0:
            raise IndexError("a live stream exposes only header(0)")
        if self.header0 is None:
            while not self._pending:
                got = self._recv(self._poll)
                if (not got and self._total is not None
                        and not self._pending):
                    raise ValueError(
                        f"empty stream: {self.path} delivered no chunks")
                if not got:
                    self._wd.check("waiting for the first chunk")
            self.header0 = dict(self._pending[min(self._pending)].header)
        return self.header0

    def feed_blocks(self):
        """The producer feed (:func:`blit_torch.pipeline.raw_block_feed`'s
        live twin): ``(header, kept_samples, read_into, chunk)`` in stream
        order, ``chunk`` the :class:`StreamChunk` (None for a masked
        seat).  The feed releases a chunk when the producer asks for the
        next item; a reducer on a CUDA device that reads ``chunk.data``
        in place later holds it (:meth:`StreamChunk.hold`) until the card
        has read it.  The overlap-trim rule is the batch one — every
        block but the stream's LAST drops its trailing ``OVERLAP``
        samples — so blocks with overlap are held until their successor
        (or end-of-stream) proves which side of the rule they fall on;
        overlap-free blocks feed with zero added latency."""
        self.header(0)
        owned: List[StreamChunk] = []  # taken in order, not yet fed
        try:
            for c in self._ordered():
                owned.append(c)
                if len(owned) > 1:
                    yield from self._feed_one(owned.pop(0), last=False)
                if not c.header.get("OVERLAP", 0):
                    yield from self._feed_one(owned.pop(0), last=False)
            if owned:
                yield from self._feed_one(owned.pop(0), last=True)
        finally:
            for c in owned + list(self._pending.values()):
                c.release()
            self._pending.clear()

    def _feed_one(self, c: StreamChunk, last: bool):
        """Feed ``c`` as one item; ``c`` is released when the producer
        moves on."""
        try:
            hdr = c.header
            nt = block_ntime(hdr)
            if not last:
                nt -= hdr.get("OVERLAP", 0)
            now = self._clock()
            self.timeline.gauge("stream.watermark_lag_s", now - c.t_arrival)
            a = self._cum
            self._cum += nt
            self._marks.append((self._cum, c.t_arrival))
            if c.masked:
                self.masked_spans.append((a, self._cum))
                self._masked_log.append((c.seq, a, self._cum))
            if c.masked:
                def read_into(dst, t0, take):
                    dst[:, :take] = 0
                    return take
            else:
                def read_into(dst, t0, take, data=c.data):
                    dst[:, :take] = data[:, t0:t0 + take]
                    return take
            yield hdr, nt, read_into, None if c.masked else c
        finally:
            c.release()

    # -- latency lookup (sink side) ----------------------------------------
    def arrival_for(self, sample: int) -> Optional[float]:
        """Arrival time of the block that delivered gap-free-stream
        sample ``sample`` (clamped to the last fed block for flush
        tails).  None before anything was fed."""
        n = len(self._marks)  # snapshot: the list only grows
        if n == 0:
            return None
        # (sample,) sorts before (sample, t): bisect lands on the first
        # mark with cum >= sample.
        i = min(bisect.bisect_left(self._marks, (sample,), 0, n), n - 1)
        return self._marks[i][1]

    def degraded_rows(self, nfft: int, ntap: int, nint: int = 1,
                      max_rows: Optional[int] = None) -> int:
        """How many OUTPUT rows the masking degraded: rows (of ``nint``
        PFB frames each) whose frames' analysis windows touch any
        zero-filled sample.  ``max_rows`` clamps to what was actually
        written (the flush drops trailing partial frames).  Frame ``f``
        consumes gap-free samples ``[f·nfft, (f+ntap)·nfft)``."""
        rows = set()
        for a, b in self.masked_spans:
            f_lo = max(0, (a - ntap * nfft) // nfft + 1)
            f_hi = (b - 1) // nfft
            r_lo, r_hi = f_lo // nint, f_hi // nint
            if max_rows is not None:
                r_hi = min(r_hi, max_rows - 1)
            rows.update(range(r_lo, r_hi + 1))
        return len(rows)

    # -- reporting ---------------------------------------------------------
    def stream_report(self) -> Dict:
        """The degradation/latency summary merged onto the finished
        product header by the entry points."""
        out = {
            "stream_chunks": self.chunks_in,
            "stream_late_chunks": self.late_chunks,
            "stream_dup_chunks": self.dup_chunks,
            "stream_masked_chunks": len(self.masked_chunks),
        }
        out.update(self.mask_header)  # _masked_chunks, when any
        if self.flight_dump:
            out["stream_flight_dump"] = self.flight_dump
        return out


class _LatencyTap:
    """A transparent product-writer wrapper observing chunk→product
    latency: after each append it maps the product's new end position
    back to the last gap-free-stream sample it depends on (PFB tail
    included), and records ``now - arrival(that sample)`` into the
    ``stream.chunk_to_product_s`` histogram.  Handles both slab writers
    (``FilWriter``/``FBH5Writer``: rows × ``nint`` frames) and the
    ragged ``.hits`` writers (``WindowHits``: windows × ``T`` spectra).
    Rides inside :class:`blit_torch.outplane.AsyncSink` unchanged — appends
    land on the sink thread, which is exactly where "product durable"
    is decided."""

    def __init__(self, writer, live: LiveRawStream, timeline: Timeline,
                 *, nfft: int, ntap: int, nint: int,
                 window_spectra: Optional[int] = None,
                 clock=time.monotonic, cursor=None, heartbeat=None,
                 start_rows: int = 0):
        self._w = writer
        self._live = live
        self._tl = timeline
        self._nfft, self._ntap, self._nint = nfft, ntap, nint
        self._T = window_spectra
        self._rows = start_rows
        self._clock = clock
        self._cursor = cursor
        self._hb = heartbeat
        # Monotone prune index into the live feed's _masked_log: spans
        # land in increasing sample order and the claim frontier only
        # advances, so entries once behind the cut never need
        # re-scanning — per-append mask bookkeeping is O(new masks),
        # not O(session degradation history).
        self._mask_lo = 0
        self.path = getattr(writer, "path", None)

    def append(self, item) -> None:
        if self._cursor is not None:
            # Mask state rides the SAME durable claim as the rows
            # set it on the cursor before the resumable
            # writer's fsync-then-save inside append(), so a crash can
            # never claim rows whose masks it forgot.  Masks observed
            # after the last claim are re-derived by the replay.  Read
            # from the append-only _masked_log (never the producer-
            # mutated set), and PRUNE seats whose samples sit entirely
            # before the claim frontier: frame f consumes samples
            # [f·nfft, (f+ntap)·nfft), so a span ending at or before
            # claimed_frames·nfft can never touch an un-claimed row —
            # the persisted list stays bounded by the claim lag, not
            # the session's degradation history.
            if self._T is not None:
                claimed = (self._cursor.windows_done * self._T
                           * self._nint)
            else:
                claimed = self._cursor.frames_done
            cut = claimed * self._nfft
            log_snap = list(self._live._masked_log)
            while (self._mask_lo < len(log_snap)
                   and log_snap[self._mask_lo][2] <= cut):
                self._mask_lo += 1
            keep = {seq for seq, a, b in log_snap[self._mask_lo:]
                    if b > cut}
            # Premasked seats this run's feed has not re-reached yet
            # (a second crash before them must not forget them; the
            # _premasked set is frozen once the feed starts, so the
            # cross-thread read is safe).
            head = self._live._next
            keep.update(s for s in self._live._premasked if s >= head)
            self._cursor.masked_chunks = sorted(keep)
        self._w.append(item)
        if self._T is not None:  # ragged: one WindowHits per window
            frames = (item.window + 1) * self._T * self._nint
        else:
            self._rows += item.shape[0]
            frames = self._rows * self._nint
        need = (frames + self._ntap - 1) * self._nfft
        t = self._live.arrival_for(need)
        if t is not None:
            self._tl.observe("stream.chunk_to_product_s",
                             self._clock() - t)
        if self._hb is not None:
            # Per-append liveness (the supervisor's lease refresh): a
            # consumer that stops landing product rows stops beating.
            self._hb(frames)

    def flush(self) -> None:
        fl = getattr(self._w, "flush", None)
        if fl is not None:
            fl()

    def close(self) -> None:
        self._w.close()

    def abort(self) -> None:
        self._w.abort()

    @property
    def nsamps(self) -> int:
        return self._w.nsamps

    @property
    def nwindows(self) -> int:
        return getattr(self._w, "nwindows", 0)


def stream_reduce(source: ChunkSource, out_path: str, *,
                  reducer=None, lateness_s: Optional[float] = None,
                  stall_timeout_s: Optional[float] = None,
                  compression: Optional[str] = None,
                  chunks=None, resume: bool = False, heartbeat=None,
                  config: SiteConfig = DEFAULT,
                  **reducer_kw) -> Dict:
    """Reduce a LIVE recording to a ``.fil`` / ``.h5`` product while it
    records: the streaming twin of
    :meth:`blit_torch.pipeline.RawReducer.reduce_to_file`, byte-identical to
    it for a completed stream.  ``reducer`` supplies a configured
    :class:`~blit_torch.pipeline.RawReducer`; otherwise ``reducer_kw``
    (``nfft``/``nint``/...) build one recording on the process-wide
    timeline (so fleet harvest and the CI telemetry artifact see the
    ``stream.*`` histograms).  Returns the product header with the
    stream degradation report merged (``stream_masked_chunks`` et al.).

    ``resume=True`` makes the live consumer REJOINABLE: a
    :class:`~blit_torch.stream.cursor.StreamCursor` sidecar persists the
    product claim + mask state on every durable append, and a restarted
    consumer re-attaches to the still-recording session mid-file —
    truncating any un-checkpointed tail, re-masking previously-masked
    seats, and fast-forwarding through already-claimed rows via the
    skip-frames replay — finishing byte-identical to a never-restarted
    consumer.  ``heartbeat(frames)`` is the per-append liveness callback
    (a supervisor's lease refresh)."""
    from blit_torch.ops.channelize import STOKES_NIF
    from blit_torch.pipeline import RawReducer

    if reducer is None:
        reducer_kw.setdefault("timeline",
                              observability.process_timeline())
        reducer = RawReducer(**reducer_kw)
    red = reducer
    cur = None
    resuming = False
    session = getattr(source, "path", "<stream>")
    is_h5 = out_path.endswith((".h5", ".hdf5"))
    if resume:
        from blit_torch.stream.cursor import StreamCursor

        cur = StreamCursor.load(out_path)
        resuming = (
            cur is not None
            and cur.matches(red, session, "filterbank", compression)
            and os.path.exists(out_path)
        )
        if not resuming:
            cur = StreamCursor.fresh(red, session, "filterbank",
                                     compression)
    live = LiveRawStream(
        source, lateness_s=lateness_s, stall_timeout_s=stall_timeout_s,
        timeline=red.timeline, config=config,
        premasked=(cur.masked_chunks if resuming else None),
    )
    # The WHOLE session publishes, not just the pump: a live feed can
    # spend minutes waiting for its first chunk, and a dashboard
    # must show the watermark/queue gauges during that wait too.
    from blit_torch.monitor import publishing

    with publishing(red.timeline, config=config), \
            observability.span("stream.reduce", out=out_path,
                               nfft=red.nfft, path=live.path,
                               resumed=bool(resuming)):
        hdr = red.header_for(live)
        nif = STOKES_NIF[red.stokes]
        from blit_torch.ops.narrow import NARROW_DTYPES

        if resuming:
            # The crash guards of the batch resume path, applied before
            # the truncate: a target the crash corrupted past reading —
            # or one shorter than its claim — restarts fresh.
            from blit_torch.pipeline import resume_fil_ok

            rows = cur.frames_done // red.nint
            if is_h5:
                from blit_torch.io.fbh5 import resume_target_ok

                ok = resume_target_ok(out_path, nif, hdr["nchans"], rows)
            else:
                ok = resume_fil_ok(out_path, nif, hdr["nchans"], rows,
                                   dtype=NARROW_DTYPES[red.nbits])
            if not ok:
                log.warning(
                    "stream resume target %s cannot honor the cursor's "
                    "claimed %d frames (crash-corrupted?); restarting "
                    "the session product fresh", out_path,
                    cur.frames_done,
                )
                resuming = False
                cur = StreamCursor.fresh(red, session, "filterbank",
                                         compression)
                live._premasked = set()
        start_rows = (cur.frames_done // red.nint) if resuming else 0
        if resume:
            if is_h5:
                from blit_torch.io.fbh5 import ResumableFBH5Writer

                if red.nbits != 32:
                    raise ValueError(
                        "nbits=8/16 quantized output is a SIGPROC .fil "
                        "feature; FBH5 products are float32")
                w = ResumableFBH5Writer(
                    out_path, hdr, nif, hdr["nchans"], start_rows,
                    red.nint, cur, compression=compression,
                    chunks=chunks)
            else:
                if compression is not None:
                    raise ValueError(".fil products are uncompressed; "
                                     "compression applies to .h5 output")
                if chunks is not None:
                    raise ValueError("chunks applies to .h5 output")
                from blit_torch.pipeline import ResumableFilWriter

                w = ResumableFilWriter(
                    out_path, hdr, nif, hdr["nchans"], start_rows,
                    red.nint, cur, dtype=NARROW_DTYPES[red.nbits])
        elif is_h5:
            from blit_torch.io.fbh5 import FBH5Writer

            if red.nbits != 32:
                raise ValueError("nbits=8/16 quantized output is a SIGPROC "
                                 ".fil feature; FBH5 products are float32")
            w = FBH5Writer(out_path, hdr, nifs=nif,
                           nchans=hdr["nchans"],
                           compression=compression, chunks=chunks)
        else:
            if compression is not None:
                raise ValueError(".fil products are uncompressed; "
                                 "compression applies to .h5 output")
            if chunks is not None:
                raise ValueError("chunks applies to .h5 output")
            from blit_torch.io.sigproc import FilWriter

            # _pump delivers nbits<32 slabs already quantized narrow
            # (reduce_to_file's writer rule) — the live product must
            # carry the same dtype or stream==batch byte-identity breaks.
            w = FilWriter(out_path, hdr, nif, hdr["nchans"],
                          dtype=NARROW_DTYPES[red.nbits])
        tap = _LatencyTap(w, live, red.timeline, nfft=red.nfft,
                          ntap=red.ntap, nint=red.nint,
                          cursor=(cur if resume else None),
                          heartbeat=heartbeat, start_rows=start_rows)
        hdr["nsamps"] = red._pump(live, tap,
                                  skip_frames=start_rows * red.nint)
    # Which ingest knobs the live reduction ran (tuning profile /
    # defaults, blit_torch/tune.py): a slow live session's report names
    # the knob source before anyone reaches for the tune command.
    hdr["stream_tuning"] = red.tuning_provenance()
    hdr.update(live.stream_report())
    hdr["stream_degraded_spectra"] = live.degraded_rows(
        red.nfft, red.ntap, red.nint, max_rows=hdr["nsamps"])
    return hdr


def stream_search(source: ChunkSource, out_path: str, *,
                  searcher=None, lateness_s: Optional[float] = None,
                  stall_timeout_s: Optional[float] = None,
                  resume: bool = False, heartbeat=None,
                  config: SiteConfig = DEFAULT, **search_kw) -> Dict:
    """Drift-search a LIVE recording into a ``.hits`` product while it
    records: the streaming twin of
    :meth:`blit_torch.search.dedoppler.DedopplerReducer.search_to_file`,
    byte-identical to it for a completed stream (same window pinning —
    window ``w`` covers spectra ``[w·T, (w+1)·T)`` wherever the chunk
    boundaries fall).  ``searcher`` supplies a configured
    :class:`~blit_torch.search.dedoppler.DedopplerReducer`; otherwise
    ``search_kw`` build one.

    ``resume=True`` / ``heartbeat`` are the :func:`stream_reduce` rejoin
    contract on the ragged product: the
    :class:`~blit_torch.stream.cursor.StreamCursor` claims whole search
    windows (fsync-before-claim through
    :class:`blit_torch.io.hits.ResumableHitsWriter`), and a restarted consumer
    rejoins at the claimed window boundary via the skip-windows replay."""
    from blit_torch.io.hits import HitsWriter, ResumableHitsWriter
    from blit_torch.search import DedopplerReducer

    if searcher is None:
        search_kw.setdefault("timeline",
                             observability.process_timeline())
        searcher = DedopplerReducer(**search_kw)
    red = searcher
    cur = None
    resuming = False
    session = getattr(source, "path", "<stream>")
    if resume:
        from blit_torch.stream.cursor import StreamCursor

        cur = StreamCursor.load(out_path)
        resuming = (
            cur is not None
            and cur.matches(red, session, "hits")
            and os.path.exists(out_path)
            and os.path.getsize(out_path) >= cur.byte_offset
        )
        if resuming:
            # Content verification of the claim: the
            # byte-length probe cannot see a flip INSIDE the claimed
            # lines or a tampered sidecar — fail closed to fresh.
            from blit_torch import integrity

            resuming = integrity.verify_claim(
                out_path, cur.windows_done, fmt="hits") is not False
        if not resuming:
            cur = StreamCursor.fresh(red, session, "hits")
    live = LiveRawStream(
        source, lateness_s=lateness_s, stall_timeout_s=stall_timeout_s,
        timeline=red.timeline, config=config,
        premasked=(cur.masked_chunks if resuming else None),
    )
    from blit_torch.monitor import publishing

    with publishing(red.timeline, config=config), \
            observability.span("stream.search", out=out_path,
                               nfft=red.nfft, path=live.path,
                               resumed=bool(resuming)):
        hdr = red.header_for(live)
        skip = cur.windows_done if resuming else 0
        if resume:
            w = ResumableHitsWriter(out_path, hdr, skip, cur)
        else:
            w = HitsWriter(out_path, hdr)
        tap = _LatencyTap(w, live, red.timeline, nfft=red.nfft,
                          ntap=red.ntap, nint=red.nint,
                          window_spectra=red.window_spectra,
                          cursor=(cur if resume else None),
                          heartbeat=heartbeat)
        hdr["search_nhits"] = red._pump(live, hdr, tap,
                                        skip_windows=skip)
    hdr["search_windows"] = tap.nwindows
    hdr["stream_tuning"] = red.tuning_provenance()
    hdr.update(live.stream_report())
    # A "row" of T·nint frames IS one search window: the degraded count
    # lands in window units directly.
    hdr["stream_degraded_windows"] = live.degraded_rows(
        red.nfft, red.ntap, red.nint * red.window_spectra,
        max_rows=hdr["search_windows"])
    return hdr
