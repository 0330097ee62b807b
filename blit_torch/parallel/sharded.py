"""The sharded reduction plane: one scan as one mesh program, threaded
end to end through the ingest and output planes.

Counterpart of ``blit/parallel/sharded.py``.  The mesh loop
(:func:`blit_torch.parallel.scan.reduce_scan_mesh_to_files`) reads,
computes, reads back and writes each window in turn; here every host leg
has a thread of its own, the reducer's architecture over the ``(band,
bank)`` mesh:

- **feed** (:class:`_ShardFeed`): a
  :class:`~blit_torch.pipeline.BufferRotation` whose slots are one pinned
  staging slab per local player (:mod:`blit_torch.hostmem`), filled by a
  producer thread while the players compute earlier windows; each block
  is copied ``non_blocking`` to its player's device
  (:func:`~blit_torch.parallel.mesh.put_local_shards`);
- **compute**: each player's channelizer and the bank stitch run as two
  steps (``band_reduce(stitch=False)``, then
  :func:`~blit_torch.parallel.mesh.stitch_despike`), so the first
  ``probe_windows`` windows time the stitch alone (``mesh.gather_s``) and
  every window accounts its gather bytes;
- **readback**: each band row this process writes goes through an
  :class:`~blit_torch.outplane.OutputRotation` readback thread; a
  window's feed slot is released only once every local player's compute
  of it has completed (an ordering-only put);
- **write**: each band streams write-behind through an
  :class:`~blit_torch.outplane.AsyncSink` into the mesh loop's writers,
  with the same pod-agreed resume.

Products are byte-identical to the pool path's
(:func:`~blit_torch.parallel.scan.reduce_scan_pool_to_files`): ``.fil``,
``.h5`` and, through :func:`search_scan_sharded_to_files`, each player's
``.hits`` (every player searches its own slice with the search's own
``dedoppler_hits``, the ``taylor_tree`` kernel on the card).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blit_torch import faults, observability
from blit_torch.monitor import published
from blit_torch.observability import Timeline, profile_trace
from blit_torch.ops.channelize import pfb_coeffs, usable_frames
from blit_torch.outplane import record_event
from blit_torch.parallel import mesh as M
from blit_torch.parallel.scan import (
    _despike_nfpc,
    _gapless,
    _gather_int64,
    _open_band_writers,
    _open_players,
    _resolve_grid,
    _resolve_out_paths,
    _scan_headers,
    _window_frames,
)

log = logging.getLogger("blit_torch.sharded")


class _Events:
    """One event per device a mesh array's shards live on: the window's
    device work, waited on by the readback thread (``synchronize``)."""

    __slots__ = ("events",)

    def __init__(self, arr: M.MeshArray):
        seen = {}
        for t in arr.shards.values():
            if t.device not in seen:
                seen[t.device] = record_event(t)
        self.events = [e for e in seen.values() if e is not None]

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class _ShardWindow:
    """One window of the sharded feed: the voltage array and its frame
    coordinates.  :meth:`release` hands the slot back to the producer;
    call it only once the compute that read ``volt`` has completed."""

    __slots__ = ("volt", "index", "f0", "frames", "ntime", "_rot", "_slot")

    def __init__(self, volt, index, f0, frames, ntime, rot, slot):
        self.volt = volt
        self.index = index
        self.f0 = f0
        self.frames = frames
        self.ntime = ntime
        self._rot = rot
        self._slot = slot

    def release(self) -> None:
        if self._rot is not None:
            rot, self._rot = self._rot, None
            rot.release(self._slot)


class _ShardFeed:
    """The pipelined window feed: a producer thread reads each local
    player's gap-free span of window ``w+1`` into its pinned slab while
    the players compute window ``w``.  Stages: ``ingest`` (RAW bytes
    read, producer thread), ``transfer`` (the copies to the players)."""

    def __init__(self, raws, local, mesh, nchan, npol, *, nfft, ntap, wf,
                 total, f0_start, timeline, prefetch_depth=2, extra_slots=0,
                 stall_timeout_s=None):
        self.raws, self.local, self.mesh = raws, local, mesh
        self.nchan, self.npol = nchan, npol
        self.nfft, self.ntap = nfft, ntap
        self.tl = timeline
        self.spans: List[Tuple[int, int]] = []
        f0 = f0_start
        while f0 < total:
            n = min(wf, total - f0)
            self.spans.append((f0, n))
            f0 += n
        self.max_ntime = (wf + ntap - 1) * nfft
        self.nslots = max(2, prefetch_depth) + max(0, extra_slots)
        self.stall_timeout_s = stall_timeout_s
        self.pinned = any(mesh.devices[p].type == "cuda" for p in local)
        self._store: List[Optional[Dict]] = [None] * self.nslots

    @property
    def nwindows(self) -> int:
        return len(self.spans)

    def _alloc(self, slot: int) -> Dict:
        if self._store[slot] is None:
            from blit_torch import hostmem

            shape = (self.nchan, self.max_ntime, self.npol, 2)
            pool = hostmem.slab_pool()
            self._store[slot] = {
                bk: pool.take(shape, np.int8, pinned=self.pinned,
                              timeline=self.tl)
                for bk in self.local}
        return self._store[slot]

    def _fill(self, rot) -> None:
        nfft, ntap = self.nfft, self.ntap
        for w, (f0, n) in enumerate(self.spans):
            slot = rot.acquire()
            if slot is None:
                return  # the consumer abandoned the stream
            store = self._alloc(slot)
            ntime = (n + ntap - 1) * nfft
            for bk in self.local:
                r = self.raws[bk]
                with self.tl.stage("ingest",
                                   nbytes=self.nchan * ntime * self.npol * 2):
                    v = _gapless(r, ntime, skip=f0 * nfft,
                                 out=store[bk].array[:, :ntime])
                if (v.shape[0] != self.nchan or v.shape[1] < ntime
                        or v.shape[2:] != (self.npol, 2)):
                    raise ValueError(
                        f"{r.path}: shape {v.shape} incompatible with "
                        f"(nchan={self.nchan}, ntime>={ntime}, "
                        f"npol={self.npol}, 2)")
            rot.emit(slot, (w, f0, n, ntime))

    def windows(self):
        """Yield :class:`_ShardWindow` in stream order; the consumer must
        release each once its compute has completed."""
        from blit_torch.pipeline import BufferRotation

        nband, nbank = self.mesh.devices.shape
        rot = BufferRotation(self.nslots, self._fill, name="blit-mesh-feed",
                             stall_timeout_s=self.stall_timeout_s)
        try:
            for slot, (w, f0, n, ntime) in rot.slots():
                store = self._store[slot]
                gshape = (nband, nbank, self.nchan, ntime, self.npol, 2)
                nbytes = 0
                with self.tl.stage("transfer"):
                    blocks = {}
                    for bk in self.local:
                        blk = store[bk].tensor[:, :ntime][None, None]
                        if not blk.is_contiguous():
                            # Only the short last window pays a copy.
                            blk = blk.contiguous()
                        blocks[bk] = blk
                        nbytes += blk.numel()
                    volt = M.put_local_shards(blocks, self.mesh, gshape)
                self.tl.stages["transfer"].bytes += nbytes
                yield _ShardWindow(volt, w, f0, n, ntime, rot, slot)
        finally:
            rot.close()

    def retire(self) -> None:
        """Return the staging slabs to the pool: only after a terminal
        synchronization (stream drained, sinks closed)."""
        from blit_torch import hostmem

        pool = hostmem.slab_pool()
        for store in self._store:
            if store:
                for slab in store.values():
                    pool.give(slab)
        self._store = [None] * self.nslots


def _mesh_probe_windows() -> int:
    from blit_torch.config import mesh_defaults

    return mesh_defaults()["probe_windows"]


@published
def reduce_scan_sharded_to_files(
        raw_paths, scan: Optional[str] = None, *, inventories=None,
        out_dir: Optional[str] = None, out_paths: Optional[Sequence[str]] = None,
        nfft: int, ntap: int = 4, nint: int = 1, stokes: str = "I",
        fqav_by: int = 1, fft_method: str = "auto", window: str = "hamming",
        despike: bool = True, max_frames: Optional[int] = None,
        window_frames: Optional[int] = None, compression: Optional[str] = None,
        resume: bool = False, mesh=None, dtype: str = "float32",
        prefetch_depth: Optional[int] = None, out_depth: Optional[int] = None,
        probe_windows: Optional[int] = None, timeline=None,
        trace_logdir: Optional[str] = None, heartbeat=None, device=None
) -> Dict[int, Tuple[str, Dict]]:
    """Reduce one scan across the mesh with the threaded sharded plane
    (module docstring) and stream each stitched band to its product.
    Call shapes, resume (the restart agreed across the pod) and products
    are those of :func:`~blit_torch.parallel.scan.reduce_scan_mesh_to_files`,
    byte-identical to it and to the pool oracle at the same
    ``window_frames``.

    ``prefetch_depth`` / ``out_depth`` size the feed rotation and the
    readback and write-behind planes (None: 2); ``probe_windows``
    (default ``BLIT_MESH_PROBE`` / ``SiteConfig.mesh_probe_windows``)
    leading windows synchronize the players' compute and time the stitch
    alone; later windows stay overlapped and only account bytes.
    ``heartbeat(window_index)`` runs between windows on the consumer
    thread (the recovery supervisor's lease refresh); the ``mesh.window``
    fault point fires at the same place."""
    from blit_torch.outplane import AsyncSink, OutputRotation, readback_extra_slots

    band_ids, raw_paths = _resolve_grid(raw_paths, scan, inventories)
    mesh, local, raws, nchan, npol, min_samps = _open_players(raw_paths, mesh,
                                                              device)
    nband, nbank = mesh.devices.shape
    total = usable_frames(min_samps, nfft, ntap, nint)
    if max_frames is not None:
        total = min(total, (max_frames // nint) * nint)
    if total <= 0:
        raise ValueError(f"scan too short: {min_samps} samples for nfft={nfft}")
    wf = _window_frames(window_frames, nfft, nint)
    prefetch = max(2, prefetch_depth or 2)
    depth = max(2, out_depth or prefetch)
    if probe_windows is None:
        probe_windows = _mesh_probe_windows()
    out_paths = _resolve_out_paths(band_ids, nband, out_dir, out_paths,
                                   compression)
    h0, bases, per_bank = _scan_headers(raws, local, nfft=nfft, nint=nint,
                                        stokes=stokes, fqav_by=fqav_by)
    coeffs = torch.from_numpy(pfb_coeffs(ntap, nfft, window))
    despike_nfpc = _despike_nfpc(despike, nfft, fqav_by)
    mine, headers, writers, f0_start = _open_band_writers(
        mesh, raws, out_paths, h0=h0, bases=bases, per_bank=per_bank,
        stokes=stokes, nfft=nfft, ntap=ntap, nint=nint, window=window,
        fqav_by=fqav_by, dtype=dtype, despike_nfpc=despike_nfpc,
        compression=compression, resume=resume, wf=wf, total=total)

    tl = timeline if timeline is not None else Timeline()
    feed = _ShardFeed(raws, local, mesh, nchan, npol, nfft=nfft, ntap=ntap,
                      wf=wf, total=total, f0_start=f0_start, timeline=tl,
                      prefetch_depth=prefetch,
                      extra_slots=readback_extra_slots(depth, prefetch))

    def route(slab) -> None:
        sinks[slab.payload].append(slab.data, release=slab.release)

    rot = None
    sinks = {}
    nsamps = {}
    try:
        rot = OutputRotation(depth=depth, timeline=tl, reuse=True,
                             name="blit-mesh-readback")
        for b in mine:
            sinks[b] = AsyncSink(writers[b], depth=depth, timeline=tl)
        with profile_trace(trace_logdir), observability.span(
                "mesh.scan", nfft=nfft, nband=nband, nbank=nbank,
                sharded=True), tl.stage("stream"):
            for win in feed.windows():
                faults.fire("mesh.window", key=f"w{win.index}")
                if heartbeat is not None:
                    heartbeat(win.index)
                with observability.span("mesh.window", i=win.index), \
                        tl.stage("dispatch", byte_free=True):
                    part = M.band_reduce(
                        win.volt, coeffs, mesh=mesh, nfft=nfft, ntap=ntap,
                        nint=nint, stokes=stokes, fft_method=fft_method,
                        stitch=False, despike_nfpc=0, fqav_by=fqav_by,
                        dtype=dtype)
                staged0 = tl.stages["mesh.host_stage"].bytes
                gather_s = None
                if win.index < probe_windows and nbank > 1:
                    with tl.stage("mesh.probe", byte_free=True):
                        if win.index == 0:
                            # Untimed warm-up: the first stitch pays its
                            # allocations, not the collective.
                            M.timed_stitch(part, mesh=mesh,
                                           despike_nfpc=despike_nfpc,
                                           timeline=None)
                        out, gather_s = M.timed_stitch(
                            part, mesh=mesh, despike_nfpc=despike_nfpc,
                            timeline=tl)
                else:
                    with tl.stage("dispatch", byte_free=True):
                        out = M.stitch_despike(part, mesh=mesh,
                                               despike_nfpc=despike_nfpc,
                                               timeline=tl)
                if nbank > 1:
                    shard_bytes = part.nbytes // (nband * nbank)
                    staged = tl.stages["mesh.host_stage"].bytes - staged0
                    M.record_ici(tl, "gather",
                                 M.gather_ici_bytes(shard_bytes, nbank) + staged,
                                 gather_s)
                # The slot goes back once every local player's compute of
                # this window has completed: an ordering-only put.
                fed = len(local) * nchan * win.ntime * npol * 2
                for slab in rot.put(None, event=_Events(out), nbytes=fed,
                                    on_consumed=win.release):
                    route(slab)
                for b in mine:
                    shard = out.shards[(b, 0)][0]
                    for slab in rot.put(shard, event=record_event(shard),
                                        payload=b):
                        route(slab)
                del part, out
            for slab in rot.drain():
                route(slab)
            for b in list(sinks):
                sinks[b].close()
                nsamps[b] = sinks.pop(b).nsamps
    except BaseException:
        for s in sinks.values():
            s.abort()
        for b in mine:
            if b not in sinks and b not in nsamps:
                writers[b].abort()
        raise
    finally:
        if rot is not None:
            rot.close()
    tl.overlap_efficiency()
    feed.retire()
    for b in mine:
        headers[b]["nsamps"] = nsamps[b]
    return {band_ids[b]: (out_paths[b], headers[b]) for b in mine}


@published
def search_scan_sharded_to_files(
        raw_paths, scan: Optional[str] = None, *, inventories=None,
        out_dir: Optional[str] = None, out_paths=None, nfft: int,
        ntap: int = 4, nint: int = 1, window: str = "hamming",
        fft_method: str = "auto", dtype: str = "float32",
        window_spectra: Optional[int] = None, top_k: Optional[int] = None,
        snr_threshold: Optional[float] = None,
        max_drift_bins: Optional[int] = None, kernel: str = "auto",
        interpret: bool = False, max_frames: Optional[int] = None,
        window_frames: Optional[int] = None, resume: bool = False, mesh=None,
        prefetch_depth: Optional[int] = None, out_depth: Optional[int] = None,
        timeline=None, trace_logdir: Optional[str] = None, heartbeat=None,
        device=None) -> Dict[Tuple[int, int], Tuple[str, Dict]]:
    """Drift-search one scan across the mesh: every player channelizes
    and searches its own ``(band, bank)`` slice in one window loop and
    each player's ``.hits`` is byte-identical to a
    :class:`~blit_torch.search.DedopplerReducer` search of that bank with
    ``chunk_frames == window_frames``.  The spectra never stitch: each
    player's packed ``(nbands, top_k, 4)`` table is read back and its
    owning process writes the player's ``.hits``.

    ``window_frames`` is rounded to whole search windows
    (``window_spectra * nint`` frames) and the span truncated to whole
    windows, the reducer's trailing-partial drop.  ``resume=True``: a
    :class:`~blit_torch.search.dedoppler.SearchCursor` a player, the
    restart window the minimum across the pod (aligned to scan windows),
    each file truncated to that window's recorded claim.  ``kernel`` and
    ``interpret`` are ``blit``'s knobs: the port's search has one route
    (``"auto"``: the ``taylor_tree`` kernel on the card, its plain
    version on the CPU).  Returns ``{(band_id, bank): (path, header)}``
    for the players this process wrote."""
    from blit_torch.io.hits import HitsWriter, ResumableHitsWriter, WindowHits
    from blit_torch.ops.dedoppler import dedoppler_hits
    from blit_torch.outplane import OutputRotation, readback_extra_slots
    from blit_torch.pipeline import ReductionCursor
    from blit_torch.search.dedoppler import DedopplerReducer, SearchCursor
    from blit_torch.search.hits import hits_from_packed

    if kernel != "auto" or interpret:
        raise ValueError("the port's search has one route (kernel='auto', "
                         f"interpret=False); got kernel={kernel!r}, "
                         f"interpret={interpret!r}")
    band_ids, raw_paths = _resolve_grid(raw_paths, scan, inventories)
    mesh, local, raws, nchan, npol, min_samps = _open_players(raw_paths, mesh,
                                                              device)
    nband, nbank = mesh.devices.shape
    # Knobs and headers come from the pool path's own reducer (identical
    # header lines and hit mapping); it never streams.
    sred = DedopplerReducer(
        nfft=nfft, ntap=ntap, nint=nint, window=window, dtype=dtype,
        window_spectra=window_spectra, top_k=top_k,
        snr_threshold=snr_threshold, max_drift_bins=max_drift_bins,
        prefetch_depth=prefetch_depth, out_depth=out_depth,
        device=str(mesh.devices[local[0]]))
    T = sred.window_spectra
    unit = T * nint
    total = usable_frames(min_samps, nfft, ntap, nint)
    if max_frames is not None:
        total = min(total, (max_frames // nint) * nint)
    nwin_total = total // unit
    if nwin_total <= 0:
        raise ValueError(f"scan too short for one search window: {total} "
                         f"frames, need {unit} (window_spectra={T} x "
                         f"nint={nint})")
    total = nwin_total * unit
    if window_frames is None:
        from blit_torch.config import default_window_frames

        window_frames = default_window_frames(nfft)
    wf = max((window_frames // unit) * unit, unit)
    prefetch = max(2, prefetch_depth or sred.prefetch_depth)
    depth = max(2, out_depth or sred.out_depth)
    if out_paths is None:
        if out_dir is None:
            raise ValueError("pass out_dir= or out_paths=")
        out_paths = [[os.path.join(out_dir, f"band{band_ids[b]}bank{k}.hits")
                      for k in range(nbank)] for b in range(nband)]
    if len(out_paths) != nband or any(len(row) != nbank for row in out_paths):
        raise ValueError("out_paths must be a rectangular nband x nbank grid "
                         "(one .hits per player)")
    hdrs = {bk: sred.header_for(raws[bk]) for bk in local}
    nbands = sred._nbands(nchan * nfft)
    thr = float(np.float32(sred.snr_threshold))
    coeffs = torch.from_numpy(pfb_coeffs(ntap, nfft, window))

    start_window = 0
    cursors: Dict[Tuple[int, int], SearchCursor] = {}
    if resume:
        swin = wf // unit
        local_done = []
        for bk in local:
            b, k = bk
            path = out_paths[b][k]
            paths_bk = getattr(raws[bk], "paths", None) or raws[bk].path
            cur = SearchCursor.load(path)
            ok = (cur is not None and cur.matches(sred, paths_bk)
                  and cur.window_claims is not None
                  and os.path.exists(path)
                  and os.path.getsize(path) >= cur.byte_offset)
            if ok:
                from blit_torch import integrity

                ok = integrity.verify_claim(path, cur.windows_done,
                                            fmt="hits") is not False
            if not ok:
                size, mtime_ns = ReductionCursor.stat_raw(paths_bk)
                cur = SearchCursor(
                    paths_bk, nfft, ntap, nint, window=window, dtype=dtype,
                    window_spectra=T, top_k=sred.top_k,
                    snr_threshold=float(sred.snr_threshold),
                    max_drift_bins=(-1 if sred.max_drift_bins is None
                                    else int(sred.max_drift_bins)),
                    raw_size=size, raw_mtime_ns=mtime_ns, window_claims=[])
            cursors[bk] = cur
            local_done.append(cur.windows_done if ok else 0)
        local_min = min(local_done) if local_done else 1 << 61
        agreed = int(_gather_int64(np.asarray([local_min], np.int64)).min())
        start_window = min((agreed // swin) * swin, nwin_total)

    tl = timeline if timeline is not None else Timeline()
    feed = _ShardFeed(raws, local, mesh, nchan, npol, nfft=nfft, ntap=ntap,
                      wf=wf, total=total, f0_start=start_window * unit,
                      timeline=tl, prefetch_depth=prefetch,
                      extra_slots=readback_extra_slots(depth, prefetch))
    rot = OutputRotation(depth=depth, timeline=tl, reuse=False,
                         name="blit-mesh-search-readback")
    writers = {}
    nwindows = {bk: start_window for bk in local}

    def route(slab) -> None:
        widx, bk = slab.payload
        hits = hits_from_packed(slab.data, widx, hdrs[bk])
        tl.observe("search.hits_per_window", len(hits))
        writers[bk].append(WindowHits(widx, hits))
        nwindows[bk] += 1
        slab.release()

    try:
        for bk in local:
            b, k = bk
            if resume:
                writers[bk] = ResumableHitsWriter(out_paths[b][k], hdrs[bk],
                                                  start_window, cursors[bk])
            else:
                writers[bk] = HitsWriter(out_paths[b][k], hdrs[bk])
        with profile_trace(trace_logdir), observability.span(
                "mesh.search", nfft=nfft, nband=nband, nbank=nbank), \
                tl.stage("stream"):
            for win in feed.windows():
                faults.fire("mesh.window", key=f"w{win.index}")
                if heartbeat is not None:
                    heartbeat(win.index)
                with observability.span("mesh.window", i=win.index), \
                        tl.stage("dispatch", byte_free=True):
                    part = M.band_reduce(
                        win.volt, coeffs, mesh=mesh, nfft=nfft, ntap=ntap,
                        nint=nint, stokes="I", fft_method=fft_method,
                        stitch=False, despike_nfpc=0, dtype=dtype)
                # The searches read the players' spectra, never the slot:
                # release it once every channelizer has completed.
                for slab in rot.put(None, event=_Events(part),
                                    on_consumed=win.release):
                    route(slab)
                rows = win.frames // nint
                for j in range(rows // T):
                    widx = win.f0 // unit + j
                    packed = {}
                    with tl.stage("dispatch", byte_free=True):
                        for bk in local:
                            power = part.shards[bk][0, j * T:(j + 1) * T, 0, :]
                            packed[bk] = dedoppler_hits(
                                power.contiguous(), thr, top_k=sred.top_k,
                                nbands=nbands,
                                max_drift_bins=sred.max_drift_bins)
                    for bk in local:
                        for slab in rot.put(packed[bk],
                                            event=record_event(packed[bk]),
                                            payload=(widx, bk)):
                            route(slab)
                del part
            for slab in rot.drain():
                route(slab)
        for bk in list(writers):
            w = writers.pop(bk)
            w.close()
    except BaseException:
        for w in writers.values():
            w.abort()
        raise
    finally:
        rot.close()
    feed.retire()
    out = {}
    for bk in local:
        b, k = bk
        hdr = dict(hdrs[bk])
        hdr["search_windows"] = nwindows[bk]
        out[(band_ids[b], k)] = (out_paths[b][k], hdr)
    return out
