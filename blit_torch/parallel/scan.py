"""Mesh-backed scan loading: RAW files → per-player reduction → stitched
band.

Counterpart of ``blit/parallel/scan.py``.  Every bank's GUPPI RAW
voltages feed the player of its ``BLP<band><bank>``; each player runs
the port's channelizer on its own block
(:func:`blit_torch.parallel.mesh.band_reduce`) and the banks of each band
stitch into one band.  The host holds at most one bank's int8 voltages at
a time.  A process opens and feeds only the players it owns; the common
sample span, the geometry and every player's failure are agreed across
the pod (:func:`_gather_int64`), so every process raises together instead
of one waiting forever in a collective.

- :func:`load_scan_mesh`: one scan to stitched bands in memory.
- :func:`reduce_scan_mesh_to_files`: the windowed loop that streams each
  band to its product (``.fil`` or ``.h5``), crash-resumable with a
  restart offset agreed across the pod.
- :func:`reduce_scan_pool_to_files`: the pool path, one
  :class:`~blit_torch.pipeline.RawReducer` per player and a host-side
  concatenation: the byte-identity oracle of the mesh paths.

Entry points take a ``mesh``; without one they seat every player of the
grid on ``device`` (the CUDA device by default; in a pod each process
seats its share).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from blit_torch.device import resolve_device
from blit_torch.io.guppi import open_raw
from blit_torch.monitor import published
from blit_torch.ops.channelize import (
    STOKES_NIF,
    output_header,
    pfb_coeffs,
    usable_frames,
)
from blit_torch.parallel import mesh as M
from blit_torch.parallel import multihost
from blit_torch.parallel.antenna import _gapless, _kept_samples  # noqa: F401 (sharded's import)

log = logging.getLogger("blit_torch.scan")


# Per-player markers riding the pod-wide sample-count agreement: ERR <
# UNFED, so an owner's failure wins the MIN over "nobody fed it", and
# both exceed any real sample count.
_SAMPS_ERR = 1 << 60
_SAMPS_UNFED = 1 << 61


def _gather_int64(local: np.ndarray) -> np.ndarray:
    """Every process's int64 array → ``(nproc, ...)``: the pod-wide
    agreement behind the common span, the failures and the resume point.
    Every process sees every value, so a check on the result raises (or
    passes) on every process alike.  The values travel as int64 over the
    process group, exact; they must lie in ``[0, 2^62)``.  Outside a pod:
    ``local[None]`` (a one-process pod runs the collective)."""
    local = np.asarray(local, np.int64)
    if (local < 0).any() or (local >= (1 << 62)).any():
        raise ValueError("_gather_int64: values must be in [0, 2^62)")
    if not multihost.in_pod():
        return local[None]
    blocks, _ = multihost.all_gather_tensor(torch.from_numpy(local.copy()))
    return np.stack([b.cpu().numpy() for b in blocks])


def _resolve_grid(raw_paths, scan, inventories):
    """An explicit ``raw_paths[band][bank]`` grid, or the inventory form
    ``(session, scan, inventories=...)``, → ``(band_ids, raw_paths)``."""
    if isinstance(raw_paths, str):
        if scan is None or inventories is None:
            raise ValueError("session-form call needs load_scan_mesh(session, "
                             "scan, inventories=...)")
        from blit_torch.inventory import scan_grid

        band_ids, _, grid = scan_grid(inventories, raw_paths, scan)
        return band_ids, grid
    if scan is not None or inventories is not None:
        raise ValueError("scan=/inventories= only apply to the session-form "
                         "call; an explicit raw_paths grid already names "
                         "every file")
    return list(range(len(raw_paths))), raw_paths


def default_mesh(nband: int, nbank: int, device=None) -> M.Mesh:
    """A grid's mesh with every player on ``device`` (the CUDA device by
    default); in a pod each process seats an equal share."""
    dev = resolve_device(device)
    share = nband * nbank // max(1, multihost.process_count())
    return M.make_mesh(nband, nbank, devices=[dev] * share)


def _open_players(raw_paths, mesh, device=None):
    """Validate the grid, build the mesh, open this process's players and
    agree the span, geometry and failures pod-wide.

    Returns ``(mesh, local, raws, nchan, npol, min_samps)``."""
    nband = len(raw_paths)
    nbank = len(raw_paths[0])
    if any(len(row) != nbank for row in raw_paths):
        raise ValueError("raw_paths must be rectangular (nband x nbank)")
    if mesh is None:
        mesh = default_mesh(nband, nbank, device)
    if mesh.devices.shape != (nband, nbank):
        raise ValueError(f"mesh {mesh.devices.shape} does not match the "
                         f"{nband}x{nbank} grid")
    local = sorted(mesh.local_players())
    if not local:
        raise ValueError("this process owns no player of the scan mesh "
                         f"(process {multihost.process_index()}/"
                         f"{multihost.process_count()})")
    raws = {}
    local_errs = {}
    for b, k in local:
        try:
            r = open_raw(raw_paths[b][k])
            if r.nblocks == 0:
                raise ValueError(f"empty RAW file: {r.path}")
            raws[(b, k)] = r
        except Exception as e:  # noqa: BLE001 — reported pod-wide below
            local_errs[(b, k)] = e
    if raws:
        first = raws[sorted(raws)[0]].header(0)
        nchan = first["OBSNCHAN"]
        npol = 2 if first["NPOL"] > 2 else first["NPOL"]
    else:
        nchan = npol = 0
    samps = np.full((nband, nbank), _SAMPS_UNFED, np.int64)
    for (b, k), r in raws.items():
        samps[b, k] = _kept_samples(r)
    for bk in local_errs:
        samps[bk] = _SAMPS_ERR
    gathered = _gather_int64(np.concatenate([samps.ravel(), [nchan, npol]]))
    samps = gathered[:, :-2].min(axis=0).reshape(nband, nbank)
    failed = [tuple(int(x) for x in i) for i in np.argwhere(samps == _SAMPS_ERR)]
    if failed:
        mine = "; ".join(f"{bk}: {type(e).__name__}: {e}"
                         for bk, e in sorted(local_errs.items()))
        cause = next(iter(local_errs.values()), None)
        raise ValueError(f"players {failed} failed to open on their owning "
                         "process" + (f" (this process: {mine})" if mine else "")
                         ) from cause
    unfed = [tuple(int(x) for x in i) for i in np.argwhere(samps == _SAMPS_UNFED)]
    if unfed:
        raise ValueError(f"no process fed players {unfed}")
    geo = gathered[:, -2:]
    geo = geo[(geo != 0).any(axis=1)]
    if not (geo == geo[0]).all():
        raise ValueError(f"processes disagree on (nchan, npol): "
                         f"{[tuple(g) for g in geo]}")
    return mesh, local, raws, int(geo[0][0]), int(geo[0][1]), int(samps.min())


def _feed_window(raws, local, mesh, nchan, npol, start, ntime) -> M.MeshArray:
    """The voltage array for gap-free samples ``[start, start + ntime)``
    of every player: each local player's block read and copied straight
    to its device, one bank on the host at a time."""
    nband, nbank = mesh.devices.shape
    shards = {}
    for b, k in local:
        r = raws[(b, k)]
        v = _gapless(r, ntime, skip=start)
        if v.shape[0] != nchan or v.shape[1] < ntime or v.shape[2:] != (npol, 2):
            raise ValueError(f"{r.path}: shape {v.shape} incompatible with "
                             f"(nchan={nchan}, ntime>={ntime}, npol={npol}, 2)")
        shards[(b, k)] = torch.from_numpy(
            np.ascontiguousarray(v[None, None, :, :ntime])).to(mesh.devices[b, k])
    return M.MeshArray(mesh, "voltages", (nband, nbank, nchan, ntime, npol, 2),
                       shards)


def _scan_headers(raws, local, *, nfft, nint, stokes, fqav_by):
    """Per-band product headers from this process's players: each bank
    ``k`` implies its band's bank-0 ``fch1`` (``fch1_k - k*per_bank*foff``)
    and all must agree; ``fqav_by > 1`` maps the range through
    ``fqav_range``.  Returns ``(h0, bases, per_bank)``."""
    from blit_torch.ops.fqav import fqav_range

    hdrs = {}
    for (b, k), r in raws.items():
        h = output_header(r.header(0), nfft=nfft, nint=nint, stokes=stokes)
        if fqav_by > 1:
            fch1, foff, nchans = fqav_range(h["fch1"], h["foff"], h["nchans"],
                                            fqav_by)
            h.update(fch1=fch1, foff=foff, nchans=nchans, nfpc=nfft // fqav_by)
        hdrs[(b, k)] = h
    h0 = hdrs[local[0]]
    foff = h0["foff"]
    per_bank = h0["nchans"]
    bases: Dict[int, float] = {}
    for (b, k), h in sorted(hdrs.items()):
        if abs(h["foff"] - foff) > 1e-12:
            raise ValueError("banks disagree on fine channel width")
        base = h["fch1"] - k * per_bank * foff
        if b in bases and abs(base - bases[b]) > abs(foff) / 2:
            log.warning("band %d bank %d not contiguous: fch1=%.6f expected %.6f",
                        b, k, h["fch1"], bases[b] + k * per_bank * foff)
        bases.setdefault(b, base)
    return h0, bases, per_bank


def _bitshuffle_window_chunk_rows(base: int, wrows: int) -> int:
    """Chunk rows of a windowed bitshuffle product: ``gcd(default, window
    rows)``, with a warning when that collapses (compression and write
    rate suffer; the output stays correct)."""
    rows = math.gcd(base, wrows)
    if rows < min(base, wrows):
        log.warning(
            "bitshuffle chunk rows collapse to %d: window rows %d share no "
            "larger factor with the default %d-row chunk; pick "
            "window_frames/nint so the window rows divide (or are a multiple "
            "of) %d", rows, wrows, base, base)
    return rows


def _despike_nfpc(despike: bool, nfft: int, fqav_by: int) -> int:
    """DC-despike width in output channels (0 disables); below 2 channels
    there is no neighbour to copy and the repair is skipped with a
    warning."""
    if not despike:
        return 0
    nfpc = nfft // fqav_by
    if nfpc < 2:
        log.warning("skipping despike (nfpc=%d after fqav_by=%d)", nfpc, fqav_by)
        return 0
    return nfpc


def _slab_writer(path: str, header: Dict, nif: int, nchans: int,
                 compression: Optional[str]):
    """Per-band product writer by extension: ``.h5`` / ``.hdf5`` through
    :class:`~blit_torch.io.fbh5.FBH5Writer`, anything else ``.fil``."""
    if path.endswith((".h5", ".hdf5")):
        from blit_torch.io.fbh5 import FBH5Writer

        return FBH5Writer(path, header, nifs=nif, nchans=nchans,
                          compression=compression)
    if compression is not None:
        raise ValueError(".fil products are uncompressed; use .h5 paths "
                         "with compression=")
    from blit_torch.io.sigproc import FilWriter

    return FilWriter(path, header, nif, nchans)


def _resolve_out_paths(band_ids, nband, out_dir, out_paths, compression):
    """Per-band product paths (``band<id>.fil`` / ``.h5``), validated on
    every process before any collective."""
    if out_paths is None:
        if out_dir is None:
            raise ValueError("pass out_dir= or out_paths=")
        ext = "h5" if compression else "fil"
        out_paths = [os.path.join(out_dir, f"band{band_ids[b]}.{ext}")
                     for b in range(nband)]
    if len(out_paths) != nband:
        raise ValueError(f"need {nband} out_paths, got {len(out_paths)}")
    if compression is not None:
        bad = [p for p in out_paths if not p.endswith((".h5", ".hdf5"))]
        if bad:
            raise ValueError(".fil products are uncompressed; compression= "
                             f"needs .h5 paths, got {bad}")
    return list(out_paths)


def _band_owners(mesh) -> list:
    """The band rows this process writes: those whose bank-0 player it
    owns."""
    nband = mesh.devices.shape[0]
    return [b for b in range(nband) if mesh.is_local((b, 0))]


def _open_band_writers(mesh, raws, out_paths, *, h0, bases, per_bank, stokes,
                       nfft, ntap, nint, window, fqav_by, dtype, despike_nfpc,
                       compression, resume, wf, total):
    """The product side shared by the mesh loop and the sharded plane:
    which band rows this process writes, their headers, the restart
    offset agreed across the pod, and the opened writers.

    Returns ``(mine, headers, writers, f0_start)``.  A writer that fails
    to open aborts the ones already opened before the error re-raises."""
    nband, nbank = mesh.devices.shape
    nif = STOKES_NIF[stokes]
    nchans = nbank * per_bank
    mine = _band_owners(mesh)
    headers: Dict[int, Dict] = {}
    for b in mine:
        hdr = dict(h0)
        hdr["fch1"] = bases[b]
        hdr["nchans"] = nchans
        hdr["nifs"] = nif
        headers[b] = hdr

    f0_start = 0
    cursors = {}
    h5_chunk_rows = None
    if resume:
        from types import SimpleNamespace

        from blit_torch.pipeline import ReductionCursor

        comp_id = compression or "none"
        # A bitshuffle .h5 ties its chunk rows to the window, so the
        # window joins the resume identity (a changed window_frames
        # restarts fresh); .fil and plain/gzip .h5 truncate at any row.
        wrows_ident = -1
        if comp_id == "bitshuffle" and any(
                p.endswith((".h5", ".hdf5")) for p in out_paths):
            from blit_torch.io.fbh5 import default_chunks

            wrows = wf // nint
            base = default_chunks(nif, nchans, 4, whole_spectrum=True)[0]
            h5_chunk_rows = _bitshuffle_window_chunk_rows(base, wrows)
            wrows_ident = wrows
        ident = SimpleNamespace(
            nfft=nfft, ntap=ntap, nint=nint, stokes=stokes, window=window,
            fqav_by=fqav_by, dtype=dtype, despike_nfpc=despike_nfpc)
        members = sorted(p for r in raws.values()
                         for p in (getattr(r, "paths", None) or [r.path]))
        local_done = []
        for b in mine:
            cur = ReductionCursor.load(out_paths[b])
            ok = (cur is not None
                  and cur.matches(ident, members)
                  and cur.compression == comp_id
                  and cur.window_rows == wrows_ident
                  and os.path.exists(out_paths[b]))
            if ok and not out_paths[b].endswith((".h5", ".hdf5")):
                # A cursor claiming bytes the file no longer holds restarts
                # the band fresh, before the pod-wide agreement, so every
                # process folds the (now zero) offset alike.
                from blit_torch.pipeline import resume_fil_ok

                if not resume_fil_ok(out_paths[b], nif, nchans,
                                     cur.frames_done // nint):
                    log.warning(
                        "resume target %s is shorter than (or unreadable as) "
                        "the cursor's claimed %d frames; restarting the band "
                        "fresh", out_paths[b], cur.frames_done)
                    ok = False
            if ok and out_paths[b].endswith((".h5", ".hdf5")):
                from blit_torch.io.fbh5 import resume_target_ok

                if not resume_target_ok(out_paths[b], nif, nchans,
                                        cur.frames_done // nint):
                    log.warning(
                        "resume target %s is not readable as the claimed "
                        "HDF5 product; discarding %d claimed frames and "
                        "restarting the band fresh", out_paths[b],
                        cur.frames_done)
                    ok = False
            if not ok:
                size, mtime_ns = ReductionCursor.stat_raw(members)
                cur = ReductionCursor(
                    members, nfft, ntap, nint, stokes, 0, window=window,
                    raw_size=size, raw_mtime_ns=mtime_ns, fqav_by=fqav_by,
                    dtype=dtype, despike_nfpc=despike_nfpc,
                    compression=comp_id, window_rows=wrows_ident)
            cursors[b] = cur
            local_done.append(cur.frames_done if ok else 0)
        # The window loop advances in lockstep, so every process restarts
        # at the same offset; a process that writes no band rides a
        # sentinel above any real count.
        local_min = min(local_done) if local_done else 1 << 61
        agreed = int(_gather_int64(np.asarray([local_min], np.int64)).min())
        f0_start = min((agreed // wf) * wf, total)

    writers = {}
    try:
        for b in mine:
            if resume and out_paths[b].endswith((".h5", ".hdf5")):
                from blit_torch.io.fbh5 import ResumableFBH5Writer

                writers[b] = ResumableFBH5Writer(
                    out_paths[b], headers[b], nif, nchans, f0_start // nint,
                    nint, cursors[b], compression=compression,
                    chunks=((h5_chunk_rows, nif, nchans) if h5_chunk_rows
                            else None))
            elif resume:
                from blit_torch.pipeline import ResumableFilWriter

                writers[b] = ResumableFilWriter(
                    out_paths[b], headers[b], nif, nchans, f0_start // nint,
                    nint, cursors[b])
            else:
                writers[b] = _slab_writer(out_paths[b], headers[b], nif, nchans,
                                          compression)
    except BaseException:
        for w in writers.values():
            w.abort()
        raise
    return mine, headers, writers, f0_start


def load_scan_mesh(raw_paths, scan: Optional[str] = None, *, inventories=None,
                   nfft: int, ntap: int = 4, nint: int = 1, stokes: str = "I",
                   fqav_by: int = 1, fft_method: str = "auto",
                   window: str = "hamming", despike: bool = True,
                   max_frames: Optional[int] = None, mesh=None,
                   dtype: str = "float32", device=None
                   ) -> Tuple[Dict, M.MeshArray]:
    """Reduce one scan's RAW files across the mesh and stitch each band.

    Call shapes: an explicit rectangular grid ``raw_paths[band][bank]``
    (each a file, a ``.NNNN.raw`` stem or a path list), or ``(session,
    scan, inventories=...)`` resolved by
    :func:`blit_torch.inventory.scan_grid`.  Each process opens only its
    own players' files.  ``max_frames`` caps the frames reduced (for long
    scans use :func:`reduce_scan_mesh_to_files`).

    Returns ``(header, stitched)``: the full-band header from this
    process's lowest player, and a :class:`~blit_torch.parallel.mesh.MeshArray`
    ``(nband, ntime_out, nif, nbank*nchan*nfft//fqav_by)`` holding each
    local band row whole (``np.asarray`` of it is the global array when
    every row is local)."""
    _, raw_paths = _resolve_grid(raw_paths, scan, inventories)
    mesh, local, raws, nchan, npol, min_samps = _open_players(raw_paths, mesh,
                                                              device)
    nbank = mesh.devices.shape[1]
    frames = usable_frames(min_samps, nfft, ntap, nint)
    if max_frames is not None:
        frames = min(frames, (max_frames // nint) * nint)
    if frames <= 0:
        raise ValueError(f"scan too short: {min_samps} samples for nfft={nfft}")
    ntime = (frames + ntap - 1) * nfft
    volt = _feed_window(raws, local, mesh, nchan, npol, 0, ntime)
    out = M.band_reduce(
        volt, torch.from_numpy(pfb_coeffs(ntap, nfft, window)), mesh=mesh,
        nfft=nfft, ntap=ntap, nint=nint, stokes=stokes, fft_method=fft_method,
        stitch=True, despike_nfpc=_despike_nfpc(despike, nfft, fqav_by),
        fqav_by=fqav_by, dtype=dtype)
    h0, bases, per_bank = _scan_headers(raws, local, nfft=nfft, nint=nint,
                                        stokes=stokes, fqav_by=fqav_by)
    hdr = dict(h0)
    hdr["fch1"] = bases[local[0][0]]
    hdr["nchans"] = nbank * per_bank
    hdr["nsamps"] = int(out.shape[1])
    hdr["nifs"] = STOKES_NIF[stokes]
    return hdr, out


def _window_frames(window_frames: Optional[int], nfft: int, nint: int) -> int:
    if window_frames is None:
        from blit_torch.config import default_window_frames

        window_frames = default_window_frames(nfft)
    return max((window_frames // nint) * nint, nint)


@published
def reduce_scan_mesh_to_files(
        raw_paths, scan: Optional[str] = None, *, inventories=None,
        out_dir: Optional[str] = None, out_paths: Optional[Sequence[str]] = None,
        nfft: int, ntap: int = 4, nint: int = 1, stokes: str = "I",
        fqav_by: int = 1, fft_method: str = "auto", window: str = "hamming",
        despike: bool = True, max_frames: Optional[int] = None,
        window_frames: Optional[int] = None, compression: Optional[str] = None,
        resume: bool = False, mesh=None, dtype: str = "float32", timeline=None,
        trace_logdir: Optional[str] = None, device=None
) -> Dict[int, Tuple[str, Dict]]:
    """Reduce one scan across the mesh and stream each stitched band to
    its product, ``window_frames`` PFB frames a window (each window
    re-reads the ``(ntap-1)*nfft``-sample PFB prologue), so host memory,
    device memory and readback stay bounded (default window:
    :func:`blit_torch.config.default_window_frames`).

    Stages in ``timeline``: ``read`` (RAW ingest and the copy to the
    players), ``dispatch``, ``device`` (the wait on a window's compute and
    stitch), ``readback``, ``write``.  One window is in flight: window
    ``w+1`` is read and dispatched before window ``w`` is read back.

    Products: ``out_paths`` (one a band) or ``out_dir`` + ``band<id>.fil``
    (``.h5`` with ``compression``); each band is written by the process
    that owns its bank-0 player.  ``resume=True``: a
    :class:`~blit_torch.pipeline.ReductionCursor` a band, the restart at
    the last window every process agrees on, products identical to an
    uninterrupted run.  Returns ``{band_id: (path, header)}`` for the
    bands this process wrote."""
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
    done = {}
    try:
        from blit_torch.observability import Timeline, profile_trace

        tl = timeline if timeline is not None else Timeline()

        def flush(out: M.MeshArray) -> None:
            with tl.stage("device", byte_free=True):
                out.synchronize()
            for b in mine:
                with tl.stage("readback"):
                    slab = np.ascontiguousarray(out.shards[(b, 0)][0].cpu().numpy())
                tl.stages["readback"].bytes += slab.nbytes
                with tl.stage("write", slab.nbytes):
                    writers[b].append(slab)

        pending = None
        f0 = f0_start
        with profile_trace(trace_logdir):
            while f0 < total:
                n = min(wf, total - f0)
                ntime = (n + ntap - 1) * nfft
                fed = len(raws) * nchan * ntime * npol * 2
                with tl.stage("read", fed):
                    volt = _feed_window(raws, local, mesh, nchan, npol,
                                        f0 * nfft, ntime)
                with tl.stage("dispatch", byte_free=True):
                    out = M.band_reduce(
                        volt, coeffs, mesh=mesh, nfft=nfft, ntap=ntap,
                        nint=nint, stokes=stokes, fft_method=fft_method,
                        stitch=True, despike_nfpc=despike_nfpc,
                        fqav_by=fqav_by, dtype=dtype, timeline=tl)
                if pending is not None:
                    flush(pending)
                pending = out
                f0 += n
            if pending is not None:
                flush(pending)
        for b in list(writers):
            writers[b].close()
            done[b] = writers.pop(b)
    finally:
        for w in writers.values():
            w.abort()
    for b in mine:
        headers[b]["nsamps"] = done[b].nsamps
    return {band_ids[b]: (out_paths[b], headers[b]) for b in mine}


@published
def reduce_scan_pool_to_files(
        raw_paths, scan: Optional[str] = None, *, inventories=None,
        out_dir: Optional[str] = None, out_paths: Optional[Sequence[str]] = None,
        nfft: int, ntap: int = 4, nint: int = 1, stokes: str = "I",
        fqav_by: int = 1, fft_method: str = "auto", window: str = "hamming",
        despike: bool = True, max_frames: Optional[int] = None,
        window_frames: Optional[int] = None, compression: Optional[str] = None,
        dtype: str = "float32", pool=None, worker_ids: Optional[Sequence[int]] = None,
        timeline=None, device=None) -> Dict[int, Tuple[str, Dict]]:
    """The pool path of a whole-scan reduction, the mesh paths' oracle:
    one :class:`~blit_torch.pipeline.RawReducer` per player (fanned over
    a :class:`~blit_torch.parallel.pool.WorkerPool` when given, else run
    here), then a host-side channel concatenation and DC despike a band
    and one product write.

    With ``window_frames`` equal to the mesh paths' and a common
    whole-frame span, the products are byte-identical to
    :func:`reduce_scan_mesh_to_files` and
    :func:`~blit_torch.parallel.sharded.reduce_scan_sharded_to_files`:
    each bank is the same channelizer call on the same chunk
    (``chunk_frames = window_frames``), the stitch an exact
    concatenation and the despike an exact copy.  Each band's stitched
    array is held on the host.  Returns ``{band_id: (path, header)}`` for
    every band."""
    band_ids, raw_paths = _resolve_grid(raw_paths, scan, inventories)
    nband = len(raw_paths)
    nbank = len(raw_paths[0])
    if any(len(row) != nbank for row in raw_paths):
        raise ValueError("raw_paths must be rectangular (nband x nbank)")
    raws = {}
    for b in range(nband):
        for k in range(nbank):
            r = open_raw(raw_paths[b][k])
            if r.nblocks == 0:
                raise ValueError(f"empty RAW file: {r.path}")
            raws[(b, k)] = r
    local = sorted(raws)
    total = min(usable_frames(_kept_samples(r), nfft, ntap, nint)
                for r in raws.values())
    if max_frames is not None:
        total = min(total, (max_frames // nint) * nint)
    if total <= 0:
        raise ValueError("scan too short")
    wf = _window_frames(window_frames, nfft, nint)
    out_paths = _resolve_out_paths(band_ids, nband, out_dir, out_paths,
                                   compression)
    h0, bases, per_bank = _scan_headers(raws, local, nfft=nfft, nint=nint,
                                        stokes=stokes, fqav_by=fqav_by)
    for r in raws.values():
        r.close()
    nif = STOKES_NIF[stokes]
    nchans = nbank * per_bank
    despike_nfpc = _despike_nfpc(despike, nfft, fqav_by)
    rows_total = total // nint

    from blit_torch.observability import Timeline

    tl = timeline if timeline is not None else Timeline()
    red_kw = dict(nfft=nfft, ntap=ntap, nint=nint, stokes=stokes, window=window,
                  fft_method=fft_method, fqav_by=fqav_by, dtype=dtype,
                  chunk_frames=wf, tune_online=False)
    if pool is None:
        red_kw["device"] = str(resolve_device(device))
    elif device is not None:
        red_kw["device"] = str(device)

    def reduce_bank(b, k):
        from blit_torch.pipeline import RawReducer

        _, data = RawReducer(**red_kw).reduce(raw_paths[b][k])
        return data

    written: Dict[int, Tuple[str, Dict]] = {}
    for b in range(nband):
        with tl.stage("read", byte_free=True):
            if pool is not None:
                from blit_torch import workers as wf_mod

                wids = (list(worker_ids) if worker_ids is not None
                        else [(b * nbank + k) % len(pool) + 1
                              for k in range(nbank)])
                results = pool.run_on(wids, wf_mod.reduce_raw,
                                      [(raw_paths[b][k],) for k in range(nbank)],
                                      kwargs=red_kw)
                banks = [data for _hdr, data in results]
            else:
                banks = [reduce_bank(b, k) for k in range(nbank)]
        short = [k for k, d in enumerate(banks) if d.shape[0] < rows_total]
        if short:
            raise ValueError(f"band {band_ids[b]} banks {short} yielded fewer "
                             f"than the agreed {rows_total} spectra; players "
                             "disagree on span")
        stitched = np.concatenate([d[:rows_total] for d in banks], axis=-1)
        if despike_nfpc >= 2:
            from blit_torch.ops.despike import despike as _despike

            stitched = _despike(stitched, despike_nfpc)
        hdr = dict(h0)
        hdr["fch1"] = bases[b]
        hdr["nchans"] = nchans
        hdr["nifs"] = nif
        w = _slab_writer(out_paths[b], hdr, nif, nchans, compression)
        try:
            with tl.stage("write", stitched.nbytes):
                w.append(stitched)
            w.close()
        except BaseException:
            w.abort()
            raise
        hdr["nsamps"] = rows_total
        written[band_ids[b]] = (out_paths[b], hdr)
    return written
