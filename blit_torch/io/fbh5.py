"""FBH5: HDF5-wrapped filterbank products (``*.h5``).

Counterpart of ``blit/io/fbh5.py``, writing the same layout: one
``data`` dataset ``(nsamps, nifs, nchans)`` whose attributes carry the
filterbank header, file attributes ``CLASS=FILTERBANK`` and
``VERSION=1.0``.  Compression is None, ``"gzip"`` or ``"bitshuffle"``
(BL's production codec, filter id 32008 with the upstream plugin's
``cd_values``); bitshuffle chunks are encoded and decoded by the port's
own codec (:mod:`blit_torch.io.bshuf`) through h5py's direct-chunk I/O,
so no HDF5 plugin is needed.

``h5py`` is imported here only, and only inside the functions that open
an HDF5 file: :func:`is_hdf5` reads the signature itself, so the
workers' format dispatch needs no ``h5py`` (a GPU host may lack it).  Every writer publishes a
``<product>.manifest.json`` sidecar whose digests cover the logical
dataset rows (:mod:`blit_torch.integrity`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from blit_torch import faults
from blit_torch.config import nfpc_from_foff
from blit_torch.io.bshuf import BITSHUFFLE_FILTER_ID

# libhdf5 refuses chunks of 4 GiB or more (H5Dcreate fails); hi-res blit
# products have 2^20-point spectra, where BL's conventional 16-spectra chunk
# row would be 16 GiB — defaults must clamp, not crash at writer open.
H5_CHUNK_LIMIT = 2**32 - 1

# The HDF5 format signature, at offset 0 or at 512, 1024, 2048, ... when
# a user block precedes the superblock.
HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _h5py():
    import h5py

    return h5py


def is_hdf5(path: str) -> bool:
    """True when ``path`` is an HDF5 file: the signature at offset 0 or at
    a power of two from 512 up to the file's size, where libhdf5's
    superblock search (``h5py.is_hdf5``) looks for it.  False for a path
    that is not a regular file.  Needs no ``h5py``."""
    if not os.path.isfile(path):
        return False
    size = os.path.getsize(path)
    n = len(HDF5_SIGNATURE)
    with open(path, "rb") as f:
        off = 0
        while off + n <= size:
            f.seek(off)
            if f.read(n) == HDF5_SIGNATURE:
                return True
            off = 512 if off == 0 else off * 2
    return False


def default_chunks(
    nifs: int,
    nchans: int,
    itemsize: int,
    *,
    whole_spectrum: bool = False,
) -> Tuple[int, int, int]:
    """BL's conventional ``(16, nifs, nchans)`` whole-spectrum chunk rows,
    with the time rows clamped so chunk bytes stay under HDF5's 4 GiB-1
    chunk limit (a hi-res 64-channel-bank Stokes product is 256 MiB per
    spectrum; the full-band IQUV mesh product is 8 GiB per spectrum).

    When even ONE spectrum exceeds the limit the channel axis is split —
    unless ``whole_spectrum=True`` (the streaming bitshuffle writer stores
    one chunk per time row and cannot split channels), which raises
    instead of returning an unusable chunk shape.
    """
    row_bytes = nifs * nchans * itemsize
    rows = max(1, min(16, H5_CHUNK_LIMIT // max(row_bytes, 1)))
    if rows * row_bytes <= H5_CHUNK_LIMIT:
        return (rows, nifs, nchans)
    if whole_spectrum:
        raise ValueError(
            f"one ({nifs}, {nchans}) spectrum is {row_bytes} bytes, over "
            f"HDF5's 4 GiB-1 chunk limit, and this writer needs "
            "whole-spectrum chunks: reduce nchans per product (e.g. "
            "per-band files) or use uncompressed/gzip output"
        )
    return (1, nifs, max(1, H5_CHUNK_LIMIT // (nifs * itemsize)))


def _bitshuffle_cd_values(ds) -> Optional[Tuple]:
    """cd_values if the dataset's filter pipeline contains bitshuffle."""
    try:
        plist = ds.id.get_create_plist()
        for i in range(plist.get_nfilters()):
            code, _flags, cd, _name = plist.get_filter(i)
            if code == BITSHUFFLE_FILTER_ID:
                return tuple(cd)
    except Exception:  # noqa: BLE001 - treat unreadable pipelines as plain
        return None
    return None


def _needs_manual_bitshuffle(ds) -> bool:
    return (
        _bitshuffle_cd_values(ds) is not None
        and not _h5py().h5z.filter_avail(BITSHUFFLE_FILTER_ID)
    )


def _read_bitshuffle_chunks(ds, bbox: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """Assemble the half-open bounding box ``bbox`` of a bitshuffle dataset
    by decoding exactly the intersecting chunks with the native codec.

    Chunk payloads are read serially (libhdf5 is not thread-safe), then
    decoded in a thread pool — the native unshuffle+LZ4 runs GIL-free via
    ctypes, so decode scales with cores instead of serializing behind the
    reads (a libhdf5 filter plugin decodes chunks one at a time inside
    H5Dread)."""
    import itertools
    from concurrent.futures import ThreadPoolExecutor

    from blit_torch.io import bshuf

    if not bshuf.available():
        raise RuntimeError(
            "file needs the bitshuffle codec, which is unavailable: "
            f"{bshuf.unavailable_reason()}"
        )
    chunk = ds.chunks
    shape = ds.shape
    out = np.empty([hi - lo for lo, hi in bbox], ds.dtype)
    ranges = [
        range(lo // c * c, hi, c) for (lo, hi), c in zip(bbox, chunk)
    ]

    def place(corner, payload):
        full = tuple(min(c, s - o) for c, s, o in zip(chunk, shape, corner))
        # Chunks are stored at full chunk size (edge chunks padded).
        dec = bshuf.decompress_chunk(
            payload, ds.dtype, int(np.prod(chunk))
        ).reshape(chunk)[tuple(slice(0, f) for f in full)]
        src = tuple(
            slice(max(lo - o, 0), min(hi - o, f))
            for (lo, hi), o, f in zip(bbox, corner, full)
        )
        dst = tuple(
            slice(max(o - lo, 0), max(o - lo, 0) + (s.stop - s.start))
            for (lo, _hi), o, s in zip(bbox, corner, src)
        )
        out[dst] = dec[src]

    corners = list(itertools.product(*ranges))
    if len(corners) == 1:
        place(corners[0], ds.id.read_direct_chunk(corners[0])[1])
        return out
    # Stream: reads stay serial, decodes overlap them in the pool; bounding
    # the in-flight futures bounds how many compressed payloads are resident
    # at once (a whole-file read must not hold the compressed file in RAM).
    from collections import deque

    nthreads = min(len(corners), os.cpu_count() or 1)
    inflight: deque = deque()
    with ThreadPoolExecutor(nthreads) as pool:
        for corner in corners:
            payload = ds.id.read_direct_chunk(corner)[1]
            inflight.append(pool.submit(place, corner, payload))
            while len(inflight) > 2 * nthreads:
                inflight.popleft().result()  # re-raises worker errors
        for f in inflight:
            f.result()
    return out


def _pyvalue(v):
    """Normalize an HDF5 attribute value to a plain Python scalar/str."""
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, np.ndarray):
        if v.shape == ():
            return _pyvalue(v[()])
        if v.dtype.kind == "S":
            return [x.decode("utf-8") for x in v]
        return v
    if isinstance(v, np.generic):
        return v.item()
    return v


def read_fbh5_header(path: str) -> Dict:
    """All attributes of the ``data`` dataset except ``DIMENSION_LABELS``,
    plus computed ``data_size`` and ``nsamps``, key-sorted.

    A missing ``nfpc`` is computed from the ``foff`` attribute.
    """
    with _h5py().File(path, "r") as h5:
        data = h5["data"]
        hdr = {
            k: _pyvalue(v)
            for k, v in data.attrs.items()
            if k != "DIMENSION_LABELS"
        }
        if "nfpc" not in hdr and "foff" in hdr:
            hdr["nfpc"] = nfpc_from_foff(hdr["foff"])
        hdr["data_size"] = data.dtype.itemsize * int(np.prod(data.shape))
        # Julia's size(data, ndims) is the slowest-varying (time) axis —
        # C-order shape[0] here.
        hdr["nsamps"] = data.shape[0]
    return dict(sorted(hdr.items()))


def read_fbh5_data(
    path: str, idxs: Optional[Tuple] = None
) -> np.ndarray:
    """Read the ``data`` dataset, full or as a hyperslab.

    ``idxs`` is a 3-tuple of slices over ``(time, pol, chan)``; None or
    all-``slice(None)`` does a single full read.  Decompression (gzip
    or bitshuffle, if the plugin is available) happens inside libhdf5 here.
    """
    with _h5py().File(path, "r") as h5:
        ds = h5["data"]
        if idxs is not None and len(idxs) != 3:
            raise ValueError("idxs must have exactly three indices")
        full = idxs is None or all(i == slice(None) for i in idxs)
        if not _needs_manual_bitshuffle(ds):
            return ds[()] if full else ds[idxs]
        # Manual path: decode intersecting chunks with the native codec.
        if idxs is None:
            idxs = (slice(None),) * 3
        norm = []
        for i, n in zip(idxs, ds.shape):
            if isinstance(i, slice):
                norm.append(i.indices(n))
            else:
                j = int(i) + n if int(i) < 0 else int(i)  # h5py-style negatives
                norm.append((j, j + 1, 1))
        if any(step < 1 or start < 0 for start, _e, step in norm):
            raise ValueError(
                "bitshuffle read: negative steps / out-of-range indices unsupported"
            )
        bbox = tuple((start, max(stop, start)) for start, stop, _ in norm)
        box = _read_bitshuffle_chunks(ds, bbox)
        residual = tuple(
            slice(None, None, step) if isinstance(i, slice) else 0
            for i, (_s, _e, step) in zip(idxs, norm)
        )
        return box[residual]


def _write_bitshuffle_chunks(ds, data: np.ndarray) -> None:
    """Encode every chunk with the native codec and store it via
    direct-chunk writes (edge chunks zero-padded to full chunk size, as the
    upstream filter does)."""
    import itertools

    from blit_torch.io import bshuf

    chunk = ds.chunks
    ranges = [range(0, s, c) for s, c in zip(data.shape, chunk)]
    for corner in itertools.product(*ranges):
        sl = tuple(
            slice(o, min(o + c, s)) for o, c, s in zip(corner, chunk, data.shape)
        )
        block = data[sl]
        if block.shape != chunk:
            padded = np.zeros(chunk, data.dtype)
            padded[tuple(slice(0, b) for b in block.shape)] = block
            block = padded
        ds.id.write_direct_chunk(corner, bshuf.compress_chunk(block))


def _header_attrs(ds, header: Dict) -> None:
    """Stamp the filterbank header onto the ``data`` dataset (shared by the
    whole-array and streaming writers; ``data_size``/``nsamps`` are computed
    on read from the dataset itself)."""
    for k, v in header.items():
        if k in ("data_size", "nsamps"):
            continue  # computed on read
        if isinstance(v, str):
            ds.attrs[k] = np.bytes_(v.encode())
        else:
            ds.attrs[k] = v
    ds.attrs["DIMENSION_LABELS"] = np.array(
        [b"time", b"feed_id", b"frequency"], dtype="S9"
    )


def _compression_kwargs(
    compression: Optional[str], itemsize: int
) -> Tuple[dict, bool]:
    """``h5py.create_dataset`` kwargs for a product codec → ``(kwargs,
    is_bitshuffle)``.  Shared by every FBH5 writer so codec wiring lives
    in one place."""
    if compression == "gzip":
        return {"compression": "gzip"}, False
    if compression == "bitshuffle":
        from blit_torch.io import bshuf

        if not bshuf.available():
            raise RuntimeError("bitshuffle codec unavailable: "
                               f"{bshuf.unavailable_reason()}")
        return {
            "compression": BITSHUFFLE_FILTER_ID,
            "compression_opts": bshuf.filter_cd_values(itemsize),
            "allow_unknown_filter": True,
        }, True
    if compression is not None:
        raise ValueError(f"unknown compression {compression!r}")
    return {}, False


def _stream_chunks(
    chunks: Optional[Tuple[int, int, int]],
    nifs: int,
    nchans: int,
    itemsize: int,
    bitshuffle: bool,
) -> Tuple[int, int, int]:
    """Resolve a streaming writer's chunk shape: explicit or clamped
    default, with the whole-spectrum constraint the streaming bitshuffle
    encoder needs (it stores one chunk per time-row corner; channel-split
    chunks would silently drop data)."""
    c = (
        tuple(chunks)
        if chunks
        else default_chunks(nifs, nchans, itemsize,
                            whole_spectrum=bitshuffle)
    )
    if bitshuffle and c[1:] != (nifs, nchans):
        raise ValueError(
            "bitshuffle streaming needs whole-spectrum chunks: "
            f"chunks[1:] must be ({nifs}, {nchans}), got {c}"
        )
    return c


class _ChunkStream:
    """The bitshuffle chunk-row streaming engine shared by
    :class:`FBH5Writer` and :class:`ResumableFBH5Writer` (state used:
    ``_ds``, ``chunks``, ``dtype``, ``nsamps``, ``_buf``, ``_buffered``).
    Encodes with the native codec and stores via direct-chunk writes,
    buffering at most one chunk row of pending spectra."""

    def _flush_chunk(self, rows: int) -> None:
        """Encode + store the buffered rows as one full chunk (edge chunks
        zero-padded to full chunk size, as the upstream filter does)."""
        from blit_torch.io import bshuf

        if rows < self.chunks[0]:
            self._buf[rows:] = 0
        corner = (self.nsamps, 0, 0)
        payload = bshuf.compress_chunk(self._buf)

        def _write():
            # Idempotent under retry: resize targets an absolute size and
            # the direct-chunk write lands at a fixed corner.
            faults.fire("fbh5.write", key=self.path)
            self._ds.resize(self.nsamps + rows, axis=0)
            self._ds.id.write_direct_chunk(corner, payload)

        faults.retry_io(_write, describe=f"fbh5 chunk write {self.path}")
        self.nsamps += rows
        self._buffered = 0
        # Manifest fold at claim granularity: only rows
        # flushed as full chunks are ever claimed by a cursor, so the
        # digest ledger advances exactly with them.
        mf = getattr(self, "_mf", None)
        if mf is not None:
            mf.fold(np.ascontiguousarray(self._buf[:rows]))
            mf.claim(self.nsamps)

    def _buffer_slab(self, slab: np.ndarray) -> bool:
        """Buffer ``slab``'s rows, flushing every completed chunk; returns
        whether at least one chunk was flushed (the durable-progress
        signal the resumable writer checkpoints on)."""
        slab = np.ascontiguousarray(slab, self.dtype)
        ct = self.chunks[0]
        pos, flushed = 0, False
        while pos < slab.shape[0]:
            take = min(ct - self._buffered, slab.shape[0] - pos)
            self._buf[self._buffered:self._buffered + take] = (
                slab[pos:pos + take]
            )
            self._buffered += take
            pos += take
            if self._buffered == ct:
                self._flush_chunk(ct)
                flushed = True
        return flushed


class FBH5Writer(_ChunkStream):
    """Streaming FBH5 product writer: append ``(k, nifs, nchans)`` slabs
    into a time-resizable ``data`` dataset at bounded host memory — the
    ``.h5`` analog of ``RawReducer.reduce_to_file``'s slab-streamed ``.fil``
    path, so a hi-res product of a long scan is written as FBH5 without
    being held in memory.

    Peak residency is one chunk row (``chunks[0]`` spectra) plus one
    encoded chunk, regardless of scan length.  Bitshuffle chunks are
    encoded by the native codec and stored via direct-chunk writes exactly
    as :func:`write_fbh5` does, so a streamed file decodes identically to
    an in-memory write of the same data.

    Atomicity mirrors the ``.fil`` streaming writer: bytes land in a
    ``.partial`` sibling and rename onto ``path`` only on a successful
    :meth:`close` — a crash mid-stream must not leave a valid-looking
    truncated product.  Use as a context manager; an exception inside the
    ``with`` removes the partial.
    """

    def __init__(
        self,
        path: str,
        header: Dict,
        *,
        nifs: int,
        nchans: int,
        dtype=np.float32,
        compression: Optional[str] = None,
        chunks: Optional[Tuple[int, int, int]] = None,
    ):
        self.final_path = path
        self.path = path + ".partial"
        self.dtype = np.dtype(dtype)
        kw, self._bitshuffle = _compression_kwargs(
            compression, self.dtype.itemsize
        )
        # A time-resizable dataset must be chunked; default matches
        # write_fbh5's BL convention (16-spectra rows, whole channel span),
        # clamped under the HDF5 chunk-size limit (the hi-res preset's
        # unclamped default chunk would be 16 GiB and fail at open).
        self.chunks = _stream_chunks(
            chunks, nifs, nchans, self.dtype.itemsize, self._bitshuffle
        )
        self._h5 = _h5py().File(self.path, "w")
        try:
            self._h5.attrs["CLASS"] = np.bytes_(b"FILTERBANK")
            self._h5.attrs["VERSION"] = np.bytes_(b"1.0")
            self._ds = self._h5.create_dataset(
                "data",
                shape=(0, nifs, nchans),
                maxshape=(None, nifs, nchans),
                dtype=self.dtype,
                chunks=self.chunks,
                **kw,
            )
            _header_attrs(self._ds, header)
        except BaseException:
            self._h5.close()
            os.unlink(self.path)
            raise
        self.nsamps = 0  # spectra durably in the dataset
        # Product manifest: logical-row digests folded as
        # slabs append; the whole-file CRC is computed by one re-read at
        # close (libhdf5 metadata churn makes mid-stream file-byte CRCs
        # meaningless — the fbh5 manifest digests the DATA rows).
        from blit_torch import integrity

        self._mf = integrity.ManifestWriter(
            self.final_path, "fbh5",
            row_bytes=nifs * nchans * self.dtype.itemsize,
            writer=type(self).__name__)
        # Pending partial chunk row (the bitshuffle path buffers up to one;
        # the plain/gzip paths let libhdf5 chunk and never touch this).
        self._buf = (
            np.empty(self.chunks, self.dtype) if self._bitshuffle else None
        )
        self._buffered = 0

    def append(self, slab: np.ndarray) -> None:
        """Append ``(k, nifs, nchans)`` spectra to the time axis."""
        if slab.ndim != 3 or slab.shape[1:] != self._ds.shape[1:]:
            raise ValueError(
                f"append: slab shape {slab.shape} does not extend "
                f"(*, {self._ds.shape[1]}, {self._ds.shape[2]})"
            )
        if not self._bitshuffle:
            k = slab.shape[0]

            def _write():
                # Absolute resize + fixed-offset assignment: safe to retry.
                faults.fire("fbh5.write", key=self.path)
                self._ds.resize(self.nsamps + k, axis=0)
                self._ds[self.nsamps:] = slab
            faults.retry_io(_write, describe=f"fbh5 write {self.path}")
            self.nsamps += k
            # Digest the STORED dtype bytes (h5py casts on assignment).
            self._mf.fold(np.ascontiguousarray(slab, self.dtype))
            self._mf.claim(self.nsamps)
            return
        self._buffer_slab(slab)

    def flush(self) -> None:
        """Flush libhdf5 buffers to the OS — the write-behind sink's
        flush barrier hook (:meth:`blit_torch.outplane.AsyncSink.flush`).
        Does NOT flush a buffered partial bitshuffle chunk row (that
        happens at :meth:`close`, padded, exactly once)."""
        if self._h5 is not None:
            self._h5.flush()

    def close(self) -> None:
        """Flush any partial tail chunk, finalize, and rename onto the
        final path.  A failure anywhere in here (tail flush, HDF5 close,
        rename) drops the ``.partial`` before re-raising — close must
        never leave a stray partial behind."""
        if self._h5 is None:
            return
        try:
            if self._bitshuffle and self._buffered:
                self._flush_chunk(self._buffered)
            self._h5.close()
            self._h5 = None
            os.replace(self.path, self.final_path)
        except BaseException:
            self.abort()
            raise
        # Whole-file digest over the finished bytes (one re-read,
        # page-cache hot); best-effort — a manifest failure must never
        # un-publish the product.
        self._mf.publish(scan_file=True)

    def abort(self) -> None:
        """Drop the partial product (crash/exception path)."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        if os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        return self

    def __exit__(self, etype, _e, _tb):
        if etype is None:
            self.close()
        else:
            self.abort()


class ResumableFBH5Writer(_ChunkStream):
    """Crash-resumable FBH5 product writer — the ``.h5`` twin of
    :class:`blit_torch.pipeline.ResumableFilWriter`: a long-scan reduction
    to BL's native format survives a crash.

    Incompleteness marker is the cursor sidecar, not a ``.partial`` rename:
    slabs land in the time-resizable dataset and are flushed + fsync'd
    BEFORE the cursor claims them, so a crash leaves a resumable prefix —
    never a cursor ahead of durable data.  ``start_rows`` > 0 resumes by
    ``resize``-truncating the dataset to that many spectra (dropping any
    un-checkpointed tail) and clamping the cursor to match.

    Durability granularity: the plain/gzip paths checkpoint after every
    append; the bitshuffle path buffers up to one chunk row (exactly as
    :class:`FBH5Writer`) and the cursor claims only rows flushed as full
    chunks — buffered rows are re-reduced after a crash, and every claim
    (hence every resume point) is chunk-aligned.  Callers that truncate to
    an externally agreed restart offset (the mesh writer's pod-wide MIN)
    must pick chunk rows dividing that offset's granularity; pass
    ``chunks=`` to arrange it.

    The cursor is duck-typed (``frames_done`` + ``save(path)`` — a
    :class:`blit_torch.pipeline.ReductionCursor`); ``nint`` converts written
    rows to its frame count.
    """

    def __init__(self, path: str, header: Dict, nifs: int, nchans: int,
                 start_rows: int, nint: int, cursor,
                 compression: Optional[str] = None,
                 chunks: Optional[Tuple[int, int, int]] = None,
                 dtype=np.float32):
        self.path = path
        self.dtype = np.dtype(dtype)
        self._nifs, self._nchans = nifs, nchans
        self._nint = nint
        self.cursor = cursor
        kw, self._bitshuffle = _compression_kwargs(
            compression, self.dtype.itemsize
        )
        self.chunks = _stream_chunks(
            chunks, nifs, nchans, self.dtype.itemsize, self._bitshuffle
        )
        if self._bitshuffle and start_rows % self.chunks[0]:
            raise ValueError(
                f"bitshuffle resume point {start_rows} rows is not "
                f"aligned to chunk rows {self.chunks[0]} — the cursor "
                "only ever claims chunk-aligned counts, so this is a "
                "caller bug (restart offset granularity must be a "
                "multiple of chunk rows)"
            )
        if start_rows > 0 and os.path.exists(path):
            self._h5 = _h5py().File(path, "r+")
            try:
                self._ds = self._h5["data"]
                if self._ds.shape[1:] != (nifs, nchans):
                    raise ValueError(
                        f"resume target {path} has dataset shape "
                        f"{self._ds.shape}, product needs (*, {nifs}, "
                        f"{nchans})"
                    )
                if self._ds.chunks != self.chunks:
                    raise ValueError(
                        f"resume target {path} has chunks {self._ds.chunks}"
                        f", writer needs {self.chunks} — cursor identity "
                        "should have refused this resume"
                    )
                # A dataset's filter pipeline is fixed at creation; direct
                # chunk writes through a MISMATCHED pipeline would store
                # undecodable payloads, so refuse rather than corrupt.
                has_bshuf = _bitshuffle_cd_values(self._ds) is not None
                if has_bshuf != self._bitshuffle:
                    raise ValueError(
                        f"resume target {path} "
                        f"{'has' if has_bshuf else 'lacks'} the bitshuffle "
                        "filter but the writer "
                        f"{'expects' if self._bitshuffle else 'does not use'}"
                        " it — cursor identity should have refused this"
                    )
                if self._ds.shape[0] < start_rows:
                    raise ValueError(
                        f"resume target {path} holds {self._ds.shape[0]} "
                        f"spectra, cursor claims {start_rows}"
                    )
                # Drop the un-checkpointed tail; clamp the cursor DOWN with
                # the truncation (mesh restarts at a pod-wide minimum).
                self._ds.resize(start_rows, axis=0)
                self._checkpoint(start_rows)
            except BaseException:
                self._h5.close()
                raise
        else:
            start_rows = 0
            self._h5 = _h5py().File(path, "w")
            try:
                self._h5.attrs["CLASS"] = np.bytes_(b"FILTERBANK")
                self._h5.attrs["VERSION"] = np.bytes_(b"1.0")
                self._ds = self._h5.create_dataset(
                    "data",
                    shape=(0, nifs, nchans),
                    maxshape=(None, nifs, nchans),
                    dtype=self.dtype,
                    chunks=self.chunks,
                    **kw,
                )
                _header_attrs(self._ds, header)
                self._checkpoint(0)
            except BaseException:
                self._h5.close()
                os.unlink(path)
                raise
        self.nsamps = start_rows
        # Product manifest: the claim ledger checkpoints
        # beside the cursor, so a resume can content-verify the claimed
        # rows (resume_target_ok) before trusting it.  On resume the
        # running digest is rebuilt over the truncated claim (callers
        # already verified it matches the ledger).
        from blit_torch import integrity

        self._mf = integrity.ManifestWriter(
            path, "fbh5", row_bytes=nifs * nchans * self.dtype.itemsize,
            writer=type(self).__name__)
        if start_rows > 0:
            row_bytes = nifs * nchans * self.dtype.itemsize
            step = max(1, (8 << 20) // max(1, row_bytes))
            manual = _needs_manual_bitshuffle(self._ds)
            for a in range(0, start_rows, step):
                b = min(start_rows, a + step)
                slab = (
                    _read_bitshuffle_chunks(
                        self._ds, ((a, b), (0, nifs), (0, nchans)))
                    if manual else self._ds[a:b]
                )
                self._mf.fold(np.ascontiguousarray(slab, self.dtype))
            self._mf.claim(start_rows)
        self._mf.save()
        self._buf = (
            np.empty(self.chunks, self.dtype) if self._bitshuffle else None
        )
        self._buffered = 0

    def _checkpoint(self, rows: int) -> None:
        """Durable data BEFORE the cursor claims it (power-loss
        ordering): flush libhdf5 buffers, fsync the file, persist the
        MANIFEST (its ledger must always hold an entry for every row
        count a cursor can claim — ahead is harmless, behind is an
        unverifiable gap), then the cursor."""
        self._h5.flush()
        os.fsync(self._h5.id.get_vfd_handle())
        mf = getattr(self, "_mf", None)
        if mf is not None:  # absent only during __init__'s own call
            mf.save()
        self.cursor.frames_done = rows * self._nint
        self.cursor.save(self.path)

    def append(self, slab: np.ndarray) -> None:
        """Append ``(k, nifs, nchans)`` spectra and checkpoint every row
        (plain/gzip) or every completed chunk (bitshuffle)."""
        if slab.ndim != 3 or slab.shape[1:] != (self._nifs, self._nchans):
            raise ValueError(
                f"append: slab shape {slab.shape} does not extend "
                f"(*, {self._nifs}, {self._nchans})"
            )
        if not self._bitshuffle:
            k = slab.shape[0]

            def _write():
                faults.fire("fbh5.write", key=self.path)
                self._ds.resize(self.nsamps + k, axis=0)
                self._ds[self.nsamps:] = slab
            faults.retry_io(_write, describe=f"fbh5 write {self.path}")
            self.nsamps += k
            self._mf.fold(np.ascontiguousarray(slab, self.dtype))
            self._mf.claim(self.nsamps)
            self._checkpoint(self.nsamps)  # saves manifest, then cursor
            return
        if self._buffer_slab(slab):
            # _flush_chunk already folded + claimed the flushed rows.
            self._checkpoint(self.nsamps)

    def close(self) -> None:
        """Flush any buffered tail (bitshuffle pads the final chunk, as
        the upstream filter does), finalize, and remove the sidecar — its
        absence is the completeness marker."""
        if self._h5 is None:
            return
        if self._bitshuffle and self._buffered:
            self._flush_chunk(self._buffered)
        self._h5.flush()
        os.fsync(self._h5.id.get_vfd_handle())
        self._h5.close()
        self._h5 = None
        # Completed product: whole-file digest (the manifest stays; the
        # cursor sidecar below goes — its absence marks completeness).
        self._mf.publish(scan_file=True)
        # The cursor names its own sidecar when it can; the duck-typed
        # fallback keeps the ReductionCursor ``.cursor`` default.
        path_for = getattr(self.cursor, "path_for", _cursor_path)
        sidecar = path_for(self.path)
        if os.path.exists(sidecar):
            os.unlink(sidecar)

    def abort(self) -> None:
        """The file + cursor ARE the resume point: close, keep both.
        Buffered (unclaimed) bitshuffle rows are simply dropped — the
        cursor never claimed them, so the resume re-reduces them."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None


def _cursor_path(out_path: str) -> str:
    """Sidecar path, kept in lockstep with
    ``blit_torch.pipeline.ReductionCursor.path_for`` (kept here so the
    I/O layer does not import the pipeline)."""
    return out_path + ".cursor"


def resume_target_ok(path: str, nifs: int, nchans: int, rows: int) -> bool:
    """Can ``path`` back a resume claiming ``rows`` spectra?

    The crash-resume protocol fsyncs data before the cursor claims it,
    but libhdf5's in-place metadata updates between checkpoints are NOT
    crash-atomic: a SIGKILL/power loss can leave a file that no longer
    opens as HDF5 — or whose claimed prefix no longer reads — while the
    cursor sidecar (written via its own tmp-rename+fsync) still parses.
    Resume callers probe with this BEFORE trusting
    the cursor: ``False`` means fall back to a fresh start exactly like
    a cursor-identity mismatch (logging what was discarded), instead of
    raising and wedging resume until an operator deletes the file by
    hand.

    The probe opens the file, checks the dataset geometry covers the
    claim, and decodes the last claimed row (one chunk read — under
    bitshuffle the cursor only ever claims flushed chunks, so that row
    must decode).  Any failure anywhere is a ``False``, not an error.

    When a manifest sidecar exists the structural probe is UPGRADED to
    content verification: the claimed rows' digest must match
    the manifest's claim ledger — bit rot or a torn write *inside* the
    claimed region fails closed where the decode probe alone would have
    resumed onto (structurally valid) corrupt spectra.  No manifest
    keeps the structural behavior.
    """
    try:
        with _h5py().File(path, "r") as h5:
            ds = h5["data"]
            if ds.shape[1:] != (nifs, nchans) or ds.shape[0] < rows:
                return False
        if rows > 0:
            read_fbh5_data(
                path, (slice(rows - 1, rows), slice(None), slice(None))
            )
    except Exception:  # noqa: BLE001 — any unreadability means start fresh
        return False
    from blit_torch import integrity

    return integrity.verify_claim(path, rows, fmt="fbh5") is not False


def write_fbh5(
    path: str,
    header: Dict,
    data: np.ndarray,
    compression: Optional[str] = None,
    chunks: Optional[Tuple[int, int, int]] = None,
) -> None:
    """Write an FBH5 file: ``data`` dataset + header attributes.

    ``compression``: None | "gzip" | "bitshuffle" (bitshuffle requires the
    native codec of ``blit_torch/native``; raises when it is unavailable).
    """
    if data.ndim != 3:
        raise ValueError("write_fbh5: data must be (nsamps, nifs, nchans)")
    bitshuffle = False
    kw = {}
    if chunks is not None:
        kw["chunks"] = chunks
    if compression == "gzip":
        kw["compression"] = "gzip"
        kw.setdefault("chunks", True)
    elif compression == "bitshuffle":
        from blit_torch.io import bshuf

        if not bshuf.available():
            raise RuntimeError("bitshuffle codec unavailable: "
                               f"{bshuf.unavailable_reason()}")
        bitshuffle = True
        dc = default_chunks(data.shape[1], data.shape[2], data.dtype.itemsize)
        kw["chunks"] = chunks or (max(1, min(data.shape[0], dc[0])), dc[1], dc[2])
        kw["compression"] = BITSHUFFLE_FILTER_ID
        kw["compression_opts"] = bshuf.filter_cd_values(data.dtype.itemsize)
        kw["allow_unknown_filter"] = True
    elif compression is not None:
        raise ValueError(f"unknown compression {compression!r}")

    with _h5py().File(path, "w") as h5:
        h5.attrs["CLASS"] = np.bytes_(b"FILTERBANK")
        h5.attrs["VERSION"] = np.bytes_(b"1.0")
        if bitshuffle:
            ds = h5.create_dataset(
                "data", shape=data.shape, dtype=data.dtype, **kw
            )
            _write_bitshuffle_chunks(ds, np.ascontiguousarray(data))
        else:
            ds = h5.create_dataset("data", data=data, **kw)
        _header_attrs(ds, header)
