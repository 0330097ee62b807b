"""SIGPROC filterbank (``.fil``) codec.

Counterpart of ``blit/io/sigproc.py``: a binary header of length-prefixed
keyword items between ``HEADER_START`` and ``HEADER_END``, then raw
samples in C order ``(nsamps, nifs, nchans)``.  The header encoder writes
the same bytes as ``blit``'s for the same header dict.  :class:`FilWriter`
publishes a ``<product>.manifest.json`` sidecar beside its product
(:mod:`blit_torch.integrity`), as ``blit``'s does.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Dict, Optional, Tuple

import numpy as np

_STRING_KEYS = {"source_name", "rawdatafile"}
_INT_KEYS = {
    "telescope_id", "machine_id", "data_type", "barycentric",
    "pulsarcentric", "nbits", "nsamples", "nchans", "nifs", "nbeams",
    "ibeam", "nbins",
}
_DOUBLE_KEYS = {
    "az_start", "za_start", "src_raj", "src_dej", "tstart", "tsamp",
    "fch1", "foff", "refdm", "period",
}
_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.float32}


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<i", f.read(4))
    if not 0 < n < 256:
        raise ValueError(f"sigproc: implausible header string length {n}")
    return f.read(n).decode("ascii")


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode("ascii")
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def encode_header(header: Dict, nbits: int, nifs: int, nchans: int) -> bytes:
    """The header bytes for ``header`` (keys outside the SIGPROC tables,
    such as ``nfpc`` and ``nsamps``, are skipped), with ``nbits``,
    ``nifs`` and ``nchans`` set from the data."""
    hdr = dict(header)
    hdr["nbits"] = nbits
    hdr["nchans"] = nchans
    hdr["nifs"] = nifs
    f = io.BytesIO()
    _write_string(f, "HEADER_START")
    for key, val in hdr.items():
        if key in _STRING_KEYS:
            _write_string(f, key)
            _write_string(f, str(val))
        elif key in _INT_KEYS:
            _write_string(f, key)
            f.write(struct.pack("<i", int(val)))
        elif key in _DOUBLE_KEYS:
            _write_string(f, key)
            f.write(struct.pack("<d", float(val)))
    _write_string(f, "HEADER_END")
    return f.getvalue()


def read_fil_header(path: str) -> Tuple[Dict, int]:
    """``(header, data_offset)``; ``nsamps`` is derived from file size,
    floored to whole spectra as ``blit``'s header reader does
    (:func:`check_payload` refuses a torn payload)."""
    hdr: Dict = {}
    with open(path, "rb") as f:
        if _read_string(f) != "HEADER_START":
            raise ValueError(f"{path}: not a SIGPROC filterbank file")
        while True:
            key = _read_string(f)
            if key == "HEADER_END":
                break
            if key in _STRING_KEYS:
                hdr[key] = _read_string(f)
            elif key in _INT_KEYS:
                (hdr[key],) = struct.unpack("<i", f.read(4))
            elif key in _DOUBLE_KEYS:
                (hdr[key],) = struct.unpack("<d", f.read(8))
            else:
                raise ValueError(f"{path}: unknown sigproc header keyword {key!r}")
        offset = f.tell()
    sample_bytes = _sample_bytes(hdr)
    payload = os.path.getsize(path) - offset
    hdr["nsamps"] = payload // sample_bytes if sample_bytes > 0 else 0
    return hdr, offset


def _sample_bytes(header: Dict) -> int:
    return header.get("nchans", 1) * header.get("nifs", 1) * header.get("nbits", 32) // 8


def check_payload(path: str, header: Dict, offset: int) -> None:
    """Raise unless the bytes after ``offset`` are a whole number of the
    spectra ``header`` describes, as ``blit``'s ``read_fil_data`` does:
    otherwise the header disagrees with the bytes on disk."""
    sample_bytes = _sample_bytes(header)
    payload = os.path.getsize(path) - offset
    if sample_bytes <= 0 or payload % sample_bytes:
        raise ValueError(
            f"{path}: payload of {payload} bytes is not a whole number "
            f"of (nifs={header.get('nifs', 1)}, nchans={header.get('nchans', 1)}, "
            f"nbits={header.get('nbits', 32)}) spectra of {sample_bytes} bytes "
            "— truncated or corrupt product (header disagrees with the bytes on disk)"
        )


def read_fil(path: str) -> Tuple[Dict, np.ndarray]:
    """``(header, data)`` with data a read-only memmap shaped
    ``(nsamps, nifs, nchans)``."""
    hdr, offset = read_fil_header(path)
    check_payload(path, hdr, offset)
    nbits = hdr.get("nbits", 32)
    if nbits not in _DTYPES:
        raise ValueError(f"{path}: unsupported nbits={nbits}")
    shape = (hdr["nsamps"], hdr.get("nifs", 1), hdr["nchans"])
    return hdr, np.memmap(path, dtype=_DTYPES[nbits], mode="r",
                          offset=offset, shape=shape)


def read_fil_data(path: str, header: Optional[Dict] = None,
                  mmap: bool = True) -> Tuple[Dict, np.ndarray]:
    """``(header, data)`` with data shaped ``(nsamps, nifs, nchans)``: a
    read-only memmap (``mmap=True``; unmapped when collected) or an array
    read into memory.  ``header`` replaces the file's own for the shape
    and dtype.  A payload that is not a whole number of spectra raises,
    as in ``blit``: the header disagrees with the bytes on disk."""
    if header is None:
        header, offset = read_fil_header(path)
    else:
        _, offset = read_fil_header(path)
    nbits = header.get("nbits", 32)
    if nbits not in _DTYPES:
        raise ValueError(f"{path}: unsupported nbits={nbits}")
    check_payload(path, header, offset)
    shape = (header["nsamps"], header.get("nifs", 1), header["nchans"])
    if mmap:
        data = np.memmap(path, dtype=_DTYPES[nbits], mode="r", offset=offset,
                         shape=shape)
    else:
        with open(path, "rb") as f:
            f.seek(offset)
            data = np.fromfile(f, dtype=_DTYPES[nbits]).reshape(shape)
    return header, data


def validate_slab(slab: np.ndarray, nifs: int, nchans: int,
                  dtype: np.dtype) -> np.ndarray:
    """The slab guard of every ``.fil`` append path: SIGPROC derives
    nsamps from the file size, so a mis-shaped or mis-typed slab would
    write a valid-looking corrupt product.  Shape and dtype must match
    exactly (the reducer's slabs always do)."""
    if slab.ndim != 3 or slab.shape[1:] != (nifs, nchans):
        raise ValueError(f"append: slab shape {slab.shape} does not "
                         f"extend (*, {nifs}, {nchans})")
    if slab.dtype != dtype:
        raise ValueError(f"append: slab dtype {slab.dtype} is not {dtype}")
    return np.ascontiguousarray(slab)


def write_fil(path: str, header: Dict, data: np.ndarray) -> None:
    """Write a SIGPROC filterbank file; ``data`` is ``(nsamps, nifs,
    nchans)`` and its dtype sets ``nbits``."""
    if data.ndim != 3:
        raise ValueError("write_fil: data must be (nsamps, nifs, nchans)")
    nbits = {np.uint8: 8, np.uint16: 16, np.float32: 32}[data.dtype.type]
    with open(path, "wb") as f:
        f.write(encode_header(header, nbits, data.shape[1], data.shape[2]))
        np.ascontiguousarray(data).tofile(f)


class FilWriter:
    """Streaming ``.fil`` writer: slabs append to a ``.partial`` sibling
    that is renamed onto ``path`` by :meth:`close`, so a crash never
    leaves a valid-looking truncated product (SIGPROC derives nsamps
    from file size).  ``dtype`` (float32, uint8 or uint16) sets the
    header's ``nbits`` and the samples' on-disk form.  The manifest's
    digests fold each slab as it is appended (on the write-behind sink's
    thread under the asynchronous plane) and the sidecar is published
    after the rename."""

    def __init__(self, path: str, header: Dict, nifs: int, nchans: int,
                 dtype=np.float32):
        from blit_torch import integrity

        self.dtype = np.dtype(dtype)
        if self.dtype not in [np.dtype(t) for t in _DTYPES.values()]:
            raise ValueError(f"FilWriter: unsupported dtype {self.dtype}")
        self.final_path = path
        self.path = path + ".partial"
        self.nifs = nifs
        self.nchans = nchans
        self.nsamps = 0
        write_fil(self.path, header, np.zeros((0, nifs, nchans), self.dtype))
        self._mf = integrity.ManifestWriter(
            path, "fil", row_bytes=nifs * nchans * self.dtype.itemsize,
            writer=type(self).__name__)
        self._mf.data_offset = os.path.getsize(self.path)
        self._mf.fold_path(self.path)
        self._f = open(self.path, "ab")

    def append(self, slab: np.ndarray) -> None:
        """Append ``(k, nifs, nchans)`` spectra (see :func:`validate_slab`)."""
        slab = validate_slab(slab, self.nifs, self.nchans, self.dtype)
        slab.tofile(self._f)
        self.nsamps += slab.shape[0]
        self._mf.fold(slab)
        self._mf.claim(self.nsamps)

    def flush(self) -> None:
        """Push appended bytes to the OS (the write-behind sink's flush
        barrier hook)."""
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is None:
            return
        try:
            self._f.close()
            self._f = None
            os.replace(self.path, self.final_path)
        except BaseException:
            self.abort()
            raise
        # After the publish; a manifest failure never un-publishes it.
        self._mf.publish()

    def abort(self) -> None:
        """Drop the partial product."""
        if self._f is not None:
            self._f.close()
            self._f = None
        if os.path.exists(self.path):
            os.unlink(self.path)
