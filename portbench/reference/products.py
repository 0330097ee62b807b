"""The reader of the products a run leaves, written from the format's
definition: SIGPROC filterbank (``HEADER_START`` … ``HEADER_END``
keyword items, then float32 samples in ``(nsamps, nifs, nchans)``
order).  The judge reads the program's products through it, so it
needs nothing of the program.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

_INT = {"telescope_id", "machine_id", "data_type", "barycentric",
        "pulsarcentric", "nbits", "nsamples", "nchans", "nifs", "nbeams",
        "ibeam", "nbins"}
_DOUBLE = {"az_start", "za_start", "src_raj", "src_dej", "tstart", "tsamp",
           "fch1", "foff", "refdm", "period"}
_STRING = {"source_name", "rawdatafile"}


def _string(f) -> str:
    (n,) = struct.unpack("<i", f.read(4))
    if not 0 < n < 256:
        raise ValueError(f"filterbank header: string length {n}")
    return f.read(n).decode("ascii")


def read_fil(path: str) -> Tuple[Dict, np.ndarray]:
    """``(header, data)`` of a float32 SIGPROC filterbank file; ``data``
    is ``(nsamps, nifs, nchans)``, memory-mapped."""
    hdr: Dict = {}
    with open(path, "rb") as f:
        if _string(f) != "HEADER_START":
            raise ValueError(f"{path}: not a SIGPROC filterbank file")
        while True:
            key = _string(f)
            if key == "HEADER_END":
                break
            if key in _INT:
                (hdr[key],) = struct.unpack("<i", f.read(4))
            elif key in _DOUBLE:
                (hdr[key],) = struct.unpack("<d", f.read(8))
            elif key in _STRING:
                hdr[key] = _string(f)
            else:
                raise ValueError(f"{path}: unknown header key {key!r}")
        offset = f.tell()
    if hdr.get("nbits") != 32:
        raise ValueError(f"{path}: nbits {hdr.get('nbits')}, want 32")
    nifs, nchans = hdr["nifs"], hdr["nchans"]
    data = np.memmap(path, np.float32, mode="r", offset=offset)
    nsamps = data.size // (nifs * nchans)
    return hdr, data[:nsamps * nifs * nchans].reshape(nsamps, nifs, nchans)

