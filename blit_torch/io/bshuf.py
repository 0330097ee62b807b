"""Python bindings of the native bitshuffle+LZ4 codec
(``blit_torch/native/bitshuffle.cc``, built on first use by
:mod:`blit_torch.io.native`).

Counterpart of ``blit/io/bshuf.py``.  :mod:`blit_torch.io.fbh5` encodes
and decodes the chunks of a ``compression="bitshuffle"`` product through
this codec and h5py's direct-chunk I/O, while the dataset's filter
pipeline carries the standard filter id 32008 with the upstream
plugin's ``cd_values``, so tools with that plugin read the files.
:func:`bitshuffle_np` is the numpy model of the bit transpose.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from blit_torch.io import native

BITSHUFFLE_FILTER_ID = 32008
H5_COMPRESS_LZ4 = 2
# (major, minor) the upstream filter stamps into cd_values.
_FILTER_VERSION = (0, 4)


def _load() -> Optional[ctypes.CDLL]:
    return native.load("bitshuffle")


def available() -> bool:
    """True when the codec library is built (or builds now) and loads."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the codec is unavailable (None when it is available)."""
    if available():
        return None
    return native.build_error("bitshuffle")


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("bitshuffle codec unavailable: "
                           f"{native.build_error('bitshuffle')}")
    return lib


def bitshuffle(a: np.ndarray) -> np.ndarray:
    """Bit transpose without compression; the element count must be a
    multiple of 8."""
    lib = _lib()
    a = np.ascontiguousarray(a)
    out = np.empty(a.nbytes, np.uint8)
    rc = lib.blit_bshuf_shuffle(a.ctypes.data, out.ctypes.data, a.size, a.itemsize)
    if rc:
        raise ValueError(f"bitshuffle failed (rc={rc}); size must be 8k")
    return out


def bitunshuffle(buf: np.ndarray, dtype, count: int) -> np.ndarray:
    lib = _lib()
    dtype = np.dtype(dtype)
    buf = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
    if buf.size != count * dtype.itemsize:
        raise ValueError(f"bitunshuffle: buffer holds {buf.size} bytes, "
                         f"need exactly {count * dtype.itemsize}")
    out = np.empty(count, dtype)
    rc = lib.blit_bshuf_unshuffle(buf.ctypes.data, out.ctypes.data, count,
                                  dtype.itemsize)
    if rc:
        raise ValueError(f"bitunshuffle failed (rc={rc})")
    return out


def compress_chunk(a: np.ndarray, block_size: int = 0) -> bytes:
    """Encode one HDF5 chunk into the bitshuffle-LZ4 wire format (the
    payload ``write_direct_chunk`` stores)."""
    lib = _lib()
    a = np.ascontiguousarray(a)
    bound = lib.blit_bshuf_compress_bound(a.size, a.itemsize, block_size)
    out = np.empty(bound, np.uint8)
    n = lib.blit_bshuf_compress_lz4(a.ctypes.data, out.ctypes.data, a.size,
                                    a.itemsize, block_size)
    if n < 0:
        raise ValueError(f"bitshuffle compress failed (rc={n})")
    return out[:n].tobytes()


def decompress_chunk(payload: bytes, dtype, count: int) -> np.ndarray:
    """Decode one chunk payload to ``count`` elements of ``dtype``."""
    lib = _lib()
    dtype = np.dtype(dtype)
    src = np.frombuffer(payload, np.uint8)
    out = np.empty(count, dtype)
    n = lib.blit_bshuf_decompress_lz4(src.ctypes.data, len(payload),
                                      out.ctypes.data, count, dtype.itemsize)
    if n < 0:
        raise ValueError(f"bitshuffle decompress failed (rc={n})")
    return out


def filter_cd_values(elem_size: int, block_size: int = 0) -> tuple:
    """The ``cd_values`` stamped into the HDF5 filter pipeline, the
    upstream bitshuffle plugin's convention."""
    return (_FILTER_VERSION[0], _FILTER_VERSION[1], elem_size, block_size,
            H5_COMPRESS_LZ4)


def bitshuffle_np(a: np.ndarray) -> np.ndarray:
    """The numpy model of the bit transpose: output row
    ``byte_pos*8 + bit`` (bit 0 = LSB); within a row, bit ``j`` of byte
    ``i`` belongs to element ``8i+j``."""
    a = np.ascontiguousarray(a)
    nelem, elem_size = a.size, a.itemsize
    if nelem % 8:
        raise ValueError("element count must be a multiple of 8")
    by = a.view(np.uint8).reshape(nelem, elem_size)  # [elem][byte]
    bits = (by[:, :, None] >> np.arange(8)) & 1      # [elem][byte][bit]
    rows = bits.transpose(1, 2, 0).reshape(elem_size * 8, nelem)
    return np.packbits(rows, axis=-1, bitorder="little").reshape(-1)
