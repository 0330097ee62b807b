"""Build and load the native (C++) host libraries of ``blit_torch/native``.

Counterpart of ``blit/io/native.py``.  ``native/guppi.cc`` is the
threaded GUPPI block reader, ``native/bitshuffle.cc`` the bitshuffle+LZ4
chunk codec of ``.h5`` products (:mod:`blit_torch.io.bshuf`).  Each is
compiled by ``g++`` on first use into ``blit_torch/native/build/``, under
a name keyed by a hash of the source and the flags, written to a
``.tmp`` name and moved into place with ``os.replace``, so processes
that race on the first build each load a whole library.  Importing this
module builds nothing.

The libraries are optional host code, as in ``blit``: when ``g++`` or
``liblz4.so.1`` is missing, :func:`load` returns None (and remembers
why, :func:`build_error`), the readers take their Python paths and
``compression="bitshuffle"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
BUILD_DIR = os.path.join(NATIVE_SRC, "build")
# blit/native/Makefile's flags, without -march=native: the library may be
# built on one host and run on another.
CXX_FLAGS = ["-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared"]
LIBS = {"guppi": ["-lpthread"], "bitshuffle": ["-l:liblz4.so.1"]}

_LOADED: Dict[str, Optional[ctypes.CDLL]] = {}
_ERRORS: Dict[str, str] = {}
_LOCK = threading.Lock()


def lib_path(name: str) -> str:
    """The library of ``native/<name>.cc`` for this source and these flags."""
    with open(os.path.join(NATIVE_SRC, name + ".cc"), "rb") as f:
        src = f.read()
    flags = " ".join(CXX_FLAGS + LIBS[name]).encode()
    h = hashlib.sha256(src + flags).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libblit_torch_{name}-{h}.so")


def _build(name: str) -> str:
    """Compile ``native/<name>.cc`` unless built; returns the library path
    or raises ``RuntimeError`` naming what is missing."""
    final = lib_path(name)
    if os.path.exists(final):
        return final
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native host libraries of "
                           "blit_torch are built with g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, os.path.join(NATIVE_SRC, name + ".cc"),
           *LIBS[name]]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"g++ failed for native/{name}.cc:\n{out.stderr}")
    os.replace(tmp, final)
    return final


def _bind_guppi(lib: ctypes.CDLL) -> None:
    lib.blit_guppi_pread.restype = ctypes.c_int
    lib.blit_guppi_pread.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int]
    lib.blit_guppi_pread2.restype = ctypes.c_int
    lib.blit_guppi_pread2.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]


def _bind_bitshuffle(lib: ctypes.CDLL) -> None:
    size, ptr = ctypes.c_size_t, ctypes.c_void_p
    for fn in (lib.blit_bshuf_shuffle, lib.blit_bshuf_unshuffle):
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ptr, size, size]
    lib.blit_bshuf_compress_bound.restype = ctypes.c_int64
    lib.blit_bshuf_compress_bound.argtypes = [size, size, size]
    lib.blit_bshuf_compress_lz4.restype = ctypes.c_int64
    lib.blit_bshuf_compress_lz4.argtypes = [ptr, ptr, size, size, size]
    lib.blit_bshuf_decompress_lz4.restype = ctypes.c_int64
    lib.blit_bshuf_decompress_lz4.argtypes = [ptr, size, ptr, size, size]


_BIND = {"guppi": _bind_guppi, "bitshuffle": _bind_bitshuffle}


def load(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of ``native/<name>.cc`` with its signatures
    bound, built on first use; None when it cannot be built or loaded
    (the reason in :func:`build_error`)."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        try:
            lib = ctypes.CDLL(_build(name))
            _BIND[name](lib)
        except (OSError, RuntimeError, AttributeError) as e:
            _ERRORS[name] = str(e)
            lib = None
        _LOADED[name] = lib
        return lib


def build_error(name: str) -> Optional[str]:
    """Why ``native/<name>.cc`` is unavailable (None: built, or not tried)."""
    return _ERRORS.get(name)


def guppi_lib() -> Optional[ctypes.CDLL]:
    """ctypes handle of the threaded GUPPI reader, or None."""
    return load("guppi")


def _unavailable() -> RuntimeError:
    return RuntimeError("native GUPPI reader unavailable: "
                        f"{build_error('guppi') or 'not built'}")


def guppi_pread_strided(path: str, offset: int, nchan: int, chan_bytes: int,
                        src_stride: int, dst, dst_stride: int,
                        nthreads: int = 8) -> None:
    """Threaded strided read: channel ``c``'s bytes ``[offset +
    c*src_stride, +chan_bytes)`` land at ``dst + c*dst_stride``, straight
    from a GUPPI block on disk into a chunk slot.  ``dst``: an ndarray
    whose buffer the rows fit inside.  Raises ``OSError`` on failure,
    ``RuntimeError`` when the library is unavailable."""
    lib = guppi_lib()
    if lib is None:
        raise _unavailable()
    try:  # numpy 2.x home, 1.x fallback
        from numpy.lib.array_utils import byte_bounds
    except ImportError:  # pragma: no cover
        from numpy import byte_bounds
    low, high = byte_bounds(dst)
    base = dst.ctypes.data
    if base < low or base + dst_stride * (nchan - 1) + chan_bytes > high:
        raise ValueError("guppi_pread_strided: rows exceed dst buffer")
    rc = lib.blit_guppi_pread2(path.encode(), offset, nchan, chan_bytes,
                               src_stride, dst_stride, base, nthreads)
    if rc:
        raise OSError(-rc, os.strerror(-rc), path)


def guppi_pread(path: str, offset: int, size: int, nthreads: int = 8):
    """Threaded pread of ``[offset, offset+size)`` into a fresh uint8
    array.  Raises ``OSError`` on failure, ``RuntimeError`` when the
    library is unavailable."""
    import numpy as np

    lib = guppi_lib()
    if lib is None:
        raise _unavailable()
    out = np.empty(size, np.uint8)
    rc = lib.blit_guppi_pread(path.encode(), offset, size, out.ctypes.data,
                              nthreads)
    if rc:
        raise OSError(-rc, os.strerror(-rc), path)
    return out
