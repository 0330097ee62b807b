"""GUPPI RAW voltage-file codec (single file).

Counterpart of ``blit/io/guppi.py``.  A RAW file is a sequence of blocks,
each a FITS-like header (80-byte ``KEY = value`` cards ending at ``END``,
padded to 512 bytes when ``DIRECTIO=1``) followed by ``BLOCSIZE`` bytes of
8-bit complex voltages laid out channel-major::

    [OBSNCHAN coarse channels][ntime samples][npol pols][2 int8 (re, im)]

``NPOL=4`` means two polarizations of complex data.  The trailing
``OVERLAP`` samples of every block repeat at the start of the next, so
the gap-free stream drops them from every block but the last.

This slice ports the single-file reader and the writer; the native
threaded reader, fault injection, digest verification and multi-file
scan sequences of ``blit`` are later work.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

CARD_LEN = 80
DIRECTIO_ALIGN = 512


def _parse_card_value(raw: str):
    s = raw.strip()
    if s.startswith("'"):
        return s.strip("'").rstrip()
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _format_card(key: str, value) -> bytes:
    if isinstance(value, str):
        vs = f"'{value:<8s}'"
    elif isinstance(value, bool):
        vs = "T" if value else "F"
    elif isinstance(value, float):
        vs = f"{value:.12G}"
    else:
        vs = str(value)
    card = f"{key:<8s}= {vs}"
    if len(card) > CARD_LEN:
        raise ValueError(f"guppi card too long: {card!r}")
    return card.ljust(CARD_LEN).encode("ascii")


def read_raw_header(f) -> Tuple[Dict, int]:
    """Read one block header at the current position.  Returns
    ``(header, data_offset)``; raises ``EOFError`` at end of file."""
    hdr: Dict = {}
    start = f.tell()
    while True:
        card = f.read(CARD_LEN)
        if len(card) < CARD_LEN:
            if not hdr and len(card) == 0:
                raise EOFError
            raise ValueError("guppi: truncated header card")
        text = card.decode("ascii", errors="replace")
        key = text[:8].strip()
        if key == "END":
            break
        if "=" not in text:
            raise ValueError(f"guppi: malformed card {text!r}")
        hdr[key] = _parse_card_value(text.split("=", 1)[1])
    end = f.tell()
    if hdr.get("DIRECTIO", 0):
        f.seek((-(end - start)) % DIRECTIO_ALIGN, os.SEEK_CUR)
    return hdr, f.tell()


def block_ntime(hdr: Dict) -> int:
    """Time samples per block implied by the header."""
    npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
    nbits = hdr.get("NBITS", 8)
    return hdr["BLOCSIZE"] // (hdr["OBSNCHAN"] * npol * 2 * nbits // 8)


class GuppiRaw:
    """One GUPPI RAW file: indexed (header, voltage block) access.  Block
    boundaries are scanned once (headers only); blocks are read on
    demand with positional reads straight into the caller's buffer."""

    def __init__(self, path: str):
        self.path = path
        self.headers: List[Dict] = []
        self._data_offsets: List[int] = []
        self._fd = None
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                try:
                    hdr, off = read_raw_header(f)
                except EOFError:
                    break
                if off + hdr["BLOCSIZE"] > size:
                    break  # truncated trailing block
                self.headers.append(hdr)
                self._data_offsets.append(off)
                f.seek(hdr["BLOCSIZE"], os.SEEK_CUR)

    @property
    def nblocks(self) -> int:
        return len(self.headers)

    def header(self, i: int = 0) -> Dict:
        return self.headers[i]

    def block_ntime_kept(self, i: int) -> int:
        """Samples block ``i`` contributes to the gap-free stream (every
        block but the last drops its trailing ``OVERLAP``)."""
        hdr = self.headers[i]
        nt = block_ntime(hdr)
        if i < self.nblocks - 1:
            nt -= hdr.get("OVERLAP", 0)
        return nt

    def _geometry(self, i: int) -> Tuple[int, int, int]:
        hdr = self.headers[i]
        nbits = hdr.get("NBITS", 8)
        if nbits != 8:
            raise NotImplementedError(f"NBITS={nbits} not supported (GBT uses 8)")
        npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
        return hdr["OBSNCHAN"], block_ntime(hdr), npol

    def read_block(self, i: int) -> np.ndarray:
        """Block ``i`` as int8 ``(obsnchan, ntime, npol, 2)`` (a copy)."""
        nchan, ntime, npol = self._geometry(i)
        out = np.empty((nchan, ntime, npol, 2), np.int8)
        self.read_block_into(i, out)
        return out

    def read_block_into(self, i: int, dst: np.ndarray, t0: int = 0,
                        ntime_keep: int = -1) -> int:
        """Read samples ``[t0, t0+ntime_keep)`` of every channel of block
        ``i`` into ``dst[:, :ntime_keep]`` (``-1``: to the block's end).
        ``dst``: int8 ``(nchan, >= ntime_keep, npol, 2)`` whose channel
        rows are C-contiguous.  Returns the samples written."""
        nchan, ntime, npol = self._geometry(i)
        if ntime_keep < 0:
            ntime_keep = ntime - t0
        if t0 < 0 or t0 + ntime_keep > ntime:
            raise ValueError(f"read_block_into: [{t0}, {t0 + ntime_keep}) "
                             f"outside block of {ntime} samples")
        if (dst.dtype != np.int8 or dst.shape[0] != nchan
                or dst.shape[2:] != (npol, 2) or dst.shape[1] < ntime_keep):
            raise ValueError("read_block_into: dst shape/dtype mismatch")
        if not dst[0].flags.c_contiguous:
            raise ValueError("read_block_into: dst rows must be C-contiguous")
        if ntime_keep == 0:
            return 0
        samp = npol * 2
        row_bytes = ntime_keep * samp
        base = self._data_offsets[i] + t0 * samp
        if self._fd is None:
            self._fd = os.open(self.path, os.O_RDONLY)
        for c in range(nchan):
            view = memoryview(dst[c]).cast("B")[:row_bytes]
            off = base + c * ntime * samp
            done = 0
            while done < row_bytes:  # a pread may return short
                got = os.preadv(self._fd, [view[done:]], off + done)
                if got <= 0:
                    raise EOFError(f"{self.path}: short read ({done} of "
                                   f"{row_bytes} bytes at offset {off})")
                done += got
        return ntime_keep

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)


RawSource = Union[str, GuppiRaw]


def open_raw(src: RawSource) -> GuppiRaw:
    """A :class:`GuppiRaw` passes through; a path opens that file."""
    return src if isinstance(src, GuppiRaw) else GuppiRaw(src)


def write_raw(path: str, header: Dict, blocks: Sequence[np.ndarray],
              directio: bool = False) -> None:
    """Write a GUPPI RAW file; ``blocks`` are int8 ``(obsnchan, ntime,
    npol, 2)`` arrays, or any iterable of them (written as it yields, so
    a generator writes a large file block by block).  Per-block headers
    come from ``header`` with ``BLOCSIZE``/``PKTIDX`` updated."""
    hdr = dict(header)
    hdr["DIRECTIO"] = 1 if directio else 0
    pktidx = int(hdr.get("PKTIDX", 0))
    with open(path, "wb") as f:
        for blk in blocks:
            if blk.dtype != np.int8 or blk.ndim != 4 or blk.shape[3] != 2:
                raise ValueError("write_raw: blocks must be int8 (nchan, ntime, npol, 2)")
            nchan, ntime, npol, _ = blk.shape
            hdr["OBSNCHAN"] = nchan
            hdr["NPOL"] = 4 if npol == 2 else npol
            hdr["NBITS"] = 8
            hdr["BLOCSIZE"] = blk.nbytes
            hdr["PKTIDX"] = pktidx
            pktidx += ntime - int(hdr.get("OVERLAP", 0))
            cards = b"".join(_format_card(k, v) for k, v in hdr.items())
            cards += "END".ljust(CARD_LEN).encode("ascii")
            f.write(cards)
            if directio:
                f.write(b"\x00" * ((-len(cards)) % DIRECTIO_ALIGN))
            f.write(np.ascontiguousarray(blk).tobytes())
