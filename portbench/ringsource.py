"""The general traffic generator: a recorder's RAM ring as a live chunk
source of the port.

Each bank's blocks sit in host RAM (:mod:`portbench.synth`).  The source
hands block ``i`` of the stream as chunk ``i`` (the pool's block ``i %
len(pool)``, ``PKTIDX`` stamped as the recorder would), under rising
sequence numbers, once ``go`` is set.  A traffic file sets the pace:
``bank_gbps`` null is a closed loop, the next block as soon as the
stream asks; a number delivers block ``i`` no earlier than ``i *
block_bytes / (bank_gbps * 1e9)`` seconds after the first.  ``stop()``
ends the stream after the chunks already handed over; ``limit`` ends it
after that many.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from blit_torch.stream.source import ChunkSource, StreamChunk


class RamRing(ChunkSource):
    def __init__(self, pool: List[np.ndarray], header: Dict,
                 go: threading.Event, *, bank_gbps: Optional[float] = None,
                 limit: Optional[int] = None, path: str = "<ram-ring>"):
        self.path = path
        self.finished = False
        self.total: Optional[int] = None
        self.delivered = 0
        self._pool = pool
        self._header = dict(header)
        self._pkts = header["BLOCSIZE"] // header["PKTSIZE"]
        self._go = go
        self._interval = (None if bank_gbps is None
                          else header["BLOCSIZE"] / (bank_gbps * 1e9))
        self._limit = limit
        self._t0: Optional[float] = None

    def get(self, timeout: float) -> Optional[StreamChunk]:
        if self.finished:
            return None
        if not self._go.wait(timeout):
            return None
        seq = self.delivered
        if self._limit is not None and seq >= self._limit:
            self.finished = True
            self.total = seq
            return None
        if self._interval is not None:
            now = time.monotonic()
            if self._t0 is None:
                self._t0 = now
            wait = self._t0 + seq * self._interval - now
            if wait > timeout:
                time.sleep(timeout)
                return None
            if wait > 0:
                time.sleep(wait)
        hdr = dict(self._header)
        hdr["PKTIDX"] = seq * self._pkts
        self.delivered = seq + 1
        return StreamChunk(seq, hdr, self._pool[seq % len(self._pool)])
