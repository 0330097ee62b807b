"""The recorder packet front end: UDP datagrams in, whole GUPPI RAW
blocks out.

Counterpart of ``blit/stream/packet.py``, with the same wire format, so
packets encoded by one package decode in the other.

**Framing.**  A HEADER packet carries the session's GUPPI header cards
(OBSNCHAN / NPOL / NBITS / BLOCSIZE / TBIN / OVERLAP fix the block
geometry), DATA packets carry an int8 tile placed by ``(chan0, time0)``
into block ``block``, and a FIN packet declares the block count.  The
32-byte header is ``!4sBBHQIIIHH`` (magic ``BLPK``, version, type,
reserved, pktidx, block, chan0, time0, nchan, ntime); payloads are
C-order ``(nchan, ntime, npol, 2)`` int8, the RAW block layout.

**Gaps.**  :class:`PacketAssembler` emits only complete blocks.  Once
packets arrive ``reorder_horizon`` blocks past an incomplete one (or FIN
lands) it is abandoned: ``packet.gap`` counted, and its sequence number
put in :attr:`PacketAssembler.gapped`, the proof
:class:`~blit_torch.stream.plane.LiveRawStream` masks the seat on at
once.  A gapped block is masked to zero weight, never delivered
partial, so the product equals the batch reduction of the recording
with those blocks zero-filled.  ``packet.late`` / ``packet.dup`` /
``packet.reorder`` count stragglers, duplicate tiles and pktidx
regressions; first packet to complete block lands in the
``packet.assembly_s`` histogram.

**Sources.**  :class:`PacketSource` binds a UDP socket (``SO_RCVBUF``
from :func:`blit_torch.config.packet_defaults`) and drains it inside
``get()``; :class:`PacketReplaySource` replays an at-rest recording as
its packet stream at ``rate`` times its cadence, with seeded drop /
``drop_blocks`` / reorder / dup schedules.  Both feed the same
assembler.  Every received packet fires the ``packet.recv`` fault point
(``drop`` / ``dup`` / ``delay`` / ``fail`` / ``reorder``); every
abandoned block counts ``packet.gap`` in :mod:`blit_torch.faults`.
"""

from __future__ import annotations

import io
import logging
import socket
import struct
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from blit_torch import faults, observability
from blit_torch.config import DEFAULT, SiteConfig, packet_defaults
from blit_torch.io.guppi import CARD_LEN, block_ntime, read_raw_header
from blit_torch.observability import Timeline
from blit_torch.stream.source import ChunkSource, StreamChunk

log = logging.getLogger("blit_torch.stream")

MAGIC = b"BLPK"
VERSION = 1
PKT_DATA, PKT_HEADER, PKT_FIN = 0, 1, 2
# magic, version, ptype, reserved, pktidx, block, chan0, time0, nchan,
# ntime — 32 bytes, network order.
_HDR = struct.Struct("!4sBBHQIIIHH")
HEADER_BYTES = _HDR.size


def encode_packet(ptype: int, pktidx: int, block: int = 0,
                  chan0: int = 0, time0: int = 0, nchan: int = 0,
                  ntime: int = 0, payload: bytes = b"") -> bytes:
    return _HDR.pack(MAGIC, VERSION, ptype, 0, pktidx, block, chan0,
                     time0, nchan, ntime) + payload


def decode_packet(data: bytes) -> Tuple[Dict, bytes]:
    """``(fields, payload)`` of one datagram.  Raises ``ValueError`` on
    anything that is not a well-formed blit packet — a capture socket
    shares its port with whatever else the network sends."""
    if len(data) < HEADER_BYTES:
        raise ValueError(f"short packet: {len(data)} bytes")
    magic, ver, ptype, _, pktidx, block, chan0, time0, nchan, ntime = (
        _HDR.unpack_from(data))
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise ValueError(f"unsupported packet version {ver}")
    return ({"ptype": ptype, "pktidx": pktidx, "block": block,
             "chan0": chan0, "time0": time0, "nchan": nchan,
             "ntime": ntime}, data[HEADER_BYTES:])


def _header_cards(hdr: Dict) -> bytes:
    from blit_torch.io.guppi import _format_card

    cards = b"".join(_format_card(k, v) for k, v in hdr.items()
                     if not k.startswith("_"))
    return cards + "END".ljust(CARD_LEN).encode("ascii")


def _parse_header_cards(payload: bytes) -> Dict:
    hdr, _ = read_raw_header(io.BytesIO(payload))
    return hdr


def _npol(hdr: Dict) -> int:
    return 2 if hdr["NPOL"] > 2 else hdr["NPOL"]


class PacketFramer:
    """Split a session's blocks into DATA packet tiles: all-channel
    strips of ``packet_ntime`` time samples (optionally split again
    into ``packet_nchan``-channel tiles).  The framing is the session
    sender's and the replay source's SHARED schedule — and the
    assembler accepts any tiling, so a real recorder's geometry needs
    no code change, only different ``(chan0, time0, nchan, ntime)``."""

    def __init__(self, header: Dict, packet_ntime: Optional[int] = None,
                 packet_nchan: Optional[int] = None,
                 config: SiteConfig = DEFAULT):
        d = packet_defaults(config)
        self.header = dict(header)
        self.nchan = int(header["OBSNCHAN"])
        self.ntime = block_ntime(header)
        self.npol = _npol(header)
        pt = d["ntime"] if packet_ntime is None else int(packet_ntime)
        self.packet_ntime = max(1, min(pt, self.ntime, 0xFFFF))
        pc = self.nchan if packet_nchan is None else int(packet_nchan)
        self.packet_nchan = max(1, min(pc, self.nchan, 0xFFFF))

    def tiles(self) -> List[Tuple[int, int, int, int]]:
        """``(chan0, time0, nchan, ntime)`` per DATA packet of one
        block, in send order (time-major, like the recorder writes)."""
        out = []
        for t0 in range(0, self.ntime, self.packet_ntime):
            nt = min(self.packet_ntime, self.ntime - t0)
            for c0 in range(0, self.nchan, self.packet_nchan):
                nc = min(self.packet_nchan, self.nchan - c0)
                out.append((c0, t0, nc, nt))
        return out

    def packets_per_block(self) -> int:
        return len(self.tiles())

    def data_packet(self, pktidx: int, block: int, data: np.ndarray,
                    tile: Tuple[int, int, int, int]) -> bytes:
        c0, t0, nc, nt = tile
        payload = np.ascontiguousarray(
            data[c0:c0 + nc, t0:t0 + nt]).tobytes()
        return encode_packet(PKT_DATA, pktidx, block, c0, t0, nc, nt,
                             payload)

    def header_packet(self, pktidx: int) -> bytes:
        return encode_packet(PKT_HEADER, pktidx,
                             payload=_header_cards(self.header))

    def fin_packet(self, pktidx: int, total_blocks: int) -> bytes:
        return encode_packet(PKT_FIN, pktidx, block=total_blocks)


def packets_of(raw, packet_ntime: Optional[int] = None,
               packet_nchan: Optional[int] = None) -> Iterator[bytes]:
    """A completed recording as its full packet stream (HEADER, every
    DATA tile in send order, FIN) — the loopback test sender and the
    simplest way to feed a :class:`PacketSource` a whole session."""
    from blit_torch.io.guppi import open_raw

    raw = raw if hasattr(raw, "nblocks") else open_raw(raw)
    fr = PacketFramer(raw.header(0), packet_ntime, packet_nchan)
    pktidx = 0
    yield fr.header_packet(pktidx)
    pktidx += 1
    for b in range(raw.nblocks):
        data = raw.read_block(b)
        for tile in fr.tiles():
            yield fr.data_packet(pktidx, b, data, tile)
            pktidx += 1
    yield fr.fin_packet(pktidx, raw.nblocks)


class PacketAssembler:
    """Datagrams → complete :class:`StreamChunk` blocks (module
    docstring).  Single-threaded by design: both sources call
    :meth:`feed` and :meth:`pop` from the consumer's pull loop, so the
    accounting needs no lock."""

    def __init__(self, *, path: str = "<packets>",
                 reorder_horizon: Optional[int] = None,
                 timeline: Optional[Timeline] = None,
                 clock=time.monotonic,
                 config: SiteConfig = DEFAULT):
        d = packet_defaults(config)
        self.path = path
        self.horizon = (d["horizon_blocks"] if reorder_horizon is None
                        else int(reorder_horizon))
        self.timeline = timeline if timeline is not None else Timeline()
        self._clock = clock
        self.header: Optional[Dict] = None
        self._shape: Optional[Tuple[int, int, int, int]] = None
        self._blocsize = 0
        # block → (buffer, {tile keys placed}, bytes_filled, t_first)
        self._partial: Dict[int, list] = {}
        self._complete: deque = deque()
        self._done: set = set()     # delivered or abandoned block idxs
        self._scan = 0              # lowest block not yet resolved
        self.gapped: set = set()    # abandoned — the plane's mask proof
        self.total: Optional[int] = None
        self.fin = False
        self._max_pktidx = -1
        self._max_block = -1
        self._preheader: List[bytes] = []
        # Fault-injected reorder holdback: [(release_after, datagram)].
        self._held: List[list] = []
        self._dumped = False
        self.packets = 0
        self.reorders = 0
        self.late = 0
        self.dups = 0
        self.bad = 0

    # -- receive ----------------------------------------------------------
    def feed(self, datagram: bytes) -> None:
        """Account and place one datagram; releases any fault-held
        packets whose holdback expired."""
        self._feed_one(datagram, held=False)
        if self._held:
            release = [h[1] for h in self._held if h[0] <= 0]
            self._held = [h for h in self._held if h[0] > 0]
            for d in release:
                self._feed_one(d, held=True)

    def _feed_one(self, datagram: bytes, held: bool) -> None:
        try:
            f, payload = decode_packet(datagram)
        except ValueError as e:
            self.bad += 1
            self.timeline.count("packet.bad")
            log.warning("%s: undecodable packet dropped (%s)",
                        self.path, e)
            return
        if not held:
            for h in self._held:
                h[0] -= 1
            act = faults.fire("packet.recv",
                              key=f"{self.path}#pkt{f['pktidx']}")
            if act is not None:
                if act.mode == "drop":
                    log.warning("injected drop of packet %d", f["pktidx"])
                    return
                if act.mode == "dup":
                    self._feed_one(datagram, held=True)
                elif act.mode == "reorder":
                    depth = act.amount if act.amount > 0 else 3
                    log.warning("injected reorder of packet %d "
                                "(held back %d packets)", f["pktidx"],
                                depth)
                    self._held.append([depth, datagram])
                    return
        self.packets += 1
        self.timeline.count("packet.recv")
        if f["pktidx"] < self._max_pktidx:
            self.reorders += 1
            self.timeline.count("packet.reorder")
        else:
            self._max_pktidx = f["pktidx"]
        if f["ptype"] == PKT_HEADER:
            self._on_header(payload)
        elif f["ptype"] == PKT_FIN:
            self._on_fin(f["block"])
        else:
            self._on_data(f, payload)

    def _on_header(self, payload: bytes) -> None:
        if self.header is not None:
            return  # a re-sent template: idempotent
        hdr = _parse_header_cards(payload)
        if hdr.get("NBITS", 8) != 8:
            raise NotImplementedError(
                f"NBITS={hdr['NBITS']} not supported (GBT uses 8)")
        self.header = hdr
        self._shape = (hdr["OBSNCHAN"], block_ntime(hdr), _npol(hdr), 2)
        self._blocsize = int(np.prod(self._shape))
        replay, self._preheader = self._preheader, []
        for d in replay:
            self._feed_one(d, held=True)

    def _on_fin(self, total: int) -> None:
        # Release anything fault-held first: the wire is done, nothing
        # more will overtake a held packet — judging gaps before
        # delivering it would fabricate one.
        release, self._held = [h[1] for h in self._held], []
        for d in release:
            self._feed_one(d, held=True)
        self.fin = True
        self.total = total
        self._max_block = max(self._max_block, total - 1)
        self._resolve_through(total - 1, "end of session")

    def _on_data(self, f: Dict, payload: bytes) -> None:
        if self.header is None:
            # Data before the template (a dropped/late HEADER packet):
            # hold a bounded replay buffer rather than losing the tiles.
            if len(self._preheader) < 65536:
                self._preheader.append(
                    encode_packet(PKT_DATA, f["pktidx"], f["block"],
                                  f["chan0"], f["time0"], f["nchan"],
                                  f["ntime"], payload))
            return
        b = f["block"]
        if b in self._done:
            # The seat was already delivered or abandoned: too late.
            self.late += 1
            self.timeline.count("packet.late")
            return
        nchan, ntime = f["nchan"], f["ntime"]
        want = nchan * ntime * self._shape[2] * 2
        if (len(payload) != want
                or f["chan0"] + nchan > self._shape[0]
                or f["time0"] + ntime > self._shape[1]):
            self.bad += 1
            self.timeline.count("packet.bad")
            log.warning("%s: packet %d payload/geometry mismatch "
                        "(%d bytes for a %d-byte tile); dropped",
                        self.path, f["pktidx"], len(payload), want)
            return
        if b > self._max_block:
            self._max_block = b
        st = self._partial.get(b)
        if st is None:
            st = [np.zeros(self._shape, np.int8), set(), 0,
                  self._clock()]
            self._partial[b] = st
        key = (f["chan0"], f["time0"])
        if key in st[1]:
            self.dups += 1
            self.timeline.count("packet.dup")
            return
        st[1].add(key)
        tile = np.frombuffer(payload, np.int8).reshape(
            nchan, ntime, self._shape[2], 2)
        st[0][f["chan0"]:f["chan0"] + nchan,
              f["time0"]:f["time0"] + ntime] = tile
        st[2] += want
        if st[2] >= self._blocsize:
            del self._partial[b]
            self._done.add(b)
            self.timeline.observe("packet.assembly_s",
                                  self._clock() - st[3])
            hdr = dict(self.header)
            hdr["PKTIDX"] = int(self.header.get("PKTIDX", 0)) + b * (
                self._shape[1] - int(self.header.get("OVERLAP", 0)))
            self._complete.append(StreamChunk(b, hdr, st[0]))
        self._sweep()

    def _sweep(self) -> None:
        """Abandon blocks the stream has provably moved past: packets
        arrived for blocks ``horizon`` beyond them, so their missing
        tiles — or the WHOLE block, if not one packet landed — are a
        GAP, not reordering still in flight."""
        self._resolve_through(
            self._max_block - self.horizon,
            f"packets arrived ≥{self.horizon} blocks past it "
            f"(the reorder horizon)")

    def _resolve_through(self, limit: int, why: str) -> None:
        """Every block ≤ ``limit`` must now be complete or a gap — a
        low-water scan, so each block is judged exactly once."""
        while self._scan <= limit:
            b = self._scan
            self._scan += 1
            if b not in self._done:
                self._abandon(b, why)

    def _abandon(self, b: int, why: str) -> None:
        st = self._partial.pop(b, None)
        got = 0 if st is None else st[2]
        self._done.add(b)
        self.gapped.add(b)
        self.timeline.count("packet.gap")
        faults.incr("packet.gap")
        rec = observability.flight_recorder()
        rec.event("packet", "gap", block=b, path=self.path,
                  bytes_missing=self._blocsize - got)
        rec.dump(
            f"packet gap: block {b} of {self.path} incomplete "
            f"({got}/{self._blocsize} bytes) — {why}; the block will "
            "be masked to zero weight, never delivered partial",
            force=not self._dumped)
        self._dumped = True
        log.warning("%s: block %d abandoned with %d/%d bytes (%s); "
                    "masked downstream", self.path, b, got,
                    self._blocsize, why)

    # -- deliver ----------------------------------------------------------
    def pop(self) -> Optional[StreamChunk]:
        return self._complete.popleft() if self._complete else None

    @property
    def drained(self) -> bool:
        return self.fin and not self._complete

    def report(self) -> Dict:
        """The packet-plane counters for session/bench reports."""
        h = self.timeline.hist_quantiles(["packet.assembly_s"]).get(
            "packet.assembly_s", {})
        return {
            "packets": self.packets,
            "gaps": len(self.gapped),
            "gapped_blocks": sorted(self.gapped),
            "reorders": self.reorders,
            "late": self.late,
            "dups": self.dups,
            "bad": self.bad,
            "assembly_p50_s": h.get("p50"),
            "assembly_p99_s": h.get("p99"),
        }


class PacketSource(ChunkSource):
    """UDP packet capture as a :class:`ChunkSource` (module docstring).
    Binds ``host:port`` (``port=0`` = ephemeral, read it back from
    :attr:`port`), sizes ``SO_RCVBUF`` from
    :func:`blit_torch.config.packet_defaults`, and drains the socket inside
    ``get()`` — no receiver thread, so back-pressure is the kernel
    buffer and anything beyond it sheds as packet loss → gaps → masked
    blocks, never a stalled recorder."""

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None, *,
                 rcvbuf: Optional[int] = None,
                 reorder_horizon: Optional[int] = None,
                 timeline: Optional[Timeline] = None,
                 clock=time.monotonic,
                 config: SiteConfig = DEFAULT):
        d = packet_defaults(config)
        host = d["host"] if host is None else host
        port = d["port"] if port is None else int(port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self._sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_RCVBUF,
                d["rcvbuf_bytes"] if rcvbuf is None else int(rcvbuf))
        except OSError:  # pragma: no cover — a host policy cap is fine
            pass
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self.path = f"udp://{host}:{self.port}"
        self.timeline = timeline if timeline is not None else Timeline()
        self.assembler = PacketAssembler(
            path=self.path, reorder_horizon=reorder_horizon,
            timeline=self.timeline, clock=clock, config=config)
        self.gapped = self.assembler.gapped
        self._clock = clock
        self._closed = False

    def get(self, timeout: float) -> Optional[StreamChunk]:
        if self.finished:
            return None
        deadline = self._clock() + timeout
        while True:
            c = self.assembler.pop()
            if c is not None:
                return c
            if self.assembler.drained or self._closed:
                self.finished = True
                self.total = self.assembler.total
                return None
            now = self._clock()
            if now >= deadline:
                return None
            self._sock.settimeout(max(0.001, deadline - now))
            try:
                data, _ = self._sock.recvfrom(65535)
            except socket.timeout:
                return None
            except OSError:
                if self._closed:  # closed mid-recv by another thread
                    self.finished = True
                    return None
                raise
            self.assembler.feed(data)
            # Drain the burst non-blocking: a recorder sends packet
            # trains, and one datagram per get() would fall behind.
            self._sock.settimeout(0)
            try:
                while True:
                    data, _ = self._sock.recvfrom(65535)
                    self.assembler.feed(data)
            except (BlockingIOError, socket.timeout):
                pass

    def packet_report(self) -> Dict:
        return self.assembler.report()

    def stop(self) -> None:
        self._closed = True
        super().stop()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class PacketReplaySource(ChunkSource):
    """Replay an at-rest recording as its PACKET stream at ``rate``×
    recording cadence, with seeded drop/reorder/dup schedules (module
    docstring).  The deterministic twin of :class:`PacketSource` for
    tests/CI/bench: same framing, same assembler, same gap discipline —
    only the socket is replaced by a paced schedule.

    ``drop`` is a fraction of DATA packets (seeded uniform) or an
    explicit pktidx iterable; ``drop_blocks`` drops EVERY packet of the
    named blocks (the deterministic whole-block gap the zero-filled
    oracle pins); ``reorder`` is a fraction of DATA packets each
    deferred ``reorder_depth`` send slots; ``dup`` re-sends a fraction
    a few slots later.  All schedules are pure functions of ``seed``."""

    def __init__(self, raw, *, rate: float = 1.0,
                 packet_ntime: Optional[int] = None,
                 packet_nchan: Optional[int] = None,
                 drop: object = None,
                 drop_blocks=None,
                 reorder: float = 0.0,
                 reorder_depth: int = 4,
                 dup: float = 0.0,
                 seed: int = 0,
                 reorder_horizon: Optional[int] = None,
                 timeline: Optional[Timeline] = None,
                 clock=time.monotonic, sleep=time.sleep,
                 config: SiteConfig = DEFAULT):
        import random

        from blit_torch.io.guppi import open_raw

        self.raw = raw if hasattr(raw, "nblocks") else open_raw(raw)
        self.path = getattr(self.raw, "path", "<packet-replay>")
        if rate <= 0:
            raise ValueError(f"replay rate must be > 0, got {rate}")
        self.rate = rate
        self._clock = clock
        self._sleep = sleep
        self.timeline = timeline if timeline is not None else Timeline()
        self.assembler = PacketAssembler(
            path=self.path, reorder_horizon=reorder_horizon,
            timeline=self.timeline, clock=clock, config=config)
        self.gapped = self.assembler.gapped
        hdr0 = self.raw.header(0)
        self._framer = PacketFramer(hdr0, packet_ntime, packet_nchan,
                                    config=config)
        tbin = float(hdr0.get("TBIN", 0.0) or 0.0)
        drop_blocks = set(drop_blocks or ())
        rng = random.Random(seed)
        # The nominal send order: HEADER, every block's tiles, FIN —
        # pktidx IS this order, so a deferred packet arrives with a
        # lower pktidx than its neighbours (a true reorder).
        nominal: List[Tuple[int, float, Optional[int],
                            Optional[tuple]]] = []
        pktidx = 0
        nominal.append((pktidx, 0.0, None, None))  # HEADER, due at t=0
        pktidx += 1
        cum = 0
        tiles = self._framer.tiles()
        for b in range(self.raw.nblocks):
            cum += self.raw.block_ntime_kept(b)
            due = cum * tbin / rate
            for tile in tiles:
                nominal.append((pktidx, due, b, tile))
                pktidx += 1
        fin_idx = pktidx
        drop_set = set()
        if drop is not None:
            if isinstance(drop, float):
                drop_set = {i for i, _, b, _ in nominal
                            if b is not None and rng.random() < drop}
            else:
                drop_set = {int(i) for i in drop}
        sched: List[Tuple[float, int, Tuple]] = []
        slot = 0
        for idx, due, b, tile in nominal:
            if b is not None and (idx in drop_set or b in drop_blocks):
                continue
            slot += 1
            pos = slot
            if b is not None and reorder and rng.random() < reorder:
                pos += max(1, int(reorder_depth))
            sched.append((due, pos, (idx, b, tile)))
            if b is not None and dup and rng.random() < dup:
                sched.append((due, pos + 2, (idx, b, tile)))
        # FIN sorts after every deferred/duplicated packet sharing its
        # due time — a schedule must never strand a reorder past the
        # end of the session (the assembler would call it a gap).
        sched.append((nominal[-1][1] if nominal else 0.0, float("inf"),
                      (fin_idx, None, "FIN")))
        # Due time first, deferred send slot second: a deferred packet
        # genuinely arrives after whatever overtook it.
        self._sched = sorted(sched, key=lambda e: (e[0], e[1]))
        self._pos = 0
        self._t0: Optional[float] = None
        self._nblocks = self.raw.nblocks
        self._cache: Dict[int, np.ndarray] = {}

    def _block(self, b: int) -> np.ndarray:
        data = self._cache.get(b)
        if data is None:
            data = self.raw.read_block(b)
            self._cache[b] = data
            # Reorder depth is small: a handful of blocks covers every
            # deferred tile without holding the recording in RAM.
            for old in sorted(self._cache):
                if len(self._cache) <= 4:
                    break
                if old != b:
                    del self._cache[old]
        return data

    def _emit(self, entry: Tuple) -> None:
        idx, b, tile = entry
        if tile == "FIN":
            self.assembler.feed(
                self._framer.fin_packet(idx, self._nblocks))
        elif b is None:
            self.assembler.feed(self._framer.header_packet(idx))
        else:
            self.assembler.feed(
                self._framer.data_packet(idx, b, self._block(b), tile))

    def get(self, timeout: float) -> Optional[StreamChunk]:
        if self.finished:
            return None
        deadline = self._clock() + timeout
        while True:
            c = self.assembler.pop()
            if c is not None:
                return c
            if self._pos >= len(self._sched):
                self.finished = True
                self.total = self.assembler.total
                return None
            if self._t0 is None:
                self._t0 = self._clock()
            due = self._sched[self._pos][0]
            wait = due - (self._clock() - self._t0)
            if wait > 0:
                if self._clock() + wait > deadline:
                    self._sleep(max(0.0, deadline - self._clock()))
                    return None
                self._sleep(wait)
            self._emit(self._sched[self._pos][2])
            self._pos += 1

    def packet_report(self) -> Dict:
        return self.assembler.report()
