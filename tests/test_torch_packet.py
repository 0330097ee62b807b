"""The port's packet front end (blit_torch.stream.packet) held against
blit.stream.packet on the CPU, after tests/test_packet.py.

Packets encoded by either package decode and assemble in the other into
the recording's blocks, byte for byte.  Under the same seeded drop /
drop_blocks / reorder / dup schedules and packet.recv fault rules the
two assemblers report the same counters and gapped blocks; the port's
product equals its batch reduction of the recording with the gapped
blocks zero-filled, byte for byte, and agrees with blit's to blit's f32
bound with the same masked seats.  One case captures over UDP loopback.
"""

import os
import signal
import socket
import threading

import numpy as np
import pytest

from blit import faults as bfaults
from blit import stream as bstream
from blit.config import packet_defaults as bpacket_defaults
from blit.config import slo_defaults as bslo_defaults
from blit.io.guppi import open_raw as bopen_raw
from blit.io.guppi import write_raw
from blit.observability import Timeline as BTimeline
from blit.pipeline import RawReducer as BRawReducer
from blit.stream import packet as bpacket
from blit.testing import synth_raw
from blit_torch import faults
from blit_torch import stream as tstream
from blit_torch.config import packet_defaults, slo_defaults
from blit_torch.io.guppi import open_raw
from blit_torch.io.sigproc import read_fil, read_fil_header
from blit_torch.observability import Timeline
from blit_torch.pipeline import RawReducer
from blit_torch.stream import packet as tpacket

NFFT = 256
NINT = 2
CHUNK_FRAMES = 4
DEADLINE_S = 60


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    monkeypatch.setenv("BLIT_FLIGHT_DIR", str(tmp_path / "flight"))
    os.makedirs(str(tmp_path / "flight"), exist_ok=True)
    yield
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()


def _synth(path, nblocks=4):
    return synth_raw(str(path), nblocks=nblocks, obsnchan=2,
                     ntime_per_block=(8 + 3) * NFFT, overlap=NFFT, seed=1,
                     tone_chan=1)


def _port(**kw):
    return RawReducer(nfft=NFFT, nint=NINT, chunk_frames=CHUNK_FRAMES,
                      device="cpu", **kw)


def _blit(**kw):
    return BRawReducer(nfft=NFFT, nint=NINT, chunk_frames=CHUNK_FRAMES, **kw)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _untimed(rep):
    return {k: v for k, v in rep.items() if not k.endswith("_s")}


def _assemble(asm_cls, packets):
    asm = asm_cls()
    for p in packets:
        asm.feed(p)
    out = []
    while (c := asm.pop()) is not None:
        out.append(c)
    return asm, out


@pytest.mark.parametrize("direction", ["port->blit", "blit->port"])
def test_packets_interchange(tmp_path, direction):
    raw = tmp_path / "r.raw"
    _synth(raw, nblocks=3)
    src_pkg, dst_pkg = ((tpacket, bpacket) if direction == "port->blit"
                        else (bpacket, tpacket))
    pkts = list(src_pkg.packets_of(str(raw), packet_ntime=64))
    other = list((dst_pkg.packets_of)(str(raw), packet_ntime=64))
    assert pkts == other  # the same bytes on the wire
    f, payload = dst_pkg.decode_packet(pkts[1])
    assert f == src_pkg.decode_packet(pkts[1])[0] and f["ptype"] == dst_pkg.PKT_DATA
    asm, got = _assemble(dst_pkg.PacketAssembler, pkts)
    rdr = bopen_raw(str(raw))
    assert [c.seq for c in got] == [0, 1, 2]
    for c in got:
        assert c.data.tobytes() == rdr.read_block(c.seq).tobytes()
        assert c.header == _assemble(src_pkg.PacketAssembler, pkts)[1][c.seq].header
    assert asm.report()["gaps"] == 0


def test_framing_refusals_match_blit():
    for pkg in (tpacket, bpacket):
        with pytest.raises(ValueError):
            pkg.decode_packet(b"short")
        bad = bytearray(pkg.encode_packet(pkg.PKT_FIN, 0))
        bad[4] = 99
        with pytest.raises(ValueError):
            pkg.decode_packet(bytes(bad))
    assert tpacket.encode_packet(tpacket.PKT_DATA, 42, 3, 1, 512, 1, 64, b"\x01") == \
        bpacket.encode_packet(bpacket.PKT_DATA, 42, 3, 1, 512, 1, 64, b"\x01")


SCHEDULES = {
    "clean": {},
    "drop_blocks": {"drop_blocks": [2]},
    "reorder_dup": {"reorder": 0.2, "dup": 0.1, "seed": 7},
    "fractional_drop": {"drop": 0.01, "seed": 1},
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_replay_schedules_match_blit_and_zero_filled_oracle(tmp_path, case):
    raw = tmp_path / "r.raw"
    hdr0, blocks = _synth(raw)
    kw = dict(rate=1e6, packet_ntime=64, **SCHEDULES[case])
    tl, btl = Timeline(), BTimeline()
    src = tstream.PacketReplaySource(str(raw), timeline=tl, **kw)
    bsrc = bstream.PacketReplaySource(str(raw), timeline=btl, **kw)
    p, b = tmp_path / "p.fil", tmp_path / "b.fil"
    hdr = tstream.stream_reduce(src, str(p), reducer=_port(timeline=tl),
                                lateness_s=5.0)
    bhdr = bstream.stream_reduce(bsrc, str(b), reducer=_blit(timeline=btl),
                                 lateness_s=5.0)
    rep, brep = src.packet_report(), bsrc.packet_report()
    assert _untimed(rep) == _untimed(brep)
    gapped = rep["gapped_blocks"]
    assert hdr.get("_masked_chunks", []) == gapped == bhdr.get("_masked_chunks", [])
    if case in ("drop_blocks", "fractional_drop"):
        assert gapped  # the schedule leaves a gap
    if case == "reorder_dup":
        assert rep["reorders"] > 0 and rep["dups"] > 0 and not gapped
    zb = [blk.copy() for blk in blocks]
    for i in gapped:
        zb[i][:] = 0
    write_raw(str(tmp_path / "z.raw"), hdr0, zb)
    _port().reduce_to_file(str(tmp_path / "z.raw"), str(tmp_path / "z.fil"))
    assert _read(p) == _read(tmp_path / "z.fil")
    _, off = read_fil_header(str(p))
    assert _read(p)[:off] == _read(b)[:off]
    (_, got), (_, want) = read_fil(str(p)), read_fil(str(b))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-2 * np.abs(want[..., :NFFT]).max())
    assert hdr["stream_degraded_spectra"] == bhdr["stream_degraded_spectra"]
    if gapped:
        assert tl.stages["stream.chunk.gap_fastpath"].calls == \
            btl.stages["stream.chunk.gap_fastpath"].calls >= 1
        assert faults.counters().get("packet.gap") == len(gapped)


@pytest.mark.parametrize("mode", ["reorder", "drop"])
def test_packet_recv_fault_drills_match_blit(tmp_path, mode):
    raw = tmp_path / "r.raw"
    _synth(raw)
    rule = dict(times=1, after=3 if mode == "reorder" else 6,
                amount=3 if mode == "reorder" else 0)
    faults.install(faults.FaultRule("packet.recv", mode, **rule))
    bfaults.install(bfaults.FaultRule("packet.recv", mode, **rule))
    src = tstream.PacketReplaySource(str(raw), rate=1e6, packet_ntime=64)
    bsrc = bstream.PacketReplaySource(str(raw), rate=1e6, packet_ntime=64)
    hdr = tstream.stream_reduce(src, str(tmp_path / "p.fil"),
                                reducer=_port(), lateness_s=5.0)
    bhdr = bstream.stream_reduce(bsrc, str(tmp_path / "b.fil"),
                                 reducer=_blit(), lateness_s=5.0)
    rep, brep = src.packet_report(), bsrc.packet_report()
    assert _untimed(rep) == _untimed(brep)
    assert rep["gaps"] == (1 if mode == "drop" else 0)
    assert hdr.get("_masked_chunks", []) == bhdr.get("_masked_chunks", []) == \
        rep["gapped_blocks"]
    assert faults.counters().get(f"fault.packet.recv.{mode}") == 1


def test_udp_loopback_capture_identical_to_batch(tmp_path):
    raw = tmp_path / "r.raw"
    _synth(raw, nblocks=3)
    _port().reduce_to_file(str(raw), str(tmp_path / "ref.fil"))
    src = tstream.PacketSource("127.0.0.1", 0)
    # blit's encoder is the sender: its packets land in the port's socket.
    pkts = list(bpacket.packets_of(str(raw), packet_ntime=64))

    def send():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for pkt in pkts:
            s.sendto(pkt, ("127.0.0.1", src.port))
        s.close()

    t = threading.Thread(target=send)
    t.start()
    out = tmp_path / "s.fil"
    hdr = tstream.stream_reduce(src, str(out), reducer=_port())
    t.join()
    src.close()
    assert hdr["stream_masked_chunks"] == 0
    assert src.packet_report()["packets"] == len(pkts)
    assert _read(out) == _read(tmp_path / "ref.fil")


def test_source_specs_and_defaults_match_blit(tmp_path, monkeypatch):
    raw = tmp_path / "r.raw"
    _synth(raw, nblocks=2)
    monkeypatch.setenv("BLIT_PACKET_PORT", "61234")
    monkeypatch.setenv("BLIT_PACKET_NTIME", "32")
    monkeypatch.setenv("BLIT_PACKET_HORIZON", "5")
    assert packet_defaults() == bpacket_defaults()
    monkeypatch.setenv("BLIT_SLO_PACKET_P99", "0.25")
    assert slo_defaults() == bslo_defaults()
    for kind in ("tail", "replay", "packet-replay"):
        spec = {"kind": kind, "raw": str(raw), "rate": 2.0}
        a = tstream.source_from_spec(spec)
        b = bstream.source_from_spec(spec)
        assert type(a).__name__ == type(b).__name__
        assert a.path == b.path
    with pytest.raises(ValueError, match="unknown source kind"):
        tstream.source_from_spec({"kind": "carrier-pigeon"})
    fr = tpacket.PacketFramer(open_raw(str(raw)).header(0))
    bfr = bpacket.PacketFramer(bopen_raw(str(raw)).header(0))
    assert fr.tiles() == bfr.tiles() and fr.packet_ntime == 32
