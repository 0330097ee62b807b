"""The RAM ring: rising sequence numbers, stamped headers, a clean stop."""

import threading
import time

import numpy as np

from conftest import REPO  # noqa: F401  (puts the repo on the path)
from portbench import synth
from portbench.ringsource import RamRing

CFG = {"obsnchan": 2, "npol": 2, "nbits": 8, "block_bytes": 2 * 2 * 2 * 16,
       "chan_bw_mhz": 2.9296875, "bank_bw_sign": -1, "band_centre_mhz": 6000.0,
       "banks": 8, "pool_blocks": 3}


def _ring(**kw):
    pool = [np.full((2, 16, 2, 2), i, np.int8) for i in range(3)]
    go = threading.Event()
    return RamRing(pool, synth.bank_header(CFG, 0), go, **kw), go


def test_rising_sequence_numbers_and_a_clean_stop():
    ring, go = _ring()
    assert ring.get(0.01) is None  # nothing before go
    go.set()
    got = [ring.get(0.1) for _ in range(7)]
    assert [c.seq for c in got] == list(range(7))
    assert [int(c.data[0, 0, 0, 0]) for c in got] == [0, 1, 2, 0, 1, 2, 0]
    pkts = CFG["block_bytes"] // 8192
    assert [c.header["PKTIDX"] for c in got] == [i * pkts for i in range(7)]
    ring.stop()
    assert ring.get(0.1) is None and ring.finished
    assert ring.delivered == 7


def test_limit_ends_the_stream_with_its_total():
    ring, go = _ring(limit=2)
    go.set()
    assert ring.get(0.1).seq == 0 and ring.get(0.1).seq == 1
    assert ring.get(0.1) is None
    assert ring.finished and ring.total == 2


def test_pace_delivers_on_schedule():
    ring, go = _ring(bank_gbps=64 / 0.05 / 1e9)  # a block every 50 ms
    go.set()
    t0 = time.monotonic()
    seqs = []
    while len(seqs) < 4:
        c = ring.get(0.5)
        if c is not None:
            seqs.append(c.seq)
    assert seqs == [0, 1, 2, 3]
    assert time.monotonic() - t0 >= 0.14


def test_bank_headers_tile_the_band():
    cfg = dict(CFG, obsnchan=64, banks=8)
    hdrs = [synth.bank_header(cfg, b) for b in range(8)]
    assert [h["OBSFREQ"] for h in hdrs] == [6000 + (3.5 - b) * 187.5
                                            for b in range(8)]
    assert all(h["OBSBW"] == -187.5 and h["NPOL"] == 4 for h in hdrs)


def test_same_seed_same_pool_and_banks_differ():
    cfg = dict(CFG, obsnchan=2, block_bytes=2 * 2 * 2 * 256, pool_blocks=2)
    sig = {"noise_rms": 8.0, "tone_amp": 20.0, "tone_chan": 1,
           "tone_freq": 0.375, "tone_drift": 0.0}
    seed = (1 << 31) + 11
    a = synth.bank_pool(cfg, sig, seed, 0, "cpu")
    b = synth.bank_pool(cfg, sig, seed, 0, "cpu")
    c = synth.bank_pool(cfg, sig, seed, 1, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert a[0].shape == (2, 256, 2, 2) and a[0].dtype == np.int8
