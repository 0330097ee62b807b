"""The port's content-addressed ProductCache held against ``blit``'s.

Fingerprints over the same recording are byte-equal for every knob
(``fft_method`` included: the port's DedopplerReducer takes it, as
``blit``'s does), and the disk tier is interchangeable: an entry the
port publishes loads in ``blit``'s cache and the reverse, with the FBH5
bytes and the meta sidecar equal.  The RAM tier's byte budget, the
encoded-wire tier, the cold tier and the ``cache.publish`` fault point
behave as ``blit``'s.
"""

import json
import os
import signal

import numpy as np
import pytest

pytest.importorskip("jax")

from blit import faults as bfaults  # noqa: E402
from blit.search import DedopplerReducer as BDedoppler  # noqa: E402
from blit.serve import ProductCache as BCache  # noqa: E402
from blit.serve.cache import fingerprint_for as bfingerprint_for  # noqa: E402
from blit.serve.cache import reduction_fingerprint as breduction_fp  # noqa: E402
from blit.serve.http import encode_product_wire as bencode_wire  # noqa: E402
from blit_torch import faults  # noqa: E402
from blit_torch.faults import FaultRule  # noqa: E402
from blit_torch.search import DedopplerReducer  # noqa: E402
from blit_torch.serve import ProductCache  # noqa: E402
from blit_torch.serve.cache import (  # noqa: E402
    fingerprint_for,
    reduction_fingerprint,
)
from blit_torch.serve.http import decode_product_wire  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

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
def clean_faults():
    faults.clear()
    faults.reset_counters()
    yield
    faults.clear()
    faults.reset_counters()
    bfaults.clear()


@pytest.fixture(scope="module")
def raws(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    out = []
    for i in range(3):
        p = str(d / f"scan.{i:04d}.raw")
        synth_raw(p, nblocks=1, obsnchan=2, ntime_per_block=4096, seed=i)
        out.append(p)
    return out


@pytest.mark.parametrize("kw", [
    dict(nfft=64, nint=1),
    dict(nfft=1024, nint=8, ntap=8, stokes="IQUV", window="hann"),
    dict(nfft=64, nint=2, fqav_by=4, dtype="bfloat16"),
    dict(nfft=64, nint=1, fft_method="direct"),
    dict(nfft=64, nint=1, extra={"search": {"window_spectra": 8}}),
])
def test_reduction_fingerprint_equal_blits(raws, kw):
    assert reduction_fingerprint(raws[0], **kw) == breduction_fp(raws[0], **kw)
    # Member order does not change a multi-file identity.
    assert reduction_fingerprint(raws[::-1], **kw) == breduction_fp(raws, **kw)


def test_fingerprint_refuses_a_missing_member(tmp_path):
    with pytest.raises(OSError):
        reduction_fingerprint(str(tmp_path / "nope.raw"), nfft=64, nint=1)


@pytest.mark.parametrize("fft_method", ["auto", "direct", "four_step"])
def test_dedoppler_fft_method_is_a_knob_and_a_key(raws, fft_method):
    port = DedopplerReducer(nfft=64, window_spectra=8, fft_method=fft_method,
                            device="cpu")
    ref = BDedoppler(nfft=64, window_spectra=8, fft_method=fft_method)
    assert port.fft_method == fft_method
    assert port._red.fft_method == fft_method
    assert (port.stokes, port.fqav_by) == (ref.stokes, ref.fqav_by)
    assert fingerprint_for(port, raws[0]) == bfingerprint_for(ref, raws[0])


def test_dedoppler_fft_method_changes_the_key(raws):
    a = DedopplerReducer(nfft=64, window_spectra=8, device="cpu")
    b = DedopplerReducer(nfft=64, window_spectra=8, fft_method="direct",
                         device="cpu")
    assert fingerprint_for(a, raws[0]) != fingerprint_for(b, raws[0])


def _product(seed=0, nsamps=6, nchans=64):
    rng = np.random.default_rng(seed)
    hdr = {"nchans": nchans, "nifs": 1, "nbits": 32, "fch1": 1500.0,
           "foff": -0.1, "tsamp": 1e-3, "tstart": 60000.5,
           "source_name": "SYNTH", "data_type": 1}
    return hdr, rng.standard_normal((nsamps, 1, nchans)).astype(np.float32)


RECIPE = {"raw": "a.raw", "nfft": 64, "nint": 1, "stokes": "I",
          "fqav_by": 1, "dtype": "float32", "kind": "filterbank"}


@pytest.mark.parametrize("direction", ["port-to-blit", "blit-to-port"])
def test_disk_entries_interchange(tmp_path, direction):
    hdr, data = _product()
    fp = "ab" * 32
    pa, pb = str(tmp_path / "port"), str(tmp_path / "blit")
    ProductCache(pa, ram_bytes=0).put(fp, hdr, data, recipe=RECIPE)
    BCache(pb, ram_bytes=0).put(fp, hdr, data, recipe=RECIPE)
    # The published files are the same bytes either way.
    with open(os.path.join(pa, fp + ".json")) as f:
        ma = json.load(f)
    with open(os.path.join(pb, fp + ".json")) as f:
        mb = json.load(f)
    assert ma == mb
    with open(os.path.join(pa, fp + ".h5"), "rb") as f:
        ha = f.read()
    with open(os.path.join(pb, fp + ".h5"), "rb") as f:
        hb = f.read()
    assert ha == hb
    reader = (BCache(pa, ram_bytes=0) if direction == "port-to-blit"
              else ProductCache(pb, ram_bytes=0))
    got = reader.get(fp)
    assert got is not None and got[2] == "disk"
    assert np.array_equal(got[1], data)
    assert got[0]["nchans"] == hdr["nchans"]
    assert reader.verify_entry(fp) is True


class TestTiers:
    def test_ram_budget_evicts_lru(self):
        hdr, data = _product(nsamps=16, nchans=64)  # 4 KiB
        c = ProductCache(None, ram_bytes=3 * data.nbytes)
        for i in range(4):
            c.put(f"fp{i}", hdr, data)
        assert c.get("fp0") is None
        assert [c.get(f"fp{i}")[2] for i in (1, 2, 3)] == ["ram"] * 3
        st = c.stats()
        assert st["ram_entries"] == 3 and st["ram_bytes_used"] <= c.ram_bytes

    def test_put_returns_a_read_only_copy(self):
        hdr, data = _product()
        c = ProductCache(None, ram_bytes=1 << 20)
        out = c.put("fp", hdr, data)
        assert not out.flags.writeable and data.flags.writeable
        data[:] = 0
        assert not np.array_equal(c.get("fp")[1], data)

    def test_wire_tier_serves_blits_frame(self, tmp_path):
        hdr, data = _product()
        c = ProductCache(str(tmp_path / "c"), ram_bytes=1 << 20)
        c.put("fp", hdr, data)
        body = bencode_wire(hdr, data)
        c.put_wire("fp", bytes(body))
        got, tier = c.get_wire("fp")
        assert tier == "ram" and bytes(got) == bytes(body)
        h2, d2 = decode_product_wire(got)
        assert np.array_equal(d2, data) and h2["nchans"] == hdr["nchans"]
        # The disk form survives a fresh cache over the same root.
        fresh = ProductCache(str(tmp_path / "c"), ram_bytes=1 << 20)
        got, tier = fresh.get_wire("fp")
        assert tier == "disk" and bytes(got) == bytes(body)

    def test_publish_fault_downgrades_to_ram(self, tmp_path):
        hdr, data = _product()
        c = ProductCache(str(tmp_path / "c"), ram_bytes=1 << 20)
        faults.install(FaultRule("cache.publish", "fail", times=1))
        c.put("fp", hdr, data)
        assert c.stats()["publish.error"] == 1
        assert c.get("fp")[2] == "ram"
        assert not os.path.exists(c.data_path("fp"))
        assert c.index() == []

    def test_corrupt_disk_entry_is_evicted_as_a_miss(self, tmp_path):
        hdr, data = _product()
        root = str(tmp_path / "c")
        ProductCache(root, ram_bytes=0).put("fp", hdr, data, recipe=RECIPE)
        path = os.path.join(root, "fp.h5")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) - 8)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        c = ProductCache(root, ram_bytes=0)
        assert c.get("fp") is None
        assert c.stats()["evict.corrupt"] == 1

    def test_cold_tier_demotes_and_promotes(self, tmp_path):
        hdr, data = _product()
        c = ProductCache(str(tmp_path / "hot"), ram_bytes=0,
                         disk_bytes=int(data.nbytes * 1.5),
                         cold_dir=str(tmp_path / "cold"))
        c.put("fp0", hdr, data, recipe=RECIPE)
        c.put("fp1", hdr, data + 1, recipe=RECIPE)
        assert c.stats()["demote.cold"] >= 1
        got = c.get("fp0")
        assert got is not None and got[2] == "cold"
        assert np.array_equal(got[1], data)
        assert c.stats()["promote.cold"] >= 1
