"""The port's fleet wire held against ``blit``'s.

The ``BLW1`` binary frame and the legacy JSON+base64 frame must be
byte-equal from both packages on the same products (every dtype the
serve plane ships, big- and little-endian, empty products, deflate),
each package must decode the other's, and both must refuse the same
torn or hostile frames with ``WireError``.  Wire request documents, the
trace headers and ``retry_after_from`` agree too, and a port peer
answers ``blit``'s client over HTTP.
"""

import json
import signal

import numpy as np
import pytest

pytest.importorskip("jax")

from blit.serve import ProductRequest as BRequest  # noqa: E402
from blit.serve import http as bhttp  # noqa: E402
from blit_torch.serve import ProductRequest  # noqa: E402
from blit_torch.serve import http as thttp  # noqa: E402

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


HDR = {"nchans": 16, "nifs": 1, "nbits": 32, "fch1": 1500.0, "foff": -0.5,
       "tsamp": 1e-3, "tstart": 60000.25, "source_name": "SYNTH",
       "_masked_blocks": [1, 3], "search_nchans": 16}


def _arrays():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((4, 1, 16))
    return {
        "f32": base.astype(np.float32),
        "f32-big": base.astype(">f4"),
        "f64": base,
        "u8": (rng.integers(0, 255, (4, 1, 16))).astype(np.uint8),
        "i16": (rng.integers(-999, 999, (3, 4, 16))).astype(np.int16),
        "empty": np.zeros((0, 1, 16), np.float32),
        "hits": rng.standard_normal((7, 1, 8)).astype(np.float32),
    }


ARRAYS = _arrays()


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_binary_frames_equal_blits(name):
    data = ARRAYS[name]
    a = thttp.encode_product_wire(HDR, data)
    b = bhttp.encode_product_wire(HDR, data)
    assert a == b and a[:4] == b"BLW1"
    pa, ba = thttp.encode_product_parts(HDR, data)
    assert pa + bytes(ba) == a
    for dec, buf in ((thttp.decode_product_wire, b),
                     (bhttp.decode_product_wire, a)):
        h, d = dec(buf)
        assert h == HDR and d.dtype == data.dtype and d.shape == data.shape
        assert np.array_equal(d, data) and not d.flags.writeable


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_json_frames_equal_blits(name):
    data = ARRAYS[name]
    a = thttp.encode_product(HDR, data)
    b = bhttp.encode_product(HDR, data)
    assert json.dumps(a) == json.dumps(b)
    for dec, doc in ((thttp.decode_product, b), (bhttp.decode_product, a)):
        h, d = dec(json.loads(json.dumps(doc)))
        assert h == HDR and np.array_equal(d, data)


def test_deflate_frames_equal_blits():
    data = ARRAYS["u8"]
    a = thttp.encode_product_wire(HDR, data, deflate=True)
    assert a == bhttp.encode_product_wire(HDR, data, deflate=True)
    h, d = thttp.decode_product_wire(a, encoding="deflate")
    assert np.array_equal(d, data)


def _torn(frame):
    good = bytearray(frame)
    meta_n = int.from_bytes(good[4:8], "big")
    huge = bytearray(good)
    huge[4:8] = (thttp.WIRE_MAX_META + 1).to_bytes(4, "big")
    return {
        "magic": b"BLW2" + bytes(good[4:]),
        "short": bytes(good[:6]),
        "meta-cut": bytes(good[:8 + meta_n // 2]),
        "payload-cut": bytes(good[:-3]),
        "payload-long": bytes(good) + b"\0",
        "huge-meta": bytes(huge),
        "bad-json": bytes(good[:8]) + b"{" * meta_n + bytes(good[8 + meta_n:]),
    }


@pytest.mark.parametrize("what", sorted(_torn(b"BLW1" + (2).to_bytes(4, "big")
                                              + b"{}")))
def test_both_refuse_the_same_frames(what):
    frame = thttp.encode_product_wire(HDR, ARRAYS["f32"])
    bad = _torn(frame)[what]
    with pytest.raises(thttp.WireError):
        thttp.decode_product_wire(bad)
    with pytest.raises(bhttp.WireError):
        bhttp.decode_product_wire(bad)


def test_unknown_encoding_refused():
    with pytest.raises(thttp.WireError):
        thttp.decode_product_wire(b"xx", encoding="br")


@pytest.mark.parametrize("kw", [
    dict(nfft=64, nint=2),
    dict(product="0002", stokes="IQUV"),
    dict(kind="hits", nfft=64, window_spectra=8, top_k=2),
    dict(session="AGBT22B_999_01", scan="0007", band=0, bank=1),
])
def test_wire_requests_equal_blits(kw):
    raw = "" if "session" in kw else ("a.0000.raw", "a.0001.raw")
    a = thttp.wire_request(ProductRequest(raw=raw, **kw), priority=0,
                           client="x", deadline_s=2.5)
    b = bhttp.wire_request(BRequest(raw=raw, **kw), priority=0,
                           client="x", deadline_s=2.5)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    req, prio, client, dl = thttp.request_from_wire(
        json.loads(json.dumps(b)))
    assert req.recipe() == ProductRequest(raw=raw, **kw).recipe()
    assert (prio, client, dl) == (0, "x", 2.5)


def test_live_sessions_refuse_the_wire():
    with pytest.raises(ValueError):
        thttp.wire_request(ProductRequest(raw="a.raw", kind="stream",
                                          out="x.fil"))


def test_trace_headers_equal_blits():
    ctx = {"trace": "abc.1", "span": "abc.2"}
    for kw in (dict(), dict(hedge=True), dict(rid="r.9"),
               dict(hedge=True, rid="r.9")):
        assert thttp.trace_headers(ctx, **kw) == bhttp.trace_headers(ctx, **kw)
    hdrs = {k.lower(): v for k, v in thttp.trace_headers(ctx).items()}
    assert thttp.trace_context_from(hdrs) == ctx
    assert thttp.trace_context_from({}) is None
    assert (thttp.TIER_HEADER, thttp.WIRE_CTYPE, thttp.WIRE_MAGIC) == (
        bhttp.TIER_HEADER, bhttp.WIRE_CTYPE, bhttp.WIRE_MAGIC)


@pytest.mark.parametrize("headers,body", [
    ({"retry-after": "3"}, {}),
    ({}, {"retry_after_s": 0.75}),
    ({"retry-after": "bogus"}, {"retry_after_s": 2.0}),
    ({}, "not json"),
])
def test_retry_after_from_equals_blits(headers, body):
    assert thttp.retry_after_from(headers, body) == bhttp.retry_after_from(
        headers, body)


def test_blits_client_reads_a_port_peer(tmp_path):
    """A port PeerServer (CPU service, RAM cache) answers ``blit``'s
    wire helpers: the binary product, the JSON product, /healthz."""
    from blit_torch.serve import ProductCache, ProductService
    from blit_torch.testing import synth_raw

    raw = str(tmp_path / "a.raw")
    synth_raw(raw, nblocks=1, obsnchan=2, ntime_per_block=4096, seed=2)
    svc = ProductService(cache=ProductCache(None, ram_bytes=1 << 24),
                         device="cpu")
    server = thttp.PeerServer(svc, name="p0").start()
    try:
        doc = bhttp.wire_request(BRequest(raw=raw, nfft=64, nint=2))
        st, hdrs, body = bhttp.http_request(
            "POST", server.url, "/product", body=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json",
                     "Accept": bhttp.WIRE_CTYPE}, timeout=30)
        assert st == 200
        assert hdrs["content-type"].startswith(bhttp.WIRE_CTYPE)
        h, d = bhttp.decode_product_wire(body)
        st, hdrs, body = bhttp.http_request(
            "POST", server.url, "/product", body=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"}, timeout=30)
        assert st == 200 and hdrs[thttp.TIER_HEADER.lower()] == "ram"
        h2, d2 = bhttp.decode_product(json.loads(body))
        assert h2 == h and np.array_equal(d2, d)
        st, _, health = bhttp.http_json("GET", server.url, "/healthz")
        assert st == 200 and health["ok"]
    finally:
        server.close()
        svc.close()
