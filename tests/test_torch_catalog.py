"""The port's archive catalog held against ``blit``'s.

Both CatalogIndex implementations crawl the same seeded observation tree
(two scans of two players, two RAW members each, plus a malformed
player directory): every lookup document, every resolved member list
and every catalog fingerprint must be equal, misses must raise
``CatalogMiss`` in both, and a catalog-addressed ask must resolve to
the same recipe, fingerprint and product as the explicit-path ask, in
the service and through a fleet door.
"""

import json
import os
import signal

import numpy as np
import pytest

pytest.importorskip("jax")

from blit.serve import ProductRequest as BRequest  # noqa: E402
from blit.serve.cache import fingerprint_for as bfingerprint_for  # noqa: E402
from blit.serve.catalog import CatalogIndex as BIndex  # noqa: E402
from blit.serve.catalog import CatalogMiss as BMiss  # noqa: E402
from blit.serve.catalog import catalog_fingerprint as bcatalog_fp  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.serve import (  # noqa: E402
    FleetFrontDoor,
    PeerServer,
    ProductCache,
    ProductRequest,
    ProductService,
)
from blit_torch.serve.catalog import (  # noqa: E402
    CatalogIndex,
    CatalogMiss,
    catalog_fingerprint,
)
from blit_torch.testing import build_observation_tree  # noqa: E402

SESSION = "AGBT25A_999_01"
NFFT = 64
RAW_NTIME = 6 * NFFT
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


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("archive"))
    build_observation_tree(root, SESSION, scans=("0001", "0002"),
                           players=((0, 0), (0, 1)), kind="raw",
                           nchans=2, raw_ntime=RAW_NTIME, nfiles=2)
    # A malformed player directory the corrected PLAYER_RE rejects.
    os.makedirs(os.path.join(root, SESSION, "GUPPI", "BLP0x"))
    return root


@pytest.fixture(scope="module")
def indexes(archive):
    return (CatalogIndex(archive, rescan_s=0.0),
            BIndex(archive, rescan_s=0.0))


@pytest.mark.parametrize("query", [(), (SESSION,), (SESSION, "0001"),
                                   (SESSION, "0002")])
def test_lookup_documents_equal_blits(indexes, query):
    port, ref = indexes
    a, b = port.lookup(*query), ref.lookup(*query)
    a.pop("generation", None)
    b.pop("generation", None)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("scan,band,bank", [("0001", 0, 0), ("0001", 0, 1),
                                            ("0002", 0, 1)])
def test_resolve_equals_blits(indexes, scan, band, bank):
    port, ref = indexes
    assert port.resolve(SESSION, scan, band=band, bank=bank) == ref.resolve(
        SESSION, scan, band=band, bank=bank)


@pytest.mark.parametrize("session,scan", [("AGBT25A_999_09", "0001"),
                                          (SESSION, "0099")])
def test_misses_raise_in_both(indexes, session, scan):
    port, ref = indexes
    with pytest.raises(CatalogMiss):
        port.resolve(session, scan, band=0, bank=0)
    with pytest.raises(BMiss):
        ref.resolve(session, scan, band=0, bank=0)


@pytest.mark.parametrize("query", ["", SESSION, f"{SESSION}/0001", "x/y"])
def test_catalog_fingerprints_equal_blits(query):
    assert catalog_fingerprint(query) == bcatalog_fp(query)


def test_served_catalog_answer_equals_blits(indexes):
    port, ref = indexes
    (ha, da), (hb, db) = port.serve(SESSION), ref.serve(SESSION)
    ha.pop("generation", None)
    hb.pop("generation", None)
    assert ha == hb and da.shape == db.shape == (0, 1, 0)


def test_addressed_recipe_equals_the_explicit_one(archive, indexes):
    port, ref = indexes
    members = port.resolve(SESSION, "0001", band=0, bank=1)
    explicit = ProductRequest(raw=tuple(members), nfft=NFFT, nint=1)
    bexplicit = BRequest(raw=tuple(members), nfft=NFFT, nint=1)
    assert explicit.recipe() == bexplicit.recipe()
    assert explicit.fingerprint() == bfingerprint_for(
        bexplicit.reducer(), bexplicit.raw_source)
    svc = ProductService(cache=ProductCache(None, ram_bytes=1 << 24),
                         catalog=port, device="cpu")
    try:
        addressed = ProductRequest(raw="", session=SESSION, scan="0001",
                                   band=0, bank=1, nfft=NFFT, nint=1)
        resolved = svc.resolve_request(addressed)
        assert resolved.fingerprint() == explicit.fingerprint()
        _, a = svc.get(addressed, timeout=50)
        t = svc.submit(explicit)
        assert t.source == "ram"
        assert svc.result(t)[1].tobytes() == a.tobytes()
        doc, empty = svc.get(ProductRequest(raw=f"{SESSION}/0001",
                                            kind="catalog"), timeout=10)
        assert sorted(doc["members"]) == ["00", "01"] and empty.size == 0
    finally:
        svc.close()


def test_door_resolves_before_routing(archive, tmp_path):
    tl = Timeline()
    svc = ProductService(cache=ProductCache(None, ram_bytes=1 << 24,
                                            timeline=tl),
                         timeline=tl, device="cpu")
    peer = PeerServer(svc, name="peer0").start()
    door = FleetFrontDoor({"peer0": peer.url},
                          catalog=CatalogIndex(archive, rescan_s=0.0),
                          request_timeout_s=50.0)
    try:
        _, a = door.get(ProductRequest(raw="", session=SESSION, scan="0002",
                                       band=0, bank=0, nfft=NFFT, nint=2))
        members = door.catalog.resolve(SESSION, "0002", band=0, bank=0)
        _, b = door.get(ProductRequest(raw=tuple(members), nfft=NFFT,
                                       nint=2))
        assert a.tobytes() == b.tobytes()
        assert svc.counts["scheduled"] == 1 and svc.counts["cache_hits"] == 1
        assert np.isfinite(a).all()
        with pytest.raises(CatalogMiss):
            door.get(ProductRequest(raw="", session=SESSION, scan="0077",
                                    band=0, bank=0, nfft=NFFT, nint=2))
    finally:
        door.close()
        peer.close()
        svc.close()
