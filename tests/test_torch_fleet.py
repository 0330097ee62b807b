"""The port's fleet (HashRing, FleetFrontDoor, PeerServer) held against
``blit``'s.

The ring places 1,000 fingerprints on the same owners and replicas as
``blit``'s at every membership and moves the same keys on a join or a
leave.  An in-process fleet of port peers (CPU services, RAM tiers,
heartbeat leases in a shared directory) serves products within
``blit``'s f32 bound of ``blit``'s own reduction, coalesces and caches
across the door, folds ``/healthz`` as ``blit``'s ``fold_health`` does,
and re-routes byte-identically when the owner stops beating.
"""

import hashlib
import signal
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from blit.monitor import fold_health as bfold_health  # noqa: E402
from blit.pipeline import RawReducer as BReducer  # noqa: E402
from blit.serve import HashRing as BRing  # noqa: E402
from blit_torch.monitor import fold_health  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.serve import (  # noqa: E402
    FleetFrontDoor,
    HashRing,
    PeerServer,
    ProductCache,
    ProductRequest,
    ProductService,
    Scheduler,
)
from blit_torch.testing import synth_raw  # noqa: E402

NFFT = 128
NTIME = (8 + 3) * NFFT
TTL = 0.6
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


KEYS = [hashlib.sha256(str(i).encode()).hexdigest() for i in range(1000)]


@pytest.mark.parametrize("peers", [
    ["peer0"], ["peer0", "peer1"], ["a", "b", "c"],
    [f"peer{i}" for i in range(7)],
])
@pytest.mark.parametrize("vnodes", [1, 16, 128])
def test_ring_owners_equal_blits(peers, vnodes):
    port, ref = HashRing(peers, vnodes=vnodes), BRing(peers, vnodes=vnodes)
    for n in (1, 2, 3):
        assert [port.owners(k, n) for k in KEYS] == [ref.owners(k, n)
                                                     for k in KEYS]
    assert port.spread(KEYS) == ref.spread(KEYS)


def test_ring_membership_changes_equal_blits():
    port, ref = HashRing(["p0", "p1", "p2"]), BRing(["p0", "p1", "p2"])
    assert port.incoming_keys("p3", KEYS) == ref.incoming_keys("p3", KEYS)
    assert port.departing_keys("p1", KEYS) == ref.departing_keys("p1", KEYS)
    assert port.remove("p1") and ref.remove("p1")
    assert not port.remove("p1")
    assert [port.owner(k) for k in KEYS] == [ref.owner(k) for k in KEYS]
    assert port.add("p9") and ref.add("p9")
    assert port.peers() == ref.peers() and len(port) == 3
    assert [port.owners(k, 2) for k in KEYS] == [ref.owners(k, 2) for k in KEYS]


@pytest.mark.parametrize("own,peers", [
    ([], {"a": {"ok": True}, "b": {"ok": True}}),
    (["draining"], {"a": {"ok": True}}),
    ([], {"a": None, "b": {"ok": False, "reasons": ["slo:x"]}}),
    ([], {"a": None}),
])
def test_fold_health_equals_blits(own, peers):
    clock = lambda: 123.0  # noqa: E731
    assert fold_health(own, peers, clock=clock) == bfold_health(
        own, peers, clock=clock)


class Fleet:
    """In-process port peers on the CPU beating leases, and a door."""

    def __init__(self, tmp_path, npeers=2, **door_kw):
        self.lease_dir = str(tmp_path / "leases")
        self.servers = {}
        peers = {}
        for i in range(npeers):
            name = f"peer{i}"
            tl = Timeline()
            svc = ProductService(
                cache=ProductCache(None, ram_bytes=1 << 24, timeline=tl),
                scheduler=Scheduler(max_concurrency=2, queue_depth=8,
                                    timeline=tl, retry_seed=i),
                timeline=tl, device="cpu")
            ps = PeerServer(svc, name=name, lease_dir=self.lease_dir,
                            proc=i, beat_interval_s=0.05).start()
            self.servers[name] = ps
            peers[name] = ps.url
        kw = dict(peer_ttl_s=TTL, poll_s=0.05, health_poll_s=0.2,
                  hedge_floor_s=5.0, request_timeout_s=50.0)
        kw.update(door_kw)
        self.timeline = Timeline()
        self.door = FleetFrontDoor(peers, lease_dir=self.lease_dir,
                                   timeline=self.timeline, **kw)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            self.door.observe()
            if all(p.watch.seen for p in self.door._peers.values()):
                break
            time.sleep(0.05)

    def close(self):
        self.door.close()
        for s in self.servers.values():
            try:
                s.close()
            except Exception:  # noqa: BLE001 — some die mid-test
                pass
            s.service.close(5)


@pytest.fixture
def fleet(tmp_path):
    f = Fleet(tmp_path)
    yield f
    f.close()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("raw") / "a.raw")
    synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=2 * NTIME,
              tone_chan=1, tone_freq=0.125, seed=9)
    return p


@pytest.mark.parametrize("kw", [dict(nfft=NFFT, nint=1),
                                dict(nfft=NFFT, nint=2, stokes="IQUV")],
                         ids=["I", "IQUV"])
def test_fleet_serves_blits_products(fleet, raw, kw):
    hdr, data = fleet.door.get(ProductRequest(raw=raw, **kw))
    bhdr, bdata = BReducer(async_output=False, **kw).reduce(raw)
    assert hdr == bhdr
    atol = 1e-2 * float(np.abs(bdata[..., :NFFT]).max())
    np.testing.assert_allclose(data, bdata, rtol=1e-4, atol=atol)
    # A repeat ask is a cache hit on the owner, byte-identical.
    hdr2, data2 = fleet.door.get(ProductRequest(raw=raw, **kw))
    assert hdr2 == hdr and data2.tobytes() == data.tobytes()
    served = {n: s.service.counts for n, s in fleet.servers.items()}
    assert sum(c["scheduled"] for c in served.values()) == 1
    assert sum(c["cache_hits"] for c in served.values()) == 1


def test_fleet_routes_to_the_rings_owner(fleet, raw):
    req = ProductRequest(raw=raw, nfft=NFFT, nint=4)
    fleet.door.get(req)
    owner = fleet.door.ring.owner(req.fingerprint())
    assert fleet.servers[owner].service.counts["scheduled"] == 1


def test_peer_kill_reroutes_byte_identically(fleet, raw):
    req = ProductRequest(raw=raw, nfft=NFFT, nint=1)
    hdr, data = fleet.door.get(req)
    owner = fleet.door.ring.owner(req.fingerprint())
    fleet.servers[owner].close()  # beats and answers stop
    deadline = time.monotonic() + 20
    while owner in fleet.door.ring and time.monotonic() < deadline:
        fleet.door.observe()
        time.sleep(0.05)
    assert owner not in fleet.door.ring
    assert fleet.timeline.report()["fleet.eject"]["calls"] == 1
    hdr2, data2 = fleet.door.get(req)
    assert hdr2 == hdr and data2.tobytes() == data.tobytes()
    doc = fleet.door.health()
    assert not doc["ok"] and any(owner in r for r in doc["reasons"])


def test_drain_refuses_then_door_fails_over(fleet, raw):
    req = ProductRequest(raw=raw, nfft=NFFT, nint=8)
    owner = fleet.door.ring.owner(req.fingerprint())
    fleet.servers[owner].drain(timeout=5)
    hdr, data = fleet.door.get(req)
    assert data.shape[0] > 0
    other = next(n for n in fleet.servers if n != owner)
    assert fleet.servers[other].service.counts["scheduled"] == 1


def test_door_health_and_stats(fleet):
    doc = fleet.door.health()
    assert doc["ok"] and doc["status"] == "ok" and doc["peers"] == 2
    st = fleet.door.stats()
    assert set(st["ring"]) == {"peer0", "peer1"}
