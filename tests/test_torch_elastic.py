"""The port's elastic FleetController held against ``blit``'s.

Two in-process fleets, one of each package (two peers and two
standbys, heartbeat leases), are driven by the same scripted burn: a
real BurnRateEvaluator fed alternating fast-burn and idle intervals
under an injected clock, then a run of idle ticks.  Both controllers
must take the same actions on the same peers in the same order (scale
out the same standby, suppress the same flaps, scale in the same
peer).  Each port test waits on lease beats and explicit ticks, never
on a sleep of its own length.
"""

import signal
import time
import types

import pytest

pytest.importorskip("jax")

import blit.monitor as bmonitor  # noqa: E402
import blit.observability as bobs  # noqa: E402
import blit.serve as bserve  # noqa: E402
import blit_torch.monitor as tmonitor  # noqa: E402
import blit_torch.observability as tobs  # noqa: E402
import blit_torch.serve as tserve  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

TTL = 0.6
DEADLINE_S = 60

PORT = types.SimpleNamespace(serve=tserve, monitor=tmonitor, obs=tobs,
                             svc_kw={"device": "cpu"})
BLIT = types.SimpleNamespace(serve=bserve, monitor=bmonitor, obs=bobs,
                             svc_kw={})


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class ElasticFleet:
    """In-process peers + standbys of one package and a door, driven by
    explicit observe() ticks."""

    def __init__(self, pkg, tmp_path, npeers=2, nstandby=1):
        S = pkg.serve
        self.pkg = pkg
        self.lease_dir = str(tmp_path / "leases")
        self.servers = {}
        peers = {}
        names = [f"peer{i}" for i in range(npeers)]
        names += [f"standby{j}" for j in range(nstandby)]
        for i, name in enumerate(names):
            tl = pkg.obs.Timeline()
            svc = S.ProductService(
                cache=S.ProductCache(None, ram_bytes=1 << 24, timeline=tl),
                scheduler=S.Scheduler(max_concurrency=2, queue_depth=8,
                                      timeline=tl, retry_seed=i),
                timeline=tl, **pkg.svc_kw)
            ps = S.PeerServer(svc, name=name, lease_dir=self.lease_dir,
                              proc=i, beat_interval_s=0.05).start()
            self.servers[name] = ps
            if not name.startswith("standby"):
                peers[name] = ps.url
        self.timeline = pkg.obs.Timeline()
        self.door = S.FleetFrontDoor(
            peers, lease_dir=self.lease_dir, timeline=self.timeline,
            peer_ttl_s=TTL, poll_s=0.05, health_poll_s=0.2,
            hedge_floor_s=5.0, request_timeout_s=50.0)
        for j in range(nstandby):
            nm = f"standby{j}"
            self.door.add_standby(nm, self.servers[nm].url, proc=npeers + j)
        self.ctl = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            self.door.observe()
            if all(p.watch.fresh() for p in self.door._peers.values()):
                break
            time.sleep(0.05)

    def controller(self, evaluator=None, **kw):
        kw.setdefault("hysteresis_s", 0.0)
        kw.setdefault("warm_timeout_s", 30.0)
        kw.setdefault("min_peers", 1)
        self.ctl = self.pkg.serve.FleetController(self.door, evaluator, **kw)
        return self.ctl

    def close(self):
        if self.ctl is not None:
            self.ctl.close()
        self.door.close()
        for s in self.servers.values():
            try:
                s.close()
            except Exception:  # noqa: BLE001 — some die mid-test
                pass
            s.service.close(5)


def burn_delta(pkg, bad: bool):
    tl = pkg.obs.Timeline()
    for _ in range(10):
        tl.observe("fleet.request_s", 1.0 if bad else 0.001)
    return tl


def scripted_burn(pkg, tmp_path):
    """The action log of one package's controller over the script."""
    M = pkg.monitor
    fleet = ElasticFleet(pkg, tmp_path, npeers=2, nstandby=2)
    try:
        ev = M.BurnRateEvaluator(
            [M.SLObjective("slo", "fleet.request_s", 0.5, budget=0.05)],
            fast_window=2, slow_window=4, fast_burn=4.0, slow_burn=2.0)
        fake = [1000.0]
        ctl = fleet.controller(evaluator=ev, hysteresis_s=100.0,
                               idle_windows=2, clock=lambda: fake[0])
        log = []
        # Alternating burn and idle for one hysteresis window, a lapse,
        # one more page, then sustained idle past the next window.
        script = [i % 2 == 0 for i in range(10)] + [True]
        script += [False] * 8
        for i, bad in enumerate(script):
            if i == 10:
                fake[0] = 1000.0 + 150.0
            fleet.door.observe()  # the door's liveness loop, one tick
            ev.observe(burn_delta(pkg, bad), 1.0)
            act = ctl.observe(interval_s=30.0)
            if act is not None:
                log.append((i, act["action"], act["peer"],
                            act.get("hinted"), act.get("acked"),
                            act.get("drained")))
            fake[0] += 10.0 if i < 10 else 60.0
        rep = fleet.timeline.report()
        log.append(("suppressed", rep["elastic.flap_suppressed"]["calls"]))
        log.append(("ring", sorted(fleet.door.ring.peers())))
        return log
    finally:
        fleet.close()


def test_controller_decisions_equal_blits(tmp_path):
    port = scripted_burn(PORT, tmp_path / "port")
    ref = scripted_burn(BLIT, tmp_path / "blit")
    assert port == ref
    actions = [a[1] for a in port if isinstance(a[0], int)]
    assert "scale-out" in actions and "scale-in" in actions


@pytest.fixture
def efleet(tmp_path):
    f = ElasticFleet(PORT, tmp_path)
    yield f
    f.close()


def make_req(tmp_path, i=0):
    p = str(tmp_path / f"r{i}.raw")
    synth_raw(p, nblocks=1, obsnchan=2, ntime_per_block=11 * 128, seed=i)
    return tserve.ProductRequest(raw=p, nfft=128, nint=1)


class TestPortController:
    def test_standby_serves_nothing_until_admitted(self, efleet, tmp_path):
        assert "standby0" not in efleet.door.ring
        for i in range(3):
            efleet.door.get(make_req(tmp_path, i))
        sb = efleet.door._peers["standby0"]
        assert sb.standby and not sb.in_ring and sb.requests == 0
        assert efleet.servers["standby0"].counts["product"] == 0
        doc = efleet.door.health()
        assert doc["ok"] and "standby0" in doc.get("standbys", [])

    def test_scale_out_admits_the_standby_warm(self, efleet, tmp_path):
        ctl = efleet.controller()
        reqs = [make_req(tmp_path, i) for i in range(6)]
        for r in reqs:
            efleet.door.get(r)
            efleet.door.get(r)
        efleet.door.observe()  # the door's liveness loop, one tick
        rec = ctl.scale_out()
        assert rec["action"] == "scale-out" and rec["peer"] == "standby0"
        assert "standby0" in efleet.door.ring and rec["acked"]
        cache = efleet.servers["standby0"].service.cache
        moved = [r for r in reqs
                 if efleet.door.ring.owner(r.fingerprint()) == "standby0"]
        assert rec["completed"] == rec["hinted"] == len(moved)
        assert all(cache.contains(r.fingerprint()) for r in moved)

    def test_min_peers_floor_refuses(self, efleet):
        ctl = efleet.controller(min_peers=2, idle_windows=1)
        for _ in range(3):
            assert ctl.observe(interval_s=30.0) is None
        assert ctl.scale_in() is None
        assert len(efleet.door.ring) == 2

    def test_traffic_resets_the_idle_run(self, efleet, tmp_path):
        ctl = efleet.controller(idle_windows=3, idle_rps=0.0)
        ctl.observe(interval_s=30.0)
        ctl.observe(interval_s=30.0)
        assert ctl._idle_ticks == 2
        efleet.door.get(make_req(tmp_path))
        ctl.observe(interval_s=30.0)
        assert ctl._idle_ticks == 0

    def test_door_healthz_is_resizing_mid_flip(self, efleet):
        ctl = efleet.controller()
        ctl._set_resizing("scale-out:standby0")
        doc = efleet.door.health()
        assert doc["status"] == "resizing" and not doc["ok"]
        ctl._set_resizing(None)
        assert efleet.door.health()["status"] == "ok"
