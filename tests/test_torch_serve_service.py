"""The port's ProductService, ProductRequest and Scheduler held against
``blit``'s.

Both packages serve the same seeded ``synth_raw`` recordings (2 coarse
channels, a tone in channel 1, channel 0 noise only): recipes and
fingerprints of every request kind must be byte-equal, products within
``blit``'s f32 bound (rtol 1e-4, atol 1e-2 of the noise channel's peak,
as ``tests/test_torch_pipeline.py``) with headers identical, hits in the
same cells (SNR and power within rtol 1e-4),
and the scheduler must admit, refuse and quote ``retry_after`` exactly as
``blit``'s does on a scripted sequence under an injected clock.  The
port's service reduces on ``device="cpu"``; without the argument it
takes the card and raises here.
"""

import dataclasses
import json
import signal
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from blit import faults as bfaults  # noqa: E402
from blit.observability import Timeline as BTimeline  # noqa: E402
from blit.serve import ProductCache as BCache  # noqa: E402
from blit.serve import ProductRequest as BRequest  # noqa: E402
from blit.serve import ProductService as BService  # noqa: E402
from blit.serve import Scheduler as BScheduler  # noqa: E402
from blit.serve.cache import fingerprint_for as bfingerprint_for  # noqa: E402
from blit.serve.scheduler import Overloaded as BOverloaded  # noqa: E402
from blit_torch import faults  # noqa: E402
from blit_torch.faults import FaultRule  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.search import hits_from_array  # noqa: E402
from blit_torch.serve import (  # noqa: E402
    Cancelled,
    Overloaded,
    ProductCache,
    ProductRequest,
    ProductService,
    Scheduler,
)
from blit_torch.serve.cache import fingerprint_for  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

NFFT = 128
NTIME = (8 + 3) * NFFT  # 8 PFB frames at ntap=4
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
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    yield
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("raw") / "a.raw")
    synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=4 * NTIME,
              tone_chan=1, tone_freq=0.125, seed=3)
    return p


def port_service(tmp_path=None, *, concurrency=4, queue_depth=16,
                 ram_bytes=1 << 24):
    tl = Timeline()
    return ProductService(
        cache=ProductCache(str(tmp_path / "port-cache") if tmp_path else None,
                           ram_bytes=ram_bytes, timeline=tl),
        scheduler=Scheduler(max_concurrency=concurrency,
                            queue_depth=queue_depth, timeline=tl),
        timeline=tl, device="cpu")


def blit_service():
    tl = BTimeline()
    return BService(cache=BCache(None, ram_bytes=1 << 24, timeline=tl),
                    scheduler=BScheduler(max_concurrency=2, queue_depth=16,
                                         timeline=tl),
                    timeline=tl)


# Every request kind and knob the recipe records.
KINDS = [
    dict(nfft=NFFT, nint=1),
    dict(nfft=NFFT, nint=4, stokes="IQUV"),
    dict(nfft=NFFT, nint=2, fqav_by=4),
    dict(nfft=NFFT, nint=1, dtype="bfloat16"),
    dict(product="0002"),
    dict(product="0001", stokes="XXYY"),
    dict(product="0000"),
    dict(kind="hits", nfft=NFFT, nint=1, window_spectra=8),
    dict(kind="hits", nfft=NFFT, nint=2, window_spectra=4,
         snr_threshold=6.0, top_k=3, max_drift_bins=2),
    dict(kind="hits", product="0002"),
]


@pytest.mark.parametrize("kw", KINDS, ids=lambda kw: json.dumps(kw))
def test_recipe_and_fingerprint_equal_blits(raw, kw):
    port, ref = ProductRequest(raw=raw, **kw), BRequest(raw=raw, **kw)
    assert json.dumps(port.recipe(), sort_keys=True) == json.dumps(
        ref.recipe(), sort_keys=True)
    assert ProductRequest.from_recipe(ref.recipe()) == port
    assert port.fingerprint() == bfingerprint_for(ref.reducer(),
                                                  ref.raw_source)
    assert fingerprint_for(port.reducer(device="cpu"),
                           port.raw_source) == port.fingerprint()


@pytest.mark.parametrize("kw", [
    dict(kind="stream", out="x.fil", session_s=10.0, replay_rate=2.0),
    dict(session="AGBT22B_999_01", scan="0001", band=1, bank=2),
    dict(kind="catalog"),
])
def test_other_kinds_recipes_equal_blits(kw):
    raw = "" if "session" in kw or kw.get("kind") == "catalog" else "a.raw"
    port, ref = ProductRequest(raw=raw, **kw), BRequest(raw=raw, **kw)
    assert port.recipe() == ref.recipe()
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("kw", [
    dict(product="0002", nfft=64),
    dict(kind="hits", nfft=NFFT, stokes="XX"),
    dict(nfft=NFFT, window_spectra=8),
    dict(nfft=NFFT, out="x.fil"),
])
def test_refusals_equal_blits(kw):
    with pytest.raises(ValueError):
        BRequest(raw="a.raw", **kw)
    with pytest.raises(ValueError):
        ProductRequest(raw="a.raw", **kw)


def test_service_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProductService()


@pytest.mark.parametrize("kw", [dict(nfft=NFFT, nint=1),
                                dict(nfft=NFFT, nint=4, stokes="IQUV"),
                                dict(nfft=NFFT, nint=2, fqav_by=4)],
                         ids=["I", "IQUV", "fqav"])
def test_products_within_blits_bound(raw, kw):
    svc, ref = port_service(), blit_service()
    try:
        hdr, data = svc.get(ProductRequest(raw=raw, **kw), timeout=50)
        bhdr, bdata = ref.get(BRequest(raw=raw, **kw), timeout=50)
    finally:
        svc.close()
        ref.close()
    assert hdr == bhdr
    assert data.shape == bdata.shape and data.dtype == bdata.dtype
    nchan = NFFT // kw.get("fqav_by", 1)
    atol = 1e-2 * float(np.abs(bdata[..., :nchan]).max())
    np.testing.assert_allclose(data, bdata, rtol=1e-4, atol=atol)
    assert not data.flags.writeable


def test_hits_equal_blits(raw):
    kw = dict(kind="hits", nfft=NFFT, nint=1, window_spectra=8,
              snr_threshold=3.0)
    svc, ref = port_service(), blit_service()
    try:
        hdr, data = svc.get(ProductRequest(raw=raw, **kw), timeout=50)
        bhdr, bdata = ref.get(BRequest(raw=raw, **kw), timeout=50)
    finally:
        svc.close()
        ref.close()
    assert hdr == bhdr
    assert len(hits_from_array(data, hdr)) > 0
    # The same cells (drift, channel, band, window) exactly; SNR and
    # power within the product bound (the spectra agree to f32 rounding).
    assert data.shape == bdata.shape
    np.testing.assert_array_equal(data[..., 2:], bdata[..., 2:])
    np.testing.assert_allclose(data[..., :2], bdata[..., :2], rtol=1e-4)


class TestSingleFlight:
    def test_eight_identical_asks_run_one_reduction(self, raw):
        # The delay on guppi.open holds the flight open until every ask
        # has been submitted; one open = one reduction.
        faults.install(FaultRule("guppi.open", "delay", times=-1,
                                 delay_s=0.5))
        svc = port_service()
        try:
            req = ProductRequest(raw=raw, nfft=NFFT, nint=2)
            tickets = [svc.submit(req, client=f"c{i}") for i in range(8)]
            results = [svc.result(t, timeout=50) for t in tickets]
        finally:
            svc.close()
        assert svc.counts["scheduled"] == 1
        assert svc.counts["coalesced"] == 7
        first = results[0][1]
        assert all(r[1] is first for r in results)
        assert [t.source for t in tickets] == ["derive"] * 8

    def test_cache_hit_never_opens_the_recording(self, raw, tmp_path):
        svc = port_service(tmp_path)
        try:
            req = ProductRequest(raw=raw, nfft=NFFT, nint=2)
            _, data = svc.get(req, timeout=50)
            faults.install(FaultRule("guppi.open", "fail", times=-1))
            t = svc.submit(req)
            assert t.source == "ram" and t.done
            assert np.array_equal(svc.result(t)[1], data)
        finally:
            svc.close()

    def test_failed_flight_is_not_poisoned(self, raw):
        faults.set_io_policy(faults.RetryPolicy(attempts=1))
        faults.install(FaultRule("guppi.open", "fail", times=1))
        svc = port_service()
        try:
            req = ProductRequest(raw=raw, nfft=NFFT, nint=2)
            with pytest.raises(OSError):
                svc.get(req, timeout=50)
            _, data = svc.get(req, timeout=50)
            assert data.shape[1:] == (1, 2 * NFFT)
        finally:
            svc.close()
            faults.set_io_policy(None)

    def test_cancelled_queued_ticket_releases_its_slot(self, raw):
        faults.install(FaultRule("guppi.open", "delay", times=1,
                                 delay_s=0.3))
        svc = port_service(concurrency=1, queue_depth=2)
        try:
            first = svc.submit(ProductRequest(raw=raw, nfft=NFFT, nint=1))
            queued = svc.submit(ProductRequest(raw=raw, nfft=NFFT, nint=2))
            assert svc.cancel(queued)
            with pytest.raises(Cancelled):
                svc.result(queued, timeout=5)
            svc.result(first, timeout=50)
            assert svc.scheduler.depth() == 0
        finally:
            svc.close()

    def test_drain_refuses_new_asks(self, raw):
        svc = port_service()
        try:
            svc.drain(timeout=5)
            with pytest.raises(Overloaded):
                svc.submit(ProductRequest(raw=raw, nfft=NFFT, nint=1))
        finally:
            svc.close()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(sched_cls, over_cls):
    """Admission, refusal and retry_after of one scheduler over a
    scripted sequence under an injected clock: fill the queues (jobs
    held by an event), refuse the overflow, advance the clock and read
    the wait estimates, then release."""
    clock = FakeClock()
    gate = threading.Event()
    sched = sched_cls(max_concurrency=1, queue_depth=3, clock=clock,
                      retry_seed=11)
    out = []
    jobs = []
    try:
        for i in range(9):
            try:
                job = sched.submit(lambda: gate.wait(10), priority=i % 2,
                                   client=f"c{i % 3}")
                jobs.append(job)
                out.append(("admitted", i, job.priority, sched.depth()))
            except over_cls as e:
                out.append(("refused", i, type(e).__name__,
                            round(e.retry_after_s, 9)))
            clock.t += 0.25
        for prio in (0, 1):
            out.append(("est_wait", prio, round(sched.est_wait_s(prio), 9)))
        out.append(("counts", dict(sched.counts)))
        out.append(("running", sched.running(), "budget",
                    sched.effective_budget()))
        sched.shed(0.5)
        try:
            sched.submit(lambda: None, priority=0, client="late")
            out.append(("admitted-shed",))
        except over_cls as e:
            out.append(("refused-shed", round(e.retry_after_s, 9)))
    finally:
        gate.set()
        for j in jobs:
            j.wait(10)
        sched.close(10)
    return out


def test_scheduler_decisions_equal_blits():
    assert _script(Scheduler, Overloaded) == _script(BScheduler, BOverloaded)
