"""The port's fault registry held against blit's, and its points in the
port's I/O.

The same spec, armed in both packages and driven through the same
sequence of hits, must fire on the same hit counts with the same
outcome; the retry policy's seeded delays and the circuit breaker's
states must agree.  Then the points themselves: a transient
``guppi.read`` / ``guppi.open`` failure is retried and the product does
not change; a ``sink.write`` / ``sink.flush`` failure fails the product
and publishes nothing.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from blit import faults as bfaults  # noqa: E402
from blit_torch import faults  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.io.guppi import GuppiRaw  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402

NO_SLEEP = dict(sleep=lambda s: None)


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    yield
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
        f.set_io_policy(None)


def _outcomes(mod, spec, calls):
    """Arm ``spec`` and record, for each ``(point, key)`` hit, what fired:
    'raise', a returned rule's mode, or None."""
    mod.clear()
    rules = mod.parse_spec(spec)
    for r in rules:
        r.sleep = lambda s: None
    mod.install(*rules)
    out = []
    for point, key in calls:
        try:
            r = mod.fire(point, key=key)
            out.append(None if r is None else r.mode)
        except OSError:
            out.append("raise")
    fired = [(r.point, r.mode, r.hits, r.fired) for r in rules]
    counts = {k: v for k, v in mod.counters().items() if k.startswith("fault.")}
    mod.clear()
    return out, fired, counts


SPECS = [
    "guppi.read:fail:2",
    "guppi.read:fail:2:after=3",
    "guppi.read:corrupt:times=-1:match=ant1",
    "guppi.read:truncate:1:after=2:amount=5;guppi.read:fail:times=-1:after=4",
    "sink.write:delay:3:delay=0.5;sink.write:fail:1:after=2",
    "guppi.open:drop:2;sink.flush:dup:1;x.y:reorder:times=-1:after=1",
]


@pytest.mark.parametrize("spec", SPECS)
def test_rules_fire_on_the_same_hits_as_blit(spec):
    points = ["guppi.read", "sink.write", "guppi.open", "sink.flush", "x.y"]
    keys = ["/d/ant0.raw", "/d/ant1.raw", None]
    calls = [(points[i % 5], keys[i % 3]) for i in range(40)]
    calls += [("guppi.read", keys[i % 3]) for i in range(12)]
    want = _outcomes(bfaults, spec, calls)
    got = _outcomes(faults, spec, calls)
    assert got == want
    assert any(o is not None for o in got[0])


def test_parse_spec_matches_blit_and_refuses_the_same():
    spec = "guppi.read:fail:2:match=ant1:message=boom;sink.write:hang:hang=60"
    fields = ("point", "mode", "times", "after", "match", "message", "delay_s",
              "hang_s", "amount")
    for a, b in zip(faults.parse_spec(spec), bfaults.parse_spec(spec)):
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    for bad in ("guppi.read", "guppi.read:explode", "guppi.read:fail:k=1"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
        with pytest.raises(ValueError):
            bfaults.parse_spec(bad)
    assert faults.MODES == bfaults.MODES


def test_retry_policy_and_breaker_match_blit():
    for seed in (None, 0, 7):
        kw = dict(attempts=5, base_s=0.01, max_s=0.05, seed=seed)
        a, b = faults.RetryPolicy(**kw), bfaults.RetryPolicy(**kw)
        if seed is not None:
            assert [a.delay_s(k) for k in range(6)] == [b.delay_s(k) for k in range(6)]
    clock = [0.0]
    states = []
    for mod in (faults, bfaults):
        clock[0] = 0.0
        br = mod.CircuitBreaker(threshold=2, cooldown_s=5.0, clock=lambda: clock[0])
        seq = []
        for step in ("f", "f", "a", "t", "a", "a", "f", "t", "a", "s", "a"):
            if step == "f":
                seq.append(br.record_failure())
            elif step == "s":
                br.record_success()
            elif step == "t":
                clock[0] += 6.0
            else:
                seq.append(br.allow())
            seq.append(br.snapshot()["state"])
        states.append(seq)
    assert states[0] == states[1]


def test_retry_call_retries_transients_only():
    slept = []
    pol = faults.RetryPolicy(attempts=3, seed=1, sleep=slept.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise faults.InjectedFault("flaky")
        return 42

    assert faults.retry_call(flaky, policy=pol) == 42
    assert len(slept) == 2 and faults.counters()["retry.io"] == 2
    with pytest.raises(FileNotFoundError):
        faults.retry_call(lambda: open("/nonexistent/x"), policy=pol)
    assert faults.counters()["retry.io"] == 2


@pytest.fixture
def raw(tmp_path):
    p = str(tmp_path / "x.raw")
    ttesting.synth_raw(p, nblocks=4, obsnchan=2, ntime_per_block=1000,
                       overlap=8, tone_chan=1)
    return p


def _red(**kw):
    return RawReducer(nfft=64, nint=2, chunk_frames=4, device="cpu",
                      output_stall_timeout_s=30.0, **kw)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("point", ["guppi.read", "guppi.open"])
def test_transient_read_faults_retry_and_change_nothing(raw, tmp_path, native,
                                                        point):
    from blit_torch.io import native as tnative

    if native and tnative.guppi_lib() is None:
        pytest.skip(f"native reader unavailable: {tnative.build_error('guppi')}")
    ref = str(tmp_path / "ref.fil")
    _red().reduce_to_file(GuppiRaw(raw, native=native), ref)
    faults.set_io_policy(faults.RetryPolicy(attempts=3, **NO_SLEEP))
    faults.install(faults.FaultRule(point, mode="fail", times=2, after=1))
    out = str(tmp_path / "x.fil")
    src = raw if point == "guppi.open" else GuppiRaw(raw, native=native)
    if point == "guppi.open":  # the second open of the file fails twice
        GuppiRaw(raw, native=native)
    _red().reduce_to_file(src, out)
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert faults.counters()["retry.io"] == 2
    assert faults.counters()[f"fault.{point}.fail"] == 2


def test_exhausted_retries_fail_the_product(raw, tmp_path):
    faults.set_io_policy(faults.RetryPolicy(attempts=2, **NO_SLEEP))
    faults.install(faults.FaultRule("guppi.read", mode="fail", times=-1, after=2))
    out = str(tmp_path / "x.fil")
    with pytest.raises(faults.InjectedFault):
        _red().reduce_to_file(raw, out)
    assert not os.path.exists(out) and not os.path.exists(out + ".partial")


def test_corrupt_read_flips_the_delivered_frame(raw):
    want = GuppiRaw(raw, native=False).read_block(1)
    faults.install(faults.FaultRule("guppi.read", mode="corrupt", times=1))
    dst = np.zeros_like(want)
    GuppiRaw(raw, native=False).read_block_into(1, dst)
    np.testing.assert_array_equal(dst[0], want[0] ^ 0x55)
    np.testing.assert_array_equal(dst[1:], want[1:])


@pytest.mark.parametrize("point", ["sink.write", "sink.flush"])
def test_sink_faults_fail_the_product_and_publish_nothing(raw, tmp_path, point):
    out = str(tmp_path / "x.fil")
    faults.install(faults.FaultRule(point, mode="fail", times=-1,
                                    match="x.fil"))
    with pytest.raises(faults.InjectedFault, match=point):
        _red().reduce_to_file(raw, out)
    assert not os.path.exists(out) and not os.path.exists(out + ".partial")
    assert not os.path.exists(out + ".manifest.json")
    # The same fault on the synchronous plane does not fire: no sink.
    _red(async_output=False).reduce_to_file(raw, out)
    assert os.path.exists(out)


def test_blit_faults_env_spec_arms_at_import(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from blit_torch import faults; "
            "print([(r.point, r.mode, r.times) for r in faults.active()])")
    env = dict(os.environ, PYTHONPATH=repo, BLIT_FAULTS="guppi.read:fail:2")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[('guppi.read', 'fail', 2)]"
