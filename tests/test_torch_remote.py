"""The port's agent, remote transport and pool health, ported from
tests/test_remote.py and tests/test_pool_health.py: real
``python -m blit_torch.agent`` subprocesses (no sshd; the transport is
spawned locally), the wire's three guards (the ``blit_torch.`` prefix,
the frame cap before allocation, the restricted unpickler), respawn and
retry of a dead agent, the call deadline on a wedged one, the breaker's
trip and re-close, and the fan-in deadlines.

Every test runs under a SIGALRM deadline, and each deadline-driven test
sets its own call / ping timeout of a few seconds, so a hung agent fails
one test instead of stalling the suite.
"""

import io
import os
import pickle
import re
import signal
import sys
import time

import numpy as np
import pytest

from blit_torch import faults, observability
from blit_torch import workers
from blit_torch.agent import (
    _LEN,
    _SAFE_GLOBALS_RESPONSE,
    _RestrictedUnpickler,
    ping,
    read_msg,
    resolve,
    serve,
    write_msg,
)
from blit_torch.config import SiteConfig
from blit_torch.inventory import InventoryRecord
from blit_torch.ops.fqav import fqav_range
from blit_torch.parallel.pool import WorkerError, WorkerPool
from blit_torch.parallel.remote import (
    _BANNER_SCAN_LIMIT,
    RemoteError,
    RemoteWorker,
    _await_banner,
    agent_env_with_repo,
    local_agent_command,
    ssh_command,
)
from blit_torch.testing import synth_fil

HERE = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 60
FQ = "blit_torch.ops.fqav.fqav_range"


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def odd_command():
    return [sys.executable, os.path.join(HERE, "_torch_wedged_agent.py")]


def odd_env(**kw):
    return dict(agent_env_with_repo(), **kw)


def transport(host):
    return odd_command() if host == "wedged" else local_agent_command()


@pytest.fixture(scope="module")
def agent():
    w = RemoteWorker("local", local_agent_command(), env=agent_env_with_repo(),
                     call_timeout=30.0)
    yield w
    w.close()


def _serve(*frames):
    inbuf = io.BytesIO()
    for fr in frames:
        if isinstance(fr, bytes):
            inbuf.write(fr)
        else:
            write_msg(inbuf, fr)
    inbuf.seek(0)
    out = io.BytesIO()
    serve(inbuf, out)
    out.seek(0)
    return out


# -- resolve and the wire ----------------------------------------------------

@pytest.mark.parametrize("path", [
    "blit.ops.fqav.fqav_range", "blit.workers.get_header", "os.system",
    "subprocess.run", "blit_torchx.evil", "blit_torch", "builtins.eval",
    "numpy.save",
])
def test_resolve_refuses_everything_but_blit_torch(path):
    with pytest.raises(PermissionError):
        resolve(path)


def test_resolve_admits_blit_torch_callables():
    assert resolve(FQ) is fqav_range
    assert resolve("blit_torch.agent.ping")() == "pong"
    assert resolve("blit_torch.workers.get_data") is workers.get_data
    with pytest.raises(TypeError, match="not callable"):
        resolve("blit_torch.agent.MAGIC")


@pytest.mark.parametrize("module,name", [
    ("numpy", "save"), ("numpy", "fromfile"), ("numpy.lib.npyio", "save"),
    ("blit_torch.workers", "reduce_raw"), ("blit_torch.io.sigproc", "write_fil"),
    ("re", "sub"), ("os", "system"), ("builtins", "eval"),
    ("blit.inventory", "InventoryRecord"), ("blit.config", "SiteConfig"),
    ("blit.naming", "GuppiName"),
])
def test_unpickler_refuses_globals_off_the_allow_list(module, name):
    with pytest.raises(pickle.UnpicklingError, match="refuses"):
        _RestrictedUnpickler(io.BytesIO(b"")).find_class(module, name)


def test_malicious_pickle_rejected_and_stream_stays_framed():
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    body = pickle.dumps((Evil(), (), {}))
    out = _serve(_LEN.pack(len(body)) + body, (FQ, (1.0, 1.0, 4, 4), {}))
    tag, etype, msg, _tb = read_msg(out)
    assert (tag, etype) == ("err", "UnpicklingError") and "refuses" in msg
    assert read_msg(out) == ("ok", (2.5, 4.0, 1))


def test_blit_paths_refused_over_the_wire():
    out = _serve(("blit.ops.fqav.fqav_range", (1.0, 1.0, 4, 4), {}),
                 ("os.getcwd", (), {}), (FQ, (1.0, 1.0, 4, 4), {}))
    for _ in range(2):
        tag, etype, _msg, _tb = read_msg(out)
        assert (tag, etype) == ("err", "PermissionError")
    assert read_msg(out) == ("ok", (2.5, 4.0, 1))


def test_frame_cap_holds_before_allocation():
    stream = io.BytesIO(_LEN.pack(3 << 10) + b"x" * (3 << 10))
    with pytest.raises(pickle.UnpicklingError, match="exceeds"):
        read_msg(stream, max_bytes=1 << 10)
    assert stream.read() == b""  # drained: framing intact
    stream = io.BytesIO(_LEN.pack(3 << 10))
    with pytest.raises(pickle.UnpicklingError, match="not drained"):
        read_msg(stream, max_bytes=1 << 10, drain_oversized=False)
    with pytest.raises(EOFError, match="tearing down"):
        read_msg(io.BytesIO(_LEN.pack(1 << 62)))
    body = pickle.dumps([1, 2, 3])
    assert read_msg(io.BytesIO(_LEN.pack(len(body)) + body), max_bytes=1 << 20) == [1, 2, 3]


def test_safe_payloads_roundtrip_and_response_refuses_regex():
    buf = io.BytesIO()
    rec = InventoryRecord(1, 2, "S", "0001", "A", 0, 1, "h", "f", 1)
    payload = (np.arange(6, dtype=np.float32).reshape(2, 3), re.compile(r"0002\.h5$"),
               slice(1, 5, 2), rec, SiteConfig(hosts=["a"]), np.mean, np.max)
    write_msg(buf, payload)
    buf.seek(0)
    back = read_msg(buf)
    np.testing.assert_array_equal(back[0], payload[0])
    assert back[1].pattern == payload[1].pattern and back[2] == payload[2]
    assert back[3] == rec and type(back[3]) is InventoryRecord
    assert back[4].hosts == ["a"] and back[5] is np.mean and back[6] is np.max
    buf = io.BytesIO()
    write_msg(buf, re.compile("x"))
    buf.seek(0)
    with pytest.raises(pickle.UnpicklingError, match="re._compile"):
        read_msg(buf, safe_globals=_SAFE_GLOBALS_RESPONSE)


def test_serve_survives_malformed_bodies_and_ships_exceptions():
    bad = pickle.dumps((1, 2, 3, 4))[:-5]
    out = _serve(_LEN.pack(len(bad)) + bad, _LEN.pack(0), "not a 3-tuple",
                 ("blit_torch.workers.get_header", ("/nonexistent.fil",), {}),
                 (FQ, (1.0, 1.0, 4, 4), {}))
    for _ in range(3):
        assert read_msg(out)[0] == "err"
    tag, etype, _msg, tb = read_msg(out)
    assert tag == "err" and "Error" in etype and tb
    assert read_msg(out) == ("ok", (2.5, 4.0, 1))


def test_ssh_and_local_commands():
    cmd = ssh_command("blc42", python="python3.12", remote_env={"BLIT_WORKER_ID": "3"})
    assert cmd[0] == "ssh" and "blc42" in cmd and "BLIT_WORKER_ID=3" in cmd
    assert cmd[-3:] == ["python3.12", "-m", "blit_torch.agent"]
    assert local_agent_command()[-2:] == ["-m", "blit_torch.agent"]
    repo = os.path.dirname(HERE)
    assert agent_env_with_repo()["PYTHONPATH"].split(os.pathsep)[0] == repo


# -- one real agent ------------------------------------------------------------

def test_agent_roundtrip_arrays_and_remote_errors(agent, tmp_path):
    assert agent.call(fqav_range, 1.0, 2.0, 8, 4) == (4.0, 8.0, 2)
    p = str(tmp_path / "x.fil")
    _, data = synth_fil(p, nsamps=8, nchans=64)
    out = agent.call(workers.get_data, p, (slice(2, 6), slice(None), slice(None)),
                     fqav_by=4, fqav_func=np.max)
    np.testing.assert_array_equal(out, data[2:6].reshape(4, 1, 16, 4).max(-1))
    with pytest.raises(RemoteError) as ei:
        agent.call(workers.get_header, "/nonexistent.fil")
    assert ei.value.host == "local" and ei.value.remote_traceback
    assert ei.value.etype == "FileNotFoundError"


def test_agent_reports_its_device(agent):
    from blit_torch.device import device_name

    assert agent.call(device_name, "cpu") == "cpu"


def test_banner_noise_skipped():
    cmd = [sys.executable, "-c",
           "import sys, runpy; sys.stdout.write('motd: welcome!\\n'); "
           "sys.stdout.flush(); runpy.run_module('blit_torch.agent', "
           "run_name='__main__')"]
    w = RemoteWorker("noisy", cmd, env=agent_env_with_repo(), call_timeout=30.0)
    try:
        assert w.call(fqav_range, 1.0, 1.0, 4, 4) == (2.5, 4.0, 1)
    finally:
        w.close()


# -- death, respawn, retry -----------------------------------------------------

def test_killed_agent_respawns():
    pool = WorkerPool(["h0"], backend="remote", transport=transport,
                      agent_env=agent_env_with_repo(), call_timeout=30.0)
    try:
        w = pool.workers[0]
        assert pool.run_on([1], fqav_range, [(1.0, 1.0, 4, 2)]) == [(1.5, 2.0, 2)]
        pid = w.remote._proc.pid
        w.remote._proc.kill()
        w.remote._proc.wait()
        assert pool.run_on([1], fqav_range, [(1.0, 1.0, 4, 2)]) == [(1.5, 2.0, 2)]
        assert w.remote._proc.pid != pid
    finally:
        pool.shutdown()


def test_agent_killed_mid_call_is_respawned_and_the_call_retried(tmp_path):
    marker = str(tmp_path / "died")
    cfg = SiteConfig(call_retries=2, call_backoff_s=0.0, retry_jitter=0.0)
    pool = WorkerPool(["wedged"], backend="remote", config=cfg, transport=transport,
                      agent_env=odd_env(DIE_ONCE=marker), call_timeout=30.0)
    before = faults.counters().get("retry.remote", 0)
    try:
        assert pool.run_on([1], fqav_range, [(1.0, 1.0, 4, 2)]) == [(1.5, 2.0, 2)]
        assert os.path.exists(marker)  # the first agent died mid-call
        assert faults.counters().get("retry.remote", 0) == before + 1
        assert pool.health()[0]["state"] == "closed"
    finally:
        pool.shutdown()


def test_midcall_death_without_retry_is_agent_died():
    w = RemoteWorker(
        "flaky",
        [sys.executable, "-c",
         "import sys; sys.stdout.buffer.write(b'BLITAGENT1\\n'); "
         "sys.stdout.flush(); sys.stdin.buffer.read(8); sys.exit(1)"],
        call_timeout=30.0)
    try:
        with pytest.raises(RemoteError, match="AgentDied"):
            w.call(fqav_range, 1.0, 1.0, 4, 2)
    finally:
        w.close()


# -- deadlines -----------------------------------------------------------------

def test_wedged_agent_hits_call_timeout_and_is_killed():
    w = RemoteWorker("wedged", odd_command(), env=odd_env(), call_timeout=1.0)
    t0 = time.monotonic()
    with pytest.raises(RemoteError) as ei:
        w.call(ping)
    assert ei.value.etype == "CallTimeout"
    assert time.monotonic() - t0 < 30
    assert w._proc is None  # killed and forgotten: the next use respawns


def test_broadcast_completes_around_a_wedged_agent():
    cfg = SiteConfig(call_retries=0)
    pool = WorkerPool(["h0", "wedged"], backend="remote", config=cfg,
                      transport=transport, agent_env=odd_env(), call_timeout=2.0)
    try:
        res = pool.broadcast(ping, on_error="capture")
    finally:
        pool.shutdown()
    assert res[0] == "pong"
    assert isinstance(res[1], WorkerError) and res[1].error.etype == "CallTimeout"


def test_wedged_reuse_is_caught_by_the_ping():
    w = RemoteWorker("wedged", odd_command(), env=odd_env(ANSWER_FIRST="1"),
                     call_timeout=10.0, ping_timeout=0.5, ping_min_idle=0.0)
    try:
        assert w.call(ping) == "pong"
        pid = w._proc.pid
        assert w.call(ping) == "pong"  # a fresh agent after the failed ping
        assert w._proc.pid != pid
    finally:
        w.close()


def test_healthy_reuse_keeps_the_agent_and_recent_ones_skip_the_ping(monkeypatch):
    w = RemoteWorker("h", local_agent_command(), env=agent_env_with_repo(),
                     call_timeout=30.0, ping_timeout=10.0, ping_min_idle=0.0)
    try:
        assert w.call(ping) == "pong"
        pid = w._proc.pid
        assert w.call(ping) == "pong"
        assert w._proc.pid == pid
        w.ping_min_idle = 60.0
        calls = []
        orig = w._transact

        def spy(proc, request, fn_path, timeout):
            calls.append(fn_path)
            return orig(proc, request, fn_path, timeout)

        monkeypatch.setattr(w, "_transact", spy)
        assert w.call(ping) == "pong"
        assert calls == ["blit_torch.agent.ping"]  # the call only, no probe
    finally:
        w.close()


@pytest.mark.parametrize("sleeps,timeout", [((1.0, 0.0), 0.2), ((0.4, 1.0, 1.0), 0.15)])
def test_fan_in_deadline_captures_late_workers(sleeps, timeout):
    pool = WorkerPool([f"h{i}" for i in range(len(sleeps))], backend="thread")
    try:
        t0 = time.monotonic()
        res = pool.run_on(list(range(1, len(sleeps) + 1)), time.sleep,
                          [(s,) for s in sleeps], on_error="capture", timeout=timeout)
        wall = time.monotonic() - t0
        with pytest.raises(TimeoutError):
            pool.run_on([1], time.sleep, [(1.0,)], timeout=0.1)
    finally:
        pool.shutdown()
    late = [s > timeout for s in sleeps]
    assert [isinstance(r, WorkerError) for r in res] == late
    assert all(type(r.error) is TimeoutError and "worker" in str(r.error)
               for r in res if isinstance(r, WorkerError))
    assert wall < 4.0


def test_banner_scan_fails_loudly():
    for data in (b"some ssh error\n", b""):
        with pytest.raises(RemoteError) as ei:
            _await_banner(io.BytesIO(data), "h")
        assert ei.value.etype == "AgentDied"
    noisy = io.BytesIO(b"x" * (_BANNER_SCAN_LIMIT + 64))
    with pytest.raises(RemoteError) as ei:
        _await_banner(noisy, "h")
    assert ei.value.etype == "NoHandshake"
    assert noisy.tell() <= _BANNER_SCAN_LIMIT + 1


def test_deadlines_come_from_the_config_unless_given():
    pool = WorkerPool(["a"], backend="local")
    assert pool.call_timeout is None and pool.ping_timeout == 30.0
    pool.shutdown()
    pool = WorkerPool(["h"], backend="remote", transport=transport,
                      agent_env=agent_env_with_repo(), call_timeout=123.0,
                      ping_timeout=7.0)
    rw = pool.workers[0].remote
    assert (rw.call_timeout, rw.ping_timeout) == (123.0, 7.0)
    pool.shutdown()
    pool = WorkerPool(["h"], backend="remote", transport=transport,
                      agent_env=agent_env_with_repo(), call_timeout=None,
                      ping_timeout=None)
    rw = pool.workers[0].remote
    assert rw.call_timeout is None and rw.ping_timeout is None
    pool.shutdown()
    with pytest.raises(ValueError, match="unknown backend"):
        WorkerPool(["a"], backend="mpi")


# -- the fan-out's span tree ---------------------------------------------------

@pytest.mark.parametrize("backend", ["local", "thread", "remote"])
def test_fan_out_span_tree_reaches_the_agents(backend):
    tr = observability.tracer()
    tr.reset()
    kw = (dict(transport=transport, agent_env=agent_env_with_repo(), call_timeout=30.0)
          if backend == "remote" else {})
    pool = WorkerPool(["h0", "h1"], backend=backend, **kw)
    try:
        with observability.span("fanout") as root:
            got = pool.run_on([1, 2], fqav_range, [(1.0, 1.0, 4, 2)] * 2)
        assert got == [(1.5, 2.0, 2)] * 2
        dispatch = {s["attrs"]["worker"]: s for s in observability.span_dicts()
                    if s["name"] == "pool.fqav_range"}
        assert sorted(dispatch) == [1, 2]
        assert all(s["parent"] == root.span_id and s["trace"] == root.trace_id
                   for s in dispatch.values())
        if backend == "remote":
            # Each agent's span parents onto the dispatch span that shipped it.
            for wid, theirs in zip((1, 2), pool.broadcast(observability.span_dicts)):
                (call,) = [s for s in theirs if s["name"] == "agent.fqav_range"]
                assert call["parent"] == dispatch[wid]["span"]
                assert call["trace"] == root.trace_id and call["worker"] == wid
                assert call["attrs"] == {"fn": FQ}
    finally:
        pool.shutdown()
        tr.reset()


def test_blit_spans_off_records_no_agent_span():
    pool = WorkerPool(["h0"], backend="remote", transport=transport,
                      agent_env=odd_env(BLIT_SPANS="0"), call_timeout=30.0)
    try:
        assert pool.run_on([1], fqav_range, [(1.0, 1.0, 4, 2)]) == [(1.5, 2.0, 2)]
        assert pool.broadcast(observability.span_dicts) == [[]]
    finally:
        pool.shutdown()


# -- the circuit breaker -------------------------------------------------------

def test_breaker_trips_then_recloses_through_a_probe():
    cfg = SiteConfig(call_retries=2, call_backoff_s=0.0, retry_jitter=0.0,
                     breaker_threshold=3, breaker_cooldown_s=60.0)
    pool = WorkerPool(["h0"], backend="remote", config=cfg, transport=transport,
                      agent_env=agent_env_with_repo(), call_timeout=30.0)
    br = pool.workers[0].breaker
    faults.clear()
    try:
        assert pool.run_on([1], ping, [()]) == ["pong"]
        faults.install(faults.FaultRule("remote.call", times=-1))
        before = faults.counters().get("breaker.trip", 0)
        with pytest.raises(RemoteError, match="AgentDied"):
            pool.run_on([1], ping, [()])
        assert pool.health()[0]["state"] == "open"
        assert faults.counters().get("breaker.trip", 0) == before + 1
        faults.clear()
        with pytest.raises(RemoteError, match="HostDegraded"):
            pool.run_on([1], ping, [()])  # fails fast, the agent is healthy
        base = time.monotonic()
        br.clock = lambda: base + br.cooldown_s + 1
        assert pool.run_on([1], ping, [()]) == ["pong"]  # the probe
        row = pool.health()[0]
        assert row["state"] == "closed" and row["half_open"] is False
        assert row["trips"] == 1
    finally:
        faults.clear()
        pool.shutdown()


def test_half_open_admits_one_probe_and_a_failure_retrips():
    pool = WorkerPool(["h0"], backend="local")
    br = pool.workers[0].breaker
    for _ in range(br.threshold):
        br.record_failure()
    assert pool.health()[0]["state"] == "open"
    base = time.monotonic()
    br.clock = lambda: base + br.cooldown_s + 1
    assert br.allow()
    assert pool.health()[0]["half_open"] is True
    assert not br.allow()
    assert br.record_failure()
    row = pool.health()[0]
    assert row["state"] == "open" and row["trips"] == 2
    pool.shutdown()
