"""The serve plane's commands of ``python -m blit_torch``: ``fleet-peer``,
``fsck``, ``backfill`` and ``requests``, with ``blit``'s flags and exit
codes.

Peers are real ``python -m blit_torch fleet-peer --device cpu``
subprocesses (each imports torch, a few seconds), started together,
beating leases in a shared directory and writing request logs; a
front door in this process serves through them, a SIGKILLed owner is
ejected and the ask re-routes byte-identically, and SIGTERM drains the
survivor to exit 0.  Every test runs under a SIGALRM deadline and kills
what it started.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from blit.serve import ProductRequest as BRequest  # noqa: E402
from blit.serve.cache import fingerprint_for as bfingerprint_for  # noqa: E402
from blit_torch import __main__ as tmain  # noqa: E402
from blit_torch.config import DEFAULT  # noqa: E402
from blit_torch.parallel.remote import agent_env_with_repo  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402
from blit_torch.serve import FleetFrontDoor, ProductRequest  # noqa: E402
from blit_torch.serve.catalog import CatalogIndex  # noqa: E402
from blit_torch.serve.http import wait_http_ready  # noqa: E402
from blit_torch.testing import build_observation_tree, synth_raw  # noqa: E402

NFFT = 64
DEADLINE_S = 60
SESSION = "AGBT25A_999_01"


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(list(argv))
    return rc, buf.getvalue()


def _cli(*argv, env=None):
    return subprocess.run([sys.executable, "-m", "blit_torch", *argv],
                          capture_output=True, text=True, timeout=50,
                          env=env or agent_env_with_repo())


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(10)


def spawn_peers(td, n, *, env, extra=()):
    """Start ``n`` fleet-peer processes at once; wait for their ports."""
    lease = os.path.join(td, "leases")
    procs, peers = [], {}
    for i in range(n):
        cmd = [sys.executable, "-m", "blit_torch", "fleet-peer",
               "--name", f"peer{i}", "--lease-dir", lease, "--proc", str(i),
               "--port", "0", "--port-file", os.path.join(td, f"p{i}.port"),
               "--beat-interval", "0.1", "--ram-bytes", str(1 << 24),
               "--retry-seed", str(i), "--device", "cpu", *extra]
        log = open(os.path.join(td, f"p{i}.log"), "w")
        procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    try:
        for i in range(n):
            pf = os.path.join(td, f"p{i}.port")
            while not os.path.exists(pf):
                assert procs[i].poll() is None, open(
                    os.path.join(td, f"p{i}.log")).read()
                time.sleep(0.05)
            with open(pf) as f:
                url = f"http://127.0.0.1:{int(f.read())}"
            wait_http_ready(url, timeout_s=40)
            peers[f"peer{i}"] = url
    except BaseException:
        _kill(procs)
        raise
    return procs, peers, lease


def test_fleet_peers_serve_reroute_drain_and_log(tmp_path):
    td = str(tmp_path)
    raw = os.path.join(td, "a.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=4096,
              tone_chan=1, tone_freq=0.125, seed=6)
    logs = os.path.join(td, "reqlog")
    env = dict(agent_env_with_repo(), BLIT_REQUEST_LOG=logs)
    procs, peers, lease = spawn_peers(td, 2, env=env)
    door = FleetFrontDoor(peers, lease_dir=lease, peer_ttl_s=1.0,
                          poll_s=0.05, request_timeout_s=40.0,
                          config=DEFAULT.with_(request_log_dir=logs)).start()
    try:
        req = ProductRequest(raw=raw, nfft=NFFT, nint=2)
        hdr, data = door.get(req)
        want_hdr, want = RawReducer(nfft=NFFT, nint=2,
                                    device="cpu").reduce(raw)
        assert hdr == want_hdr and data.tobytes() == want.tobytes()
        door.get(req)
        owner = door.ring.owner(req.fingerprint())
        victim = procs[int(owner[-1])]
        victim.send_signal(signal.SIGKILL)
        victim.wait(10)
        deadline = time.monotonic() + 20
        while owner in door.ring and time.monotonic() < deadline:
            time.sleep(0.02)
        assert owner not in door.ring
        hdr3, data3 = door.get(req)
        assert hdr3 == hdr and data3.tobytes() == data.tobytes()
        survivor = procs[1 - int(owner[-1])]
        survivor.send_signal(signal.SIGTERM)
        assert survivor.wait(30) == 0
    finally:
        door.close()
        _kill(procs)
    r = _cli("requests", logs, "--json")
    assert r.returncode == 0
    recs = [json.loads(line) for line in r.stdout.splitlines()]
    door_recs = [x for x in recs if x["role"] == "door"]
    assert len(door_recs) == 3 and all(x["status"] == "ok" for x in door_recs)
    assert [x["tier"] for x in door_recs][:2] == ["derive", "ram"]
    assert any(x["role"] == "peer" for x in recs)
    r = _cli("requests", logs, "--aggregate", "--json", "--role", "door")
    agg = json.loads(r.stdout)
    assert agg["records"] == 3 and agg["by_status"] == {"ok": 3}


def test_fleet_peer_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable")
    r = subprocess.run(
        [sys.executable, "-m", "blit_torch", "fleet-peer", "--port-file",
         str(tmp_path / "p.port")], capture_output=True, text=True,
        timeout=50, env=agent_env_with_repo())
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert not (tmp_path / "p.port").exists()


def test_fsck_exit_codes_and_quarantine(tmp_path):
    raw = str(tmp_path / "a.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=4096, seed=1)
    prod = tmp_path / "products"
    prod.mkdir()
    for nint in (1, 2):
        RawReducer(nfft=NFFT, nint=nint, device="cpu").reduce_to_file(
            raw, str(prod / f"p{nint}.fil"))
    rc, out = _run(["fsck", str(prod), "--json-out",
                    str(tmp_path / "clean.json")])
    rep = json.loads(out)
    assert rc == 0 and rep["clean"] and rep["checked"] == 2
    assert json.loads((tmp_path / "clean.json").read_text()) == rep
    path = prod / "p2.fil"
    with open(path, "r+b") as f:
        f.seek(-5, 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 1]))
    rc, out = _run(["fsck", str(prod), "--no-quarantine"])
    assert rc == 1 and path.exists()
    rc, out = _run(["fsck", str(prod)])
    rep = json.loads(out)
    assert rc == 1 and [e["path"] for e in rep["bad"]] == ["p2.fil"]
    assert not path.exists()
    assert (prod / ".quarantine" / "p2.fil").exists()
    assert "p2.fil.manifest.json" in os.listdir(prod / ".quarantine")


@pytest.fixture
def archive(tmp_path):
    root = str(tmp_path / "archive")
    build_observation_tree(root, SESSION, scans=("0001", "0002"),
                           players=((0, 0), (0, 1)), kind="raw",
                           nchans=2, raw_ntime=6 * NFFT, nfiles=2)
    return root


def _entries(cache_dir):
    out = {}
    for fn in sorted(os.listdir(cache_dir)):
        if fn.endswith(".h5"):
            with open(os.path.join(cache_dir, fn), "rb") as f:
                out[fn] = f.read()
    return out


def test_backfill_resume_is_byte_identical(archive, tmp_path):
    common = ["--nfft", str(NFFT), "--nint", "1", "--bytes-per-s", "0",
              "--device", "cpu"]
    full = str(tmp_path / "full")
    rc, out = _run(["backfill", archive, "--cache-dir", full, *common])
    rep = json.loads(out)
    assert rc == 0 and rep["derived"] == 4 and rep["errors"] == []
    # The same products by blit's fingerprints.
    idx = CatalogIndex(archive, rescan_s=0.0)
    want = set()
    for scan in ("0001", "0002"):
        for bank in (0, 1):
            m = tuple(idx.resolve(SESSION, scan, band=0, bank=bank))
            b = BRequest(raw=m, nfft=NFFT, nint=1)
            want.add(bfingerprint_for(b.reducer(), b.raw_source) + ".h5")
    assert set(_entries(full)) == want
    # Interrupted after two products, the crash leaving a torn ledger
    # line, then resumed.
    part = str(tmp_path / "part")
    rc, out = _run(["backfill", archive, "--cache-dir", part, "--limit", "2",
                    *common])
    assert rc == 0 and json.loads(out)["derived"] == 2
    with open(os.path.join(part, "backfill.ledger.jsonl"), "a") as f:
        f.write('{"fp": "dead')
    rc, out = _run(["backfill", archive, "--cache-dir", part, *common])
    rep = json.loads(out)
    assert rc == 0 and rep["skipped_ledger"] == 2 and rep["derived"] == 2
    assert _entries(part) == _entries(full)


def test_requests_filters(tmp_path):
    log = tmp_path / "requests-door-h-1.jsonl"
    now = time.time()
    rows = [dict(t=now - 600, role="door", status="ok", duration_s=0.5,
                 client="a"),
            dict(t=now - 10, role="peer", status="overloaded", code=503,
                 duration_s=0.01, client="b"),
            dict(t=now - 5, role="door", status="ok", duration_s=2.0,
                 client="a")]
    log.write_text("".join(json.dumps(r) + "\n" for r in rows) + '{"t": 1')
    rc, out = _run(["requests", str(tmp_path), "--json", "--since", "5m"])
    assert rc == 0 and len(out.splitlines()) == 2
    rc, out = _run(["requests", str(tmp_path), "--json", "--status", "503"])
    assert [json.loads(x)["client"] for x in out.splitlines()] == ["b"]
    rc, out = _run(["requests", str(tmp_path), "--json", "--slow-ms", "400"])
    assert len(out.splitlines()) == 2
    rc, out = _run(["requests", str(tmp_path), "--tail", "1"])
    assert rc == 0 and len(out.splitlines()) == 2  # header + one row
    assert np.isclose(json.loads(_run(["requests", str(tmp_path),
                                       "--aggregate", "--json"])[1])["max_s"],
                      2.0)
