"""The operator half of the port's integrity plane held against
``blit``'s: ``fsck``, quarantine, the ``Scrubber`` and the re-derivation
of quarantined cache entries.

One seeded tree holds manifested ``.fil`` and ``.hits`` products, a RAW
member under a digest sidecar, an unmanifested product and a serve-cache
directory whose entries carry recipes.  Two copies of it are corrupted
alike (a flipped product byte, a flipped cache byte, a torn manifest, a
rotten RAW block) and walked by each package's ``fsck``: the reports
(relative paths, kinds, problems, quarantine destinations) must be
equal.  ``repair=True`` then re-derives the quarantined cache entry
through the port on the CPU, byte-identical to the entry it replaces,
and ``/healthz``'s quarantine hook clears.
"""

import json
import os
import shutil
import signal
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from blit import integrity as bintegrity  # noqa: E402
from blit_torch import integrity  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402
from blit_torch.search import DedopplerReducer  # noqa: E402
from blit_torch.serve import ProductCache, ProductRequest, ProductService  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

NFFT = 64
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


def _flip(path, offset_from_end=16):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - offset_from_end)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x5A]))


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    """The clean tree, built once by the port."""
    root = str(tmp_path_factory.mktemp("tree") / "archive")
    prod = os.path.join(root, "products")
    os.makedirs(prod)
    raw = os.path.join(root, "rec.0000.raw")
    synth_raw(raw, nblocks=3, obsnchan=2, ntime_per_block=4096,
              tone_chan=1, tone_freq=0.125, seed=4)
    integrity.write_raw_digests(raw)
    RawReducer(nfft=NFFT, nint=2, device="cpu").reduce_to_file(
        raw, os.path.join(prod, "a.fil"))
    RawReducer(nfft=NFFT, nint=4, device="cpu").reduce_to_file(
        raw, os.path.join(prod, "b.fil"))
    DedopplerReducer(nfft=NFFT, window_spectra=8, snr_threshold=3.0,
                     device="cpu").search_to_file(
        raw, os.path.join(prod, "c.hits"))
    shutil.copyfile(os.path.join(prod, "a.fil"),
                    os.path.join(prod, "loose.fil"))
    svc = ProductService(cache=ProductCache(os.path.join(root, "cache"),
                                            ram_bytes=1 << 24),
                         device="cpu")
    try:
        for nint in (1, 2):
            svc.get(ProductRequest(raw=raw, nfft=NFFT, nint=nint),
                    timeout=50)
    finally:
        svc.close()
    return root


def _copy(pristine, dst):
    shutil.copytree(pristine, dst)
    # Keep the RAW member's mtime: it is part of every fingerprint.
    for name in ("rec.0000.raw",):
        st = os.stat(os.path.join(pristine, name))
        os.utime(os.path.join(dst, name), ns=(st.st_atime_ns, st.st_mtime_ns))
    return dst


def _corrupt(root):
    prod = os.path.join(root, "products")
    _flip(os.path.join(prod, "a.fil"))
    with open(os.path.join(prod, "b.fil.manifest.json"), "w") as f:
        f.write('{"kind": "blit.manifest", "ver')
    cache = os.path.join(root, "cache")
    fp = sorted(f[:-3] for f in os.listdir(cache) if f.endswith(".h5"))[0]
    _flip(os.path.join(cache, fp + ".h5"), 64)
    _flip(os.path.join(root, "rec.0000.raw"), 1000)
    return fp


def _report(rep):
    rep = dict(rep)
    rep.pop("root")
    return json.dumps(rep, sort_keys=True)


def test_clean_tree_reports_equal_blits(pristine, tmp_path):
    a = _copy(pristine, str(tmp_path / "port"))
    b = _copy(pristine, str(tmp_path / "blit"))
    ra, rb = integrity.fsck(a), bintegrity.fsck(b)
    assert ra["clean"] and ra["unmanifested"] == 1
    assert ra["checked"] == 6  # 3 manifests, 2 cache entries, 1 digests
    assert _report(ra) == _report(rb)


@pytest.mark.parametrize("quarantine", [True, False])
def test_corrupt_tree_reports_equal_blits(pristine, tmp_path, quarantine):
    a = _copy(pristine, str(tmp_path / "port"))
    b = _copy(pristine, str(tmp_path / "blit"))
    _corrupt(a)
    _corrupt(b)
    ra = integrity.fsck(a, quarantine=quarantine)
    rb = bintegrity.fsck(b, quarantine=quarantine)
    assert _report(ra) == _report(rb)
    assert not ra["clean"]
    assert sorted(e["kind"] for e in ra["bad"]) == [
        "cache", "product", "product", "raw"]
    if quarantine:
        assert not os.path.exists(os.path.join(a, "products", "a.fil"))
        assert os.path.exists(os.path.join(a, "products", ".quarantine",
                                           "a.fil"))
        assert sorted(os.listdir(os.path.join(a, ".quarantine"))
                      if os.path.isdir(os.path.join(a, ".quarantine"))
                      else []) == []  # RAW members are never moved


def test_repair_rederives_the_cache_entry(pristine, tmp_path):
    a = _copy(pristine, str(tmp_path / "port"))
    cache = os.path.join(a, "cache")
    fp = sorted(f[:-3] for f in os.listdir(cache) if f.endswith(".h5"))[0]
    with open(os.path.join(cache, fp + ".h5"), "rb") as f:
        want = f.read()
    _flip(os.path.join(cache, fp + ".h5"), 64)
    rep = integrity.fsck(cache)
    assert [e["kind"] for e in rep["bad"]] == ["cache"]
    health = integrity.quarantine_health()
    assert health and health["degraded"]
    rep = integrity.fsck(cache, repair=True, device="cpu")
    assert rep["clean"] and [r["fingerprint"] for r in rep["repaired"]] == [fp]
    with open(os.path.join(cache, fp + ".h5"), "rb") as f:
        assert f.read() == want
    assert not os.path.isdir(os.path.join(cache, ".quarantine"))
    assert ProductCache(cache, ram_bytes=0).verify_entry(fp) is True
    health = integrity.quarantine_health() or {}
    assert not any(d.startswith(cache) for d in health.get("dirs", []))


def test_repair_refuses_a_changed_input(pristine, tmp_path):
    a = _copy(pristine, str(tmp_path / "port"))
    cache = os.path.join(a, "cache")
    fp = sorted(f[:-3] for f in os.listdir(cache) if f.endswith(".h5"))[0]
    _flip(os.path.join(cache, fp + ".h5"), 64)
    integrity.fsck(cache)
    # Point the recipe at other bytes: the recomputed address differs.
    qmeta = os.path.join(cache, integrity.QUARANTINE_DIR, fp + ".json")
    with open(qmeta) as f:
        meta = json.load(f)
    meta["recipe"]["raw"] = os.path.join(a, "rec.0000.raw")
    with open(qmeta, "w") as f:
        json.dump(meta, f)
    rep = integrity.fsck(cache, repair=True, device="cpu")
    assert rep["repaired"] == [] and len(rep["repair_failed"]) == 1
    assert "fingerprint" in rep["repair_failed"][0]["why"]


def test_scrubber_finds_and_quarantines(pristine, tmp_path):
    a = _copy(pristine, str(tmp_path / "port"))
    cache = ProductCache(os.path.join(a, "cache"), ram_bytes=0)
    fps = sorted(cache.index())
    _flip(cache.data_path(fps[1]), 64)
    scrub = integrity.Scrubber(cache, interval_s=0.01, bytes_per_s=None)
    rows = [scrub.scrub_once() for _ in range(2)]
    assert [r["fp"] for r in rows] == fps
    assert [r["ok"] for r in rows] == [True, False]
    assert scrub.corrupt == 1 and cache.index() == fps[:1]
    assert os.listdir(os.path.join(a, "cache", ".quarantine"))
    rep = scrub.timeline.report()
    assert rep["integrity.scrub.ok"]["calls"] == 1
    assert rep["integrity.scrub.corrupt"]["calls"] == 1


def test_scrubber_thread_paces_and_stops(pristine, tmp_path):
    a = _copy(pristine, str(tmp_path / "port"))
    cache = ProductCache(os.path.join(a, "cache"), ram_bytes=0)
    with integrity.Scrubber(cache, interval_s=0.01) as scrub:
        deadline = time.monotonic() + 20
        while scrub.scrubbed < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert scrub.scrubbed >= 4 and scrub.corrupt == 0


def test_service_starts_the_scrubber_when_configured(tmp_path, monkeypatch):
    monkeypatch.setenv("BLIT_SCRUB_INTERVAL", "0.05")
    svc = ProductService(cache=ProductCache(str(tmp_path / "c"),
                                            ram_bytes=0), device="cpu")
    try:
        assert svc._scrubber is not None
    finally:
        svc.close()
    assert svc._scrubber is None


def test_quarantine_move_suffixes_collisions(tmp_path):
    for i in range(3):
        p = tmp_path / "x.fil"
        p.write_bytes(bytes([i]) * 8)
        moved = integrity.quarantine_move([str(p)], str(tmp_path))
        assert len(moved) == 1
    names = sorted(os.listdir(tmp_path / integrity.QUARANTINE_DIR))
    assert names == ["x.fil", "x.fil.1", "x.fil.2"]
    assert [integrity._strip_collision(n) for n in names] == ["x.fil"] * 3
    assert np.frombuffer((tmp_path / ".quarantine" / "x.fil.2").read_bytes(),
                         np.uint8)[0] == 2
