"""The port's orchestration API (blit_torch.gbt) held against blit.gbt on
the CPU, on one observation tree, under every pool backend: local,
thread, process (spawn) and remote (two local ``python -m
blit_torch.agent`` subprocesses).

Headers, inventories, data slabs (with idxs and an np.max fqav_func)
and host kurtosis maps are compared exactly; the port's kurtosis on
device="cpu" at blit's device-against-host bound (rtol 2e-3 / atol
2e-3, tests/test_stats.py:55); the reduce_raw fan-out's products at the
f32 bound of tests/test_torch_pipeline.py (rtol 1e-4, atol 1e-2 of the
noise-only coarse channel's peak) with header bytes identical, the
nbits=8 products byte-identical, and every backend's products
byte-identical to serial runs of the port.  load_scan is compared with
blit's for a whole band, a missing bank, duplicate banks, fqav_by and
an empty inventory.  on_error="capture" puts WorkerErrors where blit's
go.

Every test runs under a SIGALRM deadline, so an agent that never
answers fails its test instead of stalling the suite.
"""

import filecmp
import logging
import os
import signal

import numpy as np
import pytest

from blit import gbt as bgbt
from blit import testing as btesting
from blit.io import sigproc as bsigproc
from blit.parallel.pool import WorkerError as BWorkerError
from blit.parallel.pool import WorkerPool as BPool
from blit_torch import gbt
from blit_torch import workers as tworkers
from blit_torch.parallel import pool as pool_mod
from blit_torch.parallel.pool import WorkerError, WorkerPool
from blit_torch.parallel.remote import agent_env_with_repo, local_agent_command

pytest.importorskip("h5py")

BACKENDS = ["local", "thread", "process", "remote"]
HOSTS = ["blc00", "blc01", "blc02", "blc03"]
SESSION, SCAN = "AGBT22B_999_01", "0011"
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _pool(backend, hosts=HOSTS):
    if backend == "remote":
        return WorkerPool(hosts[:2], backend="remote",
                          transport=lambda host: local_agent_command(),
                          agent_env=agent_env_with_repo(), call_timeout=90.0,
                          ping_timeout=30.0)
    return WorkerPool(hosts, backend=backend)


@pytest.fixture(scope="module", params=BACKENDS)
def pool(request):
    p = _pool(request.param)
    yield p
    p.shutdown()


@pytest.fixture(scope="module")
def bpool():
    p = BPool(HOSTS, backend="local")
    yield p
    p.shutdown()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dibas"))
    players = tuple((0, b) for b in range(4)) + ((1, 0),)
    for kind in ("fil", "fbh5"):
        btesting.build_observation_tree(root, scans=(SCAN, "0012"), players=players,
                                        nsamps=16, nchans=128, kind=kind)
    return root


def _tuples(invs):
    return [[tuple(r) for r in inv] for inv in invs]


@pytest.mark.parametrize("file_re", [None, r"0002\.fil$"])
def test_get_inventories_equal_blit(pool, bpool, tree, file_re):
    got = gbt.get_inventories(file_re, pool=pool, root=tree)
    want = bgbt.get_inventories(file_re, pool=bpool, root=tree)[:len(pool)]
    assert len(got) == len(pool)
    assert _tuples(got) == _tuples(want)
    assert {r.worker for r in got[1]} == {2}
    assert {r.host for r in got[1]} == {HOSTS[1]}


def _files(tree, suffix):
    inv = bgbt.get_inventories(r"\." + suffix + "$", pool=BPool(["h"], backend="local"),
                               root=tree)[0]
    return sorted(r.file for r in inv if r.scan == SCAN)


@pytest.mark.parametrize("suffix", ["fil", "h5"])
def test_headers_data_kurtosis_equal_blit(pool, bpool, tree, suffix):
    files = _files(tree, suffix)
    wids = [1 + i % len(pool) for i in range(len(files))]
    assert gbt.get_headers(wids, files, pool=pool) == \
        bgbt.get_headers(wids, files, pool=bpool)
    for idxs, fqav_by, f in [((slice(None),) * 3, 1, None),
                             ((slice(2, 12), 0, slice(None)), 8, None),
                             ((slice(None), slice(None), slice(16, 80)), 4, np.max)]:
        got = gbt.get_data(wids, files, idxs, fqav_by, f, pool=pool)
        want = bgbt.get_data(wids, files, idxs, fqav_by, f, pool=bpool)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    want = bgbt.get_kurtosis(wids, files, pool=bpool)
    for g, w in zip(gbt.get_kurtosis(wids, files, device=False, pool=pool), want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(gbt.get_kurtosis(wids, files, device="cpu", pool=pool), want):
        assert g.shape == w.shape == (128, 1)
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def test_capture_puts_worker_errors_where_blit_does(pool, bpool, tree):
    # A pool of its own: the failures below trip worker 1's circuit
    # breaker on the remote backend (three in a row), as in blit.
    pool = _pool(pool.backend)
    try:
        _capture(pool, bpool, tree)
    finally:
        pool.shutdown()


def _capture(pool, bpool, tree):
    good = _files(tree, "fil")[:2]
    files = ["/nonexistent/a.fil", good[0], "/nonexistent/b.h5", good[1]]
    wids = [1, 2, 1, 2]
    got = gbt.get_headers(wids, files, pool=pool, on_error="capture")
    want = bgbt.get_headers(wids, files, pool=bpool, on_error="capture")
    assert [isinstance(g, WorkerError) for g in got] == \
        [isinstance(w, BWorkerError) for w in want] == [True, False, True, False]
    for g, w in zip(got, want):
        if isinstance(g, WorkerError):
            assert (g.worker, g.host) == (w.worker, w.host)
        else:
            assert g == w
    with pytest.raises(Exception):
        gbt.get_headers([1], ["/nonexistent/a.fil"], pool=pool)
    with pytest.raises(ValueError, match="same size"):
        gbt.get_headers([1, 2], ["x.fil"], pool=pool)
    with pytest.raises(ValueError, match="invalid worker ids"):
        gbt.get_data([0], ["x.fil"], pool=pool)


def _same_scan(got, want):
    assert sorted(got) == sorted(want)
    for band in want:
        (gh, gd), (wh, wd) = got[band], want[band]
        assert gh == wh
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("suffix", ["0002.fil", "0002.h5"])
@pytest.mark.parametrize("fqav_by", [1, 4])
def test_load_scan_equals_blit(pool, bpool, tree, suffix, fqav_by):
    invs = gbt.get_inventories(pool=pool, root=tree, file_re=suffix.replace(".", r"\.") + "$")
    binvs = bgbt.get_inventories(pool=bpool, root=tree,
                                 file_re=suffix.replace(".", r"\.") + "$")[:len(pool)]
    got = gbt.load_scan(invs, SESSION, SCAN, suffix=suffix, fqav_by=fqav_by, pool=pool)
    want = bgbt.load_scan(binvs, SESSION, SCAN, suffix=suffix, fqav_by=fqav_by,
                          pool=bpool)
    _same_scan(got, want)
    hdr, data = got[0]
    # Every worker saw every file: duplicates dropped, 4 banks stitched.
    assert data.shape == (16, 1, 4 * 128 // fqav_by)
    assert got[1][1].shape == (16, 1, 128 // fqav_by)


def test_load_scan_missing_duplicate_and_empty(pool, bpool, tree, caplog):
    invs = gbt.get_inventories(pool=pool, root=tree)
    binvs = bgbt.get_inventories(pool=bpool, root=tree)[:len(pool)]
    drop = lambda inv: [[r for r in i if r.bank != 2] for i in inv]
    with caplog.at_level(logging.WARNING, logger="blit_torch.gbt"):
        got = gbt.load_scan(drop(invs), SESSION, SCAN, pool=pool)
    assert any("only banks" in r.message for r in caplog.records)
    _same_scan(got, bgbt.load_scan(drop(binvs), SESSION, SCAN, pool=bpool))
    assert got[0][1].shape[-1] == 3 * 128
    # A second file claiming bank 1 of band 0: the first is kept, as in blit.
    first = invs[0]
    dup = [r._replace(file=r.file.replace("0011", "0011x"))
           for r in first if r.bank == 1 and r.band == 0 and r.scan == SCAN]
    bdup = [r._replace(file=r.file.replace("0011", "0011x"))
            for r in binvs[0] if r.bank == 1 and r.band == 0 and r.scan == SCAN]
    with caplog.at_level(logging.WARNING, logger="blit_torch.gbt"):
        got = gbt.load_scan([first + dup], SESSION, SCAN, pool=pool)
    assert any("multiple files" in r.message for r in caplog.records)
    _same_scan(got, bgbt.load_scan([binvs[0] + bdup], SESSION, SCAN, pool=bpool))
    ragged = [invs[0], WorkerError(2, "blc01", RuntimeError("x")), RuntimeError("bare")]
    bragged = [binvs[0], BWorkerError(2, "blc01", RuntimeError("x")), RuntimeError("bare")]
    _same_scan(gbt.load_scan(ragged, SESSION, SCAN, pool=pool),
               bgbt.load_scan(bragged, SESSION, SCAN, pool=bpool))
    assert gbt.load_scan([[]], "NOPE", "0000", pool=pool) == {}
    assert gbt.load_scan(invs, SESSION, "9999", pool=pool) == {}


# -- the reduce_raw fan-out ---------------------------------------------------

RAW_CHAN, RAW_NFFT, RAW_NINT = 4, 16, 2


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rawtree"))
    btesting.build_observation_tree(root, players=tuple((0, b) for b in range(4)),
                                    nchans=RAW_CHAN, kind="raw", nfiles=2,
                                    raw_ntime=512)
    return root


def _sequences(pool, root):
    invs = gbt.get_inventories(r"\.raw$", pool=pool, root=root)
    return gbt.raw_sequences([r for inv in invs for r in inv])


def _header_bytes(path):
    _, off = bsigproc.read_fil_header(path)
    with open(path, "rb") as f:
        return f.read(off)


@pytest.fixture(scope="module")
def blit_products(raw_tree, tmp_path_factory):
    """blit.gbt.reduce_raw over the same sequences, f32 and nbits=8."""
    d = tmp_path_factory.mktemp("blit_products")
    seqs = _sequences(WorkerPool(["h"], backend="local"), raw_tree)
    out = {}
    with BPool(["h0"], backend="local") as bp:
        for nbits in (32, 8):
            outs = [str(d / f"b{rec.bank}.{nbits}.fil") for rec, _ in seqs]
            bgbt.reduce_raw([1] * len(seqs), [p for _, p in seqs], outs, pool=bp,
                            nfft=RAW_NFFT, nint=RAW_NINT, async_output=False,
                            **_quant(nbits))
            out[nbits] = outs
    return out


def _quant(nbits):
    return {} if nbits == 32 else dict(nbits=8, quant_scale=0.01, quant_offset=3.0)


@pytest.mark.parametrize("nbits", [32, 8])
def test_reduce_raw_fanout_equals_blit_and_serial(pool, raw_tree, blit_products,
                                                  tmp_path, nbits):
    seqs = _sequences(pool, raw_tree)
    assert len(seqs) == 4 and all(len(p) == 2 for _, p in seqs)
    outs = [str(tmp_path / f"t{rec.bank}.fil") for rec, _ in seqs]
    wids = [1 + i % len(pool) for i in range(len(seqs))]
    hdrs = gbt.reduce_raw(wids, [p for _, p in seqs], outs, pool=pool, nfft=RAW_NFFT,
                          nint=RAW_NINT, device="cpu", **_quant(nbits))
    for (rec, paths), out, hdr, want in zip(seqs, outs, hdrs, blit_products[nbits]):
        serial = str(tmp_path / f"serial{rec.bank}.fil")
        tworkers.reduce_raw(paths, serial, nfft=RAW_NFFT, nint=RAW_NINT, device="cpu",
                            **_quant(nbits))
        assert filecmp.cmp(out, serial, shallow=False)
        assert hdr["nchans"] == RAW_CHAN * RAW_NFFT
        assert _header_bytes(out) == _header_bytes(want)
        if nbits == 8:
            assert filecmp.cmp(out, want, shallow=False)
            continue
        _, w = bsigproc.read_fil_data(want)
        _, g = bsigproc.read_fil_data(out)
        # The tone sits in coarse channel bank % 4; channel 3 is noise
        # only in banks 0-2, channel 0 in bank 3.
        quiet = 0 if rec.bank == 3 else 3
        peak = np.abs(w[..., quiet * RAW_NFFT:(quiet + 1) * RAW_NFFT]).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-2 * peak)
    with pytest.raises(ValueError, match="same size"):
        gbt.reduce_raw([1, 2], ["a.raw"], pool=pool)
    with pytest.raises(ValueError, match="out_paths"):
        gbt.reduce_raw([1], ["a.raw"], out_paths=["x", "y"], pool=pool)


def test_reduce_raw_fanout_in_memory(pool, raw_tree):
    seqs = _sequences(pool, raw_tree)[:2]
    got = gbt.reduce_raw([1, 2 if len(pool) > 1 else 1], [p for _, p in seqs],
                         pool=pool, nfft=RAW_NFFT, nint=RAW_NINT, device="cpu")
    for (_, paths), (hdr, data) in zip(seqs, got):
        h, d = tworkers.reduce_raw(paths, nfft=RAW_NFFT, nint=RAW_NINT, device="cpu")
        assert hdr == h
        np.testing.assert_array_equal(data, d)


def test_setup_workers_returns_the_live_pool():
    pool_mod.reset_pool()
    try:
        p1 = gbt.setup_workers(["a", "b"], backend="local")
        assert gbt.setup_workers(["c"], backend="local") is p1
        assert gbt.current_pool() is p1 and len(p1) == 2
        assert gbt._pool(None) is p1
    finally:
        pool_mod.reset_pool()
    with pytest.raises(RuntimeError, match="setup_workers"):
        gbt._pool(None)
    cfg = gbt.DEFAULT.with_(hosts=["x", "y", "z"], backend="local")
    try:
        assert gbt.setup_workers(config=cfg).hosts == ["x", "y", "z"]
    finally:
        pool_mod.reset_pool()


def test_process_backend_spawns():
    p = WorkerPool(["a"], backend="process")
    try:
        assert p._exec._mp_context.get_start_method() == "spawn"
        assert p.run_on([1], os.getpid, [()])[0] != os.getpid()
    finally:
        p.shutdown()


def test_thread_fanout_under_a_short_switch_interval_equals_serial(tmp_path):
    # More reducers than cores at once, the interpreter switching threads
    # every microsecond: the shared staging pool, kernel loader and
    # process timeline must leave every product as one reducer alone
    # writes it.
    import sys

    from blit_torch.testing import synth_raw

    n = 2 * (os.cpu_count() or 4)
    raws = []
    for k in range(n):
        p = str(tmp_path / f"s{k}.raw")
        synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=512, seed=k, tone_chan=k % 2)
        raws.append(p)
    outs = [p[:-4] + ".fil" for p in raws]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with WorkerPool([f"h{k}" for k in range(n)], backend="thread") as pool:
            gbt.reduce_raw(list(range(1, n + 1)), raws, outs, pool=pool, nfft=16,
                           nint=2, device="cpu")
    finally:
        sys.setswitchinterval(old)
    for raw, out in zip(raws, outs):
        serial = out + ".serial"
        tworkers.reduce_raw(raw, serial, nfft=16, nint=2, device="cpu")
        assert filecmp.cmp(out, serial, shallow=False)


def test_racing_setup_workers_build_one_pool():
    import sys
    import threading

    pool_mod.reset_pool()
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: got.append(gbt.setup_workers(["a", "b"], backend="local")))
            for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        pool_mod.reset_pool()
    assert len(got) == 32 and all(p is got[0] for p in got)


def test_launch_counts_are_exact_under_a_thread_pool():
    # The reducers of a thread pool count their kernels' launches at once;
    # no count may be lost (the smoke holds the fan-out's counts to the
    # serial runs' exactly).
    import sys

    from blit_torch import kernels

    def wrapper():
        pass

    wrapper.launches = 0
    n, each = 16, 2000

    def launch_many():
        for _ in range(each):
            kernels.count_launch(wrapper)
        kernels.count_launch(wrapper, 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with WorkerPool([f"h{k}" for k in range(n)], backend="thread") as pool:
            pool.broadcast(launch_many)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n * (each + 3)
