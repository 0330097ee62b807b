"""blit_torch's pods: real multi-process runs over ``torch.distributed``.

Two OS processes on the CPU, a localhost rendezvous on a free port, gloo,
disjoint local players and per-process file locality
(tests/_torch_mh_sharded_child.py, tests/_torch_mh_psum_child.py, after
blit's tests/_mh_sharded_child.py and _mh_psum_child.py).  The sharded
pod's products are byte-identical to the single-process pool oracle over
the same seeded scan, one band row a process and with the band row split
across the processes (the stitch then gathers through the process
group); the band-axis psums of the beamformer and the correlator match
blit's NumPy goldens (rtol 1e-4, atol 1e-4 of the peak).  Every test
has a SIGALRM deadline and kills its children when it fails.
"""

import filecmp
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from blit_torch.parallel import multihost  # noqa: E402
from blit_torch.parallel.scan import reduce_scan_pool_to_files  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SHARDED_CHILD = os.path.join(HERE, "_torch_mh_sharded_child.py")
PSUM_CHILD = os.path.join(HERE, "_torch_mh_psum_child.py")
DEADLINE_S = 150


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pod(child, outdir, *extra, nproc=2):
    """Start ``nproc`` children, wait for all; on any failure kill and
    reap every child and fail with the failing child's stderr."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    try:
        for pid in range(nproc):
            err = open(os.path.join(outdir, f"child{pid}.err"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, child, str(pid), str(nproc), port, str(outdir),
                 *map(str, extra)], env=env, stdout=subprocess.DEVNULL,
                stderr=err))
            err.close()
        for pid, p in enumerate(procs):
            rc = p.wait(timeout=DEADLINE_S - 20)
            if rc != 0:
                with open(os.path.join(outdir, f"child{pid}.err")) as f:
                    pytest.fail(f"child {pid} exited {rc}:\n{f.read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def _scan(tmp_path, nband, nbank):
    bank_bw = -187.5 / nbank
    paths = []
    for b in range(nband):
        row = []
        for k in range(nbank):
            p = str(tmp_path / f"golden_blc{b}{k}.raw")
            synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=512,
                      seed=b * 8 + k, tone_chan=k % 2, obsbw=bank_bw,
                      obsfreq=8000.0 + b * 500.0 + (k + 0.5) * bank_bw)
            row.append(p)
        paths.append(row)
    return paths


class TestShardedPod:
    @pytest.mark.parametrize("nband,nbank", [(2, 4), (1, 8)])
    def test_pod_writes_the_pool_oracles_bytes(self, tmp_path, nband, nbank):
        pod = tmp_path / "pod"
        pod.mkdir()
        _run_pod(SHARDED_CHILD, pod, nband, nbank)
        reports = [json.load(open(pod / f"proc{p}.json")) for p in range(2)]
        # Disjoint players, the pod's bands written once each.
        players = sorted(tuple(x) for r in reports for x in r["local"])
        assert players == [(b, k) for b in range(nband) for k in range(nbank)]
        assert sorted(b for r in reports for b in r["bands"]) == list(range(nband))
        assert all(r["ici_calls"] > 0 and r["gather_s_n"] == 2 for r in reports)
        (tmp_path / "oracle").mkdir()
        oracle = reduce_scan_pool_to_files(
            _scan(tmp_path, nband, nbank), out_dir=str(tmp_path / "oracle"),
            nfft=32, nint=2, despike=True, window_frames=4, device="cpu")
        for b, (path, hdr) in oracle.items():
            got = pod / "products" / os.path.basename(path)
            assert filecmp.cmp(str(got), path, shallow=False), f"band {b}"
            assert hdr["nsamps"] == sum(int(r["nsamps"].get(str(b), 0))
                                        for r in reports)


class TestPsumPod:
    def test_band_axis_psums_match_blits_goldens(self, tmp_path):
        from blit.parallel.beamform import beamform_np
        from blit.parallel.correlator import correlate_np

        from blit_torch.ops.channelize import pfb_coeffs

        _run_pod(PSUM_CHILD, tmp_path)
        rng = np.random.default_rng(11)
        nant, nchan, ntime, npol, nbeam = 8, 4, 512, 2, 3
        v = (rng.integers(-20, 21, (nant, nchan, ntime, npol))
             + 1j * rng.integers(-20, 21, (nant, nchan, ntime, npol))
             ).astype(np.complex64)
        w = (rng.standard_normal((nbeam, nant, nchan))
             + 1j * rng.standard_normal((nbeam, nant, nchan))).astype(np.complex64)
        want_p = beamform_np(v, w, nint=4)
        want_v = correlate_np(v, pfb_coeffs(4, 32), 32, 4, nsegments=2)
        for pid in range(2):
            p = np.load(tmp_path / f"power{pid}.npy")
            vis = np.load(tmp_path / f"vis{pid}.npy")
            np.testing.assert_allclose(p, want_p, rtol=1e-4,
                                       atol=1e-4 * np.abs(want_p).max())
            np.testing.assert_allclose(vis, want_v, rtol=1e-4,
                                       atol=1e-4 * np.abs(want_v).max())
        # Every process holds the same whole result.
        assert np.array_equal(np.load(tmp_path / "vis0.npy"),
                              np.load(tmp_path / "vis1.npy"))


class TestBringUp:
    def test_no_coordinator_is_single_and_starts_no_group(self, monkeypatch):
        import torch.distributed as dist

        for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(v, raising=False)
        assert multihost.init_multihost() is False
        assert multihost.init_multihost() is False  # idempotent
        assert not multihost.in_pod() and not dist.is_initialized()
        assert multihost.process_index() == 0 and multihost.process_count() == 1
        multihost.shutdown()

    def test_an_explicit_coordinator_never_degrades(self):
        with pytest.raises(ValueError, match="num_processes and process_id"):
            multihost.init_multihost(coordinator_address="127.0.0.1:1")
        with pytest.raises(ValueError, match="outside"):
            multihost.init_multihost("127.0.0.1:1", num_processes=2, process_id=2)
        with pytest.raises(ValueError, match="coordinator_address"):
            multihost.init_multihost(num_processes=2, process_id=0)
        with pytest.raises(ValueError, match="backend"):
            multihost.init_multihost(f"127.0.0.1:{_free_port()}", num_processes=1,
                                     process_id=0, backend="mpi", device="cpu")
        assert not multihost.in_pod()

    def test_nccl_refuses_two_ranks_on_one_card(self):
        # Both ranks declare cuda:0: the seats are compared through the
        # pod's store before any communicator exists, and every rank
        # raises the same ValueError naming the rule.
        port = _free_port()
        errors = [None, None]

        def rank(r):
            try:
                multihost.init_multihost(f"127.0.0.1:{port}", num_processes=2,
                                         process_id=r, backend="nccl",
                                         device="cuda:0", timeout_s=30)
            except Exception as e:  # noqa: BLE001 — inspected below
                errors[r] = e

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for e in errors:
            assert isinstance(e, ValueError), e
            assert "NCCL cannot seat two ranks on one GPU" in str(e)
            assert "backend='gloo'" in str(e)
        assert not multihost.in_pod()

    def test_nccl_seat_rule(self):
        multihost.check_nccl_seats(["h|cuda-uuid:a", "h|cuda-uuid:b"])
        with pytest.raises(ValueError, match="ranks \\[0, 2\\]"):
            multihost.check_nccl_seats(["h|cuda:0", "h|cuda:1", "h|cuda:0"])
        with pytest.raises(ValueError, match="needs a CUDA device"):
            multihost.check_nccl_seats(["h|cpu"])

    def test_one_process_gloo_pod_runs_its_collectives(self, tmp_path):
        import torch
        import torch.distributed as dist

        from blit_torch.parallel import mesh as M
        from blit_torch.parallel.scan import _gather_int64

        try:
            assert multihost.init_multihost(f"127.0.0.1:{_free_port()}",
                                            num_processes=1, process_id=0,
                                            backend="gloo", device="cpu") is False
            assert multihost.in_pod() and dist.is_initialized()
            assert multihost.backend() == "gloo"
            got = _gather_int64(np.array([5, 1 << 50], np.int64))
            assert got.tolist() == [[5, 1 << 50]]
            m = M.make_mesh(1, 2, devices=["cpu", "cpu"])
            assert m.nprocs() == 1
            blocks, staged = multihost.all_gather_tensor(torch.arange(3))
            assert staged == 0 and blocks[0].tolist() == [0, 1, 2]
            with pytest.raises(ValueError, match="already rank 0"):
                multihost.init_multihost("127.0.0.1:1", num_processes=2,
                                         process_id=1)
        finally:
            multihost.shutdown()
        assert not dist.is_initialized()
