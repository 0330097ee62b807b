"""blit_torch's sharded plane, on the CPU.

Within the port (players seated on ``cpu``): the sharded plane's
products byte-identical to the pool path's and to the mesh loop's, as
blit's tests/test_sharded.py pins (``.fil``, ``.h5``, despiked, resumed
after a crash, and each player's ``.hits``).  Against blit: the sharded
products' headers byte-identical and their data within blit's channelize
bounds (rtol 1e-4, atol 1e-2 of the peak); the masked-antenna product
within the beamformer's (rtol 1e-4, atol 1e-3 of the peak); the knob
resolution, the gbt wrappers and the ``scan`` command line.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from blit_torch.io.sigproc import read_fil  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.parallel import mesh as M  # noqa: E402
from blit_torch.parallel.scan import (  # noqa: E402
    reduce_scan_mesh_to_files,
    reduce_scan_pool_to_files,
)
from blit_torch.parallel.sharded import (  # noqa: E402
    reduce_scan_sharded_to_files,
    search_scan_sharded_to_files,
)
from blit_torch.testing import synth_raw  # noqa: E402

NFFT, NINT, NCHAN, WF = 64, 2, 2, 4
CPU = "cpu"


def make_scan(tmp_path, nband=1, nbank=8, ntime=1024, nblocks=2):
    paths = []
    bank_bw = -187.5 / nbank
    for b in range(nband):
        row = []
        for k in range(nbank):
            p = str(tmp_path / f"blc{b}{k}.raw")
            synth_raw(p, nblocks=nblocks, obsnchan=NCHAN, ntime_per_block=ntime,
                      seed=b * 8 + k, tone_chan=k % NCHAN, obsbw=bank_bw,
                      obsfreq=8000.0 + b * 500.0 + (k + 0.5) * bank_bw)
            row.append(p)
        paths.append(row)
    return paths


def run_three_ways(paths, tmp_path, **kw):
    outs = {}
    for tag, fn in (("sharded", reduce_scan_sharded_to_files),
                    ("pool", reduce_scan_pool_to_files),
                    ("mesh", reduce_scan_mesh_to_files)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        outs[tag] = fn(paths, out_dir=str(d), nfft=NFFT, nint=NINT,
                       window_frames=WF, device=CPU, **kw)
    return outs


class TestByteIdentity:
    @pytest.mark.parametrize("nband,nbank", [(1, 8), (2, 4)])
    def test_fil_products_byte_identical(self, tmp_path, nband, nbank):
        outs = run_three_ways(make_scan(tmp_path, nband, nbank), tmp_path)
        assert sorted(outs["sharded"]) == sorted(outs["pool"]) == list(range(nband))
        for b, (sp, shdr) in outs["sharded"].items():
            assert filecmp.cmp(sp, outs["pool"][b][0], shallow=False)
            assert filecmp.cmp(sp, outs["mesh"][b][0], shallow=False)
            assert shdr["nsamps"] == outs["pool"][b][1]["nsamps"]

    @pytest.mark.parametrize("compression", ["gzip", "bitshuffle"])
    def test_h5_products_byte_identical(self, tmp_path, compression):
        pytest.importorskip("h5py")
        outs = run_three_ways(make_scan(tmp_path, 1, 8), tmp_path,
                              compression=compression)
        for b, (sp, _) in outs["sharded"].items():
            assert sp.endswith(".h5")
            assert filecmp.cmp(sp, outs["pool"][b][0], shallow=False)
            assert filecmp.cmp(sp, outs["mesh"][b][0], shallow=False)

    def test_despiked_and_averaged_byte_identical(self, tmp_path):
        paths = make_scan(tmp_path, 1, 8)
        for fq in (1, 4):
            d1, d2 = tmp_path / f"s{fq}", tmp_path / f"p{fq}"
            d1.mkdir(), d2.mkdir()
            w1 = reduce_scan_sharded_to_files(paths, out_dir=str(d1), nfft=NFFT,
                                              nint=NINT, window_frames=WF,
                                              despike=True, fqav_by=fq, device=CPU)
            w2 = reduce_scan_pool_to_files(paths, out_dir=str(d2), nfft=NFFT,
                                           nint=NINT, window_frames=WF,
                                           despike=True, fqav_by=fq, device=CPU)
            for b in w1:
                assert filecmp.cmp(w1[b][0], w2[b][0], shallow=False)

    def test_probe_reports_the_gather(self, tmp_path):
        paths = make_scan(tmp_path, 1, 8)
        (tmp_path / "out").mkdir()
        tl = Timeline()
        reduce_scan_sharded_to_files(paths, out_dir=str(tmp_path / "out"),
                                     nfft=NFFT, nint=NINT, window_frames=WF,
                                     probe_windows=2, timeline=tl, device=CPU)
        assert tl.stages["mesh.ici"].calls > 0 and tl.stages["mesh.ici"].bytes > 0
        assert tl.hists["mesh.gather_s"].n == 2
        assert tl.hists["mesh.gather_ici_bytes"].n == tl.stages["mesh.ici"].calls
        assert tl.stages["ingest"].bytes > 0 and tl.stages["transfer"].bytes > 0

    def test_headers_and_data_match_blit(self, tmp_path):
        from blit.parallel.sharded import reduce_scan_sharded_to_files as rsharded

        paths = make_scan(tmp_path, 2, 4)
        (tmp_path / "t").mkdir(), (tmp_path / "b").mkdir()
        tw = reduce_scan_sharded_to_files(paths, out_dir=str(tmp_path / "t"),
                                          nfft=NFFT, nint=NINT, window_frames=WF,
                                          device=CPU)
        bw = rsharded(paths, out_dir=str(tmp_path / "b"), nfft=NFFT, nint=NINT,
                      window_frames=WF)
        for b in bw:
            assert tw[b][1] == bw[b][1]
            (h, d), (bh, bd) = read_fil(tw[b][0]), read_fil(bw[b][0])
            assert h == bh
            n = os.path.getsize(tw[b][0]) - d.nbytes
            with open(tw[b][0], "rb") as f1, open(bw[b][0], "rb") as f2:
                assert f1.read(n) == f2.read(n)
            np.testing.assert_allclose(d, bd, rtol=1e-4, atol=1e-2 * np.abs(bd).max())


def _crash_at(monkeypatch, n):
    real = M.band_reduce
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == n:
            raise RuntimeError("synthetic crash")
        return real(*a, **kw)

    monkeypatch.setattr(M, "band_reduce", flaky)
    return lambda: monkeypatch.setattr(M, "band_reduce", real)


class TestResumeReplay:
    @pytest.mark.parametrize("suffix", ["fil", "h5"])
    def test_crash_resume_byte_identical(self, tmp_path, monkeypatch, suffix):
        if suffix == "h5":
            pytest.importorskip("h5py")
        paths = make_scan(tmp_path, 1, 8, nblocks=4)
        kw = dict(nfft=NFFT, nint=NINT, window_frames=WF, device=CPU)
        for d in ("gold", "pool", "res"):
            (tmp_path / d).mkdir()
        op = lambda d: [str(tmp_path / d / f"band0.{suffix}")]  # noqa: E731
        gw = reduce_scan_sharded_to_files(paths, out_paths=op("gold"), **kw)
        pw = reduce_scan_pool_to_files(paths, out_paths=op("pool"), **kw)
        restore = _crash_at(monkeypatch, 3)
        with pytest.raises(RuntimeError, match="synthetic crash"):
            reduce_scan_sharded_to_files(paths, out_paths=op("res"), resume=True,
                                         **kw)
        restore()
        assert [p for p in os.listdir(tmp_path / "res") if p.endswith(".cursor")]
        rw = reduce_scan_sharded_to_files(paths, out_paths=op("res"), resume=True,
                                          **kw)
        assert not [p for p in os.listdir(tmp_path / "res")
                    if p.endswith(".cursor")]
        for b in rw:
            assert filecmp.cmp(rw[b][0], gw[b][0], shallow=False)
            assert filecmp.cmp(rw[b][0], pw[b][0], shallow=False)


class TestSearch:
    WSPEC = 4

    def _kw(self, wf):
        return dict(nfft=NFFT, nint=NINT, window_spectra=self.WSPEC,
                    window_frames=wf, snr_threshold=4.0, device=CPU)

    def _direct(self, path, out, wf):
        from blit_torch.search import DedopplerReducer

        DedopplerReducer(nfft=NFFT, nint=NINT, window_spectra=self.WSPEC,
                         snr_threshold=4.0, chunk_frames=wf,
                         device=CPU).search_to_file(path, out)

    @pytest.mark.parametrize("nband,nbank", [(1, 8), (2, 4)])
    def test_hits_byte_identical_to_pool_reducers(self, tmp_path, nband, nbank):
        paths = make_scan(tmp_path, nband, nbank)
        (tmp_path / "s").mkdir(), (tmp_path / "p").mkdir()
        written = search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "s"),
                                               **self._kw(16))
        assert sorted(written) == [(b, k) for b in range(nband) for k in range(nbank)]
        for (b, k), (spath, shdr) in written.items():
            out = str(tmp_path / "p" / f"band{b}bank{k}.hits")
            self._direct(paths[b][k], out, 16)
            assert filecmp.cmp(spath, out, shallow=False), (b, k)
            assert shdr["search_windows"] > 0

    def test_hits_header_lines_match_blit(self, tmp_path):
        from blit.parallel.sharded import search_scan_sharded_to_files as rsearch

        paths = make_scan(tmp_path, 1, 2)
        (tmp_path / "t").mkdir(), (tmp_path / "b").mkdir()
        kw = self._kw(16)
        kw.pop("device")
        tw = search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "t"),
                                          device=CPU, **kw)
        bw = rsearch(paths, out_dir=str(tmp_path / "b"), kernel="reference", **kw)
        for key in bw:
            with open(tw[key][0]) as f1, open(bw[key][0]) as f2:
                assert f1.readline() == f2.readline()
            assert tw[key][1]["search_windows"] == bw[key][1]["search_windows"]

    def test_crash_resume_byte_identical(self, tmp_path, monkeypatch):
        from blit_torch.search.dedoppler import SearchCursor

        paths = make_scan(tmp_path, 1, 8, nblocks=4)
        kw = self._kw(8)
        (tmp_path / "gold").mkdir(), (tmp_path / "res").mkdir()
        gw = search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "gold"), **kw)
        restore = _crash_at(monkeypatch, 3)
        with pytest.raises(RuntimeError, match="synthetic crash"):
            search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "res"),
                                         resume=True, **kw)
        restore()
        cur = SearchCursor.load(str(tmp_path / "res" / "band0bank0.hits"))
        assert cur is not None and cur.window_claims is not None
        rw = search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "res"),
                                          resume=True, **kw)
        assert not [p for p in os.listdir(tmp_path / "res") if p.endswith(".cursor")]
        for key, (spath, _) in rw.items():
            assert filecmp.cmp(spath, gw[key][0], shallow=False), key

    def test_resume_restarts_at_the_earlier_agreed_window(self, tmp_path,
                                                           monkeypatch):
        from blit_torch.search.dedoppler import SearchCursor

        paths = make_scan(tmp_path, 1, 8, nblocks=4)
        kw = self._kw(8)
        (tmp_path / "gold").mkdir(), (tmp_path / "res").mkdir()
        gw = search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "gold"), **kw)
        restore = _crash_at(monkeypatch, 3)
        with pytest.raises(RuntimeError):
            search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "res"),
                                         resume=True, **kw)
        restore()
        # One player rolled back a window: every player restarts at the
        # pod's minimum.
        target = str(tmp_path / "res" / "band0bank3.hits")
        cur = SearchCursor.load(target)
        assert cur.windows_done >= 2
        back = cur.windows_done - 1
        off, hits = cur.claim_at(back)
        cur.windows_done, cur.byte_offset, cur.hits_done = back, off, hits
        cur.window_claims = [e for e in cur.window_claims if e[0] <= back]
        cur.save(target)
        with open(target, "r+b") as f:
            f.truncate(off)
        rw = search_scan_sharded_to_files(paths, out_dir=str(tmp_path / "res"),
                                          resume=True, **kw)
        for key, (spath, _) in rw.items():
            assert filecmp.cmp(spath, gw[key][0], shallow=False), key

    def test_refuses_other_kernels(self, tmp_path):
        paths = make_scan(tmp_path, 1, 2)
        with pytest.raises(ValueError, match="one route"):
            search_scan_sharded_to_files(paths, out_dir=str(tmp_path),
                                         kernel="pallas", **self._kw(16))


class _Stub:
    """A hand-fed window: the consumer contract without a producer."""

    def __init__(self, index, arrays, ntime):
        self.index, self.arrays, self.ntime = index, arrays, ntime
        self.masked = ()

    def release(self):
        pass


class TestMaskedAntenna:
    NANT, W, TOTAL, START = 4, 128, 896, 48

    @pytest.fixture()
    def ant_files(self, tmp_path):
        paths = []
        for a in range(self.NANT):
            p = str(tmp_path / f"ant{a}.raw")
            synth_raw(p, nblocks=2, obsnchan=4, ntime_per_block=480,
                      seed=200 + a, tone_chan=a % 4)
            paths.append(p)
        return paths

    def _weights(self):
        rng = np.random.default_rng(5)
        return (rng.standard_normal((3, self.NANT, 4))
                + 1j * rng.standard_normal((3, self.NANT, 4))).astype(np.complex64)

    @pytest.mark.parametrize("prefetch_depth", [1, 2])
    def test_masked_accumulate_matches_zero_filled_and_blit(self, ant_files,
                                                            prefetch_depth):
        from blit import faults as rfaults
        from blit.faults import FaultRule as RFaultRule
        from blit.parallel import antenna as RA
        from blit.parallel import beamform as RB
        from blit.parallel.mesh import make_mesh as r_make_mesh

        from blit_torch import faults
        from blit_torch.faults import FaultRule
        from blit_torch.parallel import antenna as TA
        from blit_torch.parallel import beamform as TB

        w = self._weights()
        tw = (torch.from_numpy(w.real.copy()), torch.from_numpy(w.imag.copy()))
        mesh = M.make_mesh(1, 4, devices=[CPU] * 4)
        faults.clear()
        try:
            faults.install(FaultRule("guppi.read", "truncate", times=1, after=2,
                                     match="ant2"))
            feed = TA.AntennaStream(ant_files, mesh=mesh, window_samples=self.W,
                                    start_sample=self.START, max_samples=self.TOTAL,
                                    on_antenna_error="mask",
                                    prefetch_depth=prefetch_depth)
            seen = []

            def spy(f):
                for win in f:
                    seen.append(win.masked)
                    yield win

            got = TB.beamform_accumulate(spy(feed), tw, mesh=mesh).numpy()
        finally:
            faults.clear()
        assert feed.masked_antennas == {2}
        assert feed.header["_masked_antennas"] == [2]
        wmask = next(i for i, m in enumerate(seen) if m)
        assert 0 < wmask < feed.nwindows
        # The zero-filled golden: the same accumulation over windows cut
        # from planes with antenna 2 zeroed from the masked window on.
        _, (vr, vi) = TA.load_antennas_mesh(ant_files, mesh=mesh,
                                            start_sample=self.START,
                                            max_samples=self.TOTAL)
        zr, zi = np.asarray(vr).copy(), np.asarray(vi).copy()
        zr[2, :, wmask * self.W:] = 0
        zi[2, :, wmask * self.W:] = 0
        stubs = [_Stub(i, (torch.from_numpy(zr[:, :, s:s + self.W].copy()),
                           torch.from_numpy(zi[:, :, s:s + self.W].copy())), self.W)
                 for i, s in enumerate(range(0, self.TOTAL, self.W))]
        want = TB.beamform_accumulate(iter(stubs), tw, mesh=mesh).numpy()
        np.testing.assert_array_equal(got, want)
        # blit's masked product on its own mesh.
        rmesh = r_make_mesh(1, 4)
        ws = RB.weight_sharding(rmesh)
        wput = (jax.device_put(w.real.astype(np.float32), ws),
                jax.device_put(w.imag.astype(np.float32), ws))
        rfaults.clear()
        try:
            rfaults.install(RFaultRule("guppi.read", "truncate", times=1, after=2,
                                       match="ant2"))
            rfeed = RA.AntennaStream(ant_files, mesh=rmesh, window_samples=self.W,
                                     start_sample=self.START,
                                     max_samples=self.TOTAL,
                                     on_antenna_error="mask")
            ref = np.asarray(RB.beamform_accumulate(rfeed, wput, mesh=rmesh))
        finally:
            rfaults.clear()
        assert rfeed.masked_antennas == {2}
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3 * np.abs(ref).max())

    def test_masked_correlator_stream_matches_blit(self, ant_files):
        from blit import faults as rfaults
        from blit.faults import FaultRule as RFaultRule
        from blit.parallel import antenna as RA
        from blit.parallel import correlator as RC
        from blit.parallel.mesh import make_mesh as r_make_mesh

        from blit_torch import faults
        from blit_torch.faults import FaultRule
        from blit_torch.ops.channelize import pfb_coeffs
        from blit_torch.parallel import antenna as TA
        from blit_torch.parallel import correlator as TC

        nfft = 32
        h = pfb_coeffs(4, nfft)
        mesh = M.make_mesh(1, 2, devices=[CPU] * 2)
        faults.clear()
        try:
            faults.install(FaultRule("guppi.read", "truncate", times=1, after=2,
                                     match="ant1"))
            feed = TA.CorrelatorStream(ant_files, mesh=mesh, nfft=nfft,
                                       window_frames=5, on_antenna_error="mask")
            got = TC.correlate_stream(feed, h, nfft=nfft, mesh=mesh)
        finally:
            faults.clear()
        assert feed.masked_antennas == {1}
        assert feed.header["_masked_antennas"] == [1]
        rmesh = r_make_mesh(1, 2)
        rfaults.clear()
        try:
            rfaults.install(RFaultRule("guppi.read", "truncate", times=1, after=2,
                                       match="ant1"))
            rfeed = RA.CorrelatorStream(ant_files, mesh=rmesh, nfft=nfft,
                                        window_frames=5, on_antenna_error="mask")
            ref = RC.correlate_stream(rfeed, jax.numpy.asarray(h), nfft=nfft,
                                      mesh=rmesh)
        finally:
            rfaults.clear()
        assert rfeed.masked_antennas == {1}
        for g, r in zip(got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                       atol=1e-3 * np.abs(r).max())


class TestMeshDefaults:
    @pytest.mark.parametrize("env", [
        {},
        {"BLIT_MESH_SHARDED": "1", "BLIT_MESH_PROBE": "5",
         "BLIT_MESH_PREFETCH": "3", "BLIT_MESH_OUT_DEPTH": "4"},
        {"BLIT_MESH_SHARDED": "0", "BLIT_MESH_PREFETCH": "-1"},
        {"BLIT_MESH_SHARDED": "false", "BLIT_MESH_OUT_DEPTH": ""},
    ])
    def test_equal_to_blits_under_the_same_env(self, monkeypatch, env):
        from blit.config import SiteConfig as RSiteConfig
        from blit.config import mesh_defaults as r_mesh_defaults

        from blit_torch.config import SiteConfig, mesh_defaults

        for k in ("BLIT_MESH_SHARDED", "BLIT_MESH_PROBE", "BLIT_MESH_PREFETCH",
                  "BLIT_MESH_OUT_DEPTH"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert mesh_defaults(SiteConfig()) == r_mesh_defaults(RSiteConfig())

    def test_site_config_fields_match(self):
        from blit.config import SiteConfig as RSiteConfig

        from blit_torch.config import SiteConfig

        for f in ("mesh_shape", "mesh_sharded", "mesh_probe_windows",
                  "mesh_prefetch_depth", "mesh_out_depth", "recover_lease_ttl_s",
                  "recover_poll_s", "recover_max_attempts", "recover_grace_s"):
            assert getattr(SiteConfig(), f) == getattr(RSiteConfig(), f), f


class TestGbtWrappers:
    def test_wrappers_forward(self, tmp_path):
        from blit_torch import gbt

        paths = make_scan(tmp_path, 1, 2)
        for name in ("load_scan_mesh", "reduce_scan_mesh_to_files",
                     "reduce_scan_sharded_to_files", "reduce_scan_pool_to_files",
                     "search_scan_sharded_to_files"):
            assert callable(getattr(gbt, name)), name
        (tmp_path / "a").mkdir(), (tmp_path / "b").mkdir()
        a = gbt.reduce_scan_sharded_to_files(paths, out_dir=str(tmp_path / "a"),
                                             nfft=NFFT, nint=NINT,
                                             window_frames=WF, device=CPU)
        b = gbt.reduce_scan_pool_to_files(paths, out_dir=str(tmp_path / "b"),
                                          nfft=NFFT, nint=NINT, window_frames=WF,
                                          device=CPU)
        assert filecmp.cmp(a[0][0], b[0][0], shallow=False)
        hdr, out = gbt.load_scan_mesh(paths, nfft=NFFT, nint=NINT, device=CPU)
        assert hdr["nchans"] == out.shape[-1] == 2 * NCHAN * NFFT


class TestScanCLI:
    def _tree(self, tmp_path):
        from blit_torch.testing import build_observation_tree

        root = str(tmp_path / "datax")
        build_observation_tree(root, kind="raw", players=((0, 0), (0, 1)),
                               nchans=2, nfiles=2, raw_ntime=512)
        return root

    def _run(self, capsys, *args):
        from blit_torch.__main__ import main

        rc = main(list(args) + ["--device", CPU])
        return rc, capsys.readouterr().out

    @pytest.mark.parametrize("flag", ["--sharded", "--mesh-loop"])
    def test_scan_matches_pool_flag_and_blit(self, tmp_path, capsys, flag):
        root = self._tree(tmp_path)
        d1, d2 = tmp_path / "s", tmp_path / "p"
        d1.mkdir(), d2.mkdir()
        common = ("scan", root, "AGBT22B_999_01", "0011", "--nfft", "64",
                  "--nint", "2", "--window-frames", "4")
        extra = () if flag == "--mesh-loop" else (flag,)
        rc1, txt1 = self._run(capsys, *common, "-o", str(d1), *extra)
        rc2, txt2 = self._run(capsys, *common, "-o", str(d2), "--pool")
        assert rc1 == rc2 == 0
        assert filecmp.cmp(str(d1 / "band0.fil"), str(d2 / "band0.fil"),
                           shallow=False)
        s1 = json.loads(txt1.strip().splitlines()[-1])
        assert s1["parallel"] == ("sharded" if flag == "--sharded" else "mesh")
        assert json.loads(txt2.strip().splitlines()[-1])["parallel"] == "pool"
        band = json.loads(txt1.strip().splitlines()[0])
        from blit.__main__ import main as rmain

        d3 = tmp_path / "blit"
        d3.mkdir()
        assert rmain(list(common) + ["-o", str(d3), "--pool"]) == 0
        rband = json.loads(capsys.readouterr().out.strip().splitlines()[0])
        assert band == dict(rband, output=band["output"])

    def test_scan_sharded_env_default(self, tmp_path, capsys, monkeypatch):
        root = self._tree(tmp_path)
        monkeypatch.setenv("BLIT_MESH_SHARDED", "1")
        (tmp_path / "o").mkdir()
        rc, txt = self._run(capsys, "scan", root, "AGBT22B_999_01", "0011", "-o",
                            str(tmp_path / "o"), "--nfft", "64", "--nint", "2",
                            "--window-frames", "4")
        assert rc == 0
        assert json.loads(txt.strip().splitlines()[-1])["parallel"] == "sharded"

    def test_scan_search_sharded_vs_pool(self, tmp_path, capsys):
        root = self._tree(tmp_path)
        d1, d2 = tmp_path / "s", tmp_path / "p"
        d1.mkdir(), d2.mkdir()
        common = ("scan", root, "AGBT22B_999_01", "0011", "--nfft", "64",
                  "--nint", "2", "--window-frames", "16", "--search",
                  "--window-spectra", "4", "--snr", "4")
        rc1, _ = self._run(capsys, *common, "-o", str(d1), "--sharded")
        rc2, _ = self._run(capsys, *common, "-o", str(d2), "--pool")
        assert rc1 == rc2 == 0
        names = sorted(p.name for p in d1.glob("*.hits"))
        assert names == sorted(p.name for p in d2.glob("*.hits")) and names
        for name in names:
            assert filecmp.cmp(str(d1 / name), str(d2 / name), shallow=False)

    def test_scan_refusals(self, tmp_path, capsys):
        root = self._tree(tmp_path)
        common = ("scan", root, "AGBT22B_999_01", "0011", "-o", str(tmp_path))
        for extra, msg in ((("--search", "--resume"), "--resume"),
                           (("--search", "--fqav", "2"), "--fqav"),
                           (("--pool", "--resume"), "--resume")):
            with pytest.raises(SystemExit, match=msg):
                self._run(capsys, *common, *extra)
        # --trace-logdir is taken (it used to be refused): the scan runs
        # and leaves a torch.profiler trace.
        trace = tmp_path / "trace"
        (tmp_path / "traced").mkdir()
        rc, _ = self._run(capsys, "scan", root, "AGBT22B_999_01", "0011",
                          "-o", str(tmp_path / "traced"), "--nfft", "64",
                          "--window-frames", "4", "--trace-logdir",
                          str(trace))
        assert rc == 0 and list(trace.glob("*.pt.trace.json"))
