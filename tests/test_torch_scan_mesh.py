"""blit_torch's mesh scan loader and mesh loop against blit's, on the CPU.

The same seeded per-player RAW files go through ``blit.parallel.scan``
(8 virtual CPU devices) and ``blit_torch.parallel.scan`` (players seated
on ``cpu``): headers equal, f32 data within blit's channelize bounds
(rtol 1e-4, atol 1e-2 of the peak), and within the port the mesh loop's
products byte-identical to the pool path's (tests/test_sharded.py's
contract).
"""

import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from blit.parallel import scan as RS  # noqa: E402
from blit_torch.io.sigproc import read_fil  # noqa: E402
from blit_torch.parallel import mesh as M  # noqa: E402
from blit_torch.parallel import scan as TS  # noqa: E402
from blit_torch.testing import build_observation_tree, synth_raw  # noqa: E402

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


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-2 * np.abs(want).max())


class TestLoadScanMesh:
    @pytest.mark.parametrize("nband,nbank", [(1, 8), (2, 4)])
    @pytest.mark.parametrize("despike,fqav_by", [(False, 1), (True, 1), (True, 4)])
    def test_matches_blit(self, tmp_path, nband, nbank, despike, fqav_by):
        paths = make_scan(tmp_path, nband, nbank)
        rhdr, rout = RS.load_scan_mesh(paths, nfft=NFFT, nint=NINT,
                                       despike=despike, fqav_by=fqav_by)
        hdr, out = TS.load_scan_mesh(paths, nfft=NFFT, nint=NINT, despike=despike,
                                     fqav_by=fqav_by, device=CPU)
        assert hdr == rhdr
        assert out.shape == tuple(rout.shape)
        close(np.asarray(out), np.asarray(rout))

    def test_session_form_through_inventories(self, tmp_path):
        from blit_torch.inventory import get_inventory

        root = str(tmp_path / "datax")
        build_observation_tree(root, kind="raw", players=((0, 0), (0, 1)),
                               nchans=2, nfiles=2, raw_ntime=512)
        invs = [get_inventory(r"\.raw$", root=root)]
        hdr, out = TS.load_scan_mesh("AGBT22B_999_01", "0011", inventories=invs,
                                     nfft=NFFT, nint=NINT, device=CPU)
        from blit.inventory import get_inventory as r_get_inventory

        rhdr, rout = RS.load_scan_mesh(
            "AGBT22B_999_01", "0011",
            inventories=[r_get_inventory(r"\.raw$", root=root)],
            nfft=NFFT, nint=NINT)
        assert hdr == rhdr
        close(np.asarray(out), np.asarray(rout))

    def test_max_frames_and_default_mesh(self, tmp_path):
        paths = make_scan(tmp_path, 1, 2)
        hdr, out = TS.load_scan_mesh(paths, nfft=NFFT, nint=NINT, max_frames=5,
                                     device=CPU)
        assert hdr["nsamps"] == out.shape[1] == 2
        assert out.mesh.devices.shape == (1, 2)


class TestMeshLoop:
    @pytest.mark.parametrize("nband,nbank", [(1, 8), (2, 4)])
    def test_mesh_equals_pool_bytes_and_blit(self, tmp_path, nband, nbank):
        paths = make_scan(tmp_path, nband, nbank)
        outs = {}
        for tag, fn in (("mesh", TS.reduce_scan_mesh_to_files),
                        ("pool", TS.reduce_scan_pool_to_files),
                        ("blit", RS.reduce_scan_mesh_to_files)):
            d = tmp_path / tag
            d.mkdir()
            kw = {} if tag == "blit" else {"device": CPU}
            outs[tag] = fn(paths, out_dir=str(d), nfft=NFFT, nint=NINT,
                           window_frames=WF, **kw)
        assert sorted(outs["mesh"]) == sorted(outs["pool"]) == sorted(outs["blit"])
        for b, (path, hdr) in outs["mesh"].items():
            assert filecmp.cmp(path, outs["pool"][b][0], shallow=False)
            assert hdr == outs["pool"][b][1] == outs["blit"][b][1]
            (h, d), (rh, rd) = read_fil(path), read_fil(outs["blit"][b][0])
            assert h == rh and d.shape == rd.shape
            with open(path, "rb") as f1, open(outs["blit"][b][0], "rb") as f2:
                n = os.path.getsize(path) - d.nbytes
                assert f1.read(n) == f2.read(n)  # header bytes
            close(d, rd)

    def test_crash_resume_byte_identical(self, tmp_path, monkeypatch):
        paths = make_scan(tmp_path, 1, 4, nblocks=4)
        gold, res = tmp_path / "gold", tmp_path / "res"
        gold.mkdir(), res.mkdir()
        gw = TS.reduce_scan_mesh_to_files(paths, out_dir=str(gold), nfft=NFFT,
                                          nint=NINT, window_frames=WF, device=CPU)
        real = M.band_reduce
        calls = []

        def flaky(*a, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("synthetic crash")
            return real(*a, **kw)

        monkeypatch.setattr(M, "band_reduce", flaky)
        with pytest.raises(RuntimeError, match="synthetic crash"):
            TS.reduce_scan_mesh_to_files(paths, out_dir=str(res), nfft=NFFT,
                                         nint=NINT, window_frames=WF,
                                         resume=True, device=CPU)
        monkeypatch.setattr(M, "band_reduce", real)
        assert [p for p in os.listdir(res) if p.endswith(".cursor")]
        rw = TS.reduce_scan_mesh_to_files(paths, out_dir=str(res), nfft=NFFT,
                                          nint=NINT, window_frames=WF,
                                          resume=True, device=CPU)
        assert not [p for p in os.listdir(res) if p.endswith(".cursor")]
        for b in rw:
            assert filecmp.cmp(rw[b][0], gw[b][0], shallow=False)


class TestAgreementAndErrors:
    def test_gather_int64_outside_a_pod(self):
        got = TS._gather_int64(np.array([3, 1 << 40], np.int64))
        assert got.shape == (1, 2) and got[0, 1] == 1 << 40
        with pytest.raises(ValueError, match=r"\[0, 2\^62\)"):
            TS._gather_int64(np.array([-1], np.int64))

    def test_refusals(self, tmp_path):
        paths = make_scan(tmp_path, 1, 2)
        with pytest.raises(ValueError, match="rectangular"):
            TS.load_scan_mesh([paths[0], paths[0][:1]], nfft=NFFT, device=CPU)
        with pytest.raises(ValueError, match="failed to open on their owning"):
            TS.load_scan_mesh([[paths[0][0], str(tmp_path / "nope.raw")]],
                              nfft=NFFT, device=CPU)
        with pytest.raises(ValueError, match="does not match"):
            TS.load_scan_mesh(paths, nfft=NFFT,
                              mesh=M.make_mesh(1, 4, devices=[CPU] * 4))
        with pytest.raises(ValueError, match="session-form"):
            TS.load_scan_mesh("AGBT22B_999_01", nfft=NFFT, device=CPU)
        with pytest.raises(ValueError, match="out_paths"):
            TS.reduce_scan_mesh_to_files(paths, out_paths=["a.fil", "b.fil"],
                                         nfft=NFFT, device=CPU)
        with pytest.raises(ValueError, match="compression"):
            TS.reduce_scan_mesh_to_files(paths, out_paths=[str(tmp_path / "a.fil")],
                                         nfft=NFFT, compression="gzip", device=CPU)
        with pytest.raises(ValueError, match="scan too short"):
            TS.load_scan_mesh(paths, nfft=1 << 12, device=CPU)
        with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 8"):
            TS.reduce_scan_mesh_to_files(paths, out_dir=str(tmp_path), nfft=NFFT,
                                         trace_logdir=str(tmp_path), device=CPU)
