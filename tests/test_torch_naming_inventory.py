"""The port's naming, config, inventory and tree generator held against
blit's on the CPU.

- naming: every parse result equal to blit's field by field, over blit's
  test names (tests/test_naming.py) and the README's naming convention;
- inventory: the record tuples of one tree equal blit's, for the fbh5,
  fil and raw kinds, and so are raw_sequences, scan_grid and
  to_dataframe;
- save_inventories / load_inventories: each package reads the other's
  file, WorkerError entries included;
- build_observation_tree: the port writes the same files as blit.

Every comparison here is exact (no tolerance): these are parsers, file
walks and byte writers.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from blit import config as bconfig
from blit import inventory as binv
from blit import naming as bnaming
from blit import testing as btesting
from blit.parallel.pool import WorkerError as BWorkerError
from blit_torch import config as tconfig
from blit_torch import inventory as tinv
from blit_torch import naming as tnaming
from blit_torch import testing as ttesting
from blit_torch.parallel.pool import WorkerError as TWorkerError

H5 = ("/datax/dibas/AGBT22B_999_01/GUPPI/BLP42/"
      "blc42_guppi_59897_21221_HD_84406_0011.rawspec.0002.h5")
RAW = ("/datax/dibas/AGBT22B_999_01/GUPPI/BLP17/"
       "blc17_guppi_59897_21221_HD_84406_0011.0000.raw")
NAMES = [
    H5,
    RAW,
    "guppi_59897_21221_HD_84406_0011.rawspec.0002.h5",
    "/BLP00/guppi_59897_21221_12345_VOYAGER1_0002.0000.raw",
    "/datax/dibas/S/GUPPI/BLP35/sub/deep/blc35_guppi_1_2_SRC_0001.rawspec.0002.h5",
    "/mnt/BLP00/datax/S/GUPPI/BLP42/blc42_guppi_1_2_SRC_0001.rawspec.0002.h5",
    "/tmp/notaguppifile.h5",
    "guppi_59897_21221_X_0011.rawspec.0002.h5",
    # The README's convention: <root>/<session>/GUPPI/BLP<band><bank>/
    # blc<band><bank>_guppi_<imjd>_<smjd>_<src>_<scan>.<seq>.raw and the
    # rawspec products beside it.
    "/datax/dibas/AGBT22B_999_01/GUPPI/BLP00/blc00_guppi_59897_21221_HD_84406_0011.0000.raw",
    "/datax/dibas/AGBT22B_999_01/GUPPI/BLP00/blc00_guppi_59897_21221_HD_84406_0011.0001.raw",
    "/datax/dibas/AGBT22B_999_01/GUPPI/BLP77/blc77_guppi_59897_21221_HD_84406_0011.rawspec.0000.fil",
    "/datax/dibas/AGBT22B_999_01/GUPPI/BLP63/blc63_guppi_59897_21221_HD_84406_0011.rawspec.0001.h5",
    "/datax/dibas/AGBT22B_999_01/GUPPI/BLPd3/blc03_guppi_59897_21221_HD_84406_0011.rawspec.0002.h5",
    "/datax/dibas/AGBT22B_999_01/GUPPI/BLP89/blc89_guppi_59897_21221_HD_84406_0011.rawspec.0002.h5",
    "garbage.rawspec.0002.h5",
]


def _fields(parsed):
    return None if parsed is None else dataclasses.asdict(parsed)


@pytest.mark.parametrize("name", NAMES)
def test_parse_results_equal_blit(name):
    assert _fields(tnaming.parse_guppi_name(name)) == _fields(
        bnaming.parse_guppi_name(name))
    assert _fields(tnaming.parse_rawspec_name(name)) == _fields(
        bnaming.parse_rawspec_name(name))


@pytest.mark.parametrize("text", ["AGBT22B_999_01", "TGBT21A_1_05", "XGBT22B_999_01",
                                  "BLP42", "BLPd3", "BLP89", "BLP421", "BLP00"])
def test_regexes_equal_blit(text):
    for attr in ("SESSION_RE", "PLAYER_RE", "DEFAULT_FILE_RE", "GUPPI_BASE_RE",
                 "RAWSPEC_BASE_RE", "PLAYER_COMPONENT_RE"):
        assert getattr(tnaming, attr).pattern == getattr(bnaming, attr).pattern
        tm = getattr(tnaming, attr).search(text)
        bm = getattr(bnaming, attr).search(text)
        assert (tm and tm.groupdict()) == (bm and bm.groupdict())


def test_player_name_equals_blit():
    for band in range(8):
        for bank in range(8):
            assert tnaming.player_name(band, bank) == bnaming.player_name(band, bank)
    for bad in ((8, 0), (0, -1)):
        with pytest.raises(ValueError):
            tnaming.player_name(*bad)


def test_site_config_defaults_equal_blit():
    t, b = tconfig.SiteConfig(), bconfig.SiteConfig()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(b, f.name), f.name
    assert tconfig.datahosts("x-") == bconfig.datahosts("x-")
    assert t.with_(host_prefix="p").hosts == b.with_(host_prefix="p").hosts
    tp, bp = t.call_retry_policy(), b.call_retry_policy()
    assert (tp.attempts, tp.base_s, tp.max_s) == (bp.attempts, bp.base_s, bp.max_s)
    tp, bp = t.io_retry_policy(), b.io_retry_policy()
    assert (tp.attempts, tp.base_s, tp.max_s) == (bp.attempts, bp.base_s, bp.max_s)


def test_search_defaults_take_a_config(monkeypatch):
    for k in ("BLIT_SEARCH_WINDOW", "BLIT_SEARCH_TOP_K", "BLIT_SEARCH_SNR",
              "BLIT_SEARCH_MAX_DRIFT"):
        monkeypatch.delenv(k, raising=False)
    assert tconfig.search_defaults() == bconfig.search_defaults()
    kw = dict(search_window_spectra=16, search_top_k=3, search_max_drift_bins=5)
    assert (tconfig.search_defaults(tconfig.SiteConfig(**kw))
            == bconfig.search_defaults(bconfig.SiteConfig(**kw)))


KINDS = {"fbh5": None, "fil": r"0002\.fil$", "raw": r"\.raw$"}


def _tree(root, kind, pkg):
    return pkg.build_observation_tree(
        root, scans=("0011", "0012"), players=((0, 0), (0, 1), (1, 3)),
        nsamps=8, nchans=64, kind=kind, nfiles=2, raw_ntime=256)


@pytest.fixture(scope="module", params=sorted(KINDS))
def tree(request, tmp_path_factory):
    kind = request.param
    root = str(tmp_path_factory.mktemp(f"tree_{kind}"))
    _tree(root, kind, btesting)
    return kind, root


def test_inventory_records_equal_blit(tree):
    kind, root = tree
    kw = dict(root=root, worker=3, host="h3")
    if KINDS[kind]:
        kw["file_re"] = KINDS[kind]
    want = binv.get_inventory(**kw)
    got = tinv.get_inventory(**kw)
    assert len(want) > 0
    assert tinv.InventoryRecord._fields == binv.InventoryRecord._fields
    assert [tuple(r) for r in got] == [tuple(r) for r in want]


def test_raw_sequences_and_scan_grid_equal_blit(tree):
    kind, root = tree
    kw = dict(root=root, file_re=KINDS[kind]) if KINDS[kind] else dict(root=root)
    binvs = [binv.get_inventory(worker=w, host=f"h{w}", **kw) for w in (1, 2)]
    tinvs = [tinv.get_inventory(worker=w, host=f"h{w}", **kw) for w in (1, 2)]
    flat_b = [r for inv in binvs for r in inv]
    flat_t = [r for inv in tinvs for r in inv]
    want = [(tuple(r), p) for r, p in binv.raw_sequences(flat_b)]
    got = [(tuple(r), p) for r, p in tinv.raw_sequences(flat_t)]
    assert got == want
    if kind != "raw":
        assert got == []
        for mod, invs in ((binv, binvs), (tinv, tinvs)):
            with pytest.raises(ValueError, match="no RAW sequences"):
                mod.scan_grid(invs, "AGBT22B_999_01", "0011")
        return
    assert len(got) == 6 and all(len(p) == 2 for _, p in got)
    # Bank 3 of band 1 only: the grid is not rectangular in either.
    for mod, invs in ((binv, binvs), (tinv, tinvs)):
        with pytest.raises(ValueError, match="rectangular"):
            mod.scan_grid(invs, "AGBT22B_999_01", "0011")
    band0 = lambda invs: [[r for r in inv if r.band == 0] for inv in invs]
    assert (tinv.scan_grid(band0(tinvs), "AGBT22B_999_01", "0012")
            == binv.scan_grid(band0(binvs), "AGBT22B_999_01", "0012"))


def test_to_dataframe_equals_blit(tree):
    pytest.importorskip("pandas")
    kind, root = tree
    kw = dict(root=root, file_re=KINDS[kind]) if KINDS[kind] else dict(root=root)
    bdf = binv.to_dataframe([binv.get_inventory(**kw), [],
                             BWorkerError(2, "h", RuntimeError("x"))])
    tdf = tinv.to_dataframe([tinv.get_inventory(**kw), [],
                             TWorkerError(2, "h", RuntimeError("x"))])
    assert list(tdf.columns) == list(bdf.columns)
    assert tdf.equals(bdf)


@pytest.mark.parametrize("writer", ["blit", "port"])
def test_saved_inventories_read_by_the_other(tree, tmp_path, writer):
    kind, root = tree
    kw = dict(root=root, file_re=KINDS[kind]) if KINDS[kind] else dict(root=root)
    recs = {"blit": binv.get_inventory(**kw), "port": tinv.get_inventory(**kw)}
    errs = {"blit": BWorkerError(2, "blc77", RuntimeError("ssh: no route")),
            "port": TWorkerError(2, "blc77", RuntimeError("ssh: no route"))}
    mods = {"blit": binv, "port": tinv}
    reader = "port" if writer == "blit" else "blit"
    p = str(tmp_path / "inv.jsonl")
    n = mods[writer].save_inventories(p, [recs[writer], errs[writer], []])
    assert n == len(recs[writer])
    back = mods[reader].load_inventories(p)
    same = mods[writer].load_inventories(p)
    assert len(back) == len(same) == 3
    assert [tuple(r) for r in back[0]] == [tuple(r) for r in recs[writer]]
    assert type(back[0][0]).__module__ == f"{'blit_torch' if reader == 'port' else 'blit'}.inventory"
    err = back[1]
    assert isinstance(err, TWorkerError if reader == "port" else BWorkerError)
    assert (err.worker, err.host) == (2, "blc77")
    assert str(err.error) == str(same[1].error)
    assert "no route" in str(err.error)
    assert back[2] == []
    # Saved again, each package's load gives the same bytes.
    q1, q2 = str(tmp_path / "again_reader.jsonl"), str(tmp_path / "again_writer.jsonl")
    mods[reader].save_inventories(q1, back)
    mods[writer].save_inventories(q2, same)
    assert filecmp.cmp(q1, q2, shallow=False)


@pytest.mark.parametrize("kind", ["fil", "raw", "fbh5"])
def test_observation_tree_files_equal_blit(tmp_path, kind):
    a, b = str(tmp_path / "blit"), str(tmp_path / "port")
    pa = _tree(a, kind, btesting)
    pb = _tree(b, kind, ttesting)
    assert [os.path.relpath(p, a) for p in pa] == [os.path.relpath(p, b) for p in pb]
    for x, y in zip(pa, pb):
        if kind == "fbh5":
            h5py = pytest.importorskip("h5py")
            with h5py.File(x, "r") as fx, h5py.File(y, "r") as fy:
                np.testing.assert_array_equal(fx["data"][()], fy["data"][()])
                attrs = lambda f: {k: np.asarray(v).tolist()
                                   for k, v in f["data"].attrs.items()}
                assert attrs(fx) == attrs(fy)
        else:
            assert filecmp.cmp(x, y, shallow=False), (x, y)


def test_raw_sequence_dedup_equals_blit():
    rows = [(1, 2, "S", "0001", "src", 0, 0, "h1", "/d/x.0000.raw", 1),
            (1, 2, "S", "0001", "src", 0, 0, "h2", "/d/x.0000.raw", 2),
            (1, 2, "S", "0001", "src", 0, 0, "h1", "/d/x.0001.raw", 1),
            (1, 2, "S", "0001", "src", 0, 1, "h1", "/d/y.0000.raw", 1),
            (1, 2, "S", "0001", "src", 0, 1, "h1", "/d/y.fil", 1)]
    got = tinv.raw_sequences([tinv.InventoryRecord(*r) for r in rows])
    want = binv.raw_sequences([binv.InventoryRecord(*r) for r in rows])
    assert [(tuple(r), p) for r, p in got] == [(tuple(r), p) for r, p in want]
    assert got[0][0].worker == 1


def test_missing_root_and_error_entries(tmp_path):
    assert tinv.get_inventory(root=str(tmp_path / "nope")) == []
    assert tinv._is_worker_error(TWorkerError(1, "h", RuntimeError("x")))
    assert tinv._is_worker_error(RuntimeError("bare"))
    assert not tinv._is_worker_error([])
