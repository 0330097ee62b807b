"""Product integrity across the packages: manifests, RAW digest sidecars,
and resume cursors each package must accept from the other.

- ``blit.integrity.verify_product`` accepts the port's ``.fil``, ``.h5``
  and ``.hits`` products with their manifests, and the port's accepts
  blit's; a flipped byte fails both.
- A cursor the port wrote loads and ``matches`` in blit, and the reverse;
  a product blit left interrupted is finished by the port's
  ``reduce_resumable`` and the reverse, within the f32 bound.
- A flipped byte in a RAW block under a digest sidecar zero-masks that
  block: the port's header lists the same ``_masked_blocks`` as blit's
  and its product equals the port's reduction of the recording with
  that block zeroed.
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("h5py")

from blit import faults as bfaults  # noqa: E402
from blit import integrity as bintegrity  # noqa: E402
from blit.pipeline import RawReducer as BlitReducer  # noqa: E402
from blit.pipeline import ReductionCursor as BlitCursor  # noqa: E402
from blit.search.dedoppler import DedopplerReducer as BlitSearch  # noqa: E402
from blit.search.dedoppler import SearchCursor as BlitSearchCursor  # noqa: E402
from blit_torch import faults, integrity  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.io.guppi import GuppiRaw, read_raw_header, write_raw  # noqa: E402
from blit_torch.io.hits import read_hits  # noqa: E402
from blit_torch.io.sigproc import read_fil  # noqa: E402
from blit_torch.pipeline import RawReducer, ReductionCursor  # noqa: E402
from blit_torch.search import DedopplerReducer, SearchCursor  # noqa: E402

KW = dict(nfft=64, nint=2, chunk_frames=4)


class Boom(Exception):
    pass


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()
    yield
    for f in (faults, bfaults):
        f.clear()
        f.reset_counters()


@contextlib.contextmanager
def crash_after(mod, n):
    mod.install(mod.FaultRule(point="sink.write", mode="fail", after=n,
                              times=-1, exc=Boom))
    try:
        yield
    finally:
        mod.clear()


def _port(**kw):
    return RawReducer(device="cpu", output_stall_timeout_s=30.0, **KW, **kw)


def _blit(**kw):
    return BlitReducer(**KW, **kw)


@pytest.fixture
def raw(tmp_path):
    p = str(tmp_path / "x.raw")
    ttesting.synth_raw(p, nblocks=4, obsnchan=2, ntime_per_block=1000,
                       overlap=8, tone_chan=1, seed=2)
    return p


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x01]))


@pytest.mark.parametrize("name,kw", [("p.fil", {}), ("p.h5", {}),
                                     ("p.h5", {"compression": "gzip"})])
def test_manifests_verify_in_both_packages(raw, tmp_path, name, kw):
    for make, tag in ((_port, "port"), (_blit, "blit")):
        out = str(tmp_path / f"{tag}-{name}")
        make().reduce_to_file(raw, out, **kw)
        for verify in (integrity.verify_product, bintegrity.verify_product):
            doc, problems = verify(out)
            assert problems == [] and doc["complete"] and doc["rows"] == 29
        size = os.path.getsize(out)
        _flip(out, size - 5)
        for verify in (integrity.verify_product, bintegrity.verify_product):
            assert verify(out)[1], f"{tag} {name}: flipped byte not caught"
    with open(integrity.manifest_path(str(tmp_path / f"port-{name}"))) as f:
        pdoc = json.load(f)
    with open(bintegrity.manifest_path(str(tmp_path / f"blit-{name}"))) as f:
        bdoc = json.load(f)
    assert pdoc.keys() == bdoc.keys()
    assert [e[:2] for e in pdoc["windows"]] == [e[:2] for e in bdoc["windows"]]
    for k in ("kind", "version", "format", "rows", "row_bytes", "data_offset"):
        assert pdoc[k] == bdoc[k], k


def test_hits_manifests_verify_in_both_packages(raw, tmp_path):
    skw = dict(nfft=64, window_spectra=8, top_k=4, snr_threshold=3.0)
    p, b = str(tmp_path / "p.hits"), str(tmp_path / "b.hits")
    DedopplerReducer(device="cpu", chunk_frames=8, **skw).search_to_file(raw, p)
    BlitSearch(kernel="reference", async_output=False, **skw).search_to_file(raw, b)
    for out in (p, b):
        for verify in (integrity.verify_product, bintegrity.verify_product):
            assert verify(out)[1] == []
    docs = []
    for out in (p, b):
        with open(out + ".manifest.json") as f:
            docs.append(json.load(f))
    # One ledger entry per window, at the same window counts.
    assert [e[0] for e in docs[0]["windows"]] == [e[0] for e in docs[1]["windows"]]
    assert (docs[0]["format"], docs[0]["rows"]) == (docs[1]["format"], docs[1]["rows"])


def test_cursor_fields_match_blit():
    for port_cls, blit_cls in ((ReductionCursor, BlitCursor),
                               (SearchCursor, BlitSearchCursor)):
        pf = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
        bf = [(f.name, f.default) for f in dataclasses.fields(blit_cls)]
        assert sorted(pf, key=str) == sorted(bf, key=str)
    assert ReductionCursor("x", 1, 1, 1, "I").despike_nfpc == -1


@pytest.mark.parametrize("fmt", ["fil", "h5"])
def test_port_resumes_a_blit_cursor_and_blit_a_port_cursor(raw, tmp_path, fmt):
    ref = str(tmp_path / f"ref.{fmt}")
    _port().reduce_to_file(raw, ref)
    for first, second in ((_blit, _port), (_port, _blit)):
        out = str(tmp_path / f"x-{first.__name__}.{fmt}")
        mod = bfaults if first is _blit else faults
        with crash_after(mod, 2), pytest.raises(Boom):
            first().reduce_resumable(raw, out)
        # The other package's cursor loads and matches.
        bcur, pcur = BlitCursor.load(out), ReductionCursor.load(out)
        assert bcur.frames_done == pcur.frames_done == 8
        assert bcur.matches(_blit(), raw) and pcur.matches(_port(), raw)
        assert dataclasses.asdict(bcur) == dataclasses.asdict(pcur)
        second().reduce_resumable(raw, out)
        assert not os.path.exists(out + ".cursor")
        if fmt == "fil":
            want, got = read_fil(ref)[1], read_fil(out)[1]
        else:
            from blit_torch.io.fbh5 import read_fbh5_data

            want, got = read_fbh5_data(ref), read_fbh5_data(out)
        assert got.shape == want.shape == (29, 1, 128)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-2 * np.abs(want[..., :64]).max())
        for verify in (integrity.verify_product, bintegrity.verify_product):
            assert verify(out)[1] == []


def test_search_cursor_crosses_packages(raw, tmp_path):
    skw = dict(nfft=64, window_spectra=8, top_k=4, snr_threshold=3.0)
    out = str(tmp_path / "x.hits")
    with crash_after(faults, 2), pytest.raises(Boom):
        DedopplerReducer(device="cpu", chunk_frames=8,
                         output_stall_timeout_s=30.0, **skw).search_resumable(raw, out)
    pcur, bcur = SearchCursor.load(out), BlitSearchCursor.load(out)
    assert dataclasses.asdict(pcur) == dataclasses.asdict(bcur)
    assert bcur.matches(BlitSearch(kernel="reference", **skw), raw)
    BlitSearch(kernel="reference", async_output=False, **skw).search_resumable(raw, out)
    assert not os.path.exists(out + ".cursor")
    ref = str(tmp_path / "ref.hits")
    DedopplerReducer(device="cpu", **skw).search_to_file(raw, ref)
    (h, hits), (rh, rhits) = read_hits(out), read_hits(ref)
    assert h == rh and len(hits) == len(rhits) > 0
    assert [(x.window, x.drift_bins, x.chan, x.band) for x in hits] == [
        (x.window, x.drift_bins, x.chan, x.band) for x in rhits]
    np.testing.assert_allclose([x.snr for x in hits], [x.snr for x in rhits],
                               rtol=1e-4)
    for verify in (integrity.verify_product, bintegrity.verify_product):
        assert verify(out)[1] == []


def _data_offset(path, block):
    with open(path, "rb") as f:
        for _ in range(block + 1):
            hdr, off = read_raw_header(f)
            f.seek(hdr["BLOCSIZE"], os.SEEK_CUR)
    return off


@pytest.mark.parametrize("native", [False, True])
def test_digest_sidecar_masks_a_rotten_block(raw, tmp_path, native):
    from blit_torch.io import native as tnative

    if native and tnative.guppi_lib() is None:
        pytest.skip(f"native reader unavailable: {tnative.build_error('guppi')}")
    sidecar = integrity.write_raw_digests(raw)
    with open(sidecar) as f:
        pdoc = json.load(f)
    bintegrity.write_raw_digests(raw)
    with open(sidecar) as f:
        assert json.load(f) == pdoc
    assert integrity.verify_raw_member(raw) == []
    # Oracle: the recording with block 2 zeroed.
    clean = GuppiRaw(raw, native=False)
    blocks = [np.array(clean.read_block(i)) for i in range(clean.nblocks)]
    blocks[2][:] = 0
    zeroed = str(tmp_path / "zeroed.raw")
    write_raw(zeroed, clean.header(0), blocks)
    _, want = _port().reduce(zeroed)
    _flip(raw, _data_offset(raw, 2) + 100)
    assert integrity.verify_raw_member(raw) and bintegrity.verify_raw_member(raw)
    hdr, got = _port().reduce(GuppiRaw(raw, native=native))
    bhdr, _ = _blit().reduce(raw)
    assert hdr["_masked_blocks"] == bhdr["_masked_blocks"] == [2]
    np.testing.assert_array_equal(got, want)
    assert faults.counters()["mask.block"] == 1
    out = str(tmp_path / "p.fil")
    fhdr = _port().reduce_to_file(raw, out)
    assert fhdr["_masked_blocks"] == [2]
    np.testing.assert_array_equal(read_fil(out)[1], want)


def test_malformed_digest_sidecar_refuses_to_read(raw):
    with open(integrity.raw_digests_path(raw), "w") as f:
        f.write("{not json")
    with pytest.raises(integrity.IntegrityError):
        GuppiRaw(raw)
    os.environ["BLIT_VERIFY_INGEST"] = "0"
    try:
        assert GuppiRaw(raw).nblocks == 4
    finally:
        del os.environ["BLIT_VERIFY_INGEST"]


def test_verify_claim_fails_closed(raw, tmp_path):
    out = str(tmp_path / "x.fil")
    with crash_after(faults, 2), pytest.raises(Boom):
        _port().reduce_resumable(raw, out)
    row_bytes = 128 * 4
    assert integrity.verify_claim(out, 4, fmt="fil", row_bytes=row_bytes) is True
    assert integrity.verify_claim(out, 3, fmt="fil", row_bytes=row_bytes) is False
    assert integrity.verify_claim(out, 4, fmt="fbh5") is False
    assert integrity.verify_claim(str(tmp_path / "none.fil"), 4, fmt="fil") is None
    with open(integrity.manifest_path(out), "w") as f:
        f.write("{torn")
    assert integrity.verify_claim(out, 4, fmt="fil") is False
