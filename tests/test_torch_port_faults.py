"""Three faults of the port against ``blit``, closed, and the last small
pieces of ``blit``'s API.

- The staging pool's budget resolves as ``blit``'s: ``BLIT_STAGING_BYTES``,
  else ``SiteConfig.staging_pool_bytes``, else the built-in default.
- ``RawReducer.stream`` / ``drain`` take ``blit``'s ``raw`` keyword.
- (The flight recorder's dump is ``blit``'s document:
  ``tests/test_torch_operator_trace.py``.)
- ``beamform_np`` / ``correlate_np`` equal ``blit``'s exactly;
  ``SlabPool.clear``, ``bshuf.default_block_size``, ``native.native_dir``
  and ``testing.signal_ready`` behave as ``blit``'s.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from blit import config as bconfig  # noqa: E402
from blit import hostmem as bhostmem  # noqa: E402
from blit import testing as btesting  # noqa: E402
from blit.io.guppi import GuppiRaw as BGuppiRaw  # noqa: E402
from blit.parallel import beamform as bbeam  # noqa: E402
from blit.parallel import correlator as bcorr  # noqa: E402
from blit.pipeline import RawReducer as BReducer  # noqa: E402
from blit_torch import config as tconfig  # noqa: E402
from blit_torch import hostmem  # noqa: E402
from blit_torch import testing  # noqa: E402
from blit_torch.io import bshuf, native  # noqa: E402
from blit_torch.parallel import beamform as tbeam  # noqa: E402
from blit_torch.parallel import correlator as tcorr  # noqa: E402
from blit_torch.pipeline import RawReducer  # noqa: E402


@pytest.mark.parametrize("source", ["env", "config", "default"])
def test_staging_budget_resolves_as_blit(monkeypatch, source):
    monkeypatch.delenv("BLIT_STAGING_BYTES", raising=False)
    if source == "env":
        monkeypatch.setenv("BLIT_STAGING_BYTES", "12345")
    if source in ("env", "config"):
        monkeypatch.setattr(tconfig, "DEFAULT", tconfig.SiteConfig(
            staging_pool_bytes=777))
        monkeypatch.setattr(bconfig, "DEFAULT", bconfig.SiteConfig(
            staging_pool_bytes=777))
    got = hostmem.SlabPool().budget_bytes
    assert got == bhostmem.SlabPool().budget_bytes
    assert got == {"env": 12345, "config": 777,
                   "default": hostmem._DEFAULT_BUDGET}[source]
    assert hostmem._DEFAULT_BUDGET == bhostmem._DEFAULT_BUDGET


def test_slab_pool_clear():
    pool = hostmem.SlabPool(budget_bytes=1 << 20)
    slab = pool.take((4, 16), np.int8)
    pool.give(slab)
    assert pool.stats()["free_slabs"] == 1
    pool.clear()
    st = pool.stats()
    assert st["free_slabs"] == 0 and st["free_bytes"] == 0
    assert pool.take((4, 16), np.int8) is not slab


def test_stream_and_drain_take_the_raw_keyword(tmp_path):
    raw = str(tmp_path / "r.raw")
    testing.synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=11 * 64,
                      seed=5)
    red = RawReducer(nfft=64, nint=2, chunk_frames=4, device="cpu")
    got = np.concatenate(list(red.stream(raw=raw)))
    bred = BReducer(nfft=64, nint=2, chunk_frames=4, async_output=False)
    want = np.concatenate(list(bred.stream(raw=BGuppiRaw(raw))))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2 * want.max())
    total = red.drain(raw=raw)
    np.testing.assert_allclose(total, float(got.astype(np.float64).sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(total, bred.drain(raw=BGuppiRaw(raw)),
                               rtol=1e-4)


def test_beamform_np_equals_blit():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((5, 3, 16, 2)) +
         1j * rng.standard_normal((5, 3, 16, 2))).astype(np.complex64)
    w = (rng.standard_normal((4, 5, 3)) +
         1j * rng.standard_normal((4, 5, 3))).astype(np.complex64)
    for nint, detect in ((1, True), (4, True), (1, False)):
        got = tbeam.beamform_np(v, w, nint=nint, detect=detect)
        want = bbeam.beamform_np(v, w, nint=nint, detect=detect)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_correlate_np_equals_blit():
    rng = np.random.default_rng(1)
    v = (rng.integers(-8, 8, (3, 2, 2 * 64, 2)) +
         1j * rng.integers(-8, 8, (3, 2, 2 * 64, 2))).astype(np.complex64)
    coeffs = rng.standard_normal((4, 16)).astype(np.float32)
    for nseg in (1, 2):
        got = tcorr.correlate_np(v, coeffs, 16, ntap=4, nsegments=nseg)
        want = bcorr.correlate_np(v, coeffs, 16, ntap=4, nsegments=nseg)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bshuf_default_block_size_and_native_dir():
    assert os.path.isabs(native.native_dir())
    assert native.native_dir() == os.path.abspath(native.BUILD_DIR)
    if not bshuf.available():
        pytest.skip(f"the codec did not build: {bshuf.unavailable_reason()}")
    # The HDF5 filter's rule: 8 KiB of elements, a multiple of 8.
    for size in (1, 2, 4, 8):
        n = bshuf.default_block_size(size)
        assert n % 8 == 0 and n * size <= 8192 and n >= 128


def test_signal_ready_equals_blit(tmp_path):
    (tmp_path / "b").mkdir()
    a = testing.signal_ready(str(tmp_path), "p0")
    b = btesting.signal_ready(str(tmp_path / "b"), "p0")
    assert os.path.basename(a) == os.path.basename(b) == ".readyp0"
    with open(a) as f:
        assert f.read() == str(os.getpid())
    assert not os.path.exists(a + ".tmp")


def test_channelize_np_dft_np_detect_stokes_equal_blit():
    import torch

    from blit import version as bversion
    from blit.ops import channelize as bch
    from blit.ops import dft as bdft
    from blit_torch import __version__
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dft as tdft

    assert __version__ == bversion.__version__
    rng = np.random.default_rng(2)
    v = rng.integers(-20, 20, (2, 7 * 16, 2, 2)).astype(np.int8)
    coeffs = rng.standard_normal((4, 16)).astype(np.float32)
    for stokes in ("I", "XX", "YY", "XXYY", "full", "IQUV"):
        got = tch.channelize_np(v, coeffs, nfft=16, nint=2, stokes=stokes)
        want = bch.channelize_np(v, coeffs, nfft=16, nint=2, stokes=stokes)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        spec = (rng.standard_normal((3, 2, 4, 8)) +
                1j * rng.standard_normal((3, 2, 4, 8))).astype(np.complex64)
        np.testing.assert_allclose(
            tch.detect_stokes(torch.from_numpy(spec), stokes).numpy(),
            np.asarray(bch.detect_stokes(spec, stokes)), rtol=1e-6, atol=1e-6)
    xr, xi = rng.standard_normal((2, 4, 12))
    for a, b in zip(tdft.dft_np(xr, xi), bdft.dft_np(xr, xi)):
        assert np.array_equal(a, b)


def test_publisher_derives_the_ici_rate_as_blit():
    from blit import monitor as bmonitor
    from blit import observability as bobs
    from blit_torch import monitor as tmonitor
    from blit_torch import observability as tobs

    gauges = []
    for mon, obs in ((tmonitor, tobs), (bmonitor, bobs)):
        tl = obs.Timeline()
        pub = mon.MetricsPublisher(interval_s=999.0, spool_dir="", port=-1,
                                   timeline=tl)
        try:
            pub.tick()
            tl.observe("mesh.gather_ici_bytes", 4e9)
            tl.observe("mesh.psum_ici_bytes", 2e9)
            sample = pub.tick()
        finally:
            pub.close()
        gauges.append(sample["gauges"].get("mesh.ici_gbps"))
    assert gauges[0] is not None and gauges[0] > 0
    assert gauges[1] is not None and gauges[1] > 0


def test_reducer_records_blits_spans(tmp_path):
    from blit_torch import observability as tobs

    raw = str(tmp_path / "r.raw")
    testing.synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=11 * 64)
    tobs.tracer().reset()
    red = RawReducer(nfft=64, nint=2, chunk_frames=4, device="cpu")
    red.reduce_to_file(raw, str(tmp_path / "o.fil"))
    list(red.stream(raw))
    names = [s["name"] for s in tobs.span_dicts()]
    assert names.count("reduce.pump") == 1 and names.count("reduce.stream") == 1
    pump = next(s for s in tobs.span_dicts() if s["name"] == "reduce.pump")
    assert pump["attrs"]["nfft"] == 64
    assert pump["attrs"]["out"].startswith(str(tmp_path / "o.fil"))
