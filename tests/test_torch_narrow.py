"""Quantized products and host staging in the port, held against blit.

- narrow_device and narrow_host against blit.ops.narrow.narrow_host,
  bitwise, for nbits 8 and 16, on values with exact .5 ties, negatives
  and values above 2^nbits - 1;
- a quantized .fil from the port: its header bytes identical to blit's,
  its data bitwise blit's narrow_host applied to the port's own f32
  product, which stays within the f32 bound of blit's
  (tests/test_torch_pipeline.py: rtol 1e-4, atol 1e-2 of the noise-only
  channel's peak); async and sync bytes identical;
- the staging pool (mirrors tests/test_narrow.py::TestHostStaging).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from blit.io.sigproc import read_fil_data, read_fil_header  # noqa: E402
from blit.ops.narrow import narrow_host as blit_narrow_host  # noqa: E402
from blit.pipeline import RawReducer as BlitReducer  # noqa: E402
from blit_torch import hostmem  # noqa: E402
from blit_torch.io.sigproc import FilWriter, read_fil  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.ops.narrow import (  # noqa: E402
    NARROW_DTYPES,
    check_quant,
    narrow_device,
    narrow_host,
)
from blit_torch.pipeline import RawReducer  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

NFFT, NINT, CHUNK = 64, 2, 4


def _values(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 80.0, size=(32, 2, 257)).astype(np.float32)
    # Exact halves (ties go to even), negatives, the range's edges and
    # values far beyond it.
    x[0, 0, :12] = [0.5, 1.5, 2.5, 3.5, -0.5, -3.0, 254.5, 255.5, 65534.5,
                    65535.5, 1e9, -1e9]
    return x


@pytest.mark.parametrize("nbits", [8, 16])
@pytest.mark.parametrize("scale,offset", [(1.0, 0.0), (0.5, 2.0), (3.0, 0.5),
                                          (0.1, -7.0)])
def test_narrowing_bitwise_equal_to_blit(nbits, scale, offset):
    x = _values(nbits)
    want = blit_narrow_host(x, nbits, scale, offset)
    host = narrow_host(x, nbits, scale, offset)
    dev = narrow_device(torch.from_numpy(x), nbits, scale, offset).numpy()
    assert host.dtype == dev.dtype == want.dtype == NARROW_DTYPES[nbits]
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)


def test_nbits32_is_identity_and_bad_nbits_rejected():
    x = np.arange(6, dtype=np.float32).reshape(2, 1, 3)
    np.testing.assert_array_equal(narrow_host(x, 32), x)
    t = torch.from_numpy(x)
    assert narrow_device(t, 32) is t
    for bad in (4, 12, 64):
        with pytest.raises(ValueError, match="nbits"):
            check_quant(bad)
    with pytest.raises(ValueError, match="nbits"):
        RawReducer(nfft=64, nbits=12, device="cpu")


@pytest.fixture(scope="module")
def raw_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("q") / "q.raw")
    synth_raw(p, nblocks=2, obsnchan=2, ntime_per_block=2048, tone_chan=1,
              seed=9)
    return p


def _header(path):
    _, off = read_fil_header(path)
    with open(path, "rb") as f:
        return f.read(off)


@pytest.mark.parametrize("nbits", [8, 16])
def test_quantized_fil_against_blit(raw_path, tmp_path, nbits):
    kw = dict(nfft=NFFT, nint=NINT, chunk_frames=CHUNK)
    f32 = str(tmp_path / "f32.fil")
    RawReducer(device="cpu", **kw).reduce_to_file(raw_path, f32)
    _, x = read_fil(f32)
    scale = float(50.0 / np.median(x))
    q = dict(nbits=nbits, quant_scale=scale, quant_offset=1.5)
    port = str(tmp_path / "port.fil")
    hdr = RawReducer(device="cpu", **kw, **q).reduce_to_file(raw_path, port)
    ref = str(tmp_path / "blit.fil")
    BlitReducer(async_output=False, **kw, **q).reduce_to_file(raw_path, ref)
    assert _header(port) == _header(ref)
    phdr, data = read_fil(port)
    assert phdr["nbits"] == nbits and data.dtype == NARROW_DTYPES[nbits]
    assert hdr["nsamps"] == data.shape[0] == x.shape[0]
    np.testing.assert_array_equal(data, blit_narrow_host(np.asarray(x), nbits,
                                                         scale, 1.5))
    assert 0 < np.count_nonzero(data) and data.max() > 40  # not all clipped
    # The f32 product itself stays within the f32 bound of blit's.
    bref = str(tmp_path / "blitf32.fil")
    BlitReducer(async_output=False, **kw).reduce_to_file(raw_path, bref)
    _, want = read_fil_data(bref)
    np.testing.assert_allclose(x, want, rtol=1e-4,
                               atol=1e-2 * np.abs(want[..., :NFFT]).max())


@pytest.mark.parametrize("nbits", [8, 16])
def test_quantized_async_equals_sync_bytes(raw_path, tmp_path, nbits):
    kw = dict(nfft=NFFT, nint=NINT, chunk_frames=CHUNK, nbits=nbits,
              quant_scale=0.05, quant_offset=3.0, device="cpu")
    a, s = str(tmp_path / "a.fil"), str(tmp_path / "s.fil")
    RawReducer(**kw).reduce_to_file(raw_path, a)
    RawReducer(async_output=False, **kw).reduce_to_file(raw_path, s)
    with open(a, "rb") as f, open(s, "rb") as g:
        assert f.read() == g.read()


def test_stream_and_reduce_honor_nbits(raw_path):
    kw = dict(nfft=NFFT, nint=NINT, chunk_frames=CHUNK, device="cpu")
    hdr, x = RawReducer(**kw).reduce(raw_path)
    hq, q = RawReducer(nbits=8, quant_scale=0.05, **kw).reduce(raw_path)
    assert hdr["nbits"] == 32 and hq["nbits"] == 8 and q.dtype == np.uint8
    np.testing.assert_array_equal(q, narrow_host(x, 8, 0.05))
    for a, s in zip(RawReducer(nbits=16, **kw).stream(raw_path),
                    RawReducer(nbits=16, async_output=False, **kw).stream(raw_path)):
        assert a.dtype == s.dtype == np.uint16
        np.testing.assert_array_equal(a, s)


def test_fil_writer_dtypes(tmp_path):
    hdr = {"source_name": "x", "fch1": 1000.0, "foff": -1.0, "tsamp": 1.0,
           "tstart": 60000.0}
    for dtype, nbits in ((np.uint8, 8), (np.uint16, 16), (np.float32, 32)):
        p = str(tmp_path / f"{nbits}.fil")
        w = FilWriter(p, hdr, 1, 4, dtype=dtype)
        with pytest.raises(ValueError, match="dtype"):
            w.append(np.zeros((1, 1, 4), np.float64))
        w.append(np.arange(8, dtype=dtype).reshape(2, 1, 4))
        w.close()
        h, data = read_fil(p)
        assert h["nbits"] == nbits and h["nsamps"] == 2
        np.testing.assert_array_equal(data, np.arange(8).reshape(2, 1, 4))
    with pytest.raises(ValueError, match="dtype"):
        FilWriter(str(tmp_path / "bad.fil"), hdr, 1, 4, dtype=np.int32)


class TestHostStaging:
    def test_aligned_empty_alignment(self):
        for shape in [(3, 5), (1,), (17, 33, 2)]:
            a = hostmem.aligned_empty(shape, np.int8)
            assert a.ctypes.data % 4096 == 0
            assert a.shape == tuple(shape) and a.flags.c_contiguous

    @pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.uint16, np.float32])
    def test_slab_views_share_bytes(self, dtype):
        slab = hostmem.HostSlab((3, 5), dtype, pinned=False)
        assert slab.array.ctypes.data % 4096 == 0
        assert slab.tensor.shape == (3, 5) and slab.nbytes == 15 * np.dtype(dtype).itemsize
        slab.array[...] = np.arange(15, dtype=dtype).reshape(3, 5)
        np.testing.assert_array_equal(slab.tensor.numpy(), slab.array)
        assert slab.bytes.numel() == slab.nbytes

    def test_pool_reuses_exact_shape(self):
        pool = hostmem.SlabPool(budget_bytes=1 << 20)
        a = pool.take((64, 4), np.int8)
        marker = a.array.ctypes.data
        pool.give(a)
        b = pool.take((64, 4), np.int8)
        assert b.array.ctypes.data == marker
        assert pool.take((64, 8), np.int8).array.ctypes.data != marker
        assert pool.take((64, 4), np.uint8).array.ctypes.data != marker
        assert pool.stats()["reused"] == 1

    def test_pool_budget_evicts(self):
        pool = hostmem.SlabPool(budget_bytes=1000)
        pool.give(pool.take((2000,), np.int8))  # alone over budget: dropped
        assert pool.stats()["free_bytes"] == 0
        small = [pool.take((400,), np.int8) for _ in range(3)]
        for s in small:
            pool.give(s)
        st = pool.stats()
        assert st["free_bytes"] <= 1000 and st["dropped"] >= 2

    def test_zero_budget_disables(self, monkeypatch):
        monkeypatch.setenv("BLIT_STAGING_BYTES", "0")
        pool = hostmem.SlabPool()
        assert pool.budget_bytes == 0
        pool.give(pool.take((16,), np.int8))
        assert pool.stats()["free_bytes"] == 0

    def test_allocations_timed_into_the_timeline(self):
        tl = Timeline()
        pool = hostmem.SlabPool(budget_bytes=1 << 20)
        s = pool.take((256,), np.float32, timeline=tl)
        pool.give(s)
        pool.take((256,), np.float32, timeline=tl)  # reused: not timed
        st = tl.stages["staging.alloc"]
        assert (st.calls, st.bytes) == (1, 1024)
        assert pool.stats()["allocated"] == 1 and pool.stats()["alloc_seconds"] >= 0
