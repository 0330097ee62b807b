"""The port's reducer, RAW and .fil codecs held against blit's.

One small RAW file (2 coarse channels, nfft = 2^20, a non-zero OVERLAP,
5 usable frames) written by blit_torch.testing is reduced by both
packages: with chunk_frames=2 the last chunk is a short tail chunk.  The
.fil header bytes must be identical and the data within the f32 bound
of tests/test_pallas_detect.py:150-198 (rtol 1e-4, atol 1e-2·max).

The tone in coarse channel 1 peaks ~3000× above the mean noise bin, so
"max" is taken over coarse channel 0, which holds noise only: the atol
then sits at ~1e-1 of a mean noise bin, and every bin, the tone's
included, is held to it.  A reducer that carried the wrong PFB state,
mishandled OVERLAP or the tail chunk would change the noise bins by
about their own size.

The 0001 and 0002 presets are held the same way on files of their own
(a tone in coarse channel 1, channel 0 noise only), each reduced with a
chunk_frames that leaves a short tail chunk.
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from blit import testing as btesting  # noqa: E402
from blit.io import guppi as bguppi  # noqa: E402
from blit.io.sigproc import read_fil_data, read_fil_header  # noqa: E402
from blit.pipeline import RawReducer as BlitReducer  # noqa: E402
from blit.pipeline import reducer_for_product as blit_reducer_for  # noqa: E402
from blit_torch import testing as ttesting  # noqa: E402
from blit_torch.convert import reducer_from_reference  # noqa: E402
from blit_torch.io import guppi as tguppi  # noqa: E402
from blit_torch.io.sigproc import read_fil  # noqa: E402
from blit_torch.pipeline import RawReducer, reducer_for_product  # noqa: E402

NFFT = 1 << 20
OVERLAP = 4096
TONE_CHAN = 1


def _noise_peak(product):
    """Peak of the noise-only coarse channel 0: the atol scale."""
    return np.abs(product[..., :NFFT]).max()


@pytest.fixture(scope="module")
def raw_path(tmp_path_factory):
    # 9 blocks of 2^20 samples sharing OVERLAP samples: 9·2^20 - 8·OVERLAP
    # kept samples → 8 whole blocks → 5 frames of a 4-tap PFB.
    path = str(tmp_path_factory.mktemp("raw") / "synth.raw")
    ttesting.synth_raw(path, nblocks=9, obsnchan=2, ntime_per_block=NFFT,
                       overlap=OVERLAP, seed=7, tone_chan=TONE_CHAN,
                       tone_freq=0.125,
                       obsbw=-187.5 / 32, obsfreq=8000.0)
    return path


@pytest.fixture(scope="module")
def blit_product(raw_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("blit") / "blit.fil")
    BlitReducer(nfft=NFFT, chunk_frames=2, async_output=False).reduce_to_file(
        raw_path, out)
    return out


def _header_bytes(path):
    _, off = read_fil_header(path)
    with open(path, "rb") as f:
        return f.read(off)


@pytest.fixture(scope="module")
def port_product(raw_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port") / "port.fil")
    red = RawReducer(nfft=NFFT, chunk_frames=2, device="cpu")
    hdr = red.reduce_to_file(raw_path, out)
    return out, hdr, red


def test_fil_header_bytes_identical(blit_product, port_product):
    out, hdr, _ = port_product
    assert _header_bytes(out) == _header_bytes(blit_product)
    assert hdr["nsamps"] == 5
    assert not os.path.exists(out + ".partial")


def test_fil_data_within_f32_bound(blit_product, port_product):
    _, want = read_fil_data(blit_product)
    _, got = read_fil(port_product[0])
    assert got.shape == want.shape == (5, 1, 2 * NFFT)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2 * _noise_peak(want))
    # The tone lands in the fine channel both packages' headers predict.
    tone_bin = TONE_CHAN * NFFT + NFFT // 2 + NFFT // 8
    assert got[0, 0].argmax() == want[0, 0].argmax() == tone_bin


def test_product_independent_of_chunk_frames(raw_path, port_product):
    _, want = read_fil(port_product[0])
    hdr, got = RawReducer(nfft=NFFT, chunk_frames=3, device="cpu").reduce(raw_path)
    assert hdr["nsamps"] == 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * _noise_peak(want))


def test_stage_accounting(raw_path, port_product):
    _, _, red = port_product
    raw = tguppi.GuppiRaw(raw_path)
    kept = sum(raw.block_ntime_kept(i) for i in range(raw.nblocks))
    st = red.timeline.stages
    assert st["ingest"].bytes == 2 * kept * 4
    assert st["device"].calls == 3  # chunks of 2, 2 and the 1-frame tail
    assert st["write"].bytes == 5 * 2 * NFFT * 4
    assert st["state"].calls == 2
    stats = red.stats
    assert stats.output_frames == 5 and stats.input_bytes == st["ingest"].bytes
    assert stats.gbps > 0


def test_reducer_from_reference_coeffs_bitwise():
    ref = BlitReducer(nfft=NFFT, nint=2, stokes="IQUV", chunk_frames=4)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    coeffs = np.asarray(ref._coeffs)
    red = reducer_from_reference(fields, coeffs, device="cpu")
    np.testing.assert_array_equal(red.coeffs.numpy(), coeffs)
    assert (red.nfft, red.nint, red.stokes, red.chunk_frames) == (NFFT, 2, "IQUV", 4)
    # The quantization and the plane's knobs are taken over too.
    q = reducer_from_reference(
        dict(fields, nbits=8, quant_scale=0.5, quant_offset=3.0,
             prefetch_depth=3, out_depth=4, async_output=False),
        coeffs, device="cpu")
    assert (q.nbits, q.quant_scale, q.quant_offset) == (8, 0.5, 3.0)
    assert (q.prefetch_depth, q.out_depth, q.async_output) == (3, 4, False)
    with pytest.raises(ValueError, match="nbits"):
        reducer_from_reference(dict(fields, nbits=12), coeffs, device="cpu")


def test_synth_raw_bitwise_equal_to_blit(tmp_path):
    kw = dict(nblocks=3, obsnchan=4, ntime_per_block=512, overlap=32, seed=3,
              tone_chan=2)
    a, b = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    ttesting.synth_raw(a, **kw)
    btesting.synth_raw(b, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_guppi_reader_matches_blit(raw_path):
    mine, ref = tguppi.GuppiRaw(raw_path), bguppi.GuppiRaw(raw_path, native=False)
    assert mine.nblocks == ref.nblocks == 9
    for i in (0, 8):
        assert mine.header(i) == ref.header(i)
        assert mine.block_ntime_kept(i) == ref.block_ntime_kept(i)
        np.testing.assert_array_equal(mine.read_block(i), ref.read_block(i))
    dst = np.zeros((2, 100, 2, 2), np.int8)
    assert mine.read_block_into(3, dst, t0=50, ntime_keep=100) == 100
    np.testing.assert_array_equal(dst, ref.read_block(3)[:, 50:150])


def test_synth_raw_blocks_is_gap_free(tmp_path):
    path = str(tmp_path / "big.raw")
    hdr = ttesting.synth_raw_blocks(path, nblocks=4, obsnchan=3,
                                    ntime_per_block=256, overlap=16, seed=1,
                                    tone_chan=1, tone_freq=0.25, tone_amp=60.0)
    raw = tguppi.GuppiRaw(path)
    assert raw.nblocks == 4 and raw.header(0)["OVERLAP"] == 16 == hdr["OVERLAP"]
    blocks = [raw.read_block(i) for i in range(4)]
    for a, b in zip(blocks, blocks[1:]):
        np.testing.assert_array_equal(a[:, -16:], b[:, :16])
    spec = np.abs(np.fft.fft(blocks[0][1, :, 0, 0] + 1j * blocks[0][1, :, 0, 1]))
    assert spec.argmax() == 256 // 4


def test_presets_and_guards(tmp_path):
    red = reducer_for_product("0000", device="cpu")
    assert (red.nfft, red.nint, red.chunk_frames) == (NFFT, 1, 8)
    assert reducer_for_product("0002", device="cpu").nint == 1 << 11
    # .h5 products are written now; blit's refusals of the output knobs
    # come before the recording is opened.
    with pytest.raises(ValueError, match="FBH5 products are float32"):
        reducer_for_product("0000", nbits=8, device="cpu").reduce_to_file(
            "unused.raw", str(tmp_path / "x.h5"))
    with pytest.raises(ValueError, match="compression"):
        red.reduce_to_file("unused.raw", str(tmp_path / "x.fil"), compression="gzip")
    with pytest.raises(ValueError, match="fqav_by"):
        RawReducer(nfft=64, fqav_by=3, device="cpu")


# product → (samples per block, blocks, chunk_frames, expected nsamps,
# expected chunks): 0001 has 1021 frames → chunks of 256, 256, 256 and a
# 253-frame tail rounded to 128; 0002 has 7165 frames → one chunk of
# 4096 and a 3069-frame tail rounded to 2048.
SMALL_FILES = {"0001": (4096, 2, 256, 7, 4), "0002": (1 << 20, 7, 4096, 3, 2)}


@pytest.fixture(scope="module", params=sorted(SMALL_FILES))
def small_products(request, tmp_path_factory):
    product = request.param
    per, nblocks, frames, _, _ = SMALL_FILES[product]
    d = tmp_path_factory.mktemp(f"p{product}")
    raw = str(d / "synth.raw")
    ttesting.synth_raw(raw, nblocks=nblocks, obsnchan=2, ntime_per_block=per,
                       seed=11, tone_chan=TONE_CHAN, tone_freq=0.375,
                       obsbw=-187.5 / 32, obsfreq=8000.0)
    want = str(d / "blit.fil")
    blit_reducer_for(product, chunk_frames=frames, async_output=False
                     ).reduce_to_file(raw, want)
    got = str(d / "port.fil")
    red = reducer_for_product(product, chunk_frames=frames, device="cpu")
    hdr = red.reduce_to_file(raw, got)
    return product, want, got, hdr, red


def test_small_products_header_bytes_identical(small_products):
    product, want, got, hdr, red = small_products
    _, _, _, nsamps, chunks = SMALL_FILES[product]
    assert _header_bytes(got) == _header_bytes(want)
    assert hdr["nsamps"] == nsamps
    assert red.timeline.stages["device"].calls == chunks  # the tail included


def test_small_products_within_f32_bound(small_products):
    product, want_path, got_path, _, _ = small_products
    nfft = {"0001": 8, "0002": 1024}[product]
    _, want = read_fil_data(want_path)
    _, got = read_fil(got_path)
    assert got.shape == want.shape == (SMALL_FILES[product][3], 1, 2 * nfft)
    # atol from the noise-only coarse channel 0, as for 0000 above.
    noise_peak = np.abs(want[..., :nfft]).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2 * noise_peak)
    # The tone (0.375 of a coarse channel, on both fine grids) peaks where
    # both headers put it.
    tone_bin = TONE_CHAN * nfft + nfft // 2 + 3 * nfft // 8
    assert got[0, 0].argmax() == want[0, 0].argmax() == tone_bin


def test_reducer_from_reference_0002():
    ref = blit_reducer_for("0002")
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    coeffs = np.asarray(ref._coeffs)
    red = reducer_from_reference(fields, coeffs, device="cpu")
    np.testing.assert_array_equal(red.coeffs.numpy(), coeffs)
    assert (red.nfft, red.nint, red.chunk_frames) == (1024, 2048, ref.chunk_frames)
    assert red.chunk_frames == reducer_for_product("0002", device="cpu").chunk_frames
