"""blit_torch's tied-array beamformer against blit's, on the CPU.

The same numpy-seeded voltages and weights, and the same RAW files, go
through ``blit`` (its Pallas kernel in interpret mode, its ``beamform``
and streams on a one-device mesh) and through the port
(``blit_torch.ops.beamform``, ``blit_torch.parallel``).  Bounds:
detected power rtol 1e-4 / atol 1e-3·max, blit's own
(tests/test_pallas_beamform.py:43-46), also for bf16 operands when both
sides round the same operands (the kernel and its plain version); bf16
planes against blit's bf16 route, which rounds its beams to bf16 where
the port's fused route does not, rtol / atol 3e-2·max
(tests/test_pallas_beamform.py:66-69); beam voltages rtol 1e-4 / atol
1e-4·max; RAW voltages and the weights carried over bitwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import pallas_beamform as RPB  # noqa: E402
from blit.parallel import antenna as RA  # noqa: E402
from blit.parallel import beamform as RB  # noqa: E402
from blit.parallel.mesh import make_mesh  # noqa: E402
from blit_torch.convert import beam_weights_from_reference  # noqa: E402
from blit_torch.ops import beamform as TPB  # noqa: E402
from blit_torch.parallel import antenna as TA  # noqa: E402
from blit_torch.parallel import beamform as TB  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

CPU = "cpu"
NANT, NCHAN, NPOL, NBEAM = 4, 4, 2, 5
KEPT = 960          # gap-free samples per recording
START = 48          # the streams re-enter mid-recording
TOTAL = 896         # samples from START (a multiple of NINT)
W = 128             # window: 7 windows over TOTAL
NINT = 4


def close(got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


def packed_case(nchan=3, nant=6, nbeam=5, npol=2, ntime=256, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.integers(-40, 41, (2, nchan, nant, npol, ntime)).astype(np.float32)
    w = rng.standard_normal((2, nchan, nbeam, nant)).astype(np.float32)
    return v[0], v[1], w[0], w[1]


def t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


def ref_weights(seed=3, nbeam=NBEAM, nant=NANT, nchan=NCHAN):
    rng = np.random.default_rng(seed)
    wr, wi = RB.delay_weights_planar(
        jnp.asarray(rng.uniform(0, 1e-9, (nbeam, nant))),
        jnp.asarray(np.linspace(1e9, 1.1e9, nchan)))
    return np.array(wr), np.array(wi)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, 1)


@pytest.fixture(scope="module")
def ant_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf_ants")
    paths = []
    for a in range(NANT):
        p = str(d / f"ant{a}.raw")
        synth_raw(p, nblocks=2, obsnchan=NCHAN, ntime_per_block=KEPT // 2,
                  seed=100 + a, tone_chan=a % NCHAN)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def overlap_files(tmp_path_factory):
    # Blocks share OVERLAP samples, as recordings at GBT do: the gap-free
    # stream drops them from every block but the last.
    d = tmp_path_factory.mktemp("bf_overlap")
    paths = []
    for a in range(NANT):
        p = str(d / f"ant{a}.raw")
        synth_raw(p, nblocks=3, obsnchan=NCHAN, ntime_per_block=400,
                  overlap=40, seed=200 + a, tone_chan=a % NCHAN)
        paths.append(p)
    return paths


class TestFusedKernel:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("nint,tile", [(1, 32), (2, 64), (4, 64), (8, 128)])
    def test_plain_matches_blit_kernel_interpreted(self, nint, tile, dtype):
        vr, vi, wr, wi = packed_case(seed=nint)
        want = np.asarray(RPB.fused_beamform_detect(
            *(jnp.asarray(a).astype(dtype) for a in (vr, vi, wr, wi)),
            nint=nint, tile=tile, interpret=True))
        got = TPB.fused_beamform_detect(
            *t(vr, vi, wr, wi, dtype=getattr(torch, dtype)), nint=nint)
        assert got.dtype == torch.float32 and got.shape == want.shape
        close(got, want, 1e-4, 1e-3)

    def test_cpu_wrapper_is_the_plain_version(self):
        args = t(*packed_case())
        n0 = TPB.fused_beamform_detect.launches
        assert torch.equal(TPB.fused_beamform_detect(*args, nint=2),
                           TPB.fused_beamform_detect_plain(*args, nint=2))
        assert TPB.fused_beamform_detect.launches == n0

    def test_pack_matches_blit(self):
        rng = np.random.default_rng(1)
        vr, vi = rng.standard_normal((2, NANT, NCHAN, 64, NPOL)).astype(np.float32)
        wr, wi = rng.standard_normal((2, NBEAM, NANT, NCHAN)).astype(np.float32)
        for got, want in zip(TPB.pack_voltages(*t(vr, vi)) + TPB.pack_weights(*t(wr, wi)),
                             RPB.pack_voltages(vr, vi) + RPB.pack_weights(wr, wi)):
            assert np.array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("args,ok", [
        ((64, 64, 2, 8192, 8, 4), True),    # bench.py's array shape, f32
        ((64, 64, 2, 8192, 8, 2), True),    # and bf16
        ((64, 64, 2, 8192, 128, 4), True),  # the largest nint
        ((64, 64, 2, 8192, 256, 4), False),
        ((64, 64, 2, 8192, 3, 4), False),   # not a power of two
        ((64, 64, 2, 100, 8, 4), False),    # nint does not divide ntime
        ((64, 64, 2, 8192, 8, 8), False),   # f64
        ((3, 1000, 1, 136, 8, 4), True),    # ragged tiles are masked
        ((64, 64, 2, 8192, 8, 4, 65535), True),   # the grid's channel limit
        ((64, 64, 2, 8192, 8, 4, 65536), False),
    ])
    def test_hopper_gate(self, args, ok):
        assert TPB.fits(*args) is ok

    def test_indivisible_nint_raises(self):
        args = t(*packed_case(ntime=100))
        with pytest.raises(ValueError, match="does not divide"):
            TPB.fused_beamform_detect(*args, nint=8)
        with pytest.raises(ValueError, match="does not divide"):
            TPB.fused_beamform_detect_plain(*args, nint=8)


class TestWeights:
    @pytest.mark.parametrize("amplitudes", [None, "per_antenna", "per_beam"])
    def test_delay_weights_match_blit(self, amplitudes):
        rng = np.random.default_rng(7)
        delays = rng.uniform(0, 1e-9, (NBEAM, NANT))
        freqs = np.linspace(1e9, 1.1e9, NCHAN)
        amp = {None: None, "per_antenna": rng.uniform(0.5, 1, NANT),
               "per_beam": rng.uniform(0.5, 1, (NBEAM, NANT))}[amplitudes]
        want = RB.delay_weights_planar(jnp.asarray(delays), jnp.asarray(freqs),
                                       None if amp is None else jnp.asarray(amp))
        got = TB.delay_weights_planar(delays, freqs, amp, device=CPU)
        # The phase is formed in f32 as in blit; cos and sin of it come from
        # two libraries, a few ulp apart.
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)
        wc = TB.delay_weights(delays, freqs, amp, device=CPU)
        assert wc.dtype == torch.complex64
        assert torch.equal(wc.real, got[0]) and torch.equal(wc.imag, got[1])

    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_weights_from_reference_are_bitwise(self, layout):
        wr, wi = ref_weights()
        got = beam_weights_from_reference(wr, wi, layout=layout, device=CPU)
        want = (wr, wi) if layout == "antenna" else RPB.pack_weights(wr, wi)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        with pytest.raises(ValueError, match="float32"):
            beam_weights_from_reference(wr.astype(np.float64), wi, device=CPU)


def voltage_case(ntime=256, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, 41, (NANT, NCHAN, ntime, NPOL))
            + 1j * rng.integers(-40, 41, (NANT, NCHAN, ntime, NPOL))
            ).astype(np.complex64)


class TestBeamform:
    @pytest.mark.parametrize("form", ["complex", "planar"])
    @pytest.mark.parametrize("detect", [True, False])
    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_matches_blit(self, mesh, layout, detect, form):
        v = voltage_case()
        wr, wi = ref_weights()
        if layout == "chan":
            v = np.transpose(v, (1, 0, 3, 2)).copy()
            wr, wi = (np.array(a) for a in RPB.pack_weights(wr, wi))
        if form == "complex":
            rv, rw = jnp.asarray(v), jnp.asarray(wr + 1j * wi)
            tv, tw = torch.from_numpy(v), torch.complex(*t(wr, wi))
        else:
            rv = (jnp.asarray(v.real), jnp.asarray(v.imag))
            rw = (jnp.asarray(wr), jnp.asarray(wi))
            tv, tw = tuple(t(v.real, v.imag)), tuple(t(wr, wi))
        want = RB.beamform(rv, rw, mesh=mesh, nint=NINT, detect=detect,
                           layout=layout)
        got = TB.beamform(tv, tw, nint=NINT, detect=detect, layout=layout,
                          device=CPU)
        assert TB.last_beamform_plan() == {
            "layout": layout, "fused": layout == "chan" and detect, "impl": "plain"}
        if detect:
            assert got.dtype == torch.float32
            close(got, want, 1e-4, 1e-3)
        elif form == "complex":
            assert got.dtype == torch.complex64
            close(got.real, np.real(want), 1e-4, 1e-4)
            close(got.imag, np.imag(want), 1e-4, 1e-4)
        else:
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                close(g, w, 1e-4, 1e-4)

    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_bf16_planes_match_blit(self, mesh, layout):
        v = voltage_case(seed=6)
        wr, wi = ref_weights()
        if layout == "chan":
            v = np.transpose(v, (1, 0, 3, 2)).copy()
            wr, wi = (np.array(a) for a in RPB.pack_weights(wr, wi))
        want = RB.beamform(
            (jnp.asarray(v.real, jnp.bfloat16), jnp.asarray(v.imag, jnp.bfloat16)),
            (jnp.asarray(wr), jnp.asarray(wi)), mesh=mesh, nint=NINT, layout=layout)
        got = TB.beamform(tuple(t(v.real, v.imag, dtype=torch.bfloat16)),
                          tuple(t(wr, wi)), nint=NINT, layout=layout, device=CPU)
        assert got.dtype == torch.float32
        close(got, np.asarray(want, np.float32), 3e-2, 3e-2)
        # The weights are rounded to bf16 before the products: against the
        # f32 route the error is ~1e-2 of the power, far above f32 rounding.
        f32 = TB.beamform(tuple(t(v.real, v.imag)), tuple(t(wr, wi)), nint=NINT,
                          layout=layout, device=CPU)
        assert (got - f32).abs().max() > 1e-4 * f32.abs().max()

    def test_errors(self):
        v = tuple(t(*np.zeros((2, NANT, NCHAN, 100, NPOL), np.float32)))
        w = tuple(t(*ref_weights()))
        with pytest.raises(ValueError, match="bad layout"):
            TB.beamform(v, w, layout="band", device=CPU)
        with pytest.raises(ValueError, match="does not divide"):
            TB.beamform(v, w, nint=8, device=CPU)
        with pytest.raises(ValueError, match="does not divide"):
            TB.beamform(v, w, nint=0, device=CPU)


class TestFeeds:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_load_antennas_matches_blit(self, mesh, ant_files, layout, dtype):
        hdr, want = RA.load_antennas_mesh(ant_files, mesh=mesh, start_sample=START,
                                          max_samples=TOTAL, dtype=dtype,
                                          layout=layout)
        thdr, got = TA.load_antennas(ant_files, start_sample=START,
                                     max_samples=TOTAL, dtype=dtype,
                                     layout=layout, device=CPU)
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype) and g.is_contiguous()
            assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))
        assert thdr == hdr

    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_overlapping_blocks_match_blit(self, mesh, overlap_files, layout):
        _, want = RA.load_antennas_mesh(overlap_files, mesh=mesh, layout=layout)
        _, got = TA.load_antennas(overlap_files, layout=layout, device=CPU)
        assert got[0].shape[-1 if layout == "chan" else 2] == 3 * 400 - 2 * 40
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        # A window that straddles the blocks' shared samples.
        feed = TA.AntennaStream(overlap_files, window_samples=300, start_sample=90,
                                layout=layout, device=CPU)
        rfeed = RA.AntennaStream(overlap_files, mesh=mesh, window_samples=300,
                                 start_sample=90, layout=layout)
        for g, w in zip(feed, rfeed):
            assert (g.index, g.start, g.ntime) == (w.index, w.start, w.ntime)
            for a, b in zip(g.arrays, w.arrays):
                assert np.array_equal(a.numpy(), np.asarray(b))
            w.release()

    @pytest.mark.parametrize("window", [W, 200])
    def test_antenna_stream_windows_match_blit(self, mesh, ant_files, window):
        # 200 does not divide TOTAL: the last window is smaller.
        feed = TA.AntennaStream(ant_files, window_samples=window,
                                start_sample=START, max_samples=TOTAL, device=CPU)
        rfeed = RA.AntennaStream(ant_files, mesh=mesh, window_samples=window,
                                 start_sample=START, max_samples=TOTAL)
        assert feed.spans == rfeed.spans and feed.nwindows == -(-TOTAL // window)
        assert feed.header == rfeed.header
        n = 0
        for g, w in zip(feed, rfeed):
            assert (g.index, g.start, g.ntime, g.frames) == (
                w.index, w.start, w.ntime, w.frames)
            for a, b in zip(g.arrays, w.arrays):
                assert np.array_equal(a.numpy(), np.asarray(b))
            w.release()
            n += 1
        assert n == feed.nwindows and g.ntime == TOTAL - (feed.nwindows - 1) * window

    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_beamform_stream_matches_blit_and_one_shot(self, mesh, ant_files, layout):
        wr, wi = ref_weights()
        w = beam_weights_from_reference(wr, wi, layout=layout, device=CPU)
        rw = (wr, wi) if layout == "antenna" else tuple(
            np.asarray(a) for a in RPB.pack_weights(wr, wi))
        feed = TA.AntennaStream(ant_files, window_samples=W, start_sample=START,
                                max_samples=TOTAL, layout=layout, device=CPU)
        slabs = list(TB.beamform_stream(feed, w, nint=NINT, layout=layout,
                                        timeline=feed.timeline, device=CPU))
        assert len(slabs) == TOTAL // W
        axis = 2 if layout == "antenna" else 3
        streamed = torch.cat(slabs, dim=axis)
        _, v = TA.load_antennas(ant_files, start_sample=START, max_samples=TOTAL,
                                layout=layout, device=CPU)
        one = TB.beamform(v, w, nint=NINT, layout=layout, device=CPU)
        assert torch.equal(streamed, one)
        rfeed = RA.AntennaStream(ant_files, mesh=mesh, window_samples=W,
                                 start_sample=START, max_samples=TOTAL, layout=layout)
        want = np.concatenate(list(RB.beamform_stream(
            rfeed, rw, mesh=mesh, nint=NINT, layout=layout)), axis=axis)
        close(streamed, want, 1e-4, 1e-3)
        st = feed.timeline.stages
        raw = NANT * NCHAN * TOTAL * NPOL * 2
        assert (st["ingest"].bytes, st["transfer"].bytes, st["pack"].bytes) == (
            raw, raw, 4 * raw)
        assert st["device"].calls == len(slabs) == st["readback"].calls

    @pytest.mark.parametrize("layout", ["antenna", "chan"])
    def test_beamform_accumulate_matches_blit(self, mesh, ant_files, layout):
        wr, wi = ref_weights()
        w = beam_weights_from_reference(wr, wi, layout=layout, device=CPU)
        rw = (wr, wi) if layout == "antenna" else tuple(
            np.asarray(a) for a in RPB.pack_weights(wr, wi))
        feed = TA.AntennaStream(ant_files, window_samples=W, start_sample=START,
                                max_samples=TOTAL, layout=layout, device=CPU)
        got = TB.beamform_accumulate(feed, w, layout=layout, device=CPU)
        rfeed = RA.AntennaStream(ant_files, mesh=mesh, window_samples=W,
                                 start_sample=START, max_samples=TOTAL, layout=layout)
        want = RB.beamform_accumulate(rfeed, rw, mesh=mesh, layout=layout)
        assert got.shape == want.shape
        close(got, want, 1e-4, 1e-3)
        # The same total as the one-shot power summed over the span.
        _, v = TA.load_antennas(ant_files, start_sample=START, max_samples=TOTAL,
                                layout=layout, device=CPU)
        one = TB.beamform(v, w, nint=TOTAL, layout=layout, device=CPU)
        close(got, one, 1e-5, 1e-5)

    def test_bf16_stream_equals_one_shot_bitwise(self, ant_files):
        w = beam_weights_from_reference(*ref_weights(), layout="chan", device=CPU)
        feed = TA.AntennaStream(ant_files, window_samples=W, start_sample=START,
                                max_samples=TOTAL, dtype="bfloat16", layout="chan",
                                device=CPU)
        streamed = torch.cat(list(TB.beamform_stream(
            feed, w, nint=NINT, layout="chan", device=CPU)), dim=3)
        _, v = TA.load_antennas(ant_files, start_sample=START, max_samples=TOTAL,
                                dtype="bfloat16", layout="chan", device=CPU)
        assert torch.equal(streamed, TB.beamform(v, w, nint=NINT, layout="chan",
                                                 device=CPU))

    def test_errors(self, ant_files, tmp_path):
        w = tuple(t(*ref_weights()))
        feed = TA.AntennaStream(ant_files, window_samples=W + 2, device=CPU)
        with pytest.raises(ValueError, match="whole number"):
            list(TB.beamform_stream(feed, w, nint=NINT, device=CPU))
        with pytest.raises(ValueError, match="no windows"):
            TB.beamform_accumulate([], w, device=CPU)
        with pytest.raises(ValueError, match="no antenna"):
            TA.load_antennas([], device=CPU)
        with pytest.raises(ValueError, match="no common samples"):
            TA.AntennaStream(ant_files, window_samples=W, start_sample=KEPT,
                             device=CPU)
        with pytest.raises(ValueError, match="bad layout"):
            TA.load_antennas(ant_files, layout="band", device=CPU)
        with pytest.raises(ValueError, match="failed to open"):
            TA.load_antennas(ant_files + [str(tmp_path / "missing.raw")], device=CPU)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            TA.load_antennas(ant_files, dtype="float16", device=CPU)
        other = str(tmp_path / "eight.raw")
        synth_raw(other, nblocks=2, obsnchan=8, ntime_per_block=64)
        with pytest.raises(ValueError, match="disagree"):
            TA.load_antennas(ant_files + [other], device=CPU)

    # The degraded continuation is ported with the mesh, alone or beside
    # the producer thread and its watchdog: with no failure the masked
    # feed's windows equal the raising feed's bitwise and mask nothing.
    @pytest.mark.parametrize("kw", [{"on_antenna_error": "mask", "prefetch_depth": 2},
                                    {"on_antenna_error": "mask", "stall_timeout_s": 5.0},
                                    {"on_antenna_error": "mask"}])
    def test_unported_options_name_their_roadmap_item(self, ant_files, kw):
        feed = TA.AntennaStream(ant_files, window_samples=W, device=CPU, **kw)
        plain = TA.AntennaStream(ant_files, window_samples=W, device=CPU)
        for a, b in zip(feed, plain):
            assert a.masked == () and torch.equal(a.arrays[0], b.arrays[0])
            assert torch.equal(a.arrays[1], b.arrays[1])
            a.release(), b.release()
        assert feed.masked_antennas == set()
        assert "_masked_antennas" not in feed.header
        with pytest.raises(ValueError, match="on_antenna_error"):
            TA.AntennaStream(ant_files, window_samples=W, device=CPU,
                             on_antenna_error="skip")
