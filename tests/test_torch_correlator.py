"""blit_torch's FX correlator against blit's, on the CPU.

The same numpy-seeded spectra and voltages, and the same RAW files, go
through ``blit`` (its X-engine kernel in interpret mode, its
``correlate`` and streams on a one-device mesh) and through the port
(``blit_torch.ops.xengine``, ``blit_torch.parallel``).  Bounds: the
X-engine rtol 1e-4 / atol 1e-3 on unit-variance spectra, blit's own
(tests/test_pallas_xengine.py:40-43); spectra and visibilities rtol 1e-4
/ atol 1e-4·max (tighter than blit's rtol 1e-3 / atol 0.5 against its
golden at these fixture sizes, tests/test_stream_collectives.py:224-236:
the port's DFT is a matmul where blit's on the CPU is an FFT); bf16
planes 2e-2·max (tests/test_collectives.py:290); RAW voltages, the PFB
prototype and every stream against its one-shot form bitwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import pallas_xengine as RPX  # noqa: E402
from blit.ops.channelize import pfb_coeffs  # noqa: E402
from blit.parallel import antenna as RA  # noqa: E402
from blit.parallel import correlator as RC  # noqa: E402
from blit.parallel.mesh import make_mesh  # noqa: E402
from blit_torch.convert import coeffs_from_reference  # noqa: E402
from blit_torch.ops import xengine as TPX  # noqa: E402
from blit_torch.ops.channelize import fft_planar  # noqa: E402
from blit_torch.parallel import antenna as TA  # noqa: E402
from blit_torch.parallel import correlator as TC  # noqa: E402
from blit_torch.testing import synth_raw  # noqa: E402

CPU = "cpu"
NANT, NCHAN, NPOL = 4, 3, 2
NFFT, NTAP = 16, 4
KEPT = 960          # gap-free samples per recording
START = 48          # the streams re-enter mid-recording
WF = 8              # window frames: 54 frames → 6 full windows + 6


def close(got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


def t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


def equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, 1)


@pytest.fixture(scope="module")
def coeffs():
    return pfb_coeffs(NTAP, NFFT)


@pytest.fixture(scope="module")
def ant_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx_ants")
    paths = []
    for a in range(NANT):
        p = str(d / f"ant{a}.raw")
        synth_raw(p, nblocks=2, obsnchan=NCHAN, ntime_per_block=KEPT // 2,
                  seed=300 + a, tone_chan=a % NCHAN)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def overlap_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx_overlap")
    paths = []
    for a in range(NANT):
        p = str(d / f"ant{a}.raw")
        synth_raw(p, nblocks=3, obsnchan=NCHAN, ntime_per_block=400,
                  overlap=24, seed=400 + a, tone_chan=a % NCHAN)
        paths.append(p)
    return paths


def voltage_case(ntime=NFFT * 20, nant=NANT, nchan=NCHAN, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, 41, (nant, nchan, ntime, NPOL))
            + 1j * rng.integers(-40, 41, (nant, nchan, ntime, NPOL))
            ).astype(np.complex64)


class TestXengineKernel:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("nant,nchan,nfft,nframes,ft", [
        (4, 2, 16, 13, 8),     # several grid steps both axes
        (4, 1, 8, 5, 8),       # single chan, one fine tile
        (8, 3, 32, 6, 16),     # wider tile, odd chan count
    ])
    def test_plain_matches_blit_kernel_interpreted(self, nant, nchan, nfft,
                                                   nframes, ft, dtype):
        rng = np.random.default_rng(nant + nfft)
        shape = (nant, nchan, 2, nframes, nfft)
        sr = rng.standard_normal(shape).astype(np.float32)
        si = rng.standard_normal(shape).astype(np.float32)
        want = RPX.xengine_packed(jnp.asarray(sr).astype(dtype),
                                  jnp.asarray(si).astype(dtype), ft=ft,
                                  interpret=True)
        got = TPX.xengine_packed(*t(sr, si, dtype=getattr(torch, dtype)))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-3)

    def test_cpu_wrapper_is_the_plain_version(self):
        sr, si = t(*np.random.default_rng(0).standard_normal((2, 4, 2, 2, 5, 8)))
        n0 = TPX.xengine_packed.launches
        equal(TPX.xengine_packed(sr, si), TPX.xengine_packed_plain(sr, si))
        assert TPX.xengine_packed.launches == n0

    @pytest.mark.parametrize("nap", [16, 64, 120, 128, 130, 136, 256])
    @pytest.mark.parametrize("nfft", [8, 12, 16, 42, 502, 512])
    def test_gate_keeps_blits_dispatch_rule(self, nap, nfft):
        # blit dispatches on nap >= 128.  Its other rules (nap % 8, a fine
        # tile of 8 or 4 dividing nfft, the VMEM model) are the TPU's tile
        # rules; the Hopper kernel masks ragged tiles, so the gate admits
        # every shape blit admits, and the ragged ones too.
        for itemsize in (4, 2):
            assert TPX.eligible(nap, 16, nfft, itemsize) == (nap >= 128)
            if RPX.pick_ft(nap, nfft, 61, itemsize=itemsize) is not None:
                assert TPX.eligible(nap, 16, nfft, itemsize)

    def test_gate_holds_the_kernels_limits(self):
        # A persistent grid walks the work items: no channel or fine-channel
        # count is beyond the kernel (the grid of the first port's kernel
        # stopped at 65535 of each).  Spectra are f32 or bf16.
        assert TPX.eligible(128, 65535, 32 * 65535)
        assert TPX.eligible(128, 65536, 512)
        assert TPX.eligible(128, 16, 32 * 65535 + 1)
        assert not TPX.eligible(128, 16, 512, itemsize=8)
        # Offsets are 64-bit: spectra past 2^31 elements (64 antennas x 64
        # channels x 2 pols x 1100 frames x 512, bf16) stay on the kernel.
        assert 64 * 64 * 2 * 1100 * 512 > 2 ** 31
        assert TPX.eligible(128, 64, 512, 2)


class TestFEngine:
    def test_f_engine_matches_blit(self, coeffs):
        v = voltage_case()
        x = np.moveaxis(v, 3, 2)  # (a, c, p, t)
        want = RC.f_engine_planar(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  jnp.asarray(coeffs))
        got = TC.f_engine_planar(*t(x.real, x.imag), torch.from_numpy(coeffs))
        for g, w in zip(got, want):
            assert g.shape == (NANT, NCHAN, NPOL, 20 - NTAP + 1, NFFT)
            close(g, w, 1e-4, 1e-4)
        z = TC.f_engine(torch.from_numpy(x), torch.from_numpy(coeffs))
        assert z.dtype == torch.complex64
        assert torch.equal(z.real, got[0]) and torch.equal(z.imag, got[1])

    @pytest.mark.parametrize("n", [16, 512, 6144])
    def test_fft_planar_matches_numpy(self, n):
        rng = np.random.default_rng(n)
        x = rng.standard_normal((2, 3, n)) + 1j * rng.standard_normal((2, 3, n))
        got = fft_planar(*t(x.real, x.imag))
        want = np.fft.fft(x, axis=-1)
        close(got[0], want.real, 1e-4, 1e-5)
        close(got[1], want.imag, 1e-4, 1e-5)

    def test_coeffs_from_reference_are_bitwise(self, coeffs):
        assert np.array_equal(coeffs_from_reference(coeffs, device=CPU).numpy(), coeffs)
        with pytest.raises(ValueError, match="float32"):
            coeffs_from_reference(coeffs.astype(np.float64), device=CPU)


class TestCorrelate:
    @pytest.mark.parametrize("form", ["complex", "planar"])
    @pytest.mark.parametrize("acc_frames", [None, 5])
    @pytest.mark.parametrize("vis_layout", ["standard", "packed"])
    def test_matches_blit(self, mesh, coeffs, vis_layout, acc_frames, form):
        v = voltage_case()
        rv = jnp.asarray(v) if form == "complex" else (
            jnp.asarray(v.real), jnp.asarray(v.imag))
        tv = torch.from_numpy(v) if form == "complex" else tuple(t(v.real, v.imag))
        want = RC.correlate(rv, jnp.asarray(coeffs), mesh=mesh, nfft=NFFT,
                            ntap=NTAP, vis_layout=vis_layout, acc_frames=acc_frames)
        got = TC.correlate(tv, coeffs, nfft=NFFT, ntap=NTAP, vis_layout=vis_layout,
                           acc_frames=acc_frames, device=CPU)
        # nap = 8 < 128: the packed layout takes the matmul route, as blit's
        # takes its einsums.
        assert TC.last_xengine_plan() == {
            "layout": vis_layout, "engine": "matmul", "impl": "plain"}
        if form == "complex":
            assert got.dtype == torch.complex64
            close(got.real, np.real(want), 1e-4, 1e-4)
            close(got.imag, np.imag(want), 1e-4, 1e-4)
        else:
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                close(g, w, 1e-4, 1e-4)

    def test_packed_kernel_route_at_array_width(self, mesh, coeffs):
        # 64 antennas (nap = 128): the gate admits the shape and the CPU
        # runs the kernel's plain version, against blit's einsum X-engine.
        v = voltage_case(ntime=NFFT * 6, nant=64, nchan=1, seed=9)
        want = RC.correlate((jnp.asarray(v.real), jnp.asarray(v.imag)),
                            jnp.asarray(coeffs), mesh=mesh, nfft=NFFT, ntap=NTAP,
                            vis_layout="packed")
        got = TC.correlate(tuple(t(v.real, v.imag)), coeffs, nfft=NFFT, ntap=NTAP,
                           vis_layout="packed", device=CPU)
        assert TC.last_xengine_plan() == {
            "layout": "packed", "engine": "plain", "impl": "plain"}
        for g, w in zip(got, want):
            assert g.shape == (1, NFFT, 64, NPOL, 64, NPOL)
            close(g, w, 1e-4, 1e-4)

    def test_refused_packed_shape_takes_the_matmul_route(self, coeffs, monkeypatch):
        # A shape the gate refuses (here: nap = 128 against blit's
        # dispatch rule raised to 129) takes the matmul route, with the same
        # result.
        x = voltage_case(ntime=NFFT * 6, nant=64, nchan=2, seed=9)
        v = tuple(t(x.real, x.imag))
        want = TC.correlate(v, coeffs, nfft=NFFT, ntap=NTAP, vis_layout="packed",
                            device=CPU)
        assert TC.last_xengine_plan()["engine"] == "plain"
        monkeypatch.setattr(TPX, "MIN_NAP", 129)
        got = TC.correlate(v, coeffs, nfft=NFFT, ntap=NTAP, vis_layout="packed",
                           device=CPU)
        assert TC.last_xengine_plan()["engine"] == "matmul"
        for g, w in zip(got, want):
            close(g, w, 1e-4, 1e-4)

    def test_bf16_planes_match_blit(self, mesh, coeffs):
        v = voltage_case(seed=6)
        want = RC.correlate((jnp.asarray(v.real, jnp.bfloat16),
                             jnp.asarray(v.imag, jnp.bfloat16)),
                            jnp.asarray(coeffs), mesh=mesh, nfft=NFFT, ntap=NTAP)
        got = TC.correlate(tuple(t(v.real, v.imag, dtype=torch.bfloat16)), coeffs,
                           nfft=NFFT, ntap=NTAP, device=CPU)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, 2e-2, 2e-2)

    def test_errors(self, coeffs):
        v = torch.from_numpy(voltage_case())
        with pytest.raises(ValueError, match="bad vis_layout"):
            TC.correlate(v, coeffs, nfft=NFFT, vis_layout="banded", device=CPU)
        with pytest.raises(ValueError, match="coeffs shape"):
            TC.correlate(v, coeffs[:, :8], nfft=NFFT, device=CPU)
        with pytest.raises(ValueError, match="coeffs shape"):
            TC.correlate_stream([], coeffs, nfft=NFFT, ntap=3, device=CPU)
        with pytest.raises(ValueError, match="acc_frames"):
            TC.correlate(v, coeffs, nfft=NFFT, acc_frames=0, device=CPU)
        with pytest.raises(ValueError, match="no windows"):
            TC.correlate_stream([], coeffs, nfft=NFFT, device=CPU)
        with pytest.raises(ValueError, match="multiple of nfft"):
            TC.correlate(v[:, :, :NFFT * 5 + 3], coeffs, nfft=NFFT, device=CPU)


class TestStreams:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_load_correlator_matches_blit(self, mesh, ant_files, dtype):
        hdr, want = RA.load_correlator_mesh(ant_files, mesh=mesh, nfft=NFFT,
                                            ntap=NTAP, start_sample=START,
                                            dtype=dtype)
        thdr, got = TA.load_correlator(ant_files, nfft=NFFT, ntap=NTAP,
                                       start_sample=START, dtype=dtype, device=CPU)
        assert thdr == hdr and got[0].shape[2] == (KEPT - START) // NFFT * NFFT
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))

    @pytest.mark.parametrize("files,start", [("ant_files", START),
                                             ("overlap_files", 5)])
    def test_windows_match_blit(self, mesh, request, files, start):
        paths = request.getfixturevalue(files)
        feed = TA.CorrelatorStream(paths, nfft=NFFT, ntap=NTAP, window_frames=WF,
                                   start_sample=start, device=CPU)
        rfeed = RA.CorrelatorStream(paths, mesh=mesh, nfft=NFFT, ntap=NTAP,
                                    window_frames=WF, start_sample=start)
        assert feed.spans == rfeed.spans and feed.header == rfeed.header
        assert feed.spans[-1][1] < WF  # a ragged last window
        for g, w in zip(feed, rfeed):
            assert (g.index, g.start, g.ntime, g.frames) == (
                w.index, w.start, w.ntime, w.frames)
            equal(g.arrays, w.arrays)
            w.release()
        assert g.index == feed.nwindows - 1

    @pytest.mark.parametrize("vis_layout", ["standard", "packed"])
    def test_stream_matches_blit_and_one_shot(self, mesh, coeffs, ant_files,
                                              vis_layout):
        feed = TA.CorrelatorStream(ant_files, nfft=NFFT, ntap=NTAP, window_frames=WF,
                                   start_sample=START, device=CPU)
        got = TC.correlate_stream(feed, coeffs, nfft=NFFT, ntap=NTAP,
                                  vis_layout=vis_layout, timeline=feed.timeline,
                                  device=CPU)
        _, v = TA.load_correlator(ant_files, nfft=NFFT, ntap=NTAP,
                                  start_sample=START, device=CPU)
        one = TC.correlate(v, coeffs, nfft=NFFT, ntap=NTAP, vis_layout=vis_layout,
                           acc_frames=WF, device=CPU)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
        rfeed = RA.CorrelatorStream(ant_files, mesh=mesh, nfft=NFFT, ntap=NTAP,
                                    window_frames=WF, start_sample=START)
        want = RC.correlate_stream(rfeed, jnp.asarray(coeffs), mesh=mesh, nfft=NFFT,
                                   ntap=NTAP, vis_layout=vis_layout)
        for g, w in zip(got, want):
            close(g, w, 1e-4, 1e-4)
        st = feed.timeline.stages
        seg = (KEPT - START) // NFFT * NFFT
        ov = (NTAP - 1) * NFFT
        fresh = NANT * NCHAN * seg * NPOL * 2
        assert st["ingest"].bytes == st["transfer"].bytes - (feed.nwindows - 1) * (
            NANT * NCHAN * ov * NPOL * 2) == fresh
        assert st["state"].calls == feed.nwindows - 1 == st["device"].calls - 1

    def test_bf16_stream_equals_one_shot_bitwise(self, coeffs, ant_files):
        feed = TA.CorrelatorStream(ant_files, nfft=NFFT, ntap=NTAP, window_frames=WF,
                                   start_sample=START, dtype="bfloat16", device=CPU)
        got = TC.correlate_stream(feed, coeffs, nfft=NFFT, ntap=NTAP,
                                  vis_layout="packed", device=CPU)
        _, v = TA.load_correlator(ant_files, nfft=NFFT, ntap=NTAP,
                                  start_sample=START, dtype="bfloat16", device=CPU)
        one = TC.correlate(v, coeffs, nfft=NFFT, ntap=NTAP, vis_layout="packed",
                           acc_frames=WF, device=CPU)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])

    def test_errors(self, ant_files, tmp_path):
        with pytest.raises(ValueError, match="nfft-blocks"):
            TA.CorrelatorStream(ant_files, nfft=NFFT, ntap=NTAP, window_frames=WF,
                                start_sample=KEPT - 3 * NFFT, device=CPU)
        with pytest.raises(ValueError, match="nfft-blocks"):
            TA.load_correlator(ant_files, nfft=NFFT, ntap=NTAP,
                               max_samples=3 * NFFT, device=CPU)
        with pytest.raises(ValueError, match="window_frames"):
            TA.CorrelatorStream(ant_files, nfft=NFFT, window_frames=0, device=CPU)
        with pytest.raises(ValueError, match="start_sample"):
            TA.load_correlator(ant_files, nfft=NFFT, start_sample=-1, device=CPU)

    # The degraded continuation is ported with the mesh, alone or beside
    # the producer thread and its watchdog: with no failure the masked
    # feed's visibilities equal the raising feed's bitwise.
    @pytest.mark.parametrize("kw", [{"on_antenna_error": "mask", "prefetch_depth": 2},
                                    {"on_antenna_error": "mask", "stall_timeout_s": 5.0},
                                    {"on_antenna_error": "mask"}])
    def test_unported_options_name_their_roadmap_item(self, ant_files, kw):
        coeffs = pfb_coeffs(NTAP, NFFT)
        feed = TA.CorrelatorStream(ant_files, nfft=NFFT, window_frames=WF,
                                   device=CPU, **kw)
        got = TC.correlate_stream(feed, coeffs, nfft=NFFT, ntap=NTAP, device=CPU)
        want = TC.correlate_stream(
            TA.CorrelatorStream(ant_files, nfft=NFFT, window_frames=WF, device=CPU),
            coeffs, nfft=NFFT, ntap=NTAP, device=CPU)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert feed.masked_antennas == set()
        with pytest.raises(ValueError, match="on_antenna_error"):
            TA.CorrelatorStream(ant_files, nfft=NFFT, window_frames=WF,
                                on_antenna_error="skip", device=CPU)
