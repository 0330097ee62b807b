"""blit_torch's (band, bank) mesh against blit's, on the CPU.

The port seats its players on ``cpu`` (an explicit device list may repeat
a device); blit runs on the 8 virtual CPU devices of tests/conftest.py.
The same numpy-seeded voltages go through ``blit.parallel.mesh`` and
``blit_torch.parallel.mesh``: products within blit's channelize bounds
(tests/test_channelize.py:106, rtol 1e-4 / atol 1e-2), the stitch and
the despike exact within the port, the byte models and the rule
registry equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from blit.observability import Timeline as RTimeline  # noqa: E402
from blit.parallel import mesh as RM  # noqa: E402
from blit_torch.observability import Timeline  # noqa: E402
from blit_torch.ops.channelize import pfb_coeffs  # noqa: E402
from blit_torch.parallel import mesh as M  # noqa: E402
from blit_torch.testing import make_voltages  # noqa: E402

NFFT, NINT, NCHAN, NTAP = 64, 2, 2, 4


def cpu_mesh(nband, nbank):
    return M.make_mesh(nband, nbank, devices=["cpu"] * (nband * nbank))


def grid_voltages(nband, nbank, frames=4, seed=0):
    """(nband, nbank, nchan, ntime, 2, 2) int8, one seed a player."""
    ntime = (frames + NTAP - 1) * NFFT
    return np.stack([np.stack([make_voltages(obsnchan=NCHAN, ntime=ntime,
                                             seed=seed + b * 8 + k)
                               for k in range(nbank)]) for b in range(nband)])


class TestRules:
    def test_roles_split_the_same_axes_as_blit(self):
        assert sorted(M.PARTITION_RULES) == sorted(RM.PARTITION_RULES)
        for role, spec in RM.PARTITION_RULES.items():
            assert tuple(M.partition_rule(role)) == tuple(spec), role

    def test_spec_passes_through_and_unknown_role_lists_known(self):
        spec = M.P("band", None)
        assert M.partition_rule(spec) is spec
        with pytest.raises(KeyError, match="known roles"):
            M.partition_rule("nope")
        with pytest.raises(ValueError, match="unknown mesh axis"):
            M.P("chip")

    def test_histogram_names_unchanged(self):
        assert M.MESH_HISTS == RM.MESH_HISTS

    @pytest.mark.parametrize("nbytes,axis", [(0, 1), (1000, 1), (1000, 2),
                                             (4096, 4), (12345, 8), (7, 3)])
    def test_byte_models_equal_blit(self, nbytes, axis):
        assert M.gather_ici_bytes(nbytes, axis) == RM.gather_ici_bytes(nbytes, axis)
        assert M.psum_ici_bytes(nbytes, axis) == RM.psum_ici_bytes(nbytes, axis)

    def test_record_ici_accounts_as_blit(self):
        tl, rtl = Timeline(), RTimeline()
        for t in (tl, rtl):
            M.record_ici(t, "gather", 100) if t is tl else RM.record_ici(t, "gather", 100)
        M.record_ici(tl, "psum", 50, seconds=0.25)
        RM.record_ici(rtl, "psum", 50, seconds=0.25)
        for name in ("mesh.gather_ici_bytes", "mesh.psum_ici_bytes", "mesh.psum_s"):
            assert tl.hists[name].n == rtl.hists[name].n == 1
            assert tl.hists[name].total == rtl.hists[name].total
        assert (tl.stages["mesh.ici"].calls, tl.stages["mesh.ici"].bytes) == \
            (rtl.stages["mesh.ici"].calls, rtl.stages["mesh.ici"].bytes)


class TestMakeMesh:
    def test_refuses_too_few_devices_like_blit(self):
        with pytest.raises(ValueError, match="need 8 devices for a 1x8 mesh"):
            M.make_mesh(1, 8, devices=["cpu"] * 7)
        with pytest.raises(ValueError, match="need 8 devices for a 1x8 mesh"):
            RM.make_mesh(1, 8, devices=jax.devices()[:7])

    @pytest.mark.parametrize("nband,nbank", [(1, 8), (2, 4), (1, 1)])
    def test_repeated_device_seats_every_player(self, nband, nbank):
        m = cpu_mesh(nband, nbank)
        assert m.devices.shape == (nband, nbank)
        assert m.shape == {"band": nband, "bank": nbank}
        assert m.size == nband * nbank
        assert {str(d) for d in m.devices.ravel()} == {"cpu"}
        assert (m.ranks == 0).all() and m.nprocs() == 1
        assert sorted(m.local_players()) == m.players()
        assert not m.spans_processes("bank") and not m.spans_processes("band")

    def test_player_map_matches_blit_shape(self):
        from blit.parallel.multihost import player_map as rpm

        from blit_torch.parallel.multihost import player_map

        assert sorted(player_map(cpu_mesh(2, 4))) == sorted(rpm(RM.make_mesh(2, 4)))


class TestMeshArray:
    def test_device_put_round_trips(self):
        m = cpu_mesh(2, 4)
        x = np.arange(2 * 3 * 8, dtype=np.float32).reshape(2, 3, 8)
        a = M.device_put(x, M.NamedSharding(m, M.P("band", None, "bank")))
        assert a.shard((1, 2)).shape == (1, 3, 2)
        np.testing.assert_array_equal(np.asarray(a), x)
        pair = M.device_put((x, x + 1), M.NamedSharding(m, M.P()))
        assert all(isinstance(p, M.MeshArray) for p in pair)

    def test_numpy_refuses_missing_parts(self):
        m = cpu_mesh(1, 4)
        a = M.device_put(np.ones((1, 8)), M.NamedSharding(m, M.P(None, "bank")))
        del a.shards[(0, 3)]
        with pytest.raises(ValueError, match="not held by this process"):
            a.numpy()

    def test_indivisible_split_raises(self):
        with pytest.raises(ValueError, match="does not split"):
            M.device_put(np.ones((3, 5)), M.NamedSharding(cpu_mesh(1, 4),
                                                          M.P(None, "bank")))


class TestBandReduce:
    @pytest.mark.parametrize("nband,nbank", [(1, 4), (2, 2)])
    @pytest.mark.parametrize("stitch,despike_nfpc,fqav_by",
                             [(True, 0, 1), (True, NFFT, 1), (True, NFFT // 4, 4),
                              (False, 0, 1), (False, NFFT, 1)])
    def test_matches_blit(self, nband, nbank, stitch, despike_nfpc, fqav_by):
        v = grid_voltages(nband, nbank)
        h = pfb_coeffs(NTAP, NFFT)
        rmesh = RM.make_mesh(nband, nbank)
        want = np.asarray(RM.band_reduce(
            RM.shard_voltages(v, rmesh), jax.numpy.asarray(h), mesh=rmesh,
            nfft=NFFT, nint=NINT, stitch=stitch, despike_nfpc=despike_nfpc,
            fqav_by=fqav_by))
        m = cpu_mesh(nband, nbank)
        got = M.band_reduce(M.shard_voltages(v, m), torch.from_numpy(h), mesh=m,
                            nfft=NFFT, nint=NINT, stitch=stitch,
                            despike_nfpc=despike_nfpc, fqav_by=fqav_by)
        assert got.spec == M.partition_rule(
            "filterbank_stitched" if stitch else "filterbank_sharded")
        got = np.asarray(got)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)

    def test_stitch_is_the_concatenation_and_despike_exact(self):
        m = cpu_mesh(2, 4)
        v = grid_voltages(2, 4, seed=5)
        h = torch.from_numpy(pfb_coeffs(NTAP, NFFT))
        part = M.band_reduce(M.shard_voltages(v, m), h, mesh=m, nfft=NFFT,
                             nint=NINT, stitch=False)
        flat = np.asarray(part)
        st = M.stitch_bands(part, m)
        np.testing.assert_array_equal(np.asarray(st), flat)
        # Every player of a row holds the whole band (one tensor on one
        # device, shared).
        assert st.shards[(1, 0)] is st.shards[(1, 3)]
        ds = np.asarray(M.stitch_despike(part, mesh=m, despike_nfpc=NFFT))
        want = flat.copy()
        want[..., NFFT // 2::NFFT] = flat[..., NFFT // 2 - 1::NFFT]
        np.testing.assert_array_equal(ds, want)
        whole = M.band_reduce(M.shard_voltages(v, m), h, mesh=m, nfft=NFFT,
                              nint=NINT, despike_nfpc=NFFT)
        np.testing.assert_array_equal(np.asarray(whole), want)

    def test_timed_stitch_returns_the_stitch(self):
        m = cpu_mesh(1, 4)
        part = M.band_reduce(M.shard_voltages(grid_voltages(1, 4), m),
                             torch.from_numpy(pfb_coeffs(NTAP, NFFT)), mesh=m,
                             nfft=NFFT, nint=NINT, stitch=False)
        out, s = M.timed_stitch(part, mesh=m, despike_nfpc=0, timeline=None)
        assert s >= 0
        np.testing.assert_array_equal(np.asarray(out), np.asarray(part))


class TestPsum:
    @pytest.mark.parametrize("axis", ["band", "bank"])
    def test_groups_sum_in_axis_order(self, axis):
        m = cpu_mesh(2, 4)
        parts = {p: (torch.full((3,), float(10 * p[0] + p[1])),)
                 for p in m.players()}
        groups = M.psum_groups(m, parts, axis)
        if axis == "bank":
            assert sorted(groups) == [0, 1]
            for b in (0, 1):
                assert groups[b][0].tolist() == [40.0 * b + 6.0] * 3
        else:
            assert sorted(groups) == [0, 1, 2, 3]
            for k in range(4):
                assert groups[k][0].tolist() == [10.0 + 2 * k] * 3

    def test_pod_gather_outside_a_pod_is_local(self):
        m = cpu_mesh(1, 2)
        local = {(0, 0): torch.zeros(2), (0, 1): torch.ones(2)}
        got, staged = M.pod_gather(m, local)
        assert staged == 0 and got.keys() == local.keys()


class TestShardedAccumulator:
    def test_fold_before_init_raises(self):
        acc = M.ShardedAccumulator(cpu_mesh(1, 2), "beamform_acc")
        with pytest.raises(RuntimeError, match="before init"):
            acc.fold(lambda v: v)

    def test_fold_preserving_rule_passes(self):
        m = cpu_mesh(1, 2)
        acc = M.ShardedAccumulator(m, "vis_acc_packed")
        a = M.device_put(np.zeros((1, 4)), M.NamedSharding(m, "vis_acc_packed"))
        acc.init(a)

        def add(value, x):
            value.shards = {p: t + x for p, t in value.shards.items()}
            return value

        acc.fold(add, 1.0)
        np.testing.assert_array_equal(np.asarray(acc.value), np.ones((1, 4)))
        assert acc.sharding.spec == M.partition_rule("vis_acc_packed")

    def test_spec_drift_fails_loudly(self):
        m = cpu_mesh(1, 2)
        acc = M.ShardedAccumulator(m, "vis_acc_packed")
        acc.init(M.device_put(np.zeros((1, 4)), M.NamedSharding(m, "vis_acc_packed")))
        with pytest.raises(ValueError, match="drifted"):
            acc.fold(lambda v: M.device_put(np.zeros((1, 4)),
                                            M.NamedSharding(m, "replicated")))
