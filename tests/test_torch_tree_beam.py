"""Torch mirrors of the schedules of the two kernels redesigned for the
H100, ``csrc/taylor_tree.cu`` and ``csrc/beamform_detect.cu``, held
against the plain versions and blit on the CPU (the kernels themselves run
only on the card: tests/test_torch_cuda.py).

- The tree: the kernel's decomposition step by step (its tiles, staged
  rows with their halos and zeros past the band, the register subtrees of
  the first three stages and of the rest, the global passes over a
  scratch plane in natural column order for the negative sign) must give
  the plain version's bits at every window 2..1024, both signs, on widths
  that span several tiles and on a width of a few columns; and blit's
  interpreted Pallas tree's bits up to T = 256; at T = 512 and 1024, where
  blit's VMEM gate refuses the Pallas block or its tree compiles for tens
  of seconds on the CPU, blit's brute force on integer-valued power,
  which every order of f32 adds sums exactly.  Values are compared as
  int32 bits.
- The beamform: the persistent blocks' item ranges, antenna chunks and
  detect-and-integrate stores write every (chan, beam, pol, output) once,
  and no padded beam or sample; the weight tile a slot holds is loaded
  again exactly when the (channel, beam tile, antenna chunk) changes.
- The f32 arithmetic of the beamform on the tensor cores: three tf32
  passes (x = hi + lo, hi rounded to nearest with ties away, lo cut to
  tf32) of 8-antenna MMAs added to the f32 sums in the kernel's order,
  then |B|^2 and the fixed integration tree, held to
  the smoke's f32 bound (rtol 1e-4, atol 1e-3 of the peak and of the
  median power) against the plain version and blit's interpreted kernel.
  One tf32 pass (the control) lands ~1000 times farther from the plain
  version and misses the bound before integration (nint <= 4).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blit.ops import pallas_beamform as RPB  # noqa: E402
from blit.ops import pallas_dedoppler as bpd  # noqa: E402
from blit_torch.ops import beamform as tbf  # noqa: E402
from blit_torch.ops import dedoppler as tpd  # noqa: E402

# -- the tree ---------------------------------------------------------------
# csrc/taylor_tree.cu's geometry: threads a block; the registers route's and
# the passes' strips a thread, natural columns a block and staged columns a
# row; the shared route's tile for 2^s2 groups of 8 rows (tile_geo).
NT, SPT = 256, 2
BW = 4 * NT * SPT
WSB = BW + 16
WIDE_F = 2 * BW + 37  # several tiles of every route, odd


ROUNDS = 2  # the shared route's phase-1 rounds


def tile_geo(s2):
    """(rows, phase-1 columns, output columns, staged columns)."""
    r1 = 8 << s2
    wt = ROUNDS * 4 * (NT // (r1 // 8))
    return r1, wt, wt - r1, wt + 8


def _stage(rows, nlo, width, F):
    """Row r of ``rows`` over natural columns nlo[r] + [0, width), zeros
    outside [0, F): what the cp.async copies put in shared memory."""
    nat = nlo[:, None] + torch.arange(width)
    got = torch.gather(rows, 1, nat.clamp(0, rows.shape[1] - 1))
    return torch.where((nat >= 0) & (nat < F), got, torch.zeros(()))


def _subtree(leaves):
    """The register subtree: leaf m is a (..., 4 + m) window; at each level
    the block of rows from L0 is computed over columns [0, 4 + L0), row e =
    top[e>>1] + bot[e>>1] shifted by (e+1)>>1: one f32 add an element."""
    rows = list(leaves)
    R, H = len(rows), 1
    while H < R:
        for L0 in range(0, R, 2 * H):
            w = 4 + L0
            rows[L0:L0 + 2 * H] = [
                rows[L0 + (e >> 1)][..., :w]
                + rows[L0 + H + (e >> 1)][..., (e + 1) >> 1:((e + 1) >> 1) + w]
                for e in range(2 * H)]
        H *= 2
    return rows


def _window(rows, start, width, limit):
    """rows (J, W) at columns start (J, nstrips) + [0, width), all below
    ``limit`` (the columns the kernel has there)."""
    idx = start[..., None] + torch.arange(width)
    assert int(idx.max()) < limit and int(idx.min()) >= 0
    return torch.gather(rows[:, None, :].expand(-1, idx.shape[1], -1), 2, idx)


class _Out:
    """Where a pass's rows go: the final (T, F) / (2T-1, F) output, or the
    (nsign, T, ld) scratch planes (negative sign in natural order)."""

    def __init__(self, T, F, both, scratch=None):
        self.T, self.F, self.both, self.scratch = T, F, both, scratch
        self.final = scratch is None
        if self.final:
            self.t = torch.full(((2 * T - 1) if both else T, F), float("nan"))
        else:
            self.t = scratch

    def put(self, sign, d, n, vals):
        """Rows d (J,) at natural chunks n (nstrips,), vals (J, nstrips, 4)
        in the sign's logical order."""
        v = vals.flip(-1) if sign else vals
        cols = n[:, None] + torch.arange(4)
        if self.final:
            T, F = self.T, self.F
            rows = (T - 1 if self.both else 0) + d if sign == 0 else T - 1 - d
            keep = torch.ones_like(d, dtype=torch.bool) if sign == 0 else d > 0
            ok = (cols < F)[None].expand(len(d), -1, -1) & keep[:, None, None]
            r = rows[:, None, None].expand_as(ok)
            c = cols[None].expand_as(ok)
            self.t[r[ok], c[ok]] = v[ok]
        else:
            ld = self.t.shape[-1]
            ok = (n < ld)[None, :, None].expand(len(d), -1, 4)
            r = d[:, None, None].expand_as(ok)
            c = cols[None].expand_as(ok)
            self.t[sign][r[ok], c[ok]] = v[ok]


def _tile_route(x, F, s2, grp, sign, out):
    """The shared route's kernel on rows group * R1 of x, one sign."""
    r1, wt, tw, ws = tile_geo(s2)
    X = x[grp * r1:(grp + 1) * r1]
    for t in range(-(-F // tw)):
        anchor = t * tw + (tw - 1 if sign else 0)
        nlo = anchor - ws + 1 if sign else anchor
        st = _stage(X, torch.full((r1,), nlo), ws, F)
        L = st.flip(-1) if sign else st  # logical column order
        # Phase 1: the first three stages of each 8-row group over [0, wt),
        # from the staged rows (the rounds read before they write).
        P = L.clone()
        c = torch.arange(0, wt, 4)
        G = L.view(r1 // 8, 8, ws)
        rows = _subtree([_window(G[:, m], c.expand(r1 // 8, -1), 4 + m, ws)
                         for m in range(8)])
        for e in range(8):
            P.view(r1 // 8, 8, ws)[:, e, :wt] = rows[e].reshape(r1 // 8, wt)
        # Phase 2: subtrees over rows j of the 2^s2 groups, reading P
        # (columns past wt still hold the staged band, as in the kernel).
        c = torch.arange(0, tw, 4)
        j = torch.arange(8)
        Q = P.view(1 << s2, 8, ws)
        rows = _subtree([_window(Q[m], c[None] + j[:, None] * m, 4 + m, ws)
                         for m in range(1 << s2)])
        n = anchor - c - 3 if sign else anchor + c
        for e in range(1 << s2):
            out.put(sign, grp * r1 + (j << s2) + e, n, rows[e])


def _sub_route(plane, F, S, B, sign, out):
    """The registers route (plane = x, B = 1) or a global pass over a
    scratch plane: S levels over rows j of 2^S blocks of B rows."""
    T, ld = plane.shape
    c = torch.arange(0, BW, 4)
    j = torch.arange(B)
    for tile in range(-(-ld // BW)):
        n0 = tile * BW
        anchor = n0 + BW - 1 if sign else n0
        for a in range(T // (B << S)):
            leaves = []
            for m in range(1 << S):
                k0 = (j * m) & ~3
                nlo = anchor - k0 - WSB + 1 if sign else anchor + k0
                st = _stage(plane[((a << S) + m) * B + j], nlo, WSB, F)
                L = st.flip(-1) if sign else st  # logical [k0, k0 + WSB)
                leaves.append(_window(L, c[None] + (j * m - k0)[:, None], 4 + m, WSB))
            rows = _subtree(leaves)
            n = anchor - c - 3 if sign else anchor + c
            for e in range(1 << S):
                out.put(sign, a * (B << S) + (j << S) + e, n, rows[e])


def tree_mirror(x, both):
    """csrc/taylor_tree.cu's schedule for one window, in torch."""
    T, F = x.shape
    log = T.bit_length() - 1
    nsign = 2 if both else 1
    fin = _Out(T, F, both)
    if log <= 3:
        for sign in range(nsign):
            _sub_route(x, F, log, 1, sign, fin)
        return fin.t
    if log <= 6:
        for sign in range(nsign):
            _tile_route(x, F, log - 3, 0, sign, fin)
        return fin.t
    ld = -(-F // 4) * 4
    scr = _Out(T, F, both, torch.full((nsign, T, ld), float("nan")))
    for sign in range(nsign):
        for grp in range(T // 64):
            _tile_route(x, F, 3, grp, sign, scr)
    B, left, launches = 64, log - 6, 1
    while left:
        S = min(left, 3)
        left -= S
        dst = fin if left == 0 else _Out(T, F, both,
                                         torch.full((nsign, T, ld), float("nan")))
        for sign in range(nsign):
            _sub_route(scr.t[sign], ld, S, B, sign, dst)
        B, scr, launches = B << S, dst, launches + 1
    assert launches == tpd.kernel_route(T)[1]
    return fin.t


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


def _power(T, F, seed):
    return np.random.default_rng(seed).normal(50.0, 5.0, (T, F)).astype(np.float32)


WINDOWS = [1 << k for k in range(1, 11)]


@pytest.mark.parametrize("F", [5, WIDE_F])
@pytest.mark.parametrize("T", WINDOWS)
def test_tree_mirror_bitwise_equal_to_plain(T, F):
    x = torch.from_numpy(_power(T, F, T + F))
    both = tree_mirror(x, both=True)
    assert np.array_equal(_bits(both), _bits(tpd.drift_spectra_plain(x)))
    one = tree_mirror(x, both=False)
    assert np.array_equal(_bits(one), _bits(tpd.taylor_tree_plain(x)))


@pytest.mark.parametrize("T", WINDOWS)
def test_tree_mirror_bitwise_equal_to_blit(T):
    F = 37
    if T <= 256:
        x = _power(T, F, 3 * T)
        want = bpd.drift_spectra(x, kernel="pallas", interpret=True, tile=64)
    else:
        # blit's brute force sums integer-valued power exactly, as every
        # order of f32 adds does below 2^24.
        x = np.random.default_rng(T).integers(0, 200, (T, F)).astype(np.float32)
        pos = bpd.brute_force_dedoppler(x)
        neg = bpd.brute_force_dedoppler(np.ascontiguousarray(x[:, ::-1]))[:, ::-1]
        want = np.concatenate([neg[::-1][:T - 1], pos]).astype(np.float32)
    assert np.array_equal(_bits(tree_mirror(torch.from_numpy(x), both=True)),
                          _bits(want))


def test_tree_tiles_hold_the_chunks_the_kernel_reads():
    # A leaf window is read as 16-byte chunks from its aligned start,
    # (4 + m + 3) / 4 of them when the start is aligned, (4 + m + 6) / 4
    # when not: the last chunk stays inside the staged row.  (That the
    # windows' values come from the columns phase 1 computed, the bitwise
    # tests show.)  Three shared-route tiles fit an SM.
    for s2 in (1, 2, 3):
        r1, wt, tw, ws = tile_geo(s2)
        assert tw % 4 == 0 and wt % (4 * (NT // (r1 // 8))) == 0
        assert (wt - 4) + 4 * ((4 + 7 + 3) // 4) <= ws  # phase 1
        m = (1 << s2) - 1
        k0 = (tw - 4 + 7 * m) & ~3
        assert k0 + 4 * ((4 + m + 6) // 4) <= ws  # phase 2
        assert 3 * r1 * ws * 4 <= 227 * 1024  # three blocks an SM
    assert (BW - 4) + 4 * ((4 + 7 + 6) // 4) <= WSB  # registers route, passes


# -- the beamform -----------------------------------------------------------
# csrc/beamform_detect.cu's geometry: beams and samples a block; per element
# size: antennas a stage, stage slots, blocks an SM.
BB, NB = tbf.BEAMS_PER_BLOCK, tbf.MAX_NINT
KA, NSLOT, MINB = {4: 32, 2: 64}, {4: 4, 2: 2}, {4: 1, 2: 2}

# The epilogue's lanes: warps (wm, wn), lanes (g, q), m16 tiles mt, n8
# tiles nt → beam in the tile and first sample of the lane's pair (samples
# 2q, 2q+1 of the n8 tile); nint 8..32 store from the lanes q = 0 of
# (wm, wn, mt, g), 32 / nint consecutive outputs from sample 32 wn.
_wm, _wn, _mt, _g, _nt, _q = np.meshgrid(*(np.arange(n) for n in (2, 4, 4, 8, 4, 4)),
                                         indexing="ij")
LANE_BEAM = (32 * _wm + 8 * _mt + _g).ravel()
LANE_T = (32 * _wn + 8 * _nt + 2 * _q).ravel()
LANE_Q = _q.ravel()
Q0 = (_nt == 0).ravel() & (LANE_Q == 0)


def beam_schedule(nchan, nant, nbeam, npol, ntime, nint, esize, nsm):
    """The kernel's stores as counts over (chan, beam, pol, output), and
    each block's weight loads [(block, (chan, beam tile, chunk))]."""
    nbt, ntt = -(-nbeam // BB), -(-ntime // NB)
    nck, nslot = -(-nant // KA[esize]), NSLOT[esize]
    items = nchan * nbt * npol * ntt
    grid = min(items, MINB[esize] * nsm)
    count = np.zeros((nchan, nbeam, npol, ntime // nint), np.int64)
    loads = []
    for blk in range(grid):
        i0, i1 = items * blk // grid, items * (blk + 1) // grid
        tag = [None] * nslot
        for s in range((i1 - i0) * nck):
            i, ka = i0 + s // nck, s % nck
            tt, r = i % ntt, i // ntt
            p, r = r % npol, r // npol
            bt, c = r % nbt, r // nbt
            if tag[s % nslot] != (c, bt, ka):
                loads.append((blk, (c, bt, ka)))
                tag[s % nslot] = (c, bt, ka)
            if ka != nck - 1:
                continue
            if nint <= 4:
                b, t = bt * BB + LANE_BEAM, tt * NB + LANE_T
                if nint == 1:  # both samples of the pair
                    b, t = np.concatenate([b, b]), np.concatenate([t, t + 1])
                elif nint == 4:  # the even lanes after one shuffle
                    b, t = b[LANE_Q % 2 == 0], t[LANE_Q % 2 == 0]
            elif nint <= 32:  # lanes q = 0, from the registers
                k = np.arange(32 // nint)
                b = np.repeat(bt * BB + LANE_BEAM[Q0], len(k))
                t = (tt * NB + LANE_T[Q0])[:, None] + k[None] * nint
                t = t.ravel()
            else:  # the 8-sample sums of a group, thread by thread
                bl, ol = np.divmod(np.arange(BB * (NB // nint)), NB // nint)
                b, t = bt * BB + bl, tt * NB + ol * nint
            ok = (b < nbeam) & (t < ntime)
            np.add.at(count, (c, b[ok], p, t[ok] // nint), 1)
    return count, loads


@pytest.mark.parametrize("nchan,nant,nbeam,npol,ntime", [
    (3, 64, 64, 2, 1024), (2, 17, 65, 2, 136), (1, 5, 3, 1, 256),
    (2, 130, 130, 2, 384), (1, 1, 1, 1, 8)], ids=str)
@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("nsm", [132, 3])
def test_beamform_schedule_writes_every_output_once(nchan, nant, nbeam, npol,
                                                    ntime, esize, nsm):
    nck = -(-nant // KA[esize])
    for nint in [1 << k for k in range(8)]:
        if ntime % nint:
            continue
        count, loads = beam_schedule(nchan, nant, nbeam, npol, ntime, nint,
                                     esize, nsm)
        assert (count == 1).all(), nint
        # When the slots cycle with the antenna chunks, a slot's weight
        # tile changes only with the (channel, beam tile): a block loads
        # its weights once per slot and (channel, beam tile), however many
        # time tiles it walks.
        if NSLOT[esize] % nck == 0:
            for blk in {x[0] for x in loads}:
                mine = [w for x, w in loads if x == blk]
                assert len(mine) <= NSLOT[esize] * len({w[:2] for w in mine})


def _tf32_hi(x):
    """cvt.rna.tf32.f32: round to 10 fraction bits, ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x):
    hi = _tf32_hi(x)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def beamform_tf32(vr, vi, wr, wi, nint, passes=3):
    """The f32 kernel's arithmetic: per channel [Br; Bi] = [Wr, -Wi; Wi, Wr]
    [Vr; Vi] in 8-antenna steps; each step's MMAs in the kernel's order,
    [Wr; Wi] Vr as xl yh, xh yl, xh yh (xh yh alone with passes=1), then
    [-Wi; Wr] Vi the same way, each an exact 8-term sum added to the f32
    sums with one rounding; |B|^2; the lane pair, the shuffle tree to 8
    samples, then the 8-sample sums of a group in order.  (The kernel skips
    xh yl where a warp's voltages have no low part: those products are
    exact zeros, which this sum adds.)"""
    nchan, nant, npol, ntime = vr.shape
    pad = -nant % 8
    vr, vi, wr, wi = (torch.nn.functional.pad(t, p) for t, p in (
        (vr, (0, 0, 0, 0, 0, pad)), (vi, (0, 0, 0, 0, 0, pad)),
        (wr, (0, pad)), (wi, (0, pad))))
    V = [_tf32_split(vr), _tf32_split(vi)]  # (hi, lo) of each plane
    W = [_tf32_split(wr), _tf32_split(wi)]
    br = torch.zeros((nchan, wr.shape[1], npol, ntime))
    bi = torch.zeros_like(br)
    order = [(1, 0), (0, 1), (0, 0)] if passes == 3 else [(0, 0)]  # (w, v): 0 hi, 1 lo
    for k in range((nant + pad) // 8):
        s = slice(8 * k, 8 * k + 8)

        def dot(w, v):
            return torch.einsum("cba,capt->cbpt", w[..., s].double(), v[:, s].double())

        for half in (0, 1):  # Vr with [Wr; Wi], then Vi with [-Wi; Wr]
            for wp, vp in order:
                v = V[half][vp]
                r = dot(W[0][wp], v) if half == 0 else -dot(W[1][wp], v)
                i = dot(W[1][wp], v) if half == 0 else dot(W[0][wp], v)
                br = (br.double() + r).float()
                bi = (bi.double() + i).float()
    p = br * br + bi * bi
    if nint == 1:
        return p
    s = p[..., 0::2] + p[..., 1::2]  # a lane's two samples
    for n in (4, 8):  # the shuffles over the lanes of an n8 tile
        if nint >= n:
            s = s[..., 0::2] + s[..., 1::2]
    if nint <= 8:
        return s
    groups = s.reshape(*s.shape[:3], -1, nint // 8)
    acc = groups[..., 0].clone()
    for k in range(1, nint // 8):  # the 8-sample sums of a group, in order
        acc += groups[..., k]
    return acc


def _within_f32_bound(got, want):
    peak, med = want.abs().max().item(), want.median().item()
    err = (got - want).abs()
    return (bool((err <= 1e-3 * peak + 1e-4 * want.abs()).all()),
            bool((err <= 1e-3 * med + 1e-4 * want.abs()).all()))


@pytest.mark.parametrize("nint,tile", [(1, 32), (4, 64), (8, 128), (32, 128),
                                       (128, 128)])
def test_beamform_tf32_passes_hold_the_f32_bound(nint, tile):
    rng = np.random.default_rng(nint)
    nchan, nant, nbeam, npol, ntime = 2, 20, 9, 2, 256
    vr, vi = rng.standard_normal((2, nchan, nant, npol, ntime)).astype(np.float32)
    wr, wi = rng.standard_normal((2, nchan, nbeam, nant)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (vr, vi, wr, wi)]
    got = beamform_tf32(*args, nint=nint)
    plain = tbf.fused_beamform_detect_plain(*args, nint=nint)
    blit = torch.from_numpy(np.array(RPB.fused_beamform_detect(
        *(jnp.asarray(a) for a in (vr, vi, wr, wi)), nint=nint, tile=tile,
        interpret=True)))
    assert got.shape == plain.shape == blit.shape
    for want in (plain, blit):
        assert _within_f32_bound(got, want) == (True, True)
    one = beamform_tf32(*args, nint=nint, passes=1)
    assert (one - plain).abs().max() > 100 * (got - plain).abs().max()
    if nint <= 4:
        assert _within_f32_bound(one, plain) != (True, True)


def test_tf32_split_is_exact_to_2_21():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _tf32_split(x)
    for t in (hi, lo):  # tf32 values: the 13 low fraction bits are zero
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert rel < 2.0 ** -21
    assert math.isclose(float(_tf32_hi(torch.tensor([1.0 + 2.0 ** -11]))),
                        1.0 + 2.0 ** -10)  # a tie rounds away from zero
