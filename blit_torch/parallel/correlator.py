"""FX correlator, on one card or over the ``(band, bank)`` mesh.

Counterpart of ``blit/parallel/correlator.py``.  With ``mesh=``, coarse
channels split over ``bank`` and time over ``band``
(:func:`correlator_sharding`): each band row F-engines its own time
segment (the PFB does not run across segment boundaries, so the golden
is ``correlate_np(nsegments=nband)``), and the visibilities are summed
over ``band`` by one ``psum``, the correlator's only collective.
``device=`` is the one-card form: one band segment, every psum the
identity.

- F-engine (:func:`f_engine_planar`): the polyphase FIR on each plane
  with the fftshift folded into the window's sign, then the planar DFT
  (:func:`blit_torch.ops.channelize.fft_planar`: the ``dft_last`` kernel
  on the card at n <= 4096).
- X-engine: ``vis_layout="packed"`` → ``(nchan, nfft, nant, npol, nant,
  npol)`` through the Hopper kernel
  (:func:`blit_torch.ops.xengine.xengine_packed`) where its gate admits
  the shape (``nap >= 128``); ``"standard"`` → ``(nant, nant, nchan,
  nfft, npol, npol)``, and packed shapes the gate refuses, through the
  matmul route: a batched complex ``torch.matmul`` of the packed spectra
  with their conjugate transpose.

Voltages ``(nant, nchan, ntime, npol)`` come as a planar pair or one
complex tensor; bf16 planes run the F-engine in bf16 and stage the
spectra in bf16, visibilities are f32 either way.  The result is a
planar f32 pair, or complex64 when the input was complex.
:func:`last_xengine_plan` says which X-engine the last call took.
The stream folds each player's windows into an on-device accumulator
that carries its partition rule
(:class:`~blit_torch.parallel.mesh.ShardedAccumulator`) and runs the
band psum once, at the end, in :func:`correlate`'s fold order, so stream
and one-shot (``acc_frames=window_frames``) agree bitwise.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from blit_torch.device import resolve_device
from blit_torch.observability import Timeline
from blit_torch.ops import xengine as xe
from blit_torch.ops.channelize import fft_planar, pfb_frontend
from blit_torch.ops.dft import ComplexOrPlanar, Planar, as_planar
from blit_torch.outplane import FoldInFlight, record_event

# X-engine of the most recent call (read via last_xengine_plan()).
_LAST_PLAN: dict = {}


def last_xengine_plan() -> dict:
    """The X-engine the most recent correlation took: ``layout``
    (``"standard"`` or ``"packed"``); ``engine`` (``"cuda"``: the Hopper
    kernel; ``"plain"``: the kernel route on the CPU, its plain version;
    ``"matmul"``: the matmul route); ``impl`` (``"cuda"`` or ``"plain"``,
    the device the call ran on)."""
    return dict(_LAST_PLAN)


def f_engine_planar(vr: torch.Tensor, vi: torch.Tensor,
                    coeffs: torch.Tensor) -> Planar:
    """Fine-channelize complex voltages held as planes: ``(..., ntime)``
    → fftshifted spectra ``(..., nframes, nfft)``, f32.  The fftshift is
    the window's sign flip (shift theorem); ``±1`` is exact in every
    dtype, so bf16 ``coeffs`` keep the FIR in bf16."""
    ntap, nfft = coeffs.shape
    if nfft % 2:
        raise ValueError("f_engine_planar: nfft must be even")
    sign = torch.ones(nfft, dtype=coeffs.dtype, device=coeffs.device)
    sign[1::2] = -1
    shifted = coeffs * sign[None, :]
    return fft_planar(pfb_frontend(vr, shifted), pfb_frontend(vi, shifted))


def f_engine(v: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Complex64 form of :func:`f_engine_planar`."""
    return torch.complex(*f_engine_planar(v.real, v.imag, coeffs))


def _fx_spectra(vr: torch.Tensor, vi: torch.Tensor, h: torch.Tensor) -> Planar:
    """Voltages ``(nant, nchan, ntime, npol)`` → fftshifted spectra
    ``(nant, nchan, npol, nframes, nfft)``, staged in bf16 when the
    voltages are bf16 (the window rounded to bf16 first)."""
    bf16 = vr.dtype == torch.bfloat16
    if bf16:
        h = h.to(torch.bfloat16)
    sr, si = f_engine_planar(vr.movedim(3, 2), vi.movedim(3, 2), h)
    if bf16:
        sr, si = sr.to(torch.bfloat16), si.to(torch.bfloat16)
    return sr, si


def _xengine_matmul(sr: torch.Tensor, si: torch.Tensor) -> Planar:
    """The matmul route: packed ``(nchan, nfft, nap, nap)`` visibilities
    from one batched complex64 product ``X · Xᴴ`` over frames, ``X`` the
    spectra packed ``(nchan, nfft, nap, nframes)``."""
    nant, nchan, npol, nframes, nfft = sr.shape
    x = torch.complex(sr.to(torch.float32), si.to(torch.float32))
    x = x.permute(1, 4, 0, 2, 3).reshape(nchan, nfft, nant * npol, nframes)
    v = torch.matmul(x, x.transpose(-1, -2).conj())
    return v.real.contiguous(), v.imag.contiguous()


def _fx_xengine(sr: torch.Tensor, si: torch.Tensor, vis_layout: str) -> Planar:
    """X-engine dispatch by output layout; records the plan."""
    nant, nchan, npol, _, nfft = sr.shape
    cuda = sr.device.type == "cuda"
    if vis_layout == "packed" and xe.eligible(nant * npol, nchan, nfft,
                                              sr.element_size()):
        engine = "cuda" if cuda else "plain"
        vr, vi = xe.xengine_packed(sr, si)
    else:
        engine = "matmul"
        vr, vi = _xengine_matmul(sr, si)
    _LAST_PLAN.clear()
    _LAST_PLAN.update(layout=vis_layout, engine=engine,
                      impl="cuda" if cuda else "plain")
    shape6 = (nchan, nfft, nant, npol, nant, npol)
    vr, vi = vr.reshape(shape6), vi.reshape(shape6)
    if vis_layout == "packed":
        return vr, vi
    return (vr.permute(2, 4, 0, 1, 3, 5).contiguous(),
            vi.permute(2, 4, 0, 1, 3, 5).contiguous())


def _check(vis_layout: str, h: torch.Tensor, nfft: int, ntap: int) -> None:
    if vis_layout not in ("standard", "packed"):
        raise ValueError(f"bad vis_layout {vis_layout!r}")
    if tuple(h.shape) != (ntap, nfft):
        raise ValueError(f"coeffs shape {tuple(h.shape)} != (ntap={ntap}, "
                         f"nfft={nfft})")


def correlator_sharding(mesh):
    """Voltages ``(nant, nchan, ntime, npol)``: channels over ``bank``,
    time over ``band``."""
    from blit_torch.parallel import mesh as M

    return M.NamedSharding(mesh, M.P(None, M.BANK_AXIS, M.BAND_AXIS))


def visibility_sharding(mesh):
    """Visibilities ``(nant, nant, nchan, nfft, npol, npol)``: channels
    over ``bank``, whole over ``band``."""
    from blit_torch.parallel import mesh as M

    return M.NamedSharding(mesh, M.P(None, None, M.BANK_AXIS))


def _acc_rule(vis_layout: str) -> str:
    """The stream accumulator's partition rule."""
    return "vis_acc_packed" if vis_layout == "packed" else "vis_acc_standard"


def _fold_frames(sr, si, vis_layout: str, acc_frames: Optional[int]) -> Planar:
    """One player's visibilities over its frames: one contraction, or
    ``acc_frames`` frames a tile folded in time order (the first tile not
    added to zeros), the stream's accumulation."""
    nframes = sr.shape[3]
    if acc_frames is None or acc_frames >= nframes:
        return _fx_xengine(sr, si, vis_layout)
    visr = visi = None
    for t0 in range(0, nframes, acc_frames):
        pr, pi = _fx_xengine(sr[..., t0:t0 + acc_frames, :],
                             si[..., t0:t0 + acc_frames, :], vis_layout)
        if visr is None:
            visr, visi = pr, pi
        else:
            visr.add_(pr)
            visi.add_(pi)
    return visr, visi


def _mesh_planes(voltages, mesh):
    from blit_torch.parallel import mesh as M

    if isinstance(voltages, tuple) and isinstance(voltages[0], M.MeshArray):
        return voltages[0], voltages[1], False
    vr, vi, cplx = as_planar(voltages)
    sh = correlator_sharding(mesh)
    return M.device_put(vr, sh), M.device_put(vi, sh), cplx


def _band_psum(mesh, partials, vis_layout: str, timeline=None) -> Planar:
    """The band psum of every player's partial visibilities, then the
    banks' channel blocks side by side: whole visibilities on this
    process's first player's device."""
    from blit_torch.parallel import mesh as M

    cols = M.psum_groups(mesh, partials, M.BAND_AXIS, timeline)
    dev = mesh.devices[mesh.local_players()[0]]
    dim = 0 if vis_layout == "packed" else 2
    nbank = mesh.shape[M.BANK_AXIS]
    visr = torch.cat([cols[k][0].to(dev) for k in range(nbank)], dim=dim)
    visi = torch.cat([cols[k][1].to(dev) for k in range(nbank)], dim=dim)
    return visr, visi


def correlate(voltages: ComplexOrPlanar, coeffs, *, nfft: int, ntap: int = 4,
              vis_layout: str = "standard", acc_frames: Optional[int] = None,
              device=None, mesh=None):
    """Full FX correlation of ``(nant, nchan, ntime, npol)`` voltages
    (``ntime`` a multiple of ``nfft`` with at least ``ntap`` blocks) with
    the ``(ntap, nfft)`` PFB prototype ``coeffs``.

    Returns visibilities integrated over all frames: standard ``(nant,
    nant, nchan, nfft, npol, npol)`` or packed ``(nchan, nfft, nant, npol,
    nant, npol)``, entry ``⟨S_a S_b*⟩``.  ``acc_frames`` folds the frame
    contraction tile by tile (``acc_frames`` frames a tile, in time order,
    the first tile not added to zeros): the accumulation of
    :func:`correlate_stream` with ``window_frames=acc_frames``, which it
    then equals bitwise.  ``device``: where to compute (``None``: CUDA).
    ``mesh``: the mesh form (module docstring); voltages are tensors,
    split here by :func:`correlator_sharding`, or mesh arrays already
    split so; each band row's ``ntime`` segment must hold at least
    ``ntap`` blocks.  The result is whole on every process.
    """
    if acc_frames is not None and acc_frames < 1:
        raise ValueError(f"acc_frames must be >= 1, got {acc_frames}")
    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh= or device=, not both")
        vr, vi, was_complex = _mesh_planes(voltages, mesh)
        _check(vis_layout, torch.as_tensor(coeffs), nfft, ntap)
        partials = {}
        hs: dict = {}
        for p in sorted(vr.shards):
            d = mesh.devices[p]
            if d not in hs:
                hs[d] = torch.as_tensor(coeffs).to(d)
            sr, si = _fx_spectra(vr.shards[p], vi.shards[p], hs[d])
            partials[p] = _fold_frames(sr, si, vis_layout, acc_frames)
        visr, visi = _band_psum(mesh, partials, vis_layout)
    else:
        dev = resolve_device(device)
        h = torch.as_tensor(coeffs).to(dev)
        _check(vis_layout, h, nfft, ntap)
        vr, vi, was_complex = as_planar(voltages)
        sr, si = _fx_spectra(vr.to(dev), vi.to(dev), h)
        visr, visi = _fold_frames(sr, si, vis_layout, acc_frames)
    if was_complex:
        return torch.complex(visr, visi)
    return visr, visi


def correlate_stream(feed: Iterable, coeffs, *, nfft: int, ntap: int = 4,
                     vis_layout: str = "standard",
                     timeline: Optional[Timeline] = None,
                     device=None, mesh=None) -> Planar:
    """Full FX correlation over a windowed feed
    (:class:`blit_torch.parallel.antenna.CorrelatorStream`): each
    window's visibilities fold into an on-device accumulator (the first
    window's are the accumulator).  Equal bitwise to ``correlate(...,
    acc_frames=window_frames)`` on the same span.  Returns the planar f32
    pair in :func:`correlate`'s layouts, complete.  Window ``w-1``'s fold
    is waited on (stage ``device``; :class:`~blit_torch.outplane.FoldInFlight`)
    and its slot released only before window ``w``'s dispatch, so the
    feed reads and copies the next window while the card folds this one.
    Stage ``dispatch``: the F-engine, X-engine and fold launches.

    With ``mesh`` (a mesh feed's windows) each player folds its own
    partials into a :class:`~blit_torch.parallel.mesh.ShardedAccumulator`
    (``"vis_acc_standard"`` / ``"vis_acc_packed"``: a band block a row,
    channels over ``bank``), and the band psum runs once, at the end,
    timed (``mesh.psum_s``) where the mesh has more than one band row."""
    tl = timeline if timeline is not None else Timeline()
    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh= or device=, not both")
        return _correlate_stream_mesh(feed, coeffs, nfft=nfft, ntap=ntap,
                                      vis_layout=vis_layout, tl=tl, mesh=mesh)
    dev = resolve_device(device)
    h = torch.as_tensor(coeffs).to(dev)
    _check(vis_layout, h, nfft, ntap)
    flight = FoldInFlight(tl, depth=1)
    accr = acci = None
    for win in feed:
        if getattr(win, "masked", ()):
            tl.count("masked_antennas", len(win.masked))
        vr, vi = win.arrays
        flight.make_room()
        with tl.stage("dispatch", byte_free=True):
            pr, pi = _fx_xengine(*_fx_spectra(vr.to(dev), vi.to(dev), h),
                                 vis_layout)
            if accr is None:
                accr, acci = pr, pi
            else:
                accr.add_(pr)
                acci.add_(pi)
        flight.admit(win, record_event(acci))
    flight.drain()
    if accr is None:
        raise ValueError("correlate_stream: feed yielded no windows")
    return accr, acci


def _correlate_stream_mesh(feed, coeffs, *, nfft, ntap, vis_layout, tl,
                           mesh) -> Planar:
    import time

    from blit_torch.parallel import mesh as M

    _check(vis_layout, torch.as_tensor(coeffs), nfft, ntap)
    rule = _acc_rule(vis_layout)
    acc = M.ShardedAccumulator(mesh, rule)
    hs: dict = {}

    def partials(win):
        vr, vi = _mesh_planes(win.arrays, mesh)[:2]
        out = {}
        for p in sorted(vr.shards):
            d = mesh.devices[p]
            if d not in hs:
                hs[d] = torch.as_tensor(coeffs).to(d)
            out[p] = _fx_xengine(*_fx_spectra(vr.shards[p], vi.shards[p],
                                              hs[d]), vis_layout)
        return out

    def as_acc(parts):
        first = next(iter(parts.values()))[0]
        shape = (mesh.shape[M.BAND_AXIS],) + tuple(first.shape)
        if vis_layout == "packed":
            shape = shape[:1] + (shape[1] * mesh.shape[M.BANK_AXIS],) + shape[2:]
        else:
            shape = shape[:3] + (shape[3] * mesh.shape[M.BANK_AXIS],) + shape[4:]
        return tuple(M.MeshArray(mesh, rule, shape,
                                 {p: v[c][None] for p, v in parts.items()})
                     for c in range(2))

    def add(value, parts):
        for c in range(2):
            for p, t in value[c].shards.items():
                t.add_(parts[p][c][None])
        return value

    flight = FoldInFlight(tl, depth=1)
    for win in feed:
        if getattr(win, "masked", ()):
            tl.count("masked_antennas", len(win.masked))
        flight.make_room()
        with tl.stage("dispatch", byte_free=True):
            parts = partials(win)
            if acc.value is None:
                acc.init(as_acc(parts))
            else:
                acc.fold(add, parts)
        flight.admit(win, record_event(next(iter(acc.value[1].shards.values()))))
    if acc.value is None:
        raise ValueError("correlate_stream: feed yielded no windows")
    flight.drain()
    nband = mesh.shape[M.BAND_AXIS]
    final = {p: (acc.value[0].shards[p][0], acc.value[1].shards[p][0])
             for p in acc.value[0].shards}
    with tl.stage("device", byte_free=True):
        acc.value[0].synchronize()
        t0 = time.perf_counter()
        visr, visi = _band_psum(mesh, final, vis_layout, tl)
        if visr.device.type == "cuda":
            torch.cuda.synchronize(visr.device)
        psum_s = time.perf_counter() - t0
    if nband > 1:
        per_player = sum(a.nbytes for a in acc.value) // mesh.size
        M.record_ici(tl, "psum", M.psum_ici_bytes(per_player, nband), psum_s)
    return visr, visi
