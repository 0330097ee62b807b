"""Coherent multibeam (tied-array) beamforming, on one card or over the
``(band, bank)`` mesh.

Counterpart of ``blit/parallel/beamform.py``.  With ``mesh=`` the
antenna axis is split over ``axis`` (default ``bank``,
:func:`antenna_sharding`): each player forms the partial beams of its own
antennas and one ``psum`` over ``axis`` completes the tied-array sum (the
only communication: partial beams travel, never voltages); detection
follows.  ``blit``'s gate holds: the fused beamform + detect kernel runs
only where every antenna is on one player (``mesh.shape[axis] == 1``),
since the power of a sum is not the sum of powers.  ``device=`` is the
one-card form, where every antenna is local and the gate always holds.

Complex values travel planar, as ``(re, im)`` pairs; the entry points
take a pair or one complex tensor, and the output dtype follows the
input as in ``blit``.  Two layouts:

- ``"antenna"``: voltages ``(nant, nchan, ntime, npol)``, weights
  ``(nbeam, nant, nchan)``: ``blit``'s einsum route, here the four real
  products as ``torch.einsum`` (batched matmuls) in the voltages' dtype;
- ``"chan"``: packed voltages ``(nchan, nant, npol, ntime)`` and weights
  ``(nchan, nbeam, nant)``.  With ``detect=True``, every antenna local
  and a shape the Hopper gate (:func:`blit_torch.ops.beamform.fits`)
  admits, the fused beamform + detect + integrate kernel (beams never
  reach device memory); otherwise the same matmul route as above.

bf16 voltages round the weights to bf16 first, as ``blit`` does.
:func:`last_beamform_plan` says which route the last call took.
:func:`beamform_stream` and :func:`beamform_accumulate` run over a
windowed feed on the asynchronous plane (:mod:`blit_torch.outplane`):
the stream reads each window's power back on an
:class:`~blit_torch.outplane.OutputRotation` thread while the next window
is dispatched, the accumulation waits on window ``w-1``'s fold only
before dispatching window ``w`` (:class:`~blit_torch.outplane.FoldInFlight`),
and both release a window's feed slot once the compute that read it has
completed.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Optional, Tuple

import torch

from blit_torch.device import resolve_device
from blit_torch.observability import Timeline
from blit_torch.ops import beamform as beam_ops
from blit_torch.ops.channelize import integrate
from blit_torch.ops.dft import ComplexOrPlanar, Planar, as_planar
from blit_torch.outplane import FoldInFlight, OutputRotation, record_event

ANT_AXIS_DEFAULT = "bank"

# Route of the most recent beamform call (read via last_beamform_plan()).
_LAST_PLAN: dict = {}


def last_beamform_plan() -> dict:
    """The route the most recent :func:`beamform` call took: ``layout``;
    ``fused`` (True: the fused beamform + detect kernel route, False: the
    matmul route); ``impl`` (``"cuda"`` on the card, where the fused route
    is the Hopper kernel, or ``"plain"`` on the CPU, where it is the
    kernel's plain version)."""
    return dict(_LAST_PLAN)


def delay_weights_planar(delays_s, freqs_hz, amplitudes=None, *,
                         device=None) -> Planar:
    """Per-(beam, antenna, channel) phasors from geometric delays, planar:
    ``delays_s`` ``(nbeam, nant)`` seconds, ``freqs_hz`` ``(nchan,)`` →
    f32 ``(wr, wi)`` ``(nbeam, nant, nchan)`` = cos/sin of ``-2π f τ``,
    the phase formed in f32 as ``blit`` forms it (inputs cast to f32
    first).  Optionally scaled by ``amplitudes`` ``(nbeam, nant)`` or
    ``(nant,)``."""
    dev = resolve_device(device)
    d = torch.as_tensor(delays_s, dtype=torch.float32, device=dev)
    f = torch.as_tensor(freqs_hz, dtype=torch.float32, device=dev)
    phase = -2.0 * math.pi * d[..., None] * f[None, None, :]
    wr, wi = torch.cos(phase), torch.sin(phase)
    if amplitudes is not None:
        amp = torch.as_tensor(amplitudes, dtype=torch.float32, device=dev)
        if amp.ndim == 1:
            amp = amp[None, :]
        wr = wr * amp[..., None]
        wi = wi * amp[..., None]
    return wr, wi


def delay_weights(delays_s, freqs_hz, amplitudes=None, *,
                  device=None) -> torch.Tensor:
    """Complex64 form of :func:`delay_weights_planar`: ``exp(-2πi f τ)``
    shaped ``(nbeam, nant, nchan)``."""
    return torch.complex(*delay_weights_planar(delays_s, freqs_hz, amplitudes,
                                               device=device))


def _beams(eq: str, vr, vi, wr, wi) -> Planar:
    """The complex contraction over antennas as four real einsums."""
    rr = torch.einsum(eq, wr, vr)
    ii = torch.einsum(eq, wi, vi)
    br = rr - ii
    del rr, ii
    ri = torch.einsum(eq, wr, vi)
    ir = torch.einsum(eq, wi, vr)
    return br, ri + ir


def _geometry(layout: str, vr, wr, nint: int, detect: bool) -> Tuple:
    """``(nchan, nant, npol, ntime, nbeam, equation)`` of a call (whole
    shapes), refusing an ``nint`` that does not divide the time axis."""
    if layout == "chan":
        nchan, nant, npol, ntime = vr.shape
        nbeam = wr.shape[1]
        eq = "cba,capt->cbpt"
    else:
        nant, nchan, ntime, npol = vr.shape
        nbeam = wr.shape[0]
        eq = "bac,actp->bctp"
    if nint < 1 or (detect and ntime % nint):
        raise ValueError(f"integrate: nint={nint} does not divide ntime={ntime}")
    return nchan, nant, npol, ntime, nbeam, eq


def _fits(geom: Tuple, layout: str, detect: bool, nint: int,
          itemsize: int) -> bool:
    """Whether the fused kernel's layout, mode and Hopper gate admit the
    call (every antenna local is the caller's half of the gate)."""
    nchan, nant, npol, ntime, nbeam, _ = geom
    return (layout == "chan" and detect
            and beam_ops.fits(nant, nbeam, npol, ntime, nint, itemsize, nchan))


def _note_plan(layout: str, fuse: bool, dev, **extra) -> None:
    _LAST_PLAN.clear()
    _LAST_PLAN.update(layout=layout, fused=fuse,
                      impl="cuda" if dev.type == "cuda" else "plain", **extra)


def _fused(vr, vi, wr, wi, nint: int) -> torch.Tensor:
    """The fused beamform + detect + integrate kernel; bf16 voltages
    take bf16-rounded weights."""
    return beam_ops.fused_beamform_detect(
        vr.contiguous(), vi.contiguous(), wr.to(vr.dtype).contiguous(),
        wi.to(vr.dtype).contiguous(), nint=nint)


def _finish(br, bi, geom: Tuple, *, layout: str, nint: int, detect: bool,
            complex_out: bool):
    """Whole beams → the caller's product: the beams themselves, or their
    power detected in f32 and integrated over ``nint``."""
    if not detect:
        return torch.complex(br, bi) if complex_out else (br, bi)
    nchan, _, npol, ntime, nbeam, _ = geom
    br, bi = br.to(torch.float32), bi.to(torch.float32)
    power = br * br + bi * bi
    if layout == "antenna":
        return integrate(power, nint)
    # (c, b, p, t): time is last, integrate() sums axis -2.
    return power.reshape(nchan, nbeam, npol, ntime // nint, nint).sum(-1)


def beamform(voltages: ComplexOrPlanar, weights: ComplexOrPlanar, *,
             nint: int = 1, detect: bool = True, layout: str = "antenna",
             device=None, mesh=None, axis: str = ANT_AXIS_DEFAULT):
    """Form tied-array beams (module docstring for the layouts).

    ``detect=True`` → per-beam power integrated over ``nint`` samples,
    f32: ``(nbeam, nchan, ntime // nint, npol)`` (antenna layout) or
    ``(nchan, nbeam, npol, ntime // nint)`` (chan layout).
    ``detect=False`` → beam voltages ``(nbeam, nchan, ntime, npol)`` /
    ``(nchan, nbeam, npol, ntime)`` in the voltages' dtype: one complex64
    tensor when both inputs were complex, else a planar pair.
    ``device``: where to compute (``None``: the CUDA device); inputs
    elsewhere are copied there.  ``mesh`` / ``axis``: the mesh form
    (module docstring); voltages and weights are tensors, split here by
    :func:`antenna_sharding` / :func:`weight_sharding`, or mesh arrays
    already split so.  The result is whole, on the device of this
    process's first player.
    """
    if layout not in ("antenna", "chan"):
        raise ValueError(f"bad layout {layout!r}")
    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh= or device=, not both")
        return _beamform_mesh(voltages, weights, mesh=mesh, axis=axis,
                              nint=nint, detect=detect, layout=layout)
    dev = resolve_device(device)
    vr, vi, v_cplx = as_planar(voltages)
    wr, wi, w_cplx = as_planar(weights)
    vr, vi = vr.to(dev), vi.to(dev)
    # bf16 voltages take bf16-rounded weights; f32 ones f32 weights.
    wr, wi = wr.to(dev, vr.dtype), wi.to(dev, vr.dtype)
    geom = _geometry(layout, vr, wr, nint, detect)
    fuse = _fits(geom, layout, detect, nint, vr.element_size())
    _note_plan(layout, fuse, dev)
    if fuse:
        return _fused(vr, vi, wr, wi, nint)
    br, bi = _beams(geom[-1], vr, vi, wr, wi)
    return _finish(br, bi, geom, layout=layout, nint=nint, detect=detect,
                   complex_out=v_cplx and w_cplx)


def _planes(x, sharding) -> Tuple:
    """``(re, im, was_complex)`` as mesh arrays split by ``sharding``."""
    from blit_torch.parallel import mesh as M

    if isinstance(x, tuple) and isinstance(x[0], M.MeshArray):
        return x[0], x[1], False
    r, i, cplx = as_planar(x)
    return M.device_put(r, sharding), M.device_put(i, sharding), cplx


def _beamform_mesh(voltages, weights, *, mesh, axis: str, nint: int,
                   detect: bool, layout: str):
    """Each local player's partial beams over its antennas, the psum over
    ``axis``, then detection; the fused kernel where ``mesh.shape[axis]
    == 1`` (every antenna on each player)."""
    from blit_torch.parallel import mesh as M

    vr, vi, v_cplx = _planes(voltages, antenna_sharding(mesh, axis, layout))
    wr, wi, w_cplx = _planes(weights, weight_sharding(mesh, axis, layout))
    geom = _geometry(layout, vr, wr, nint, detect)
    local = sorted(vr.shards)
    dev = mesh.devices[local[0]]
    fuse = (mesh.shape[axis] == 1
            and _fits(geom, layout, detect, nint,
                      vr.shards[local[0]].element_size()))
    _note_plan(layout, fuse, dev, mesh_axis_size=mesh.shape[axis])
    if fuse:
        # Every player holds every antenna and the product is replicated:
        # this process's first player computes it.
        p = local[0]
        return _fused(vr.shards[p], vi.shards[p], wr.shards[p], wi.shards[p],
                      nint)
    partials = {}
    for p in local:
        xr, xi = vr.shards[p], vi.shards[p]
        partials[p] = _beams(geom[-1], xr, xi, wr.shards[p].to(xr.dtype),
                             wi.shards[p].to(xr.dtype))
    groups = M.psum_groups(mesh, partials, axis)
    br, bi = groups[min(groups)]
    return _finish(br.to(dev), bi.to(dev), geom, layout=layout, nint=nint,
                   detect=detect, complex_out=v_cplx and w_cplx)


def antenna_sharding(mesh, axis: str = ANT_AXIS_DEFAULT, layout: str = "antenna"):
    """Voltages ``(nant, nchan, ntime, npol)`` (or packed ``(nchan, nant,
    npol, ntime)``): antennas over ``axis``, everything else whole."""
    from blit_torch.parallel import mesh as M

    spec = M.P(None, axis) if layout == "chan" else M.P(axis)
    return M.NamedSharding(mesh, spec)


def weight_sharding(mesh, axis: str = ANT_AXIS_DEFAULT, layout: str = "antenna"):
    """Weights ``(nbeam, nant, nchan)`` (or packed ``(nchan, nbeam,
    nant)``), split like :func:`antenna_sharding`."""
    from blit_torch.parallel import mesh as M

    spec = M.P(None, None, axis) if layout == "chan" else M.P(None, axis)
    return M.NamedSharding(mesh, spec)


def _device_weights(weights: ComplexOrPlanar, dev) -> Planar:
    wr, wi, _ = as_planar(weights)
    return wr.to(dev), wi.to(dev)


def _stream_weights(weights: ComplexOrPlanar, dev, mesh, axis: str,
                    layout: str):
    """The weights placed once for a whole stream: on the device, or
    split over the mesh."""
    if mesh is None:
        return _device_weights(weights, resolve_device(dev))
    wr, wi, _ = _planes(weights, weight_sharding(mesh, axis, layout))
    return wr, wi


def _psum_bytes(win, layout: str, nbeam: int) -> int:
    """Bytes of the partial beam planes one window's psum moves (both
    planes, full time extent)."""
    v = win.arrays[0]
    shape = v.shape
    nchan = shape[0] if layout == "chan" else shape[1]
    npol = shape[2] if layout == "chan" else shape[3]
    return 2 * nbeam * nchan * win.ntime * npol * torch.empty(
        (), dtype=v.dtype).element_size()


def beamform_stream(feed: Iterable, weights: ComplexOrPlanar, *,
                    nint: int = 1, layout: str = "antenna",
                    timeline: Optional[Timeline] = None, device=None,
                    stall_timeout_s: Optional[float] = None, mesh=None,
                    axis: str = ANT_AXIS_DEFAULT) -> Iterator[torch.Tensor]:
    """Detected beam power over a windowed feed
    (:class:`blit_torch.parallel.antenna.AntennaStream`): one f32 host
    slab per window, in time order, ``(nbeam, nchan, wt // nint, npol)``
    (antenna layout) or ``(nchan, nbeam, npol, wt // nint)`` (chan
    layout).  Concatenated along time they equal the one-shot
    :func:`beamform` on the same span bitwise: every sum is window-local
    and taken in the same order.  Every window must hold a whole number
    of integrations.  With ``mesh`` (a mesh feed's windows) each window's
    psum over ``axis`` is accounted on ``mesh.ici`` / ``mesh.psum_ici_bytes``;
    masked antennas count ``masked_antennas``.

    Window ``w`` is dispatched, and its power read back on an
    :class:`~blit_torch.outplane.OutputRotation` (depth 2) thread while
    ``w+1`` is dispatched; the window's slot is released once its compute
    completed.  Stages in ``timeline``: ``dispatch`` (the launches),
    ``device`` (the readback thread's wait on a window's event) and
    ``readback`` (device → host, bytes)."""
    tl = timeline if timeline is not None else Timeline()
    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    weights = _stream_weights(weights, device, mesh, axis, layout)
    kw = dict(mesh=mesh, axis=axis) if mesh is not None else dict(device=device)
    nbeam = weights[0].shape[1 if layout == "chan" else 0]
    axis_size = mesh.shape[axis] if mesh is not None else 1
    rot = OutputRotation(depth=2, timeline=tl, reuse=False,
                         name="blit-bf-readback", stall_timeout_s=stall_timeout_s)
    try:
        for win in feed:
            if win.ntime % nint:
                raise ValueError(
                    f"window {win.index} holds {win.ntime} samples, not a whole "
                    f"number of nint={nint} integrations; choose window_samples "
                    "(and span) divisible by nint")
            if getattr(win, "masked", ()):
                tl.count("masked_antennas", len(win.masked))
            with tl.stage("dispatch", byte_free=True):
                out = beamform(win.arrays, weights, nint=nint, detect=True,
                               layout=layout, **kw)
                ev = record_event(out)
            if axis_size > 1:
                from blit_torch.parallel.mesh import psum_ici_bytes, record_ici

                record_ici(tl, "psum", psum_ici_bytes(
                    _psum_bytes(win, layout, nbeam), axis_size))
            slabs = rot.put(out, event=ev, on_consumed=win.release)
            del out
            for slab in slabs:
                yield torch.from_numpy(slab.data)
        for slab in rot.drain():
            yield torch.from_numpy(slab.data)
    finally:
        rot.close()


def beamform_accumulate(feed: Iterable, weights: ComplexOrPlanar, *,
                        layout: str = "antenna",
                        timeline: Optional[Timeline] = None,
                        device=None, mesh=None,
                        axis: str = ANT_AXIS_DEFAULT) -> torch.Tensor:
    """Total beam power over a whole windowed feed, accumulated on the
    device: each window's power, integrated over the window, adds into
    an f32 accumulator (the first window's power is the accumulator, not
    added to zeros).  Returns ``(nbeam, nchan, 1, npol)`` (antenna
    layout) or ``(nchan, nbeam, npol, 1)`` (chan layout) on the device,
    complete.  Window ``w-1``'s fold is waited on (stage ``device``) and
    its slot released only before window ``w``'s dispatch.  With
    ``mesh`` the accumulator carries its partition rule
    (:class:`~blit_torch.parallel.mesh.ShardedAccumulator`,
    ``"beamform_acc"``: the power after its psum, whole)."""
    tl = timeline if timeline is not None else Timeline()
    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    weights = _stream_weights(weights, device, mesh, axis, layout)
    kw = dict(mesh=mesh, axis=axis) if mesh is not None else dict(device=device)
    acc = None
    if mesh is not None:
        from blit_torch.parallel.mesh import MeshArray, ShardedAccumulator

        acc = ShardedAccumulator(mesh, "beamform_acc")

        def add(value, p):
            value.shards = {q: t.add_(p) for q, t in value.shards.items()}
            return value
    flight = FoldInFlight(tl, depth=1)
    total = None
    for win in feed:
        if getattr(win, "masked", ()):
            tl.count("masked_antennas", len(win.masked))
        flight.make_room()
        with tl.stage("dispatch", byte_free=True):
            p = beamform(win.arrays, weights, nint=win.ntime, detect=True,
                         layout=layout, **kw)
            if acc is None:
                total = p if total is None else total.add_(p)
            elif acc.value is None:
                first = min(mesh.local_players())
                acc.init(MeshArray(mesh, "beamform_acc", tuple(p.shape),
                                   {first: p}))
            else:
                acc.fold(add, p)
            done = total if acc is None else next(iter(acc.value.shards.values()))
        flight.admit(win, record_event(done))
    flight.drain()
    if acc is not None:
        total = None if acc.value is None else next(iter(acc.value.shards.values()))
    if total is None:
        raise ValueError("beamform_accumulate: feed yielded no windows")
    return total
