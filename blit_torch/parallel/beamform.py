"""Coherent multibeam (tied-array) beamforming on one card.

Counterpart of ``blit/parallel/beamform.py``.  ``blit`` shards the
antenna axis over a mesh and completes the tied-array sum with one
``psum``; on one card that psum is the identity and every antenna is
local, so ``blit``'s gate for fusing detection (``mesh.shape[axis] ==
1``) always holds.  The entry points take ``device=`` in place of
``mesh`` and ``axis``; the sharded forms come with the
``torch.distributed`` mesh (ROADMAP.md Queue 1 item 6).

Complex values travel planar, as ``(re, im)`` pairs; the entry points
take a pair or one complex tensor, and the output dtype follows the
input as in ``blit``.  Two layouts:

- ``"antenna"``: voltages ``(nant, nchan, ntime, npol)``, weights
  ``(nbeam, nant, nchan)``: ``blit``'s einsum route, here the four real
  products as ``torch.einsum`` (batched matmuls) in the voltages' dtype;
- ``"chan"``: packed voltages ``(nchan, nant, npol, ntime)`` and weights
  ``(nchan, nbeam, nant)``.  With ``detect=True`` and a shape the Hopper
  gate (:func:`blit_torch.ops.beamform.fits`) admits, the fused
  beamform + detect + integrate kernel (beams never reach device memory);
  otherwise the same matmul route as above.

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
from typing import Iterable, Iterator, Optional

import torch

from blit_torch.device import resolve_device
from blit_torch.observability import Timeline
from blit_torch.ops import beamform as beam_ops
from blit_torch.ops.channelize import integrate
from blit_torch.ops.dft import ComplexOrPlanar, Planar, as_planar
from blit_torch.outplane import FoldInFlight, OutputRotation, record_event

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


def beamform(voltages: ComplexOrPlanar, weights: ComplexOrPlanar, *,
             nint: int = 1, detect: bool = True, layout: str = "antenna",
             device=None):
    """Form tied-array beams (module docstring for the layouts).

    ``detect=True`` → per-beam power integrated over ``nint`` samples,
    f32: ``(nbeam, nchan, ntime // nint, npol)`` (antenna layout) or
    ``(nchan, nbeam, npol, ntime // nint)`` (chan layout).
    ``detect=False`` → beam voltages ``(nbeam, nchan, ntime, npol)`` /
    ``(nchan, nbeam, npol, ntime)`` in the voltages' dtype: one complex64
    tensor when both inputs were complex, else a planar pair.
    ``device``: where to compute (``None``: the CUDA device); inputs
    elsewhere are copied there.
    """
    if layout not in ("antenna", "chan"):
        raise ValueError(f"bad layout {layout!r}")
    dev = resolve_device(device)
    vr, vi, v_cplx = as_planar(voltages)
    wr, wi, w_cplx = as_planar(weights)
    complex_out = v_cplx and w_cplx
    vr, vi = vr.to(dev), vi.to(dev)
    # bf16 voltages take bf16-rounded weights; f32 ones f32 weights.
    wr, wi = wr.to(dev, vr.dtype), wi.to(dev, vr.dtype)
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
    fuse = (layout == "chan" and detect
            and beam_ops.fits(nant, nbeam, npol, ntime, nint, vr.element_size(),
                              nchan))
    _LAST_PLAN.clear()
    _LAST_PLAN.update(layout=layout, fused=fuse,
                      impl="cuda" if dev.type == "cuda" else "plain")
    if fuse:
        return beam_ops.fused_beamform_detect(
            vr.contiguous(), vi.contiguous(), wr.contiguous(), wi.contiguous(),
            nint=nint)
    br, bi = _beams(eq, vr, vi, wr, wi)
    if not detect:
        return torch.complex(br, bi) if complex_out else (br, bi)
    br, bi = br.to(torch.float32), bi.to(torch.float32)
    power = br * br + bi * bi
    if layout == "antenna":
        return integrate(power, nint)
    # (c, b, p, t): time is last, integrate() sums axis -2.
    return power.reshape(nchan, nbeam, npol, ntime // nint, nint).sum(-1)


def _device_weights(weights: ComplexOrPlanar, dev) -> Planar:
    wr, wi, _ = as_planar(weights)
    return wr.to(dev), wi.to(dev)


def beamform_stream(feed: Iterable, weights: ComplexOrPlanar, *,
                    nint: int = 1, layout: str = "antenna",
                    timeline: Optional[Timeline] = None, device=None,
                    stall_timeout_s: Optional[float] = None
                    ) -> Iterator[torch.Tensor]:
    """Detected beam power over a windowed feed
    (:class:`blit_torch.parallel.antenna.AntennaStream`): one f32 host
    slab per window, in time order, ``(nbeam, nchan, wt // nint, npol)``
    (antenna layout) or ``(nchan, nbeam, npol, wt // nint)`` (chan
    layout).  Concatenated along time they equal the one-shot
    :func:`beamform` on the same span bitwise: every sum is window-local
    and taken in the same order.  Every window must hold a whole number
    of integrations.

    Window ``w`` is dispatched, and its power read back on an
    :class:`~blit_torch.outplane.OutputRotation` (depth 2) thread while
    ``w+1`` is dispatched; the window's slot is released once its compute
    completed.  Stages in ``timeline``: ``dispatch`` (the launches),
    ``device`` (the readback thread's wait on a window's event) and
    ``readback`` (device → host, bytes)."""
    tl = timeline if timeline is not None else Timeline()
    dev = resolve_device(device)
    weights = _device_weights(weights, dev)
    rot = OutputRotation(depth=2, timeline=tl, reuse=False,
                         name="blit-bf-readback", stall_timeout_s=stall_timeout_s)
    try:
        for win in feed:
            if win.ntime % nint:
                raise ValueError(
                    f"window {win.index} holds {win.ntime} samples, not a whole "
                    f"number of nint={nint} integrations; choose window_samples "
                    "(and span) divisible by nint")
            with tl.stage("dispatch", byte_free=True):
                out = beamform(win.arrays, weights, nint=nint, detect=True,
                               layout=layout, device=dev)
                ev = record_event(out)
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
                        device=None) -> torch.Tensor:
    """Total beam power over a whole windowed feed, accumulated on the
    device: each window's power, integrated over the window, adds into
    an f32 accumulator (the first window's power is the accumulator, not
    added to zeros).  Returns ``(nbeam, nchan, 1, npol)`` (antenna
    layout) or ``(nchan, nbeam, npol, 1)`` (chan layout) on the device,
    complete.  Window ``w-1``'s fold is waited on (stage ``device``) and
    its slot released only before window ``w``'s dispatch."""
    tl = timeline if timeline is not None else Timeline()
    dev = resolve_device(device)
    weights = _device_weights(weights, dev)
    flight = FoldInFlight(tl, depth=1)
    acc = None
    for win in feed:
        flight.make_room()
        with tl.stage("dispatch", byte_free=True):
            p = beamform(win.arrays, weights, nint=win.ntime, detect=True,
                         layout=layout, device=dev)
            acc = p if acc is None else acc.add_(p)
        flight.admit(win, record_event(acc))
    flight.drain()
    if acc is None:
        raise ValueError("beamform_accumulate: feed yielded no windows")
    return acc
