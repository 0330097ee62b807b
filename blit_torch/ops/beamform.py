"""Fused tied-array beamform + detect + integrate, packed layout.

Counterpart of ``blit/ops/pallas_beamform.py``.  Voltages ``(nchan,
nant, npol, ntime)`` and weights ``(nchan, nbeam, nant)``, planar pairs
of one dtype, f32 or bf16, become integrated beam power ``(nchan, nbeam, npol,
ntime // nint)`` in f32: per channel the complex product of the weights
with the voltages over antennas, ``|·|²``, and the sum of ``nint``
consecutive samples.

On a CUDA tensor :func:`fused_beamform_detect` launches the hand-written
Hopper kernel of ``blit_torch/csrc/beamform_detect.cu`` (the complex
product on the tensor cores: bf16 in one pass, f32 in three tf32 passes);
on a CPU tensor it runs :func:`fused_beamform_detect_plain`.  :func:`fits`
is the Hopper gate that replaces ``pick_tile``'s TPU VMEM model: the
kernel's shared memory (two stage slots of 64 beams x 128 samples) and its
persistent grid do not depend on the shape, so the gate is about ``nint``
(a power of two up to the 128-sample tile, dividing ``ntime``), with the
channel and (beam tile, pol) limits it has always had.
:func:`blit_torch.parallel.beamform.beamform` takes the kernel where the
gate admits the shape and its matmul route elsewhere.
"""

from __future__ import annotations

import ctypes
import math

import torch

from blit_torch import kernels
from blit_torch.ops.dft import Planar

# Geometry compiled into csrc/beamform_detect.cu (its launch refuses
# other nint): the largest nint (one 128-sample tile) and beams per block.
MAX_NINT = 128
BEAMS_PER_BLOCK = 64
_GRID_YZ_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)


def fits(nant: int, nbeam: int, npol: int, ntime: int, nint: int,
         itemsize: int = 4, nchan: int = 1) -> bool:
    """Whether the Hopper kernel takes this shape: f32 or bf16 operands,
    ``nint`` a power of two up to :data:`MAX_NINT` dividing ``ntime``, and
    the channel and (beam tile, pol) counts inside 65535.  Shared memory
    is fixed (antennas are staged 32 or 64 at a time, beams 64 at a time),
    so nant and nbeam are free."""
    return (itemsize in (2, 4) and min(nant, nbeam, npol, ntime, nchan) >= 1
            and 1 <= nint <= MAX_NINT and nint & (nint - 1) == 0
            and ntime % nint == 0 and nchan <= _GRID_YZ_MAX
            and npol * math.ceil(nbeam / BEAMS_PER_BLOCK) <= _GRID_YZ_MAX)


def _geometry(vr, vi, wr, wi, nint):
    if vr.ndim != 4 or wr.ndim != 3:
        raise ValueError("fused_beamform_detect: voltages (nchan, nant, npol, "
                         "ntime) and weights (nchan, nbeam, nant) required")
    if vi.shape != vr.shape or wi.shape != wr.shape:
        raise ValueError("fused_beamform_detect: re/im shape mismatch")
    nchan, nant, npol, ntime = vr.shape
    if wr.shape[0] != nchan or wr.shape[2] != nant:
        raise ValueError(f"fused_beamform_detect: weights {tuple(wr.shape)} do "
                         f"not match voltages {tuple(vr.shape)}")
    if vr.dtype not in _DTYPES or any(x.dtype != vr.dtype for x in (vi, wr, wi)):
        raise ValueError("fused_beamform_detect: voltages and weights must all "
                         "be float32 or all bfloat16")
    if nint < 1 or ntime % nint:
        raise ValueError(f"fused_beamform_detect: nint={nint} does not divide "
                         f"ntime={ntime}")
    return nchan, nant, npol, ntime, wr.shape[1]


def fused_beamform_detect(vr: torch.Tensor, vi: torch.Tensor,
                          wr: torch.Tensor, wi: torch.Tensor, *,
                          nint: int) -> torch.Tensor:
    """Integrated beam power ``(nchan, nbeam, npol, ntime // nint)`` f32
    of packed voltages ``v`` and weights ``w`` (module docstring).  On a
    CUDA tensor the shape must pass :func:`fits`, else this raises."""
    nchan, nant, npol, ntime, nbeam = _geometry(vr, vi, wr, wi, nint)
    if vr.device.type == "cpu":
        return fused_beamform_detect_plain(vr, vi, wr, wi, nint=nint)
    if vr.device.type != "cuda":
        raise ValueError(f"fused_beamform_detect: unsupported device {vr.device}")
    if not fits(nant, nbeam, npol, ntime, nint, vr.element_size(), nchan):
        raise ValueError(
            f"fused_beamform_detect: the Hopper kernel takes nint a power of "
            f"two up to {MAX_NINT} dividing ntime and nchan up to "
            f"{_GRID_YZ_MAX} (got nint={nint}, ntime={ntime}, nchan={nchan}); "
            f"beamform's matmul route takes other shapes")
    dev = vr.device
    for t in (vr, vi, wr, wi):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"fused_beamform_detect: inputs must be contiguous "
                             f"on {dev}")
    out = vr.new_empty((nchan, nbeam, npol, ntime // nint), dtype=torch.float32)
    lib = _lib()
    ctx, stream = kernels.launch_stream(dev)
    with ctx:
        rc = lib.beamform_detect_launch(
            vr.data_ptr(), vi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            out.data_ptr(), nchan, nant, nbeam, npol, ntime, nint,
            int(vr.dtype == torch.bfloat16), stream)
    kernels.check(lib, rc, "fused_beamform_detect")
    fused_beamform_detect.launches += 1
    return out


fused_beamform_detect.launches = 0  # kernel launches (CUDA tensors only)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("beamform_detect")
    if lib.beamform_detect_launch.argtypes is None:
        lib.beamform_detect_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.beamform_detect_launch.restype = ctypes.c_int
    return lib


def fused_beamform_detect_plain(vr: torch.Tensor, vi: torch.Tensor,
                                wr: torch.Tensor, wi: torch.Tensor, *,
                                nint: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_beamform_detect`: the four
    real products as f32 einsums of the (bf16-rounded) operands, the
    combines, ``|·|²``, and the sum of ``nint`` consecutive samples."""
    nchan, nant, npol, ntime, nbeam = _geometry(vr, vi, wr, wi, nint)
    vr, vi, wr, wi = (t.to(torch.float32) for t in (vr, vi, wr, wi))
    rr = torch.einsum("cba,capt->cbpt", wr, vr)
    ii = torch.einsum("cba,capt->cbpt", wi, vi)
    ri = torch.einsum("cba,capt->cbpt", wr, vi)
    ir = torch.einsum("cba,capt->cbpt", wi, vr)
    br, bi = rr - ii, ri + ir
    del rr, ii, ri, ir
    power = br * br + bi * bi
    return power.reshape(nchan, nbeam, npol, ntime // nint, nint).sum(-1)


def pack_voltages(vr: torch.Tensor, vi: torch.Tensor) -> Planar:
    """Antenna-layout ``(nant, nchan, ntime, npol)`` planes → packed
    ``(nchan, nant, npol, ntime)`` (one transpose; the antenna feeds load
    packed planes directly with ``layout="chan"``)."""
    return (vr.permute(1, 0, 3, 2).contiguous(),
            vi.permute(1, 0, 3, 2).contiguous())


def pack_weights(wr: torch.Tensor, wi: torch.Tensor) -> Planar:
    """``(nbeam, nant, nchan)`` weight planes → packed ``(nchan, nbeam,
    nant)``."""
    return wr.permute(2, 0, 1).contiguous(), wi.permute(2, 0, 1).contiguous()
