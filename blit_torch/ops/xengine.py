"""The FX correlator's X-engine, packed visibility layout.

Counterpart of ``blit/ops/pallas_xengine.py``.  Spectra ``(nant, nchan,
npol, nframes, nfft)`` as a planar pair (f32 or bf16) become visibilities
``(nchan, nfft, nap, nap)`` as an f32 pair, ``V[c, f, ap, bq] = Σ_t
S_a · conj(S_b)`` with ``ap = a·npol + p`` (antenna-major).

On a CUDA tensor :func:`xengine_packed` launches the hand-written Hopper
kernel of ``blit_torch/csrc/xengine.cu``, which reads the unpacked
spectra itself (``blit`` packs them with an XLA transpose first); on a
CPU tensor it runs :func:`xengine_packed_plain`.  :func:`eligible` is the
gate that replaces ``eligible`` / ``pick_ft``: it keeps ``blit``'s
dispatch rule (``nap >= 128``) and the kernel's grid limits, and drops the
TPU VMEM arithmetic and tile rules, since the Hopper kernel stages a fixed
48 KB whatever the number of frames, masks ragged tiles and addresses the
spectra with 64-bit offsets.
:func:`blit_torch.parallel.correlator.correlate` takes the kernel for
``vis_layout="packed"`` where the gate admits the shape.
"""

from __future__ import annotations

import ctypes

import torch

from blit_torch import kernels
from blit_torch.ops.dft import Planar

# blit's dispatch rule: baseline tiles of at least 128 (the size at which
# its kernel measured faster than its einsum X-engine).
MIN_NAP = 128
# Geometry compiled into csrc/xengine.cu: fine channels, ap rows and bq
# columns a block owns, and CUDA's grid limits.
_FT, _TM, _TN = 32, 32, 16
_GRID_X_MAX, _GRID_YZ_MAX = 2 ** 31 - 1, 65535
_DTYPES = (torch.float32, torch.bfloat16)


def _grid_fits(nap: int, nchan: int, nfft: int) -> bool:
    return (-(-nap // _TM) * -(-nap // _TN) <= _GRID_X_MAX
            and -(-nfft // _FT) <= _GRID_YZ_MAX and nchan <= _GRID_YZ_MAX)


def eligible(nap: int, nchan: int, nfft: int, itemsize: int = 4) -> bool:
    """Whether ``correlate`` takes the Hopper kernel: ``nap >= 128``, f32
    or bf16 spectra, and a grid inside CUDA's limits (``nchan`` and
    ``nfft / 32`` up to 65535).  The number of frames is free (the kernel
    stages 4 at a time), as are ragged tiles of ``nap`` and ``nfft``."""
    return nap >= MIN_NAP and itemsize in (2, 4) and _grid_fits(nap, nchan, nfft)


def _check(sr, si):
    if sr.ndim != 5 or si.shape != sr.shape:
        raise ValueError("xengine_packed: spectra (nant, nchan, npol, nframes, "
                         "nfft) planar pair required")
    if sr.dtype not in _DTYPES or si.dtype != sr.dtype:
        raise ValueError("xengine_packed: sr/si must both be float32 or bfloat16")
    return sr.shape


def xengine_packed(sr: torch.Tensor, si: torch.Tensor) -> Planar:
    """Cross-multiply and time-integrate planar spectra into packed
    visibilities (module docstring).  The fine-channel axis must be
    contiguous; a slice along the other axes (a tile of frames) is read
    in place."""
    nant, nchan, npol, nframes, nfft = _check(sr, si)
    if sr.device.type == "cpu":
        return xengine_packed_plain(sr, si)
    if sr.device.type != "cuda":
        raise ValueError(f"xengine_packed: unsupported device {sr.device}")
    dev = sr.device
    if si.device != dev or sr.stride() != si.stride() or sr.stride(-1) != 1:
        raise ValueError("xengine_packed: sr/si must share strides on one "
                         "device, the fine-channel axis contiguous")
    nap = nant * npol
    if not _grid_fits(nap, nchan, nfft):
        raise ValueError(f"xengine_packed: nap={nap}, nchan={nchan}, "
                         f"nfft={nfft} beyond the kernel's grid")
    vr = torch.empty((nchan, nfft, nap, nap), dtype=torch.float32, device=dev)
    vi = torch.empty_like(vr)
    if sr.numel() == 0:
        return vr, vi
    lib = _lib()
    s_ant, s_chan, s_pol, s_frame, _ = sr.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.xengine_launch(
            sr.data_ptr(), si.data_ptr(), vr.data_ptr(), vi.data_ptr(),
            nant, nchan, npol, nframes, nfft, s_ant, s_chan, s_pol, s_frame,
            int(sr.dtype == torch.bfloat16), stream)
    kernels.check(lib, rc, "xengine_packed")
    xengine_packed.launches += 1
    return vr, vi


xengine_packed.launches = 0  # kernel launches (CUDA tensors only)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("xengine")
    if lib.xengine_launch.argtypes is None:
        lib.xengine_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
        lib.xengine_launch.restype = ctypes.c_int
    return lib


def xengine_packed_plain(sr: torch.Tensor, si: torch.Tensor) -> Planar:
    """Plain PyTorch version of :func:`xengine_packed`: the four real
    products as f32 einsums of the (bf16-rounded) spectra, then
    ``rr + ii`` and ``ir − ri``."""
    nant, nchan, npol, nframes, nfft = _check(sr, si)
    sr, si = sr.to(torch.float32), si.to(torch.float32)
    eq = "acptf,bcqtf->cfapbq"
    rr = torch.einsum(eq, sr, sr)
    ii = torch.einsum(eq, si, si)
    vr = (rr + ii).reshape(nchan, nfft, nant * npol, nant * npol)
    del rr, ii
    ir = torch.einsum(eq, si, sr)
    ri = torch.einsum(eq, sr, si)
    return vr, (ir - ri).reshape(nchan, nfft, nant * npol, nant * npol)
