"""The FX correlator's X-engine, packed visibility layout.

Counterpart of ``blit/ops/pallas_xengine.py``.  Spectra ``(nant, nchan,
npol, nframes, nfft)`` as a planar pair (f32 or bf16) become visibilities
``(nchan, nfft, nap, nap)`` as an f32 pair, ``V[c, f, ap, bq] = Σ_t
S_a · conj(S_b)`` with ``ap = a·npol + p`` (antenna-major).

On a CUDA tensor :func:`xengine_packed` launches the hand-written Hopper
kernels of ``blit_torch/csrc/xengine.cu``, which pack the spectra into a
scratch copy (as ``blit`` packs them with an XLA transpose) and compute
only the 32 x 32 tiles on and above the diagonal of each ``(nap, nap)``
product (:func:`tile_pairs`), each storing its conjugate transpose too:
bf16 on the tensor cores, f32 in three tf32 passes there; on a CPU
tensor it runs :func:`xengine_packed_plain`.
:func:`eligible` is the gate that replaces ``eligible`` / ``pick_ft``: it
keeps ``blit``'s dispatch rule (``nap >= 128``) and drops the TPU VMEM
arithmetic and tile rules, since the Hopper kernel stages a fixed chunk
of frames whatever their number, masks ragged tiles, addresses the
spectra with 64-bit offsets and walks any number of work items with a
persistent grid.
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
# The tile edge compiled into csrc/xengine.cu (TILE).
_TILE = 32
_DTYPES = (torch.float32, torch.bfloat16)


def tile_pairs(nap: int):
    """The tiles csrc/xengine.cu computes for ``nap`` rows, in its item
    order: ``(I0, J0)`` row and column offsets of the 32 x 32 tiles on and
    above the diagonal, row by row of the upper triangle.  Each stores
    itself and, off the diagonal, its conjugate transpose at ``(J0, I0)``;
    a diagonal tile stores its upper half and the mirror of it."""
    ntiles = -(-nap // _TILE)
    return [(_TILE * i, _TILE * j) for i in range(ntiles)
            for j in range(i, ntiles)]


def eligible(nap: int, nchan: int, nfft: int, itemsize: int = 4) -> bool:
    """Whether ``correlate`` takes the Hopper kernel: ``nap >= 128`` and
    f32 or bf16 spectra.  The number of frames is free (the kernel stages
    a chunk at a time), as are ragged tiles of ``nap`` and ``nfft`` and
    the number of channels and fine channels (a persistent grid walks the
    work items)."""
    return nap >= MIN_NAP and itemsize in (2, 4)


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
    _check(sr, si)
    if sr.device.type == "cpu":
        return xengine_packed_plain(sr, si)
    if sr.device.type != "cuda":
        raise ValueError(f"xengine_packed: unsupported device {sr.device}")
    out = xengine_packed_cuda(sr, si)
    if sr.numel():
        xengine_packed.launches += 1
    return out


xengine_packed.launches = 0  # kernel launches (CUDA tensors only)


def xengine_packed_cuda(sr: torch.Tensor, si: torch.Tensor) -> Planar:
    """Launch ``csrc/xengine.cu`` on CUDA tensors, uncounted."""
    nant, nchan, npol, nframes, nfft = _check(sr, si)
    dev = sr.device
    if si.device != dev or sr.stride() != si.stride() or sr.stride(-1) != 1:
        raise ValueError("xengine_packed: sr/si must share strides on one "
                         "device, the fine-channel axis contiguous")
    nap = nant * npol
    vr = torch.empty((nchan, nfft, nap, nap), dtype=torch.float32, device=dev)
    vi = torch.empty_like(vr)
    if sr.numel() == 0:
        return vr, vi
    lib = _lib()
    bf16 = int(sr.dtype == torch.bfloat16)
    # Scratch for the kernel's packed copy of the spectra.
    words = lib.xengine_scratch_words(nant, nchan, npol, nframes, nfft, bf16)
    q = torch.empty(words, dtype=torch.int32, device=dev)
    s_ant, s_chan, s_pol, s_frame, _ = sr.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.xengine_launch(
            sr.data_ptr(), si.data_ptr(), vr.data_ptr(), vi.data_ptr(),
            q.data_ptr(), words, nant, nchan, npol, nframes, nfft, s_ant,
            s_chan, s_pol, s_frame, bf16, stream)
    kernels.check(lib, rc, "xengine_packed")
    return vr, vi


def _lib() -> ctypes.CDLL:
    lib = kernels.load("xengine")
    if lib.xengine_launch.argtypes is None:
        lib.xengine_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
        lib.xengine_launch.restype = ctypes.c_int
        lib.xengine_scratch_words.argtypes = [ctypes.c_int] * 6
        lib.xengine_scratch_words.restype = ctypes.c_longlong
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
