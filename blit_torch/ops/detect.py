"""Stokes detection fused with the DFT's last steps: the two kernels of
``blit/ops/pallas_detect.py``.

- :func:`tail2_detect` (``pallas_detect.py:tail2_detect``): DFT levels 2
  and 3, the inner untwist and any Stokes product, written in the
  filterbank product layout, f32 ``(nframes, nif, nchan, f1·f2·f3)`` in
  natural frequency order.  CUDA kernel ``blit_torch/csrc/tail2_detect.cu``,
  plain twin :func:`tail2_detect_plain`, gate :func:`fits`.
- :func:`detect_untwist_i` (``pallas_detect.py:detect_untwist_i``):
  twisted spectra (``dft(order="twisted")``) → natural-order Stokes-I
  power, f32 ``(nchan, nframes, n)``.  CUDA kernel
  ``blit_torch/csrc/detect_untwist.cu``, plain twin
  :func:`detect_untwist_i_plain`, gate :func:`untwist_fits`.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain twin.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from blit_torch import kernels
from blit_torch.ops.dft import (
    dft_matrices_on,
    dft_tail,
    twiddles_on,
    untwist,
)
from blit_torch.ops.pfb import HOPPER_SMEM_MAX

STOKES_NIF = {"I": 1, "XX": 1, "YY": 1, "XXYY": 2, "full": 4, "IQUV": 4}
_STOKES_CODE = {"I": 0, "XX": 1, "YY": 2, "XXYY": 3, "full": 4, "IQUV": 5}

# Kernel geometry (mirrors csrc/tail2_detect.cu; checked when it loads):
# f2 and f3 compiled in, a thread-block cluster of KERNEL_K1_TILE blocks on
# consecutive k1.
KERNEL_F2 = 128
KERNEL_F3 = 64
KERNEL_K1_TILE = 8


def kernel_smem_bytes() -> int:
    """Dynamic shared memory of one tail2_detect block: the rows of W2
    and W3, the (f2, f3) twiddle's two planes, and the four planes of a
    panel pair (re, im of both pols; rows padded by 4 floats), over which
    the detected product's planes are written.  The same for every
    Stokes product."""
    f2, f3 = KERNEL_F2, KERNEL_F3
    return (2 * (f2 + f3) + 2 * f2 * f3 + 4 * f2 * (f3 + 4)) * 4


def detect_stokes_planar(sr: torch.Tensor, si: torch.Tensor, stokes: str
                         ) -> torch.Tensor:
    """Planar spectra ``(..., npol, nframes, n)`` → power products
    ``(..., nif, nframes, n)`` f32 (rawspec conventions: I, XX, YY, XXYY,
    full = [XX, YY, Re XY*, Im XY*], IQUV)."""
    npol = sr.shape[-3]
    if npol == 1:
        if stokes not in ("I", "XX"):
            raise ValueError(f"stokes={stokes!r} needs 2 pols, got 1")
        return (sr**2 + si**2)[..., 0:1, :, :]
    xr, yr = sr[..., 0, :, :], sr[..., 1, :, :]
    xi, yi = si[..., 0, :, :], si[..., 1, :, :]
    xx = xr**2 + xi**2
    yy = yr**2 + yi**2
    if stokes == "I":
        return (xx + yy)[..., None, :, :]
    if stokes == "XX":
        return xx[..., None, :, :]
    if stokes == "YY":
        return yy[..., None, :, :]
    if stokes == "XXYY":
        return torch.stack([xx, yy], dim=-3)
    xy_re = xr * yr + xi * yi
    xy_im = xi * yr - xr * yi
    if stokes == "full":
        return torch.stack([xx, yy, xy_re, xy_im], dim=-3)
    if stokes == "IQUV":
        return torch.stack([xx + yy, xx - yy, 2 * xy_re, -2 * xy_im], dim=-3)
    raise ValueError(f"unknown stokes {stokes!r}")


def _check(ur: torch.Tensor, f2: int, f3: int, stokes: str):
    if ur.ndim != 5:
        raise ValueError("tail2_detect: (nchan, npol, nframes, f1, m) input")
    nchan, npol, nframes, f1, m = ur.shape
    if m != f2 * f3:
        raise ValueError(f"tail2_detect: last axis {m} != {f2}*{f3}")
    if stokes not in STOKES_NIF:
        raise ValueError(f"unknown stokes {stokes!r}")
    if npol == 1 and stokes not in ("I", "XX"):
        raise ValueError(f"stokes={stokes!r} needs 2 pols, got 1")
    return nchan, npol, nframes, f1, m


def fits(factors, npol: int = 2, stokes: str = "I") -> bool:
    """Hopper fit gate of the CUDA kernel: exactly three factors
    ``(f1, 128, 64)`` with ``f1`` a multiple of the cluster's k1 tile
    (8), two pols, any Stokes product (the detected planes are written
    over the panel pair in shared memory, :func:`kernel_smem_bytes`)."""
    if len(factors) != 3 or stokes not in STOKES_NIF or npol != 2:
        return False
    f1, f2, f3 = factors
    return (f2 == KERNEL_F2 and f3 == KERNEL_F3 and f1 % KERNEL_K1_TILE == 0
            and kernel_smem_bytes() <= HOPPER_SMEM_MAX)


def tail2_detect(ur: torch.Tensor, ui: torch.Tensor, f2: int, f3: int, *,
                 stokes: str = "I") -> torch.Tensor:
    """Stage-1 spectra ``(nchan, npol, nframes, f1, f2·f3)`` (f32 or bf16)
    → f32 ``(nframes, nif, nchan, f1·f2·f3)`` natural-order products."""
    if ur.device.type == "cpu":
        return tail2_detect_plain(ur, ui, f2, f3, stokes=stokes)
    if ur.device.type != "cuda":
        raise ValueError(f"tail2_detect: unsupported device {ur.device}")
    return _tail2_detect_cuda(ur, ui, f2, f3, stokes)


tail2_detect.launches = 0  # kernel launches (CUDA tensors only)


def tail2_detect_i(ur, ui, f2: int, f3: int) -> torch.Tensor:
    """Stokes-I :func:`tail2_detect` returning ``(nframes, nchan, n)``."""
    return tail2_detect(ur, ui, f2, f3, stokes="I")[:, 0]


def _lib() -> ctypes.CDLL:
    lib = kernels.load("tail2_detect")
    if lib.tail2_detect_launch.argtypes is None:
        lib.tail2_detect_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.tail2_detect_launch.restype = ctypes.c_int
        geom = (lib.tail2_detect_f2(), lib.tail2_detect_f3(),
                lib.tail2_detect_k1_tile(), lib.tail2_detect_smem_bytes())
        want = (KERNEL_F2, KERNEL_F3, KERNEL_K1_TILE, kernel_smem_bytes())
        if geom != want:
            raise RuntimeError(f"tail2_detect.cu geometry {geom} disagrees "
                               "with blit_torch/ops/detect.py")
    return lib


def _tail2_detect_cuda(ur, ui, f2, f3, stokes):
    nchan, npol, nframes, f1, m = _check(ur, f2, f3, stokes)
    dev = ur.device
    if ur.dtype not in (torch.float32, torch.bfloat16) or ui.dtype != ur.dtype:
        raise ValueError("tail2_detect: ur/ui must both be float32 or bfloat16")
    if ui.shape != ur.shape or ui.device != dev:
        raise ValueError("tail2_detect: ur/ui shape or device mismatch")
    if not (ur.is_contiguous() and ui.is_contiguous()):
        raise ValueError("tail2_detect: ur/ui must be contiguous")
    if not fits((f1, f2, f3), npol, stokes):
        raise ValueError(
            f"tail2_detect: the Hopper kernel takes factors (f1, "
            f"{KERNEL_F2}, {KERNEL_F3}) with f1 % {KERNEL_K1_TILE} == 0 and "
            f"2 pols (got ({f1}, {f2}, {f3}), npol={npol})")
    if ur.data_ptr() % 16 or ui.data_ptr() % 16:
        raise ValueError("tail2_detect: misaligned input")
    nif = STOKES_NIF[stokes]
    w2r, w2i = dft_matrices_on(f2, dev)
    w3r, w3i = dft_matrices_on(f3, dev)
    t2r, t2i = twiddles_on(f2, f3, dev)
    out = torch.empty((nframes, nif, nchan, f1 * m), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tail2_detect_launch(
            ur.data_ptr(), ui.data_ptr(), w2r[1].data_ptr(), w2i[1].data_ptr(),
            w3r[1].data_ptr(), w3i[1].data_ptr(), t2r.data_ptr(),
            t2i.data_ptr(), out.data_ptr(), nchan, nframes, f1,
            _STOKES_CODE[stokes], nif, int(ur.dtype == torch.bfloat16),
            stream)
    kernels.check(lib, rc, "tail2_detect")
    kernels.count_launch(tail2_detect)
    return out


def tail2_detect_plain(ur: torch.Tensor, ui: torch.Tensor, f2: int, f3: int,
                       *, stokes: str = "I") -> torch.Tensor:
    """Plain PyTorch twin of :func:`tail2_detect`, one coarse channel at a
    time.  bf16 input takes the TPU kernel's rounding points: matrices
    and post-twiddle intermediates rounded to bf16, sums in f32."""
    nchan, npol, nframes, f1, m = _check(ur, f2, f3, stokes)
    bf16 = ur.dtype == torch.bfloat16
    out = torch.empty((nframes, STOKES_NIF[stokes], nchan, f1 * m),
                      dtype=torch.float32, device=ur.device)
    for c in range(nchan):
        sr, si = dft_tail(ur[c].to(torch.float32), ui[c].to(torch.float32),
                          (f1, f2, f3), bf16=bf16)  # (npol, nframes, n)
        out[:, :, c] = detect_stokes_planar(sr, si, stokes).transpose(0, 1)
    return out


# Largest factor the detect_untwist kernel takes (its sizes are ints).
UNTWIST_MAX_FACTOR = (1 << 31) - 1


def untwist_fits(factors, npol: int = 2) -> bool:
    """Hopper gate of :func:`detect_untwist_i`'s kernel: one to three
    factors (axis reversal keeps one middle axis), each a positive int
    below 2^31, and one or two pols.  Unlike ``blit``'s ``fits`` it has
    no VMEM model: the kernel stages 32 × 32 tiles of the
    ``f1 × flast`` transpose, masks ragged edges and walks its tiles
    with a grid-stride loop over 64-bit offsets, so the factor sizes
    and the grid set no other limit — ``(1000, 1000)`` fits here but
    not in ``blit``, where ``f1`` and ``flast`` are untiled."""
    factors = tuple(factors)
    return (1 <= len(factors) <= 3 and npol in (1, 2)
            and all(isinstance(f, int) and 0 < f <= UNTWIST_MAX_FACTOR
                    for f in factors))


def _untwist_geometry(sr, si, factors) -> Tuple[int, int, int]:
    """→ (f1, mid, flast) of the twisted layout; checks the shapes."""
    factors = tuple(int(f) for f in factors)
    if sr.ndim != 4:
        raise ValueError("detect_untwist_i: (nchan, npol, nframes, n) input")
    if si.shape != sr.shape or si.dtype != sr.dtype or si.device != sr.device:
        raise ValueError("detect_untwist_i: sr/si shape, dtype or device mismatch")
    n = sr.shape[-1]
    if math.prod(factors) != n:
        raise ValueError(f"detect_untwist_i: factors {factors} do not "
                         f"multiply to {n}")
    if len(factors) > 3:
        raise ValueError("detect_untwist_i supports at most 3 DFT factors")
    if len(factors) == 1:
        return n, 1, 1
    f1, flast = factors[0], factors[-1]
    return f1, n // (f1 * flast), flast


def detect_untwist_i(sr: torch.Tensor, si: torch.Tensor,
                     factors: Tuple[int, ...]) -> torch.Tensor:
    """Twisted planar spectra ``(nchan, npol, nframes, n)`` (f32 or
    bf16, the layout of ``dft(order="twisted")`` over ``factors``, at
    most three) → f32 natural-order Stokes-I power ``(nchan, nframes,
    n)``: the sum over pols of ``re² + im²``, written at ``k = k1 +
    f1·kmid + f1·mid·klast``, i.e. as ``(flast, mid, f1)`` row-major."""
    if sr.device.type == "cpu":
        return detect_untwist_i_plain(sr, si, factors)
    if sr.device.type != "cuda":
        raise ValueError(f"detect_untwist_i: unsupported device {sr.device}")
    return _detect_untwist_cuda(sr, si, factors)


detect_untwist_i.launches = 0  # kernel launches (CUDA tensors only)


def _untwist_lib() -> ctypes.CDLL:
    lib = kernels.load("detect_untwist")
    if lib.detect_untwist_launch.argtypes is None:
        lib.detect_untwist_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.detect_untwist_launch.restype = ctypes.c_int
    return lib


def _detect_untwist_cuda(sr, si, factors):
    f1, mid, flast = _untwist_geometry(sr, si, factors)
    nchan, npol, nframes, n = sr.shape
    if sr.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("detect_untwist_i: sr/si must be float32 or bfloat16")
    if not (sr.is_contiguous() and si.is_contiguous()):
        raise ValueError("detect_untwist_i: sr/si must be contiguous")
    if not untwist_fits(tuple(int(f) for f in factors), npol):
        raise ValueError(
            f"detect_untwist_i: the Hopper kernel takes 1 to 3 factors below "
            f"2^31 and 1 or 2 pols (got {tuple(factors)}, npol={npol})")
    out = torch.empty((nchan, nframes, n), dtype=torch.float32, device=sr.device)
    if out.numel() == 0:
        return out
    lib = _untwist_lib()
    with torch.cuda.device(sr.device):
        stream = torch.cuda.current_stream(sr.device).cuda_stream
        rc = lib.detect_untwist_launch(
            sr.data_ptr(), si.data_ptr(), out.data_ptr(), nchan * nframes,
            nframes, npol, f1, mid, flast, int(sr.dtype == torch.bfloat16),
            stream)
    kernels.check(lib, rc, "detect_untwist_i")
    kernels.count_launch(detect_untwist_i)
    return out


def detect_untwist_i_plain(sr: torch.Tensor, si: torch.Tensor,
                           factors: Tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch twin of :func:`detect_untwist_i`: the f32 power of
    each pol (``re² + im²``), the sum over pols, then :func:`untwist` —
    the kernel's four squares and three adds, in its order."""
    _untwist_geometry(sr, si, factors)
    sr, si = sr.to(torch.float32), si.to(torch.float32)
    power = (sr * sr + si * si).sum(dim=1)
    return untwist(power, tuple(int(f) for f in factors))
