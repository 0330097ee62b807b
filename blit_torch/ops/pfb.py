"""The channelizer's front ends: int8 dequant + polyphase FIR, alone or
fused with DFT stage 1 (+ twiddle).

Counterpart of ``blit/ops/pallas_pfb.py``: :func:`pfb_dequant` and
:func:`pfb_dft1`.  On a CUDA tensor each launches its hand-written Hopper
kernel (``blit_torch/csrc/pfb_dequant.cu``, ``pfb_dft1.cu``); on a CPU
tensor it runs its plain PyTorch twin (:func:`pfb_dequant_plain`,
:func:`pfb_dft1_plain`), which repeats the kernel's arithmetic (and the
TPU kernel's rounding points) step by step.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from blit_torch import kernels
from blit_torch.ops.dft import _radices, fft_plan, round_bf16

# Dynamic shared memory one block may use on an H100.
HOPPER_SMEM_MAX = 232448
# csrc/pfb_dft1.cu: frames a tile holds at most (FG), values one round of
# an FFT pass covers (SE), and the tile widths it takes.
KERNEL_FRAMES = 4
KERNEL_ROUND = 8192
KERNEL_TILE_COLS = (16, 8)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _geometry(voltages: torch.Tensor, coeffs: torch.Tensor, n1: int):
    if voltages.ndim != 4 or voltages.shape[2:] != (2, 2):
        raise ValueError("pfb_dft1: npol=2 complex int8 input required")
    nchan, ntime = voltages.shape[:2]
    ntap, nfft = coeffs.shape
    if nfft % n1:
        raise ValueError(f"pfb_dft1: n1={n1} does not divide nfft={nfft}")
    if ntime % nfft:
        raise ValueError(f"ntime={ntime} not a multiple of nfft={nfft}")
    nblk = ntime // nfft
    nframes = nblk - ntap + 1
    if nframes < 1:
        raise ValueError(f"pfb_dft1: need >= {ntap} blocks of {nfft}, got {nblk}")
    return nchan, nfft, ntap, nblk, nframes


def _panel_floats(n1: int, tc: int) -> int:
    return ((n1 * tc + 31) & ~31) + tc


def _smem(n1: int, tc: int, fg: int, ntap: int, nstage: int) -> int:
    """csrc/pfb_dft1.cu ``pfb_smem``: the root table, the FIR tile (two
    planes of fg·2 padded panels) and the stage buffers (fg + ntap - 1
    blocks of n1 rows × tc int8 samples, then the window's ntap rows of
    the same columns; 4 bytes each)."""
    return (8 * ((n1 + 1) & ~1) + 2 * fg * 2 * _panel_floats(n1, tc) * 4
            + nstage * (fg + 2 * ntap - 1) * n1 * tc * 4)


def kernel_geometry(n1: int, ntap: int = 4) -> Optional[dict]:
    """How csrc/pfb_dft1.cu runs stage 1 of n1 points with an ntap-tap
    window: the radix plan (:func:`blit_torch.ops.dft.fft_plan`), the
    tile (``tc`` columns × ``fg`` frames × 2 pols, the FIR tile in shared
    memory), the columns a round of passes takes, the stage buffers (two
    where they fit, else one whose next tile's copies start after the
    FIR) and the shared-memory bytes, the layout the kernel checks.  The
    widest tile first (16 columns store 64-byte runs; at n1 = 128 a tile
    of 8 took 3.3 times as long, PERF.md §6), then the most frames (each
    int8 block is read by fewer tiles), then two stage buffers.  None
    where no layout fits in :data:`HOPPER_SMEM_MAX` (or n1 < 2)."""
    if not 2 <= n1 <= KERNEL_ROUND or ntap < 1:
        return None
    for tc in KERNEL_TILE_COLS:
        for fg in (KERNEL_FRAMES, 2, 1):
            for nstage in (2, 1):
                smem = _smem(n1, tc, fg, ntap, nstage)
                if smem <= HOPPER_SMEM_MAX:
                    return dict(plan=fft_plan(n1), tc=tc, fg=fg,
                                per_round=min(fg * 2 * tc,
                                              KERNEL_ROUND // n1),
                                nstage=nstage, smem=smem)
    return None


def fits(nfft: int, n1: int, npol: int = 2, ntap: int = 4) -> bool:
    """Hopper fit gate of the CUDA kernel: two pols, an n1 >= 2 that
    divides nfft, and a tile of n1 rows (the FIR output of up to 4 frames
    and both pols, and the int8 rows it reads) that fits in shared memory
    (:func:`kernel_geometry`; n1 up to 592 at ntap = 4).  Every n1 is an
    FFT of ``fft_plan``'s passes, a ragged last column tile is masked, so
    any m = nfft / n1 is taken.  Like ``blit``'s ``fused1_fits`` it
    depends on the shape, not on the number of frames."""
    return (npol == 2 and n1 >= 2 and nfft % n1 == 0
            and kernel_geometry(n1, ntap) is not None)


def pfb_dft1(
    voltages: torch.Tensor,
    coeffs: torch.Tensor,
    w1r: torch.Tensor,
    w1i: torch.Tensor,
    tr: torch.Tensor,
    ti: torch.Tensor,
    *,
    dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 ``(nchan, ntime, 2, 2)`` voltages → planar stage-1 spectra
    ``(ur, ui)``, each ``(nchan, 2, nframes, n1, nfft//n1)`` in ``dtype``.

    ``coeffs``: f32 ``(ntap, nfft)`` sign-folded window; ``w1r, w1i``:
    the ``n1``-point DFT matrix (:func:`blit_torch.ops.dft.dft_matrices`;
    the CUDA kernel reads only its row 1, as ``W[k, j] = W[1, k*j mod n1]``);
    ``tr, ti``: f32 ``(n1, nfft//n1)`` stage-1 twiddles.
    """
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    if voltages.device.type == "cpu":
        return pfb_dft1_plain(voltages, coeffs, w1r, w1i, tr, ti, dtype=dtype)
    if voltages.device.type != "cuda":
        raise ValueError(f"pfb_dft1: unsupported device {voltages.device}")
    return _pfb_dft1_cuda(voltages, coeffs, w1r, w1i, tr, ti, dtype)


pfb_dft1.launches = 0  # kernel launches (CUDA tensors only)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("pfb_dft1")
    if lib.pfb_dft1_launch.argtypes is None:
        lib.pfb_dft1_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.pfb_dft1_launch.restype = ctypes.c_int
        lib.pfb_dft1_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.pfb_dft1_smem_bytes.restype = ctypes.c_longlong
        # The layout this module plans for is the one the kernel uses.
        for args in ((128, 16, 4, 4, 1), (64, 16, 4, 4, 2), (192, 8, 2, 4, 1),
                     (6, 16, 1, 9, 2)):
            if lib.pfb_dft1_smem_bytes(*args) != _smem(*args):
                raise RuntimeError("csrc/pfb_dft1.cu's shared-memory layout "
                                   "disagrees with blit_torch/ops/pfb.py")
    return lib


def _pfb_dft1_cuda(voltages, coeffs, w1r, w1i, tr, ti, dtype):
    n1 = w1r.shape[0]
    nchan, nfft, ntap, nblk, nframes = _geometry(voltages, coeffs, n1)
    m = nfft // n1
    dev = voltages.device
    if voltages.dtype != torch.int8:
        raise ValueError("pfb_dft1: voltages must be int8")
    for name, t, shape in (("coeffs", coeffs, (ntap, nfft)),
                           ("w1r", w1r, (n1, n1)), ("w1i", w1i, (n1, n1)),
                           ("tr", tr, (n1, m)), ("ti", ti, (n1, m))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"pfb_dft1: {name} must be float32 {shape}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"pfb_dft1: {name} must be contiguous on {dev}")
    if not voltages.is_contiguous():
        raise ValueError("pfb_dft1: voltages must be contiguous")
    if not fits(nfft, n1, ntap=ntap):
        raise ValueError(
            f"pfb_dft1: the Hopper kernel takes an n1 >= 2 whose tile "
            f"({KERNEL_FRAMES} frames at most, {ntap} taps) fits in "
            f"{HOPPER_SMEM_MAX} bytes of shared memory (got n1={n1}, "
            f"nfft={nfft})")
    if voltages.data_ptr() % 4 or coeffs.data_ptr() % 4:
        raise ValueError("pfb_dft1: misaligned input")
    out_dtype = _DTYPES[dtype]
    ur = torch.empty((nchan, 2, nframes, n1, m), dtype=out_dtype, device=dev)
    ui = torch.empty_like(ur)
    if ur.numel() == 0:
        return ur, ui
    # 16-byte copies where every row of the voltages and of the window
    # starts on 16 bytes.
    vec = int(m % 4 == 0 and voltages.data_ptr() % 16 == 0
              and coeffs.data_ptr() % 16 == 0)
    geo = kernel_geometry(n1, ntap)
    plan = geo["plan"]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pfb_dft1_launch(
            voltages.data_ptr(), coeffs.data_ptr(), w1r[1].data_ptr(),
            w1i[1].data_ptr(), tr.data_ptr(), ti.data_ptr(), ur.data_ptr(),
            ui.data_ptr(), nchan, n1, m, ntap, nblk, nframes, _radices(plan),
            len(plan), geo["tc"], geo["fg"], geo["per_round"],
            geo["nstage"], vec, geo["smem"], int(dtype == "bfloat16"),
            stream)
    kernels.check(lib, rc, "pfb_dft1")
    pfb_dft1.launches += 1
    return ur, ui


def pfb_dft1_plain(
    voltages: torch.Tensor,
    coeffs: torch.Tensor,
    w1r: torch.Tensor,
    w1i: torch.Tensor,
    tr: torch.Tensor,
    ti: torch.Tensor,
    *,
    dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`pfb_dft1` (same contract), one coarse
    channel at a time to bound memory.  Rounds where the TPU kernel does:
    in bf16 mode the FIR sum and the DFT matrix go to bf16, the products
    sum in f32, the twiddle is f32 and the result is stored in bf16."""
    n1 = w1r.shape[0]
    nchan, nfft, ntap, nblk, nframes = _geometry(voltages, coeffs, n1)
    m = nfft // n1
    bf16 = dtype == "bfloat16"
    wr, wi = (round_bf16(w1r), round_bf16(w1i)) if bf16 else (w1r, w1i)
    w = coeffs.reshape(ntap, n1, m)
    out_dtype = _DTYPES[dtype]
    ur = torch.empty((nchan, 2, nframes, n1, m), dtype=out_dtype,
                     device=voltages.device)
    ui = torch.empty_like(ur)
    for c in range(nchan):
        # (nblk, n1, m, pol, re/im) → (pol, re/im, nblk, n1, m)
        x = voltages[c].reshape(nblk, n1, m, 2, 2).permute(3, 4, 0, 1, 2)
        x = x.to(torch.float32)
        fir = w[0] * x[:, :, 0:nframes]
        for k in range(1, ntap):
            fir = fir + w[k] * x[:, :, k:k + nframes]
        if bf16:
            fir = round_bf16(fir)
        fr, fi = fir[:, 0], fir[:, 1]  # (pol, nframes, n1, m)
        sr = torch.matmul(wr, fr) - torch.matmul(wi, fi)
        si = torch.matmul(wr, fi) + torch.matmul(wi, fr)
        ur[c] = (sr * tr - si * ti).to(out_dtype)
        ui[c] = (sr * ti + si * tr).to(out_dtype)
    return ur, ui


def _dequant_geometry(voltages: torch.Tensor, coeffs: torch.Tensor):
    if voltages.ndim != 4 or voltages.shape[2:] != (2, 2):
        raise ValueError("pfb_dequant: npol=2 complex int8 input required")
    nchan, ntime = voltages.shape[:2]
    ntap, nfft = coeffs.shape
    if ntime % nfft:
        raise ValueError(f"ntime={ntime} not a multiple of nfft={nfft}")
    nblk = ntime // nfft
    nframes = nblk - ntap + 1
    if nframes < 1:
        raise ValueError(f"pfb_dequant: need >= {ntap} blocks of {nfft}, got {nblk}")
    return nchan, nfft, ntap, nblk, nframes


def pfb_dequant(voltages: torch.Tensor, coeffs: torch.Tensor, *,
                dtype: str = "float32") -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 ``(nchan, ntime, 2, 2)`` voltages → planar PFB frames
    ``(fr, fi)``, each ``(nchan, 2, nframes, nfft)`` in ``dtype``:
    ``pfb_frontend`` of the dequantized voltages with the f32
    ``(ntap, nfft)`` sign-folded window ``coeffs``, tap sums in f32 and
    one rounding to ``dtype``."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    if voltages.device.type == "cpu":
        return pfb_dequant_plain(voltages, coeffs, dtype=dtype)
    if voltages.device.type != "cuda":
        raise ValueError(f"pfb_dequant: unsupported device {voltages.device}")
    return _pfb_dequant_cuda(voltages, coeffs, dtype)


pfb_dequant.launches = 0  # kernel launches (CUDA tensors only)


def _dequant_lib() -> ctypes.CDLL:
    lib = kernels.load("pfb_dequant")
    if lib.pfb_dequant_launch.argtypes is None:
        lib.pfb_dequant_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.pfb_dequant_launch.restype = ctypes.c_int
    return lib


def _pfb_dequant_cuda(voltages, coeffs, dtype):
    nchan, nfft, ntap, nblk, nframes = _dequant_geometry(voltages, coeffs)
    dev = voltages.device
    if voltages.dtype != torch.int8 or not voltages.is_contiguous():
        raise ValueError("pfb_dequant: voltages must be contiguous int8")
    if (coeffs.dtype != torch.float32 or coeffs.device != dev
            or not coeffs.is_contiguous()):
        raise ValueError(f"pfb_dequant: coeffs must be contiguous float32 on {dev}")
    if voltages.data_ptr() % 4:
        raise ValueError("pfb_dequant: misaligned input")
    fr = torch.empty((nchan, 2, nframes, nfft), dtype=_DTYPES[dtype], device=dev)
    fi = torch.empty_like(fr)
    lib = _dequant_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pfb_dequant_launch(
            voltages.data_ptr(), coeffs.data_ptr(), fr.data_ptr(),
            fi.data_ptr(), nchan, nfft, nblk, nframes, ntap,
            int(dtype == "bfloat16"), stream)
    kernels.check(lib, rc, "pfb_dequant")
    pfb_dequant.launches += 1
    return fr, fi


def pfb_dequant_plain(voltages: torch.Tensor, coeffs: torch.Tensor, *,
                      dtype: str = "float32"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`pfb_dequant` (same contract), one
    coarse channel at a time: dequantize, the f32 FIR, one cast."""
    nchan, nfft, ntap, nblk, nframes = _dequant_geometry(voltages, coeffs)
    w = coeffs.to(torch.float32)
    fr = torch.empty((nchan, 2, nframes, nfft), dtype=_DTYPES[dtype],
                     device=voltages.device)
    fi = torch.empty_like(fr)
    for c in range(nchan):
        # (nblk, nfft, pol, re/im) → (re/im, pol, nblk, nfft)
        x = voltages[c].reshape(nblk, nfft, 2, 2).permute(3, 2, 0, 1)
        x = x.to(torch.float32)
        acc = w[0] * x[:, :, 0:nframes]
        for k in range(1, ntap):
            acc = acc + w[k] * x[:, :, k:k + nframes]
        fr[c] = acc[0]
        fi[c] = acc[1]
    return fr, fi
