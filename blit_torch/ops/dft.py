"""Planar (real/imag) DFT: the matrices, twiddles and factor policy the
channelizer's kernels are defined in, the DFT-level kernels and the
multi-level DFT built from them.

Counterpart of ``blit/ops/dft.py`` and of ``blit/ops/pallas_dft.py``'s
``dft_stage``, ``dft_last`` and ``dft_tail2``.  The matrices are built in
float64 with numpy and then cast, exactly as there, so they are bitwise
equal to ``blit``'s: the PFB window and these matrices are this system's
weights.

On a CUDA tensor :func:`dft_last` and :func:`dft_stage` launch the
hand-written Hopper kernels of ``blit_torch/csrc/dft.cu``, and
:func:`dft_tail2` (``pallas_dft.py``'s fused last two levels) that of
``blit_torch/csrc/dft_tail2.cu``; on a CPU tensor they run their plain
twins (:func:`dft_last_plain`, :func:`dft_stage_plain`,
:func:`dft_tail2_plain`: f32 ``torch.matmul`` with the four real
products).  All three compute their DFTs as FFTs in shared memory,
reading only row 1 of the DFT matrices (the table of roots, ``W[j, k]
== W[1, (j·k) mod n]``), over the radix plans of :func:`fft_plan`;
``dft_stage`` keeps the dense product for the shapes whose column tiles
do not fit or where it timed faster, such as a large prime factor of n
(:func:`dft_stage_design`).  :func:`dft`
and :func:`dft_tail` walk the Cooley-Tukey levels with them
(``use_pallas=True``, ``blit``'s name for its kernel route) or with the
twins, in natural order or in the twisted (digit-permuted) order that
:func:`untwist` restores.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from blit_torch import kernels

# Largest DFT applied as a single matmul; larger sizes decompose.
DIRECT_DFT_MAX = 4096

# The planar complex convention: a complex array is a (re, im) pair of
# equal-shape real tensors.
Planar = Tuple[torch.Tensor, torch.Tensor]
# A planar entry point's input: one complex tensor or a planar pair.
ComplexOrPlanar = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def as_planar(x) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Normalize a complex tensor or a planar pair to ``(re, im,
    was_complex)``, as ``blit.ops.dft.as_planar``: a pair passes through,
    a complex tensor splits into contiguous planes, a real tensor gets a
    zero imaginary plane.  numpy arrays are taken as tensors."""
    if isinstance(x, (tuple, list)):
        xr, xi = x
        return torch.as_tensor(xr), torch.as_tensor(xi), False
    x = torch.as_tensor(x)
    if x.is_complex():
        return x.real.contiguous(), x.imag.contiguous(), True
    return x, torch.zeros_like(x), False


@functools.lru_cache(maxsize=32)
def dft_matrices(n: int, dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """(Wr, Wi): the n-point DFT matrix ``W[k, j] = exp(-2πi k j / n)``
    (symmetric).  Entries depend only on ``(k·j) mod n``."""
    k = np.arange(n).reshape(n, 1).astype(np.float64)
    j = np.arange(n).reshape(1, n).astype(np.float64)
    ang = -2.0 * np.pi * ((k * j) % n) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=32)
def twiddles(n1: int, n2: int, dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """(Tr, Ti): four-step twiddles ``exp(-2πi k1 j2 / (n1 n2))`` shaped
    (n1, n2) — k1 indexes stage-1 output rows, j2 the columns."""
    n = n1 * n2
    k1 = np.arange(n1).reshape(n1, 1).astype(np.float64)
    j2 = np.arange(n2).reshape(1, n2).astype(np.float64)
    ang = -2.0 * np.pi * ((k1 * j2) % n) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def default_factors(n: int) -> Tuple[int, ...]:
    """Factorization policy: peel factors of 128 while the remainder
    exceeds DIRECT_DFT_MAX, so 2^20 → (128, 128, 64).  Non-powers of two
    take an as-square-as-possible two-factor split."""
    if n <= DIRECT_DFT_MAX:
        return (n,)
    if n & (n - 1) == 0:
        factors = []
        while n > DIRECT_DFT_MAX:
            f = min(128, n)
            factors.append(f)
            n //= f
        factors.append(n)
        return tuple(factors)
    n1 = int(math.isqrt(n))
    while n % n1:
        n1 -= 1
    if n1 == 1 or max(n1, n // n1) > DIRECT_DFT_MAX:
        raise NotImplementedError(f"dft: no supported factorization for n={n}")
    return (n1, n // n1)


def as_tensors(arrays, device) -> Tuple[torch.Tensor, ...]:
    """numpy constants → float32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


# The DFT matrices and twiddles on each device, uploaded once: a copy
# from pageable numpy memory stalls the dispatching thread, so constants
# must not be sent again with every call.  Callers never write to them.
@functools.lru_cache(maxsize=32)
def dft_matrices_on(n: int, device: torch.device) -> Planar:
    """:func:`dft_matrices` ``(n)`` as f32 tensors on ``device``."""
    return as_tensors(dft_matrices(n), device)


@functools.lru_cache(maxsize=32)
def twiddles_on(n1: int, n2: int, device: torch.device) -> Planar:
    """:func:`twiddles` ``(n1, n2)`` as f32 tensors on ``device``."""
    return as_tensors(twiddles(n1, n2), device)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 precision, keeping the f32 dtype — the
    operand rounding a bf16 dot with f32 accumulation applies."""
    return x.to(torch.bfloat16).to(torch.float32)


def _planar_check(name: str, xr: torch.Tensor, xi: torch.Tensor):
    if xr.dtype not in (torch.float32, torch.bfloat16) or xi.dtype != xr.dtype:
        raise ValueError(f"{name}: xr/xi must both be float32 or bfloat16")
    if xi.shape != xr.shape or xi.device != xr.device:
        raise ValueError(f"{name}: xr/xi shape or device mismatch")
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError(f"{name}: xr/xi must be contiguous")
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError(f"{name}: misaligned input")


def _f32_check(name: str, dev, **tensors):
    for what, (t, shape) in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be float32 {shape}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on {dev}")


def _lib() -> ctypes.CDLL:
    lib = kernels.load("dft")
    if lib.dft_last_launch.argtypes is None:
        lib.dft_last_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_void_p])
        lib.dft_last_launch.restype = ctypes.c_int
        lib.dft_stage_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_void_p])
        lib.dft_stage_launch.restype = ctypes.c_int
    return lib


# Shared memory a block may take on an H100 or H200 (227 KB, opt-in).
SMEM_MAX = 232448


@functools.lru_cache(maxsize=None)
def fft_plan(n: int) -> Tuple[int, ...]:
    """The radices of the shared-memory FFT of n points, in pass order
    (their product is n): the power of two 2^k in ceil(k/4) passes of
    radix 16, 8, 4 or 2 as even as can be, largest first; then 3, 5 and
    7 once per factor; then every other prime factor as one dense pass."""
    if n < 2:
        raise ValueError(f"fft_plan: n={n} < 2")
    k = (n & -n).bit_length() - 1
    m = n >> k
    radices = []
    if k:
        npass = -(-k // 4)
        base, extra = divmod(k, npass)
        radices = [1 << (base + (i < extra)) for i in range(npass)]
    for p in (3, 5, 7):
        while m % p == 0:
            radices.append(p)
            m //= p
    f = 11
    while m > 1:
        while m % f == 0:
            radices.append(f)
            m //= f
        f += 2
    return tuple(radices)


# Values of a row group of dft_last's FFT kernel: csrc/dft.cu FE.
_LAST_GROUP = 4096
# dft_last at n = 8: the row kernel ("rows") or the FFT ("fft"), the one
# chip_smoke.py (c) times faster on the 0001 chunk (PERF.md §6).
_N8_DESIGN = "rows"


def dft_last_design(n: int) -> str:
    """The design :func:`dft_last` launches for n points: ``"rows"``
    (csrc/dft.cu's row kernel) at n = 8, where the smoke timed it
    against the FFT; else ``"fft"`` for 2 <= n <= DIRECT_DFT_MAX; the
    tiled GEMM (``"tiled"``) for n = 1."""
    if n == 8:
        return _N8_DESIGN
    return "fft" if 2 <= n <= DIRECT_DFT_MAX else "tiled"


def _padded(e: int) -> int:
    return (max(e + e // 32 + 1, e + 8) + 7) & ~7


def last_fft_geometry(n: int, esize: int) -> Tuple[int, int, int]:
    """``(rows a group, stage buffers, shared-memory bytes)`` of
    dft_last's FFT kernel for n points of ``esize``-byte input, the
    layout ``csrc/dft.cu`` ``last_fft_smem`` checks: groups of up to 4096
    values, two stage buffers where they fit in :data:`SMEM_MAX`."""
    rows = max(1, _LAST_GROUP // n)
    e = rows * n
    pe = _padded(e)
    se = pe if esize == 4 else (e + 16 + 7) & ~7
    we = 0 if esize == 4 else pe
    n4 = (n + 3) & ~3

    def smem(nstage):  # the root and pass tables, stages, work
        return 4 * n4 * 4 + nstage * 2 * se * esize + 2 * we * 4

    nstage = 2 if smem(2) <= SMEM_MAX else 1
    return rows, nstage, smem(nstage)


def _radices(plan) -> ctypes.Array:
    return (ctypes.c_int * len(plan))(*plan)


def dft_last(xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor,
             wi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar DFT along the last axis, the recursion's base case:
    ``o[..., k] = Σ_j x[..., j] · W[j, k]``.  ``xr, xi``: f32 or bf16
    ``(..., n)``; ``wr, wi``: the f32 ``(n, n)`` DFT matrix (the kernel
    reads its row 1).  Returns f32."""
    if xr.device.type == "cpu":
        return dft_last_plain(xr, xi, wr, wi)
    if xr.device.type != "cuda":
        raise ValueError(f"dft_last: unsupported device {xr.device}")
    out = dft_last_cuda(xr, xi, wr, wi)
    if xr.numel():
        kernels.count_launch(dft_last)
    return out


dft_last.launches = 0  # kernel launches (CUDA tensors only)

_DESIGNS = {"fft": 0, "tiled": 1, "rows": 2}


def dft_last_cuda(xr, xi, wr, wi, *, tiled: bool = False,
                  design: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/dft.cu``'s ``dft_last`` on CUDA tensors, uncounted:
    the design :func:`dft_last_design` picks, or ``design`` (``"fft"``,
    ``"rows"`` at n = 8, ``"tiled"``).  ``tiled=True`` runs the dense
    tiled GEMM (the first port's design) at any n, to time it beside the
    FFT."""
    n = xr.shape[-1]
    _planar_check("dft_last", xr, xi)
    _f32_check("dft_last", xr.device, wr=(wr, (n, n)), wi=(wi, (n, n)))
    if n > DIRECT_DFT_MAX:
        raise ValueError(f"dft_last: n={n} > DIRECT_DFT_MAX={DIRECT_DFT_MAX}")
    design = "tiled" if tiled else design or dft_last_design(n)
    if design not in _DESIGNS or (design == "rows" and n != 8) or (
            design == "fft" and n < 2):
        raise ValueError(f"dft_last: no design {design!r} at n={n}")
    or_ = torch.empty(xr.shape, dtype=torch.float32, device=xr.device)
    oi = torch.empty_like(or_)
    rows = xr.numel() // n if n else 0
    if rows == 0:
        return or_, oi
    plan = fft_plan(n) if design == "fft" else (n,)
    group, nstage, smem = last_fft_geometry(n, xr.element_size())
    lib = _lib()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.dft_last_launch(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            or_.data_ptr(), oi.data_ptr(), rows, n,
            int(xr.dtype == torch.bfloat16), _DESIGNS[design],
            _radices(plan), len(plan), group, nstage, smem, stream)
    kernels.check(lib, rc, "dft_last")
    return or_, oi


def dft_last_plain(xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor,
                   wi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`dft_last`: the four f32 products
    ``rr, ii, ri, ir`` and the combines ``rr - ii``, ``ri + ir``."""
    xr, xi = xr.to(torch.float32), xi.to(torch.float32)
    return xr @ wr - xi @ wi, xi @ wr + xr @ wi


# Values one round of dft_stage's column FFT holds (csrc/dft.cu SE).
_STAGE_ROUND = 4096


def _stage_tc(n: int, m: int) -> int:
    """Columns of a dft_stage FFT tile: where a round holds 32 or more
    columns of n points, the multiple of 32 (up to a round) that pads m
    least, the largest of those; else 16 or 8."""
    cap = _STAGE_ROUND // n
    if cap < 32:
        return 16 if cap >= 16 else 8
    best = None
    for tc in range(32, min(cap, -(-m // 32) * 32) + 1, 32):
        cost = -(-m // tc) * tc
        if best is None or cost <= best[0]:
            best = (cost, tc)
    return best[1]


def stage_fft_geometry(n: int, m: int, esize: int) -> Optional[dict]:
    """How dft_stage's column FFT runs (n, m) panels of ``esize``-byte
    input: the radix plan, the tile width ``tc`` (a tile is n rows x tc
    columns of a panel, the last one of a panel ragged), the columns a
    round of passes takes (``per_round``), the stage buffers (two where
    they fit in :data:`SMEM_MAX`) and the shared-memory bytes, the layout
    ``csrc/dft.cu`` ``stage_fft_smem`` checks.  None where no layout
    fits (or n < 2)."""
    if not 2 <= n <= DIRECT_DFT_MAX:
        return None
    tc = _stage_tc(n, m)
    ss = tc + 16 // esize
    ws = ss if esize == 4 else tc + 4
    n4 = (n + 3) & ~3
    for nstage in (2, 1):
        smem = (8 * n4 + nstage * 2 * n * ss * esize
                + (0 if esize == 4 else 2 * n * ws * 4))
        if smem <= SMEM_MAX:
            return dict(plan=fft_plan(n), tc=tc,
                        per_round=min(tc, max(1, _STAGE_ROUND // n)),
                        nstage=nstage, smem=smem)
    return None


# n where chip_smoke.py's design sweep timed the tiled GEMM faster than
# the column FFT although the FFT has no dense pass: 48 = 16·3, whose
# radix-16 pass keeps 96 of a block's threads busy (PERF.md §6, PR 7).
_STAGE_TILED_N = frozenset({48})


def dft_stage_design(n: int, m: int) -> str:
    """The design :func:`dft_stage` launches for (n, m) panels, by shape
    alone: ``"fft"`` (csrc/dft.cu's column FFT) where its tiles fit in
    shared memory for f32 and bf16 input alike and it timed faster, else
    ``"tiled"`` (the dense tiled GEMM).  The GEMM keeps n = 1, n above
    1383 (a bf16 tile of 8 columns no longer fits), every n whose plan
    has a dense pass of a prime p > 7 with n < 8p (that pass multiplies
    p times an output in shared memory, where the GEMM's register tiles
    multiply n times; the sweep timed a multiply of the dense pass about
    5 times slower and the two designs even near n = 8p), and
    :data:`_STAGE_TILED_N`."""
    if not all(stage_fft_geometry(n, m, e) for e in (4, 2)):
        return "tiled"
    dense = max((r for r in fft_plan(n) if r > 7 and r % 2), default=0)
    if n < 8 * dense or n in _STAGE_TILED_N:
        return "tiled"
    return "fft"


def dft_stage(xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor,
              wi: torch.Tensor, tr: Optional[torch.Tensor] = None,
              ti: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One planar DFT stage down axis -2 of ``(..., n, m)`` panels:
    ``o[b, k, j] = tw[k, j] · Σ_l W[k, l] · x[b, l, j]`` with the optional
    f32 ``(n, m)`` twiddle ``tr, ti``.  ``xr, xi``: f32 or bf16; ``wr, wi``:
    the f32 ``(n, n)`` DFT matrix (the column FFT reads its row 1).
    Returns f32."""
    if (tr is None) != (ti is None):
        raise ValueError("dft_stage: pass both twiddle parts or neither")
    if xr.device.type == "cpu":
        return dft_stage_plain(xr, xi, wr, wi, tr, ti)
    if xr.device.type != "cuda":
        raise ValueError(f"dft_stage: unsupported device {xr.device}")
    out = dft_stage_cuda(xr, xi, wr, wi, tr, ti)
    if xr.numel():
        kernels.count_launch(dft_stage)
    return out


def dft_stage_cuda(xr, xi, wr, wi, tr=None, ti=None, *, tiled: bool = False,
                   design: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/dft.cu``'s ``dft_stage`` on CUDA tensors, uncounted:
    the design :func:`dft_stage_design` picks, or ``design`` (``"fft"``
    where its tiles fit, ``"tiled"``).  ``tiled=True`` runs the dense
    tiled GEMM (the first port's design) at any shape, to time it beside
    the FFT."""
    if xr.ndim < 2:
        raise ValueError("dft_stage: (..., n, m) panels required")
    n, m = xr.shape[-2], xr.shape[-1]
    _planar_check("dft_stage", xr, xi)
    mats = dict(wr=(wr, (n, n)), wi=(wi, (n, n)))
    if tr is not None:
        mats.update(tr=(tr, (n, m)), ti=(ti, (n, m)))
    _f32_check("dft_stage", xr.device, **mats)
    if n > DIRECT_DFT_MAX:
        raise ValueError(f"dft_stage: n={n} > DIRECT_DFT_MAX={DIRECT_DFT_MAX}")
    or_ = torch.empty(xr.shape, dtype=torch.float32, device=xr.device)
    oi = torch.empty_like(or_)
    panels = xr.numel() // (n * m) if n * m else 0
    if panels == 0:
        return or_, oi
    design = "tiled" if tiled else design or dft_stage_design(n, m)
    geo = (stage_fft_geometry(n, m, xr.element_size()) if design == "fft"
           else dict(plan=(n,), tc=0, per_round=0, nstage=0, smem=0))
    if design not in ("fft", "tiled") or geo is None:
        raise ValueError(f"dft_stage: no design {design!r} at (n, m) = ({n}, {m})")
    lib = _lib()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.dft_stage_launch(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            None if tr is None else tr.data_ptr(),
            None if ti is None else ti.data_ptr(),
            or_.data_ptr(), oi.data_ptr(), panels, n, m,
            int(xr.dtype == torch.bfloat16), _DESIGNS[design],
            _radices(geo["plan"]), len(geo["plan"]), geo["tc"],
            geo["per_round"], geo["nstage"], geo["smem"], stream)
    kernels.check(lib, rc, "dft_stage")
    return or_, oi


dft_stage.launches = 0  # kernel launches (CUDA tensors only)


def dft_stage_plain(xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor,
                    wi: torch.Tensor, tr: Optional[torch.Tensor] = None,
                    ti: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`dft_stage`: four f32 matmuls, the
    combines, then the twiddle."""
    xr, xi = xr.to(torch.float32), xi.to(torch.float32)
    sr = torch.matmul(wr, xr) - torch.matmul(wi, xi)
    si = torch.matmul(wr, xi) + torch.matmul(wi, xr)
    if tr is None:
        return sr, si
    return sr * tr - si * ti, sr * ti + si * tr


# dft_tail2's Hopper kernel: f2 and f3 powers of two in these ranges
# (f3 as blit's VMEM gate takes it at f2 = 128: up to 512, not 2^24's
# 1024); panels of up to 16384 values in one launch, larger ones in two
# through a scratch panel, tiles of 8192 values (csrc/dft_tail2.cu NT·MAXV).
TAIL2_F2 = (8, 1024)
TAIL2_F3 = (32, 512)
TAIL2_ONE_PASS = 16384
_TAIL2_TILE = 8192


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def tail2_fits(f2: int, f3: int) -> bool:
    """Hopper fit gate of :func:`dft_tail2`'s kernel: f2 and f3 powers of
    two, 8 <= f2 <= 1024 and 32 <= f3 <= 512.  The three-factor sizes it
    takes are 2^20 to 2^23 (f3 64 to 512), the ones ``blit``'s VMEM gate
    passes."""
    return (_pow2(f2) and _pow2(f3) and TAIL2_F2[0] <= f2 <= TAIL2_F2[1]
            and TAIL2_F3[0] <= f3 <= TAIL2_F3[1])


def _tail2_smem(mode, f2, f3, tr, tc, nstage, esize) -> int:
    """csrc/dft_tail2.cu ``tail2_smem``: mode 0 both levels on whole
    panels, 1 the column level, 2 the row level."""
    ss, ws = tc + 16 // esize, tc + 4
    work = 0 if esize == 4 else 2 * tr * ws * 4
    # Whole f32 panels larger than a round stage their twiddle a round
    # (two planes of _TAIL2_TILE floats) at a time.
    twiddle = (2 * _TAIL2_TILE * 4 if mode == 0 and esize == 4
               and f2 * f3 > _TAIL2_TILE else 0)
    return 2 * (f2 + f3) * 4 + nstage * 2 * tr * ss * esize + work + twiddle


def tail2_geometry(f2: int, f3: int, esize: int) -> dict:
    """How :func:`dft_tail2`'s kernel runs (f2, f3) on ``esize``-byte
    input: the radix plans of both levels, the column tile width ``ct``
    and row tile height ``rt`` (``ct == f3`` and ``rt == f2``: one launch
    over whole panels; else the column level on (f2, ct) tiles to a
    scratch panel, then the row level on (rt, f3) tiles), and each
    launch's stage buffers and shared-memory bytes (two buffers where
    they fit in :data:`SMEM_MAX`), the layout ``csrc/dft_tail2.cu``
    checks.  Raises where the layout does not fit."""
    if not tail2_fits(f2, f3):
        raise ValueError(f"dft_tail2: no Hopper geometry for ({f2}, {f3})")

    def stages(mode, tr, tc, es):
        for nstage in (2, 1):
            smem = _tail2_smem(mode, f2, f3, tr, tc, nstage, es)
            if smem <= SMEM_MAX:
                return nstage, smem
        return None

    one = stages(0, f2, f3, esize) if f2 * f3 <= TAIL2_ONE_PASS else None
    if one is not None:
        ct, rt, a, b = f3, f2, one, one
    else:
        ct, rt = min(f3, _TAIL2_TILE // f2), min(f2, _TAIL2_TILE // f3)
        a, b = stages(1, f2, ct, esize), stages(2, rt, f3, 4)
        if a is None or b is None:
            raise ValueError(f"dft_tail2: ({f2}, {f3}) tiles do not fit")
    return dict(plans=(fft_plan(f2), fft_plan(f3)), ct=ct, rt=rt,
                launches=1 if one is not None else 2,
                nstage=(a[0], b[0]), smem=(a[1], b[1]))


def _tail2_lib() -> ctypes.CDLL:
    lib = kernels.load("dft_tail2")
    if lib.dft_tail2_launch.argtypes is None:
        ip = ctypes.POINTER(ctypes.c_int)
        lib.dft_tail2_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ip, ctypes.c_int, ip] + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_void_p])
        lib.dft_tail2_launch.restype = ctypes.c_int
        lib.dft_tail2_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.dft_tail2_smem_bytes.restype = ctypes.c_longlong
        # The layout this module plans for is the one the kernel uses.
        for args in ((0, 128, 128, 128, 128, 1, 4), (0, 128, 64, 128, 64, 2, 2),
                     (1, 128, 512, 128, 64, 2, 4), (2, 128, 512, 16, 512, 2, 4)):
            if lib.dft_tail2_smem_bytes(*args) != _tail2_smem(*args):
                raise RuntimeError("csrc/dft_tail2.cu's shared-memory "
                                   "layout disagrees with ops/dft.py")
    return lib


def dft_tail2(xr: torch.Tensor, xi: torch.Tensor, f2: int, f3: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last two levels of a three-factor DFT and the inner untwist,
    as ``blit``'s ``dft_tail2``: stage-1 rows ``(..., f2·f3)`` (f32 or
    bf16, as :func:`blit_torch.ops.pfb.pfb_dft1` emits them) → f32
    ``(..., f2·f3)`` natural-order sub-spectra, index ``k2 + f2·k3``.
    The caller's remaining work is the level-0 swap."""
    m = xr.shape[-1]
    if m != f2 * f3:
        raise ValueError(f"dft_tail2: last axis {m} != {f2}*{f3}")
    if xr.device.type == "cpu":
        return dft_tail2_plain(xr, xi, f2, f3)
    if xr.device.type != "cuda":
        raise ValueError(f"dft_tail2: unsupported device {xr.device}")
    _planar_check("dft_tail2", xr, xi)
    if not tail2_fits(f2, f3):
        raise ValueError(
            f"dft_tail2: the Hopper kernel takes f2 and f3 powers of two, "
            f"f2 in {TAIL2_F2} and f3 in {TAIL2_F3} (got {f2}, {f3})")
    geo = tail2_geometry(f2, f3, xr.element_size())
    dev = xr.device
    w2r, w2i = dft_matrices_on(f2, dev)
    w3r, w3i = dft_matrices_on(f3, dev)
    tr, ti = twiddles_on(f2, f3, dev)
    or_ = torch.empty(xr.shape, dtype=torch.float32, device=dev)
    oi = torch.empty_like(or_)
    panels = xr.numel() // m
    if panels == 0:
        return or_, oi
    scratch = ((torch.empty_like(or_), torch.empty_like(or_))
               if geo["launches"] == 2 else (None, None))
    p2, p3 = geo["plans"]
    lib = _tail2_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dft_tail2_launch(
            xr.data_ptr(), xi.data_ptr(), w2r[1].data_ptr(), w2i[1].data_ptr(),
            w3r[1].data_ptr(), w3i[1].data_ptr(), tr.data_ptr(), ti.data_ptr(),
            or_.data_ptr(), oi.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch),
            panels, f2, f3, _radices(p2), len(p2), _radices(p3), len(p3),
            geo["ct"], geo["rt"], geo["nstage"][0], geo["smem"][0],
            geo["nstage"][1], geo["smem"][1],
            int(xr.dtype == torch.bfloat16), stream)
    kernels.check(lib, rc, "dft_tail2")
    kernels.count_launch(dft_tail2)
    return or_, oi


dft_tail2.launches = 0  # kernel launches (CUDA tensors only)


def dft_tail2_plain(xr: torch.Tensor, xi: torch.Tensor, f2: int, f3: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`dft_tail2`: the f2-point stage with
    the twiddle (:func:`dft_stage_plain`), the f3-point stage along the
    rows (:func:`dft_last_plain`), then the ``(k2, k3) → (k3, k2)`` swap."""
    m = xr.shape[-1]
    if m != f2 * f3:
        raise ValueError(f"dft_tail2: last axis {m} != {f2}*{f3}")
    batch = xr.shape[:-1]
    dev = xr.device
    w2 = dft_matrices_on(f2, dev)
    tw = twiddles_on(f2, f3, dev)
    ur, ui = dft_stage_plain(xr.reshape(batch + (f2, f3)),
                             xi.reshape(batch + (f2, f3)), *w2, *tw)
    vr, vi = dft_last_plain(ur, ui, *dft_matrices_on(f3, dev))
    del ur, ui
    return (vr.transpose(-1, -2).reshape(batch + (m,)),
            vi.transpose(-1, -2).reshape(batch + (m,)))


def _stage_bf16(xr, xi, wr, wi, tr, ti):
    """The bf16 rounding points of ``blit``'s fused tail kernels: bf16
    matrix, f32 sums and twiddle, the twiddled result rounded to bf16."""
    ur, ui = dft_stage_plain(xr, xi, round_bf16(wr), round_bf16(wi), tr, ti)
    return round_bf16(ur), round_bf16(ui)


def _last_bf16(xr, xi, wr, wi):
    return dft_last_plain(xr, xi, round_bf16(wr), round_bf16(wi))


# (stage, last) per route of the Cooley-Tukey walk.
_LEVELS = {
    "kernels": (dft_stage, dft_last),
    "plain": (dft_stage_plain, dft_last_plain),
    "bf16": (_stage_bf16, _last_bf16),
}


def untwist(x: torch.Tensor, factors: Tuple[int, ...]) -> torch.Tensor:
    """Restore natural frequency order after ``order="twisted"``: the
    twisted layout enumerates the digits ``(k1, k2, ..., klast)`` row-major
    along the last axis, the natural index is ``k1 + f1·k2 + f1·f2·k3 +
    ...``, so the untwist is a reshape, a reversal of the digit axes and a
    reshape (one copy)."""
    if len(factors) == 1:
        return x
    batch = tuple(x.shape[:-1])
    nb = len(batch)
    y = x.reshape(batch + tuple(factors))
    perm = tuple(range(nb)) + tuple(reversed(range(nb, nb + len(factors))))
    return y.permute(perm).reshape(batch + (int(np.prod(factors)),))


def _check_order(order: str) -> bool:
    if order not in ("natural", "twisted"):
        raise ValueError(f"order must be 'natural' or 'twisted', got {order!r}")
    return order == "twisted"


def _dft_rec(xr, xi, factors, route: str, twisted: bool = False):
    """Planar DFT along the last axis over ``factors``: an ``n1``-point
    stage (+ twiddle) down the columns of the ``(n1, n2)`` view, the rest
    along the rows, then the ``(k1, k2) → (k2, k1)`` swap — which
    ``twisted`` skips at every level, leaving the digits row-major."""
    stage, last = _LEVELS[route]
    n = xr.shape[-1]
    dev = xr.device
    if len(factors) == 1:
        wr, wi = dft_matrices_on(n, dev)
        return last(xr, xi, wr, wi)
    n1 = factors[0]
    n2 = n // n1
    batch = xr.shape[:-1]
    wr, wi = dft_matrices_on(n1, dev)
    tr, ti = twiddles_on(n1, n2, dev)
    ur, ui = stage(xr.reshape(batch + (n1, n2)), xi.reshape(batch + (n1, n2)),
                   wr, wi, tr, ti)
    vr, vi = _dft_rec(ur, ui, factors[1:], route, twisted)
    del ur, ui
    if twisted:
        return vr.reshape(batch + (n,)), vi.reshape(batch + (n,))
    # Output index k = k1 + n1*k2: (k1, k2) → (k2, k1), then flatten.
    vr = vr.transpose(-1, -2).reshape(batch + (n,))
    vi = vi.transpose(-1, -2).reshape(batch + (n,))
    return vr, vi


def _check_factors(factors, n: int) -> Tuple[int, ...]:
    factors = tuple(int(f) for f in factors)
    if int(np.prod(factors)) != n:
        raise ValueError(f"dft: factors {factors} do not multiply to {n}")
    if max(factors) > DIRECT_DFT_MAX:
        raise NotImplementedError(f"dft: factor {max(factors)} > {DIRECT_DFT_MAX}")
    return factors


def dft(xr: torch.Tensor, xi: torch.Tensor, *,
        factors: Optional[Tuple[int, ...]] = None, use_pallas: bool = False,
        order: str = "natural") -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar DFT along the last axis (matches ``np.fft.fft`` in natural
    order), f32 out; counterpart of ``blit.ops.dft.dft``.

    ``factors``: the Cooley-Tukey split (each <= DIRECT_DFT_MAX, product
    n); None → :func:`default_factors`.  ``use_pallas=True`` runs each
    level through the kernels (:func:`dft_stage` with the twiddle, then
    :func:`dft_last`); False through their plain twins.  ``order=
    "twisted"`` skips every level's swap and emits the digit-permuted
    layout :func:`untwist` restores; the levels compute the same values
    either way, so ``untwist(dft(x, order="twisted"), factors)`` equals
    ``dft(x)`` bitwise.
    """
    n = xr.shape[-1]
    twisted = _check_order(order)
    factors = _check_factors(default_factors(n) if factors is None
                             else factors, n)
    return _dft_rec(xr, xi, factors, "kernels" if use_pallas else "plain",
                    twisted)


def dft_tail(ur: torch.Tensor, ui: torch.Tensor, factors: Tuple[int, ...],
             *, bf16: bool = False, use_pallas: bool = False,
             order: str = "natural") -> Tuple[torch.Tensor, torch.Tensor]:
    """Finish a DFT whose first stage (``n1``-point matmul + twiddle) was
    computed already, as by :func:`blit_torch.ops.pfb.pfb_dft1`: run
    ``factors[1:]`` along the last axis and assemble natural order.

    ``ur, ui``: f32 or bf16 ``(..., n1, m)``.  Returns f32 ``(..., n1*m)``.
    ``use_pallas=True`` walks the levels with :func:`dft_stage` and ends
    with :func:`dft_last`; False with their plain twins.  ``bf16=True``
    (plain route only) applies the bf16 operand rounding of the fused
    tail kernel (matrices and post-twiddle intermediates rounded, sums
    f32); the input is taken as already rounded.  ``order="twisted"``
    skips every swap, the final one included: the layout of
    :func:`dft` ``(order="twisted")`` over ``factors``.
    """
    n1, m = ur.shape[-2], ur.shape[-1]
    twisted = _check_order(order)
    if factors[0] != n1 or int(np.prod(factors[1:])) != m:
        raise ValueError(f"dft_tail: factors {factors} mismatch ({n1}, {m})")
    if bf16 and use_pallas:
        raise ValueError("dft_tail: the bf16 rounding points are the plain "
                         "route's; the kernels sum bf16 input in f32")
    route = "kernels" if use_pallas else "bf16" if bf16 else "plain"
    batch = ur.shape[:-2]
    vr, vi = _dft_rec(ur, ui, _check_factors(factors[1:], m), route, twisted)
    if twisted:
        return vr.reshape(batch + (n1 * m,)), vi.reshape(batch + (n1 * m,))
    vr = vr.transpose(-1, -2).reshape(batch + (n1 * m,))
    vi = vi.transpose(-1, -2).reshape(batch + (n1 * m,))
    return vr, vi


def dft_np(xr: np.ndarray, xi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy golden reference (tests)."""
    z = np.fft.fft(xr + 1j * xi)
    return z.real, z.imag
