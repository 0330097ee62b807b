"""Taylor-tree dedoppler: the drift-rate transform and on-device hit
extraction.

Counterpart of ``blit/ops/pallas_dedoppler.py``, with its conventions:

- input is ``(T, F)`` float32 power, T a power of two in 2..1024,
  time-major;
- output row ``d`` of :func:`taylor_tree` sums the tree's drift-``d``
  path anchored at t = 0, ``out[d, f] = Σ_t x[t, f + shift(d, t)]``
  (:func:`tree_path_shift`); positive drift moves toward higher channel
  index, and the negative drifts are the same tree over the
  frequency-reversed band (:func:`drift_spectra`);
- paths that run off the band edge read zeros.

On a CUDA tensor :func:`taylor_tree` and :func:`drift_spectra` launch the
hand-written Hopper kernel ``blit_torch/csrc/taylor_tree.cu`` (both signs
in each launch; :func:`kernel_route` states the launches); on a CPU tensor
they run the plain version :func:`taylor_tree_plain`.  All of them do the same single f32 add per
element per stage in the same order as ``blit``'s reference, so the three
agree bitwise.  The rest of :func:`dedoppler_hits` (SNR, threshold,
per-band top-k, packing) is torch ops, as ``blit`` leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from blit_torch import kernels

# The stages are unrolled per window in blit; the same bound holds here.
MAX_WINDOW = 1024

# Encoded hit-table columns (:func:`dedoppler_hits` packed output):
# [snr_bits(f32), power_bits(f32), drift_bins(i32), chan(i32)].
HIT_PACK_COLS = 4

# csrc/taylor_tree.cu runs up to 2^3 rows as one subtree in registers,
# up to 2^6 through one shared-memory tile, and each further three stages
# as one global pass; :func:`kernel_route` states the routes that follow.
KERNEL_REG_LOG = 3
KERNEL_SMEM_LOG = 6


def tree_path_shift(d: int, t: int, T: int) -> int:
    """The frequency shift of the tree's drift-``d`` path at time ``t``
    over a window of ``T`` spectra.  The first half-window inherits
    drift ``d>>1``; the second half starts ``(d+1)>>1`` bins up and
    inherits the same drift."""
    if T == 1:
        return 0
    half = T // 2
    if t < half:
        return tree_path_shift(d >> 1, t, half)
    return ((d + 1) >> 1) + tree_path_shift(d >> 1, t - half, half)


def _check_window(T: int) -> None:
    if T < 2 or T & (T - 1):
        raise ValueError(f"window_spectra must be a power of two >= 2, got {T}")
    if T > MAX_WINDOW:
        raise ValueError(
            f"window_spectra {T} > {MAX_WINDOW}: the unrolled tree stages "
            "stop being compile-affordable — search shorter windows"
        )


def kernel_route(T: int) -> Tuple[str, int]:
    """The Hopper kernel's route for window ``T`` and the launches a call
    should make: ``("registers", 1)`` for T <= 8 (one subtree a thread),
    ``("shared", 1)`` for T <= 64 (three stages in registers into a
    shared-memory tile, the rest from it), else ``("shared+passes", 1 +
    ceil((log2(T) - 6) / 3))``: the shared route on each 64-row group,
    then one global pass per three further stages.  The wrapper counts
    what the kernel reports it launched; tests and the smoke hold that
    count to this one.  A window outside 2..1024 raises."""
    _check_window(T)
    log = T.bit_length() - 1
    if log <= KERNEL_REG_LOG:
        return "registers", 1
    if log <= KERNEL_SMEM_LOG:
        return "shared", 1
    return "shared+passes", 1 + -(-(log - KERNEL_SMEM_LOG) // KERNEL_REG_LOG)


def taylor_tree(power: torch.Tensor) -> torch.Tensor:
    """Drift-rate transform of one window: ``(T, F)`` power → ``(T, F)``
    f32 path sums for drifts 0..T-1 (module docstring)."""
    T = power.shape[0]
    _check_window(T)
    if power.dtype != torch.float32:
        power = power.to(torch.float32)
    if power.device.type == "cpu":
        return taylor_tree_plain(power)
    return _tree_cuda(power, both=False)


taylor_tree.launches = 0  # kernel launches (CUDA tensors only)


def drift_spectra(power: torch.Tensor) -> torch.Tensor:
    """Both-sign drift transform: ``(T, F)`` → ``(2T-1, F)`` with row
    ``i`` holding drift ``i - (T-1)`` bins per window (negative = toward
    lower channel index).  Drift 0 appears once."""
    T = power.shape[0]
    _check_window(T)
    if power.dtype != torch.float32:
        power = power.to(torch.float32)
    if power.device.type == "cpu":
        return drift_spectra_plain(power)
    return _tree_cuda(power, both=True)


def taylor_tree_plain(power: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`taylor_tree`, ``blit``'s reference
    step by step: pad by T zero columns, then at each stage build row
    ``d`` of a merged block as ``top[d>>1] + roll(bot[d>>1],
    -((d+1)>>1))`` — one f32 add per element per stage."""
    T, F = power.shape
    _check_window(T)
    buf = torch.nn.functional.pad(power.to(torch.float32), (0, T))[:, None, :]
    L = 1
    while L < T:
        top, bot = buf[0::2], buf[1::2]  # (nb2, L, Fp) each
        nxt = torch.empty((top.shape[0], 2 * L, buf.shape[-1]),
                          dtype=torch.float32, device=buf.device)
        for d in range(2 * L):
            s = (d + 1) >> 1
            r2 = bot[:, d >> 1]
            if s:
                r2 = torch.roll(r2, -s, dims=-1)
            torch.add(top[:, d >> 1], r2, out=nxt[:, d])
        buf = nxt
        L *= 2
    return buf[0, :, :F].contiguous()


def drift_spectra_plain(power: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`drift_spectra`: the tree on the
    band and on the reversed band, flipped back, rows concatenated."""
    T = power.shape[0]
    pos = taylor_tree_plain(power)
    neg = taylor_tree_plain(power.flip(1)).flip(1)  # drifts 0..-(T-1)
    return torch.cat([neg.flip(0)[:T - 1], pos], dim=0)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("taylor_tree")
    if lib.taylor_tree_launch.argtypes is None:
        lib.taylor_tree_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)])
        lib.taylor_tree_launch.restype = ctypes.c_int
    return lib


def _tree_cuda(power: torch.Tensor, both: bool) -> torch.Tensor:
    """Launch the Hopper kernel: ``(T, F)`` → ``(T, F)`` (positive
    drifts) or ``(2T-1, F)`` (both signs)."""
    dev = power.device
    if dev.type != "cuda":
        raise ValueError(f"taylor_tree: unsupported device {dev}")
    if power.ndim != 2 or power.shape[1] < 1:
        raise ValueError("taylor_tree: (T, F) power with F >= 1 required")
    if not power.is_contiguous():
        raise ValueError("taylor_tree: power must be contiguous")
    T, F = power.shape
    _, launches = kernel_route(T)
    nsign = 2 if both else 1
    out = power.new_empty(((2 * T - 1) if both else T, F))
    # One scratch plane set per launch but the last, rows padded to 16 bytes.
    scratch = (power.new_empty((launches - 1, nsign, T, -(-F // 4) * 4))
               if launches > 1 else None)
    lib = _lib()
    launched = ctypes.c_int(0)
    ctx, stream = kernels.launch_stream(dev)
    with ctx:
        rc = lib.taylor_tree_launch(
            power.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), T, F, int(both),
            stream, ctypes.byref(launched))
    kernels.count_launch(taylor_tree, launched.value)
    kernels.check(lib, rc, "taylor_tree")
    return out


def drift_rates(T: int) -> np.ndarray:
    """The drift values (bins per window) of :func:`drift_spectra` rows."""
    return np.arange(-(T - 1), T)


def snr_normalize(dd: torch.Tensor) -> torch.Tensor:
    """Per-drift-row SNR: ``(dd - mean_f) / std_f`` over the frequency
    axis (population std, as ``jnp.std``), the std clamped at 1e-30."""
    sd, mu = torch.std_mean(dd, dim=1, keepdim=True, correction=0)
    snr = dd - mu
    return snr.div_(sd.clamp_min_(1e-30))


# Elements of one batch of the tie repair in :func:`_top_k` (its int64
# keys take 8 bytes each).
_TIE_BATCH = 1 << 27


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of each row of ``x``: the ``k`` largest values,
    descending, equal values taken and ordered lower index first."""
    n = x.shape[1]
    kk = min(k + 1, n)
    vals, idx = torch.topk(x, kk, dim=1)
    kth = vals[:, k - 1:k]
    tied = (vals[:, k:] == kth).any(dim=1)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].contiguous()
    if bool(tied.any()):
        # Equal values straddle the cut: torch.topk may have taken any of
        # them, top_k takes the lowest indices.  A row keeps its `above`
        # values past the k-th and fills the rest with the lowest indices
        # equal to it, found as a top-k over keys -index (-n elsewhere),
        # batched over the tied rows.
        rows = tied.nonzero().flatten()
        above = (vals[rows] > kth[rows]).sum(dim=1, keepdim=True)
        neg_pos = -torch.arange(n, device=x.device)
        j = torch.arange(k, device=x.device)
        batch = max(1, _TIE_BATCH // n)
        for lo in range(0, len(rows), batch):
            r, a = rows[lo:lo + batch], above[lo:lo + batch]
            keys = torch.where(x[r] == kth[r], neg_pos, -n)
            first = torch.topk(keys, k, dim=1).values.neg_()
            fill = torch.gather(first, 1, (j - a).clamp_(min=0))
            keep = j < a
            idx[r] = torch.where(keep, idx[r], fill)
            vals[r] = torch.where(keep, vals[r], kth[r])
    idx, order = torch.sort(idx, dim=1)
    vals = torch.gather(vals, 1, order)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, torch.gather(idx, 1, order)


@functools.lru_cache(maxsize=32)
def _drift_mask(T: int, max_drift_bins: int, device: torch.device) -> torch.Tensor:
    """The drift rows beyond ``max_drift_bins``, on ``device`` (uploaded
    once, not with every window)."""
    return torch.from_numpy(np.abs(drift_rates(T)) > max_drift_bins).to(device)


def dedoppler_hits(
    power: torch.Tensor,
    snr_threshold: float,
    *,
    top_k: int = 8,
    nbands: int = 1,
    max_drift_bins: Optional[int] = None,
) -> torch.Tensor:
    """The on-device search step: one window of power → packed top hits.

    ``power`` is ``(T, F)`` float32.  The frequency axis splits into
    ``nbands`` equal bands (``F % nbands == 0``) and the strongest
    ``top_k`` (drift, channel) cells are taken per band.

    Returns int32 ``(nbands, top_k, 4)``: ``[snr_bits, power_bits,
    drift_bins, chan]``, SNR-descending within each band.  Entries below
    the threshold carry -inf SNR bits, which the host decode drops.
    """
    T, F = power.shape
    if F % nbands:
        raise ValueError(f"nbands={nbands} does not divide F={F}")
    dd = drift_spectra(power)
    snr = snr_normalize(dd)  # (D, F), D = 2T-1
    D = 2 * T - 1
    if max_drift_bins is not None:
        snr.masked_fill_(_drift_mask(T, max_drift_bins, snr.device)[:, None],
                         -torch.inf)
    Fb = F // nbands
    # (D, nbands, Fb) → (nbands, D·Fb): top-k over every (drift, chan)
    # cell of each band.  Indices stay int64 until the pack.
    flat = snr.view(D, nbands, Fb).transpose(0, 1).reshape(nbands, D * Fb)
    del snr
    vals, idx = _top_k(flat, top_k)
    del flat
    row = idx // Fb
    chan = idx % Fb + torch.arange(nbands, device=idx.device)[:, None] * Fb
    pwr = dd[row, chan]
    thr = float(np.float32(snr_threshold))
    vals = torch.where(vals >= thr, vals, -torch.inf)
    return torch.stack([
        vals.contiguous().view(torch.int32),
        pwr.contiguous().view(torch.int32),
        (row - (T - 1)).to(torch.int32),
        chan.to(torch.int32),
    ], dim=-1)


def brute_force_dedoppler(power: np.ndarray) -> np.ndarray:
    """O(T·D·F) host reference summing the exact tree paths
    (:func:`tree_path_shift`) in float64, zero outside the band."""
    T, F = power.shape
    out = np.zeros((T, F), np.float64)
    x = power.astype(np.float64)
    for d in range(T):
        for t in range(T):
            s = tree_path_shift(d, t, T)
            if s < F:
                out[d, :F - s] += x[t, s:]
    return out


def unpack_hits(
    packed: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode a fetched :func:`dedoppler_hits` array → parallel arrays
    ``(snr, power, drift_bins, chan, band)`` with the -inf sentinels
    dropped, order kept (band-major, SNR-descending within a band)."""
    packed = np.asarray(packed)
    nbands, k, _ = packed.shape
    flat = packed.reshape(nbands * k, HIT_PACK_COLS)
    snr = flat[:, 0].view(np.float32)
    ok = np.isfinite(snr)
    band = np.repeat(np.arange(nbands, dtype=np.int32), k)[ok]
    return (
        snr[ok],
        flat[:, 1].view(np.float32)[ok],
        flat[:, 2][ok],
        flat[:, 3][ok],
        band,
    )
