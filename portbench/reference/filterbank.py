"""Plain reference of a GUPPI RAW bank reduced to a filterbank product.

Written from the product's definition, not from the program: rawspec's
polyphase filterbank (a windowed-sinc prototype of ``ntap * nfft`` taps
with unit DC gain), an ``nfft``-point FFT of each coarse channel's
frames with the zero frequency moved to the middle, Stokes I
(``|X|^2 + |Y|^2``) and sums of ``nint`` consecutive frames.  Frame
``f`` of a gap-free stream reads samples ``[f * nfft, (f + ntap) *
nfft)``.  Everything is float64 and complex128, on whatever device the
caller names.  Imports neither JAX nor anything of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Coarse channels computed at once: at the cell's size a 0002 row
# (nint 3072) takes some tens of GB of the card in float64 this way.
CHAN_BLOCK = 64


def prototype(ntap: int, nfft: int, window: str = "hamming") -> np.ndarray:
    """The prototype filter ``(ntap, nfft)`` in float64: a sinc spanning
    ``ntap`` channels, tapered by ``window`` and scaled to unit DC gain."""
    n = ntap * nfft
    x = np.arange(n, dtype=np.float64) / nfft - ntap / 2.0
    taper = {"hamming": np.hamming, "hanning": np.hanning,
             "rect": np.ones}[window](n)
    h = np.sinc(x) * taper
    return (h / h.sum()).reshape(ntap, nfft)


def samples(pool, s0: int, n: int):
    """Samples ``[s0, s0 + n)`` of the stream a cyclic block pool feeds:
    stream block ``i`` is ``pool[i % len(pool)]``; each block is int8
    ``(nchan, ntime, npol, 2)``, NumPy arrays or torch tensors alike."""
    ntime = pool[0].shape[1]
    parts = []
    done = 0
    while done < n:
        b, t0 = divmod(s0 + done, ntime)
        take = min(ntime - t0, n - done)
        parts.append(pool[b % len(pool)][:, t0:t0 + take])
        done += take
    if isinstance(pool[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return np.concatenate(parts, axis=1)


def period_rows(pool_samples: int, nfft: int, nint: int) -> int:
    """Rows after which a cyclic pool of ``pool_samples`` samples feeds a
    product row the same samples again: row ``r``'s frames read samples
    from ``r * nint * nfft`` on, so rows ``r`` and ``r + k`` read the same
    ones exactly where ``k * nint * nfft`` is a multiple of the pool."""
    row = nint * nfft
    return pool_samples // math.gcd(pool_samples, row)


def stokes_i_frames(volts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """int8 ``(nchan, nsamp, npol, 2)`` on a device → Stokes I power of
    every whole frame, ``(nchan, nframes, nfft)`` float64, zero
    frequency in the middle of each coarse channel."""
    ntap, nfft = h.shape
    z = torch.complex(volts[..., 0].double(), volts[..., 1].double())
    z = z.movedim(2, 1)  # (nchan, npol, nsamp)
    nblk = z.shape[-1] // nfft
    nframes = nblk - ntap + 1
    blocks = z[..., :nblk * nfft].reshape(z.shape[:2] + (nblk, nfft))
    frames = h[0] * blocks[..., 0:nframes, :]
    for k in range(1, ntap):
        frames = frames + h[k] * blocks[..., k:k + nframes, :]
    spec = torch.fft.fftshift(torch.fft.fft(frames, dim=-1), dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).sum(dim=1)


def product_row(pool, row: int, *, nfft: int, ntap: int, nint: int,
                window: str, device) -> np.ndarray:
    """Row ``row`` of the Stokes I product, ``(nchan * nfft,)`` float64:
    the sum of frames ``[row * nint, (row + 1) * nint)``, computed
    ``CHAN_BLOCK`` coarse channels at a time."""
    h = torch.from_numpy(prototype(ntap, nfft, window)).to(device)
    s0 = row * nint * nfft
    n = (nint + ntap - 1) * nfft
    nchan = pool[0].shape[0]
    out = np.empty((nchan, nfft), np.float64)
    for c in range(0, nchan, CHAN_BLOCK):
        part = [p[c:c + CHAN_BLOCK] for p in pool]
        v = torch.as_tensor(samples(part, s0, n), device=device)
        out[c:c + CHAN_BLOCK] = stokes_i_frames(v, h).sum(dim=1).cpu().numpy()
        del v
    return out.reshape(-1)


def whole_frames(nsamp: int, nfft: int, ntap: int) -> int:
    """Whole PFB frames a gap-free span of ``nsamp`` samples holds."""
    return max(0, nsamp // nfft - ntap + 1)


def header(raw_header: dict, *, nfft: int, nint: int) -> dict:
    """The filterbank header fields a product of this RAW header must
    carry: fine channel ``j`` of coarse channel ``c`` sits at the coarse
    channel's centre plus ``(j - nfft / 2)`` fine channels."""
    nchan = int(raw_header["OBSNCHAN"])
    bw = float(raw_header["OBSBW"])
    chan_bw = bw / nchan
    foff = chan_bw / nfft
    first_centre = float(raw_header["OBSFREQ"]) - bw / 2 + chan_bw / 2
    return {
        "nchans": nchan * nfft,
        "nifs": 1,
        "nbits": 32,
        "foff": foff,
        "fch1": first_centre - (nfft // 2) * foff,
        "tsamp": float(raw_header["TBIN"]) * nfft * nint,
    }


def header_off(got: dict, want: dict) -> int:
    """Fields of ``want`` that ``got`` lacks or differs in: integers
    exactly, floats beyond a relative 1e-12."""
    off = 0
    for k, v in want.items():
        g = got.get(k)
        if g is None:
            off += 1
        elif isinstance(v, int):
            off += int(g != v)
        else:
            off += int(not abs(g - v) <= 1e-12 * abs(v))
    return off
