"""Synthetic GUPPI RAW generators (test fixtures and smoke inputs).

Counterpart of the RAW part of ``blit/testing.py``: the same header, the
same seeded voltages and the same files for the same arguments, so a
file written here reduces identically in both packages, one file
(:func:`synth_raw`) or a ``.NNNN.raw`` scan (:func:`synth_raw_sequence`).
Adds :func:`synth_raw_blocks`, which writes a large recording block by
block at bounded memory (``synth_raw`` builds the whole float64 stream
first).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from blit_torch.io.guppi import write_raw


def make_raw_header(
    obsnchan: int = 64,
    npol: int = 2,
    obsfreq: float = 8437.5,
    obsbw: float = 187.5,
    tbin: Optional[float] = None,
    overlap: int = 0,
    src_name: str = "SYNTH",
    stt_imjd: int = 59897,
    stt_smjd: int = 21221,
) -> Dict:
    if tbin is None:
        tbin = abs(obsnchan / (obsbw * 1e6))  # critically sampled
    return {
        "SRC_NAME": src_name,
        "TELESCOP": "GBT",
        "OBSFREQ": obsfreq,
        "OBSBW": obsbw,
        "OBSNCHAN": obsnchan,
        "NPOL": 4 if npol == 2 else npol,
        "NBITS": 8,
        "TBIN": tbin,
        "OVERLAP": overlap,
        "STT_IMJD": stt_imjd,
        "STT_SMJD": stt_smjd,
        "PKTIDX": 0,
        "CHAN_BW": obsbw / obsnchan,
    }


def tone_drift_for(nfft: int, nspectra: int, drift_bins: float) -> float:
    """The ``tone_drift`` (cycles/sample²) that drifts a tone by
    ``drift_bins`` fine channels (bin width ``1/nfft`` cycles/sample)
    over ``nspectra`` consecutive nfft-point spectra: inject with this,
    search with ``window_spectra=nspectra``, and the top hit's
    ``drift_bins`` lands within one drift step."""
    return drift_bins / (nfft * nspectra * nfft)


def make_voltages(
    obsnchan: int,
    ntime: int,
    npol: int = 2,
    seed: int = 0,
    tone_chan: Optional[int] = None,
    tone_freq: float = 0.25,
    tone_amp: float = 20.0,
    noise_rms: float = 8.0,
    tone_drift: float = 0.0,
) -> np.ndarray:
    """Quantized complex voltages ``(obsnchan, ntime, npol, 2)`` int8:
    Gaussian noise plus an optional complex tone in one coarse channel.
    ``tone_drift`` chirps the tone linearly: its instantaneous frequency
    is ``tone_freq + tone_drift·t`` cycles per sample, so its phase is
    ``2π(f₀·t + ½·ḟ·t²)`` (:func:`tone_drift_for`)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, noise_rms, size=(obsnchan, ntime, npol, 2))
    if tone_chan is not None:
        t = np.arange(ntime, dtype=np.float64)
        ph = 2 * np.pi * (tone_freq * t + 0.5 * tone_drift * t * t)
        v[tone_chan, :, :, 0] += tone_amp * np.cos(ph)[:, None]
        v[tone_chan, :, :, 1] += tone_amp * np.sin(ph)[:, None]
    return np.clip(np.round(v), -128, 127).astype(np.int8)


def synth_raw(
    path: str,
    nblocks: int = 2,
    obsnchan: int = 64,
    ntime_per_block: int = 1024,
    npol: int = 2,
    overlap: int = 0,
    directio: bool = False,
    seed: int = 0,
    tone_chan: Optional[int] = None,
    tone_drift: float = 0.0,
    tone_freq: float = 0.25,
    tone_amp: float = 20.0,
    **hdrkw,
) -> Tuple[Dict, List[np.ndarray]]:
    """Write a synthetic GUPPI RAW file whose consecutive blocks share
    ``overlap`` samples, as on disk at GBT.  ``tone_drift`` chirps the
    injected tone (a drifting technosignature, :func:`tone_drift_for`)."""
    hdr = make_raw_header(obsnchan=obsnchan, npol=npol, overlap=overlap, **hdrkw)
    step = ntime_per_block - overlap
    total = step * (nblocks - 1) + ntime_per_block
    stream = make_voltages(obsnchan, total, npol, seed=seed,
                           tone_chan=tone_chan, tone_drift=tone_drift,
                           tone_freq=tone_freq, tone_amp=tone_amp)
    blocks = [stream[:, i * step:i * step + ntime_per_block]
              for i in range(nblocks)]
    write_raw(path, hdr, blocks, directio=directio)
    return hdr, blocks


def synth_raw_sequence(
    stem: str,
    nfiles: int = 2,
    blocks_per_file: int = 2,
    obsnchan: int = 64,
    ntime_per_block: int = 1024,
    npol: int = 2,
    overlap: int = 0,
    seed: int = 0,
    tone_chan: Optional[int] = None,
    tone_drift: float = 0.0,
    **hdrkw,
) -> Tuple[List[str], np.ndarray]:
    """Write a ``<stem>.NNNN.raw`` scan carrying one contiguous voltage
    stream (the block stream, OVERLAP and PKTIDX included, continues
    across the members).  Returns ``(paths, stream)``, ``stream`` the
    gap-free voltages the scan encodes."""
    nblocks = nfiles * blocks_per_file
    hdr = make_raw_header(obsnchan=obsnchan, npol=npol, overlap=overlap, **hdrkw)
    step = ntime_per_block - overlap
    total = step * (nblocks - 1) + ntime_per_block
    stream = make_voltages(obsnchan, total, npol, seed=seed,
                           tone_chan=tone_chan, tone_drift=tone_drift)
    blocks = [stream[:, i * step:i * step + ntime_per_block]
              for i in range(nblocks)]
    paths = []
    for f in range(nfiles):
        p = f"{stem}.{f:04d}.raw"
        fhdr = dict(hdr)
        fhdr["PKTIDX"] = f * blocks_per_file * step
        write_raw(p, fhdr, blocks[f * blocks_per_file:(f + 1) * blocks_per_file])
        paths.append(p)
    return paths, stream


def _segment(rng: np.random.Generator, nchan: int, t0: int, nt: int,
             npol: int, tone_chan: Optional[int], tone_freq: float,
             tone_amp: float, noise_rms: float) -> np.ndarray:
    """Samples ``[t0, t0+nt)`` of a seeded stream: f32 Gaussian noise
    plus the tone at absolute sample time, quantized to int8."""
    v = rng.standard_normal((nchan, nt, npol, 2), dtype=np.float32)
    v *= np.float32(noise_rms)
    if tone_chan is not None:
        ph = 2 * np.pi * tone_freq * np.arange(t0, t0 + nt, dtype=np.float64)
        v[tone_chan, :, :, 0] += (tone_amp * np.cos(ph)).astype(np.float32)[:, None]
        v[tone_chan, :, :, 1] += (tone_amp * np.sin(ph)).astype(np.float32)[:, None]
    np.rint(v, out=v)
    np.clip(v, -128, 127, out=v)
    return v.astype(np.int8)


def synth_raw_blocks(
    path: str,
    nblocks: int,
    obsnchan: int = 64,
    ntime_per_block: int = 1 << 19,
    npol: int = 2,
    overlap: int = 0,
    seed: int = 0,
    tone_chan: Optional[int] = None,
    tone_freq: float = 0.25,
    tone_amp: float = 20.0,
    noise_rms: float = 8.0,
    **hdrkw,
) -> Dict:
    """Write a large synthetic RAW file one block at a time: host memory
    stays at a few blocks whatever the file size.  The stream is one
    gap-free seeded sequence, so blocks sharing ``overlap`` samples hold
    the same values there.  Returns the header."""
    if not 0 <= overlap < ntime_per_block:
        raise ValueError("overlap must be in [0, ntime_per_block)")
    hdr = make_raw_header(obsnchan=obsnchan, npol=npol, overlap=overlap, **hdrkw)
    step = ntime_per_block - overlap
    rng = np.random.default_rng(seed)
    seg_kw = dict(npol=npol, tone_chan=tone_chan, tone_freq=tone_freq,
                  tone_amp=tone_amp, noise_rms=noise_rms)

    def blocks() -> Iterator[np.ndarray]:
        cur = _segment(rng, obsnchan, 0, step, **seg_kw)
        for i in range(nblocks):
            nxt_len = step if i + 1 < nblocks else overlap
            nxt = _segment(rng, obsnchan, (i + 1) * step, nxt_len, **seg_kw)
            yield np.concatenate([cur, nxt[:, :overlap]], axis=1)
            cur = nxt

    write_raw(path, hdr, blocks())
    return hdr
