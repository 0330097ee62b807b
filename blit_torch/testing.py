"""Synthetic BL@GBT data generators (test fixtures and smoke inputs).

Counterpart of ``blit/testing.py``: the same headers, the same seeded
voltages and spectra and the same files for the same arguments, so a
file written here reads and reduces identically in both packages: RAW
recordings, one file (:func:`synth_raw`) or a ``.NNNN.raw`` scan
(:func:`synth_raw_sequence`), ``.fil`` and ``.h5`` products
(:func:`synth_fil`, :func:`synth_fbh5`) and whole observation trees
(:func:`build_observation_tree`).  Adds :func:`synth_raw_blocks`, which
writes a large recording block by block at bounded memory
(``synth_raw`` builds the whole float64 stream first).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from blit_torch.config import COARSE_MHZ, nfpc_from_foff
from blit_torch.io.guppi import write_raw
from blit_torch.io.sigproc import write_fil


def make_fil_header(
    nchans: int = 64,
    nifs: int = 1,
    fch1: float = 8437.5,
    foff: Optional[float] = None,
    tsamp: float = 1.0e-3,
    tstart: float = 59897.0,
    source_name: str = "SYNTH",
) -> Dict:
    """A plausible GBT filterbank header; ``foff`` defaults to one coarse
    channel over ``nchans // 64`` fine channels (nfpc computes cleanly)."""
    if foff is None:
        foff = -COARSE_MHZ / max(nchans // 64, 1)
    return {
        "telescope_id": 6,  # GBT
        "machine_id": 0,
        "data_type": 1,
        "source_name": source_name,
        "barycentric": 0,
        "pulsarcentric": 0,
        "az_start": 0.0,
        "za_start": 0.0,
        "src_raj": 120000.0,
        "src_dej": 450000.0,
        "tstart": tstart,
        "tsamp": tsamp,
        "fch1": fch1,
        "foff": foff,
        "nchans": nchans,
        "nifs": nifs,
    }


def make_spectra(
    nsamps: int = 16,
    nifs: int = 1,
    nchans: int = 64,
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """Deterministic positive "power" spectra ``(nsamps, nifs, nchans)``."""
    rng = np.random.default_rng(seed)
    base = rng.chisquare(4, size=(nsamps, nifs, nchans))
    ramp = 1.0 + np.arange(nchans) / nchans
    return (base * ramp).astype(dtype)


def synth_fil(path: str, nsamps=16, nifs=1, nchans=64, seed=0,
              **hdrkw) -> Tuple[Dict, np.ndarray]:
    hdr = make_fil_header(nchans=nchans, nifs=nifs, **hdrkw)
    data = make_spectra(nsamps, nifs, nchans, seed)
    write_fil(path, hdr, data)
    return hdr, data


def synth_fbh5(path: str, nsamps=16, nifs=1, nchans=64, seed=0,
               compression=None, **hdrkw) -> Tuple[Dict, np.ndarray]:
    """As :func:`synth_fil`, to an ``.h5`` product (needs ``h5py``)."""
    from blit_torch.io.fbh5 import write_fbh5

    hdr = make_fil_header(nchans=nchans, nifs=nifs, **hdrkw)
    hdr["nfpc"] = nfpc_from_foff(hdr["foff"])
    data = make_spectra(nsamps, nifs, nchans, seed)
    write_fbh5(path, hdr, data, compression=compression)
    return hdr, data


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
    out = np.empty((obsnchan, ntime, npol, 2), np.int8)
    tone = None
    if tone_chan is not None:
        t = np.arange(ntime, dtype=np.float64)
        ph = 2 * np.pi * (tone_freq * t + 0.5 * tone_drift * t * t)
        tone = (range(obsnchan)[tone_chan], tone_amp * np.cos(ph)[:, None],
                tone_amp * np.sin(ph)[:, None])
    # In cache-sized pieces, channel after channel, time after time: the
    # draws are the sequence one whole-array ``rng.normal(0, noise_rms,
    # size)`` makes (``normal`` is ``loc + scale * standard_normal``), so
    # the values are that call's, and host memory stays at one piece.
    step = max(1, (1 << 16) // (npol * 2))
    buf = np.empty((step, npol, 2))
    for c in range(obsnchan):
        for t0 in range(0, ntime, step):
            t1 = min(ntime, t0 + step)
            v = buf[:t1 - t0]
            rng.standard_normal(out=v)
            v *= noise_rms
            if tone is not None and c == tone[0]:
                v[:, :, 0] += tone[1][t0:t1]
                v[:, :, 1] += tone[2][t0:t1]
            np.rint(v, out=v)
            np.clip(v, -128, 127, out=v)
            out[c, t0:t1] = v
    return out


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


def build_observation_tree(
    root: str,
    session: str = "AGBT22B_999_01",
    scans: Tuple[str, ...] = ("0011",),
    players: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 1)),
    nsamps: int = 16,
    nchans: int = 64,
    kind: str = "fbh5",
    nfiles: int = 1,
    raw_ntime: int = 1024,
) -> List[str]:
    """A fake BL@GBT data tree, ``<root>/<session>/GUPPI/BLPbb/<guppi
    name>``, of real, readable files; returns their paths.

    ``kind`` is ``"fbh5"``, ``"fil"`` or ``"raw"``: per-player ``.NNNN.raw``
    sequences (``nfiles`` members of 2 blocks of ``raw_ntime`` samples, a
    tone in coarse channel ``bank % nchans``) whose banks tile each band,
    bank k owning the k-th 187.5/8 MHz slice, descending, as ``blit``'s
    tree does."""
    paths = []
    for band, bank in players:
        player = f"BLP{band}{bank}"
        host = f"blc{band}{bank}"
        d = os.path.join(root, session, "GUPPI", player)
        os.makedirs(d, exist_ok=True)
        for scan in scans:
            base = f"{host}_guppi_59897_21221_HD_84406_{scan}"
            if kind == "fbh5":
                p = os.path.join(d, base + ".rawspec.0002.h5")
                synth_fbh5(p, nsamps=nsamps, nchans=nchans, seed=band * 8 + bank)
            elif kind == "fil":
                p = os.path.join(d, base + ".rawspec.0002.fil")
                synth_fil(p, nsamps=nsamps, nchans=nchans, seed=band * 8 + bank)
            elif kind == "raw":
                bank_bw = -187.5 / 8
                ps, _ = synth_raw_sequence(
                    os.path.join(d, base),
                    nfiles=nfiles,
                    blocks_per_file=2,
                    obsnchan=nchans,
                    ntime_per_block=raw_ntime,
                    seed=band * 8 + bank,
                    tone_chan=bank % nchans,
                    obsbw=bank_bw,
                    obsfreq=8000.0 + band * 500.0 + (bank + 0.5) * bank_bw,
                )
                paths.extend(ps)
                continue
            else:
                raise ValueError(f"unknown kind {kind!r}")
            paths.append(p)
    return paths


def signal_ready(outdir: str, tag) -> str:
    """Atomically drop a readiness marker ``<outdir>/.ready<tag>`` — the
    multi-process harness's bring-up barrier: a pod child writes it the
    moment its process group is up, so the parent can time the work
    phase apart from the bring-up."""
    path = os.path.join(outdir, f".ready{tag}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(os.getpid()))
    os.replace(tmp, path)
    return path


def sync_compare_verdict(async_path: str, sync_path: str,
                         async_wall_s: float, sync_wall_s: float) -> Dict:
    """The async-vs-sync acceptance of ``ingest-bench --sync-compare``:
    the asynchronous (narrowed on the device when nbits < 32) and the
    synchronous products of one recording must be the same file, and
    the speedup is the sync / async wall ratio.  Compared in constant
    memory: products can be large."""
    import filecmp

    return {
        "async_speedup": round(sync_wall_s / max(async_wall_s, 1e-9), 3),
        "products_identical": filecmp.cmp(async_path, sync_path,
                                          shallow=False),
    }
