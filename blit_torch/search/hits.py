"""Hit records, the search plane's product atom.

Counterpart of ``blit/search/hits.py``.  A :class:`Hit` is one (drift
rate, frequency) cell that passed the device-side threshold and per-band
top-k of :func:`blit_torch.ops.dedoppler.dedoppler_hits`: bin-space
coordinates (drift bins per window, absolute fine channel), the physical
values derived from the filterbank header (sky frequency in MHz, drift
rate in Hz/s), the SNR and power that ranked it, and which window it
came from.

Two encodings, both deterministic and both ``blit``'s:

- JSON-line records (:meth:`Hit.record` / :func:`hit_from_record`), the
  ``.hits`` product format (``blit_torch/io/hits.py``);
- a dense float32 array (:func:`hits_to_array` / :func:`hits_from_array`)
  shaped ``(nhits, 1, HIT_COLS)``.  Fine channel indices are split into
  two halves exact in f32 (``chan = hi·2**16 + lo``): the hi-res
  product's 2^26 channels exceed f32's 2^24 integer range.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Sequence

import numpy as np

from blit_torch.ops.dedoppler import unpack_hits

# Columns of the dense encoding (:func:`hits_to_array`):
# [snr, power, drift_bins, chan_hi, chan_lo, band, window, reserved].
HIT_COLS = 8
_CHAN_SPLIT = 1 << 16


@dataclass(frozen=True)
class Hit:
    """One detected drift-rate candidate (module docstring)."""

    snr: float
    power: float
    drift_bins: int
    chan: int
    band: int
    window: int
    t_start: int
    freq_mhz: float
    drift_hz_s: float

    def record(self) -> Dict:
        """The JSON-safe record of this hit (plain builtins only)."""
        return asdict(self)


def hit_from_record(rec: Dict) -> Hit:
    """Rebuild a :class:`Hit` from :meth:`Hit.record` output."""
    return Hit(
        snr=float(rec["snr"]), power=float(rec["power"]),
        drift_bins=int(rec["drift_bins"]), chan=int(rec["chan"]),
        band=int(rec["band"]), window=int(rec["window"]),
        t_start=int(rec["t_start"]), freq_mhz=float(rec["freq_mhz"]),
        drift_hz_s=float(rec["drift_hz_s"]),
    )


def physical(chan: int, drift_bins: int, header: Dict) -> tuple:
    """``(freq_mhz, drift_hz_s)`` of a bin-space hit under ``header`` (a
    filterbank header with ``fch1``/``foff`` in MHz, ``tsamp`` in
    seconds, and ``search_window_spectra``)."""
    T = int(header["search_window_spectra"])
    freq_mhz = float(header["fch1"]) + chan * float(header["foff"])
    drift_hz_s = (
        drift_bins * float(header["foff"]) * 1e6
        / ((T - 1) * float(header["tsamp"]))
    )
    return freq_mhz, drift_hz_s


def hits_from_packed(
    packed: np.ndarray, window: int, header: Dict
) -> List[Hit]:
    """Decode one window's fetched ``dedoppler_hits`` array into
    :class:`Hit` objects (sentinels dropped; band-major, SNR-descending
    within a band)."""
    T = int(header["search_window_spectra"])
    snr, power, drift, chan, band = unpack_hits(packed)
    out = []
    for i in range(len(snr)):
        c, d = int(chan[i]), int(drift[i])
        freq_mhz, drift_hz_s = physical(c, d, header)
        out.append(Hit(
            snr=float(snr[i]), power=float(power[i]), drift_bins=d,
            chan=c, band=int(band[i]), window=int(window),
            t_start=int(window) * T, freq_mhz=freq_mhz,
            drift_hz_s=drift_hz_s,
        ))
    return out


def hits_to_array(hits: Sequence[Hit]) -> np.ndarray:
    """Dense encoding: ``(nhits, 1, HIT_COLS)`` float32 of the bin-space
    fields; the physical values re-derive from the header on decode."""
    out = np.zeros((len(hits), 1, HIT_COLS), np.float32)
    for i, h in enumerate(hits):
        out[i, 0] = (
            np.float32(h.snr), np.float32(h.power), h.drift_bins,
            h.chan // _CHAN_SPLIT, h.chan % _CHAN_SPLIT, h.band,
            h.window, 0.0,
        )
    return out


def hits_from_array(arr: np.ndarray, header: Dict) -> List[Hit]:
    """Decode :func:`hits_to_array` output back into :class:`Hit`
    objects under ``header`` (the search product header)."""
    T = int(header["search_window_spectra"])
    out = []
    for row in np.asarray(arr).reshape(-1, HIT_COLS):
        chan = int(row[3]) * _CHAN_SPLIT + int(row[4])
        drift = int(row[2])
        freq_mhz, drift_hz_s = physical(chan, drift, header)
        out.append(Hit(
            snr=float(np.float32(row[0])), power=float(np.float32(row[1])),
            drift_bins=drift, chan=chan, band=int(row[5]),
            window=int(row[6]), t_start=int(row[6]) * T,
            freq_mhz=freq_mhz, drift_hz_s=drift_hz_s,
        ))
    return out
