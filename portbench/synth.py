"""A bank's recording, made on the device from the seed and handed back
as blocks in host RAM, where a recorder holds them.

The signal model: complex Gaussian noise of rms ``noise_rms`` in every
coarse channel and pol, plus in coarse channel ``tone_chan`` a complex
tone of amplitude ``tone_amp`` starting at ``tone_freq`` cycles a
sample and chirping by ``tone_drift`` cycles a sample per sample (phase
``2 pi (f0 t + tone_drift t^2 / 2)`` at the pool's sample time ``t``),
rounded and clipped to int8.  One generator a bank, seeded from the
run's seed and the bank's index, so a seed always gives the same band.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def bank_seed(seed: int, bank: int) -> int:
    return (int(seed) * 1_000_003 + bank) % (1 << 63)


def block_ntime(config: Dict) -> int:
    """Time samples a block of ``block_bytes`` holds (2 bytes a complex
    8-bit sample a pol)."""
    per = config["obsnchan"] * config["npol"] * 2 * config["nbits"] // 8
    return config["block_bytes"] // per


def bank_header(config: Dict, bank: int) -> Dict:
    """The GUPPI RAW header a recorder stamps on bank ``bank``'s blocks:
    the band's ``band_banks`` banks (all ``banks`` where not given) side
    by side, bank 0 at the top when the bandwidth is negative."""
    nchan = config["obsnchan"]
    chan_bw = config["bank_bw_sign"] * config["chan_bw_mhz"]
    bw = nchan * chan_bw
    band = config.get("band_banks", config["banks"])
    centre = config["band_centre_mhz"] + ((band - 1) / 2 - bank) * abs(bw)
    return {
        "BACKEND": "GUPPI",
        "TELESCOP": "GBT",
        "SRC_NAME": "PORTBENCH",
        "BANKNAM": f"BANK{bank}",
        "OBSFREQ": centre,
        "OBSBW": bw,
        "OBSNCHAN": nchan,
        "CHAN_BW": chan_bw,
        "NPOL": 4 if config["npol"] == 2 else config["npol"],
        "NBITS": config["nbits"],
        "TBIN": 1.0 / (config["chan_bw_mhz"] * 1e6),
        "BLOCSIZE": config["block_bytes"],
        "OVERLAP": 0,
        "PKTSIZE": 8192,
        "PKTIDX": 0,
        "STT_IMJD": 60000,
        "STT_SMJD": 43200,
        "STT_OFFS": 0,
        "DIRECTIO": 0,
    }


def bank_pool(config: Dict, signal: Dict, seed: int, bank: int,
              device) -> List[np.ndarray]:
    """The ``pool_blocks`` blocks of bank ``bank``, each int8 ``(nchan,
    ntime, npol, 2)`` in host RAM, drawn on ``device``."""
    device = torch.device(device)
    nchan, npol = config["obsnchan"], config["npol"]
    ntime = block_ntime(config)
    gen = torch.Generator(device=device).manual_seed(bank_seed(seed, bank))
    t = torch.arange(ntime, device=device, dtype=torch.float64)
    f0, fdot = signal["tone_freq"], signal["tone_drift"]
    c = signal["tone_chan"]
    pool = []
    for j in range(config["pool_blocks"]):
        v = torch.randn((nchan, ntime, npol, 2), generator=gen, device=device)
        v *= signal["noise_rms"]
        tt = t + j * ntime
        ph = (2 * math.pi) * (f0 * tt + 0.5 * fdot * tt * tt)
        v[c, :, :, 0] += (signal["tone_amp"] * torch.cos(ph)).float()[:, None]
        v[c, :, :, 1] += (signal["tone_amp"] * torch.sin(ph)).float()[:, None]
        pool.append(v.round_().clamp_(-128, 127).to(torch.int8).cpu().numpy())
        del v
    return pool
