"""A configuration of kind ``reduce``: each bank's live stream reduced to
a filterbank product by ``blit_torch.stream.stream_reduce`` through a
``blit_torch.pipeline.RawReducer`` at the configuration's product and
the port's default knobs.

The judge holds every bank's product to the plain reference
(:mod:`portbench.reference.filterbank`): its header, its row count
against the samples the bank was fed, and every row element by element.
The ring feeds its pool over and over, so the product repeats every
``period_rows`` rows: the reference works out one period's rows from
the bank's pool, uploaded once, and each row is held to its own.  The
configuration's ``pool_blocks`` keeps that period longer than the
program's rotation of chunk slots, so a slot filled from another chunk
shows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.reference import filterbank, products

SUFFIX = ".fil"


def make(config: Dict, device, timeline, dtype: str):
    from blit_torch.pipeline import RawReducer

    p = config["product"]
    return RawReducer(nfft=p["nfft"], nint=p["nint"], ntap=p["ntap"],
                      window=p["window"], stokes=p["stokes"], dtype=dtype,
                      device=device, timeline=timeline)


def run(reducer, source, out_path: str) -> Dict:
    from blit_torch.stream import stream_reduce

    return stream_reduce(source, out_path, reducer=reducer)


def frames_done(config: Dict, hdr: Dict) -> int:
    """PFB frames in the finished product."""
    return int(hdr["nsamps"]) * config["product"]["nint"]


def judge(config: Dict, banks: List[Dict], rng: np.random.Generator,
          device) -> Dict:
    import torch

    p = config["product"]
    nfft, nint, ntap = p["nfft"], p["nint"], p["ntap"]
    lim = config["limits"]["rel_err"]
    rel_err, rows_missing, hdr_off = 0.0, 0, 0
    attempted = failed = 0
    for b in banks:
        hdr, data = products.read_fil(b["product"])
        want_rows = filterbank.whole_frames(b["samples"], nfft, ntap) // nint
        have = min(want_rows, data.shape[0])
        rows_missing += abs(want_rows - data.shape[0])
        hdr_off += filterbank.header_off(hdr, filterbank.header(b["raw_header"],
                                                     nfft=nfft, nint=nint))
        attempted += want_rows
        failed += abs(want_rows - data.shape[0])
        if have == 0:
            continue
        pool = [torch.as_tensor(blk, device=device) for blk in b["pool"]]
        period = filterbank.period_rows(len(pool) * pool[0].shape[1], nfft, nint)
        for phase in range(min(period, have)):
            want = filterbank.product_row(pool, phase, nfft=nfft, ntap=ntap,
                                          nint=nint, window=p["window"],
                                          device=device)
            got = np.asarray(data[phase:have:period, 0], np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                err = np.max(np.abs(got - want) / want, axis=1)
            err[~np.isfinite(err)] = np.inf
            rel_err = max(rel_err, float(err.max()))
            failed += int(np.count_nonzero(~(err <= lim)))
        del pool, data
    return {"numbers": {"rel_err": float(rel_err),
                        "rows_missing": int(rows_missing),
                        "header_off": int(hdr_off)},
            "attempted": attempted, "failed": failed}
