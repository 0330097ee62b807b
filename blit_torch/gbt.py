"""Main-process orchestration API — the rebuild of module ``GBT``
(src/gbt.jl).

Counterpart of ``blit/gbt.py``.  Call pattern parity (SURVEY.md §3):
every function fans one call per worker (or per (worker, file) pair)
through the pool and gathers results ordered like its inputs; reductions
happen worker-side before results cross any wire.  ``load_scan`` makes
the reference's commented-out scan loader (src/gbt.jl:90-114)
first-class: per-band bank stitching + DC despike.

This is the host-side control plane; the workers' reductions and
``get_kurtosis`` run on their card unless the caller asks for the host.
The mesh-backed wrappers (``load_scan_mesh``,
``reduce_scan_mesh_to_files``, ``reduce_scan_sharded_to_files``,
``reduce_scan_pool_to_files``, ``search_scan_sharded_to_files``) import
the ``(band, bank)`` mesh (:mod:`blit_torch.parallel.scan`,
:mod:`blit_torch.parallel.sharded`) when called.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from blit_torch import workers as wf
from blit_torch.config import DEFAULT, SiteConfig, datahosts  # noqa: F401 (re-export)
from blit_torch.inventory import (  # noqa: F401 (re-exports)
    InventoryRecord,
    raw_sequences,
    scan_grid,
    to_dataframe,
)
from blit_torch.ops.despike import despike as _despike
from blit_torch.ops.fqav import fqav_range
from blit_torch.parallel.pool import (  # noqa: F401 (re-export)
    WorkerError,
    WorkerPool,
    current_pool,
    setup_workers,
)




def load_scan_mesh(*args, **kw):
    """Mesh-backed whole-scan reduction (RAW files → each player's
    channelizer → the bank stitch); see
    :func:`blit_torch.parallel.scan.load_scan_mesh`.  The mesh is imported
    when called."""
    from blit_torch.parallel.scan import load_scan_mesh as _impl

    return _impl(*args, **kw)


def reduce_scan_mesh_to_files(*args, **kw):
    """The windowed mesh reduction streaming each stitched band to its
    product; see :func:`blit_torch.parallel.scan.reduce_scan_mesh_to_files`."""
    from blit_torch.parallel.scan import reduce_scan_mesh_to_files as _impl

    return _impl(*args, **kw)


def reduce_scan_sharded_to_files(*args, **kw):
    """The sharded reduction plane (the mesh loop with every host leg on
    a thread); see
    :func:`blit_torch.parallel.sharded.reduce_scan_sharded_to_files`."""
    from blit_torch.parallel.sharded import reduce_scan_sharded_to_files as _impl

    return _impl(*args, **kw)


def reduce_scan_pool_to_files(*args, **kw):
    """The pool path of a whole-scan reduction and the mesh paths'
    byte-identity oracle; see
    :func:`blit_torch.parallel.scan.reduce_scan_pool_to_files`."""
    from blit_torch.parallel.scan import reduce_scan_pool_to_files as _impl

    return _impl(*args, **kw)


def search_scan_sharded_to_files(*args, **kw):
    """The sharded whole-scan drift search, one ``.hits`` a player; see
    :func:`blit_torch.parallel.sharded.search_scan_sharded_to_files`."""
    from blit_torch.parallel.sharded import search_scan_sharded_to_files as _impl

    return _impl(*args, **kw)


log = logging.getLogger("blit_torch.gbt")

Idxs = Tuple
_ALL = (slice(None), slice(None), slice(None))


def _pool(pool: Optional[WorkerPool]) -> WorkerPool:
    p = pool or current_pool()
    if p is None:
        raise RuntimeError("no worker pool: call setup_workers() first")
    return p


def get_inventories(
    file_re=None,
    *,
    pool: Optional[WorkerPool] = None,
    on_error: str = "raise",
    **kw,
) -> List[Union[List[InventoryRecord], WorkerError]]:
    """Fan the inventory crawl out to every worker; returns one (possibly
    empty) record list per worker, ordered like the pool's hosts
    (reference: ``GBT.getinventories``, src/gbt.jl:48-58)."""
    p = _pool(pool)

    def kwargs_for(w):
        d = dict(kw)
        d["worker"] = w.wid
        d["host"] = w.host
        if file_re is not None:
            d["file_re"] = file_re
        return d

    return p.broadcast(wf.get_inventory, kwargs_for, on_error=on_error)


def get_headers(
    worker_ids: Sequence[int],
    fnames: Sequence[str],
    *,
    pool: Optional[WorkerPool] = None,
    on_error: str = "raise",
) -> List[Dict]:
    """One header per (worker, fname) pair (reference: ``GBT.getheaders``,
    src/gbt.jl:60-67, including its size assertion)."""
    if len(worker_ids) != len(fnames):
        raise ValueError("worker_ids and fnames must have the same size")
    p = _pool(pool)
    return p.run_on(worker_ids, wf.get_header, [(f,) for f in fnames], on_error=on_error)


def get_data(
    worker_ids: Sequence[int],
    fnames: Sequence[str],
    idxs: Idxs = _ALL,
    fqav_by: int = 1,
    fqav_func: Optional[Callable] = None,
    *,
    pool: Optional[WorkerPool] = None,
    on_error: str = "raise",
) -> List[np.ndarray]:
    """One data slab per (worker, fname) pair, frequency-averaged
    worker-side (reference: ``GBT.getdata``, src/gbt.jl:69-79)."""
    if len(worker_ids) != len(fnames):
        raise ValueError("worker_ids and fnames must have the same size")
    p = _pool(pool)
    return p.run_on(
        worker_ids,
        wf.get_data,
        [(f, idxs) for f in fnames],
        kwargs={"fqav_by": fqav_by, "fqav_func": fqav_func},
        on_error=on_error,
    )


def get_kurtosis(
    worker_ids: Sequence[int],
    fnames: Sequence[str],
    idxs: Idxs = _ALL,
    device: Union[bool, str, None] = True,
    *,
    pool: Optional[WorkerPool] = None,
    on_error: str = "raise",
) -> List[np.ndarray]:
    """Per-file excess-kurtosis maps, shape (nchan, nifs) each (reference:
    ``GBT.getkurtosis``, src/gbt.jl:81-88).  Each worker's moment
    reduction runs as torch ops on its card unless ``device=False`` (the
    host NumPy path) or ``"cpu"`` is passed
    (:func:`blit_torch.workers.get_kurtosis`)."""
    if len(worker_ids) != len(fnames):
        raise ValueError("worker_ids and fnames must have the same size")
    p = _pool(pool)
    return p.run_on(
        worker_ids,
        wf.get_kurtosis,
        [(f, idxs) for f in fnames],
        kwargs={"device": device},
        on_error=on_error,
    )


def load_scan(
    inventories: Sequence[Sequence[InventoryRecord]],
    session: str,
    scan: str,
    suffix: str = "0002.h5",
    idxs: Idxs = _ALL,
    fqav_by: int = 1,
    fqav_func: Optional[Callable] = None,
    do_despike: bool = True,
    *,
    pool: Optional[WorkerPool] = None,
) -> Dict[int, Tuple[Dict, np.ndarray]]:
    """Load one (session, scan) across all bands: fetch every bank's file,
    stitch the 8 banks of each band into one contiguous band array along the
    channel axis (bank-ascending), and repair the per-coarse-channel DC
    spikes.

    The first-class rebuild of the reference's commented-out ``loadscan``
    (src/gbt.jl:90-114) — same stitch (``reduce(vcat, banks)``) and despike
    semantics, without the main-process-only limitation: this host-side path
    serves small/interactive reads (:func:`load_scan_mesh` runs the same
    product as a gather over the ``(band, bank)`` mesh).

    Returns ``{band: (stitched_header, stitched_array)}``; bands with missing
    banks are stitched from what exists (ragged results are first-class) with
    a warning.
    """
    from blit_torch.inventory import _is_worker_error

    recs = [
        r
        for inv in inventories
        if not _is_worker_error(inv)
        for r in inv
        if r.session == session and r.scan == scan and r.file.endswith(suffix)
    ]
    if not recs:
        return {}
    out: Dict[int, Tuple[Dict, np.ndarray]] = {}
    bands = sorted({r.band for r in recs})
    for band in bands:
        # One record per bank: duplicates (two workers inventorying the
        # same file on a shared filesystem, or two files claiming one
        # player) must not stitch the bank twice into a double-width
        # band.  First record per bank wins, like raw_sequences' dedup.
        by_bank: Dict[int, InventoryRecord] = {}
        for r in sorted((r for r in recs if r.band == band),
                        key=lambda r: r.bank):
            if r.bank in by_bank:
                if r.file != by_bank[r.bank].file:
                    log.warning(
                        "band %d bank %d: multiple files (%s kept, %s "
                        "dropped)", band, r.bank, by_bank[r.bank].file,
                        r.file,
                    )
                continue
            by_bank[r.bank] = r
        bankrecs = list(by_bank.values())
        if len(bankrecs) < 8:
            log.warning(
                "band %d: only banks %s present for %s/%s",
                band,
                [r.bank for r in bankrecs],
                session,
                scan,
            )
        wids = [r.worker for r in bankrecs]
        files = [r.file for r in bankrecs]
        datas = get_data(
            wids, files, idxs, fqav_by=fqav_by, fqav_func=fqav_func, pool=pool
        )
        hdrs = get_headers(wids, files, pool=pool)
        stitched = np.concatenate(datas, axis=-1)
        hdr = dict(hdrs[0])
        fch1, foff, _ = fqav_range(
            hdr["fch1"], hdr["foff"], hdr["nchans"], fqav_by
        )
        hdr.update(
            fch1=fch1,
            foff=foff,
            nchans=stitched.shape[-1],
            nsamps=stitched.shape[0],
            data_size=stitched.nbytes,
        )
        if do_despike:
            nfpc = max(int(hdr.get("nfpc", 0)) // max(fqav_by, 1), 0)
            if nfpc >= 2 and stitched.shape[-1] % nfpc == 0:
                stitched = _despike(stitched, nfpc)
            else:
                log.warning("band %d: skipping despike (nfpc=%s)", band, nfpc)
        out[band] = (hdr, stitched)
    return out


def reduce_raw(
    worker_ids: Sequence[int],
    raw_paths: Sequence[Union[str, Sequence[str]]],
    out_paths: Optional[Sequence[str]] = None,
    *,
    pool: Optional[WorkerPool] = None,
    on_error: str = "raise",
    **reducer_kw,
) -> List:
    """Fan GUPPI RAW → filterbank reduction out over the workers that own
    the files, one (worker, raw source) pair at a time — the distributed
    rawspec replacement (capability extension over the reference, which
    only reads already-reduced products; BASELINE.json configs 1-2).

    Each entry of ``raw_paths`` may be a single file path, a ``.NNNN.raw``
    sequence stem, or a path list (one scan's multi-file recording —
    :func:`blit_torch.inventory.raw_sequences` groups an inventory into
    exactly these units).  ``reducer_kw`` passes through to
    :func:`blit_torch.workers.reduce_raw` (``product=`` preset or
    ``nfft``/``nint``/``stokes``, and the reducer's knobs: each worker's
    reduction runs on its card unless ``device="cpu"``).
    """
    if len(worker_ids) != len(raw_paths):
        raise ValueError("worker_ids and raw_paths must have the same size")
    if out_paths is not None and len(out_paths) != len(raw_paths):
        raise ValueError("out_paths must match raw_paths")
    p = _pool(pool)
    args = [
        (rp,) if out_paths is None else (rp, op)
        for rp, op in zip(raw_paths, out_paths or raw_paths)
    ]
    return p.run_on(worker_ids, wf.reduce_raw, args, kwargs=reducer_kw,
                    on_error=on_error)

