"""Per-worker data-access functions.

Counterpart of ``blit/workers.py``, the rebuild of ``GBT.WorkerFunctions``
(src/gbtworkerfunctions.jl): every function here runs *on the host that
owns the files* (or in-process for the local and thread backends) and
returns reduced results — the reference's lever of reducing worker-side,
before the wire (SURVEY.md §3.3).

Index convention: arrays are C-order ``(time, pol, chan)`` (see
:mod:`blit_torch.ops.fqav`); ``idxs`` is a 3-tuple over those axes,
0-based, ints sanitized to length-1 slices so results are always 3-D
(reference: ``sanitizeidxs``, src/gbtworkerfunctions.jl:167-169).

Reads, headers and ``fqav`` run on the host in NumPy, as in ``blit``.
``get_kurtosis`` runs the moment reduction as torch ops on the card
unless ``device=False`` (the host NumPy path) or ``"cpu"`` is passed;
:func:`reduce_raw` and :func:`search_raw` build the port's
reducers, which run on the card unless ``device="cpu"`` is passed.
``.h5`` files are recognised by their signature
(:func:`blit_torch.io.fbh5.is_hdf5`, which needs no ``h5py``);
``h5py`` is imported only when an ``.h5`` file is read, so the ``.fil``
and RAW paths run where it is missing.  :func:`stream_raw` reduces or
searches a recording that is still being written, on the worker that
owns it (:mod:`blit_torch.stream`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from blit_torch import faults
from blit_torch.config import nfpc_from_foff
from blit_torch.inventory import get_inventory  # noqa: F401  (re-export: workers run it)
from blit_torch.io import sigproc
from blit_torch.ops.fqav import fqav, fqav_range
from blit_torch.ops.stats import kurtosis as _kurtosis

Idxs = Tuple


def _fbh5():
    """:mod:`blit_torch.io.fbh5`, imported on first use."""
    from blit_torch.io import fbh5

    return fbh5


def sanitize_idxs(idxs: Idxs) -> Idxs:
    """Replace integer indices with length-1 slices so indexing never drops
    a dimension (reference: src/gbtworkerfunctions.jl:167-169)."""
    return tuple(
        slice(i, i + 1) if isinstance(i, (int, np.integer)) else i for i in idxs
    )


def get_fb_header(path: str) -> Dict:
    """Normalized SIGPROC header: on-disk keywords + computed ``nfpc`` (the
    GBT constant 187.5/64 over |foff|), ``nsamps`` and ``data_size``; no
    ``header_size``/``sample_size`` — FBH5 parity (reference:
    src/gbtworkerfunctions.jl:131-139)."""
    hdr, _ = sigproc.read_fil_header(path)
    hdr["nfpc"] = nfpc_from_foff(hdr["foff"])
    hdr["data_size"] = (
        hdr["nsamps"] * hdr.get("nifs", 1) * hdr["nchans"] * hdr.get("nbits", 32) // 8
    )
    return dict(sorted(hdr.items()))


def get_fbh5_header(path: str) -> Dict:
    """Normalized FBH5 header (reference: src/gbtworkerfunctions.jl:141-155,
    with the missing-nfpc crash fixed)."""
    return _fbh5().read_fbh5_header(path)


def get_header(path: str) -> Dict:
    """Format dispatch (reference: src/gbtworkerfunctions.jl:157-159)."""
    return get_fbh5_header(path) if _fbh5().is_hdf5(path) else get_fb_header(path)


_ALL = (slice(None), slice(None), slice(None))


def get_fb_data(
    path: str,
    idxs: Idxs = _ALL,
    fqav_by: int = 1,
    fqav_func: Optional[Callable] = None,
) -> np.ndarray:
    """Memmap a .fil file, materialize the requested slab, frequency-average
    (reference: src/gbtworkerfunctions.jl:171-177; the explicit finalize is
    unnecessary here — the memmap unmaps on GC)."""
    if len(idxs) != 3:
        raise ValueError("idxs must have exactly three indices")

    def _read():
        # Transient NFS weather retries under faults.io_policy(); the
        # materializing copy happens inside so page-in faults retry too.
        faults.fire("workers.read", key=path)
        _, mm = sigproc.read_fil_data(path, mmap=True)
        data = np.ascontiguousarray(mm[idxs])
        del mm
        return data

    return fqav(faults.retry_io(_read, describe=f"read {path}"),
                fqav_by, f=fqav_func)


def get_fbh5_data(
    path: str,
    idxs: Idxs = _ALL,
    fqav_by: int = 1,
    fqav_func: Optional[Callable] = None,
) -> np.ndarray:
    """Hyperslab-read an FBH5 file then frequency-average — averaging is
    post-read, on the worker (reference: src/gbtworkerfunctions.jl:179-189)."""

    def _read():
        faults.fire("workers.read", key=path)
        return _fbh5().read_fbh5_data(path, idxs)

    return fqav(faults.retry_io(_read, describe=f"read {path}"),
                fqav_by, f=fqav_func)


def get_data(
    path: str,
    idxs: Idxs = _ALL,
    fqav_by: int = 1,
    fqav_func: Optional[Callable] = None,
) -> np.ndarray:
    """Sanitize indices, dispatch on format (reference:
    src/gbtworkerfunctions.jl:191-195)."""
    idxs = sanitize_idxs(idxs)
    reader = get_fbh5_data if _fbh5().is_hdf5(path) else get_fb_data
    return reader(path, idxs, fqav_by=fqav_by, fqav_func=fqav_func)


def get_kurtosis(path: str, idxs: Idxs = _ALL,
                 device: Union[bool, str, None] = True) -> np.ndarray:
    """Excess kurtosis over time per (chan, pol), full time resolution
    (reference: src/gbtworkerfunctions.jl:197-202).  Returns shape
    ``(nchan, nifs)`` to preserve the reference's ``[chan, if]`` indexing.

    By default (``device=True`` or None) the moment reduction runs as
    torch ops on the card (:func:`blit_torch.device.resolve_device`; it
    raises where there is none) — the reference's "ship the computation,
    return the reduced statistic" lever, only the small (nchan, nifs) map
    crossing back.  Integer products are reduced in float32 there, as
    ``blit``'s jitted kernel does.  A device name (``"cpu"``,
    ``"cuda:1"``) runs the same torch ops on that device; ``False`` runs
    ``blit``'s host NumPy path, bit for bit.
    """
    data = get_data(path, idxs)
    if device is False:
        return np.asarray(_kurtosis(data, axis=0)).T
    import torch

    from blit_torch.device import resolve_device

    dev = resolve_device(None if device is True else device)
    # A slab of a read-only memmap is copied: torch takes only writable
    # arrays.
    x = torch.from_numpy(np.require(data, requirements=["C", "W"])).to(dev)
    if not x.is_floating_point():
        x = x.float()
    return _kurtosis(x, axis=0).cpu().numpy().T


def get_freq_axis(header: Dict, fqav_by: int = 1) -> Tuple[float, float, int]:
    """The (fch1, foff, nchans) triple of a file's channel axis after
    optional frequency averaging — the range arithmetic the reference
    exposes as ``fqav(::AbstractRange, n)`` (src/gbtworkerfunctions.jl:27-33)."""
    return fqav_range(header["fch1"], header["foff"], header["nchans"], fqav_by)


def reduce_raw(
    raw_path,
    out_path: Optional[str] = None,
    product: Optional[str] = None,
    nfft: int = 1024,
    nint: int = 1,
    stokes: str = "I",
    resume: bool = False,
    **reducer_kw,
):
    """Reduce a GUPPI RAW recording to a filterbank product on this worker —
    the rawspec-equivalent stage the reference assumes already ran on each
    node (SURVEY.md §0 "File products").  ``raw_path`` may be a single file,
    a ``.NNNN.raw`` sequence stem, or a path list: multi-file scans stream
    as one gap-free reduction (:class:`blit_torch.io.guppi.GuppiScan`).

    ``product`` selects a standard rawspec preset ("0000"/"0001"/"0002",
    :data:`blit_torch.pipeline.PRODUCT_PRESETS`); otherwise
    ``nfft``/``nint``/``stokes`` configure the reduction directly, and
    ``reducer_kw`` passes the other :class:`~blit_torch.pipeline.RawReducer`
    knobs (``device`` among them: the card by default).  With ``out_path``
    the product is written (``.fil``/``.h5`` by extension) and the output
    header returned; without it, ``(header, data)`` come back over the
    wire (small products only).  ``resume=True`` (with an out_path)
    restarts an interrupted reduction from its cursor sidecar
    (:class:`blit_torch.pipeline.ReductionCursor`).
    """
    from blit_torch.observability import process_timeline
    from blit_torch.pipeline import RawReducer, reducer_for_product

    # Fan-out reductions record on the process-wide timeline by default,
    # as in blit (whose pool harvests it from each worker).  The Timeline
    # takes no lock: reductions running at once on a thread pool share
    # it, so its counts are approximate there; the products are not
    # touched by it.  Callers can still pass their own.
    reducer_kw.setdefault("timeline", process_timeline())
    if product is not None:
        if nfft != 1024 or nint != 1:
            raise ValueError(
                "reduce_raw: pass either product= or explicit nfft/nint, not both"
            )
        red = reducer_for_product(product, stokes=stokes, **reducer_kw)
    else:
        red = RawReducer(nfft=nfft, nint=nint, stokes=stokes, **reducer_kw)
    if out_path is not None:
        if resume:
            return red.reduce_resumable(raw_path, out_path)
        return red.reduce_to_file(raw_path, out_path)
    if resume:
        raise ValueError("reduce_raw: resume=True requires a .fil out_path")
    return red.reduce(raw_path)


def stream_raw(
    raw_path: str,
    out_path: str,
    search: bool = False,
    replay_rate: Optional[float] = None,
    lateness_s: Optional[float] = None,
    idle_timeout_s: Optional[float] = None,
    done_path: Optional[str] = None,
    source: Optional[dict] = None,
    nfft: int = 1024,
    nint: int = 1,
    **reducer_kw,
):
    """Reduce a recording live on this worker, the streaming twin of
    :func:`reduce_raw` / :func:`search_raw`: the host that owns the
    growing file tails it (:class:`blit_torch.stream.FileTailSource`),
    and only the product header crosses the wire.

    ``replay_rate`` replays an at-rest recording at that multiple of its
    cadence (:class:`blit_torch.stream.ReplaySource`); ``source`` is a
    source spec (:func:`blit_torch.stream.source_from_spec`: tail,
    replay, packet or packet-replay) and overrides both; ``search=True``
    writes a ``.hits`` product through
    :func:`blit_torch.stream.stream_search` instead of a filterbank.
    ``reducer_kw`` passes the reducer's knobs (``device`` among them: the
    card by default); the watermark knobs left ``None`` resolve from the
    site defaults + ``BLIT_STREAM_*`` on the worker.  A packet source's
    report comes back under ``_packet_report``."""
    from blit_torch.observability import process_timeline
    from blit_torch.stream import (
        FileTailSource,
        ReplaySource,
        source_from_spec,
        stream_reduce,
        stream_search,
    )

    reducer_kw.setdefault("timeline", process_timeline())
    if source is not None:
        spec = dict(source)
        spec.setdefault("raw", raw_path)
        src = source_from_spec(spec, timeline=reducer_kw["timeline"])
    elif replay_rate is not None:
        src = ReplaySource(raw_path, rate=replay_rate)
    else:
        src = FileTailSource(raw_path, idle_timeout_s=idle_timeout_s,
                             done_path=done_path)
    fn = stream_search if search else stream_reduce
    hdr = fn(src, out_path, lateness_s=lateness_s, nfft=nfft, nint=nint,
             **reducer_kw)
    if hasattr(src, "packet_report"):
        hdr = dict(hdr)
        hdr["_packet_report"] = src.packet_report()
    return hdr


def search_raw(
    raw_path,
    out_path: Optional[str] = None,
    nfft: int = 1024,
    nint: int = 1,
    resume: bool = False,
    **search_kw,
):
    """Drift-search a GUPPI RAW recording on this worker — the
    search-plane twin of :func:`reduce_raw`, so pools fan drift searches
    across the hosts that own the files exactly like reductions.

    With ``out_path`` a ``.hits`` product is written (``resume=True``
    restarts from its cursor sidecar) and the search header returned;
    without it, ``(header, hit_records)`` come back over the wire —
    records as plain dicts (:meth:`blit_torch.search.hits.Hit.record`) so
    the restricted agent transport never needs the Hit class.
    ``search_kw`` passes the
    :class:`~blit_torch.search.dedoppler.DedopplerReducer` knobs through
    (window_spectra / snr_threshold / top_k / max_drift_bins / device /
    ...); unset knobs resolve from the site defaults + ``BLIT_SEARCH_*``
    on the WORKER, as deployments expect."""
    from blit_torch.observability import process_timeline
    from blit_torch.search import DedopplerReducer

    search_kw.setdefault("timeline", process_timeline())
    red = DedopplerReducer(nfft=nfft, nint=nint, **search_kw)
    if out_path is not None:
        if resume:
            return red.search_resumable(raw_path, out_path)
        return red.search_to_file(raw_path, out_path)
    if resume:
        raise ValueError("search_raw: resume=True requires an out_path")
    header, hits = red.search(raw_path)
    return header, [h.record() for h in hits]
