"""blit_torch — the PyTorch/CUDA port of blit for NVIDIA Hopper.

The port sits beside the JAX package ``blit`` and keeps its public
contracts: the same module names, array layouts, product headers and
``.fil`` bytes.  It imports ``torch`` and numpy only — never ``jax`` and
never a module of ``blit`` — and keeps its own copies of what it needs.

The main path: one bank's GUPPI RAW recording in, rawspec's three
filterbank products out — ``0000`` (nfft 2^20), ``0001`` (nfft 8, nint
128) and ``0002`` (nfft 1024, nint 2048) — through
:func:`blit_torch.pipeline.reducer_for_product`, or any nfft that
``default_factors`` splits, one pol or two, through
``RawReducer(nfft=...)``.  On a CUDA device the channelizer runs six hand-written
Hopper kernels (``blit_torch/csrc``: ``pfb_dft1``, ``tail2_detect``,
``pfb_dequant``, ``dft_stage``, ``dft_last``, ``dft_tail2``); on the CPU
it runs their plain PyTorch twins.  It takes ``blit``'s kernel knobs
(``fft_method``, ``dft_order``, ``pfb_kernel``, ``tail_kernel``,
``detect_kernel``): ``detect_kernel="pallas"`` runs a tenth kernel,
``detect_untwist_i``, on the twisted spectra of ``dft(order="twisted")``.

The search plane: :class:`blit_torch.search.DedopplerReducer` turns the
same recording into the Stokes-I spectra stream, fixed windows, the
Taylor-tree drift transform of both signs through a seventh kernel
(``taylor_tree``), per-drift SNR, a device-side threshold and per-band
top-k, and writes a ``.hits`` product.

The antenna-array plane (:mod:`blit_torch.parallel`): per-antenna RAW
recordings → tied-array beam power through an eighth kernel
(``fused_beamform_detect``) and FX visibilities through the F-engine's
``dft_last`` and a ninth (``xengine_packed``), on one card.

The reducer, the search and the array streams run on ``blit``'s
asynchronous ingest and output plane (:mod:`blit_torch.pipeline`'s
``BufferRotation``, :mod:`blit_torch.outplane`, :mod:`blit_torch.hostmem`):
host reads, the device's work, readback and the file write overlap;
``async_output=False`` runs the synchronous path, byte-identical.

Around the path, as in ``blit``: ``.h5`` products
(:mod:`blit_torch.io.fbh5`, bitshuffle through the port's own codec),
crash-resumable reductions and searches (``reduce_resumable``,
``search_resumable``), product manifests and RAW digest checks
(:mod:`blit_torch.integrity`), the fault registry
(:mod:`blit_torch.faults`), multi-file ``.NNNN.raw`` scans and the
threaded native reader (:mod:`blit_torch.io.guppi`, built with g++ at
first use).

The reference's own API (:mod:`blit_torch.gbt` over
:mod:`blit_torch.workers`, as ``blit.gbt`` / ``blit.workers``):
inventories of a site's data tree (:mod:`blit_torch.inventory`,
:mod:`blit_torch.naming`), headers, ``get_data`` with ``fqav``,
``get_kurtosis`` (torch ops on the card with ``device=True``),
``load_scan`` (the eight banks of a band stitched, the DC spikes
repaired) and the ``reduce_raw`` fan-out, over a worker pool
(:mod:`blit_torch.parallel.pool`: local, thread, process or remote
``python -m blit_torch.agent`` workers).  These submodules load on
first access, as ``blit``'s do.

The live plane (:mod:`blit_torch.stream`: ``stream_reduce`` /
``stream_search`` from a growing file, a paced replay or a packet
stream, with watermark masking, rejoin and chunk-to-product latency),
per-rig tuning profiles and the online tuner (:mod:`blit_torch.tune`),
the metrics publisher (:mod:`blit_torch.monitor`) and ``python -m
blit_torch`` (``reduce``, ``search``, ``stream``, ``inventory``,
``info``, ``tune``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from blit_torch.device import resolve_device
from blit_torch.ops.channelize import channelize, last_kernel_plan
from blit_torch.pipeline import (
    PRODUCT_PRESETS,
    RawReducer,
    ReductionStats,
    reducer_for_product,
)
from blit_torch.search import DedopplerReducer

__all__ = [
    "DedopplerReducer",
    "PRODUCT_PRESETS",
    "RawReducer",
    "ReductionStats",
    "channelize",
    "last_kernel_plan",
    "reducer_for_product",
    "resolve_device",
]

# Submodules that load on first access (blit's lazy surface).
_LAZY = ("gbt", "workers", "inventory", "naming", "config", "testing",
         "faults", "observability", "agent", "integrity", "hostmem",
         "outplane", "io", "ops", "parallel", "pipeline", "search",
         "stream", "tune", "monitor")
# The live plane's front-door names, re-exported from blit_torch.stream
# on first access (as blit's are).
_STREAM_EXPORTS = ("stream_reduce", "stream_search")


def __getattr__(name):
    if name in _STREAM_EXPORTS:
        import importlib

        return getattr(importlib.import_module("blit_torch.stream"), name)
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"blit_torch.{name}")
    raise AttributeError(f"module 'blit_torch' has no attribute {name!r}")
