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
