"""blit_torch — the PyTorch/CUDA port of blit for NVIDIA Hopper.

The port sits beside the JAX package ``blit`` and keeps its public
contracts: the same module names, array layouts, product headers and
``.fil`` bytes.  It imports ``torch`` and numpy only — never ``jax`` and
never a module of ``blit`` — and keeps its own copies of what it needs.

This slice carries the main path: one bank's GUPPI RAW recording in,
the rawspec ``0000`` high-resolution filterbank product out
(:func:`blit_torch.pipeline.reducer_for_product`).  On a CUDA device the
channelizer runs two hand-written Hopper kernels (``blit_torch/csrc``);
on the CPU it runs their plain PyTorch twins.

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

__all__ = [
    "PRODUCT_PRESETS",
    "RawReducer",
    "ReductionStats",
    "channelize",
    "last_kernel_plan",
    "reducer_for_product",
    "resolve_device",
]
