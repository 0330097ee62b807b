"""Compute ops of the port: the planar DFT helpers, the channelizer, the
Hopper kernels with their plain twins, and the reference's host-side
statistics (``fqav``, ``kurtosis``, ``despike``) on NumPy arrays and
torch tensors alike."""

from blit_torch.ops import despike
from blit_torch.ops.fqav import fqav, fqav_range
from blit_torch.ops.stats import kurtosis

__all__ = ["despike", "fqav", "fqav_range", "kurtosis"]
