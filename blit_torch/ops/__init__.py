"""Compute ops of the port: the planar DFT helpers, the channelizer, and
the two Hopper kernels of the main path with their plain twins."""
