"""blit_torch.search — the drift-rate search plane on the device.

Counterpart of ``blit/search``: ``.hits`` products computed from the
same streaming reducer as the filterbank products (windowed spectra →
Taylor tree through the Hopper kernel → device-side threshold and
per-band top-k → ``.hits`` lines).

- :class:`~blit_torch.search.dedoppler.DedopplerReducer`: the entry point
  (``search`` / ``search_to_file`` / ``search_resumable`` / ``reduce``),
  and :class:`~blit_torch.search.dedoppler.SearchCursor`, the resume
  sidecar.
- :class:`~blit_torch.search.hits.Hit` and its record and array codecs.
- The kernel's wrapper lives in :mod:`blit_torch.ops.dedoppler`, the
  ``.hits`` writer in :mod:`blit_torch.io.hits`.
"""

from blit_torch.search.dedoppler import DedopplerReducer, SearchCursor
from blit_torch.search.hits import (
    Hit,
    hit_from_record,
    hits_from_array,
    hits_from_packed,
    hits_to_array,
)

__all__ = [
    "DedopplerReducer",
    "Hit",
    "SearchCursor",
    "hit_from_record",
    "hits_from_array",
    "hits_from_packed",
    "hits_to_array",
]
