"""Per-stage timing and byte accounting of a reduction.

Counterpart of the ``Timeline`` / stage part of ``blit/observability.py``.
The reducer records the stages ``ingest`` (file bytes read into the host
staging buffer), ``state`` (the PFB overlap carried between chunks),
``device`` (host→device copy, the channelizer, device→host copy) and
``write`` (product bytes written), plus ``stream`` (the wall clock of the
whole streaming loop).  End-to-end RAW GB/s is ``ingest`` bytes over
``stream`` seconds.  The search adds the stages ``search.window_fill``
(spectra copied into the window buffer) and ``search.write`` (``.hits``
lines written), and the per-window observations ``search.tree_s`` (the
window's H2D copy, drift transform, SNR, top-k and D2H of the packed
hits) and ``search.hits_per_window``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List


@dataclass
class StageStats:
    """Accumulated wall time and bytes of one stage."""

    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class Timeline:
    """A registry of named stage timings and per-event observations
    (one per reducer)."""

    stages: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))
    observations: Dict[str, List[float]] = field(
        default_factory=lambda: defaultdict(list))

    def observe(self, name: str, value: float) -> None:
        """Record one value of the per-event metric ``name``."""
        self.observations[name].append(value)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stages[name]
            s.calls += 1
            s.seconds += time.perf_counter() - t0
            s.bytes += nbytes
