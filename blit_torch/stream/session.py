"""Source specs: a :class:`~blit_torch.stream.source.ChunkSource` as a
plain JSON-able dict, rebuilt where the consumer runs.

Counterpart of ``source_from_spec`` in ``blit/stream/session.py``, with
the same kinds and keys::

    {"kind": "tail",   "raw": ..., "idle_timeout_s": ..., "done_path": ...}
    {"kind": "replay", "raw": ..., "rate": ...}
    {"kind": "packet", "host": ..., "port": ..., "rcvbuf": ...,
     "horizon": ...}
    {"kind": "packet-replay", "raw": ..., "rate": ..., "packet_ntime":
     ..., "drop": ..., "drop_blocks": [...], "reorder": ...,
     "dup": ..., "seed": ..., "horizon": ...}

``blit``'s ``SessionSupervisor``, which fans a session's seats across
supervised consumers, needs ``blit/recover.py`` and is not ported
(ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, Optional

from blit_torch.config import DEFAULT, SiteConfig
from blit_torch.observability import Timeline

SOURCE_KINDS = ("tail", "replay", "packet", "packet-replay")


def source_from_spec(spec: Dict, *, timeline: Optional[Timeline] = None,
                     config: SiteConfig = DEFAULT):
    """Build a :class:`~blit_torch.stream.source.ChunkSource` from its spec
    dict (module docstring), so a seat's source survives the trip
    through a JSON spec file or the worker wire."""
    kind = spec.get("kind", "tail")
    if kind == "tail":
        from blit_torch.stream.source import FileTailSource

        return FileTailSource(
            spec["raw"], idle_timeout_s=spec.get("idle_timeout_s"),
            done_path=spec.get("done_path"), config=config)
    if kind == "replay":
        from blit_torch.stream.source import ReplaySource

        return ReplaySource(spec["raw"], rate=spec.get("rate", 1.0))
    if kind == "packet":
        from blit_torch.stream.packet import PacketSource

        return PacketSource(
            spec.get("host"), spec.get("port"),
            rcvbuf=spec.get("rcvbuf"),
            reorder_horizon=spec.get("horizon"),
            timeline=timeline, config=config)
    if kind == "packet-replay":
        from blit_torch.stream.packet import PacketReplaySource

        return PacketReplaySource(
            spec["raw"], rate=spec.get("rate", 1.0),
            packet_ntime=spec.get("packet_ntime"),
            packet_nchan=spec.get("packet_nchan"),
            drop=spec.get("drop"),
            drop_blocks=spec.get("drop_blocks"),
            reorder=spec.get("reorder", 0.0),
            reorder_depth=spec.get("reorder_depth", 4),
            dup=spec.get("dup", 0.0),
            seed=spec.get("seed", 0),
            reorder_horizon=spec.get("horizon"),
            timeline=timeline, config=config)
    raise ValueError(
        f"unknown source kind {kind!r} (one of {SOURCE_KINDS})")
