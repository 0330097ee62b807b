"""``blit_torch.stream``: the live plane, reducing while the telescope
records.

Counterpart of ``blit/stream``, with ``blit``'s ``__all__``.  The same reducers
are fed from sources still being written (a growing file, a paced
replay, a packet stream, an in-memory queue) through a watermark
assembler that repairs late, duplicate and missing chunks (missing ones
mask to zero weight), with chunk-to-product latency as a histogram.  A
stream of a completed recording through :func:`stream_reduce` /
:func:`stream_search` writes the same ``.fil`` / ``.h5`` / ``.hits``
bytes as the batch path.
"""

from blit_torch.stream.cursor import StreamCursor
from blit_torch.stream.packet import (
    PacketAssembler,
    PacketFramer,
    PacketReplaySource,
    PacketSource,
    packets_of,
)
from blit_torch.stream.plane import LiveRawStream, stream_reduce, stream_search
from blit_torch.stream.session import SessionSupervisor, source_from_spec
from blit_torch.stream.source import (
    ChunkSource,
    FileTailSource,
    QueueSource,
    ReplaySource,
    StreamChunk,
    chunks_of,
)

__all__ = [
    "ChunkSource",
    "FileTailSource",
    "LiveRawStream",
    "PacketAssembler",
    "PacketFramer",
    "PacketReplaySource",
    "PacketSource",
    "QueueSource",
    "ReplaySource",
    "SessionSupervisor",
    "StreamChunk",
    "StreamCursor",
    "chunks_of",
    "packets_of",
    "source_from_spec",
    "stream_reduce",
    "stream_search",
]
