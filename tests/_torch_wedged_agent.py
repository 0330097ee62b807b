"""Misbehaving stand-ins for ``python -m blit_torch.agent``.

Default: wedged but alive — handshakes, consumes requests, never replies
(a hung NFS mount or a stuck ssh).  ``ANSWER_FIRST=1`` serves the first
request with "pong" and wedges from the second on, so the client's
reuse-time ping is what trips.  ``DIE_ONCE=<marker path>``: the first
agent started (the marker absent) creates the marker and dies while
serving its first request; later agents serve normally.
"""

import os
import sys
import time

from blit_torch.agent import MAGIC, read_msg, serve, write_msg

out = sys.stdout.buffer
marker = os.environ.get("DIE_ONCE")
if marker:
    if os.path.exists(marker):
        out.write(MAGIC)
        out.flush()
        serve(sys.stdin.buffer, out)
        sys.exit(0)
    open(marker, "w").close()
out.write(MAGIC)
out.flush()
if marker:
    read_msg(sys.stdin.buffer)
    os._exit(1)
if os.environ.get("ANSWER_FIRST") == "1":
    read_msg(sys.stdin.buffer)
    write_msg(out, ("ok", "pong"))
# Keep consuming requests without ever answering (EOF: the client closed
# the pipe on purpose, so exit and keep pool shutdown fast).
while True:
    try:
        read_msg(sys.stdin.buffer)
    except (EOFError, OSError):
        sys.exit(0)
    time.sleep(0)
