"""``.hits`` product codec: the search plane's atomic-publish writer and
its reader.

Counterpart of ``blit/io/hits.py``, writing the same bytes: JSON lines,
the first a header record (``kind``, format version, the full search and
filterbank header), then one line per hit in stream order, every object
serialized with ``sort_keys=True``.  A file written by either package
reads in the other.

:class:`HitsWriter` streams into a ``.partial`` sibling renamed on
success, so a crash never leaves a complete-looking truncated product.
``blit``'s product manifest sidecar and its resumable writer come with
the resume slice (ROADMAP.md Queue 1); the ``.hits`` bytes do not depend
on them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

HITS_KIND = "blit.hits"
HITS_VERSION = 1


def _jsonable(header: Dict) -> Dict:
    out = {}
    for k, v in header.items():
        if isinstance(v, np.generic):
            v = v.item()
        out[k] = v
    return out


def header_line(header: Dict) -> str:
    """The deterministic first line of a ``.hits`` file."""
    return json.dumps(
        {"kind": HITS_KIND, "version": HITS_VERSION,
         "header": _jsonable(header)},
        sort_keys=True, default=str,
    ) + "\n"


class WindowHits:
    """One window's hit list, serialized once (``nbytes`` is what a
    writer accounts)."""

    __slots__ = ("window", "hits", "lines")

    def __init__(self, window: int, hits: List) -> None:
        self.window = window
        self.hits = hits
        self.lines = "".join(
            json.dumps(h.record(), sort_keys=True) + "\n" for h in hits
        )

    @property
    def nbytes(self) -> int:
        return len(self.lines)


class HitsWriter:
    """Streaming ``.hits`` writer published by renaming its ``.partial``
    sibling at :meth:`close`.  ``nsamps`` counts hits written."""

    def __init__(self, path: str, header: Dict) -> None:
        self.path = path
        self._tmp = path + ".partial"
        self._f = open(self._tmp, "w")
        self._f.write(header_line(header))
        self.nsamps = 0
        self.nwindows = 0

    def append(self, wh: WindowHits) -> None:
        self._f.write(wh.lines)
        self.nsamps += len(wh.hits)
        self.nwindows += 1

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self.flush()
        self._f.close()
        os.replace(self._tmp, self.path)

    def abort(self) -> None:
        """Error-path teardown: drop the ``.partial``."""
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass


def write_hits(path: str, header: Dict, hits: List) -> None:
    """One-shot atomic ``.hits`` publish of an in-memory hit list."""
    w = HitsWriter(path, header)
    try:
        w.append(WindowHits(-1, hits))
    except BaseException:
        w.abort()
        raise
    w.close()


def read_hits(path: str) -> Tuple[Dict, List]:
    """Read a ``.hits`` product → ``(header, hits)``, the hits as
    :class:`blit_torch.search.hits.Hit` objects."""
    from blit_torch.search.hits import hit_from_record

    header: Optional[Dict] = None
    hits = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if header is None:
                if doc.get("kind") != HITS_KIND:
                    raise ValueError(
                        f"{path}: not a {HITS_KIND} file "
                        f"(kind={doc.get('kind')!r})"
                    )
                header = doc["header"]
                continue
            hits.append(hit_from_record(doc))
    if header is None:
        raise ValueError(f"{path}: empty .hits file")
    return header, hits
