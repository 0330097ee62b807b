"""``.hits`` product codec: the search plane's atomic-publish writer and
its reader.

Counterpart of ``blit/io/hits.py``, writing the same bytes: JSON lines,
the first a header record (``kind``, format version, the full search and
filterbank header), then one line per hit in stream order, every object
serialized with ``sort_keys=True``.  A file written by either package
reads in the other.

- :class:`HitsWriter` streams into a ``.partial`` sibling renamed on
  success, so a crash never leaves a complete-looking truncated product.
- :class:`ResumableHitsWriter` appends directly, with a cursor sidecar
  (:class:`blit_torch.search.dedoppler.SearchCursor`) that claims a
  window only after its lines are fsync'd; ``abort()`` keeps file and
  cursor as the resume point.
- Both publish a ``<product>.manifest.json`` sidecar
  (:mod:`blit_torch.integrity`) whose ledger holds a digest for every
  claimed window count, so a resume verifies the claimed bytes first.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

HITS_KIND = "blit.hits"
HITS_VERSION = 1

# Bound on a resumable writer's per-window claim ledger
# (``cursor.window_claims``, ``[window, byte_offset, hits]`` triples):
# every append re-serializes and fsyncs the whole cursor, so the ledger
# must not grow with the session.  A restart older than the kept tail is
# refused, never guessed.
CLAIM_LEDGER_MAX = 4096


def ledger_claim_at(windows: int, windows_done: int, byte_offset: int,
                    hits_done: int, claims) -> Optional[Tuple[int, int]]:
    """The ledger rule of the search cursors: the head claim resolves
    directly, earlier windows through a ``[window, byte_offset, hits]``
    entry; anything else (no ledger, a trimmed window) is None and the
    caller refuses."""
    if windows == windows_done:
        return byte_offset, hits_done
    if claims is None or windows <= 0:
        return None
    for w, off, hits in reversed(claims):
        if w == windows:
            return int(off), int(hits)
    return None


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
    sibling at :meth:`close`.  ``nsamps`` counts hits written.  The
    manifest's running CRC folds every byte in write order, so once
    complete it is the whole-file digest."""

    def __init__(self, path: str, header: Dict) -> None:
        from blit_torch import integrity

        self.path = path
        self._tmp = path + ".partial"
        self._f = open(self._tmp, "w")
        hl = header_line(header)
        self._f.write(hl)
        self._mf = integrity.ManifestWriter(path, "hits",
                                            writer=type(self).__name__)
        self._mf.fold(hl.encode())
        self.nsamps = 0
        self.nwindows = 0

    def append(self, wh: WindowHits) -> None:
        self._f.write(wh.lines)
        self.nsamps += len(wh.hits)
        self.nwindows += 1
        self._mf.fold(wh.lines.encode())
        self._mf.claim(self.nwindows)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self.flush()
        self._f.close()
        os.replace(self._tmp, self.path)
        self._mf.publish()

    def abort(self) -> None:
        """Error-path teardown: drop the ``.partial``."""
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass


class ResumableHitsWriter:
    """Append-directly ``.hits`` writer whose incompleteness marker is a
    cursor sidecar: a window's lines are fsync'd before the cursor claims
    them, so a crash leaves a resumable prefix, never a cursor ahead of
    the bytes.  ``start_windows`` > 0 resumes: the file is truncated to
    the byte offset the cursor claims for that window (dropping any
    unclaimed tail); 0 or a missing file starts fresh."""

    def __init__(self, path: str, header: Dict, start_windows: int,
                 cursor) -> None:
        from blit_torch import integrity

        self.path = path
        self.cursor = cursor
        self._mf = integrity.ManifestWriter(path, "hits",
                                            writer=type(self).__name__)
        if start_windows > 0 and os.path.exists(path):
            claim = cursor.claim_at(start_windows)
            if claim is None:
                # Truncating somewhere else than start_windows would
                # duplicate or drop windows mid-product.
                raise ValueError(
                    f"{path}: cursor cannot resolve a truncation point "
                    f"for window {start_windows} (claimed "
                    f"{cursor.windows_done}; claim ledger absent or "
                    f"trimmed) — delete the sidecar to restart fresh")
            off, hits = claim
            with open(path, "r+b") as f:
                f.truncate(off)
            cursor.windows_done = start_windows
            cursor.hits_done = hits
            cursor.byte_offset = off
            if cursor.window_claims is not None:
                cursor.window_claims = [e for e in cursor.window_claims
                                        if e[0] <= start_windows]
            cursor.save(path)
            # Rebuild the running digest over the (verified) claim and
            # checkpoint the manifest at the restart point.
            self._mf.fold_path(path)
            self._mf.claim(start_windows)
            self._mf.save()
            self._f = open(path, "a")
        else:
            self._f = open(path, "w")
            self._f.write(header_line(header))
            self._f.flush()
            os.fsync(self._f.fileno())
            cursor.windows_done = 0
            cursor.hits_done = 0
            cursor.byte_offset = self._f.tell()
            cursor.window_claims = []
            cursor.save(path)
            self._mf.fold_path(path)
            self._mf.save()
        # Cumulative over the whole product, resumed windows included.
        self.nsamps = cursor.hits_done
        self.nwindows = cursor.windows_done

    def append(self, wh: WindowHits) -> None:
        self._f.write(wh.lines)
        # Durable lines, then the manifest, then the cursor's claim: the
        # ledger always holds an entry for every count a cursor claims.
        self._f.flush()
        os.fsync(self._f.fileno())
        self.nsamps += len(wh.hits)
        self.nwindows += 1
        self._mf.fold(wh.lines.encode())
        self._mf.claim(self.nwindows)
        self._mf.save()
        self.cursor.windows_done = self.nwindows
        self.cursor.hits_done = self.nsamps
        self.cursor.byte_offset = self._f.tell()
        claims = self.cursor.window_claims
        if claims is not None:
            claims.append([self.nwindows, self.cursor.byte_offset, self.nsamps])
            del claims[:-CLAIM_LEDGER_MAX]
        self.cursor.save(self.path)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        """Finish: the cursor sidecar goes (its absence marks the product
        complete), the manifest turns complete and stays."""
        self._f.close()
        self._mf.publish()
        sidecar = self.cursor.path_for(self.path)
        if os.path.exists(sidecar):
            os.unlink(sidecar)

    def abort(self) -> None:
        # The file and the cursor are the resume point: keep both.
        self._f.close()


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
