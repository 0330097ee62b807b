"""Product integrity: RAW digest sidecars, product manifests and the
verification of resume claims and finished products.

Counterpart of the product half of ``blit/integrity.py``, with the same
sidecar formats, so either package verifies what the other wrote.  All
digests are ``zlib.crc32`` (the threat is bit rot and torn writes):

- **Ingest digests**: an optional ``<member>.digests.json`` sidecar
  holds one CRC per RAW block over its on-disk payload
  (:func:`write_raw_digests`).  When it exists,
  :class:`blit_torch.io.guppi.GuppiRaw` verifies every block it delivers
  and zero-fills a block that fails, so the product equals a reduction
  of the recording with that block zeroed; the reducer records it in
  the header (``_masked_blocks``).  ``BLIT_VERIFY_INGEST=0`` turns the
  check off.
- **Product manifests**: every ``.fil``, ``.h5`` and ``.hits`` writer
  publishes ``<product>.manifest.json`` (:class:`ManifestWriter`): a
  ledger of per-claim digests, which the resumable writers save beside
  their cursor, and the whole-file CRC once complete.  Resume paths
  verify the claimed region against the ledger before trusting a cursor
  (:func:`verify_claim`); :func:`verify_product` verifies a product.

``blit``'s operator half (``fsck``, quarantine, the ``Scrubber`` and the
rederivation of cache entries) needs the serve cache and is not ported
yet.  Imports: stdlib and numpy at module scope, the port's I/O lazily.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("blit_torch.integrity")

MANIFEST_KIND = "blit.manifest"
MANIFEST_VERSION = 1
MANIFEST_SUFFIX = ".manifest.json"

DIGESTS_KIND = "blit.digests"
DIGESTS_VERSION = 1
DIGESTS_SUFFIX = ".digests.json"

# Claim-ledger bound (as blit_torch.io.hits.CLAIM_LEDGER_MAX):
# every resumable append re-serializes the manifest, so the ledger must
# not grow with session length.  Claims older than the trimmed tail
# verify through the newest surviving earlier entry (prefix coverage).
LEDGER_MAX = 4096

# Chunk size for streaming file CRCs (bounded memory over TB products).
_CRC_CHUNK = 8 << 20


class IntegrityError(ValueError):
    """A malformed/corrupt integrity sidecar (digests file that does not
    parse, wrong kind, ...) — loud by design: reducing against a sidecar
    that cannot be trusted silently would defeat the whole plane."""


# -- crc helpers -------------------------------------------------------------


def crc32_update(crc: int, buf) -> int:
    """Fold ``buf`` (any C-contiguous buffer: bytes, int8 ndarray, a
    memmap slice) into a running CRC32."""
    return zlib.crc32(buf, crc) & 0xFFFFFFFF


def crc32_file(path: str, start: int = 0, length: Optional[int] = None,
               crc: int = 0) -> int:
    """Streaming CRC32 over ``path[start : start+length)`` (to EOF when
    ``length`` is None) at bounded memory."""
    with open(path, "rb") as f:
        f.seek(start)
        remaining = length
        while True:
            take = _CRC_CHUNK if remaining is None else min(
                _CRC_CHUNK, remaining)
            if take <= 0:
                break
            chunk = f.read(take)
            if not chunk:
                if remaining is not None:
                    raise IntegrityError(
                        f"{path}: EOF {remaining} bytes before the end of "
                        "the digested region")
                break
            crc = crc32_update(crc, chunk)
            if remaining is not None:
                remaining -= len(chunk)
    return crc


def hex_crc(crc: int) -> str:
    return f"{crc & 0xFFFFFFFF:08x}"


def parse_crc(s) -> Optional[int]:
    try:
        return int(str(s), 16) & 0xFFFFFFFF
    except (TypeError, ValueError):
        return None


def _atomic_json(path: str, doc: Dict) -> None:
    """The sidecar publish rule (the ReductionCursor.save discipline):
    write-temp, fsync, ``os.replace`` — a reader sees a whole sidecar or
    none, never a torn one."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- counters / telemetry ----------------------------------------------------


def incr(name: str, n: int = 1) -> None:
    """Bump a process-wide ``integrity.*`` counter through
    :func:`blit_torch.faults.incr` (``faults.counters()`` and the flight
    recorder's ring)."""
    from blit_torch import faults

    faults.incr(name, n)


def observe_verify(seconds: float, timeline=None) -> None:
    """Record one verification pass into the ``integrity.verify_s``
    histogram (process-wide, plus the caller's timeline when given)."""
    try:
        from blit_torch.observability import process_timeline

        process_timeline().observe("integrity.verify_s", seconds)
        if timeline is not None:
            timeline.observe("integrity.verify_s", seconds)
    except Exception:  # noqa: BLE001 — telemetry must not fail verification
        pass


def ingest_verify_enabled() -> bool:
    """Honor RAW digest sidecars?  On by default; ``BLIT_VERIFY_INGEST=0``
    is the drill/bench escape hatch (a sidecar only costs anything when
    it exists next to the recording)."""
    return os.environ.get("BLIT_VERIFY_INGEST", "1") not in (
        "0", "false", "False")


# -- RAW digest sidecars -----------------------------------------------------


def raw_digests_path(member: str) -> str:
    return member + DIGESTS_SUFFIX


def _iter_block_crcs(member: str):
    """Yield ``(index, crc)`` over a RAW member's whole on-disk blocks —
    the one block walk the sidecar writer and the verifier share, so
    what a "block's bytes" means can never drift between them.
    Truncated trailing blocks are skipped exactly as GuppiRaw skips
    them; the file is read directly (never through the ``guppi.read``
    injection point — digests describe the bytes on disk, not a
    drilled delivery)."""
    from blit_torch.io.guppi import read_raw_header

    with open(member, "rb") as f:
        size = os.path.getsize(member)
        i = 0
        while True:
            try:
                hdr, off = read_raw_header(f)
            except EOFError:
                break
            blocsize = int(hdr["BLOCSIZE"])
            if off + blocsize > size:
                break
            crc = 0
            remaining = blocsize
            while remaining:
                chunk = f.read(min(_CRC_CHUNK, remaining))
                if not chunk:
                    raise IntegrityError(f"{member}: short read mid-block")
                crc = crc32_update(crc, chunk)
                remaining -= len(chunk)
            yield i, crc
            i += 1


def write_raw_digests(member: str) -> str:
    """Compute and atomically publish the per-block digest sidecar of one
    RAW member: one CRC32 per block over its on-disk payload bytes
    (``[data_offset, data_offset + BLOCSIZE)``)."""
    blocks = [hex_crc(crc) for _i, crc in _iter_block_crcs(member)]
    path = raw_digests_path(member)
    _atomic_json(path, {
        "kind": DIGESTS_KIND, "version": DIGESTS_VERSION, "algo": "crc32",
        "member": os.path.basename(member), "blocks": blocks,
    })
    return path


def load_raw_digests(member: str) -> Optional[List[int]]:
    """Parse a member's digest sidecar → per-block CRC list, or None when
    absent.  A sidecar that EXISTS but does not parse raises
    :class:`IntegrityError` — never reduce against an untrustworthy
    sidecar silently."""
    path = raw_digests_path(member)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("kind") != DIGESTS_KIND:
            raise ValueError(f"kind={doc.get('kind')!r}")
        out = []
        for s in doc["blocks"]:
            crc = parse_crc(s)
            if crc is None:
                raise ValueError(f"bad digest {s!r}")
            out.append(crc)
        return out
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise IntegrityError(
            f"{path}: malformed RAW digest sidecar ({e}); remove or "
            "regenerate it (blit_torch.integrity.write_raw_digests)") from e


def verify_raw_member(member: str) -> List[str]:
    """Re-derive a RAW member's per-block digests against its sidecar →
    problem strings (empty = verified).  A rotten block is reported
    here (and zero-masked at ingest by GuppiRaw), never moved: RAW
    members are the read-only source of truth."""
    try:
        digests = load_raw_digests(member)
    except IntegrityError as e:
        return [str(e)]
    if digests is None:
        return []
    problems: List[str] = []
    blocks = 0
    try:
        for i, crc in _iter_block_crcs(member):
            blocks = i + 1
            if i < len(digests) and crc != digests[i]:
                problems.append(
                    f"block {i} digest mismatch ({hex_crc(crc)} != "
                    f"{hex_crc(digests[i])})")
        if blocks < len(digests):
            problems.append(
                f"member holds {blocks} whole blocks, sidecar digests "
                f"{len(digests)} (truncated since digesting?)")
    except (OSError, IntegrityError) as e:
        problems.append(f"unreadable member: {e}")
    if problems:
        incr("integrity.bad_block", len(problems))
    return problems


# -- product manifests -------------------------------------------------------


def manifest_path(product: str) -> str:
    return product + MANIFEST_SUFFIX


class ManifestWriter:
    """The per-writer manifest accumulator: a running content CRC, a
    bounded per-window claim ledger, and the atomic sidecar publish.

    CRC space is per format: ``fil`` and ``hits`` fold the FILE bytes in
    write order (header first), so the running CRC at any claim equals
    ``crc32_file(path, 0, nbytes)`` and the completed running CRC *is*
    the whole-file CRC; ``fbh5`` folds the LOGICAL dataset rows (libhdf5
    metadata churn makes file-byte space meaningless mid-stream) and the
    whole-file CRC is computed by one re-read at close
    (``publish(scan_file=True)``).

    Ledger entries are ``[rows, nbytes, crc-hex]`` — rows claimed, bytes
    folded so far, running CRC — and :func:`verify_claim` replays them.
    ``save`` is best-effort (a failing manifest write must never fail the
    product it describes); the counters say when it happened.
    """

    def __init__(self, final_path: str, fmt: str, *, data_offset: int = 0,
                 row_bytes: int = 0, fingerprint: Optional[str] = None,
                 writer: str = ""):
        self.final_path = final_path
        self.fmt = fmt
        self.data_offset = data_offset
        self.row_bytes = row_bytes
        self.fingerprint = fingerprint
        self.writer = writer
        self.crc = 0
        self.nbytes = 0
        self.rows = 0
        self.ledger: List[List] = []

    # -- accumulation ------------------------------------------------------
    def fold(self, buf) -> None:
        """Fold appended content (bytes / contiguous ndarray)."""
        self.crc = crc32_update(self.crc, buf)
        self.nbytes += memoryview(buf).nbytes

    def fold_path(self, path: str, length: Optional[int] = None) -> None:
        """Fold existing file bytes (header prologue; resume rebuild)."""
        n = os.path.getsize(path) if length is None else length
        self.crc = crc32_file(path, 0, n, self.crc)
        self.nbytes += n

    def claim(self, rows: int) -> None:
        """Record a durable claim at ``rows`` with the current CRC."""
        self.rows = rows
        self.ledger.append([int(rows), int(self.nbytes),
                            hex_crc(self.crc)])
        del self.ledger[:-LEDGER_MAX]

    # -- publish -----------------------------------------------------------
    def _doc(self, complete: bool, file_bytes: Optional[int],
             file_crc: Optional[int]) -> Dict:
        return {
            "kind": MANIFEST_KIND, "version": MANIFEST_VERSION,
            "product": os.path.basename(self.final_path),
            "format": self.fmt,
            "complete": bool(complete),
            "rows": int(self.rows),
            "data_offset": int(self.data_offset),
            "row_bytes": int(self.row_bytes),
            "data_crc32": hex_crc(self.crc),
            "bytes": file_bytes,
            "crc32": hex_crc(file_crc) if file_crc is not None else None,
            "windows": list(self.ledger),
            "fingerprint": self.fingerprint,
            "writer": {"writer": self.writer,
                       "host": socket.gethostname(), "pid": os.getpid(),
                       "t": time.time()},
        }

    def save(self, complete: bool = False,
             file_bytes: Optional[int] = None,
             file_crc: Optional[int] = None) -> bool:
        """Atomically (re)publish the sidecar; best-effort (returns
        whether it landed — products must not fail on manifest I/O)."""
        try:
            _atomic_json(manifest_path(self.final_path),
                         self._doc(complete, file_bytes, file_crc))
            return True
        except OSError:
            incr("integrity.manifest.error")
            log.warning("manifest publish of %s failed",
                        self.final_path, exc_info=True)
            return False

    def publish(self, scan_file: bool = False) -> bool:
        """Publish the COMPLETE manifest for the finished product at
        ``final_path``.  ``scan_file=True`` re-reads the file for the
        whole-file CRC (the fbh5 path — its running CRC is logical);
        otherwise the running CRC is the file CRC (fil/hits)."""
        try:
            size = os.path.getsize(self.final_path)
            crc = (crc32_file(self.final_path) if scan_file else self.crc)
        except OSError:
            incr("integrity.manifest.error")
            log.warning("manifest publish of %s failed",
                        self.final_path, exc_info=True)
            return False
        return self.save(complete=True, file_bytes=size, file_crc=crc)


def try_load_manifest(product: str
                      ) -> Tuple[Optional[Dict], Optional[str]]:
    """``(doc, problem)`` for a product's manifest: ``(None, None)`` when
    absent, ``(None, "why")`` when present but unusable (torn JSON,
    wrong kind — fail closed, never trust), ``(doc, None)`` when it
    parses."""
    path = manifest_path(product)
    if not os.path.exists(path):
        return None, None
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("kind") != MANIFEST_KIND:
            return None, f"not a {MANIFEST_KIND} document"
        return doc, None
    except (OSError, ValueError) as e:
        return None, f"unreadable/torn manifest: {e}"


def _ledger_entry(doc: Dict, rows: int) -> Optional[List]:
    """The EXACT ledger entry for a claim of ``rows``.  Exact, not
    at-or-before: the writers checkpoint the manifest between the data
    fsync and the cursor save, so every row count a cursor can legally
    claim has an entry — a missing one means a tampered/foreign ledger
    or a claim older than the trimmed tail, and a prefix check would
    leave the gap ``(entry, rows]`` unverified yet resumed-into.  Any
    malformed entry makes the whole ledger unusable (fail closed)."""
    best = None
    for e in doc.get("windows") or []:
        try:
            r, nb, crc = int(e[0]), int(e[1]), str(e[2])
        except (TypeError, ValueError, IndexError):
            return None  # a torn ledger is an unusable ledger
        if r == rows:
            best = [r, nb, crc]
    return best


def verify_claim(product: str, rows: int, *, fmt: str,
                 row_bytes: int = 0, timeline=None,
                 strict: bool = True) -> Optional[bool]:
    """Content-verify a resume claim of ``rows`` rows/windows against the
    product's manifest ledger.

    Returns ``None`` when no manifest exists (legacy product — the
    caller keeps its length-only probe), ``True`` when the best covering
    claim's digest matches the bytes on disk, ``False`` on ANY doubt: a
    manifest that does not parse, a format/shape mismatch, a missing
    covering entry for a nonzero claim, or a digest mismatch (torn write
    inside the claimed region, tampered sidecar, replaced product) —
    fail closed, the caller restarts fresh.

    ``strict=False`` (the fsck walk) additionally returns ``None`` when
    the recompute ERRORED rather than mismatched — a file that cannot
    be read right now is usually a LIVE writer holding it (HDF5 write
    locks), and an observer must not quarantine work in progress; the
    resume paths keep ``strict=True`` because the resuming writer owns
    the file and an unreadable target must fail closed."""
    doc, problem = try_load_manifest(product)
    if doc is None:
        if problem is None:
            return None
        incr("integrity.manifest.mismatch")
        log.warning("%s: %s; refusing to trust the resume claim",
                    product, problem)
        return False
    try:
        doc_row_bytes = int(doc.get("row_bytes") or 0)
    except (TypeError, ValueError):
        doc_row_bytes = -1  # malformed: never matches
    if doc.get("format") != fmt or (
            row_bytes and doc_row_bytes not in (0, row_bytes)):
        incr("integrity.manifest.mismatch")
        log.warning("%s: manifest describes a different product shape "
                    "(format=%s row_bytes=%s); refusing the resume claim",
                    product, doc.get("format"), doc.get("row_bytes"))
        return False
    if rows <= 0:
        return True
    entry = _ledger_entry(doc, rows)
    if entry is None:
        incr("integrity.manifest.mismatch")
        log.warning("%s: manifest has no claim entry for row %d "
                    "(tampered/foreign ledger, or a claim older than "
                    "the trimmed tail); refusing the resume claim",
                    product, rows)
        return False
    e_rows, e_bytes, e_crc = entry
    expected = parse_crc(e_crc)
    if expected is None:
        incr("integrity.manifest.mismatch")
        return False
    t0 = time.perf_counter()
    err = False
    try:
        if fmt == "fbh5":
            got = _fbh5_rows_crc(product, e_rows)
        else:  # fil / hits: file-byte prefix space
            if os.path.getsize(product) < e_bytes:
                got = None
            else:
                got = crc32_file(product, 0, e_bytes)
    except Exception:  # noqa: BLE001 — classified below
        got = None
        err = True
    observe_verify(time.perf_counter() - t0, timeline)
    if err and not strict:
        log.warning("%s: claim unverifiable right now (read error — "
                    "a live writer?); leaving it alone", product)
        return None
    if got != expected:
        incr("integrity.resume.mismatch")
        log.warning(
            "%s: claimed region digest mismatch at row %d (%s != %s) — "
            "torn write or tampered sidecar; failing closed",
            product, e_rows, hex_crc(got) if got is not None else "<err>",
            e_crc)
        return False
    incr("integrity.resume.verified")
    return True


def _fbh5_rows_crc(path: str, rows: int) -> Optional[int]:
    """CRC over the logical dataset rows ``[0, rows)`` of an FBH5
    product, read in bounded row chunks (manual bitshuffle decode
    included via :func:`blit_torch.io.fbh5.read_fbh5_data`)."""
    import h5py

    from blit_torch.io.fbh5 import read_fbh5_data

    with h5py.File(path, "r") as h5:
        ds = h5["data"]
        if ds.shape[0] < rows:
            return None
        row_bytes = int(np.prod(ds.shape[1:])) * ds.dtype.itemsize
    step = max(1, _CRC_CHUNK // max(1, row_bytes))
    crc = 0
    for a in range(0, rows, step):
        b = min(rows, a + step)
        slab = read_fbh5_data(path, (slice(a, b), slice(None), slice(None)))
        crc = crc32_update(crc, np.ascontiguousarray(slab))
    return crc


def verify_product(path: str, *, timeline=None
                   ) -> Tuple[Optional[Dict], List[str]]:
    """Verify one product against its manifest → ``(manifest, problems)``.

    No manifest → ``(None, [])`` (unmanifested — reported, not failed).
    Complete manifests verify size + whole-file CRC (any single flipped
    byte anywhere in the file is caught); incomplete manifests (a
    resumable writer mid-stream or crashed) verify the newest claimed
    prefix through the ledger.  Every problem string is operator-facing.
    """
    doc, problem = try_load_manifest(path)
    if doc is None:
        return (None, [problem] if problem else [])
    problems: List[str] = []
    if not os.path.exists(path):
        problems.append("product missing (manifest orphaned)")
        return doc, problems
    size = os.path.getsize(path)
    try:
        want = doc.get("bytes")
        want = int(want) if want is not None else None
        claimed_rows = int(doc.get("rows") or 0)
    except (TypeError, ValueError):
        # Malformed numeric fields: the manifest cannot be trusted and
        # the product cannot be verified — the failure mode (fail
        # closed), not an exception out of the fsck walk.
        return doc, ["malformed manifest fields (tampered/torn?)"]
    if doc.get("complete"):
        want_crc = parse_crc(doc.get("crc32"))
        if want is not None and size != want:
            problems.append(
                f"size {size} != manifest {want} (product replaced or "
                "truncated after publish)")
        elif want_crc is None:
            problems.append("manifest carries no whole-file digest")
        else:
            t0 = time.perf_counter()
            got = crc32_file(path)
            observe_verify(time.perf_counter() - t0, timeline)
            if got != want_crc:
                problems.append(
                    f"content digest mismatch ({hex_crc(got)} != "
                    f"{doc['crc32']})")
    else:
        # strict=False: an in-progress product a live writer holds
        # (HDF5 write locks make it unreadable from outside) verifies
        # as None and is left alone — fsck counts it in_progress.
        ok = verify_claim(path, claimed_rows,
                          fmt=str(doc.get("format")),
                          timeline=timeline, strict=False)
        if ok is False:
            problems.append("claimed-prefix digest mismatch "
                            "(torn write or tampered sidecar)")
    if problems:
        incr("integrity.manifest.mismatch")
    return doc, problems
