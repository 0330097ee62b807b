"""On-node inventory crawl of GUPPI-convention directory trees.

Counterpart of ``blit/inventory.py`` (the reference's
``WorkerFunctions.getinventory`` + ``InventoryTuple``,
src/gbtworkerfunctions.jl:63-129), with the same records in the same
order.  The crawl walks
``<root>/<session>/<extra>/<player>/**``: top-level session directories
(symlinks to directories included) filtered by ``session_re``, player
directories filtered by ``player_re``, then a recursive walk per player with
files filtered by ``file_re``; each hit is parsed with
:func:`blit_torch.naming.parse_guppi_name`, warning and skipping on mismatch.
"""

from __future__ import annotations

import json
import logging
import os
import socket
from typing import Iterable, List, NamedTuple, Optional, Pattern, Tuple, Union

from blit_torch import naming
from blit_torch.config import DEFAULT, SiteConfig, _compile

log = logging.getLogger("blit_torch.inventory")


class InventoryRecord(NamedTuple):
    """One data-product file found on one host.

    Field names, order, and types match the reference ``InventoryTuple``
    (src/gbtworkerfunctions.jl:63-66; README.md:77-89) so downstream tabular
    workflows (pandas ``DataFrame(records)``, groupby on (session, scan))
    carry over unchanged.
    """

    imjd: int
    smjd: int
    session: str
    scan: str
    src_name: str
    band: int
    bank: int
    host: str
    file: str
    worker: int


def _listdirs(path: str) -> List[str]:
    """Names of subdirectories of `path`, *including* symlinks that resolve to
    directories (reference includes session symlinks: src/gbtworkerfunctions.jl:81-83).
    Sorted for determinism (Julia's walkdir sorts by name)."""
    try:
        with os.scandir(path) as it:
            names = [e.name for e in it if e.is_dir(follow_symlinks=True)]
    except OSError:
        return []
    return sorted(names)


def get_inventory(
    file_re: Union[str, Pattern, None] = None,
    *,
    root: Optional[str] = None,
    session_re: Union[str, Pattern, None] = None,
    extra: Optional[str] = None,
    player_re: Union[str, Pattern, None] = None,
    worker: int = 0,
    host: Optional[str] = None,
    config: SiteConfig = DEFAULT,
) -> List[InventoryRecord]:
    """Crawl this host's data tree and return its inventory.

    Matches reference behavior (src/gbtworkerfunctions.jl:68-129):

    - returns ``[]`` early if ``root`` is not a directory;
    - session symlinks are followed;
    - files whose *basename* matches ``file_re`` are parsed against the full
      path; parse failures log a warning and are skipped (per-file
      warn-and-skip is the reference's only "fault tolerance" — SURVEY.md §5);
    - ``host``/``worker`` are stamped into every record.
    """
    file_re = _compile(file_re) if file_re is not None else config.file_re
    session_re = _compile(session_re) if session_re is not None else config.session_re
    player_re = _compile(player_re) if player_re is not None else config.player_re
    root = root if root is not None else config.root
    extra = extra if extra is not None else config.extra
    host = host or socket.gethostname()

    records: List[InventoryRecord] = []
    if not os.path.isdir(root):
        return records

    sessions = [s for s in _listdirs(root) if session_re.search(s)]
    for session in sessions:
        playerdir = os.path.join(root, session, extra)
        players = [p for p in _listdirs(playerdir) if player_re.search(p)]
        for player in players:
            top = os.path.join(playerdir, player)
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames.sort()
                for base in sorted(filenames):
                    if not file_re.search(base):
                        continue
                    path = os.path.join(dirpath, base)
                    parsed = naming.parse_guppi_name(path)
                    if parsed is None:
                        log.warning("%s:%s did not match guppiname regex", host, path)
                        continue
                    if parsed.band is None or parsed.bank is None:
                        log.warning("%s:%s did not match player regex", host, path)
                        continue
                    records.append(
                        InventoryRecord(
                            imjd=parsed.imjd,
                            smjd=parsed.smjd,
                            session=session,
                            scan=parsed.scan,
                            src_name=parsed.src,
                            band=parsed.band,
                            bank=parsed.bank,
                            host=host,
                            file=path,
                            worker=worker,
                        )
                    )
    return records


def raw_sequences(
    records: Iterable[InventoryRecord],
) -> List[Tuple[InventoryRecord, List[str]]]:
    """Group RAW-file inventory records into ``.NNNN.raw`` scan sequences.

    A GBT scan is recorded as ``<stem>.0000.raw, <stem>.0001.raw, ...``
    (the NNNN field of the reference's filename grammar,
    src/gbtworkerfunctions.jl:35-47; README.md:25-27) — one logical unit
    the reducer must consume as a single gap-free stream
    (:class:`blit_torch.io.guppi.GuppiScan`).  Returns ``(first_record, sorted_paths)``
    per sequence, stem-sorted; records whose ``file`` is not a ``.NNNN.raw``
    member are ignored.

    Duplicate members (two workers inventorying the same file on a shared
    filesystem) are deduped by exact path — file identity IS the path
    string here, matching the reference's one-root-path-per-site
    convention (src/gbt.jl:48).  Two spellings of one file (differing
    mount prefixes) are NOT conflated: in a pod the same string can name
    DIFFERENT files on different hosts, so normalizing (realpath) from
    the main process would be wrong more often than right; such aliases
    surface as scan_grid's explicit "multiple RAW sequences" error.
    """
    from blit_torch.io.guppi import SEQ_RE

    groups: dict = {}
    for r in records:
        m = SEQ_RE.match(r.file)
        if m is None:
            continue
        # Dedupe by (stem, seq): on a shared filesystem two workers can
        # both inventory the same member, and a duplicated path must not
        # double the "sequence" (GuppiScan would read the recording
        # twice as if it were longer).  First reporter wins.
        members = groups.setdefault(m.group("stem"), {})
        members.setdefault(int(m.group("seq")), r)
    out = []
    for stem in sorted(groups):
        members = sorted(groups[stem].items())
        out.append((members[0][1], [r.file for _, r in members]))
    return out


def scan_grid(
    inventories: Iterable,
    session: str,
    scan: str,
) -> Tuple[List[int], List[int], List[List[List[str]]]]:
    """Resolve one (session, scan)'s RAW recordings into the rectangular
    ``raw_paths[band][bank]`` grid that ``blit``'s ``load_scan_mesh``
    consumes — the bridge from the inventory workflow (the reference's
    DataFrame groupby on (session, scan), README.md:95-157) to a
    (band, bank) data plane.

    ``inventories`` is per-worker record lists as
    :func:`blit_torch.gbt.get_inventories` returns them (``WorkerError`` entries skipped, like the
    host-side ``load_scan``).  RAW records are grouped into ``.NNNN.raw``
    sequences (:func:`raw_sequences`); each (band, bank) player must have
    exactly one sequence for the scan.  The grid is rectangular over the
    sorted band and bank ids found — a band missing a bank other bands have
    is an error (a mesh needs one recording per device), as ``blit``'s
    ``load_scan_mesh`` requires.

    Returns ``(band_ids, bank_ids, grid)`` where ``grid[i][j]`` is the
    sorted path list of band ``band_ids[i]``, bank ``bank_ids[j]``.
    """
    recs = [
        r
        for inv in inventories
        if not _is_worker_error(inv)
        for r in inv
        if r.session == session and r.scan == scan
    ]
    cells: dict = {}
    for rec, paths in raw_sequences(recs):
        key = (rec.band, rec.bank)
        if key in cells:
            raise ValueError(
                f"band {rec.band} bank {rec.bank} has multiple RAW sequences "
                f"for {session}/{scan}: {cells[key][0]} and {paths[0]}"
            )
        cells[key] = paths
    if not cells:
        raise ValueError(f"no RAW sequences for {session}/{scan} in inventories")
    band_ids = sorted({b for b, _ in cells})
    bank_ids = sorted({k for _, k in cells})
    missing = [
        (b, k) for b in band_ids for k in bank_ids if (b, k) not in cells
    ]
    if missing:
        raise ValueError(
            f"{session}/{scan}: players {missing} have no RAW sequence — "
            f"the (band, bank) grid must be rectangular"
        )
    grid = [[cells[(b, k)] for k in bank_ids] for b in band_ids]
    return band_ids, bank_ids, grid


def to_dataframe(inventories: Iterable[Iterable[InventoryRecord]]):
    """Flatten per-worker inventories into one pandas DataFrame — the L4
    analysis-layer workflow from the reference README
    (``DataFrame(Iterators.flatten(invs))``, README.md:95-157).  Captured
    ``WorkerError`` entries (live or restored by :func:`load_inventories`)
    are skipped, like every other consumer of the ragged shape."""
    import pandas as pd

    flat = [
        rec
        for inv in inventories
        if not _is_worker_error(inv)
        for rec in inv
    ]
    return pd.DataFrame(flat, columns=InventoryRecord._fields)


def save_inventories(path: str, inventories) -> int:
    """Persist per-worker inventories as JSON-lines (the reference's
    "state" is a saved pid vector + inventory DataFrame, README.md:62-64,
    100-101 — this is the durable half).  Each line is one record plus its
    worker-list index, so :func:`load_inventories` restores the ragged
    per-worker shape exactly — including ``WorkerError`` entries from a
    captured fan-out (``get_inventories(on_error="capture")``), which
    round-trip as error markers rather than crashing the save.  Returns
    the record count."""
    n = 0
    with open(path, "w") as f:
        for w, inv in enumerate(inventories):
            if _is_worker_error(inv):
                # getattr fallbacks: _is_worker_error also admits bare
                # Exception entries, which lack WorkerError's fields.
                err = getattr(inv, "error", inv)
                f.write(json.dumps({
                    "_w": w,
                    "_error": f"{type(err).__name__}: {err}",
                    "_host": getattr(inv, "host", ""),
                    "_worker": getattr(inv, "worker", w),
                }) + "\n")
                continue
            wrote_any = False
            for rec in inv:
                row = rec._asdict()
                row["_w"] = w
                f.write(json.dumps(row) + "\n")
                n += 1
                wrote_any = True
            if not wrote_any:
                f.write(json.dumps({"_w": w, "_empty": True}) + "\n")
    return n


def _is_worker_error(entry) -> bool:
    """True for a captured per-worker failure entry (a ``WorkerError`` or
    a bare exception)."""
    from blit_torch.parallel.pool import WorkerError

    return isinstance(entry, (WorkerError, Exception))


def load_inventories(path: str) -> List:
    """Restore what :func:`save_inventories` wrote (ragged shape included).
    Captured failures come back as ``WorkerError`` entries carrying the
    saved message, so downstream consumers (``scan_grid``, ``load_scan``)
    skip them exactly as they would the live objects."""
    from blit_torch.parallel.pool import WorkerError

    out: List = []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            w = row.pop("_w")
            while len(out) <= w:
                out.append([])
            if "_error" in row:
                out[w] = WorkerError(
                    worker=row.get("_worker", w),
                    host=row.get("_host", ""),
                    error=RuntimeError(row["_error"]),
                )
                continue
            if row.pop("_empty", False):
                continue
            out[w].append(InventoryRecord(**row))
    return out
