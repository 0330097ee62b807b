"""Archive catalog: the session/scan/product index of a data tree.

The reference package is an *archive access layer* — inventory the
fleet, then load scan products by (session, scan) — but until this
module every fleet request had to spell out explicit member paths.
:class:`CatalogIndex` closes that gap: an in-RAM index built from the
existing :func:`blit_torch.inventory.get_inventory` crawl and the
:mod:`blit_torch.naming` grammar, held per process and kept fresh by
**mtime-invalidated incremental rescan** — each session directory's
subtree signature (the sorted ``(relative dir, mtime_ns)`` pairs; adding
or removing a file touches its directory's mtime) is recorded at crawl
time, and a later refresh re-crawls ONLY the sessions whose signature
changed.  A bounded TTL'd **negative-lookup cache** keeps repeated
misses from forcing a rescan per ask.

Two serving surfaces ride the fleet plane unchanged:

- peers serve the catalog document as ``ProductRequest(kind="catalog")``
  over the existing product wire (``raw`` carries the query string:
  ``""`` lists sessions, ``"<session>"`` one session's scans,
  ``"<session>/<scan>"`` one scan's membership);
- the front door resolves by-(session, scan) product asks into the
  explicit member-path recipe BEFORE ring routing
  (:meth:`CatalogIndex.resolve`), so a logical ask and the equivalent
  explicit-path ask fingerprint identically — same ring owner, same
  single-flight group, byte-identical product.

Import discipline matches the serve plane: stdlib at module scope,
blit imports lazy inside methods.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from blit_torch.config import DEFAULT, SiteConfig, catalog_defaults

# Catalog crawls index BOTH the derivable source (``.NNNN.raw`` scan
# sequences — what :meth:`CatalogIndex.resolve` turns into member-path
# recipes) and the already-derived rawspec products sitting next to
# them (listed per scan under ``"products"``).
CATALOG_FILE_RE = re.compile(r"(\.\d{4}\.raw|\.rawspec\.\d{4}\.(?:h5|fil))$")


class CatalogMiss(KeyError):
    """An ask for a session/scan the catalog does not hold (after a
    forced rescan) — the door maps it onto its request-error surface."""


def catalog_fingerprint(query: str) -> str:
    """The content address of one catalog ask — what the front door
    routes/dedupes catalog requests by.  Product fingerprints hash raw
    bytes identity; a catalog document's identity is its QUERY (the
    answer changes as the tree grows, exactly like a directory
    listing), so identical asks land on one ring owner and coalesce
    while never colliding with any product key."""
    return hashlib.sha256(f"blit.catalog:{query}".encode()).hexdigest()


class CatalogIndex:
    """In-RAM session/scan/product index over one archive root (module
    docstring).  All methods are thread-safe.  ``rescan_s`` bounds how
    often a lookup may re-stat the tree (0 = every lookup);
    ``negative_ttl_s`` / ``negative_max`` bound the negative cache."""

    def __init__(
        self,
        root: Optional[str] = None,
        *,
        config: SiteConfig = DEFAULT,
        rescan_s: Optional[float] = None,
        negative_ttl_s: Optional[float] = None,
        negative_max: Optional[int] = None,
        timeline=None,
    ):
        kn = catalog_defaults(config)
        self.root = os.path.abspath(root if root is not None
                                    else (kn["root"] or config.root))
        self.config = config
        self.rescan_s = (kn["rescan_s"] if rescan_s is None
                         else float(rescan_s))
        self.negative_ttl_s = (kn["negative_ttl_s"] if negative_ttl_s is None
                               else float(negative_ttl_s))
        self.negative_max = max(1, int(kn["negative_max"]
                                       if negative_max is None
                                       else negative_max))
        self.timeline = timeline
        self._lock = threading.Lock()
        # session -> {"sig": ((reldir, mtime_ns), ...), "scans": {...}}
        self._sessions: Dict[str, Dict] = {}
        # (session, scan-or-None) -> monotonic expiry of the miss.
        self._neg: "OrderedDict[Tuple[str, Optional[str]], float]" = (
            OrderedDict())
        self._last_refresh = float("-inf")
        self._generation = 0
        self.counts: Dict[str, int] = {
            "lookups": 0, "hits": 0, "misses": 0, "neg_hits": 0,
            "rescans": 0, "refreshes": 0,
        }

    # -- counters ----------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n
        if self.timeline is not None:
            self.timeline.count(f"catalog.{name}", n)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counts)
            out["sessions"] = len(self._sessions)
            out["scans"] = sum(len(s["scans"])
                               for s in self._sessions.values())
            out["negative_entries"] = len(self._neg)
            out["generation"] = self._generation
        return out

    # -- crawl / refresh ---------------------------------------------------
    def _tree_sig(self, session_dir: str) -> Tuple:
        """The mtime signature of one session subtree: sorted
        ``(relative dir, mtime_ns)`` pairs over every directory under
        it.  Creating/removing a file updates its parent directory's
        mtime, so ANY membership change flips the signature — file
        stats are only paid for sessions whose signature moved."""
        sig: List[Tuple[str, int]] = []
        for dirpath, dirnames, _files in os.walk(session_dir,
                                                 followlinks=True):
            dirnames.sort()
            try:
                st = os.stat(dirpath)
            except OSError:
                continue
            sig.append((os.path.relpath(dirpath, session_dir),
                        st.st_mtime_ns))
        return tuple(sorted(sig))

    def _crawl_session(self, session: str) -> Dict:
        """One session's scan table via the EXISTING inventory crawl
        (``get_inventory`` anchored to exactly this session — the
        corrected ``PLAYER_RE`` and warn-and-skip parse rules apply
        unchanged, so malformed player dirs never index)."""
        from blit_torch import inventory, naming

        records = inventory.get_inventory(
            CATALOG_FILE_RE,
            root=self.root,
            session_re=re.compile(rf"^{re.escape(session)}$"),
            extra=self.config.extra,
            player_re=self.config.player_re,
            config=self.config,
        )
        scans: Dict[str, Dict] = {}
        raw_records = []
        for r in records:
            sc = scans.setdefault(r.scan, {
                "src": r.src_name, "imjd": r.imjd, "smjd": r.smjd,
                "bands": set(), "banks": set(), "products": set(),
                "sequences": {},
            })
            sc["bands"].add(r.band)
            sc["banks"].add(r.bank)
            parsed = naming.parse_rawspec_name(r.file)
            if parsed is not None and parsed.product is not None:
                sc["products"].add(parsed.product)
            else:
                raw_records.append(r)
        for rec, paths in inventory.raw_sequences(raw_records):
            scans[rec.scan]["sequences"][(rec.band, rec.bank)] = paths
        return scans

    def refresh(self, force: bool = False) -> int:
        """Re-stat the tree and re-crawl the sessions whose subtree
        signature changed (all of them on first touch).  Rate-limited
        by ``rescan_s`` unless forced.  Returns how many sessions were
        (re)crawled."""
        from blit_torch.inventory import _listdirs

        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < self.rescan_s:
                return 0
            self._last_refresh = now
            known = {s: e["sig"] for s, e in self._sessions.items()}
        self._count("refreshes")
        session_re = self.config.session_re
        live = [s for s in _listdirs(self.root) if session_re.search(s)]
        fresh: Dict[str, Dict] = {}
        rescanned = 0
        for session in live:
            sig = self._tree_sig(os.path.join(self.root, session))
            if session in known and known[session] == sig:
                continue
            fresh[session] = {"sig": sig,
                              "scans": self._crawl_session(session)}
            rescanned += 1
        with self._lock:
            gone = set(self._sessions) - set(live)
            for s in gone:
                del self._sessions[s]
            self._sessions.update(fresh)
            if fresh or gone:
                self._generation += 1
        if rescanned:
            self._count("rescans", rescanned)
        return rescanned

    # -- negative cache ----------------------------------------------------
    def _neg_fresh_locked(self, key: Tuple[str, Optional[str]]) -> bool:
        exp = self._neg.get(key)
        if exp is None:
            return False
        if time.monotonic() >= exp:
            del self._neg[key]
            return False
        return True

    def _neg_note_locked(self, key: Tuple[str, Optional[str]]) -> None:
        self._neg[key] = time.monotonic() + self.negative_ttl_s
        self._neg.move_to_end(key)
        while len(self._neg) > self.negative_max:
            self._neg.popitem(last=False)

    # -- lookups -----------------------------------------------------------
    def _find_locked(self, session: Optional[str],
                     scan: Optional[str]) -> Optional[Dict]:
        if session is None:
            return {"_all": True}
        entry = self._sessions.get(session)
        if entry is None:
            return None
        if scan is None:
            return entry
        return entry["scans"].get(scan)

    def lookup(self, session: Optional[str] = None,
               scan: Optional[str] = None) -> Dict:
        """The catalog document for one ask (module docstring's three
        shapes).  A miss forces ONE rescan (the data may have just
        landed) and then raises :class:`CatalogMiss`; the negative
        cache answers repeat misses without touching the tree until
        the TTL expires."""
        self._count("lookups")
        key = (session or "", scan)
        with self._lock:
            if session is not None and self._neg_fresh_locked(key):
                self._count("neg_hits")
                self._count("misses")
                raise CatalogMiss(
                    f"no such {'scan' if scan else 'session'}: "
                    f"{session}{'/' + scan if scan else ''} "
                    "(negative-cached)")
        self.refresh()
        with self._lock:
            found = self._find_locked(session, scan)
        if found is None:
            self.refresh(force=True)
            with self._lock:
                found = self._find_locked(session, scan)
                if found is None:
                    self._neg_note_locked(key)
                    self._count("misses")
                    raise CatalogMiss(
                        f"no such {'scan' if scan else 'session'}: "
                        f"{session}{'/' + scan if scan else ''}")
        with self._lock:
            self._neg.pop(key, None)
            self._count("hits")
            return self._render_locked(session, scan)

    def _render_locked(self, session: Optional[str],
                       scan: Optional[str]) -> Dict:
        """JSON-able view of one ask (under the lock; pure reads)."""
        if session is None:
            return {
                "root": self.root, "generation": self._generation,
                "sessions": {
                    s: {"scans": len(e["scans"]),
                        "files": sum(
                            len(sc["products"])
                            + sum(len(p) for p in
                                  sc["sequences"].values())
                            for sc in e["scans"].values())}
                    for s, e in sorted(self._sessions.items())
                },
            }
        entry = self._sessions[session]
        if scan is None:
            return {
                "root": self.root, "session": session,
                "generation": self._generation,
                "scans": {
                    name: self._scan_doc(sc, members=False)
                    for name, sc in sorted(entry["scans"].items())
                },
            }
        return {
            "root": self.root, "session": session, "scan": scan,
            "generation": self._generation,
            **self._scan_doc(entry["scans"][scan], members=True),
        }

    @staticmethod
    def _scan_doc(sc: Dict, members: bool) -> Dict:
        doc = {
            "src": sc["src"], "imjd": sc["imjd"], "smjd": sc["smjd"],
            "bands": sorted(sc["bands"]), "banks": sorted(sc["banks"]),
            "products": sorted(sc["products"]),
            "sequences": len(sc["sequences"]),
        }
        if members:
            doc["members"] = {
                f"{band}{bank}": list(paths)
                for (band, bank), paths in sorted(sc["sequences"].items())
            }
        return doc

    def resolve(self, session: str, scan: str, *,
                band: Optional[int] = None,
                bank: Optional[int] = None) -> List[str]:
        """The member-path list of one (session, scan)'s RAW sequence —
        what the front door substitutes into a logical product ask
        before ring routing.  A scan recorded by several players needs
        ``band``/``bank`` to pick one; an ambiguous ask is a loud
        :class:`CatalogMiss` (guessing a recording would serve the
        wrong bytes)."""
        self.lookup(session, scan)
        with self._lock:
            seqs = self._sessions[session]["scans"][scan]["sequences"]
            picks = {
                k: v for k, v in seqs.items()
                if (band is None or k[0] == band)
                and (bank is None or k[1] == bank)
            }
        if not picks:
            raise CatalogMiss(
                f"{session}/{scan}: no RAW sequence"
                + (f" for player BLP{band}{bank}"
                   if band is not None or bank is not None else ""))
        if len(picks) > 1:
            players = ", ".join(f"BLP{b}{k}" for b, k in sorted(picks))
            raise CatalogMiss(
                f"{session}/{scan} has {len(picks)} RAW sequences "
                f"({players}); pass band=/bank= to pick one")
        return list(next(iter(picks.values())))

    # -- the kind="catalog" serving surface --------------------------------
    def serve(self, query: str) -> Tuple[Dict, "object"]:
        """Answer one wire catalog ask: ``(header, empty array)`` in the
        product-result shape, so the existing encode/decode wire and
        the peer's ticket plumbing carry it unchanged.  The document
        rides the header."""
        import numpy as np

        query = (query or "").strip("/")
        session: Optional[str] = None
        scan: Optional[str] = None
        if query:
            session, _, scan_part = query.partition("/")
            scan = scan_part or None
        doc = self.lookup(session, scan)
        header = {"kind": "catalog", "query": query, **doc}
        data = np.zeros((0, 1, 0), np.float32)
        data.setflags(write=False)
        return header, data
