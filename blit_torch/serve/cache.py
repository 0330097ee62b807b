"""Two-tier content-addressed product cache (the serving layer's artifact
store).

Keys are **reduction fingerprints**: a stable digest over the raw-input
identity (the order-insensitive ``(path, size, mtime_ns)`` member triples of
:meth:`blit_torch.pipeline.ReductionCursor.normalized_members`) plus the full
output-affecting reducer configuration.  Two callers asking for the same
product of the same bytes — however their globs ordered the ``.NNNN.raw``
members — get the same key; touching a member or changing any knob gets a
different one.  Content addressing makes invalidation structural: a stale
entry is simply never asked for again.

Tiers:

- **RAM** — an LRU dict of finished ``(header, product array)`` pairs,
  bounded by a byte budget (``SiteConfig.cache_ram_bytes``).  Entries are
  published complete-and-read-only under the cache lock, so a concurrent
  reader sees a whole product or a miss — never a torn entry (eviction
  drops the dict reference; an array already handed out stays valid).
- **Disk** — completed FBH5 products (+ a JSON header sidecar) under one
  directory, indexed by fingerprint.  Publish is atomic: both files are
  written to temp names and ``os.replace``d into place, data before
  sidecar, so the sidecar's existence marks a complete entry exactly like
  the pipeline's ``.partial``-rename rule.  Loads re-probe the entry with
  :func:`blit_torch.io.fbh5.resume_target_ok`; an unreadable/corrupt entry (torn
  by a crash mid-publish on a non-atomic filesystem, bit rot) is EVICTED
  and reported as a miss instead of raising.

A third, derived tier rides both: the
**encoded wire body** — the already-framed ``application/x-blit-product``
bytes of an entry (:func:`blit_torch.serve.http.encode_product_wire`).  A hot
binary-wire hit is then one memoryview write: no re-encode, no ndarray
copy, and a disk-tier wire hit streams file bytes without materializing
the array at all.  Wire bodies share the RAM byte budget but are always
evicted FIRST (they are re-derivable from their product), and the disk
form (``<fp>.wire`` = frame + CRC32 footer) is verified on load exactly
like the product files.

A **cold tier** sits behind the hot disk tier
when ``cold_dir`` is set: an object-store-style content-addressed
layout (``<cold>/<fp[:2]>/<fp>.h5`` + the same meta sidecar, so ``blit
fsck`` walks it with the rules it already knows).  Hot-tier capacity
evictions DEMOTE into it (files moved, not copied — the bytes that
were verified at publish stay the bytes served later) and a cold hit
is PROMOTED back to hot under the CRC manifest check before it
is served — a rotted cold entry is evicted and reported as a miss,
never promoted.  A cold miss falls through to the serve layer's
re-derivation path (the recipe in the meta sidecar — the ``tier ∈
{ram, wire, disk, cold, derive}`` story on ``/metrics``).

Hit/miss/evict counters land on the :class:`~blit_torch.observability.Timeline`
(``cache.hit.ram`` / ``cache.hit.disk`` / ``cache.hit.wire`` /
``cache.hit.cold`` / ``cache.miss`` / ``cache.evict.*`` /
``cache.demote.cold`` / ``cache.promote.cold`` / ``cache.derive``) and
the ``cache.publish`` fault-injection point covers the disk publish
path for drills (blit/faults.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from blit_torch import faults
from blit_torch.observability import Timeline

log = logging.getLogger("blit_torch.serve.cache")


def reduction_fingerprint(
    raw_path: Union[str, Sequence[str]],
    *,
    nfft: int,
    nint: int,
    ntap: int = 4,
    stokes: str = "I",
    window: str = "hamming",
    fqav_by: int = 1,
    dtype: str = "float32",
    fft_method: str = "auto",
    extra: Optional[Dict] = None,
) -> str:
    """The content address of one reduction: sha256 over the canonical
    JSON of ``(raw identity, reducer config)``.

    The raw identity reuses :class:`blit_torch.pipeline.ReductionCursor`'s
    ``(path, size, mtime_ns)`` member triples — the same
    "same config over the same bytes" contract the resume path enforces —
    normalized to an order-insensitive, absolute-path member list so cache
    keys are stable across glob orderings.  Raises
    ``OSError`` when a member does not exist: an address over unknown
    bytes would alias whatever lands at the path later.

    ``extra`` admits future key components (e.g. a despike width for mesh
    products) without breaking existing keys when absent.
    """
    from blit_torch.pipeline import ReductionCursor

    paths = [raw_path] if isinstance(raw_path, str) else list(raw_path)
    paths = [os.path.abspath(p) for p in paths]
    sizes, mtimes = ReductionCursor.stat_raw(paths)
    ident = {
        "raw": ReductionCursor.normalized_members(paths, sizes, mtimes),
        "nfft": nfft, "ntap": ntap, "nint": nint, "stokes": stokes,
        "window": window, "fqav_by": fqav_by, "dtype": dtype,
        "fft_method": fft_method,
    }
    if extra:
        ident["extra"] = dict(sorted(extra.items()))
    blob = json.dumps(ident, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def fingerprint_for(reducer, raw_path: Union[str, Sequence[str]]) -> str:
    """The fingerprint of ``reducer`` (a :class:`blit_torch.pipeline.RawReducer`
    or any reducer speaking its knob surface) applied to ``raw_path`` —
    pulls every output-affecting knob off the configured reducer so the
    two can never drift.  Reducers with EXTRA output-affecting knobs
    (e.g. :class:`blit_torch.search.dedoppler.DedopplerReducer`'s drift-search
    parameters) expose them via a ``fingerprint_extra()`` dict, merged
    into the key the same way the despike width would be — absent for
    plain reductions, so existing keys are untouched."""
    extra_fn = getattr(reducer, "fingerprint_extra", None)
    return reduction_fingerprint(
        raw_path,
        nfft=reducer.nfft, nint=reducer.nint, ntap=reducer.ntap,
        stokes=reducer.stokes, window=reducer.window,
        fqav_by=reducer.fqav_by, dtype=reducer.dtype,
        fft_method=reducer.fft_method,
        extra=extra_fn() if extra_fn is not None else None,
    )


def _frozen(data: np.ndarray) -> np.ndarray:
    """A read-only float32 view of ``data`` the cache can hand to many
    concurrent callers: copied when the caller still holds a writable
    reference (a later mutation must not tear a served entry)."""
    data = np.asarray(data, np.float32)
    if data.flags.writeable:
        # A real copy, not ascontiguousarray (which returns the SAME
        # array when already contiguous — freezing it would flip the
        # caller's own buffer read-only).
        data = data.copy()
        data.setflags(write=False)
    return data


class ProductCache:
    """Two-tier (RAM over disk) content-addressed product cache.

    ``ram_bytes`` bounds the RAM tier (0 disables it); ``root=None``
    disables the disk tier (RAM-only cache).  ``disk_bytes`` optionally
    bounds the disk tier — oldest completed entries are evicted when a
    publish would exceed it.  All methods are thread-safe.
    """

    def __init__(
        self,
        root: Optional[str] = None,
        *,
        ram_bytes: int = 1 << 30,
        disk_bytes: Optional[int] = None,
        cold_dir: Optional[str] = None,
        timeline: Optional[Timeline] = None,
    ):
        self.root = root
        self.ram_bytes = max(0, int(ram_bytes))
        self.disk_bytes = disk_bytes
        # Cold tier: requires a hot disk tier to promote
        # into — a RAM-only cache with a cold_dir would demote nothing
        # and have nowhere to promote, so it is simply ignored.
        self.cold_dir = cold_dir if root is not None else None
        self.timeline = timeline if timeline is not None else Timeline()
        self._lock = threading.Lock()
        # fp -> (header, read-only data, nbytes); insertion order = LRU.
        self._ram: "OrderedDict[str, Tuple[Dict, np.ndarray, int]]" = (
            OrderedDict()
        )
        self._ram_used = 0
        # Encoded-wire-body tier: fp -> (frame bytes,
        # nbytes), LRU, sharing ram_bytes with the product entries but
        # evicted first — a wire body is re-derivable from its product.
        self._wire: "OrderedDict[str, Tuple[bytes, int]]" = OrderedDict()
        self._wire_used = 0
        # Per-fingerprint hit totals (bounded: RAM/disk hits only, LRU
        # pruned alongside the RAM tier) — the fleet plane's hotness
        # signal: `hot()` feeds cache-warm replication and
        # the drain-time hot-entry hints.
        self._hits_by_fp: "OrderedDict[str, int]" = OrderedDict()
        self.counts: Dict[str, int] = {
            "hit.ram": 0, "hit.disk": 0, "hit.wire": 0, "hit.cold": 0,
            "miss": 0, "evict.ram": 0, "evict.disk": 0,
            "evict.corrupt": 0, "evict.wire": 0, "demote.cold": 0,
            "promote.cold": 0, "derive": 0, "publish": 0,
            "publish.error": 0,
        }
        if root is not None:
            os.makedirs(root, exist_ok=True)
            # Integrity plane: the disk tier's quarantine dir
            # joins the /healthz watch set — a serve process whose cache
            # grew a quarantine reports degraded until triaged.
            from blit_torch import integrity

            integrity.watch_quarantine(
                os.path.join(root, integrity.QUARANTINE_DIR))
        if self.cold_dir is not None:
            os.makedirs(self.cold_dir, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def data_path(self, fp: str) -> str:
        return os.path.join(self.root, f"{fp}.h5")

    def meta_path(self, fp: str) -> str:
        return os.path.join(self.root, f"{fp}.json")

    def wire_path(self, fp: str) -> str:
        return os.path.join(self.root, f"{fp}.wire")

    def cold_data_path(self, fp: str) -> str:
        return os.path.join(self.cold_dir, fp[:2], f"{fp}.h5")

    def cold_meta_path(self, fp: str) -> str:
        return os.path.join(self.cold_dir, fp[:2], f"{fp}.json")

    # -- counters ----------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n
        self.timeline.count(f"cache.{name}", n)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counts)
            out["ram_entries"] = len(self._ram)
            out["ram_bytes_used"] = self._ram_used
            out["wire_entries"] = len(self._wire)
            out["wire_bytes_used"] = self._wire_used
        return out

    @property
    def hit_rate(self) -> float:
        s = self.stats()
        served = s["hit.ram"] + s["hit.disk"] + s["hit.cold"]
        total = served + s["miss"]
        return served / total if total else 0.0

    def note_derive(self) -> None:
        """One miss re-derived through the reduce path — the serve
        layer reports it so the per-tier story on /metrics covers all
        of {ram, wire, disk, cold, derive}."""
        self._count("derive")

    # -- RAM tier ----------------------------------------------------------
    def _evict_wire_locked(self, need: int) -> None:
        """Drop LRU wire bodies until ``need`` more bytes fit the
        shared budget (wire bodies go first: re-derivable)."""
        while (self._ram_used + self._wire_used + need > self.ram_bytes
               and self._wire):
            _, (_, b) = self._wire.popitem(last=False)
            self._wire_used -= b
            self.counts["evict.wire"] += 1
            self.timeline.count("cache.evict.wire")

    def _ram_put_locked(self, fp: str, header: Dict,
                        data: np.ndarray) -> None:
        nbytes = data.nbytes
        if nbytes > self.ram_bytes:
            return  # larger than the whole budget: disk-only entry
        old = self._ram.pop(fp, None)
        if old is not None:
            self._ram_used -= old[2]
        self._evict_wire_locked(nbytes)
        while (self._ram_used + self._wire_used + nbytes > self.ram_bytes
               and self._ram):
            _, (_, _, b) = self._ram.popitem(last=False)
            self._ram_used -= b
            self.counts["evict.ram"] += 1
            self.timeline.count("cache.evict.ram")
        self._ram[fp] = (header, data, nbytes)
        self._ram_used += nbytes

    def _wire_put_locked(self, fp: str, body: bytes) -> None:
        """RAM leg of the wire tier: evicts only OTHER wire bodies —
        never a product entry — and declines when products already
        fill the budget (the body stays derivable)."""
        nbytes = len(body)
        old = self._wire.pop(fp, None)
        if old is not None:
            self._wire_used -= old[1]
        self._evict_wire_locked(nbytes)
        if self._ram_used + self._wire_used + nbytes <= self.ram_bytes:
            self._wire[fp] = (bytes(body), nbytes)
            self._wire_used += nbytes

    # -- disk tier ---------------------------------------------------------
    def _disk_publish(self, fp: str, header: Dict, data: np.ndarray,
                      recipe: Optional[Dict] = None) -> None:
        """Atomic publish: data file first, sidecar last, both via
        write-temp-``os.replace`` — the sidecar's existence marks a
        complete entry.  Raises on failure (the caller downgrades to a
        RAM/serve-only result and counts it).

        The meta sidecar carries the entry's CONTENT digest (a CRC over
        the published file's bytes) — loads and the background
        scrubber verify it, turning the structural resume probe into
        content verification — plus the optional ``recipe`` (the
        serve request's knob surface) so ``blit fsck --repair`` can
        re-derive a quarantined entry: the fingerprint is already a
        content-addressed recipe key, the recipe makes it executable."""
        from blit_torch import integrity
        from blit_torch.io.fbh5 import write_fbh5

        faults.fire("cache.publish", key=fp)
        self._disk_evict_for(data.nbytes)
        suffix = f".tmp.{os.getpid()}.{threading.get_ident()}"
        dtmp = self.data_path(fp) + suffix
        mtmp = self.meta_path(fp) + suffix
        try:
            write_fbh5(dtmp, header, np.ascontiguousarray(data))
            file_crc = integrity.crc32_file(dtmp)
            file_bytes = os.path.getsize(dtmp)
            os.replace(dtmp, self.data_path(fp))
            meta = {"fingerprint": fp, "nsamps": int(data.shape[0]),
                    "nifs": int(data.shape[1]),
                    "nchans": int(data.shape[2]),
                    "nbytes": int(data.nbytes),
                    "crc32": integrity.hex_crc(file_crc),
                    "file_bytes": int(file_bytes),
                    "header": _jsonable(header)}
            if recipe is not None:
                meta["recipe"] = recipe
            with open(mtmp, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, self.meta_path(fp))
        finally:
            for t in (dtmp, mtmp):
                try:
                    os.unlink(t)
                except OSError:
                    pass

    def _disk_evict(self, fp: str, reason: str) -> None:
        for p in (self.meta_path(fp), self.data_path(fp),
                  self.wire_path(fp)):
            try:
                os.unlink(p)
            except OSError:
                pass
        self._count(f"evict.{reason}")

    def _disk_evict_for(self, incoming: int) -> None:
        """Make room for ``incoming`` bytes under ``disk_bytes`` (oldest
        completed entries first; no-op without a budget).  Also sweeps
        sidecar-less ``.h5`` orphans (a crash between the data and
        sidecar renames) old enough to not be a publish in progress —
        they are invisible to :meth:`index` and would otherwise leak
        outside the budget forever."""
        if self.disk_bytes is None:
            return
        complete = set(self.index())
        now_ns = time.time_ns()
        entries = []
        total = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for n in names:
            if not n.endswith(".h5"):
                continue
            fp = n[:-3]
            try:
                st = os.stat(os.path.join(self.root, n))
            except OSError:
                continue
            if fp not in complete:
                if now_ns - st.st_mtime_ns > 60 * 10**9:
                    self._disk_evict(fp, "disk")  # crash-orphaned data
                continue
            size = st.st_size
            try:
                # The entry's wire body is budgeted (and evicted) with
                # its product file.
                size += os.path.getsize(self.wire_path(fp))
            except OSError:
                pass
            entries.append((st.st_mtime_ns, fp, size))
            total += size
        entries.sort()
        while entries and total + incoming > self.disk_bytes:
            _, fp, size = entries.pop(0)
            # With a cold tier, a capacity eviction DEMOTES instead of
            # deleting: the entry's bytes move to the
            # object-store layout, promotable on the next hit.
            if self.cold_dir is not None and self._demote(fp):
                self._count("demote.cold")
            else:
                self._disk_evict(fp, "disk")
            total -= size

    def _disk_load(self, fp: str) -> Optional[Tuple[Dict, np.ndarray]]:
        """Load a completed disk entry, probing it for corruption first —
        an entry that no longer reads as the product its sidecar claims is
        evicted (count ``evict.corrupt``) and reported as a miss."""
        from blit_torch.io.fbh5 import read_fbh5_data
        from blit_torch.io.fbh5 import resume_target_ok

        mpath = self.meta_path(fp)
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            self._disk_evict(fp, "corrupt")
            return None
        nsamps = int(meta.get("nsamps", -1))
        if nsamps < 0 or not resume_target_ok(
            self.data_path(fp), int(meta["nifs"]), int(meta["nchans"]),
            nsamps,
        ):
            log.warning("cache entry %s is unreadable; evicting", fp[:16])
            self._disk_evict(fp, "corrupt")
            return None
        # Content verification: the structural probe above
        # cannot see a flipped byte inside a structurally valid file —
        # the published content digest can.  BLIT_VERIFY_CACHE=0 is the
        # escape hatch; entries published before the digest existed
        # keep the structural-probe behavior.
        from blit_torch import integrity

        want = integrity.parse_crc(meta.get("crc32"))
        if want is not None and integrity.cache_verify_enabled():
            t0 = time.perf_counter()
            got = integrity.crc32_file(self.data_path(fp))
            integrity.observe_verify(time.perf_counter() - t0,
                                     self.timeline)
            if got != want:
                integrity.incr("integrity.cache.corrupt")
                log.warning(
                    "cache entry %s fails its content digest (%s != "
                    "%s); evicting", fp[:16], integrity.hex_crc(got),
                    meta["crc32"])
                self._disk_evict(fp, "corrupt")
                return None
        try:
            data = read_fbh5_data(self.data_path(fp))
        except Exception:  # noqa: BLE001 — corrupt past the probe: evict
            self._disk_evict(fp, "corrupt")
            return None
        return meta["header"], _frozen(data)

    # -- cold tier ----------------------------------
    def _demote(self, fp: str) -> bool:
        """Move a completed hot-tier entry into the cold layout (data
        file first, sidecar last — the publish ordering rule, so the
        cold sidecar's existence marks a complete cold entry).  The
        derived ``.wire`` body is dropped, not demoted: it re-derives
        from the product in one encode.  Returns False (caller falls
        back to a plain eviction) when the move fails midway."""
        mpath, dpath = self.meta_path(fp), self.data_path(fp)
        if not (os.path.exists(mpath) and os.path.exists(dpath)):
            return False
        try:
            os.makedirs(os.path.join(self.cold_dir, fp[:2]),
                        exist_ok=True)
            shutil.move(dpath, self.cold_data_path(fp))
            shutil.move(mpath, self.cold_meta_path(fp))
        except OSError as e:
            log.warning("demote of %s to the cold tier failed: %s",
                        fp[:16], e)
            return False
        try:
            os.unlink(self.wire_path(fp))
        except OSError:
            pass
        self.timeline.count("cache.demote.cold")
        return True

    def _cold_evict(self, fp: str) -> None:
        for p in (self.cold_meta_path(fp), self.cold_data_path(fp)):
            try:
                os.unlink(p)
            except OSError:
                pass
        self._count("evict.corrupt")

    def _cold_load(self, fp: str) -> Optional[Tuple[Dict, np.ndarray]]:
        """Cold hit: CRC-verify the cold entry against its manifest
        sidecar (the promotion gate, the manifest rules — a cold entry that
        fails its digest is EVICTED and reported as a miss, never
        promoted), then PROMOTE it into the hot disk tier byte-for-byte
        (files copied, sidecar last) and load through the normal hot
        path."""
        from blit_torch import integrity
        from blit_torch.io.fbh5 import read_fbh5_data

        mpath = self.cold_meta_path(fp)
        dpath = self.cold_data_path(fp)
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as f:
                meta = json.load(f)
            want = integrity.parse_crc(meta.get("crc32"))
        except (OSError, ValueError):
            self._cold_evict(fp)
            return None
        if want is not None and integrity.cache_verify_enabled():
            t0 = time.perf_counter()
            try:
                got = integrity.crc32_file(dpath)
            except OSError:
                got = None
            integrity.observe_verify(time.perf_counter() - t0,
                                     self.timeline)
            if got != want:
                integrity.incr("integrity.cache.corrupt")
                log.warning("cold entry %s fails its content digest; "
                            "evicting", fp[:16])
                self._cold_evict(fp)
                return None
        # Promote: data before sidecar, both via temp + os.replace —
        # the hot tier sees a whole entry or none, and the bytes are
        # the EXACT bytes the cold manifest just verified.
        suffix = f".tmp.{os.getpid()}.{threading.get_ident()}"
        dtmp = self.data_path(fp) + suffix
        mtmp = self.meta_path(fp) + suffix
        try:
            self._disk_evict_for(
                int(meta.get("file_bytes") or 0)
                or (os.path.getsize(dpath) if os.path.exists(dpath)
                    else 0))
            shutil.copyfile(dpath, dtmp)
            os.replace(dtmp, self.data_path(fp))
            shutil.copyfile(mpath, mtmp)
            os.replace(mtmp, self.meta_path(fp))
        except OSError as e:
            log.warning("promotion of cold entry %s failed: %s",
                        fp[:16], e)
            for t in (dtmp, mtmp):
                try:
                    os.unlink(t)
                except OSError:
                    pass
            # Serve from the cold files directly this once.
            try:
                data = read_fbh5_data(dpath)
            except Exception:  # noqa: BLE001 — rot past the CRC gate
                self._cold_evict(fp)
                return None
            return meta["header"], _frozen(data)
        self._count("promote.cold")
        self._cold_evict_entry_files_after_promote(fp)
        try:
            data = read_fbh5_data(self.data_path(fp))
        except Exception:  # noqa: BLE001 — corrupt past the probe: evict
            self._disk_evict(fp, "corrupt")
            return None
        return meta["header"], _frozen(data)

    def _cold_evict_entry_files_after_promote(self, fp: str) -> None:
        """After a verified promotion the hot tier owns the entry; the
        cold copy is removed so one fingerprint lives in exactly one
        durable tier (a later demotion re-creates it)."""
        for p in (self.cold_meta_path(fp), self.cold_data_path(fp)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def cold_index(self) -> list:
        """Fingerprints of the completed COLD entries (sidecar
        present), sorted — the fsck/drill view of the cold tier."""
        if self.cold_dir is None:
            return []
        out = []
        try:
            shards = sorted(os.listdir(self.cold_dir))
        except OSError:
            return []
        for shard in shards:
            sub = os.path.join(self.cold_dir, shard)
            if not os.path.isdir(sub):
                continue
            try:
                names = os.listdir(sub)
            except OSError:
                continue
            out.extend(n[:-5] for n in names if n.endswith(".json"))
        return sorted(out)

    # -- encoded wire bodies ------------------------
    def _wire_publish(self, fp: str, body: bytes) -> None:
        """Atomic ``<fp>.wire`` spill: frame bytes + big-endian CRC32
        footer, write-temp-``os.replace`` — a disk wire hit streams
        these bytes back without materializing the array."""
        suffix = f".tmp.{os.getpid()}.{threading.get_ident()}"
        tmp = self.wire_path(fp) + suffix
        crc = zlib.crc32(body) & 0xFFFFFFFF
        try:
            with open(tmp, "wb") as f:
                f.write(body)
                f.write(crc.to_bytes(4, "big"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.wire_path(fp))
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _wire_load(self, fp: str) -> Optional[bytes]:
        """Read + CRC-verify a ``.wire`` file; a
        failing body is unlinked and counted ``evict.corrupt`` —
        the PRODUCT entry, verified separately, stays servable."""
        from blit_torch import integrity

        path = self.wire_path(fp)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        ok = len(blob) >= 4
        if ok and integrity.cache_verify_enabled():
            t0 = time.perf_counter()
            ok = ((zlib.crc32(blob[:-4]) & 0xFFFFFFFF)
                  == int.from_bytes(blob[-4:], "big"))
            integrity.observe_verify(time.perf_counter() - t0,
                                     self.timeline)
        if not ok:
            integrity.incr("integrity.cache.corrupt")
            log.warning("wire body %s fails its CRC footer; evicting",
                        fp[:16])
            try:
                os.unlink(path)
            except OSError:
                pass
            self._count("evict.corrupt")
            return None
        return blob[:-4]

    def get_wire(self, fp: str) -> Optional[Tuple[bytes, str]]:
        """``(encoded wire body, tier)`` for an entry whose framed form
        is retained (``tier`` in ``("ram", "disk")``), or ``None`` —
        which is NOT counted as a miss: the caller falls back to
        :meth:`get` (which counts), so per-tier accounting stays
        single-entry.  Hits count ``hit.ram``/``hit.disk`` like any
        other hit, plus ``hit.wire`` naming the fast path taken."""
        with self._lock:
            hit = self._wire.get(fp)
            if hit is not None:
                self._wire.move_to_end(fp)
                self.counts["hit.ram"] += 1
                self.counts["hit.wire"] += 1
                self._note_hit_locked(fp)
                self.timeline.count("cache.hit.ram")
                self.timeline.count("cache.hit.wire")
                return hit[0], "ram"
        if self.root is None:
            return None
        body = self._wire_load(fp)
        if body is None:
            return None
        with self._lock:
            self._wire_put_locked(fp, body)
            self.counts["hit.disk"] += 1
            self.counts["hit.wire"] += 1
            self._note_hit_locked(fp)
        self.timeline.count("cache.hit.disk")
        self.timeline.count("cache.hit.wire")
        return body, "disk"

    def put_wire(self, fp: str, body: bytes) -> None:
        """Retain the already-encoded wire body of a completed entry:
        the next binary-wire hit is one memoryview write — no
        re-encode, no ndarray copy.  RAM (shared budget, wire-first
        eviction, never displacing a product) then disk spill; a
        failed spill is logged and dropped — the body is re-derivable
        from its product, so losing it costs one future encode."""
        with self._lock:
            self._wire_put_locked(fp, body)
        if self.root is not None:
            try:
                self._wire_publish(fp, body)
            except OSError as e:
                log.warning("wire spill of %s failed: %s", fp[:16], e)

    # -- public surface ----------------------------------------------------
    def get(self, fp: str) -> Optional[Tuple[Dict, np.ndarray, str]]:
        """``(header, read-only data, tier)`` for a completed entry
        (``tier`` in ``("ram", "disk", "cold")``; disk hits are promoted
        to RAM, cold hits are CRC-verified and promoted to disk+RAM),
        or ``None`` on a miss."""
        with self._lock:
            hit = self._ram.get(fp)
            if hit is not None:
                self._ram.move_to_end(fp)
                self.counts["hit.ram"] += 1
                self._note_hit_locked(fp)
                self.timeline.count("cache.hit.ram")
                # dict() copy out: the array is frozen, but a caller
                # mutating a by-reference header would corrupt the entry
                # for every later hitter.
                return dict(hit[0]), hit[1], "ram"
        if self.root is not None:
            loaded = self._disk_load(fp)
            if loaded is not None:
                header, data = loaded
                with self._lock:
                    self._ram_put_locked(fp, header, data)
                    self.counts["hit.disk"] += 1
                    self._note_hit_locked(fp)
                self.timeline.count("cache.hit.disk")
                return dict(header), data, "disk"
        if self.cold_dir is not None:
            loaded = self._cold_load(fp)
            if loaded is not None:
                header, data = loaded
                with self._lock:
                    self._ram_put_locked(fp, header, data)
                    self.counts["hit.cold"] += 1
                    self._note_hit_locked(fp)
                self.timeline.count("cache.hit.cold")
                return dict(header), data, "cold"
        self._count("miss")
        return None

    def put(self, fp: str, header: Dict, data: np.ndarray,
            *, recipe: Optional[Dict] = None) -> np.ndarray:
        """Publish a finished product under ``fp`` (RAM, then disk spill).
        A disk-publish failure (including an injected ``cache.publish``
        fault) downgrades to a RAM-only entry — the result in hand is
        still correct and MUST still be served (count
        ``publish.error``).  Returns the read-only array the cache will
        serve, so the publisher and later hitters share bytes.
        ``recipe`` (the serve request's knob surface) rides
        the meta sidecar so ``blit fsck --repair`` can re-derive the
        entry after a quarantine."""
        data = _frozen(data)
        header = dict(header)
        with self._lock:
            self._ram_put_locked(fp, header, data)
            self.counts["publish"] += 1
        if self.root is not None:
            try:
                self._disk_publish(fp, header, data, recipe=recipe)
            except Exception as e:  # noqa: BLE001 — serve-path must survive
                log.warning("disk publish of %s failed: %s", fp[:16], e)
                self._count("publish.error")
                if not os.path.exists(self.meta_path(fp)):
                    # A data file that landed without its sidecar (the
                    # failure hit between the two renames) is an orphan
                    # no index/eviction pass would ever reclaim.
                    try:
                        os.unlink(self.data_path(fp))
                    except OSError:
                        pass
        return data

    def verify_entry(self, fp: str, quarantine: bool = False
                     ) -> Optional[bool]:
        """Content-verify one completed disk entry (the scrubber's and
        ``blit fsck``'s unit of work).  Returns None when the
        entry does not exist, True when it verifies, False when it does
        not — in which case it is QUARANTINED (moved into
        ``<root>/.quarantine/``, inspectable, no longer servable) when
        asked, else evicted; either way counted ``evict.corrupt``."""
        from blit_torch import integrity

        if self.root is None:
            return None
        mpath = self.meta_path(fp)
        if not os.path.exists(mpath):
            return None
        ok = True
        try:
            with open(mpath) as f:
                meta = json.load(f)
            want = integrity.parse_crc(meta.get("crc32"))
            if want is not None:
                ok = integrity.crc32_file(self.data_path(fp)) == want
            else:
                from blit_torch.io.fbh5 import resume_target_ok

                ok = resume_target_ok(
                    self.data_path(fp), int(meta["nifs"]),
                    int(meta["nchans"]), int(meta["nsamps"]))
        except (OSError, ValueError, KeyError, TypeError):
            ok = False  # torn meta / missing data: fail closed
        if ok:
            # The derived wire body is scrubbed alongside its product:
            # a failing footer costs ONLY the encoded copy (unlinked,
            # counted) — the verified product entry stays servable.
            if os.path.exists(self.wire_path(fp)):
                self._wire_load(fp)
            return True
        integrity.incr("integrity.cache.corrupt")
        log.warning("cache entry %s failed verification; %s", fp[:16],
                    "quarantining" if quarantine else "evicting")
        if quarantine:
            integrity.quarantine_move(
                [self.data_path(fp), mpath], self.root)
            try:
                os.unlink(self.wire_path(fp))
            except OSError:
                pass
            with self._lock:
                old = self._ram.pop(fp, None)
                if old is not None:
                    self._ram_used -= old[2]
                old_wire = self._wire.pop(fp, None)
                if old_wire is not None:
                    self._wire_used -= old_wire[1]
            self._count("evict.corrupt")
        else:
            self._disk_evict(fp, "corrupt")
        return False

    # Hotness-tracking bound: enough for any realistic hot set, small
    # enough that the tracker can never become the memory story.
    _HOT_TRACK_MAX = 4096

    def _note_hit_locked(self, fp: str) -> None:
        self._hits_by_fp[fp] = self._hits_by_fp.get(fp, 0) + 1
        self._hits_by_fp.move_to_end(fp)
        while len(self._hits_by_fp) > self._HOT_TRACK_MAX:
            self._hits_by_fp.popitem(last=False)

    def warm_range(self, in_range=None, n: int = 16) -> list:
        """The ``n`` hottest fingerprints as ``(fp, hits)`` pairs,
        hit-count descending (recency breaks ties), restricted to the
        fingerprints ``in_range`` accepts (a predicate; None = all).
        The range-scoped form serves elastic warm handoff:
        a resize moves exactly one peer's key range, so only entries in
        that range are worth streaming to the joiner."""
        with self._lock:
            items = list(self._hits_by_fp.items())
        items.reverse()  # most-recent first → stable tie-break
        items.sort(key=lambda kv: kv[1], reverse=True)
        if in_range is not None:
            items = [kv for kv in items if in_range(kv[0])]
        return items[:max(0, int(n))]

    def hot(self, n: int = 16) -> list:
        """The ``n`` hottest fingerprints as ``(fp, hits)`` pairs —
        the full-keyspace :meth:`warm_range` view (the fleet plane's
        cache-warm / drain-hint source)."""
        return self.warm_range(None, n)

    def contains(self, fp: str) -> bool:
        with self._lock:
            if fp in self._ram:
                return True
        if self.root is not None and os.path.exists(self.meta_path(fp)):
            return True
        return (self.cold_dir is not None
                and os.path.exists(self.cold_meta_path(fp)))

    def index(self) -> list:
        """Fingerprints of the COMPLETED disk entries (sidecar present)."""
        if self.root is None:
            return []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n[:-5] for n in names if n.endswith(".json"))

    def clear(self) -> None:
        with self._lock:
            self._ram.clear()
            self._ram_used = 0
            self._wire.clear()
            self._wire_used = 0
        for fp in self.index():
            self._disk_evict(fp, "disk")
        # A wire body can outlive its product entry (RAM-only product,
        # spilled frame) — sweep stray .wire files too.
        if self.root:
            try:
                names = os.listdir(self.root)
            except OSError:
                names = []
            for n in names:
                if n.endswith(".wire"):
                    try:
                        os.unlink(os.path.join(self.root, n))
                    except OSError:
                        pass


def _jsonable(header: Dict) -> Dict:
    """The JSON-safe view of a product header (numpy scalars → Python)."""
    out = {}
    for k, v in header.items():
        if isinstance(v, np.generic):
            v = v.item()
        out[k] = v
    return out
