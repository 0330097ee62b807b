"""Consistent-hash ring over reduction fingerprints.

The fleet front door (blit/serve/fleet.py) routes every product request
to a stable OWNER peer plus ``replicas - 1`` successor peers.  Keys are
the content-addressed reduction fingerprints — order-insensitive
over the raw members and every output-affecting knob — so two front
doors (or two processes of one door across restarts) agree on ownership
without coordination, and cross-host dedupe is structural: the same
product always lands on the same owner's cache.

Design points:

- **Hashes are sha256**, never Python ``hash()``: ``PYTHONHASHSEED``
  randomizes the latter per process, and ring agreement ACROSS processes
  is the whole point (pinned by tests/test_fleet_ring.py's subprocess
  determinism drill).
- **Virtual nodes** (``vnodes`` per peer) smooth the load spread: with
  the default 128 vnodes a peer's share of a large keyspace stays within
  a small factor of fair (the uniform-spread invariant test bounds it).
- **Minimal movement**: removing a peer moves ONLY the keys it owned
  (≈ K/N of K keys over N peers) onto their next successors; adding one
  moves only the keys it now owns.  Everything else stays put — a
  rolling restart must not invalidate the whole fleet's cache.
- **Replica sets never collapse**: ``owners(key, n)`` walks the ring
  clockwise collecting DISTINCT peers, so a replica set has ``min(n,
  peers)`` different hosts however the vnodes interleave.

The ring itself is pure data (stdlib only, thread-safe); liveness —
ejecting a dead peer, rejoining a recovered one — is the front door's
job (:class:`blit_torch.serve.fleet.FleetFrontDoor`), which calls
:meth:`remove` / :meth:`add` off its lease watch.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["HashRing", "ring_hash"]


def ring_hash(key: str) -> int:
    """A 64-bit ring position for ``key`` — the top 8 bytes of its
    sha256, so positions are stable across processes and platforms."""
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring mapping keys to ordered distinct peer sets.

    ``peers`` seeds the ring; ``vnodes`` is the virtual-node count per
    peer (spread smoothness); ``replicas`` is the DEFAULT owner-set size
    :meth:`owners` returns.  All methods are thread-safe.
    """

    def __init__(self, peers: Iterable[str] = (), *, vnodes: int = 128,
                 replicas: int = 2):
        self.vnodes = max(1, int(vnodes))
        self.replicas = max(1, int(replicas))
        self._lock = threading.Lock()
        self._peers: Dict[str, bool] = {}
        # Sorted parallel arrays: vnode position -> owning peer.
        self._points: List[int] = []
        self._owners: List[str] = []
        for p in peers:
            self.add(p)

    # -- membership --------------------------------------------------------
    def _vnode_points(self, peer: str) -> List[int]:
        return [ring_hash(f"{peer}#{v}") for v in range(self.vnodes)]

    def add(self, peer: str) -> bool:
        """Join ``peer`` (idempotent).  Returns True when it was new."""
        with self._lock:
            if peer in self._peers:
                return False
            self._peers[peer] = True
            for pt in self._vnode_points(peer):
                i = bisect.bisect(self._points, pt)
                self._points.insert(i, pt)
                self._owners.insert(i, peer)
            return True

    def remove(self, peer: str) -> bool:
        """Leave ``peer`` (idempotent).  Returns True when it was
        present.  Only the keys it owned move — to their next clockwise
        successor — which is the minimal-movement contract."""
        with self._lock:
            if peer not in self._peers:
                return False
            del self._peers[peer]
            keep = [(pt, o) for pt, o in zip(self._points, self._owners)
                    if o != peer]
            self._points = [pt for pt, _ in keep]
            self._owners = [o for _, o in keep]
            return True

    def peers(self) -> List[str]:
        with self._lock:
            return sorted(self._peers)

    def __len__(self) -> int:
        with self._lock:
            return len(self._peers)

    def __contains__(self, peer: str) -> bool:
        with self._lock:
            return peer in self._peers

    # -- lookup ------------------------------------------------------------
    def owners(self, key: str, n: Optional[int] = None,
               exclude: Sequence[str] = ()) -> List[str]:
        """The ordered DISTINCT owner set for ``key``: the first peer is
        the owner, the rest its failover/hedge replicas, clockwise from
        the key's ring position.  ``n`` defaults to the ring's
        ``replicas``; fewer peers than ``n`` returns them all.
        ``exclude`` skips peers (an ejected-but-not-yet-removed host)."""
        want = self.replicas if n is None else max(1, int(n))
        skip = set(exclude)
        with self._lock:
            if not self._points:
                return []
            out: List[str] = []
            seen = set(skip)
            start = bisect.bisect(self._points, ring_hash(key))
            m = len(self._points)
            for step in range(m):
                peer = self._owners[(start + step) % m]
                if peer in seen:
                    continue
                seen.add(peer)
                out.append(peer)
                if len(out) >= want:
                    break
            return out

    def owner(self, key: str) -> Optional[str]:
        got = self.owners(key, 1)
        return got[0] if got else None

    # -- diagnostics -------------------------------------------------------
    def spread(self, keys: Iterable[str]) -> Dict[str, int]:
        """How many of ``keys`` each peer owns — the uniform-load
        invariant's measurement (tests) and ``fleet stats``' ring row."""
        counts = {p: 0 for p in self.peers()}
        for k in keys:
            o = self.owner(k)
            if o is not None:
                counts[o] += 1
        return counts

    def moved(self, keys: Iterable[str], other: "HashRing"
              ) -> Tuple[int, int]:
        """``(moved, total)`` keys whose OWNER differs between this ring
        and ``other`` — the minimal-key-movement invariant's
        measurement."""
        moved = total = 0
        for k in keys:
            total += 1
            if self.owner(k) != other.owner(k):
                moved += 1
        return moved, total

    # -- resize deltas ------------------------------------------
    def incoming_keys(self, joiner: str,
                      keys: Iterable[str]) -> List[str]:
        """The subset of ``keys`` whose ownership would MOVE to
        ``joiner`` if it joined now — the scale-out warm-handoff range.
        Pure: computed on a shadow ring, this ring is not mutated.  By
        minimal movement these are the ONLY keys that move, so warming
        exactly this range makes the membership flip hit-rate neutral.
        A ``joiner`` already present owns its current keys."""
        members = self.peers()
        if joiner not in members:
            members.append(joiner)
        shadow = HashRing(members, vnodes=self.vnodes,
                          replicas=self.replicas)
        return [k for k in keys if shadow.owner(k) == joiner]

    def departing_keys(self, leaver: str,
                       keys: Iterable[str]) -> List[str]:
        """The subset of ``keys`` ``leaver`` currently owns — exactly
        what moves to the clockwise successors when it leaves (the
        scale-in pre-warm range)."""
        return [k for k in keys if self.owner(k) == leaver]
