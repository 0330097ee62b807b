"""blit_torch.serve — the product service layer.

Counterpart of ``blit.serve`` with the same ``__all__``, recipes,
fingerprints, cache layout and wire frames, so either package serves,
caches and decodes what the other produced.  A miss is a reduction on
the service's device: ``ProductService(device=None)`` runs the port's
Hopper kernels on the card (and raises without one), ``device="cpu"``
their plain versions.

The multi-tenant serving stack over the reduction machinery:

- :mod:`blit_torch.serve.cache` — two-tier (RAM LRU over disk FBH5)
  content-addressed product cache keyed by reduction fingerprint;
- :mod:`blit_torch.serve.scheduler` — priority scheduler with admission control
  (bounded queues, :class:`Overloaded` rejection, fair share across
  clients, health-aware concurrency budget);
- :mod:`blit_torch.serve.service` — :class:`ProductService`, the front door:
  ``submit() -> Ticket`` / ``result()`` / ``get()``, single-flight
  request coalescing, cache-first serving.

The FLEET plane scales the same stack across hosts:

- :mod:`blit_torch.serve.ring` — :class:`HashRing`, consistent-hash routing
  of fingerprints to owner+replica peer sets;
- :mod:`blit_torch.serve.http` — the stdlib-HTTP wire: :class:`PeerServer`
  (one ProductService served over ``/product`` with lease heartbeats
  and the monitor plane's ``/metrics``–``/healthz``) and
  :class:`FrontDoorServer`;
- :mod:`blit_torch.serve.fleet` — :class:`FleetFrontDoor`: ring routing,
  lease-driven peer ejection/rejoin, per-peer breakers, hedged reads
  off the live p99, deadline propagation, cache-warm replication and
  graceful drain.

The HOT-PATH data plane makes the fleet wire fast:
:class:`ConnectionPool` keep-alive sockets on every hop, the
``application/x-blit-product`` binary frame
(:class:`~blit_torch.serve.http.WireError` guards decode) negotiated by
``Accept``, and the cache's encoded-wire-body tier so a hot hit never
re-encodes.

The ELASTIC plane closes the burn-rate→membership loop:
:class:`FleetController` admits lease-fresh standbys after a
range-scoped warm handoff when the SLO pages, and drains/retires the
coldest peer after sustained idle — hysteresis-gated so membership
never flaps.
"""

from blit_torch.serve.cache import (
    ProductCache,
    fingerprint_for,
    reduction_fingerprint,
)
from blit_torch.serve.elastic import FleetController
from blit_torch.serve.fleet import FleetError, FleetFrontDoor
from blit_torch.serve.http import (
    ConnectionPool,
    FrontDoorServer,
    PeerServer,
    WireError,
)
from blit_torch.serve.ring import HashRing
from blit_torch.serve.scheduler import (
    Cancelled,
    DeadlineExpired,
    Job,
    Overloaded,
    Scheduler,
)
from blit_torch.serve.service import ProductRequest, ProductService, Ticket

__all__ = [
    "Cancelled",
    "ConnectionPool",
    "DeadlineExpired",
    "FleetController",
    "FleetError",
    "FleetFrontDoor",
    "FrontDoorServer",
    "HashRing",
    "Job",
    "Overloaded",
    "PeerServer",
    "ProductCache",
    "ProductRequest",
    "ProductService",
    "Scheduler",
    "Ticket",
    "WireError",
    "fingerprint_for",
    "reduction_fingerprint",
]
