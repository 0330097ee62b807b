"""Stdlib-HTTP plumbing for the fleet serve plane.

One wire, three speakers:

- **codecs** — :func:`wire_request` / :func:`request_from_wire` carry a
  :class:`~blit_torch.serve.service.ProductRequest` as its JSON recipe (the
  re-derivation recipe made transport), and
  :func:`encode_product` / :func:`decode_product` carry the finished
  ``(header, array)`` product as JSON + base64 payload bytes — small
  products by design (the serve layer returns reduced arrays, not raw
  voltages), so JSON keeps every hop debuggable with ``curl``.  The
  hot path speaks ``application/x-blit-product`` instead:
  :func:`encode_product_wire` / :func:`decode_product_wire` frame the
  same product as a length-prefixed JSON meta document + the raw
  C-order payload bytes — no base64 size tax, no payload copy on
  decode — negotiated by ``Accept`` so legacy JSON clients keep
  working bit-for-bit (``X-Blit-Wire`` on the response says which
  form answered).
- **transport** — :func:`http_request` is the byte-exact transport
  half (one round-trip → status, headers, payload bytes);
  :func:`http_json` is the codec half layered on top.
  :class:`ConnectionPool` gives the fleet's hops bounded per-peer
  keep-alive sockets; transport errors on a reused socket evict it
  and retry once on a fresh dial, so the failover/breaker
  semantics only ever judge fresh-dial verdicts.
- :class:`PeerServer` — one serving peer: a
  :class:`~blit_torch.serve.service.ProductService` behind ``POST /product``
  (+ ``/warm`` cache-warm hints, ``/stats``, ``POST /drain``), with the
  ``/metrics``–``/healthz`` surface REUSED from
  :class:`blit_torch.monitor.MetricsPublisher` (same Prometheus exposition,
  same honest-degradation health document) and a heartbeat
  :class:`blit_torch.recover.Lease` beaten on a background thread so the
  front door detects a dead/wedged peer within the lease TTL — the
  recover-plane staleness contract applied to serving.
- :class:`FrontDoorServer` — the fleet front door
  (:class:`blit_torch.serve.fleet.FleetFrontDoor`) as an HTTP service with
  the same ``/product`` shape, an AGGREGATED ``/healthz``
  (:func:`blit_torch.monitor.fold_health`), and ``/metrics`` for the routing
  counters (hedges, failovers, ejections).

Error mapping, both servers: :class:`~blit_torch.serve.scheduler.Overloaded`
→ **503** with the seeded-jitter ``retry_after_s`` honored as the
``Retry-After`` header (the thundering-herd satellite);
:class:`~blit_torch.serve.scheduler.DeadlineExpired` → **504** (the request
was never computed); anything else → **500** carrying the error type.

:func:`install_drain_handler` wires SIGTERM/SIGINT to a graceful drain
(refuse new, finish in-flight, release ``kind="stream"`` holds) — used
by the ``fleet-peer`` command so an interpreter exit
stops leaking capacity holds.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from blit_torch import faults, observability
from blit_torch.config import DEFAULT, SiteConfig
from blit_torch.serve.scheduler import DeadlineExpired, Overloaded

log = logging.getLogger("blit_torch.serve.http")


# -- trace context on the wire ------------------------
#
# Every fleet HTTP hop carries the trace context as headers, so the
# receiving process reactivates the caller's context and its spans
# parent onto the caller's — one request, one trace, across processes.
TRACE_HEADER = "X-Blit-Trace"
SPAN_HEADER = "X-Blit-Span"
HEDGE_HEADER = "X-Blit-Hedge"
REQUEST_ID_HEADER = "X-Blit-Request"
# Response side: the peer reports which cache tier answered, so the
# front door's access record carries the tier outcome it cannot see.
TIER_HEADER = "X-Blit-Tier"


def trace_headers(ctx: Optional[Dict] = None, *, hedge: bool = False,
                  rid: Optional[str] = None) -> Dict[str, str]:
    """The outgoing headers for one hop: the ambient (or given) trace
    context, the hedge tag, and the request id."""
    if ctx is None:
        ctx = observability.tracer().context()
    out: Dict[str, str] = {}
    if ctx:
        out[TRACE_HEADER] = str(ctx.get("trace", ""))
        out[SPAN_HEADER] = str(ctx.get("span", ""))
    if hedge:
        out[HEDGE_HEADER] = "1"
    if rid:
        out[REQUEST_ID_HEADER] = rid
    return out


def trace_context_from(headers: Optional[Dict]) -> Optional[Dict]:
    """The ``{"trace", "span"}`` context a request's headers carry
    (None when absent) — feed it to ``tracer().activate`` so peer-side
    spans parent onto the caller's span across the process boundary."""
    if not headers:
        return None
    trace = headers.get(TRACE_HEADER.lower())
    span = headers.get(SPAN_HEADER.lower())
    if not trace or not span:
        return None
    return {"trace": trace, "span": span}


# -- wire codecs -------------------------------------------------------------


def encode_product(header: Dict, data: np.ndarray) -> Dict:
    """The JSON wire form of a finished product: header + shape/dtype +
    base64 payload bytes (C-order)."""
    arr = np.ascontiguousarray(data)
    return {
        "header": {k: (v.item() if isinstance(v, np.generic) else v)
                   for k, v in dict(header).items()},
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "data_b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def decode_product(doc: Dict) -> Tuple[Dict, np.ndarray]:
    """Inverse of :func:`encode_product` — the array comes back
    READ-ONLY (``np.frombuffer`` of immutable bytes), matching the
    cache's frozen-result contract."""
    raw = base64.b64decode(doc["data_b64"])
    arr = np.frombuffer(raw, dtype=np.dtype(doc["dtype"]))
    arr = arr.reshape(tuple(doc["shape"]))
    return dict(doc["header"]), arr


# -- binary product wire ------------------------------
#
# ``application/x-blit-product``: WIRE_MAGIC, a big-endian u32 meta
# length, the JSON meta document ({"header", "shape", "dtype", "order"}
# — dtype as numpy's ``.str`` form, e.g. "<f4", so endianness rides the
# wire explicitly), then the raw C-order payload bytes.  Compared with
# the JSON+base64 wire: no ~33% base64 size tax, no encode copy on a
# cached hit (the frame is the cacheable body), and decode is an
# ``np.frombuffer`` view over the received buffer — zero payload
# copies on either end.

WIRE_CTYPE = "application/x-blit-product"
WIRE_HEADER = "X-Blit-Wire"
WIRE_MAGIC = b"BLW1"
# A product meta document is a header + shape/dtype — kilobytes.  A
# frame claiming more is torn or hostile: refuse before allocating.
WIRE_MAX_META = 4 << 20


class WireError(ValueError):
    """A binary product frame that cannot be trusted: bad magic, a
    truncated meta/payload, or an implausible meta length."""


def encode_product_parts(header: Dict,
                         data: np.ndarray) -> Tuple[bytes, memoryview]:
    """The zero-copy form of :func:`encode_product_wire`:
    ``(prefix bytes, payload buffer)`` with the payload a flat byte
    memoryview of the (contiguous) array — the server writes both
    straight to the socket without joining them into one copy."""
    arr = np.ascontiguousarray(data)
    meta = json.dumps({
        "header": {k: (v.item() if isinstance(v, np.generic) else v)
                   for k, v in dict(header).items()},
        "shape": list(arr.shape),
        "dtype": arr.dtype.str,
        "order": "C",
    }).encode()
    if len(meta) > WIRE_MAX_META:
        raise WireError(f"product meta is {len(meta)} bytes "
                        f"(cap {WIRE_MAX_META})")
    prefix = WIRE_MAGIC + len(meta).to_bytes(4, "big") + meta
    # memoryview.cast refuses zero-size shapes; an empty product's
    # payload is simply no bytes.
    payload = (memoryview(b"") if arr.size == 0
               else memoryview(arr).cast("B"))
    return prefix, payload


def encode_product_wire(header: Dict, data: np.ndarray, *,
                        deflate: bool = False) -> bytes:
    """One ``application/x-blit-product`` frame as bytes — the
    cacheable wire body.  ``deflate``
    zlib-compresses the WHOLE frame; the response then carries
    ``Content-Encoding: deflate`` (worth it for compressible products
    only — float spectra mostly are not, so it defaults off)."""
    prefix, payload = encode_product_parts(header, data)
    body = prefix + bytes(payload)
    if deflate:
        body = zlib.compress(body, 6)
    return body


def decode_product_wire(buf, *,
                        encoding: Optional[str] = None
                        ) -> Tuple[Dict, np.ndarray]:
    """Inverse of :func:`encode_product_wire` — the array is a
    READ-ONLY ``np.frombuffer`` view over ``buf``'s payload bytes (the
    frozen-result contract, with zero payload copies).  Raises
    :class:`WireError` on a frame that cannot be trusted."""
    if encoding:
        if encoding.strip().lower() != "deflate":
            raise WireError(f"unknown content encoding {encoding!r}")
        try:
            buf = zlib.decompress(bytes(buf))
        except zlib.error as e:
            raise WireError(f"undecodable deflate frame: {e}") from None
    view = memoryview(buf)
    if len(view) < 8 or bytes(view[:4]) != WIRE_MAGIC:
        raise WireError("not a blit product frame (bad magic)")
    n = int.from_bytes(view[4:8], "big")
    if n > WIRE_MAX_META:
        raise WireError(f"implausible meta length {n} "
                        f"(cap {WIRE_MAX_META})")
    if len(view) < 8 + n:
        raise WireError(f"truncated frame: meta claims {n} bytes, "
                        f"{max(0, len(view) - 8)} present")
    try:
        meta = json.loads(bytes(view[8:8 + n]))
        dtype = np.dtype(meta["dtype"])
        shape = tuple(int(s) for s in meta["shape"])
    except (ValueError, KeyError, TypeError) as e:
        raise WireError(f"unparseable frame meta: {e}") from None
    want = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
    payload = view[8 + n:]
    if payload.nbytes != want:
        raise WireError(f"truncated frame: payload is {payload.nbytes} "
                        f"bytes, {dtype}{shape} needs {want}")
    arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
    arr.setflags(write=False)
    return dict(meta["header"]), arr


def wants_binary_product(accept: Optional[str]) -> bool:
    """Did the request's ``Accept`` header ask for the binary product
    wire?  Absent/other → the legacy JSON wire, bit-for-bit."""
    return WIRE_CTYPE in (accept or "")


def wants_deflate(accept_encoding: Optional[str]) -> bool:
    return "deflate" in (accept_encoding or "")


def wire_request(request, *, priority: int = 1, client: str = "anon",
                 deadline_s: Optional[float] = None) -> Dict:
    """A :class:`~blit_torch.serve.service.ProductRequest` as one wire
    document.  Live sessions (``kind="stream"``) are refused: a session
    is pinned to ONE host for its recording's duration — it has no
    meaningful ring owner, no replica, and no cacheable result, so the
    fleet plane serves bounded products only."""
    if request.kind == "stream":
        raise ValueError(
            "kind='stream' live sessions do not ride the fleet wire — "
            "submit them to one peer's ProductService directly")
    return {"recipe": request.recipe(), "priority": int(priority),
            "client": str(client),
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s))}


def request_from_wire(doc: Dict):
    """``(ProductRequest, priority, client, deadline_s)`` from a wire
    document (unknown recipe keys ignored — the
    :meth:`ProductRequest.from_recipe` forward-compat rule)."""
    from blit_torch.serve.service import ProductRequest

    req = ProductRequest.from_recipe(doc["recipe"])
    return (req, int(doc.get("priority", 1)),
            str(doc.get("client", "anon")), doc.get("deadline_s"))


# -- tiny HTTP client --------------------------------------------------------


class ConnectionPool:
    """A bounded, thread-safe per-peer keep-alive pool replacing the per-call ``HTTPConnection``:
    :meth:`request` leases a pooled socket to the target host (LIFO —
    the warmest socket first), runs one round-trip, and returns the
    socket when the response allows reuse.  A transport error on a
    REUSED socket evicts it and retries ONCE on a fresh dial — safe
    because every fleet POST is idempotent (content-addressed
    products, best-effort warms) — so breakers and failover only ever
    judge fresh-dial verdicts, exactly as before pooling.
    ``fleet.pool.open`` / ``fleet.pool.reuse`` / ``fleet.pool.evict``
    ride ``timeline``; the ``pool.reuse`` fault point fires on the
    reused-socket leg only (the ``BLIT_FAULTS`` drill seam —
    :class:`~blit_torch.faults.InjectedFault` is an ``OSError``, so a bare
    injected fault IS a mid-flight reset)."""

    def __init__(self, max_per_peer: int = 4, timeline=None):
        self.max_per_peer = max(1, int(max_per_peer))
        self.timeline = timeline
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int], List] = {}
        self._closed = False

    def _count(self, name: str) -> None:
        if self.timeline is not None:
            self.timeline.count(name)

    def _take(self, key):
        with self._lock:
            conns = self._idle.get(key)
            if conns:
                return conns.pop()
        return None

    def _give(self, key, conn) -> None:
        with self._lock:
            if not self._closed:
                conns = self._idle.setdefault(key, [])
                if len(conns) < self.max_per_peer:
                    conns.append(conn)
                    return
        conn.close()

    def stats(self) -> Dict[str, int]:
        """Idle sockets per peer — the reuse-ratio denominator lives
        on the timeline counters; this is the live pool occupancy."""
        with self._lock:
            return {f"{h}:{p}": len(c)
                    for (h, p), c in self._idle.items() if c}

    def evict_peer(self, url: str) -> int:
        """Sever and drop every idle socket to ``url``'s host — called
        when a peer leaves the ring (ejection or elastic scale-in),
        so no later request is written to a departed peer's
        dead keep-alive.  Counts ``fleet.pool.evict`` per socket;
        returns how many were evicted."""
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        key = (parts.hostname or "127.0.0.1", parts.port or 80)
        with self._lock:
            conns = self._idle.pop(key, [])
        for c in conns:
            self._count("fleet.pool.evict")
            try:
                c.close()
            except OSError:
                pass
        return len(conns)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for lst in self._idle.values() for c in lst]
            self._idle.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def request(self, method: str, url: str, path: str, body=None,
                headers: Optional[Dict[str, str]] = None,
                timeout: float = 10.0
                ) -> Tuple[int, Dict[str, str], bytes]:
        """One round-trip → ``(status, lower-cased headers, payload
        bytes)``.  Raises ``OSError`` on fresh-dial transport failure,
        exactly like an unpooled connection — a reused-socket failure
        is absorbed by the evict-and-redial retry."""
        import http.client
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        key = (parts.hostname or "127.0.0.1", parts.port or 80)
        conn = self._take(key)
        if conn is not None:
            self._count("fleet.pool.reuse")
            try:
                faults.fire("pool.reuse", key=f"{key[0]}:{key[1]}")
                return self._roundtrip(conn, key, method, path, body,
                                       headers, timeout)
            except OSError:
                # Stale keep-alive (peer restarted, idle timeout,
                # mid-flight reset): evict, fall through to the dial.
                self._count("fleet.pool.evict")
                try:
                    conn.close()
                except OSError:
                    pass
        conn = http.client.HTTPConnection(key[0], key[1], timeout=timeout)
        self._count("fleet.pool.open")
        try:
            return self._roundtrip(conn, key, method, path, body,
                                   headers, timeout)
        except BaseException:
            conn.close()
            raise

    def _roundtrip(self, conn, key, method, path, body, headers,
                   timeout) -> Tuple[int, Dict[str, str], bytes]:
        # Per-request deadline on a long-lived socket: the connection's
        # dial timeout is whatever the FIRST request chose — retune it.
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        conn.request(method, path, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        payload = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        if resp.will_close:
            conn.close()
        else:
            self._give(key, conn)
        return resp.status, hdrs, payload


def http_request(method: str, url: str, path: str, body=None,
                 headers: Optional[Dict[str, str]] = None,
                 timeout: float = 10.0,
                 pool: Optional[ConnectionPool] = None,
                 ) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP round-trip to ``url`` (``http://host:port``) →
    ``(status, lower-cased headers, payload bytes)`` — the byte-exact
    TRANSPORT half of :func:`http_json`.  ``pool``
    reuses a :class:`ConnectionPool` keep-alive socket; without one
    the connection is dialed and closed per call.  Raises ``OSError``
    on transport failure (refused/reset/timeout), which the front
    door classifies as a peer failure."""
    if pool is not None:
        return pool.request(method, url, path, body=body,
                            headers=headers, timeout=timeout)
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname,
                                      parts.port or 80, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        payload = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        return resp.status, hdrs, payload
    finally:
        conn.close()


def http_json(method: str, url: str, path: str, doc: Optional[Dict] = None,
              timeout: float = 10.0,
              headers: Optional[Dict[str, str]] = None,
              pool: Optional[ConnectionPool] = None,
              ) -> Tuple[int, Dict[str, str], object]:
    """One JSON request to ``url`` (``http://host:port``) →
    ``(status, headers, body)`` — the body is the parsed JSON when the
    response says so, the raw BYTES for a binary content type (the
    product wire — never text-decoded), else decoded text
    (``/metrics``).  ``headers`` adds extra request headers (the
    trace-context hop); ``pool`` rides a keep-alive socket.  Raises
    ``OSError`` on transport failure (refused/reset/timeout), which
    the front door classifies as a peer failure."""
    req_hdrs = dict(headers or {})
    body = None
    if doc is not None:
        body = json.dumps(doc).encode()
        req_hdrs["Content-Type"] = "application/json"
    status, hdrs, payload = http_request(method, url, path, body=body,
                                         headers=req_hdrs,
                                         timeout=timeout, pool=pool)
    ctype = (hdrs.get("content-type") or "").lower()
    if "json" in ctype:
        try:
            return status, hdrs, json.loads(payload or b"{}")
        except ValueError:
            pass
    if ctype.startswith(WIRE_CTYPE) or ctype.startswith(
            "application/octet"):
        return status, hdrs, payload
    return status, hdrs, payload.decode("utf-8", "replace")


# -- shared server skeleton --------------------------------------------------


def _make_server(router: Callable, port: int, host: str = "127.0.0.1"):
    """A ThreadingHTTPServer whose GET/POST route through ``router``:
    ``router(method, path, doc, headers) -> (status, body, ctype,
    headers)`` — the :func:`blit_torch.monitor._make_http_server` shape,
    generalized so the peer and the front door share one handler.
    ``headers`` is the request's header map with lower-cased keys (the
    trace-context hop rides it).  ``host`` defaults to loopback (safe
    local default); a multi-host fleet binds ``"0.0.0.0"``
    (``blit fleet-peer --host``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: the fleet's ConnectionPool
        # reuses sockets across requests.  Safe with the stdlib
        # handler because every response carries Content-Length.
        protocol_version = "HTTP/1.1"

        def _route(self, method: str):
            try:
                doc = None
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    try:
                        doc = json.loads(self.rfile.read(n))
                    except ValueError:
                        self.send_error(400, "unparseable JSON body")
                        return
                hdrs = {k.lower(): v for k, v in self.headers.items()}
                status, body, ctype, extra = router(
                    method, self.path, doc, hdrs)
            except Exception as e:  # noqa: BLE001 — a request must not kill
                log.warning("http route failed", exc_info=True)
                status, body, ctype, extra = (
                    500, json.dumps({"error": str(e),
                                     "etype": type(e).__name__}),
                    "application/json", {})
            if isinstance(body, tuple):
                # Zero-copy wire body: (prefix bytes,
                # payload buffer) written straight through — the
                # product's bytes are never joined into one copy.
                parts = list(body)
            else:
                parts = [body.encode() if isinstance(body, str) else body]
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length",
                             str(sum(len(p) for p in parts)))
            for k, v in (extra or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            for p in parts:
                self.wfile.write(p)

        def do_GET(self):  # noqa: N802 — stdlib contract
            self._route("GET")

        def do_POST(self):  # noqa: N802 — stdlib contract
            self._route("POST")

        def log_message(self, fmt, *args):  # quiet request traffic
            log.debug("http: " + fmt, *args)

    class Server(ThreadingHTTPServer):
        """Tracks live connections so ``close_all_connections`` can
        sever keep-alive sockets: with HTTP/1.1, closing the listener
        alone would leave a "dead" server still answering pooled
        clients through established connections."""

        daemon_threads = True

        def __init__(self, *a, **kw):
            self._conns = set()
            self._conns_lock = threading.Lock()
            super().__init__(*a, **kw)

        def get_request(self):
            sock, addr = super().get_request()
            with self._conns_lock:
                self._conns.add(sock)
            return sock, addr

        def shutdown_request(self, request):
            with self._conns_lock:
                self._conns.discard(request)
            super().shutdown_request(request)

        def close_all_connections(self):
            import socket as _socket

            with self._conns_lock:
                conns = list(self._conns)
                self._conns.clear()
            for s in conns:
                try:
                    s.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

    return Server((host, int(port)), Handler)


def _json_resp(status: int, doc: Dict,
               headers: Optional[Dict] = None) -> Tuple:
    return status, json.dumps(doc), "application/json", headers or {}


def history_query(path: str) -> Tuple[float, float, Optional[str]]:
    """Parse a ``GET /history`` query string → ``(since, until, tier)``
    epochs.  ``since``/``until`` accept the shared window grammar
    (:func:`blit_torch.history.parse_when`: epoch, ``"15m"``-style
    ago-windows, ``"now"``); default: the last hour."""
    from urllib.parse import parse_qs, urlsplit

    from blit_torch.history import parse_when

    q = parse_qs(urlsplit(path).query)
    now = time.time()
    until = parse_when(q["until"][0], now) if q.get("until") else now
    since = (parse_when(q["since"][0], now) if q.get("since")
             else until - 3600.0)
    tier = q["tier"][0] if q.get("tier") else None
    return since, until, tier


def _history_doc(pub, path: str) -> Dict:
    """The peer ``GET /history`` body: this process's bucket records
    over the queried window, in the fleet-merge wire shape (the door
    folds peers' answers with :func:`blit_torch.history.merge_buckets`)."""
    since, until, tier = history_query(path)
    store = getattr(pub, "history", None)
    doc = {"t0": since, "t1": until, "enabled": store is not None,
           "host": observability.hostname(), "buckets": [], "metrics": []}
    if store is not None:
        doc["buckets"] = store.buckets(since, until, tier=tier)
        doc["metrics"] = store.metrics(window_s=max(60.0, until - since))
    return doc


def snapshot_with(timeline, name: Optional[str] = None) -> Dict:
    """This process's telemetry-snapshot wire document WITH spans — the
    ``/snapshot`` body both the peer and the front door serve: the
    process timeline merged with the serving component's (histogram
    exemplars ride the state), plus the full span buffer, stitchable by
    ``trace-view --fleet``."""
    from blit_torch.observability import Timeline, telemetry_snapshot

    doc = telemetry_snapshot(spans=True)
    merged = Timeline.from_state(doc["timeline"])
    merged.merge(timeline)
    doc["timeline"] = merged.state()
    if name is not None:
        doc["name"] = name
    return doc


def _error_resp(e: BaseException) -> Tuple:
    """The shared serve-error → HTTP mapping (module docstring)."""
    if isinstance(e, DeadlineExpired):
        return _json_resp(504, {"error": str(e), "etype": "DeadlineExpired",
                                "retry_after_s": e.retry_after_s})
    if isinstance(e, Overloaded):
        # The jittered back-off hint honored ON THE WIRE: every rejected client reads a DIFFERENT
        # Retry-After, so the herd does not return in one instant.
        ra = max(0.0, float(e.retry_after_s))
        return _json_resp(503, {"error": str(e), "etype": "Overloaded",
                                "retry_after_s": ra},
                          {"Retry-After": f"{ra:.3f}"})
    if type(e).__name__ == "CatalogMiss":
        # An archive session/scan the catalog does not hold
        # — the caller named it wrong: not-found, breaker-neutral.
        return _json_resp(404, {"error": str(e), "etype": "CatalogMiss"})
    return _json_resp(500, {"error": str(e), "etype": type(e).__name__})


# -- the serving peer --------------------------------------------------------


class PeerServer:
    """One cache/compute peer of the fleet (module docstring): a
    :class:`~blit_torch.serve.service.ProductService` served over HTTP, with
    lease heartbeats and the monitor plane's ``/metrics``–``/healthz``
    surface.  ``port=0`` binds an ephemeral port (``.port`` / ``.url``
    say which).  ``lease_dir``/``proc`` arm the heartbeat lease the
    front door watches; ``beat_interval_s`` should sit well under the
    fleet's ``peer_ttl_s`` (default: 0.5 s).

    The server owns its HTTP lifecycle but NOT the service: ``close()``
    stops serving and beating; draining/closing the service stays the
    caller's call (``blit fleet-peer`` wires SIGTERM → :meth:`drain` →
    exit)."""

    def __init__(self, service, *, name: str = "peer", port: int = 0,
                 host: str = "127.0.0.1",
                 lease_dir: Optional[str] = None, proc: int = 0,
                 beat_interval_s: float = 0.5,
                 request_timeout_s: float = 300.0,
                 config: SiteConfig = DEFAULT):
        self.service = service
        self.name = name
        self.request_timeout_s = float(request_timeout_s)
        # Whole-frame deflate on the binary wire, only when BOTH the
        # client advertises it and the knob says so (off by default:
        # float spectra compress poorly and the CPU tax lands on the
        # hot path).
        from blit_torch.config import fleet_defaults

        self._wire_deflate = bool(fleet_defaults(config)["wire_deflate"])
        # Per-request access records: one line
        # per handled /product with trace id, tier outcome, queue wait
        # and status — None (one attribute test per request) unless
        # BLIT_REQUEST_LOG / SiteConfig.request_log_dir is set.
        self.request_log = observability.request_log_for(
            f"peer-{name}", config)
        # The monitor plane's surface, reused wholesale: health() folds
        # breakers/recover-hooks/SLO burn; fleet_report() renders the
        # service timeline as native-histogram Prometheus exposition.
        from blit_torch.monitor import MetricsPublisher

        # port=-1 / spool_dir="": explicitly OFF — this server IS the
        # peer's endpoint; the publisher only renders its bodies.  With
        # the history store armed (BLIT_HISTORY_DIR) the publisher does
        # tick on the monitor interval, so the peer's /history rings fill
        # and its anomaly baselines score — still no second HTTP endpoint
        # and no spool.
        from blit_torch.config import history_defaults, monitor_defaults

        history_on = bool(history_defaults(config)["enabled"])
        self._pub = MetricsPublisher(
            interval_s=(monitor_defaults(config)["interval_s"]
                        if history_on else 3600.0),
            spool_dir="", port=-1, timeline=service.timeline,
            config=config)
        if history_on:
            self._pub.start()
        self._server = _make_server(self._route, port, host)
        self.port = self._server.server_address[1]
        # The advertised URL: loopback when bound there, else the
        # wildcard bind resolves to this host's name for the peers map.
        adv = "127.0.0.1" if host in ("127.0.0.1", "localhost") else host
        self.url = f"http://{adv}:{self.port}"
        self._server_thread: Optional[threading.Thread] = None
        self._lease = None
        self._beat_stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None
        if lease_dir is not None:
            from blit_torch.recover import Lease

            self._lease = Lease(lease_dir, proc)
            self._beat_interval_s = max(0.05, float(beat_interval_s))
        self.counts: Dict[str, int] = {"product": 0, "warm": 0}
        self._counts_lock = threading.Lock()

    # -- routing -----------------------------------------------------------
    def _route(self, method: str, path: str, doc: Optional[Dict],
               headers: Optional[Dict] = None) -> Tuple:
        if method == "GET" and path.startswith("/healthz"):
            return _json_resp(200, self.health())
        if method == "GET" and path.startswith("/metrics"):
            from blit_torch.observability import (
                OPENMETRICS_CTYPE,
                PROM_CTYPE,
                render_prometheus,
                wants_openmetrics,
            )

            om = wants_openmetrics((headers or {}).get("accept"))
            return (200, render_prometheus(self._pub.fleet_report(),
                                           openmetrics=om),
                    OPENMETRICS_CTYPE if om else PROM_CTYPE, {})
        if method == "GET" and path.startswith("/stats"):
            return _json_resp(200, self.stats())
        if method == "GET" and path.startswith("/snapshot"):
            # The fleet trace harvest surface:
            # this process's span batch + merged timeline state (with
            # histogram exemplars), in the telemetry-snapshot wire
            # shape — `blit trace-view --fleet <url>` stitches these.
            return _json_resp(200, self.snapshot())
        if method == "GET" and path.startswith("/history"):
            # The durable-store range query: bucket records
            # over ?since/?until — empty (enabled=false) until
            # BLIT_HISTORY_DIR arms the plane.
            return _json_resp(200, _history_doc(self._pub, path))
        if method == "POST" and path.startswith("/product"):
            return self._handle_product(doc or {}, headers or {})
        if method == "POST" and path.startswith("/warm"):
            return self._handle_warm(doc or {}, headers or {})
        if method == "POST" and path.startswith("/drain"):
            threading.Thread(target=self.drain, name=f"{self.name}-drain",
                             daemon=True).start()
            return _json_resp(200, {"draining": True})
        return _json_resp(404, {"error": f"no route {method} {path}"})

    def _wire_resp(self, body: bytes, tier: Optional[str], rid: str,
                   deflate: bool) -> Tuple:
        """One binary-wire 200: the already-encoded frame (optionally
        whole-frame deflated), ``X-Blit-Wire: binary`` naming the
        negotiated form, and the tier/rid headers as on the JSON
        wire."""
        extra = {TIER_HEADER: tier, REQUEST_ID_HEADER: rid,
                 WIRE_HEADER: "binary"}
        if deflate:
            body = zlib.compress(body, 6)
            extra["Content-Encoding"] = "deflate"
        self.service.timeline.count("serve.wire.binary")
        self.service.timeline.observe("fleet.wire_bytes", len(body))
        return 200, body, WIRE_CTYPE, extra

    def _handle_product(self, doc: Dict, headers: Dict) -> Tuple:
        with self._counts_lock:
            self.counts["product"] += 1
        # Reactivate the caller's trace context:
        # everything this request does on the peer — serve.reduce on the
        # scheduler's job thread included, via the submit-time context
        # capture — parents onto the FRONT DOOR's dispatch span, so one
        # request is one trace across processes.
        ctx = trace_context_from(headers)
        hedge = headers.get(HEDGE_HEADER.lower()) == "1"
        rid = headers.get(REQUEST_ID_HEADER.lower()) or observability.new_id()
        binary = wants_binary_product(headers.get("accept"))
        deflate = (binary and self._wire_deflate
                   and wants_deflate(headers.get("accept-encoding")))
        tr = observability.tracer()
        t0 = time.perf_counter()
        status, code, ticket, nbytes = "error", 500, None, 0
        fp = tier = qwait = None
        priority = client = deadline_s = None
        try:
            with tr.activate(ctx):
                req, priority, client, deadline_s = request_from_wire(doc)
                # The chaos schedule's injection point: kill/hang/delay
                # THIS peer on the Nth handled request (chaos --fleet).
                faults.fire("peer.request", key=str(req.raw_source))
                if binary:
                    # The encoded-body fast path: a retained wire body answers without
                    # re-encoding — or even materializing — the array.
                    hit = self.service.wire_for(req)
                    if hit is not None:
                        fp, body, tier = hit
                        nbytes = len(body)
                        status, code = "ok", 200
                        return self._wire_resp(body, tier, rid, deflate)
                timeout = (min(self.request_timeout_s, deadline_s)
                           if deadline_s is not None
                           else self.request_timeout_s)
                # submit + result (not service.get): the ticket carries
                # the tier outcome and queue wait the access record —
                # and the front door, via the tier response header —
                # need.
                ticket = self.service.submit(
                    req, priority=priority, client=client,
                    deadline_s=deadline_s)
                try:
                    header, data = self.service.result(ticket,
                                                       timeout=timeout)
                except TimeoutError as e:
                    if deadline_s is None:
                        raise
                    # The reduction ran PAST the caller's deadline (the
                    # admission estimate under-predicted): that is a
                    # deadline verdict — 504, which the front door
                    # treats as breaker-NEUTRAL — not a peer failure
                    # that should trip a healthy host's breaker.
                    raise DeadlineExpired(
                        f"deadline {deadline_s:.3f}s expired "
                        f"mid-compute: {e}") from e
            nbytes = data.nbytes
            status, code = "ok", 200
            fp, tier = ticket.fingerprint, ticket.source
            qwait = round(ticket.queue_wait_s(), 6)
            if binary:
                t_enc = time.perf_counter()
                body = encode_product_wire(header, data)
                self.service.timeline.observe(
                    "fleet.serialize_s", time.perf_counter() - t_enc)
                # Retain the encoded body: the NEXT binary hit for
                # this fingerprint skips the encode entirely.  Catalog
                # documents regenerate per ask (the tree grows under
                # them) — never retained.
                if tier != "catalog":
                    self.service.cache.put_wire(fp, body)
                return self._wire_resp(body, tier, rid, deflate)
            t_enc = time.perf_counter()
            resp = _json_resp(200, encode_product(header, data),
                              {TIER_HEADER: tier,
                               REQUEST_ID_HEADER: rid,
                               WIRE_HEADER: "json"})
            self.service.timeline.observe(
                "fleet.serialize_s", time.perf_counter() - t_enc)
            self.service.timeline.count("serve.wire.json")
            self.service.timeline.observe("fleet.wire_bytes",
                                          len(resp[1]))
            return resp
        except BaseException as e:  # noqa: BLE001 — mapped onto the wire
            from blit_torch.serve.scheduler import classify_failure

            resp = _error_resp(e)
            status, _ = classify_failure(e)
            # The record's code is WIRE truth — what this handler
            # actually answered (matches classify_failure except the
            # bare-TimeoutError corner, where the wire says 500).
            code = resp[0]
            return resp
        finally:
            if self.request_log is not None:
                dt = time.perf_counter() - t0
                if fp is None and ticket is not None:
                    # A failed flight still records its routing truth.
                    fp, tier = ticket.fingerprint, ticket.source
                    qwait = round(ticket.queue_wait_s(), 6)
                self.request_log.record(
                    rid=rid, trace=(ctx or {}).get("trace"), role="peer",
                    peer=self.name, client=client, priority=priority,
                    fp=(fp[:16] if fp else None),
                    tier=tier, queue_wait_s=qwait,
                    deadline_s=deadline_s,
                    deadline_left_s=(round(deadline_s - dt, 6)
                                     if deadline_s is not None else None),
                    hedged=(1 if hedge else None), status=status,
                    code=code, bytes=nbytes, duration_s=round(dt, 6))

    def _handle_warm(self, doc: Dict, headers: Dict) -> Tuple:
        """Cache-warm hints: submit each recipe at the
        lowest priority, fire-and-forget — a warm failure is a cold
        cache, never an error.  The peer's own cache/single-flight
        machinery dedupes repeats.  Warm reductions parent onto the
        hinting door's trace so replication work is
        attributable to the request that made the entry hot.

        Elastic warm handoff sends ``wait_s``: the response
        then blocks until the accepted recipes complete (or the budget
        burns), answering ``completed`` / ``bytes`` / ``timed_out`` —
        the joiner's warm-completion ack the controller gates the
        membership flip on.  ``priority`` overrides the default 9 so a
        handoff outranks background replication."""
        accepted = rejected = 0
        tickets: List = []
        from blit_torch.serve.service import ProductRequest

        try:
            priority = int(doc.get("priority", 9))
        except (TypeError, ValueError):
            priority = 9
        tr = observability.tracer()
        with tr.activate(trace_context_from(headers)):
            for recipe in (doc.get("recipes") or []):
                with self._counts_lock:
                    self.counts["warm"] += 1
                try:
                    tickets.append(self.service.submit(
                        ProductRequest.from_recipe(recipe),
                        priority=priority, client="fleet-warm"))
                    accepted += 1
                except Exception:  # noqa: BLE001 — warming is best-effort
                    rejected += 1
        self.service.timeline.count("serve.warm", accepted)
        out = {"accepted": accepted, "rejected": rejected}
        wait_s = doc.get("wait_s")
        if wait_s is not None:
            completed, warm_bytes, timed_out = 0, 0, False
            deadline = time.monotonic() + max(0.0, float(wait_s))
            for t in tickets:
                try:
                    _, data = self.service.result(
                        t, timeout=max(0.0, deadline - time.monotonic()))
                    completed += 1
                    warm_bytes += int(getattr(data, "nbytes", 0) or 0)
                except TimeoutError:
                    timed_out = True  # budget burned; rest stay queued
                    break
                except Exception:  # noqa: BLE001 — a failed warm is cold
                    pass
            out.update(completed=completed, bytes=warm_bytes,
                       timed_out=timed_out)
        # /warm negotiates like /product — its 202 body is
        # JSON either way (recipes in, counts out: nothing to frame),
        # so the header honestly answers "json" even to binary askers.
        return _json_resp(202, out, {WIRE_HEADER: "json"})

    # -- surfaces ----------------------------------------------------------
    def health(self) -> Dict:
        """The peer's ``/healthz`` body: the monitor plane's honest
        document, degraded further while this peer drains."""
        doc = self._pub.health()
        if self.service.draining():
            doc["reasons"] = list(doc.get("reasons") or []) + ["draining"]
            doc["ok"] = False
            doc["status"] = "degraded"
        doc["name"] = self.name
        return doc

    def stats(self) -> Dict:
        s = self.service.stats()
        s["name"] = self.name
        s["hot"] = self.service.cache.hot(8)
        with self._counts_lock:
            s["http"] = dict(self.counts)
        return s

    def snapshot(self) -> Dict:
        """This peer's ``/snapshot`` body (:func:`snapshot_with`)."""
        return snapshot_with(self.service.timeline, self.name)

    # -- lifecycle ---------------------------------------------------------
    def _beat_loop(self) -> None:
        while not self._beat_stop.wait(self._beat_interval_s):
            try:
                self._lease.beat()
            except OSError:
                log.warning("peer lease beat failed", exc_info=True)

    def start(self) -> "PeerServer":
        if self._server_thread is None:
            self._server_thread = threading.Thread(
                target=self._server.serve_forever,
                name=f"blit-peer-{self.name}", daemon=True)
            self._server_thread.start()
        if self._lease is not None and self._beat_thread is None:
            self._lease.beat()  # bring-up beat: alive before first tick
            self._beat_thread = threading.Thread(
                target=self._beat_loop, name=f"blit-peer-{self.name}-beat",
                daemon=True)
            self._beat_thread.start()
        return self

    def drain(self, timeout: Optional[float] = 30.0) -> Dict[str, int]:
        """Graceful drain: the service refuses new work and finishes
        in-flight (releasing live-session holds); the lease KEEPS
        beating and ``/healthz`` answers degraded-draining, so the
        front door routes around an announced shutdown instead of
        burning its lease TTL discovering it."""
        return self.service.drain(timeout)

    def close(self) -> None:
        self._beat_stop.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=2.0)
            self._beat_thread = None
        self._server.shutdown()
        self._server.server_close()
        self._server.close_all_connections()
        self._server_thread = None
        self._pub.close()
        if self.request_log is not None:
            self.request_log.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# -- the front door as HTTP --------------------------------------------------


class FrontDoorServer:
    """The fleet front door (:class:`blit_torch.serve.fleet.FleetFrontDoor`)
    served over HTTP: same ``/product`` wire as a peer (clients cannot
    tell one host from a fleet), aggregated ``/healthz``
    (:func:`blit_torch.monitor.fold_health` — one probe answers "is the fleet
    serving"), ``/metrics`` with the routing counters, ``/stats``, and
    ``POST /drain``."""

    def __init__(self, door, *, port: int = 0, host: str = "127.0.0.1"):
        self.door = door
        self._server = _make_server(self._route, port, host)
        self.port = self._server.server_address[1]
        adv = "127.0.0.1" if host in ("127.0.0.1", "localhost") else host
        self.url = f"http://{adv}:{self.port}"
        self._server_thread: Optional[threading.Thread] = None

    def _route(self, method: str, path: str, doc: Optional[Dict],
               headers: Optional[Dict] = None) -> Tuple:
        if method == "GET" and path.startswith("/healthz"):
            return _json_resp(200, self.door.health())
        if method == "GET" and path.startswith("/metrics"):
            from blit_torch.observability import (
                OPENMETRICS_CTYPE,
                PROM_CTYPE,
                wants_openmetrics,
            )

            om = wants_openmetrics((headers or {}).get("accept"))
            return (200, self.door.metrics_prometheus(openmetrics=om),
                    OPENMETRICS_CTYPE if om else PROM_CTYPE, {})
        if method == "GET" and path.startswith("/stats"):
            return _json_resp(200, self.door.stats())
        if method == "GET" and path.startswith("/snapshot"):
            return _json_resp(200, snapshot_with(self.door.timeline,
                                                 "door"))
        if method == "GET" and path.startswith("/history"):
            # Fleet-wide history: fan the range query out to every
            # live peer and fold the answers — one query
            # surface for "what did the FLEET look like last Tuesday".
            since, until, tier = history_query(path)
            return _json_resp(200, self.door.history(since, until,
                                                     tier=tier))
        if method == "POST" and path.startswith("/product"):
            # An external client's trace continues through the door
            #: activate its context so the door's
            # fleet.request span — and everything downstream — parents
            # onto it.
            tr = observability.tracer()
            binary = wants_binary_product((headers or {}).get("accept"))
            try:
                with tr.activate(trace_context_from(headers)):
                    req, priority, client, deadline_s = request_from_wire(
                        doc or {})
                    header, data = self.door.get(
                        req, priority=priority, client=client,
                        deadline_s=deadline_s)
            except BaseException as e:  # noqa: BLE001 — mapped
                return _error_resp(e)
            if binary:
                # Zero-copy to the client: prefix + payload buffer
                # written straight through (_make_server), no joined
                # body copy of the product bytes.
                return (200, encode_product_parts(header, data),
                        WIRE_CTYPE, {WIRE_HEADER: "binary"})
            return _json_resp(200, encode_product(header, data),
                              {WIRE_HEADER: "json"})
        if method == "POST" and path.startswith("/drain"):
            threading.Thread(target=self.door.drain,
                             name="blit-door-drain", daemon=True).start()
            return _json_resp(200, {"draining": True})
        return _json_resp(404, {"error": f"no route {method} {path}"})

    def start(self) -> "FrontDoorServer":
        if self._server_thread is None:
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, name="blit-front-door",
                daemon=True)
            self._server_thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._server.close_all_connections()
        self._server_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# -- signal wiring -----------------------------------------------------------


def install_drain_handler(drain_fn: Callable[[], object], *,
                          exit_after: bool = True,
                          signals: Optional[Tuple] = None):
    """Wire SIGTERM/SIGINT to a graceful drain:
    the FIRST signal runs ``drain_fn`` (refuse new, finish in-flight,
    release ``kind="stream"`` holds) and then — with ``exit_after`` —
    raises ``SystemExit(128+signum)``; a SECOND signal while draining
    exits immediately (the operator's escalation path).  Returns an
    uninstall callable restoring the previous handlers.  No-ops (and
    returns a no-op) off the main thread, where CPython forbids signal
    installation."""
    import signal as _signal

    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)
    prev = {}
    state = {"fired": False}

    def _handler(signum, frame):
        if state["fired"]:
            raise SystemExit(128 + signum)
        state["fired"] = True
        log.warning("signal %s: draining (second signal exits now)",
                    signum)
        try:
            drain_fn()
        finally:
            if exit_after:
                raise SystemExit(128 + signum)

    for s in signals:
        try:
            prev[s] = _signal.signal(s, _handler)
        except (ValueError, OSError):  # not the main thread
            pass

    def uninstall():
        for s, h in prev.items():
            try:
                _signal.signal(s, h)
            except (ValueError, OSError):
                pass

    return uninstall


# -- wait helpers (bench/chaos bring-up) -------------------------------------


def wait_http_ready(url: str, path: str = "/healthz",
                    timeout_s: float = 30.0,
                    poll_s: float = 0.05) -> Dict:
    """Poll ``url+path`` until it answers 200 (→ the parsed body) or
    the budget burns (``TimeoutError``) — the bench/chaos bring-up
    barrier for peer subprocesses."""
    deadline = time.monotonic() + timeout_s
    last: Optional[str] = None
    while time.monotonic() < deadline:
        try:
            status, _, body = http_json("GET", url, path, timeout=2.0)
            if status == 200:
                return body if isinstance(body, dict) else {}
            last = f"HTTP {status}"
        except OSError as e:
            last = str(e)
        time.sleep(poll_s)
    raise TimeoutError(f"{url}{path} not ready in {timeout_s}s ({last})")


def retry_after_from(headers: Dict[str, str], body: object) -> float:
    """The jittered back-off a 503 told us to honor: the JSON body's
    exact float when present, else the ``Retry-After`` header."""
    if isinstance(body, dict) and "retry_after_s" in body:
        return float(body["retry_after_s"])
    try:
        return float(headers.get("retry-after", 1.0))
    except ValueError:
        return 1.0


__all__ = [
    "ConnectionPool",
    "FrontDoorServer",
    "HEDGE_HEADER",
    "PeerServer",
    "REQUEST_ID_HEADER",
    "SPAN_HEADER",
    "TIER_HEADER",
    "TRACE_HEADER",
    "WIRE_CTYPE",
    "WIRE_HEADER",
    "WireError",
    "decode_product",
    "decode_product_wire",
    "encode_product",
    "encode_product_parts",
    "encode_product_wire",
    "http_json",
    "http_request",
    "install_drain_handler",
    "request_from_wire",
    "retry_after_from",
    "trace_context_from",
    "trace_headers",
    "wait_http_ready",
    "wants_binary_product",
    "wire_request",
]
