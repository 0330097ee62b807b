"""Site configuration with BL@GBT defaults.

Counterpart of the parts of ``blit/config.py`` that the port reads:
:class:`SiteConfig` with its data-tree fields (``root``, ``extra``, the
session / player / file regexes, ``hosts``, ``host_prefix``,
``backend``), the worker liveness deadlines, the retry and breaker knobs
with :meth:`SiteConfig.io_retry_policy` /
:meth:`SiteConfig.call_retry_policy`, and the four ``search_*`` knobs;
:data:`DEFAULT`, :func:`datahosts`, :func:`search_defaults` with the same
``BLIT_SEARCH_*`` overrides, and :func:`nfpc_from_foff`, which the
``.h5`` reader needs; the live plane's fields (``stream_*``,
``packet_*``, ``tune_dir``, ``monitor_*``, ``slo_*``, and the history
switches the publisher refuses) with :func:`stream_defaults`,
:func:`packet_defaults`, :func:`monitor_defaults`, :func:`slo_defaults`,
:func:`history_defaults` and :func:`default_window_frames`, under the
same ``BLIT_STREAM_*`` / ``BLIT_PACKET_*`` / ``BLIT_MONITOR_*`` /
``BLIT_SLO_*`` / ``BLIT_HISTORY_DIR`` / ``BLIT_INCIDENT_DIR`` overrides;
the mesh and recovery fields with :func:`mesh_defaults` and
:func:`recover_defaults`; and the serve plane's fields (``cache_*``,
``serve_*``, ``scrub_*``, ``fleet_*``, ``elastic_*``, ``request_log_*``,
``exemplars``, ``catalog_*``, ``backfill_bytes_per_s``) with
:func:`scrub_defaults`, :func:`fleet_defaults`, :func:`elastic_defaults`,
:func:`request_log_defaults`, :func:`catalog_defaults` and
:func:`archive_defaults`, under ``blit``'s ``BLIT_*`` overrides.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Pattern, Tuple

from blit_torch import naming


def datahosts(prefix: str = "") -> List[str]:
    """The 64 BL@GBT host names ``blc00``..``blc77`` (8 bands × 8 banks),
    optionally prefixed for ssh aliases."""
    return [f"{prefix}blc{band}{bank}" for band in range(8) for bank in range(8)]


# GBT BL backend constants: a band of 8 banks covers 1500 MHz, a bank
# 187.5 MHz in 64 coarse channels.
BAND_MHZ = 1500.0
BANK_MHZ = BAND_MHZ / 8
COARSE_PER_BANK = 64
COARSE_MHZ = BANK_MHZ / COARSE_PER_BANK

# Taylor-tree integration window: spectra per drift transform, a power of
# two (the drift resolution is one bin per window).
SEARCH_WINDOW_SPECTRA = 64
# Hits kept per band per window.
SEARCH_TOP_K = 8
# The device-side SNR cut.
SEARCH_SNR_THRESHOLD = 10.0
# Clamp on the searched drift range; None: the full ±(window-1) bins the
# tree computes.
SEARCH_MAX_DRIFT_BINS: Optional[int] = None


def nfpc_from_foff(foff_mhz: float) -> int:
    """Fine channels per coarse channel implied by a filterbank's channel
    width: ``round(COARSE_MHZ / |foff|)``."""
    return int(round(COARSE_MHZ / abs(foff_mhz)))


@dataclass
class SiteConfig:
    """Everything site-specific, with BL@GBT defaults (the fields of
    ``blit``'s ``SiteConfig`` that the port reads, same names and
    defaults)."""

    root: str = "/datax/dibas"
    extra: str = "GUPPI"
    session_re: Pattern = naming.SESSION_RE
    player_re: Pattern = naming.PLAYER_RE
    file_re: Pattern = naming.DEFAULT_FILE_RE
    # None derives the 64 default hosts from host_prefix.
    hosts: Optional[List[str]] = None
    host_prefix: str = ""
    # Worker-pool backend: "local" | "thread" | "process" | "remote".
    backend: str = "thread"
    # Remote-worker liveness: the per-call reply deadline (opt-in: a
    # whole-scan reduce_raw can run for hours, and a deadline that fires
    # on healthy work kills the agent mid-write; None blocks) and the
    # deadline of the ping that precedes reuse of an idle agent.
    call_timeout: Optional[float] = None
    ping_timeout: Optional[float] = 30.0
    # io_retries: total attempts of worker-side file reads; call_retries:
    # re-dispatches of a remote call after AgentDied / CallTimeout.
    # Jittered exponential backoff; retry_seed pins the jitter.
    io_retries: int = 3
    io_backoff_s: float = 0.05
    io_backoff_max_s: float = 2.0
    call_retries: int = 2
    call_backoff_s: float = 0.5
    call_backoff_max_s: float = 10.0
    retry_jitter: float = 0.5
    retry_seed: Optional[int] = None
    # Per-worker circuit breaker: breaker_threshold consecutive remote
    # failures mark the host degraded (calls fail fast); after
    # breaker_cooldown_s one probe call may close it again.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 60.0
    # The search plane's site defaults (see search_defaults).
    search_window_spectra: int = SEARCH_WINDOW_SPECTRA
    search_top_k: int = SEARCH_TOP_K
    search_snr_threshold: float = SEARCH_SNR_THRESHOLD
    search_max_drift_bins: Optional[int] = SEARCH_MAX_DRIFT_BINS
    # The live plane (see stream_defaults): the watermark's lateness
    # budget (a missing chunk is masked once the watermark passes it), the
    # tailer's poll cadence and idle timeout (None: wait for the done
    # marker forever) and the live feed's stall watchdog (None: unarmed).
    stream_lateness_s: float = 2.0
    stream_poll_s: float = 0.05
    stream_idle_timeout_s: Optional[float] = None
    stream_stall_timeout_s: Optional[float] = None
    # The packet front end (see packet_defaults): where a PacketSource
    # listens, its SO_RCVBUF, the framer's time samples per packet and
    # the assembler's reorder horizon in blocks.
    packet_host: str = "127.0.0.1"
    packet_port: int = 60000
    packet_rcvbuf_bytes: int = 32 << 20
    packet_ntime: int = 64
    packet_horizon_blocks: int = 2
    # Where per-rig tuning profiles live (None: BLIT_TUNE_DIR, else
    # ~/.cache/blit/tune).
    tune_dir: Optional[str] = None
    # The metrics publisher is off unless a spool dir or a port is set
    # (port 0 binds an ephemeral one); see monitor_defaults.
    monitor_interval_s: float = 1.0
    monitor_port: Optional[int] = None
    monitor_spool_dir: Optional[str] = None
    # Service-level objectives (None disables one) and the multi-window
    # burn-rate rule; see slo_defaults.
    slo_serve_wait_p99_s: Optional[float] = None
    slo_stream_latency_p99_s: Optional[float] = None
    slo_ingest_gbps_floor: Optional[float] = None
    slo_packet_assembly_p99_s: Optional[float] = None
    slo_budget: float = 0.01
    slo_fast_burn: float = 14.0
    slo_slow_burn: float = 2.0
    slo_fast_window: int = 5
    slo_slow_window: int = 30
    slo_objectives: Optional[List[Dict]] = None
    # blit's history store and incident bundles (not ported: a publisher
    # configured with either raises).
    history_dir: Optional[str] = None
    incident_dir: Optional[str] = None
    # The (band, bank) mesh (see mesh_defaults): mesh_shape is the
    # logical grid of a whole site; mesh_sharded makes the scan command
    # default to the threaded sharded plane (the mesh loop and the pool
    # stay selectable); mesh_probe_windows is how many leading windows
    # time the stitch alone (mesh.gather_s; 0: none); the depths size
    # the sharded plane's feed and readback (None: the ingest defaults).
    mesh_shape: Tuple[int, int] = (8, 8)
    mesh_sharded: bool = False
    mesh_probe_windows: int = 2
    mesh_prefetch_depth: Optional[int] = None
    mesh_out_depth: Optional[int] = None
    # The crash-recovery plane (see recover_defaults): a supervised
    # child whose lease goes stale for recover_lease_ttl_s is declared
    # hung; recover_poll_s is the watch cadence, recover_max_attempts
    # bounds abort -> re-plan -> resume, recover_grace_s is the bring-up
    # budget before a child's first beat (torch import, process group).
    recover_lease_ttl_s: float = 10.0
    recover_poll_s: float = 0.2
    recover_max_attempts: int = 3
    recover_grace_s: float = 120.0
    # The product service (blit_torch.serve): cache_ram_bytes bounds the
    # RAM tier of the content-addressed product cache; cache_dir, when
    # set, enables the disk tier and cache_cold_dir the cold tier behind
    # it.  serve_max_concurrency is the scheduler's concurrency budget,
    # serve_queue_depth bounds each priority's queue (excess asks are
    # refused with Overloaded).
    cache_ram_bytes: int = 1 << 30
    cache_dir: Optional[str] = None
    cache_cold_dir: Optional[str] = None
    serve_max_concurrency: int = 4
    serve_queue_depth: int = 64
    # The background scrubber (see scrub_defaults): off unless an
    # interval is set; it verifies one disk-tier entry per interval and
    # keeps verified bytes/s under scrub_bytes_per_s.
    scrub_interval_s: Optional[float] = None
    scrub_bytes_per_s: float = 64e6
    # The fleet (see fleet_defaults): owners per fingerprint on the ring,
    # virtual nodes per peer, the peers' lease TTL and the door's watch
    # and health cadences, the hedge floor until a peer has
    # fleet_hedge_min_n latency samples, the hit count that warms the
    # replicas, and the door -> peer wire ("binary" or "json"), its
    # per-peer keep-alive pool and optional whole-frame deflate.
    fleet_replicas: int = 2
    fleet_vnodes: int = 128
    fleet_peer_ttl_s: float = 3.0
    fleet_poll_s: float = 0.25
    fleet_health_poll_s: float = 1.0
    fleet_hedge_floor_s: float = 0.05
    fleet_hedge_min_n: int = 16
    fleet_hot_hits: int = 3
    fleet_wire: str = "binary"
    fleet_pool_conns: int = 4
    fleet_wire_deflate: bool = False
    # The elastic controller (see elastic_defaults): scale out on a page,
    # scale in after elastic_idle_windows ticks under elastic_idle_rps,
    # never below elastic_min_peers, no second resize within
    # elastic_hysteresis_s; the warm handoff and the drain are bounded.
    elastic_idle_rps: float = 0.1
    elastic_idle_windows: int = 6
    elastic_hysteresis_s: float = 60.0
    elastic_warm_timeout_s: float = 30.0
    elastic_warm_hints: int = 32
    elastic_min_peers: int = 1
    elastic_poll_s: float = 1.0
    elastic_drain_timeout_s: float = 30.0
    # Per-request access records (see request_log_defaults): off unless
    # a directory is set, size-rotated; exemplars keeps the newest trace
    # id of every histogram bucket.
    request_log_dir: Optional[str] = None
    request_log_max_bytes: int = 8 << 20
    request_log_files: int = 4
    exemplars: bool = True
    # The archive catalog (see catalog_defaults): on when catalog_root is
    # set; how often a lookup may rescan, and the negative-lookup cache.
    # backfill_bytes_per_s paces the backfill command (archive_defaults).
    catalog_root: Optional[str] = None
    catalog_rescan_s: float = 2.0
    catalog_negative_ttl_s: float = 30.0
    catalog_negative_max: int = 4096
    backfill_bytes_per_s: float = 256e6

    def io_retry_policy(self):
        """The :class:`blit_torch.faults.RetryPolicy` of worker-side file
        reads; install it with ``faults.set_io_policy(...)``."""
        from blit_torch import faults

        return faults.RetryPolicy(
            attempts=max(1, self.io_retries), base_s=self.io_backoff_s,
            max_s=self.io_backoff_max_s, jitter=self.retry_jitter,
            seed=self.retry_seed,
        )

    def call_retry_policy(self):
        """The :class:`blit_torch.faults.RetryPolicy` of a pool's remote
        re-dispatch (``attempts = call_retries + 1``)."""
        from blit_torch import faults

        return faults.RetryPolicy(
            attempts=max(0, self.call_retries) + 1,
            base_s=self.call_backoff_s, max_s=self.call_backoff_max_s,
            jitter=self.retry_jitter, seed=self.retry_seed,
        )

    def __post_init__(self):
        if self.hosts is None:
            self.hosts = datahosts(self.host_prefix)

    def with_(self, **kw) -> "SiteConfig":
        from dataclasses import replace

        if "host_prefix" in kw and "hosts" not in kw:
            kw["hosts"] = None  # re-derived from the new prefix
        return replace(self, **kw)


DEFAULT = SiteConfig()


def search_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The effective search knobs: ``config``'s values with the
    per-process overrides ``BLIT_SEARCH_WINDOW``, ``BLIT_SEARCH_TOP_K``,
    ``BLIT_SEARCH_SNR`` and ``BLIT_SEARCH_MAX_DRIFT`` applied.  Read when
    a reducer is built, not at import.  A negative drift limit means no
    limit: headers encode "unlimited" as -1, and reading that back must
    not turn into a mask that rejects every drift row."""
    max_drift = os.environ.get("BLIT_SEARCH_MAX_DRIFT")
    max_drift = int(max_drift) if max_drift else config.search_max_drift_bins
    if max_drift is not None and max_drift < 0:
        max_drift = None
    return {
        "window_spectra": int(os.environ.get(
            "BLIT_SEARCH_WINDOW", config.search_window_spectra)),
        "top_k": int(os.environ.get("BLIT_SEARCH_TOP_K", config.search_top_k)),
        "snr_threshold": float(os.environ.get(
            "BLIT_SEARCH_SNR", config.search_snr_threshold)),
        "max_drift_bins": max_drift,
    }


# Device-window budget in samples of the windowed reductions: 8 frames of
# the 0000 product, scaled to whole frames at other nfft.
WINDOW_SAMPLES = 8 << 20


def default_window_frames(nfft: int) -> int:
    """The default ``window_frames`` for ``nfft``: ~``WINDOW_SAMPLES``
    samples, at least 8 whole frames."""
    return max(8, WINDOW_SAMPLES // nfft)


def _opt_float(env: str, fallback: Optional[float]) -> Optional[float]:
    """An optional float knob from the environment: "", "none" and a
    negative value mean unset (the -1 encoding of the search knobs)."""
    v = os.environ.get(env)
    if v is None:
        return fallback
    if not v or v.lower() == "none":
        return None
    f = float(v)
    return None if f < 0 else f


def stream_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The live plane's knobs: ``config``'s values with the
    ``BLIT_STREAM_LATENESS`` / ``_POLL`` / ``_IDLE_TIMEOUT`` /
    ``_STALL_TIMEOUT`` overrides, read when a stream is built."""
    return {
        "lateness_s": float(os.environ.get(
            "BLIT_STREAM_LATENESS", config.stream_lateness_s)),
        "poll_s": float(os.environ.get(
            "BLIT_STREAM_POLL", config.stream_poll_s)),
        "idle_timeout_s": _opt_float(
            "BLIT_STREAM_IDLE_TIMEOUT", config.stream_idle_timeout_s),
        "stall_timeout_s": _opt_float(
            "BLIT_STREAM_STALL_TIMEOUT", config.stream_stall_timeout_s),
    }


def packet_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The packet front end's knobs: ``config``'s values with the
    ``BLIT_PACKET_HOST`` / ``_PORT`` / ``_RCVBUF`` / ``_NTIME`` /
    ``_HORIZON`` overrides."""
    return {
        "host": os.environ.get("BLIT_PACKET_HOST", config.packet_host),
        "port": int(os.environ.get("BLIT_PACKET_PORT", config.packet_port)),
        "rcvbuf_bytes": int(os.environ.get(
            "BLIT_PACKET_RCVBUF", config.packet_rcvbuf_bytes)),
        "ntime": int(os.environ.get("BLIT_PACKET_NTIME", config.packet_ntime)),
        "horizon_blocks": int(os.environ.get(
            "BLIT_PACKET_HORIZON", config.packet_horizon_blocks)),
    }


def monitor_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The publisher's knobs: ``config``'s values with the
    ``BLIT_MONITOR_INTERVAL`` / ``_PORT`` / ``_SPOOL`` / ``_SPANS``
    overrides.  ``enabled`` only when a spool dir or a port is set (a
    negative port, or an empty spool, means none)."""
    port_env = os.environ.get("BLIT_MONITOR_PORT")
    port = int(port_env) if port_env not in (None, "") else config.monitor_port
    if port is not None and port < 0:
        port = None
    spool = os.environ.get("BLIT_MONITOR_SPOOL")
    if spool is None:
        spool = config.monitor_spool_dir
    elif not spool:
        spool = None
    return {
        "interval_s": float(os.environ.get(
            "BLIT_MONITOR_INTERVAL", config.monitor_interval_s)),
        "port": port,
        "spool_dir": spool,
        "spans": os.environ.get("BLIT_MONITOR_SPANS", "").lower() not in (
            "", "0", "false", "off"),
        "enabled": port is not None or spool is not None,
    }


def slo_defaults(config: SiteConfig = DEFAULT) -> List[Dict]:
    """The objective list as plain dicts (``blit``'s four built-in ones,
    each enabled by its field or ``BLIT_SLO_SERVE_WAIT_P99`` /
    ``_STREAM_P99`` / ``_INGEST_GBPS_FLOOR`` / ``_PACKET_P99``, then
    ``config.slo_objectives``)."""
    objs: List[Dict] = []
    wait = _opt_float("BLIT_SLO_SERVE_WAIT_P99", config.slo_serve_wait_p99_s)
    if wait is not None:
        objs.append({"name": "serve-queue-wait", "kind": "latency",
                     "metric": "sched.wait_s", "threshold": wait,
                     "budget": config.slo_budget})
    lat = _opt_float("BLIT_SLO_STREAM_P99", config.slo_stream_latency_p99_s)
    if lat is not None:
        objs.append({"name": "stream-latency", "kind": "latency",
                     "metric": "stream.chunk_to_product_s",
                     "threshold": lat, "budget": config.slo_budget})
    floor = _opt_float("BLIT_SLO_INGEST_GBPS_FLOOR", config.slo_ingest_gbps_floor)
    if floor is not None:
        objs.append({"name": "ingest-throughput", "kind": "throughput",
                     "metric": "ingest", "threshold": floor,
                     "budget": config.slo_budget})
    asm = _opt_float("BLIT_SLO_PACKET_P99", config.slo_packet_assembly_p99_s)
    if asm is not None:
        objs.append({"name": "packet-assembly", "kind": "latency",
                     "metric": "packet.assembly_s", "threshold": asm,
                     "budget": config.slo_budget})
    objs.extend(config.slo_objectives or [])
    return objs


def history_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The switches of ``blit``'s history store and incident bundles:
    ``BLIT_HISTORY_DIR`` / ``BLIT_INCIDENT_DIR`` (an empty value unsets).
    ``enabled`` when a history dir is set."""

    def opt_dir(env: str, fallback: Optional[str]) -> Optional[str]:
        v = os.environ.get(env)
        return fallback if v is None else (v or None)

    d = opt_dir("BLIT_HISTORY_DIR", config.history_dir)
    return {
        "dir": d,
        "incident_dir": opt_dir("BLIT_INCIDENT_DIR", config.incident_dir),
        "enabled": d is not None,
    }


def _compile(p) -> Pattern:
    """Accept a str or a compiled pattern for every regex option."""
    return re.compile(p) if isinstance(p, str) else p


def mesh_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The sharded plane's knobs: ``config``'s values with the
    per-process overrides ``BLIT_MESH_SHARDED``, ``BLIT_MESH_PROBE``,
    ``BLIT_MESH_PREFETCH`` and ``BLIT_MESH_OUT_DEPTH`` applied (a
    negative depth means unset)."""

    def opt_int(env: str, fallback: Optional[int]) -> Optional[int]:
        v = os.environ.get(env)
        if v is None or v == "":
            return fallback
        i = int(v)
        return None if i < 0 else i

    sharded = os.environ.get("BLIT_MESH_SHARDED")
    return {
        "sharded": (
            config.mesh_sharded if sharded is None
            else sharded not in ("", "0", "false", "False")
        ),
        "probe_windows": int(os.environ.get(
            "BLIT_MESH_PROBE", config.mesh_probe_windows)),
        "prefetch_depth": opt_int(
            "BLIT_MESH_PREFETCH", config.mesh_prefetch_depth),
        "out_depth": opt_int(
            "BLIT_MESH_OUT_DEPTH", config.mesh_out_depth),
    }


def recover_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The recovery plane's knobs: ``config``'s values with the
    per-process overrides ``BLIT_RECOVER_LEASE_TTL``,
    ``BLIT_RECOVER_POLL``, ``BLIT_RECOVER_MAX_ATTEMPTS`` and
    ``BLIT_RECOVER_GRACE`` applied."""
    return {
        "lease_ttl_s": float(os.environ.get(
            "BLIT_RECOVER_LEASE_TTL", config.recover_lease_ttl_s)),
        "poll_s": float(os.environ.get(
            "BLIT_RECOVER_POLL", config.recover_poll_s)),
        "max_attempts": int(os.environ.get(
            "BLIT_RECOVER_MAX_ATTEMPTS", config.recover_max_attempts)),
        "grace_s": float(os.environ.get(
            "BLIT_RECOVER_GRACE", config.recover_grace_s)),
    }


def scrub_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The scrubber's knobs with ``BLIT_SCRUB_INTERVAL`` /
    ``BLIT_SCRUB_BYTES_PER_S`` applied.  An empty, ``none``, zero or
    negative interval disables it; ``enabled`` is derived."""
    v = os.environ.get("BLIT_SCRUB_INTERVAL")
    if v is None:
        interval = config.scrub_interval_s
    elif not v or v.lower() == "none" or float(v) <= 0:
        interval = None
    else:
        interval = float(v)
    return {
        "interval_s": interval,
        "bytes_per_s": float(os.environ.get(
            "BLIT_SCRUB_BYTES_PER_S", config.scrub_bytes_per_s)),
        "enabled": interval is not None,
    }


def fleet_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The fleet's knobs with the ``BLIT_FLEET_*`` overrides applied."""
    return {
        "replicas": int(os.environ.get(
            "BLIT_FLEET_REPLICAS", config.fleet_replicas)),
        "vnodes": int(os.environ.get(
            "BLIT_FLEET_VNODES", config.fleet_vnodes)),
        "peer_ttl_s": float(os.environ.get(
            "BLIT_FLEET_PEER_TTL", config.fleet_peer_ttl_s)),
        "poll_s": float(os.environ.get(
            "BLIT_FLEET_POLL", config.fleet_poll_s)),
        "health_poll_s": float(os.environ.get(
            "BLIT_FLEET_HEALTH_POLL", config.fleet_health_poll_s)),
        "hedge_floor_s": float(os.environ.get(
            "BLIT_FLEET_HEDGE_FLOOR", config.fleet_hedge_floor_s)),
        "hedge_min_n": int(os.environ.get(
            "BLIT_FLEET_HEDGE_MIN_N", config.fleet_hedge_min_n)),
        "hot_hits": int(os.environ.get(
            "BLIT_FLEET_HOT_HITS", config.fleet_hot_hits)),
        "wire": str(os.environ.get(
            "BLIT_FLEET_WIRE", config.fleet_wire)).strip().lower(),
        "pool_conns": int(os.environ.get(
            "BLIT_FLEET_POOL_CONNS", config.fleet_pool_conns)),
        "wire_deflate": str(os.environ.get(
            "BLIT_FLEET_WIRE_DEFLATE",
            config.fleet_wire_deflate)) not in (
                "0", "false", "False"),
    }


def elastic_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The elastic controller's knobs with the ``BLIT_ELASTIC_*``
    overrides applied."""
    return {
        "idle_rps": float(os.environ.get(
            "BLIT_ELASTIC_IDLE_RPS", config.elastic_idle_rps)),
        "idle_windows": int(os.environ.get(
            "BLIT_ELASTIC_IDLE_WINDOWS", config.elastic_idle_windows)),
        "hysteresis_s": float(os.environ.get(
            "BLIT_ELASTIC_HYSTERESIS", config.elastic_hysteresis_s)),
        "warm_timeout_s": float(os.environ.get(
            "BLIT_ELASTIC_WARM_TIMEOUT", config.elastic_warm_timeout_s)),
        "warm_hints": int(os.environ.get(
            "BLIT_ELASTIC_WARM_HINTS", config.elastic_warm_hints)),
        "min_peers": int(os.environ.get(
            "BLIT_ELASTIC_MIN_PEERS", config.elastic_min_peers)),
        "poll_s": float(os.environ.get(
            "BLIT_ELASTIC_POLL", config.elastic_poll_s)),
        "drain_timeout_s": float(os.environ.get(
            "BLIT_ELASTIC_DRAIN_TIMEOUT",
            config.elastic_drain_timeout_s)),
    }


def request_log_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The access-record knobs with ``BLIT_REQUEST_LOG`` /
    ``BLIT_REQUEST_LOG_MAX_BYTES`` / ``BLIT_REQUEST_LOG_FILES`` /
    ``BLIT_EXEMPLARS`` applied; ``dir`` is None when logging is off."""
    d = os.environ.get("BLIT_REQUEST_LOG")
    if d is None:
        d = config.request_log_dir
    elif not d:
        d = None
    ex = os.environ.get("BLIT_EXEMPLARS")
    return {
        "dir": d,
        "max_bytes": int(os.environ.get(
            "BLIT_REQUEST_LOG_MAX_BYTES", config.request_log_max_bytes)),
        "files": int(os.environ.get(
            "BLIT_REQUEST_LOG_FILES", config.request_log_files)),
        "exemplars": (config.exemplars if ex is None
                      else ex.lower() not in ("", "0", "false", "off")),
    }


def catalog_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The catalog's knobs with the ``BLIT_CATALOG_*`` overrides
    applied; ``enabled`` is derived from the root."""
    root = os.environ.get("BLIT_CATALOG_ROOT")
    if root is None:
        root = config.catalog_root
    elif not root:
        root = None
    return {
        "root": root,
        "rescan_s": float(os.environ.get(
            "BLIT_CATALOG_RESCAN", config.catalog_rescan_s)),
        "negative_ttl_s": float(os.environ.get(
            "BLIT_CATALOG_NEG_TTL", config.catalog_negative_ttl_s)),
        "negative_max": int(os.environ.get(
            "BLIT_CATALOG_NEG_MAX", config.catalog_negative_max)),
        "enabled": root is not None,
    }


def archive_defaults(config: SiteConfig = DEFAULT) -> Dict:
    """The cold tier's root and the backfill's pacing, with
    ``BLIT_CACHE_COLD_DIR`` / ``BLIT_BACKFILL_BYTES_PER_S`` applied (a
    budget of 0 or less: unpaced, None)."""
    cold = os.environ.get("BLIT_CACHE_COLD_DIR")
    if cold is None:
        cold = config.cache_cold_dir
    elif not cold:
        cold = None
    v = os.environ.get("BLIT_BACKFILL_BYTES_PER_S")
    bps = float(v) if v else config.backfill_bytes_per_s
    if bps is not None and bps <= 0:
        bps = None
    return {"cold_dir": cold, "backfill_bytes_per_s": bps}
