"""Ingest tuning profiles and the online tuner.

Counterpart of ``blit/tune.py``, with the same fingerprint recipe,
profile file format, sweep and heuristics, so a profile written by one
package loads in the other when their rig identities are equal:

- :func:`tune`: deterministic coordinate descent over the ingest knobs
  (``chunk_frames`` / ``prefetch_depth`` / ``out_depth``) against any
  measure function (``python -m blit_torch tune`` times real
  reductions).
- :class:`TuningProfile`: the persisted winner, content-addressed by
  :func:`rig_fingerprint` (sha256 over the canonical JSON of the rig
  identity and the workload's knob surface).  A reducer whose knobs are
  left unset consults :func:`lookup` when it is built (``BLIT_TUNE=0``
  disables); a profile for another rig or shape hashes to another key,
  and a tampered file (its identity no longer hashing to its key) or
  out-of-range knobs are ignored.
- :class:`OnlineTuner`: after a warm-up of dispatched chunks, derives a
  recommendation from the reducer's Timeline
  (:func:`recommend_from_stages`), publishes ``tune.rec_*`` gauges, and
  persists it as an ``online`` profile when ``BLIT_TUNE_ONLINE=1``.

The rig identity is built from the device the reducer runs on, where
``blit`` asks ``jax.default_backend()`` / ``jax.devices()``: the host,
``backend`` ``"cuda"`` or ``"cpu"``, ``device_kind``
(``torch.cuda.get_device_name``), and on CUDA the compute
``capability`` and the device count.  A CPU reducer's identity touches
no CUDA API, so a lookup on the CPU never initializes CUDA.  Profiles
live under ``BLIT_TUNE_DIR`` (else ``SiteConfig.tune_dir``, else
``~/.cache/blit/tune``), one JSON file per fingerprint (``asdict`` of
the profile), written through a temporary and a rename.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("blit_torch.tune")

KNOBS = ("chunk_frames", "prefetch_depth", "out_depth")

# Knob bounds: depths below 2 serialize the planes; depths above 8 pin
# more chunk buffers than they hide latency for (each held chunk is host
# RSS and — on the output side — device HBM).
MIN_DEPTH, MAX_DEPTH = 2, 8
MAX_CHUNK_FRAMES = 1 << 12

PROFILE_VERSION = 1


# -- rig fingerprint ------------------------------------------------------

def _rig_identity(device=None) -> Dict:
    """Host + device identity: what makes a tuning result non-portable.
    ``device`` is the reducer's (a ``torch.device`` or a string; None:
    the CUDA device).  Never raises."""
    from blit_torch import observability

    ident = {"host": observability.hostname()}
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            major, minor = torch.cuda.get_device_capability(index)
            ident["backend"] = "cuda"
            ident["device_kind"] = torch.cuda.get_device_name(index)
            ident["capability"] = f"{major}.{minor}"
            ident["device_count"] = torch.cuda.device_count()
        else:
            ident["backend"] = dev.type
            ident["device_kind"] = dev.type
            ident["device_count"] = 1
    except Exception:  # noqa: BLE001 — the fingerprint must never raise
        ident["backend"] = "unknown"
        ident["device_kind"] = "unknown"
        ident["device_count"] = 0
    return ident


def rig_fingerprint(*, nfft: int, nint: int, ntap: int = 4,
                    stokes: str = "I", window: str = "hamming",
                    fqav_by: int = 1, dtype: str = "float32",
                    fft_method: str = "auto", nbits: int = 32,
                    workload: str = "reduce",
                    device=None) -> Tuple[str, Dict]:
    """``(key, identity)`` of one (rig, workload shape) pair: sha256 of
    the canonical JSON of the rig identity on ``device`` plus the knobs
    that shape per-chunk cost (not the recording: tuning transfers
    across same-shaped inputs)."""
    ident = _rig_identity(device)
    ident.update(
        workload=workload, nfft=int(nfft), ntap=int(ntap), nint=int(nint),
        stokes=stokes, window=window, fqav_by=int(fqav_by), dtype=dtype,
        fft_method=fft_method, nbits=int(nbits),
    )
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest(), ident


# -- profile store --------------------------------------------------------

@dataclass
class TuningProfile:
    """One rig's converged ingest knobs, with provenance: the fingerprint
    identity it was measured under, the score that won, and the stage
    quantiles behind it (so a bench report can embed *why* these knobs,
    not just *which*)."""

    key: str
    rig: Dict
    chunk_frames: int
    prefetch_depth: int
    out_depth: int
    score_gbps: float = 0.0
    trials: int = 0
    stages: Dict = field(default_factory=dict)
    source: str = "offline"  # "offline" (the tune command) | "online"
    created_s: float = 0.0
    version: int = PROFILE_VERSION
    # Channel count of the recording the profile was MEASURED on.  NOT
    # part of the fingerprint key (lookup happens before any recording
    # is open, and tuning transfers across same-shaped workloads) — but
    # per-chunk staging and stage cost scale linearly with it, so the
    # reducer warns when a loaded profile was measured on a
    # different-width recording.  0 = unknown (legacy profile).
    tuned_nchan: int = 0

    def knobs(self) -> Dict[str, int]:
        return {
            "chunk_frames": int(self.chunk_frames),
            "prefetch_depth": int(self.prefetch_depth),
            "out_depth": int(self.out_depth),
        }

    def provenance(self) -> Dict:
        """The compact provenance block bench/ingest-bench embed."""
        return {
            "key": self.key,
            "source": self.source,
            "score_gbps": self.score_gbps,
            "trials": self.trials,
            "created_s": self.created_s,
            "tuned_nchan": self.tuned_nchan,
            **self.knobs(),
        }


def enabled() -> bool:
    """Auto-load kill switch: ``BLIT_TUNE=0`` makes every reducer fall
    back to the built-in defaults (drills, A/B runs, tests)."""
    return os.environ.get("BLIT_TUNE", "1") != "0"


def profile_dir(config=None) -> str:
    env = os.environ.get("BLIT_TUNE_DIR")
    if env:
        return env
    if config is None:
        # Site default: every production caller (reducer lookup, online
        # persist, CLI) passes config=None, so SiteConfig.tune_dir must
        # apply here — the hostmem staging_pool_bytes rule.
        from blit_torch.config import DEFAULT as config
    cfg_dir = getattr(config, "tune_dir", None)
    if cfg_dir:
        return cfg_dir
    return os.path.join(os.path.expanduser("~"), ".cache", "blit", "tune")


def _profile_path(key: str, config=None) -> str:
    return os.path.join(profile_dir(config), f"tune-{key[:24]}.json")


def save_profile(profile: TuningProfile, config=None) -> str:
    """Persist atomically; returns the path.  The file embeds the full
    fingerprint identity so :func:`load_profile` can verify the content
    still hashes to the key it is stored under."""
    path = _profile_path(profile.key, config)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not profile.created_s:
        profile.created_s = time.time()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(asdict(profile), f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_profile(key: str, config=None) -> Optional[TuningProfile]:
    """The profile stored under ``key`` — or None when absent, corrupt,
    from a different profile version, or STALE (its embedded identity no
    longer hashes to ``key``: a copied-over profile from another rig, a
    hand-edited file, or a changed fingerprint recipe all land here and
    are ignored rather than trusted)."""
    path = _profile_path(key, config)
    try:
        with open(path) as f:
            doc = json.load(f)
        prof = TuningProfile(**doc)
    except (OSError, ValueError, TypeError):
        return None
    if prof.version != PROFILE_VERSION or prof.key != key:
        return None
    blob = json.dumps(prof.rig, sort_keys=True).encode()
    if hashlib.sha256(blob).hexdigest() != key:
        log.warning("tuning profile %s is stale (identity mismatch); "
                    "ignoring", path)
        return None
    # Knob sanity is part of "corrupt is ignored, not trusted": the
    # integrity hash covers only the rig identity, so non-numeric or
    # out-of-range knob values (hand edits, partial writes) must land
    # here — bounded to the sweep's own ladder limits, never a crash.
    try:
        knobs = prof.knobs()
        prof.tuned_nchan = int(prof.tuned_nchan or 0)
    except (TypeError, ValueError):
        log.warning("tuning profile %s has non-numeric knobs; ignoring",
                    path)
        return None
    if not (0 < knobs["chunk_frames"] <= MAX_CHUNK_FRAMES
            and MIN_DEPTH <= knobs["prefetch_depth"] <= MAX_DEPTH
            and MIN_DEPTH <= knobs["out_depth"] <= MAX_DEPTH):
        log.warning("tuning profile %s has out-of-range knobs %s; "
                    "ignoring", path, knobs)
        return None
    return prof


def lookup(config=None, **fingerprint_kw) -> Optional[TuningProfile]:
    """The active profile for this rig + workload shape, or None.  Cheap
    when no profile exists (one stat); disabled by ``BLIT_TUNE=0``."""
    if not enabled():
        return None
    key, _ = rig_fingerprint(**fingerprint_kw)
    return load_profile(key, config)


# -- offline sweep --------------------------------------------------------

def _cf_bound(nint: int, max_chunk_frames: Optional[int] = None) -> int:
    """The effective chunk_frames ceiling: the caller's recording bound
    capped by the global ladder limit, floored to an nint multiple
    (chunk_frames must fold evenly) but never below nint itself."""
    b = min(MAX_CHUNK_FRAMES,
            max_chunk_frames if max_chunk_frames else MAX_CHUNK_FRAMES)
    return max(nint, (b // nint) * nint)


def normalize_base(base: Optional[Dict[str, int]] = None, *, nint: int = 1,
                   max_chunk_frames: Optional[int] = None) -> Dict[str, int]:
    """The exact starting knob set :func:`tune` will measure first —
    defaults filled, chunk_frames rounded UP to an nint multiple the way
    ``RawReducer.__post_init__`` executes it (so the sweep measures the
    knob value that actually runs), then clamped into the same bounds
    ``load_profile`` enforces plus the caller's recording bound.
    Callers that warm up untimed at the base (the tune command) must warm
    at THIS value, or a clamped base pays its jit compile inside the
    first timed trial and the reported baseline understates."""
    bound = _cf_bound(nint, max_chunk_frames)
    cur = {"chunk_frames": max(nint, 8), "prefetch_depth": 2, "out_depth": 2}
    if base:
        cur.update({k: int(v) for k, v in base.items() if k in KNOBS})
    cf = -(-max(nint, cur["chunk_frames"]) // nint) * nint
    cur["chunk_frames"] = min(bound, cf)
    for k in ("prefetch_depth", "out_depth"):
        cur[k] = max(MIN_DEPTH, min(MAX_DEPTH, cur[k]))
    return cur


def _ladder(knob: str, value: int, nint: int,
            max_chunk_frames: int = MAX_CHUNK_FRAMES) -> List[int]:
    """Deterministic candidate neighborhood around ``value`` (the
    coordinate-descent move set).  chunk_frames moves multiplicatively —
    its effect (dispatch amortization vs HBM/latency) is log-scaled —
    while the depths move by single steps inside [MIN_DEPTH, MAX_DEPTH]."""
    if knob == "chunk_frames":
        vals = {max(nint, (value // 2 // nint) * nint), value,
                min(max_chunk_frames, value * 2)}
        return sorted(v for v in vals if nint <= v <= max_chunk_frames)
    vals = {max(MIN_DEPTH, value - 1), value, min(MAX_DEPTH, value + 1)}
    return sorted(vals)


def tune(measure: Callable[[Dict[str, int]], float], *,
         base: Optional[Dict[str, int]] = None, nint: int = 1,
         max_trials: int = 24, max_passes: int = 6,
         rel_tol: float = 0.01,
         max_chunk_frames: Optional[int] = None,
         ) -> Tuple[Dict[str, int], List[Dict]]:
    """Coordinate descent over the ingest knobs against ``measure``
    (knobs → score, higher is better; GB/s in production, a simulated
    cost model in tests).

    Deterministic: candidates are a fixed ladder around the current
    value, evaluations are memoized (a knob setting is measured at most
    once), a move must win by ``rel_tol`` relative margin (ties keep the
    SMALLER knob value — cheaper in host/device memory), and passes
    repeat until a full pass moves nothing or ``max_trials``
    measurements were spent.  Returns ``(best_knobs, trials)`` with
    ``trials`` the evaluation log in measurement order.

    ``max_chunk_frames`` bounds the chunk_frames ladder below the global
    MAX_CHUNK_FRAMES — callers measuring against a finite recording pass
    total_frames//2 so every candidate still fills ≥2 full chunks
    (a chunk spanning most of the file scores a degenerate
    near-zero-overhead measurement that would otherwise always win).
    """
    cf_bound = _cf_bound(nint, max_chunk_frames)
    # Normalize into the same bounds load_profile enforces (plus the
    # caller's recording bound) — otherwise a base above the cap can
    # WIN, persist, and be silently rejected by every later lookup.
    cur = normalize_base(base, nint=nint, max_chunk_frames=max_chunk_frames)
    memo: Dict[Tuple, float] = {}
    trials: List[Dict] = []

    def score(knobs: Dict[str, int]) -> Optional[float]:
        key = tuple(knobs[k] for k in KNOBS)
        if key in memo:
            return memo[key]
        if len(memo) >= max_trials:
            return None
        s = float(measure(dict(knobs)))
        memo[key] = s
        trials.append({**knobs, "score": s})
        return s

    best = score(cur)
    if best is None:
        raise ValueError("max_trials=0 leaves nothing to tune")
    for _ in range(max_passes):
        moved = False
        for knob in KNOBS:
            for cand in _ladder(knob, cur[knob], nint,
                                max_chunk_frames=cf_bound):
                if cand == cur[knob]:
                    continue
                trial = dict(cur, **{knob: cand})
                s = score(trial)
                if s is None:
                    return cur, trials  # budget spent
                if s > best * (1.0 + rel_tol):
                    # Strictly better by the margin.
                    cur, best = trial, s
                    moved = True
                elif s >= best * (1.0 - rel_tol) and cand < cur[knob]:
                    # A tie within the margin prefers the SMALLER knob
                    # (cheaper in host/device memory).  ``best`` keeps
                    # the highest score seen at the current point so
                    # repeated tie-moves cannot ratchet the bar down by
                    # rel_tol per pass; tie-moves alone also do not
                    # extend the pass loop (``moved`` stays False), so a
                    # flat surface terminates.
                    cur = trial
                    best = max(best, s)
        if not moved:
            break
    return cur, trials


# -- online convergence ---------------------------------------------------

@dataclass
class Recommendation:
    knobs: Dict[str, int]
    reasons: List[str]


def recommend_from_stages(stages: Dict[str, Dict], hists: Dict[str, Dict],
                          current: Dict[str, int], *,
                          nint: int = 1) -> Recommendation:
    """Derive the next knob set from observed per-stage costs — the pure
    decision core behind :class:`OnlineTuner` (tested against a
    simulated cost model; no device needed).

    Every heuristic reads only what is POPULATED mid-stream: the
    ``dispatch`` stage (consumer-side enqueue, per chunk), the
    ``device`` stage (the readback thread's lag-synchronized waits —
    blit_torch/outplane.py records it per chunk), the ``ingest`` stage (the
    producer's file reads) and the ``out.*`` histograms.  The ``stream``
    wall stage is deliberately NOT used — its context is still open
    when the online tuner fires, so its seconds read zero until the
    stream ends.

    Heuristics, in the order a saturating ingest plane develops them:

    - **Dispatch-bound** (per-chunk fixed overhead — the consumer-side
      ``dispatch`` stage plus the producer's chunk framing — is a big
      fraction of per-chunk device work): double ``chunk_frames`` to
      amortize it.
    - **Readback-lagged** (``out.readback_lag_s`` median well above the
      per-chunk service latency median: dispatches PERSISTENTLY queue
      faster than the readback thread drains — medians, because over a
      handful of warmup samples p99 is just the max and one compile-
      sized outlier would fire it on every cold run): deepen
      ``out_depth``.
    - **Producer-bound** (per-chunk file-read seconds exceed the
      per-chunk hidden work — device wait + dispatch — so the consumer
      regularly waits on the producer): deepen ``prefetch_depth`` so
      more read-ahead runs before it is needed.
    """

    def sec(name: str) -> float:
        return float(stages.get(name, {}).get("seconds",
                                              stages.get(name, {}).get("s", 0.0)))

    def calls(name: str) -> int:
        return int(stages.get(name, {}).get("calls", 0))

    rec = dict(current)
    reasons: List[str] = []
    # Chunks observed so far: the dispatch stage ticks once per chunk on
    # the async path; fall back to device calls for sync-shaped tables.
    nchunks = max(1, calls("dispatch") or calls("device"))
    per_disp = sec("dispatch") / nchunks
    per_dev = sec("device") / max(1, calls("device"))
    if per_dev > 0 and per_disp / per_dev > 0.25:
        rec["chunk_frames"] = min(
            MAX_CHUNK_FRAMES,
            max(nint, (current["chunk_frames"] * 2 // nint) * nint),
        )
        reasons.append(
            f"dispatch-bound: {per_disp:.2e}s fixed per chunk vs "
            f"{per_dev:.2e}s device — amortize with bigger chunks"
        )
    lag = hists.get("out.readback_lag_s", {})
    latency = hists.get("out.chunk_latency_s", {})
    # Median vs median, NOT p99: with only ~warmup samples p99 is the
    # max, and chunk 1's compile-sized lag sample (recorded by the
    # readback thread, racing the snapshot above) would trip it on
    # every cold run.  A rig that needs a deeper ring lags PERSISTENTLY
    # — the median shows it; one warmup outlier doesn't.
    if (lag.get("n", 0) and latency.get("n", 0)
            and lag.get("p50", 0.0) > 2.0 * max(latency.get("p50", 0.0),
                                                1e-9)):
        rec["out_depth"] = min(MAX_DEPTH, current["out_depth"] + 1)
        reasons.append(
            f"readback-lagged: lag p50 {lag['p50']:.2e}s vs service p50 "
            f"{latency.get('p50', 0.0):.2e}s — deepen the readback ring"
        )
    per_ing = sec("ingest") / nchunks
    per_hidden = per_dev + per_disp
    if per_ing > 0 and per_ing > per_hidden:
        rec["prefetch_depth"] = min(MAX_DEPTH, current["prefetch_depth"] + 1)
        reasons.append(
            f"producer-bound: {per_ing:.2e}s file read per chunk vs "
            f"{per_hidden:.2e}s hidden work — deepen read-ahead"
        )
    return Recommendation(knobs=rec, reasons=reasons)


class OnlineTuner:
    """Converge a recommendation during the first windows of a streaming
    reduction (class docstring in the module header).

    The reducer calls :meth:`observe_chunk` once per dispatched chunk;
    after ``warmup_chunks`` the tuner reads the timeline ONCE, derives
    the recommendation, publishes ``tune.rec_*`` gauges, and goes
    dormant (zero further per-chunk cost).  :meth:`maybe_persist` at
    stream end writes the recommendation as an ``online`` profile when
    ``BLIT_TUNE_ONLINE=1`` and the recommendation actually moved a knob.
    """

    def __init__(self, timeline, current: Dict[str, int], *, nint: int = 1,
                 warmup_chunks: int = 8):
        self._tl = timeline
        self._current = dict(current)
        self._nint = nint
        self.warmup_chunks = max(2, warmup_chunks)
        self._seen = 0
        self._snap = None
        self._hist_snap: Dict[str, Dict] = {}
        self.recommendation: Optional[Recommendation] = None

    @property
    def converged(self) -> bool:
        return self.recommendation is not None

    def observe_chunk(self) -> None:
        if self.recommendation is not None:
            return
        self._seen += 1
        if self._snap is None:
            # Chunk 1's dispatch stage carries the first-call costs (kernel
            # builds and loads, allocations).  Folding
            # it into per-chunk cost makes EVERY cold run look
            # dispatch-bound — and with BLIT_TUNE_ONLINE=1 the persisted
            # chunk_frames would ratchet x2 per run (each new shape
            # recompiles, re-tripping the heuristic).  Snapshot after
            # the first chunk and recommend from the post-warmup DELTA.
            self._snap = self._tl.snapshot()
            self._hist_snap = {k: h.state()
                               for k, h in list(self._tl.hists.items())}
            return
        if self._seen < self.warmup_chunks:
            return
        stages = self._tl.since(self._snap)
        # Hists delta the same way (HistogramStats.since): chunk 2's
        # out.readback_lag_s sample is compile-sized too (the readback
        # thread blocked behind chunk 1's compile) — read cumulatively
        # it would fire the readback-lagged heuristic on every cold run.
        hists = {k: h.since(self._hist_snap.get(k, {})).report()
                 for k, h in list(self._tl.hists.items())}
        self.recommendation = recommend_from_stages(
            stages, hists, self._current, nint=self._nint
        )
        for k in KNOBS:
            self._tl.gauge(f"tune.rec_{k}",
                           float(self.recommendation.knobs[k]))

    def maybe_persist(self, *, config=None, tuned_nchan: int = 0,
                      **fingerprint_kw) -> Optional[str]:
        """Persist the converged recommendation as an ``online`` profile
        (opt-in: ``BLIT_TUNE_ONLINE=1``); returns the path when written."""
        if self.recommendation is None:
            return None
        if os.environ.get("BLIT_TUNE_ONLINE", "0") != "1":
            return None
        if self.recommendation.knobs == self._current:
            return None  # nothing learned worth persisting
        key, ident = rig_fingerprint(**fingerprint_kw)
        existing = load_profile(key, config)
        if existing is not None and existing.source == "offline":
            # The tune command MEASURED those knobs (timed sweep, score_gbps);
            # the online recommendation is a heuristic off one warmup
            # window — possibly a transient load spike.  A measured
            # profile outranks it: never overwrite, or every rig running
            # BLIT_TUNE_ONLINE=1 would silently lose its sweep results.
            log.info("online tuning recommendation %s not persisted: a "
                     "measured offline profile holds key %s",
                     self.recommendation.knobs, key[:24])
            return None
        # Clamp into the exact bounds load_profile enforces (the
        # offline sweep clamps its base the same way): unmoved knobs
        # are copied verbatim from the running reducer, which permits
        # e.g. prefetch_depth=1 — persisting that verbatim would write
        # a profile every subsequent lookup rejects as out-of-range.
        rec = {k: int(self.recommendation.knobs[k]) for k in KNOBS}
        rec["chunk_frames"] = max(self._nint,
                                  min(MAX_CHUNK_FRAMES, rec["chunk_frames"]))
        for k in ("prefetch_depth", "out_depth"):
            rec[k] = max(MIN_DEPTH, min(MAX_DEPTH, rec[k]))
        prof = TuningProfile(
            key=key, rig=ident, source="online",
            trials=self._seen, tuned_nchan=int(tuned_nchan), **rec,
        )
        try:
            return save_profile(prof, config)
        except OSError:  # a read-only rig must not fail the reduction
            log.warning("online tuning profile not writable", exc_info=True)
            return None
