"""Command line: ``python -m blit_torch <command>``.

Counterpart of ``python -m blit``: all 22 of its commands, each with
``blit``'s flags and its JSON line (or text) on stdout:

  reduce       GUPPI RAW (a file, a ``.NNNN.raw`` stem or a member list)
               to a filterbank product (``.fil``; ``.h5`` = FBH5).
  search       GUPPI RAW to a ``.hits`` drift-search product.
  stream       Live reduction: follow a RAW file the recorder is still
               appending to (or replay a completed one with
               ``--replay-rate``) and write the product during the
               session, with p50/p99 chunk-to-product latency.
  session      Run (or rejoin) a whole live session from a spec file: one
               supervised stream consumer a recorder seat.
  scan         A whole (session, scan) of a data tree → one product a band
               (or, with ``--search``, a ``.hits`` a player) over the
               ``(band, bank)`` mesh; ``--trace-logdir`` writes a
               ``torch.profiler`` trace.
  inventory    Crawl a data tree and print its records as JSON lines.
  info         Print the normalized header of a ``.fil`` / ``.h5`` /
               ``.raw`` file.
  ingest-bench File → product throughput probe of the asynchronous output
               plane on a synthetic recording: the per-stage table, the
               overlap gauge, ``--sync-compare`` (products identical, the
               speedup), the search, live, drill and recovery legs, and
               the spans / history overhead A/Bs.
  tune         Sweep the ingest knobs with timed reductions on this rig and
               save the winner as its tuning profile (``BLIT_TUNE_DIR``).
  serve-bench  A zipfian request replay through a ``ProductService``, or
               (``--fleet``, ``--diurnal``, ``--archive-day``) through a
               front door over real ``fleet-peer`` processes.
  fleet-peer   One serving peer of the fleet: a ``ProductService`` behind
               the HTTP wire, beating a heartbeat lease; SIGTERM drains it.
  chaos        A seeded fault against a supervised scan or live consumer
               (kill, hang, reorder), the integrity drill (corrupt), or a
               serving fleet (``--fleet``: kill, hang, partition, resize);
               exit 0 only when it recovered with identical bytes.
  fsck         Verify a tree's product manifests and serve-cache entries,
               quarantine what fails (exit 1), ``--repair`` re-derives.
  backfill     Derive and publish every product of an archive tree into a
               hot (and cold) cache, resumable through a ledger.
  telemetry    A fleet telemetry report: this process, a saved report
               (``--from``) or a worker pool's harvest (``--demo``), as
               text, Prometheus exposition or JSON; ``--trace-out``
               writes the spans as a Chrome trace, ``--watch`` refreshes.
  top          The live terminal dashboard over a monitor spool or a
               publisher's ``/snapshot`` (``--history``: sparklines).
  bench-diff   The regression gate: a fresh bench record against a
               baseline trajectory's noise band (exit 2 on a regression).
  trace-view   Render a flight-recorder dump, or stitch span batches of
               many processes into one trace (``--fleet``).
  requests     Tail, filter and aggregate a per-request access-record
               spool.
  incidents    List the incident bundles under the incident dir.
  incident     ``incident show BUNDLE``: one bundle's merged timeline.
  slo-report   Attainment and error-budget spend an objective over day /
               week windows, from a history store.

One flag is the port's own: ``--device`` (default ``cuda``) on the
commands that compute; ``--device cpu`` runs the plain PyTorch path.
With the default and no GPU the command raises.  ``search``'s
``--kernel`` / ``--interpret`` are accepted for ``blit``'s command lines
and change nothing: the port's paths agree bitwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

_PRODUCTS = ("0000", "0001", "0002")


def _cmd_reduce(args: argparse.Namespace) -> int:
    from blit_torch.pipeline import RawReducer, reducer_for_product

    kw = dict(stokes=args.stokes, fqav_by=args.fqav, dtype=args.dtype,
              device=args.device)
    if args.product is not None:
        red = reducer_for_product(args.product, **kw)
    else:
        red = RawReducer(nfft=args.nfft, nint=args.nint, **kw)
    src: object = args.raw[0] if len(args.raw) == 1 else args.raw
    if args.resume:
        hdr = red.reduce_resumable(src, args.output,
                                   compression=args.compression)
    else:
        hdr = red.reduce_to_file(src, args.output,
                                 compression=args.compression)
    stats = red.stats
    print(json.dumps({
        "output": args.output,
        "nsamps": hdr.get("nsamps"),
        "nchans": hdr.get("nchans"),
        "nifs": hdr.get("nifs"),
        "input_bytes": stats.input_bytes,
        "gbps": round(stats.gbps, 3),
    }))
    return 0


def _cmd_search(args: argparse.Namespace) -> int:
    from blit_torch.pipeline import PRODUCT_PRESETS
    from blit_torch.search import DedopplerReducer

    nfft, nint = ((args.nfft, args.nint) if args.product is None
                  else PRODUCT_PRESETS[args.product])
    red = DedopplerReducer(
        nfft=nfft, nint=nint, dtype=args.dtype,
        window_spectra=args.window_spectra, top_k=args.top_k,
        snr_threshold=args.snr, max_drift_bins=args.max_drift_bins,
        device=args.device,
    )
    src: object = args.raw[0] if len(args.raw) == 1 else args.raw
    if args.resume:
        hdr = red.search_resumable(src, args.output)
    else:
        hdr = red.search_to_file(src, args.output)
    print(json.dumps({
        "output": args.output,
        "windows": hdr.get("search_windows"),
        "hits": hdr.get("search_nhits"),
        "nchans": hdr.get("nchans"),
        "window_spectra": hdr.get("search_window_spectra"),
        "snr_threshold": hdr.get("search_snr_threshold"),
        "top_k": hdr.get("search_top_k"),
        "hists": red.timeline.report().get("hists", {}),
    }))
    return 0


def _monitor_from_flags(args: argparse.Namespace):
    """Start and install the process-wide publisher from the
    ``--monitor-*`` flags (None when neither a spool nor a port is
    given); the caller shuts it down."""
    if args.monitor_spool is None and args.monitor_port is None:
        return None
    from blit_torch import monitor

    pub = monitor.install_publisher(monitor.MetricsPublisher(
        interval_s=args.monitor_interval, spool_dir=args.monitor_spool,
        port=args.monitor_port).start())
    if pub.port is not None:
        print(f"# monitor: {pub.url}/metrics", file=sys.stderr)
    return pub


def _cmd_stream(args: argparse.Namespace) -> int:
    from blit_torch.observability import Timeline
    from blit_torch.pipeline import PRODUCT_PRESETS
    from blit_torch.stream import FileTailSource, ReplaySource

    pub = _monitor_from_flags(args)
    if args.replay_rate is not None:
        src = ReplaySource(args.raw, rate=args.replay_rate)
    else:
        src = FileTailSource(args.raw, poll_s=args.poll,
                             idle_timeout_s=args.idle_timeout,
                             done_path=args.done_file)
    nfft, nint = ((args.nfft, args.nint) if args.product is None
                  else PRODUCT_PRESETS[args.product])
    tl = Timeline()
    if args.search:
        from blit_torch.stream import stream_search

        hdr = stream_search(
            src, args.output, lateness_s=args.lateness, nfft=nfft,
            nint=nint, dtype=args.dtype, timeline=tl,
            window_spectra=args.window_spectra, snr_threshold=args.snr,
            top_k=args.top_k, resume=args.resume, device=args.device,
        )
        body = {"hits": hdr.get("search_nhits"),
                "windows": hdr.get("search_windows")}
    else:
        from blit_torch.stream import stream_reduce

        hdr = stream_reduce(
            src, args.output, lateness_s=args.lateness, nfft=nfft,
            nint=nint, stokes=args.stokes, fqav_by=args.fqav,
            dtype=args.dtype, compression=args.compression, timeline=tl,
            resume=args.resume, device=args.device,
        )
        body = {"nsamps": hdr.get("nsamps"), "nchans": hdr.get("nchans")}
    lat = tl.report().get("hists", {}).get("stream.chunk_to_product_s", {})
    out = {
        "output": args.output,
        **body,
        "stream_chunks": hdr.get("stream_chunks"),
        "late_chunks": hdr.get("stream_late_chunks"),
        "dup_chunks": hdr.get("stream_dup_chunks"),
        "masked_chunks": hdr.get("stream_masked_chunks"),
        "degraded_spectra": hdr.get("stream_degraded_spectra",
                                    hdr.get("stream_degraded_windows")),
        "chunk_to_product_p50_s": lat.get("p50"),
        "chunk_to_product_p99_s": lat.get("p99"),
    }
    if hdr.get("_masked_chunks"):
        out["masked_chunk_seqs"] = hdr["_masked_chunks"]
    if hdr.get("stream_flight_dump"):
        out["flight_dump"] = hdr["stream_flight_dump"]
    if pub is not None:
        pub.tick()
        out["monitor"] = {"port": pub.port, "spool": pub.spool_path,
                          "samples": pub.seq}
        from blit_torch import monitor

        monitor.shutdown_publisher()
    print(json.dumps(out))
    return 0


def _cmd_inventory(args: argparse.Namespace) -> int:
    from blit_torch.inventory import get_inventory, raw_sequences

    records = get_inventory(args.file_re, root=args.root,
                            session_re=args.session_re, extra=args.extra)
    if args.sequences:
        for rec, paths in raw_sequences(records):
            print(json.dumps({"stem_of": rec._asdict(), "files": paths}))
        return 0
    for rec in records:
        print(json.dumps(rec._asdict()))
    return 0


def _cmd_info(args: argparse.Namespace) -> int:
    import os

    from blit_torch.io.guppi import open_raw, scan_files

    path = args.file
    if path.endswith(".raw") or (not os.path.exists(path)
                                 and bool(scan_files(path))):
        raw = open_raw(path)
        hdr = dict(raw.header(0))
        hdr["_nblocks"] = raw.nblocks
        hdr["_files"] = getattr(raw, "paths", [raw.path])
        hdr["_time_span_s"] = raw.time_span_s()
    else:
        from blit_torch.workers import get_header

        hdr = get_header(path)
    print(json.dumps(hdr, indent=2, default=str))
    return 0


def _cmd_tune(args: argparse.Namespace) -> int:
    """Coordinate descent over ``chunk_frames`` / ``prefetch_depth`` /
    ``out_depth`` with timed file-to-product reductions on this rig's
    ``--device``, saved as the profile that later reducers on the same
    device and workload shape load."""
    import os
    import tempfile
    import time

    from blit_torch import tune as T
    from blit_torch.outplane import INGEST_HISTS
    from blit_torch.pipeline import RawReducer
    from blit_torch.testing import synth_raw

    def build(knobs: dict) -> RawReducer:
        return RawReducer(
            nfft=args.nfft, nint=args.nint, fqav_by=args.fqav,
            dtype=args.dtype, nbits=args.nbits,
            chunk_frames=knobs["chunk_frames"],
            prefetch_depth=knobs["prefetch_depth"],
            out_depth=knobs["out_depth"], tune_online=False,
            device=args.device)

    with tempfile.TemporaryDirectory(prefix="blit-tune-") as td:
        if args.raw:
            from blit_torch.io.guppi import open_raw

            raw_path = args.raw
            file_bytes = os.path.getsize(raw_path)
            rdr = open_raw(raw_path)
            tuned_nchan = int(rdr.header(0)["OBSNCHAN"])
            total_samps = sum(rdr.block_ntime_kept(i)
                              for i in range(rdr.nblocks))
            rdr.close()
        else:
            raw_path = os.path.join(td, "tune.raw")
            ntime = (args.chunks * args.chunk_frames + 3) * args.nfft
            _, blocks = synth_raw(raw_path, nblocks=args.blocks,
                                  obsnchan=args.nchan,
                                  ntime_per_block=-(-ntime // args.blocks))
            file_bytes = sum(b.nbytes for b in blocks)
            tuned_nchan = args.nchan
            total_samps = sum(b.shape[1] for b in blocks)
        # Every candidate keeps at least 2 full chunks in the recording.
        max_cf = max(args.nint, total_samps // args.nfft // 2)
        base = T.normalize_base({"chunk_frames": args.chunk_frames},
                                nint=args.nint, max_chunk_frames=max_cf)
        # Untimed warm run at the first knob set measured (kernel builds,
        # page faults, pinned staging).
        build(base).reduce_to_file(raw_path, os.path.join(td, "warm.fil"))
        seq = [0]

        def measure(knobs: dict) -> float:
            best = 0.0
            for _ in range(max(1, args.reps)):
                red = build(knobs)
                out = os.path.join(td, f"t{seq[0]}.fil")
                seq[0] += 1
                t0 = time.perf_counter()
                red.reduce_to_file(raw_path, out)
                best = max(best, file_bytes / (time.perf_counter() - t0) / 1e9)
                os.unlink(out)
            return best

        best, trials = T.tune(measure, base=base, nint=args.nint,
                              max_trials=args.trials,
                              max_chunk_frames=max_cf)
        # A confirmation run at the winner gives the stage tails the
        # profile keeps as its provenance.
        winner = build(best)
        t0 = time.perf_counter()
        winner.reduce_to_file(raw_path, os.path.join(td, "winner.fil"))
        score = file_bytes / (time.perf_counter() - t0) / 1e9
        key, ident = T.rig_fingerprint(**winner._tune_fingerprint_kw())
        prof = T.TuningProfile(
            key=key, rig=ident, source="offline", tuned_nchan=tuned_nchan,
            score_gbps=round(score, 4), trials=len(trials),
            stages=winner.timeline.hist_quantiles(INGEST_HISTS),
            **{k: int(best[k]) for k in T.KNOBS},
        )
        path = T.save_profile(prof)
        base_score = trials[0]["score"] if trials else None
        print(json.dumps({
            "profile": path,
            "key": key,
            "winner": prof.knobs(),
            "score_gbps": prof.score_gbps,
            "baseline_gbps": (round(base_score, 4)
                              if base_score is not None else None),
            "trials": trials,
        }))
    return 0


def _cmd_scan(args: argparse.Namespace) -> int:
    from blit_torch.config import default_window_frames, mesh_defaults
    from blit_torch.inventory import get_inventory
    from blit_torch.observability import Timeline, profile_trace
    from blit_torch.parallel.scan import (
        reduce_scan_mesh_to_files,
        reduce_scan_pool_to_files,
    )

    mdef = mesh_defaults()
    # --sharded: the threaded sharded plane; --pool: the pool path (the
    # oracle); neither: SiteConfig / BLIT_MESH_SHARDED picks between the
    # sharded plane and the mesh loop.
    sharded = args.sharded or (mdef["sharded"] and not args.pool)
    invs = [get_inventory(args.file_re or r"\.raw$", root=args.root)]
    tuning = {"source": "explicit"}
    depths = {"prefetch_depth": mdef["prefetch_depth"],
              "out_depth": mdef["out_depth"]}
    if args.window_frames is None:
        # An unset window consults this rig's tuning profile through a
        # probe reducer, the key recipe reduce and stream use.
        from blit_torch.pipeline import RawReducer

        probe = RawReducer(nfft=args.nfft, nint=args.nint, stokes=args.stokes,
                           fqav_by=args.fqav, dtype=args.dtype,
                           device=args.device)
        prov = probe.tuning_provenance()
        for knob in ("prefetch_depth", "out_depth"):
            if depths[knob] is None and prov["sources"][knob] == "profile":
                depths[knob] = getattr(probe, knob)
        if prov["sources"]["chunk_frames"] == "profile":
            wf = probe.chunk_frames
            pprov = prov["profile"]
            pprov["profile_source"] = pprov.pop("source")
            tuning = {"source": "profile", **pprov}
        else:
            wf = default_window_frames(args.nfft)
            tuning = {"source": "default"}
    else:
        wf = args.window_frames
    wf = max((wf // args.nint) * args.nint, args.nint)
    tl = Timeline()
    parallel = "sharded" if sharded else ("pool" if args.pool else "mesh")
    if args.search:
        if args.resume:
            raise SystemExit("--resume is not supported with scan --search; "
                             "re-run fresh, or use `search --resume` per player")
        if args.stokes != "I":
            raise SystemExit("--stokes is not supported with --search "
                             "(drift search runs on Stokes I)")
        if args.fqav != 1:
            raise SystemExit("--fqav is not supported with --search (the drift "
                             "transform needs full-resolution fine channels)")
        if args.compression is not None:
            raise SystemExit("--compression applies to .h5 filterbank "
                             "products, not .hits")
        from blit_torch.search import DedopplerReducer

        probe = DedopplerReducer(nfft=args.nfft, nint=args.nint,
                                 dtype=args.dtype,
                                 window_spectra=args.window_spectra,
                                 device=args.device)
        unit = probe.window_spectra * args.nint
        wf = max((wf // unit) * unit, unit)
        if args.pool:
            if args.max_frames is not None:
                raise SystemExit("--max-frames is not supported with --pool "
                                 "--search (the per-player reducers search "
                                 "whole recordings)")
            with profile_trace(args.trace_logdir, args.device):
                written = _pool_scan_search(args, invs, wf, tl)
        else:
            from blit_torch.parallel.sharded import search_scan_sharded_to_files

            parallel = "sharded"
            written = search_scan_sharded_to_files(
                args.session, args.scan, inventories=invs,
                out_dir=args.output_dir, nfft=args.nfft, nint=args.nint,
                dtype=args.dtype, window_spectra=args.window_spectra,
                top_k=args.top_k, snr_threshold=args.snr,
                max_drift_bins=args.max_drift_bins, window_frames=wf,
                max_frames=args.max_frames, timeline=tl, device=args.device,
                trace_logdir=args.trace_logdir, **depths)
        for player, (path, hdr) in sorted(written.items()):
            print(json.dumps({"player": list(player), "output": path,
                              "windows": hdr.get("search_windows"),
                              "nchans": hdr.get("nchans")}))
        print(json.dumps({"window_frames": wf, "parallel": parallel,
                          "tuning": tuning, "stages": tl.report()}))
        return 0
    kw = dict(inventories=invs, out_dir=args.output_dir, nfft=args.nfft,
              nint=args.nint, stokes=args.stokes, fqav_by=args.fqav,
              despike=not args.no_despike, window_frames=wf,
              max_frames=args.max_frames, compression=args.compression,
              dtype=args.dtype, timeline=tl, device=args.device)
    if args.pool:
        if args.resume:
            raise SystemExit("--resume applies to the mesh and sharded paths; "
                             "the pool path re-runs whole reductions")
        with profile_trace(args.trace_logdir, args.device):
            written = reduce_scan_pool_to_files(args.session, args.scan, **kw)
    elif sharded:
        from blit_torch.parallel.sharded import reduce_scan_sharded_to_files

        written = reduce_scan_sharded_to_files(
            args.session, args.scan, resume=args.resume,
            trace_logdir=args.trace_logdir, **depths, **kw)
    else:
        written = reduce_scan_mesh_to_files(
            args.session, args.scan, resume=args.resume,
            trace_logdir=args.trace_logdir, **kw)
    for band, (path, hdr) in sorted(written.items()):
        print(json.dumps({"band": band, "output": path,
                          "nsamps": hdr.get("nsamps"),
                          "nchans": hdr.get("nchans"), "fch1": hdr.get("fch1"),
                          "foff": hdr.get("foff")}))
    print(json.dumps({"window_frames": wf, "parallel": parallel,
                      "tuning": tuning, "stages": tl.report()}))
    return 0


def _pool_scan_search(args: argparse.Namespace, invs, wf: int, tl) -> dict:
    """The pool path of a whole-scan search: one
    :class:`~blit_torch.search.DedopplerReducer` a player at the sharded
    search's dispatch shapes (``chunk_frames = window_frames``), its
    byte-identity oracle where the players share a whole-window span."""
    import os

    from blit_torch.inventory import scan_grid
    from blit_torch.search import DedopplerReducer

    band_ids, _, grid = scan_grid(invs, args.session, args.scan)
    written = {}
    for b, row in enumerate(grid):
        for k, rp in enumerate(row):
            red = DedopplerReducer(
                nfft=args.nfft, nint=args.nint, dtype=args.dtype,
                window_spectra=args.window_spectra, top_k=args.top_k,
                snr_threshold=args.snr, max_drift_bins=args.max_drift_bins,
                chunk_frames=wf, timeline=tl, device=args.device)
            out = os.path.join(args.output_dir, f"band{band_ids[b]}bank{k}.hits")
            written[(band_ids[b], k)] = (out, red.search_to_file(rp, out))
    return written


def _cmd_session(args: argparse.Namespace) -> int:
    """Run (or rejoin) a live session from a JSON spec::

        {"seats": [{"name": "blc00", "out": "...", "raw": "...",
                    "source": {"kind": "replay", "raw": "...", "rate": 1.0},
                    "knobs": {"nfft": 1024}}, ...],
         "work_dir": "...", "lease_ttl_s": 5.0}

    (:class:`blit_torch.stream.SessionSupervisor`).  Re-running the same
    spec after a crash rejoins every seat mid-product.  Prints the
    session report; exit 0 when every seat completed."""
    import tempfile

    from blit_torch.observability import Timeline
    from blit_torch.stream import SessionSupervisor

    with open(args.spec) as f:
        spec = json.load(f)
    tl = Timeline()
    pub = _monitor_from_flags(args)
    work = (args.work_dir or spec.get("work_dir")
            or tempfile.mkdtemp(prefix="blit-session-"))
    sup = SessionSupervisor(
        spec["seats"], work_dir=work,
        lease_ttl_s=(args.lease_ttl if args.lease_ttl is not None
                     else spec.get("lease_ttl_s")),
        poll_s=args.poll if args.poll is not None else spec.get("poll_s"),
        max_attempts=(args.attempts if args.attempts is not None
                      else spec.get("max_attempts")),
        faults=spec.get("faults"), timeline=tl, device=args.device)
    rep = sup.run()
    rep["work_dir"] = work
    if pub is not None:
        pub.tick()
        rep["monitor"] = {"port": pub.port, "spool": pub.spool_path}
        from blit_torch import monitor

        monitor.shutdown_publisher()
    body = json.dumps(rep)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    return 0 if rep["ok"] else 1


def _chaos_run(sup) -> dict:
    """Run a supervisor for the drill; an exhausted recovery budget is a
    failed report, not a traceback."""
    try:
        return sup.run()
    except RuntimeError as e:
        return {"recovered": False, "error": str(e), "attempts": [],
                "attempts_tried": sup.state().get("attempt", 0) + 1}


def _cmd_chaos(args: argparse.Namespace) -> int:
    """A seeded kill/hang schedule against a supervised workload: a
    multi-process sharded scan (``--workload scan`` / ``scan-search``)
    or a live consumer (``stream``).  The failure must be detected within
    the lease budget, the scan re-planned (a smaller pod or the pool
    path) or the consumer rejoined, and the products byte-identical to
    an uninterrupted oracle.  Prints the drill report; exit 0 when it
    recovered with identical bytes."""
    import filecmp
    import os
    import tempfile

    from blit_torch.observability import Timeline
    from blit_torch.recover import RECOVER_HISTS, ScanSupervisor, StreamSupervisor
    from blit_torch.testing import synth_raw

    tl = Timeline()
    work = args.work_dir or tempfile.mkdtemp(prefix="blit-chaos-")
    os.makedirs(work, exist_ok=True)
    if args.fleet:
        if args.fault == "corrupt":
            print("chaos --fleet supports kill/hang/partition/resize, "
                  "not corrupt", file=sys.stderr)
            return 2
        report = {"workload": "fleet", "fault": args.fault,
                  "device": args.device}
        if args.fault == "resize":
            return _chaos_fleet_resize(args, work, report)
        return _chaos_fleet(args, work, report)
    if args.fault == "partition":
        print("--fault partition requires --fleet (a network partition "
              "is a serving-fleet failure shape)", file=sys.stderr)
        return 2
    if args.fault == "resize":
        print("--fault resize requires --fleet (an elastic membership "
              "flip is a serving-fleet failure shape)", file=sys.stderr)
        return 2
    if args.fault == "reorder" and args.workload != "stream":
        print("--fault reorder requires --workload stream (wire reordering "
              "is a packet front-end failure shape)", file=sys.stderr)
        return 2
    use_packets = args.workload == "stream" and (
        args.packets or args.fault == "reorder")
    point = args.point or ("packet.recv" if args.fault == "reorder"
                           else "stream.chunk" if args.workload == "stream"
                           else "mesh.window")
    if args.fault == "corrupt":
        # The integrity drill is its own shape: no supervisor, no crash —
        # a corrupted delivered frame must be detected and masked,
        # whatever the workload flag says.
        report = {"workload": "reduce",
                  "fault": f"guppi.read:corrupt:after={args.after}",
                  "device": args.device}
        return _chaos_corrupt(args, work, report)
    fault = (f"{point}:{args.fault}:after={args.after}"
             + (f":hang={args.hang_s}" if args.fault == "hang" else ""))
    report = {"workload": args.workload, "fault": fault, "procs": args.procs,
              "device": args.device}
    if args.workload == "stream":
        from blit_torch.pipeline import RawReducer

        raw = os.path.join(work, "chaos.raw")
        nblocks = max(4, args.chunks)
        ntime = (args.chunks * args.window_frames + 3) * args.nfft
        hdr0, blocks = synth_raw(raw, nblocks=nblocks, obsnchan=args.nchan,
                                 ntime_per_block=-(-ntime // nblocks),
                                 seed=args.seed)
        out = os.path.join(work, "chaos.fil")
        oracle = os.path.join(work, "oracle.fil")
        source = None
        oracle_raw = raw
        if use_packets:
            # --packets drops one whole block off the wire: the oracle is
            # the recording with that block zero-filled.
            source = {"kind": "packet-replay", "raw": raw,
                      "rate": args.replay_rate,
                      "packet_ntime": args.packet_ntime, "seed": args.seed}
            if args.packets:
                from blit_torch.io.guppi import write_raw

                source.update(drop_blocks=[1], reorder=0.15, dup=0.05)
                report["gapped_blocks"] = [1]
                zb = [b.copy() for b in blocks]
                zb[1][:] = 0
                oracle_raw = os.path.join(work, "chaos_zeroed.raw")
                write_raw(oracle_raw, hdr0, zb)
        RawReducer(nfft=args.nfft, nint=args.nint,
                   chunk_frames=args.window_frames, tune_online=False,
                   device=args.device).reduce_to_file(oracle_raw, oracle)
        sup = StreamSupervisor(
            raw, out, kind="reduce",
            knobs=dict(nfft=args.nfft, nint=args.nint,
                       chunk_frames=args.window_frames, tune_online=False),
            replay_rate=args.replay_rate, source=source, faults=fault,
            lease_ttl_s=args.lease_ttl, poll_s=args.poll,
            max_attempts=args.attempts, timeline=tl, device=args.device)
        rep = _chaos_run(sup)
        products = [(out, oracle)]
    else:
        kind = "search" if args.workload == "scan-search" else "reduce"
        grid = []
        bank_bw = -187.5 / args.nbank
        for b in range(args.nband):
            row = []
            for k in range(args.nbank):
                p = os.path.join(work, f"blc{b}{k}.raw")
                synth_raw(p, nblocks=2, obsnchan=args.nchan,
                          ntime_per_block=-(-(args.chunks * args.window_frames
                                              + 3) * args.nfft // 2),
                          seed=args.seed + b * 8 + k, tone_chan=k % args.nchan,
                          obsbw=bank_bw,
                          obsfreq=8000.0 + b * 500.0 + (k + 0.5) * bank_bw)
                row.append(p)
            grid.append(row)
        out_dir = os.path.join(work, "products")
        oracle_dir = os.path.join(work, "oracle")
        os.makedirs(oracle_dir, exist_ok=True)
        search_kw = dict(window_spectra=args.window_spectra, top_k=4,
                         snr_threshold=2.0, max_drift_bins=None)
        sup = ScanSupervisor(
            grid, out_dir=out_dir, kind=kind, nfft=args.nfft, nint=args.nint,
            despike=False, window_frames=args.window_frames,
            search=search_kw if kind == "search" else None, nprocs=args.procs,
            devices_per_proc=(args.devices_per_proc if args.devices_per_proc
                              else (args.nband * args.nbank) // args.procs),
            lease_ttl_s=args.lease_ttl, poll_s=args.poll,
            max_attempts=args.attempts, faults={args.victim: fault},
            timeline=tl, device=args.device)
        rep = _chaos_run(sup)
        wf = sup.wf
        if kind == "search":
            from blit_torch.search import DedopplerReducer

            products = []
            for b in range(args.nband):
                for k in range(args.nbank):
                    op = os.path.join(oracle_dir, f"band{b}bank{k}.hits")
                    DedopplerReducer(nfft=args.nfft, nint=args.nint,
                                     chunk_frames=wf, device=args.device,
                                     **search_kw).search_to_file(grid[b][k], op)
                    products.append(
                        (os.path.join(out_dir, f"band{b}bank{k}.hits"), op))
        else:
            from blit_torch.parallel.scan import reduce_scan_pool_to_files

            written = reduce_scan_pool_to_files(
                grid, out_dir=oracle_dir, nfft=args.nfft, nint=args.nint,
                despike=False, window_frames=wf, device=args.device)
            products = [(os.path.join(out_dir, os.path.basename(path)), path)
                        for _, (path, _) in sorted(written.items())]
    identical = True
    diffs = []
    for got, want in products:
        try:
            same = filecmp.cmp(got, want, shallow=False)
        except OSError:
            same = False
        if not same:
            identical = False
            diffs.append(got)
    hists = tl.report().get("hists", {})
    report.update(
        recovered=rep.get("recovered", False), error=rep.get("error"),
        byte_identical=identical, differing_products=diffs,
        attempts=rep.get("attempts"), result=rep.get("result"),
        recover={h: hists.get(h, {}) for h in RECOVER_HISTS},
        windows_recomputed=sum(a.get("windows_recomputed", 0)
                               for a in (rep.get("attempts") or [])),
        work_dir=work)
    body = json.dumps(report)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    # kill and hang demand a recovery; reorder is absorbed in place.
    crashy = args.fault in ("kill", "hang")
    ok = identical and (report["recovered"] if crashy else not rep.get("error"))
    return 0 if ok else 1


def _cmd_fleet_peer(args: argparse.Namespace) -> int:
    """``fleet-peer``: one serving peer of the fleet — a ProductService
    on ``--device`` (the card by default) behind the HTTP wire (``/product``, ``/warm``,
    ``/stats``, ``/healthz``, ``/metrics``, ``/drain``), beating a
    heartbeat lease the front door watches.  SIGTERM/SIGINT drain
    gracefully: refuse new work, finish in-flight (releasing live
    capacity holds), then exit.  ``--port 0`` binds an ephemeral port,
    published via ``--port-file`` (atomic write) for the spawner."""
    import os
    import threading

    from blit_torch.config import DEFAULT
    from blit_torch.observability import Timeline
    from blit_torch.serve import ProductCache, ProductService, Scheduler
    from blit_torch.serve.http import PeerServer, install_drain_handler

    tl = Timeline()
    # Archive plane: --catalog-root arms the peer's catalog
    # (kind="catalog" asks + local session=/scan= resolution);
    # --cold-dir/--disk-bytes arm the tiered store behind the hot disk
    # cache.  Flags override the env/config defaults.
    config = DEFAULT
    if args.catalog_root:
        config = config.with_(catalog_root=args.catalog_root)
    if args.cold_dir:
        config = config.with_(cache_cold_dir=args.cold_dir)
    from blit_torch.config import archive_defaults

    service = ProductService(
        cache=ProductCache(args.cache_dir, ram_bytes=args.ram_bytes,
                           disk_bytes=args.disk_bytes,
                           cold_dir=archive_defaults(config)["cold_dir"],
                           timeline=tl),
        scheduler=Scheduler(max_concurrency=args.concurrency,
                            queue_depth=args.queue_depth, timeline=tl,
                            retry_seed=args.retry_seed),
        timeline=tl,
        config=config,
        device=args.device,
    )
    server = PeerServer(service, name=args.name, port=args.port,
                        host=args.host,
                        lease_dir=args.lease_dir, proc=args.proc,
                        beat_interval_s=args.beat_interval).start()
    stop = threading.Event()

    def _drain():
        server.drain(timeout=args.drain_timeout)
        stop.set()

    uninstall = install_drain_handler(_drain, exit_after=False)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)
    # --standby: the peer itself serves identically — it is
    # the FRONT DOOR that keeps a standby out of the ring until the
    # elastic controller admits it.  The flag rides the bring-up line
    # so spawners and operators see the role the process was given.
    print(json.dumps({"name": args.name, "url": server.url,
                      "pid": os.getpid(), "lease_dir": args.lease_dir,
                      "proc": args.proc,
                      "standby": bool(args.standby)}), flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        service.drain(timeout=args.drain_timeout)
    uninstall()
    server.close()
    service.close()
    return 0


def _cmd_fsck(args: argparse.Namespace) -> int:
    """``fsck``: verify an archive tree's manifests and cache-entry
    content digests, quarantine what fails, optionally repair (the
    re-derivations run on ``--device``).  Exit 0 = clean tree; 1 = corruption found (the report
    names every artifact, and everything bad is already quarantined
    unless ``--no-quarantine``)."""
    from blit_torch import integrity

    rep = integrity.fsck(args.root, repair=args.repair,
                         quarantine=not args.no_quarantine,
                         device=args.device)
    cold = getattr(args, "cold_dir", None)
    if cold:
        # The cold tier shares the hot tier's sidecar
        # convention, so the SAME walk verifies/quarantines/repairs it
        # — one merged report, one exit verdict.
        crep = integrity.fsck(cold, repair=args.repair,
                              quarantine=not args.no_quarantine,
                              device=args.device)
        rep = {
            "root": rep["root"], "cold_root": crep["root"],
            "checked": rep["checked"] + crep["checked"],
            "ok": rep["ok"] + crep["ok"],
            "unmanifested": (rep["unmanifested"]
                             + crep["unmanifested"]),
            "in_progress": rep["in_progress"] + crep["in_progress"],
            "bad": rep["bad"] + crep["bad"],
            "quarantined": rep["quarantined"] + crep["quarantined"],
            "repaired": rep["repaired"] + crep["repaired"],
            "repair_failed": (rep["repair_failed"]
                              + crep["repair_failed"]),
            "clean": rep["clean"] and crep["clean"],
        }
    body = json.dumps(rep)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    return 0 if rep["clean"] else 1


def _cmd_backfill(args: argparse.Namespace) -> int:
    """``backfill``: walk an archive root
    through the catalog crawl, derive + publish EVERY (session, scan,
    player) product into a hot(+cold) cache — the fleet then serves the
    archive day from warm tiers instead of recompute storms.

    Resumable by construction: a product's completion is recorded in an
    append-only fsync-per-line LEDGER only AFTER its cache publish
    lands, so a kill mid-derive leaves no entry and the product simply
    re-derives on resume, while completed products are never re-derived
    (the acceptance kill-drill).  Products are content-addressed, so an
    interrupted+resumed backfill finishes byte-identical to an
    uninterrupted one.

    Paced like the Scrubber: after each product the walker sleeps
    off the debt ``max(0, input_bytes / bytes_per_s - elapsed)`` so a
    backfill sharing a host with foreground serving never starves it."""
    import os
    import time as _time

    from blit_torch.config import DEFAULT, archive_defaults
    from blit_torch.observability import Timeline
    from blit_torch.serve.cache import ProductCache
    from blit_torch.serve.catalog import CatalogIndex
    from blit_torch.serve.service import ProductRequest

    config = DEFAULT
    if args.cold_dir:
        config = config.with_(cache_cold_dir=args.cold_dir)
    if args.bytes_per_s is not None:
        config = config.with_(backfill_bytes_per_s=args.bytes_per_s
                              if args.bytes_per_s > 0 else None)
    bps = archive_defaults(config)["backfill_bytes_per_s"]
    tl = Timeline()
    cache = ProductCache(args.cache_dir, ram_bytes=args.ram_bytes,
                         disk_bytes=args.disk_bytes,
                         cold_dir=archive_defaults(config)["cold_dir"],
                         timeline=tl)
    catalog = CatalogIndex(args.root, config=config, rescan_s=0.0,
                           timeline=tl)
    catalog.refresh(force=True)
    ledger_path = args.ledger or os.path.join(args.cache_dir,
                                              "backfill.ledger.jsonl")
    done: set = set()
    if os.path.exists(ledger_path):
        with open(ledger_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    done.add(json.loads(line)["fp"])
                except (ValueError, KeyError):
                    # A torn tail line (the crash wrote half a record):
                    # treat as not-completed — the product re-derives.
                    continue
    os.makedirs(os.path.dirname(os.path.abspath(ledger_path)),
                exist_ok=True)
    ledger = open(ledger_path, "a")
    if ledger.tell() > 0:
        with open(ledger_path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            torn_tail = f.read(1) != b"\n"
        if torn_tail:
            # Terminate the crash's half-record so the claims appended
            # below never concatenate onto it (both would be lost on
            # the NEXT resume).
            ledger.write("\n")
            ledger.flush()

    def _claim(fp: str, session: str, scan: str, player: str) -> None:
        """fsync-before-claim: the ledger line is durable BEFORE the
        product counts as completed — a crash can lose work, never
        fake it."""
        ledger.write(json.dumps({"fp": fp, "session": session,
                                 "scan": scan, "player": player,
                                 "t": round(_time.time(), 3)}) + "\n")
        ledger.flush()
        os.fsync(ledger.fileno())
        done.add(fp)

    report = {"backfill": True, "root": os.path.abspath(args.root),
              "cache_dir": args.cache_dir,
              "cold_dir": archive_defaults(config)["cold_dir"],
              "ledger": ledger_path, "bytes_per_s": bps,
              "products_total": 0, "derived": 0, "skipped_ledger": 0,
              "skipped_cached": 0, "errors": []}
    t_start = _time.perf_counter()
    bytes_read = 0
    debt_s = 0.0
    stop = False
    try:
        with catalog._lock:
            sessions = {s: dict(e["scans"])
                        for s, e in catalog._sessions.items()}
        for session in sorted(sessions):
            if stop:
                break
            for scan in sorted(sessions[session]):
                if stop:
                    break
                seqs = sessions[session][scan]["sequences"]
                for (band, bank), members in sorted(seqs.items()):
                    if args.limit and report["products_total"] >= args.limit:
                        stop = True
                        break
                    report["products_total"] += 1
                    player = f"BLP{band}{bank}"
                    req = (ProductRequest(raw=tuple(members),
                                          product=args.product)
                           if args.product else
                           ProductRequest(raw=tuple(members),
                                          nfft=args.nfft,
                                          nint=args.nint))
                    fp = req.fingerprint()
                    if fp in done:
                        report["skipped_ledger"] += 1
                        continue
                    if cache.contains(fp):
                        # Published but the claim never landed (killed
                        # in the publish→claim window) — or a foreground
                        # serve beat us to it.  Completed either way.
                        _claim(fp, session, scan, player)
                        report["skipped_cached"] += 1
                        continue
                    t0 = _time.perf_counter()
                    nbytes = sum(os.path.getsize(m) for m in members)
                    try:
                        header, data = req.reducer(args.device).reduce(
                            req.raw_source)
                        cache.put(fp, header, data, recipe=req.recipe())
                        cache.note_derive()
                    except Exception as e:  # noqa: BLE001 — reported
                        report["errors"].append(
                            f"{session}/{scan}/{player}: {e!r}")
                        continue
                    _claim(fp, session, scan, player)
                    report["derived"] += 1
                    bytes_read += nbytes
                    # The Scrubber debt discipline: pay for the bytes
                    # just read before touching the next product.
                    if bps:
                        dt = _time.perf_counter() - t0
                        debt_s = max(0.0, nbytes / bps - dt)
                        if debt_s > 0:
                            _time.sleep(debt_s)
    finally:
        ledger.close()
    report["wall_s"] = round(_time.perf_counter() - t_start, 3)
    report["bytes_read"] = bytes_read
    report["cache"] = cache.stats()
    body = json.dumps(report)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    return 1 if report["errors"] else 0


def _cmd_requests(args: argparse.Namespace) -> int:
    """``requests``: tail, filter and
    aggregate a per-request access-record spool — the operator's "which
    requests were slow, and whose trace do I open" surface."""
    from blit_torch import monitor

    since = until = None
    if args.since or args.until:
        import time

        from blit_torch.history import parse_when

        now = time.time()
        since = parse_when(args.since, now) if args.since else None
        until = parse_when(args.until, now) if args.until else None
    records = monitor.read_requests(args.spool, tail=args.tail)
    records = monitor.filter_requests(
        records, slow_ms=args.slow_ms, status=args.status,
        client=args.client, role=args.role, since=since, until=until)
    if args.aggregate:
        agg = monitor.aggregate_requests(records)
        print(json.dumps(agg) if args.json
              else json.dumps(agg, indent=2))
        return 0
    if args.json:
        for r in records:
            print(json.dumps(r))
    else:
        print(monitor.render_requests(records))
    return 0


def _spawn_fleet_peers(td: str, npeers: int, *, concurrency: int,
                       queue_depth: int, ram_bytes: int,
                       beat_interval_s: float = 0.2,
                       bringup_timeout_s: float = 120.0,
                       standbys: int = 0,
                       extra_env: Optional[dict] = None,
                       catalog_root: Optional[str] = None,
                       cold_dirs: bool = False,
                       disk_bytes: Optional[int] = None,
                       device: str = "cuda"):
    """Bring up ``npeers`` REAL ``fleet-peer`` subprocesses, each serving
    on ``device`` (the
    bench/chaos rig): per-peer cache dirs + one shared lease dir under
    ``td``, ephemeral ports published through port files.  Returns
    ``(procs, peers, lease_dir)`` with ``procs`` a list of
    ``(Popen, logfile)`` pairs and ``peers`` the name→url map the
    front door takes.

    ``standbys`` additionally spawns that many ``--standby`` peers
: named ``standby{j}``, lease proc ``npeers + j``,
    appended to both ``procs`` and ``peers`` — the caller registers
    them via ``door.add_standby`` instead of the ring-seeding map.

    Archive plane: ``catalog_root`` arms every peer's
    catalog, ``cold_dirs`` gives each peer a per-peer cold tier under
    ``td``, ``disk_bytes`` caps the hot disk tier (what forces
    demotion)."""
    import os
    import subprocess
    import time as _time

    from blit_torch.serve.http import wait_http_ready

    lease_dir = os.path.join(td, "leases")
    names = [f"peer{i}" for i in range(npeers)]
    names += [f"standby{j}" for j in range(max(0, standbys))]
    procs, peers = [], {}
    for i, name in enumerate(names):
        port_file = os.path.join(td, f"{name}.port")
        cmd = [sys.executable, "-m", "blit_torch", "fleet-peer",
               "--name", name, "--device", device,
               "--cache-dir", os.path.join(td, f"cache-{name}"),
               "--lease-dir", lease_dir, "--proc", str(i),
               "--port", "0", "--port-file", port_file,
               "--concurrency", str(concurrency),
               "--queue-depth", str(queue_depth),
               "--ram-bytes", str(ram_bytes),
               "--beat-interval", str(beat_interval_s),
               "--retry-seed", str(i)]
        if catalog_root:
            cmd += ["--catalog-root", catalog_root]
        if cold_dirs:
            cmd += ["--cold-dir", os.path.join(td, f"cold-{name}")]
        if disk_bytes is not None:
            cmd += ["--disk-bytes", str(disk_bytes)]
        if i >= npeers:
            cmd.append("--standby")
        env = dict(os.environ)
        env.update(extra_env or {})
        logf = open(os.path.join(td, f"{name}.log"), "w")
        procs.append((subprocess.Popen(cmd, stdout=logf, stderr=logf,
                                       env=env), logf))
    try:
        for i, name in enumerate(names):
            port_file = os.path.join(td, f"{name}.port")
            deadline = _time.monotonic() + bringup_timeout_s
            while not os.path.exists(port_file):
                if procs[i][0].poll() is not None:
                    raise RuntimeError(
                        f"{name} died at bring-up "
                        f"(rc={procs[i][0].returncode}; see {name}.log)")
                if _time.monotonic() > deadline:
                    raise TimeoutError(f"{name} port file never appeared")
                _time.sleep(0.05)
            with open(port_file) as f:
                url = f"http://127.0.0.1:{int(f.read().strip())}"
            wait_http_ready(url, timeout_s=bringup_timeout_s)
            peers[name] = url
    except BaseException:
        _reap_fleet_peers(procs)
        raise
    return procs, peers, lease_dir


def _reap_fleet_peers(procs) -> None:
    """Terminate (then kill) peer subprocesses and close their logs —
    every exit path of the bench/chaos rigs."""
    for p, _ in procs:
        if p.poll() is None:
            p.terminate()
    for p, logf in procs:
        try:
            p.wait(timeout=10)
        except Exception:  # noqa: BLE001 — escalate to SIGKILL
            p.kill()
            try:
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001 — nothing left to do
                pass
        try:
            logf.close()
        except OSError:
            pass


def _cmd_serve_bench(args: argparse.Namespace) -> int:
    """Drive a ProductService with a zipfian request replay — the serving
    layer's dispatch-overhead probe: most traffic re-asks for a
    few hot products, so the report's hit-rate/coalesce/queue-wait numbers
    are what a multi-tenant deployment would see.  ``--fleet`` replays
    the same mix through a REAL multi-process fleet front door instead
: N ``fleet-peer`` subprocesses behind consistent-hash
    routing, reporting per-tier hit-rate, SLO attainment and the hedge
    counters."""
    import math
    import os
    import random
    import tempfile
    import threading
    import time as _time

    from blit_torch.observability import Timeline
    from blit_torch.serve import (
        Overloaded,
        ProductCache,
        ProductRequest,
        ProductService,
        Scheduler,
    )
    from blit_torch.serve.http import install_drain_handler
    from blit_torch.testing import synth_raw

    if args.archive_day:
        return _serve_bench_archive_day(args)
    if args.diurnal:
        return _serve_bench_diurnal(args)
    if args.fleet:
        return _serve_bench_fleet(args)
    from blit_torch.config import DEFAULT

    with tempfile.TemporaryDirectory(prefix="blit-serve-bench-") as td:
        # Distinct products = distinct synthetic recordings (tiny: the
        # bench measures the serving layer, not the channelizer).
        ntime = (8 + 3) * args.nfft  # 8 PFB frames at ntap=4
        reqs = []
        for i in range(args.distinct):
            path = os.path.join(td, f"bench{i:03d}.raw")
            synth_raw(path, nblocks=1, obsnchan=2, ntime_per_block=ntime,
                      seed=i)
            reqs.append(ProductRequest(raw=path, nfft=args.nfft, nint=1))
        # Zipfian popularity over the distinct products: p(k) ∝ 1/(k+1)^s
        # — one pick sequence, replayed identically by every pass so the
        # request-log A/B compares the same workload.
        rng = random.Random(args.seed)
        weights = [1.0 / math.pow(k + 1, args.zipf_s)
                   for k in range(args.distinct)]
        picks = rng.choices(range(args.distinct), weights=weights,
                            k=args.requests)

        def one_pass(request_log_dir, pass_id: int = 0) -> dict:
            tl = Timeline()
            cache_dir = (os.path.join(td, f"cache{pass_id}")
                         if args.disk_cache else None)
            # Pin the env for this pass's service construction: an
            # ambient BLIT_REQUEST_LOG would override the config and
            # silently invalidate the off/on A/B ("" = disabled, the
            # request_log_defaults encoding).
            prev = os.environ.get("BLIT_REQUEST_LOG")
            os.environ["BLIT_REQUEST_LOG"] = request_log_dir or ""
            try:
                service = ProductService(
                    cache=ProductCache(cache_dir,
                                       ram_bytes=args.ram_bytes,
                                       timeline=tl),
                    scheduler=Scheduler(max_concurrency=args.concurrency,
                                        queue_depth=args.queue_depth,
                                        timeline=tl,
                                        retry_seed=args.seed),
                    timeline=tl,
                    config=DEFAULT.with_(
                        request_log_dir=request_log_dir),
                    device=args.device,
                )
            finally:
                if prev is None:
                    os.environ.pop("BLIT_REQUEST_LOG", None)
                else:
                    os.environ["BLIT_REQUEST_LOG"] = prev
            # Graceful-shutdown satellite: SIGTERM/SIGINT
            # drains the scheduler — in-flight jobs finish, queued ones
            # deliver Cancelled, and kind="stream" capacity holds
            # release instead of leaking on interpreter exit.
            uninstall_signals = install_drain_handler(
                lambda: service.drain(timeout=30.0))
            errors: list = []
            rejected = [0]
            lock = threading.Lock()
            it = iter(picks)

            def client_loop(cid: int) -> None:
                while True:
                    with lock:
                        k = next(it, None)
                    if k is None:
                        return
                    try:
                        service.get(reqs[k], timeout=120,
                                    client=f"client{cid}")
                    except Overloaded:
                        with lock:
                            rejected[0] += 1
                    except Exception as e:  # noqa: BLE001 — reported
                        with lock:
                            errors.append(repr(e))

            t0 = _time.perf_counter()
            threads = [threading.Thread(target=client_loop, args=(c,))
                       for c in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = _time.perf_counter() - t0
            uninstall_signals()
            service.close()
            stats = service.stats()
            qw = stats["queue_wait"]
            rep = {
                "requests": args.requests,
                "distinct": args.distinct,
                "clients": args.clients,
                "zipf_s": args.zipf_s,
                "wall_s": round(wall, 3),
                "hit_rate": stats["hit_rate"],
                "coalesced": stats["coalesced"],
                "scheduled": stats["scheduled"],
                "rejected_overloaded": rejected[0],
                "queue_wait_p50_s": round(qw["p50"], 6),
                "queue_wait_p99_s": round(qw["p99"], 6),
                "cache": stats["cache"],
                # Latency distributions: the bounded
                # histograms the serving timeline accumulated — tails,
                # not averages.
                "hists": tl.report().get("hists", {}),
                "errors": errors[:5],
            }
            if request_log_dir:
                from blit_torch import monitor

                recs = monitor.read_requests(request_log_dir)
                rep["request_log"] = monitor.aggregate_requests(recs)
            return rep

        if args.request_log_compare:
            # The request-log A/B (the --spans-compare discipline): the
            # identical replay with request logging DISABLED then
            # ENABLED — the report pins the disabled pass's record
            # count at zero and prices the enabled pass.  An untimed
            # warmup pass absorbs the XLA compiles first, so off/on
            # compare warm against warm instead of cold against warm.
            one_pass(None, 9)
            off = one_pass(None, 0)
            log_dir = args.request_log or os.path.join(td, "reqlog")
            # Measured, not assumed: the disabled pass must have
            # written NOTHING anywhere under the bench root.
            import glob as _glob

            off_records = len(_glob.glob(
                os.path.join(td, "**", "requests-*.jsonl*"),
                recursive=True))
            on = one_pass(log_dir, 1)
            overhead = (on["wall_s"] / off["wall_s"] - 1.0
                        if off["wall_s"] else 0.0)
            print(json.dumps({
                "request_log_compare": True,
                "off_wall_s": off["wall_s"],
                "on_wall_s": on["wall_s"],
                "overhead_pct": round(overhead * 100.0, 2),
                "off_records": off_records,
                "on_records": (on.get("request_log") or {}).get(
                    "records", 0),
                "off": off,
                "on": on,
            }))
            return 1 if off["errors"] or on["errors"] else 0
        rep = one_pass(args.request_log, 0)
        print(json.dumps(rep))
        return 1 if rep["errors"] else 0


def _serve_bench_fleet(args: argparse.Namespace) -> int:
    """``serve-bench --fleet``: replay the zipfian mix at
    accelerated clock through a REAL fleet — N ``fleet-peer``
    subprocesses behind an in-process :class:`FleetFrontDoor` (the HTTP
    hop is at the peer boundary, where the bytes actually move).  The
    report is what a deployment watches: per-tier hit-rate across the
    fleet, SLO attainment against ``--slo-ms``, request p50/p99, and
    the hedge/failover counters with the duplicate-compute bound."""
    import math
    import os
    import random
    import tempfile
    import threading
    import time as _time

    from blit_torch import monitor, observability
    from blit_torch.config import DEFAULT
    from blit_torch.observability import HistogramStats, Timeline
    from blit_torch.serve import Overloaded, ProductRequest
    from blit_torch.serve.fleet import FleetFrontDoor
    from blit_torch.serve.http import (
        WIRE_CTYPE,
        WIRE_HEADER,
        decode_product,
        decode_product_wire,
        http_json,
        http_request,
        install_drain_handler,
        wire_request,
    )
    from blit_torch.serve.scheduler import DeadlineExpired
    from blit_torch.testing import synth_raw

    rng = random.Random(args.seed)
    tl = Timeline()
    with tempfile.TemporaryDirectory(prefix="blit-fleet-bench-") as td:
        ntime = (8 + 3) * args.nfft  # 8 PFB frames at ntap=4
        reqs = []
        for i in range(args.distinct):
            path = os.path.join(td, f"bench{i:03d}.raw")
            synth_raw(path, nblocks=1, obsnchan=2, ntime_per_block=ntime,
                      seed=i)
            reqs.append(ProductRequest(raw=path, nfft=args.nfft, nint=1))
        # Request observability is ON for the fleet replay:
        # the report's p50/p99 come from the access records, and the
        # peers inherit the spool dir through their environment.  The
        # door's env is pinned too — an ambient BLIT_REQUEST_LOG would
        # override the config and send its records elsewhere.
        reqlog_dir = args.request_log or os.path.join(td, "reqlog")
        os.environ["BLIT_REQUEST_LOG"] = reqlog_dir
        procs, peers, lease_dir = _spawn_fleet_peers(
            td, args.peers, device=args.device, concurrency=args.concurrency,
            queue_depth=args.queue_depth, ram_bytes=args.ram_bytes,
            extra_env={"BLIT_REQUEST_LOG": reqlog_dir})
        door = FleetFrontDoor(
            peers, lease_dir=lease_dir, timeline=tl,
            replicas=args.replicas, peer_ttl_s=args.peer_ttl,
            poll_s=min(0.1, args.peer_ttl / 4),
            hedge_floor_s=args.hedge_floor_ms / 1e3,
            request_timeout_s=60.0,
            config=DEFAULT.with_(request_log_dir=reqlog_dir)).start()
        uninstall = install_drain_handler(lambda: door.drain())
        weights = [1.0 / math.pow(k + 1, args.zipf_s)
                   for k in range(args.distinct)]
        picks = rng.choices(range(args.distinct), weights=weights,
                            k=args.requests)
        lat = HistogramStats()
        slo_s = args.slo_ms / 1e3
        lock = threading.Lock()
        attained = [0]
        rejected = [0]
        expired = [0]
        errors: list = []
        it = iter(picks)

        def client_loop(cid: int) -> None:
            while True:
                with lock:
                    k = next(it, None)
                if k is None:
                    return
                t = _time.perf_counter()
                ok = False
                try:
                    door.get(reqs[k], client=f"client{cid}",
                             deadline_s=args.deadline)
                    ok = True
                except DeadlineExpired:
                    with lock:
                        expired[0] += 1
                except Overloaded as e:
                    with lock:
                        rejected[0] += 1
                    _time.sleep(min(0.25, e.retry_after_s))
                except Exception as e:  # noqa: BLE001 — reported below
                    with lock:
                        errors.append(repr(e))
                dt = _time.perf_counter() - t
                lat.observe(dt)
                # SLO attainment counts SERVED requests only: a fleet
                # that 503s everything in a millisecond must read as
                # 0% attained, not 100%.
                if ok and dt <= slo_s:
                    with lock:
                        attained[0] += 1

        try:
            t0 = _time.perf_counter()
            threads = [threading.Thread(target=client_loop, args=(c,))
                       for c in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = _time.perf_counter() - t0
            tiers = {"hit.ram": 0, "hit.disk": 0, "miss": 0}
            per_peer = {}
            for name, url in sorted(peers.items()):
                try:
                    _, _, s = http_json("GET", url, "/stats", timeout=5.0)
                except OSError:
                    continue
                c = (s.get("cache") or {})
                for k in tiers:
                    tiers[k] += int(c.get(k, 0))
                per_peer[name] = {
                    "hit_rate": s.get("hit_rate"),
                    "scheduled": s.get("scheduled"),
                    "coalesced": s.get("coalesced"),
                }
            served_tier = tiers["hit.ram"] + tiers["hit.disk"]
            total_tier = served_tier + tiers["miss"]
            # Wire back-compat probe: ONE explicit
            # legacy-JSON request and ONE binary request against the
            # same peer for the same product — the CI smoke pins that
            # the binary frame was actually negotiated somewhere AND
            # that a client which never sends the binary Accept still
            # gets the identical bytes.
            try:
                probe_doc = json.dumps(wire_request(
                    reqs[0], client="compat")).encode()
                purl = sorted(peers.values())[0]
                st_j, hdr_j, pay_j = http_request(
                    "POST", purl, "/product", body=probe_doc,
                    headers={"Content-Type": "application/json"},
                    timeout=60.0)
                st_b, hdr_b, pay_b = http_request(
                    "POST", purl, "/product", body=probe_doc,
                    headers={"Content-Type": "application/json",
                             "Accept": f"{WIRE_CTYPE}, application/json"},
                    timeout=60.0)
                _, dj = decode_product(json.loads(pay_j))
                _, db = decode_product_wire(
                    pay_b, encoding=hdr_b.get("content-encoding"))
                compat = {
                    "legacy_wire": hdr_j.get(WIRE_HEADER.lower()),
                    "binary_wire": hdr_b.get(WIRE_HEADER.lower()),
                    "byte_identical": bool(
                        st_j == 200 and st_b == 200
                        and dj.dtype == db.dtype
                        and dj.shape == db.shape
                        and dj.tobytes() == db.tobytes()),
                }
            except Exception as e:  # noqa: BLE001 — probe is advisory
                compat = {"error": repr(e)}
            # Fleet trace harvest: stitch the
            # peers' span batches (their live /snapshot endpoints, with
            # histogram exemplars) and the door's own spans/hists into
            # ONE reviewable artifact — the Perfetto export plus a raw
            # .snapshot.json that `trace-view --fleet` reads after
            # the peers are gone.
            trace_block = None
            if args.trace_out:
                spans, hists = monitor.gather_trace_sources(
                    list(peers.values()))
                seen_ids = {s.get("span") for s in spans}
                spans.extend(s for s in observability.tracer().span_dicts()
                             if s.get("span") not in seen_ids)
                for k, h in list(tl.hists.items()):
                    if k in hists:
                        hists[k].merge(h)
                    else:
                        hists[k] = HistogramStats.from_state(h.state())
                stitcher = observability.Tracer(
                    max_spans=max(1, len(spans)), enabled=True)
                stitcher.ingest(spans)
                stitcher.export_chrome(args.trace_out)
                snap_path = args.trace_out + ".snapshot.json"
                with open(snap_path, "w") as f:
                    json.dump({"spans": spans,
                               "hists": {k: h.state()
                                         for k, h in hists.items()}}, f)
                trace_block = dict(observability.trace_summary(spans),
                                   out=args.trace_out,
                                   snapshot=snap_path)
            # The report's latency quantiles come from the ACCESS
            # RECORDS: what the door actually
            # logged per request, not a separate in-bench stopwatch.
            all_recs = monitor.read_requests(reqlog_dir)
            door_agg = monitor.aggregate_requests(
                monitor.filter_requests(all_recs, role="door"))
            fstats = door.stats()
            c = fstats["counters"]
            hedges = c.get("fleet.hedge", 0)
            report = {
                "fleet": True,
                "requests": args.requests,
                "distinct": args.distinct,
                "clients": args.clients,
                "peers": args.peers,
                "replicas": args.replicas,
                "zipf_s": args.zipf_s,
                "wall_s": round(wall, 3),
                "rps": round(args.requests / wall, 1) if wall else None,
                "tiers": tiers,
                "hit_rate": (round(served_tier / total_tier, 4)
                             if total_tier else 0.0),
                "hit_rate_ram": (round(tiers["hit.ram"] / total_tier, 4)
                                 if total_tier else 0.0),
                "hit_rate_disk": (round(tiers["hit.disk"] / total_tier, 4)
                                  if total_tier else 0.0),
                "slo": {"target_s": slo_s,
                        "attained": round(attained[0] / args.requests, 4)
                        if args.requests else None},
                "request_p50_s": round(lat.percentile(0.50), 6),
                "request_p99_s": round(lat.percentile(0.99), 6),
                "hedge": {
                    "hedges": hedges,
                    "wins": c.get("fleet.hedge.win", 0),
                    "dup_done": c.get("fleet.hedge.dup_done", 0),
                    "rate": (round(hedges / args.requests, 4)
                             if args.requests else 0.0),
                    # The acceptance bound: each hedge adds at most ONE
                    # duplicate dispatch, so compute on the hedged slice
                    # is <= 2x by construction; dup_ratio reports how
                    # much actually ran to completion.
                    "dup_ratio": (round(
                        c.get("fleet.hedge.dup_done", 0) / hedges, 4)
                        if hedges else 0.0),
                },
                "failovers": c.get("fleet.failover", 0),
                # The hot-path data plane: which wire each
                # peer answer rode, the keep-alive pool's reuse ratio,
                # and the negotiation/back-compat probe CI asserts on.
                "wire": {
                    "mode": fstats.get("wire"),
                    "binary_responses": c.get("fleet.wire.binary", 0),
                    "json_responses": c.get("fleet.wire.json", 0),
                    "wire_gb": round(
                        tl.hists["fleet.wire_bytes"].total / 1e9, 6)
                    if "fleet.wire_bytes" in tl.hists else 0.0,
                    "pool": {
                        "open": c.get("fleet.pool.open", 0),
                        "reuse": c.get("fleet.pool.reuse", 0),
                        "evict": c.get("fleet.pool.evict", 0),
                        "idle": fstats.get("pool"),
                    },
                    "compat": compat,
                },
                "rejected_overloaded": rejected[0],
                "deadline_expired": expired[0],
                "per_peer": per_peer,
                "request_log": {
                    "dir": reqlog_dir,
                    "records": len(all_recs),
                    "door_records": door_agg["records"],
                    "p50_s": door_agg["p50_s"],
                    "p99_s": door_agg["p99_s"],
                    "by_status": door_agg["by_status"],
                    "by_tier": door_agg["by_tier"],
                },
                "errors": errors[:5],
            }
            if trace_block is not None:
                report["trace"] = trace_block
            print(json.dumps(report))
        finally:
            uninstall()
            door.close()
            _reap_fleet_peers(procs)
    return 1 if errors else 0


def _serve_bench_diurnal(args: argparse.Namespace) -> int:
    """``serve-bench --diurnal``: day-shaped
    load at accelerated clock over a REAL fleet with the ELASTIC
    controller in the loop.  Each cycle is one diurnal swing: a peak
    burst that should page the burn-rate evaluator into a scale-out
    (warm handoff → membership flip; forced through the manual lever
    when the rig serves the peak inside the SLO, and the report says
    which lever moved), a post-resize probe that pins the hit-rate
    within 10% of the pre-resize probe, then a trough of idle
    controller ticks that drains the coldest peer back out.  The
    report asserts what the acceptance gates on: SLO attainment
    through all the resizes, the hit-rate bound per cycle, and ZERO
    requests routed to a departed peer."""
    import math
    import os
    import random
    import tempfile
    import threading
    import time as _time

    from blit_torch.monitor import BurnRateEvaluator, SLObjective
    from blit_torch.observability import HistogramStats, Timeline
    from blit_torch.serve import Overloaded, ProductRequest
    from blit_torch.serve.elastic import FleetController
    from blit_torch.serve.fleet import FleetError, FleetFrontDoor
    from blit_torch.serve.http import http_json, install_drain_handler
    from blit_torch.serve.scheduler import DeadlineExpired
    from blit_torch.testing import synth_raw

    rng = random.Random(args.seed)
    tl = Timeline()
    cycles = max(1, args.cycles)
    standbys = args.standbys if args.standbys is not None else cycles
    report: dict = {"diurnal": True, "cycles": cycles,
                    "peers": args.peers, "standbys": standbys,
                    "replicas": args.replicas, "distinct": args.distinct,
                    "clients": args.clients, "zipf_s": args.zipf_s}
    ok = False
    with tempfile.TemporaryDirectory(prefix="blit-diurnal-") as td:
        ntime = (8 + 3) * args.nfft  # 8 PFB frames at ntap=4
        reqs = []
        for i in range(args.distinct):
            path = os.path.join(td, f"bench{i:03d}.raw")
            synth_raw(path, nblocks=1, obsnchan=2, ntime_per_block=ntime,
                      seed=i)
            reqs.append(ProductRequest(raw=path, nfft=args.nfft, nint=1))
        procs, peers, lease_dir = _spawn_fleet_peers(
            td, args.peers, device=args.device, concurrency=args.concurrency,
            queue_depth=args.queue_depth, ram_bytes=args.ram_bytes,
            standbys=standbys)
        names = [f"peer{i}" for i in range(args.peers)]
        standby_names = [f"standby{j}" for j in range(standbys)]
        proc_of = {nm: procs[i][0]
                   for i, nm in enumerate(names + standby_names)}
        door = FleetFrontDoor(
            {nm: peers[nm] for nm in names}, lease_dir=lease_dir,
            timeline=tl, replicas=args.replicas,
            peer_ttl_s=args.peer_ttl, poll_s=min(0.1, args.peer_ttl / 4),
            hedge_floor_s=args.hedge_floor_ms / 1e3,
            request_timeout_s=60.0).start()
        for j, nm in enumerate(standby_names):
            door.add_standby(nm, peers[nm], proc=args.peers + j)

        def terminate(nm: str) -> None:
            """The scale-in epilogue: SIGTERM the retired child — the
            peer's drain handler finishes in-flight work and exits."""
            p = proc_of.get(nm)
            if p is not None and p.poll() is None:
                p.terminate()

        uninstall = install_drain_handler(lambda: door.drain())
        weights = [1.0 / math.pow(k + 1, args.zipf_s)
                   for k in range(args.distinct)]
        slo_s = args.slo_ms / 1e3
        lat = HistogramStats()
        lock = threading.Lock()
        counts = {"issued": 0, "served": 0, "attained": 0,
                  "rejected": 0, "expired": 0}
        errors: list = []

        def run_burst(n: int, record: bool = True) -> None:
            picks = rng.choices(range(args.distinct), weights=weights,
                                k=n)
            it = iter(picks)

            def worker(cid: int) -> None:
                while True:
                    with lock:
                        k = next(it, None)
                    if k is None:
                        return
                    t = _time.perf_counter()
                    got, err = False, None
                    for _attempt in range(4):
                        try:
                            door.get(reqs[k], client=f"diurnal{cid}")
                            got = True
                            break
                        except DeadlineExpired:
                            with lock:
                                counts["expired"] += 1
                            break
                        except Overloaded as e:
                            with lock:
                                counts["rejected"] += 1
                            _time.sleep(min(0.25, e.retry_after_s))
                        except (FleetError, OSError) as e:
                            # Transient while a flip/eject settles:
                            # back off a beat and retry, like a real
                            # client's loop.
                            err = repr(e)
                            _time.sleep(0.2)
                        except Exception as e:  # noqa: BLE001
                            err = repr(e)
                            break
                    if not got and err is not None:
                        with lock:
                            errors.append(err)
                    if not record:
                        continue
                    dt = _time.perf_counter() - t
                    lat.observe(dt)
                    with lock:
                        counts["issued"] += 1
                        if got:
                            counts["served"] += 1
                            if dt <= slo_s:
                                counts["attained"] += 1

            threads = [threading.Thread(target=worker, args=(c,))
                       for c in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        def cache_totals() -> dict:
            out = {}
            for nm, p in sorted(door._peers.items()):
                try:
                    _, _, s = http_json("GET", p.url, "/stats",
                                        timeout=2.0, pool=door.pool)
                except OSError:
                    continue
                c = s.get("cache") or {}
                out[nm] = (c.get("hit.ram", 0) + c.get("hit.disk", 0),
                           c.get("miss", 0))
            return out

        def window_hit_rate(before: dict, after: dict):
            dh = dm = 0
            for nm, (h1, m1) in after.items():
                if nm not in before:
                    continue
                h0, m0 = before[nm]
                dh += max(0, h1 - h0)
                dm += max(0, m1 - m0)
            return (dh / (dh + dm)) if dh + dm else None

        peak_n = max(16, args.requests // 2)
        probe_n = max(12, args.requests // 4)
        tick_s = 30.0  # the accelerated clock: one tick "is" 30s of day
        forced = {"out": 0, "in": 0}
        departed: dict = {}
        cyc_reports: list = []
        ctl = None
        try:
            # Untimed warm-up: first-touch XLA compiles and cache fills
            # land OUTSIDE the SLO ledger, like a deployment bring-up.
            run_burst(args.requests, record=False)
            ev = BurnRateEvaluator(
                [SLObjective("fleet-latency", "fleet.request_s",
                             args.burn_threshold_ms / 1e3, budget=0.05)],
                fast_window=2, slow_window=4, fast_burn=4.0,
                slow_burn=2.0)
            ctl = FleetController(
                door, ev, feed=tl, terminate=terminate,
                idle_windows=args.idle_windows,
                hysteresis_s=args.hysteresis,
                warm_timeout_s=args.warm_timeout,
                min_peers=args.peers, poll_s=0.5)
            # Prime the feed baseline so the warm-up's latencies are
            # not the first tick's delta — the day starts NOW.
            ctl._feed_state = tl.state()
            t0 = _time.perf_counter()
            for c in range(cycles):
                ring_pre = sorted(door.ring.peers())
                # Pre-resize probe: the hit-rate the flip must not
                # crater (caches are warm from the previous swing).
                a0 = cache_totals()
                run_burst(probe_n)
                a1 = cache_totals()
                hit_pre = window_hit_rate(a0, a1)
                # -- PEAK: the day's load pages the evaluator.
                out_rec = None
                for _ in range(4):
                    run_burst(peak_n)
                    act = ctl.observe(interval_s=tick_s)
                    if act is not None and act["action"] == "scale-out":
                        out_rec = act
                        break
                organic_out = out_rec is not None
                if out_rec is None:
                    # A fast rig can serve the whole peak inside the
                    # SLO; force the flip so the resize contract is
                    # still exercised — the report says which lever.
                    out_rec = ctl.scale_out()
                    if out_rec is not None:
                        forced["out"] += 1
                # Post-resize probe: the warm-handoff dividend.
                b0 = cache_totals()
                run_burst(probe_n)
                b1 = cache_totals()
                hit_post = window_hit_rate(b0, b1)
                hit_ok = (hit_pre is not None and hit_post is not None
                          and hit_post >= hit_pre - 0.10)
                # -- TROUGH: sustained idle drains the coldest peer.
                _time.sleep(args.hysteresis)  # let the flap guard lapse
                in_rec = None
                for _ in range(args.idle_windows + 6):
                    act = ctl.observe(interval_s=tick_s)
                    if act is not None and act["action"] == "scale-in":
                        in_rec = act
                        break
                organic_in = in_rec is not None
                if in_rec is None:
                    in_rec = ctl.scale_in()
                    if in_rec is not None:
                        forced["in"] += 1
                if in_rec is not None:
                    victim = in_rec["peer"]
                    departed[victim] = door._peers[victim].requests
                _time.sleep(args.hysteresis)  # disarm before next peak
                cyc_reports.append({
                    "cycle": c,
                    "ring_pre": ring_pre,
                    "ring_post": sorted(door.ring.peers()),
                    "scale_out": out_rec,
                    "organic_out": organic_out,
                    "scale_in": in_rec,
                    "organic_in": organic_in,
                    "hit_rate_pre_resize": (round(hit_pre, 4)
                                            if hit_pre is not None
                                            else None),
                    "hit_rate_post_resize": (round(hit_post, 4)
                                             if hit_post is not None
                                             else None),
                    "hit_bound_ok": hit_ok,
                })
            wall = _time.perf_counter() - t0
            # ZERO requests to a departed peer: the per-peer request
            # counter of every retired peer must not have moved since
            # its retirement.
            requests_to_departed = sum(
                max(0, door._peers[nm].requests - snap)
                for nm, snap in departed.items())
            attain = (counts["attained"] / counts["issued"]
                      if counts["issued"] else None)
            slo_ok = attain is not None and attain >= args.slo_floor
            resizes_out = sum(1 for r in cyc_reports if r["scale_out"])
            resizes_in = sum(1 for r in cyc_reports if r["scale_in"])
            hit_ok_all = all(r["hit_bound_ok"] for r in cyc_reports)
            fstats = door.stats()
            cnt = fstats["counters"]
            rh = tl.hists.get("elastic.resize_s")
            wb = tl.hists.get("elastic.warm_bytes")
            ok = (resizes_out >= cycles and resizes_in >= cycles
                  and slo_ok and hit_ok_all
                  and requests_to_departed == 0 and not errors)
            report.update(
                requests=counts["issued"],
                served=counts["served"],
                wall_s=round(wall, 3),
                slo={"target_s": slo_s,
                     "attained": (round(attain, 4)
                                  if attain is not None else None),
                     "floor": args.slo_floor, "ok": slo_ok},
                request_p50_s=round(lat.percentile(0.50), 6),
                request_p99_s=round(lat.percentile(0.99), 6),
                scale_outs=resizes_out,
                scale_ins=resizes_in,
                forced_resizes=forced,
                requests_to_departed=requests_to_departed,
                hit_bound_ok=hit_ok_all,
                cycles_detail=cyc_reports,
                elastic={
                    "scale_out": cnt.get("elastic.scale_out", 0),
                    "scale_in": cnt.get("elastic.scale_in", 0),
                    "warm_timeout": cnt.get("elastic.warm_timeout", 0),
                    "flap_suppressed": cnt.get(
                        "elastic.flap_suppressed", 0),
                    "resize_p50_s": (round(rh.percentile(0.50), 6)
                                     if rh is not None else None),
                    "resize_p99_s": (round(rh.percentile(0.99), 6)
                                     if rh is not None else None),
                    "warm_bytes": int(wb.total) if wb is not None else 0,
                },
                controller=ctl.stats(),
                rejected_overloaded=counts["rejected"],
                deadline_expired=counts["expired"],
                errors=errors[:5],
            )
            # The flat scalar block bench-diff extracts and gates,
            # exactly like the ingest/archive-day records.
            report["metrics"] = {
                "diurnal.cycles": float(len(cyc_reports)),
                "diurnal.slo_attained": float(attain or 0.0),
                "diurnal.request_p50_s": report["request_p50_s"],
                "diurnal.request_p99_s": report["request_p99_s"],
                "diurnal.scale_out": float(cnt.get(
                    "elastic.scale_out", 0)),
                "diurnal.scale_in": float(cnt.get("elastic.scale_in", 0)),
                "diurnal.warm_timeouts": float(cnt.get(
                    "elastic.warm_timeout", 0)),
                "diurnal.requests_to_departed": float(
                    requests_to_departed),
                "diurnal.post_resize_min_hit_rate": float(min(
                    (r["hit_rate_post_resize"] for r in cyc_reports
                     if r["hit_rate_post_resize"] is not None),
                    default=0.0)),
            }
            report["ok"] = ok
            body = json.dumps(report)
            print(body)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(body)
        finally:
            uninstall()
            if ctl is not None:
                ctl.close()
            door.close()
            _reap_fleet_peers(procs)
    return 0 if ok else 1


def _serve_bench_archive_day(args: argparse.Namespace) -> int:
    """``serve-bench --archive-day``: replay a zipfian
    MULTI-SESSION observing day at accelerated clock over REAL
    ``fleet-peer`` subprocesses serving a REAL on-disk archive tree.
    Every product ask is by-(session, scan, player) and resolves
    through the door's catalog, peers run hot(+cold) tiered caches
    with a bounded hot disk (what forces demotion), and
    ``kind="catalog"`` asks ride the same wire.  Two passes per run —
    binary then legacy JSON, identical seeds, fresh peer caches — and
    the report carries catalog-lookup p50/p99, per-tier
    (ram/wire/disk/cold/derive) rates, SLO attainment against
    ``--slo-ms``, the wire A/B with a byte-identity pin AND the
    addressed-vs-explicit-member byte-identity pin.  The record
    carries ``config.backend`` (the rig) and a flat ``metrics`` dict
    so ``bench-diff`` extracts and gates it exactly like the
    ingest records."""
    import math
    import os
    import random
    import tempfile
    import threading
    import time as _time

    from blit_torch import monitor
    from blit_torch.config import DEFAULT
    from blit_torch.observability import HistogramStats, Timeline
    from blit_torch.serve import Overloaded, ProductRequest
    from blit_torch.serve.fleet import FleetFrontDoor
    from blit_torch.serve.http import http_json, install_drain_handler
    from blit_torch.serve.scheduler import DeadlineExpired
    from blit_torch.testing import build_observation_tree

    backend = str(args.device).split(":")[0]  # the rig label

    def q(h, p: float) -> float:
        return round(h.percentile(p), 6) if h is not None and h.n else 0.0

    players = ((0, 0), (0, 1))
    slo_s = args.slo_ms / 1e3
    with tempfile.TemporaryDirectory(prefix="blit-archive-day-") as td:
        # The day's archive is a REAL on-disk BL tree:
        # --sessions observing sessions x --distinct scans x the
        # player pair, crawled by every peer's catalog AND the
        # door's.  Popularity is zipfian along BOTH axes — a few hot
        # sessions dominate the day and within a session a few hot
        # scans dominate — which is what makes the warm tiers earn
        # their bytes.
        arc = os.path.join(td, "archive")
        raw_ntime = 6 * args.nfft  # x2 blocks/file = 12 frames' worth
        scan_names = [f"{i + 1:04d}" for i in range(args.distinct)]
        sess_names = [f"AGBT25A_999_{s:02d}"
                      for s in range(args.sessions)]
        for sess in sess_names:
            build_observation_tree(
                arc, sess, scans=tuple(scan_names), players=players,
                kind="raw", nchans=2, raw_ntime=raw_ntime, nfiles=1)
        reqs = []   # (addressed request, session, scan)
        weights = []
        for s, sess in enumerate(sess_names):
            for i, scan in enumerate(scan_names):
                w = 1.0 / (math.pow(s + 1, args.zipf_s)
                           * math.pow(i + 1, args.zipf_s))
                for band, bank in players:
                    reqs.append((ProductRequest(
                        raw="", session=sess, scan=scan, band=band,
                        bank=bank, nfft=args.nfft, nint=1),
                        sess, scan))
                    weights.append(w)
        picks = random.Random(args.seed).choices(
            range(len(reqs)), weights=weights, k=args.requests)

        def one_pass(wire_mode: str, tag: str):
            """One full day replay on a fresh fleet speaking
            ``wire_mode``; returns ``(pass_report, probe)`` where
            ``probe`` is the decoded hottest product for the cross-wire
            byte-identity pin."""
            pd = os.path.join(td, tag)
            os.makedirs(pd, exist_ok=True)
            tl = Timeline()
            # Pin the pass's wire on the environment: fleet_defaults
            # lets ambient BLIT_FLEET_WIRE* override the config, which
            # would silently turn the A/B into two identical passes.
            pinned = {"BLIT_FLEET_WIRE": wire_mode,
                      "BLIT_FLEET_WIRE_DEFLATE": "1" if args.deflate
                      else "0",
                      "BLIT_REQUEST_LOG": args.request_log or ""}
            prev = {k: os.environ.get(k) for k in pinned}
            os.environ.update(pinned)
            procs, peers, lease_dir = _spawn_fleet_peers(
                pd, args.peers, device=args.device, concurrency=args.concurrency,
                queue_depth=args.queue_depth, ram_bytes=args.ram_bytes,
                extra_env=pinned, catalog_root=arc, cold_dirs=True,
                disk_bytes=args.disk_bytes)
            try:
                door = FleetFrontDoor(
                    peers, lease_dir=lease_dir, timeline=tl,
                    replicas=args.replicas, peer_ttl_s=args.peer_ttl,
                    poll_s=min(0.1, args.peer_ttl / 4),
                    hedge_floor_s=args.hedge_floor_ms / 1e3,
                    request_timeout_s=60.0,
                    config=DEFAULT.with_(
                        fleet_wire=wire_mode, catalog_root=arc,
                        request_log_dir=args.request_log)).start()
            finally:
                for k, v in prev.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            uninstall = install_drain_handler(lambda: door.drain())
            lat = HistogramStats()
            lock = threading.Lock()
            rejected = [0]
            delivered = [0]  # decoded product bytes handed to clients
            slo_ok = [0]
            nprod = [0]
            catalog_asks = [0]
            errors: list = []
            it = iter(enumerate(picks))

            def client_loop(cid: int) -> None:
                while True:
                    with lock:
                        nk = next(it, None)
                    if nk is None:
                        return
                    n, k = nk
                    req, sess, scan = reqs[k]
                    if n % 16 == 0:
                        # Every 16th slot also asks the CATALOG about
                        # the scan it is about to fetch — the
                        # archive-plane control queries ride the same
                        # wire and feed the same catalog.lookup_s
                        # histogram as door-side resolution.
                        try:
                            door.get(ProductRequest(
                                kind="catalog",
                                raw=f"{sess}/{scan}"),
                                client=f"client{cid}")
                            with lock:
                                catalog_asks[0] += 1
                        except Exception as e:  # noqa: BLE001
                            with lock:
                                errors.append(f"catalog: {e!r}")
                    t = _time.perf_counter()
                    ok = False
                    try:
                        _, d = door.get(req, client=f"client{cid}")
                        ok = True
                        with lock:
                            delivered[0] += d.nbytes
                    except (Overloaded, DeadlineExpired) as e:
                        with lock:
                            rejected[0] += 1
                        if isinstance(e, Overloaded):
                            _time.sleep(min(0.25, e.retry_after_s))
                    except Exception as e:  # noqa: BLE001 — reported
                        with lock:
                            errors.append(repr(e))
                    dur = _time.perf_counter() - t
                    lat.observe(dur)
                    with lock:
                        nprod[0] += 1
                        if ok and dur <= slo_s:
                            slo_ok[0] += 1

            try:
                t0 = _time.perf_counter()
                threads = [threading.Thread(target=client_loop,
                                            args=(c,))
                           for c in range(args.clients)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = _time.perf_counter() - t0
                # Byte-identity probes on the day's hottest product:
                # (1) decoded through THIS pass's wire for the
                # cross-wire pin, (2) addressed-by-(session, scan,
                # player) vs explicit member paths — the
                # catalog-resolution acceptance.
                probe = None
                addr_identical = None
                try:
                    req0, sess0, scan0 = reqs[0]
                    ph, pdata = door.get(req0, client="probe")
                    probe = (dict(ph), pdata.dtype.str,
                             tuple(pdata.shape), pdata.tobytes())
                    members = door.catalog.resolve(
                        sess0, scan0, band=req0.band, bank=req0.bank)
                    _, edata = door.get(
                        ProductRequest(raw=tuple(members),
                                       nfft=args.nfft, nint=1),
                        client="probe-explicit")
                    addr_identical = (
                        pdata.dtype == edata.dtype
                        and pdata.shape == edata.shape
                        and pdata.tobytes() == edata.tobytes())
                except Exception as e:  # noqa: BLE001 — reported
                    errors.append(f"probe: {e!r}")
                tiers = {"hit.ram": 0, "hit.disk": 0, "hit.wire": 0,
                         "hit.cold": 0, "derive": 0, "miss": 0}
                for _name, url in sorted(peers.items()):
                    try:
                        _, _, s = http_json("GET", url, "/stats",
                                            timeout=5.0)
                    except OSError:
                        continue
                    cst = (s.get("cache") or {})
                    for k in tiers:
                        tiers[k] += int(cst.get(k, 0))
                # The peers' serialize histogram rides their /snapshot
                # endpoints (merged across the fleet); deserialize and
                # wire bytes live on the door's own timeline.
                _, peer_hists = monitor.gather_trace_sources(
                    list(peers.values()))
                ser = peer_hists.get("fleet.serialize_s")
                de = tl.hists.get("fleet.deserialize_s")
                wire_h = tl.hists.get("fleet.wire_bytes")
                wire_bytes = float(wire_h.total) if wire_h else 0.0
                served = (tiers["hit.ram"] + tiers["hit.disk"]
                          + tiers["hit.cold"])
                total = served + tiers["miss"]
                ch = tl.hists.get("catalog.lookup_s")
                c = door.stats()["counters"]
                rep = {
                    "wire": wire_mode,
                    "wall_s": round(wall, 3),
                    "rps": (round(args.requests / wall, 1)
                            if wall else None),
                    "tiers": tiers,
                    "hit_rate": (round(served / total, 4)
                                 if total else 0.0),
                    # wire_bytes is what moved on the socket (base64
                    # inflates the JSON pass ~4/3); wire_gbps is the
                    # USEFUL throughput — decoded product bytes
                    # delivered to clients per wall second, the number
                    # the two wires compete on.
                    "wire_bytes": int(wire_bytes),
                    "delivered_bytes": delivered[0],
                    "wire_gbps": (round(delivered[0] / wall / 1e9, 6)
                                  if wall else 0.0),
                    "request_p50_s": q(lat, 0.50),
                    "request_p99_s": q(lat, 0.99),
                    "serialize_p50_s": q(ser, 0.50),
                    "serialize_p99_s": q(ser, 0.99),
                    "deserialize_p50_s": q(de, 0.50),
                    "deserialize_p99_s": q(de, 0.99),
                    "catalog_lookup_p50_s": q(ch, 0.50),
                    "catalog_lookup_p99_s": q(ch, 0.99),
                    "catalog_asks": catalog_asks[0],
                    "slo_attained": (round(slo_ok[0] / nprod[0], 4)
                                     if nprod[0] else 0.0),
                    "addressing_byte_identical": addr_identical,
                    "door": {
                        "binary_responses": c.get("fleet.wire.binary",
                                                  0),
                        "json_responses": c.get("fleet.wire.json", 0),
                        "pool_open": c.get("fleet.pool.open", 0),
                        "pool_reuse": c.get("fleet.pool.reuse", 0),
                        "pool_evict": c.get("fleet.pool.evict", 0),
                    },
                    "rejected": rejected[0],
                    "errors": errors[:5],
                }
                return rep, probe
            finally:
                uninstall()
                door.close()
                _reap_fleet_peers(procs)

        bin_rep, bin_probe = one_pass("binary", "binary")
        json_rep, json_probe = one_pass("json", "legacy")
        byte_identical = (bin_probe is not None
                          and bin_probe == json_probe)
        addressing_ok = (bin_rep["addressing_byte_identical"] is True
                         and json_rep["addressing_byte_identical"]
                         is True)
        speedup = (json_rep["wall_s"] / bin_rep["wall_s"]
                   if bin_rep["wall_s"] else 0.0)
        # The accelerated-clock framing: the replay IS the day's
        # zipfian ask stream compressed into wall_s, so the modeled
        # archive-day request count is requests x (86400 / wall_s) —
        # the number the catalog/tier quantiles were measured under.
        accel = (86400.0 / bin_rep["wall_s"] if bin_rep["wall_s"]
                 else 0.0)
        bt = bin_rep["tiers"]
        t_total = (bt["hit.ram"] + bt["hit.disk"] + bt["hit.wire"]
                   + bt["hit.cold"] + bt["miss"])

        def tier_rate(k: str) -> float:
            return round(bt[k] / t_total, 4) if t_total else 0.0

        report = {
            "serve_bench": "archive-day",
            "requests": args.requests,
            "sessions": args.sessions,
            "scans_per_session": args.distinct,
            "distinct": args.sessions * args.distinct * len(players),
            "clients": args.clients,
            "peers": args.peers,
            "replicas": args.replicas,
            "zipf_s": args.zipf_s,
            "seed": args.seed,
            "slo_ms": args.slo_ms,
            "clock_accel": round(accel, 1),
            "modeled_day_requests": int(args.requests * accel),
            "config": {"backend": backend, "nfft": args.nfft,
                       "peers": args.peers,
                       "deflate": bool(args.deflate),
                       "disk_bytes": args.disk_bytes},
            "binary": bin_rep,
            "legacy_json": json_rep,
            "ab": {
                "byte_identical": byte_identical,
                "addressing_byte_identical": addressing_ok,
                "wire_speedup": round(speedup, 4),
                "binary_wall_s": bin_rep["wall_s"],
                "json_wall_s": json_rep["wall_s"],
                "binary_wire_gbps": bin_rep["wire_gbps"],
                "json_wire_gbps": json_rep["wire_gbps"],
            },
            # The flat gate surface: bench-diff reads exactly these
            # (throughput/hit-rate/attainment band up,
            # latency-quantile band inverted).  tier_derive_rate is
            # report-only — a RISING derive rate is a regression, so
            # it must not ride the higher-is-better extractor.
            "metrics": {
                "fleet_hit_rate": bin_rep["hit_rate"],
                "fleet_wire_gbps": bin_rep["wire_gbps"],
                "wire_speedup": round(speedup, 4),
                "fleet_request_p50_s": bin_rep["request_p50_s"],
                "fleet_request_p99_s": bin_rep["request_p99_s"],
                "fleet_serialize_p99_s": bin_rep["serialize_p99_s"],
                "fleet_deserialize_p99_s":
                    bin_rep["deserialize_p99_s"],
                "catalog_lookup_p50_s":
                    bin_rep["catalog_lookup_p50_s"],
                "catalog_lookup_p99_s":
                    bin_rep["catalog_lookup_p99_s"],
                "tier_ram_hit_rate": tier_rate("hit.ram"),
                "tier_disk_hit_rate": tier_rate("hit.disk"),
                "tier_wire_hit_rate": tier_rate("hit.wire"),
                "tier_cold_hit_rate": tier_rate("hit.cold"),
                "tier_derive_rate": (round(bt["derive"] / t_total, 4)
                                     if t_total else 0.0),
                "slo_attained": bin_rep["slo_attained"],
            },
            "errors": (bin_rep["errors"] + json_rep["errors"])[:5],
        }
        if args.request_log:
            # The archive access log: door records carry the LOGICAL
            # (session, scan) address, so `requests --aggregate`
            # groups a day's traffic per scan.
            recs = monitor.read_requests(args.request_log)
            report["request_log"] = monitor.aggregate_requests(recs)
        out = json.dumps(report)
        print(out)
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                f.write(out + "\n")
            os.replace(tmp, args.out)
    if report["errors"]:
        return 1
    return 0 if (byte_identical and addressing_ok) else 1


def _cmd_ingest_bench(args: argparse.Namespace) -> int:
    """File→product throughput probe for the asynchronous output plane
: reduce a synthetic RAW recording to a real on-disk product
    and print the per-stage table — including the new ``readback`` and
    ``write`` stages — plus the overlap-efficiency gauge, optionally
    A/B'ing against the fully synchronous path (``--sync-compare``).
    This is the table an operator reads when a deployment's end-to-end
    rate collapses below the kernel rate (docs/WORKFLOWS.md "Diagnosing
    a slow link")."""
    import os
    import tempfile
    import time as _time

    from blit_torch.outplane import INGEST_HISTS

    from blit_torch.pipeline import RawReducer
    from blit_torch.testing import synth_raw

    def run(async_output: bool) -> dict:
        red = RawReducer(nfft=args.nfft, nint=args.nint,
                         chunk_frames=args.chunk_frames,
                         fqav_by=args.fqav, dtype=args.dtype,
                         nbits=args.nbits, quant_scale=args.quant_scale,
                         async_output=async_output, tune_online=False,
                         device=args.device)
        out = os.path.join(td, "bench_async.fil" if async_output
                           else "bench_sync.fil")
        t0 = _time.perf_counter()
        red.reduce_to_file(raw_path, out)
        wall = _time.perf_counter() - t0
        tl = red.timeline
        return {
            "async_output": async_output,
            "wall_s": round(wall, 3),
            "ingest_gbps": round(file_bytes / wall / 1e9, 3),
            "overlap_efficiency": round(tl.overlap_efficiency(), 3),
            "stages": {
                k: {"calls": v.calls, "s": round(v.seconds, 4),
                    "bytes": v.bytes}
                for k, v in sorted(list(tl.stages.items()))
            },
            # Stage TAILS from the telemetry hists:
            # readback lag / per-append write / per-chunk service
            # latency p50/p99 — the burst an average hides.
            "stage_quantiles": tl.hist_quantiles(INGEST_HISTS),
            # Per-chunk latency distributions (out.chunk_latency_s /
            # out.readback_lag_s): the tails behind the stage
            # sums above.
            "hists": tl.report().get("hists", {}),
            "product_bytes": os.path.getsize(out),
        }

    def run_dedoppler() -> dict:
        """The science leg: the same recording through the
        search plane — RAW → windowed spectra → on-device Taylor tree →
        ``.hits`` — reporting drift-rate trials/s alongside the ingest
        rate (a drift trial = one (drift row, channel) cell scored)."""
        from blit_torch.search import DedopplerReducer

        red = DedopplerReducer(
            nfft=args.nfft, nint=args.nint,
            chunk_frames=args.chunk_frames, dtype=args.dtype,
            window_spectra=args.dedoppler_window, snr_threshold=5.0,
            device=args.device,
        )
        out = os.path.join(td, "bench.hits")
        t0 = _time.perf_counter()
        hdr = red.search_to_file(raw_path, out)
        wall = _time.perf_counter() - t0
        T = hdr["search_window_spectra"]
        windows = hdr.get("search_windows", 0)
        trials = (2 * T - 1) * hdr["nchans"] * windows
        tl = red.timeline
        return {
            "windows": windows,
            "window_spectra": T,
            "hits": hdr.get("search_nhits"),
            "wall_s": round(wall, 3),
            "ingest_gbps": round(file_bytes / wall / 1e9, 4),
            "drift_rates_per_s": round(trials / wall, 1),
            "hists": tl.report().get("hists", {}),
            "product_bytes": os.path.getsize(out),
        }

    def run_live(drill: bool) -> dict:
        """The live leg: replay the recording through the
        streaming ingest plane at ``--live-rate`` × wall-clock recording
        rate and report p50/p99 chunk→product latency.  The recording is
        re-synthesized with TBIN stretched so it SPANS ``--live-seconds``
        of wall time — replay pacing is meaningless on a microsecond
        recording.  ``drill=True`` is the seeded late-chunk drill: one
        chunk held past a tightened lateness budget, proving the product
        masks (and flight-records) instead of wedging.

        With ``--packets`` the replay goes through the
        PACKET front end — the recording framed as datagrams, with the
        ``--packet-drop``/``--packet-reorder``/``--packet-dup``
        schedules applied — so the leg measures the sustained-capture
        contract: 1× for the whole session, back-pressure shedding as
        masked gaps (counted in the report), never a stall.  The stall
        watchdog is ARMED, so a completed leg IS the zero-stall proof
        (``stalls`` would have been a raised incident, not a number)."""
        from blit_torch.observability import Timeline
        from blit_torch.stream import (
            PacketReplaySource,
            ReplaySource,
            stream_reduce,
        )

        packets = bool(getattr(args, "packets", False))
        nblocks = max(4, args.blocks)
        ntime = (args.chunks * args.chunk_frames + 3) * args.nfft
        per_block = -(-ntime // nblocks)
        live_raw = os.path.join(td, "live.raw")
        synth_raw(live_raw, nblocks=nblocks, obsnchan=args.nchan,
                  ntime_per_block=per_block,
                  tbin=args.live_seconds / (nblocks * per_block))
        tl = Timeline()
        red = RawReducer(nfft=args.nfft, nint=args.nint,
                         chunk_frames=args.chunk_frames, fqav_by=args.fqav,
                         dtype=args.dtype, timeline=tl, tune_online=False,
                         device=args.device)
        lateness = None
        late = {}
        if drill:
            # Chunk 1 arrives well past a tightened budget: it must be
            # masked (zero weight) while the stream keeps flowing.
            lateness = 0.02 * args.live_seconds
            late = {1: 0.8 * args.live_seconds}
        if packets:
            src = PacketReplaySource(
                live_raw, rate=args.live_rate,
                packet_ntime=args.packet_ntime,
                drop=(args.packet_drop or None),
                reorder=args.packet_reorder, dup=args.packet_dup,
                seed=0, timeline=tl)
            # The sustained-capture leg must complete masked, not
            # wedged: a whole-stream lateness stall would hide behind
            # the default budget, so bound it by the recording span.
            lateness = lateness or 0.25 * args.live_seconds
        else:
            src = ReplaySource(live_raw, rate=args.live_rate, late=late)
        out = os.path.join(td, "live_drill.fil" if drill else "live.fil")
        t0 = _time.perf_counter()
        hdr = stream_reduce(src, out, reducer=red, lateness_s=lateness,
                            stall_timeout_s=max(5.0,
                                                2 * args.live_seconds))
        wall = _time.perf_counter() - t0
        lat = tl.report().get("hists", {}).get(
            "stream.chunk_to_product_s", {})
        leg = {
            "rate": args.live_rate,
            "recording_s": round(args.live_seconds, 3),
            "wall_s": round(wall, 3),
            "chunks": hdr["stream_chunks"],
            "chunk_to_product_p50_s": lat.get("p50"),
            "chunk_to_product_p99_s": lat.get("p99"),
            "late_chunks": hdr["stream_late_chunks"],
            "dup_chunks": hdr["stream_dup_chunks"],
            "masked_chunks": hdr["stream_masked_chunks"],
            # Output spectra whose PFB windows touched a zero-filled
            # sample — the clean path must report 0 here.
            "degraded_spectra": hdr["stream_degraded_spectra"],
            "product_bytes": os.path.getsize(out),
            # The armed watchdog raised on any stall, so reaching this
            # line proves zero.
            "stalls": 0,
        }
        if packets:
            leg["packet"] = src.packet_report()
        if hdr.get("stream_flight_dump"):
            leg["flight_dump"] = hdr["stream_flight_dump"]
        return leg

    def run_chaos() -> dict:
        """The recovery leg: a live consumer is SIGKILLed
        mid-session by a seeded ``stream.chunk:kill`` fault, the
        :class:`blit_torch.recover.StreamSupervisor` detects the death and
        restarts it with ``resume=True`` (StreamCursor rejoin), and the
        leg reports detection latency (``recover.detect_s``), recovery
        time (``recover.resume_s``), the frames the rejoin recomputed,
        and product byte-identity against the batch oracle."""
        from blit_torch.observability import Timeline
        from blit_torch.recover import StreamSupervisor
        from blit_torch.stream import StreamCursor

        nblocks = max(4, args.blocks)
        ntime = (args.chunks * args.chunk_frames + 3) * args.nfft
        chaos_raw = os.path.join(td, "chaos.raw")
        synth_raw(chaos_raw, nblocks=nblocks, obsnchan=args.nchan,
                  ntime_per_block=-(-ntime // nblocks))
        oracle = os.path.join(td, "chaos_oracle.fil")
        RawReducer(nfft=args.nfft, nint=args.nint,
                   chunk_frames=args.chunk_frames, fqav_by=args.fqav,
                   dtype=args.dtype, tune_online=False,
                   device=args.device).reduce_to_file(chaos_raw, oracle)
        out = os.path.join(td, "chaos.fil")
        tl = Timeline()
        sup = StreamSupervisor(
            chaos_raw, out, kind="reduce",
            knobs=dict(nfft=args.nfft, nint=args.nint,
                       chunk_frames=args.chunk_frames,
                       fqav_by=args.fqav, dtype=args.dtype,
                       tune_online=False),
            replay_rate=args.chaos_rate,
            faults=f"stream.chunk:kill:after={args.chaos_after}",
            lease_ttl_s=3.0, poll_s=0.05, timeline=tl,
            device=args.device,
        )
        import filecmp

        t0 = _time.perf_counter()
        rep = _chaos_run(sup)  # a failed drill becomes a failed LEG
        wall = _time.perf_counter() - t0
        try:
            identical = filecmp.cmp(out, oracle, shallow=False)
        except OSError:
            identical = False
        hists = tl.report().get("hists", {})
        cur = StreamCursor.load(out)  # removed on clean completion
        frames_claimed_at_crash = None
        for a in rep.get("attempts", []):
            if not a.get("ok", True):
                frames_claimed_at_crash = a.get("failure", {})
        return {
            "wall_s": round(wall, 3),
            "recovered": rep.get("recovered"),
            "attempts": len(rep.get("attempts", [])),
            "products_identical": identical,
            "cursor_removed": cur is None,
            "detect": hists.get("recover.detect_s", {}),
            "resume": hists.get("recover.resume_s", {}),
            "failure": frames_claimed_at_crash,
        }

    # --chunk-frames 0 (or negative) = auto: resolve from this rig's
    # tuning profile (blit_torch/tune.py) exactly as `reduce` would; the
    # probe's provenance is embedded in the report's ingest_config.
    if args.chunk_frames is not None and args.chunk_frames <= 0:
        args.chunk_frames = None
    # tune_online=False throughout the bench: a converged OnlineTuner
    # persisting mid-run (warmup is exactly its warmup window) would
    # reshape later legs' knobs AFTER this probe resolved the published
    # provenance — the A/B legs and ingest_config must describe ONE
    # knob set, like _cmd_tune's measured sweeps.
    probe = RawReducer(nfft=args.nfft, nint=args.nint,
                       chunk_frames=args.chunk_frames, fqav_by=args.fqav,
                       dtype=args.dtype, nbits=args.nbits,
                       tune_online=False, device=args.device)
    args.chunk_frames = probe.chunk_frames

    # Live monitoring: --monitor-spool / --monitor-port start
    # the process publisher, so `top` (or a curl at /metrics) can
    # watch this bench while it runs — the CI monitor smoke rides this.
    pub = _monitor_from_flags(args)

    with tempfile.TemporaryDirectory(prefix="blit-ingest-bench-") as td:
        raw_path = os.path.join(td, "bench.raw")
        # File length leaves exactly the (ntap-1)*nfft PFB tail after the
        # last chunk so no flush-shape recompile triggers (bench.py rule).
        ntime = (args.chunks * args.chunk_frames + 3) * args.nfft
        _, blocks = synth_raw(raw_path, nblocks=args.blocks,
                              obsnchan=args.nchan,
                              ntime_per_block=-(-ntime // args.blocks))
        file_bytes = sum(b.nbytes for b in blocks)
        if args.digests:
            # The integrity A/B: every leg then
            # ingests through per-block digest verification — the
            # reported rates must sit inside the bench-diff noise band
            # of an unarmed run.
            from blit_torch import integrity

            integrity.write_raw_digests(raw_path)
        # Untimed warmup: compile the channelizer (and fault the product
        # path's buffers) so the timed legs measure steady-state
        # streaming, not the one-off jit compile.
        RawReducer(nfft=args.nfft, nint=args.nint,
                   chunk_frames=args.chunk_frames, fqav_by=args.fqav,
                   dtype=args.dtype, nbits=args.nbits,
                   quant_scale=args.quant_scale,
                   tune_online=False, device=args.device).reduce_to_file(
            raw_path, os.path.join(td, "warmup.fil"))
        legs = [run(True)]
        if args.sync_compare:
            legs.append(run(False))
        report = {
            "file_bytes": file_bytes,
            # The knob set every leg ran, with tuning provenance.
            "ingest_config": {
                "nfft": args.nfft, "nint": args.nint, "nchan": args.nchan,
                "chunk_frames": args.chunk_frames,
                "prefetch_depth": probe.prefetch_depth,
                "out_depth": probe.out_depth, "dtype": args.dtype,
                "nbits": args.nbits, "digests": bool(args.digests),
                "tuning": probe.tuning_provenance(),
            },
            "legs": legs,
        }
        if args.dedoppler:
            report["dedoppler"] = run_dedoppler()
        if args.live:
            report["live"] = run_live(False)
        if args.live_drill:
            report["live_drill"] = run_live(True)
        if args.chaos:
            report["chaos"] = run_chaos()
        if len(legs) == 2 and legs[1]["wall_s"] > 0:
            from blit_torch.testing import sync_compare_verdict

            report.update(sync_compare_verdict(
                os.path.join(td, "bench_async.fil"),
                os.path.join(td, "bench_sync.fil"),
                async_wall_s=legs[0]["wall_s"],
                sync_wall_s=legs[1]["wall_s"]))
        if args.spans_compare:
            # Tracing-overhead A/B: interleave spans-on/spans-off legs so slow
            # drift doesn't masquerade as overhead, and compare the best
            # wall of each arm (min is the standard noise-floor estimator
            # for identical repeated work).
            from blit_torch import observability

            tr = observability.tracer()
            prev, walls = tr.enabled, {True: [], False: []}
            try:
                for _ in range(args.spans_reps):
                    for enabled in (True, False):
                        tr.enabled = enabled
                        walls[enabled].append(run(True)["wall_s"])
            finally:
                tr.enabled = prev
            on, off = min(walls[True]), min(walls[False])
            report["spans_on_s"] = on
            report["spans_off_s"] = off
            report["span_overhead"] = round(on / max(off, 1e-9) - 1.0, 4)
        if args.history_compare:
            # History+anomaly overhead A/B — the --spans-compare discipline: interleaved arms
            # so slow drift doesn't masquerade as overhead, best wall
            # per arm.  Each arm runs under a fast-ticking publisher;
            # the ON arm's publisher also feeds tiered rings and
            # scores anomaly baselines every tick.
            import shutil as _shutil

            from blit_torch import monitor as _mon
            from blit_torch.config import SiteConfig as _SC

            hist_td = os.path.join(td, "hist-ab")
            hwalls = {True: [], False: []}
            for _ in range(args.spans_reps):
                for enabled in (True, False):
                    if enabled:
                        _shutil.rmtree(hist_td, ignore_errors=True)
                        cfg = _SC(history_dir=hist_td,
                                  history_raw_s=0.5)
                    else:
                        cfg = _SC(history_anomaly=False)
                    p2 = _mon.MetricsPublisher(
                        interval_s=0.05, spool_dir="", port=-1,
                        config=cfg).start()
                    try:
                        hwalls[enabled].append(run(True)["wall_s"])
                    finally:
                        p2.close()
            hon, hoff = min(hwalls[True]), min(hwalls[False])
            report["history_on_s"] = hon
            report["history_off_s"] = hoff
            report["history_overhead"] = round(
                hon / max(hoff, 1e-9) - 1.0, 4)
        if pub is not None:
            pub.tick()  # a final sample so short benches always spool one
            report["monitor"] = {"port": pub.port,
                                 "spool": pub.spool_path,
                                 "samples": pub.seq}
            from blit_torch import monitor

            monitor.shutdown_publisher()
        print(json.dumps(report))
    return 0


def _chaos_corrupt(args: argparse.Namespace, work: str,
                   report: dict) -> int:
    """The ``chaos --fault corrupt`` leg:
    seeded in-flight corruption of one delivered RAW block under a
    digest sidecar.  The contract asserted end to end: the mismatch is
    DETECTED (``integrity.bad_block`` >= 1), the block is MASKED to
    zero weight (never garbage), and the product is byte-identical to
    an oracle reduction of the same recording with that block zeroed.

    Geometry note: blocks are sized so the whole drill fits one device
    chunk — every block then arrives as ONE delivery, so "delivery k"
    is "block k" and the zero-filled oracle is exact."""
    import filecmp
    import os

    import numpy as np

    from blit_torch import faults, integrity
    from blit_torch.io.guppi import GuppiRaw, write_raw
    from blit_torch.pipeline import RawReducer
    from blit_torch.testing import synth_raw

    nblocks = max(2, args.chunks)
    per_block = max(4, args.window_frames) * args.nfft
    victim = min(max(0, args.after), nblocks - 1)
    in_dir = os.path.join(work, "input")
    oracle_dir = os.path.join(work, "oracle_input")
    os.makedirs(in_dir, exist_ok=True)
    os.makedirs(oracle_dir, exist_ok=True)
    raw = os.path.join(in_dir, "chaos.raw")
    synth_raw(raw, nblocks=nblocks, obsnchan=args.nchan,
              ntime_per_block=per_block, seed=args.seed)
    # The zero-filled oracle: the SAME recording with the victim block
    # zeroed (same basename so derived headers cannot differ).
    rdr0 = GuppiRaw(raw, native=False)
    blocks = [np.array(rdr0.read_block(i)) for i in range(nblocks)]
    blocks[victim][:] = 0
    write_raw(os.path.join(oracle_dir, "chaos.raw"),
              dict(rdr0.header(0)), blocks)
    integrity.write_raw_digests(raw)
    # One chunk spans the whole recording: leave the (ntap-1)-frame PFB
    # tail after chunk_frames so every block lands as one delivery.
    cf = max(args.nint, (nblocks * per_block) // args.nfft - 3)
    kw = dict(nfft=args.nfft, nint=args.nint, chunk_frames=cf,
              tune_online=False, device=args.device)
    oracle = os.path.join(work, "oracle.fil")
    RawReducer(**kw).reduce_to_file(
        os.path.join(oracle_dir, "chaos.raw"), oracle)
    out = os.path.join(work, "chaos.fil")
    faults.reset_counters()
    faults.install(faults.FaultRule(point="guppi.read", mode="corrupt",
                                    after=victim, times=1))
    try:
        rdr = GuppiRaw(raw)  # arms the digest sidecar
        hdr = RawReducer(**kw).reduce_to_file(rdr, out)
    finally:
        faults.clear()
    counters = faults.counters()
    try:
        identical = filecmp.cmp(out, oracle, shallow=False)
    except OSError:
        identical = False
    bad_blocks = int(counters.get("integrity.bad_block", 0))
    report.update(
        recovered=bad_blocks >= 1,
        byte_identical=identical,
        victim_block=victim,
        masked_blocks=hdr.get("_masked_blocks", []),
        integrity={k: v for k, v in sorted(counters.items())
                   if k.startswith(("integrity.", "mask."))},
        work_dir=work,
    )
    body = json.dumps(report)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    return 0 if (identical and bad_blocks >= 1) else 1


def _chaos_fleet(args: argparse.Namespace, work: str, report: dict) -> int:
    """``chaos --fleet``: break a REAL
    multi-process serving fleet mid-replay and assert the front door's
    recovery contract end to end:

    - the failed peer (SIGKILL / SIGSTOP-wedge / SIGSTOP+SIGCONT
      partition) is DETECTED within the lease TTL and ejected,
    - its key range re-routes: every request completes,
    - every served product is BYTE-IDENTICAL to a single-process
      oracle reduction,
    - ``/healthz`` degrades honestly and (partition) recovers,
    - post-recovery hit-rate returns to within 10% of pre-kill.

    The victim is the OWNER of the hottest product — the worst case for
    the cache-warm replication story."""
    import math
    import os
    import random
    import signal
    import time as _time

    import numpy as np

    from blit_torch.observability import Timeline
    from blit_torch.serve import Overloaded, ProductRequest
    from blit_torch.serve.fleet import FleetError, FleetFrontDoor
    from blit_torch.serve.http import http_json
    from blit_torch.serve.scheduler import DeadlineExpired
    from blit_torch.testing import synth_raw

    rng = random.Random(args.seed)
    nfft = args.nfft
    distinct = max(2, args.fleet_distinct)
    total = max(30, args.fleet_requests)
    ntime = (8 + 3) * nfft
    reqs, oracle = [], {}
    for i in range(distinct):
        path = os.path.join(work, f"prod{i:02d}.raw")
        synth_raw(path, nblocks=1, obsnchan=2, ntime_per_block=ntime,
                  seed=args.seed + i)
        req = ProductRequest(raw=path, nfft=nfft, nint=1)
        reqs.append(req)
        # The single-process oracle: the same reduction, no fleet.
        _, data = req.reducer(args.device).reduce(path)
        oracle[i] = np.asarray(data)
    procs, peers, lease_dir = _spawn_fleet_peers(
        work, args.peers, device=args.device, concurrency=2, queue_depth=32,
        ram_bytes=64 << 20, beat_interval_s=min(0.2, args.lease_ttl / 5))
    tl = Timeline()
    door = FleetFrontDoor(
        peers, lease_dir=lease_dir, timeline=tl, replicas=args.replicas,
        peer_ttl_s=args.lease_ttl, poll_s=args.poll,
        health_poll_s=max(args.poll, 0.5),
        hedge_floor_s=0.05, request_timeout_s=10.0).start()

    fp0 = reqs[0].fingerprint()
    victim = door.ring.owners(fp0)[0]
    victim_proc = procs[int(victim.removeprefix("peer"))][0]
    weights = [1.0 / math.pow(k + 1, 1.2) for k in range(distinct)]
    picks = rng.choices(range(distinct), weights=weights, k=total)
    third = total // 3

    def cache_totals() -> dict:
        out = {}
        for name, url in peers.items():
            try:
                _, _, s = http_json("GET", url, "/stats", timeout=2.0)
            except OSError:
                continue
            c = s.get("cache") or {}
            out[name] = (c.get("hit.ram", 0) + c.get("hit.disk", 0),
                         c.get("miss", 0))
        return out

    def window_hit_rate(before: dict, after: dict):
        """Hit rate of the interval, over peers alive in BOTH samples
        (a SIGKILLed peer's counters vanish mid-drill)."""
        dh = dm = 0
        for name, (h1, m1) in after.items():
            if name not in before:
                continue
            h0, m0 = before[name]
            dh += max(0, h1 - h0)
            dm += max(0, m1 - m0)
        return (dh / (dh + dm)) if dh + dm else None

    failed: list = []
    diffs: list = []

    def run_slice(idxs) -> None:
        for k in idxs:
            for _attempt in range(8):
                try:
                    _, d = door.get(reqs[k], client="chaos")
                except Overloaded as e:
                    _time.sleep(min(0.25, e.retry_after_s))
                    continue
                except (FleetError, DeadlineExpired, OSError):
                    # Transient while the failure is being detected:
                    # back off a beat and retry — a real client's loop.
                    _time.sleep(0.2)
                    continue
                if not np.array_equal(np.asarray(d), oracle[k]):
                    diffs.append(k)
                failed_here = False
                break
            else:
                failed_here = True
            if failed_here:
                failed.append(k)

    try:
        run_slice(picks[:third])                     # warm the fleet
        marks = {"warm": cache_totals()}
        health_pre = door.health()
        run_slice(picks[third:2 * third])            # pre-kill window
        marks["pre_kill"] = cache_totals()
        hit_pre = window_hit_rate(marks["warm"], marks["pre_kill"])

        sig = (signal.SIGKILL if args.fault == "kill" else signal.SIGSTOP)
        t_kill = _time.monotonic()
        victim_proc.send_signal(sig)
        # Detection: the lease goes stale, the door ejects within the
        # TTL (+ the watch cadence), traffic re-routes to the replicas.
        detect_budget = args.lease_ttl * 3 + 5.0
        while victim in door.ring and \
                _time.monotonic() - t_kill < detect_budget:
            _time.sleep(args.poll / 2)
        detect_s = _time.monotonic() - t_kill
        detected = victim not in door.ring
        health_after = door.health()

        tail = picks[2 * third:]
        run_slice(tail[:len(tail) // 2])             # recovery window
        marks["recovering"] = cache_totals()
        run_slice(tail[len(tail) // 2:])             # recovered window
        marks["recovered"] = cache_totals()
        hit_post = window_hit_rate(marks["recovering"],
                                   marks["recovered"])

        rejoined = None
        if args.fault == "partition":
            victim_proc.send_signal(signal.SIGCONT)
            budget = _time.monotonic() + args.lease_ttl * 4 + 5.0
            while victim not in door.ring and _time.monotonic() < budget:
                _time.sleep(args.poll / 2)
            rejoined = victim in door.ring
        health_final = door.health()

        fstats = door.stats()
        hit_recovered = (hit_pre is not None and hit_post is not None
                         and hit_post >= hit_pre - 0.10)
        report.update(
            peers=args.peers,
            replicas=args.replicas,
            requests=total,
            distinct=distinct,
            victim=victim,
            detected=detected,
            detect_s=round(detect_s, 3),
            lease_ttl_s=args.lease_ttl,
            recovered=detected and not failed,
            byte_identical=not diffs,
            differing_products=diffs[:8],
            failed_requests=len(failed),
            hit_rate_pre_kill=(round(hit_pre, 4)
                               if hit_pre is not None else None),
            hit_rate_post_recovery=(round(hit_post, 4)
                                    if hit_post is not None else None),
            hit_rate_recovered=hit_recovered,
            rejoined=rejoined,
            healthz={
                "pre": health_pre["status"],
                "after_detect": health_after["status"],
                "final": health_final["status"],
                "final_reasons": health_final["reasons"],
            },
            counters=fstats["counters"],
            work_dir=work,
        )
    finally:
        door.close()
        # A SIGSTOPped victim cannot be reaped until it runs again.
        if args.fault in ("hang", "partition") and \
                victim_proc.poll() is None:
            try:
                victim_proc.send_signal(signal.SIGCONT)
            except OSError:
                pass
        _reap_fleet_peers(procs)

    ok = (report["recovered"] and report["byte_identical"]
          and report["hit_rate_recovered"]
          and report["healthz"]["after_detect"] == "degraded"
          and (rejoined is None or rejoined))
    report["ok"] = ok
    body = json.dumps(report)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    return 0 if ok else 1


def _chaos_fleet_resize(args: argparse.Namespace, work: str,
                        report: dict) -> int:
    """``chaos --fleet --fault resize``: SIGKILL a
    serving peer DURING the elastic warm handoff — the worst moment:
    the controller is mid-flip, the joiner is computing its incoming
    hot range, and a peer that was supposed to keep serving dies.
    Asserts the resize contract under fire:

    - the membership flip still COMPLETES (the standby is admitted;
      fail-open if the handoff deadline burns),
    - ``/healthz`` answers an honest ``"resizing"`` mid-flip,
    - the killed peer is detected within the lease TTL and ejected,
    - every request completes BYTE-IDENTICAL to a single-process
      oracle,
    - post-resize hit-rate is within 10% of pre-resize.

    The product set is EXTENDED until the joiner's incoming key range
    holds several hot products, so the handoff has real work to
    interrupt (otherwise the flip is sub-millisecond and the kill
    cannot land inside it)."""
    import math
    import os
    import random
    import signal
    import threading
    import time as _time

    import numpy as np

    from blit_torch.observability import Timeline
    from blit_torch.serve import Overloaded, ProductRequest
    from blit_torch.serve.elastic import FleetController
    from blit_torch.serve.fleet import FleetError, FleetFrontDoor
    from blit_torch.serve.http import http_json
    from blit_torch.serve.scheduler import DeadlineExpired
    from blit_torch.testing import synth_raw

    rng = random.Random(args.seed)
    nfft = args.nfft
    joiner = "standby0"
    total = max(30, args.fleet_requests)
    ntime = (8 + 3) * nfft
    reqs, oracle, fps = [], {}, []

    def add_product(i: int) -> None:
        path = os.path.join(work, f"prod{i:02d}.raw")
        synth_raw(path, nblocks=1, obsnchan=2, ntime_per_block=ntime,
                  seed=args.seed + i)
        req = ProductRequest(raw=path, nfft=nfft, nint=1)
        reqs.append(req)
        fps.append(req.fingerprint())
        # The single-process oracle: the same reduction, no fleet.
        _, data = req.reducer(args.device).reduce(path)
        oracle[i] = np.asarray(data)

    for i in range(max(2, args.fleet_distinct)):
        add_product(i)
    procs, peers, lease_dir = _spawn_fleet_peers(
        work, args.peers, device=args.device, concurrency=2, queue_depth=32,
        ram_bytes=64 << 20,
        beat_interval_s=min(0.2, args.lease_ttl / 5), standbys=1)
    tl = Timeline()
    door = FleetFrontDoor(
        {f"peer{i}": peers[f"peer{i}"] for i in range(args.peers)},
        lease_dir=lease_dir, timeline=tl, replicas=args.replicas,
        peer_ttl_s=args.lease_ttl, poll_s=args.poll,
        health_poll_s=max(args.poll, 0.5),
        hedge_floor_s=0.05, request_timeout_s=10.0).start()
    door.add_standby(joiner, peers[joiner], proc=args.peers)
    ctl = FleetController(door, None, hysteresis_s=0.0,
                          warm_timeout_s=30.0, min_peers=1,
                          warm_hints=64, timeline=tl)
    # Grow the mix until >= 3 products will MOVE to the joiner on
    # admit — the handoff then computes them on the cold joiner, a
    # window wide enough to kill a peer inside.
    while len(reqs) < 40 and \
            len(door.ring.incoming_keys(joiner, fps)) < 3:
        add_product(len(reqs))
    incoming = door.ring.incoming_keys(joiner, fps)

    victim = door.ring.owners(fps[0])[0]
    victim_proc = procs[int(victim.removeprefix("peer"))][0]
    weights = [1.0 / math.pow(k + 1, 1.2) for k in range(len(reqs))]
    picks = rng.choices(range(len(reqs)), weights=weights, k=total)
    third = total // 3

    def cache_totals() -> dict:
        out = {}
        for name, url in peers.items():
            try:
                _, _, s = http_json("GET", url, "/stats", timeout=2.0)
            except OSError:
                continue
            c = s.get("cache") or {}
            out[name] = (c.get("hit.ram", 0) + c.get("hit.disk", 0),
                         c.get("miss", 0))
        return out

    def window_hit_rate(before: dict, after: dict):
        dh = dm = 0
        for name, (h1, m1) in after.items():
            if name not in before:
                continue
            h0, m0 = before[name]
            dh += max(0, h1 - h0)
            dm += max(0, m1 - m0)
        return (dh / (dh + dm)) if dh + dm else None

    failed: list = []
    diffs: list = []

    def run_slice(idxs) -> None:
        for k in idxs:
            for _attempt in range(8):
                try:
                    _, d = door.get(reqs[k], client="chaos")
                except Overloaded as e:
                    _time.sleep(min(0.25, e.retry_after_s))
                    continue
                except (FleetError, DeadlineExpired, OSError):
                    _time.sleep(0.2)
                    continue
                if not np.array_equal(np.asarray(d), oracle[k]):
                    diffs.append(k)
                failed_here = False
                break
            else:
                failed_here = True
            if failed_here:
                failed.append(k)

    flip_completed = detected = False
    mid_handoff = False
    resizing_status = None
    detect_s = None
    hit_pre = hit_post = None
    out_rec: list = []
    try:
        # Warm every product once (so the door's hot map knows the
        # whole range), then the zipfian pre window.
        run_slice(list(range(len(reqs))) + picks[:third])
        marks = {"warm": cache_totals()}
        run_slice(picks[third:2 * third])
        marks["pre"] = cache_totals()
        hit_pre = window_hit_rate(marks["warm"], marks["pre"])
        health_pre = door.health()

        # The flip, in a thread — and the kill, INSIDE the handoff.
        t = threading.Thread(target=lambda: out_rec.append(
            ctl.scale_out(joiner)))
        t.start()
        gate = _time.monotonic() + 30.0
        while _time.monotonic() < gate:
            if door.resize_reason is not None:
                mid_handoff = True
                break
            _time.sleep(0.001)
        if mid_handoff:
            resizing_status = door.health()["status"]
        t_kill = _time.monotonic()
        victim_proc.send_signal(signal.SIGKILL)
        t.join(timeout=120.0)
        flip_completed = joiner in door.ring

        detect_budget = args.lease_ttl * 3 + 5.0
        while victim in door.ring and \
                _time.monotonic() - t_kill < detect_budget:
            _time.sleep(args.poll / 2)
        detect_s = _time.monotonic() - t_kill
        detected = victim not in door.ring

        tail = picks[2 * third:]
        run_slice(tail[:len(tail) // 2])             # recovery window
        marks["recovering"] = cache_totals()
        run_slice(tail[len(tail) // 2:])             # recovered window
        marks["recovered"] = cache_totals()
        hit_post = window_hit_rate(marks["recovering"],
                                   marks["recovered"])
        health_final = door.health()

        fstats = door.stats()
        hit_recovered = (hit_pre is not None and hit_post is not None
                         and hit_post >= hit_pre - 0.10)
        report.update(
            peers=args.peers,
            replicas=args.replicas,
            requests=total,
            distinct=len(reqs),
            joiner=joiner,
            joiner_incoming=len(incoming),
            victim=victim,
            killed_mid_handoff=mid_handoff,
            resizing_status=resizing_status,
            flip_completed=flip_completed,
            warm=(out_rec[0] if out_rec else None),
            detected=detected,
            detect_s=round(detect_s, 3),
            lease_ttl_s=args.lease_ttl,
            recovered=detected and not failed,
            byte_identical=not diffs,
            differing_products=diffs[:8],
            failed_requests=len(failed),
            hit_rate_pre_resize=(round(hit_pre, 4)
                                 if hit_pre is not None else None),
            hit_rate_post_resize=(round(hit_post, 4)
                                  if hit_post is not None else None),
            hit_rate_recovered=hit_recovered,
            healthz={
                "pre": health_pre["status"],
                "mid_flip": resizing_status,
                "final": health_final["status"],
                "final_reasons": health_final["reasons"],
            },
            counters=fstats["counters"],
            work_dir=work,
        )
    finally:
        ctl.close()
        door.close()
        _reap_fleet_peers(procs)

    ok = (flip_completed and mid_handoff
          and resizing_status == "resizing"
          and report.get("recovered", False)
          and report.get("byte_identical", False)
          and report.get("hit_rate_recovered", False))
    report["ok"] = ok
    body = json.dumps(report)
    print(body)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(body)
    return 0 if ok else 1


def _cmd_telemetry(args: argparse.Namespace) -> int:
    """Fleet telemetry report.  Three sources:
    ``--from`` renders a saved report JSON; ``--demo`` runs a real
    multi-worker ``reduce_to_file`` fan-out over synthetic recordings and
    harvests the pool (the end-to-end proof: every worker's stage table
    and fault counters in one per-host report, plus a Perfetto-loadable
    trace via ``--trace-out``); the default snapshots this process."""
    import json as _json

    from blit_torch import observability

    if args.watch is not None and not args.demo:
        # Poor-man's live mode: periodic re-harvest
        # + re-render on `top`'s refresh path (monitor.watch_loop —
        # same ANSI frame loop, same cadence semantics).
        from blit_torch import monitor

        def frame() -> str:
            if args.from_file:
                with open(args.from_file) as f:
                    rep = _json.load(f)
            else:
                rep = observability.local_fleet_report()
            if args.format == "prom":
                return observability.render_prometheus(rep)
            if args.format == "json":
                return _json.dumps(rep)
            return observability.render_fleet_text(rep)

        monitor.watch_loop(frame, args.watch, count=args.iterations)
        return 0
    if args.from_file:
        with open(args.from_file) as f:
            report = _json.load(f)
    elif args.demo:
        import os
        import tempfile

        from blit_torch import workers
        from blit_torch.parallel.pool import WorkerPool
        from blit_torch.testing import synth_raw

        n = max(1, args.workers)
        with tempfile.TemporaryDirectory(prefix="blit-telemetry-") as td:
            argtuples = []
            for i in range(n):
                raw = os.path.join(td, f"demo{i}.raw")
                synth_raw(raw, nblocks=1, obsnchan=2,
                          ntime_per_block=(8 + 3) * args.nfft, seed=i)
                argtuples.append((raw, os.path.join(td, f"demo{i}.fil")))
            with WorkerPool([f"w{i + 1}" for i in range(n)],
                            backend=args.backend) as pool:
                with observability.span("telemetry-demo", workers=n):
                    pool.run_on(list(range(1, n + 1)), workers.reduce_raw,
                                argtuples, kwargs={"nfft": args.nfft,
                                            "device": args.device})
                report = pool.harvest_telemetry()
    else:
        report = observability.local_fleet_report()
    if args.trace_out:
        # Works in every source mode: the tracer holds this process's
        # spans, the report carries any harvested (or saved) ones.
        observability.tracer().export_chrome(
            args.trace_out, extra=report.get("spans"))
        print(f"# trace written to {args.trace_out}", file=sys.stderr)
    if args.format == "prom":
        print(observability.render_prometheus(report), end="")
    elif args.format == "json":
        print(_json.dumps(report))
    else:
        print(observability.render_fleet_text(report))
    return 0


def _cmd_top(args: argparse.Namespace) -> int:
    """``top``: the live terminal dashboard.
    ``--spool DIR`` tails the per-process monitor spool (merging a pod's
    processes through ``merge_fleet``); ``--url`` polls one publisher's
    ``/snapshot`` endpoint.  Refreshes every ``--interval`` seconds with
    an ANSI clear; ``--once`` renders a single frame with no clear.
    ``--history DIR`` appends a sparkline panel per stored series from
    a durable history store."""
    from blit_torch import monitor, observability

    def fetch() -> str:
        if args.url:
            import urllib.request

            with urllib.request.urlopen(
                    args.url.rstrip("/") + "/snapshot", timeout=10) as r:
                sample = json.load(r)
            report = observability.merge_fleet([sample])
            samples = [sample]
        else:
            report, samples = monitor.merge_spool(args.spool)
        frame = monitor.render_top(report, samples)
        if args.history:
            from blit_torch.history import HistoryStore, render_history_panel

            store = HistoryStore(args.history, create=False)
            frame += "\n" + render_history_panel(
                store, buckets=args.history_buckets)
        return frame

    if args.once:
        print(fetch())
        return 0
    monitor.watch_loop(fetch, args.interval, count=args.iterations)
    return 0


def _cmd_bench_diff(args: argparse.Namespace) -> int:
    """``bench-diff``: the perf-regression
    gate.  Loads the fresh record and the baseline trajectory (explicit
    ``--baseline`` files and/or every ``BENCH_*.json`` under
    ``--baseline-dir``, the fresh file itself excluded), compares every
    shared higher-is-better metric against the trajectory's noise band,
    and exits 0 on pass / 2 on regress."""
    import os

    from blit_torch import monitor

    baselines = []
    if args.baseline_dir:
        import glob

        fresh_real = os.path.realpath(args.fresh)
        for p in sorted(glob.glob(
                os.path.join(args.baseline_dir, "BENCH_*.json"))):
            if os.path.realpath(p) == fresh_real:
                continue
            try:
                baselines.append(monitor.load_bench_json(p))
            except ValueError as e:
                # A failed round with no record line is part of history;
                # it thins the trajectory, it doesn't break the gate.
                print(f"# bench-diff: skipping {p}: {e}",
                      file=sys.stderr)
    for p in args.baseline or []:
        baselines.append(monitor.load_bench_json(p))
    if not baselines:
        raise SystemExit("bench-diff needs at least one baseline "
                         "(--baseline / --baseline-dir)")
    fresh = monitor.load_bench_json(args.fresh)
    metrics = args.metrics.split(",") if args.metrics else None
    verdict = monitor.bench_diff(fresh, baselines, rel_tol=args.noise,
                                 metrics=metrics,
                                 cross_rig=args.cross_rig)
    if args.json:
        print(json.dumps(verdict))
    else:
        print(monitor.render_bench_diff(verdict))
    return 0 if verdict["verdict"] == "pass" else 2


def _cmd_trace_view(args: argparse.Namespace) -> int:
    """Render a flight-recorder dump into an incident summary, or
    (``--fleet``) stitch span batches from many processes —
    monitor spools, saved snapshots, live ``/snapshot`` endpoints —
    into ONE trace view: a Perfetto export (``--out``), per-trace trees
    (``--trace``), and tail-bucket exemplar resolution
    (``--exemplar METRIC`` → the trace id behind the slowest bucket)."""
    import json as _json

    from blit_torch.observability import render_flight_dump

    if args.fleet:
        return _trace_view_fleet(args)
    if not args.dump:
        raise SystemExit("trace-view needs a flight dump path "
                         "(or --fleet SOURCES)")
    with open(args.dump) as f:
        doc = _json.load(f)
    print(render_flight_dump(doc, tail=args.events))
    if args.trace or args.exemplar or args.out:
        # A flight dump is itself a span batch: reuse the fleet path so
        # `trace-view dump.json --trace <id>` follows the dump's trace.
        args.fleet = [args.dump]
        return _trace_view_fleet(args)
    return 0


def _trace_view_fleet(args: argparse.Namespace) -> int:
    """The fleet half of ``trace-view``."""
    from blit_torch import monitor, observability

    spans, hists = monitor.gather_trace_sources(args.fleet)
    summary = observability.trace_summary(spans)
    out = {"sources": list(args.fleet), **summary}
    if args.out:
        tr = observability.Tracer(max_spans=max(len(spans), 1),
                                  enabled=True)
        tr.ingest(spans)
        tr.export_chrome(args.out)
        out["out"] = args.out
    exemplar_trace = None
    if args.exemplar:
        h = hists.get(args.exemplar)
        ex = h.tail_exemplar() if h is not None else None
        if ex is None:
            print(json.dumps(out))
            print(f"# no exemplar recorded for {args.exemplar!r} "
                  f"({len(hists)} histogram(s) in the sources)",
                  file=sys.stderr)
            return 1
        out["exemplar"] = {"metric": args.exemplar, **ex}
        exemplar_trace = ex["trace"]
    print(json.dumps(out))
    for trace_id in ([args.trace] if args.trace else []) + (
            [exemplar_trace] if exemplar_trace else []):
        print(observability.render_trace_tree(spans, trace_id))
    return 0


def _incident_dir(args: argparse.Namespace) -> str:
    from blit_torch.config import history_defaults

    d = args.dir or history_defaults()["incident_dir"]
    if not d:
        raise SystemExit("no incident dir: pass --dir or set "
                         "BLIT_INCIDENT_DIR")
    return d


def _cmd_incidents(args: argparse.Namespace) -> int:
    """``incidents``: list the self-contained forensics
    bundles under the incident dir, oldest first."""
    from blit_torch.history import list_incidents, render_incidents

    manifests = list_incidents(_incident_dir(args))
    if args.json:
        for m in manifests:
            print(json.dumps(m))
    else:
        print(render_incidents(manifests))
    return 0


def _cmd_incident(args: argparse.Namespace) -> int:
    """``incident show BUNDLE``: render one bundle's
    merged cross-source timeline — flight events, request records,
    trace spans and the triggering alert, wall-clock aligned via the
    stamped anchors.  ``--window`` narrows the timeline around the
    page using the shared grammar (``15m``, ``2h``, an epoch pair)."""
    import time

    from blit_torch.history import load_incident, render_incident, window_seconds

    bundle = load_incident(args.bundle)
    window = None
    if args.window:
        t = float((bundle.get("manifest") or {}).get("t", time.time()))
        half = window_seconds(args.window)
        window = (t - half, t + half / 4.0)
    if args.json:
        print(json.dumps(bundle))
    else:
        print(render_incident(bundle, window))
    return 0


def _cmd_slo_report(args: argparse.Namespace) -> int:
    """``slo-report``: attainment + error-budget spend
    per objective over day/week windows, straight from a durable
    history store — text for the operator, ``--json`` for CI (its
    ``metrics`` block rides ``bench_metrics``/``bench-diff``, so
    attainment gates like any bench scalar)."""
    from blit_torch.history import (
        HistoryStore,
        render_slo_report,
        slo_report,
        window_seconds,
    )

    store = HistoryStore(args.store, create=False)
    doc = slo_report(store, window_s=window_seconds(args.window))
    body = json.dumps(doc) if args.json else render_slo_report(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write((json.dumps(doc) if args.json else body) + "\n")
    print(body)
    return 0


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to compute on (default cuda; "
                             "cpu runs the plain PyTorch path)")


def _add_monitor_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--monitor-spool", default=None,
                        help="spool live telemetry samples (JSON lines) "
                             "into this dir")
    parser.add_argument("--monitor-port", type=int, default=None,
                        help="serve /metrics, /healthz and /snapshot on "
                             "this port while running (0 = ephemeral; "
                             "the chosen port prints to stderr)")
    parser.add_argument("--monitor-interval", type=float, default=0.25,
                        help="publisher snapshot cadence in seconds")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="blit_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("reduce", help="RAW → filterbank product")
    pr.add_argument("raw", nargs="+",
                    help="RAW file, .NNNN.raw sequence stem, or member list")
    pr.add_argument("-o", "--output", required=True,
                    help="output product path (.fil streams; .h5 = FBH5)")
    pr.add_argument("--product", choices=list(_PRODUCTS),
                    help="rawspec product preset (else --nfft/--nint)")
    pr.add_argument("--nfft", type=int, default=1024)
    pr.add_argument("--nint", type=int, default=1)
    pr.add_argument("--stokes", default="I")
    pr.add_argument("--fqav", type=int, default=1,
                    help="on-device frequency averaging factor")
    pr.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pr.add_argument("--compression", default=None,
                    choices=["gzip", "bitshuffle"],
                    help="codec for .h5 (FBH5) output")
    pr.add_argument("--resume", action="store_true",
                    help="crash-resumable streaming (cursor sidecar; "
                         ".fil and .h5)")
    _add_device(pr)
    pr.set_defaults(fn=_cmd_reduce)

    ph = sub.add_parser("search", help="RAW → .hits drift-rate search product")
    ph.add_argument("raw", nargs="+",
                    help="RAW file, .NNNN.raw sequence stem, or member list")
    ph.add_argument("-o", "--output", required=True,
                    help="output .hits product path (JSON lines)")
    ph.add_argument("--product", choices=list(_PRODUCTS),
                    help="rawspec product preset for the underlying "
                         "filterbank (else --nfft/--nint)")
    ph.add_argument("--nfft", type=int, default=1024)
    ph.add_argument("--nint", type=int, default=1)
    ph.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ph.add_argument("--window-spectra", type=int, default=None,
                    help="spectra per drift transform (power of two; "
                         "default SiteConfig/BLIT_SEARCH_WINDOW)")
    ph.add_argument("--snr", type=float, default=None,
                    help="SNR threshold (default SiteConfig/BLIT_SEARCH_SNR)")
    ph.add_argument("--top-k", type=int, default=None,
                    help="hits kept per band per window "
                         "(default SiteConfig/BLIT_SEARCH_TOP_K)")
    ph.add_argument("--max-drift-bins", type=int, default=None,
                    help="clamp the searched drift range (bins/window; "
                         "default the full ±(window-1))")
    ph.add_argument("--kernel", default="auto",
                    choices=["auto", "reference", "pallas"],
                    help="accepted for blit's command lines; the port's "
                         "paths agree bitwise and the device picks one")
    ph.add_argument("--interpret", action="store_true",
                    help="accepted for blit's command lines; no effect")
    ph.add_argument("--resume", action="store_true",
                    help="crash-resumable search (cursor sidecar; resumes "
                         "at the last durable window boundary)")
    _add_device(ph)
    ph.set_defaults(fn=_cmd_search)

    pl = sub.add_parser(
        "stream",
        help="live reduction: follow (or replay) a recording and write "
             "the product during the session")
    pl.add_argument("raw",
                    help="RAW file (or growing .NNNN.raw member) to "
                         "follow, or the completed recording to replay")
    pl.add_argument("-o", "--output", required=True,
                    help="product path: .fil / .h5, or .hits with --search")
    pl.add_argument("--product", choices=list(_PRODUCTS),
                    help="rawspec product preset (else --nfft/--nint)")
    pl.add_argument("--nfft", type=int, default=1024)
    pl.add_argument("--nint", type=int, default=1)
    pl.add_argument("--stokes", default="I")
    pl.add_argument("--fqav", type=int, default=1)
    pl.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pl.add_argument("--compression", default=None,
                    choices=["gzip", "bitshuffle"],
                    help="codec for .h5 (FBH5) output")
    pl.add_argument("--search", action="store_true",
                    help="write a .hits drift-search product instead of "
                         "a filterbank")
    pl.add_argument("--window-spectra", type=int, default=None,
                    help="search window (with --search; default "
                         "SiteConfig/BLIT_SEARCH_WINDOW)")
    pl.add_argument("--snr", type=float, default=None,
                    help="search SNR threshold (with --search)")
    pl.add_argument("--top-k", type=int, default=None,
                    help="hits kept per band per window (with --search)")
    pl.add_argument("--replay-rate", type=float, default=None,
                    help="replay a COMPLETED recording at this multiple "
                         "of its recording rate instead of tailing a "
                         "growing one (1.0 = real time)")
    pl.add_argument("--lateness", type=float, default=None,
                    help="watermark lateness budget in seconds (default "
                         "SiteConfig/BLIT_STREAM_LATENESS); chunks missing "
                         "past it are masked to zero weight")
    pl.add_argument("--poll", type=float, default=None,
                    help="growing-file poll cadence in seconds "
                         "(default SiteConfig/BLIT_STREAM_POLL)")
    pl.add_argument("--idle-timeout", type=float, default=None,
                    help="end the tail after this long without file "
                         "growth (default SiteConfig/"
                         "BLIT_STREAM_IDLE_TIMEOUT: wait forever)")
    pl.add_argument("--done-file", default=None,
                    help="end-of-session marker path (default <stem>.done)")
    pl.add_argument("--resume", action="store_true",
                    help="rejoinable consumer: a .stream-cursor sidecar "
                         "lets a restarted consumer re-attach mid-session, "
                         "byte-identical to one that never restarted")
    _add_monitor_flags(pl)
    _add_device(pl)
    pl.set_defaults(fn=_cmd_stream)

    pi = sub.add_parser("inventory", help="crawl a data tree")
    pi.add_argument("root")
    pi.add_argument("--file-re", default=None)
    pi.add_argument("--session-re", default=None)
    pi.add_argument("--extra", default=None)
    pi.add_argument("--sequences", action="store_true",
                    help="group .NNNN.raw members into scan sequences")
    pi.set_defaults(fn=_cmd_inventory)

    pf = sub.add_parser("info", help="print a file's normalized header")
    pf.add_argument("file")
    pf.set_defaults(fn=_cmd_info)

    pg = sub.add_parser(
        "ingest-bench",
        help="file→product throughput probe of the async output plane "
             "(per-stage readback/write table + overlap gauge)",
    )
    pg.add_argument("--nfft", type=int, default=1024)
    pg.add_argument("--nint", type=int, default=1)
    pg.add_argument("--nchan", type=int, default=4)
    pg.add_argument("--chunk-frames", type=int, default=8)
    pg.add_argument("--chunks", type=int, default=8,
                    help="device chunks in the synthetic recording")
    pg.add_argument("--blocks", type=int, default=4,
                    help="RAW blocks the recording is split into")
    pg.add_argument("--fqav", type=int, default=1,
                    help="on-device frequency averaging (shrinks the "
                         "product crossing the readback link)")
    pg.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pg.add_argument("--nbits", type=int, default=32, choices=[8, 16, 32],
                    help="SIGPROC product quantization: nbits<32 products "
                         "are narrowed ON DEVICE before D2H (4x/2x fewer "
                         "bytes across the readback link; byte-identical "
                         "to the sync path's host quantization)")
    pg.add_argument("--quant-scale", type=float, default=1.0,
                    help="affine quantize scale for --nbits 8/16")
    pg.add_argument("--digests", action="store_true",
                    help="arm a per-block digest sidecar on the "
                         "synthetic recording so every leg ingests "
                         "through integrity verification ("
                         "rates must stay inside the bench-diff noise "
                         "band of an unarmed run)")
    pg.add_argument("--sync-compare", action="store_true",
                    help="also run the fully synchronous output path and "
                         "report the async speedup")
    pg.add_argument("--spans-compare", action="store_true",
                    help="A/B the async leg with spans enabled vs disabled "
                         "and report the tracing overhead ratio")
    pg.add_argument("--spans-reps", type=int, default=3,
                    help="interleaved repetitions per spans-compare / "
                         "history-compare arm")
    pg.add_argument("--history-compare", action="store_true",
                    help="A/B the async leg under a fast-ticking "
                         "publisher with the history store + anomaly "
                         "baselines armed vs bare, and report the "
                         "history overhead ratio")
    pg.add_argument("--dedoppler", action="store_true",
                    help="also run the drift-search science leg over the "
                         "same recording and report drift-rate trials/s")
    pg.add_argument("--dedoppler-window", type=int, default=8,
                    help="search window (spectra per drift transform, "
                         "power of two) for the --dedoppler leg")
    pg.add_argument("--live", action="store_true",
                    help="also replay the recording through the "
                         "streaming ingest plane at --live-rate and "
                         "report p50/p99 chunk→product latency")
    pg.add_argument("--live-rate", type=float, default=1.0,
                    help="replay speed as a multiple of wall-clock "
                         "recording rate (1.0 = real time)")
    pg.add_argument("--live-seconds", type=float, default=0.5,
                    help="wall-clock span the live recording is "
                         "stretched to cover (TBIN-scaled)")
    pg.add_argument("--packets", action="store_true",
                    help="run the --live leg through the PACKET front "
                         "end: the recording framed as "
                         "datagrams via PacketReplaySource, gaps "
                         "masked not stalled; the leg reports the "
                         "packet gap/reorder/dup counters and block "
                         "assembly tails beside chunk→product latency")
    pg.add_argument("--packet-ntime", type=int, default=None,
                    help="time samples per DATA packet (default "
                         "SiteConfig/BLIT_PACKET_NTIME)")
    pg.add_argument("--packet-drop", type=float, default=0.0,
                    help="seeded fraction of DATA packets dropped in "
                         "the --packets leg (a partial block becomes a "
                         "masked gap)")
    pg.add_argument("--packet-reorder", type=float, default=0.0,
                    help="seeded fraction of DATA packets deferred out "
                         "of order in the --packets leg")
    pg.add_argument("--packet-dup", type=float, default=0.0,
                    help="seeded fraction of DATA packets duplicated "
                         "in the --packets leg")
    pg.add_argument("--live-drill", action="store_true",
                    help="also run the seeded late-chunk drill: one "
                         "chunk past a tightened lateness budget must "
                         "yield a masked (not wedged) product and a "
                         "flight-recorder dump")
    pg.add_argument("--chaos", action="store_true",
                    help="also run the recovery drill: "
                         "SIGKILL a supervised live consumer "
                         "mid-session, rejoin via the StreamCursor, "
                         "and report recover.detect_s / "
                         "recover.resume_s + byte-identity")
    pg.add_argument("--chaos-after", type=int, default=2,
                    help="kill the consumer after this many chunks")
    pg.add_argument("--chaos-rate", type=float, default=200.0,
                    help="chaos-leg replay speed multiple")
    _add_monitor_flags(pg)
    _add_device(pg)
    pg.set_defaults(fn=_cmd_ingest_bench)

    pn = sub.add_parser(
        "tune",
        help="autotune the ingest knobs on this rig and save the winner "
             "as its tuning profile")
    pn.add_argument("--raw", default=None,
                    help="tune against this recording instead of a "
                         "synthetic one")
    pn.add_argument("--nfft", type=int, default=1024)
    pn.add_argument("--nint", type=int, default=1)
    pn.add_argument("--nchan", type=int, default=4,
                    help="synthetic recording coarse channels")
    pn.add_argument("--chunk-frames", type=int, default=8,
                    help="sweep starting point (and synthetic sizing)")
    pn.add_argument("--chunks", type=int, default=8,
                    help="device chunks in the synthetic recording")
    pn.add_argument("--blocks", type=int, default=4,
                    help="RAW blocks the synthetic recording is split into")
    pn.add_argument("--fqav", type=int, default=1)
    pn.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pn.add_argument("--nbits", type=int, default=32, choices=[8, 16, 32])
    pn.add_argument("--trials", type=int, default=12,
                    help="measurement budget")
    pn.add_argument("--reps", type=int, default=1,
                    help="repetitions per measurement (best-of)")
    _add_device(pn)
    pn.set_defaults(fn=_cmd_tune)

    pb = sub.add_parser(
        "serve-bench",
        help="replay a zipfian request mix against a ProductService",
    )
    pb.add_argument("--requests", type=int, default=64,
                    help="total requests to replay")
    pb.add_argument("--distinct", type=int, default=8,
                    help="distinct products in the mix")
    pb.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads")
    pb.add_argument("--zipf-s", type=float, default=1.1,
                    help="zipf exponent of the popularity skew")
    pb.add_argument("--concurrency", type=int, default=2,
                    help="scheduler concurrency budget")
    pb.add_argument("--queue-depth", type=int, default=64,
                    help="bounded per-priority queue depth")
    pb.add_argument("--ram-bytes", type=int, default=64 << 20,
                    help="RAM cache tier byte budget")
    pb.add_argument("--disk-bytes", type=int, default=None,
                    help="per-peer HOT disk tier capacity "
                         "(--archive-day; a bound forces demotion "
                         "into each peer's cold tier)")
    pb.add_argument("--nfft", type=int, default=256)
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--disk-cache", action="store_true",
                    help="enable the disk cache tier (tempdir)")
    pb.add_argument("--fleet", action="store_true",
                    help="replay through a REAL multi-process fleet "
                         "front door: N fleet-peer "
                         "subprocesses behind consistent-hash routing")
    pb.add_argument("--peers", type=int, default=3,
                    help="fleet peer subprocess count (--fleet)")
    pb.add_argument("--replicas", type=int, default=2,
                    help="ring owner-set size R (--fleet)")
    pb.add_argument("--peer-ttl", type=float, default=3.0,
                    help="peer heartbeat-lease TTL seconds (--fleet)")
    pb.add_argument("--slo-ms", type=float, default=500.0,
                    help="SLO attainment target per request (--fleet)")
    pb.add_argument("--hedge-floor-ms", type=float, default=50.0,
                    help="hedge delay before the live p99 exists "
                         "(--fleet)")
    pb.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline_s propagated through "
                         "the fleet (--fleet)")
    pb.add_argument("--request-log", default=None, metavar="DIR",
                    help="per-request access records land here "
                         "(--fleet defaults to a temp spool "
                         "so the report's p50/p99 always come from the "
                         "records — point it somewhere to keep them)")
    pb.add_argument("--request-log-compare", action="store_true",
                    help="A/B the identical replay with request "
                         "logging off then on and report the overhead "
                         "(the --spans-compare discipline; non-fleet)")
    pb.add_argument("--trace-out", default=None, metavar="PATH",
                    help="with --fleet: stitch the peers' span batches "
                         "+ the door's into one Perfetto trace at PATH "
                         "(plus PATH.snapshot.json for trace-view "
                         "--fleet)")
    pb.add_argument("--archive-day", action="store_true",
                    help="replay a zipfian multi-session observing day "
                         "over REAL fleet-peer subprocesses, binary "
                         "wire vs legacy JSON A/B with a byte-identity "
                         "pin; emits a bench-diff-gateable "
                         "record")
    pb.add_argument("--sessions", type=int, default=4,
                    help="observing sessions in the day, each with "
                         "--distinct products (--archive-day)")
    pb.add_argument("--deflate", action="store_true",
                    help="advertise Accept-Encoding: deflate on the "
                         "binary pass (--archive-day)")
    pb.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report JSON here "
                         "(--archive-day / --diurnal; the CI artifact)")
    pb.add_argument("--diurnal", action="store_true",
                    help="day-shaped load at accelerated clock over a "
                         "REAL fleet + standbys with the ELASTIC "
                         "controller in the loop: peak "
                         "pages scale-out through a warm handoff, "
                         "trough idles into a drain + scale-in; the "
                         "report pins SLO attainment through the "
                         "resizes and the post-resize hit-rate bound")
    pb.add_argument("--cycles", type=int, default=3,
                    help="peak/trough cycles, i.e. scale-out/in pairs "
                         "(--diurnal)")
    pb.add_argument("--standbys", type=int, default=None,
                    help="standby fleet-peer subprocesses to pre-"
                         "register (--diurnal; default --cycles)")
    pb.add_argument("--idle-windows", type=int, default=3,
                    help="consecutive idle controller ticks before "
                         "scale-in (--diurnal)")
    pb.add_argument("--hysteresis", type=float, default=2.0,
                    help="flap-guard cooldown seconds after any resize "
                         "(--diurnal)")
    pb.add_argument("--warm-timeout", type=float, default=60.0,
                    help="warm-handoff ack deadline seconds — the "
                         "joiner's first XLA compile happens inside it "
                         "(--diurnal)")
    pb.add_argument("--burn-threshold-ms", type=float, default=250.0,
                    help="per-request latency SLO the burn-rate "
                         "evaluator pages on (--diurnal)")
    pb.add_argument("--slo-floor", type=float, default=0.5,
                    help="minimum end-to-end SLO attainment the "
                         "diurnal leg must hold through the resizes")
    _add_device(pb)
    pb.set_defaults(fn=_cmd_serve_bench)

    pv = sub.add_parser(
        "session",
        help="run (or rejoin) a whole live session from a spec file: one "
             "supervised stream consumer a recorder seat")
    pv.add_argument("spec", help="session spec JSON: {\"seats\": [{name, "
                                 "out, source, knobs...}], ...}")
    pv.add_argument("--work-dir", default=None,
                    help="lease/spec scratch dir (default: the spec's "
                         "work_dir, else a fresh temp dir); re-use it to "
                         "rejoin after a crash")
    pv.add_argument("--lease-ttl", type=float, default=None,
                    help="per-seat heartbeat lease TTL in seconds")
    pv.add_argument("--poll", type=float, default=None,
                    help="seat supervisor watch cadence")
    pv.add_argument("--attempts", type=int, default=None,
                    help="per-seat recovery attempt budget")
    pv.add_argument("--json-out", default=None,
                    help="also write the session report JSON here")
    _add_monitor_flags(pv)
    _add_device(pv)
    pv.set_defaults(fn=_cmd_session)

    ps = sub.add_parser(
        "scan", help="whole (session, scan) → per-band products via the mesh")
    ps.add_argument("root", help="data tree root (as `inventory`)")
    ps.add_argument("session", help="e.g. AGBT22B_999_01")
    ps.add_argument("scan", help="4-digit scan number, e.g. 0011")
    ps.add_argument("-o", "--output-dir", required=True)
    ps.add_argument("--file-re", default=None,
                    help=r"inventory filename filter (default \.raw$)")
    ps.add_argument("--nfft", type=int, default=1024)
    ps.add_argument("--nint", type=int, default=1)
    ps.add_argument("--stokes", default="I")
    ps.add_argument("--fqav", type=int, default=1,
                    help="per-player frequency averaging before the stitch")
    ps.add_argument("--no-despike", action="store_true")
    ps.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ps.add_argument("--window-frames", type=int, default=None,
                    help="PFB frames a window (bounds device memory, host "
                         "memory and readback; default max(8, 2^23/nfft))")
    ps.add_argument("--max-frames", type=int, default=None)
    ps.add_argument("--trace-logdir", default=None,
                    help="write a torch.profiler Chrome trace of the scan "
                         "(CUDA kernels included on the card) here")
    ps.add_argument("--compression", default=None,
                    choices=["gzip", "bitshuffle"],
                    help="write .h5 (FBH5) band products with this codec")
    ps.add_argument("--resume", action="store_true",
                    help="crash-resumable streaming (a cursor sidecar a band)")
    par = ps.add_mutually_exclusive_group()
    par.add_argument("--sharded", action="store_true",
                     help="the threaded sharded plane (default: SiteConfig / "
                          "BLIT_MESH_SHARDED)")
    par.add_argument("--pool", action="store_true",
                     help="the pool path: a reducer a player and a host "
                          "stitch, the mesh paths' byte-identity oracle")
    ps.add_argument("--search", action="store_true",
                    help="write a .hits drift-search product a player")
    ps.add_argument("--window-spectra", type=int, default=None)
    ps.add_argument("--snr", type=float, default=None)
    ps.add_argument("--top-k", type=int, default=None)
    ps.add_argument("--max-drift-bins", type=int, default=None)
    ps.add_argument("--kernel", default="auto",
                    choices=["auto", "reference", "pallas"],
                    help="accepted for blit's command lines; the port's "
                         "search has one route")
    ps.add_argument("--interpret", action="store_true",
                    help="accepted for blit's command lines; no effect")
    _add_device(ps)
    ps.set_defaults(fn=_cmd_scan)

    pc = sub.add_parser(
        "chaos",
        help="run a seeded kill/hang schedule against a supervised scan or "
             "live stream and check recovery with identical bytes")
    pc.add_argument("--workload", default="scan",
                    choices=["scan", "scan-search", "stream"])
    pc.add_argument("--fault", default="kill",
                    choices=["kill", "hang", "corrupt", "partition",
                             "resize", "reorder"],
                    help="kill / hang the victim at the point; corrupt: a "
                         "bit-flipped delivered RAW frame under a digest "
                         "sidecar must be masked, not propagated; "
                         "partition (--fleet only): SIGSTOP then SIGCONT, "
                         "the peer must be ejected and rejoin; resize "
                         "(--fleet only): SIGKILL a serving peer during "
                         "the elastic warm handoff, the flip must still "
                         "complete with identical answers; reorder "
                         "(stream only) holds packets back at packet.recv")
    pc.add_argument("--fleet", action="store_true",
                    help="break a serving fleet instead: SIGKILL / SIGSTOP "
                         "a real fleet-peer subprocess mid-replay and check "
                         "detection within the lease TTL, re-routing, "
                         "identical bytes against a one-process oracle and "
                         "the hit rate's recovery")
    pc.add_argument("--peers", type=int, default=3,
                    help="fleet peer subprocess count (--fleet)")
    pc.add_argument("--replicas", type=int, default=2,
                    help="ring owner-set size R (--fleet)")
    pc.add_argument("--fleet-requests", type=int, default=150,
                    help="zipfian requests replayed across the drill "
                         "(--fleet)")
    pc.add_argument("--fleet-distinct", type=int, default=6,
                    help="distinct products in the fleet mix (--fleet)")
    pc.add_argument("--after", type=int, default=2,
                    help="fire after this many windows/chunks")
    pc.add_argument("--hang-s", type=float, default=60.0,
                    help="hang duration (must exceed --lease-ttl)")
    pc.add_argument("--point", default=None,
                    help="injection point (default mesh.window for scans, "
                         "stream.chunk for streams)")
    pc.add_argument("--victim", type=int, default=0,
                    help="pod process the schedule targets (scan modes)")
    pc.add_argument("--procs", type=int, default=2,
                    help="pod size of the first scan attempt")
    pc.add_argument("--devices-per-proc", type=int, default=None,
                    help="players a host seats (default: the mesh share, so "
                         "losing a host forces the pool path; the whole mesh "
                         "re-plans onto a smaller pod)")
    pc.add_argument("--nband", type=int, default=2)
    pc.add_argument("--nbank", type=int, default=2)
    pc.add_argument("--nchan", type=int, default=2)
    pc.add_argument("--nfft", type=int, default=32)
    pc.add_argument("--nint", type=int, default=1)
    pc.add_argument("--window-frames", type=int, default=4)
    pc.add_argument("--window-spectra", type=int, default=4,
                    help="search window (scan-search workload)")
    pc.add_argument("--chunks", type=int, default=6,
                    help="windows/chunks the synthetic recordings span")
    pc.add_argument("--replay-rate", type=float, default=200.0,
                    help="stream workload replay speed")
    pc.add_argument("--packets", action="store_true",
                    help="feed the stream workload through the packet front "
                         "end with a seeded whole-block drop")
    pc.add_argument("--packet-ntime", type=int, default=64)
    pc.add_argument("--lease-ttl", type=float, default=3.0,
                    help="heartbeat lease TTL (the detection budget)")
    pc.add_argument("--poll", type=float, default=0.1,
                    help="supervisor watch cadence")
    pc.add_argument("--attempts", type=int, default=3)
    pc.add_argument("--seed", type=int, default=0)
    pc.add_argument("--work-dir", default=None)
    pc.add_argument("--json-out", default=None)
    _add_device(pc)
    pc.set_defaults(fn=_cmd_chaos)

    pfp = sub.add_parser(
        "fleet-peer",
        help="run ONE serving peer of the fleet: a ProductService "
             "over HTTP with lease heartbeats; SIGTERM drains "
             "gracefully",
    )
    pfp.add_argument("--name", default="peer")
    pfp.add_argument("--port", type=int, default=0,
                     help="bind port (0 = ephemeral; see --port-file)")
    pfp.add_argument("--host", default="127.0.0.1",
                     help="bind address (default loopback; a multi-host "
                          "fleet binds 0.0.0.0, or this host's fabric "
                          "address, which is then advertised in .url)")
    pfp.add_argument("--port-file", default=None,
                     help="publish the bound port here (atomic write) "
                          "so a spawner can find an ephemeral bind")
    pfp.add_argument("--cache-dir", default=None,
                     help="disk cache tier root (None = RAM-only)")
    pfp.add_argument("--lease-dir", default=None,
                     help="shared heartbeat-lease dir the front door "
                          "watches")
    pfp.add_argument("--proc", type=int, default=0,
                     help="this peer's lease proc index")
    pfp.add_argument("--ram-bytes", type=int, default=256 << 20)
    pfp.add_argument("--concurrency", type=int, default=2)
    pfp.add_argument("--queue-depth", type=int, default=64)
    pfp.add_argument("--retry-seed", type=int, default=None,
                     help="seed the jittered Retry-After spread")
    pfp.add_argument("--beat-interval", type=float, default=0.5,
                     help="lease heartbeat cadence (keep well under "
                          "the fleet's peer TTL)")
    pfp.add_argument("--drain-timeout", type=float, default=30.0)
    pfp.add_argument("--catalog-root", default=None,
                     help="archive tree to catalog: serves "
                          "kind='catalog' asks and resolves "
                          "session=/scan= logical addressing locally")
    pfp.add_argument("--cold-dir", default=None,
                     help="cold storage tier root: disk evictees "
                          "demote here; cold hits are CRC-verified and "
                          "promoted back")
    pfp.add_argument("--disk-bytes", type=int, default=None,
                     help="hot disk tier capacity (None = unbounded; "
                          "a bound is what forces demotion)")
    pfp.add_argument("--standby", action="store_true",
                     help="run as an elastic STANDBY: process up and "
                          "lease beating but NOT in the ring — the "
                          "front door's controller admits it after a "
                          "warm handoff when the SLO pages")
    _add_device(pfp)
    pfp.set_defaults(fn=_cmd_fleet_peer)

    pk = sub.add_parser(
        "fsck",
        help="verify an archive tree (manifests + cache content "
             "digests), quarantining corruption; exit 1 when any is "
             "found",
    )
    pk.add_argument("root", help="tree to walk: product dirs and/or a "
                                 "serve disk-cache dir")
    pk.add_argument("--repair", action="store_true",
                    help="re-derive quarantined cache entries from "
                         "their recorded recipes (the serve layer's "
                         "miss path, on --device) and retire "
                         "quarantined corpses superseded by a verified "
                         "replacement")
    pk.add_argument("--no-quarantine", action="store_true",
                    help="report only; leave corrupt artifacts in "
                         "place (default: move them to a .quarantine/ "
                         "sibling so they stop being served/resumed)")
    pk.add_argument("--cold-dir", default=None,
                    help="ALSO walk this cold storage tier: cold "
                         "entries share the hot tier's sidecar "
                         "convention, so quarantine and --repair "
                         "re-derivation apply unchanged")
    pk.add_argument("--json-out", default=None,
                    help="also write the fsck report JSON here")
    _add_device(pk)
    pk.set_defaults(fn=_cmd_fsck)

    pbf = sub.add_parser(
        "backfill",
        help="derive+publish every product of an archive root into a "
             "hot(+cold) cache — resumable (fsync-per-line ledger), "
             "budget-paced",
    )
    pbf.add_argument("root", help="archive tree to walk (the catalog "
                                  "crawl's session/GUPPI layout)")
    pbf.add_argument("--cache-dir", required=True,
                     help="hot disk cache tier to publish into")
    pbf.add_argument("--cold-dir", default=None,
                     help="cold tier behind the hot cache (evictees "
                          "demote here)")
    pbf.add_argument("--ledger", default=None,
                     help="completion ledger path (default: "
                          "<cache-dir>/backfill.ledger.jsonl)")
    pbf.add_argument("--product", default=None,
                     help="rawspec preset (0000/0001/0002); otherwise "
                          "--nfft/--nint configure the reduction")
    pbf.add_argument("--nfft", type=int, default=1024)
    pbf.add_argument("--nint", type=int, default=1)
    pbf.add_argument("--ram-bytes", type=int, default=64 << 20)
    pbf.add_argument("--disk-bytes", type=int, default=None,
                     help="hot tier capacity (a bound forces demotion "
                          "into --cold-dir)")
    pbf.add_argument("--bytes-per-s", type=float, default=None,
                     help="pacing budget over input bytes (the "
                          "Scrubber debt discipline; 0 = unpaced; "
                          "default SiteConfig.backfill_bytes_per_s)")
    pbf.add_argument("--limit", type=int, default=None,
                     help="stop after this many products (CI drills)")
    pbf.add_argument("--json-out", default=None,
                     help="also write the backfill report JSON here")
    _add_device(pbf)
    pbf.set_defaults(fn=_cmd_backfill)

    pt = sub.add_parser(
        "telemetry",
        help="fleet telemetry report (harvest / render / demo run)",
    )
    pt.add_argument("--from", dest="from_file", default=None,
                    help="render a saved fleet report JSON instead of "
                         "harvesting")
    pt.add_argument("--demo", action="store_true",
                    help="run a multi-worker reduce_to_file fan-out over "
                         "synthetic recordings and harvest the pool")
    pt.add_argument("--workers", type=int, default=2,
                    help="demo pool size")
    pt.add_argument("--backend", default="thread",
                    choices=["local", "thread", "process"],
                    help="demo pool backend")
    pt.add_argument("--nfft", type=int, default=256)
    pt.add_argument("--trace-out", default=None,
                    help="also export the run's spans as Chrome-trace-"
                         "event JSON (Perfetto-loadable)")
    pt.add_argument("--format", default="text",
                    choices=["text", "prom", "json"],
                    help="report rendering: human text, Prometheus "
                         "exposition, or raw JSON")
    pt.add_argument("--watch", type=float, default=None, metavar="N",
                    help="re-harvest and re-render every N seconds "
                         "(`top`'s refresh loop; Ctrl-C to stop)")
    pt.add_argument("--iterations", type=int, default=None,
                    help="with --watch: stop after this many frames "
                         "(tests/scripts; default: until interrupted)")
    _add_device(pt)
    pt.set_defaults(fn=_cmd_telemetry)

    po = sub.add_parser(
        "top",
        help="live terminal dashboard over a monitor spool dir or a "
             "publisher endpoint",
    )
    src = po.add_mutually_exclusive_group(required=True)
    src.add_argument("--spool",
                     help="monitor spool dir to tail (one JSONL file "
                          "per process; merged into one fleet view)")
    src.add_argument("--url",
                     help="publisher base URL to poll "
                          "(e.g. http://127.0.0.1:8080)")
    po.add_argument("--interval", type=float, default=1.0,
                    help="refresh cadence in seconds")
    po.add_argument("--once", action="store_true",
                    help="render one frame (no ANSI clear) and exit")
    po.add_argument("--iterations", type=int, default=None,
                    help="stop after this many frames (tests/scripts)")
    po.add_argument("--history", default=None, metavar="DIR",
                    help="append per-series sparklines from this "
                         "durable history store (BLIT_HISTORY_DIR)")
    po.add_argument("--history-buckets", type=int, default=32,
                    help="how many finest-tier buckets each sparkline "
                         "spans")
    po.set_defaults(fn=_cmd_top)

    pd = sub.add_parser(
        "bench-diff",
        help="compare a fresh bench.py / ingest-bench JSON against the "
             "checked-in BENCH_*.json trajectory (exit 2 on regress)",
    )
    pd.add_argument("fresh",
                    help="fresh bench record (plain JSON or a "
                         "BENCH_*.json wrapper)")
    pd.add_argument("--baseline", action="append", default=[],
                    help="baseline record (repeatable)")
    pd.add_argument("--baseline-dir", default=None,
                    help="load every BENCH_*.json here as the baseline "
                         "trajectory (the fresh file itself excluded)")
    pd.add_argument("--noise", type=float, default=0.35,
                    help="relative noise band around the trajectory's "
                         "[min, max] envelope (0.35 = ±35%%)")
    pd.add_argument("--metrics", default=None,
                    help="comma-separated metric filter (default: every "
                         "shared metric)")
    pd.add_argument("--cross-rig", action="store_true",
                    help="compare against baselines from OTHER rigs "
                         "(config.backend) too — default: same-rig only")
    pd.add_argument("--json", action="store_true",
                    help="print the verdict as JSON instead of a table")
    pd.set_defaults(fn=_cmd_bench_diff)

    pv = sub.add_parser(
        "trace-view",
        help="render a flight-recorder dump into an incident summary, "
             "or stitch a fleet's span batches into one trace "
             "(--fleet)",
    )
    pv.add_argument("dump", nargs="?", default=None,
                    help="flight-recorder JSON "
                         "(blit-flight-<host>-<pid>-<t>-<n>.json)")
    pv.add_argument("--events", type=int, default=40,
                    help="how many trailing ring events to show")
    pv.add_argument("--fleet", nargs="+", default=None, metavar="SRC",
                    help="stitch spans from these sources into one "
                         "trace view: monitor spool dirs / .jsonl "
                         "files, saved *.snapshot.json batches, flight "
                         "dumps, or live http://host:port /snapshot "
                         "endpoints")
    pv.add_argument("--out", default=None,
                    help="write the stitched spans as Chrome-trace-"
                         "event JSON (Perfetto-loadable)")
    pv.add_argument("--trace", default=None, metavar="ID",
                    help="print one trace's span tree")
    pv.add_argument("--exemplar", default=None, metavar="METRIC",
                    help="resolve METRIC's tail-bucket exemplar to its "
                         "trace id (and print that trace's tree when "
                         "the spans are in the sources)")
    pv.set_defaults(fn=_cmd_trace_view)

    pq = sub.add_parser(
        "requests",
        help="tail / filter / aggregate a per-request access-record "
             "spool (BLIT_REQUEST_LOG)",
    )
    pq.add_argument("spool",
                    help="request-log spool dir (requests-*.jsonl) or "
                         "one log file")
    pq.add_argument("--tail", type=int, default=None,
                    help="keep only the newest N records")
    pq.add_argument("--slow-ms", type=float, default=None,
                    help="keep records at least this slow")
    pq.add_argument("--status", default=None,
                    help="keep one status (ok/overloaded/deadline/"
                         "timeout/error, or an HTTP code like 503)")
    pq.add_argument("--client", default=None,
                    help="keep one client's records")
    pq.add_argument("--role", default=None,
                    choices=["door", "peer", "serve"],
                    help="keep one component role's records")
    pq.add_argument("--since", default=None, metavar="WHEN",
                    help="keep records at/after WHEN — an epoch, "
                         "'15m'/'2h'/'1d'-style ago-windows, or 'now'")
    pq.add_argument("--until", default=None, metavar="WHEN",
                    help="keep records at/before WHEN (same grammar)")
    pq.add_argument("--aggregate", action="store_true",
                    help="print one summary (counts by status/tier, "
                         "p50/p99, slowest records w/ trace ids) "
                         "instead of the record table")
    pq.add_argument("--json", action="store_true",
                    help="machine output: one JSON record per line "
                         "(or the compact aggregate)")
    pq.set_defaults(fn=_cmd_requests)

    pin = sub.add_parser(
        "incidents",
        help="list the self-contained incident bundles under the "
             "incident dir (BLIT_INCIDENT_DIR)",
    )
    pin.add_argument("--dir", default=None,
                     help="incident bundle dir (default: "
                          "BLIT_INCIDENT_DIR)")
    pin.add_argument("--json", action="store_true",
                     help="one manifest JSON per line")
    pin.set_defaults(fn=_cmd_incidents)

    pic = sub.add_parser(
        "incident",
        help="render one incident bundle's merged cross-source "
             "timeline",
    )
    pic.add_argument("action", choices=["show"],
                     help="'show': render the bundle")
    pic.add_argument("bundle",
                     help="bundle directory (from `incidents`)")
    pic.add_argument("--window", default=None, metavar="SPAN",
                     help="narrow the timeline to SPAN around the page "
                          "('15m', '2h', '1d' — the shared window "
                          "grammar)")
    pic.add_argument("--json", action="store_true",
                     help="dump the loaded bundle as one JSON doc")
    pic.set_defaults(fn=_cmd_incident)

    psr = sub.add_parser(
        "slo-report",
        help="attainment + error-budget spend per objective over "
             "day/week windows from a durable history store "
             "(--json rides bench-diff)",
    )
    psr.add_argument("store",
                     help="history store dir (BLIT_HISTORY_DIR)")
    psr.add_argument("--window", default="1d",
                     help="report window: '1d', '1w', seconds, ... "
                          "(the shared window grammar; default 1d)")
    psr.add_argument("--json", action="store_true",
                     help="machine output (the 'metrics' block carries "
                          "slo.<name>_attained for bench-diff gating)")
    psr.add_argument("--out", default=None,
                     help="also write the report to this file "
                          "(CI artifact)")
    psr.set_defaults(fn=_cmd_slo_report)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
