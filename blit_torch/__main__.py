"""Command line: ``python -m blit_torch <command>``.

Counterpart of ``python -m blit`` for the commands whose modules the port
has, each with ``blit``'s flags and its one JSON line on stdout:

  reduce     GUPPI RAW (a file, a ``.NNNN.raw`` stem or a member list)
             to a filterbank product (``.fil``; ``.h5`` = FBH5).
  search     GUPPI RAW to a ``.hits`` drift-search product.
  stream     Live reduction: follow a RAW file the recorder is still
             appending to (or replay a completed one with
             ``--replay-rate``) and write the ``.fil`` / ``.h5`` (or,
             with ``--search``, ``.hits``) product during the session,
             with p50/p99 chunk-to-product latency in the report.
  inventory  Crawl a data tree and print its records as JSON lines.
  info       Print the normalized header of a ``.fil`` / ``.h5`` /
             ``.raw`` file.
  tune       Sweep the ingest knobs with timed reductions on this rig and
             save the winner as its tuning profile (``BLIT_TUNE_DIR``),
             which reducers with unset knobs then load.
  scan       A whole (session, scan) of a data tree → one product a band
             (or, with ``--search``, a ``.hits`` a player) over the
             ``(band, bank)`` mesh: the sharded plane (``--sharded``),
             the mesh loop, or the pool path (``--pool``), every player
             seated on ``--device``.
  session    Run (or rejoin) a whole live session from a spec file: one
             supervised stream consumer a recorder seat.
  chaos      Run a seeded kill/hang schedule against a supervised scan
             (``--workload scan`` / ``scan-search``) or a live consumer
             (``stream``) and check recovery with identical bytes (exit
             0 only then).
  fleet-peer One serving peer of the fleet: a ``ProductService`` on
             ``--device`` behind the HTTP wire, beating a heartbeat
             lease; SIGTERM drains it.
  fsck       Verify a tree's product manifests and serve-cache entries,
             quarantine what fails (exit 1), ``--repair`` re-derives
             quarantined cache entries on ``--device``.
  backfill   Derive and publish every product of an archive tree into a
             hot (and cold) cache, resumable through a ledger.
  requests   Tail, filter and aggregate a per-request access-record
             spool.

One flag is the port's own: ``--device`` (default ``cuda``) on the
commands that compute; ``--device cpu`` runs the plain PyTorch path.
With the default and no GPU the command raises.  ``search``'s
``--kernel`` / ``--interpret`` are accepted for ``blit``'s command lines
and change nothing: the port's paths agree bitwise.  ``blit``'s other
commands are not registered; ROADMAP.md (Queue 1) names the item that
brings each one.
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
    from blit_torch.observability import Timeline
    from blit_torch.parallel.scan import (
        reduce_scan_mesh_to_files,
        reduce_scan_pool_to_files,
    )

    if args.trace_logdir is not None:
        raise SystemExit("--trace-logdir (profile_trace) is not in the port "
                         "yet (ROADMAP.md Queue 1 item 8)")
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
                **depths)
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
        written = reduce_scan_pool_to_files(args.session, args.scan, **kw)
    elif sharded:
        from blit_torch.parallel.sharded import reduce_scan_sharded_to_files

        written = reduce_scan_sharded_to_files(args.session, args.scan,
                                               resume=args.resume, **depths,
                                               **kw)
    else:
        written = reduce_scan_mesh_to_files(args.session, args.scan,
                                            resume=args.resume, **kw)
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
    if args.fault == "reorder" and args.workload != "stream":
        print("--fault reorder requires --workload stream (wire reordering "
              "is a packet front-end failure shape)", file=sys.stderr)
        return 2
    use_packets = args.workload == "stream" and (
        args.packets or args.fault == "reorder")
    point = args.point or ("packet.recv" if args.fault == "reorder"
                           else "stream.chunk" if args.workload == "stream"
                           else "mesh.window")
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
                    help="not in the port yet (ROADMAP.md Queue 1 item 8)")
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
    pc.add_argument("--fault", default="kill", choices=["kill", "hang", "reorder"],
                    help="kill / hang the victim at the point; reorder "
                         "(stream only) holds packets back at packet.recv")
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
