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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
