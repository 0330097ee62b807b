#!/usr/bin/env python3
"""Smoke run of blit_torch on one CUDA GPU: builds the Hopper kernels,
holds each against its plain PyTorch twin at the main paths' shapes,
then reduces a 64-channel GUPPI RAW recording to rawspec's three
products (``0000``: nfft 2^20; ``0002``: nfft 1024, nint 2048;
``0001``: nfft 8, nint 128), searches it for drifting tones
(``.hits`` at nfft 1024 and at nfft 2^20), channelizes one chunk at
nfft 2^21 and one at nfft 6144, drives channelize's opt-in routes
(detect_kernel="pallas", dft_order="twisted", one-pol input,
fft_method="direct"), recovers injected ±20-bin drifts, and turns 64
per-antenna recordings into tied-array beam power and FX visibilities
at the array scale, all through the kernels, serves products through
the serve plane (ProductService, fleet peers, fsck, the catalog), then
drives the reference's own API (inventory, the reduce_raw fan-out over a worker
pool, load_scan, get_data / get_kurtosis, remote agents) over one band
of eight banks, drives the live plane (streams from a replay, a growing
file and packets, a rejoin, the metrics publisher) and the command
line, drives the (band, bank) mesh (the sharded plane, pods of
processes, the array plane over players) and the recovery plane (kill
and hang drills, a supervised live consumer, a session), and checks the
results.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  (a) device: name and power limit;
  (b) build: the nine sources (ten kernels: pfb_dft1, tail2_detect,
      pfb_dequant, dft_stage + dft_last in dft.cu, dft_tail2,
      taylor_tree, fused_beamform_detect in beamform_detect.cu,
      xengine_packed in xengine.cu, detect_untwist_i in
      detect_untwist.cu) with nvcc for sm_90a, started together, timed;
  (c) kernels vs twins at the main paths' chunk shapes, elementwise
      (bf16 outputs also in relative rms against a control that skips
      the bf16 rounding; pfb_dft1 and tail2_detect, FFTs that cannot
      round their DFT matrices to bf16 as the twins do, against the
      twins' arithmetic at the kernels' rounding points, their distance
      from the twins recorded beside), with CUDA-event times (median of 7 runs after
      a warm-up), the least time the card could take for the function
      (bound_ms: the larger of its bytes over HBM's rate and its
      operations, a DFT counted as an FFT's 5·log2(n) flops per output,
      over the f32 peak), the same bound for the dense products the
      kernels compute (contract_ms) and, where one PyTorch call computes
      the same function, its time: pfb_dft1 and tail2_detect at the 0000
      chunk (64 coarse channels, nfft 2^20, 4 frames), pfb_dft1 also at
      the 6144 chunk (n1 = 64, m = 96, 1024 frames); pfb_dequant at the
      0002 (2048 frames of 1024) and 0001 (2^17 frames of 8) chunks;
      dft_last at n = 1024 and n = 8 on those chunks' PFB output, each
      beside the dense tiled GEMM (tiled=True, the first port's design:
      tiled_ms) and, at n = 8, the FFT the row kernel stands in for;
      dft_tail2 in (e), dft_stage and dft_last in (f), dft_last in (m)
      and (l) at their paths' shapes;
  (d) main paths: a synthetic 2.95 GB RAW file (128 MiB blocks, a tone
      at 0.375 of one coarse channel, on the fine grid of all three
      products) → reducer_for_product(p).reduce_to_file(.fil) on the GPU
      for p = "0000" (chunk_frames 4), "0002" (its default 2048 frames:
      5 chunks of 537 MB) and "0001" (chunk_frames 2^17: 11 chunks of
      268 MB); for each, the launch counts are set to 0 just before and
      read just after; checks the kernel plan, the launches, the header
      bytes, shape and nsamps, the tone's fine channel, and the first two
      chunks against the plan run through the plain twins (the second
      starts from the PFB state carried across); prints stage seconds,
      RAW GB/s and the real-time factor against one bank's 0.75 GB/s;
  (e) the 2^21 path (128·128·128): dft_tail2 against its twin on the
      path's stage-1 spectra, then channelize on 64 coarse channels × one
      chunk of 4 frames (int8 made on the card from a seeded generator):
      pfb_dft1, dft_tail2 (levels 2 and 3, inner untwist), the level-0
      swap and torch detect, as blit runs it; then dft_tail2 at 2^20's
      (128, 64) on (c)'s stage-1 spectra, against its twin and timed,
      and dft_stage down route (a) 2^20's (128, 64) panels of the same
      rows, as in (f).  Device memory: 3.8 GB of
      voltages; 8.6 GB each for the stage-1 spectra, the dft_tail2 output
      and the swapped spectra, of which two live at once: ~25 GB at the
      peak of the 80 GB card (the dft_tail2 check before it, with the
      twin's four products, ~50 GB).  The first 4 channels are compared
      with the twins;
  (f) the 6144 path (64·96): dft_stage (64 points, twiddle; the column
      FFT dft_stage_design picks, timed beside the dense tiled GEMM,
      tiled_ms, and the complex torch.matmul of W and the panels) on
      pfb_dequant's frames, as route (b) runs it, and dft_last (96 points,
      also timed beside the tiled GEMM) on its output; then channelize on
      64 coarse channels × 1024 frames: pfb_dft1 (n1 = 64), dft_last, the
      swap and torch detect; all 64 channels compared with the twins
      (~30 GB at the peak); then dft_stage_design's sweep: both designs
      (the column FFT, the tiled GEMM) at 38 panel sizes n ≤ 1383 and m
      96 and 1024, f32 and bf16, each held to dft_stage's bound against
      the plain version and timed, beside the design picked;
  (m) run after (f), once its tensors are freed: the opt-in routes.
      detect_untwist_i against detect_untwist_i_plain on twisted spectra
      of the 0000 chunk's shape (64, 2, 4, 2^20), factors (128, 128, 64),
      f32 and bf16 input (rtol 1e-6, atol 1e-5 of the input's mean
      square: the same squares and adds in the same order), CUDA-event
      medians of 7 runs for both, the byte bound, no library call;
      route (a), channelize(detect_kernel="pallas", tail_kernel="xla")
      at 2^20 on (c)'s chunk: pfb_dft1, dft_stage + dft_last in twisted
      order, detect_untwist_i, held against the twins on 4 channels and
      against the default plan's (tail2_detect) output, and timed beside
      it (medians of 7 channelize calls); the dft_tail2 route,
      channelize(tail_kernel="pallas", detect_kernel="xla") at 2^20 on the
      same chunk (pfb_dft1, dft_tail2 at f3 = 64, torch detect), the same
      way; dft_last at route (a) 2^13's n = 64 (64 × 2 × 64 × 128 rows)
      beside the tiled GEMM; route (a) at 2^13 (two factors,
      mid = 1; 64 frames) against the twins and the default plan; route
      (b), dft_order="twisted" on (f)'s chunk (pfb_dequant, the twisted
      DFT, detect, the untwist of the power) against the twins on 4
      channels and the natural route; route (c), one-pol input (64
      channels, nfft 1024, 1024 frames: the FIR in torch ops, dft_last)
      against the twins; route (d), fft_method="direct" on the same
      chunk (torch.fft), against (c)'s output.
  (g) run after (c): taylor_tree against taylor_tree_plain on the card,
      BITWISE (torch.equal), one sign and both signs (drift_spectra, one
      launch per stage for both), at (64, 65536) (the default window over
      64 channels × nfft 1024), (8, 2^26) (the hi-res window of (i)),
      (16, 2^26), (1024, 65536) (the largest window, on the route with
      global passes) and one odd F on each route; CUDA-event medians of
      7 runs after a warm-up for the kernel and the plain version, and
      the bound: bytes (input read once, output written once) over HBM's
      rate; no PyTorch call computes the function (library "none");
  (h) inside (d)'s try, on its recording: DedopplerReducer(nfft=1024,
      nint=1) at search_defaults() (window 64, top_k 8, SNR 10)
      .search_to_file(.hits): 175 windows of (64, 65536) through
      pfb_dequant + dft_last + taylor_tree, launches counted as (d)
      counts; checks the plan, taylor_tree launches = launches per
      window × windows, the .hits header line byte for byte, the tone as
      every window's top hit (drift 0, its fine channel, its band), and
      the first two windows' hits against the same spectra run through
      channelize_twins and the plain tree on the CPU (identical cells in
      order, SNR and power within rtol 1e-4); prints stage seconds, the
      per-window device time, a CUDA-event breakdown of one window
      (H2D, tree, SNR + top-k, D2H), windows/s, RAW GB/s and the
      real-time factor;
  (i) the hi-res search: DedopplerReducer(nfft=2^20, window_spectra=8,
      chunk_frames=4) on the same recording: one (8, 2^26) window, 64
      bands, through pfb_dft1 + tail2_detect + taylor_tree; the tone is
      the top hit; peak device memory and seconds;
  (j) drift recovery: two small recordings (synth_raw, 64 channels, two
      windows of 64 spectra at nfft 1024, a tone in coarse channel 10
      drifting by tone_drift_for(1024, 64, ±20)); in both windows the
      top hit is in the tone's band at a drift within 1 of ±20.
  (k) beamform, after (f): 64 RAW files (synth_raw, 64 channels, 32768
      samples, a tone in channel a % 64: 537 MB), delay weights for 64
      beams as bench.py makes them; the one-shot path
      (load_antennas(layout="chan") + beamform(layout="chan"), 8192
      samples, nint 8) must take the fused CUDA kernel, once, and agree
      with the plain version (rtol 1e-4, atol 1e-3 of the peak and of the
      median power); the kernel against its plain version in f32 and
      bf16 (bf16 also in relative rms against the f32 weights), timed
      with the matmul route beside it (no single PyTorch call computes
      the function); beamform_stream over 4 windows of 8192 (4 launches)
      bitwise equal (torch.equal) to the one-shot beamform on the span;
      beamform_accumulate over the same feed (nint 8192: the matmul
      route) within rtol 1e-4 of the one-shot power summed; stage
      seconds and RAW GB/s;
  (l) correlator: 64 RAW files (16 channels, 64·512 samples: 134 MB);
      load_correlator + correlate(vis_layout="packed") at nfft 512, ntap
      4 must take the CUDA X-engine and one dft_last launch, and agree
      with the plain route (F-engine DFT through dft_last's twin,
      xengine_packed_plain; rtol 1e-4, atol 1e-3 of the noise rms);
      dft_last at n = 512 on the F-engine's FIR output against its twin,
      beside the tiled GEMM and torch.fft.fft;
      xengine_packed against its plain version at (64, 16, 2, 61, 512)
      in f32 (three tf32 passes) and bf16 (atol 1e-3 of the spectra's
      mean square), the mirrored half bitwise the conjugate transpose
      (vr == vr.mT, vi == -vi.mT), timed beside the batched complex64
      torch.matmul of the packed spectra;
      correlate_stream over windows of 15 frames (5 windows, 5 launches
      of each) bitwise equal to correlate(acc_frames=15); stage seconds
      and RAW GB/s.
  (n) the asynchronous ingest and output plane, on (d)'s recording before
      it is deleted and on (k)'s and (l)'s array recordings: each product
      through reduce_to_file on the asynchronous plane (the default, which
      (d), (h) and (i) also take) and with async_output=False, in turns,
      three times: the .fil files byte-identical and the launches equal; 0002
      at nbits=8 (quant_scale mapping the f32 product's median to 100,
      quant_offset 3) async against sync, byte-identical, and bitwise the
      host narrowing of the f32 product; narrow_device on the card against
      narrow_host at nbits 8 and 16; the search (h) async against sync,
      three times, the .hits identical; beamform_stream and
      correlate_stream with prefetch_depth 1 (the synchronous feed), 2 and
      3, in turns, three times, each bitwise equal to the one-shot form,
      the launches equal.  For each run: RAW GB/s, the stage table
      (ingest, state, dispatch, device, readback, write, stream),
      overlap_efficiency and the host staging allocations (pinned;
      seconds, count, GB); then one "plane table" line per path and mode:
      the RAW GB/s median and range, the median stage seconds and
      overlap efficiency, the allocations summed.
  (o) after (n), on (d)'s recording, each product deleted after its
      check: (o1) 0000 through reduce_resumable, interrupted by a
      FaultRule("sink.write", after=1) once the first chunk's slab is
      written, the .cursor sidecar checked, then resumed: the .fil
      byte-identical to (d)'s uninterrupted product, the cursor gone, the
      manifest passing verify_product; the frames the resume re-reduced
      and each leg's seconds; (o2) the recording's blocks copied into a
      three-member .NNNN.raw scan, every member on the native reader
      (blit_torch/native/guppi.cc, built with g++), 0002 over the scan
      byte-identical to (d)'s single-file product, and again under a
      transient guppi.read fault (fail once; the product unchanged,
      retry.io at least 1); (o3) 0002 with native=True and native=False,
      in turns, three runs each, RAW GB/s and ingest seconds per run and
      a table; (o4) when h5py imports (else one line naming what is
      missing): 0000 to .h5 uncompressed, and with bitshuffle when the
      codec builds (chunks of one 0000 chunk, plus an interrupted and
      resumed ResumableFBH5Writer run), each decoding bitwise to (o1)'s
      .fil payload; (o5) the search (h) through search_resumable,
      interrupted after 20 windows and resumed, the .hits byte-identical
      to (h)'s search_to_file.  Launches are counted for each leg.
  (p) last, in a directory of its own: the reference's own API
      (blit_torch.gbt) over session AGBT22B_999_01, scan 0011, band 0:
      banks 0-7 (BLP00..BLP07, hosts blc00..blc07) at the GBT widths
      (64 coarse channels, OBSBW -187.5 MHz, OBSFREQ descending by bank
      so the banks tile the band), each a 2-member .NNNN.raw sequence of
      2 blocks of 2^17 samples (32 MiB blocks, 128 MiB a bank, 1 GiB the
      band: the depth is cut to 2^19 samples a channel), a tone at 0.375
      of coarse channel k in bank k.  setup_workers(thread, 8 hosts) →
      get_inventories → raw_sequences (8 sequences of 2); the reduce_raw
      fan-out, bank k on worker k+1, at nfft 1024 and nint 16 (0002's
      width, nint cut from 2048): every product byte-identical to a
      serial RawReducer(nfft=1024, nint=16).reduce_to_file outside the
      pool, each tone in its fine channel, pfb_dequant and dft_last
      counted as the path "gbt" and equal to the serial runs' counts
      exactly; the fan-out again, warm, timed beside
      the serial runs and byte-identical too; load_scan of the 8
      products: the band
      (nspectra, 1, 524288), bank-ascending, fch1 and nchans right, equal
      to the stitched products despiked at nfpc 1024 (band[..., 512::1024]
      == band[..., 511::1024]), and again at fqav_by 8, both timed;
      get_data with idxs and an np.max fqav_func, and
      get_kurtosis(device=True) against device=False (rtol 2e-3, atol
      2e-3), over the 8 products; search_raw through the pool on bank 0
      (nfft 1024, nint 1), the .hits byte-identical to a direct
      DedopplerReducer.search_to_file, its taylor_tree launches added to
      "gbt"; a remote pool of 2 agents (python -m blit_torch.agent) that
      report their card, reduce banks 0 and 1 byte-identical to the
      thread pool's products and return the same get_data slab, each
      agent's reduce_raw span parented onto the pool's dispatch span.  Prints
      the fan-out and serial walls with the aggregate RAW GB/s, the
      load_scan seconds, the kurtosis maps' ms and the agents' spawn
      seconds, each beside the card's name and power limit.
  (q) after (n), before (o), on (d)'s recording: the live plane.  (q1)
      the 0000 product through stream_reduce from a ReplaySource at the
      rate that delivers a bank's 0.75 GB/s (1.0: the recording is
      critically sampled), then unthrottled: each .fil byte-identical to
      (d)'s, pfb_dft1 and tail2_detect launched as often as in (d),
      0 masked chunks; with BLIT_MONITOR_SPOOL set for the paced run,
      the publisher's spool holds samples whose dev.hbm_in_use_bytes
      (torch.cuda.memory_stats) is above 0 (q7); (q2) 0002 through a
      FileTailSource following a file a thread grows block by block at
      0.75 GB/s, byte-identical to (d)'s; (q3) 0002 from a
      PacketReplaySource with every packet of block 5 dropped, equal to
      the batch reduction of the recording with that block zero-filled,
      masking it, and differing from (d)'s product only in the rows the
      block's samples reach (degraded_rows counts them); (q4) 0000
      through stream_reduce(resume=True) stopped by a sink.write fault,
      then rejoined, byte-identical to (d)'s; (q5) the search (h) through
      stream_search, the .hits byte-identical; each leg's wall, RAW
      GB/s, p50/p99 stream.chunk_to_product_s and peak
      stream.watermark_lag_s in a "live table"; (q6) python -m
      blit_torch as subprocesses with BLIT_TUNE_DIR in the run's temp
      dir: tune (3 trials on the recording, nfft 1024, nint 2048), reduce
      --product 0002 (the profile's key in the provenance, the card's
      name in its rig identity), stream --replay-rate (the same bytes as
      reduce) and info.
  (r) the (band, bank) mesh and the recovery plane, in three places:
      after (q), on (d)'s recording: (r2) 0000 on a (1, 2) mesh (both
      players on the card), bank 0 (d)'s recording and bank 1 a second
      of the same length, contiguous below it, with its tone in another
      coarse channel: reduce_scan_sharded_to_files byte-identical to
      reduce_scan_pool_to_files (pfb_dft1 + tail2_detect counted as the
      path "mesh 0000"); (r6) StreamSupervisor on an unthrottled 0002
      replay of the recording, its child killed after the second chunk,
      rejoined, byte-identical to (d)'s 0002.  After (n)'s array runs,
      on (k)'s and (l)'s recordings: (r4) beamform with the antenna axis
      over 8 players of a (1, 8) mesh (the matmul route, then the psum)
      and over 1 (the fused kernel, bitwise the one-card call), both
      against the one-card port (rtol 1e-4, atol 1e-3 of the peak);
      correlate on a (2, 4) mesh, packed (the X-engine kernel on each of
      8 players), against the plain route summed over the two band
      segments (atol 1e-4 of the peak); an AntennaStream over the mesh
      with on_antenna_error="mask" and one antenna's file cut after it
      opened: the power finite, the antenna in the header's
      _masked_antennas from the first short window on.  Last, over
      (p)'s band tree written anew: (r1) a single-process (1, 8) mesh,
      8 players on the card, windows of MESH_WINDOW_FRAMES frames, each
      a probe: the sharded plane, the pool path and the mesh loop
      byte-identical, mesh.gather_s p50/p99 and mesh.gather_ici_bytes
      printed; load_scan_mesh (despiked) equal to gbt.load_scan over
      serial products of the same dispatch shape; (r3)
      search_scan_sharded_to_files, every player's .hits equal to a
      direct DedopplerReducer search; (r5) three pods at once, children
      `python -m blit_torch.recover` on cuda:0: banks 0-3 and 4-7 as a
      (2, 4) grid over 2 gloo processes, the (1, 8) grid over 2 gloo
      processes with the band row split (the stitch through pinned host
      memory), and the (1, 8) grid as a 1-process NCCL pod, each
      byte-identical to the pool oracle; (r6) ScanSupervisor on the
      (2, 4) grid with mesh.window:kill:after=1 in process 1 (re-planned
      onto a 1-process pod that resumes the cursors), then a hang in
      process 0 (detected by the lease, re-planned onto the pool path),
      recover.detect_s / resume_s printed, products byte-identical; and
      python -m blit_torch scan (--sharded), chaos --workload scan and
      session (2 replay seats, one killed) as subprocesses at once.
  (s) the serve plane, in two places.  After (r2), on (d)'s recording
      and products: (s1) a ProductService on the card (RAM tier of
      6 GiB) serves ProductRequest(raw, product="0000") at full width,
      byte-equal to reducer_for_product("0000").reduce on the card, then
      a RAM hit with zero launches; with the cache cleared, 8 identical
      asks at once run one reduction (scheduled 1, coalesced 7, the
      launches of one reduction); an in-process PeerServer answers the
      binary wire twice (the second a wire hit: zero launches, its GB/s
      printed); (s2) a kind="hits" ask at search_defaults() equal to
      (h)'s .hits (hits_from_array) and to the direct reduction's bytes;
      (s3) two `python -m blit_torch fleet-peer --device cuda` processes
      (RAM tier, heartbeat leases, request logs), started together,
      behind this process's FleetFrontDoor on the binary wire: 0002,
      0001 and hits asks byte-equal to direct reductions (run on a
      thread meanwhile), each repeat from the owner's RAM or wire tier;
      the owner of 0002 SIGKILLed, ejected by its lease, 0002 re-routed
      byte-identically; the other SIGTERMed, draining to exit 0;
      `python -m blit_torch requests` over the logs lists every ask;
      (s4) `python -m blit_torch fsck` over copies of (d)'s 0002 and
      0001 products with their manifests: exit 0, then, one byte
      flipped, exit 1 naming the product and quarantining it; when h5py
      imports (else one line naming what is missing), the disk and cold
      tiers, the scrubber and fsck --repair.  After (r), over (p)'s band
      tree: (s5) a fleet-peer with --catalog-root serves a (session,
      scan, band, bank) ask byte-equal to the explicit-path ask and the
      direct reduction (and, with h5py, backfill of two players).  Every
      cache asserts publish.error == 0.  Prints each ask's cold and hot
      wall, the coalesced and scheduled counts, the peers' spawn
      seconds, detect and re-route seconds after the kill, and phase
      (s)'s seconds, beside the card's name and power limit.
(e), (f) and (m) count launches as (d) does, for each path, and hold
the output to rtol 1e-4 and an atol of 1e-3 of the mean bin; (k) and (l)
count them for each path the same way.  The line before the last two is
one JSON object listing the ten kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

NCHAN = 64               # coarse channels per bank
NFFT = 1 << 20           # the 0000 product
NTAP = 4
CHUNK_FRAMES = 4
BLOCK_NTIME = 1 << 19    # 128 MiB RAW blocks at 64 channels
RAW_SAMPLES = (2 * CHUNK_FRAMES + NTAP - 1) * NFFT  # two full 0000 chunks
# On the fine grid of all three products (3/8 of a coarse channel).
TONE_CHAN, TONE_FREQ = 10, 0.375
# Product → reducer_for_product keywords; "0002" keeps its default
# chunk_frames (2048 = nint).  0001's default of 128 frames moves 268 KB
# per device call, so the smoke takes 2^17.
PRODUCTS = {"0000": {"chunk_frames": CHUNK_FRAMES}, "0002": {},
            "0001": {"chunk_frames": 1 << 17}}
NFFT_21 = 1 << 21        # the 128·128·128 path
REF_CHANNELS_21 = 4      # channels of (e) compared with the twins
NFFT_6144 = 6144         # the 64·96 path (a non-power-of-two nfft)
FRAMES_6144 = 1024
# (m) the opt-in routes: route (a) at 2^13 on FRAMES_13 frames, one-pol
# input (routes (c) and (d)) at nfft ONEPOL_NFFT on ONEPOL_FRAMES frames,
# REF_CHANNELS_M channels of the big routes compared with the twins.
NFFT_13 = 1 << 13
FRAMES_13 = 64
ONEPOL_NFFT = 1024
ONEPOL_FRAMES = 1024
REF_CHANNELS_M = 4
REALTIME_BANK_GBPS = 0.750
SEED = 2026
# The search: nfft 1024 at search_defaults() for (h), one window of 8
# hi-res spectra for (i), ±20-bin drifts over two 64-spectrum windows
# for (j).  Each shape of (g): (what it is, T, F).
SEARCH_NFFT = 1024
HIRES_WINDOW = 8
DRIFT_BINS = 20
DRIFT_WINDOWS = 2
TREE_SHAPES = (
    ("default window", 64, NCHAN * SEARCH_NFFT),
    ("hi-res window", HIRES_WINDOW, NCHAN * NFFT),
    ("16 hi-res spectra", 16, NCHAN * NFFT),
    ("largest window", 1024, NCHAN * SEARCH_NFFT),
    ("shared route, odd F", 32, 100003),
    ("global-pass route, odd F", 256, 70001),
)

# The antenna-array plane at bench.py's array scale (_run_collectives):
# (k) beamform: 64 antennas → 64 beams over 64 channels, 2 pols, nint 8,
# one-shot over BF_SAMPLES, streamed over BF_WINDOWS windows of it; (l)
# correlator: 64 antennas, 16 channels, nfft 512, ntap 4, FX_SAMPLES
# samples, streamed in windows of FX_WINDOW_FRAMES frames.  One RAW file
# per antenna, a tone in channel a % nchan (bench.py:560-568).
ARRAY_NANT = 64
BF_NBEAM = 64
BF_NCHAN = 64
BF_NINT = 8
BF_SAMPLES = 8192
BF_WINDOWS = 4
FX_NCHAN = 16
FX_NFFT = 512
FX_SAMPLES = 64 * FX_NFFT
FX_WINDOW_FRAMES = 15

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # CUDA cores, f32
BF16_TC_FLOPS = 989e12   # tensor cores, bf16 operands
TF32_TC_FLOPS = 495e12   # tensor cores, tf32 operands
# f32 products in three tf32 passes (x = hi + lo: lo*hi + hi*lo + hi*hi):
# three tensor-core products for each f32 one.
F32_3XTF32_FLOPS = TF32_TC_FLOPS / 3

# Elementwise bounds: (rtol, atol as a fraction of the reference's
# scale, the scale).  The f32 ones are blit's (tests/test_pallas_pfb.py,
# tests/test_pallas_detect.py).  Over 2^28 outputs the peak is ~10-20×
# the mean, so the bf16 atol scales with the mean |value| instead.
BOUNDS = {
    ("pfb_dft1", "float32"): (1e-4, 1e-2, "peak"),
    ("pfb_dft1", "bfloat16"): (0.05, 0.05, "mean"),
    ("tail2_detect", "float32"): (1e-5, 1e-4, "peak"),
    ("tail2_detect", "bfloat16"): (0.05, 0.05, "mean"),
    # tests/test_pallas_pfb.py:24-42: |err| / max(peak, 1).
    ("pfb_dequant", "float32"): (0.0, 1e-6, "peak1"),
    ("pfb_dequant", "bfloat16"): (0.0, 3e-2, "peak1"),
    # tests/test_pallas_dft.py:22-33 (rtol 1e-4, atol 1e-3 on unit-
    # variance input): atol scales with the input's rms, the noise.
    ("dft_last", "float32"): (1e-4, 1e-3, "input_rms"),
    ("dft_last", "bfloat16"): (1e-4, 1e-3, "input_rms"),
    ("dft_stage", "float32"): (1e-4, 1e-3, "input_rms"),
    ("dft_tail2", "float32"): (1e-4, 1e-3, "input_rms"),
    # tests/test_pallas_beamform.py:43-46 and tests/test_pallas_xengine.py:
    # 40-43 (atol 1e-3 on unit-variance spectra: visibilities scale with
    # the spectra's rms squared, and so does the atol here).
    ("fused_beamform_detect", "float32"): (1e-4, 1e-3, "peak"),
    ("fused_beamform_detect", "bfloat16"): (1e-4, 1e-3, "peak"),
    ("xengine_packed", "float32"): (1e-4, 1e-3, "input_ms"),
    ("xengine_packed", "bfloat16"): (1e-4, 1e-3, "input_ms"),
    # tests/test_pallas_detect.py:22-39 (rtol 1e-6, atol 1e-5 on unit-
    # variance spectra): kernel and plain version compute the same four
    # squares and three adds, each rounded, in the same order.
    ("detect_untwist_i", "float32"): (1e-6, 1e-5, "input_ms"),
    ("detect_untwist_i", "bfloat16"): (1e-6, 1e-5, "input_ms"),
}
# bf16 outputs are also held in aggregate, ‖got − want‖₂ / ‖want‖₂: a
# sound kernel differs from its twin only where an f32 rounding
# difference flips a bf16 rounding, while one that rounds at other points
# differs almost everywhere.  The control (the twin without its bf16
# rounding points) must land above the bound, or the bound could not
# tell the two apart.
BF16_REL_RMS = 3e-4
DETECT_FLOPS = {"I": 7, "XX": 3, "YY": 3, "XXYY": 6, "full": 12, "IQUV": 16}


def log(msg: str) -> None:
    print(msg, flush=True)


def stage_table(tl) -> dict:
    """A Timeline's stages as {name: {"s": seconds, "GB": bytes / 1e9}}."""
    return {k: {"s": round(v.seconds, 4), "GB": round(v.bytes / 1e9, 4)}
            for k, v in list(tl.stages.items())}


def median_ms(torch, fn, runs: int = 7) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_close(torch, got, want, rtol, atol):
    """(max |got - want|, whether |got - want| <= atol + rtol·|want|)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return err.max().item(), ok


def rms(torch, tensors) -> float:
    return (sum((t.float() ** 2).sum(dtype=torch.float64).item() for t in tensors)
            / sum(t.numel() for t in tensors)) ** 0.5


def check_bound(torch, got, want, name, dtype, inputs=(), grow=1.0,
                noise=None):
    """Elementwise check of ``BOUNDS[(name, dtype)]`` over the tensors
    of ``got`` and ``want``, the atol times ``grow`` → (max abs error,
    atol, ok).  With ``noise``, the atol scales with that noise level
    instead of the bound's own scale."""
    rtol, frac, scale = BOUNDS[(name, dtype)]
    if noise is not None:
        scale = "noise"
    if scale == "peak":
        s = max(w.float().abs().max().item() for w in want)
    elif scale == "peak1":
        s = max(max(w.float().abs().max().item() for w in want), 1.0)
    elif scale == "input_rms":
        s = rms(torch, inputs)
    elif scale == "input_ms":
        s = rms(torch, inputs) ** 2
    elif scale == "noise":
        s = noise
    else:
        s = (sum(w.float().abs().sum(dtype=torch.float64).item() for w in want)
             / sum(w.numel() for w in want))
    atol = frac * s * grow
    errs = [check_close(torch, a, b, rtol, atol) for a, b in zip(got, want)]
    return max(e[0] for e in errs), atol, all(e[1] for e in errs)


def rel_rms(torch, got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂ over the tensors of ``got`` and ``want``."""
    num = sum(((a.float() - b.float()) ** 2).sum(dtype=torch.float64)
              for a, b in zip(got, want))
    den = sum((b.float() ** 2).sum(dtype=torch.float64) for b in want)
    return float((num / den) ** 0.5)


def bound_ms(nbytes: float, flops_by_rate) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(f / r for f, r in flops_by_rate)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# Costs: (bytes, the function's operations, the dense-matmul operations).
# Bytes count each input read once and each output written once.  A DFT
# of n points costs 5·log2(n) flops per complex output, as an FFT: the
# least work the function needs, which sets bound_ms.  The TPU kernels'
# contract computes each level as a dense product instead, 8·n flops per
# complex output (bf16 operands at the tensor-core rate, else f32 on the
# CUDA cores); contract_ms is the bound for that choice of arithmetic.


def fft_flops(nout, n) -> float:
    return 5.0 * nout * math.log2(n)


def pfb_cost(nchan, ntime, nframes, n1, dtype, nfft=NFFT):
    """pfb_dft1: FIR 2 flops per tap per real value, the n1-point DFT
    stage, 6 flops per complex output for the twiddle."""
    esize = 2 if dtype == "bfloat16" else 4
    m = nfft // n1
    nout = nchan * 2 * nframes * nfft
    nbytes = (nchan * ntime * 4 + NTAP * nfft * 4 + 2 * n1 * n1 * 4
              + 2 * n1 * m * 4 + 2 * nout * esize)
    rest = nout * (2 * 2 * NTAP + 6)
    dft_rate = BF16_TC_FLOPS if dtype == "bfloat16" else F32_FLOPS
    return (nbytes, [(rest + fft_flops(nout, n1), F32_FLOPS)],
            [(rest, F32_FLOPS), (nout * 8 * n1, dft_rate)])


def tail_cost(nchan, nframes, f2, f3, stokes, dtype, nif):
    """tail2_detect: the (f2·f3)-point DFT of levels 2 and 3, the
    twiddle, the detection."""
    esize = 2 if dtype == "bfloat16" else 4
    nin = nchan * 2 * nframes * NFFT
    nbytes = 2 * nin * esize + (2 * f2 * f2 + 2 * f3 * f3 + 2 * f2 * f3) * 4 \
        + nframes * nif * nchan * NFFT * 4
    rest = nin * 6 + nframes * nchan * NFFT * DETECT_FLOPS[stokes]
    dft_rate = BF16_TC_FLOPS if dtype == "bfloat16" else F32_FLOPS
    return (nbytes, [(rest + fft_flops(nin, f2 * f3), F32_FLOPS)],
            [(rest, F32_FLOPS), (nin * 8 * (f2 + f3), dft_rate)])


def bf16_aggregate(torch, got, want, control) -> dict:
    """The aggregate bf16 check: the kernel within ``BF16_REL_RMS`` of
    its twin, the control beyond it."""
    r, c = rel_rms(torch, got, want), rel_rms(torch, control, want)
    return dict(rel_rms=r, control_rel_rms=c, rel_rms_bound=BF16_REL_RMS,
                rel_rms_ok=r <= BF16_REL_RMS < c)


def bf16_fft_aggregate(torch, got, want, fft_ref, control) -> dict:
    """The aggregate bf16 check of a kernel that computes its DFT as an
    FFT: the twin rounds the DFT matrices to bf16 as the TPU contract
    does, which an FFT cannot.  So the kernel is held within
    ``BF16_REL_RMS`` of ``fft_ref`` (the same plain arithmetic at the
    kernel's rounding points: the contract's other bf16 roundings, f32
    roots), the control beyond it.  Its distance from the twin, and the
    control's, are recorded beside (the matrices' rounding, about 2e-3)."""
    agg = bf16_aggregate(torch, got, fft_ref, control)
    return dict(agg, twin_rel_rms=rel_rms(torch, got, want),
                twin_control_rel_rms=rel_rms(torch, control, want))


def pfb_fft_reference(torch, v, h, mats):
    """pfb_dft1 in bf16 at its kernel's rounding points: the FIR sum
    rounded to bf16 (pfb_dequant_plain's, the twin's FIR), the n1-point
    stage and twiddle in f32 with f32 roots (dft_stage_plain), stored as
    bf16."""
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import pfb as tpfb

    n1 = mats[0].shape[0]
    fr, fi = tpfb.pfb_dequant_plain(v, h, dtype="bfloat16")
    shape = fr.shape[1:-1] + (n1, fr.shape[-1] // n1)
    out = [torch.empty((fr.shape[0],) + shape, dtype=torch.bfloat16,
                       device=v.device) for _ in range(2)]
    for c in range(fr.shape[0]):
        sr, si = tdft.dft_stage_plain(fr[c].reshape(shape), fi[c].reshape(shape),
                                      *mats)
        out[0][c], out[1][c] = sr, si
    return out


def tail2_fft_reference(torch, ur, ui, f2, f3, stokes):
    """tail2_detect on bf16 spectra at its kernel's rounding points: the
    f2-point level and the twiddle in f32 with f32 roots, rounded to bf16
    (the contract's rounding of the twiddled rows), the f3-point level in
    f32, the detect; the twin's order of operations otherwise."""
    from blit_torch.ops import detect as tdet
    from blit_torch.ops import dft as tdft

    nchan, npol, nframes, f1, m = ur.shape
    dev = ur.device
    w2 = tdft.as_tensors(tdft.dft_matrices(f2), dev)
    tw = tdft.as_tensors(tdft.twiddles(f2, f3), dev)
    w3 = tdft.as_tensors(tdft.dft_matrices(f3), dev)
    out = torch.empty((nframes, tdet.STOKES_NIF[stokes], nchan, f1 * m),
                      device=dev)
    shape = (npol, nframes, f1, f2, f3)
    for c in range(nchan):
        yr, yi = tdft.dft_stage_plain(ur[c].float().reshape(shape),
                                      ui[c].float().reshape(shape), *w2, *tw)
        zr, zi = tdft.dft_last_plain(tdft.round_bf16(yr), tdft.round_bf16(yi),
                                     *w3)
        del yr, yi
        # (pol, frame, k1, k2, k3) → natural order k1 + f1·k2 + f1·f2·k3.
        zr = zr.permute(0, 1, 4, 3, 2).reshape(npol, nframes, f1 * m)
        zi = zi.permute(0, 1, 4, 3, 2).reshape(npol, nframes, f1 * m)
        out[:, :, c] = tdet.detect_stokes_planar(zr, zi, stokes).transpose(0, 1)
    return out


def phase_kernels(torch, dev):
    """(c): every kernel variant against its plain twin at the chunk
    shape.  Returns the main-path variants' records."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import detect as tdet
    from blit_torch.ops import dft as tdft

    ntime = (CHUNK_FRAMES + NTAP - 1) * NFFT
    g = torch.Generator(device=dev).manual_seed(SEED)
    v = torch.randint(-128, 128, (NCHAN, ntime, 2, 2), generator=g,
                      device=dev, dtype=torch.int8)
    sign = torch.where(torch.arange(NFFT, device=dev) % 2 == 0, 1.0, -1.0)
    h = (torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT)).to(dev) * sign).contiguous()
    f1, f2, f3 = tdft.default_factors(NFFT)
    mats = tdft.as_tensors(tdft.dft_matrices(f1) + tdft.twiddles(f1, NFFT // f1), dev)
    records = []
    spectra = {}
    for dtype in ("float32", "bfloat16"):
        got, rec = pfb_record(torch, v, h, mats, dtype, NFFT, CHUNK_FRAMES,
                              "0000")
        records.append(rec)
        spectra[dtype] = got
    del v
    for dtype in ("float32", "bfloat16"):
        ur, ui = spectra[dtype]
        for stokes in ("I", "IQUV"):
            nif = tdet.STOKES_NIF[stokes]
            got = tdet.tail2_detect(ur, ui, f2, f3, stokes=stokes)
            want = tdet.tail2_detect_plain(ur, ui, f2, f3, stokes=stokes)
            err, atol, ok = check_bound(torch, [got], [want], "tail2_detect", dtype)
            agg = {}
            if dtype == "bfloat16":
                # Control: the twin in f32 on the same bf16 input.
                control = tdet.tail2_detect_plain(ur.float(), ui.float(), f2,
                                                  f3, stokes=stokes)
                ref = tail2_fft_reference(torch, ur, ui, f2, f3, stokes)
                agg = bf16_fft_aggregate(torch, [got], [want], [ref], [control])
                del control, ref
            del got, want
            ms = median_ms(torch, lambda: tdet.tail2_detect(ur, ui, f2, f3, stokes=stokes))
            plain_ms = median_ms(
                torch, lambda: tdet.tail2_detect_plain(ur, ui, f2, f3, stokes=stokes),
                runs=5)
            records.append(kernel_record(
                "tail2_detect", dtype, "blit_torch/csrc/tail2_detect.cu",
                "blit/ops/pallas_detect.py:281", err, atol,
                ok and agg.get("rel_rms_ok", True), ms, plain_ms,
                tail_cost(NCHAN, CHUNK_FRAMES, f2, f3, stokes, dtype, nif), None,
                stokes=stokes, **agg))
    del spectra
    torch.cuda.empty_cache()

    # pfb_dft1 at 6144's first factor, n1 = 64 (m = 96), on the 6144 path's
    # chunk shape ((f)); the kernels line keeps the 0000 record.
    n1, m = tdft.default_factors(NFFT_6144)
    ntime = (FRAMES_6144 + NTAP - 1) * NFFT_6144
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    v = torch.randint(-128, 128, (NCHAN, ntime, 2, 2), generator=g,
                      device=dev, dtype=torch.int8)
    sign = torch.where(torch.arange(NFFT_6144, device=dev) % 2 == 0, 1.0, -1.0)
    h = (torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT_6144)).to(dev)
         * sign).contiguous()
    mats = tdft.as_tensors(tdft.dft_matrices(n1) + tdft.twiddles(n1, m), dev)
    for dtype in ("float32", "bfloat16"):
        got, rec = pfb_record(torch, v, h, mats, dtype, NFFT_6144,
                              FRAMES_6144, "6144", line=False)
        records.append(rec)
        del got
    del v
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    return records


def pfb_record(torch, v, h, mats, dtype, nfft, nframes, product, **extra):
    """pfb_dft1 on int8 voltages against its twin in ``dtype`` (bf16 also
    in relative rms, :func:`bf16_fft_aggregate`), timed beside the twin.
    Returns (the kernel's spectra, the record)."""
    from blit_torch.ops import pfb as tpfb

    got = tpfb.pfb_dft1(v, h, *mats, dtype=dtype)
    want = tpfb.pfb_dft1_plain(v, h, *mats, dtype=dtype)
    err, atol, ok = check_bound(torch, got, want, "pfb_dft1", dtype)
    agg = {}
    if dtype == "bfloat16":
        # Control: the f32 twin rounded only at its store.
        control = [x.to(torch.bfloat16) for x in tpfb.pfb_dft1_plain(v, h, *mats)]
        ref = pfb_fft_reference(torch, v, h, mats)
        agg = bf16_fft_aggregate(torch, got, want, ref, control)
        del control, ref
    del want
    torch.cuda.empty_cache()
    ms = median_ms(torch, lambda: tpfb.pfb_dft1(v, h, *mats, dtype=dtype))
    plain_ms = median_ms(torch, lambda: tpfb.pfb_dft1_plain(v, h, *mats, dtype=dtype),
                         runs=5)
    torch.cuda.empty_cache()
    n1 = mats[0].shape[0]
    geo = tpfb.kernel_geometry(n1, h.shape[0])
    rec = kernel_record(
        "pfb_dft1", dtype, "blit_torch/csrc/pfb_dft1.cu",
        "blit/ops/pallas_pfb.py:175", err, atol,
        ok and agg.get("rel_rms_ok", True), ms, plain_ms,
        pfb_cost(v.shape[0], v.shape[1], nframes, n1, dtype, nfft), None,
        product=product, n1=n1, m=nfft // n1, plan=list(geo["plan"]),
        tc=geo["tc"], fg=geo["fg"], nstage=geo["nstage"], smem=geo["smem"],
        **agg, **extra)
    return got, rec


def kernel_record(name, dtype, source, replaces, err, atol, ok, ms, plain_ms,
                  cost, library_ms, **extra):
    nbytes, ops, dense = cost
    bms, by = bound_ms(nbytes, ops)
    contract = bound_ms(nbytes, dense)[0] if dense else None
    rec = dict(name=name, dtype=dtype, route="cuda", source=source,
               replaces=replaces, max_abs_err=err, atol=atol, ok=ok, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               contract_ms=contract, library_ms=library_ms, **extra)
    log(f"kernel {json.dumps(rec)}")
    return rec


def dequant_cost(nchan, nblk, nframes, nfft, dtype):
    """pfb_dequant: each int8 sample read once (4 bytes), the window
    once, each output written once; 2 flops per tap per real output.
    No DFT, so no dense-matmul figure."""
    esize = 2 if dtype == "bfloat16" else 4
    nout = nchan * 2 * nframes * nfft  # complex outputs, both pols
    nbytes = nchan * nblk * nfft * 4 + NTAP * nfft * 4 + 2 * nout * esize
    return nbytes, [(nout * 2 * 2 * NTAP, F32_FLOPS)], None


def dft_cost(nout, n, in_esize, twiddle=0):
    """A DFT level of n points over ``nout`` complex outputs: input and
    output once, the matrix and the ``twiddle`` entries (if any) once;
    6 flops per output for the twiddle."""
    nbytes = 2 * nout * (in_esize + 4) + 2 * (n * n + twiddle) * 4
    tw = nout * 6 if twiddle else 0
    return (nbytes, [(fft_flops(nout, n) + tw, F32_FLOPS)],
            [(nout * 8 * n + tw, F32_FLOPS)])


def tail2_cost(nout, f2, f3, in_esize):
    """dft_tail2: the (f2·f3)-point DFT of levels 2 and 3 and the twiddle
    between them; input and output once, W2, W3 and the twiddle once."""
    nbytes = 2 * nout * (in_esize + 4) + 2 * (f2 * f2 + f3 * f3 + f2 * f3) * 4
    tw = nout * 6
    return (nbytes, [(fft_flops(nout, f2 * f3) + tw, F32_FLOPS)],
            [(nout * 8 * (f2 + f3) + tw, F32_FLOPS)])


def dft_last_record(torch, xr, xi, n, where, **extra):
    """dft_last on (xr, xi) (rows of n points) against its plain version,
    timed beside the tiled GEMM (``tiled=True``, the dense design of the
    first port, also held to the bound) and, for f32, ``torch.fft.fft``
    of the same rows; at n = 8 also the design the gate did not pick
    (the row kernel or the FFT), checked and timed."""
    from blit_torch.ops import dft as tdft

    dev = xr.device
    dtype = "bfloat16" if xr.dtype == torch.bfloat16 else "float32"
    w = tdft.as_tensors(tdft.dft_matrices(n), dev)
    want = tdft.dft_last_plain(xr, xi, *w)
    got = tdft.dft_last(xr, xi, *w)
    err, atol, ok = check_bound(torch, got, want, "dft_last", dtype,
                                inputs=(xr, xi))
    del got
    design = tdft.dft_last_design(n)
    others = ["tiled"] + [d for d in ("fft", "rows")
                          if n == 8 and d != design]
    designs = {}
    for other in others:
        got = tdft.dft_last_cuda(xr, xi, *w, design=other)
        oerr, _, ook = check_bound(torch, got, want, "dft_last", dtype,
                                   inputs=(xr, xi))
        del got
        ok = ok and ook
        designs[other] = dict(max_abs_err=oerr, ms=median_ms(
            torch, lambda: tdft.dft_last_cuda(xr, xi, *w, design=other)))
    del want
    torch.cuda.empty_cache()
    ms = median_ms(torch, lambda: tdft.dft_last(xr, xi, *w))
    plain_ms = median_ms(torch, lambda: tdft.dft_last_plain(xr, xi, *w), runs=5)
    lib_ms = None
    if dtype == "float32":
        z = torch.complex(xr, xi)
        lib_ms = median_ms(torch, lambda: torch.fft.fft(z, dim=-1))
        del z
    torch.cuda.empty_cache()
    return kernel_record(
        "dft_last", dtype, "blit_torch/csrc/dft.cu",
        "blit/ops/pallas_dft.py:325", err, atol, ok, ms, plain_ms,
        dft_cost(xr.numel(), n, xr.element_size()), lib_ms, n=n,
        design=design, plan=list(tdft.fft_plan(n)), path=where,
        library="torch.fft.fft", tiled_ms=designs["tiled"]["ms"],
        tiled_max_abs_err=designs["tiled"]["max_abs_err"],
        designs=designs, **extra)


def phase_front_kernels(torch, dev):
    """(c) for the 0002 and 0001 paths: pfb_dequant at both chunk shapes
    (f32, bf16) and dft_last on their PFB output (n = 1024, n = 8)."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import pfb as tpfb
    from blit_torch.pipeline import PRODUCT_PRESETS

    records = []
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for product in ("0002", "0001"):
        nfft, nint = PRODUCT_PRESETS[product]
        frames = PRODUCTS[product].get("chunk_frames", nint)
        nblk = frames + NTAP - 1
        v = torch.randint(-128, 128, (NCHAN, nblk * nfft, 2, 2), generator=g,
                          device=dev, dtype=torch.int8)
        sign = torch.where(torch.arange(nfft, device=dev) % 2 == 0, 1.0, -1.0)
        h = (torch.from_numpy(tch.pfb_coeffs(NTAP, nfft)).to(dev) * sign).contiguous()
        planes = {}
        for dtype in ("float32", "bfloat16"):
            got = tpfb.pfb_dequant(v, h, dtype=dtype)
            want = tpfb.pfb_dequant_plain(v, h, dtype=dtype)
            err, atol, ok = check_bound(torch, got, want, "pfb_dequant", dtype)
            agg = {}
            if dtype == "bfloat16":
                # Control: the f32 twin, without the one rounding.
                agg = bf16_aggregate(torch, got, want,
                                     tpfb.pfb_dequant_plain(v, h))
            del want
            ms = median_ms(torch, lambda: tpfb.pfb_dequant(v, h, dtype=dtype))
            plain_ms = median_ms(
                torch, lambda: tpfb.pfb_dequant_plain(v, h, dtype=dtype), runs=5)
            records.append(kernel_record(
                "pfb_dequant", dtype, "blit_torch/csrc/pfb_dequant.cu",
                "blit/ops/pallas_pfb.py:252", err, atol,
                ok and agg.get("rel_rms_ok", True), ms, plain_ms,
                dequant_cost(NCHAN, nblk, frames, nfft, dtype), None,
                product=product, **agg))
            planes[dtype] = got
        del v
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16" and product == "0001":
                continue
            xr, xi = planes.pop(dtype)
            records.append(dft_last_record(torch, xr, xi, nfft, product,
                                           product=product))
            del xr, xi
        planes.clear()
        torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    return records


COUNTED = ("pfb_dft1", "tail2_detect", "pfb_dequant", "dft_stage", "dft_last",
           "dft_tail2", "taylor_tree", "fused_beamform_detect", "xengine_packed",
           "detect_untwist_i")


def _wrappers():
    from blit_torch.ops import beamform as tbf
    from blit_torch.ops import dedoppler as tpd
    from blit_torch.ops import detect as tdet
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import pfb as tpfb
    from blit_torch.ops import xengine as txe

    return {"pfb_dft1": tpfb.pfb_dft1, "tail2_detect": tdet.tail2_detect,
            "pfb_dequant": tpfb.pfb_dequant, "dft_stage": tdft.dft_stage,
            "dft_last": tdft.dft_last, "dft_tail2": tdft.dft_tail2,
            "taylor_tree": tpd.taylor_tree,
            "fused_beamform_detect": tbf.fused_beamform_detect,
            "xengine_packed": txe.xengine_packed,
            "detect_untwist_i": tdet.detect_untwist_i}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def _plan(pfb, tail, detect="torch", **extra) -> dict:
    return dict(pfb_kernel=pfb, tail_kernel=tail, detect_kernel=detect, **extra)


# Plan and kernels each path must run: (plan keys, kernels).
EXPECTED = {
    "0000": (_plan("fused1", "tail2_detect", "tail2_detect"),
             ("pfb_dft1", "tail2_detect")),
    "0002": (_plan("pallas", "dft_last"), ("pfb_dequant", "dft_last")),
    "0001": (_plan("pallas", "dft_last"), ("pfb_dequant", "dft_last")),
    "2^21": (_plan("fused1", "dft_tail2"), ("pfb_dft1", "dft_tail2")),
    "6144": (_plan("fused1", "dft_last"), ("pfb_dft1", "dft_last")),
    "search": (_plan("pallas", "dft_last"),
               ("pfb_dequant", "dft_last", "taylor_tree")),
    "hi-res search": (_plan("fused1", "tail2_detect", "tail2_detect"),
                      ("pfb_dft1", "tail2_detect", "taylor_tree")),
    "drift": (_plan("pallas", "dft_last"),
              ("pfb_dequant", "dft_last", "taylor_tree")),
    "route (a) 2^20": (_plan("fused1", "dft_stage+dft_last", "detect_untwist_i"),
                       ("pfb_dft1", "dft_stage", "dft_last", "detect_untwist_i")),
    "route (a) 2^13": (_plan("fused1", "dft_last", "detect_untwist_i"),
                       ("pfb_dft1", "dft_last", "detect_untwist_i")),
    "route (b) 6144": (_plan("pallas", "dft_stage+dft_last", dft_order="twisted"),
                       ("pfb_dequant", "dft_stage", "dft_last")),
    "route tail2 2^20": (_plan("fused1", "dft_tail2"), ("pfb_dft1", "dft_tail2")),
    "route (c) one pol": (_plan("torch", "dft_last", fft_method="matmul"),
                          ("dft_last",)),
    "route (d) direct": (_plan("torch", "torch", fft_method="direct"), ()),
    "gbt": (_plan("pallas", "dft_last"), ("pfb_dequant", "dft_last")),
    "mesh (1,8)": (_plan("pallas", "dft_last"), ("pfb_dequant", "dft_last")),
    "mesh search": (_plan("pallas", "dft_last"),
                    ("pfb_dequant", "dft_last", "taylor_tree")),
    "mesh 0000": (_plan("fused1", "tail2_detect", "tail2_detect"),
                  ("pfb_dft1", "tail2_detect")),
    "gbt search": (_plan("pallas", "dft_last"),
                   ("pfb_dequant", "dft_last", "taylor_tree")),
    "serve 0000": (_plan("fused1", "tail2_detect", "tail2_detect"),
                   ("pfb_dft1", "tail2_detect")),
    "serve hits": (_plan("pallas", "dft_last"),
                   ("pfb_dequant", "dft_last", "taylor_tree")),
}


def check_plan(path, plan, launches, tree_launches=None):
    """The path ran its plan through the Hopper kernels, each launched;
    with ``tree_launches``, taylor_tree exactly that many times."""
    keys, names = EXPECTED[path]
    want = dict(keys, impl="cuda")
    if {k: plan.get(k) for k in want} != want:
        raise AssertionError(f"{path} did not run the Hopper kernels: {plan}")
    if names and min(launches[k] for k in names) < 1:
        raise AssertionError(f"a kernel of the {path} path never launched: {launches}")
    if tree_launches is not None and launches["taylor_tree"] != tree_launches:
        raise AssertionError(f"{path}: taylor_tree launched {launches['taylor_tree']} "
                             f"times, want {tree_launches}")


def read_span(raw, s0: int, n: int, per: int):
    """Samples ``[s0, s0+n)`` of a gap-free RAW file of ``per``-sample
    blocks → int8 ``(nchan, n, 2, 2)``."""
    import numpy as np

    out = np.empty((NCHAN, n, 2, 2), np.int8)
    done = 0
    while done < n:
        b, t0 = divmod(s0 + done, per)
        take = min(per - t0, n - done)
        raw.read_block_into(b, out[:, done:done + take], t0, take)
        done += take
    return out


def write_recording(tmp):
    from blit_torch.testing import synth_raw_blocks

    raw_path = os.path.join(tmp, "smoke.raw")
    t0 = time.perf_counter()
    synth_raw_blocks(raw_path, nblocks=RAW_SAMPLES // BLOCK_NTIME, obsnchan=NCHAN,
                     ntime_per_block=BLOCK_NTIME, seed=SEED,
                     tone_chan=TONE_CHAN, tone_freq=TONE_FREQ)
    log(f"main: wrote {os.path.getsize(raw_path) / 1e9:.3f} GB RAW in "
        f"{time.perf_counter() - t0:.1f} s")
    return raw_path


def phase_product(torch, dev, raw_path, tmp, product):
    """(d) for one product: reduce the recording through the kernels and
    check it.  Returns (launch counts, summary)."""
    import numpy as np

    from blit_torch.io.guppi import GuppiRaw
    from blit_torch.io.sigproc import encode_header, read_fil
    from blit_torch.ops import channelize as tch
    from blit_torch.pipeline import reducer_for_product

    fil_path = os.path.join(tmp, f"smoke.{product}.fil")
    red = reducer_for_product(product, **PRODUCTS[product])
    nfft, nint, frames = red.nfft, red.nint, red.chunk_frames
    reset_launches()
    t0 = time.perf_counter()
    hdr = red.reduce_to_file(raw_path, fil_path)
    wall = time.perf_counter() - t0
    launches = read_launches()
    plan = tch.last_kernel_plan()
    log(f"{product}: plan {json.dumps(plan)} launches {json.dumps(launches)}")
    check_plan(product, plan, launches)

    raw = GuppiRaw(raw_path)
    want_hdr = tch.output_header(raw.header(0), nfft=nfft, nint=nint, stokes="I")
    nchans = NCHAN * nfft
    fhdr, data = read_fil(fil_path)
    with open(fil_path, "rb") as f:
        head = f.read(len(encode_header(want_hdr, 32, 1, nchans)))
    if head != encode_header(want_hdr, 32, 1, nchans):
        raise AssertionError(f"{product}: product header differs from output_header")
    nsamps = tch.usable_frames(RAW_SAMPLES, nfft, NTAP, nint) // nint
    if data.shape != (nsamps, 1, nchans) or hdr["nsamps"] != nsamps:
        raise AssertionError(f"{product}: product shape {data.shape}, "
                             f"nsamps {hdr['nsamps']}, want {nsamps}")
    if not np.isfinite(data).all():
        raise AssertionError(f"{product}: non-finite product values")
    chan_bw = want_hdr["foff"] * nfft
    f_tone = (float(raw.header(0)["OBSFREQ"]) - float(raw.header(0)["OBSBW"]) / 2
              + chan_bw / 2 + TONE_CHAN * chan_bw + TONE_FREQ * chan_bw)
    predicted = int(round((f_tone - fhdr["fch1"]) / fhdr["foff"]))
    peak = int(data[0, 0].argmax())
    log(f"{product}: tone peak at fine channel {peak}, header predicts {predicted}")
    if peak != predicted:
        raise AssertionError(f"{product}: tone peak is not where the header puts it")

    # The first two chunks against the plan run through the plain twins on
    # the same voltages; the second starts chunk_frames·nfft samples in,
    # after the PFB state carried across.  The tone's coarse channel peaks
    # far above the noise, so the atol scale (blit's f32 bound, 1e-2·peak)
    # is the peak outside it.
    noise = torch.ones(nchans, dtype=torch.bool, device=dev)
    noise[TONE_CHAN * nfft:(TONE_CHAN + 1) * nfft] = False
    per_chunk = frames // nint
    errs = []
    for k in range(2):
        host = read_span(raw, k * frames * nfft, (frames + NTAP - 1) * nfft,
                         BLOCK_NTIME)
        ref = tch.channelize_twins(torch.from_numpy(host).to(dev), red.coeffs,
                                   nfft=nfft, ntap=NTAP, nint=nint, device=dev)
        del host
        got = torch.from_numpy(np.array(
            data[k * per_chunk:(k + 1) * per_chunk])).to(dev)
        atol = 1e-2 * ref[..., noise].abs().max().item()
        err, ok = check_close(torch, got, ref, 1e-4, atol)
        rel = ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
        log(f"{product}: chunk {k + 1} vs plain twins max_abs_err {err:.6g} "
            f"max_rel_err {rel:.3g} (rtol 1e-4, atol {atol:.6g})")
        if not ok:
            raise AssertionError(f"{product}: chunk {k + 1} disagrees with the plain twins")
        errs.append(err)
        del ref, got
    raw.close()
    torch.cuda.empty_cache()

    st = red.stats
    stages = stage_table(red.timeline)
    gbps = st.gbps
    summary = dict(product=product, nfft=nfft, nint=nint, chunk_frames=frames,
                   chunks=red.timeline.stages["device"].calls,
                   nsamps=nsamps, raw_gb=st.input_bytes / 1e9,
                   wall_s=st.wall_seconds, reduce_to_file_s=wall, raw_gbps=gbps,
                   realtime_factor=gbps / REALTIME_BANK_GBPS,
                   chunk_max_abs_err=errs, stages=stages)
    log(f"{product}: {json.dumps(summary)}")
    return launches, summary


def run_path(torch, dev, path, v, coeffs, nfft, nchan_ref, **knobs):
    """Drive one ``channelize`` path (with ``knobs``) on the card with the
    launch counts set to 0 just before and read just after, then hold its
    first ``nchan_ref`` channels against the plan run through the twins:
    rtol 1e-4 and an atol of 1e-3 of the mean bin (a kernel that lost
    f32 precision, ~1e-3 relative, fails it).  Returns (launches,
    output)."""
    from blit_torch.ops import channelize as tch

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tch.channelize(v, coeffs, nfft=nfft, ntap=NTAP, device=dev, **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    plan = tch.last_kernel_plan()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"{path}: plan {json.dumps(plan)} launches {json.dumps(launches)} "
        f"channelize {wall:.4f} s, peak device memory {peak_gb:.2f} GB")
    check_plan(path, plan, launches)
    nframes = v.shape[1] // nfft - NTAP + 1
    if out.shape != (nframes, 1, v.shape[0] * nfft) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{path}: output shape {tuple(out.shape)} or non-finite")
    ref = tch.channelize_twins(v[:nchan_ref].contiguous(), coeffs, nfft=nfft,
                               ntap=NTAP, device=dev, **knobs)
    got = out[..., :nchan_ref * nfft]
    atol = 1e-3 * ref.abs().mean().item()
    err, ok = check_close(torch, got, ref, 1e-4, atol)
    log(f"{path}: first {nchan_ref} channels vs plain twins max_abs_err {err:.6g} "
        f"(rtol 1e-4, atol {atol:.6g} = 1e-3 of the mean bin)")
    if not ok:
        raise AssertionError(f"{path}: channelize disagrees with the plain twins")
    del ref, got
    torch.cuda.empty_cache()
    return launches, out


def tail2_record(torch, ur, ui, f2, f3, product):
    """dft_tail2 on stage-1 spectra against its twin, timed beside the
    twin and ``torch.fft.fft`` of the same rows."""
    from blit_torch.ops import dft as tdft

    got = tdft.dft_tail2(ur, ui, f2, f3)
    want = tdft.dft_tail2_plain(ur, ui, f2, f3)
    # blit's bound is for its tests' panels of <= 128 points; the outputs
    # of an m-point DFT, and the f32 rounding of their sums, grow as
    # sqrt(m), and so does the atol (as in tests/test_torch_cuda.py).
    err, atol, ok = check_bound(torch, got, want, "dft_tail2", "float32",
                                inputs=(ur, ui), grow=(f2 * f3 / 128) ** 0.5)
    del got, want
    torch.cuda.empty_cache()
    ms = median_ms(torch, lambda: tdft.dft_tail2(ur, ui, f2, f3))
    plain_ms = median_ms(torch, lambda: tdft.dft_tail2_plain(ur, ui, f2, f3), runs=5)
    torch.cuda.empty_cache()
    # One PyTorch call for the same function: each row's (f2·f3)-point DFT.
    z = torch.complex(ur, ui)
    lib_ms = median_ms(torch, lambda: torch.fft.fft(z, dim=-1))
    del z
    torch.cuda.empty_cache()
    geo = tdft.tail2_geometry(f2, f3, ur.element_size())
    rec = kernel_record(
        "dft_tail2", "float32", "blit_torch/csrc/dft_tail2.cu",
        "blit/ops/pallas_dft.py:246", err, atol, ok, ms, plain_ms,
        tail2_cost(ur.numel(), f2, f3, 4), lib_ms,
        product=product, f2=f2, f3=f3, plans=[list(p) for p in geo["plans"]],
        kernel_launches=geo["launches"], library="torch.fft.fft")
    if not ok:
        raise AssertionError(f"dft_tail2 disagrees with its twin: {rec}")
    return rec


def dft_stage_record(torch, xr, xi, n, m, where, **extra):
    """dft_stage (the design dft_stage_design picks, with the twiddle) on
    (..., n, m) panels against its plain version, timed beside the dense
    tiled GEMM (``tiled=True``, the first port's design, also checked)
    and the complex ``torch.matmul`` of W and the panels (no twiddle)."""
    from blit_torch.ops import dft as tdft

    st = tdft.as_tensors(tdft.dft_matrices(n) + tdft.twiddles(n, m), xr.device)
    want = tdft.dft_stage_plain(xr, xi, *st)
    got = tdft.dft_stage(xr, xi, *st)
    err, atol, ok = check_bound(torch, got, want, "dft_stage", "float32",
                                inputs=(xr, xi))
    del got
    got = tdft.dft_stage_cuda(xr, xi, *st, tiled=True)
    tiled_err, _, tiled_ok = check_bound(torch, got, want, "dft_stage",
                                         "float32", inputs=(xr, xi))
    del got, want
    torch.cuda.empty_cache()
    ms = median_ms(torch, lambda: tdft.dft_stage(xr, xi, *st))
    tiled_ms = median_ms(torch, lambda: tdft.dft_stage_cuda(xr, xi, *st, tiled=True))
    plain_ms = median_ms(torch, lambda: tdft.dft_stage_plain(xr, xi, *st), runs=5)
    torch.cuda.empty_cache()
    z = torch.complex(xr, xi)
    wc = torch.complex(st[0], st[1])
    lib_ms = median_ms(torch, lambda: torch.matmul(wc, z))
    del z, wc
    torch.cuda.empty_cache()
    geo = tdft.stage_fft_geometry(n, m, xr.element_size())
    rec = kernel_record(
        "dft_stage", "float32", "blit_torch/csrc/dft.cu",
        "blit/ops/pallas_dft.py:83", err, atol, ok and tiled_ok, ms, plain_ms,
        dft_cost(xr.numel(), n, xr.element_size(), twiddle=n * m), lib_ms,
        n=n, m=m, path=where, design=tdft.dft_stage_design(n, m),
        plan=list(geo["plan"]), tc=geo["tc"], tiled_ms=tiled_ms,
        tiled_max_abs_err=tiled_err,
        library="torch.matmul(complex W, complex panels), no twiddle", **extra)
    if not rec["ok"]:
        raise AssertionError(f"dft_stage disagrees with its twin: {rec}")
    return rec


# dft_stage_design's sweep: panel sizes n off the main paths (no plan
# compiled in: the column FFT reads its plan at run time; powers of two,
# 3/5/7 passes, dense prime passes of 11 to 641 at several n / p) and the
# compiled ones for scale, each at m = 96 (6144's width) and 1024, about
# 2^23 complex values a call.
DESIGN_SWEEP_N = (3, 5, 6, 11, 12, 13, 22, 24, 31, 44, 48, 62, 64, 80, 88, 96,
                  100, 112, 124, 127, 128, 144, 160, 176, 208, 248, 256, 352,
                  384, 496, 512, 641, 704, 768, 992, 1000, 1024, 1383)
DESIGN_SWEEP_M = (96, 1024)


def stage_design_sweep(torch, dev):
    """Both dft_stage designs (the column FFT, the dense tiled GEMM) on the
    same panels, with the twiddle, f32 and bf16: each held against the
    plain version and timed, beside the design dft_stage_design picks.
    Returns the rows; fails if a design disagrees with its twin."""
    from blit_torch.ops import dft as tdft

    rows = []
    for n in DESIGN_SWEEP_N:
        for m in DESIGN_SWEEP_M:
            st = tdft.as_tensors(tdft.dft_matrices(n) + tdft.twiddles(n, m), dev)
            b = max(1, (1 << 23) // (n * m))
            g = torch.Generator(device=dev).manual_seed(SEED + n + m)
            x32 = [torch.randn((b, n, m), generator=g, device=dev) for _ in range(2)]
            for dtype in ("float32", "bfloat16"):
                xr, xi = (x.to(getattr(torch, dtype)) for x in x32)
                want = tdft.dft_stage_plain(xr, xi, *st)
                row = dict(n=n, m=m, dtype=dtype, panels=b,
                           plan=list(tdft.fft_plan(n)),
                           picked=tdft.dft_stage_design(n, m))
                for design in ("fft", "tiled"):
                    run = (lambda d=design: tdft.dft_stage_cuda(
                        xr, xi, *st, design=d))
                    err, atol, ok = check_bound(torch, run(), want, "dft_stage",
                                                "float32", inputs=(xr, xi))
                    row[design] = dict(ms=median_ms(torch, run),
                                       max_abs_err=err, ok=ok)
                del want, xr, xi
                row["faster"] = min(("fft", "tiled"), key=lambda d: row[d]["ms"])
                log(f"dft_stage design {json.dumps(row)}")
                rows.append(row)
            del x32, st
            torch.cuda.empty_cache()
    bad = [r for r in rows if not (r["fft"]["ok"] and r["tiled"]["ok"])]
    if bad:
        raise AssertionError(f"dft_stage designs disagree with the twin: {bad}")
    picked = sum(r["picked"] == r["faster"] for r in rows)
    log(f"dft_stage design sweep: the picked design timed faster in {picked} "
        f"of {len(rows)} rows")
    return rows


def phase_2pow21(torch, dev):
    """(e): dft_tail2 against its twin at this path's shape and at 2^20's
    (128, 64) on (c)'s chunk, then the 2^21 path through channelize.
    Returns (launch counts, [2^21 record, 2^20 record])."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import pfb as tpfb

    nfft = NFFT_21
    f1, f2, f3 = tdft.default_factors(nfft)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    v = torch.randint(-128, 128, (NCHAN, (CHUNK_FRAMES + NTAP - 1) * nfft, 2, 2),
                      generator=g, device=dev, dtype=torch.int8)
    coeffs = torch.from_numpy(tch.pfb_coeffs(NTAP, nfft)).to(dev)

    # dft_tail2 at the shape channelize gives it: the stage-1 spectra,
    # (nchan·2·frames·f1) rows of f2·f3.
    sign = torch.where(torch.arange(nfft, device=dev) % 2 == 0, 1.0, -1.0)
    h = (coeffs * sign).contiguous()
    mats = tdft.as_tensors(tdft.dft_matrices(f1) + tdft.twiddles(f1, nfft // f1), dev)
    ur, ui = tpfb.pfb_dft1(v, h, *mats)
    records = [tail2_record(torch, ur, ui, f2, f3, "2^21")]
    del ur, ui
    torch.cuda.empty_cache()
    launches, _ = run_path(torch, dev, "2^21", v, coeffs, nfft, REF_CHANNELS_21)
    del v
    torch.cuda.empty_cache()

    # 2^20 = (128, 128, 64) on (c)'s chunk: the stage-1 spectra of the
    # 0000 chunk, which tail2_detect takes on the default plan and
    # dft_tail2 on tail_kernel="pallas", detect_kernel="xla" ((m)).
    f1, f2, f3 = tdft.default_factors(NFFT)
    g = torch.Generator(device=dev).manual_seed(SEED)
    v = torch.randint(-128, 128, (NCHAN, (CHUNK_FRAMES + NTAP - 1) * NFFT, 2, 2),
                      generator=g, device=dev, dtype=torch.int8)
    sign = torch.where(torch.arange(NFFT, device=dev) % 2 == 0, 1.0, -1.0)
    h = (torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT)).to(dev) * sign).contiguous()
    mats = tdft.as_tensors(tdft.dft_matrices(f1) + tdft.twiddles(f1, NFFT // f1), dev)
    ur, ui = tpfb.pfb_dft1(v, h, *mats)
    del v
    records.append(tail2_record(torch, ur, ui, f2, f3, "2^20"))
    # Route (a)'s level 2 at 2^20: dft_stage down the (128, 64) panels of
    # the same rows (line=False: the kernels line keeps 6144's level 1).
    shape = ur.shape[:-1] + (f2, f3)
    records.append(dft_stage_record(torch, ur.reshape(shape), ui.reshape(shape),
                                    f2, f3, "route (a) 2^20", line=False))
    del ur, ui
    torch.cuda.empty_cache()
    return launches, records


def phase_6144(torch, dev):
    """(f): the non-power-of-two path, nfft 6144 = 64·96: dft_stage (64
    points + twiddle) on pfb_dequant's frames, as route (b) and the
    design sweep run it, and dft_last (96 points) on its output, each
    against its twin, then the path through channelize, which runs
    pfb_dft1 (n1 = 64, held in (c)) and dft_last.  Returns (launch
    counts, [dft_stage record, dft_last record])."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import pfb as tpfb

    nfft = NFFT_6144
    n1, n2 = tdft.default_factors(nfft)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    v = torch.randint(-128, 128, (NCHAN, (FRAMES_6144 + NTAP - 1) * nfft, 2, 2),
                      generator=g, device=dev, dtype=torch.int8)
    coeffs = torch.from_numpy(tch.pfb_coeffs(NTAP, nfft)).to(dev)
    sign = torch.where(torch.arange(nfft, device=dev) % 2 == 0, 1.0, -1.0)
    fr, fi = tpfb.pfb_dequant(v, (coeffs * sign).contiguous())
    records = []

    # Level 1: (nchan·2·frames) panels of (n1, n2), with the twiddle.
    xr, xi = fr.reshape(-1, n1, n2), fi.reshape(-1, n1, n2)
    records.append(dft_stage_record(torch, xr, xi, n1, n2, "6144",
                                    product="6144"))
    st = tdft.as_tensors(tdft.dft_matrices(n1) + tdft.twiddles(n1, n2), dev)
    got = tdft.dft_stage(xr, xi, *st)
    del xr, xi, fr, fi

    # Level 2: the stage's rows, n2 points along the last axis.
    ur, ui = got
    del got
    records.append(dft_last_record(torch, ur, ui, n2, "6144", product="6144"))
    del ur, ui
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    launches, _ = run_path(torch, dev, "6144", v, coeffs, nfft, NCHAN)
    del v
    torch.cuda.empty_cache()
    return launches, records


def untwist_cost(shape, esize):
    """detect_untwist_i: the twisted planes read once, the power written
    once; per output 3 flops a pol and the adds across pols."""
    nchan, npol, nframes, n = shape
    nout = nchan * nframes * n
    nbytes = 2 * nout * npol * esize + nout * 4
    return nbytes, [(nout * (4 * npol - 1), F32_FLOPS)], None


def compare_outputs(torch, what, got, want):
    """Two routes' products: rtol 1e-4 and an atol of 1e-3 of the mean
    bin, as (e); also whether they are bitwise equal."""
    atol = 1e-3 * want.abs().mean().item()
    err, ok = check_close(torch, got, want, 1e-4, atol)
    equal = bool(torch.equal(got, want))
    log(f"{what}: max_abs_err {err:.6g} (rtol 1e-4, atol {atol:.6g} = 1e-3 "
        f"of the mean bin), bitwise equal {equal}")
    if not ok:
        raise AssertionError(f"{what}: the routes disagree")
    return dict(max_abs_err=err, atol=atol, bitwise_equal=equal)


def phase_routes(torch, dev):
    """(m): detect_untwist_i against its plain version at the 0000 chunk,
    then channelize's opt-in routes, each driven with the launch counts
    set to 0 just before and read just after.  Returns (launch counts
    by path, [records], summary)."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import detect as tdet
    from blit_torch.ops import dft as tdft

    records = []
    counts = {}
    summary = {}

    # The kernel on twisted spectra of the 0000 chunk's shape.
    factors = tdft.default_factors(NFFT)
    shape = (NCHAN, 2, CHUNK_FRAMES, NFFT)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    sr = torch.randn(shape, generator=g, device=dev)
    si = torch.randn(shape, generator=g, device=dev)
    for dtype in ("float32", "bfloat16"):
        xr, xi = sr.to(getattr(torch, dtype)), si.to(getattr(torch, dtype))
        got = tdet.detect_untwist_i(xr, xi, factors)
        want = tdet.detect_untwist_i_plain(xr, xi, factors)
        err, atol, ok = check_bound(torch, [got], [want], "detect_untwist_i",
                                    dtype, inputs=(xr, xi))
        bitwise = bool(torch.equal(got, want))
        del got, want
        torch.cuda.empty_cache()
        ms = median_ms(torch, lambda: tdet.detect_untwist_i(xr, xi, factors))
        plain_ms = median_ms(torch, lambda: tdet.detect_untwist_i_plain(xr, xi, factors))
        torch.cuda.empty_cache()
        records.append(kernel_record(
            "detect_untwist_i", dtype, "blit_torch/csrc/detect_untwist.cu",
            "blit/ops/pallas_detect.py:85", err, atol, ok, ms, plain_ms,
            untwist_cost(shape, xr.element_size()), None, factors=factors,
            bitwise=bitwise, library="none"))
        del xr, xi
    del sr, si
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"detect_untwist_i disagrees with its plain version: {bad}")

    # Route (a) at 2^20 on (c)'s chunk: pfb_dft1, the twisted tail through
    # dft_stage + dft_last, detect_untwist_i; held against the twins and
    # the default plan (tail2_detect), and timed beside it.
    g = torch.Generator(device=dev).manual_seed(SEED)
    v = torch.randint(-128, 128, (NCHAN, (CHUNK_FRAMES + NTAP - 1) * NFFT, 2, 2),
                      generator=g, device=dev, dtype=torch.int8)
    coeffs = torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT)).to(dev)
    knobs = dict(detect_kernel="pallas", tail_kernel="xla")
    counts["route (a) 2^20"], out = run_path(torch, dev, "route (a) 2^20", v,
                                             coeffs, NFFT, REF_CHANNELS_M, **knobs)
    default = tch.channelize(v, coeffs, nfft=NFFT, ntap=NTAP, device=dev)
    if tch.last_kernel_plan()["detect_kernel"] != "tail2_detect":
        raise AssertionError("the default plan at 2^20 is not tail2_detect")
    summary["route (a) 2^20 vs tail2_detect"] = compare_outputs(
        torch, "route (a) 2^20 vs the default plan", out, default)
    del out, default
    torch.cuda.empty_cache()
    route_ms = median_ms(torch, lambda: tch.channelize(
        v, coeffs, nfft=NFFT, ntap=NTAP, device=dev, **knobs))
    default_ms = median_ms(torch, lambda: tch.channelize(
        v, coeffs, nfft=NFFT, ntap=NTAP, device=dev))
    # The dft_tail2 route at 2^20 on the same chunk: pfb_dft1, dft_tail2
    # (f3 = 64), the level-0 swap, torch detect; held against the twins
    # and the default plan, and timed beside it.
    knobs2 = dict(tail_kernel="pallas", detect_kernel="xla")
    counts["route tail2 2^20"], out = run_path(
        torch, dev, "route tail2 2^20", v, coeffs, NFFT, REF_CHANNELS_M, **knobs2)
    default = tch.channelize(v, coeffs, nfft=NFFT, ntap=NTAP, device=dev)
    summary["route tail2 2^20 vs tail2_detect"] = compare_outputs(
        torch, "route tail2 2^20 vs the default plan", out, default)
    del out, default
    torch.cuda.empty_cache()
    tail2_ms = median_ms(torch, lambda: tch.channelize(
        v, coeffs, nfft=NFFT, ntap=NTAP, device=dev, **knobs2))
    summary["channelize 2^20 ms"] = dict(route_a=route_ms, default=default_ms,
                                         route_tail2=tail2_ms)
    log(f"2^20: channelize route (a) {route_ms:.4f} ms, route tail2 "
        f"{tail2_ms:.4f} ms, default plan (pfb_dft1 + tail2_detect) "
        f"{default_ms:.4f} ms")
    del v, coeffs
    torch.cuda.empty_cache()

    # dft_last at route (a) 2^13's level: rows of 64 points, the stage-1
    # spectra's shape (64 channels, 2 pols, 64 frames, 128 rows).
    shape = (NCHAN, 2, FRAMES_13, 128, 64)
    xr = torch.randn(shape, generator=g, device=dev)
    xi = torch.randn(shape, generator=g, device=dev)
    records.append(dft_last_record(torch, xr, xi, 64, "route (a) 2^13"))
    del xr, xi

    # Route (a) at 2^13: two factors (128, 64), so mid = 1.
    v = torch.randint(-128, 128, (NCHAN, (FRAMES_13 + NTAP - 1) * NFFT_13, 2, 2),
                      generator=g, device=dev, dtype=torch.int8)
    coeffs = torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT_13)).to(dev)
    counts["route (a) 2^13"], out = run_path(
        torch, dev, "route (a) 2^13", v, coeffs, NFFT_13, NCHAN,
        detect_kernel="pallas")
    default = tch.channelize(v, coeffs, nfft=NFFT_13, ntap=NTAP, device=dev)
    summary["route (a) 2^13 vs default"] = compare_outputs(
        torch, "route (a) 2^13 vs the default plan", out, default)
    del v, coeffs, out, default
    torch.cuda.empty_cache()

    # Route (b) at 6144 on (f)'s chunk: the twisted DFT, detect, untwist
    # of the power; held against the natural route.
    g6 = torch.Generator(device=dev).manual_seed(SEED + 3)
    v = torch.randint(-128, 128, (NCHAN, (FRAMES_6144 + NTAP - 1) * NFFT_6144, 2, 2),
                      generator=g6, device=dev, dtype=torch.int8)
    coeffs = torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT_6144)).to(dev)
    counts["route (b) 6144"], out = run_path(
        torch, dev, "route (b) 6144", v, coeffs, NFFT_6144, REF_CHANNELS_M,
        dft_order="twisted")
    natural = tch.channelize(v, coeffs, nfft=NFFT_6144, ntap=NTAP, device=dev)
    summary["route (b) 6144 vs natural"] = compare_outputs(
        torch, "route (b) 6144 vs the natural route", out, natural)
    del v, coeffs, out, natural
    torch.cuda.empty_cache()

    # Routes (c) and (d): one-pol input, the FIR in torch ops, then
    # dft_last (c) or torch.fft (d).
    v = torch.randint(-128, 128, (NCHAN, (ONEPOL_FRAMES + NTAP - 1) * ONEPOL_NFFT, 1, 2),
                      generator=g, device=dev, dtype=torch.int8)
    coeffs = torch.from_numpy(tch.pfb_coeffs(NTAP, ONEPOL_NFFT)).to(dev)
    counts["route (c) one pol"], out = run_path(
        torch, dev, "route (c) one pol", v, coeffs, ONEPOL_NFFT, NCHAN)
    counts["route (d) direct"], direct = run_path(
        torch, dev, "route (d) direct", v, coeffs, ONEPOL_NFFT, NCHAN,
        fft_method="direct")
    summary["route (d) direct vs matmul"] = compare_outputs(
        torch, "route (d) direct vs the matmul route (c)", direct, out)
    del v, coeffs, out, direct
    torch.cuda.empty_cache()
    log(f"routes: {json.dumps(summary)}")
    return counts, records, summary


def tree_cost(T, F, signs):
    """taylor_tree: the (T, F) input read once, each sign's output (T
    rows, T-1 for the second) written once; T·log2(T) adds per column
    per sign on the f32 CUDA cores."""
    rows_out = T if signs == 1 else 2 * T - 1
    adds = signs * T * int(math.log2(T)) * F
    return 4 * F * (T + rows_out), [(adds, F32_FLOPS)], None


def phase_tree(torch, dev):
    """(g): the taylor_tree kernel against taylor_tree_plain, bitwise, at
    each of TREE_SHAPES, both signs first (what the search launches),
    then one.  Returns the records."""
    from blit_torch.ops import dedoppler as tpd

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    records = []
    for what, T, F in TREE_SHAPES:
        # Power of a Stokes-I bin summed over a few spectra: positive,
        # mean 50, rms 5.
        x = torch.empty((T, F), device=dev).normal_(50.0, 5.0, generator=g)
        route, per_call = tpd.kernel_route(T)
        for signs, fn, plain in ((2, tpd.drift_spectra, tpd.drift_spectra_plain),
                                 (1, tpd.taylor_tree, tpd.taylor_tree_plain)):
            got = fn(x)
            want = plain(x)
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want))
            err = (got - want).abs().max().item()
            del got, want
            torch.cuda.empty_cache()
            ms = median_ms(torch, lambda: fn(x))
            # Back to back, the host's cost of a call overlaps the card's
            # work: per call, the larger of the two.
            k = 20 if T * F <= 1 << 24 else 3
            batch_ms = median_ms(torch, lambda: [fn(x) for _ in range(k)]) / k
            plain_ms = median_ms(torch, lambda: plain(x))
            torch.cuda.empty_cache()
            records.append(kernel_record(
                "taylor_tree", "float32", "blit_torch/csrc/taylor_tree.cu",
                "blit/ops/pallas_dedoppler.py:138", err, 0.0, equal, ms,
                plain_ms, tree_cost(T, F, signs), None, shape=what, T=T, F=F,
                signs=signs, tree_route=route, launches_per_call=per_call,
                bitwise=equal, batch_ms=batch_ms))
        del x
        torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"taylor_tree is not bitwise equal to its plain version: {bad}")
    return records


def tone_chan_of(nfft: int) -> int:
    """The fine channel of the smoke's tone (TONE_FREQ of coarse channel
    TONE_CHAN, the fftshift folded in) at ``nfft``."""
    return TONE_CHAN * nfft + nfft // 2 + int(TONE_FREQ * nfft)


def top_hits(hits, windows):
    """The top hit (by SNR) of each window; every window must have one."""
    best = {}
    for h in hits:
        if h.window not in best or h.snr > best[h.window].snr:
            best[h.window] = h
    if sorted(best) != list(range(windows)):
        raise AssertionError(f"windows without hits: {sorted(set(range(windows)) - set(best))}")
    return [best[w] for w in range(windows)]


def window_breakdown(torch, dev, red, host_window, nbands):
    """CUDA-event medians of one window's device step, in pieces: the
    H2D copy from pinned memory, the both-sign tree, the whole
    dedoppler_hits (tree + SNR + top-k + pack), the D2H of the hits."""
    from blit_torch.ops import dedoppler as tpd

    win = host_window.pin_memory()
    x = win.to(dev)
    kw = dict(top_k=red.top_k, nbands=nbands, max_drift_bins=red.max_drift_bins)
    packed = tpd.dedoppler_hits(x, red.snr_threshold, **kw)
    out = dict(
        h2d_ms=median_ms(torch, lambda: win.to(dev, non_blocking=True)),
        tree_ms=median_ms(torch, lambda: tpd.drift_spectra(x)),
        hits_ms=median_ms(torch, lambda: tpd.dedoppler_hits(x, red.snr_threshold, **kw)),
        d2h_ms=median_ms(torch, lambda: packed.cpu()))
    out["snr_topk_ms"] = out["hits_ms"] - out["tree_ms"]
    return out


def search_summary(red, hdr, wall, extra):
    st = red.timeline.stages
    stages = stage_table(red.timeline)
    # search.tree_s is the synchronous path's per-window time; on the
    # asynchronous plane the windows overlap, and the stage table holds
    # the readback thread's waits ("device").
    # The histogram's p50 is a bucket midpoint (within a factor of 2).
    tree_s = red.timeline.hists.get("search.tree_s")
    gbps = st["ingest"].bytes / st["stream"].seconds / 1e9
    return dict(windows=hdr["search_windows"], hits=hdr["search_nhits"],
                wall_s=wall, windows_per_s=hdr["search_windows"] / wall,
                window_device_s_p50=tree_s.percentile(0.5) if tree_s else None,
                window_device_s_sum=tree_s.total if tree_s else 0.0,
                raw_gb=st["ingest"].bytes / 1e9,
                raw_gbps=gbps, realtime_factor=gbps / REALTIME_BANK_GBPS,
                stages=stages, **extra)


def phase_search(torch, dev, raw_path, tmp):
    """(h): the search at search_defaults() through search_to_file.
    Returns (launch counts, summary)."""
    import numpy as np

    from blit_torch.config import search_defaults
    from blit_torch.io.guppi import GuppiRaw
    from blit_torch.io.hits import header_line, read_hits
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dedoppler as tpd
    from blit_torch.search import DedopplerReducer
    from blit_torch.search.hits import hits_from_packed

    d = search_defaults()
    if (d["window_spectra"], d["top_k"], d["snr_threshold"]) != (64, 8, 10.0):
        raise AssertionError(f"search_defaults() are not the site's: {d}")
    red = DedopplerReducer(nfft=SEARCH_NFFT, nint=1)
    T, nfft = red.window_spectra, red.nfft
    out = os.path.join(tmp, "smoke.hits")
    reset_launches()
    t0 = time.perf_counter()
    hdr = red.search_to_file(raw_path, out)
    wall = time.perf_counter() - t0
    launches = read_launches()
    plan = tch.last_kernel_plan()
    log(f"search: plan {json.dumps(plan)} launches {json.dumps(launches)}")
    spectra = tch.usable_frames(RAW_SAMPLES, nfft, NTAP, 1)
    windows = spectra // T
    if hdr["search_windows"] != windows:
        raise AssertionError(f"search: {hdr['search_windows']} windows, want {windows}")
    per_window = tpd.kernel_route(T)[1]
    check_plan("search", plan, launches, per_window * windows)
    raw = GuppiRaw(raw_path)
    with open(out) as f:
        line = f.readline()
    if line != header_line(red.header_for(raw)):
        raise AssertionError("search: .hits header line differs from header_for")
    fhdr, hits = read_hits(out)
    chan = tone_chan_of(nfft)
    tops = top_hits(hits, windows)
    wrong = [(h.window, h.drift_bins, h.chan, h.band) for h in tops
             if (h.drift_bins, h.chan, h.band) != (0, chan, TONE_CHAN)]
    log(f"search: {windows} windows ({spectra - windows * T} spectra dropped), "
        f"{len(hits)} hits; top hit of every window at drift 0, chan {chan}, "
        f"band {TONE_CHAN}: {not wrong}")
    if wrong:
        raise AssertionError(f"search: windows whose top hit is not the tone: {wrong[:5]}")

    # The first two windows' spectra through the plain twins on the card,
    # then the search step with the plain tree on the CPU.
    nwin = 2
    host = read_span(raw, 0, (nwin * T + NTAP - 1) * nfft, BLOCK_NTIME)
    spec = tch.channelize_twins(torch.from_numpy(host).to(dev), red._red.coeffs,
                                nfft=nfft, ntap=NTAP, nint=1, device=dev)[:, 0].cpu()
    del host
    raw.close()
    nbands = fhdr["search_nbands"]
    ref = []
    for w in range(nwin):
        packed = tpd.dedoppler_hits(spec[w * T:(w + 1) * T], red.snr_threshold,
                                    top_k=red.top_k, nbands=nbands,
                                    max_drift_bins=red.max_drift_bins)
        ref += hits_from_packed(packed.numpy(), w, fhdr)
    got = [h for h in hits if h.window < nwin]
    cells = [(h.window, h.drift_bins, h.chan, h.band) for h in got]
    if cells != [(h.window, h.drift_bins, h.chan, h.band) for h in ref]:
        raise AssertionError("search: the first windows' hits differ from the plain run")
    rel = max(max(abs(a.snr - b.snr) / abs(b.snr), abs(a.power - b.power) / abs(b.power))
              for a, b in zip(got, ref))
    log(f"search: first {nwin} windows' {len(got)} hits equal the plain run's, "
        f"max rel err of SNR and power {rel:.3g} (rtol 1e-4)")
    if rel > 1e-4:
        raise AssertionError("search: SNR or power of the first windows beyond rtol 1e-4")
    breakdown = window_breakdown(torch, dev, red, spec[:T].contiguous(), nbands)
    summary = search_summary(red, hdr, wall, dict(
        path="search", nfft=nfft, window_spectra=T, nbands=nbands,
        taylor_tree_launches_per_window=per_window, spectra_dropped=spectra - windows * T,
        first_windows_max_rel_err=rel, window_breakdown_ms=breakdown))
    log(f"search: {json.dumps(summary)}")
    torch.cuda.empty_cache()
    return launches, summary


def phase_hires_search(torch, dev, raw_path):
    """(i): one hi-res window, (8, 2^26), 64 bands.  Returns (launch
    counts, summary)."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dedoppler as tpd
    from blit_torch.search import DedopplerReducer

    red = DedopplerReducer(nfft=NFFT, window_spectra=HIRES_WINDOW,
                           chunk_frames=CHUNK_FRAMES)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    hdr, hits = red.search(raw_path)
    wall = time.perf_counter() - t0
    launches = read_launches()
    plan = tch.last_kernel_plan()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"hi-res search: plan {json.dumps(plan)} launches {json.dumps(launches)}")
    windows = tch.usable_frames(RAW_SAMPLES, NFFT, NTAP, 1) // HIRES_WINDOW
    if hdr["search_windows"] != windows:
        raise AssertionError(f"hi-res search: {hdr['search_windows']} windows, want {windows}")
    check_plan("hi-res search", plan, launches,
               tpd.kernel_route(HIRES_WINDOW)[1] * windows)
    if hdr["search_nbands"] != NCHAN:
        raise AssertionError(f"hi-res search: {hdr['search_nbands']} bands")
    top = top_hits(hits, windows)[0]
    chan = tone_chan_of(NFFT)
    log(f"hi-res search: top hit drift {top.drift_bins}, chan {top.chan}, band "
        f"{top.band}, SNR {top.snr:.1f} (tone at chan {chan})")
    if (top.drift_bins, top.chan, top.band) != (0, chan, TONE_CHAN):
        raise AssertionError("hi-res search: the top hit is not the tone")
    summary = search_summary(red, hdr, wall, dict(
        path="hi-res search", nfft=NFFT, window_spectra=HIRES_WINDOW,
        nbands=NCHAN, peak_device_gb=peak_gb))
    log(f"hi-res search: {json.dumps(summary)}")
    del red, hits
    torch.cuda.empty_cache()
    return launches, summary


def phase_drift(torch, dev, tmp):
    """(j): recover ±DRIFT_BINS-bin drifts injected with tone_drift_for.
    Returns the launch counts."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dedoppler as tpd
    from blit_torch.search import DedopplerReducer
    from blit_torch.testing import synth_raw, tone_drift_for

    T = 64
    ntime = (T * DRIFT_WINDOWS + NTAP - 1) * SEARCH_NFFT
    launches = {}
    for sign in (1, -1):
        drift = sign * DRIFT_BINS
        path = os.path.join(tmp, f"drift{drift:+d}.raw")
        synth_raw(path, nblocks=2, obsnchan=NCHAN, ntime_per_block=-(-ntime // 2),
                  seed=SEED + 5, tone_chan=TONE_CHAN,
                  tone_drift=tone_drift_for(SEARCH_NFFT, T, drift))
        red = DedopplerReducer(nfft=SEARCH_NFFT, window_spectra=T)
        reset_launches()
        hdr, hits = red.search(path)
        counts = read_launches()
        check_plan("drift", tch.last_kernel_plan(), counts,
                   tpd.kernel_route(T)[1] * DRIFT_WINDOWS)
        os.unlink(path)
        tops = top_hits(hits, DRIFT_WINDOWS)
        log(f"drift {drift:+d}: {ntime * NCHAN * 4 / 1e6:.1f} MB RAW, "
            f"top hits " + ", ".join(f"(window {h.window}: drift {h.drift_bins}, "
                                     f"band {h.band}, SNR {h.snr:.1f})" for h in tops))
        bad = [h for h in tops if h.band != TONE_CHAN or abs(h.drift_bins - drift) > 1]
        if hdr["search_windows"] != DRIFT_WINDOWS or bad:
            raise AssertionError(f"drift {drift:+d} not recovered: {bad}")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    torch.cuda.empty_cache()
    return launches


def bf_cost(nchan, nant, nbeam, npol, ntime, nint, esize):
    """fused_beamform_detect: voltages and weights read once, the
    integrated power written once; 8 flops per (beam, antenna, pol,
    sample) of complex products; the detection and integration (<1% more)
    are left out.  bf16 operands at the bf16 tensor-core rate; f32 at the
    tf32 tensor-core rate over three passes, the least time f32 products
    take on this card (the CUDA cores' 67 TFLOP/s is slower: the kernel
    computes its f32 products in three tf32 passes, so a bound at the CUDA
    cores' rate would let it run faster than its bound)."""
    nbytes = (2 * nchan * nant * npol * ntime * esize + 2 * nchan * nbeam * nant * esize
              + nchan * nbeam * npol * (ntime // nint) * 4)
    rate = BF16_TC_FLOPS if esize == 2 else F32_3XTF32_FLOPS
    return nbytes, [(8.0 * nchan * nbeam * nant * npol * ntime, rate)], None


def xe_cost(nant, nchan, npol, nframes, nfft, esize):
    """xengine_packed: the spectra read once, both visibility planes
    written once.  V is Hermitian, so the function needs 8 flops per (ap,
    bq, frame, fine channel) of one half, diagonal included: 4·nap·(nap+1)
    per (frame, fine channel).  The kernel computes every (ap, bq), 8·nap²
    (contract_ms).  f32 at the tf32 tensor-core rate over three passes,
    as bf_cost: the kernel's f32 products are three tf32 passes."""
    nap = nant * npol
    nbytes = (2 * nant * nchan * npol * nframes * nfft * esize
              + 2 * nchan * nfft * nap * nap * 4)
    rate = BF16_TC_FLOPS if esize == 2 else F32_3XTF32_FLOPS
    per = nframes * nchan * nfft
    return (nbytes, [(4.0 * nap * (nap + 1) * per, rate)],
            [(8.0 * nap * nap * per, rate)])


def write_antennas(tmp, tag, nchan, nsamples):
    """One RAW recording per antenna (synth_raw, two blocks, a tone in
    channel a % nchan, as bench.py writes them)."""
    from blit_torch.testing import synth_raw

    t0 = time.perf_counter()
    paths = []
    for a in range(ARRAY_NANT):
        path = os.path.join(tmp, f"{tag}{a}.raw")
        synth_raw(path, nblocks=2, obsnchan=nchan, ntime_per_block=nsamples // 2,
                  seed=300 + a, tone_chan=a % nchan)
        paths.append(path)
    log(f"{tag}: wrote {sum(map(os.path.getsize, paths)) / 1e9:.3f} GB RAW for "
        f"{ARRAY_NANT} antennas in {time.perf_counter() - t0:.1f} s")
    return paths


def check_array(path, plan, want_plan, launches, want_launches):
    """The array path took ``want_plan``, and each kernel of
    ``want_launches`` launched exactly as often as its windows predict."""
    got = {k: launches[k] for k in want_launches}
    log(f"{path}: plan {json.dumps(plan)} launches {json.dumps(got)}")
    if plan != want_plan:
        raise AssertionError(f"{path}: plan {plan}, want {want_plan}")
    if got != want_launches:
        raise AssertionError(f"{path}: launches {got}, want {want_launches}")


def phase_beamform(torch, dev, tmp):
    """(k): per-antenna RAW → tied-array beam power at the array scale.
    Returns (launch counts by path, kernel records)."""
    import numpy as np

    from blit_torch.ops import beamform as tbf
    from blit_torch.parallel import antenna as A
    from blit_torch.parallel import beamform as B

    total = BF_SAMPLES * BF_WINDOWS
    paths = write_antennas(tmp, "bf", BF_NCHAN, total)
    rng = np.random.default_rng(SEED)
    w = tbf.pack_weights(*B.delay_weights_planar(
        rng.uniform(0, 1e-9, (BF_NBEAM, ARRAY_NANT)),
        np.linspace(1e9, 1.1e9, BF_NCHAN), device=dev))
    fused = {"layout": "chan", "fused": True, "impl": "cuda"}
    counts = {}

    # The one-shot path: load_antennas + beamform.
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, v = A.load_antennas(paths, max_samples=BF_SAMPLES, layout="chan", device=dev)
    one = B.beamform(v, w, nint=BF_NINT, layout="chan", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["beamform"] = read_launches()
    check_array("beamform", B.last_beamform_plan(), fused, counts["beamform"],
                {"fused_beamform_detect": 1})
    if one.shape != (BF_NCHAN, BF_NBEAM, 2, BF_SAMPLES // BF_NINT):
        raise AssertionError(f"beamform: output shape {tuple(one.shape)}")
    want = tbf.fused_beamform_detect_plain(*v, *w, nint=BF_NINT)
    err, atol, ok = check_bound(torch, [one], [want], "fused_beamform_detect", "float32")
    nerr, natol, nok = check_bound(torch, [one], [want], "fused_beamform_detect",
                                   "float32", noise=want.median().item())
    log(f"beamform: one-shot {wall:.4f} s; vs the plain version max_abs_err "
        f"{err:.6g} (rtol 1e-4, atol {atol:.6g} = 1e-3 of the peak; {natol:.6g} "
        f"= 1e-3 of the median power: {nok})")
    if not (ok and nok):
        raise AssertionError("beamform: the one-shot path disagrees with the plain version")
    del one, want

    # The kernel against its plain version, f32 and bf16, timed.
    records = []
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        vv, ww = [x.to(td) for x in v], [x.to(td) for x in w]
        got = tbf.fused_beamform_detect(*vv, *ww, nint=BF_NINT)
        want = tbf.fused_beamform_detect_plain(*vv, *ww, nint=BF_NINT)
        err, atol, ok = check_bound(torch, [got], [want], "fused_beamform_detect", dtype)
        _, natol, nok = check_bound(torch, [got], [want], "fused_beamform_detect",
                                    dtype, noise=want.median().item())
        agg = {}
        if dtype == "bfloat16":
            # Control: the f32 weights, not rounded (the voltages are exact).
            control = tbf.fused_beamform_detect_plain(*v, *w, nint=BF_NINT)
            agg = bf16_aggregate(torch, [got], [want], [control])
            del control
        del got, want
        ms = median_ms(torch, lambda: tbf.fused_beamform_detect(*vv, *ww, nint=BF_NINT))
        plain_ms = median_ms(
            torch, lambda: tbf.fused_beamform_detect_plain(*vv, *ww, nint=BF_NINT), runs=5)
        extra = {}
        if dtype == "float32":
            # The matmul route: one complex torch.matmul per channel's
            # (nbeam, nant) x (nant, npol·ntime), then detect and integrate.
            z = torch.complex(*v).reshape(BF_NCHAN, ARRAY_NANT, -1)
            wz = torch.complex(*w)

            def route():
                b = torch.matmul(wz, z)
                p = b.real * b.real + b.imag * b.imag
                return p.reshape(BF_NCHAN, BF_NBEAM, 2, -1, BF_NINT).sum(-1)

            extra["matmul_route_ms"] = median_ms(torch, route)
            del z, wz
        torch.cuda.empty_cache()
        records.append(kernel_record(
            "fused_beamform_detect", dtype, "blit_torch/csrc/beamform_detect.cu",
            "blit/ops/pallas_beamform.py:108", err, atol,
            ok and nok and agg.get("rel_rms_ok", True), ms, plain_ms,
            bf_cost(BF_NCHAN, ARRAY_NANT, BF_NBEAM, 2, BF_SAMPLES, BF_NINT,
                    vv[0].element_size()), None,
            noise_atol=natol, library="none", **extra, **agg))
        del vv, ww
    del v
    # Untimed: antennas and beams off the MMA tiles (zero-padded), the
    # largest nint, both dtypes, against the plain version; voltages that
    # are not integers, so f32 runs all three tf32 passes.
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    odd = [torch.randn((4, 65, 2, 1024), device=dev, generator=gen) * 20
           for _ in range(2)] + [torch.randn((4, 17, 65), device=dev, generator=gen)
                                 for _ in range(2)]
    for dtype in ("float32", "bfloat16"):
        args = [x.to(getattr(torch, dtype)) for x in odd]
        got = tbf.fused_beamform_detect(*args, nint=128)
        want = tbf.fused_beamform_detect_plain(*args, nint=128)
        err, atol, ok = check_bound(torch, [got], [want], "fused_beamform_detect", dtype)
        _, natol, nok = check_bound(torch, [got], [want], "fused_beamform_detect", dtype,
                                    noise=want.median().item())
        log(f"beamform 65 antennas x 17 beams, nint 128, {dtype}: max_abs_err {err:.6g} "
            f"(atol {atol:.6g} = 1e-3 of the peak: {ok}; {natol:.6g} = 1e-3 of the "
            f"median power: {nok})")
        records.append(dict(name="fused_beamform_detect", dtype=dtype, ok=ok and nok,
                            max_abs_err=err, line=False, shape="65 x 17, nint 128"))
    del odd, args, got, want
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_beamform_detect disagrees with its plain version: {bad}")

    # beamform_stream over BF_WINDOWS windows, then the one-shot on the span.
    feed = A.AntennaStream(paths, window_samples=BF_SAMPLES, layout="chan", device=dev)
    reset_launches()
    t0 = time.perf_counter()
    slabs = list(B.beamform_stream(feed, w, nint=BF_NINT, layout="chan",
                                   timeline=feed.timeline, device=dev))
    wall = time.perf_counter() - t0
    counts["beamform stream"] = read_launches()
    check_array("beamform stream", B.last_beamform_plan(), fused,
                counts["beamform stream"], {"fused_beamform_detect": BF_WINDOWS})
    _, vall = A.load_antennas(paths, layout="chan", device=dev)
    whole = B.beamform(vall, w, nint=BF_NINT, layout="chan", device=dev)
    del vall
    equal = bool(torch.equal(torch.cat(slabs, dim=3), whole.cpu()))
    ingest = feed.timeline.stages["ingest"].bytes
    summary = dict(path="beamform stream", windows=feed.nwindows, samples=total,
                   wall_s=wall, raw_gb=ingest / 1e9, raw_gbps=ingest / wall / 1e9,
                   bitwise_equal_one_shot=equal, stages=stage_table(feed.timeline))
    log(f"beamform stream: {json.dumps(summary)}")
    if not equal:
        raise AssertionError("beamform stream: the slabs differ from the one-shot beamform")

    # beamform_accumulate over the same feed: each window integrated whole
    # (nint = 8192, past the kernel's gate: the matmul route, as in blit).
    feed = A.AntennaStream(paths, window_samples=BF_SAMPLES, layout="chan", device=dev)
    reset_launches()
    t0 = time.perf_counter()
    acc = B.beamform_accumulate(feed, w, layout="chan", timeline=feed.timeline,
                                device=dev)
    wall = time.perf_counter() - t0
    counts["beamform accumulate"] = read_launches()
    check_array("beamform accumulate", B.last_beamform_plan(),
                {"layout": "chan", "fused": False, "impl": "cuda"},
                counts["beamform accumulate"], {"fused_beamform_detect": 0})
    want = whole.sum(-1, keepdim=True)
    err, ok = check_close(torch, acc, want, 1e-4, 1e-3 * want.abs().max().item())
    log(f"beamform accumulate: {wall:.4f} s, vs the one-shot power summed "
        f"max_abs_err {err:.6g} (rtol 1e-4, atol 1e-3 of the peak): {ok}")
    if not ok:
        raise AssertionError("beamform accumulate disagrees with the one-shot power")
    del acc, whole, want, slabs, w
    torch.cuda.empty_cache()
    return counts, records


def correlate_plain(torch, v, h):
    """The correlator on the plain route: the F-engine's FIR, its DFT
    through dft_last's plain twin, then xengine_packed_plain."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import xengine as txe

    sign = torch.ones(h.shape[1], device=h.device)
    sign[1::2] = -1
    shifted = h * sign
    fr, fi = (tch.pfb_frontend(x.movedim(3, 2), shifted) for x in v)
    sr, si = tdft.dft(fr, fi, use_pallas=False)
    del fr, fi
    nant, nchan, npol, _, nfft = sr.shape
    shape6 = (nchan, nfft, nant, npol, nant, npol)
    return tuple(x.reshape(shape6) for x in txe.xengine_packed_plain(sr, si))


def phase_correlator(torch, dev, tmp):
    """(l): per-antenna RAW → packed FX visibilities at the array scale.
    Returns (launch counts by path, kernel records)."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import xengine as txe
    from blit_torch.parallel import antenna as A
    from blit_torch.parallel import correlator as C

    paths = write_antennas(tmp, "fx", FX_NCHAN, FX_SAMPLES)
    h = torch.from_numpy(tch.pfb_coeffs(NTAP, FX_NFFT)).to(dev)
    packed = {"layout": "packed", "engine": "cuda", "impl": "cuda"}
    nframes = FX_SAMPLES // FX_NFFT - NTAP + 1
    counts = {}

    # The one-shot path: load_correlator + correlate(vis_layout="packed").
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, v = A.load_correlator(paths, nfft=FX_NFFT, ntap=NTAP, device=dev)
    vis = C.correlate(v, h, nfft=FX_NFFT, ntap=NTAP, vis_layout="packed", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["correlate"] = read_launches()
    check_array("correlate", C.last_xengine_plan(), packed, counts["correlate"],
                {"xengine_packed": 1, "dft_last": 1})
    shape6 = (FX_NCHAN, FX_NFFT, ARRAY_NANT, 2, ARRAY_NANT, 2)
    if vis[0].shape != shape6 or not all(bool(torch.isfinite(x).all()) for x in vis):
        raise AssertionError(f"correlate: output shape {tuple(vis[0].shape)} or non-finite")
    want = correlate_plain(torch, v, h)
    # The tone (0.25 of the coarse channel, synth_raw's default) lies in
    # fine channel nfft/2 + nfft/4 after the fftshift; the noise level is
    # the rms of the visibilities in the other fine channels.
    tone = FX_NFFT // 2 + FX_NFFT // 4
    off = torch.ones(FX_NFFT, dtype=torch.bool, device=dev)
    off[tone] = False
    noise = rms(torch, [x[:, off] for x in want])
    peak = max(x.abs().max().item() for x in want)
    errs = [check_close(torch, a, b, 1e-4, 1e-3 * noise) for a, b in zip(vis, want)]
    err, ok = max(e[0] for e in errs), all(e[1] for e in errs)
    log(f"correlate: one-shot {wall:.4f} s; vs the plain route max_abs_err {err:.6g} "
        f"(rtol 1e-4, atol {1e-3 * noise:.6g} = 1e-3 of the noise rms; the peak "
        f"is {peak:.6g}): {ok}")
    if not ok:
        raise AssertionError("correlate: the one-shot path disagrees with the plain route")
    del want

    # dft_last at the F-engine's n = 512 on its FIR output, then the
    # X-engine against its plain version on the F-engine's spectra.
    sign = torch.ones(FX_NFFT, device=dev)
    sign[1::2] = -1
    fr, fi = (tch.pfb_frontend(x.movedim(3, 2), h * sign).contiguous() for x in v)
    records = [dft_last_record(torch, fr, fi, FX_NFFT, "correlate")]
    del fr, fi
    sr, si = C.f_engine_planar(v[0].movedim(3, 2), v[1].movedim(3, 2), h)
    for dtype in ("float32", "bfloat16"):
        xr, xi = sr.to(getattr(torch, dtype)), si.to(getattr(torch, dtype))
        want = txe.xengine_packed_plain(xr, xi)
        got = txe.xengine_packed(xr, xi)
        err, atol, ok = check_bound(torch, got, want, "xengine_packed",
                                    dtype, inputs=(sr, si))
        # The mirrored half is exactly the conjugate transpose.
        herm = bool(torch.equal(got[0], got[0].mT)
                    and torch.equal(got[1], -got[1].mT))
        del got
        agg = {}
        if dtype == "bfloat16":
            # Control: the f32 spectra, not rounded, with the visibilities
            # rounded at their store (as (c)'s pfb_dft1 control).  The
            # spectra's rounding alone averages down over the frames, to
            # about the bound.
            got = txe.xengine_packed(xr, xi)
            control = [x.to(torch.bfloat16) for x in txe.xengine_packed_plain(sr, si)]
            agg = bf16_aggregate(torch, got, want, control)
            del control, got
        del want
        torch.cuda.empty_cache()
        ms = median_ms(torch, lambda: txe.xengine_packed(xr, xi))
        plain_ms = median_ms(torch, lambda: txe.xengine_packed_plain(xr, xi), runs=5)
        lib_ms = None
        if dtype == "float32":
            # One PyTorch call for the function: the packed spectra
            # (nchan·nfft, nap, nframes) times their conjugate transpose.
            x = torch.complex(sr, si).permute(1, 4, 0, 2, 3).reshape(
                FX_NCHAN * FX_NFFT, 2 * ARRAY_NANT, nframes).contiguous()
            xh = x.transpose(-1, -2).conj()
            lib_ms = median_ms(torch, lambda: torch.matmul(x, xh))
            del x, xh
        torch.cuda.empty_cache()
        records.append(kernel_record(
            "xengine_packed", dtype, "blit_torch/csrc/xengine.cu",
            "blit/ops/pallas_xengine.py:119", err, atol,
            ok and herm and agg.get("rel_rms_ok", True), ms,
            plain_ms,
            xe_cost(ARRAY_NANT, FX_NCHAN, 2, nframes, FX_NFFT, xr.element_size()),
            lib_ms, library="torch.matmul(complex64 packed spectra, conj transpose)",
            hermitian=herm,
            arithmetic="bf16 MMA" if dtype == "bfloat16" else "three tf32 MMA passes",
            **agg))
        del xr, xi
    del sr, si
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"xengine_packed disagrees with its plain version: {bad}")

    # correlate_stream over windows of FX_WINDOW_FRAMES frames, then the
    # one-shot at the same accumulation.
    feed = A.CorrelatorStream(paths, nfft=FX_NFFT, ntap=NTAP,
                              window_frames=FX_WINDOW_FRAMES, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    svis = C.correlate_stream(feed, h, nfft=FX_NFFT, ntap=NTAP, vis_layout="packed",
                              timeline=feed.timeline, device=dev)
    wall = time.perf_counter() - t0
    counts["correlate stream"] = read_launches()
    check_array("correlate stream", C.last_xengine_plan(), packed,
                counts["correlate stream"],
                {"xengine_packed": feed.nwindows, "dft_last": feed.nwindows})
    acc = C.correlate(v, h, nfft=FX_NFFT, ntap=NTAP, vis_layout="packed",
                      acc_frames=FX_WINDOW_FRAMES, device=dev)
    equal = all(bool(torch.equal(a, b)) for a, b in zip(svis, acc))
    ingest = feed.timeline.stages["ingest"].bytes
    summary = dict(path="correlate stream", windows=feed.nwindows,
                   window_frames=FX_WINDOW_FRAMES, frames=nframes, wall_s=wall,
                   raw_gb=ingest / 1e9, raw_gbps=ingest / wall / 1e9,
                   bitwise_equal_acc_frames=equal, stages=stage_table(feed.timeline))
    log(f"correlate stream: {json.dumps(summary)}")
    if not equal:
        raise AssertionError("correlate stream differs from correlate(acc_frames)")
    del v, vis, svis, acc
    torch.cuda.empty_cache()
    return counts, records


# -- (n) the asynchronous plane -----------------------------------------------

PLANE_REPEATS = 3          # async and sync runs of each product, in turns
PLANE_DEPTHS = (1, 2, 3)   # feed depths of the array streams (1: synchronous)
QUANT_NBITS = 8
QUANT_MEDIAN_TO = 100.0    # quant_scale maps the f32 product's median here
QUANT_OFFSET = 3.0


def plane_summary(tl, wall, **extra) -> dict:
    """RAW GB/s over the loop's wall, the stage table, the overlap
    efficiency and the host staging allocations of one plane run."""
    st = tl.stages
    stream_s = st["stream"].seconds
    alloc = st["staging.alloc"]
    return dict(extra, wall_s=wall, raw_gb=st["ingest"].bytes / 1e9,
                raw_gbps=st["ingest"].bytes / stream_s / 1e9 if stream_s else 0.0,
                overlap_efficiency=tl.overlap_efficiency(),
                staging_alloc_s=alloc.seconds, staging_allocs=alloc.calls,
                staging_alloc_gb=alloc.bytes / 1e9, stages=stage_table(tl))


def same_file(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def plane_reduce(torch, raw_path, tmp, product, mode, tag, **kw):
    """One reduce_to_file of ``product`` in ``mode`` ("async" | "sync"),
    its launches counted alone.  Returns (path, launches, summary)."""
    from blit_torch.ops import channelize as tch
    from blit_torch.pipeline import reducer_for_product

    path = os.path.join(tmp, f"plane.{product}.{tag}.{mode}.fil")
    red = reducer_for_product(product, async_output=mode == "async",
                              **PRODUCTS[product], **kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    red.reduce_to_file(raw_path, path)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_plan(product, tch.last_kernel_plan(), launches)
    summary = plane_summary(red.timeline, wall, path=product, mode=mode,
                            nbits=red.nbits)
    log(f"plane {product} {tag} {mode}: {json.dumps(summary)}")
    return path, launches, summary


def phase_plane_products(torch, dev, raw_path, tmp):
    """(n) on the recording: each product through reduce_to_file on the
    asynchronous plane and on the synchronous path, in turns,
    PLANE_REPEATS times: the .fil files byte-identical, the launches
    equal; 0002 at nbits=8 the same way, its bytes also equal to the host
    narrowing of the f32 product, and narrow_device on the card bitwise
    equal to narrow_host at nbits 8 and 16; then the search, async
    against sync, in turns, PLANE_REPEATS times, the .hits identical.
    Returns the summaries."""
    import numpy as np

    from blit_torch.io.sigproc import read_fil
    from blit_torch.ops.narrow import narrow_device, narrow_host

    rows = []
    for product in PRODUCTS:
        for rep in range(PLANE_REPEATS):
            got = {}
            for mode in (("async", "sync") if rep % 2 == 0 else ("sync", "async")):
                path, launches, summary = plane_reduce(torch, raw_path, tmp, product,
                                                       mode, f"run{rep + 1}")
                got[mode] = (path, launches)
                rows.append(summary)
            identical = same_file(got["async"][0], got["sync"][0])
            log(f"plane {product} run {rep + 1}: async .fil byte-identical to sync: "
                f"{identical}; launches async {json.dumps(got['async'][1])} sync "
                f"{json.dumps(got['sync'][1])}")
            if not identical:
                raise AssertionError(f"plane {product}: the async .fil differs from the sync one")
            if got["async"][1] != got["sync"][1]:
                raise AssertionError(f"plane {product}: async and sync ran other kernels")
            if product == "0002" and rep == 0:
                f32_path = got["sync"][0]  # kept for the quantized runs
                os.unlink(got["async"][0])
            else:
                for path, _ in got.values():
                    os.unlink(path)

    # 0002 quantized: the scale maps the f32 product's median to
    # QUANT_MEDIAN_TO.
    _, f32 = read_fil(f32_path)
    f32 = np.array(f32)
    scale = float(QUANT_MEDIAN_TO / np.median(f32))
    q = dict(nbits=QUANT_NBITS, quant_scale=scale, quant_offset=QUANT_OFFSET)
    got = {}
    for mode in ("async", "sync"):
        path, launches, summary = plane_reduce(torch, raw_path, tmp, "0002", mode,
                                               "nbits8", **q)
        got[mode] = (path, launches)
        rows.append(summary)
    _, data = read_fil(got["async"][0])
    want = narrow_host(f32, QUANT_NBITS, scale, QUANT_OFFSET)
    identical = same_file(got["async"][0], got["sync"][0])
    host_equal = bool(np.array_equal(np.asarray(data), want))
    clipped = float((want == 255).mean())
    log(f"plane 0002 nbits={QUANT_NBITS} quant_scale={scale!r} "
        f"quant_offset={QUANT_OFFSET!r}: async .fil byte-identical to sync: "
        f"{identical}; data bitwise narrow_host(f32 product): {host_equal}; "
        f"share at 255: {clipped:.4g}; dtype {data.dtype}")
    if not (identical and host_equal and data.dtype == np.uint8):
        raise AssertionError("plane 0002 nbits=8: the quantized products differ")
    if got["async"][1] != got["sync"][1]:
        raise AssertionError("plane 0002 nbits=8: async and sync ran other kernels")
    for path, _ in got.values():
        os.unlink(path)
    x = torch.from_numpy(f32).to(dev)
    for nbits in (8, 16):
        for s, o in ((scale, QUANT_OFFSET), (scale * 0.5, 0.5)):
            dev_q = narrow_device(x, nbits, s, o).cpu().numpy()
            ok = bool(np.array_equal(dev_q, narrow_host(f32, nbits, s, o)))
            log(f"narrow_device on the card, nbits={nbits}, scale {s!r}, offset {o!r}: "
                f"bitwise narrow_host: {ok} ({dev_q.dtype})")
            if not ok:
                raise AssertionError(f"narrow_device nbits={nbits} differs from narrow_host")
    del x
    os.unlink(f32_path)

    # The search, async against sync, in turns.
    for rep in range(PLANE_REPEATS):
        rows += plane_search(torch, raw_path, tmp, rep)
    return rows


def plane_search(torch, raw_path, tmp, rep):
    """One async and one sync search_to_file (order by ``rep``): the .hits
    identical, the launches equal.  Returns the two summaries."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dedoppler as tpd
    from blit_torch.search import DedopplerReducer

    rows = []
    got = {}
    for mode in (("async", "sync") if rep % 2 == 0 else ("sync", "async")):
        red = DedopplerReducer(nfft=SEARCH_NFFT, nint=1, async_output=mode == "async")
        out = os.path.join(tmp, f"plane.{mode}.hits")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hdr = red.search_to_file(raw_path, out)
        wall = time.perf_counter() - t0
        launches = read_launches()
        windows = hdr["search_windows"]
        check_plan("search", tch.last_kernel_plan(), launches,
                   tpd.kernel_route(red.window_spectra)[1] * windows)
        summary = plane_summary(red.timeline, wall, path="search", mode=mode,
                                windows=windows, hits=hdr["search_nhits"])
        log(f"plane search run{rep + 1} {mode}: {json.dumps(summary)}")
        rows.append(summary)
        got[mode] = (out, launches)
    identical = same_file(got["async"][0], got["sync"][0])
    log(f"plane search run {rep + 1}: async .hits identical to sync: {identical}")
    if not identical:
        raise AssertionError("plane search: the async .hits differ from the sync ones")
    if got["async"][1] != got["sync"][1]:
        raise AssertionError("plane search: async and sync ran other kernels")
    for path, _ in got.values():
        os.unlink(path)
    return rows


PLANE_STAGES = ("ingest", "state", "dispatch", "device", "readback", "write",
                "search.window_fill", "search.write", "stream", "staging.alloc")


def plane_table(rows) -> list:
    """(n)'s runs grouped by path and mode (or feed depth): RAW GB/s
    median and range, the median seconds of each stage, the median
    overlap efficiency, and the host staging allocations summed."""
    import statistics

    groups = {}
    for r in rows:
        mode = r.get("mode") or f"depth {r['prefetch_depth']}"
        if r.get("nbits", 32) != 32:
            mode += f" nbits={r['nbits']}"
        groups.setdefault((r["path"], mode), []).append(r)
    table = []
    for (path, mode), rs in groups.items():
        rates = [r["raw_gbps"] for r in rs]
        table.append(dict(
            path=path, mode=mode, runs=len(rs),
            raw_gbps_median=statistics.median(rates),
            raw_gbps_range=[min(rates), max(rates)],
            stage_s_median={k: statistics.median(r["stages"].get(k, {}).get("s", 0.0)
                                                 for r in rs)
                            for k in PLANE_STAGES},
            overlap_efficiency_median=statistics.median(
                r["overlap_efficiency"] for r in rs),
            staging_alloc_s_sum=sum(r["staging_alloc_s"] for r in rs),
            staging_allocs_sum=sum(r["staging_allocs"] for r in rs),
            staging_alloc_gb_sum=sum(r["staging_alloc_gb"] for r in rs)))
    return table


def plane_depth_turns() -> list:
    """PLANE_DEPTHS PLANE_REPEATS times, every other pass reversed."""
    return [d for rep in range(PLANE_REPEATS)
            for d in (PLANE_DEPTHS if rep % 2 == 0 else PLANE_DEPTHS[::-1])]


def phase_plane_array(torch, dev, tmp):
    """(n) on the array recordings of (k) and (l): beamform_stream and
    correlate_stream at feed depths PLANE_DEPTHS (1: the synchronous
    feed), in turns, PLANE_REPEATS times, each bitwise equal to the
    one-shot form, the launches equal.  Returns the summaries."""
    import numpy as np

    from blit_torch.ops import beamform as tbf
    from blit_torch.ops import channelize as tch
    from blit_torch.parallel import antenna as A
    from blit_torch.parallel import beamform as B
    from blit_torch.parallel import correlator as C

    rows = []
    bf_paths = [os.path.join(tmp, f"bf{a}.raw") for a in range(ARRAY_NANT)]
    rng = np.random.default_rng(SEED)
    w = tbf.pack_weights(*B.delay_weights_planar(
        rng.uniform(0, 1e-9, (BF_NBEAM, ARRAY_NANT)),
        np.linspace(1e9, 1.1e9, BF_NCHAN), device=dev))
    _, vall = A.load_antennas(bf_paths, layout="chan", device=dev)
    whole = B.beamform(vall, w, nint=BF_NINT, layout="chan", device=dev).cpu()
    del vall
    fused = {"layout": "chan", "fused": True, "impl": "cuda"}
    for depth in plane_depth_turns():
        feed = A.AntennaStream(bf_paths, window_samples=BF_SAMPLES, layout="chan",
                               prefetch_depth=depth, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with feed.timeline.stage("stream"):  # the call's wall
            slabs = list(B.beamform_stream(feed, w, nint=BF_NINT, layout="chan",
                                           timeline=feed.timeline, device=dev))
        wall = time.perf_counter() - t0
        check_array(f"plane beamform stream depth {depth}", B.last_beamform_plan(),
                    fused, read_launches(), {"fused_beamform_detect": BF_WINDOWS})
        equal = bool(torch.equal(torch.cat(slabs, dim=3), whole))
        summary = plane_summary(feed.timeline, wall, path="beamform stream",
                                prefetch_depth=depth, bitwise_equal_one_shot=equal)
        log(f"plane beamform stream depth {depth}: {json.dumps(summary)}")
        rows.append(summary)
        if not equal:
            raise AssertionError(f"plane beamform stream depth {depth} differs "
                                 "from the one-shot beamform")
    del whole, slabs, w

    fx_paths = [os.path.join(tmp, f"fx{a}.raw") for a in range(ARRAY_NANT)]
    h = torch.from_numpy(tch.pfb_coeffs(NTAP, FX_NFFT)).to(dev)
    _, v = A.load_correlator(fx_paths, nfft=FX_NFFT, ntap=NTAP, device=dev)
    acc = C.correlate(v, h, nfft=FX_NFFT, ntap=NTAP, vis_layout="packed",
                      acc_frames=FX_WINDOW_FRAMES, device=dev)
    del v
    packed = {"layout": "packed", "engine": "cuda", "impl": "cuda"}
    for depth in plane_depth_turns():
        feed = A.CorrelatorStream(fx_paths, nfft=FX_NFFT, ntap=NTAP,
                                  window_frames=FX_WINDOW_FRAMES,
                                  prefetch_depth=depth, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with feed.timeline.stage("stream"):  # the call's wall
            svis = C.correlate_stream(feed, h, nfft=FX_NFFT, ntap=NTAP,
                                      vis_layout="packed", timeline=feed.timeline,
                                      device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_array(f"plane correlate stream depth {depth}", C.last_xengine_plan(),
                    packed, read_launches(),
                    {"xengine_packed": feed.nwindows, "dft_last": feed.nwindows})
        equal = all(bool(torch.equal(a, b)) for a, b in zip(svis, acc))
        summary = plane_summary(feed.timeline, wall, path="correlate stream",
                                prefetch_depth=depth, bitwise_equal_acc_frames=equal)
        log(f"plane correlate stream depth {depth}: {json.dumps(summary)}")
        rows.append(summary)
        if not equal:
            raise AssertionError(f"plane correlate stream depth {depth} differs "
                                 "from correlate(acc_frames)")
    del acc, svis
    torch.cuda.empty_cache()
    return rows


# -- (o) resume, scans, the native reader, .h5 products ----------------------

SCAN_MEMBERS = 3           # members of (o2)'s scan
NATIVE_REPEATS = 3         # (o3): native and Python 0002 runs, in turns
RESUME_BITSHUFFLE_ROWS = CHUNK_FRAMES  # (o4): one 0000 chunk per h5 chunk
SEARCH_RESUME_AFTER = 20   # (o5): windows written before the fault


def _timed_reduce(torch, red, method, src, out, path, **kw):
    """``red.<method>(src, out)`` with the launches counted alone and the
    path's plan checked.  Returns (header, seconds, launches)."""
    from blit_torch.ops import channelize as tch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    hdr = getattr(red, method)(src, out, **kw)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_plan(path, tch.last_kernel_plan(), launches)
    return hdr, wall, launches


def _interrupted(torch, point, after, match, fn):
    """Run ``fn`` under a FaultRule failing ``point`` after ``after`` hits
    of paths containing ``match``; it must raise the injected fault.
    Returns (seconds, launches)."""
    from blit_torch import faults

    faults.install(faults.FaultRule(point, mode="fail", after=after,
                                    times=-1, match=match))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        fn()
    except faults.InjectedFault as e:
        log(f"resume: interrupted as planned: {e}")
    else:
        raise AssertionError(f"the {point} fault after {after} did not interrupt the run")
    finally:
        faults.clear()
    return time.perf_counter() - t0, read_launches()


def split_recording(raw_path, tmp, members, stem="scan"):
    """Copy the recording's blocks, byte for byte, into ``members``
    ``<stem>.NNNN.raw`` files in ``tmp``.  Returns their paths."""
    from blit_torch.io.guppi import GuppiRaw

    raw = GuppiRaw(raw_path, native=False)
    ends = [off + h["BLOCSIZE"] for off, h in zip(raw._data_offsets, raw.headers)]
    starts = [0] + ends[:-1]
    per = -(-raw.nblocks // members)
    paths = []
    with open(raw_path, "rb") as src:
        for m in range(members):
            blocks = range(m * per, min(raw.nblocks, (m + 1) * per))
            path = os.path.join(tmp, f"{stem}.{m:04d}.raw")
            with open(path, "wb") as dst:
                src.seek(starts[blocks[0]])
                n = ends[blocks[-1]] - starts[blocks[0]]
                while n:
                    buf = src.read(min(n, 64 << 20))
                    if not buf:
                        raise OSError(f"{raw_path} ended {n} bytes short")
                    dst.write(buf)
                    n -= len(buf)
            paths.append(path)
    return paths


def phase_resume(torch, dev, raw_path, tmp):
    """(o) on (d)'s recording: (o1) 0000 through reduce_resumable,
    interrupted at the sink after the first slab and resumed, byte-identical
    to (d)'s uninterrupted product, manifest verified; (o2) the recording
    split into a three-member scan, 0002 over it byte-identical to (d)'s,
    every member on the native reader, and again under a transient
    guppi.read fault; (o3) 0002 with native=True and native=False, in
    turns, three times each, RAW GB/s and ingest seconds; (o4) 0000 to .h5
    (none; bitshuffle, also interrupted and resumed) decoding to (o1)'s
    payload, when h5py imports; (o5) the search (h) interrupted after
    SEARCH_RESUME_AFTER windows and resumed, equal to (h)'s .hits.
    Returns the launches of each leg."""
    import numpy as np

    from blit_torch import faults, integrity
    from blit_torch.io import bshuf
    from blit_torch.io.guppi import GuppiRaw, GuppiScan
    from blit_torch.io.sigproc import read_fil
    from blit_torch.pipeline import ReductionCursor, reducer_for_product
    from blit_torch.search import DedopplerReducer, SearchCursor

    launches = {}
    ref0000 = os.path.join(tmp, "smoke.0000.fil")
    ref0002 = os.path.join(tmp, "smoke.0002.fil")

    # (o1) .fil resume at full width.
    out = os.path.join(tmp, "resume.0000.fil")
    red = reducer_for_product("0000", **PRODUCTS["0000"])
    first_s, launches["resume 0000 leg 1"] = _interrupted(
        torch, "sink.write", 1, "resume.0000",
        lambda: red.reduce_resumable(raw_path, out))
    cur = ReductionCursor.load(out)
    if cur is None or not os.path.exists(ReductionCursor.path_for(out)):
        raise AssertionError("resume 0000: no cursor sidecar after the interruption")
    done = cur.frames_done
    total = tch_usable(NFFT, 1)
    red = reducer_for_product("0000", **PRODUCTS["0000"])
    hdr, second_s, launches["resume 0000 leg 2"] = _timed_reduce(
        torch, red, "reduce_resumable", raw_path, out, "0000")
    identical = same_file(out, ref0000)
    cursor_gone = not os.path.exists(ReductionCursor.path_for(out))
    _, problems = integrity.verify_product(out)
    log(f"resume 0000: cursor claimed {done} of {total} frames; the resume "
        f"re-reduced {total - done} frames; leg 1 {first_s:.3f} s, leg 2 "
        f"{second_s:.3f} s; byte-identical to the uninterrupted product: "
        f"{identical}; cursor removed: {cursor_gone}; verify_product problems: "
        f"{problems}; launches leg 2 {json.dumps(launches['resume 0000 leg 2'])}")
    if not (identical and cursor_gone and problems == [] and 0 < done < total
            and hdr["nsamps"] == total):
        raise AssertionError("resume 0000: the resumed product is not the uninterrupted one")
    os.unlink(out)
    os.unlink(integrity.manifest_path(out))

    # (o2) a three-member scan.
    t0 = time.perf_counter()
    paths = split_recording(raw_path, tmp, SCAN_MEMBERS)
    split_s = time.perf_counter() - t0
    scan = GuppiScan(paths)
    natives = [f.native for f in scan.files]
    log(f"scan: {len(paths)} members of {[GuppiRaw(p, native=False).nblocks for p in paths]} "
        f"blocks written in {split_s:.2f} s; native reader per member {natives}")
    if not all(natives):
        raise AssertionError(f"scan: a member did not take the native reader: {natives}")
    for tag, rule in (("clean", None),
                      ("guppi.read fault", faults.FaultRule("guppi.read", mode="fail",
                                                            times=1, after=3))):
        out = os.path.join(tmp, f"scan.0002.{tag.split()[0]}.fil")
        faults.reset_counters()
        if rule is not None:
            faults.install(rule)
        try:
            red = reducer_for_product("0002", **PRODUCTS["0002"])
            _, wall, launches[f"scan 0002 {tag}"] = _timed_reduce(
                torch, red, "reduce_to_file", paths, out, "0002")
        finally:
            faults.clear()
        retries = faults.counters().get("retry.io", 0)
        identical = same_file(out, ref0002)
        gbps = red.stats.gbps
        log(f"scan 0002 ({tag}): {wall:.3f} s, RAW GB/s {gbps:.4g}; byte-identical "
            f"to the single-file product: {identical}; retry.io {retries}")
        if not identical or (rule is not None and retries < 1):
            raise AssertionError(f"scan 0002 ({tag}): product differs or no retry counted")
        os.unlink(out)
        os.unlink(integrity.manifest_path(out))
    for p in paths:
        os.unlink(p)

    # (o3) the native reader against the Python one, 0002, in turns.
    runs = []
    for rep in range(NATIVE_REPEATS):
        for native in ((True, False) if rep % 2 == 0 else (False, True)):
            out = os.path.join(tmp, f"native.{native}.fil")
            raw = GuppiRaw(raw_path, native=native)
            red = reducer_for_product("0002", **PRODUCTS["0002"])
            _, wall, lc = _timed_reduce(torch, red, "reduce_to_file", raw, out, "0002")
            launches[f"0002 native={native} run {rep + 1}"] = lc
            ing = red.timeline.stages["ingest"]
            row = dict(native=native, run=rep + 1, wall_s=wall, raw_gbps=red.stats.gbps,
                       ingest_s=ing.seconds, ingest_gbps=ing.gbps,
                       identical=same_file(out, ref0002))
            log(f"native reader: {json.dumps(row)}")
            runs.append(row)
            raw.close()
            os.unlink(out)
            os.unlink(integrity.manifest_path(out))
            if not row["identical"]:
                raise AssertionError(f"0002 native={native}: product differs")
    for native in (True, False):
        g = sorted(r["raw_gbps"] for r in runs if r["native"] is native)
        i = sorted(r["ingest_s"] for r in runs if r["native"] is native)
        log(f"native reader table: native={native} RAW GB/s median {g[len(g) // 2]:.4g} "
            f"range {g[0]:.4g}-{g[-1]:.4g}; ingest s median {i[len(i) // 2]:.4g} "
            f"range {i[0]:.4g}-{i[-1]:.4g}")
    os.unlink(ref0002)
    os.unlink(integrity.manifest_path(ref0002))

    # (o4) .h5 products, where h5py imports.
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        codec = ("builds (g++, liblz4.so.1)" if bshuf.available()
                 else f"is unavailable: {bshuf.unavailable_reason()}")
        log(f"h5: skipped, h5py is missing on this machine ({e}); the "
            f"bitshuffle codec {codec}")
    else:
        from blit_torch.io.fbh5 import read_fbh5_data

        _, want = read_fil(ref0000)
        legs = [("none", None, None)]
        if bshuf.available():
            legs.append(("bitshuffle", "bitshuffle",
                         (RESUME_BITSHUFFLE_ROWS, 1, NCHAN * NFFT)))
        else:
            log(f"h5: bitshuffle leg skipped, codec unavailable: "
                f"{bshuf.unavailable_reason()}")
        for tag, comp, chunks in legs:
            out = os.path.join(tmp, f"smoke.0000.{tag}.h5")
            red = reducer_for_product("0000", **PRODUCTS["0000"])
            _, wall, launches[f"h5 0000 {tag}"] = _timed_reduce(
                torch, red, "reduce_to_file", raw_path, out, "0000",
                compression=comp, chunks=chunks)
            t0 = time.perf_counter()
            equal = bool(np.array_equal(read_fbh5_data(out), want))
            read_s = time.perf_counter() - t0
            size = os.path.getsize(out)
            log(f"h5 0000 {tag}: write {wall:.3f} s, {size / 1e9:.4g} GB, decode "
                f"{read_s:.3f} s; payload bitwise the .fil payload: {equal}")
            if not equal:
                raise AssertionError(f"h5 0000 {tag}: payload differs from the .fil")
            os.unlink(out)
            os.unlink(integrity.manifest_path(out))
            if comp != "bitshuffle":
                continue
            out = os.path.join(tmp, "resume.0000.bitshuffle.h5")
            red = reducer_for_product("0000", **PRODUCTS["0000"])
            first_s, launches["h5 resume leg 1"] = _interrupted(
                torch, "sink.write", 1, "resume.0000.bitshuffle",
                lambda: red.reduce_resumable(raw_path, out, compression=comp,
                                             chunks=chunks))
            done = ReductionCursor.load(out).frames_done
            red = reducer_for_product("0000", **PRODUCTS["0000"])
            _, second_s, launches["h5 resume leg 2"] = _timed_reduce(
                torch, red, "reduce_resumable", raw_path, out, "0000",
                compression=comp, chunks=chunks)
            equal = bool(np.array_equal(read_fbh5_data(out), want))
            _, problems = integrity.verify_product(out)
            log(f"h5 resume 0000 bitshuffle: claimed {done} frames; leg 1 {first_s:.3f} s, "
                f"leg 2 {second_s:.3f} s; payload bitwise the .fil payload: {equal}; "
                f"verify_product problems: {problems}")
            if not (equal and problems == [] and done > 0):
                raise AssertionError("h5 resume 0000 bitshuffle: resumed payload differs")
            os.unlink(out)
            os.unlink(integrity.manifest_path(out))
        del want
    os.unlink(ref0000)
    os.unlink(integrity.manifest_path(ref0000))

    # (o5) the search, interrupted and resumed.
    ref_hits = os.path.join(tmp, "smoke.hits")
    out = os.path.join(tmp, "resume.hits")
    red = DedopplerReducer(nfft=SEARCH_NFFT, nint=1)
    first_s, launches["resume search leg 1"] = _interrupted(
        torch, "sink.write", SEARCH_RESUME_AFTER, "resume.hits",
        lambda: red.search_resumable(raw_path, out))
    done = SearchCursor.load(out).windows_done
    red = DedopplerReducer(nfft=SEARCH_NFFT, nint=1)
    hdr, second_s, launches["resume search leg 2"] = _timed_reduce(
        torch, red, "search_resumable", raw_path, out, "search")
    identical = same_file(out, ref_hits)
    _, problems = integrity.verify_product(out)
    log(f"resume search: cursor claimed {done} of {hdr['search_windows']} windows; "
        f"leg 1 {first_s:.3f} s, leg 2 {second_s:.3f} s; .hits byte-identical to "
        f"the uninterrupted search_to_file: {identical}; verify_product problems: "
        f"{problems}")
    if not (identical and problems == [] and 0 < done < hdr["search_windows"]):
        raise AssertionError("resume search: the resumed .hits differ")
    os.unlink(out)
    os.unlink(integrity.manifest_path(out))
    return launches


LIVE_DROP_BLOCK = 5          # (q3): the block whose every packet is dropped
LIVE_TUNE_TRIALS = 3         # (q6): the cut sweep of the tune command
LIVE_MONITOR_INTERVAL = 0.5  # (q7): the publisher's cadence, seconds
CLI_DEVICE = "cuda"          # (q6): --device of the command line's runs


def _live_leg(torch, path, fn):
    """``fn()`` with the launches counted alone; returns (result, wall,
    launches).  The plan check is the batch path ``path``'s."""
    from blit_torch.ops import channelize as tch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_plan(path, tch.last_kernel_plan(), launches)
    return out, wall, launches


def live_summary(red, hdr, wall, **extra) -> dict:
    """Wall, RAW GB/s over it, chunk-to-product p50/p99, the peak
    watermark lag and the masked chunks of one live run."""
    tl = red.timeline
    lat = tl.hists["stream.chunk_to_product_s"]
    lag = tl.gauges["stream.watermark_lag_s"]
    raw_gb = tl.stages["ingest"].bytes / 1e9
    return dict(extra, wall_s=wall, raw_gb=raw_gb, raw_gbps=raw_gb / wall,
                chunk_to_product_n=lat.n,
                chunk_to_product_p50_s=lat.percentile(0.5),
                chunk_to_product_p99_s=lat.percentile(0.99),
                chunk_to_product_max_s=lat.vmax,
                watermark_lag_peak_s=lag.hi,
                masked_chunks=hdr["stream_masked_chunks"],
                late_chunks=hdr["stream_late_chunks"])


def _block_spans(raw_path):
    """(start, end) byte offsets of each block (header and payload) and
    each block's payload offset, of a RAW file."""
    from blit_torch.io.guppi import GuppiRaw

    raw = GuppiRaw(raw_path, native=False)
    ends = [off + h["BLOCSIZE"] for off, h in zip(raw._data_offsets, raw.headers)]
    spans = list(zip([0] + ends[:-1], ends))
    offsets = list(raw._data_offsets)
    tbin = float(raw.header(0)["TBIN"])
    npol = 2 if raw.header(0)["NPOL"] > 2 else raw.header(0)["NPOL"]
    raw.close()
    return spans, offsets, tbin, NCHAN * npol * 2


def _grow(raw_path, live_path, done_path, gbps, spans):
    """Append the recording's blocks to ``live_path`` at ``gbps`` (a
    recorder's cadence), then write the done marker.  Returns the
    writer thread and a dict that receives its wall and any error."""
    import threading

    state = {}

    def run():
        try:
            t0 = time.perf_counter()
            sent = 0
            with open(raw_path, "rb") as src, open(live_path, "wb") as dst:
                for a, b in spans:
                    src.seek(a)
                    dst.write(src.read(b - a))
                    dst.flush()
                    sent += b - a
                    ahead = sent / (gbps * 1e9) - (time.perf_counter() - t0)
                    if ahead > 0:
                        time.sleep(ahead)
            with open(done_path, "w"):
                pass
            state["wall_s"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — re-raised by the reader
            state["error"] = e

    t = threading.Thread(target=run, name="smoke-recorder", daemon=True)
    t.start()
    return t, state


def _product_rows(path):
    """The .fil product's header bytes and its rows as bytes."""
    from blit_torch.io.sigproc import read_fil_header

    hdr, off = read_fil_header(path)
    with open(path, "rb") as f:
        head = f.read(off)
        body = f.read()
    row = hdr["nchans"] * hdr.get("nifs", 1) * hdr["nbits"] // 8
    return head, [body[i:i + row] for i in range(0, len(body), row)]


def degraded_rows_of(a, b, nfft, ntap, nint):
    """The output rows whose PFB windows touch gap-free samples [a, b):
    frame f reads samples [f·nfft, (f+ntap)·nfft)."""
    f_lo = max(0, (a - ntap * nfft) // nfft + 1)
    f_hi = (b - 1) // nfft
    return set(range(f_lo // nint, f_hi // nint + 1))


def phase_live(torch, dev, raw_path, tmp, batch_launches, smi):
    """(q) the live plane on (d)'s recording, against (d)'s and (h)'s
    batch products (smoke.0000.fil, smoke.0002.fil, smoke.hits).
    Returns the launches of each leg."""
    import subprocess

    from blit_torch import faults, integrity, monitor
    from blit_torch.pipeline import reducer_for_product
    from blit_torch.search import DedopplerReducer
    from blit_torch.stream import (
        FileTailSource,
        PacketReplaySource,
        ReplaySource,
        StreamCursor,
        stream_reduce,
        stream_search,
    )

    launches = {}
    rows = []
    ref0000 = os.path.join(tmp, "smoke.0000.fil")
    ref0002 = os.path.join(tmp, "smoke.0002.fil")
    ref_hits = os.path.join(tmp, "smoke.hits")
    spans, offsets, tbin, bytes_per_sample = _block_spans(raw_path)
    # ReplaySource paces block i at its cumulative samples · TBIN / rate:
    # this rate delivers a bank's 0.75 GB/s.
    realtime_rate = REALTIME_BANK_GBPS * 1e9 / bytes_per_sample * tbin

    def cleanup(*paths):
        for q in paths:
            for f in (q, integrity.manifest_path(q)):
                if os.path.exists(f):
                    os.unlink(f)

    # (q1) a live 0000 stream, at a bank's rate and unthrottled; (q7) the
    # publisher spools the paced run.
    spool = os.path.join(tmp, "spool")
    os.environ["BLIT_MONITOR_SPOOL"] = spool
    os.environ["BLIT_MONITOR_INTERVAL"] = str(LIVE_MONITOR_INTERVAL)
    try:
        for tag, rate in (("0.75 GB/s", realtime_rate), ("unthrottled", 1e6)):
            out = os.path.join(tmp, "live.0000.fil")
            red = reducer_for_product("0000", **PRODUCTS["0000"])
            hdr, wall, lc = _live_leg(torch, "0000", lambda: stream_reduce(
                ReplaySource(raw_path, rate=rate), out, reducer=red))
            launches[f"live 0000 {tag}"] = lc
            summary = live_summary(red, hdr, wall, leg="q1", product="0000",
                                   source=f"replay {tag}", rate=rate)
            rows.append(summary)
            identical = same_file(out, ref0000)
            same = all(lc[k] == batch_launches["0000"][k]
                       for k in ("pfb_dft1", "tail2_detect"))
            log(f"live 0000 ({tag}): {json.dumps(summary)}; byte-identical to "
                f"reduce_to_file: {identical}; launches {json.dumps(lc)} equal to "
                f"the batch run's: {same}")
            if not (identical and same and hdr["stream_masked_chunks"] == 0):
                raise AssertionError(f"live 0000 ({tag}): not the batch product")
            cleanup(out)
            if tag == "0.75 GB/s":
                monitor.shutdown_publisher()
                os.environ.pop("BLIT_MONITOR_SPOOL")
                samples = monitor.read_spool(spool, tail=1000)
                hbm = [s["gauges"].get("dev.hbm_in_use_bytes", 0) for s in samples]
                chunks = max((s["timeline"]["stages"].get(
                    "stream.chunks", {}).get("calls", 0) for s in samples),
                    default=0)
                lat_n = max((s["timeline"]["hists"].get(
                    "stream.chunk_to_product_s", {}).get("n", 0) for s in samples),
                    default=0)
                log(f"publisher: {len(samples)} spool samples at "
                    f"{LIVE_MONITOR_INTERVAL} s; dev.hbm_in_use_bytes max "
                    f"{max(hbm, default=0)} (torch.cuda.memory_stats); live "
                    f"chunks spooled {chunks}, stream.chunk_to_product_s "
                    f"samples spooled {lat_n}")
                if not (len(samples) >= 2 and max(hbm, default=0) > 0 and chunks > 0):
                    raise AssertionError("publisher: no device gauges or live "
                                         "timeline in the spool")
    finally:
        os.environ.pop("BLIT_MONITOR_SPOOL", None)
        os.environ.pop("BLIT_MONITOR_INTERVAL", None)
        monitor.shutdown_publisher()

    # (q2) tailing a file a recorder thread grows at 0.75 GB/s.
    live_raw = os.path.join(tmp, "growing.0000.raw")
    done = os.path.join(tmp, "growing.done")
    out = os.path.join(tmp, "live.0002.fil")
    writer, state = _grow(raw_path, live_raw, done, REALTIME_BANK_GBPS, spans)
    red = reducer_for_product("0002", **PRODUCTS["0002"])
    try:
        hdr, wall, lc = _live_leg(torch, "0002", lambda: stream_reduce(
            FileTailSource(live_raw, poll_s=0.01), out, reducer=red))
    finally:
        writer.join(timeout=600)
    if "error" in state:
        raise state["error"]
    launches["live 0002 tail"] = lc
    summary = live_summary(red, hdr, wall, leg="q2", product="0002",
                           source="tail at 0.75 GB/s",
                           recorder_wall_s=state.get("wall_s"))
    rows.append(summary)
    identical = same_file(out, ref0002)
    log(f"live 0002 (tail): {json.dumps(summary)}; byte-identical to "
        f"reduce_to_file: {identical}")
    if not (identical and hdr["stream_chunks"] == len(spans)):
        raise AssertionError("live 0002 (tail): not the batch product")
    cleanup(out)
    os.unlink(live_raw)
    os.unlink(done)

    # (q3) the packet stream with one block's packets dropped, against the
    # batch reduction of the recording with that block zero-filled.
    zero_raw = os.path.join(tmp, "zeroed.raw")
    shutil.copyfile(raw_path, zero_raw)
    a, b = spans[LIVE_DROP_BLOCK]
    with open(zero_raw, "r+b") as f:
        f.seek(offsets[LIVE_DROP_BLOCK])
        f.write(bytes(b - offsets[LIVE_DROP_BLOCK]))
    zref = os.path.join(tmp, "zeroed.0002.fil")
    reducer_for_product("0002", **PRODUCTS["0002"]).reduce_to_file(zero_raw, zref)
    os.unlink(zero_raw)
    out = os.path.join(tmp, "packets.0002.fil")
    red = reducer_for_product("0002", **PRODUCTS["0002"])
    src = PacketReplaySource(raw_path, rate=1e6, drop_blocks=[LIVE_DROP_BLOCK],
                             timeline=red.timeline)
    hdr, wall, lc = _live_leg(torch, "0002", lambda: stream_reduce(
        src, out, reducer=red, lateness_s=5.0))
    launches["live 0002 packets"] = lc
    rep = src.packet_report()
    summary = live_summary(red, hdr, wall, leg="q3", product="0002",
                           source="packets, one block dropped",
                           packets=rep["packets"], gaps=rep["gaps"],
                           assembly_p50_s=rep["assembly_p50_s"],
                           assembly_p99_s=rep["assembly_p99_s"])
    rows.append(summary)
    identical = same_file(out, zref)
    kept = BLOCK_NTIME  # synth_raw_blocks writes no overlap
    want = degraded_rows_of(LIVE_DROP_BLOCK * kept, (LIVE_DROP_BLOCK + 1) * kept,
                            red.nfft, red.ntap, red.nint)
    want = {r for r in want if r < hdr["nsamps"]}
    head, got_rows = _product_rows(out)
    bhead, batch_rows = _product_rows(ref0002)
    differ = {i for i, (x, y) in enumerate(zip(got_rows, batch_rows)) if x != y}
    log(f"live 0002 (packets): {json.dumps(summary)}; byte-identical to the "
        f"zero-filled batch product: {identical}; masked {hdr.get('_masked_chunks')}; "
        f"degraded_rows {hdr['stream_degraded_spectra']}, rows {sorted(want)} "
        f"touch the block, rows differing from the intact product {sorted(differ)}")
    if not (identical and hdr.get("_masked_chunks") == [LIVE_DROP_BLOCK]
            and rep["gapped_blocks"] == [LIVE_DROP_BLOCK]
            and hdr["stream_degraded_spectra"] == len(want)
            and differ <= want and differ and head == bhead):
        raise AssertionError("live 0002 (packets): not the zero-filled oracle")
    cleanup(out, zref)

    # (q4) rejoin: a resumable 0000 stream stopped by a sink.write fault,
    # then rejoined.
    out = os.path.join(tmp, "rejoin.0000.fil")
    red = reducer_for_product("0000", **PRODUCTS["0000"])
    first_s, launches["live rejoin leg 1"] = _interrupted(
        torch, "sink.write", 1, "rejoin.0000", lambda: stream_reduce(
            ReplaySource(raw_path, rate=1e6), out, reducer=red, resume=True))
    cur = StreamCursor.load(out)
    if cur is None or cur.frames_done <= 0:
        raise AssertionError("live rejoin: no stream cursor after the stop")
    red = reducer_for_product("0000", **PRODUCTS["0000"])
    hdr, second_s, launches["live rejoin leg 2"] = _live_leg(
        torch, "0000", lambda: stream_reduce(ReplaySource(raw_path, rate=1e6),
                                             out, reducer=red, resume=True))
    identical = same_file(out, ref0000)
    gone = StreamCursor.load(out) is None
    log(f"live rejoin 0000: cursor claimed {cur.frames_done} frames; leg 1 "
        f"{first_s:.3f} s, leg 2 {second_s:.3f} s; byte-identical to the "
        f"uninterrupted product: {identical}; cursor removed: {gone}")
    if not (identical and gone):
        raise AssertionError("live rejoin 0000: not the uninterrupted product")
    cleanup(out)

    # (q5) a live search at search_defaults().
    out = os.path.join(tmp, "live.hits")
    red = DedopplerReducer(nfft=SEARCH_NFFT, nint=1)
    hdr, wall, lc = _live_leg(torch, "search", lambda: stream_search(
        ReplaySource(raw_path, rate=1e6), out, searcher=red))
    launches["live search"] = lc
    summary = live_summary(red, hdr, wall, leg="q5", product="hits",
                           source="replay unthrottled",
                           windows=hdr["search_windows"])
    rows.append(summary)
    identical = same_file(out, ref_hits)
    log(f"live search: {json.dumps(summary)}; .hits byte-identical to "
        f"search_to_file: {identical}")
    if not identical:
        raise AssertionError("live search: not the batch .hits")
    cleanup(out)
    for r in rows:
        log(f"live table: {json.dumps({k: r[k] for k in ('leg', 'product', 'source', 'wall_s', 'raw_gbps', 'chunk_to_product_p50_s', 'chunk_to_product_p99_s', 'watermark_lag_peak_s', 'masked_chunks')})}")
    log(f"live card: {smi}")

    # (q6) the command line, as subprocesses on the card.
    tune_dir = os.path.join(tmp, "tune")
    env = dict(os.environ, BLIT_TUNE_DIR=tune_dir,
               PYTHONPATH=os.pathsep.join(
                   p for p in (os.path.dirname(os.path.abspath(__file__)),
                               os.environ.get("PYTHONPATH")) if p))

    def cli(*argv, timeout=600):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "blit_torch", *argv],
                             capture_output=True, text=True, env=env,
                             timeout=timeout)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"blit_torch {argv[0]} failed ({res.returncode}): "
                                 f"{res.stderr[-2000:]}")
        return res.stdout, wall

    text, wall = cli("tune", "--raw", raw_path, "--nfft", "1024", "--nint", "2048",
                     "--trials", str(LIVE_TUNE_TRIALS), "--device", CLI_DEVICE)
    tuned = json.loads(text.strip().splitlines()[-1])
    log(f"cli tune: {wall:.1f} s; winner {json.dumps(tuned['winner'])}, "
        f"{json.dumps(tuned['trials'])}")
    x = os.path.join(tmp, "cli.0002.fil")
    text, wall = cli("reduce", raw_path, "-o", x, "--product", "0002",
                     "--device", CLI_DEVICE)
    rep = json.loads(text.strip().splitlines()[-1])
    old = os.environ.get("BLIT_TUNE_DIR")
    os.environ["BLIT_TUNE_DIR"] = tune_dir
    try:
        prov = reducer_for_product("0002", device=CLI_DEVICE).tuning_provenance()
    finally:
        if old is None:
            os.environ.pop("BLIT_TUNE_DIR")
        else:
            os.environ["BLIT_TUNE_DIR"] = old
    with open(tuned["profile"]) as f:
        rig = json.load(f)["rig"]
    log(f"cli reduce: {wall:.1f} s, {json.dumps(rep)}; provenance "
        f"{json.dumps(prov)}; the profile's rig {json.dumps(rig)}")
    if not (prov.get("profile", {}).get("key") == tuned["key"]
            and set(prov["sources"].values()) == {"profile"}
            and rig["device_kind"] == (torch.cuda.get_device_name(0)
                                       if CLI_DEVICE == "cuda" else "cpu")
            and rig["backend"] == CLI_DEVICE):
        raise AssertionError("cli: the reduction did not take the card's profile")
    y = os.path.join(tmp, "cli.stream.0002.fil")
    text, wall = cli("stream", raw_path, "-o", y, "--product", "0002",
                     "--replay-rate", "1000000", "--device", CLI_DEVICE)
    srep = json.loads(text.strip().splitlines()[-1])
    log(f"cli stream: {wall:.1f} s, {json.dumps(srep)}; byte-identical to the "
        f"cli reduce product: {same_file(x, y)}")
    if not (same_file(x, y) and srep["masked_chunks"] == 0
            and srep["chunk_to_product_p99_s"] is not None):
        raise AssertionError("cli stream: not the reduce product")
    text, wall = cli("info", y)
    info = json.loads(text)
    log(f"cli info: {wall:.1f} s; nchans {info['nchans']}, nsamps "
        f"{info.get('nsamps')}")
    if info["nchans"] != NCHAN * 1024:
        raise AssertionError("cli info: wrong header")
    cleanup(x, y)
    shutil.rmtree(tune_dir, ignore_errors=True)
    return launches


def tch_usable(nfft, nint):
    from blit_torch.ops import channelize as tch

    return tch.usable_frames(RAW_SAMPLES, nfft, NTAP, nint) // nint


# (p) the reference workflow: one session, scan 0011, band 0 of 8 banks at
# the GBT widths (64 coarse channels of a 187.5 MHz bank, banks tiling the
# band downwards from GBT_TOP_MHZ), each bank a 2-member .NNNN.raw sequence
# of GBT_MEMBER_BLOCKS blocks of GBT_BLOCK_NTIME samples (32 MiB blocks,
# 128 MiB a bank: depth cut to 2^19 samples a channel), reduced at 0002's
# nfft with nint cut from 2048 to GBT_NINT.
GBT_SESSION, GBT_SCAN = "AGBT22B_999_01", "0011"
GBT_BANKS = 8
GBT_BLOCK_NTIME = 1 << 17
GBT_MEMBERS = 2
GBT_MEMBER_BLOCKS = 2
GBT_NFFT, GBT_NINT = 1024, 16
GBT_TOP_MHZ = 9500.0
GBT_COARSE_MHZ = 187.5 / 64   # a bank is NCHAN of these: 187.5 MHz at 64
GBT_AGENTS = 2


def write_gbt_tree(root):
    """(p)'s tree: ``<root>/<session>/GUPPI/BLP0k/blc0k_guppi_..._0011.000m.raw``,
    a tone at TONE_FREQ of coarse channel k in bank k.  Returns
    {bank: member paths}."""
    from blit_torch.testing import synth_raw_blocks

    seqs = {}
    for k in range(GBT_BANKS):
        d = os.path.join(root, GBT_SESSION, "GUPPI", f"BLP0{k}")
        os.makedirs(d, exist_ok=True)
        whole = os.path.join(d, "whole.raw")
        synth_raw_blocks(whole, nblocks=GBT_MEMBERS * GBT_MEMBER_BLOCKS,
                         obsnchan=NCHAN, ntime_per_block=GBT_BLOCK_NTIME,
                         seed=SEED + k, tone_chan=k, tone_freq=TONE_FREQ,
                         obsbw=-NCHAN * GBT_COARSE_MHZ,
                         obsfreq=GBT_TOP_MHZ - (k + 0.5) * NCHAN * GBT_COARSE_MHZ)
        seqs[k] = split_recording(whole, d, GBT_MEMBERS,
                                  stem=f"blc0{k}_guppi_59897_21221_HD_84406_{GBT_SCAN}")
        os.unlink(whole)
    return seqs


def gbt_tone_chan(hdr, raw_hdr, k):
    """The fine channel of bank k's tone, from the product's header."""
    chan_bw = hdr["foff"] * GBT_NFFT
    f_tone = (float(raw_hdr["OBSFREQ"]) - float(raw_hdr["OBSBW"]) / 2
              + chan_bw / 2 + k * chan_bw + TONE_FREQ * chan_bw)
    return int(round((f_tone - hdr["fch1"]) / hdr["foff"]))


def phase_gbt(torch, dev, smi, keep=None):
    """(p): the reference's own API on the card.  Inventory over a thread
    pool of 8 workers (blc00..blc07), the reduce_raw fan-out (each bank's
    sequence on its own worker) byte-identical to serial RawReducer runs
    with each tone in its fine channel, load_scan (the band stitched,
    despiked at nfpc 1024; again at fqav_by 8), get_data and
    get_kurtosis(device=True) fan-outs against the host, search_raw
    through the pool against a direct search, and 2 remote agents (python
    -m blit_torch.agent) reducing banks 0 and 1 on the card.  Returns the
    launch counts of the gbt path (fan-out and search); with ``keep`` (a
    dict) it keeps the band tree for (r) and names it there (``root``,
    ``seqs``)."""
    import filecmp

    import numpy as np

    from blit_torch import gbt, observability, workers
    from blit_torch.device import device_name
    from blit_torch.io.guppi import GuppiRaw
    from blit_torch.io.sigproc import read_fil
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import dedoppler as tpd
    from blit_torch.ops.despike import despike
    from blit_torch.ops.fqav import fqav
    from blit_torch.parallel.pool import WorkerPool, reset_pool
    from blit_torch.parallel.remote import agent_env_with_repo, local_agent_command
    from blit_torch.pipeline import RawReducer
    from blit_torch.search import DedopplerReducer

    root = tempfile.mkdtemp(prefix="blit-smoke-gbt-")
    try:
        t0 = time.perf_counter()
        seqs = write_gbt_tree(root)
        raw_bytes = sum(os.path.getsize(p) for ps in seqs.values() for p in ps)
        log(f"gbt: wrote {GBT_BANKS} banks × {GBT_MEMBERS} members, "
            f"{raw_bytes / 1e9:.3f} GB RAW, in {time.perf_counter() - t0:.1f} s")
        hosts = [f"blc0{k}" for k in range(GBT_BANKS)]
        reset_pool()
        pool = gbt.setup_workers(hosts=hosts, backend="thread")

        # Inventory: every worker sees the shared tree; the sequences dedup.
        invs = gbt.get_inventories(r"\.raw$", root=root)
        found = gbt.raw_sequences([r for inv in invs for r in inv])
        if ([(r.band, r.bank, len(p)) for r, p in found]
                != [(0, k, GBT_MEMBERS) for k in range(GBT_BANKS)]
                or [p for _, p in found] != [seqs[k] for k in range(GBT_BANKS)]):
            raise AssertionError(f"gbt: raw_sequences found {found}")
        log(f"gbt: inventory {[len(i) for i in invs]} records a worker; "
            f"raw_sequences: {len(found)} sequences of {GBT_MEMBERS} members")

        # The fan-out: bank k's sequence on worker k+1 (host blc0k).
        wids = [hosts.index(f"blc{r.band}{r.bank}") + 1 for r, _ in found]
        outs = [os.path.join(os.path.dirname(p[0]),
                             os.path.basename(p[0])[:-len(".0000.raw")]
                             + ".rawspec.0002.fil") for _, p in found]
        reset_launches()
        t0 = time.perf_counter()
        hdrs = gbt.reduce_raw(wids, [p for _, p in found], outs,
                              nfft=GBT_NFFT, nint=GBT_NINT)
        fan_s = time.perf_counter() - t0
        launches = read_launches()
        plan = tch.last_kernel_plan()
        log(f"gbt fan-out: plan {json.dumps(plan)} launches {json.dumps(launches)}")
        check_plan("gbt", plan, launches)
        reset_launches()
        t0 = time.perf_counter()
        serial = []
        for k, (_, paths) in enumerate(found):
            out = os.path.join(root, f"serial{k}.fil")
            RawReducer(nfft=GBT_NFFT, nint=GBT_NINT).reduce_to_file(paths, out)
            serial.append(out)
        serial_s = time.perf_counter() - t0
        # The fan-out ran the same chunks as the serial runs, one reducer
        # per thread: its counts must be theirs exactly (no lost count).
        serial_counts = read_launches()
        log(f"gbt serial runs: launches {json.dumps(serial_counts)}")
        if any(launches[k] != serial_counts[k] for k in EXPECTED["gbt"][1]):
            raise AssertionError(f"gbt: fan-out launches {launches} differ from "
                                 f"the serial runs' {serial_counts}")
        # The first fan-out paid the pool's first use of the card (eight
        # reducers' staging allocations); a second one, warm, is timed
        # beside the serial runs.
        warm = [os.path.join(root, f"warm{k}.fil") for k in range(len(found))]
        t0 = time.perf_counter()
        gbt.reduce_raw(wids, [p for _, p in found], warm, nfft=GBT_NFFT, nint=GBT_NINT)
        warm_s = time.perf_counter() - t0
        identical = [filecmp.cmp(a, b, shallow=False) and filecmp.cmp(c, b, shallow=False)
                     for a, b, c in zip(outs, serial, warm)]
        tones = []
        for k, (out, (_, paths)) in enumerate(zip(outs, found)):
            fhdr, data = read_fil(out)
            raw_hdr = GuppiRaw(paths[0], native=False).header(0)
            want = gbt_tone_chan(fhdr, raw_hdr, k)
            got = int(np.asarray(data).mean(axis=0)[0].argmax())
            tones.append((got, want))
            if not np.isfinite(np.asarray(data)).all():
                raise AssertionError(f"gbt: bank {k}'s product has non-finite values")
        log(f"gbt fan-out: {GBT_BANKS} banks in {fan_s:.3f} s, aggregate RAW "
            f"GB/s {raw_bytes / fan_s / 1e9:.3f}; serial {serial_s:.3f} s "
            f"(RAW GB/s {raw_bytes / serial_s / 1e9:.3f}); fan-out again, warm, "
            f"{warm_s:.3f} s (RAW GB/s {raw_bytes / warm_s / 1e9:.3f}); both "
            f"fan-outs byte-identical to serial: {identical}; tone fine channel "
            f"(peak, header) {tones}; card: {smi}")
        if not all(identical):
            raise AssertionError("gbt: fan-out products differ from serial runs")
        if any(g != w for g, w in tones):
            raise AssertionError("gbt: a tone is not in its fine channel")
        if any(h["nchans"] != NCHAN * GBT_NFFT or workers.get_header(o)["nfpc"] != GBT_NFFT
               for h, o in zip(hdrs, outs)):
            raise AssertionError(f"gbt: product headers {hdrs}")

        # load_scan: the band stitched bank-ascending and despiked.
        pinvs = gbt.get_inventories(r"0002\.fil$", root=root)
        banks = [np.array(read_fil(o)[1]) for o in outs]
        nspec = banks[0].shape[0]
        stitched = np.concatenate(banks, axis=-1)
        band_n = GBT_BANKS * NCHAN * GBT_NFFT
        scan_s = {}
        for fq in (1, 8):
            t0 = time.perf_counter()
            got = gbt.load_scan(pinvs, GBT_SESSION, GBT_SCAN, suffix="0002.fil",
                                fqav_by=fq)
            scan_s[fq] = time.perf_counter() - t0
            hdr, band = got[0]
            nfpc = GBT_NFFT // fq
            want = despike(fqav(stitched, fq), nfpc)
            ok = (sorted(got) == [0] and band.shape == (nspec, 1, band_n // fq)
                  and hdr["nchans"] == band_n // fq
                  and hdr["fch1"] == (hdrs[0]["fch1"] if fq == 1
                                      else hdrs[0]["fch1"] + (fq - 1) * hdrs[0]["foff"] / 2)
                  and np.array_equal(band, want)
                  and np.array_equal(band[..., nfpc // 2::nfpc],
                                     band[..., nfpc // 2 - 1::nfpc]))
            if fq == 1:
                peaks = [int(band.mean(axis=0)[0, k * NCHAN * GBT_NFFT:
                                                  (k + 1) * NCHAN * GBT_NFFT].argmax())
                         + k * NCHAN * GBT_NFFT for k in range(GBT_BANKS)]
                ok = ok and peaks == [k * NCHAN * GBT_NFFT + w
                                      for k, (_, w) in enumerate(tones)]
            log(f"gbt load_scan fqav_by={fq}: {scan_s[fq]:.3f} s, band {band.shape}, "
                f"fch1 {hdr['fch1']!r}, nchans {hdr['nchans']}, despiked at nfpc "
                f"{nfpc}, equal to the stitched products: {ok}; card: {smi}")
            if not ok:
                raise AssertionError(f"gbt: load_scan fqav_by={fq} is not the stitched band")
            del got, band, want

        # get_data and get_kurtosis fanned out over the 8 products.
        idxs = (slice(0, 8), 0, slice(None))
        slabs = gbt.get_data(wids, outs, idxs, 16, np.max)
        ok = all(np.array_equal(s_, b[0:8, 0:1].reshape(-1, 1, b.shape[-1] // 16, 16).max(-1))
                 for s_, b in zip(slabs, banks))
        log(f"gbt get_data (np.max over 16, 8 spectra): equal to the host: {ok}")
        if not ok:
            raise AssertionError("gbt: get_data slabs differ")
        gbt.get_kurtosis(wids, outs, device=True)  # warm the card
        t0 = time.perf_counter()
        maps = gbt.get_kurtosis(wids, outs, device=True)
        kurt_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = gbt.get_kurtosis(wids, outs, device=False)
        host_ms = (time.perf_counter() - t0) * 1e3
        err = max(float(np.nanmax(np.abs(m - h))) for m, h in zip(maps, host))
        ok = all(m.shape == (NCHAN * GBT_NFFT, 1)
                 and np.allclose(m, h, rtol=2e-3, atol=2e-3, equal_nan=True)
                 for m, h in zip(maps, host))
        log(f"gbt get_kurtosis: 8 maps on the card in {kurt_ms:.1f} ms (host "
            f"{host_ms:.1f} ms), max |card - host| {err:.3g}, within rtol 2e-3 / "
            f"atol 2e-3: {ok}; card: {smi}")
        if not ok:
            raise AssertionError("gbt: the card's kurtosis maps differ from the host's")

        # search_raw through the pool on bank 0, against a direct search.
        hits = os.path.join(root, "bank0.hits")
        direct = os.path.join(root, "direct.hits")
        reset_launches()
        t0 = time.perf_counter()
        shdr = pool.run_on([1], workers.search_raw, [(found[0][1], hits)],
                           kwargs=dict(nfft=GBT_NFFT, nint=1))[0]
        search_s = time.perf_counter() - t0
        counts = read_launches()
        per_window = tpd.kernel_route(shdr["search_window_spectra"])[1]
        check_plan("gbt search", tch.last_kernel_plan(), counts,
                   per_window * shdr["search_windows"])
        launches = {k: launches[k] + counts[k] for k in launches}
        DedopplerReducer(nfft=GBT_NFFT, nint=1).search_to_file(found[0][1], direct)
        ok = filecmp.cmp(hits, direct, shallow=False)
        log(f"gbt search_raw: {search_s:.3f} s, {shdr['search_windows']} windows of "
            f"{shdr['search_window_spectra']} spectra, {shdr['search_nhits']} hits, "
            f"taylor_tree launches {counts['taylor_tree']}, .hits byte-identical "
            f"to a direct search: {ok}")
        if not ok or shdr["search_windows"] < 1:
            raise AssertionError("gbt: search_raw's .hits differ")
        reset_pool()

        # Two remote agents on the card.
        rpool = WorkerPool(hosts[:GBT_AGENTS], backend="remote",
                           transport=lambda host: local_agent_command(),
                           agent_env=agent_env_with_repo(), call_timeout=600.0)
        try:
            t0 = time.perf_counter()
            names = rpool.broadcast(device_name)
            spawn_s = time.perf_counter() - t0
            routs = [os.path.join(root, f"agent{k}.fil") for k in range(GBT_AGENTS)]
            t0 = time.perf_counter()
            gbt.reduce_raw(list(range(1, GBT_AGENTS + 1)),
                           [found[k][1] for k in range(GBT_AGENTS)], routs,
                           pool=rpool, nfft=GBT_NFFT, nint=GBT_NINT)
            agent_s = time.perf_counter() - t0
            same = [filecmp.cmp(a, b, shallow=False)
                    for a, b in zip(routs, outs[:GBT_AGENTS])]
            rslab = gbt.get_data([1], [outs[0]], idxs, 16, np.max, pool=rpool)[0]
            slab_ok = np.array_equal(rslab, slabs[0])
            # The span tree across processes: each agent's reduce_raw span
            # parents onto the pool's dispatch span that shipped it.
            dispatch = {s["span"]: s for s in observability.span_dicts()
                        if s["name"] == "pool.reduce_raw"}
            agent_spans = rpool.broadcast(observability.span_dicts)
        finally:
            rpool.shutdown()
        tree = [[(s["worker"], dispatch[s["parent"]]["attrs"]["worker"],
                  round(s["duration_s"], 3), round(dispatch[s["parent"]]["duration_s"], 3))
                 for s in theirs if s["name"] == "agent.reduce_raw"
                 and s["parent"] in dispatch
                 and s["trace"] == dispatch[s["parent"]]["trace"]]
                for theirs in agent_spans]
        log(f"gbt agents: {GBT_AGENTS} spawned and answered in {spawn_s:.2f} s, "
            f"devices {names}; banks 0-{GBT_AGENTS - 1} reduced in {agent_s:.3f} s, "
            f"byte-identical to the thread pool's: {same}; get_data slab equal: "
            f"{slab_ok}; span tree (agent worker, dispatch worker, agent s, "
            f"dispatch s): {tree}; card: {smi}")
        if not (all(same) and slab_ok and names == [device_name()] * GBT_AGENTS):
            raise AssertionError("gbt: the agents' products differ")
        if [[t[:2] for t in ts] for ts in tree] != [[(k, k)] for k in range(1, GBT_AGENTS + 1)]:
            raise AssertionError(f"gbt: the agents' spans do not parent onto the "
                                 f"pool's: {agent_spans}")
        if keep is not None:  # (r) reuses the band tree; its caller deletes it
            keep.update(root=root, seqs=seqs)
        return launches
    finally:
        reset_pool()
        if keep is None or keep.get("root") != root:
            shutil.rmtree(root, ignore_errors=True)


# (r) the (band, bank) mesh and the recovery plane.  (r1)-(r3) and
# (r5)-(r6) run over (p)'s band tree (8 banks of 2^19 samples x 64
# channels, nfft 1024, nint 16 for the products, nint 1 for the search)
# in windows of MESH_WINDOW_FRAMES frames; (r2) is 0000 on (d)'s
# recording and a second one of the same length; (r4) runs at (k)'s and
# (l)'s shapes.  Subprocesses (the pods, the drills, the command line)
# seat their players on MESH_CHILD_DEVICE.
MESH_WINDOW_FRAMES = 64
MESH_TONE_CHAN = 20            # (r2): bank 1's tone, so a swapped bank shows
MESH_LEASE_TTL = 5.0           # (r6): the drills' lease TTL, seconds
MESH_MASK_ANTENNA = 5          # (r4): the antenna whose file is cut
MESH_CHILD_DEVICE = "cuda:0"
MESH_ONE_BACKEND = "nccl"      # (r5): the one-process pod's backend
MESH_CHILD_TIMEOUT = 300
MESH_CHAOS_WINDOWS = 4         # (r6): windows in each chaos bank's recording
MESH_SESSION_BLOCKS = 4        # (r6): each session seat's recording, in
MESH_SESSION_NTIME = 1 << 15   # blocks of this many samples


def mesh_summary(tl, wall, nbytes, **extra) -> dict:
    """Wall, RAW GB/s over it, the gather's p50/p99 and bytes."""
    g = tl.hists.get("mesh.gather_s")
    gb = tl.hists.get("mesh.gather_ici_bytes")
    out = {"wall_s": round(wall, 3), "raw_gbps": round(nbytes / wall / 1e9, 3)}
    if g is not None and g.n:
        out.update(gather_n=g.n, gather_p50_ms=round(g.percentile(50) * 1e3, 4),
                   gather_p99_ms=round(g.percentile(99) * 1e3, 4))
    if gb is not None and gb.n:
        out.update(gather_ici_bytes=int(gb.total), gather_windows=gb.n)
    out.update(extra)
    return out


def _files_equal(pairs) -> list:
    import filecmp

    return [filecmp.cmp(a, b, shallow=False) for a, b in pairs]


def phase_mesh_recording(torch, dev, raw_path, tmp, smi):
    """(r2) 0000 on a (1, 2) mesh, bank 0 (d)'s recording and bank 1 a
    second of the same length with its tone in MESH_TONE_CHAN: the
    sharded plane's bytes equal the pool path's; then (r6) a supervised
    0002 stream of (d)'s recording killed after its second chunk rejoins
    and writes (d)'s bytes.  Returns the launch counts of the path."""
    from blit_torch.observability import Timeline
    from blit_torch.ops import channelize as tch
    from blit_torch.parallel.mesh import make_mesh
    from blit_torch.parallel.scan import reduce_scan_pool_to_files
    from blit_torch.parallel.sharded import reduce_scan_sharded_to_files
    from blit_torch.recover import StreamSupervisor
    from blit_torch.testing import synth_raw_blocks

    import numpy as np

    from blit_torch.io.guppi import GuppiRaw, write_raw

    t0 = time.perf_counter()
    raw2 = os.path.join(tmp, "smoke_bank1.raw")
    # The next bank down the band, contiguous with (d)'s recording: its
    # blocks with the channels rolled, so the tone sits in MESH_TONE_CHAN
    # (a swapped bank shows) at the cost of a copy, not a synthesis.
    r = GuppiRaw(raw_path)
    h0 = dict(r.header(0))
    h0["OBSFREQ"] = h0["OBSFREQ"] + h0["OBSBW"]
    write_raw(raw2, h0, (np.roll(r.read_block(i), MESH_TONE_CHAN - TONE_CHAN, axis=0)
                         for i in range(r.nblocks)))
    r.close()
    log(f"mesh 0000: wrote bank 1, {os.path.getsize(raw2) / 1e9:.3f} GB, in "
        f"{time.perf_counter() - t0:.1f} s")
    grid = [[raw_path, raw2]]
    raw_bytes = os.path.getsize(raw_path) + os.path.getsize(raw2)
    mesh = make_mesh(1, 2, devices=[dev, dev])
    d_sh, d_pool = os.path.join(tmp, "mesh_sh"), os.path.join(tmp, "mesh_pool")
    os.makedirs(d_sh), os.makedirs(d_pool)
    tl = Timeline()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sh = reduce_scan_sharded_to_files(grid, out_dir=d_sh, nfft=NFFT, nint=1,
                                      window_frames=CHUNK_FRAMES, mesh=mesh,
                                      timeline=tl, probe_windows=2)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_plan("mesh 0000", tch.last_kernel_plan(), launches)
    t0 = time.perf_counter()
    pool = reduce_scan_pool_to_files(grid, out_dir=d_pool, nfft=NFFT, nint=1,
                                     window_frames=CHUNK_FRAMES, device=dev)
    pool_s = time.perf_counter() - t0
    same = _files_equal([(sh[0][0], pool[0][0])])
    log(f"mesh 0000 (r2): {json.dumps(mesh_summary(tl, wall, raw_bytes, pool_s=round(pool_s, 3), nsamps=sh[0][1]['nsamps'], byte_identical_to_pool=same[0], launches={k: launches[k] for k in ('pfb_dft1', 'tail2_detect')}))}; card: {smi}")
    if not all(same) or sh[0][1]["nsamps"] != pool[0][1]["nsamps"]:
        raise AssertionError("mesh 0000: the sharded product differs from the pool's")
    for d in (d_sh, d_pool):
        shutil.rmtree(d)
    os.unlink(raw2)

    # (r6) the live drill: a supervised 0002 replay killed mid-stream.
    out = os.path.join(tmp, "mesh_stream.0002.fil")
    tl = Timeline()
    t0 = time.perf_counter()
    rep = StreamSupervisor(
        raw_path, out, kind="reduce",
        knobs=dict(nfft=1 << 10, nint=1 << 11, tune_online=False),
        replay_rate=1e6, faults="stream.chunk:kill:after=2",
        lease_ttl_s=MESH_LEASE_TTL, poll_s=0.05, max_attempts=3,
        timeline=tl, device=MESH_CHILD_DEVICE).run()
    wall = time.perf_counter() - t0
    same = _files_equal([(out, os.path.join(tmp, "smoke.0002.fil"))])
    hists = tl.report().get("hists", {})
    log(f"mesh stream drill (r6): {json.dumps({'wall_s': round(wall, 3), 'recovered': rep['recovered'], 'attempts': rep['attempts'], 'detect_s': hists.get('recover.detect_s', {}), 'resume_s': hists.get('recover.resume_s', {}), 'byte_identical_to_batch': same[0]})}; card: {smi}")
    if not rep["recovered"] or not all(same):
        raise AssertionError("mesh stream drill: not recovered with identical bytes")
    os.unlink(out)
    return {"mesh 0000": launches}


def _run_pod(spec, nprocs, work, tag):
    """A pod of ``nprocs`` children ``python -m blit_torch.recover`` (the
    supervised scan's own child) with ``spec``; returns the Popen list."""
    from blit_torch.recover import _free_port, _spawn_child

    port = _free_port()
    procs = []
    for proc in range(nprocs):
        s = dict(spec, nprocs=nprocs, port=port, proc=proc,
                 result=os.path.join(work, f"{tag}p{proc}.result.json"))
        procs.append(_spawn_child(s, os.path.join(work, f"{tag}p{proc}.spec.json"),
                                  dict(os.environ), os.path.join(work, f"{tag}p{proc}")))
    return procs


def _wait_all(procs, what, timeout=MESH_CHILD_TIMEOUT):
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc != 0:
                raise AssertionError(f"{what}: a child exited {rc}: {p.args}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def _pod_results(work, tag, nprocs) -> dict:
    out = {}
    for proc in range(nprocs):
        with open(os.path.join(work, f"{tag}p{proc}.result.json")) as f:
            out.update(json.load(f))
    return out


def phase_mesh(torch, dev, smi, tree=None):
    """(r1), (r3), (r5), (r6) over (p)'s band tree: the sharded plane,
    the mesh loop and the pool path byte-identical; load_scan_mesh equal
    to gbt.load_scan; each player's .hits equal to a direct search; pods
    of two processes (gloo, pinned host staging) and of one (NCCL) writing
    the pool's bytes; kill and hang drills recovering with identical
    bytes; the scan, chaos and session commands.  Returns the launch
    counts of the in-process paths."""
    import numpy as np

    from blit_torch import gbt
    from blit_torch.io.sigproc import read_fil
    from blit_torch.observability import Timeline
    from blit_torch.ops import channelize as tch
    from blit_torch.parallel.mesh import make_mesh
    from blit_torch.parallel.pool import reset_pool
    from blit_torch.parallel.scan import (
        load_scan_mesh,
        reduce_scan_mesh_to_files,
        reduce_scan_pool_to_files,
    )
    from blit_torch.parallel.sharded import (
        reduce_scan_sharded_to_files,
        search_scan_sharded_to_files,
    )
    from blit_torch.pipeline import RawReducer
    from blit_torch.recover import RECOVER_HISTS, ScanSupervisor
    from blit_torch.search import DedopplerReducer

    counts = {}
    t_phase = time.perf_counter()
    if tree and tree.get("root"):
        root, seqs = tree["root"], tree["seqs"]
    else:
        root = tempfile.mkdtemp(prefix="blit-smoke-mesh-")
        seqs = None
    try:
        t0 = time.perf_counter()
        if seqs is None:
            seqs = write_gbt_tree(root)
        grid = [[seqs[k] for k in range(GBT_BANKS)]]
        raw_bytes = sum(os.path.getsize(p) for ps in seqs.values() for p in ps)
        log(f"mesh: the band tree, {raw_bytes / 1e9:.3f} GB, ready in "
            f"{time.perf_counter() - t0:.1f} s")
        mesh = make_mesh(1, GBT_BANKS, devices=[dev] * GBT_BANKS)
        kw = dict(nfft=GBT_NFFT, nint=GBT_NINT, window_frames=MESH_WINDOW_FRAMES)
        dirs = {t: os.path.join(root, "mesh", t) for t in ("sh", "pool", "loop", "pod24",
                                                   "pod18", "nccl", "kill", "hang",
                                                   "cli", "work")}
        for d in dirs.values():
            os.makedirs(d)

        # (r1) the sharded plane (every window a probe), the pool path, the
        # mesh loop.
        frames = tch.usable_frames(GBT_MEMBERS * GBT_MEMBER_BLOCKS * GBT_BLOCK_NTIME,
                                   GBT_NFFT, NTAP, GBT_NINT)
        nwin = -(-frames // MESH_WINDOW_FRAMES)
        tl = Timeline()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sh = reduce_scan_sharded_to_files(grid, out_dir=dirs["sh"], mesh=mesh,
                                          timeline=tl, probe_windows=nwin, **kw)
        wall = time.perf_counter() - t0
        counts["mesh (1,8)"] = read_launches()
        check_plan("mesh (1,8)", tch.last_kernel_plan(), counts["mesh (1,8)"])
        t0 = time.perf_counter()
        pool = reduce_scan_pool_to_files(grid, out_dir=dirs["pool"], device=dev, **kw)
        pool_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loop = reduce_scan_mesh_to_files(grid, out_dir=dirs["loop"], mesh=mesh, **kw)
        loop_s = time.perf_counter() - t0
        oracle18 = pool[0][0]
        same = _files_equal([(sh[0][0], oracle18), (loop[0][0], oracle18)])
        log(f"mesh (r1): {json.dumps(mesh_summary(tl, wall, raw_bytes, pool_s=round(pool_s, 3), loop_s=round(loop_s, 3), windows=nwin, nsamps=sh[0][1]['nsamps'], byte_identical=same))}; card: {smi}")
        if not all(same):
            raise AssertionError("mesh (r1): the sharded plane or the mesh loop "
                                 "differs from the pool path")
        if tl.hists["mesh.gather_s"].n != nwin:
            raise AssertionError("mesh (r1): not every window timed its gather")

        # load_scan_mesh (one window, despiked) against gbt.load_scan over
        # serial products of the same shape.
        t0 = time.perf_counter()
        hdr, band = load_scan_mesh(grid, nfft=GBT_NFFT, nint=GBT_NINT, mesh=mesh,
                                   despike=True)
        band = band.numpy()
        lsm_s = time.perf_counter() - t0
        for k in range(GBT_BANKS):
            stem = os.path.basename(seqs[k][0])[:-len(".0000.raw")]
            RawReducer(nfft=GBT_NFFT, nint=GBT_NINT, chunk_frames=frames,
                       tune_online=False, device=dev).reduce_to_file(
                seqs[k], os.path.join(os.path.dirname(seqs[k][0]),
                                      stem + ".rawspec.0002.fil"))
        reset_pool()
        gbt.setup_workers(hosts=[f"blc0{k}" for k in range(GBT_BANKS)],
                          backend="thread")
        try:
            invs = gbt.get_inventories(r"0002\.fil$", root=root)
            (bhdr, want), = gbt.load_scan(invs, GBT_SESSION, GBT_SCAN,
                                          suffix="0002.fil").values()
        finally:
            reset_pool()
        ok = (band.shape == (1,) + want.shape and np.array_equal(band[0], want)
              and hdr["nchans"] == bhdr["nchans"] and hdr["fch1"] == bhdr["fch1"])
        log(f"mesh load_scan_mesh (r1): {lsm_s:.3f} s, band {band.shape}, "
            f"equal to gbt.load_scan: {ok}; card: {smi}")
        if not ok:
            raise AssertionError("mesh: load_scan_mesh differs from gbt.load_scan")
        del band, want

        # (r3) the sharded search, every player against a direct search.
        T = DedopplerReducer(nfft=GBT_NFFT, device=dev).window_spectra
        tl = Timeline()
        reset_launches()
        t0 = time.perf_counter()
        hits = search_scan_sharded_to_files(grid, out_dir=dirs["sh"], nfft=GBT_NFFT,
                                            window_frames=T, mesh=mesh, timeline=tl)
        wall = time.perf_counter() - t0
        counts["mesh search"] = read_launches()
        search_plan = tch.last_kernel_plan()
        pairs = []
        for (b, k), (path, _) in sorted(hits.items()):
            direct = os.path.join(dirs["pool"], f"direct{k}.hits")
            DedopplerReducer(nfft=GBT_NFFT, chunk_frames=T,
                             device=dev).search_to_file(seqs[k], direct)
            pairs.append((path, direct))
        same = _files_equal(pairs)
        nwin_s = hits[(0, 0)][1]["search_windows"]
        log(f"mesh search (r3): {json.dumps(mesh_summary(tl, wall, raw_bytes, players=len(hits), windows=nwin_s, taylor_tree=counts['mesh search']['taylor_tree'], byte_identical=same))}; card: {smi}")
        from blit_torch.ops import dedoppler as tpd

        check_plan("mesh search", search_plan, counts["mesh search"],
                   tree_launches=GBT_BANKS * nwin_s * tpd.kernel_route(T)[1])
        if not all(same):
            raise AssertionError("mesh search: a player's .hits differs from a "
                                 "direct search")

        # (r5) pods, in parallel: (2, 4) one band row a process and (1, 8)
        # with the row split (both gloo, two processes on one card), and a
        # one-process NCCL pod on (1, 8).
        grid24 = [grid[0][:4], grid[0][4:]]
        base = dict(kind="reduce", search={}, lease_dir=dirs["work"],
                    window_frames=MESH_WINDOW_FRAMES, device=MESH_CHILD_DEVICE,
                    knobs=dict(nfft=GBT_NFFT, ntap=NTAP, nint=GBT_NINT, stokes="I",
                               fqav_by=1, window="hamming", despike=True,
                               dtype="float32", max_frames=None, compression=None))
        pods = [("pod24", grid24, [2, 4], 2, 4, "gloo"),
                ("pod18", grid, [1, 8], 2, 4, "gloo"),
                ("nccl", grid, [1, 8], 1, 8, MESH_ONE_BACKEND)]
        t0 = time.perf_counter()
        running = []
        for tag, g, shape, nprocs, dpp, backend in pods:
            outp = [os.path.join(dirs[tag], f"band{b}.fil") for b in range(shape[0])]
            running += _run_pod(dict(base, grid=g, out_paths=outp, mesh_shape=shape,
                                     devices_per_proc=dpp, backend=backend),
                                nprocs, dirs["work"], tag)
        _wait_all(running, "mesh pods")
        pods_s = time.perf_counter() - t0
        os.makedirs(dirs["pool"] + "24")
        oracle24 = reduce_scan_pool_to_files(grid24, out_dir=dirs["pool"] + "24",
                                             device=dev, **kw)
        res = {tag: _pod_results(dirs["work"], tag, n) for tag, _, _, n, _, _ in pods}
        same = _files_equal(
            [(os.path.join(dirs["pod24"], f"band{b}.fil"), oracle24[b][0])
             for b in (0, 1)]
            + [(os.path.join(dirs["pod18"], "band0.fil"), oracle18),
               (os.path.join(dirs["nccl"], "band0.fil"), oracle18)])
        split = [res["pod18"][f"proc{p}"] for p in (0, 1)]
        log(f"mesh pods (r5): {json.dumps({'wall_s': round(pods_s, 3), 'byte_identical': same, 'backends': {t: r['proc0']['backend'] for t, r in res.items()}, 'split_row_host_stage_bytes': [x['host_stage_bytes'] for x in split], 'split_row_gather': [x['hists'].get('mesh.gather_ici_bytes', {}) for x in split], 'split_row_gather_s': [x['hists'].get('mesh.gather_s', {}) for x in split]})}; card: {smi}")
        if (not all(same) or res["nccl"]["proc0"]["backend"] != MESH_ONE_BACKEND
                or (MESH_CHILD_DEVICE.startswith("cuda")  # gloo stages CUDA
                    and min(x["host_stage_bytes"] for x in split) <= 0)):
            raise AssertionError("mesh pods: a pod's product differs from the pool "
                                 "oracle, or a collective did not run as planned")

        # (r6) the command line as subprocesses (scan over the tree, chaos
        # --workload scan, a session of two seats), started first, then the
        # kill and hang drills on the (2, 4) grid at once, each supervisor
        # on a thread of its own.
        import threading

        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        sess = []
        for i in range(2):
            raw = os.path.join(dirs["cli"], f"seat{i}.raw")
            synth_raw_seat(raw, i)
            oracle = os.path.join(dirs["cli"], f"seat{i}.oracle.fil")
            RawReducer(nfft=GBT_NFFT, nint=GBT_NINT, tune_online=False,
                       device=dev).reduce_to_file(raw, oracle)
            seat = {"name": f"blc0{i}", "out": os.path.join(dirs["cli"], f"seat{i}.fil"),
                    "source": {"kind": "replay", "raw": raw, "rate": 1e6},
                    "knobs": {"nfft": GBT_NFFT, "nint": GBT_NINT, "tune_online": False}}
            if i == 1:
                seat["faults"] = "stream.chunk:kill:after=1"
            sess.append((seat, oracle))
        spec = os.path.join(dirs["cli"], "session.json")
        with open(spec, "w") as f:
            json.dump({"seats": [s for s, _ in sess], "lease_ttl_s": MESH_LEASE_TTL,
                       "poll_s": 0.05}, f)
        cmds = {
            "scan": ["scan", root, GBT_SESSION, GBT_SCAN, "-o", dirs["cli"],
                     "--nfft", str(GBT_NFFT), "--nint", str(GBT_NINT),
                     "--window-frames", str(MESH_WINDOW_FRAMES), "--sharded"],
            # chaos at the band tree's widths (64 channels a bank, nfft
            # 1024, nint 16, windows of 64 frames) on its own 2 x 2 grid
            # of 4 windows a bank, so its detection latency is a real
            # window's.
            "chaos": ["chaos", "--workload", "scan", "--nchan", str(NCHAN),
                      "--nfft", str(GBT_NFFT), "--nint", str(GBT_NINT),
                      "--window-frames", str(MESH_WINDOW_FRAMES), "--chunks",
                      str(MESH_CHAOS_WINDOWS), "--lease-ttl", str(MESH_LEASE_TTL),
                      "--poll", "0.05",
                      "--work-dir", os.path.join(dirs["cli"], "chaos")],
            "session": ["session", spec, "--work-dir", os.path.join(dirs["cli"], "sw")],
        }
        t_cli = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "blit_torch", *args, "--device", MESH_CHILD_DEVICE],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, args in cmds.items()}
        try:
            drills = {}

            def drill(tag, fault, dpp):
                tl = Timeline()
                t0 = time.perf_counter()
                try:
                    rep = ScanSupervisor(
                        grid24, out_dir=dirs[tag], nfft=GBT_NFFT, nint=GBT_NINT,
                        window_frames=MESH_WINDOW_FRAMES, nprocs=2,
                        devices_per_proc=dpp, lease_ttl_s=MESH_LEASE_TTL,
                        poll_s=0.05, max_attempts=3, faults=fault, timeline=tl,
                        device=MESH_CHILD_DEVICE).run()
                except Exception as e:  # noqa: BLE001 — reported below
                    rep = {"recovered": False, "error": repr(e), "attempts": []}
                drills[tag] = (rep, tl, time.perf_counter() - t0)

            threads = [threading.Thread(target=drill, args=a) for a in (
                ("kill", {1: "mesh.window:kill:after=1"}, 8),
                ("hang", {0: "mesh.window:hang:after=3:hang=120"}, 4))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=MESH_CHILD_TIMEOUT)
            for tag in ("kill", "hang"):
                rep, tl, wall = drills.get(tag, ({"recovered": False, "attempts": []},
                                                 Timeline(), 0.0))
                same = _files_equal([(os.path.join(dirs[tag], f"band{b}.fil"),
                                      oracle24[b][0]) for b in (0, 1)]
                                    ) if rep["recovered"] else [False]
                hists = tl.report().get("hists", {})
                plans = [(a["plan"], a["nprocs"], a.get("failure", {}).get("why"))
                         for a in rep["attempts"]]
                log(f"mesh {tag} drill (r6): {json.dumps({'wall_s': round(wall, 3), 'recovered': rep['recovered'], 'error': rep.get('error'), 'plans': plans, 'windows_recomputed': sum(a.get('windows_recomputed', 0) for a in rep['attempts']), **{h: hists.get(h, {}) for h in RECOVER_HISTS}, 'byte_identical': same})}; card: {smi}")
                want_why = "died" if tag == "kill" else "hung"
                if (not rep["recovered"] or not all(same)
                        or rep["attempts"][0]["failure"]["why"] != want_why):
                    raise AssertionError(f"mesh {tag} drill: not recovered with "
                                         "identical bytes")
            outs = {}
            for name, p in procs.items():
                out, err = p.communicate(timeout=MESH_CHILD_TIMEOUT)
                outs[name] = (p.returncode, out.strip().splitlines()[-1:], err[-2000:])
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
        cli_s = time.perf_counter() - t_cli
        chaos = json.loads(outs["chaos"][1][0]) if outs["chaos"][1] else {}
        session = json.loads(outs["session"][1][0]) if outs["session"][1] else {}
        same = _files_equal([(os.path.join(dirs["cli"], "band0.fil"), oracle18)]
                            + [(s["out"], o) for s, o in sess])
        log(f"mesh command line and drills (r6): {json.dumps({'wall_s': round(cli_s, 3), 'rc': {k: v[0] for k, v in outs.items()}, 'chaos': {k: chaos.get(k) for k in ('recovered', 'byte_identical', 'recover')}, 'session': {'ok': session.get('ok'), 'recovered_seats': session.get('recovered_seats')}, 'byte_identical': same})}; card: {smi}")
        if any(v[0] != 0 for v in outs.values()) or not all(same):
            raise AssertionError(f"mesh command line: {outs}")
    finally:
        if not (tree and tree.get("root") == root):  # a handed tree is the caller's
            shutil.rmtree(root, ignore_errors=True)
    log(f"mesh: phase (r) over the band tree took {time.perf_counter() - t_phase:.1f} s")
    return counts


def synth_raw_seat(path, i):
    """(r6)'s session seat i: a small 64-channel recording."""
    from blit_torch.testing import synth_raw_blocks

    synth_raw_blocks(path, nblocks=MESH_SESSION_BLOCKS, obsnchan=NCHAN,
                     ntime_per_block=MESH_SESSION_NTIME, seed=SEED + 40 + i,
                     tone_chan=i, tone_freq=TONE_FREQ)


def check_mesh_xengine(plan, launches):
    """(r4)'s correlate took the X-engine kernel on each of 8 players and
    the F-engine's dft_last on each."""
    if (plan != {"layout": "packed", "engine": "cuda", "impl": "cuda"}
            or launches["xengine_packed"] != 8 or launches["dft_last"] < 8):
        raise AssertionError(f"mesh correlate: plan {plan}, launches {launches}")


def phase_mesh_array(torch, dev, tmp, smi):
    """(r4) on (k)'s and (l)'s recordings: beamform with the antennas over
    8 players (the matmul route and the psum) and over 1 (the fused
    kernel), both against the one-card port; correlate on a (2, 4) mesh
    with packed visibilities against its plain version, segment by
    segment; an AntennaStream with on_antenna_error="mask" and one
    antenna's file cut after it opened.  Returns (launch counts, [])."""
    import numpy as np

    from blit_torch.ops import beamform as tbf
    from blit_torch.ops import channelize as tch
    from blit_torch.parallel import antenna as A
    from blit_torch.parallel import beamform as B
    from blit_torch.parallel import correlator as C
    from blit_torch.parallel.mesh import make_mesh

    counts = {}
    bf = [os.path.join(tmp, f"bf{a}.raw") for a in range(ARRAY_NANT)]
    fx = [os.path.join(tmp, f"fx{a}.raw") for a in range(ARRAY_NANT)]
    rng = np.random.default_rng(SEED)
    w = tbf.pack_weights(*B.delay_weights_planar(
        rng.uniform(0, 1e-9, (BF_NBEAM, ARRAY_NANT)),
        np.linspace(1e9, 1.1e9, BF_NCHAN), device=dev))
    _, v1 = A.load_antennas(bf, max_samples=BF_SAMPLES, layout="chan", device=dev)
    ref = B.beamform(v1, w, nint=BF_NINT, layout="chan", device=dev)
    del v1
    rows = {}
    for nplayers in (8, 1):
        m = make_mesh(1, nplayers, devices=[dev] * nplayers)
        _, v = A.load_antennas_mesh(bf, mesh=m, max_samples=BF_SAMPLES, layout="chan")
        torch.cuda.synchronize()
        reset_launches()
        got = B.beamform(v, w, nint=BF_NINT, layout="chan", mesh=m)
        torch.cuda.synchronize()
        path = f"mesh beamform {nplayers}"
        counts[path] = read_launches()
        plan = B.last_beamform_plan()
        fused = nplayers == 1
        check_array(path, plan, {"layout": "chan", "fused": fused, "impl": "cuda",
                                 "mesh_axis_size": nplayers},
                    counts[path], {"fused_beamform_detect": 1 if fused else 0})
        err, ok = check_close(torch, got, ref, 1e-4, 1e-3 * float(ref.abs().max()))
        ms = median_ms(torch, lambda: B.beamform(v, w, nint=BF_NINT, layout="chan",
                                                 mesh=m))
        rows[nplayers] = {"max_abs_err": err, "bitwise": bool(torch.equal(got, ref)),
                          "ms": round(ms, 4)}
        if not ok or (fused and not torch.equal(got, ref)):
            raise AssertionError(f"{path}: differs from the one-card beamform")
        del v, got
    log(f"mesh beamform (r4): antennas over 8 players (matmul + psum) and 1 "
        f"(fused) against the one-card port: {json.dumps(rows)}; card: {smi}")

    # Correlate on (2, 4): each band row F-engines its own segment.
    m24 = make_mesh(2, 4, devices=[dev] * 8)
    h = torch.from_numpy(tch.pfb_coeffs(NTAP, FX_NFFT)).to(dev)
    _, v = A.load_correlator_mesh(fx, mesh=m24, nfft=FX_NFFT, ntap=NTAP)
    torch.cuda.synchronize()
    reset_launches()
    visr, visi = C.correlate(v, h, nfft=FX_NFFT, ntap=NTAP, vis_layout="packed",
                             mesh=m24)
    torch.cuda.synchronize()
    counts["mesh correlate"] = launches = read_launches()
    check_mesh_xengine(C.last_xengine_plan(), launches)
    seg = (FX_SAMPLES // 2) // FX_NFFT * FX_NFFT
    wr = wi = None
    for b in range(2):
        _, vb = A.load_correlator(fx, nfft=FX_NFFT, ntap=NTAP, start_sample=b * seg,
                                  max_samples=seg, device=dev)
        pr, pi = correlate_plain(torch, vb, h)
        wr, wi = (pr, pi) if wr is None else (wr + pr, wi + pi)
        del vb
    scale = float(wr.abs().max())
    err_r, ok_r = check_close(torch, visr, wr, 1e-4, 1e-4 * scale)
    err_i, ok_i = check_close(torch, visi, wi, 1e-4, 1e-4 * scale)
    log(f"mesh correlate (r4): (2, 4) mesh, packed, {ARRAY_NANT} antennas x "
        f"{FX_NCHAN} channels, nfft {FX_NFFT}, two segments of {seg} samples: "
        f"launches {json.dumps({k: launches[k] for k in ('xengine_packed', 'dft_last')})}, "
        f"max |err| {max(err_r, err_i):.3e} against the plain route (atol "
        f"{1e-4 * scale:.3e}); card: {smi}")
    if not (ok_r and ok_i):
        raise AssertionError("mesh correlate: differs from its plain version")
    del v, visr, visi, wr, wi

    # The degraded continuation: one antenna's file cut after it opened.
    cut = os.path.join(tmp, "bf_cut.raw")
    shutil.copyfile(bf[MESH_MASK_ANTENNA], cut)
    paths = list(bf)
    paths[MESH_MASK_ANTENNA] = cut
    m8 = make_mesh(1, 8, devices=[dev] * 8)
    feed = A.AntennaStream(paths, mesh=m8, window_samples=BF_SAMPLES, layout="chan",
                           on_antenna_error="mask")
    # The second of the file's two blocks loses its last half: windows
    # 0 and 1 read whole, the reads of windows 2 and 3 come back short.
    os.truncate(cut, os.path.getsize(cut) - os.path.getsize(cut) // 4)
    masked = []

    def spy(f):
        for win in f:
            masked.append(win.masked)
            yield win

    slabs = list(B.beamform_stream(spy(feed), w, nint=BF_NINT, layout="chan",
                                   mesh=m8))
    power = torch.cat(slabs, dim=-1)
    finite = bool(torch.isfinite(power).all())
    log(f"mesh masked stream (r4): antenna {MESH_MASK_ANTENNA}'s file cut: "
        f"masked by window {masked}, header _masked_antennas "
        f"{feed.header.get('_masked_antennas')}, power {tuple(power.shape)} "
        f"finite: {finite}; card: {smi}")
    if (not finite or feed.header.get("_masked_antennas") != [MESH_MASK_ANTENNA]
            or not masked[-1] or masked[0]):
        raise AssertionError("mesh masked stream: the cut antenna was not masked")
    os.unlink(cut)
    return counts, []


# (s) the serve plane: ProductService, the content-addressed cache, the
# fleet wire and front door, the catalog, fsck.  Peers are
# `python -m blit_torch fleet-peer` processes on the card, started together.
SERVE_RAM_BYTES = 6 << 30       # (s1): holds the 0000 product and its wire body
SERVE_PEERS = 2                 # (s3)
SERVE_PEER_RAM_BYTES = 1 << 30
SERVE_PEER_TTL = 2.0            # (s3): the door's lease TTL, seconds
SERVE_COALESCED = 8             # (s1): identical asks submitted at once
SERVE_TIMEOUT = 300


def _serve_env(reqlog):
    """Environment of a fleet-peer child: this checkout on PYTHONPATH,
    its request log under ``reqlog``."""
    env = dict(os.environ, BLIT_REQUEST_LOG=reqlog)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn_fleet_peers(work, n, env, extra=()):
    """Start ``n`` fleet-peer processes at once on CLI_DEVICE, RAM tier
    only, beating leases in ``work/leases``.  Returns (procs, name → url,
    lease dir, spawn seconds)."""
    from blit_torch.serve.http import wait_http_ready

    lease = os.path.join(work, "leases")
    t0 = time.perf_counter()
    procs, peers = [], {}
    for i in range(n):
        cmd = [sys.executable, "-m", "blit_torch", "fleet-peer",
               "--name", f"peer{i}", "--lease-dir", lease, "--proc", str(i),
               "--port", "0", "--port-file", os.path.join(work, f"peer{i}.port"),
               "--beat-interval", "0.1", "--ram-bytes", str(SERVE_PEER_RAM_BYTES),
               "--retry-seed", str(i), "--device", CLI_DEVICE, *extra]
        log_f = open(os.path.join(work, f"peer{i}.log"), "w")
        procs.append(subprocess.Popen(cmd, env=env, stdout=log_f,
                                      stderr=subprocess.STDOUT))
        log_f.close()
    try:
        for i in range(n):
            pf = os.path.join(work, f"peer{i}.port")
            deadline = time.monotonic() + SERVE_TIMEOUT
            while not os.path.exists(pf):
                if procs[i].poll() is not None or time.monotonic() > deadline:
                    with open(os.path.join(work, f"peer{i}.log")) as f:
                        raise AssertionError(f"serve: peer{i} did not come up: "
                                             f"{f.read()[-2000:]}")
                time.sleep(0.05)
            with open(pf) as f:
                url = f"http://127.0.0.1:{int(f.read())}"
            wait_http_ready(url, timeout_s=SERVE_TIMEOUT)
            peers[f"peer{i}"] = url
    except BaseException:
        stop_procs(procs)
        raise
    return procs, peers, lease, time.perf_counter() - t0


def stop_procs(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)


def ask_peer(url, request, binary=True):
    """One /product round trip to a peer → (status, tier, header, data,
    payload bytes, seconds)."""
    from blit_torch.serve import http as shttp

    hdrs = {"Content-Type": "application/json"}
    if binary:
        hdrs["Accept"] = shttp.WIRE_CTYPE
    t0 = time.perf_counter()
    st, rh, body = shttp.http_request(
        "POST", url, "/product",
        body=json.dumps(shttp.wire_request(request)).encode(),
        headers=hdrs, timeout=SERVE_TIMEOUT)
    dt = time.perf_counter() - t0
    if st != 200:
        raise AssertionError(f"serve: peer answered {st}: {body[:300]!r}")
    if rh.get("content-type", "").startswith(shttp.WIRE_CTYPE):
        hdr, data = shttp.decode_product_wire(body)
    else:
        hdr, data = shttp.decode_product(json.loads(body))
    return st, rh.get(shttp.TIER_HEADER.lower()), hdr, data, len(body), dt


def same_product(what, got, want):
    """Header equal and payload byte-equal, else raise."""
    (gh, gd), (wh, wd) = got, want
    if gh != wh:
        raise AssertionError(f"serve {what}: header differs from the direct "
                             f"reduction's")
    if gd.shape != wd.shape or gd.dtype != wd.dtype or gd.tobytes() != wd.tobytes():
        raise AssertionError(f"serve {what}: product differs from the direct "
                             f"reduction's")


def check_publish(what, cache):
    st = cache.stats()
    if st.get("publish.error", 0):
        raise AssertionError(f"serve {what}: {st['publish.error']} failed "
                             "publishes")
    return st


def phase_serve_service(torch, dev, raw_path, tmp, smi):
    """(s1), (s2): ProductService on the card, RAM tier.  Returns the
    launch counts of the serve paths."""
    import numpy as np

    from blit_torch.io.hits import read_hits
    from blit_torch.observability import Timeline
    from blit_torch.ops import channelize as tch
    from blit_torch.pipeline import reducer_for_product
    from blit_torch.search import DedopplerReducer, hits_from_array
    from blit_torch.serve import (
        PeerServer,
        ProductCache,
        ProductRequest,
        ProductService,
        Scheduler,
    )

    counts = {}
    tl = Timeline()
    cache = ProductCache(None, ram_bytes=SERVE_RAM_BYTES, timeline=tl)
    svc = ProductService(cache=cache, timeline=tl, device=dev,
                         scheduler=Scheduler(max_concurrency=2, queue_depth=16,
                                             timeline=tl))
    server = None
    try:
        # (s1) the 0000 product, cold, then against the direct reduction.
        req = ProductRequest(raw=raw_path, product="0000")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = svc.get(req, timeout=SERVE_TIMEOUT)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts["serve 0000"] = cold = read_launches()
        check_plan("serve 0000", tch.last_kernel_plan(), cold)
        t0 = time.perf_counter()
        want = reducer_for_product("0000", device=dev).reduce(raw_path)
        direct_s = time.perf_counter() - t0
        same_product("0000", got, want)
        if not np.isfinite(got[1]).all():
            raise AssertionError("serve 0000: non-finite product values")
        del want
        reset_launches()
        t0 = time.perf_counter()
        t = svc.submit(req)
        hot = svc.result(t, timeout=10)
        hot_s = time.perf_counter() - t0
        if t.source != "ram" or hot[1] is not got[1] or any(read_launches().values()):
            raise AssertionError(f"serve 0000: the repeat ask was not a RAM hit "
                                 f"({t.source}) or launched a kernel")
        log(f"serve (s1): 0000 through ProductService, {got[1].nbytes / 2**30:.3f} "
            f"GiB: cold {cold_s:.3f} s (direct reduce {direct_s:.3f} s), RAM hit "
            f"{hot_s * 1e3:.3f} ms, byte-equal to the direct reduction, launches "
            f"{json.dumps({k: cold[k] for k in ('pfb_dft1', 'tail2_detect')})}; "
            f"card: {smi}")

        # Eight identical asks at once: one reduction.
        cache.clear()
        c0 = dict(svc.counts)
        reset_launches()
        t0 = time.perf_counter()
        tickets = [svc.submit(req, client=f"c{i}") for i in range(SERVE_COALESCED)]
        outs = [svc.result(tk, timeout=SERVE_TIMEOUT) for tk in tickets]
        torch.cuda.synchronize()
        co_s = time.perf_counter() - t0
        launches = read_launches()
        delta = {k: svc.counts[k] - c0[k] for k in ("scheduled", "coalesced")}
        log(f"serve (s1): {SERVE_COALESCED} identical 0000 asks at once in "
            f"{co_s:.3f} s: scheduled {delta['scheduled']}, coalesced "
            f"{delta['coalesced']}, launches {json.dumps(launches)}; card: {smi}")
        if (delta != {"scheduled": 1, "coalesced": SERVE_COALESCED - 1}
                or launches != cold
                or any(o[1] is not outs[0][1] for o in outs)
                or outs[0][1].tobytes() != got[1].tobytes()):
            raise AssertionError("serve 0000: the identical asks did not share "
                                 "one reduction")
        del outs, tickets

        # The binary wire through an in-process peer: the first ask
        # encodes and keeps the frame, the second is a wire hit.
        server = PeerServer(svc, name="s1").start()
        reset_launches()
        _, tier1, h1, d1, nb, first_s = ask_peer(server.url, req)
        _, tier2, h2, d2, nb2, wire_s = ask_peer(server.url, req)
        if any(read_launches().values()):
            raise AssertionError("serve 0000: a wire hit launched a kernel")
        same_product("0000 wire", (h2, d2), got)
        if tier1 != "ram" or tier2 != "ram" or cache.stats()["wire_entries"] != 1:
            raise AssertionError(f"serve 0000: wire tiers {tier1}, {tier2}, "
                                 f"{cache.stats()}")
        log(f"serve (s1): 0000 over the binary wire: first {first_s:.3f} s "
            f"(encode kept), hot wire hit {wire_s:.3f} s for {nb2 / 1e9:.3f} GB "
            f"= {nb2 / wire_s / 1e9:.3f} GB/s, zero launches; card: {smi}")
        del d1, d2, h1, h2
        server.close()
        server = None
        cache.clear()
        del got, hot
        torch.cuda.empty_cache()

        # (s2) a hits ask at search_defaults() against (h)'s .hits.
        hreq = ProductRequest(raw=raw_path, kind="hits", nfft=SEARCH_NFFT, nint=1)
        reset_launches()
        t0 = time.perf_counter()
        hh, hd = svc.get(hreq, timeout=SERVE_TIMEOUT)
        torch.cuda.synchronize()
        hits_s = time.perf_counter() - t0
        counts["serve hits"] = hl = read_launches()
        check_plan("serve hits", tch.last_kernel_plan(), hl)
        _, file_hits = read_hits(os.path.join(tmp, "smoke.hits"))
        mine = hits_from_array(hd, hh)
        if [h.record() for h in mine] != [h.record() for h in file_hits]:
            raise AssertionError("serve hits: the hits differ from (h)'s .hits")
        want = DedopplerReducer(nfft=SEARCH_NFFT, nint=1, device=dev).reduce(raw_path)
        same_product("hits", (hh, hd), want)
        t0 = time.perf_counter()
        t = svc.submit(hreq)
        svc.result(t, timeout=10)
        log(f"serve (s2): hits ask at search_defaults(): {len(mine)} hits equal "
            f"to (h)'s .hits and the direct reduction's bytes, cold {hits_s:.3f} s, "
            f"{t.source} hit {(time.perf_counter() - t0) * 1e3:.3f} ms, "
            f"taylor_tree launches {hl['taylor_tree']}; card: {smi}")
        st = check_publish("(s1, s2)", cache)
        log(f"serve (s1, s2): service counts {json.dumps(svc.counts)}, cache "
            f"{json.dumps(st)}")
    finally:
        if server is not None:
            server.close()
        svc.close()
    return counts


def phase_serve_fleet(torch, dev, raw_path, tmp, smi):
    """(s3): two fleet-peer processes on the card behind this process's
    FleetFrontDoor on the binary wire; a peer SIGKILLed, the other
    drained by SIGTERM; the requests command over their logs."""
    from blit_torch.config import DEFAULT
    from blit_torch.pipeline import reducer_for_product
    from blit_torch.search import DedopplerReducer
    from blit_torch.serve import FleetFrontDoor, ProductRequest

    work = os.path.join(tmp, "fleet")
    reqlog = os.path.join(work, "reqlog")
    os.makedirs(work)
    env = _serve_env(reqlog)
    procs, peers, lease, spawn_s = spawn_fleet_peers(work, SERVE_PEERS, env)
    door = None
    try:
        log(f"serve (s3): {SERVE_PEERS} fleet-peer processes on {CLI_DEVICE} up in "
            f"{spawn_s:.2f} s; card: {smi}")
        door = FleetFrontDoor(peers, lease_dir=lease, peer_ttl_s=SERVE_PEER_TTL,
                              poll_s=0.05, hedge_floor_s=SERVE_TIMEOUT,
                              request_timeout_s=SERVE_TIMEOUT,
                              config=DEFAULT.with_(request_log_dir=reqlog)).start()
        asks = {
            "0002": (ProductRequest(raw=raw_path, product="0002"),
                     lambda: reducer_for_product("0002", device=dev).reduce(raw_path)),
            "0001": (ProductRequest(raw=raw_path, product="0001"),
                     lambda: reducer_for_product("0001", device=dev).reduce(raw_path)),
            "hits": (ProductRequest(raw=raw_path, kind="hits", nfft=SEARCH_NFFT,
                                    nint=1),
                     lambda: DedopplerReducer(nfft=SEARCH_NFFT, nint=1,
                                              device=dev).reduce(raw_path)),
        }
        # The direct reductions run in this process on a thread of their
        # own while the peers serve the same asks (0001's default 128
        # frames a chunk makes both take tens of seconds).
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        pending = {name: pool.submit(fn) for name, (_, fn) in asks.items()}
        pool.shutdown(wait=False)
        rows, direct = {}, {}
        for name, (req, fn) in asks.items():
            t0 = time.perf_counter()
            got = door.get(req)
            cold = time.perf_counter() - t0
            direct[name] = pending[name].result(timeout=SERVE_TIMEOUT)
            same_product(f"fleet {name}", got, direct[name])
            t0 = time.perf_counter()
            again = door.get(req)
            hot = time.perf_counter() - t0
            same_product(f"fleet {name} repeat", again, direct[name])
            rows[name] = {"owner": door.ring.owner(req.fingerprint()),
                          "cold_s": round(cold, 6), "hot_s": round(hot, 6),
                          "bytes": int(got[1].nbytes)}
        from blit_torch.monitor import read_requests

        door_recs = [r for r in read_requests(reqlog) if r.get("role") == "door"]
        tiers = [r.get("tier") for r in door_recs]
        log(f"serve (s3): asks through the door, byte-equal to the direct "
            f"reductions: {json.dumps(rows)}; door tiers {tiers}; card: {smi}")
        if not all(t in ("ram", "wire") for t in tiers[1::2]):
            raise AssertionError(f"serve fleet: a repeat ask missed the peer's "
                                 f"RAM/wire tier: {tiers}")

        # SIGKILL the owner of 0002: ejected by its lease, re-routed.
        req = asks["0002"][0]
        owner = rows["0002"]["owner"]
        victim = procs[int(owner[len("peer"):])]
        t_kill = time.perf_counter()
        victim.kill()
        victim.wait(timeout=30)
        deadline = time.monotonic() + 10 * SERVE_PEER_TTL
        while owner in door.ring and time.monotonic() < deadline:
            time.sleep(0.01)
        detect_s = time.perf_counter() - t_kill
        if owner in door.ring:
            raise AssertionError(f"serve fleet: {owner} was never ejected")
        t0 = time.perf_counter()
        rerouted = door.get(req)
        reroute_s = time.perf_counter() - t0
        same_product("fleet 0002 after the kill", rerouted, direct["0002"])
        survivor_name = next(n for n in peers if n != owner)
        survivor = procs[int(survivor_name[len("peer"):])]
        log(f"serve (s3): SIGKILL {owner}: ejected after {detect_s:.3f} s "
            f"(TTL {SERVE_PEER_TTL} s), 0002 re-routed to {survivor_name} in "
            f"{reroute_s:.3f} s, byte-identical; card: {smi}")
        t0 = time.perf_counter()
        survivor.send_signal(signal.SIGTERM)
        rc = survivor.wait(timeout=SERVE_TIMEOUT)
        log(f"serve (s3): SIGTERM {survivor_name}: drained and exited {rc} in "
            f"{time.perf_counter() - t0:.3f} s; card: {smi}")
        if rc != 0:
            raise AssertionError(f"serve fleet: the drained peer exited {rc}")
        door.close()
        door = None
        out = subprocess.run([sys.executable, "-m", "blit_torch", "requests",
                              reqlog, "--json"], capture_output=True, text=True,
                             timeout=SERVE_TIMEOUT, env=env)
        recs = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
        by_role = {}
        for r in recs:
            by_role[r.get("role")] = by_role.get(r.get("role"), 0) + 1
        log(f"serve (s3): python -m blit_torch requests: rc {out.returncode}, "
            f"records by role {json.dumps(by_role)}")
        if (out.returncode != 0 or by_role.get("door") != 2 * len(asks) + 1
                or not by_role.get("peer")
                or any(r.get("status") != "ok" for r in recs)):
            raise AssertionError(f"serve fleet: the request logs: {out.stderr[-2000:]}")
        return {"spawn_s": spawn_s, "detect_s": detect_s, "reroute_s": reroute_s}
    finally:
        if door is not None:
            door.close()
        stop_procs(procs)


def _flip_byte(path, from_end=64):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - from_end)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x5A]))


def h5py_missing():
    """None when h5py imports, else why not (the disk and cold tiers,
    the scrubber, backfill and fsck --repair write FBH5)."""
    try:
        import h5py  # noqa: F401
    except Exception as e:  # noqa: BLE001 — reported on the skip line
        return f"{type(e).__name__}: {e}"
    return None


def phase_serve_fsck(torch, dev, raw_path, tmp, smi):
    """(s4): python -m blit_torch fsck over copies of (d)'s .fil products
    and their manifests; then, when h5py imports, the disk and cold tiers,
    the scrubber and fsck --repair on the card."""
    env = _serve_env("")
    tree = os.path.join(tmp, "fsck")
    os.makedirs(tree)
    for p in ("0002", "0001"):
        for suffix in ("", ".manifest.json"):
            shutil.copyfile(os.path.join(tmp, f"smoke.{p}.fil{suffix}"),
                            os.path.join(tree, f"smoke.{p}.fil{suffix}"))

    def fsck(*args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "blit_torch", "fsck", *args],
                             capture_output=True, text=True, timeout=SERVE_TIMEOUT,
                             env=env)
        rep = json.loads(out.stdout.strip().splitlines()[-1]) if out.stdout.strip() else {}
        return out.returncode, rep, time.perf_counter() - t0

    rc0, rep0, s0 = fsck(tree)
    _flip_byte(os.path.join(tree, "smoke.0001.fil"))
    rc1, rep1, s1 = fsck(tree)
    bad = [e["path"] for e in rep1.get("bad", [])]
    quarantined = os.path.exists(os.path.join(tree, ".quarantine", "smoke.0001.fil"))
    log(f"serve (s4): fsck over (d)'s 0002 and 0001 products: clean rc {rc0} "
        f"({rep0.get('checked')} checked, {s0:.2f} s), one flipped byte rc {rc1}, "
        f"bad {bad}, quarantined {quarantined}; card: {smi}")
    if (rc0, rc1) != (0, 1) or bad != ["smoke.0001.fil"] or not quarantined:
        raise AssertionError("serve fsck: the flipped byte was not caught")
    why = h5py_missing()
    if why is not None:
        log(f"serve (s4): skipped the disk tier, the cold tier, the scrubber, "
            f"backfill and fsck --repair: they write FBH5 and h5py does not import "
            f"here ({why})")
        return
    phase_serve_disk(torch, dev, raw_path, tmp, smi, fsck)


def phase_serve_disk(torch, dev, raw_path, tmp, smi, fsck):
    """(s4), with h5py: 0002 and 0001 through a disk tier whose bound
    demotes 0002 to a cold tier; the cold hit promoted and byte-equal;
    the scrubber over the entries; one entry flipped and rebuilt by
    fsck --repair on CLI_DEVICE."""
    from blit_torch import integrity
    from blit_torch.serve import ProductCache, ProductRequest, ProductService

    hot = os.path.join(tmp, "serve-hot")
    cold = os.path.join(tmp, "serve-cold")
    reqs = {p: ProductRequest(raw=raw_path, product=p) for p in ("0002", "0001")}
    svc = ProductService(device=dev, cache=ProductCache(hot, ram_bytes=0,
                                                        disk_bytes=1,
                                                        cold_dir=cold))
    try:
        first = {p: svc.get(r, timeout=SERVE_TIMEOUT) for p, r in reqs.items()}
        t0 = time.perf_counter()
        t = svc.submit(reqs["0002"])
        again = svc.result(t, timeout=SERVE_TIMEOUT)
        cold_s = time.perf_counter() - t0
        same_product("0002 cold tier", again, first["0002"])
        st = check_publish("(s4) disk", svc.cache)
        scrub = integrity.Scrubber(svc.cache, interval_s=1.0)
        rows = [scrub.scrub_once() for _ in svc.cache.index()]
    finally:
        svc.close()
    log(f"serve (s4): disk + cold tiers: 0002 served from {t.source} in "
        f"{cold_s:.3f} s byte-equal; cache {json.dumps(st)}; scrubber "
        f"{[(r['ok'], r['bytes']) for r in rows if r]}; card: {smi}")
    if t.source != "cold" or not rows or not all(r and r["ok"] for r in rows):
        raise AssertionError("serve disk tiers: a cold hit or the scrub failed")
    fp = svc.cache.index()[0]
    with open(svc.cache.data_path(fp), "rb") as f:
        want = f.read()
    _flip_byte(svc.cache.data_path(fp))
    rc, rep, secs = fsck(hot, "--repair", "--device", CLI_DEVICE)
    with open(svc.cache.data_path(fp), "rb") as f:
        same = f.read() == want
    log(f"serve (s4): fsck --repair on {CLI_DEVICE}: rc {rc}, repaired "
        f"{len(rep.get('repaired', []))}, entry byte-identical {same}, "
        f"{secs:.2f} s; card: {smi}")
    if not (rep.get("repaired") and same):
        raise AssertionError("serve fsck --repair: the entry was not re-derived")


def phase_serve_catalog(torch, dev, tree, smi):
    """(s5), over (p)'s band tree: a catalog-addressed ask through a
    fleet-peer started with --catalog-root equals the explicit-path ask
    and the direct reduction; with h5py, backfill over two players."""
    from blit_torch.pipeline import RawReducer
    from blit_torch.serve import ProductRequest

    root, seqs = tree["root"], tree["seqs"]
    work = tempfile.mkdtemp(prefix="blit-smoke-serve-")
    env = _serve_env(os.path.join(work, "reqlog"))
    procs, peers, _, spawn_s = spawn_fleet_peers(
        work, 1, env, extra=("--catalog-root", root))
    try:
        url = peers["peer0"]
        bank = 1
        addressed = ProductRequest(raw="", session=GBT_SESSION, scan=GBT_SCAN,
                                   band=0, bank=bank, nfft=GBT_NFFT, nint=GBT_NINT)
        explicit = ProductRequest(raw=tuple(seqs[bank]), nfft=GBT_NFFT,
                                  nint=GBT_NINT)
        _, tier_a, ha, da, _, a_s = ask_peer(url, addressed)
        _, tier_e, he, de, _, e_s = ask_peer(url, explicit)
        want = RawReducer(nfft=GBT_NFFT, nint=GBT_NINT, device=dev).reduce(
            list(seqs[bank]))
        same_product("catalog ask", (ha, da), want)
        same_product("explicit ask", (he, de), want)
        log(f"serve (s5): peer with --catalog-root up in {spawn_s:.2f} s; "
            f"({GBT_SESSION}, {GBT_SCAN}, band 0, bank {bank}) {tier_a} in "
            f"{a_s:.3f} s, the explicit-path ask {tier_e} in {e_s:.3f} s, both "
            f"byte-equal to the direct reduction; card: {smi}")
        if tier_a != "derive" or tier_e not in ("ram", "wire"):
            raise AssertionError(f"serve catalog: tiers {tier_a}, {tier_e}")
        procs[0].send_signal(signal.SIGTERM)
        if procs[0].wait(timeout=SERVE_TIMEOUT) != 0:
            raise AssertionError("serve catalog: the peer did not drain to 0")
        if h5py_missing() is None:
            out = subprocess.run(
                [sys.executable, "-m", "blit_torch", "backfill", root,
                 "--cache-dir", os.path.join(work, "backfill"), "--nfft",
                 str(GBT_NFFT), "--nint", str(GBT_NINT), "--limit", "2",
                 "--bytes-per-s", "0", "--device", CLI_DEVICE],
                capture_output=True, text=True, timeout=SERVE_TIMEOUT, env=env)
            rep = json.loads(out.stdout.strip().splitlines()[-1])
            log(f"serve (s5): backfill of 2 players: rc {out.returncode}, derived "
                f"{rep['derived']}, {rep['wall_s']} s; card: {smi}")
            if out.returncode != 0 or rep["derived"] != 2:
                raise AssertionError("serve backfill failed")
    finally:
        stop_procs(procs)
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke needs a GPU", file=sys.stderr)
        return 2
    try:
        from blit_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: blit_torch is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # (a) device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}")
    log(f"card: {smi}")

    # (b) build
    t0 = time.perf_counter()
    logs = kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    # (c) kernels vs twins, (g) taylor_tree vs its plain version
    records = phase_kernels(torch, dev) + phase_front_kernels(torch, dev)
    records += phase_tree(torch, dev)

    # (d) main paths, (h) the search, (i) the hi-res search, (j) drift
    # recovery, then (e) the 2^21 path and (f) the 6144 path
    launches = {}
    tmp = tempfile.mkdtemp(prefix="blit-smoke-")
    try:
        raw_path = write_recording(tmp)
        for product in PRODUCTS:
            launches[product], _ = phase_product(torch, dev, raw_path, tmp,
                                                 product)
        launches["search"], _ = phase_search(torch, dev, raw_path, tmp)
        launches["hi-res search"], _ = phase_hires_search(torch, dev, raw_path)
        # (n) the asynchronous plane against the synchronous path
        plane_rows = phase_plane_products(torch, dev, raw_path, tmp)
        # (q) the live plane and the command line
        t0 = time.perf_counter()
        launches.update(phase_live(torch, dev, raw_path, tmp, launches, smi))
        log(f"live: phase (q) took {time.perf_counter() - t0:.1f} s")
        # (r2) 0000 on a (1, 2) mesh, (r6) the supervised live drill
        t_mesh = time.perf_counter()
        launches.update(phase_mesh_recording(torch, dev, raw_path, tmp, smi))
        mesh_s = time.perf_counter() - t_mesh
        # (s1)-(s4) the serve plane on (d)'s recording and products
        t_serve = time.perf_counter()
        launches.update(phase_serve_service(torch, dev, raw_path, tmp, smi))
        fleet = phase_serve_fleet(torch, dev, raw_path, tmp, smi)
        phase_serve_fsck(torch, dev, raw_path, tmp, smi)
        serve_s = time.perf_counter() - t_serve
        # (o) resume, the scan, the native reader, .h5 products
        launches.update(phase_resume(torch, dev, raw_path, tmp))
        os.unlink(raw_path)
        launches["drift"] = phase_drift(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["2^21"], tail2_recs = phase_2pow21(torch, dev)
    records.extend(tail2_recs)
    launches["6144"], level_recs = phase_6144(torch, dev)
    records.extend(level_recs)
    stage_design_sweep(torch, dev)

    # (m) the opt-in routes and detect_untwist_i
    counts, recs, _ = phase_routes(torch, dev)
    launches.update(counts)
    records.extend(recs)

    # (k) the beamformer and (l) the correlator, from per-antenna RAW
    tmp = tempfile.mkdtemp(prefix="blit-smoke-array-")
    try:
        for phase in (phase_beamform, phase_correlator):
            counts, recs = phase(torch, dev, tmp)
            launches.update(counts)
            records.extend(recs)
        plane_rows += phase_plane_array(torch, dev, tmp)
        # (r4) the array plane over the mesh
        t_mesh = time.perf_counter()
        counts, _ = phase_mesh_array(torch, dev, tmp, smi)
        launches.update(counts)
        mesh_s += time.perf_counter() - t_mesh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (p) the reference's own API: inventory, the reduce_raw fan-out,
    # load_scan, get_data / get_kurtosis, search_raw, remote agents
    band_tree = {}
    launches["gbt"] = phase_gbt(torch, dev, smi, band_tree)

    # (r1), (r3), (r5), (r6): the mesh over (p)'s band tree, the pods, the
    # drills and the command line
    t_mesh = time.perf_counter()
    try:
        launches.update(phase_mesh(torch, dev, smi, band_tree))
        mesh_s += time.perf_counter() - t_mesh
        log(f"mesh: phase (r) took {mesh_s:.1f} s in all")
        # (s5) a catalog-addressed ask over the same band tree
        t_serve = time.perf_counter()
        phase_serve_catalog(torch, dev, band_tree, smi)
        serve_s += time.perf_counter() - t_serve
    finally:
        if band_tree.get("root"):
            shutil.rmtree(band_tree["root"], ignore_errors=True)
    log(f"serve: phase (s) took {serve_s:.1f} s in all (peer spawn "
        f"{fleet['spawn_s']:.2f} s, detect {fleet['detect_s']:.3f} s, re-route "
        f"{fleet['reroute_s']:.3f} s); card: {smi}")

    from blit_torch import hostmem

    for row in plane_table(plane_rows):
        log(f"plane table: {json.dumps(row)}")
    log(f"plane: {len(plane_rows)} runs passed; staging pool "
        f"{json.dumps(hostmem.slab_pool().stats())}")
    log(f"plane card: {smi}")

    # One record per kernel: the f32 variant at its first path's shape.
    total = {k: sum(c[k] for c in launches.values()) for k in COUNTED}
    log(f"launches by path: {json.dumps(launches)}")
    line = {"kernels": []}
    for name in COUNTED:
        r = next(r for r in records if r["name"] == name
                 and r["dtype"] == "float32" and r.get("stokes", "I") == "I"
                 and r.get("line", True))
        line["kernels"].append(
            {k: r[k] for k in ("name", "route", "source", "replaces")}
            | {"launches": total[name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"]})
    print(json.dumps(line))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
