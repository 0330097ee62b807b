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
at the array scale, all through the kernels, then drives the
reference's own API (inventory, the reduce_raw fan-out over a worker
pool, load_scan, get_data / get_kurtosis, remote agents) over one band
of eight banks, and checks the results.

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
    "gbt search": (_plan("pallas", "dft_last"),
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
    tree_s = sorted(red.timeline.observations.get("search.tree_s", []))
    gbps = st["ingest"].bytes / st["stream"].seconds / 1e9
    return dict(windows=hdr["search_windows"], hits=hdr["search_nhits"],
                wall_s=wall, windows_per_s=hdr["search_windows"] / wall,
                window_device_s_median=tree_s[len(tree_s) // 2] if tree_s else None,
                window_device_s_sum=sum(tree_s), raw_gb=st["ingest"].bytes / 1e9,
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


def phase_gbt(torch, dev, smi):
    """(p): the reference's own API on the card.  Inventory over a thread
    pool of 8 workers (blc00..blc07), the reduce_raw fan-out (each bank's
    sequence on its own worker) byte-identical to serial RawReducer runs
    with each tone in its fine channel, load_scan (the band stitched,
    despiked at nfpc 1024; again at fqav_by 8), get_data and
    get_kurtosis(device=True) fan-outs against the host, search_raw
    through the pool against a direct search, and 2 remote agents (python
    -m blit_torch.agent) reducing banks 0 and 1 on the card.  Returns the
    launch counts of the gbt path (fan-out and search)."""
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
        return launches
    finally:
        reset_pool()
        shutil.rmtree(root, ignore_errors=True)


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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (p) the reference's own API: inventory, the reduce_raw fan-out,
    # load_scan, get_data / get_kurtosis, search_raw, remote agents
    launches["gbt"] = phase_gbt(torch, dev, smi)

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
