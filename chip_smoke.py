#!/usr/bin/env python3
"""Smoke run of blit_torch on one CUDA GPU: builds the Hopper kernels,
holds each against its plain PyTorch twin at the main path's shapes,
then reduces a 64-channel GUPPI RAW recording to the rawspec ``0000``
product (nfft = 2^20) through the kernels and checks the result.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  (a) device: name and power limit;
  (b) build: both kernels with nvcc for sm_90a, timed;
  (c) kernels vs twins at the chunk shape of (d) — 64 coarse channels,
      nfft 2^20, ntap 4, chunk_frames 4 — elementwise, and for bf16 also
      in relative rms against a control that skips the bf16 rounding,
      with CUDA-event times (median of 7 runs after a warm-up), the least
      time the card could take (bound), and one JSON line listing the
      main path's kernels;
  (d) main path: a synthetic 2.95 GB RAW file (128 MiB blocks, a tone in
      one coarse channel) → reducer_for_product("0000", chunk_frames=4)
      .reduce_to_file(.fil) on the GPU; checks the kernel plan, the
      launch counts, the header, the tone's fine channel and both
      chunks against the plain twins (the second starts from the PFB
      state carried across); prints stage seconds, RAW GB/s and the
      real-time factor against one bank's 0.75 GB/s.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
RAW_SAMPLES = (2 * CHUNK_FRAMES + NTAP - 1) * NFFT  # two full chunks
TONE_CHAN, TONE_FREQ = 10, 0.3125
REALTIME_BANK_GBPS = 0.750
SEED = 2026

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # CUDA cores, f32
BF16_TC_FLOPS = 989e12   # tensor cores, bf16 operands

# Elementwise bounds: (rtol, atol as a fraction of the reference's
# scale, the scale).  The f32 ones are blit's (tests/test_pallas_pfb.py,
# tests/test_pallas_detect.py).  Over 2^28 outputs the peak is ~10-20×
# the mean, so the bf16 atol scales with the mean |value| instead.
BOUNDS = {
    ("pfb_dft1", "float32"): (1e-4, 1e-2, "peak"),
    ("pfb_dft1", "bfloat16"): (0.05, 0.05, "mean"),
    ("tail2_detect", "float32"): (1e-5, 1e-4, "peak"),
    ("tail2_detect", "bfloat16"): (0.05, 0.05, "mean"),
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


def check_bound(torch, got, want, name, dtype):
    """Elementwise check of ``BOUNDS[(name, dtype)]`` over the tensors
    of ``got`` and ``want`` → (max abs error, atol, ok)."""
    rtol, frac, scale = BOUNDS[(name, dtype)]
    if scale == "peak":
        s = max(w.float().abs().max().item() for w in want)
    else:
        s = (sum(w.float().abs().sum(dtype=torch.float64).item() for w in want)
             / sum(w.numel() for w in want))
    errs = [check_close(torch, a, b, rtol, frac * s) for a, b in zip(got, want)]
    return max(e[0] for e in errs), frac * s, all(e[1] for e in errs)


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


def pfb_cost(nchan, ntime, nframes, n1, dtype):
    """Bytes (each input once, each output once) and operations of one
    pfb_dft1 call: FIR 2 flops per tap per real value, 8·n1 flops per
    complex output of the DFT stage, 6 for the twiddle."""
    esize = 2 if dtype == "bfloat16" else 4
    m = NFFT // n1
    nout = nchan * 2 * nframes * NFFT
    nbytes = (nchan * ntime * 4 + NTAP * NFFT * 4 + 2 * n1 * n1 * 4
              + 2 * n1 * m * 4 + 2 * nout * esize)
    fir = nout * 2 * 2 * NTAP
    dft = nout * 8 * n1
    tw = nout * 6
    dft_rate = BF16_TC_FLOPS if dtype == "bfloat16" else F32_FLOPS
    return nbytes, [(fir + tw, F32_FLOPS), (dft, dft_rate)]


def tail_cost(nchan, nframes, f2, f3, stokes, dtype, nif):
    esize = 2 if dtype == "bfloat16" else 4
    nin = nchan * 2 * nframes * NFFT
    nbytes = 2 * nin * esize + (2 * f2 * f2 + 2 * f3 * f3 + 2 * f2 * f3) * 4 \
        + nframes * nif * nchan * NFFT * 4
    dft = nin * 8 * (f2 + f3)
    rest = nin * 6 + nframes * nchan * NFFT * DETECT_FLOPS[stokes]
    dft_rate = BF16_TC_FLOPS if dtype == "bfloat16" else F32_FLOPS
    return nbytes, [(rest, F32_FLOPS), (dft, dft_rate)]


def bf16_aggregate(torch, got, want, control) -> dict:
    """The aggregate bf16 check: the kernel within ``BF16_REL_RMS`` of
    its twin, the control beyond it."""
    r, c = rel_rms(torch, got, want), rel_rms(torch, control, want)
    return dict(rel_rms=r, control_rel_rms=c, rel_rms_bound=BF16_REL_RMS,
                rel_rms_ok=r <= BF16_REL_RMS < c)


def phase_kernels(torch, dev):
    """(c): every kernel variant against its plain twin at the chunk
    shape.  Returns the main-path variants' records."""
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import detect as tdet
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import pfb as tpfb

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
        got = tpfb.pfb_dft1(v, h, *mats, dtype=dtype)
        want = tpfb.pfb_dft1_plain(v, h, *mats, dtype=dtype)
        err, atol, ok = check_bound(torch, got, want, "pfb_dft1", dtype)
        agg = {}
        if dtype == "bfloat16":
            # Control: the f32 twin rounded only at its store.
            control = [x.to(torch.bfloat16)
                       for x in tpfb.pfb_dft1_plain(v, h, *mats)]
            agg = bf16_aggregate(torch, got, want, control)
            del control
        del want
        ms = median_ms(torch, lambda: tpfb.pfb_dft1(v, h, *mats, dtype=dtype))
        plain_ms = median_ms(torch, lambda: tpfb.pfb_dft1_plain(v, h, *mats, dtype=dtype),
                             runs=5)
        nbytes, ops = pfb_cost(NCHAN, ntime, CHUNK_FRAMES, f1, dtype)
        bms, by = bound_ms(nbytes, ops)
        rec = dict(name="pfb_dft1", dtype=dtype, route="cuda",
                   source="blit_torch/csrc/pfb_dft1.cu",
                   replaces="blit/ops/pallas_pfb.py:175",
                   max_abs_err=err, atol=atol, ok=ok and agg.get("rel_rms_ok", True),
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=None, **agg)
        log(f"kernel {json.dumps(rec)}")
        records.append(rec)
        spectra[dtype] = got
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
                agg = bf16_aggregate(torch, [got], [want], [control])
                del control
            del got, want
            ms = median_ms(torch, lambda: tdet.tail2_detect(ur, ui, f2, f3, stokes=stokes))
            plain_ms = median_ms(
                torch, lambda: tdet.tail2_detect_plain(ur, ui, f2, f3, stokes=stokes),
                runs=5)
            nbytes, ops = tail_cost(NCHAN, CHUNK_FRAMES, f2, f3, stokes, dtype, nif)
            bms, by = bound_ms(nbytes, ops)
            rec = dict(name="tail2_detect", dtype=dtype, stokes=stokes,
                       route="cuda", source="blit_torch/csrc/tail2_detect.cu",
                       replaces="blit/ops/pallas_detect.py:281",
                       max_abs_err=err, atol=atol,
                       ok=ok and agg.get("rel_rms_ok", True), ms=ms,
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=None, **agg)
            log(f"kernel {json.dumps(rec)}")
            records.append(rec)
    del spectra, v
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    return records


def phase_main_path(torch, dev, tmp):
    """(d): the 0000 reduction of a synthetic recording through the
    kernels.  Returns (launch counts, summary)."""
    import numpy as np

    from blit_torch.io.guppi import GuppiRaw
    from blit_torch.io.sigproc import encode_header, read_fil
    from blit_torch.ops import channelize as tch
    from blit_torch.ops import detect as tdet
    from blit_torch.ops import dft as tdft
    from blit_torch.ops import pfb as tpfb
    from blit_torch.pipeline import reducer_for_product
    from blit_torch.testing import synth_raw_blocks

    raw_path = os.path.join(tmp, "smoke.raw")
    fil_path = os.path.join(tmp, "smoke.fil")
    t0 = time.perf_counter()
    synth_raw_blocks(raw_path, nblocks=RAW_SAMPLES // BLOCK_NTIME, obsnchan=NCHAN,
                     ntime_per_block=BLOCK_NTIME, seed=SEED,
                     tone_chan=TONE_CHAN, tone_freq=TONE_FREQ)
    log(f"main: wrote {os.path.getsize(raw_path) / 1e9:.3f} GB RAW in "
        f"{time.perf_counter() - t0:.1f} s")

    red = reducer_for_product("0000", chunk_frames=CHUNK_FRAMES)
    tpfb.pfb_dft1.launches = 0
    tdet.tail2_detect.launches = 0
    t0 = time.perf_counter()
    hdr = red.reduce_to_file(raw_path, fil_path)
    wall = time.perf_counter() - t0
    launches = {"pfb_dft1": tpfb.pfb_dft1.launches,
                "tail2_detect": tdet.tail2_detect.launches}
    plan = tch.last_kernel_plan()
    log(f"main: plan {json.dumps(plan)} launches {json.dumps(launches)}")
    if (plan.get("pfb_kernel"), plan.get("tail_kernel"), plan.get("impl")) != (
            "fused1", "tail2_detect", "cuda"):
        raise AssertionError(f"main path did not run the Hopper kernels: {plan}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    raw = GuppiRaw(raw_path)
    want_hdr = tch.output_header(raw.header(0), nfft=NFFT, nint=1, stokes="I")
    fhdr, data = read_fil(fil_path)
    with open(fil_path, "rb") as f:
        head = f.read(len(encode_header(want_hdr, 32, 1, NCHAN * NFFT)))
    if head != encode_header(want_hdr, 32, 1, NCHAN * NFFT):
        raise AssertionError("product header differs from output_header")
    nframes = RAW_SAMPLES // NFFT - NTAP + 1
    if data.shape != (nframes, 1, NCHAN * NFFT) or hdr["nsamps"] != nframes:
        raise AssertionError(f"product shape {data.shape}, nsamps {hdr['nsamps']}")
    if not np.isfinite(data).all():
        raise AssertionError("non-finite product values")
    chan_bw = want_hdr["foff"] * NFFT
    f_tone = (float(raw.header(0)["OBSFREQ"]) - float(raw.header(0)["OBSBW"]) / 2
              + chan_bw / 2 + TONE_CHAN * chan_bw + TONE_FREQ * chan_bw)
    predicted = int(round((f_tone - fhdr["fch1"]) / fhdr["foff"]))
    peak = int(data[0, 0].argmax())
    log(f"main: tone peak at fine channel {peak}, header predicts {predicted}")
    if peak != predicted:
        raise AssertionError("tone peak is not where the header puts it")

    # Both chunks against the plain twins on the same voltages; the
    # second starts chunk_frames·nfft samples in, after the PFB state
    # carried across.  The tone's coarse channel peaks ~3000× above the
    # noise, so the atol scale (blit's f32 bound, 1e-2·peak) is the peak
    # outside it.
    sign = torch.where(torch.arange(NFFT, device=dev) % 2 == 0, 1.0, -1.0)
    h = (red.coeffs * sign).contiguous()
    f1, f2, f3 = tdft.default_factors(NFFT)
    mats = tdft.as_tensors(tdft.dft_matrices(f1) + tdft.twiddles(f1, NFFT // f1), dev)
    host = np.empty((NCHAN, (CHUNK_FRAMES + NTAP - 1) * NFFT, 2, 2), np.int8)
    per = BLOCK_NTIME
    noise = torch.ones(NCHAN * NFFT, dtype=torch.bool, device=dev)
    noise[TONE_CHAN * NFFT:(TONE_CHAN + 1) * NFFT] = False
    for k in range(nframes // CHUNK_FRAMES):
        b0 = k * CHUNK_FRAMES * NFFT // per
        for j in range(host.shape[1] // per):
            raw.read_block_into(b0 + j, host[:, j * per:(j + 1) * per])
        v = torch.from_numpy(host).to(dev)
        ur, ui = tpfb.pfb_dft1_plain(v, h, *mats)
        ref = tdet.tail2_detect_plain(ur, ui, f2, f3, stokes="I")
        del ur, ui, v
        ref = ref.reshape(CHUNK_FRAMES, 1, NCHAN * NFFT)
        got = torch.from_numpy(np.array(
            data[k * CHUNK_FRAMES:(k + 1) * CHUNK_FRAMES])).to(dev)
        atol = 1e-2 * ref[..., noise].abs().max().item()
        err, ok = check_close(torch, got, ref, 1e-4, atol)
        log(f"main: chunk {k + 1} vs plain twins max_abs_err {err:.6g} "
            f"(rtol 1e-4, atol {atol:.6g})")
        if not ok:
            raise AssertionError(f"chunk {k + 1} disagrees with the plain twins")
        del ref, got
    raw.close()

    st = red.stats
    stages = {k: {"s": round(s.seconds, 4), "GB": round(s.bytes / 1e9, 4)}
              for k, s in red.timeline.stages.items()}
    gbps = st.gbps
    summary = dict(raw_gb=st.input_bytes / 1e9, wall_s=st.wall_seconds,
                   reduce_to_file_s=wall, raw_gbps=gbps,
                   realtime_factor=gbps / REALTIME_BANK_GBPS, stages=stages)
    log(f"main: {json.dumps(summary)}")
    return launches, summary


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

    # (c) kernels vs twins
    records = phase_kernels(torch, dev)

    # (d) main path
    tmp = tempfile.mkdtemp(prefix="blit-smoke-")
    try:
        launches, summary = phase_main_path(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_variants = [r for r in records if r["dtype"] == "float32"
                     and r.get("stokes", "I") == "I"]
    line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[r["name"]], "max_abs_err": r["max_abs_err"],
           "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in main_variants
    ]}
    print(json.dumps(line))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
