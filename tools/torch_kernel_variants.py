#!/usr/bin/env python3
"""Time variants of the port's kernels on one CUDA GPU: each variant is a
copy of ``blit_torch/csrc`` with text substitutions (or a whole file
replaced), built with the package's own nvcc flags.  Two groups:

- ``0000`` (the default): pfb_dft1 and tail2_detect, optionally with
  another tile for pfb_dft1; each checked against the plain twins on 4
  channels and timed (CUDA-event median of 7 runs) at the 0000 chunk: 64
  coarse channels, nfft 2^20, 4 frames, f32, Stokes I and IQUV.
- ``tree_beam`` (and any group named ``tree_beam...``): taylor_tree
  (both signs, held bitwise to its plain
  version where that fits in memory) at the smoke's windows (64, 65536),
  (8, 2^26), (16, 2^26) and (1024, 65536), and fused_beamform_detect at the
  array scale (64 channels, 64 antennas, 64 beams, 2 pols, 8192 samples,
  nint 8) in f32 on integer voltages (as RAW holds them), f32 on
  non-integer voltages and bf16, held to its plain version; each timed as
  one call (CUDA-event median of 7, as chip_smoke.py times it) and per
  call over back-to-back calls (the host's cost of a call overlapping the
  card's work).  The variants build in parallel.

    python3 tools/torch_kernel_variants.py tools/torch_kernel_variants.json [0000|tree_beam]

The JSON file maps each group to ``[name, {source: [[old, new], ...] |
path}, tile]`` entries (``tile``: ``{"fg": .., "tc": .., "nstage": ..}``
or null; pfb_dft1 only).  A variant that skips work (no FFT, no store, no
MMA) measures what the rest costs; its error is printed, not checked.
Prints the card's name and power limit, each build's register and
shared-memory report, and one JSON line a variant.  Builds go under
``build/kernel_variants/`` (git-ignored).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blit_torch import kernels  # noqa: E402
from blit_torch.ops import channelize as tch  # noqa: E402
from blit_torch.ops import detect as tdet  # noqa: E402
from blit_torch.ops import dft as tdft  # noqa: E402
from blit_torch.ops import pfb as tpfb  # noqa: E402

NFFT = 1 << 20
NCHAN = 64
FRAMES = 4
NTAP = 4
CSRC = kernels.CSRC
ROOT = os.path.join(os.path.dirname(CSRC), "..", "build", "kernel_variants")


def median_ms(fn, runs=7):
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
    return sorted(times)[len(times) // 2]


def rel_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               / w.float().abs().max().item() for g, w in zip(got, want))


def make_variant(name, subs):
    """A copy of csrc with ``subs`` applied → its directory."""
    d = os.path.abspath(os.path.join(ROOT, name, "csrc"))
    shutil.rmtree(os.path.dirname(d), ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, change in subs.items():
        path = os.path.join(d, fname)
        if isinstance(change, str):
            shutil.copy(change, path)
            continue
        text = open(path).read()
        for old, new in change:
            if old not in text:
                raise ValueError(f"{name}: {fname} has no {old[:60]!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
    return d


def main(path, group="0000") -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    entries = json.load(open(path))[group]
    if group.startswith("tree_beam"):
        return tree_beam(entries, dev)
    return pair_0000(entries, dev)


def use_variant(name, subs=None):
    """Point the kernel loader at variant ``name`` (made when ``subs`` is
    given)."""
    kernels.CSRC = make_variant(name, subs) if subs is not None else os.path.abspath(
        os.path.join(ROOT, name, "csrc"))
    kernels.BUILD_DIR = os.path.join(os.path.dirname(kernels.CSRC), "build")
    kernels._LIBS.clear()


def build_variants(entries, sources):
    """Make every variant and build its ``sources``, all nvcc at once."""
    jobs = []
    for name, subs, _ in entries:
        use_variant(name, subs)
        jobs += [(name, src, kernels._start_build(src)) for src in sources]
    for name, src, job in jobs:
        if job is None:
            continue
        proc, tmp, final = job
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed for {src}.cu:\n{out}")
        os.replace(tmp, final)
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {src}: {line.strip()}", flush=True)


def per_call_ms(fn, k):
    """Per-call time of ``k`` back-to-back calls (median of 7 runs)."""
    return median_ms(lambda: [fn() for _ in range(k)]) / k


def tree_beam(entries, dev) -> int:
    from blit_torch.ops import beamform as tbf
    from blit_torch.ops import dedoppler as tpd

    build_variants(entries, ["taylor_tree", "beamform_detect"])
    g = torch.Generator(device=dev).manual_seed(7)
    shapes = [(64, 1 << 16), (8, 1 << 26), (16, 1 << 26), (1024, 1 << 16)]
    xs = {s: torch.empty(s, device=dev).normal_(50.0, 5.0, generator=g) for s in shapes}
    want = {s: tpd.drift_spectra_plain(x) for s, x in xs.items() if s[0] * s[1] <= 1 << 22}
    shape = (64, 64, 2, 8192)
    v = [torch.randint(-40, 41, shape, generator=g, device=dev).float() for _ in range(2)]
    vf = [torch.randn(shape, generator=g, device=dev) * 20 for _ in range(2)]
    w = [torch.randn((64, 64, 64), generator=g, device=dev) for _ in range(2)]
    cases = {"f32": v + w, "f32 non-integer": vf + w,
             "bf16": [t.to(torch.bfloat16) for t in v + w]}
    wantb = {k: tbf.fused_beamform_detect_plain(*a, nint=8) for k, a in cases.items()}
    for name, _, _ in entries:
        use_variant(name)
        rec = {"variant": name}
        for s, x in xs.items():
            key = f"tree {s[0]}x{s[1]}"
            got = tpd.drift_spectra(x)
            if s in want:
                rec[key + " bitwise"] = bool(torch.equal(got, want[s]))
            del got
            rec[key + " ms"] = median_ms(lambda: tpd.drift_spectra(x))
            rec[key + " back_to_back_ms"] = per_call_ms(
                lambda: tpd.drift_spectra(x), 20 if s[0] * s[1] <= 1 << 22 else 3)
            torch.cuda.empty_cache()
        for key, args in cases.items():
            got = tbf.fused_beamform_detect(*args, nint=8)
            rec[f"beamform {key} rel_err"] = rel_err([got], [wantb[key]])
            del got
            fn = lambda: tbf.fused_beamform_detect(*args, nint=8)  # noqa: E731
            rec[f"beamform {key} ms"] = median_ms(fn)
            rec[f"beamform {key} back_to_back_ms"] = per_call_ms(fn, 10)
        torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
    return 0


def pair_0000(entries, dev) -> int:
    g = torch.Generator(device=dev).manual_seed(5)
    v = torch.randint(-128, 128, (NCHAN, (FRAMES + NTAP - 1) * NFFT, 2, 2),
                      generator=g, device=dev, dtype=torch.int8)
    sign = torch.where(torch.arange(NFFT, device=dev) % 2 == 0, 1.0, -1.0)
    h = (torch.from_numpy(tch.pfb_coeffs(NTAP, NFFT)).to(dev) * sign).contiguous()
    mats = tdft.as_tensors(tdft.dft_matrices(128) + tdft.twiddles(128, NFFT // 128), dev)
    ref_v = v[:4]
    spectra = tpfb.pfb_dft1_plain(ref_v, h, *mats)
    want_td = {st: tdet.tail2_detect_plain(*spectra, 128, 64, stokes=st)
               for st in ("I", "IQUV")}
    geometry = tpfb.kernel_geometry
    for name, subs, tile in entries:
        kernels.CSRC = make_variant(name, subs)
        kernels.BUILD_DIR = os.path.join(os.path.dirname(kernels.CSRC), "build")
        kernels._LIBS.clear()
        # A variant may lay out shared memory otherwise: take its own size.
        tdet.kernel_smem_bytes = lambda: kernels.load(
            "tail2_detect").tail2_detect_smem_bytes()
        if tile:
            def tiled(n1, ntap=4, tile=tile):
                geo = dict(geometry(n1, ntap))
                geo.update(tile)
                geo["per_round"] = min(geo["fg"] * 2 * geo["tc"],
                                       tpfb.KERNEL_ROUND // n1)
                geo["smem"] = tpfb._smem(n1, geo["tc"], geo["fg"], ntap,
                                         geo["nstage"])
                return geo
            tpfb.kernel_geometry = tiled
        else:
            tpfb.kernel_geometry = geometry
        for src, log in kernels.build_all(["pfb_dft1", "tail2_detect"]).items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"{name}: {src}: {line.strip()}", flush=True)
        rec = {"variant": name, "tile": tile or "default"}
        rec["pfb_dft1_rel_err"] = rel_err(tpfb.pfb_dft1(ref_v, h, *mats), spectra)
        rec["pfb_dft1_ms"] = median_ms(lambda: tpfb.pfb_dft1(v, h, *mats))
        full = tpfb.pfb_dft1(v, h, *mats)
        for st in ("I", "IQUV"):
            got = tdet.tail2_detect(*spectra, 128, 64, stokes=st)
            rec[f"tail2_detect_{st}_rel_err"] = rel_err([got], [want_td[st]])
            rec[f"tail2_detect_{st}_ms"] = median_ms(
                lambda: tdet.tail2_detect(*full, 128, 64, stokes=st))
        del full, got
        torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
