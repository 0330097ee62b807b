"""Streaming GUPPI RAW → filterbank reduction driver.

Counterpart of ``blit/pipeline.py``'s :class:`RawReducer`, synchronous
path.  The reducer reads voltage blocks into a host staging buffer,
carries the PFB state across chunk boundaries, feeds fixed-shape chunks
to :func:`blit_torch.ops.channelize.channelize` on the device, and
writes SIGPROC ``.fil`` products.  Every rawspec preset runs on the card:
``0000`` through ``pfb_dft1`` + ``tail2_detect``, ``0001`` and ``0002``
through ``pfb_dequant`` + ``dft_last`` (the channelizer picks the plan);
a one-pol recording through the FIR in torch ops + the DFT kernels.

- A chunk of ``chunk_frames + ntap - 1`` blocks of ``nfft`` samples
  yields ``chunk_frames`` PFB frames; consecutive chunks share a
  ``(ntap-1)*nfft``-sample overlap, so frames are continuous across
  chunks and the product does not depend on ``chunk_frames``.
- ``chunk_frames`` is a multiple of ``nint``.  The last, short chunk
  keeps the whole frames left, rounded down to ``nint``
  (:func:`usable_frames`); trailing samples that cannot fill an
  integration are dropped, as rawspec does.
- On a CUDA device the staging buffer is pinned host memory, so the
  host→device copy is a direct DMA.

``blit``'s pipelined ingest (``BufferRotation`` prefetch), asynchronous
output plane, tuning profiles, ``.h5`` products, quantized ``nbits``
output, resumable reductions and integrity checks are later slices
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from blit_torch.device import resolve_device
from blit_torch.io.guppi import GuppiRaw, RawSource, open_raw
from blit_torch.io.sigproc import FilWriter
from blit_torch.observability import Timeline
from blit_torch.ops.channelize import (
    STOKES_NIF,
    channelize,
    output_header,
    pfb_coeffs,
    usable_frames,
)
from blit_torch.ops.fqav import fqav_range

# rawspec-equivalent product presets: name → (nfft, nint).
PRODUCT_PRESETS = {
    "0000": (1 << 20, 1),        # hi-res: ~3 Hz channels
    "0001": (1 << 3, 128),       # mid-res time product
    "0002": (1 << 10, 1 << 11),  # low-res survey product
}


@dataclass
class ReductionStats:
    """Aggregate throughput view derived from the reducer's timeline."""

    input_bytes: int = 0
    output_frames: int = 0
    device_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def gbps(self) -> float:
        return self.input_bytes / self.wall_seconds / 1e9 if self.wall_seconds else 0.0


@dataclass
class RawReducer:
    """Configured RAW → filterbank reduction on one device.

    ``device=None`` runs on the CUDA device and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch path.
    """

    nfft: int
    ntap: int = 4
    nint: int = 1
    stokes: str = "I"
    window: str = "hamming"
    # channelize's FFT: "auto" (= "matmul", the DFT kernels), "direct" or
    # "four_step" (torch.fft).
    fft_method: str = "auto"
    # On-device frequency averaging of every fqav_by fine channels.
    fqav_by: int = 1
    # Working dtype of the stage-1 spectra ("float32" | "bfloat16").
    dtype: str = "float32"
    # Output frames per device call; rounded up to a multiple of nint.
    # The default (~8M samples per coarse channel, at most 64 frames,
    # blit's) gives 0002 2048 frames and 0001 only 128.
    chunk_frames: Optional[int] = None
    device: Optional[str] = None
    timeline: Timeline = field(default_factory=Timeline)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.stokes not in STOKES_NIF:
            raise ValueError(f"unknown stokes {self.stokes!r}")
        if self.chunk_frames is None:
            # ~8M samples per coarse channel per device call (blit's
            # budget): few frames for the 1M-point product.
            budget = max(1, (1 << 23) // self.nfft)
            self.chunk_frames = self.nint * max(1, min(64, budget) // self.nint)
        if self.chunk_frames % self.nint:
            self.chunk_frames += self.nint - self.chunk_frames % self.nint
        if self.fqav_by > 1 and self.nfft % self.fqav_by:
            raise ValueError(f"fqav_by={self.fqav_by} does not divide nfft={self.nfft}")
        self._pfb_coeffs: Optional[torch.Tensor] = None
        self._output_frames = 0
        self._staging: Optional[torch.Tensor] = None

    @property
    def coeffs(self) -> torch.Tensor:
        """The PFB coefficient bank on the device, built on first use."""
        if self._pfb_coeffs is None:
            self._pfb_coeffs = torch.from_numpy(
                pfb_coeffs(self.ntap, self.nfft, self.window)).to(self.device)
        return self._pfb_coeffs

    @property
    def stats(self) -> ReductionStats:
        st = self.timeline.stages
        return ReductionStats(
            input_bytes=st["ingest"].bytes,
            output_frames=self._output_frames,
            device_seconds=st["device"].seconds,
            wall_seconds=st["stream"].seconds,
        )

    def header_for(self, raw: GuppiRaw) -> Dict:
        hdr = output_header(raw.header(0), nfft=self.nfft, nint=self.nint,
                            stokes=self.stokes)
        if self.fqav_by > 1:
            fch1, foff, nchans = fqav_range(hdr["fch1"], hdr["foff"],
                                            hdr["nchans"], self.fqav_by)
            hdr.update(fch1=fch1, foff=foff, nchans=nchans,
                       nfpc=self.nfft // self.fqav_by)
        return hdr

    # -- streaming core ----------------------------------------------------
    def _staging_buffer(self, shape) -> torch.Tensor:
        """The host chunk buffer (pinned when the device is CUDA), reused
        across streams of the same shape."""
        if self._staging is None or tuple(self._staging.shape) != shape:
            self._staging = torch.empty(
                shape, dtype=torch.int8,
                pin_memory=self.device.type == "cuda")
        return self._staging

    def _chunks(self, raw: GuppiRaw) -> Iterator[Tuple[torch.Tensor, int]]:
        """Yield ``(host chunk, frames)`` in stream order.  A yielded
        chunk aliases the staging buffer: the consumer finishes with it
        before asking for the next."""
        nfft, ntap = self.nfft, self.ntap
        chunk_samps = (self.chunk_frames + ntap - 1) * nfft
        advance = self.chunk_frames * nfft
        state = (ntap - 1) * nfft
        buf = host = None
        filled = 0
        carried = False  # the buffer starts with the previous chunk's state
        for i in range(raw.nblocks):
            hdr = raw.header(i)
            nt = raw.block_ntime_kept(i)
            t0 = 0
            nchan = hdr["OBSNCHAN"]
            npol = 2 if hdr["NPOL"] > 2 else hdr["NPOL"]
            while nt > 0:
                if buf is None:
                    buf = self._staging_buffer((nchan, chunk_samps, npol, 2))
                    host = buf.numpy()
                take = min(nt, chunk_samps - filled)
                with self.timeline.stage("ingest", nbytes=nchan * take * npol * 2):
                    raw.read_block_into(i, host[:, filled:], t0, take)
                filled += take
                t0 += take
                nt -= take
                if filled == chunk_samps:
                    yield buf, self.chunk_frames
                    with self.timeline.stage("state", nbytes=nchan * state * npol * 2):
                        host[:, :state] = host[:, advance:]
                    filled = state
                    carried = True
        if filled > (state if carried else 0):
            frames = usable_frames(filled, nfft, ntap, self.nint)
            if frames > 0:
                yield buf[:, :(frames + ntap - 1) * nfft], frames

    def _run_chunk(self, chunk: torch.Tensor) -> np.ndarray:
        with self.timeline.stage("device", nbytes=chunk.numel()):
            if not chunk.is_contiguous():
                chunk = chunk.contiguous()  # the short tail chunk
            v = chunk.to(self.device, non_blocking=True)
            out = channelize(
                v, self.coeffs, nfft=self.nfft, ntap=self.ntap,
                nint=self.nint, stokes=self.stokes,
                fft_method=self.fft_method, dtype=self.dtype,
                fqav_by=self.fqav_by, device=self.device,
            )
            return out.cpu().numpy()

    def stream(self, raw_src: RawSource) -> Iterator[np.ndarray]:
        """Yield f32 slabs ``(nspectra, nif, nchans)`` covering the
        recording gap-free, one per chunk."""
        raw = open_raw(raw_src)
        try:
            with self.timeline.stage("stream"):
                for chunk, frames in self._chunks(raw):
                    slab = self._run_chunk(chunk)
                    self._output_frames += frames
                    yield slab
        finally:
            if raw is not raw_src:
                raw.close()

    def _open_validated(self, raw_src: RawSource) -> Tuple[GuppiRaw, Dict]:
        raw = open_raw(raw_src)
        if raw.nblocks == 0:
            raise ValueError(f"empty or fully truncated RAW file: {raw.path}")
        return raw, self.header_for(raw)

    def reduce(self, raw_src: RawSource) -> Tuple[Dict, np.ndarray]:
        """Reduce a whole RAW file in memory → ``(header, data)`` with
        data ``(nsamps, nif, nchans)`` f32."""
        raw, hdr = self._open_validated(raw_src)
        try:
            slabs = list(self.stream(raw))
        finally:
            if raw is not raw_src:
                raw.close()
        if slabs:
            data = np.concatenate(slabs, axis=0)
        else:
            data = np.zeros((0, STOKES_NIF[self.stokes], hdr["nchans"]),
                            np.float32)
        hdr["nsamps"] = data.shape[0]
        return hdr, data

    def reduce_to_file(self, raw_src: RawSource, out_path: str) -> Dict:
        """Reduce and stream a ``.fil`` product to ``out_path`` (through a
        ``.partial`` sibling renamed on success).  Returns the header."""
        if not out_path.endswith(".fil"):
            raise NotImplementedError(
                "blit_torch writes .fil products; .h5 output is a later "
                "slice (ROADMAP.md Queue 1: '.h5 and resume')")
        raw, hdr = self._open_validated(raw_src)
        w = FilWriter(out_path, hdr, STOKES_NIF[self.stokes], hdr["nchans"])
        try:
            for slab in self.stream(raw):
                with self.timeline.stage("write", nbytes=slab.nbytes):
                    w.append(slab)
            w.close()
        except BaseException:
            w.abort()
            raise
        finally:
            if raw is not raw_src:
                raw.close()
        hdr["nsamps"] = w.nsamps
        return hdr


def reducer_for_product(product: str, **kw) -> RawReducer:
    """A :class:`RawReducer` configured like rawspec's standard product
    ``product`` ("0000" | "0001" | "0002")."""
    nfft, nint = PRODUCT_PRESETS[product]
    return RawReducer(nfft=nfft, nint=nint, **kw)
