// pfb_dequant.cu — fused int8 dequant + polyphase FIR.
//
// Replaces the TPU kernel blit/ops/pallas_pfb.py:pfb_dequant (body _kernel)
// with the same contract:
//   in : int8 voltages (nchan, ntime, 2 pol, 2 re/im), ntime = nblk*nfft,
//        each sample read as one 32-bit word (p0r, p0i, p1r, p1i);
//        f32 sign-folded window w (ntap, nfft);
//   out: (fr, fi), each (nchan, 2, nframes, nfft), f32 or bf16, with
//        fr[c,p,f,j] = sum_k w[k,j] * re v[c, (f+k)*nfft + j, p]  (fi: im),
//        nframes = nblk - ntap + 1.  The taps accumulate in f32 and the sum
//        is rounded once to the output type.
//
// What bounds it on an H100: 2*ntap flops per output value against 4 bytes
// read per sample and 16 (f32) or 8 (bf16) bytes written per sample, so it
// is bound by memory: at the 0002 chunk shape 2.7 GB moved, 0.8 ms.  The
// design therefore reads each sample about once and writes each output
// once, coalesced, whatever nfft is:
//   - a thread owns one fine channel j of one coarse channel and a segment
//     of consecutive frames; it walks the segment's blocks in order and
//     keeps the last ntap samples of column j in registers (the FIR window
//     slides by one block per frame), so a sample is read once per segment
//     plus an ntap-1 block halo;
//   - the segment length is picked so that the grid holds ~2^19 threads at
//     any nfft: at nfft = 8 (the 0001 product) one thread per fine channel
//     would give 512 threads for a whole chunk;
//   - lanes of a warp take consecutive j (then consecutive segments), so at
//     nfft = 8 each group of 8 lanes reads and writes whole 32-byte sectors;
//   - each thread issues the loads of U frames before it uses them, to keep
//     several loads in flight per thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int U = 4;                      // frames loaded ahead
constexpr long long TARGET_THREADS = 1 << 19;
constexpr int MIN_SEG = 16;

__device__ __forceinline__ float sbyte(uint32_t w, int q) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * q)) & 0xFFu));
}

template <bool BF16>
__device__ __forceinline__ void put(void* base, size_t off, float x) {
  if (BF16) {
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(base)[off] = x;
  }
}

// Stores frame f's four tap sums (pol 0 re/im, pol 1 re/im).
template <bool BF16>
__device__ __forceinline__ void store_frame(void* out_r, void* out_i,
                                            size_t o, size_t plane,
                                            const float a[4]) {
  put<BF16>(out_r, o, a[0]);
  put<BF16>(out_i, o, a[1]);
  put<BF16>(out_r, o + plane, a[2]);
  put<BF16>(out_i, o + plane, a[3]);
}

// NTAP > 0 (ntap <= 8): the last NTAP samples of the column stay in
// registers.  NTAP == 0: any ntap; each frame reads its ntap samples through L1.
template <int NTAP, bool BF16>
__global__ void __launch_bounds__(NTHREADS)
pfb_dequant_kernel(const uint32_t* __restrict__ v, const float* __restrict__ w,
                   void* __restrict__ out_r, void* __restrict__ out_i,
                   int nchan, int nfft, int nblk, int nframes, int ntap,
                   int seg) {
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const int nseg = (nframes + seg - 1) / seg;
  if (t >= (long long)nchan * nseg * nfft) return;
  const int j = (int)(t % nfft);
  const long long rest = t / nfft;
  const int s = (int)(rest % nseg);
  const int c = (int)(rest / nseg);
  const int f0 = s * seg;
  const int f1 = min(f0 + seg, nframes);
  const uint32_t* vc = v + (size_t)c * nblk * nfft + j;
  const size_t plane = (size_t)nframes * nfft;  // one (channel, pol) plane
  size_t o = (size_t)c * 2 * plane + (size_t)f0 * nfft + j;

  if (NTAP == 0) {
    for (int f = f0; f < f1; ++f, o += nfft) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < ntap; ++k) {
        const uint32_t x = __ldg(vc + (size_t)(f + k) * nfft);
        const float wk = __ldg(w + (size_t)k * nfft + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = k == 0 ? wk * sbyte(x, q) : fmaf(wk, sbyte(x, q), a[q]);
        }
      }
      store_frame<BF16>(out_r, out_i, o, plane, a);
    }
    return;
  }

  constexpr int NT = NTAP > 0 ? NTAP : 1;
  float wk[NT];
  uint32_t win[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) wk[k] = __ldg(w + (size_t)k * nfft + j);
  // win[1..NT-1] <- blocks f0 .. f0+NT-2; each frame shifts in one block.
#pragma unroll
  for (int k = 0; k + 1 < NT; ++k) win[k + 1] = __ldg(vc + (size_t)(f0 + k) * nfft);

  for (int f = f0; f < f1; f += U) {
    uint32_t nx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      nx[u] = f + u < f1 ? __ldg(vc + (size_t)(f + u + NT - 1) * nfft) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (f + u < f1) {
#pragma unroll
        for (int k = 0; k + 1 < NT; ++k) win[k] = win[k + 1];
        win[NT - 1] = nx[u];
        float a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = wk[0] * sbyte(win[0], q);
#pragma unroll
        for (int k = 1; k < NT; ++k) {
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q] = fmaf(wk[k], sbyte(win[k], q), a[q]);
        }
        store_frame<BF16>(out_r, out_i, o, plane, a);
        o += nfft;
      }
    }
  }
}

// Frames per thread: enough segments to fill the card with ~TARGET_THREADS
// threads, at least MIN_SEG frames each so the ntap-1 halo stays small.
int segment_frames(int nchan, int nfft, int nframes) {
  const long long work = (long long)nchan * nfft * nframes;
  long long seg = (work + TARGET_THREADS - 1) / TARGET_THREADS;
  if (seg < MIN_SEG) seg = MIN_SEG;
  if (seg > nframes) seg = nframes;
  return (int)seg;
}

template <int NTAP, bool BF16>
cudaError_t launch(const void* v, const void* w, void* out_r, void* out_i,
                   int nchan, int nfft, int nblk, int nframes, int ntap,
                   cudaStream_t stream) {
  const int seg = segment_frames(nchan, nfft, nframes);
  const long long nseg = (nframes + seg - 1) / seg;
  const long long threads = (long long)nchan * nseg * nfft;
  const long long blocks = (threads + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  pfb_dequant_kernel<NTAP, BF16><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const uint32_t*>(v), static_cast<const float*>(w), out_r,
      out_i, nchan, nfft, nblk, nframes, ntap, seg);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const void* v, const void* w, void* out_r, void* out_i,
                     int nchan, int nfft, int nblk, int nframes, int ntap,
                     cudaStream_t s) {
#define BLIT_PFB_TAPS(N) \
  case N:                \
    return launch<N, BF16>(v, w, out_r, out_i, nchan, nfft, nblk, nframes, ntap, s);
  switch (ntap) {
    BLIT_PFB_TAPS(1)
    BLIT_PFB_TAPS(2)
    BLIT_PFB_TAPS(3)
    BLIT_PFB_TAPS(4)
    BLIT_PFB_TAPS(5)
    BLIT_PFB_TAPS(6)
    BLIT_PFB_TAPS(7)
    BLIT_PFB_TAPS(8)
    default:
      return launch<0, BF16>(v, w, out_r, out_i, nchan, nfft, nblk, nframes, ntap, s);
  }
#undef BLIT_PFB_TAPS
}

}  // namespace

extern "C" {

int pfb_dequant_launch(const void* v, const void* w, void* out_r, void* out_i,
                       int nchan, int nfft, int nblk, int nframes, int ntap,
                       int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<true>(v, w, out_r, out_i, nchan, nfft, nblk, nframes, ntap, s)
           : dispatch<false>(v, w, out_r, out_i, nchan, nfft, nblk, nframes, ntap, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
