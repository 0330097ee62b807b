// xengine.cu — the FX correlator's X-engine, packed visibility layout.
//
// Replaces the TPU kernel blit/ops/pallas_xengine.py:xengine_packed (body
// _kernel) with its contract:
//   in : spectra (sr, si), each (nant, nchan, npol, nframes, nfft), f32 or
//        bf16, the fine-channel axis contiguous (the other strides are
//        passed, so a slice of frames needs no copy);
//   out: f32 (vr, vi), each (nchan, nfft, nap, nap), nap = nant*npol,
//        V[c,f,ap,bq] = sum_t S[a,c,p,t,f] * conj(S[b,c,q,t,f]),
//        ap = a*npol + p (antenna-major): vr = sum rr + ii, vi = sum ir - ri.
// bf16 spectra are widened to f32 as they are staged (exact), so every
// product is exact in f32 and the sums are f32, as the TPU kernel's dots
// with preferred_element_type=f32.
//
// What bounds it on an H100: V is Hermitian, so the function needs the
// products of one half, 4 * nap * (nap + 1) flops per (frame, channel,
// fine channel), on the f32 CUDA cores (no TF32, no tensor cores in this
// first version): at the array scale (64 antennas, 2 pols, 16 channels,
// nfft 512, 61 frames) 33.0 GFLOP, 0.49 ms at 67 TFLOP/s, against 0.47 ms
// for its bytes (0.51 GB of spectra in, 1.07 GB of visibilities out).
// This kernel computes every (ap, bq), 8 * nap^2 flops: twice that work.
// Design:
//   - the kernel reads the unpacked spectra itself, in place of blit's XLA
//     transpose.  At a fixed (a, c, p, t) consecutive fine channels are
//     contiguous, so a block takes 32 of them: each warp's 32 lanes are 32
//     fine channels, every global load is one 128-byte run, and in shared
//     memory lane f reads column f of each staged row: no bank conflicts;
//   - a block owns one coarse channel, 32 fine channels and a 32 x 16 tile
//     of (ap, bq); its 16 warps each hold a 4 x 8 sub-tile of complex sums
//     in registers per lane (128 FMAs per frame against 24 shared loads);
//     frames are staged 4 at a time (48 KB), the next 4 loaded into
//     registers while the block computes on these (one block fills an SM,
//     so nothing else hides the loads' latency); element offsets are
//     64-bit, so the spectra may be of any size the card holds;
//   - blocks that share a (channel, fine-channel run) are adjacent in the
//     grid, so the tiles re-read their rows from L2, not from memory;
//   - the sums leave through shared memory, 8 fine channels a pass, so each
//     (f, ap) row of 16 outputs is written as one 64-byte run;
//   - every output is summed over frames in time order in one thread: no
//     atomics, no split over frames, so a windowed stream that adds the
//     same tiles equals the one-shot call bitwise.
// Skipping the tiles below the diagonal (the conjugates of those above
// it), tensor cores, TMA and a deeper pipeline are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FT = 32;                        // fine channels per block (lanes)
constexpr int TM = 32;                        // ap rows per block
constexpr int TN = 16;                        // bq columns per block
constexpr int RM = 4;                         // rows per lane
constexpr int RN = 8;                         // columns per lane
constexpr int KT = 4;                         // frames staged per step
constexpr int NWARPS = (TM / RM) * (TN / RN); // 16
constexpr int NTHREADS = NWARPS * 32;         // 512
constexpr int RSTEP = NWARPS / KT;            // rows apart a thread stages
constexpr int NLOAD = (TM + TN) / RSTEP;      // rows a thread stages (12)
static_assert(TM % RSTEP == 0 && (TM + TN) % RSTEP == 0, "staging rows");
// Write-back: FW fine channels a pass through shared memory, rows padded
// so the 8 lanes that store at once hit 8 banks.
constexpr int FW = 8;
constexpr int ROW = TN + 1;
constexpr int FSTRIDE = TM * ROW + 1;
constexpr int SMEM = KT * (TM + TN) * FT * 2;
static_assert(2 * FW * FSTRIDE <= SMEM, "write-back buffer");

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  // bf16 is the top half of an f32: widen by a shift (exact).
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
xengine_kernel(const T* __restrict__ sr, const T* __restrict__ si,
               float* __restrict__ vr, float* __restrict__ vi, int nchan,
               int npol, int nframes, int nfft, int nap, long long s_ant,
               long long s_chan, long long s_pol, long long s_frame) {
  __shared__ float smem[SMEM];
  auto ar_s = reinterpret_cast<float(*)[TM][FT]>(smem);
  auto ai_s = reinterpret_cast<float(*)[TM][FT]>(smem + KT * TM * FT);
  auto br_s = reinterpret_cast<float(*)[TN][FT]>(smem + 2 * KT * TM * FT);
  auto bi_s = reinterpret_cast<float(*)[TN][FT]>(smem + 2 * KT * TM * FT + KT * TN * FT);

  const int ntn = (nap + TN - 1) / TN;
  const int i0 = (blockIdx.x / ntn) * TM;
  const int j0 = (blockIdx.x % ntn) * TN;
  const int f0 = blockIdx.y * FT;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (warp % (TM / RM)) * RM;  // the lane's rows in the tile
  const int q0 = (warp / (TM / RM)) * RN;  // and columns

  float accr[RM][RN], acci[RM][RN];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      accr[m][n] = 0.f;
      acci[m][n] = 0.f;
    }
  }

  const int f = f0 + lane;
  const bool fin = f < nfft;
  // Staging: each thread loads, for frame lt of every step and fine
  // channel f, rows lrow + RSTEP*k (k < NLOAD) of the A rows then the B
  // rows.  Their offsets at frame 0 are fixed (-1: past nap or nfft), and
  // the next step's loads are issued before this step's products, so they
  // are in flight while the block computes.
  const int lt = warp % KT;
  const int lrow = warp / KT;
  long long roff[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int row = lrow + RSTEP * k;
    const int g = row < TM ? i0 + row : j0 + row - TM;  // ap or bq
    roff[k] = (g < nap && fin)
                  ? (g / npol) * s_ant + c * s_chan + (g % npol) * s_pol + f
                  : -1;
  }
  float nr[NLOAD], ni[NLOAD];
  auto load = [&](int t0) {
    const bool tin = t0 + lt < nframes;
    const long long fo = (long long)(t0 + lt) * s_frame;
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const bool ok = tin && roff[k] >= 0;
      nr[k] = ok ? ld(sr + roff[k] + fo) : 0.f;
      ni[k] = ok ? ld(si + roff[k] + fo) : 0.f;
    }
  };
  load(0);
  for (int t0 = 0; t0 < nframes; t0 += KT) {
    __syncthreads();  // the previous frames are consumed
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const int row = lrow + RSTEP * k;
      if (k < TM / RSTEP) {
        ar_s[lt][row][lane] = nr[k];
        ai_s[lt][row][lane] = ni[k];
      } else {
        br_s[lt][row - TM][lane] = nr[k];
        bi_s[lt][row - TM][lane] = ni[k];
      }
    }
    __syncthreads();
    if (t0 + KT < nframes) load(t0 + KT);
    // Frames past nframes were staged as zeros: their products add +0.
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      float xr[RM], xi[RM];
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        xr[m] = ar_s[t][r0 + m][lane];
        xi[m] = ai_s[t][r0 + m][lane];
      }
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const float yr = br_s[t][q0 + n][lane];
        const float yi = bi_s[t][q0 + n][lane];
#pragma unroll
        for (int m = 0; m < RM; ++m) {
          accr[m][n] = fmaf(xr[m], yr, accr[m][n]);
          accr[m][n] = fmaf(xi[m], yi, accr[m][n]);
          acci[m][n] = fmaf(xi[m], yr, acci[m][n]);
          acci[m][n] = fmaf(-xr[m], yi, acci[m][n]);
        }
      }
    }
  }

  // Write-back: pass q stores fine channels f0 + FW*q ... through shared
  // memory, so each (f, ap) row of TN outputs leaves as one contiguous run
  // (direct stores from the lanes would be 4-byte writes 64 KB apart).
  float* ob = smem;  // [plane][FW][TM][ROW], FSTRIDE per fine channel
  for (int q = 0; q < FT / FW; ++q) {
    __syncthreads();  // the staging buffers, or the last pass, are consumed
    if (lane / FW == q) {
      float* o = ob + (lane % FW) * FSTRIDE;
#pragma unroll
      for (int m = 0; m < RM; ++m) {
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          o[(r0 + m) * ROW + q0 + n] = accr[m][n];
          o[FW * FSTRIDE + (r0 + m) * ROW + q0 + n] = acci[m][n];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < 2 * FW * TM * TN; e += NTHREADS) {
      const int bq = e % TN, ap = (e / TN) % TM, fl = (e / (TN * TM)) % FW;
      const int plane = e / (TN * TM * FW);
      const int fo = f0 + FW * q + fl;
      if (fo < nfft && i0 + ap < nap && j0 + bq < nap) {
        const size_t g = (((size_t)c * nfft + fo) * nap + i0 + ap) * nap + j0 + bq;
        (plane ? vi : vr)[g] = ob[plane * FW * FSTRIDE + fl * FSTRIDE + ap * ROW + bq];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* sr, const void* si, float* vr, float* vi,
                   int nant, int nchan, int npol, int nframes, int nfft,
                   long long s_ant, long long s_chan, long long s_pol,
                   long long s_frame, cudaStream_t stream) {
  const long long nap = (long long)nant * npol;
  const long long nx = ((nap + TM - 1) / TM) * ((nap + TN - 1) / TN);
  const long long ny = ((long long)nfft + FT - 1) / FT;
  if (nx > 0x7fffffffLL || ny > 65535 || nchan > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  dim3 grid((unsigned)nx, (unsigned)ny, (unsigned)nchan);
  xengine_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(sr), static_cast<const T*>(si), vr, vi, nchan,
      npol, nframes, nfft, (int)nap, s_ant, s_chan, s_pol, s_frame);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int xengine_launch(const void* sr, const void* si, void* vr, void* vi,
                   int nant, int nchan, int npol, int nframes, int nfft,
                   long long s_ant, long long s_chan, long long s_pol,
                   long long s_frame, int bf16, void* stream) {
  if (nant < 1 || nchan < 1 || npol < 1 || nframes < 1 || nfft < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o_r = static_cast<float*>(vr);
  float* o_i = static_cast<float*>(vi);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(sr, si, o_r, o_i, nant, nchan, npol, nframes,
                                   nfft, s_ant, s_chan, s_pol, s_frame, s)
           : launch<float>(sr, si, o_r, o_i, nant, nchan, npol, nframes, nfft,
                           s_ant, s_chan, s_pol, s_frame, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
