// beamform_detect.cu — fused tied-array beamform + detect + integrate.
//
// Replaces the TPU kernel blit/ops/pallas_beamform.py:fused_beamform_detect
// (body _kernel) with its contract, packed chan-major layouts:
//   in : voltages (vr, vi), each (nchan, nant, npol, ntime), and
//        weights  (wr, wi), each (nchan, nbeam, nant), all f32 or all bf16;
//   out: f32 (nchan, nbeam, npol, ntime / nint) with
//        out[c,b,p,o] = sum_{t in [o*nint, (o+1)*nint)} |B[c,b,p,t]|^2,
//        B[c,b,p,t]   = sum_a w[c,b,a] * v[c,a,p,t]   (complex).
// bf16 operands are widened to f32 as they are staged (exact), so every
// product is taken from the bf16-rounded values and summed in f32, as the
// TPU kernel's dots with preferred_element_type=f32.
//
// What bounds it on an H100: 8 flops per (beam, antenna, pol, sample) on
// the f32 CUDA cores (no TF32, no tensor cores in this first version), and
// only 8 bytes read per (antenna, pol, sample) in f32; at the array scale
// (64 antennas, 64 beams, 64 channels, 2 pols, 8192 samples) that is
// 34.4 GFLOP, 0.513 ms at 67 TFLOP/s, against 0.171 ms of bytes: the
// kernel is bound by its arithmetic.  Design:
//   - a block owns one channel, one pol, 64 beams and a tile of 128
//     samples; antennas are staged 16 at a time in shared memory (the
//     weights' 16 x 64 slice and the voltages' 16 x 128 slice, 24 KB), so
//     any nant and nbeam work and several blocks fit on an SM; each
//     thread issues all 24 loads of a slice before it stores any;
//   - each of the 256 threads holds 4 beams x 8 consecutive samples of
//     complex sums in registers (64 FMAs per antenna against 6 16-byte
//     shared loads) and turns them into power in registers: the beams
//     never leave the SM, only integrated power is written;
//   - integration: the TPU kernel sums nint samples by a matmul against a
//     0/1 matrix only because Mosaic refuses lane-axis reshapes.  Here a
//     thread sums its 8 samples in registers (nint <= 8), and for nint of
//     16..128 the threads of one group add their partials by a fixed
//     shuffle tree.  Every output is summed in an order that depends only
//     on its own samples, never on where the tile or window starts, and
//     with no atomics: windowed streams equal one-shot calls bitwise;
//   - nint must be a power of two up to 128 dividing ntime (the Python
//     gate `fits`); other shapes take beamform's matmul route.
// Tensor cores (wgmma on bf16 operands), TMA and a deeper pipeline are
// left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;                 // samples of one pol per block
constexpr int TS = 8;                   // consecutive samples per thread
constexpr int NCHUNK = TT / TS;         // threads along time (16)
constexpr int BPT = 4;                  // beams per thread
constexpr int NBG = 16;                 // beam groups per block
constexpr int BB = BPT * NBG;           // beams per block (64)
constexpr int KA = 16;                  // antennas staged per step
constexpr int NTHREADS = NCHUNK * NBG;  // 256
constexpr int MAX_NINT = TT;
constexpr int VSTEP = NTHREADS / TT;    // antennas apart a thread stages
constexpr int NLV = KA / VSTEP;         // voltages a thread stages (8)
constexpr int WSTEP = NTHREADS / BB;
constexpr int NLW = KA / WSTEP;         // weights a thread stages (4)
static_assert(KA % VSTEP == 0 && KA % WSTEP == 0, "staging rows");

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  // bf16 is the top half of an f32: widen by a shift (exact).
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// Two blocks an SM (<= 128 registers a thread): one block's staging
// overlaps the other's products.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
beamform_detect_kernel(const T* __restrict__ vr, const T* __restrict__ vi,
                       const T* __restrict__ wr, const T* __restrict__ wi,
                       float* __restrict__ out, int nant, int nbeam, int npol,
                       int ntime, int nint) {
  __shared__ __align__(16) float swr[KA][BB];
  __shared__ __align__(16) float swi[KA][BB];
  __shared__ __align__(16) float svr[KA][TT];
  __shared__ __align__(16) float svi[KA][TT];

  const int t0 = blockIdx.x * TT;
  const int nbt = (nbeam + BB - 1) / BB;
  const int p = blockIdx.y / nbt;
  const int b0 = (blockIdx.y % nbt) * BB;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int chunk = tid % NCHUNK;
  const int bg = tid / NCHUNK;

  float accr[BPT][TS], acci[BPT][TS];
#pragma unroll
  for (int m = 0; m < BPT; ++m) {
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      accr[m][j] = 0.f;
      acci[m][j] = 0.f;
    }
  }

  const size_t vchan = (size_t)c * nant * npol * ntime;
  const size_t wchan = (size_t)c * nbeam * nant;
  // Staging: a thread loads sample vt of antennas vka + VSTEP*k of the
  // slice, and the weights of beam wb for antennas wka + WSTEP*k; all its
  // loads are issued before any is stored, so they are in flight together.
  const int vt = tid % TT, vka = tid / TT;
  const int wb = tid % BB, wka = tid / BB;
  for (int a0 = 0; a0 < nant; a0 += KA) {
    float lvr[NLV], lvi[NLV], lwr[NLW], lwi[NLW];
#pragma unroll
    for (int k = 0; k < NLV; ++k) {
      const int a = a0 + vka + VSTEP * k;
      const bool ok = a < nant && t0 + vt < ntime;
      const size_t o = vchan + ((size_t)a * npol + p) * ntime + t0 + vt;
      lvr[k] = ok ? ld(vr + o) : 0.f;
      lvi[k] = ok ? ld(vi + o) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < NLW; ++k) {
      const int a = a0 + wka + WSTEP * k;
      const bool ok = a < nant && b0 + wb < nbeam;
      const size_t o = wchan + (size_t)(b0 + wb) * nant + a;
      lwr[k] = ok ? ld(wr + o) : 0.f;
      lwi[k] = ok ? ld(wi + o) : 0.f;
    }
    __syncthreads();  // the previous slices are consumed
#pragma unroll
    for (int k = 0; k < NLV; ++k) {
      svr[vka + VSTEP * k][vt] = lvr[k];
      svi[vka + VSTEP * k][vt] = lvi[k];
    }
#pragma unroll
    for (int k = 0; k < NLW; ++k) {
      swr[wka + WSTEP * k][wb] = lwr[k];
      swi[wka + WSTEP * k][wb] = lwi[k];
    }
    __syncthreads();
    // Antennas past nant were staged as zeros: their products add +0.
#pragma unroll 4
    for (int ka = 0; ka < KA; ++ka) {
      const float4 w4r = *reinterpret_cast<const float4*>(&swr[ka][bg * BPT]);
      const float4 w4i = *reinterpret_cast<const float4*>(&swi[ka][bg * BPT]);
      const float wrm[BPT] = {w4r.x, w4r.y, w4r.z, w4r.w};
      const float wim[BPT] = {w4i.x, w4i.y, w4i.z, w4i.w};
      float xr[TS], xi[TS];
      const float4* pr = reinterpret_cast<const float4*>(&svr[ka][chunk * TS]);
      const float4* pi = reinterpret_cast<const float4*>(&svi[ka][chunk * TS]);
#pragma unroll
      for (int q = 0; q < TS / 4; ++q) {
        const float4 a = pr[q], b = pi[q];
        xr[4 * q] = a.x; xr[4 * q + 1] = a.y; xr[4 * q + 2] = a.z; xr[4 * q + 3] = a.w;
        xi[4 * q] = b.x; xi[4 * q + 1] = b.y; xi[4 * q + 2] = b.z; xi[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int m = 0; m < BPT; ++m) {
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          accr[m][j] = fmaf(wrm[m], xr[j], accr[m][j]);
          accr[m][j] = fmaf(-wim[m], xi[j], accr[m][j]);
          acci[m][j] = fmaf(wrm[m], xi[j], acci[m][j]);
          acci[m][j] = fmaf(wim[m], xr[j], acci[m][j]);
        }
      }
    }
  }

  // Detect and integrate.  Every thread takes part in the shuffles, also
  // those whose beams or samples lie past the edges (their sums are 0).
  const int nout = ntime / nint;
  const int tc = t0 + chunk * TS;
#pragma unroll
  for (int m = 0; m < BPT; ++m) {
    const int b = b0 + bg * BPT + m;
    float pw[TS];
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      pw[j] = accr[m][j] * accr[m][j] + acci[m][j] * acci[m][j];
    }
    float* orow = out + (((size_t)c * nbeam + b) * npol + p) * nout;
    if (nint <= TS) {
      // Groups of nint samples inside the thread's 8, summed in order
      // (indices stay compile-time, so pw stays in registers).
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        s = (j & (nint - 1)) ? s + pw[j] : pw[j];
        if (((j + 1) & (nint - 1)) == 0) {
          const int t = tc + j + 1 - nint;
          if (b < nbeam && t < ntime) orow[t / nint] = s;
        }
      }
    } else {
      float s = pw[0];
#pragma unroll
      for (int j = 1; j < TS; ++j) s += pw[j];
      const int lanes = nint / TS;  // threads of one group: 2..16
      for (int off = 1; off < lanes; off <<= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off, NCHUNK);
      }
      if (chunk % lanes == 0 && b < nbeam && tc < ntime) orow[tc / nint] = s;
    }
  }
}

template <typename T>
cudaError_t launch(const void* vr, const void* vi, const void* wr,
                   const void* wi, float* out, int nchan, int nant, int nbeam,
                   int npol, int ntime, int nint, cudaStream_t stream) {
  const long long nbt = (nbeam + BB - 1) / BB;
  const long long ny = nbt * npol;
  const long long nx = ((long long)ntime + TT - 1) / TT;
  if (ny > 65535 || nchan > 65535 || nx > 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  dim3 grid((unsigned)nx, (unsigned)ny, (unsigned)nchan);
  beamform_detect_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(vr), static_cast<const T*>(vi),
      static_cast<const T*>(wr), static_cast<const T*>(wi), out, nant, nbeam,
      npol, ntime, nint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int beamform_detect_launch(const void* vr, const void* vi, const void* wr,
                           const void* wi, void* out, int nchan, int nant,
                           int nbeam, int npol, int ntime, int nint,
                           int bf16, void* stream) {
  if (nint < 1 || nint > MAX_NINT || (nint & (nint - 1)) || ntime % nint ||
      nchan < 1 || nant < 1 || nbeam < 1 || npol < 1 || ntime < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(vr, vi, wr, wi, o, nchan, nant, nbeam, npol,
                                   ntime, nint, s)
           : launch<float>(vr, vi, wr, wi, o, nchan, nant, nbeam, npol, ntime,
                           nint, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
