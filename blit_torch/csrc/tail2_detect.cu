// tail2_detect.cu — DFT levels 2 and 3 + inner untwist + Stokes detect,
// written straight into the filterbank product layout.
//
// Replaces the TPU kernel blit/ops/pallas_detect.py:tail2_detect (body
// _td_kernel) with the same contract:
//   in : stage-1 spectra (ur, ui), each (nchan, 2 pol, nframes, f1, f2*f3),
//        f32 or bf16, as pfb_dft1 emits them;
//        the f2-point and f3-point DFT matrices as their row 1
//        (W[k,j] == W[1,(k*j) mod n]), the (f2, f3) twiddles — all f32;
//   out: f32 (nframes, nif, nchan, f1*f2*f3) in natural order
//        k = k1 + f1*k2 + f1*f2*k3.
// Within one k1 row (a panel) the last axis is viewed as (a, b) =
// (j2, j3), index a*f3 + b:  y[k2,b] = tw[k2,b] * sum_a W2[k2,a] x[a,b];
//                           z[k2,k3] = sum_b y[k2,b] W3[k3,b];
// then both pols are detected.
//
// What bounds it on an H100: its bytes.  Each input value is read once (8
// bytes f32 or 4 bf16 for re and im) and each product written once (4
// bytes a plane): at the 0000 shape 4.3 GB in and 1.07 GB out (I; 4.3 GB
// IQUV), 1.60 ms (2.56) at 3.35 TB/s.  As FFTs the two levels cost
// 5*log2(f2*f3) = 65 flops a value, far under the bytes; the contract's
// dense products (8*(f2+f3) = 1536 flops a value) would take 12.4 ms of
// f32 arithmetic.  Design (building blocks in fft_smem.cuh; f2 = 128,
// f3 = 64 compiled in):
//   - a block takes one panel pair, both pols of one (channel, frame, k1):
//     it loads both into shared memory (f32 by 16-byte cp.async, bf16
//     widened on load), rows padded by 4 floats as dft_tail2 pads them,
//     and runs for each pol the column level (128 points down each of the
//     64 columns, the twiddle, staged in shared memory once, on the way
//     out of its last pass) and the row level (64 points along each of the
//     128 rows) with fft_smem.cuh's passes, in place, roots indexed in the
//     rows of W2 and W3 the wrapper passes;
//   - the row level's last pass stores z in q = k2 + f2*k3 order; the
//     detect reads both pols' z and writes the product's planes over them,
//     in place;
//   - the store is the hard part: one panel is one k1, and its outputs lie
//     f1 floats apart.  Eight blocks on consecutive k1 form a thread-block
//     cluster; once all eight have detected, each writes one eighth of the
//     q positions for all eight k1, reading the others' planes through
//     distributed shared memory 16 bytes at a time, so every store is a
//     whole 32-byte run (8 k1) and each sector is written once;
//   - persistent clusters walk over (channel, frame, group of 8 k1), the
//     next panel pair prefetched into L2 (bulk prefetch) while this one is
//     transformed.  One panel pair and the twiddle fill shared memory, so
//     the loads cannot overlap the FFTs within a block: with a third
//     panel slot in place of the staged twiddle the kernel ran slower;
//     pushing the products to the writing block instead of pulling them
//     spilled registers and ran slower too (PERF.md §6);
//   - f32 stays f32 on the CUDA cores (no TF32).  bf16 input rounds the
//     twiddled column level to bf16, as _td_kernel does; the contract's
//     dense products also round W2 and W3 to bf16, which an FFT cannot, so
//     bf16 results differ from the contract by that rounding (relative rms
//     a few 1e-3 in power) and equal, up to f32 summation order, the FFTs
//     with f32 roots and the rounded column level.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int F2 = 128;
constexpr int F3 = 64;
constexpr int Q = F2 * F3;        // values of a panel
constexpr int CL = 8;             // blocks of a cluster: consecutive k1
constexpr int NT = 512;           // threads per block
constexpr int MAXV = 16;          // complex values a thread holds in a pass
constexpr int WS = F3 + 4;        // row stride of a work plane (floats)
constexpr int QS = F2 + 8;        // k3 stride of the detected planes
constexpr int PL = F2 * WS;       // floats of a work plane (= F3 * QS)
constexpr int WQ = Q / CL / 4 * CL / NT;  // quads a thread writes, a plane
constexpr int TWS = 2 * (F2 + F3);  // the staged twiddle (floats)
constexpr int WORK = TWS + 2 * Q;   // the four work planes (floats)
constexpr int SMEM_FLOATS = WORK + 4 * PL;
using P2 = fft::Radices<16, 8>;
using P3 = fft::Radices<8, 8>;

static_assert(F3 * QS == PL, "the detected planes fill the work planes");

__device__ __forceinline__ float rbf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A 16-byte-aligned run of global memory into L2, asynchronously.
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// Element idx of transform t of one pol's panel (planes wr, wi).  Column
// level (COLS): t a column b, idx a row, row stride WS; its last pass
// multiplies by the staged twiddle (and rounds to bf16 for bf16 input).
// Row level: t a row k2, idx a column, row stride WS; its last pass (one
// round: it reads all before it writes) stores z[k2][k3] at k3*QS + k2,
// so q = k2 + F2*k3 runs along memory.  Lanes of a warp take TG
// transforms x 32/TG butterflies (dft_tail2's PanelIO: 32 columns, or 8
// rows x 4 butterflies, conflict-free with the 4-float pad; the last
// pass's stores are conflict-free with QS = F2 + 8).  Each level is one
// round of CNT transforms, so every index folds to constants.
template <bool BF16, bool COLS>
struct DetIO {
  static constexpr int TG = COLS ? 32 : 8;
  static constexpr int CNT = COLS ? F3 : F2;
  static constexpr int NTR = CNT / TG;
  int wr, wi;
  bool last;

  __device__ __forceinline__ int pass_table() const { return -1; }
  __device__ __forceinline__ void set_pass(bool, bool l) { last = l; }
  __device__ __forceinline__ void round(int, int) {}
  __device__ __forceinline__ void map(int b, int, int& t, int& j) const {
    const int w = b >> 5, l = b & 31;
    t = (w % NTR) * TG + l % TG;
    j = (w / NTR) * (32 / TG) + l / TG;
  }
  __device__ __forceinline__ int off(int t, int idx) const {
    return COLS ? idx * WS + t : t * WS + idx;
  }
  __device__ __forceinline__ void ld(int t, int idx, float& a, float& b) const {
    a = fft::fft_smem[wr + off(t, idx)];
    b = fft::fft_smem[wi + off(t, idx)];
  }
  __device__ __forceinline__ void st(int t, int idx, float a, float b) const {
    int o = off(t, idx);
    if (COLS && last) {  // row k2 = idx, column t
      const int e = TWS + idx * F3 + t;
      fft::cmul(a, b, fft::fft_smem[e], fft::fft_smem[e + Q]);
      if (BF16) {
        a = rbf16(a);
        b = rbf16(b);
      }
    } else if (!COLS && last) {  // k2 = t, k3 = idx
      o = idx * QS + t;
    }
    fft::fft_smem[wr + o] = a;
    fft::fft_smem[wi + o] = b;
  }
};

// Stokes products (blit.ops.channelize.detect_stokes_planar's table):
// 0 I, 1 XX, 2 YY, 3 XXYY, 4 full, 5 IQUV.
__device__ __forceinline__ void detect(int stokes, float xr, float xi,
                                       float yr, float yi, float* o) {
  const float xx = xr * xr + xi * xi;
  const float yy = yr * yr + yi * yi;
  const float xy_re = xr * yr + xi * yi;
  const float xy_im = xi * yr - xr * yi;
  switch (stokes) {
    case 0: o[0] = xx + yy; break;
    case 1: o[0] = xx; break;
    case 2: o[0] = yy; break;
    case 3: o[0] = xx; o[1] = yy; break;
    case 4: o[0] = xx; o[1] = yy; o[2] = xy_re; o[3] = xy_im; break;
    default:
      o[0] = xx + yy; o[1] = xx - yy; o[2] = 2.f * xy_re; o[3] = -2.f * xy_im;
  }
}

// Load the panel pair of (c, f, k1) into the four work planes (re0, im0,
// re1, im1), row a at a*WS.
template <typename T>
__device__ __forceinline__ void load_panels(const T* xr, const T* xi,
                                            long long p0, long long p1) {
  constexpr int V = 16 / sizeof(T);  // values of one 16-byte copy
  constexpr int CPP = Q / V;         // copies of a plane
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
#pragma unroll 4
    for (int k = tid; k < 4 * CPP; k += NT) {
      const int pl = k / CPP, e = (k - pl * CPP) * V;
      const T* src = (pl & 1 ? xi : xr) + (pl & 2 ? p1 : p0) + e;
      fft::cp16(fft::fft_smem + WORK + pl * PL + (e / F3) * WS + e % F3, src, 16);
    }
    fft::cp_commit();
    fft::cp_wait_all();
  } else {
    constexpr int PER = 4 * CPP / NT;  // copies a thread
    uint4 u[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * NT;
      const int pl = k / CPP, e = (k - pl * CPP) * V;
      const T* src = (pl & 1 ? xi : xr) + (pl & 2 ? p1 : p0) + e;
      u[i] = __ldg(reinterpret_cast<const uint4*>(src));
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * NT;
      const int pl = k / CPP, e = (k - pl * CPP) * V;
      float* d = fft::fft_smem + WORK + pl * PL + (e / F3) * WS + e % F3;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c = __bfloat1622float2(h[2]), e4 = __bfloat1622float2(h[3]);
      reinterpret_cast<float4*>(d)[0] = make_float4(a.x, a.y, b.x, b.y);
      reinterpret_cast<float4*>(d)[1] = make_float4(c.x, c.y, e4.x, e4.y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
tail2_detect_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                    const float* __restrict__ w2r_row,
                    const float* __restrict__ w2i_row,
                    const float* __restrict__ w3r_row,
                    const float* __restrict__ w3i_row,
                    const float* __restrict__ twr,
                    const float* __restrict__ twi, float* __restrict__ out,
                    int nchan, int nframes, int f1, int stokes, int nif) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  // Shared memory: W2's row and W3's row as (re, im) pairs at float2
  // offsets 0 and F2, the twiddle's planes at TWS, the work planes at WORK.
  for (int k = tid; k < F2; k += NT) {
    fft::fft_smem[2 * k] = w2r_row[k];
    fft::fft_smem[2 * k + 1] = w2i_row[k];
  }
  for (int k = tid; k < F3; k += NT) {
    fft::fft_smem[2 * (F2 + k)] = w3r_row[k];
    fft::fft_smem[2 * (F2 + k) + 1] = w3i_row[k];
  }
  for (int k = tid; k < Q; k += NT) {
    fft::fft_smem[TWS + k] = twr[k];
    fft::fft_smem[TWS + Q + k] = twi[k];
  }
  const long long nfft = (long long)f1 * Q;
  const int groups = f1 / CL;
  const long long items = (long long)nchan * nframes * groups;
  const int kr = tid % CL;
  // The other blocks' planes: this thread reads those of rank kr.
  const float* remote = cluster.map_shared_rank(fft::fft_smem, kr);
  const long long pstride = (long long)nframes * f1 * Q;  // pol stride
  auto panel = [&](long long it, int& c, int& f, int& k1_0) {
    const long long cf = it / groups;
    k1_0 = (int)(it - cf * groups) * CL;
    c = (int)(cf / nframes);
    f = (int)(cf - (long long)c * nframes);
    return (((long long)c * 2 * nframes + f) * f1 + k1_0 + rank) * Q;
  };

  for (long long it = blockIdx.x / CL; it < items; it += gridDim.x / CL) {
    int c, f, k1_0;
    const long long p0 = panel(it, c, f, k1_0);
    load_panels<T>(xr, xi, p0, p0 + pstride);
    __syncthreads();
    // The next panel pair into L2 while this one is transformed.
    const long long nx = it + gridDim.x / CL;
    if (nx < items && tid < 4) {
      int c2, f2, k2;
      const long long q0 = panel(nx, c2, f2, k2) + (tid & 2 ? pstride : 0);
      prefetch_l2((tid & 1 ? xi : xr) + q0, Q * sizeof(T));
    }

    for (int p = 0; p < 2; ++p) {
      const int wr = WORK + 2 * p * PL;
      // Column level: 64 columns of 128 points, the twiddle on the way out.
      DetIO<sizeof(T) == 2, true> cio{wr, wr + PL};
      fft::static_plan<NT, MAXV, F2, 1>(cio, F3, F3, 0, P2());
      // Row level: 128 rows of 64 points, z[k2][k3] to k3*QS + k2.
      DetIO<sizeof(T) == 2, false> rio{wr, wr + PL};
      fft::static_plan<NT, MAXV, F3, 1>(rio, F2, F2, F2, P3());
    }

    // Detect both pols; plane pl of the product over work plane pl.
    for (int e = tid; e < Q; e += NT) {
      const int o = WORK + (e / F2) * QS + e % F2;
      float v[4];
      detect(stokes, fft::fft_smem[o], fft::fft_smem[o + PL],
             fft::fft_smem[o + 2 * PL], fft::fft_smem[o + 3 * PL], v);
#pragma unroll
      for (int pl = 0; pl < 4; ++pl) {
        if (pl < nif) fft::fft_smem[o + pl * PL] = v[pl];
      }
    }
    cluster.sync();

    // This block writes positions q = k2 + F2*k3 in [rank*Q/CL, ..) of
    // every plane for the cluster's CL k1: a thread reads 4 consecutive q
    // of rank kr's plane (16 bytes), and the CL lanes of a group write the
    // CL k1 of each q as one 32-byte run at q*f1 + k1_0.
    for (int pl = 0; pl < nif; ++pl) {
      float4 v[WQ];
#pragma unroll
      for (int i = 0; i < WQ; ++i) {
        const int q0 = rank * (Q / CL) + 4 * ((tid + i * NT) / CL);
        const int o = WORK + pl * PL + (q0 / F2) * QS + q0 % F2;
        v[i] = *reinterpret_cast<const float4*>(remote + o);
      }
      float* dst = out + (((long long)f * nif + pl) * nchan + c) * nfft +
                   k1_0 + kr;
#pragma unroll
      for (int i = 0; i < WQ; ++i) {
        const int q0 = rank * (Q / CL) + 4 * ((tid + i * NT) / CL);
        const long long g = (long long)q0 * f1;
        dst[g] = v[i].x;
        dst[g + f1] = v[i].y;
        dst[g + 2 * f1] = v[i].z;
        dst[g + 3 * f1] = v[i].w;
      }
    }
    // The planes are read: the next panels may overwrite them.
    cluster.sync();
  }
}

size_t smem_bytes() { return (size_t)SMEM_FLOATS * sizeof(float); }

template <typename T>
cudaError_t launch(const void* xr, const void* xi, const void* w2r_row,
                   const void* w2i_row, const void* w3r_row,
                   const void* w3i_row, const void* twr, const void* twi,
                   void* out, int nchan, int nframes, int f1, int stokes,
                   int nif, cudaStream_t stream) {
  if (f1 < CL || f1 % CL || nchan < 1 || nframes < 1 || nif < 1 || nif > 4) {
    return cudaErrorInvalidValue;
  }
  auto kernel = tail2_detect_kernel<T>;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long items = (long long)nchan * nframes * (f1 / CL);
  cfg.gridDim = dim3((unsigned)(CL * (items < 1024 ? items : 1024)));
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) {
    return err;
  }
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(CL * (items < clusters ? items : clusters)));
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const float*>(w2r_row), static_cast<const float*>(w2i_row),
      static_cast<const float*>(w3r_row), static_cast<const float*>(w3i_row),
      static_cast<const float*>(twr), static_cast<const float*>(twi),
      static_cast<float*>(out), nchan, nframes, f1, stokes, nif);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the Python fit gate checks against.
int tail2_detect_f2() { return F2; }
int tail2_detect_f3() { return F3; }
int tail2_detect_k1_tile() { return CL; }
int tail2_detect_smem_bytes() { return (int)smem_bytes(); }

int tail2_detect_launch(const void* xr, const void* xi, const void* w2r_row,
                        const void* w2i_row, const void* w3r_row,
                        const void* w3i_row, const void* twr, const void* twi,
                        void* out, int nchan, int nframes, int f1, int stokes,
                        int nif, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(xr, xi, w2r_row, w2i_row, w3r_row, w3i_row,
                                   twr, twi, out, nchan, nframes, f1, stokes,
                                   nif, s)
           : launch<float>(xr, xi, w2r_row, w2i_row, w3r_row, w3i_row, twr,
                           twi, out, nchan, nframes, f1, stokes, nif, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
