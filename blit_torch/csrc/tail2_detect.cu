// tail2_detect.cu — DFT levels 2 and 3 + inner untwist + Stokes detect,
// written straight into the filterbank product layout.
//
// Replaces the TPU kernel blit/ops/pallas_detect.py:tail2_detect (body
// _td_kernel) with the same contract:
//   in : stage-1 spectra (ur, ui), each (nchan, 2 pol, nframes, f1, f2*f3),
//        f32 or bf16, as pfb_dft1 emits them;
//        the f2-point DFT matrix as its row 1 (W2[k,j] == W2[1,(k*j) mod f2]),
//        the f3-point DFT matrix, the (f2, f3) twiddles — all f32;
//   out: f32 (nframes, nif, nchan, f1*f2*f3) in natural order
//        k = k1 + f1*k2 + f1*f2*k3.
// Within one k1 row the last axis is viewed as (a, b) = (j2, j3), index
// a*f3 + b:  y[k2,b] = tw[k2,b] * sum_a W2[k2,a] x[a,b];
//            z[k2,k3] = sum_b y[k2,b] W3[k3,b];  then detect both pols.
//
// What bounds it on an H100: 8*(f2+f3) = 1536 flops per complex input
// element against 8 (f32) or 4 (bf16) bytes read and nif*2 bytes written,
// so at the 0000 shape ~8.2e11 f32 flops against ~5.4 GB: 12 ms of f32
// CUDA-core peak against 1.6 ms of HBM — bound by f32 arithmetic.  Design:
//   - a block owns TK1 = 8 consecutive k1 rows and G2 = 16 of the f2 output
//     rows k2 of one (channel, frame); it computes only its k2 rows of the
//     f2-point stage (no wasted arithmetic) and all f3 outputs of them;
//   - the f2 stage streams the rows' input through shared memory in tiles
//     of AT rows, loaded with 16-byte coalesced loads one tile ahead (the
//     eight k2 groups of the same rows are neighbours in the grid and share
//     the input through L2); the twiddled rows stay in shared memory, the
//     f3 stage and the Stokes epilogue run in registers;
//   - the detected tile is staged in shared memory as [k3][k2][k1] and
//     written out so that each (k3, k2) pair stores TK1 consecutive floats —
//     whole 32-byte sectors — instead of the stride-f1 single floats a
//     one-row block would write (the final f1<->f2 swap that the TPU kernel
//     left to XLA happens here);
//   - f32 input runs in f32 (not TF32); bf16 input rounds where _td_kernel
//     does: matrices and the post-twiddle rows to bf16, sums in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int F2 = 128;
constexpr int F3 = 64;
constexpr int G2 = 16;   // k2 rows per block
constexpr int TK1 = 8;   // k1 rows per block
constexpr int NT = 256;  // threads: F3 columns x 4 row-quads
constexpr int SK = G2 * TK1 + 1;  // padded k3 stride of the staging tile
constexpr int AT = 16;             // input rows (a) per staged tile
constexpr int NTL = F2 / AT;       // tiles per k1 row
constexpr int VQ = AT * F3 / 4;    // 4-element vectors per pol per tile
constexpr int VPT = 2 * VQ / NT;   // vectors each thread loads per tile

__device__ __forceinline__ float rbf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive input values as f32 (i is a multiple of 4).
template <bool BF16>
__device__ __forceinline__ float4 ld4(const void* p, size_t i) {
  if (BF16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
}

// Load rows [a0, a0+AT) of both pols' k1 row into registers, coalesced:
// vector v covers pol v / VQ, row a0 + (v % VQ) / (F3/4), 4 columns.
template <bool BF16>
__device__ __forceinline__ void load_tile(const void* xr, const void* xi,
                                          size_t base0, size_t base1, int a0,
                                          int tid, float4* pr, float4* pi) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = tid + NT * j;
    const int rem = v % VQ;
    const size_t off = (v / VQ ? base1 : base0) +
                       (size_t)(a0 + rem / (F3 / 4)) * F3 + (rem % (F3 / 4)) * 4;
    pr[j] = ld4<BF16>(xr, off);
    pi[j] = ld4<BF16>(xi, off);
  }
}

// Store a loaded tile as (re, im) pairs: X[pol][a - a0][b].
__device__ __forceinline__ void store_tile(float2* X, int tid, const float4* pr,
                                           const float4* pi) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = tid + NT * j;
    const int rem = v % VQ;
    float2* d = X + ((v / VQ) * AT + rem / (F3 / 4)) * F3 + (rem % (F3 / 4)) * 4;
    d[0] = make_float2(pr[j].x, pi[j].x);
    d[1] = make_float2(pr[j].y, pi[j].y);
    d[2] = make_float2(pr[j].z, pi[j].z);
    d[3] = make_float2(pr[j].w, pi[j].w);
  }
}

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

template <bool BF16>
__global__ void __launch_bounds__(NT)
tail2_detect_kernel(const void* __restrict__ xr_, const void* __restrict__ xi_,
                    const float* __restrict__ w2r_row,
                    const float* __restrict__ w2i_row,
                    const float* __restrict__ w3r, const float* __restrict__ w3i,
                    const float* __restrict__ twr, const float* __restrict__ twi,
                    float* __restrict__ out, int nchan, int nframes, int f1,
                    int stokes, int nif) {
  extern __shared__ float sm[];
  float* T2r = sm;
  float* T2i = T2r + F2;
  float* W3r = T2i + F2;
  float* W3i = W3r + F3 * F3;
  float2* Y = reinterpret_cast<float2*>(W3i + F3 * F3);  // [2 pol][G2][F3]
  float2* X = Y + 2 * G2 * F3;                           // [2 pol][AT][F3]
  float* S = reinterpret_cast<float*>(X + 2 * AT * F3);  // [nif][F3][SK]

  const int g2 = blockIdx.x;
  const int k1_0 = blockIdx.y * TK1;
  const int c = blockIdx.z / nframes;
  const int f = blockIdx.z % nframes;
  const int tid = threadIdx.x;
  const int m = F2 * F3;
  const size_t nfft = (size_t)f1 * m;

  for (int i = tid; i < F2; i += NT) {
    T2r[i] = BF16 ? rbf16(w2r_row[i]) : w2r_row[i];
    T2i[i] = BF16 ? rbf16(w2i_row[i]) : w2i_row[i];
  }
  for (int i = tid; i < F3 * F3; i += NT) {
    W3r[i] = BF16 ? rbf16(w3r[i]) : w3r[i];
    W3i[i] = BF16 ? rbf16(w3i[i]) : w3i[i];
  }
  __syncthreads();

  const int col = tid % F3;  // b in the f2 stage, k3 in the f3 stage
  const int q = tid / F3;    // this thread's k2 rows: q, q+4, q+8, q+12
  auto row_base = [&](int p, int k1) {
    return ((((size_t)c * 2 + p) * nframes + f) * f1 + k1) * (size_t)m;
  };
  float4 pr[VPT], pi[VPT];
  load_tile<BF16>(xr_, xi_, row_base(0, k1_0), row_base(1, k1_0), 0, tid, pr, pi);
  for (int r = 0; r < TK1; ++r) {
    const int k1 = k1_0 + r;
    // f2-point stage for this block's k2 rows, column b = col, over
    // tiles of AT input rows staged in shared memory.
    float ar[2][4], ai[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ar[0][i] = ai[0][i] = ar[1][i] = ai[1][i] = 0.f;
    for (int t = 0; t < NTL; ++t) {
      store_tile(X, tid, pr, pi);
      __syncthreads();
      // Prefetch the next tile (this row's next or the next row's first)
      // into registers while this one is used.
      if (t + 1 < NTL) {
        load_tile<BF16>(xr_, xi_, row_base(0, k1), row_base(1, k1),
                        (t + 1) * AT, tid, pr, pi);
      } else if (r + 1 < TK1) {
        load_tile<BF16>(xr_, xi_, row_base(0, k1 + 1), row_base(1, k1 + 1),
                        0, tid, pr, pi);
      }
#pragma unroll
      for (int al = 0; al < AT; ++al) {
        const int a = t * AT + al;
        const float2 x0 = X[al * F3 + col];
        const float2 x1 = X[(AT + al) * F3 + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k2 = g2 * G2 + q + 4 * i;
          const int idx = (k2 * a) & (F2 - 1);
          const float wr = T2r[idx];
          const float wi = T2i[idx];
          ar[0][i] = fmaf(wr, x0.x, fmaf(-wi, x0.y, ar[0][i]));
          ai[0][i] = fmaf(wr, x0.y, fmaf(wi, x0.x, ai[0][i]));
          ar[1][i] = fmaf(wr, x1.x, fmaf(-wi, x1.y, ar[1][i]));
          ai[1][i] = fmaf(wr, x1.y, fmaf(wi, x1.x, ai[1][i]));
        }
      }
      __syncthreads();  // X is rewritten by the next tile
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = q + 4 * i;
      const int k2 = g2 * G2 + kk;
      const float tr = __ldg(twr + k2 * F3 + col);
      const float ti = __ldg(twi + k2 * F3 + col);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float yr = ar[p][i] * tr - ai[p][i] * ti;
        float yi = ar[p][i] * ti + ai[p][i] * tr;
        if (BF16) {
          yr = rbf16(yr);
          yi = rbf16(yi);
        }
        Y[(p * G2 + kk) * F3 + col] = make_float2(yr, yi);
      }
    }
    __syncthreads();

    // f3-point stage (W3 is symmetric: W3[k3,b] == W3[b,k3]), k3 = col.
    float zr[2][4], zi[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zr[0][i] = zi[0][i] = zr[1][i] = zi[1][i] = 0.f;
#pragma unroll 8
    for (int b = 0; b < F3; ++b) {
      const float wr = W3r[b * F3 + col];
      const float wi = W3i[b * F3 + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = q + 4 * i;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float2 y = Y[(p * G2 + kk) * F3 + b];
          zr[p][i] = fmaf(y.x, wr, fmaf(-y.y, wi, zr[p][i]));
          zi[p][i] = fmaf(y.x, wi, fmaf(y.y, wr, zi[p][i]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = q + 4 * i;
      float o[4];
      detect(stokes, zr[0][i], zi[0][i], zr[1][i], zi[1][i], o);
      for (int pl = 0; pl < nif; ++pl) {
        S[(pl * F3 + col) * SK + kk * TK1 + r] = o[pl];
      }
    }
    __syncthreads();  // Y is rewritten by the next row
  }

  // Coalesced store: each (plane, k3, k2) holds TK1 consecutive k1.
  const int tile = nif * F3 * G2 * TK1;
  for (int e = tid; e < tile; e += NT) {
    const int r = e % TK1;
    const int kk = (e / TK1) % G2;
    const int k3 = (e / (TK1 * G2)) % F3;
    const int pl = e / (TK1 * G2 * F3);
    const size_t k = (size_t)(k1_0 + r) + (size_t)f1 * (g2 * G2 + kk) +
                     (size_t)f1 * F2 * k3;
    out[(((size_t)f * nif + pl) * nchan + c) * nfft + k] =
        S[(pl * F3 + k3) * SK + kk * TK1 + r];
  }
}

size_t smem_bytes(int nif) {
  return (2 * F2 + 2 * F3 * F3) * sizeof(float) +
         (2 * G2 * F3 + 2 * AT * F3) * sizeof(float2) +
         (size_t)nif * F3 * SK * sizeof(float);
}

template <bool BF16>
cudaError_t launch(const void* xr, const void* xi, const void* w2r_row,
                   const void* w2i_row, const void* w3r, const void* w3i,
                   const void* twr, const void* twi, void* out, int nchan,
                   int nframes, int f1, int stokes, int nif,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(nif);
  cudaError_t err = cudaFuncSetAttribute(
      tail2_detect_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(F2 / G2, f1 / TK1, nchan * nframes);
  tail2_detect_kernel<BF16><<<grid, NT, smem, stream>>>(
      xr, xi, static_cast<const float*>(w2r_row),
      static_cast<const float*>(w2i_row), static_cast<const float*>(w3r),
      static_cast<const float*>(w3i), static_cast<const float*>(twr),
      static_cast<const float*>(twi), static_cast<float*>(out), nchan, nframes,
      f1, stokes, nif);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the Python fit gate checks against.
int tail2_detect_f2() { return F2; }
int tail2_detect_f3() { return F3; }
int tail2_detect_k1_tile() { return TK1; }
int tail2_detect_smem_bytes(int nif) { return (int)smem_bytes(nif); }

int tail2_detect_launch(const void* xr, const void* xi, const void* w2r_row,
                        const void* w2i_row, const void* w3r, const void* w3i,
                        const void* twr, const void* twi, void* out, int nchan,
                        int nframes, int f1, int stokes, int nif, int bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<true>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr, twi, out,
                          nchan, nframes, f1, stokes, nif, s)
           : launch<false>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr, twi, out,
                           nchan, nframes, f1, stokes, nif, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
