// dft_tail2.cu — the last two DFT levels of a three-factor DFT and the
// inner untwist: natural-order sub-spectra, no detection.
//
// Replaces the TPU kernel blit/ops/pallas_dft.py:dft_tail2 (body
// _tail2_kernel) with the same contract:
//   in : x (b, f2*f3) planar, f32 or bf16 (widened to f32 as it is loaded):
//        one stage-1 row panel per batch element, index a*f3 + c;
//        the f2-point DFT matrix as its row 1 (W2[k,a] == W2[1,(k*a) mod f2]),
//        the f3-point DFT matrix W3 and the (f2, f3) twiddles tw, all f32;
//   out: f32 (b, f3*f2), index k3*f2 + k2 (natural order within the panel):
//        u[k2,c]  = tw[k2,c] * sum_a W2[k2,a] x[a,c];
//        o[k3,k2] = sum_c u[k2,c] W3[c,k3].
// Like _tail2_kernel in f32 mode, each level is a dense product, summed in
// f32; bf16 input is widened (the output is f32 either way).
//
// What bounds it on an H100: the dense products do 8*(f2+f3) flops per
// complex output against 16 bytes moved (f32 in and out) — at the 2^21
// shape (f2 = f3 = 128) 2.2e12 flops per chunk of 2^30 outputs, 33 ms at
// the f32 CUDA-core peak, while the transform itself (5*log2(f2*f3) flops
// an output as an FFT) is bound by its 17 GB of traffic, 5.1 ms.  So this
// kernel is bound by the f32 arithmetic it chooses.  Design:
//   - a block owns G2 = 4096/f3 of the f2 output rows k2 of one panel and
//     computes only those rows of the f2-point stage (no wasted arithmetic);
//     the f2/G2 blocks of a panel are grid neighbours and share its input
//     through L2;
//   - both stages are one loop shape: a 4 x 4 tile of complex sums per
//     thread, against 2048-value slices staged in shared memory (16 KB) and
//     loaded one slice ahead into registers with 16-byte coalesced loads —
//     the panel's rows for the f2 stage, rows of W3 (read from L2) for the
//     f3 stage.  The other operand is warp-uniform, so its shared-memory
//     reads are broadcasts: W2 from its f2-entry table, the twiddled rows
//     u (32 KB, the block's G2 rows x f3 columns) four columns at a time;
//   - the twiddle multiplies the f2 stage's sums once, on the way into u;
//   - each thread stores its four k2 rows of a column k3 as one 16-byte
//     store at k3*f2 + k2: the inner untwist costs no pass of its own.
//   - f3 is compiled in (128, 256, 512); f2 is any power of two from G2 to
//     1024.  f32 stays f32 on the CUDA cores (no TF32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int UE = 4096;       // complex sums a block holds (G2 x f3)
constexpr int SE = 2048;       // complex values of one staged slice
constexpr int VPP = SE / 4 / NT;  // 4-value vectors per plane per thread
constexpr int MAX_F2 = 1024;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// SE consecutive values of each plane into registers, coalesced.
template <typename T>
__device__ __forceinline__ void load_slice(const T* pr, const T* pi, int tid,
                                           float4* r, float4* i) {
#pragma unroll
  for (int v = 0; v < VPP; ++v) {
    const int e = (tid + NT * v) * 4;
    r[v] = ld4(pr + e);
    i[v] = ld4(pi + e);
  }
}

__device__ __forceinline__ void store_slice(float* sr, float* si, int tid,
                                            const float4* r, const float4* i) {
#pragma unroll
  for (int v = 0; v < VPP; ++v) {
    const int e = (tid + NT * v) * 4;
    *reinterpret_cast<float4*>(sr + e) = r[v];
    *reinterpret_cast<float4*>(si + e) = i[v];
  }
}

template <int F3, typename T>
__global__ void __launch_bounds__(NT)
dft_tail2_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 const float* __restrict__ w2r_row,
                 const float* __restrict__ w2i_row,
                 const float* __restrict__ w3r, const float* __restrict__ w3i,
                 const float* __restrict__ twr, const float* __restrict__ twi,
                 float* __restrict__ o_r, float* __restrict__ o_i, int f2) {
  constexpr int G2 = UE / F3;    // k2 rows of a block
  constexpr int ROWS = SE / F3;  // rows of one staged slice
  constexpr int NQ = F3 / 4;     // column quads: threads along a row
  static_assert(G2 / 4 * NQ == NT, "one 4 x 4 tile per thread");
  static_assert(ROWS % 4 == 0, "the f3 stage reads u four columns at a time");

  extern __shared__ __align__(16) float sm[];
  float* Ur = sm;            // [G2][F3] twiddled rows
  float* Ui = Ur + UE;
  float* Sr = Ui + UE;       // [ROWS][F3] staged slice
  float* Si = Sr + SE;
  float* T2r = Si + SE;      // [f2] row 1 of W2
  float* T2i = T2r + f2;

  const int groups = f2 / G2;
  const long long b = blockIdx.x / groups;
  const int k2_0 = (int)(blockIdx.x % groups) * G2;
  const int tid = threadIdx.x;
  const int c0 = (tid % NQ) * 4;  // columns c0 .. c0+3
  const int r0 = (tid / NQ) * 4;  // the block's rows r0 .. r0+3
  const size_t m = (size_t)f2 * F3;
  xr += b * m;
  xi += b * m;

  for (int i = tid; i < f2; i += NT) {
    T2r[i] = w2r_row[i];
    T2i[i] = w2i_row[i];
  }
  float4 pr[VPP], pi[VPP];
  load_slice(xr, xi, tid, pr, pi);
  store_slice(Sr, Si, tid, pr, pi);
  __syncthreads();

  float ar[4][4], ai[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) ar[i][q] = ai[i][q] = 0.f;
  }

  // f2-point stage: s[k2,c] = sum_a W2[k2,a] x[a,c], slice by slice of rows a.
  const int nsl = f2 / ROWS;
  for (int s = 0; s < nsl; ++s) {
    const bool more = s + 1 < nsl;
    if (more) {
      load_slice(xr + (size_t)(s + 1) * SE, xi + (size_t)(s + 1) * SE, tid, pr, pi);
    }
#pragma unroll 4
    for (int aa = 0; aa < ROWS; ++aa) {
      const int a = s * ROWS + aa;
      const float4 vr = *reinterpret_cast<const float4*>(Sr + aa * F3 + c0);
      const float4 vi = *reinterpret_cast<const float4*>(Si + aa * F3 + c0);
      const float x_r[4] = {vr.x, vr.y, vr.z, vr.w};
      const float x_i[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = ((k2_0 + r0 + i) * a) & (f2 - 1);
        const float wr = T2r[idx];
        const float wi = T2i[idx];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[i][q] = fmaf(wr, x_r[q], fmaf(-wi, x_i[q], ar[i][q]));
          ai[i][q] = fmaf(wr, x_i[q], fmaf(wi, x_r[q], ai[i][q]));
        }
      }
    }
    __syncthreads();
    if (more) {
      store_slice(Sr, Si, tid, pr, pi);
      __syncthreads();
    }
  }

  // Twiddle into u; the first W3 slice is staged meanwhile (every thread
  // has passed the loop's last barrier, so the slice buffer is free).
  load_slice(w3r, w3i, tid, pr, pi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t t = (size_t)(k2_0 + r0 + i) * F3 + c0;
    const float4 tr = __ldg(reinterpret_cast<const float4*>(twr + t));
    const float4 ti = __ldg(reinterpret_cast<const float4*>(twi + t));
    const float t_r[4] = {tr.x, tr.y, tr.z, tr.w};
    const float t_i[4] = {ti.x, ti.y, ti.z, ti.w};
    float u_r[4], u_i[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u_r[q] = ar[i][q] * t_r[q] - ai[i][q] * t_i[q];
      u_i[q] = ar[i][q] * t_i[q] + ai[i][q] * t_r[q];
      ar[i][q] = ai[i][q] = 0.f;
    }
    *reinterpret_cast<float4*>(Ur + (r0 + i) * F3 + c0) =
        make_float4(u_r[0], u_r[1], u_r[2], u_r[3]);
    *reinterpret_cast<float4*>(Ui + (r0 + i) * F3 + c0) =
        make_float4(u_i[0], u_i[1], u_i[2], u_i[3]);
  }
  store_slice(Sr, Si, tid, pr, pi);
  __syncthreads();

  // f3-point stage: o[k2,k3] = sum_c u[k2,c] W3[c,k3], slice by slice of
  // W3's rows c; k3 = c0 + q.
  constexpr int NSL3 = F3 / ROWS;
  for (int s = 0; s < NSL3; ++s) {
    const bool more = s + 1 < NSL3;
    if (more) {
      load_slice(w3r + (size_t)(s + 1) * SE, w3i + (size_t)(s + 1) * SE, tid, pr, pi);
    }
#pragma unroll
    for (int cc = 0; cc < ROWS; cc += 4) {
      const int c = s * ROWS + cc;
      float u_r[4][4], u_i[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(Ur + (r0 + i) * F3 + c);
        const float4 d = *reinterpret_cast<const float4*>(Ui + (r0 + i) * F3 + c);
        u_r[i][0] = a.x; u_r[i][1] = a.y; u_r[i][2] = a.z; u_r[i][3] = a.w;
        u_i[i][0] = d.x; u_i[i][1] = d.y; u_i[i][2] = d.z; u_i[i][3] = d.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 vr = *reinterpret_cast<const float4*>(Sr + (cc + e) * F3 + c0);
        const float4 vi = *reinterpret_cast<const float4*>(Si + (cc + e) * F3 + c0);
        const float w_r[4] = {vr.x, vr.y, vr.z, vr.w};
        const float w_i[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ar[i][q] = fmaf(u_r[i][e], w_r[q], fmaf(-u_i[i][e], w_i[q], ar[i][q]));
            ai[i][q] = fmaf(u_r[i][e], w_i[q], fmaf(u_i[i][e], w_r[q], ai[i][q]));
          }
        }
      }
    }
    __syncthreads();
    if (more) {
      store_slice(Sr, Si, tid, pr, pi);
      __syncthreads();
    }
  }

  // Natural order within the panel: k3*f2 + k2, four k2 rows per store.
  o_r += b * m + k2_0 + r0;
  o_i += b * m + k2_0 + r0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t off = (size_t)(c0 + q) * f2;
    *reinterpret_cast<float4*>(o_r + off) =
        make_float4(ar[0][q], ar[1][q], ar[2][q], ar[3][q]);
    *reinterpret_cast<float4*>(o_i + off) =
        make_float4(ai[0][q], ai[1][q], ai[2][q], ai[3][q]);
  }
}

size_t smem_bytes(int f2) { return (2 * UE + 2 * SE + 2 * (size_t)f2) * sizeof(float); }

template <int F3, typename T>
cudaError_t launch(const void* xr, const void* xi, const void* w2r_row,
                   const void* w2i_row, const void* w3r, const void* w3i,
                   const void* twr, const void* twi, void* o_r, void* o_i,
                   long long b, int f2, cudaStream_t s) {
  constexpr int G2 = UE / F3;
  if (f2 < G2 || f2 > MAX_F2 || (f2 & (f2 - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = b * (f2 / G2);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(f2);
  cudaError_t err = cudaFuncSetAttribute(
      dft_tail2_kernel<F3, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dft_tail2_kernel<F3, T><<<(unsigned)blocks, NT, smem, s>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const float*>(w2r_row), static_cast<const float*>(w2i_row),
      static_cast<const float*>(w3r), static_cast<const float*>(w3i),
      static_cast<const float*>(twr), static_cast<const float*>(twi),
      static_cast<float*>(o_r), static_cast<float*>(o_i), f2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xr, const void* xi, const void* w2r_row,
                     const void* w2i_row, const void* w3r, const void* w3i,
                     const void* twr, const void* twi, void* o_r, void* o_i,
                     long long b, int f2, int f3, cudaStream_t s) {
  switch (f3) {
    case 128:
      return launch<128, T>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr, twi, o_r,
                            o_i, b, f2, s);
    case 256:
      return launch<256, T>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr, twi, o_r,
                            o_i, b, f2, s);
    case 512:
      return launch<512, T>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr, twi, o_r,
                            o_i, b, f2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Geometry the Python fit gate checks against.
int dft_tail2_max_f2() { return MAX_F2; }
int dft_tail2_rows_per_block(int f3) { return UE / f3; }

int dft_tail2_launch(const void* xr, const void* xi, const void* w2r_row,
                     const void* w2i_row, const void* w3r, const void* w3i,
                     const void* twr, const void* twi, void* o_r, void* o_i,
                     long long b, int f2, int f3, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr,
                                     twi, o_r, o_i, b, f2, f3, s)
           : dispatch<float>(xr, xi, w2r_row, w2i_row, w3r, w3i, twr, twi,
                             o_r, o_i, b, f2, f3, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
