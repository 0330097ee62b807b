// dft.cu — the planar DFT stages dft_last and dft_stage.
//
// Replaces two TPU kernels of blit/ops/pallas_dft.py with their contracts:
//   dft_last  (body _last_kernel): x (r, n) planar → o[r,k] = sum_j x[r,j] W[j,k];
//   dft_stage (bodies _stage_kernel_tw / _stage_kernel): x (b, n, m) planar →
//             o[b,k,j] = tw[k,j] * sum_l W[k,l] x[b,l,j], the twiddle optional.
// W is the n-point DFT matrix (f32, symmetric), tw the (n, m) twiddles; the
// input is f32 or bf16 (widened to f32 as it is loaded), the output f32.
// Like _last_kernel and _stage_kernel, each output takes the four real
// products; here rr - ii and ri + ir accumulate as two f32 sums per output.
//
// What bounds it on an H100: the transform itself (5*log2(n) flops per
// complex output as an FFT) is bound by its 16 bytes per output (f32 in and
// out): 1.28 ms for the 0002 product's n = 1024 chunk.  The dense product
// that this contract fixes does 8n flops per output instead, so at n >= 16
// this kernel is bound by the f32 arithmetic it chooses (67 TFLOP/s on the
// CUDA cores; 2.2e12 flops, 32.8 ms, for that chunk) and only at n = 8
// (the 0001 product) by memory.  Design:
//   - both are one complex tiled GEMM, C = A·B per batch element: dft_last
//     takes A = x, B = W; dft_stage takes A = W (shared by the batch), B = x.
//     A block computes a 64 x 64 tile of C from 16-deep slices of A and B
//     staged in shared memory; each of its 256 threads holds a 4 x 4 tile
//     of complex sums in registers (64 FMAs per 4 16-byte shared loads);
//     the next slices are loaded into registers while the current ones are
//     used.  Edges are masked, so any n, m and row count works.
//   - the twiddle multiplies the sums in the epilogue, read once per output.
//   - for n = 8 (the 0001 product) dft_last instead gives each thread whole
//     rows and keeps W in shared memory: the tile would waste 56 of its 64
//     columns, and the work is a stream of bytes.  The launch's `tiled`
//     flag runs the tile there anyway, so the two can be timed side by side.
//   - f32 stays f32 on the CUDA cores (no TF32, no tensor cores); wgmma,
//     TMA and a deeper pipeline are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // C rows per block
constexpr int BN = 64;          // C columns per block
constexpr int BK = 16;          // depth of one staged slice
constexpr int NTHREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = BM + 4;    // row stride of the transposed A slice
constexpr int ROWS_THREADS = 256;

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// C[b] = A[b] (M x K) · B[b] (K x N), planar complex, row-major with
// leading dimensions K, N, N and batch strides sa, sb, sc (elements; 0
// shares the operand).  TW: C *= T (M x N) elementwise.
template <typename TA, typename TB, bool TW>
__global__ void __launch_bounds__(NTHREADS)
cgemm_kernel(const TA* __restrict__ ar, const TA* __restrict__ ai,
             const TB* __restrict__ br, const TB* __restrict__ bi,
             const float* __restrict__ tr, const float* __restrict__ ti,
             float* __restrict__ cr, float* __restrict__ ci, int M, int N,
             int K, long long sa, long long sb, long long sc, int mtiles,
             int vec_out) {
  __shared__ __align__(16) float As_r[BK][APAD];
  __shared__ __align__(16) float As_i[BK][APAD];
  __shared__ __align__(16) float Bs_r[BK][BN];
  __shared__ __align__(16) float Bs_i[BK][BN];

  const long long batch = blockIdx.x / mtiles;
  const int m0 = (int)(blockIdx.x % mtiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  ar += batch * sa;
  ai += batch * sa;
  br += batch * sb;
  bi += batch * sb;

  // Slice loaders: 4 elements of each plane per thread.  A: consecutive
  // threads walk k within a row; B: consecutive threads walk a row's n.
  float pa_r[4], pa_i[4], pb_r[4], pb_i[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i * NTHREADS + tid;
      const int am = m0 + e / BK, ak = k0 + e % BK;
      const bool aok = am < M && ak < K;
      const size_t aoff = (size_t)am * K + ak;
      pa_r[i] = aok ? ldf(ar + aoff) : 0.f;
      pa_i[i] = aok ? ldf(ai + aoff) : 0.f;
      const int bk = k0 + e / BN, bn = n0 + e % BN;
      const bool bok = bk < K && bn < N;
      const size_t boff = (size_t)bk * N + bn;
      pb_r[i] = bok ? ldf(br + boff) : 0.f;
      pb_i[i] = bok ? ldf(bi + boff) : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i * NTHREADS + tid;
      As_r[e % BK][e / BK] = pa_r[i];
      As_i[e % BK][e / BK] = pa_i[i];
      Bs_r[e / BN][e % BN] = pb_r[i];
      Bs_i[e / BN][e % BN] = pb_i[i];
    }
  };

  float sr[4][4], si[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) sr[i][q] = si[i][q] = 0.f;
  }

  load(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 xr = *reinterpret_cast<const float4*>(&As_r[kk][ty * 4]);
      const float4 xi = *reinterpret_cast<const float4*>(&As_i[kk][ty * 4]);
      const float4 yr = *reinterpret_cast<const float4*>(&Bs_r[kk][tx * 4]);
      const float4 yi = *reinterpret_cast<const float4*>(&Bs_i[kk][tx * 4]);
      const float a_r[4] = {xr.x, xr.y, xr.z, xr.w};
      const float a_i[4] = {xi.x, xi.y, xi.z, xi.w};
      const float b_r[4] = {yr.x, yr.y, yr.z, yr.w};
      const float b_i[4] = {yi.x, yi.y, yi.z, yi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sr[i][q] = fmaf(a_r[i], b_r[q], sr[i][q]);
          sr[i][q] = fmaf(-a_i[i], b_i[q], sr[i][q]);
          si[i][q] = fmaf(a_r[i], b_i[q], si[i][q]);
          si[i][q] = fmaf(a_i[i], b_r[q], si[i][q]);
        }
      }
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  cr += batch * sc;
  ci += batch * sc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int n = n0 + tx * 4;
    float o_r[4], o_i[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o_r[q] = sr[i][q];
      o_i[q] = si[i][q];
      if (TW && n + q < N) {
        const float wr = __ldg(tr + (size_t)m * N + n + q);
        const float wi = __ldg(ti + (size_t)m * N + n + q);
        o_r[q] = sr[i][q] * wr - si[i][q] * wi;
        o_i[q] = sr[i][q] * wi + si[i][q] * wr;
      }
    }
    const size_t off = (size_t)m * N + n;
    if (vec_out && n + 3 < N) {
      *reinterpret_cast<float4*>(cr + off) = make_float4(o_r[0], o_r[1], o_r[2], o_r[3]);
      *reinterpret_cast<float4*>(ci + off) = make_float4(o_i[0], o_i[1], o_i[2], o_i[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (n + q < N) {
          cr[off + q] = o_r[q];
          ci[off + q] = o_i[q];
        }
      }
    }
  }
}

// Four consecutive inputs from a 16-byte (f32) or 8-byte (bf16) aligned
// address, widened to f32.
__device__ __forceinline__ void ld4(const float* p, float* a) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* a) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
}

// dft_last for small n: one thread per row, W in shared memory.
template <int N, typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
dft_last_rows_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     const float* __restrict__ wr, const float* __restrict__ wi,
                     float* __restrict__ o_r, float* __restrict__ o_i,
                     long long r) {
  __shared__ float swr[N * N];
  __shared__ float swi[N * N];
  for (int e = threadIdx.x; e < N * N; e += ROWS_THREADS) {
    swr[e] = wr[e];
    swi[e] = wi[e];
  }
  __syncthreads();
  const long long row = (long long)blockIdx.x * ROWS_THREADS + threadIdx.x;
  if (row >= r) return;
  const size_t base = (size_t)row * N;
  float a[N], b[N];
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    ld4(xr + base + j, a + j);
    ld4(xi + base + j, b + j);
  }
  float yr[N], yi[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s_r = 0.f, s_i = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float w_r = swr[j * N + k];
      const float w_i = swi[j * N + k];
      s_r = fmaf(a[j], w_r, s_r);
      s_r = fmaf(-b[j], w_i, s_r);
      s_i = fmaf(a[j], w_i, s_i);
      s_i = fmaf(b[j], w_r, s_i);
    }
    yr[k] = s_r;
    yi[k] = s_i;
  }
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    *reinterpret_cast<float4*>(o_r + base + k) = make_float4(yr[k], yr[k + 1], yr[k + 2], yr[k + 3]);
    *reinterpret_cast<float4*>(o_i + base + k) = make_float4(yi[k], yi[k + 1], yi[k + 2], yi[k + 3]);
  }
}

template <typename TA, typename TB, bool TW>
cudaError_t cgemm(const void* ar, const void* ai, const void* br,
                  const void* bi, const void* tr, const void* ti, void* cr,
                  void* ci, long long batch, long long M, int N, int K,
                  long long sa, long long sb, long long sc, cudaStream_t s) {
  const long long mtiles = (M + BM - 1) / BM;
  const long long gx = batch * mtiles;
  const long long gy = (N + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535 || M > 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(cr) | reinterpret_cast<uintptr_t>(ci);
  const int vec_out = N % 4 == 0 && sc % 4 == 0 && align % 16 == 0;
  cgemm_kernel<TA, TB, TW><<<dim3((unsigned)gx, (unsigned)gy), NTHREADS, 0, s>>>(
      static_cast<const TA*>(ar), static_cast<const TA*>(ai),
      static_cast<const TB*>(br), static_cast<const TB*>(bi),
      static_cast<const float*>(tr), static_cast<const float*>(ti),
      static_cast<float*>(cr), static_cast<float*>(ci), (int)M, N, K, sa, sb,
      sc, (int)mtiles, vec_out);
  return cudaGetLastError();
}

template <int N, typename T>
cudaError_t last_rows(const void* xr, const void* xi, const void* wr,
                      const void* wi, void* o_r, void* o_i, long long r,
                      cudaStream_t s) {
  const long long blocks = (r + ROWS_THREADS - 1) / ROWS_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dft_last_rows_kernel<N, T><<<(unsigned)blocks, ROWS_THREADS, 0, s>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<float*>(o_r), static_cast<float*>(o_i), r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t last(const void* xr, const void* xi, const void* wr,
                 const void* wi, void* o_r, void* o_i, long long r, int n,
                 int tiled, cudaStream_t s) {
  if (n == 8 && !tiled) {
    return last_rows<8, T>(xr, xi, wr, wi, o_r, o_i, r, s);
  }
  return cgemm<T, float, false>(xr, xi, wr, wi, nullptr, nullptr, o_r, o_i, 1,
                                r, n, n, 0, 0, 0, s);
}

template <typename T>
cudaError_t stage(const void* xr, const void* xi, const void* wr,
                  const void* wi, const void* tr, const void* ti, void* o_r,
                  void* o_i, long long b, int n, int m, cudaStream_t s) {
  const long long panel = (long long)n * m;
  if (tr != nullptr) {
    return cgemm<float, T, true>(wr, wi, xr, xi, tr, ti, o_r, o_i, b, n, m, n,
                                 0, panel, panel, s);
  }
  return cgemm<float, T, false>(wr, wi, xr, xi, nullptr, nullptr, o_r, o_i, b,
                                n, m, n, 0, panel, panel, s);
}

}  // namespace

extern "C" {

// tiled: run the tiled GEMM also where the row kernel applies (n = 8).
int dft_last_launch(const void* xr, const void* xi, const void* wr,
                    const void* wi, void* o_r, void* o_i, long long r, int n,
                    int bf16, int tiled, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? last<__nv_bfloat16>(xr, xi, wr, wi, o_r, o_i, r, n, tiled, s)
           : last<float>(xr, xi, wr, wi, o_r, o_i, r, n, tiled, s);
  return (int)err;
}

// tr/ti may be null: no twiddle.
int dft_stage_launch(const void* xr, const void* xi, const void* wr,
                     const void* wi, const void* tr, const void* ti, void* o_r,
                     void* o_i, long long b, int n, int m, int bf16,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? stage<__nv_bfloat16>(xr, xi, wr, wi, tr, ti, o_r, o_i, b, n, m, s)
           : stage<float>(xr, xi, wr, wi, tr, ti, o_r, o_i, b, n, m, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
