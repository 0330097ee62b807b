// dft.cu — the planar DFT stages dft_last and dft_stage.
//
// Replaces two TPU kernels of blit/ops/pallas_dft.py with their contracts:
//   dft_last  (body _last_kernel): x (r, n) planar → o[r,k] = sum_j x[r,j] W[j,k];
//   dft_stage (bodies _stage_kernel_tw / _stage_kernel): x (b, n, m) planar →
//             o[b,k,j] = tw[k,j] * sum_l W[k,l] x[b,l,j], the twiddle optional.
// W is the n-point DFT matrix (f32, symmetric), tw the (n, m) twiddles; the
// input is f32 or bf16 (widened to f32 as it is loaded), the output f32.
//
// What bounds dft_last on an H100: its bytes.  As an FFT it does
// 5*log2(n) flops per complex output against 16 bytes moved (f32 in and
// out): about 3 flops a byte, far under the card's 20 f32 flops a byte.
// The TPU contract's dense product does 8n flops per output instead (32.8
// ms of f32 arithmetic for the 0002 product's n = 1024 chunk, whose bytes
// take 1.28 ms).  So dft_last computes the function as an FFT
// (dft_last_fft_kernel, the building blocks in fft_smem.cuh):
//   - W[j, k] = W[1, (j*k) mod n]: the kernel reads only row 1 of the W it
//     is given, the table of n-th roots, into shared memory, and indexes it
//     for every root; each pass's twiddles are copied from it, by index,
//     into a table of their own in which consecutive butterflies read
//     consecutive entries (no bank conflicts);
//   - a persistent block (as many per SM as registers and shared memory
//     allow) walks over groups of rows, 4096 values at most, contiguous in
//     memory; it stages a group with 16-byte cp.async copies over the flat
//     range (the range's first chunk aligned down, so a row may start
//     anywhere) while the previous group's butterflies run (two stage
//     buffers);
//   - the radix plan comes from ops/dft.py fft_plan: Stockham passes of
//     radix 16/8/4/2 in registers, then 3, 5, 7, and a dense pass for any
//     other prime, so every n <= 4096 is an FFT; between passes the data
//     sit in shared memory with one pad word every 32 (the stride-R
//     writes of the first pass hit 32 banks), f32 in place in the stage
//     buffer; the last pass writes natural order straight to device
//     memory, consecutive threads on consecutive addresses;
//   - the main paths' sizes (1024, 512, 96, 64) have their plans compiled
//     in, so every index computation folds to constants; any other plan is
//     read at run time, each pass a function of its own;
//   - each row's arithmetic is the same wherever the row falls, in any
//     call: a row's output depends only on that row;
//   - f32 stays f32 on the CUDA cores (no TF32).
// For n = 8 a row kernel (dft_last_rows_kernel: one thread a row, W in
// shared memory, 16-byte loads and stores) can take the call instead;
// ops/dft.py dft_last_design picks the one the smoke timed faster.
//
// dft_stage is bound by its bytes the same way (6144's first level: 805 M
// outputs of 64 points, 3.85 ms of bytes against 6.2 ms of dense f32
// products), so it too is an FFT (dft_stage_fft_kernel), down the columns:
//   - a persistent block walks over tiles of n rows x tc columns of a
//     panel (ops/dft.py stage_fft_geometry: tc a multiple of 32 that pads m
//     least, up to 4096 values a tile; 8 or 16 for n above 128), stages the
//     next tile with 16-byte cp.async copies of each row's segment (from
//     its first value aligned down, so a row may start anywhere) while this
//     tile's passes run, two stage buffers where they fit;
//   - consecutive threads take consecutive columns, so every pass reads and
//     writes shared memory without bank conflicts and the roots broadcast;
//     the passes and the plan are fft_smem.cuh's and fft_plan's, roots from
//     row 1 of the W it is given; the last pass multiplies by the twiddle
//     and stores natural k order, coalesced along j, only the columns that
//     exist;
//   - the main paths' stages have plan and tile compiled in (64 and 128
//     points at 32 columns, 6 at 352); any other n reads them at run time;
//   - a column's arithmetic is the same wherever it falls, so the twisted
//     order (route (b)) equals the natural one bitwise.
// ops/dft.py dft_stage_design keeps the dense tiled GEMM (cgemm_kernel)
// for what the FFT's tiles do not fit (n = 1, n above 1383) and where it
// timed faster (a dense prime pass p with n < 8p, n = 48); it also runs
// dft_last and dft_stage at any n when asked (the design of the first
// port, timed beside the FFTs by chip_smoke.py):
//   - C = A·B per batch element: dft_last takes A = x, B = W; dft_stage
//     takes A = W (shared by the batch), B = x.  A block computes a 64 x 64
//     tile of C from 16-deep slices of A and B staged in shared memory;
//     each of its 256 threads holds a 4 x 4 tile of complex sums in
//     registers; the next slices are loaded into registers while the
//     current ones are used.  Edges are masked, so any n, m and row count
//     works.  Like _last_kernel and _stage_kernel, each output takes the
//     four real products; rr - ii and ri + ir accumulate as two f32 sums;
//   - the twiddle multiplies the sums in the epilogue, read once per output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fft_smem.cuh"

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

// ---- dft_last as an FFT -------------------------------------------------

constexpr int FE = 4096;  // values of a row group, at most
// Threads of an FFT block: 256 (16 values a thread in a pass) for the
// compiled-in powers of two, 512 (8 values) for 96 and the plans read at
// run time, whose radix-3/5/7 passes spill registers at 16 values.
constexpr int FT_POW2 = 256;
constexpr int FT_OTHER = 512;

// Shared-memory floats of a padded f32 group of e values (one pad word
// every 32), room for the staged copies, rounded to 8 so the planes stay
// 16-byte aligned.
__host__ __device__ inline int padded_elems(int e) {
  const int a = e + e / 32 + 1, b = e + 8;  // b: + 2 copies of 4
  return ((a > b ? a : b) + 7) & ~7;
}

// Element idx of row t of a staged group: the stage planes (values of T
// at shared offsets sr, si, unpadded, from soff) on the first pass, the
// padded f32 work planes (wr, wi) after it; the last pass stores to the
// group's output rows.  Butterflies run along a row (consecutive threads on
// consecutive j), then over rows.
template <typename T>
struct RowIO {
  float* gr;
  float* gi;
  int sr, si, wr, wi, soff, n, pt;
  bool from_stage, to_global;

  __device__ __forceinline__ int pass_table() const { return pt; }

  __device__ __forceinline__ void set_pass(bool first, bool last) {
    from_stage = first;
    to_global = last;
  }
  __device__ __forceinline__ void round(int, int) {}

  __device__ __forceinline__ void map(int b, int L, int& t, int& j) const {
    t = b / L;
    j = b - t * L;
  }
  __device__ __forceinline__ void map_out(int o, int L, int& t, int& j,
                                          int& r) const {
    t = o / n;
    const int rem = o - t * n;
    r = rem / L;
    j = rem - r * L;
  }
  __device__ __forceinline__ void ld(int t, int idx, float& a, float& b) const {
    const int e = t * n + idx;
    if (from_stage) {
      a = fft::smem_ld<T>(sr + soff + e);
      b = fft::smem_ld<T>(si + soff + e);
    } else {
      const int p = e + (e >> 5);
      a = fft::fft_smem[wr + p];
      b = fft::fft_smem[wi + p];
    }
  }
  __device__ __forceinline__ void st(int t, int idx, float a, float b) const {
    const int e = t * n + idx;
    if (to_global) {
      gr[e] = a;
      gi[e] = b;
    } else {
      const int p = e + (e >> 5);
      fft::fft_smem[wr + p] = a;
      fft::fft_smem[wi + p] = b;
    }
  }
};

// Shared memory of the FFT kernel: the root table and the passes'
// twiddle tables ((re, im) pairs, n rounded up to 4 each), `nstage` stage buffers (two planes each) and, for bf16 input, an
// f32 work buffer; f32 input works in place in its stage buffer.
__host__ __device__ inline size_t last_fft_smem(int n, int group_rows,
                                                int nstage, int esize,
                                                int* stage_elems,
                                                int* work_elems) {
  const int e = group_rows * n;
  const int pe = padded_elems(e);
  const int se = esize == 4 ? pe : ((e + 16) + 7) & ~7;  // + 2 copies of 8
  const int we = esize == 4 ? 0 : pe;
  if (stage_elems) *stage_elems = se;
  if (work_elems) *work_elems = we;
  const size_t n4 = (size_t)((n + 3) & ~3);
  return 4 * n4 * 4 + (size_t)nstage * 2 * se * esize + 2 * (size_t)we * 4;
}

// N > 0: n = N and the plan P are compile-time constants (the main paths'
// sizes); N = 0: both come from the arguments.  FT threads.
template <typename T, int N, class P, int FT>
__global__ void __launch_bounds__(FT, 512 / FT)
dft_last_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                    const float* __restrict__ tr, const float* __restrict__ ti,
                    float* __restrict__ o_r, float* __restrict__ o_i,
                    long long rows, int n_arg, int group_rows_arg,
                    fft::Plan plan, int nstage, int stage_elems,
                    int work_elems) {
  const int n = N ? N : n_arg;
  const int group_rows = N ? (FE / N > 0 ? FE / N : 1) : group_rows_arg;
  constexpr int V = 16 / sizeof(T);  // values of one 16-byte copy
  // Shared memory: the root table as (re, im) pairs at float2 offset 0,
  // the passes' twiddle tables at n4, the stage buffers from `stage`
  // (values of T), the work planes from `work` (floats).
  const int n4 = (n + 3) & ~3;
  const int stage = 4 * n4 * 4 / (int)sizeof(T);
  const int work = (4 * n4 * 4 + nstage * 2 * stage_elems * (int)sizeof(T)) / 4;
  T* smem_t = reinterpret_cast<T*>(fft::fft_smem);
  const int tid = threadIdx.x;

  for (int k = tid; k < n; k += FT) {
    fft::fft_smem[2 * k] = tr[k];
    fft::fft_smem[2 * k + 1] = ti[k];
  }
  fft::fill_pass_tables<FT>(plan, n, tr, ti, n4);
  const long long ngroups = (rows + group_rows - 1) / group_rows;
  const long long total = rows * n;

  // Stage group g into buffer s: 16-byte copies from the group's first
  // value aligned down; the copy that holds the tensor's last value reads
  // only up to it.
  auto issue = [&](long long g, int s) {
    const long long start = g * group_rows * (long long)n;
    const long long end = min(total, start + (long long)group_rows * n);
    const long long cbeg = start & ~(long long)(V - 1);
    const int nchunk = (int)((end - cbeg + V - 1) / V);
    T* dr = smem_t + stage + s * 2 * stage_elems;
    T* di = dr + stage_elems;
    for (int k = tid; k < nchunk; k += FT) {
      const long long c = cbeg + (long long)k * V;
      const int bytes = (int)min((long long)V, total - c) * (int)sizeof(T);
      fft::cp16(dr + k * V, xr + c, bytes);
      fft::cp16(di + k * V, xi + c, bytes);
    }
  };

  long long g = blockIdx.x;
  if (g < ngroups) issue(g, 0);
  fft::cp_commit();
  for (int it = 0; g < ngroups; g += gridDim.x, ++it) {
    const int s = nstage == 2 ? (it & 1) : 0;
    const long long gn = g + gridDim.x;
    if (nstage == 2) {
      if (gn < ngroups) issue(gn, s ^ 1);
      fft::cp_commit();
      fft::cp_wait_prev();
    } else {
      fft::cp_wait_all();
    }
    __syncthreads();

    const long long row0 = g * group_rows;
    const int grows = (int)min((long long)group_rows, rows - row0);
    const long long start = row0 * n;
    RowIO<T> io;
    io.sr = stage + s * 2 * stage_elems;
    io.si = io.sr + stage_elems;
    // f32 works in place in its stage buffer (T = float: the same offsets).
    io.wr = work_elems ? work : io.sr;
    io.wi = io.wr + (work_elems ? work_elems : stage_elems);
    io.gr = o_r + start;
    io.gi = o_i + start;
    io.soff = (int)(start & (V - 1));
    io.n = n;
    io.pt = n4;
    if constexpr (N > 0) {
      fft::static_plan<FT, FE / FT, N, 1>(io, grows, group_rows, 0, P());
    } else {
      fft::run_plan<FT, FE / FT>(io, n, plan, grows, grows, 0);
    }
    // Every pass ends in a barrier: the stage buffer is free again.
    if (nstage == 1) {
      if (gn < ngroups) issue(gn, 0);
      fft::cp_commit();
    }
  }
}

template <typename T, int N, class P, int FT>
cudaError_t launch_fft(const T* xr, const T* xi, const float* tr,
                       const float* ti, float* o_r, float* o_i, long long r,
                       int n, int group_rows, const fft::Plan& plan,
                       int nstage, int se, int we, size_t smem,
                       cudaStream_t s) {
  auto kernel = dft_last_fft_kernel<T, N, P, FT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FT, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (r + group_rows - 1) / group_rows;
  const long long slots = (long long)per_sm * sms;
  const long long grid = groups < slots ? groups : slots;
  kernel<<<(unsigned)grid, FT, smem, s>>>(xr, xi, tr, ti, o_r, o_i, r, n,
                                          group_rows, plan, nstage, se, we);
  return cudaGetLastError();
}

template <int... Rs>
bool is_plan(const fft::Plan& plan, fft::Radices<Rs...>) {
  const int want[] = {Rs...};
  if (plan.np != (int)sizeof...(Rs)) return false;
  for (int p = 0; p < plan.np; ++p) {
    if (plan.r[p] != want[p]) return false;
  }
  return true;
}

// The main paths' sizes with their plans compiled in: 1024 (0002, the
// search), 512 (the F-engine), 96 (6144's last level), 64 (route (a) at
// 2^13).  Any other plan runs the kernel that reads it at run time.
using P1024 = fft::Radices<16, 8, 8>;
using P512 = fft::Radices<8, 8, 8>;
using P96 = fft::Radices<8, 4, 3>;
using P64 = fft::Radices<8, 8>;

template <typename T>
cudaError_t last_fft(const void* xr_, const void* xi_, const void* wr,
                     const void* wi, void* o_r_, void* o_i_, long long r,
                     int n, const int* radices, int npass, int group_rows,
                     int nstage, long long smem_want, cudaStream_t s) {
  if (npass < 1 || npass > fft::MAX_PASSES || group_rows < 1 ||
      group_rows * n > FE || (nstage != 1 && nstage != 2) || n < 2) {
    return cudaErrorInvalidValue;
  }
  fft::Plan plan;
  plan.np = npass;
  long long prod = 1;
  for (int p = 0; p < npass; ++p) {
    plan.r[p] = radices[p];
    prod *= radices[p];
  }
  if (prod != n || group_rows != (FE / n > 0 ? FE / n : 1)) {
    return cudaErrorInvalidValue;
  }
  int se = 0, we = 0;
  const size_t smem = last_fft_smem(n, group_rows, nstage, sizeof(T), &se, &we);
  if ((long long)smem != smem_want) return cudaErrorInvalidValue;
  const T* xr = static_cast<const T*>(xr_);
  const T* xi = static_cast<const T*>(xi_);
  float* o_r = static_cast<float*>(o_r_);
  float* o_i = static_cast<float*>(o_i_);
  // Row 1 of W: the n-th roots of unity.
  const float* tr = static_cast<const float*>(wr) + n;
  const float* ti = static_cast<const float*>(wi) + n;
#define BLIT_LAST_STATIC(NN, PP, FT)                                      \
  if (n == NN && is_plan(plan, PP())) {                                   \
    return launch_fft<T, NN, PP, FT>(xr, xi, tr, ti, o_r, o_i, r, n,      \
                                     group_rows, plan, nstage, se, we,    \
                                     smem, s);                            \
  }
  BLIT_LAST_STATIC(1024, P1024, FT_POW2)
  BLIT_LAST_STATIC(512, P512, FT_POW2)
  BLIT_LAST_STATIC(96, P96, FT_OTHER)
  BLIT_LAST_STATIC(64, P64, FT_POW2)
#undef BLIT_LAST_STATIC
  return launch_fft<T, 0, fft::Radices<>, FT_OTHER>(
      xr, xi, tr, ti, o_r, o_i, r, n, group_rows, plan, nstage, se, we, smem,
      s);
}

// ---- dft_stage as an FFT down the columns -------------------------------

constexpr int SE = 4096;  // values one round of a column FFT's passes holds

// Shared memory of the column FFT: the root table ((re, im) pairs, n
// rounded up to 4), `nstage` stage buffers of two planes of n rows x ss
// values of T and, for bf16 input, two f32 work planes of n rows x ws;
// f32 works in place in its stage buffer (ws = ss).  A row holds its tc
// columns after the offset of the 16-byte copy that staged them (a row
// may start anywhere), so ss = tc + one copy.
__host__ __device__ inline size_t stage_fft_smem(int n, int tc, int nstage,
                                                 int esize, int* ss,
                                                 int* ws) {
  const int s = tc + 16 / esize;
  const int w = esize == 4 ? s : tc + 4;
  if (ss) *ss = s;
  if (ws) *ws = w;
  const size_t n4 = (size_t)((n + 3) & ~3);
  return 8 * n4 + (size_t)nstage * 2 * n * s * esize +
         (esize == 4 ? 0 : 2 * (size_t)n * w * 4);
}

// Element idx (a row) of transform t (a column of the tile) of a staged
// (n, tc) tile: the stage planes on the first pass (values of T at shared
// offsets sr, si, row stride ss, each row from its own offset in its first
// copy), the f32 work planes (wr, wi, row stride ws) after it; the last
// pass multiplies by the twiddle, if any, and stores row idx, column t of
// the tile to the output panel (row stride m), only the w columns that
// exist.  Butterfly b of a round takes column b % count: consecutive
// threads take consecutive columns, so loads, stores and the copies of a
// row are conflict-free and the global stores are coalesced along j.
// CNT > 0: the round is CNT columns, a compile-time constant.
template <typename T, int CNT>
struct ColIO {
  float* gr;
  float* gi;
  const float* twr;
  const float* twi;
  int sr, si, wr, wi, ss, ws, m, w, off0, offm, t0, count;
  bool from_stage, to_global;

  __device__ __forceinline__ int pass_table() const { return -1; }
  __device__ __forceinline__ void set_pass(bool first, bool last) {
    from_stage = first;
    to_global = last;
  }
  __device__ __forceinline__ void round(int first, int c) {
    t0 = first;
    count = c;
  }
  __device__ __forceinline__ int cnt() const { return CNT ? CNT : count; }
  __device__ __forceinline__ void map(int b, int, int& t, int& j) const {
    const int c = cnt();
    j = b / c;
    t = t0 + b - j * c;
  }
  __device__ __forceinline__ void map_out(int o, int L, int& t, int& j,
                                          int& r) const {
    const int c = cnt();
    const int rem = o / c;
    t = t0 + o - rem * c;
    r = rem / L;
    j = rem - r * L;
  }
  __device__ __forceinline__ void ld(int t, int idx, float& a, float& b) const {
    if (from_stage) {
      constexpr int V = 16 / sizeof(T);
      const int e = idx * ss + ((off0 + idx * offm) & (V - 1)) + t;
      a = fft::smem_ld<T>(sr + e);
      b = fft::smem_ld<T>(si + e);
    } else {
      a = fft::fft_smem[wr + idx * ws + t];
      b = fft::fft_smem[wi + idx * ws + t];
    }
  }
  __device__ __forceinline__ void st(int t, int idx, float a, float b) const {
    if (to_global) {
      if (t < w) {
        const size_t g = (size_t)idx * m + t;
        if (twr != nullptr) fft::cmul(a, b, __ldg(twr + g), __ldg(twi + g));
        gr[g] = a;
        gi[g] = b;
      }
    } else {
      fft::fft_smem[wr + idx * ws + t] = a;
      fft::fft_smem[wi + idx * ws + t] = b;
    }
  }
};

// dft_stage on (panels, n, m): a persistent block walks over tiles of n
// rows x tc columns of a panel (ceil(m / tc) a panel, the last ragged),
// stages the next tile with 16-byte cp.async copies while this one's
// passes run (two stage buffers where they fit), runs the n-point plan
// down every column and stores natural k order, times the twiddle.  N > 0:
// n, the plan P and the tile TC (one round) are compile-time constants;
// N = 0: they come from the arguments, a round being `pr` columns.  rr, ri:
// row 1 of W, the n-th roots.
template <typename T, int N, class P, int TC, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
dft_stage_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     const float* __restrict__ rr, const float* __restrict__ ri,
                     const float* __restrict__ twr,
                     const float* __restrict__ twi, float* __restrict__ o_r,
                     float* __restrict__ o_i, long long panels, int n_arg,
                     int m, int tc_arg, int pr, fft::Plan plan, int nstage,
                     int ss, int ws) {
  constexpr int V = 16 / sizeof(T);  // values of one 16-byte copy
  constexpr int MAXV = SE / NT;
  const int n = N ? N : n_arg;
  const int tc = TC ? TC : tc_arg;
  // Shared memory: the root table at float2 offset 0, the stage buffers
  // from `stage` (values of T), the work planes from `work` (floats).
  const int n4 = (n + 3) & ~3;
  const int se = n * ss;
  const int stage = 8 * n4 / (int)sizeof(T);
  const int work = (8 * n4 + nstage * 2 * se * (int)sizeof(T)) / 4;
  T* smem_t = reinterpret_cast<T*>(fft::fft_smem);
  const int tid = threadIdx.x;
  for (int k = tid; k < n; k += NT) {
    fft::fft_smem[2 * k] = rr[k];
    fft::fft_smem[2 * k + 1] = ri[k];
  }
  const int ntc = (m + tc - 1) / tc;
  const long long ntiles = panels * ntc;
  const long long pm = (long long)n * m;
  const long long total = panels * pm;
  const int offm = m & (V - 1);
  const int cpr = tc / V + 1;  // copies a row at most

  // Stage tile g into buffer s: each row's columns c0 .. c0+w from the
  // 16-byte copy that holds its first value (aligned down), the copy that
  // holds the tensor's last value reading only up to it.
  auto issue = [&](long long g, int s) {
    const long long panel = g / ntc;
    const int c0 = (int)(g - panel * ntc) * tc;
    const int w = min(tc, m - c0);
    const long long base = panel * pm + c0;
    const int off0 = (int)(base & (V - 1));
    T* dr = smem_t + stage + s * 2 * se;
    T* di = dr + se;
    for (int k = tid; k < n * cpr; k += NT) {
      const int row = k / cpr, q = k - row * cpr;
      const int off = (off0 + row * offm) & (V - 1);
      if (q * V < off + w) {
        const long long c = base + (long long)row * m - off + q * V;
        const int bytes = (int)min((long long)V, total - c) * (int)sizeof(T);
        fft::cp16(dr + row * ss + q * V, xr + c, bytes);
        fft::cp16(di + row * ss + q * V, xi + c, bytes);
      }
    }
  };

  long long g = blockIdx.x;
  if (g < ntiles) issue(g, 0);
  fft::cp_commit();
  for (int it = 0; g < ntiles; g += gridDim.x, ++it) {
    const int s = nstage == 2 ? (it & 1) : 0;
    const long long gn = g + gridDim.x;
    if (nstage == 2) {
      if (gn < ntiles) issue(gn, s ^ 1);
      fft::cp_commit();
      fft::cp_wait_prev();
    } else {
      fft::cp_wait_all();
    }
    __syncthreads();

    const long long panel = g / ntc;
    const int c0 = (int)(g - panel * ntc) * tc;
    ColIO<T, TC> io;
    io.sr = stage + s * 2 * se;
    io.si = io.sr + se;
    // f32 works in place in its stage buffer (T = float: the same offsets).
    io.wr = sizeof(T) == 4 ? io.sr : work;
    io.wi = sizeof(T) == 4 ? io.si : work + n * ws;
    io.ss = ss;
    io.ws = ws;
    io.m = m;
    io.w = min(tc, m - c0);
    io.off0 = (int)((panel * pm + c0) & (V - 1));
    io.offm = offm;
    io.gr = o_r + panel * pm + c0;
    io.gi = o_i + panel * pm + c0;
    io.twr = twr != nullptr ? twr + c0 : nullptr;
    io.twi = twi != nullptr ? twi + c0 : nullptr;
    if constexpr (N > 0) {
      fft::static_plan<NT, MAXV, N, 1>(io, TC, TC, 0, P());
    } else {
      fft::run_plan<NT, MAXV>(io, n, plan, tc, pr, 0);
    }
    // Every pass ends in a barrier: the stage buffer is free again.
    if (nstage == 1) {
      if (gn < ntiles) issue(gn, 0);
      fft::cp_commit();
    }
  }
}

template <typename T, int N, class P, int TC, int NT>
cudaError_t launch_stage_fft(const T* xr, const T* xi, const float* rr,
                             const float* ri, const float* twr,
                             const float* twi, float* o_r, float* o_i,
                             long long panels, int n, int m, int tc, int pr,
                             const fft::Plan& plan, int nstage, int ss, int ws,
                             size_t smem, cudaStream_t s) {
  auto kernel = dft_stage_fft_kernel<T, N, P, TC, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = panels * ((m + tc - 1) / tc);
  const long long slots = (long long)per_sm * sms;
  const long long grid = tiles < slots ? tiles : slots;
  kernel<<<(unsigned)grid, NT, smem, s>>>(xr, xi, rr, ri, twr, twi, o_r, o_i,
                                          panels, n, m, tc, pr, plan, nstage,
                                          ss, ws);
  return cudaGetLastError();
}

// The main paths' stages with their plans and tiles compiled in: n = 64
// (6144's first level), 128 (2^24's middle level, route (a) 2^20's
// (128, 64)), 6 (4098 = 6 x 683).  Any other n runs the kernel that reads
// its plan at run time.
using P128 = fft::Radices<16, 8>;
using P6 = fft::Radices<2, 3>;

template <typename T>
cudaError_t stage_fft(const void* xr_, const void* xi_, const void* wr,
                      const void* wi, const void* tr, const void* ti,
                      void* o_r_, void* o_i_, long long panels, int n, int m,
                      const int* radices, int npass, int tc, int pr,
                      int nstage, long long smem_want, cudaStream_t s) {
  if (npass < 1 || npass > fft::MAX_PASSES || n < 2 || n > SE || m < 1 ||
      tc < 8 || tc % 8 || pr < 1 || pr > tc || pr * n > SE ||
      (nstage != 1 && nstage != 2)) {
    return cudaErrorInvalidValue;
  }
  fft::Plan plan;
  plan.np = npass;
  long long prod = 1;
  for (int p = 0; p < npass; ++p) {
    plan.r[p] = radices[p];
    prod *= radices[p];
  }
  if (prod != n) return cudaErrorInvalidValue;
  int ss = 0, ws = 0;
  const size_t smem = stage_fft_smem(n, tc, nstage, sizeof(T), &ss, &ws);
  if ((long long)smem != smem_want) return cudaErrorInvalidValue;
  const T* xr = static_cast<const T*>(xr_);
  const T* xi = static_cast<const T*>(xi_);
  float* o_r = static_cast<float*>(o_r_);
  float* o_i = static_cast<float*>(o_i_);
  // Row 1 of W: the n-th roots of unity.
  const float* rr = static_cast<const float*>(wr) + n;
  const float* ri = static_cast<const float*>(wi) + n;
  const float* twr = static_cast<const float*>(tr);
  const float* twi = static_cast<const float*>(ti);
#define BLIT_STAGE_STATIC(NN, PP, TT, NT)                                    \
  if (n == NN && tc == TT && pr == TT && is_plan(plan, PP())) {             \
    return launch_stage_fft<T, NN, PP, TT, NT>(xr, xi, rr, ri, twr, twi,    \
                                               o_r, o_i, panels, n, m, tc,  \
                                               pr, plan, nstage, ss, ws,    \
                                               smem, s);                    \
  }
  BLIT_STAGE_STATIC(64, P64, 32, FT_POW2)
  BLIT_STAGE_STATIC(128, P128, 32, FT_POW2)
  BLIT_STAGE_STATIC(6, P6, 352, FT_OTHER)
#undef BLIT_STAGE_STATIC
  return launch_stage_fft<T, 0, fft::Radices<>, 0, FT_OTHER>(
      xr, xi, rr, ri, twr, twi, o_r, o_i, panels, n, m, tc, pr, plan, nstage,
      ss, ws, smem, s);
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

// design: 0 the FFT, 1 the tiled GEMM, 2 the row kernel (n = 8).
template <typename T>
cudaError_t last(const void* xr, const void* xi, const void* wr,
                 const void* wi, void* o_r, void* o_i, long long r, int n,
                 int design, const int* radices, int npass, int group_rows,
                 int nstage, long long smem, cudaStream_t s) {
  switch (design) {
    case 0:
      return last_fft<T>(xr, xi, wr, wi, o_r, o_i, r, n, radices, npass,
                         group_rows, nstage, smem, s);
    case 1:
      return cgemm<T, float, false>(xr, xi, wr, wi, nullptr, nullptr, o_r,
                                    o_i, 1, r, n, n, 0, 0, 0, s);
    case 2:
      if (n != 8) return cudaErrorInvalidValue;
      return last_rows<8, T>(xr, xi, wr, wi, o_r, o_i, r, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// design: 0 the column FFT (stage_fft), 1 the tiled GEMM.
template <typename T>
cudaError_t stage(const void* xr, const void* xi, const void* wr,
                  const void* wi, const void* tr, const void* ti, void* o_r,
                  void* o_i, long long b, int n, int m, int design,
                  const int* radices, int npass, int tc, int pr, int nstage,
                  long long smem, cudaStream_t s) {
  if (design == 0) {
    return stage_fft<T>(xr, xi, wr, wi, tr, ti, o_r, o_i, b, n, m, radices,
                        npass, tc, pr, nstage, smem, s);
  }
  if (design != 1) return cudaErrorInvalidValue;
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

// design: 0 the FFT over the plan `radices[0..npass)` in groups of
// `group_rows` rows, `nstage` stage buffers, `smem` bytes of shared memory
// (checked against this file's layout); 1 the tiled GEMM; 2 the row kernel
// (n = 8).
int dft_last_launch(const void* xr, const void* xi, const void* wr,
                    const void* wi, void* o_r, void* o_i, long long r, int n,
                    int bf16, int design, const int* radices, int npass,
                    int group_rows, int nstage, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? last<__nv_bfloat16>(xr, xi, wr, wi, o_r, o_i, r, n, design,
                                 radices, npass, group_rows, nstage, smem, s)
           : last<float>(xr, xi, wr, wi, o_r, o_i, r, n, design, radices,
                         npass, group_rows, nstage, smem, s);
  return (int)err;
}

// tr/ti may be null: no twiddle.  design: 0 the column FFT over the plan
// `radices[0..npass)` on tiles of `tc` columns, `pr` columns a round,
// `nstage` stage buffers, `smem` bytes of shared memory (checked against
// this file's layout); 1 the tiled GEMM (the FFT arguments unread).
int dft_stage_launch(const void* xr, const void* xi, const void* wr,
                     const void* wi, const void* tr, const void* ti, void* o_r,
                     void* o_i, long long b, int n, int m, int bf16,
                     int design, const int* radices, int npass, int tc, int pr,
                     int nstage, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? stage<__nv_bfloat16>(xr, xi, wr, wi, tr, ti, o_r, o_i, b, n, m,
                                  design, radices, npass, tc, pr, nstage,
                                  smem, s)
           : stage<float>(xr, xi, wr, wi, tr, ti, o_r, o_i, b, n, m, design,
                          radices, npass, tc, pr, nstage, smem, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
