// taylor_tree.cu — the Taylor-tree drift transform of one search window,
// for one drift sign or both.
//
// Replaces the TPU kernel blit/ops/pallas_dedoppler.py:taylor_tree (body
// _tree_kernel over _tree_stages) with the same contract:
//   in : f32 power x (T, F), time-major, T a power of two in 2..1024;
//   out: f32 (T, F) with row d the sum along the tree's drift-d path
//        anchored at t = 0, out[d, f] = sum_t x[t, f + shift(d, t)], reading
//        zeros past column F-1.  With both signs: f32 (2T-1, F), row i the
//        drift i-(T-1); the negative drifts are the same tree over the
//        frequency-reversed band, written back in natural column order.
//
// Bitwise equal to the plain version (blit_torch/ops/dedoppler.py:
// taylor_tree_plain) and to blit's reference: log2(T) stages, and at the
// stage that merges two blocks of Ls rows into one of 2Ls, row d of the
// merged block is
//     top[d>>1][f] + bot[d>>1][f + ((d+1)>>1)]
// — one f32 add per element per stage, nothing fused, nothing reassociated
// (the build uses no fast-math; an add alone never contracts into an FMA).
// A path's total shift is below T, so every value an output column below F
// reads lies below column F + T, where blit's zero-padded, rolled buffer
// holds zeros or in-band sums: reading zeros past F gives the same bits.
// Intermediate values at columns >= F are sums of such zeros, so every stage
// may read zeros there too.
//
// What bounds it on an H100: memory.  The function reads T*F*4 bytes and
// writes T*F*4 per sign against T*log2(T)*F adds, about one add per byte
// moved, far below the f32 rate.  The design keeps the stages out of
// device memory where a block can hold them:
//   - route "shared" (T <= 64): a block loads L = T rows x (W + L) columns
//     (W output columns and an L-column halo: a group's paths shift by < L,
//     so the halo is read from L2 by the neighbouring block) into shared
//     memory, runs every stage there, ping-ponging two buffers, and writes
//     its W columns once;
//   - route "shared+passes" (128 <= T <= 1024): the same kernel runs the
//     first six stages on each group of 64 rows (the tree's first stages
//     merge only rows of one group) into a scratch buffer, then one global
//     pass per remaining stage merges block pairs, thread per column and
//     row pair, each pass reading and writing the whole (T, F) once;
//   - both signs run in one launch per stage (blockIdx.z is the sign); the
//     negative sign reads the band reversed and its last stage writes
//     straight into rows T-2..0 of the (2T-1, F) output, reversed back, so
//     no flipped copy of the band or of the result is made.
// A block is 256 threads over a tile of L rows by 256 columns (W = 256 - L
// outputs and the halo), each thread one column: shared memory 2*L*256*4
// bytes (16 KB at L = 8, eight blocks per SM; 128 KB at L = 64, one).  The
// per-element instruction count is what bounds a shared-memory tree on
// this card: a first version that spread the tile's elements over threads
// in flat order, with a division, a modulo and 64-bit address arithmetic
// per element and stage, ran at 2-11x the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int SMEM_LOG_MAX = 6;  // stages run in shared memory: 64-row groups
constexpr int MAX_LOG = 10;      // T <= 1024 (blit's MAX_WINDOW)

// A block's tile: L rows by WH = 256 columns, one per thread: W output
// columns and an L-column halo.
template <int LOG>
struct Tile {
  static constexpr int L = 1 << LOG;
  static constexpr int WH = NTHREADS;
  static constexpr int W = WH - L;
  static constexpr int SMEM = 2 * L * WH * 4;
};

// Where a row of finished (or intermediate) drift sums goes.  Scratch holds
// (nsign, T, F) in logical columns (the negative sign's reversed order);
// the final output maps them back.
struct Store {
  float* p;
  long long F;
  int T;
  int row0;   // output row of drift 0, positive sign
  int is_final;  // 0: scratch layout
};

__device__ __forceinline__ void store(const Store& m, int sign, int d,
                                      long long g, float v) {
  if (!m.is_final) {
    m.p[((size_t)sign * m.T + d) * (size_t)m.F + g] = v;
  } else if (sign == 0) {
    m.p[(size_t)(m.row0 + d) * (size_t)m.F + g] = v;
  } else if (d > 0) {  // drift 0 of the negative sign is the positive's row
    m.p[(size_t)(m.T - 1 - d) * (size_t)m.F + (m.F - 1 - g)] = v;
  }
}

// The first LOG stages on group blockIdx.y (rows [y*L, (y+1)*L)) over
// output columns [x*W, (x+1)*W), sign blockIdx.z.  Thread c owns column c
// of the (L, WH) tile in every phase, so rows, stages and shifts are
// compile-time constants and an element costs two shared loads, an add and
// a shared store per stage.
template <int LOG>
__global__ void __launch_bounds__(NTHREADS)
tree_shared_kernel(const float* __restrict__ x, long long F, Store m) {
  using G = Tile<LOG>;
  constexpr int L = G::L, W = G::W, WH = G::WH;
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + L * WH;
  const int c = threadIdx.x;
  const long long g = (long long)blockIdx.x * W + c;  // logical column
  const int grp = blockIdx.y;
  const int sign = blockIdx.z;

  // All L loads of the column are issued before the first is stored.  The
  // negative sign reads the band reversed; past its edge the band is zero.
  float v[L];
  const bool in_band = g < F;
  const long long col = in_band ? (sign ? F - 1 - g : g) : 0;
  const float* src = x + (size_t)grp * L * (size_t)F + col;
#pragma unroll
  for (int r = 0; r < L; ++r) v[r] = in_band ? __ldg(src + (size_t)r * F) : 0.f;
#pragma unroll
  for (int r = 0; r < L; ++r) cur[r * WH + c] = v[r];
  __syncthreads();

#pragma unroll
  for (int ls = 0; ls < LOG; ++ls) {
    const int Ls = 1 << ls;
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const int b = r >> (ls + 1), d = r & (2 * Ls - 1);
      const int j = d >> 1, s = (d + 1) >> 1;
      const float top = cur[(2 * b * Ls + j) * WH + c];
      // Past the tile's halo only columns no output reads: zeros there.
      const float bot = c + s < WH ? cur[((2 * b + 1) * Ls + j) * WH + c + s] : 0.f;
      nxt[r * WH + c] = top + bot;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (c < W && in_band) {
#pragma unroll
    for (int r = 0; r < L; ++r) store(m, sign, grp * L + r, g, cur[r * WH + c]);
  }
}

// One stage from blocks of Ls rows to blocks of 2Ls: blockIdx.y is the row
// pair (merged block b, inherited row j), each thread one column.
__global__ void __launch_bounds__(NTHREADS)
tree_pass_kernel(const float* __restrict__ in, long long F, int Ls, Store m) {
  const long long f = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (f >= F) return;
  const int p = blockIdx.y, sign = blockIdx.z;
  const int b = p / Ls, j = p % Ls;
  const float* base = in + (size_t)sign * m.T * (size_t)F;
  const float* top = base + (size_t)(2 * b * Ls + j) * (size_t)F;
  const float* bot = base + (size_t)((2 * b + 1) * Ls + j) * (size_t)F;
  const float t = __ldg(top + f);
  const float u0 = f + j < F ? __ldg(bot + f + j) : 0.f;
  const float u1 = f + j + 1 < F ? __ldg(bot + f + j + 1) : 0.f;
  const int d = 2 * b * Ls + 2 * j;
  store(m, sign, d, f, t + u0);
  store(m, sign, d + 1, f, t + u1);
}

template <int LOG>
cudaError_t launch_shared(const float* x, int T, long long F, int nsign,
                          Store m, cudaStream_t s) {
  using G = Tile<LOG>;
  cudaError_t err = cudaFuncSetAttribute(
      tree_shared_kernel<LOG>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long nx = (F + G::W - 1) / G::W;
  if (nx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)nx, (unsigned)(T / G::L), (unsigned)nsign);
  tree_shared_kernel<LOG><<<grid, NTHREADS, G::SMEM, s>>>(x, F, m);
  return cudaGetLastError();
}

cudaError_t dispatch_shared(int log, const float* x, int T, long long F,
                            int nsign, Store m, cudaStream_t s) {
  switch (log) {
    case 1: return launch_shared<1>(x, T, F, nsign, m, s);
    case 2: return launch_shared<2>(x, T, F, nsign, m, s);
    case 3: return launch_shared<3>(x, T, F, nsign, m, s);
    case 4: return launch_shared<4>(x, T, F, nsign, m, s);
    case 5: return launch_shared<5>(x, T, F, nsign, m, s);
    case 6: return launch_shared<6>(x, T, F, nsign, m, s);
    default: return cudaErrorInvalidValue;
  }
}

int log2_window(int T) {
  if (T < 2 || (T & (T - 1))) return -1;
  int log = 0;
  while ((1 << log) < T) ++log;
  return log <= MAX_LOG ? log : -1;
}

}  // namespace

extern "C" {

// x: (T, F) f32; out: (T, F) (both = 0) or (2T-1, F) (both = 1);
// scratch: 2 * nsign * T * F floats when T > 64, else unused.  *launched
// gets the number of kernels launched: 1 (T <= 64) or 1 + log2(T) - 6.
int taylor_tree_launch(const void* x, void* out, void* scratch, int T,
                       long long F, int both, void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int log = log2_window(T);
  if (log < 0 || F < 1) return (int)cudaErrorInvalidValue;
  const int nsign = both ? 2 : 1;
  const Store fin{static_cast<float*>(out), F, T, both ? T - 1 : 0, 1};
  const float* in = static_cast<const float*>(x);
  if (log <= SMEM_LOG_MAX) {
    const cudaError_t err = dispatch_shared(log, in, T, F, nsign, fin, s);
    if (err == cudaSuccess) *launched = 1;
    return (int)err;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;

  float* buf[2] = {static_cast<float*>(scratch),
                   static_cast<float*>(scratch) + (size_t)nsign * T * (size_t)F};
  cudaError_t err = dispatch_shared(SMEM_LOG_MAX, in, T, F, nsign,
                                    Store{buf[0], F, T, 0, 0}, s);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  int src = 0;
  for (int ls = SMEM_LOG_MAX; ls < log; ++ls) {
    const Store m = ls + 1 == log ? fin : Store{buf[1 - src], F, T, 0, 0};
    dim3 grid((unsigned)((F + NTHREADS - 1) / NTHREADS), (unsigned)(T / 2),
              (unsigned)nsign);
    tree_pass_kernel<<<grid, NTHREADS, 0, s>>>(buf[src], F, 1 << ls, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    src = 1 - src;
  }
  return 0;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
