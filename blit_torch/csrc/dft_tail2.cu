// dft_tail2.cu — the last two DFT levels of a three-factor DFT and the
// inner untwist: natural-order sub-spectra, no detection.
//
// Replaces the TPU kernel blit/ops/pallas_dft.py:dft_tail2 (body
// _tail2_kernel) with the same contract:
//   in : x (b, f2*f3) planar, f32 or bf16 (widened to f32 as it is loaded):
//        one stage-1 row panel per batch element, index a*f3 + c;
//        row 1 of the f2-point DFT matrix W2 and row 1 of the f3-point W3
//        (W[k, a] == W[1, (k*a) mod n]), the (f2, f3) twiddles tw, all f32;
//   out: f32 (b, f3*f2), index k3*f2 + k2 (natural order within the panel):
//        u[k2,c]  = tw[k2,c] * sum_a W2[k2,a] x[a,c];
//        o[k3,k2] = sum_c u[k2,c] W3[c,k3].
// blit's level split and tables are kept; each level is computed as an
// FFT instead of the contract's dense product.
//
// What bounds it on an H100: its bytes.  As FFTs the two levels do
// 5*log2(f2*f3) flops per complex output (+ 6 for the twiddle) against 16
// bytes moved (f32 in and out): the 2^21 chunk (f2 = f3 = 128, 2^30
// outputs) moves 17.2 GB, 5.13 ms at 3.35 TB/s, while the dense products
// would take 33 ms of f32 arithmetic.  Design (building blocks in
// fft_smem.cuh):
//   - a block stages a tile of the (f2, f3) panel in shared memory with
//     16-byte cp.async copies, rows padded by 16 bytes, and runs the
//     column level (f2 points down each column: Stockham passes of the
//     plan ops/dft.py fft_plan(f2) gives, roots indexed in W2's row 1), the
//     twiddle on the way out of its last pass, then the row level (f3
//     points along each row, W3's row 1), in place; for f32 panels larger
//     than a round of a pass (2^21) the twiddle, which then no longer
//     stays in L1, is copied into shared memory a column round at a time
//     while the round's first pass runs;
//   - consecutive threads take consecutive columns in the column level,
//     and 8 rows x 4 butterflies in the row level: with the 4-float row
//     pad both read and write shared memory without bank conflicts, and
//     the row level's last pass stores k3*f2 + k2 as full 32-byte sectors,
//     so the untwist is folded into the store;
//   - m = f2*f3 <= 16384 (2^20's (128, 64), 2^21's (128, 128)): one tile
//     is the whole panel, read once and written once; a persistent block
//     walks over panels, double-buffered where two tiles fit in shared
//     memory (2^20), single-buffered at 2^21 (132 KB a tile);
//   - larger panels (2^22, 2^23: 256 and 512 KB) go through device memory
//     in two launches of the same kernel: the column level on tiles of
//     8192/f2 columns, the twiddled result written to a scratch panel,
//     then the row level on tiles of 8192/f3 rows.  This moves the panel
//     twice (a thread-block cluster holding it in distributed shared
//     memory would move it once, at the price of cross-SM exchanges; the
//     two-pass design keeps one kernel for every shape);
//   - f32 stays f32 on the CUDA cores (no TF32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace {

constexpr int NT = 512;        // threads per block
constexpr int MAXV = 16;       // complex values a thread holds in a pass
constexpr int RE = NT * MAXV;  // values one round of a pass covers

// Modes: both levels on whole panels, the column level to a scratch panel,
// the row level from it.
enum { BOTH = 0, COLS = 1, ROWS = 2 };

// Whether a launch stages the (f2, f3) twiddle through shared memory, a
// column round (f2 x RE/f2 values) at a time: whole f32 panels larger than
// a round, whose twiddle table does not stay in the L1 the panel leaves.
__host__ __device__ inline bool stages_twiddle(int mode, int f2, int f3,
                                               int esize) {
  return mode == BOTH && esize == 4 && f2 * f3 > RE;
}

// Row strides (stage, f32 work) and elements of a tile's buffers, and the
// shared memory of the kernel: the two root tables, `nstage` stage
// buffers of two planes, an f32 work buffer for bf16 input (f32 input
// works in place: its stage row stride is the work's), and the staged
// twiddle round (two planes of RE floats) where stages_twiddle.
__host__ __device__ inline size_t tail2_smem(int mode, int f2, int f3, int tr,
                                             int tc, int nstage, int esize,
                                             int* ss, int* ws, int* se,
                                             int* we) {
  const int s = tc + 16 / esize;
  const int w = tc + 4;
  if (ss) *ss = s;
  if (ws) *ws = w;
  if (se) *se = tr * s;
  if (we) *we = esize == 4 ? 0 : tr * w;
  return 2 * (size_t)(f2 + f3) * 4 + (size_t)nstage * 2 * tr * s * esize +
         (esize == 4 ? 0 : 2 * (size_t)tr * w * 4) +
         (stages_twiddle(mode, f2, f3, esize) ? 2 * (size_t)RE * 4 : 0);
}

// Element idx of transform t of a tile.  Column level: t a column, idx a
// row; row level: t a row, idx a column.  Loads come from the stage planes
// (values of T at shared offsets sr, si, row stride ss) on a level's first
// pass, else from the f32 work planes (wr, wi, row stride ws); `dst` sends
// the stores to the work planes (0), the work planes times the twiddle
// (1), device memory (2), device memory times the twiddle (3).  Lanes of
// a warp take `tg` transforms x 32/tg butterflies.
template <typename T>
struct PanelIO {
  float* gr;
  float* gi;
  const float* twr;
  const float* twi;
  int sr, si, wr, wi, ss, ws, gts, ges, tws;
  int count, t0, tg, dst, last_dst;
  int tw_s;  // shared offset of the staged twiddle round, or -1

  // The passes take their twiddles from the root tables.
  __device__ __forceinline__ int pass_table() const { return -1; }
  bool cols, from_stage, level_from_stage;

  // Set before a level: its first pass loads from the stage planes if
  // level_from_stage, its last stores to last_dst.
  __device__ __forceinline__ void set_pass(bool first, bool last) {
    from_stage = level_from_stage && first;
    dst = last ? last_dst : 0;
  }
  __device__ __forceinline__ void round(int first, int n) {
    t0 = first;
    count = n;
  }
  __device__ __forceinline__ void map(int b, int L, int& t, int& j) const {
    const int w = b >> 5, l = b & 31;
    const int nt = count / tg;
    t = t0 + (w % nt) * tg + l % tg;
    j = (w / nt) * (32 / tg) + l / tg;
  }
  __device__ __forceinline__ void map_out(int o, int L, int& t, int& j,
                                          int& r) const {
    t = t0 + o % count;
    const int rem = o / count;
    r = rem / L;
    j = rem - r * L;
  }
  __device__ __forceinline__ void ld(int t, int idx, float& a, float& b) const {
    const int row = cols ? idx : t, col = cols ? t : idx;
    if (from_stage) {
      a = fft::smem_ld<T>(sr + row * ss + col);
      b = fft::smem_ld<T>(si + row * ss + col);
    } else {
      a = fft::fft_smem[wr + row * ws + col];
      b = fft::fft_smem[wi + row * ws + col];
    }
  }
  __device__ __forceinline__ void st(int t, int idx, float a, float b) const {
    const int row = cols ? idx : t, col = cols ? t : idx;
    if (dst & 1) {
      if (tw_s >= 0) {  // row k2, column col - t0 of the staged round
        const int off = tw_s + row * count + (col - t0);
        fft::cmul(a, b, fft::fft_smem[off], fft::fft_smem[off + RE]);
      } else {
        fft::cmul(a, b, twr[row * tws + col], twi[row * tws + col]);
      }
    }
    if (dst & 2) {
      gr[(size_t)t * gts + (size_t)idx * ges] = a;
      gi[(size_t)t * gts + (size_t)idx * ges] = b;
    } else {
      fft::fft_smem[wr + row * ws + col] = a;
      fft::fft_smem[wi + row * ws + col] = b;
    }
  }
};

// F2 > 0: f2, f3, the tile (TR, TC) and the plans P2, P3 are compile-time
// constants (the main paths' shapes); F2 = 0: they come from the arguments.
template <typename T, int MODE, int F2, int F3, int TR, int TC, class P2,
          class P3>
__global__ void __launch_bounds__(NT, 1)
dft_tail2_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 const float* __restrict__ w2r_row,
                 const float* __restrict__ w2i_row,
                 const float* __restrict__ w3r_row,
                 const float* __restrict__ w3i_row,
                 const float* __restrict__ twr, const float* __restrict__ twi,
                 float* __restrict__ o_r, float* __restrict__ o_i,
                 long long b, int f2_arg, int f3_arg, int tr_arg, int tc_arg,
                 fft::Plan p2, fft::Plan p3, int nstage) {
  constexpr int V = 16 / sizeof(T);  // values of one 16-byte copy
  const int f2 = F2 ? F2 : f2_arg, f3 = F2 ? F3 : f3_arg;
  const int tr = F2 ? TR : tr_arg, tc = F2 ? TC : tc_arg;
  int ss, ws, se, we;
  tail2_smem(MODE, f2, f3, tr, tc, nstage, sizeof(T), &ss, &ws, &se, &we);
  const bool stw = stages_twiddle(MODE, f2, f3, sizeof(T));
  // Shared memory: W2's row and W3's row as (re, im) pairs at float2
  // offsets 0 and f2, the stage buffers from `stage` (values of T), the
  // work planes from `work` (floats).
  const int stage = 2 * (f2 + f3) * 4 / (int)sizeof(T);
  const int work = (2 * (f2 + f3) * 4 + nstage * 2 * se * (int)sizeof(T)) / 4;
  const int twst = work + 2 * we;  // the staged twiddle round (floats)
  T* smem_t = reinterpret_cast<T*>(fft::fft_smem);
  const int tid = threadIdx.x;
  for (int k = tid; k < f2; k += NT) {
    fft::fft_smem[2 * k] = w2r_row[k];
    fft::fft_smem[2 * k + 1] = w2i_row[k];
  }
  for (int k = tid; k < f3; k += NT) {
    fft::fft_smem[2 * (f2 + k)] = w3r_row[k];
    fft::fft_smem[2 * (f2 + k) + 1] = w3i_row[k];
  }
  const size_t m = (size_t)f2 * f3;
  const int nc = f3 / tc;
  const int tiles = (f2 / tr) * nc;
  const long long ngroups = b * tiles;
  const int cpr = tc / V;  // copies per tile row

  auto issue = [&](long long g, int s) {
    const long long panel = g / tiles;
    const int tile = (int)(g - panel * tiles);
    const int r0 = (tile / nc) * tr, c0 = (tile % nc) * tc;
    const T* pr = xr + panel * m + (size_t)r0 * f3 + c0;
    const T* pi = xi + panel * m + (size_t)r0 * f3 + c0;
    T* dr = smem_t + stage + s * 2 * se;
    T* di = dr + se;
    for (int k = tid; k < tr * cpr; k += NT) {
      const int a = k / cpr, v = (k - a * cpr) * V;
      fft::cp16(dr + a * ss + v, pr + (size_t)a * f3 + v, 16);
      fft::cp16(di + a * ss + v, pi + (size_t)a * f3 + v, 16);
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

    const long long panel = g / tiles;
    const int tile = (int)(g - panel * tiles);
    const int r0 = (tile / nc) * tr, c0 = (tile % nc) * tc;
    PanelIO<T> io;
    io.sr = stage + s * 2 * se;
    io.si = io.sr + se;
    // f32 works in place in its stage buffer (T = float: the same offsets).
    io.wr = we ? work : io.sr;
    io.wi = io.wr + (we ? we : se);
    io.ss = ss;
    io.ws = ws;
    io.tws = f3;
    io.twr = twr + c0;  // r0 = 0 where the column level runs
    io.twi = twi + c0;
    io.tw_s = -1;
    if constexpr (MODE != ROWS) {
      // Column level: tc columns of f2 points, the twiddle on the way out.
      const int per_round = min(tc, RE / f2);
      io.cols = true;
      io.tg = min(32, per_round);
      io.gr = o_r + panel * m + c0;  // COLS: the scratch panel, k2*f3 + c
      io.gi = o_i + panel * m + c0;
      io.gts = 1;
      io.ges = f3;
      io.level_from_stage = true;
      io.last_dst = MODE == BOTH ? 1 : 3;
      if (stw) {
        // A round at a time, all its passes: the round's twiddle columns
        // are copied into shared memory while its first passes run.
        io.tw_s = twst;
        auto wait_twiddle = [&]() {
          fft::cp_wait_all();
          __syncthreads();
        };
        for (int t0 = 0; t0 < tc; t0 += per_round) {
          const int cpr4 = per_round / 4;
          for (int k = tid; k < f2 * cpr4; k += NT) {
            const int row = k / cpr4, v = (k - row * cpr4) * 4;
            const size_t g = (size_t)row * f3 + t0 + v;
            fft::cp16(fft::fft_smem + twst + row * per_round + v, twr + c0 + g, 16);
            fft::cp16(fft::fft_smem + twst + RE + row * per_round + v, twi + c0 + g, 16);
          }
          fft::cp_commit();
          if constexpr (F2 > 0) {
            fft::static_round<NT, MAXV, F2, 1>(io, t0, per_round, 0,
                                               wait_twiddle, P2());
          } else {
            fft::run_round<NT, MAXV>(io, f2, p2, t0, per_round, 0,
                                     wait_twiddle);
          }
        }
        io.tw_s = -1;
      } else if constexpr (F2 > 0) {
        fft::static_plan<NT, MAXV, F2, 1>(io, TC, per_round, 0, P2());
      } else {
        fft::run_plan<NT, MAXV>(io, f2, p2, tc, per_round, 0);
      }
    }
    if constexpr (MODE != COLS) {
      // Row level: tr rows of f3 points, stored at k3*f2 + k2.
      io.cols = false;
      io.tg = 8;
      io.gr = o_r + panel * m + r0;
      io.gi = o_i + panel * m + r0;
      io.gts = 1;
      io.ges = f2;
      io.level_from_stage = MODE == ROWS;
      io.last_dst = 2;
      const int per_round = min(tr, RE / f3);
      if constexpr (F2 > 0) {
        fft::static_plan<NT, MAXV, F3, 1>(io, TR, per_round, f2, P3());
      } else {
        fft::run_plan<NT, MAXV>(io, f3, p3, tr, per_round, f2);
      }
    }
    // Every pass ends in a barrier: the stage buffer is free again.
    if (nstage == 1) {
      if (gn < ngroups) issue(gn, 0);
      fft::cp_commit();
    }
  }
}

bool to_plan(const int* radices, int npass, int n, fft::Plan* plan) {
  if (npass < 1 || npass > fft::MAX_PASSES) return false;
  plan->np = npass;
  long long prod = 1;
  for (int p = 0; p < npass; ++p) {
    const int r = radices[p];
    if (r != 2 && r != 4 && r != 8 && r != 16) return false;
    plan->r[p] = r;
    prod *= r;
  }
  return prod == n;
}

template <typename T, int MODE, int F2 = 0, int F3 = 0, int TR = 0, int TC = 0,
          class P2 = fft::Radices<>, class P3 = fft::Radices<>>
cudaError_t launch(const void* xr, const void* xi, const float* w2r_row,
                   const float* w2i_row, const float* w3r_row,
                   const float* w3i_row, const float* twr, const float* twi,
                   float* o_r, float* o_i, long long b, int f2, int f3, int tr,
                   int tc, const fft::Plan& p2, const fft::Plan& p3,
                   int nstage, long long smem_want, cudaStream_t s) {
  if (tr < 8 || tc < 8 || f2 % tr || f3 % tc || (nstage != 1 && nstage != 2) ||
      (MODE != ROWS && tr != f2) || (MODE != COLS && tc != f3)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = tail2_smem(MODE, f2, f3, tr, tc, nstage, sizeof(T),
                                 nullptr, nullptr, nullptr, nullptr);
  if ((long long)smem != smem_want) return cudaErrorInvalidValue;
  auto kernel = dft_tail2_kernel<T, MODE, F2, F3, TR, TC, P2, P3>;
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
  const long long groups = b * (f2 / tr) * (f3 / tc);
  const long long grid = groups < (long long)per_sm * sms ? groups : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, NT, smem, s>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi), w2r_row, w2i_row,
      w3r_row, w3i_row, twr, twi, o_r, o_i, b, f2, f3, tr, tc, p2, p3, nstage);
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

using R88 = fft::Radices<8, 8>;
using R168 = fft::Radices<16, 8>;
using R1616 = fft::Radices<16, 16>;
using R888 = fft::Radices<8, 8, 8>;

// One launch over whole panels (ct == f3, rt == f2), or two through the
// scratch panels ur/ui: the column level on tiles of ct columns, then the
// row level on tiles of rt rows.  The main paths' shapes (2^20 to 2^23 at
// f2 = 128) have their sizes and plans compiled in; any other shape runs
// the kernel that reads them at run time.
template <typename T>
cudaError_t run(const void* xr, const void* xi, const float* w2r_row,
                const float* w2i_row, const float* w3r_row,
                const float* w3i_row, const float* twr, const float* twi,
                float* o_r, float* o_i, float* ur, float* ui, long long b,
                int f2, int f3, const fft::Plan& p2, const fft::Plan& p3,
                int ct, int rt, int nstage_a, long long smem_a, int nstage_b,
                long long smem_b, cudaStream_t s) {
  const bool std2 = f2 == 128 && is_plan(p2, R168());
  if (ct == f3 && rt == f2) {
#define BLIT_BOTH(FF3, PP3)                                                   \
    if (std2 && f3 == FF3 && is_plan(p3, PP3())) {                            \
      return launch<T, BOTH, 128, FF3, 128, FF3, R168, PP3>(                  \
          xr, xi, w2r_row, w2i_row, w3r_row, w3i_row, twr, twi, o_r, o_i, b,  \
          f2, f3, f2, f3, p2, p3, nstage_a, smem_a, s);                       \
    }
    BLIT_BOTH(64, R88)
    BLIT_BOTH(128, R168)
#undef BLIT_BOTH
    return launch<T, BOTH>(xr, xi, w2r_row, w2i_row, w3r_row, w3i_row, twr,
                           twi, o_r, o_i, b, f2, f3, f2, f3, p2, p3, nstage_a,
                           smem_a, s);
  }
  if (ur == nullptr || ui == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  bool done = false;
#define BLIT_TWO(FF3, RR, PP3)                                                \
  if (!done && std2 && f3 == FF3 && ct == 64 && rt == RR &&                   \
      is_plan(p3, PP3())) {                                                   \
    err = launch<T, COLS, 128, FF3, 128, 64, R168, PP3>(                      \
        xr, xi, w2r_row, w2i_row, w3r_row, w3i_row, twr, twi, ur, ui, b, f2,  \
        f3, f2, ct, p2, p3, nstage_a, smem_a, s);                             \
    if (err == cudaSuccess) {                                                 \
      err = launch<float, ROWS, 128, FF3, RR, FF3, R168, PP3>(                \
          ur, ui, w2r_row, w2i_row, w3r_row, w3i_row, twr, twi, o_r, o_i, b,  \
          f2, f3, rt, f3, p2, p3, nstage_b, smem_b, s);                       \
    }                                                                         \
    done = true;                                                              \
  }
  BLIT_TWO(256, 32, R1616)
  BLIT_TWO(512, 16, R888)
#undef BLIT_TWO
  if (done) return err;
  err = launch<T, COLS>(xr, xi, w2r_row, w2i_row, w3r_row, w3i_row, twr, twi,
                        ur, ui, b, f2, f3, f2, ct, p2, p3, nstage_a, smem_a, s);
  if (err != cudaSuccess) return err;
  return launch<float, ROWS>(ur, ui, w2r_row, w2i_row, w3r_row, w3i_row, twr,
                             twi, o_r, o_i, b, f2, f3, rt, f3, p2, p3,
                             nstage_b, smem_b, s);
}

}  // namespace

extern "C" {

// Shared memory of a launch (mode 0 both levels, 1 the column level, 2
// the row level; the layout the kernel uses), for the Python geometry to
// check against.
long long dft_tail2_smem_bytes(int mode, int f2, int f3, int tr, int tc,
                               int nstage, int esize) {
  return (long long)tail2_smem(mode, f2, f3, tr, tc, nstage, esize, nullptr,
                               nullptr, nullptr, nullptr);
}

// r2/r3: the radix plans of f2 and f3 (n2, n3 passes).  ct == f3 and
// rt == f2: one launch; else two through ur/ui.  nstage/smem: of the
// (first) launch and of the row launch.
int dft_tail2_launch(const void* xr, const void* xi, const void* w2r_row,
                     const void* w2i_row, const void* w3r_row,
                     const void* w3i_row, const void* twr, const void* twi,
                     void* o_r, void* o_i, void* ur, void* ui, long long b,
                     int f2, int f3, const int* r2, int n2, const int* r3,
                     int n3, int ct, int rt, int nstage_a, long long smem_a,
                     int nstage_b, long long smem_b, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fft::Plan p2, p3;
  if (!to_plan(r2, n2, f2, &p2) || !to_plan(r3, n3, f3, &p3)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* a = static_cast<const float*>(w2r_row);
  const float* c = static_cast<const float*>(w2i_row);
  const float* d = static_cast<const float*>(w3r_row);
  const float* e = static_cast<const float*>(w3i_row);
  const float* tr = static_cast<const float*>(twr);
  const float* ti = static_cast<const float*>(twi);
  float* orr = static_cast<float*>(o_r);
  float* oi = static_cast<float*>(o_i);
  float* sr = static_cast<float*>(ur);
  float* si = static_cast<float*>(ui);
  cudaError_t err =
      bf16 ? run<__nv_bfloat16>(xr, xi, a, c, d, e, tr, ti, orr, oi, sr, si, b,
                                f2, f3, p2, p3, ct, rt, nstage_a, smem_a,
                                nstage_b, smem_b, s)
           : run<float>(xr, xi, a, c, d, e, tr, ti, orr, oi, sr, si, b, f2, f3,
                        p2, p3, ct, rt, nstage_a, smem_a, nstage_b, smem_b, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
