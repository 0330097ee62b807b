// pfb_dft1.cu — fused int8 dequant + polyphase FIR + DFT stage 1 + twiddle.
//
// Replaces the TPU kernel blit/ops/pallas_pfb.py:pfb_dft1 (body
// _fused1_kernel) with the same contract:
//   in : int8 voltages (nchan, ntime, 2 pol, 2 re/im), ntime = nblk*nfft
//        f32 sign-folded window (ntap, nfft)
//        the n1-point DFT matrix (passed as its row 1: W[k,j] depends only
//        on (k*j) mod n1, so W[k,j] == W[1, (k*j) mod n1] bitwise)
//        f32 stage-1 twiddles (n1, nfft/n1)
//   out: (ur, ui), each (nchan, 2, nframes, n1, nfft/n1), f32 or bf16.
// Sample j of a frame is viewed as (j1, j2) with j = j1*m + j2, m = nfft/n1,
// and out[k1, j2] = tw[k1, j2] * sum_j1 W[k1, j1] * fir[j1, j2].
//
// What bounds it on an H100: its bytes.  Each int8 sample is read once (4
// bytes for both pols) and each output written once (8 bytes f32, 4 bf16
// for re and im): at the 0000 shape 1.9 GB in and 4.3 GB out, 1.85 ms at
// 3.35 TB/s.  As an FFT the n1-point DFT costs 5*log2(n1) flops an output
// (35 at n1 = 128), far under the bytes; the contract's dense product
// (8*n1 = 1024 flops an output) would take 8.4 ms of f32 arithmetic.
// Design (building blocks in fft_smem.cuh):
//   - a persistent block walks over tiles of (coarse channel, group of up
//     to FG frames, TC columns j2); it stages the tile's int8 rows, all
//     nb = frames + ntap - 1 blocks of n1 rows x TC samples, and the
//     window's ntap rows of the same columns with cp.async copies (16
//     bytes where the rows allow, else 4), the next tile's copies in
//     flight while this tile's FFT runs (one stage buffer: they are
//     issued once the FIR has read it; two where they fit);
//   - the FIR converts each staged sample once (a byte permute and an
//     add, exact; with the main paths' 4 taps compiled in, every tap's
//     weight in a register), sums all taps of the group's frames in
//     registers (f32 FMAs, taps in order; bf16 rounds the sum, as
//     _fused1_kernel does) and writes the tile of FIR outputs, FG frames
//     x 2 pols x n1 rows x TC columns, to shared memory, panels padded so
//     that the two panels a warp touches fall in other banks;
//   - the n1-point transform runs down every column of every panel with
//     fft_smem.cuh's Stockham passes (plan ops/dft.py fft_plan(n1); 128 =
//     16 x 8 and 64 = 8 x 8 compiled in, any other n1 read at run time,
//     each pass a function of its own), roots indexed in
//     the row of W the wrapper passes, in f32 for both dtypes; consecutive
//     threads take consecutive columns, so passes are conflict-free;
//   - the last pass multiplies the twiddle and stores natural k1 order,
//     coalesced along j2, only the columns that exist (a ragged last
//     column tile is masked);
//   - bf16: the FIR sum is rounded to bf16 as the contract does, the FFT
//     runs in f32 on it and the result is stored as bf16.  The contract's
//     dense product also rounds W to bf16; an FFT cannot, so the bf16
//     output differs from the contract by that rounding (relative rms
//     about 1e-3) and equals, up to f32 summation order, the FFT of the
//     bf16 FIR output with f32 roots.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace {

constexpr int NT = 512;          // threads per block
constexpr int MAXV = 16;         // complex values a thread holds in a pass
constexpr int SE = NT * MAXV;    // values one round of a pass covers
constexpr int FG = 4;            // frames of a tile, at most

__device__ __forceinline__ float rbf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Byte k of u ^ 0x80808080 (an int8 sample + 128) as the sample in f32,
// exactly: 0x4B0000bb is the float 2^23 + bb.  sel = 0x7540 + k.
__device__ __forceinline__ float s8(unsigned u, unsigned sel) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 bytes global -> shared, asynchronously; 0 bytes fill with zeros.
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Floats of one padded panel of the FIR tile: n1 rows x tc columns, rounded
// up to a bank row, plus tc, so that panels p and p+1 of a warp's columns
// fall in other banks.
__host__ __device__ inline int panel_floats(int n1, int tc) {
  return ((n1 * tc + 31) & ~31) + tc;
}

// Shared memory of a launch: the root table ((re, im) pairs, n1 rounded up
// to 2), the FIR tile (two planes of fg*2 panels) and `nstage` stage
// buffers, each nb = fg + ntap - 1 blocks of n1 rows x tc int8 samples
// (char4) and then the ntap rows x tc window values (f32) of the tile.
__host__ __device__ inline size_t pfb_smem(int n1, int tc, int fg, int ntap,
                                           int nstage) {
  return 8 * (size_t)((n1 + 1) & ~1) +
         2 * (size_t)fg * 2 * panel_floats(n1, tc) * 4 +
         (size_t)nstage * (fg + 2 * ntap - 1) * n1 * tc * 4;
}

// Element idx (a row) of transform t of the FIR tile, t = (frame*2 + pol)*tc
// + column: the f32 planes (re at wr, im plane floats further, panel stride
// ps, row stride tc).  The last pass multiplies by the twiddle and stores
// row idx of panel (frame, pol), column t % tc, to the output (only the w
// columns that exist).  Butterfly b of a round takes transform b % count:
// consecutive threads take consecutive columns.  TC > 0: tc at compile time.
template <typename TO, int TC>
struct FirIO {
  TO* gr;
  TO* gi;
  const float* twr;
  const float* twi;
  long long pstride, fstride;  // output pol and frame strides
  int wr, plane, ps, tc_arg, m, w, t0, count, sh;
  bool to_global;

  __device__ __forceinline__ int tc() const { return TC ? TC : tc_arg; }
  __device__ __forceinline__ int pass_table() const { return -1; }
  __device__ __forceinline__ void set_pass(bool, bool last) {
    to_global = last;
  }
  // A round of c transforms; sh = log2(c) where c is a power of two.
  __device__ __forceinline__ void round(int first, int c) {
    t0 = first;
    count = c;
    sh = c & (c - 1) ? -1 : __ffs(c) - 1;
  }
  __device__ __forceinline__ int div(int b) const {
    return sh >= 0 ? b >> sh : b / count;
  }
  __device__ __forceinline__ void map(int b, int, int& t, int& j) const {
    j = div(b);
    t = t0 + b - j * count;
  }
  __device__ __forceinline__ void map_out(int o, int L, int& t, int& j,
                                          int& r) const {
    const int rem = div(o);
    t = t0 + o - rem * count;
    r = rem / L;
    j = rem - r * L;
  }
  __device__ __forceinline__ int off(int t, int idx) const {
    const int fp = t / tc();
    return wr + fp * ps + idx * tc() + (t - fp * tc());
  }
  __device__ __forceinline__ void ld(int t, int idx, float& a, float& b) const {
    const int o = off(t, idx);
    a = fft::fft_smem[o];
    b = fft::fft_smem[o + plane];
  }
  __device__ __forceinline__ void st(int t, int idx, float a, float b) const {
    if (to_global) {
      const int fp = t / tc(), col = t - fp * tc();
      if (col < w) {
        const long long g = (long long)idx * m + col;
        fft::cmul(a, b, __ldg(twr + g), __ldg(twi + g));
        const long long o = (fp & 1) * pstride + (fp >> 1) * fstride + g;
        put(gr + o, a);
        put(gi + o, b);
      }
    } else {
      const int o = off(t, idx);
      fft::fft_smem[o] = a;
      fft::fft_smem[o + plane] = b;
    }
  }
};

// N > 0: n1, its plan P and the tile width TC are compile-time constants;
// N = 0: they come from the arguments.  KT > 0: ntap = KT, the FIR's loops
// unrolled (each sample converted once, every tap's weight in a register);
// KT = 0: ntap from the arguments.  vec: rows start on 16-byte boundaries
// (m % 4 == 0 and aligned tensors), so 16-byte copies.
template <typename TO, int N, class P, int TC, int KT>
__global__ void __launch_bounds__(NT, 1)
pfb_dft1_kernel(const char4* __restrict__ v, const float* __restrict__ coeffs,
                const float* __restrict__ rr, const float* __restrict__ ri,
                const float* __restrict__ twr, const float* __restrict__ twi,
                TO* __restrict__ out_r, TO* __restrict__ out_i, int nchan,
                int n1_arg, int m, int ntap, int nblk, int nframes,
                int tc_arg, int fg, int per_round, fft::Plan plan, int nstage,
                int vec) {
  const int n1 = N ? N : n1_arg;
  const int tc = TC ? TC : tc_arg;
  const long long nfft = (long long)n1 * m;
  const int nbmax = fg + ntap - 1;
  const int ps = panel_floats(n1, tc);
  // Shared memory: the roots at float2 offset 0, the FIR tile's planes
  // from `work` (floats), the stage buffers from `stage` (4-byte values:
  // char4 samples, then the window's floats from cw).
  const int work = 2 * ((n1 + 1) & ~1);
  const int plane = fg * 2 * ps;
  const int stage = work + 2 * plane;  // a char4 is one float's size
  const int cw = nbmax * n1 * tc;      // the window rows of a stage buffer
  const int sb = cw + ntap * n1 * tc;  // 4-byte values of a stage buffer
  char4* smem_c = reinterpret_cast<char4*>(fft::fft_smem);
  const int tid = threadIdx.x;
  for (int k = tid; k < n1; k += NT) {
    fft::fft_smem[2 * k] = rr[k];
    fft::fft_smem[2 * k + 1] = ri[k];
  }
  const int nct = (m + tc - 1) / tc;
  const int nfg = (nframes + fg - 1) / fg;
  const long long ntiles = (long long)nchan * nfg * nct;

  // Tile g: channel, frame group, column tile (columns fastest, so blocks
  // in flight together write neighbouring columns).
  auto decode = [&](long long g, int& c, int& f0, int& c0) {
    const long long cf = g / nct;
    c0 = (int)(g - cf * nct) * tc;
    c = (int)(cf / nfg);
    f0 = (int)(cf - (long long)c * nfg) * fg;
  };
  // Stage tile g into buffer s: blocks f0 .. f0+nb of rows 0 .. n1, columns
  // c0 .. c0+tc, then the window's rows (tap k, row j1) of the same
  // columns; columns past m read as zeros.  Row r of the copy is int8 row
  // r < nb*n1, else window row r - nb*n1 (stored from cw).
  auto issue = [&](long long g, int s) {
    int c, f0, c0;
    decode(g, c, f0, c0);
    const int nb = min(fg, nframes - f0) + ntap - 1;
    const char4* src = v + (long long)c * nblk * nfft + (long long)f0 * nfft + c0;
    char4* dst = smem_c + stage + s * sb;
    const int rows = (nb + ntap) * n1;
    auto row_at = [&](int row, int col, void*& d) -> const void* {
      if (row < nb * n1) {
        const int bi = row / n1, j1 = row - bi * n1;
        d = dst + row * tc + col;
        return src + bi * nfft + (long long)j1 * m + col;
      }
      const int r = row - nb * n1;  // k * n1 + j1
      d = dst + cw + r * tc + col;
      const int k = r / n1, j1 = r - k * n1;
      return coeffs + k * nfft + (long long)j1 * m + c0 + col;
    };
    if (vec) {
      const int q4 = tc / 4;
      for (int k = tid; k < rows * q4; k += NT) {
        const int row = k / q4, q = k - row * q4;
        const bool ok = c0 + 4 * q < m;
        void* d;
        const void* src4 = row_at(row, ok ? 4 * q : 0, d);
        if (!ok) d = static_cast<char4*>(d) + 4 * q;
        fft::cp16(d, src4, ok ? 16 : 0);
      }
    } else {
      for (int k = tid; k < rows * tc; k += NT) {
        const int row = k / tc, col = k - row * tc;
        const bool ok = c0 + col < m;
        void* d;
        const void* src1 = row_at(row, ok ? col : 0, d);
        if (!ok) d = static_cast<char4*>(d) + col;
        cp4(d, src1, ok ? 4 : 0);
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

    int c, f0, c0;
    decode(g, c, f0, c0);
    const int nf = min(fg, nframes - f0);
    // FIR: every (row, column) of the tile, all taps of the group's frames.
    const unsigned* su =
        reinterpret_cast<const unsigned*>(fft::fft_smem + stage + s * sb);
    const float* wt = fft::fft_smem + stage + s * sb + cw;
    for (int e = tid; e < n1 * tc; e += NT) {
      const int j1 = e / tc, col = e - j1 * tc;
      const int at = j1 * tc + col;  // (row, column) in a block of the stage
      float acc[FG][4];
#pragma unroll
      for (int f = 0; f < FG; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;
      // Frame f sums tap k of block f + k, taps in increasing order.
      auto tap = [&](int f, float w, const float* x) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][q] = fmaf(w, x[q], acc[f][q]);
      };
      auto load = [&](int bi, float* x) {
        const unsigned u = su[bi * n1 * tc + at] ^ 0x80808080u;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = s8(u, 0x7540u + q);
      };
      if constexpr (KT > 0) {
        float w[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) w[k] = wt[k * n1 * tc + at];
#pragma unroll
        for (int bi = 0; bi < FG + KT - 1; ++bi) {
          if (bi < nf + KT - 1) {
            float x[4];
            load(bi, x);
#pragma unroll
            for (int f = 0; f < FG; ++f) {
              if (bi - f >= 0 && bi - f < KT && f < nf) tap(f, w[bi - f], x);
            }
          }
        }
      } else {
        for (int k = 0; k < ntap; ++k) {
          const float w = wt[k * n1 * tc + at];
#pragma unroll
          for (int f = 0; f < FG; ++f) {
            if (f < nf) {
              float x[4];
              load(f + k, x);
              tap(f, w, x);
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < FG; ++f) {
        if (f < nf) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {  // char4: pol 0 re, im, pol 1 re, im
            float a = acc[f][2 * p], b = acc[f][2 * p + 1];
            if (sizeof(TO) == 2) {
              a = rbf16(a);
              b = rbf16(b);
            }
            const int o = work + (f * 2 + p) * ps + j1 * tc + col;
            fft::fft_smem[o] = a;
            fft::fft_smem[o + plane] = b;
          }
        }
      }
    }
    __syncthreads();
    // The stage buffer is read: the next tile's copies may land in it.
    if (nstage == 1) {
      if (gn < ntiles) issue(gn, 0);
      fft::cp_commit();
    }

    FirIO<TO, TC> io;
    io.wr = work;
    io.plane = plane;
    io.ps = ps;
    io.tc_arg = tc;
    io.m = m;
    io.w = min(tc, m - c0);
    io.pstride = (long long)nframes * nfft;
    io.fstride = nfft;
    const long long obase = ((long long)c * 2 * nframes + f0) * nfft + c0;
    io.gr = out_r + obase;
    io.gi = out_i + obase;
    io.twr = twr + c0;
    io.twi = twi + c0;
    const int count = nf * 2 * tc;
    if constexpr (N > 0) {
      fft::static_plan<NT, MAXV, N, 1>(io, count, per_round, 0, P());
    } else {
      fft::run_plan<NT, MAXV>(io, n1, plan, count, per_round, 0);
    }
    // Every pass ends in a barrier: the FIR tile is free again.
  }
}

template <typename TO, int N, class P, int TC, int KT>
cudaError_t launch_kernel(const void* v, const float* coeffs, const float* rr,
                          const float* ri, const float* twr, const float* twi,
                          void* out_r, void* out_i, int nchan, int n1, int m,
                          int ntap, int nblk, int nframes, int tc, int fg,
                          int per_round, const fft::Plan& plan, int nstage,
                          int vec, size_t smem, cudaStream_t s) {
  auto kernel = pfb_dft1_kernel<TO, N, P, TC, KT>;
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
  const long long tiles = (long long)nchan * ((nframes + fg - 1) / fg) *
                          ((m + tc - 1) / tc);
  const long long slots = (long long)per_sm * sms;
  const long long grid = tiles < slots ? tiles : slots;
  kernel<<<(unsigned)grid, NT, smem, s>>>(
      static_cast<const char4*>(v), coeffs, rr, ri, twr, twi,
      static_cast<TO*>(out_r), static_cast<TO*>(out_i), nchan, n1, m, ntap,
      nblk, nframes, tc, fg, per_round, plan, nstage, vec);
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

// The main paths' n1 with 4 taps have their plan, tile and taps compiled
// in: 128 (0000, 2^21, the hi-res search) and 64 (6144); any other n1 runs
// the kernel that reads them (with 4 taps compiled in, or any).
using P128 = fft::Radices<16, 8>;
using P64 = fft::Radices<8, 8>;

template <typename TO>
cudaError_t launch(const void* v, const void* coeffs, const void* w1r_row,
                   const void* w1i_row, const void* tr, const void* ti,
                   void* out_r, void* out_i, int nchan, int n1, int m,
                   int ntap, int nblk, int nframes, const int* radices,
                   int npass, int tc, int fg, int per_round, int nstage,
                   int vec, long long smem_want, cudaStream_t s) {
  if (npass < 1 || npass > fft::MAX_PASSES || n1 < 2 || n1 > SE || m < 1 ||
      ntap < 1 || nframes < 1 || nblk != nframes + ntap - 1 || tc < 4 ||
      tc % 4 || fg < 1 || fg > FG || per_round < 1 || per_round * n1 > SE ||
      (nstage != 1 && nstage != 2) || (vec && m % 4)) {
    return cudaErrorInvalidValue;
  }
  fft::Plan plan;
  plan.np = npass;
  long long prod = 1;
  for (int p = 0; p < npass; ++p) {
    plan.r[p] = radices[p];
    prod *= radices[p];
  }
  if (prod != n1) return cudaErrorInvalidValue;
  const size_t smem = pfb_smem(n1, tc, fg, ntap, nstage);
  if ((long long)smem != smem_want) return cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coeffs);
  const float* rr = static_cast<const float*>(w1r_row);
  const float* ri = static_cast<const float*>(w1i_row);
  const float* twr = static_cast<const float*>(tr);
  const float* twi = static_cast<const float*>(ti);
  if (n1 == 128 && tc == 16 && ntap == 4 && is_plan(plan, P128())) {
    return launch_kernel<TO, 128, P128, 16, 4>(
        v, c, rr, ri, twr, twi, out_r, out_i, nchan, n1, m, ntap, nblk,
        nframes, tc, fg, per_round, plan, nstage, vec, smem, s);
  }
  if (n1 == 64 && tc == 16 && ntap == 4 && is_plan(plan, P64())) {
    return launch_kernel<TO, 64, P64, 16, 4>(
        v, c, rr, ri, twr, twi, out_r, out_i, nchan, n1, m, ntap, nblk,
        nframes, tc, fg, per_round, plan, nstage, vec, smem, s);
  }
  if (ntap == 4) {
    return launch_kernel<TO, 0, fft::Radices<>, 0, 4>(
        v, c, rr, ri, twr, twi, out_r, out_i, nchan, n1, m, ntap, nblk,
        nframes, tc, fg, per_round, plan, nstage, vec, smem, s);
  }
  return launch_kernel<TO, 0, fft::Radices<>, 0, 0>(
      v, c, rr, ri, twr, twi, out_r, out_i, nchan, n1, m, ntap, nblk, nframes,
      tc, fg, per_round, plan, nstage, vec, smem, s);
}

}  // namespace

extern "C" {

// Shared memory of a launch (the layout the kernel uses), for the Python
// geometry to check against.
long long pfb_dft1_smem_bytes(int n1, int tc, int fg, int ntap, int nstage) {
  return (long long)pfb_smem(n1, tc, fg, ntap, nstage);
}

// radices: the plan of n1 (npass passes); tc columns and fg frames a tile,
// per_round columns of a pass round, nstage stage buffers, smem bytes
// (checked against this file's layout); vec: 16-byte copies.
int pfb_dft1_launch(const void* v, const void* coeffs, const void* w1r_row,
                    const void* w1i_row, const void* tr, const void* ti,
                    void* out_r, void* out_i, int nchan, int n1, int m,
                    int ntap, int nblk, int nframes, const int* radices,
                    int npass, int tc, int fg, int per_round, int nstage,
                    int vec, long long smem, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(v, coeffs, w1r_row, w1i_row, tr, ti, out_r,
                                   out_i, nchan, n1, m, ntap, nblk, nframes,
                                   radices, npass, tc, fg, per_round, nstage,
                                   vec, smem, s)
           : launch<float>(v, coeffs, w1r_row, w1i_row, tr, ti, out_r, out_i,
                           nchan, n1, m, ntap, nblk, nframes, radices, npass,
                           tc, fg, per_round, nstage, vec, smem, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
