// detect_untwist.cu — Stokes-I detection of twisted DFT spectra, written
// in natural frequency order.
//
// Replaces the TPU kernel blit/ops/pallas_detect.py:detect_untwist_i (body
// _detect_kernel) with its contract:
//   in : twisted planar spectra (sr, si), each (nchan, npol, nframes, n),
//        f32 or bf16, npol 1 or 2, n = f1 * mid * flast (the layout of
//        dft(order="twisted") over at most three factors: the digits
//        (k1, kmid, klast) row-major; one factor is f1 = n, mid = flast = 1);
//   out: f32 (nchan, nframes, n), p = sum over pols of re^2 + im^2, at the
//        natural index k = k1 + f1*kmid + f1*mid*klast, i.e. (flast, mid,
//        f1) row-major (axis reversal, blit/ops/dft.py:untwist).
// Each output is (re0*re0 + im0*im0) + (re1*re1 + im1*im1), rounded after
// every operation (no contraction into FMAs), as the plain version
// detect_untwist_i_plain computes it.
//
// What bounds it on an H100: it moves bytes and does 7 flops per output.
// At the 0000 chunk, (64, 2, 4, 2^20) f32 twisted spectra in two planes:
// 4.29 GB read and 1.07 GB written, 1.60 ms at 3.35 TB/s (bf16 input:
// 2.15 GB + 1.07 GB, 0.96 ms).  Design, for the bytes:
//   - for each (channel, frame, kmid) the function is a transpose of an
//     f1 x flast tile; a block takes a 32 x 32 piece of it;
//   - it reads along klast, contiguous in the input: the 32 lanes of a warp
//     load 32 neighbouring values, one 128-byte run of f32 (64 bytes of
//     bf16), from each of the four planes (two pols, re and im), and sum the
//     pols in registers, so the input is read once;
//   - the powers are staged in shared memory, padded to 33 columns so the
//     column reads of the write-back hit 32 different banks, and written
//     along k1, contiguous in the output: 128-byte runs again;
//   - ragged tiles (flast 4 in blit's tests, f1 < 32) are masked; offsets
//     are 64-bit (at 2^21 one plane holds 2^30 values), and blocks walk the
//     tiles with a grid-stride loop, so no grid limit binds;
//   - one factor (mid = flast = 1) has no transpose: untwist is the
//     identity, and a tile would hold one valid column, so a second kernel
//     sums the powers along each row, reads and writes both contiguous.
// No TMA, no vector loads wider than a value, no multi-tile pipeline: the
// first version is simple; where it lands against the bound is measured.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // k1 rows and klast columns of a tile
constexpr int ROWS = 8;   // thread rows: a block is TILE x ROWS threads

template <bool BF16>
__device__ __forceinline__ float ld(const void* p, long long i) {
  if (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  return static_cast<const float*>(p)[i];
}

template <bool BF16>
__device__ __forceinline__ float power(const void* sr, const void* si,
                                       long long i) {
  const float re = ld<BF16>(sr, i);
  const float im = ld<BF16>(si, i);
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

template <bool BF16>
__global__ void __launch_bounds__(TILE * ROWS)
detect_untwist_kernel(const void* __restrict__ sr, const void* __restrict__ si,
                      float* __restrict__ out, long long rows, int nframes,
                      int npol, int f1, int mid, int flast) {
  __shared__ float tile[TILE][TILE + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long n = (long long)f1 * mid * flast;
  const long long t1 = ((long long)f1 + TILE - 1) / TILE;
  const long long tl = ((long long)flast + TILE - 1) / TILE;
  const long long per_mid = t1 * tl;
  const long long per_row = per_mid * mid;
  const long long ntiles = rows * per_row;
  const long long plane = (long long)nframes * n;  // one pol of a channel
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long r = t / per_row;  // (channel, frame) output row
    long long rem = t - r * per_row;
    const long long kmid = rem / per_mid;
    rem -= kmid * per_mid;
    const long long k10 = (rem / tl) * TILE;
    const long long kl0 = (rem % tl) * TILE;
    const long long c = r / nframes;
    const long long f = r - c * nframes;
    const long long base = (c * npol * nframes + f) * n;  // pol 0's row

    // Read: lane tx walks klast, thread row ty walks k1.
    const long long kl = kl0 + tx;
#pragma unroll
    for (int j = 0; j < TILE / ROWS; ++j) {
      const long long k1 = k10 + ty + ROWS * j;
      float p = 0.0f;
      if (k1 < f1 && kl < flast) {
        const long long i = base + (k1 * mid + kmid) * flast + kl;
        p = power<BF16>(sr, si, i);
        if (npol == 2) {
          p = __fadd_rn(p, power<BF16>(sr, si, i + plane));
        }
      }
      tile[ty + ROWS * j][tx] = p;
    }
    __syncthreads();

    // Write: lane tx walks k1, thread row ty walks klast.
    const long long k1w = k10 + tx;
    const long long obase = r * n + kmid * f1 + k1w;
#pragma unroll
    for (int j = 0; j < TILE / ROWS; ++j) {
      const long long klw = kl0 + ty + ROWS * j;
      if (k1w < f1 && klw < flast) {
        out[obase + klw * f1 * mid] = tile[tx][ty + ROWS * j];
      }
    }
    __syncthreads();
  }
}

// One factor: out[r, k] = power of row r at k; thread i takes value i.
template <bool BF16>
__global__ void __launch_bounds__(256)
detect_rows_kernel(const void* __restrict__ sr, const void* __restrict__ si,
                   float* __restrict__ out, long long rows, int nframes,
                   int npol, long long n) {
  const long long total = rows * n;
  const long long plane = (long long)nframes * n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / n;
    const long long k = i - r * n;
    const long long c = r / nframes;
    const long long f = r - c * nframes;
    const long long j = (c * npol * nframes + f) * n + k;
    float p = power<BF16>(sr, si, j);
    if (npol == 2) {
      p = __fadd_rn(p, power<BF16>(sr, si, j + plane));
    }
    out[i] = p;
  }
}

}  // namespace

extern "C" {

int detect_untwist_launch(const void* sr, const void* si, void* out,
                          long long rows, int nframes, int npol, int f1,
                          int mid, int flast, int bf16, void* stream) {
  if (rows < 1 || nframes < 1 || rows % nframes || npol < 1 || npol > 2 ||
      f1 < 1 || mid < 1 || flast < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = rows * mid * (((long long)f1 + TILE - 1) / TILE) *
                           (((long long)flast + TILE - 1) / TILE);
  const unsigned grid =
      (unsigned)(ntiles < (long long)INT_MAX ? ntiles : (long long)INT_MAX);
  const dim3 block(TILE, ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mid == 1 && flast == 1) {
    const long long n = f1;
    const long long blocks = (rows * n + 255) / 256;
    const unsigned g =
        (unsigned)(blocks < (long long)INT_MAX ? blocks : (long long)INT_MAX);
    if (bf16) {
      detect_rows_kernel<true><<<g, 256, 0, s>>>(sr, si, o, rows, nframes,
                                                 npol, n);
    } else {
      detect_rows_kernel<false><<<g, 256, 0, s>>>(sr, si, o, rows, nframes,
                                                  npol, n);
    }
    return (int)cudaGetLastError();
  }
  if (bf16) {
    detect_untwist_kernel<true><<<grid, block, 0, s>>>(sr, si, o, rows,
                                                        nframes, npol, f1,
                                                        mid, flast);
  } else {
    detect_untwist_kernel<false><<<grid, block, 0, s>>>(sr, si, o, rows,
                                                         nframes, npol, f1,
                                                         mid, flast);
  }
  return (int)cudaGetLastError();
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
