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
// What bounds it on an H100: the 128-point complex DFT costs 8*128 flops
// per output element against 8 (f32) or 4 (bf16) bytes stored, so at the
// 0000 shape the kernel does ~5.5e11 f32 flops for ~6.2 GB moved:
// 8.2 ms of f32 CUDA-core peak against 1.9 ms of HBM — it is bound by
// f32 arithmetic, not by memory.  The design therefore:
//   - reads each int8 sample once (as one char4: both pols, re and im) and
//     accumulates all taps of up to FG frames in registers, so the input is
//     read once per group of FG frames (once per chunk at chunk_frames=4);
//   - keeps the FIR output tile (n1 rows x TJ columns, all frames of the
//     group, both pols) in shared memory and never in device memory;
//   - keeps the DFT matrix as a 128-entry table in shared memory and runs
//     the 128x128 complex product on the CUDA cores in f32 (not TF32), each
//     thread owning a 4x4 register tile of outputs;
//   - in bf16 mode rounds where _fused1_kernel does: FIR sum -> bf16, DFT
//     with bf16 operands and f32 sums, twiddle in f32, store bf16.
// Tensor cores (wgmma), TMA and pipelining are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int N1 = 128;        // first DFT factor (the 0000 plan's)
constexpr int TJ = 16;         // j2 columns per block
constexpr int FG = 4;          // frames per input pass
constexpr int NTHREADS = 512;

__device__ __forceinline__ float rbf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ void store4(void* base, size_t off, float a,
                                       float b, float c, float d) {
  if (BF16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + off) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + off) =
        make_float4(a, b, c, d);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
pfb_dft1_kernel(const char4* __restrict__ v, const float* __restrict__ coeffs,
                const float* __restrict__ w1r_row,
                const float* __restrict__ w1i_row,
                const float* __restrict__ tr, const float* __restrict__ ti,
                void* __restrict__ out_r, void* __restrict__ out_i,
                int nfft, int ntap, int nblk, int nframes) {
  extern __shared__ float smem[];
  float* tab_r = smem;
  float* tab_i = smem + N1;
  float* xs = smem + 2 * N1;  // [FG][2 pol][2 re/im][N1][TJ]
  const int m = nfft / N1;
  const int c = blockIdx.y;
  const int j2_0 = blockIdx.x * TJ;
  const int tid = threadIdx.x;

  for (int i = tid; i < N1; i += NTHREADS) {
    const float a = w1r_row[i];
    const float b = w1i_row[i];
    tab_r[i] = BF16 ? rbf16(a) : a;
    tab_i[i] = BF16 ? rbf16(b) : b;
  }
  const char4* vc = v + (size_t)c * nblk * nfft;

  for (int f0 = 0; f0 < nframes; f0 += FG) {
    const int nfg = min(FG, nframes - f0);
    const int nb = nfg + ntap - 1;
    // Phase 1: dequant + FIR for every frame of the group, one read of
    // each sample.
    for (int e = tid; e < N1 * TJ; e += NTHREADS) {
      const int jj = e % TJ;
      const int j1 = e / TJ;
      const int j = j1 * m + j2_0 + jj;
      float acc[FG][4];
#pragma unroll
      for (int f = 0; f < FG; ++f) {
        acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;
      }
      for (int bi = 0; bi < nb; ++bi) {
        const char4 s = vc[(size_t)(f0 + bi) * nfft + j];
        const float x0 = s.x, x1 = s.y, x2 = s.z, x3 = s.w;
#pragma unroll
        for (int f = 0; f < FG; ++f) {
          const int k = bi - f;
          if (f < nfg && k >= 0 && k < ntap) {
            const float w = __ldg(coeffs + (size_t)k * nfft + j);
            acc[f][0] = fmaf(w, x0, acc[f][0]);
            acc[f][1] = fmaf(w, x1, acc[f][1]);
            acc[f][2] = fmaf(w, x2, acc[f][2]);
            acc[f][3] = fmaf(w, x3, acc[f][3]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < FG; ++f) {
        if (f < nfg) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // q = pol*2 + (re|im)
            const float val = BF16 ? rbf16(acc[f][q]) : acc[f][q];
            xs[((f * 4 + q) * N1 + j1) * TJ + jj] = val;
          }
        }
      }
    }
    __syncthreads();

    // Phase 2: 128-point complex DFT down j1, twiddle, store.  Four
    // groups of 128 threads each take one (frame, pol) at a time; a
    // thread owns rows k = kq + 32*i (i < 4) and columns jq*4 .. jq*4+3.
    const int grp = tid / 128;
    const int t = tid % 128;
    const int jq = t % 4;
    const int kq = t / 4;
    for (int cb = grp; cb < nfg * 2; cb += 4) {
      const int f = cb / 2;
      const int p = cb % 2;
      const float* xr = xs + ((f * 4 + p * 2 + 0) * N1) * TJ;
      const float* xi = xs + ((f * 4 + p * 2 + 1) * N1) * TJ;
      float sr[4][4], si[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) sr[i][q] = si[i][q] = 0.f;
      }
      for (int j1 = 0; j1 < N1; ++j1) {
        const float4 ar = *reinterpret_cast<const float4*>(xr + j1 * TJ + jq * 4);
        const float4 ai = *reinterpret_cast<const float4*>(xi + j1 * TJ + jq * 4);
        const float xre[4] = {ar.x, ar.y, ar.z, ar.w};
        const float xim[4] = {ai.x, ai.y, ai.z, ai.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = ((kq + 32 * i) * j1) & (N1 - 1);
          const float wr = tab_r[idx];
          const float wi = tab_i[idx];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sr[i][q] = fmaf(wr, xre[q], fmaf(-wi, xim[q], sr[i][q]));
            si[i][q] = fmaf(wr, xim[q], fmaf(wi, xre[q], si[i][q]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kq + 32 * i;
        const size_t toff = (size_t)k * m + j2_0 + jq * 4;
        const float4 Tr = __ldg(reinterpret_cast<const float4*>(tr + toff));
        const float4 Ti = __ldg(reinterpret_cast<const float4*>(ti + toff));
        const float twr[4] = {Tr.x, Tr.y, Tr.z, Tr.w};
        const float twi[4] = {Ti.x, Ti.y, Ti.z, Ti.w};
        float orr[4], oii[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          orr[q] = sr[i][q] * twr[q] - si[i][q] * twi[q];
          oii[q] = sr[i][q] * twi[q] + si[i][q] * twr[q];
        }
        const size_t ooff =
            ((((size_t)c * 2 + p) * nframes + f0 + f) * N1 + k) * m + j2_0 + jq * 4;
        store4<BF16>(out_r, ooff, orr[0], orr[1], orr[2], orr[3]);
        store4<BF16>(out_i, ooff, oii[0], oii[1], oii[2], oii[3]);
      }
    }
    __syncthreads();
  }
}

constexpr size_t kSmemBytes = (2 * N1 + FG * 4 * N1 * TJ) * sizeof(float);

template <bool BF16>
cudaError_t launch(const void* v, const void* coeffs, const void* w1r_row,
                   const void* w1i_row, const void* tr, const void* ti,
                   void* out_r, void* out_i, int nchan, int nfft, int ntap,
                   int nblk, int nframes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pfb_dft1_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(nfft / N1 / TJ, nchan);
  pfb_dft1_kernel<BF16><<<grid, NTHREADS, kSmemBytes, stream>>>(
      static_cast<const char4*>(v), static_cast<const float*>(coeffs),
      static_cast<const float*>(w1r_row), static_cast<const float*>(w1i_row),
      static_cast<const float*>(tr), static_cast<const float*>(ti), out_r,
      out_i, nfft, ntap, nblk, nframes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the Python fit gate checks against.
int pfb_dft1_n1() { return N1; }
int pfb_dft1_tile_cols() { return TJ; }
int pfb_dft1_smem_bytes() { return (int)kSmemBytes; }

int pfb_dft1_launch(const void* v, const void* coeffs, const void* w1r_row,
                    const void* w1i_row, const void* tr, const void* ti,
                    void* out_r, void* out_i, int nchan, int nfft, int ntap,
                    int nblk, int nframes, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<true>(v, coeffs, w1r_row, w1i_row, tr, ti, out_r, out_i,
                          nchan, nfft, ntap, nblk, nframes, s)
           : launch<false>(v, coeffs, w1r_row, w1i_row, tr, ti, out_r, out_i,
                           nchan, nfft, ntap, nblk, nframes, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
