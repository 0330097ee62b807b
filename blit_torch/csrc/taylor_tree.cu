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
// moved.  The first port kept one thread per column and ran every stage
// through shared memory, three shared accesses per element and stage, a
// 256-column tile with an L-column halo and 128 KB of shared memory at
// L = 64 (one block an SM): it ran at 16-21% of the byte bound.  This
// design moves each element through shared memory a few times at most:
//   - a subtree of 2^S rows (S <= 3) runs in registers.  A thread owns 4
//     consecutive output columns; leaf m (the subtree's m-th row) is read
//     over the window of 4 + m columns its paths can reach, and each level
//     computes its rows over the window the levels above still need, so
//     no value crosses threads between the subtree's levels;
//   - the same subtree serves every level of the tree: merging 2^S blocks
//     of B rows, row j of each block is a leaf, at an offset of j*m columns
//     for block m (the shift (d+1)>>1 of a row d = 2j + e is j plus the
//     subtree's own), and the subtree's outputs are rows j*2^S + e;
//   - every kernel first copies the rows it reads into shared memory by
//     cp.async (16-byte where F % 4 == 0, else 4-byte; zeros outside the
//     band), all of them in flight at once, and reads its leaf windows
//     there as 16-byte chunks; a window that starts at j*m columns past the
//     strip is shifted into place by selects on (j*m) & 3;
//   - route "registers" (T <= 8): one subtree over the whole window, 2048
//     columns a block, written to the output: one launch;
//   - route "shared" (16 <= T <= 64): a block stages T rows of a tile (TW
//     output columns, a T-column halo, 8 columns the first stages read past
//     it; ~67 KB, three blocks an SM).  Phase 1 runs the first three stages
//     of each 8-row group in place, in two rounds of one task a thread
//     from left to right: a round reads its windows, waits at a barrier and
//     writes columns no later round reads.  Phase 2 runs the rest as one
//     subtree of T/8 leaves per row j of the groups, tile to output;
//   - route "shared+passes" (128 <= T <= 1024): the shared route's kernel
//     on every 64-row group into a scratch plane, then one pass per three
//     further stages (T = 1024: two passes), each the registers route's
//     kernel over rows j of 2^S blocks of the scratch: the planes are
//     written and read two or three times, not once per stage;
//   - both signs run in one launch (block index = 2 * tile + sign: the two
//     signs' tiles of one band region run together, so the second read of
//     the band hits L2).  The negative sign's staged rows keep natural
//     column order and are read reversed (a 16-byte chunk reversed in
//     registers); it writes rows T-2..0 of the (2T-1, F) output in natural
//     column order, and its scratch rows in natural order too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int SMEM_LOG = 6;      // stages before the global passes: 64-row groups
constexpr int MAX_LOG = 10;      // T <= 1024 (blit's MAX_WINDOW)
constexpr int MAX_S = 3;         // levels of one register subtree
constexpr int SPT = 2;           // route "registers" / passes: strips a thread
constexpr int BW = 4 * NT * SPT; // and natural columns a block
constexpr int WSB = BW + 16;     // and staged columns a row (the windows' reach)

// A subtree of 2^S leaves; the last leaf's window is the widest.
template <int S>
struct Sub {
  static constexpr int R = 1 << S;         // rows (leaves)
  static constexpr int WMAX = 4 + R - 1;   // the last leaf's window
};

// Rows of a subtree in registers: row m holds columns [0, 4 + m) of its
// window at first; after level lv, the block of 2^(lv+1) rows starting at
// row L0 holds its rows over columns [0, 4 + L0).
template <int S>
using Rows = float[Sub<S>::R][Sub<S>::WMAX];

template <int S, int LV>
__device__ __forceinline__ void levels(Rows<S>& v) {
  if constexpr (LV < S) {
    constexpr int H = 1 << LV, R = Sub<S>::R, WM = Sub<S>::WMAX;
#pragma unroll
    for (int L0 = 0; L0 < R; L0 += 2 * H) {
      float o[2 * H][WM];
#pragma unroll
      for (int e = 0; e < 2 * H; ++e) {
        const int s = (e + 1) >> 1;
#pragma unroll
        for (int x = 0; x < WM; ++x) {
          if (x < 4 + L0) {
            const int xs = x + s < WM ? x + s : WM - 1;
            o[e][x] = v[L0 + (e >> 1)][x] + v[L0 + H + (e >> 1)][xs];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2 * H; ++e) {
#pragma unroll
        for (int x = 0; x < WM; ++x) {
          if (x < 4 + L0) v[L0 + e][x] = o[e][x];
        }
      }
    }
    levels<S, LV + 1>(v);
  }
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy natural columns [n, n+4) of `row` to dst (zeros outside [0, F)).
// VEC: F % 4 == 0, n % 4 == 0 and the row 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void stage4(float* dst, const float* row,
                                       long long n, long long F) {
  if constexpr (VEC) {
    const bool ok = n >= 0 && n < F;
    cp16(dst, ok ? row + n : row, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = n + i >= 0 && n + i < F;
      cp4(dst + i, ok ? row + n + i : row, ok);
    }
  }
}

// Stage R rows of `width` floats: row r from src(r) over natural columns
// [nlo(r), nlo(r) + width), zeros outside [0, F), by 16- or 4-byte
// cp.async, all in flight at once.  Ends with the rows in shared memory
// and a barrier.
template <bool VEC, class SrcRow, class Nlo>
__device__ __forceinline__ void stage_rows(float* sm, int R, int width, long long F,
                                           const SrcRow& src, const Nlo& nlo) {
  for (int e = threadIdx.x; e < R * (width / 4); e += NT) {
    const int r = e / (width / 4), q = e % (width / 4);
    stage4<VEC>(sm + r * width + 4 * q, src(r), nlo(r) + 4 * q, F);
  }
  cp_wait_all();
  __syncthreads();
}

// A staged row in shared memory: `width` floats in natural column order
// holding logical columns [k0, k0 + width) of a sign; logical chunk [k,
// k+4) (k % 4 == 0) lies at k - k0 (sign 0) or width - 4 - (k - k0)
// (sign 1, reversed).
struct Staged {
  float* row;
  int width, sign;
  long long k0;

  __device__ __forceinline__ float4 chunk(long long k) const {
    const int i = (int)(k - k0);
    if (sign) {
      const float4 v = *reinterpret_cast<const float4*>(row + width - 4 - i);
      return make_float4(v.w, v.z, v.y, v.x);
    }
    return *reinterpret_cast<const float4*>(row + i);
  }
  __device__ __forceinline__ void put(long long k, const float* v) const {
    const int i = (int)(k - k0);
    if (sign) {
      *reinterpret_cast<float4*>(row + width - 4 - i) = make_float4(v[3], v[2], v[1], v[0]);
    } else {
      *reinterpret_cast<float4*>(row + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// Leaf window: logical columns [start, start + NW) of `src` into w[0, NW).
// ALIGNED: start % 4 == 0 is known.  Otherwise the chunks covering it are
// read and shifted by selects on start & 3.
template <int NW, bool ALIGNED, int WM, class Src>
__device__ __forceinline__ void window(const Src& src, long long start,
                                       float (&w)[WM]) {
  const long long k0 = start & ~3LL;
  constexpr int NQ = ALIGNED ? (NW + 3) / 4 : (NW + 6) / 4;
  float b[4 * NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 c = src.chunk(k0 + 4 * q);
    b[4 * q] = c.x;
    b[4 * q + 1] = c.y;
    b[4 * q + 2] = c.z;
    b[4 * q + 3] = c.w;
  }
  if constexpr (ALIGNED) {
#pragma unroll
    for (int x = 0; x < NW; ++x) w[x] = b[x];
  } else {
    const int r = (int)(start & 3);
    const bool r1 = r & 1, r2 = r & 2;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      const int i1 = x + 1 < 4 * NQ ? x + 1 : 4 * NQ - 1;
      const int i2 = x + 2 < 4 * NQ ? x + 2 : 4 * NQ - 1;
      const int i3 = x + 3 < 4 * NQ ? x + 3 : 4 * NQ - 1;
      const float lo = r1 ? b[i1] : b[x];
      const float hi = r1 ? b[i3] : b[i2];
      w[x] = r2 ? hi : lo;
    }
  }
}

// Leaves m = 0 .. 2^S-1 of a subtree: leaf m from src(m) at logical
// start c + j*m.
template <int S, bool ALIGNED, int M = 0, class SrcOf>
__device__ __forceinline__ void leaves(Rows<S>& v, const SrcOf& src_of,
                                       long long c, long long j) {
  if constexpr (M < Sub<S>::R) {
    window<4 + M, ALIGNED>(src_of(M), c + j * M, v[M]);
    leaves<S, ALIGNED, M + 1>(v, src_of, c, j);
  }
}

// Where a pass's rows go.  Final: the (T, F) output (one sign) or the
// (2T-1, F) output (both); scratch: (nsign, T, ld) planes, the negative
// sign in natural column order.
struct Out {
  float* p;
  long long F, ld;
  int T, both, final_, vec;

  // Row `d` of the tree (drift d of the sign), natural columns [n, n+4),
  // values in natural order.
  __device__ __forceinline__ void put(int sign, int d, long long n,
                                      const float (&v)[4]) const {
    float* dst;
    if (!final_) {
      if (n >= ld) return;
      dst = p + ((size_t)sign * T + d) * (size_t)ld + n;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
    if (sign == 0) {
      dst = p + (size_t)((both ? T - 1 : 0) + d) * (size_t)F;
    } else if (d > 0) {  // drift 0 of the negative sign is the positive's row
      dst = p + (size_t)(T - 1 - d) * (size_t)F;
    } else {
      return;
    }
    if (vec) {
      if (n < F) {
        *reinterpret_cast<float4*>(dst + n) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n + i < F) dst[n + i] = v[i];
      }
    }
  }
};

// Logical columns [c, c+4) → natural chunk start and natural-order values.
__device__ __forceinline__ long long natural4(int sign, long long anchor,
                                              long long c, const float* w,
                                              float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = sign ? w[3 - i] : w[i];
  return sign ? anchor - c - 3 : anchor + c;
}

// Route "registers" and the global passes: S levels over blocks of B rows
// of `in` (rows of stride ld, natural columns [0, F) hold data; the sign's
// plane starts `plane` floats in).  blockIdx.x = 2 * tile + sign (both) or
// tile, a tile BW natural columns; blockIdx.y = a * B + j: merged block a
// (of B * 2^S rows), row j of each of its 2^S blocks.  Leaf m is staged
// over logical columns [k0, k0 + WSB), k0 = (j*m) & ~3.
template <int S, bool VEC>
__global__ void __launch_bounds__(NT, 2)
tree_sub_kernel(const float* __restrict__ in, long long F, long long ld,
                long long plane, int B, int nsign, Out o) {
  constexpr int R = Sub<S>::R;
  extern __shared__ __align__(16) float sm[];
  const long long tile = blockIdx.x / nsign;
  const int sign = blockIdx.x % nsign;
  const int a = blockIdx.y / B, j = blockIdx.y % B;
  const long long n0 = tile * BW;
  const long long anchor = sign ? n0 + BW - 1 : n0;
  const float* base = in + (size_t)sign * plane;
  stage_rows<VEC>(
      sm, R, WSB, F,
      [&](int m) { return base + (size_t)(((a << S) + m) * B + j) * ld; },
      [&](int m) {
        const long long k0 = (long long)(j * m) & ~3LL;
        return sign ? anchor - k0 - WSB + 1 : anchor + k0;
      });
  auto src = [&](int m) {
    return Staged{sm + m * WSB, WSB, sign, (long long)(j * m) & ~3LL};
  };
#pragma unroll 1
  for (int st = 0; st < SPT; ++st) {
    const long long c = 4LL * (threadIdx.x + st * NT);
    Rows<S> v;
    leaves<S, false>(v, src, c, j);
    levels<S, 0>(v);
    float nat[4];
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long long n = natural4(sign, anchor, c, v[e], nat);
      o.put(sign, a * (B << S) + (j << S) + e, n, nat);
    }
  }
}

// Route "shared": one 64-row group (or the whole window, T = 8 * 2^S2 <=
// 64), TW output columns.  The tile: R1 staged rows of WS columns (outputs,
// halo, and the 8 columns phase 1 reads past them).  Phase 1 takes SR
// strips of every 8-row group a round, three rounds over the WT columns
// phase 2 reads.  blockIdx.x = 2 * tile + sign (both) or tile, blockIdx.y =
// the group; rows go to `o` as group * R1 + D.
template <int S2>
struct TileGeo {
  static constexpr int R1 = 8 << S2;        // rows
  static constexpr int SR = NT / (R1 / 8);  // phase-1 strips a round
  static constexpr int ROUNDS = 2;          // phase-1 rounds
  static constexpr int WT = ROUNDS * 4 * SR;  // phase-1 columns
  static constexpr int TW = WT - R1;        // output columns
  static constexpr int WS = WT + 8;         // staged columns a row
  static constexpr int SMEM = R1 * WS * 4;  // bytes (~67 KB: three blocks an SM)
};

template <int S2, bool VEC>
__global__ void __launch_bounds__(NT, 3)
tree_tile_kernel(const float* __restrict__ x, long long F, int nsign, Out o) {
  using G = TileGeo<S2>;
  constexpr int R1 = G::R1, WS = G::WS, TW = G::TW, SR = G::SR;
  extern __shared__ __align__(16) float tile[];
  const long long t = blockIdx.x / nsign;
  const int sign = blockIdx.x % nsign;
  const int grp = blockIdx.y;
  const long long anchor = sign ? t * TW + TW - 1 : t * TW;
  const long long nlo = sign ? anchor - WS + 1 : anchor;
  const float* xg = x + (size_t)grp * R1 * (size_t)F;
  stage_rows<VEC>(
      tile, R1, WS, F, [&](int r) { return xg + (size_t)r * F; },
      [&](int) { return nlo; });

  // Phase 1, in place: round k reads logical columns [4 SR k, 4 SR (k+1)
  // + 8) and writes [4 SR k, 4 SR (k+1)); later rounds read only further
  // right.
  const int b = threadIdx.x / SR;
#pragma unroll 1
  for (int k = 0; k < G::ROUNDS; ++k) {
    const long long c = 4LL * (k * SR + threadIdx.x % SR);
    Rows<3> v;
    auto src = [&](int m) { return Staged{tile + (8 * b + m) * WS, WS, sign, 0}; };
    leaves<3, true>(v, src, c, 0);
    levels<3, 0>(v);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e) src(e).put(c, v[e]);
  }
  __syncthreads();

  // Phase 2: tasks (j, strip) over the TW output columns.
  constexpr int NS2 = TW / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < 8 * NS2; i += NT) {
    const int j = i / NS2;
    const long long c = 4LL * (i % NS2);
    Rows<S2> v;
    auto src = [&](int m) { return Staged{tile + (8 * m + j) * WS, WS, sign, 0}; };
    leaves<S2, false>(v, src, c, j);
    levels<S2, 0>(v);
    float nat[4];
#pragma unroll
    for (int e = 0; e < Sub<S2>::R; ++e) {
      const long long n = natural4(sign, anchor, c, v[e], nat);
      o.put(sign, grp * R1 + (j << S2) + e, n, nat);
    }
  }
}

// Dynamic shared memory past 48 KB needs the kernel's opt-in, once a
// device (later launches make no attribute call).
template <class K>
cudaError_t allow_smem(K kernel, int smem, unsigned& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// The registers route (in = x, B = 1, plane 0) or a pass (in = scratch).
template <int S, bool VEC>
cudaError_t launch_sub_v(const float* in, long long F, long long ld,
                         long long plane, int T, int B, int nsign, const Out& o,
                         cudaStream_t s) {
  const int smem = Sub<S>::R * WSB * 4;
  const long long nx = (ld + BW - 1) / BW * nsign;
  if (nx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)nx, (unsigned)(T >> S));
  static unsigned done = 0;
  cudaError_t err = allow_smem(tree_sub_kernel<S, VEC>, smem, done);
  if (err != cudaSuccess) return err;
  tree_sub_kernel<S, VEC><<<grid, NT, smem, s>>>(in, F, ld, plane, B, nsign, o);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_sub(const float* in, long long F, long long ld,
                       long long plane, int T, int B, int nsign, bool vec,
                       const Out& o, cudaStream_t s) {
  return vec ? launch_sub_v<S, true>(in, F, ld, plane, T, B, nsign, o, s)
             : launch_sub_v<S, false>(in, F, ld, plane, T, B, nsign, o, s);
}

cudaError_t dispatch_sub(int S, const float* in, long long F, long long ld,
                         long long plane, int T, int B, int nsign, bool vec,
                         const Out& o, cudaStream_t s) {
  switch (S) {
    case 1: return launch_sub<1>(in, F, ld, plane, T, B, nsign, vec, o, s);
    case 2: return launch_sub<2>(in, F, ld, plane, T, B, nsign, vec, o, s);
    case 3: return launch_sub<3>(in, F, ld, plane, T, B, nsign, vec, o, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int S2, bool VEC>
cudaError_t launch_tile_v(const float* x, long long F, int nsign, int ngrp,
                          const Out& o, cudaStream_t s) {
  using G = TileGeo<S2>;
  const long long nx = (F + G::TW - 1) / G::TW * nsign;
  if (nx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)nx, (unsigned)ngrp);
  static unsigned done = 0;
  cudaError_t err = allow_smem(tree_tile_kernel<S2, VEC>, G::SMEM, done);
  if (err != cudaSuccess) return err;
  tree_tile_kernel<S2, VEC><<<grid, NT, G::SMEM, s>>>(x, F, nsign, o);
  return cudaGetLastError();
}

cudaError_t dispatch_tile(int S2, const float* x, long long F, int nsign,
                          int ngrp, bool vec, const Out& o, cudaStream_t s) {
  switch (S2 * 2 + (vec ? 1 : 0)) {
    case 2: return launch_tile_v<1, false>(x, F, nsign, ngrp, o, s);
    case 3: return launch_tile_v<1, true>(x, F, nsign, ngrp, o, s);
    case 4: return launch_tile_v<2, false>(x, F, nsign, ngrp, o, s);
    case 5: return launch_tile_v<2, true>(x, F, nsign, ngrp, o, s);
    case 6: return launch_tile_v<3, false>(x, F, nsign, ngrp, o, s);
    case 7: return launch_tile_v<3, true>(x, F, nsign, ngrp, o, s);
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

// x: (T, F) f32; out: (T, F) (both = 0) or (2T-1, F) (both = 1); scratch:
// nbuf * nsign * T * ld floats, ld = F rounded up to a multiple of 4, nbuf
// = launches - 1 (0 for T <= 64).  *launched gets the number of kernels
// launched: 1 (T <= 64), else 1 + ceil((log2(T) - 6) / 3).
int taylor_tree_launch(const void* x, void* out, void* scratch, int T,
                       long long F, int both, void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int log = log2_window(T);
  if (log < 0 || F < 1) return (int)cudaErrorInvalidValue;
  const int nsign = both ? 2 : 1;
  const float* in = static_cast<const float*>(x);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long ld = (F + 3) & ~3LL;
  const Out fin{static_cast<float*>(out), F, F, T, both, 1, vec ? 1 : 0};
  cudaError_t err;
  if (log <= MAX_S) {
    err = dispatch_sub(log, in, F, F, 0, T, 1, nsign, vec, fin, s);
    if (err == cudaSuccess) *launched = 1;
    return (int)err;
  }
  if (log <= SMEM_LOG) {
    err = dispatch_tile(log - 3, in, F, nsign, 1, vec, fin, s);
    if (err == cudaSuccess) *launched = 1;
    return (int)err;
  }
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long plane = (long long)T * ld;
  float* buf[2] = {static_cast<float*>(scratch),
                   static_cast<float*>(scratch) + (size_t)nsign * plane};
  err = dispatch_tile(3, in, F, nsign, T >> SMEM_LOG, vec,
                      Out{buf[0], F, ld, T, both, 0, 1}, s);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  int B = 1 << SMEM_LOG, src = 0;
  for (int left = log - SMEM_LOG; left > 0;) {
    const int S = left < MAX_S ? left : MAX_S;
    left -= S;
    const Out o = left == 0 ? fin : Out{buf[1 - src], F, ld, T, both, 0, 1};
    err = dispatch_sub(S, buf[src], ld, ld, plane, T, B, nsign, true, o, s);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    B <<= S;
    src = 1 - src;
  }
  return 0;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
