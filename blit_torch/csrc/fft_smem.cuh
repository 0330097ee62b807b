// fft_smem.cuh — the building blocks of the shared-memory FFTs in dft.cu
// (dft_last) and dft_tail2.cu: the radix passes, the roots, the staging
// copies.  Included by both sources; each builds its own library.
//
// A transform of n points runs as Stockham passes of the radices of a plan
// (ops/dft.py fft_plan: 16, 8, 4, 2 in registers, then 3, 5, 7, then any
// other prime as a dense sum), in the plan's order.  Pass p, after Ns = the
// product of the radices before it, takes butterfly j < n/R: it reads
// elements j + q*(n/R) (q < R), multiplies input q by the root
// T[q*(j%Ns)*(n/(Ns*R))], takes the R-point DFT and writes output r to
// element (j/Ns)*Ns*R + j%Ns + r*Ns.  After the last pass the transform is
// in natural order.  T is row 1 of the n-point DFT matrix, W[1, k] =
// exp(-2πi k/n), so every root is an entry of blit's own table, indexed;
// none is built from products or recurrences.  The trivial roots ±1 and
// ±i are applied exactly, as sign changes and swaps (the table holds them
// to within 6.2e-17).
//
// A pass reads all its inputs into registers, passes a barrier, then
// writes: source and destination may be the same shared-memory buffer.
// An IO object says where element idx of transform t lies (ld/st) and
// which butterfly a thread takes (map).  Shared memory is addressed by
// offsets from fft_smem, so every access is a 32-bit shared-memory one;
// the root tables are stored as (re, im) pairs.
//
// Two ways to run a plan.  A plan compiled in (static_plan, Radices<...>)
// inlines every pass with n and Ns as constants, so the index arithmetic
// folds to shifts and constants.  A plan read at run time (run_plan) calls
// each pass as a function of its own (radix_pass, not inlined): one kernel
// then runs every radix, and the compiler sizes each pass's registers
// alone (inlined into one loop the passes took 255 registers and
// spilled).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fft {

constexpr int MAX_PASSES = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The kernels' dynamic shared memory.
extern __shared__ __align__(16) float fft_smem[];

// Value `off` of shared memory seen as an array of T.
template <typename T>
__device__ __forceinline__ float smem_ld(int off) {
  return widen(reinterpret_cast<const T*>(fft_smem)[off]);
}

// Entry e of a root table stored as (re, im) pairs from float2 offset tab.
__device__ __forceinline__ float2 root(int tab, int e) {
  return reinterpret_cast<const float2*>(fft_smem)[tab + e];
}

// The radices of one transform, in pass order.
struct Plan {
  int np;
  int r[MAX_PASSES];
};

// 16 bytes global → shared, asynchronously; `bytes` < 16 copies that many
// and fills the rest with zeros (the ragged end of a tensor).
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// All but the most recent group complete.
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a *= w.
__device__ __forceinline__ void cmul(float& ar, float& ai, float wr, float wi) {
  const float r = ar * wr - ai * wi;
  ai = ar * wi + ai * wr;
  ar = r;
}
__device__ __forceinline__ void cmul(float& ar, float& ai, float2 w) {
  cmul(ar, ai, w.x, w.y);
}

// a *= -i.
__device__ __forceinline__ void mul_mi(float& ar, float& ai) {
  const float r = ai;
  ai = -ar;
  ar = r;
}

// 4-point DFT of x[0], x[s], x[2s], x[3s] in place: y[k] = sum_a x[a] (-i)^(ak).
template <int S>
__device__ __forceinline__ void dft4(float* xr, float* xi) {
  const float t0r = xr[0] + xr[2 * S], t0i = xi[0] + xi[2 * S];
  const float t1r = xr[0] - xr[2 * S], t1i = xi[0] - xi[2 * S];
  const float t2r = xr[S] + xr[3 * S], t2i = xi[S] + xi[3 * S];
  const float t3r = xr[S] - xr[3 * S], t3i = xi[S] - xi[3 * S];
  xr[0] = t0r + t2r;
  xi[0] = t0i + t2i;
  xr[2 * S] = t0r - t2r;
  xi[2 * S] = t0i - t2i;
  xr[S] = t1r + t3i;  // t1 - i t3
  xi[S] = t1i - t3r;
  xr[3 * S] = t1r - t3i;  // t1 + i t3
  xi[3 * S] = t1i + t3r;
}

// The R-point DFT of x[0..R) in registers, in place:
// x[k] = sum_q x[q] w^(qk), w = exp(-2πi/R) = T[step] (step = n/R), the
// table T at float2 offset tab.
template <int R>
struct Dft {
  // Small odd primes: the dense sum, roots T[((k q) mod R) * step].
  static __device__ __forceinline__ void run(float* xr, float* xi, int tab,
                                             int step) {
    float yr[R], yi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float sr = xr[0], si = xi[0];
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const int e = ((k * q) % R) * step;
        const float2 w = root(tab, e);
        const float wr = w.x, wi = w.y;
        sr = fmaf(xr[q], wr, fmaf(-xi[q], wi, sr));
        si = fmaf(xr[q], wi, fmaf(xi[q], wr, si));
      }
      yr[k] = sr;
      yi[k] = si;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      xr[k] = yr[k];
      xi[k] = yi[k];
    }
  }
};

template <>
struct Dft<2> {
  static __device__ __forceinline__ void run(float* xr, float* xi, int, int) {
    const float ar = xr[0], ai = xi[0];
    xr[0] = ar + xr[1];
    xi[0] = ai + xi[1];
    xr[1] = ar - xr[1];
    xi[1] = ai - xi[1];
  }
};

template <>
struct Dft<4> {
  static __device__ __forceinline__ void run(float* xr, float* xi, int, int) {
    dft4<1>(xr, xi);
  }
};

// 8 = 4 x 2: q = 2a + b, k = c + 4d; the radix-4 DFTs over a, the roots
// w8^(bc), then the radix-2 over b.
template <>
struct Dft<8> {
  static __device__ __forceinline__ void run(float* xr, float* xi, int tab,
                                             int step) {
    dft4<2>(xr, xi);          // b = 0: x[0], x[2], x[4], x[6] → c = 0..3
    dft4<2>(xr + 1, xi + 1);  // b = 1: x[1], x[3], x[5], x[7]
    // y_1[c] *= w8^c: T[step], -i exactly, T[3 step].
    cmul(xr[3], xi[3], root(tab, step));
    mul_mi(xr[5], xi[5]);
    cmul(xr[7], xi[7], root(tab, 3 * step));
    float yr[8], yi[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      yr[c] = xr[2 * c] + xr[2 * c + 1];
      yi[c] = xi[2 * c] + xi[2 * c + 1];
      yr[c + 4] = xr[2 * c] - xr[2 * c + 1];
      yi[c + 4] = xi[2 * c] - xi[2 * c + 1];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      xr[k] = yr[k];
      xi[k] = yi[k];
    }
  }
};

// 16 = 4 x 4: q = 4a + b, k = c + 4d; the radix-4 DFTs over a, the roots
// w16^(bc), then the radix-4 DFTs over b.
template <>
struct Dft<16> {
  static __device__ __forceinline__ void run(float* xr, float* xi, int tab,
                                             int step) {
#pragma unroll
    for (int b = 0; b < 4; ++b) dft4<4>(xr + b, xi + b);  // x[4c + b] = y_b[c]
#pragma unroll
    for (int b = 1; b < 4; ++b) {
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        const int e = b * c;
        if (e == 4) {
          mul_mi(xr[4 * c + b], xi[4 * c + b]);
        } else {
          cmul(xr[4 * c + b], xi[4 * c + b], root(tab, e * step));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) dft4<1>(xr + 4 * c, xi + 4 * c);  // x[4c + d] = out[c + 4d]
    float yr[16], yi[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        yr[c + 4 * d] = xr[4 * c + d];
        yi[c + 4 * d] = xi[4 * c + d];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      xr[k] = yr[k];
      xi[k] = yi[k];
    }
  }
};

// Copy, for every pass after the first of `plan` (n points), the twiddle
// roots it multiplies by, T[q*js*n/(Ns*R)] for 0 < q < R and js < Ns, from
// row 1 of the DFT matrix (tr, ti in device memory) into the (re, im)
// pairs from float2 offset pt, entry q*Ns + js - 1: the passes fill
// [Ns - 1, Ns*R - 1), fewer than n entries in all.
template <int NT>
__device__ __forceinline__ void fill_pass_tables(const Plan& plan, int n,
                                                 const float* tr,
                                                 const float* ti, int pt) {
  int Ns = plan.r[0];
  for (int p = 1; p < plan.np; ++p) {
    const int R = plan.r[p];
    const int tstep = n / (Ns * R);
    for (int i = threadIdx.x; i < (R - 1) * Ns; i += NT) {
      const int q = i / Ns + 1, js = i - (q - 1) * Ns;
      const int e = q * js * tstep;
      fft_smem[2 * (pt + Ns - 1 + i)] = tr[e];
      fft_smem[2 * (pt + Ns - 1 + i) + 1] = ti[e];
    }
    Ns *= R;
  }
}

// A compile-time int: passed where a pass takes n or Ns, it makes every
// index computation of the pass constant-folded (shifts for powers of two).
template <int V>
struct cint {
  __host__ __device__ constexpr operator int() const { return V; }
};

// One radix-R pass over `nb` butterflies (NT threads, NBF butterflies a
// thread at most), roots from the table at float2 offset tab; n and Ns are
// ints or cints.  Where io.pass_table() >= 0 the twiddles come from there
// instead: the root T[q*js*n/(Ns*R)] copied to entry q*Ns + js - 1 (see
// fill_pass_tables), so that butterflies with consecutive j read
// consecutive entries.  Ends with a barrier.
template <int R, int NT, int NBF, class IO, class NN, class NSS>
__device__ __forceinline__ void pass_body(const IO& io, NN n_, NSS ns_, int nb,
                                          int tab) {
  const int n = n_, Ns = ns_;
  const int L = n / R;
  const int tstep = n / (Ns * R);
  float xr[NBF][R], xi[NBF][R];
#pragma unroll
  for (int u = 0; u < NBF; ++u) {
    const int b = threadIdx.x + u * NT;
    if (b < nb) {
      int t, j;
      io.map(b, L, t, j);
#pragma unroll
      for (int q = 0; q < R; ++q) io.ld(t, j + q * L, xr[u][q], xi[u][q]);
      const int js = j % Ns;
      if (js) {
        const int pt = io.pass_table();
#pragma unroll
        for (int q = 1; q < R; ++q) {
          cmul(xr[u][q], xi[u][q],
               pt >= 0 ? root(pt, q * Ns + js - 1) : root(tab, q * js * tstep));
        }
      }
      Dft<R>::run(xr[u], xi[u], tab, L);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NBF; ++u) {
    const int b = threadIdx.x + u * NT;
    if (b < nb) {
      int t, j;
      io.map(b, L, t, j);
      const int base = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
      for (int r = 0; r < R; ++r) io.st(t, base + r * Ns, xr[u][r], xi[u][r]);
    }
  }
  __syncthreads();
}

// The pass of a plan known only at run time: a function of its own.
template <int R, int NT, int MAXV, class IO>
__device__ __noinline__ void radix_pass(const IO io, int n, int Ns, int nb,
                                        int tab) {
  pass_body<R, NT, (MAXV + R - 1) / R>(io, n, Ns, nb, tab);
}

// A pass of any radix R as a dense R-point sum per output: output r of
// butterfly j is sum_q x[j + q L] T[(q e) mod n], e = (j%Ns + r Ns)·n/(Ns R)
// (the twiddle and the R-point root in one entry).  `nout` outputs, one a
// thread at a time, MAXV a thread at most.  Ends with a barrier.
template <int NT, int MAXV, class IO>
__device__ __noinline__ void generic_pass(const IO io, int n, int R, int Ns,
                                          int nout, int tab) {
  const int L = n / R;
  const int tstep = n / (Ns * R);
  float yr[MAXV], yi[MAXV];
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int o = threadIdx.x + u * NT;
    if (o < nout) {
      int t, j, r;
      io.map_out(o, L, t, j, r);
      const int e = (j % Ns + r * Ns) * tstep;
      float sr = 0.f, si = 0.f;
      int idx = 0;
      for (int q = 0; q < R; ++q) {
        float a, b;
        io.ld(t, j + q * L, a, b);
        const float2 w = root(tab, idx);
        const float wr = w.x, wi = w.y;
        sr = fmaf(a, wr, fmaf(-b, wi, sr));
        si = fmaf(a, wi, fmaf(b, wr, si));
        idx += e;
        if (idx >= n) idx -= n;
      }
      yr[u] = sr;
      yi[u] = si;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int o = threadIdx.x + u * NT;
    if (o < nout) {
      int t, j, r;
      io.map_out(o, L, t, j, r);
      io.st(t, (j / Ns) * Ns * R + j % Ns + r * Ns, yr[u], yi[u]);
    }
  }
  __syncthreads();
}

// Pass `p` of a plan (radix R = plan.r[p], Ns the product before it) over
// `count` transforms of n points: the butterflies or, for a radix with no
// register pass, the outputs.
template <int NT, int MAXV, class IO>
__device__ __forceinline__ void run_pass(const IO& io, int n, int R, int Ns,
                                         int count, int tab) {
  const int nb = count * (n / R);
  switch (R) {
    case 2: radix_pass<2, NT, MAXV>(io, n, Ns, nb, tab); break;
    case 3: radix_pass<3, NT, MAXV>(io, n, Ns, nb, tab); break;
    case 4: radix_pass<4, NT, MAXV>(io, n, Ns, nb, tab); break;
    case 5: radix_pass<5, NT, MAXV>(io, n, Ns, nb, tab); break;
    case 7: radix_pass<7, NT, MAXV>(io, n, Ns, nb, tab); break;
    case 8: radix_pass<8, NT, MAXV>(io, n, Ns, nb, tab); break;
    case 16: radix_pass<16, NT, MAXV>(io, n, Ns, nb, tab); break;
    default:
      generic_pass<NT, MAXV>(io, n, R, Ns, count * n, tab);
      break;
  }
}

// Every pass of a plan known only at run time over `count` transforms of
// n points, in rounds of `per_round` transforms (a pass moves values only
// within a transform, so a round may work in place).
template <int NT, int MAXV, class IO>
__device__ __forceinline__ void run_plan(IO& io, int n, const Plan& plan,
                                         int count, int per_round, int tab) {
  int Ns = 1;
  for (int p = 0; p < plan.np; ++p) {
    io.set_pass(p == 0, p == plan.np - 1);
    for (int t0 = 0; t0 < count; t0 += per_round) {
      const int c = min(per_round, count - t0);
      io.round(t0, c);
      run_pass<NT, MAXV>(io, n, plan.r[p], Ns, c, tab);
    }
    Ns *= plan.r[p];
  }
}

// One round (transforms t0 .. t0+c) of every pass of a plan read at run
// time, before_last() called before the last pass.
template <int NT, int MAXV, class IO, class F>
__device__ __forceinline__ void run_round(IO& io, int n, const Plan& plan,
                                          int t0, int c, int tab,
                                          F& before_last) {
  int Ns = 1;
  for (int p = 0; p < plan.np; ++p) {
    const bool last = p == plan.np - 1;
    io.set_pass(p == 0, last);
    io.round(t0, c);
    if (last) before_last();
    run_pass<NT, MAXV>(io, n, plan.r[p], Ns, c, tab);
    Ns *= plan.r[p];
  }
}

// A plan known at compile time: its radices.
template <int... Rs>
struct Radices {};

// Every pass of a compile-time plan over transforms of N points, inlined,
// so each pass's index arithmetic folds to constants.
template <int NT, int MAXV, int N, int NS, class IO>
__device__ __forceinline__ void static_plan(IO&, int, int, int, Radices<>) {}

template <int NT, int MAXV, int N, int NS, class IO, int R, int... Rest>
__device__ __forceinline__ void static_plan(IO& io, int count, int per_round,
                                            int tab,
                                            Radices<R, Rest...>) {
  static_assert(R == 2 || R == 3 || R == 4 || R == 5 || R == 7 || R == 8 ||
                    R == 16, "a register radix");
  io.set_pass(NS == 1, sizeof...(Rest) == 0);
#pragma unroll
  for (int t0 = 0; t0 < count; t0 += per_round) {
    const int c = min(per_round, count - t0);
    io.round(t0, c);
    pass_body<R, NT, (MAXV + R - 1) / R>(io, cint<N>(), cint<NS>(),
                                         c * (N / R), tab);
  }
  static_plan<NT, MAXV, N, NS * R>(io, count, per_round, tab,
                                   Radices<Rest...>());
}

// One round of every pass of a compile-time plan, inlined, before_last()
// called before the last pass.
template <int NT, int MAXV, int N, int NS, class IO, class F>
__device__ __forceinline__ void static_round(IO&, int, int, int, F&,
                                             Radices<>) {}

template <int NT, int MAXV, int N, int NS, class IO, class F, int R,
          int... Rest>
__device__ __forceinline__ void static_round(IO& io, int t0, int c, int tab,
                                             F& before_last,
                                             Radices<R, Rest...>) {
  io.set_pass(NS == 1, sizeof...(Rest) == 0);
  io.round(t0, c);
  if constexpr (sizeof...(Rest) == 0) before_last();
  pass_body<R, NT, (MAXV + R - 1) / R>(io, cint<N>(), cint<NS>(),
                                       c * (N / R), tab);
  static_round<NT, MAXV, N, NS * R>(io, t0, c, tab, before_last,
                                    Radices<Rest...>());
}

}  // namespace fft
