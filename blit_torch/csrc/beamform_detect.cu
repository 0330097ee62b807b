// beamform_detect.cu — fused tied-array beamform + detect + integrate.
//
// Replaces the TPU kernel blit/ops/pallas_beamform.py:fused_beamform_detect
// (body _kernel) with its contract, packed chan-major layouts:
//   in : voltages (vr, vi), each (nchan, nant, npol, ntime), and
//        weights  (wr, wi), each (nchan, nbeam, nant), all f32 or all bf16;
//   out: f32 (nchan, nbeam, npol, ntime / nint) with
//        out[c,b,p,o] = sum_{t in [o*nint, (o+1)*nint)} |B[c,b,p,t]|^2,
//        B[c,b,p,t]   = sum_a w[c,b,a] * v[c,a,p,t]   (complex).
// bf16 products are taken from the bf16 values exactly and summed in f32,
// as the TPU kernel's dots with preferred_element_type=f32.
//
// What bounds it on an H100: 8 flops per (beam, antenna, pol, sample) of
// complex products, 8 bytes read per (antenna, pol, sample) in f32 (4 in
// bf16).  At the array scale (64 antennas, 64 beams, 64 channels, 2 pols,
// 8192 samples): 34.4 GFLOP against 0.17 ms of bytes in f32 (0.09 in bf16).
// The first port ran those products as f32 FMAs on the CUDA cores (0.51 ms
// at their 67 TFLOP/s even at full rate) and widened bf16 to f32, so bf16
// ran no faster.  Design:
//   - per channel the complex product is one real product on the tensor
//     cores: [Br; Bi] = [Wr, -Wi; Wi, Wr] [Vr; Vi].  An m16 tile of the
//     stacked weights is 8 beams, their Br rows (0-7) over their Bi rows
//     (8-15), so an accumulator fragment holds Br and Bi of the same (beam,
//     sample) in one lane: c0, c2 and c1, c3.  The K axis runs over the
//     antennas twice, Vr then Vi, and the A fragments of the second half are
//     the first half's registers permuted and negated (-Wi, Wr), so one load
//     of (Wr, Wi) serves both;
//   - bf16: mma.sync m16n8k16 bf16 -> f32.  The B fragments come from the
//     voltages' time-contiguous rows by ldmatrix .trans; the weights' rows
//     are antenna-contiguous, the A layout as it is;
//   - f32: the same products in three tf32 passes on m16n8k8 (x = xh + xl:
//     xl yh + xh yl + xh yh, the split of blit_torch/csrc/xengine.cu) into
//     the f32 sums; single-pass tf32 (~5e-4 a product) would not hold the
//     f32 bound.  Holding each 8-antenna step's products apart from the
//     running sums (xengine.cu's way) spilled at 255 registers and ran
//     slower.  mma.sync's tf32 rate bounds it, so the xh yl pass is skipped
//     where a warp's voltages have no low part (integer RAW voltages are
//     exact in tf32): its products are exact zeros;
//   - detect and integrate from the accumulator fragments: |B|^2 of the
//     lane's two samples, their sum, then the lanes of one n8 tile by a fixed
//     shuffle tree (nint <= 8), then a warp's n8 tiles in order (nint 16,
//     32), stored from the registers (8 to 32 consecutive outputs of a beam
//     a lane: no barrier); nint 64 and 128 span the warps, whose 8-sample
//     sums meet in a small shared buffer and are added in order.  Every
//     output is summed in an order that depends only on its own samples,
//     never on where the tile or the call starts, with no atomics: windowed
//     streams equal one-shot calls bitwise;
//   - a block is 64 beams x 128 samples of one (channel, pol): 8 warps, 2
//     along the beams (4 m16 tiles each) by 4 along the samples (4 n8 tiles
//     each).  Persistent blocks walk contiguous ranges of the (channel,
//     beam tile, pol, time tile) items, advanced stage by stage without
//     division; antennas are staged KA at a time by 16-byte cp.async into
//     NSLOT slots, NSLOT - 1 stages in flight while one computes (f32: 32
//     antennas, four slots, one block an SM at up to 255 registers; bf16:
//     64 antennas, two slots, two blocks an SM).  A slot keeps the weight
//     tile it holds and loads it again only when the (channel, beam tile,
//     antenna chunk) changes: where the number of antenna chunks divides
//     NSLOT (at 64 antennas in both) a block keeps its channel's weights
//     across its time tiles;
//   - nant, nbeam and ntime need not fill a tile: missing antennas and beams
//     are staged as zeros (their products add +0), samples past ntime are
//     zeros and not stored.  Where the rows are not 16-byte multiples the
//     stage copies element by element;
//   - nint must be a power of two up to 128 dividing ntime (the Python gate
//     `fits`); other shapes take beamform's matmul route.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BB = 64;         // beams a block (8 m16 tiles of 8 beams)
constexpr int NB = 128;        // samples a time tile, one pol
constexpr int NWM = 2;         // warps along the beams (4 along the samples)
constexpr int MTW = 8 / NWM;   // m16 tiles a warp
constexpr int BPW = 8 * MTW;   // beams a warp
constexpr int NTW = 4;         // n8 tiles a warp (32 samples)
constexpr int NTHREADS = 32 * NWM * 4;
constexpr int MAX_NINT = NB;
constexpr int PS = NB / 8 + 1;  // words a beam of the 8-sample sums

// Shared memory of one stage slot, in 32-bit words: the voltages (both
// planes, KA antenna rows of NB samples) and the weights (both planes, BB
// beam rows of KA antennas).  Row strides put the MMA fragments' reads on
// distinct banks: f32 V rows 136 words (lanes (g, q) at 8q + g), W rows
// KA + 4 (4g + q); bf16 V rows 272 bytes (ldmatrix's 8 rows on distinct
// 16-byte bank groups), W rows 36 words (4g + q).
// Per operand type: antennas a stage (KA), stage slots (NSLOT: NSLOT - 1
// stages in flight), blocks an SM (MINB: f32 holds the three passes'
// operands besides its sums in up to 255 registers, one block an SM; bf16
// two blocks of at most 128).
template <typename T>
struct Geo;
template <>
struct Geo<float> {
  static constexpr int KA = 32, NSLOT = 4, MINB = 1;
  static constexpr int VROW = NB + 8;
  static constexpr int WROW = KA + 4;
};
template <>
struct Geo<__nv_bfloat16> {
  static constexpr int KA = 64, NSLOT = 2, MINB = 2;
  static constexpr int VROW = NB / 2 + 4;
  static constexpr int WROW = KA / 2 + 4;
};
template <typename T>
struct Slot {
  static constexpr int KA = Geo<T>::KA, VROW = Geo<T>::VROW, WROW = Geo<T>::WROW;
  static constexpr int NSLOT = Geo<T>::NSLOT;
  static constexpr int V_WORDS = 2 * KA * VROW;
  static constexpr int WORDS = V_WORDS + 2 * BB * WROW;
  static constexpr int SMEM = (NSLOT * WORDS + BB * PS) * 4;  // slots + sums
};

struct Args {
  const void* vr;
  const void* vi;
  const void* wr;
  const void* wi;
  float* out;
  int nchan, nant, nbeam, npol, ntime, nint, nck, nbt, ntt;
  long long items;
};

// An item (channel, beam tile, pol, time tile) and an antenna chunk, as a
// block walks them: decoded once, then advanced stage by stage with no
// division.
struct Cursor {
  int c, bt, p, tt, ka;
  __device__ __forceinline__ Cursor(const Args& a, long long i) {
    tt = (int)(i % a.ntt);
    i /= a.ntt;
    p = (int)(i % a.npol);
    i /= a.npol;
    bt = (int)(i % a.nbt);
    c = (int)(i / a.nbt);
    ka = 0;
  }
  __device__ __forceinline__ void next(const Args& a) {
    if (++ka < a.nck) return;
    ka = 0;
    if (++tt < a.ntt) return;
    tt = 0;
    if (++p < a.npol) return;
    p = 0;
    if (++bt < a.nbt) return;
    bt = 0;
    ++c;
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage antennas [ka*KA, ka*KA + KA) of item `it` into `slot`: the voltages
// always, the weights when `with_w`.  AL: rows are 16-byte multiples and
// the planes 16-byte aligned, so 16-byte chunks lie wholly inside or
// outside the data; else element by element.
template <typename T, bool AL>
__device__ __forceinline__ void issue(const Args& a, uint32_t* slot,
                                      const Cursor& it, bool with_w) {
  using S = Slot<T>;
  constexpr int KA = S::KA, CE = 16 / (int)sizeof(T);
  const int a0 = it.ka * KA, t0 = it.tt * NB, b0 = it.bt * BB;
  const size_t vrow = (size_t)a.npol * a.ntime;  // antenna stride
  const size_t voff = (((size_t)it.c * a.nant + a0) * a.npol + it.p) * a.ntime + t0;
  const T* vsrc[2] = {static_cast<const T*>(a.vr) + voff,
                      static_cast<const T*>(a.vi) + voff};
  constexpr int VCH = NB / CE;  // chunks a voltage row
  static_assert(2 * KA * VCH % NTHREADS == 0 && 2 * BB * (KA / CE) % NTHREADS == 0,
                "whole chunks a thread");
#pragma unroll
  for (int k = 0; k < 2 * KA * VCH / NTHREADS; ++k) {
    const int e = threadIdx.x + k * NTHREADS;
    const int pl = e / (KA * VCH), al = e / VCH % KA, ch = e % VCH;
    uint32_t* dst = slot + (pl * KA + al) * S::VROW + ch * 4;
    const T* src = vsrc[pl] + al * vrow + ch * CE;
    if constexpr (AL) {
      const bool ok = a0 + al < a.nant && t0 + ch * CE < a.ntime;
      cp16(dst, ok ? src : vsrc[pl], ok ? 16 : 0);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int i = 0; i < CE; ++i) {
        const bool ok = a0 + al < a.nant && t0 + ch * CE + i < a.ntime;
        d[i] = ok ? src[i] : T(0.f);
      }
    }
  }
  if (!with_w) return;
  const size_t woff = ((size_t)it.c * a.nbeam + b0) * a.nant + a0;
  const T* wsrc[2] = {static_cast<const T*>(a.wr) + woff,
                      static_cast<const T*>(a.wi) + woff};
  constexpr int WCH = KA / CE;  // chunks a weight row
#pragma unroll
  for (int k = 0; k < 2 * BB * WCH / NTHREADS; ++k) {
    const int e = threadIdx.x + k * NTHREADS;
    const int pl = e / (BB * WCH), bl = e / WCH % BB, ch = e % WCH;
    uint32_t* dst = slot + S::V_WORDS + (pl * BB + bl) * S::WROW + ch * 4;
    const T* src = wsrc[pl] + (size_t)bl * a.nant + ch * CE;
    if constexpr (AL) {
      const bool ok = b0 + bl < a.nbeam && a0 + ch * CE < a.nant;
      cp16(dst, ok ? src : wsrc[pl], ok ? 16 : 0);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int i = 0; i < CE; ++i) {
        const bool ok = b0 + bl < a.nbeam && a0 + ch * CE + i < a.nant;
        d[i] = ok ? src[i] : T(0.f);
      }
    }
  }
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: A 16 x 8 (row), B 8 x 8 (col), tf32 in, f32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + e: hi x rounded to tf32 (11 significant bits), lo the
// rest with its bits past tf32's cut (the MMA reads 11), |e| < 2^-22 |x|.
// The rounding, to nearest with ties away from zero (cvt.rna.tf32's), is
// an integer add and mask on the bits of a finite x: full-rate ALU work
// where the conversion instruction measured slower on the H100.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

constexpr uint32_t SIGN32 = 0x80000000u, SIGN16X2 = 0x80008000u;

// The Vi half's A fragment from the Vr half's (Wr_q, Wi_q, Wr_q4, Wi_q4):
// rows of Br take -Wi, rows of Bi take Wr.
__device__ __forceinline__ void second_half(const uint32_t* a, uint32_t sign,
                                            uint32_t* b) {
  b[0] = a[1] ^ sign;
  b[1] = a[0];
  b[2] = a[3] ^ sign;
  b[3] = a[2];
}

using Acc = float[MTW][NTW][4];

// One stage's products, f32 in three tf32 passes: 8 antennas a step.  For
// each n8 tile the four m16 tiles' MMA chains are interleaved pass by pass,
// so consecutive MMAs are independent.  Voltages that tf32 holds exactly
// (RAW voltages are small integers) have no low part: the xh yl pass then
// adds exact zeros, and a warp whose n8 tile has none skips it.
__device__ __forceinline__ void compute(const uint32_t* slot, Acc& acc,
                                        const float*) {
  using S = Slot<float>;
  const float* V = reinterpret_cast<const float*>(slot);
  const float* W = reinterpret_cast<const float*>(slot + S::V_WORDS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll 1
  for (int kb = 0; kb < S::KA / 8; ++kb) {
    // The weights' split, once a step for the four m16 tiles: (hi, lo) of
    // the Vr half and of the Vi half.
    uint32_t ah[MTW][4], al[MTW][4], h2[MTW][4], l2[MTW][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int b = BPW * wm + 8 * mt + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // e: Wr at q, Wi at q, Wr at q+4, Wi at q+4.
        const float w = W[((e & 1) * BB + b) * S::WROW + 8 * kb + q + 4 * (e >> 1)];
        split(w, ah[mt][e], al[mt][e]);
      }
      second_half(ah[mt], SIGN32, h2[mt]);
      second_half(al[mt], SIGN32, l2[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = 32 * wn + 8 * nt + g;
      uint32_t bh[4], bl[4];  // Vr at q, q+4; Vi at q, q+4
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = V[((e >> 1) * S::KA + 8 * kb + q + 4 * (e & 1)) * S::VROW + n];
        split(v, bh[e], bl[e]);
      }
      const bool vlo = __any_sync(0xffffffffu, (bl[0] | bl[1] | bl[2] | bl[3]) != 0u);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) mma_tf32(acc[mt][nt], al[mt], bh[0], bh[1]);
      if (vlo) {
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl[0], bl[1]);
      }
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) mma_tf32(acc[mt][nt], ah[mt], bh[0], bh[1]);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) mma_tf32(acc[mt][nt], l2[mt], bh[2], bh[3]);
      if (vlo) {
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) mma_tf32(acc[mt][nt], h2[mt], bl[2], bl[3]);
      }
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) mma_tf32(acc[mt][nt], h2[mt], bh[2], bh[3]);
    }
  }
}

// One stage's products, bf16: 16 antennas a step.
__device__ __forceinline__ void compute(const uint32_t* slot, Acc& acc,
                                        const __nv_bfloat16*) {
  using S = Slot<__nv_bfloat16>;
  const uint32_t* W = slot + S::V_WORDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  // ldmatrix rows: lane l addresses row (l & 7) of matrix l >> 3: Vr rows
  // k..k+7, Vr k+8..k+15, Vi k..k+7, Vi k+8..k+15 of the step.
  const int lrow = (lane >> 4) * S::KA + ((lane >> 3) & 1) * 8 + (lane & 7);
  const unsigned vbase = static_cast<unsigned>(__cvta_generic_to_shared(slot)) +
                         (unsigned)(lrow * S::VROW * 4 + (32 * wn) * 2);
#pragma unroll 1
  for (int kb = 0; kb < S::KA / 16; ++kb) {
    uint32_t a1[MTW][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int b = BPW * wm + 8 * mt + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a1[mt][e] = W[((e & 1) * BB + b) * S::WROW + 8 * kb + q + 4 * (e >> 1)];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      uint32_t bv[4];  // Vr k 0-7 / 8-15, Vi k 0-7 / 8-15 at n = g
      const unsigned addr = vbase + (unsigned)(16 * kb * S::VROW * 4 + 16 * nt);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(bv[0]), "=r"(bv[1]), "=r"(bv[2]), "=r"(bv[3])
          : "r"(addr));
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) mma_bf16(acc[mt][nt], a1[mt], bv[0], bv[1]);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        uint32_t a2[4];
        second_half(a1[mt], SIGN16X2, a2);
        mma_bf16(acc[mt][nt], a2, bv[2], bv[3]);
      }
    }
  }
}

// Detect and integrate one item's sums, then zero them.  nint <= 32: from
// the registers (a lane's pair, the shuffles over an n8 tile's lanes, then
// a warp's n8 tiles in order); nint 64 and 128 span the warps along the
// samples: their 8-sample sums meet in shared memory, added in order.
__device__ __forceinline__ void epilogue(const Args& a, const Cursor& it,
                                         Acc& acc, float* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int nint = a.nint, nout = a.ntime / nint;
  const int t0 = it.tt * NB;
  const size_t orow0 = ((size_t)it.c * a.nbeam + (size_t)it.bt * BB) * a.npol + it.p;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int bl = BPW * wm + 8 * mt + g;
    const bool bok = it.bt * BB + bl < a.nbeam;
    float* orow = a.out + (orow0 + (size_t)bl * a.npol) * nout;
    float s8[NTW];  // lane q = 0: the 8-sample sums of the warp's n8 tiles
    static_assert(NTW == 4, "the sums below name the four n8 tiles");
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float* c = acc[mt][nt];
      const float p0 = c[0] * c[0] + c[2] * c[2];  // |B|^2 at sample 2q
      const float p1 = c[1] * c[1] + c[3] * c[3];  // and 2q + 1
      const int t = t0 + 32 * wn + 8 * nt + 2 * q;
      s8[nt] = 0.f;
      if (nint == 1) {
        if (bok && t < a.ntime) orow[t] = p0;
        if (bok && t + 1 < a.ntime) orow[t + 1] = p1;
        continue;
      }
      float s = p0 + p1;
      if (nint == 2) {
        if (bok && t < a.ntime) orow[t >> 1] = s;
        continue;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (nint == 4) {
        if (!(q & 1) && bok && t < a.ntime) orow[t >> 2] = s;
        continue;
      }
      s8[nt] = s + __shfl_xor_sync(0xffffffffu, s, 2);
    }
    if (nint < 8 || q != 0) continue;
    if (nint >= 64) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) sums[bl * PS + 4 * wn + nt] = s8[nt];
      continue;
    }
    // nint 8, 16, 32: NTW * 8 / nint consecutive outputs of this beam.
    const int n = NTW * 8 / nint;
    const int o0 = (t0 + 32 * wn) / nint;
    float o[NTW] = {s8[0], s8[1], s8[2], s8[3]};
    if (nint == 16) {
      o[0] = s8[0] + s8[1];
      o[1] = s8[2] + s8[3];
    } else if (nint == 32) {
      o[0] = s8[0] + s8[1] + s8[2] + s8[3];
    }
    if (!bok) continue;
    if (n == 4 && nout % 4 == 0 && (o0 + 4) * nint <= a.ntime) {
      *reinterpret_cast<float4*>(orow + o0) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < NTW; ++k) {
        if (k < n && (o0 + k) * nint < a.ntime) orow[o0 + k] = o[k];
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
  if (nint < 64) return;
  __syncthreads();
  // Groups of nint / 8 eight-sample sums, added in order; consecutive
  // threads store consecutive outputs of a beam row.
  const int per = nint >> 3, nt_out = NB / nint;
  for (int i = threadIdx.x; i < BB * nt_out; i += NTHREADS) {
    const int bl = i / nt_out, ol = i % nt_out;
    const float* p = sums + bl * PS + ol * per;
    float s = p[0];
    for (int k = 1; k < per; ++k) s += p[k];
    const int t = t0 + ol * nint;
    if (it.bt * BB + bl < a.nbeam && t < a.ntime) {
      a.out[(orow0 + (size_t)bl * a.npol) * nout + t / nint] = s;
    }
  }
}

// Persistent: block x walks items [x * items / grid, (x+1) * items / grid),
// each item's antenna chunks in order, through NSLOT stage slots: stage
// s + NSLOT - 1 is issued once stage s is in and the slot it refills,
// stage s - 1's, has been read by every warp.
template <typename T, bool AL>
__global__ void __launch_bounds__(NTHREADS, Geo<T>::MINB)
beamform_detect_kernel(Args a) {
  using S = Slot<T>;
  constexpr int NSLOT = S::NSLOT;
  extern __shared__ __align__(16) uint32_t smem[];
  float* sums = reinterpret_cast<float*>(smem + NSLOT * S::WORDS);
  const long long i0 = a.items * blockIdx.x / gridDim.x;
  const long long i1 = a.items * (blockIdx.x + 1) / gridDim.x;
  const long long nstage = (i1 - i0) * a.nck;
  long long tag[NSLOT];  // the weight tile each slot holds
#pragma unroll
  for (int k = 0; k < NSLOT; ++k) tag[k] = -1;
  if (nstage == 0) return;
  Cursor in(a, i0), done = in;  // the next stage to issue, to compute

  auto stage = [&](long long s) {
    if (s >= nstage) return;
    const int sl = (int)(s % NSLOT);
    const long long w = ((long long)in.c * a.nbt + in.bt) * a.nck + in.ka;
    bool with_w = true;
#pragma unroll
    for (int k = 0; k < NSLOT; ++k) {
      if (k == sl) {
        with_w = tag[k] != w;
        tag[k] = w;
      }
    }
    issue<T, AL>(a, smem + sl * S::WORDS, in, with_w);
    in.next(a);
  };

  Acc acc;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < NSLOT - 1; ++k) {
    stage(k);
    cp_commit();
  }
  for (long long s = 0; s < nstage; ++s) {
    cp_wait<NSLOT - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1
    compute(smem + (s % NSLOT) * S::WORDS, acc, static_cast<const T*>(nullptr));
    stage(s + NSLOT - 1);
    cp_commit();
    if (done.ka == a.nck - 1) epilogue(a, done, acc, sums);
    done.next(a);
  }
}

template <typename T, bool AL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // The SM count and the shared-memory opt-in, once a device.
  static int nsm[32] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (nsm[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(beamform_detect_kernel<T, AL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Slot<T>::SMEM);
    if (err != cudaSuccess) return err;
    nsm[dev] = n;
  }
  const long long cap = (long long)Geo<T>::MINB * nsm[dev];
  const long long grid = a.items < cap ? a.items : cap;
  beamform_detect_kernel<T, AL><<<(unsigned)grid, NTHREADS, Slot<T>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(Args a, cudaStream_t stream) {
  constexpr int KA = Slot<T>::KA;
  a.nck = (a.nant + KA - 1) / KA;
  const size_t es = sizeof(T);
  const bool al = ((size_t)a.ntime * es) % 16 == 0 && ((size_t)a.nant * es) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.vr) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.vi) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.wr) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.wi) % 16 == 0;
  return al ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

extern "C" {

int beamform_detect_launch(const void* vr, const void* vi, const void* wr,
                           const void* wi, void* out, int nchan, int nant,
                           int nbeam, int npol, int ntime, int nint,
                           int bf16, void* stream) {
  if (nint < 1 || nint > MAX_NINT || (nint & (nint - 1)) || ntime % nint ||
      nchan < 1 || nant < 1 || nbeam < 1 || npol < 1 || ntime < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{vr, vi, wr, wi, static_cast<float*>(out), nchan, nant, nbeam, npol,
         ntime, nint, 0, (nbeam + BB - 1) / BB, (ntime + NB - 1) / NB, 0};
  a.items = (long long)nchan * a.nbt * npol * a.ntt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_t<__nv_bfloat16>(a, s) : launch_t<float>(a, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
