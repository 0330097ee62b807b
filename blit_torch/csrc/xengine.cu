// xengine.cu — the FX correlator's X-engine, packed visibility layout.
//
// Replaces the TPU kernel blit/ops/pallas_xengine.py:xengine_packed (body
// _kernel) with its contract:
//   in : spectra (sr, si), each (nant, nchan, npol, nframes, nfft), f32 or
//        bf16, the fine-channel axis contiguous (the other strides are
//        passed, so a slice of frames needs no copy);
//   out: f32 (vr, vi), each (nchan, nfft, nap, nap), nap = nant*npol,
//        V[c,f,ap,bq] = sum_t S[a,c,p,t,f] * conj(S[b,c,q,t,f]),
//        ap = a*npol + p (antenna-major): vr = sum rr + ii, vi = sum ir - ri.
//
// What bounds it on an H100: V is Hermitian, so the function needs the
// products of one half, 4 * nap * (nap + 1) flops per (frame, channel,
// fine channel); at the array scale (64 antennas, 2 pols, 16 channels,
// nfft 512, 61 frames) 33.0 GFLOP, 0.49 ms on the f32 CUDA cores, against
// 0.47 ms for its bytes (0.51 GB of spectra in, 1.07 GB of visibilities
// out); bf16 on the tensor cores is bound by its bytes (0.40 ms).
// Design:
//   - per (channel, fine channel) V is an nap x nap product of the spectra
//     with their conjugate transpose.  It is cut into 32 x 32 tiles, and
//     only the tiles (I, J) on and above the diagonal are computed:
//     T(T+1)/2 tile pairs (T = ceil(nap / 32); 10 at nap = 128, where the
//     full product has 16).  An off-diagonal tile stores itself and its
//     conjugate transpose (vr[bq,ap] = vr[ap,bq], vi[bq,ap] = -vi[ap,bq]);
//     a diagonal tile stores its upper half and mirrors it into its lower
//     half, its diagonal vi exactly 0, so V is exactly Hermitian;
//   - pack_kernel first copies the spectra into a packed layout (as blit
//     packs them with an XLA transpose): per (channel, fine channel) the
//     rows ap contiguous, frame after frame, through 32 x 32 tiles of
//     shared memory, so that it reads 128-byte runs of fine channels and
//     writes 128-byte runs of rows, whatever the spectra's strides; a bf16
//     word holds frames 2k and 2k+1 of one row, the k-pair an MMA fragment
//     register takes;
//   - a work item is (channel, fine channel, 5 consecutive tile pairs); a
//     block's 5 warps take one pair each and hold its 32 x 32 complex sums
//     in registers (64 a lane).  The tiles the item's pairs touch (at most
//     6; 4 and 3 for the two items of nap = 128) are staged once for all
//     five, 8 words of each row a chunk, with 16-byte cp.async copies of
//     128-byte runs of the packed spectra; the next chunk (or the next
//     item's first) is in flight while the block computes on this one.
//     Every thread derives its item's tiles from the item's index (Item);
//   - bf16: mma.sync m16n8k16 bf16 -> f32 on the tensor cores, the four
//     real products per complex product as blit's _kernel takes them
//     (vr += Ar Ar^T + Ai Ai^T, vi += Ai Ar^T + (-Ar) Ai^T), 16 frames a
//     chunk, the frame axis padded with zeros to the MMA depth;
//   - f32: the same products in three tf32 passes (x = xh + xl: xl yh +
//     xh yl + xh yh, m16n8k8), each 8-frame chunk summed from zero and
//     added to the running f32 sums, so the tensor cores' sums stay short
//     and the result stays within the f32 bounds (single-pass tf32, with
//     an error of ~5e-4 a product, would not).  Exact f32 FMAs on the CUDA
//     cores issue about four times the instructions here and measured
//     slower on the H100 (PERF.md);
//   - a persistent block walks over the items; two or three blocks share
//     an SM, so one's write-back overlaps the others' products, and the
//     next item's first chunk loads while this item's sums leave.  Each
//     warp writes its tile back alone, through a padded 32 x 33 tile of
//     shared memory of its own (no block barrier): every store instruction
//     is one (fine channel, row) run of 32 floats, 128 bytes, for the tile
//     and for its transpose alike;
//   - every output is summed over frames in time order by one lane (f32
//     FMAs) or one MMA chain (chunk by chunk): no atomics, no split over
//     frames, and an output depends only on its (channel, fine channel)
//     and the frames of the call, so a windowed stream that adds the
//     windows' tiles equals the one-shot call with the same windows
//     bitwise;
//   - element offsets are 64-bit, so the spectra may be of any size the
//     card holds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;             // tile rows and columns
constexpr int NW = 5;                // warps a block, tile pairs an item
constexpr int NTHREADS = 32 * NW;
constexpr int MAXSLOT = 6;           // tiles 5 consecutive pairs touch
constexpr int WB = TILE * (TILE + 1);  // a warp's write-back tile

// A chunk's staging: KW words of each row of each staged tile (f32 words
// hold one frame, bf16 words two), RT words a (word, tile) (the tile's 32
// rows and a pad that puts the MMA fragments' 8 rows x 4 words on 32
// banks), a tile of both planes SLOT words, a stage buffer STAGE; shared
// memory: two stage buffers and the warps' write-back tiles.
constexpr int KW = 8;
constexpr int RT = TILE + 8;
constexpr int SLOT = 2 * KW * RT;
constexpr int STAGE = MAXSLOT * SLOT;
constexpr int SMEM_WORDS = 2 * STAGE + NW * WB;

struct Args {
  const void* sr;
  const void* si;
  float* vr;
  float* vi;
  uint32_t* q;  // the packed spectra, two planes of qplane words
  size_t qplane;
  int nchan, npol, nframes, nfft, nap, napp, nkw, ntiles, ngroups;
  long long s_ant, s_chan, s_pol, s_frame, npairs, items;
};

// The packed spectra: per plane, word (c, f, k, ap) at ((c * nfft + f) *
// nkw + k) * napp + ap: f32 frame k, bf16 frames 2k (low half) and 2k+1
// (zeros past nframes), of row ap = a*npol + p; napp = nap rounded up to
// 4, so every row run starts on 16 bytes.
constexpr int PT = 32;  // a pack tile's fine channels and rows
constexpr int PACK_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(Args a) {
  __shared__ uint32_t tile[2][PT][PT + 1];
  const T* src[2] = {static_cast<const T*>(a.sr), static_cast<const T*>(a.si)};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntf = (a.nfft + PT - 1) / PT, nta = (a.nap + PT - 1) / PT;
  const long long tiles = (long long)a.nchan * a.nkw * ntf * nta;
  for (long long g = blockIdx.x; g < tiles; g += gridDim.x) {
    const int ta = (int)(g % nta);
    long long r = g / nta;
    const int tf = (int)(r % ntf);
    r /= ntf;
    const int k = (int)(r % a.nkw);
    const int c = (int)(r / a.nkw);
    // Read: lane = fine channel, rows warp + 8j.
    const int f = tf * PT + lane;
#pragma unroll
    for (int j = 0; j < PT / 8; ++j) {
      const int row = warp + 8 * j;
      const int ap = ta * PT + row;
      uint32_t v[2] = {0u, 0u};
      if (ap < a.nap && f < a.nfft) {
        const long long off = (ap / a.npol) * a.s_ant + c * a.s_chan +
                              (ap % a.npol) * a.s_pol + f;
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          if constexpr (sizeof(T) == 4) {
            v[pl] = __ldg(reinterpret_cast<const unsigned int*>(src[pl] + off + k * a.s_frame));
          } else {
            const unsigned short* p =
                reinterpret_cast<const unsigned short*>(src[pl] + off + 2LL * k * a.s_frame);
            v[pl] = __ldg(p);
            if (2 * k + 1 < a.nframes) v[pl] |= (uint32_t)__ldg(p + a.s_frame) << 16;
          }
        }
      }
      tile[0][lane][row] = v[0];
      tile[1][lane][row] = v[1];
    }
    __syncthreads();
    // Write: lane = row, fine channels warp + 8j.
    const int ap = ta * PT + lane;
#pragma unroll
    for (int j = 0; j < PT / 8; ++j) {
      const int fl = warp + 8 * j;
      const int fg = tf * PT + fl;
      if (fg < a.nfft && ap < a.nap) {
        const size_t o = (((size_t)c * a.nfft + fg) * a.nkw + k) * a.napp + ap;
        a.q[o] = tile[0][fl][lane];
        a.q[a.qplane + o] = tile[1][fl][lane];
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp16(uint32_t* dst, const void* src, int bytes) {
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

// Tile pair p: (I, J), I <= J, row by row of the upper triangle: (0,0)
// (0,1) .. (0,T-1) (1,1) ..  (ops/xengine.py tile_pairs).
__device__ __forceinline__ void pair_tiles(long long p, int ntiles, int& i,
                                           int& j) {
  i = 0;
  while (p >= ntiles - i) {
    p -= ntiles - i;
    ++i;
  }
  j = i + (int)p;
}

// Item w: channel c, fine channel f, group g = w % ngroups, which takes
// tile pairs 5g .. 5g+4 (those below npairs), one a warp: the distinct
// tiles they touch (nslot of them, tile s staged in slot s, in the order
// the pairs first touch them) and the calling warp's pair: tiles (i, j),
// slots (sa, sb); i = -1: none.  Every thread derives the same, in
// registers.
struct Item {
  int c, f, nslot, i, j, sa, sb;
  int tile[MAXSLOT];

  __device__ __forceinline__ Item(const Args& a, long long w) {
    long long g;
    if (a.items <= 0x7fffffffLL) {  // 32-bit division where it suffices
      const unsigned u = (unsigned)w, rest = u / (unsigned)a.ngroups;
      g = u - rest * (unsigned)a.ngroups;
      c = (int)(rest / (unsigned)a.nfft);
      f = (int)(rest - (unsigned)c * (unsigned)a.nfft);
    } else {
      const long long rest = w / a.ngroups;
      g = w - rest * a.ngroups;
      c = (int)(rest / a.nfft);
      f = (int)(rest - (long long)c * a.nfft);
    }
    nslot = 0;
#pragma unroll
    for (int k = 0; k < MAXSLOT; ++k) tile[k] = 0;
    i = j = -1;
    sa = sb = 0;
    const int me = threadIdx.x >> 5;
    int pi, pj;
    pair_tiles(g * NW, a.ntiles, pi, pj);
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      if (g * NW + u < a.npairs) {
        const int s0 = slot(pi), s1 = slot(pj);
        if (u == me) i = pi, j = pj, sa = s0, sb = s1;
        if (++pj == a.ntiles) pj = ++pi;
      }
    }
  }
  // The slot of tile x, given a new one if no earlier pair touched it (5
  // consecutive pairs touch at most 6 tiles: 2, then 1 a pair).
  __device__ __forceinline__ int slot(int x) {
    int s = nslot;
#pragma unroll
    for (int k = MAXSLOT - 1; k >= 0; --k) {
      if (k < nslot && tile[k] == x) s = k;
    }
    if (s == nslot) {
#pragma unroll
      for (int k = 0; k < MAXSLOT; ++k) {
        if (k == nslot) tile[k] = x;
      }
      ++nslot;
    }
    return s;
  }
  __device__ __forceinline__ int tile_of(int s) const {
    int x = 0;
#pragma unroll
    for (int k = 0; k < MAXSLOT; ++k) {
      if (k == s) x = tile[k];
    }
    return x;
  }
};

// Stage chunk k (row words KW*k ..) of item `it` into stage buffer `buf`:
// word (slot, plane, kw, row) at buf*STAGE + slot*SLOT + plane*KW*RT +
// kw*RT + row; the 32 rows of one (slot, plane, kw) are one 128-byte run
// of the packed spectra, copied in 16-byte pieces.  Words past nap or
// nkw are zeros.
__device__ __forceinline__ void issue(const Args& a, uint32_t* smem,
                                      const Item& it, int k, int buf) {
  const size_t row0 = ((size_t)it.c * a.nfft + it.f) * a.nkw;
  for (int e = threadIdx.x; e < it.nslot * 2 * KW * 8; e += NTHREADS) {
    const int q = e & 7, kw = (e >> 3) % KW, plane = (e >> 3) / KW % 2;
    const int slot = (e >> 3) / (2 * KW);
    const int row = it.tile_of(slot) * TILE + 4 * q;
    const int kwg = k * KW + kw;
    const bool ok = kwg < a.nkw && row < a.nap;
    const size_t src = ok ? (row0 + kwg) * a.napp + row : 0;
    cp16(smem + buf * STAGE + slot * SLOT + plane * KW * RT + kw * RT + 4 * q,
         a.q + plane * a.qplane + src, ok ? min(4, a.nap - row) * 4 : 0);
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
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// The sums of a warp's 32 x 32 tile as MMA accumulator fragments: tiles of
// 16 x 8, two down (mt) and four across (nt); lane (g, q) = (lane / 4,
// lane % 4) holds rows g, g+8 and columns 2q, 2q+1 of each.  On a
// diagonal tile the two fragments below the diagonal (mt 1, nt 0 and 1)
// are not computed: the write-back mirrors the upper half.
struct MmaAcc {
  float r[2][4][4], i[2][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[mt][nt][e] = i[mt][nt][e] = 0.f;
      }
    }
  }
  static __device__ __forceinline__ bool below(bool diag, int mt, int nt) {
    return diag && mt > nt / 2;
  }
  __device__ __forceinline__ void to_tile(float* wb, bool imag) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + (e >> 1) * 8;
          const int col = 8 * nt + 2 * q + (e & 1);
          wb[row * (TILE + 1) + col] = imag ? i[mt][nt][e] : r[mt][nt][e];
        }
      }
    }
  }
};

// f32 in three tf32 passes on the tensor cores, one m16n8k8 step a chunk:
// x y = xl yh + xh yl + xh yh to a relative 2^-21.  Each chunk's sums start
// from zero and join the running sums in an f32 add, so the tensor cores'
// sums stay short (8 frames): the error stays near that of f32 FMAs.
struct AccTf32 : MmaAcc {
  __device__ __forceinline__ void chunk(const uint32_t* a_, const uint32_t* b_,
                                        bool diag) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const float* a = reinterpret_cast<const float*>(a_);
    const float* b = reinterpret_cast<const float*>(b_);
    // A fragments: rows g, g+8 at frames q (registers 0, 1) and q+4 (2, 3).
    uint32_t ah[2][2][4], al[2][2][4];  // [mt][plane][register]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split(a[(pl * KW + q + 4 * (e >> 1)) * RT + 16 * mt + g + 8 * (e & 1)],
                ah[mt][pl][e], al[mt][pl][e]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh[3][2], bl[3][2];  // Br, Bi, -Bi at frames q, q+4
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          split(b[(pl * KW + q + 4 * e) * RT + 8 * nt + g], bh[pl][e], bl[pl][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bh[2][e] = bh[1][e] ^ 0x80000000u;
        bl[2][e] = bl[1][e] ^ 0x80000000u;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (below(diag, mt, nt)) continue;
        auto mma3 = [&](float* d, int pa, int pb) {
          mma_tf32(d, al[mt][pa], bh[pb][0], bh[pb][1]);
          mma_tf32(d, ah[mt][pa], bl[pb][0], bl[pb][1]);
          mma_tf32(d, ah[mt][pa], bh[pb][0], bh[pb][1]);
        };
        float tr[4] = {0.f, 0.f, 0.f, 0.f}, ti[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(tr, 0, 0);  // vr += Ar Br^T + Ai Bi^T
        mma3(tr, 1, 1);
        mma3(ti, 1, 0);  // vi += Ai Br^T - Ar Bi^T
        mma3(ti, 0, 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          r[mt][nt][e] += tr[e];
          i[mt][nt][e] += ti[e];
        }
      }
    }
  }
};

// bf16 on the tensor cores, one m16n8k16 step a chunk (16 frames): a
// staged word (one row, frames 2k, 2k+1) is one fragment register, the
// products exact in f32, f32 sums.
struct AccBf16 : MmaAcc {
  __device__ __forceinline__ void chunk(const uint32_t* a, const uint32_t* b,
                                        bool diag) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    uint32_t ar[2][4], ai[2][4], an[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = (q + 4 * (e >> 1)) * RT + 16 * mt + g + 8 * (e & 1);
        ar[mt][e] = a[w];
        ai[mt][e] = a[KW * RT + w];
        an[mt][e] = ar[mt][e] ^ 0x80008000u;  // -Ar
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c0 = 8 * nt + g;
      const uint32_t br0 = b[q * RT + c0], br1 = b[(q + 4) * RT + c0];
      const uint32_t bi0 = b[(KW + q) * RT + c0], bi1 = b[(KW + q + 4) * RT + c0];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (below(diag, mt, nt)) continue;
        mma_bf16(r[mt][nt], ar[mt], br0, br1);  // vr += Ar Br^T + Ai Bi^T
        mma_bf16(r[mt][nt], ai[mt], bi0, bi1);
        mma_bf16(i[mt][nt], ai[mt], br0, br1);  // vi += Ai Br^T - Ar Bi^T
        mma_bf16(i[mt][nt], an[mt], bi0, bi1);
      }
    }
  }
};

// One warp stores its tile of item `it`, both planes, through wb: every
// instruction stores one row of 32 floats.  Off the diagonal also the
// conjugate transpose; on it the upper half and its mirror, vi's
// diagonal exactly 0.
template <class Acc>
__device__ __forceinline__ void write_back(const Args& a, const Acc& acc,
                                           float* wb, const Item& it) {
  const int lane = threadIdx.x & 31;
  const int i0 = it.i * TILE, j0 = it.j * TILE;
  const int nr = min(TILE, a.nap - i0);  // rows of I that exist
  const int nc = min(TILE, a.nap - j0);  // and of J
  const size_t nap = a.nap;
  const size_t base = ((size_t)it.c * a.nfft + it.f) * nap * nap;
#pragma unroll
  for (int im = 0; im < 2; ++im) {
    const float sgn = im ? -1.f : 1.f;
    float* out = (im ? a.vi : a.vr) + base;
    acc.to_tile(wb, im);
    __syncwarp();
    float* o = out + i0 * nap + j0 + lane;
    if (i0 == j0) {
      for (int r = 0; r < nr; ++r, o += nap) {
        float v = lane >= r ? wb[r * (TILE + 1) + lane]
                            : sgn * wb[lane * (TILE + 1) + r];
        if (im && lane == r) v = 0.f;
        if (lane < nc) __stcs(o, v);
      }
    } else {
      for (int r = 0; r < nr; ++r, o += nap) {
        if (lane < nc) __stcs(o, wb[r * (TILE + 1) + lane]);
      }
      o = out + j0 * nap + i0 + lane;
      for (int c = 0; c < nc; ++c, o += nap) {
        if (lane < nr) __stcs(o, sgn * wb[lane * (TILE + 1) + c]);
      }
    }
    __syncwarp();
  }
}

// A persistent block walks over the items w = blockIdx.x, + gridDim.x, ..;
// each item over its chunks of frames.  The chunk after this one (or the
// next item's first) is staged into the other buffer while this one is
// summed; one barrier a chunk.
template <class Acc, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB) xengine_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  float* wb = reinterpret_cast<float*>(smem + 2 * STAGE) + (threadIdx.x >> 5) * WB;
  long long w = blockIdx.x;
  if (w >= a.items) return;
  Item it(a, w);
  issue(a, smem, it, 0, 0);
  cp_commit();
  Acc acc;
  acc.zero();
  for (int k = 0, buf = 0;; buf ^= 1) {
    cp_wait_all();
    __syncthreads();  // chunk k is here; the other buffer is free
    const bool last = k == (a.nkw + KW - 1) / KW - 1;
    const long long wn = last ? w + gridDim.x : w;
    const Item next = last && wn < a.items ? Item(a, wn) : it;
    if (wn < a.items) issue(a, smem, next, last ? 0 : k + 1, buf ^ 1);
    cp_commit();
    if (it.i >= 0) {
      const uint32_t* s = smem + buf * STAGE;
      acc.chunk(s + it.sa * SLOT, s + it.sb * SLOT, it.i == it.j);
    }
    if (!last) {
      ++k;
      continue;
    }
    if (it.i >= 0) write_back(a, acc, wb, it);
    if (wn >= a.items) break;
    acc.zero();
    w = wn;
    it = next;
    k = 0;
  }
}

// How many blocks of `kernel` the card holds at once.
template <class K>
cudaError_t slots(K kernel, int threads, int smem, long long* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *n = (long long)per_sm * sms;
  return cudaSuccess;
}

// The pack, then the products, on `stream`: Acc the arithmetic, MINB the
// blocks an SM holds (its registers: 128 a thread at 3, 204 at 2).
template <typename T, class Acc, int MINB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  long long n = 0;
  cudaError_t err = slots(pack_kernel<T>, PACK_THREADS, 0, &n);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)a.nchan * a.nkw *
                          ((a.nfft + PT - 1) / PT) * ((a.nap + PT - 1) / PT);
  pack_kernel<T><<<(unsigned)(tiles < n ? tiles : n), PACK_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto kernel = xengine_kernel<Acc, MINB>;
  const int smem = SMEM_WORDS * 4;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if ((err = slots(kernel, NTHREADS, smem, &n)) != cudaSuccess) return err;
  kernel<<<(unsigned)(a.items < n ? a.items : n), NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

long long words_a_row(int nframes, int bf16) {
  return bf16 ? (nframes + 1) / 2 : nframes;
}

}  // namespace

extern "C" {

// 4-byte words of the scratch `q` that xengine_launch takes: the packed
// spectra, both planes.
long long xengine_scratch_words(int nant, int nchan, int npol, int nframes,
                                int nfft, int bf16) {
  const long long nap = (long long)nant * npol;
  return 2 * (long long)nchan * nfft * words_a_row(nframes, bf16) *
         ((nap + 3) / 4 * 4);
}

int xengine_launch(const void* sr, const void* si, void* vr, void* vi,
                   void* q, long long q_words, int nant, int nchan, int npol,
                   int nframes, int nfft, long long s_ant, long long s_chan,
                   long long s_pol, long long s_frame, int bf16,
                   void* stream) {
  if (nant < 1 || nchan < 1 || npol < 1 || nframes < 1 || nfft < 1 ||
      (long long)nant * npol > 0x7fffff00LL ||
      q_words != xengine_scratch_words(nant, nchan, npol, nframes, nfft, bf16) ||
      (reinterpret_cast<uintptr_t>(q) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.sr = sr;
  a.si = si;
  a.vr = static_cast<float*>(vr);
  a.vi = static_cast<float*>(vi);
  a.q = static_cast<uint32_t*>(q);

  a.nchan = nchan;
  a.npol = npol;
  a.nframes = nframes;
  a.nfft = nfft;
  a.nap = nant * npol;
  a.napp = (a.nap + 3) / 4 * 4;
  a.nkw = (int)words_a_row(nframes, bf16);
  a.ntiles = (a.nap + TILE - 1) / TILE;
  a.npairs = (long long)a.ntiles * (a.ntiles + 1) / 2;
  a.ngroups = (int)((a.npairs + NW - 1) / NW);
  a.qplane = (size_t)nchan * nfft * a.nkw * a.napp;
  a.s_ant = s_ant;
  a.s_chan = s_chan;
  a.s_pol = s_pol;
  a.s_frame = s_frame;
  a.items = (long long)nchan * nfft * a.ngroups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16, AccBf16, 3>(a, s)
                               : launch<float, AccTf32, 2>(a, s);
  return (int)err;
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
