// Bitshuffle + LZ4 codec for FBH5 chunks — the C++ rebuild of the
// reference's H5Zbitshuffle dependency (SURVEY.md §2.3: bitshuffle C library
// with SSE2/AVX2 kernels wrapped by H5Zbitshuffle.jl, Project.toml:9).
//
// Implements the bitshuffle on-disk format (HDF5 filter id 32008, LZ4 mode):
//
//   chunk payload := [u64 BE total uncompressed bytes]
//                    [u32 BE block size in bytes]
//                    repeat: [u32 BE compressed size][LZ4 block]
//                    [raw leftover: (nelem % 8) * elem_size bytes]
//
// Each block of `block_size` elements is bit-transposed ("bitshuffled") then
// LZ4-compressed independently.  The bit transpose layout: for a block of n
// elements of elem_size bytes, output row (byte_pos*8 + bit) (bit 0 = LSB)
// holds n/8 bytes; bit j of its byte i is bit `bit` of byte `byte_pos` of
// element 8i+j.  This matches upstream bitshuffle's
// trans_byte_elem → trans_bit_byte → trans_bitrow_eight pipeline.
//
// LZ4 block compression comes from the system liblz4 (stable C ABI,
// prototypes declared below, so no lz4 header is needed to build).
//
// Exposed C ABI (ctypes-consumed by blit_torch/io/bshuf.py):
//   blit_bshuf_shuffle / blit_bshuf_unshuffle    — bit transpose only
//   blit_bshuf_compress_lz4 / _decompress_lz4    — full chunk codec
//   blit_bshuf_compress_bound, blit_bshuf_default_block_size

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {
// liblz4.so.1 ABI (stable since lz4 r129).
int LZ4_compress_default(const char* src, char* dst, int srcSize, int dstCapacity);
int LZ4_decompress_safe(const char* src, char* dst, int compressedSize, int dstCapacity);
int LZ4_compressBound(int inputSize);
}

namespace {

constexpr size_t kBlockedMult = 8;      // elements per bit-transpose unit
constexpr size_t kTargetBlockBytes = 8192;
constexpr size_t kMinBlockElems = 128;

// 8x8 bit-matrix transpose on a little-endian u64 (Hacker's Delight 7-3).
inline void trans_bit_8x8(uint64_t& x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
  x = x ^ t ^ (t << 28);
}

// 8x8 BYTE-matrix transpose on 8 little-endian u64 rows: afterwards byte k
// of r[j] = byte j of the original r[k].  Three levels of block swaps, all
// word-wide — the building block that lets shuffle/unshuffle run on u64
// loads/stores instead of byte-granular strided gathers (the scalar
// reference path below was measured at ~0.1 GB/s/core; this restructure is
// worth ~5x, upstream bitshuffle's SSE2/AVX2 kernels being the model).
inline void trans_byte_8x8(uint64_t r[8]) {
  uint64_t t;
  for (int i = 0; i < 8; i += 2) {
    t = ((r[i] >> 8) ^ r[i + 1]) & 0x00FF00FF00FF00FFULL;
    r[i] ^= t << 8;
    r[i + 1] ^= t;
  }
  for (int i = 0; i < 8; i += 4) {
    for (int j = 0; j < 2; j++) {
      t = ((r[i + j] >> 16) ^ r[i + j + 2]) & 0x0000FFFF0000FFFFULL;
      r[i + j] ^= t << 16;
      r[i + j + 2] ^= t;
    }
  }
  for (int j = 0; j < 4; j++) {
    t = ((r[j] >> 32) ^ r[j + 4]) & 0x00000000FFFFFFFFULL;
    r[j] ^= t << 32;
    r[j + 4] ^= t;
  }
}

// Scalar reference paths (tail handling + elem_size > 8).
void shuffle_scalar(const uint8_t* in, uint8_t* out, size_t nelem,
                    size_t elem_size, size_t nrow_bytes, size_t i0,
                    size_t i1) {
  (void)nelem;
  for (size_t b = 0; b < elem_size; b++) {
    for (size_t i = i0; i < i1; i++) {
      // Gather byte `b` of elements 8i..8i+7 into a u64 (byte j = elem 8i+j).
      uint64_t x = 0;
      for (size_t j = 0; j < 8; j++) {
        x |= (uint64_t)in[(8 * i + j) * elem_size + b] << (8 * j);
      }
      trans_bit_8x8(x);
      // After transpose, byte k of x = bit k of the 8 gathered bytes.
      for (size_t k = 0; k < 8; k++) {
        out[(b * 8 + k) * nrow_bytes + i] = (uint8_t)(x >> (8 * k));
      }
    }
  }
}

void unshuffle_scalar(const uint8_t* in, uint8_t* out, size_t nelem,
                      size_t elem_size, size_t nrow_bytes, size_t i0,
                      size_t i1) {
  (void)nelem;
  for (size_t b = 0; b < elem_size; b++) {
    for (size_t i = i0; i < i1; i++) {
      uint64_t x = 0;
      for (size_t k = 0; k < 8; k++) {
        x |= (uint64_t)in[(b * 8 + k) * nrow_bytes + i] << (8 * k);
      }
      trans_bit_8x8(x);  // involution: same transpose inverts
      for (size_t j = 0; j < 8; j++) {
        out[(8 * i + j) * elem_size + b] = (uint8_t)(x >> (8 * j));
      }
    }
  }
}

#if defined(__AVX2__)

// ---- AVX2 fast paths (elem_size 1/2/4; upstream bitshuffle's SSE2/AVX2
// kernels are the model).  Elements stream through a small L1-resident
// SoA staging buffer: byte planes are (de)interleaved with SSE unpack
// pyramids, bit planes with vpmovmskb (shuffle) / a shuffle_epi8+cmpeq
// bit-expand (unshuffle) — ~1.5 instructions per byte instead of the u64
// path's ~3 word ops per 8 bytes.

constexpr size_t kChunkElems = 512;  // SoA staging chunk; 8 planes = 4 KB

// Expand the 32 bits of `w` into 32 bytes: byte e = 0xFF iff bit e set.
inline __m256i expand_bits_32(uint32_t w) {
  __m256i v = _mm256_set1_epi32((int)w);
  // shuffle_epi8 is lane-local; the word is replicated in both lanes, so
  // lane-local source bytes 0..3 are the word's bytes in each lane.
  const __m256i sel = _mm256_setr_epi8(
      0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
      2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3);
  v = _mm256_shuffle_epi8(v, sel);
  const __m256i bits = _mm256_set1_epi64x((long long)0x8040201008040201ULL);
  v = _mm256_and_si256(v, bits);
  return _mm256_cmpeq_epi8(v, bits);
}

// SoA byte planes -> interleaved elements (16-byte SSE unpack pyramid).
void interleave_soa(const uint8_t soa[8][kChunkElems], uint8_t* out,
                    size_t n, size_t es) {
  if (es == 1) {
    std::memcpy(out, soa[0], n);
    return;
  }
  if (es == 2) {
    for (size_t c = 0; c < n; c += 16) {
      __m128i a = _mm_loadu_si128((const __m128i*)(soa[0] + c));
      __m128i b = _mm_loadu_si128((const __m128i*)(soa[1] + c));
      _mm_storeu_si128((__m128i*)(out + 2 * c),
                       _mm_unpacklo_epi8(a, b));
      _mm_storeu_si128((__m128i*)(out + 2 * c + 16),
                       _mm_unpackhi_epi8(a, b));
    }
    return;
  }
  // es == 4
  for (size_t c = 0; c < n; c += 16) {
    __m128i a = _mm_loadu_si128((const __m128i*)(soa[0] + c));
    __m128i b = _mm_loadu_si128((const __m128i*)(soa[1] + c));
    __m128i cc = _mm_loadu_si128((const __m128i*)(soa[2] + c));
    __m128i d = _mm_loadu_si128((const __m128i*)(soa[3] + c));
    __m128i ab_lo = _mm_unpacklo_epi8(a, b);
    __m128i ab_hi = _mm_unpackhi_epi8(a, b);
    __m128i cd_lo = _mm_unpacklo_epi8(cc, d);
    __m128i cd_hi = _mm_unpackhi_epi8(cc, d);
    uint8_t* o = out + 4 * c;
    _mm_storeu_si128((__m128i*)(o), _mm_unpacklo_epi16(ab_lo, cd_lo));
    _mm_storeu_si128((__m128i*)(o + 16), _mm_unpackhi_epi16(ab_lo, cd_lo));
    _mm_storeu_si128((__m128i*)(o + 32), _mm_unpacklo_epi16(ab_hi, cd_hi));
    _mm_storeu_si128((__m128i*)(o + 48), _mm_unpackhi_epi16(ab_hi, cd_hi));
  }
}

// Interleaved elements -> SoA byte planes (stride-gather shuffles).
void deinterleave_aos(const uint8_t* in, uint8_t soa[8][kChunkElems],
                      size_t n, size_t es) {
  if (es == 1) {
    std::memcpy(soa[0], in, n);
    return;
  }
  if (es == 2) {
    const __m128i sel = _mm_setr_epi8(0, 2, 4, 6, 8, 10, 12, 14,
                                      1, 3, 5, 7, 9, 11, 13, 15);
    for (size_t c = 0; c < n; c += 16) {
      __m128i x0 = _mm_shuffle_epi8(
          _mm_loadu_si128((const __m128i*)(in + 2 * c)), sel);
      __m128i x1 = _mm_shuffle_epi8(
          _mm_loadu_si128((const __m128i*)(in + 2 * c + 16)), sel);
      _mm_storeu_si128((__m128i*)(soa[0] + c),
                       _mm_unpacklo_epi64(x0, x1));
      _mm_storeu_si128((__m128i*)(soa[1] + c),
                       _mm_unpackhi_epi64(x0, x1));
    }
    return;
  }
  // es == 4
  const __m128i sel = _mm_setr_epi8(0, 4, 8, 12, 1, 5, 9, 13,
                                    2, 6, 10, 14, 3, 7, 11, 15);
  for (size_t c = 0; c < n; c += 16) {
    const uint8_t* p = in + 4 * c;
    __m128i x0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)p), sel);
    __m128i x1 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(p + 16)), sel);
    __m128i x2 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(p + 32)), sel);
    __m128i x3 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(p + 48)), sel);
    __m128i t0 = _mm_unpacklo_epi32(x0, x1);
    __m128i t1 = _mm_unpackhi_epi32(x0, x1);
    __m128i t2 = _mm_unpacklo_epi32(x2, x3);
    __m128i t3 = _mm_unpackhi_epi32(x2, x3);
    _mm_storeu_si128((__m128i*)(soa[0] + c), _mm_unpacklo_epi64(t0, t2));
    _mm_storeu_si128((__m128i*)(soa[1] + c), _mm_unpackhi_epi64(t0, t2));
    _mm_storeu_si128((__m128i*)(soa[2] + c), _mm_unpacklo_epi64(t1, t3));
    _mm_storeu_si128((__m128i*)(soa[3] + c), _mm_unpackhi_epi64(t1, t3));
  }
}

void shuffle_avx2(const uint8_t* in, uint8_t* out, size_t nelem,
                  size_t elem_size) {
  const size_t nrow_bytes = nelem / 8;
  alignas(32) uint8_t soa[8][kChunkElems];
  size_t e0 = 0;
  for (; e0 + kChunkElems <= nelem; e0 += kChunkElems) {
    deinterleave_aos(in + e0 * elem_size, soa, kChunkElems, elem_size);
    for (size_t b = 0; b < elem_size; b++) {
      for (size_t c = 0; c < kChunkElems; c += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(soa[b] + c));
        for (size_t k = 8; k-- > 0;) {
          // vpmovmskb takes each byte's MSB: after 7-k doublings the MSB
          // is original bit k; bit j of the mask = element (c+j).
          uint32_t w = (uint32_t)_mm256_movemask_epi8(x);
          std::memcpy(out + (b * 8 + k) * nrow_bytes + e0 / 8 + c / 8,
                      &w, 4);
          x = _mm256_add_epi8(x, x);
        }
      }
    }
  }
  if (e0 < nelem) {
    shuffle_scalar(in, out, nelem, elem_size, nrow_bytes, e0 / 8,
                   nrow_bytes);
  }
}

void unshuffle_avx2(const uint8_t* in, uint8_t* out, size_t nelem,
                    size_t elem_size) {
  const size_t nrow_bytes = nelem / 8;
  alignas(32) uint8_t soa[8][kChunkElems];
  size_t e0 = 0;
  for (; e0 + kChunkElems <= nelem; e0 += kChunkElems) {
    for (size_t b = 0; b < elem_size; b++) {
      for (size_t c = 0; c < kChunkElems; c += 32) {
        __m256i acc = _mm256_setzero_si256();
        for (size_t k = 0; k < 8; k++) {
          uint32_t w;
          std::memcpy(&w, in + (b * 8 + k) * nrow_bytes + e0 / 8 + c / 8,
                      4);
          __m256i m = expand_bits_32(w);
          acc = _mm256_or_si256(
              acc,
              _mm256_and_si256(m, _mm256_set1_epi8((char)(1u << k))));
        }
        _mm256_storeu_si256((__m256i*)(soa[b] + c), acc);
      }
    }
    interleave_soa(soa, out + e0 * elem_size, kChunkElems, elem_size);
  }
  if (e0 < nelem) {
    unshuffle_scalar(in, out, nelem, elem_size, nrow_bytes, e0 / 8,
                     nrow_bytes);
  }
}

#endif  // __AVX2__

// Bitshuffle one block: nelem must be a multiple of 8.
// in: nelem elements of elem_size bytes; out: same byte count.
//
// Fast path (elem_size <= 8): process 8 bit-plane positions (64 elements)
// per step.  Element bytes are gathered with whole-u64 loads + an 8x8 byte
// transpose, bits with the 8x8 bit transpose, and rows stored as u64s —
// no byte-granular strided access anywhere.
void shuffle_block(const uint8_t* in, uint8_t* out, size_t nelem,
                   size_t elem_size) {
  const size_t nrow_bytes = nelem / 8;  // bytes per bit plane
#if defined(__AVX2__)
  if ((elem_size == 1 || elem_size == 2 || elem_size == 4) &&
      nelem >= kChunkElems) {
    shuffle_avx2(in, out, nelem, elem_size);
    return;
  }
#endif
  if (elem_size > 8 || nrow_bytes < 8) {
    shuffle_scalar(in, out, nelem, elem_size, nrow_bytes, 0, nrow_bytes);
    return;
  }
  const size_t i_fast = nrow_bytes & ~(size_t)7;
  uint64_t vals[8][8];  // [b][i'] — bit-transposed gathers per byte pos
  for (size_t i = 0; i < i_fast; i += 8) {
    for (size_t ip = 0; ip < 8; ip++) {
      // c[j] = the elem_size bytes of element 8(i+ip)+j.
      uint64_t c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      const uint8_t* src = in + 8 * (i + ip) * elem_size;
      for (size_t j = 0; j < 8; j++) {
        std::memcpy(&c[j], src + j * elem_size, elem_size);
      }
      trans_byte_8x8(c);  // c[b] byte j = byte b of element 8(i+ip)+j
      for (size_t b = 0; b < elem_size; b++) {
        uint64_t x = c[b];
        trans_bit_8x8(x);  // byte k = bit k of the 8 gathered bytes
        vals[b][ip] = x;
      }
    }
    for (size_t b = 0; b < elem_size; b++) {
      uint64_t r[8];
      for (size_t ip = 0; ip < 8; ip++) r[ip] = vals[b][ip];
      trans_byte_8x8(r);  // r[k] byte i' = row (b*8+k) byte (i+i')
      for (size_t k = 0; k < 8; k++) {
        std::memcpy(out + (b * 8 + k) * nrow_bytes + i, &r[k], 8);
      }
    }
  }
  if (i_fast < nrow_bytes) {
    shuffle_scalar(in, out, nelem, elem_size, nrow_bytes, i_fast,
                   nrow_bytes);
  }
}

void unshuffle_block(const uint8_t* in, uint8_t* out, size_t nelem,
                     size_t elem_size) {
  const size_t nrow_bytes = nelem / 8;
#if defined(__AVX2__)
  if ((elem_size == 1 || elem_size == 2 || elem_size == 4) &&
      nelem >= kChunkElems) {
    unshuffle_avx2(in, out, nelem, elem_size);
    return;
  }
#endif
  if (elem_size > 8 || nrow_bytes < 8) {
    unshuffle_scalar(in, out, nelem, elem_size, nrow_bytes, 0, nrow_bytes);
    return;
  }
  const size_t i_fast = nrow_bytes & ~(size_t)7;
  uint64_t vals[8][8];  // [b][i'] — byte b of elements 8(i+i')..+7
  for (size_t i = 0; i < i_fast; i += 8) {
    for (size_t b = 0; b < elem_size; b++) {
      uint64_t r[8];
      for (size_t k = 0; k < 8; k++) {
        std::memcpy(&r[k], in + (b * 8 + k) * nrow_bytes + i, 8);
      }
      trans_byte_8x8(r);  // r[i'] byte k = row (b*8+k) byte (i+i')
      for (size_t ip = 0; ip < 8; ip++) {
        uint64_t x = r[ip];
        trans_bit_8x8(x);  // byte j = out byte b of element 8(i+ip)+j
        vals[b][ip] = x;
      }
    }
    for (size_t ip = 0; ip < 8; ip++) {
      uint64_t c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (size_t b = 0; b < elem_size; b++) c[b] = vals[b][ip];
      trans_byte_8x8(c);  // c[j] byte b = out byte b of element 8(i+ip)+j
      uint8_t* dst = out + 8 * (i + ip) * elem_size;
      for (size_t j = 0; j < 8; j++) {
        std::memcpy(dst + j * elem_size, &c[j], elem_size);
      }
    }
  }
  if (i_fast < nrow_bytes) {
    unshuffle_scalar(in, out, nelem, elem_size, nrow_bytes, i_fast,
                     nrow_bytes);
  }
}

inline void store_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
inline void store_be64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (uint8_t)(v >> (56 - 8 * i));
}
inline uint32_t load_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}
inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

}  // namespace

extern "C" {

size_t blit_bshuf_default_block_size(size_t elem_size) {
  size_t bs = kTargetBlockBytes / elem_size;
  bs = (bs / kBlockedMult) * kBlockedMult;
  if (bs < kMinBlockElems) bs = kMinBlockElems;
  return bs;
}

// Bit transpose only (no compression); nelem must be a multiple of 8.
// Returns 0 on success.
int blit_bshuf_shuffle(const void* in, void* out, size_t nelem,
                       size_t elem_size) {
  if (nelem % 8) return -1;
  shuffle_block((const uint8_t*)in, (uint8_t*)out, nelem, elem_size);
  return 0;
}

int blit_bshuf_unshuffle(const void* in, void* out, size_t nelem,
                         size_t elem_size) {
  if (nelem % 8) return -1;
  unshuffle_block((const uint8_t*)in, (uint8_t*)out, nelem, elem_size);
  return 0;
}

int64_t blit_bshuf_compress_bound(size_t nelem, size_t elem_size,
                                  size_t block_elems) {
  if (block_elems == 0) block_elems = blit_bshuf_default_block_size(elem_size);
  size_t nblocks = nelem / block_elems + 2;  // + partial + slack
  size_t block_bytes = block_elems * elem_size;
  return 12 + (int64_t)nblocks * (4 + LZ4_compressBound((int)block_bytes)) +
         8 * elem_size;
}

// Compress nelem elements into the bitshuffle-LZ4 HDF5 chunk format.
// block_elems == 0 -> default.  Returns bytes written, or < 0 on error.
int64_t blit_bshuf_compress_lz4(const void* in_v, void* out_v, size_t nelem,
                                size_t elem_size, size_t block_elems) {
  const uint8_t* in = (const uint8_t*)in_v;
  uint8_t* out = (uint8_t*)out_v;
  if (block_elems == 0) block_elems = blit_bshuf_default_block_size(elem_size);
  if (block_elems % kBlockedMult) return -2;
  const size_t block_bytes = block_elems * elem_size;

  uint8_t* p = out;
  store_be64(p, (uint64_t)nelem * elem_size); p += 8;
  store_be32(p, (uint32_t)block_bytes); p += 4;

  // Scratch for one shuffled block.
  uint8_t* tmp = new uint8_t[block_bytes];
  size_t done = 0;
  while (done + block_elems <= nelem) {
    shuffle_block(in + done * elem_size, tmp, block_elems, elem_size);
    int c = LZ4_compress_default((const char*)tmp, (char*)(p + 4),
                                 (int)block_bytes,
                                 LZ4_compressBound((int)block_bytes));
    if (c <= 0) { delete[] tmp; return -3; }
    store_be32(p, (uint32_t)c);
    p += 4 + c;
    done += block_elems;
  }
  // Final partial block, rounded down to a multiple of 8 elements.
  size_t rem = nelem - done;
  size_t last = rem - rem % kBlockedMult;
  if (last) {
    size_t last_bytes = last * elem_size;
    shuffle_block(in + done * elem_size, tmp, last, elem_size);
    int c = LZ4_compress_default((const char*)tmp, (char*)(p + 4),
                                 (int)last_bytes,
                                 LZ4_compressBound((int)last_bytes));
    if (c <= 0) { delete[] tmp; return -3; }
    store_be32(p, (uint32_t)c);
    p += 4 + c;
    done += last;
  }
  delete[] tmp;
  // Sub-8-element leftover: raw copy, no framing.
  size_t left_bytes = (nelem - done) * elem_size;
  if (left_bytes) {
    std::memcpy(p, in + done * elem_size, left_bytes);
    p += left_bytes;
  }
  return (int64_t)(p - out);
}

// Decompress a bitshuffle-LZ4 chunk.  out must hold nelem*elem_size bytes.
// Returns bytes consumed from `in`, or < 0 on error.
int64_t blit_bshuf_decompress_lz4(const void* in_v, size_t in_size,
                                  void* out_v, size_t nelem,
                                  size_t elem_size) {
  const uint8_t* in = (const uint8_t*)in_v;
  uint8_t* out = (uint8_t*)out_v;
  if (in_size < 12) return -1;
  const uint64_t total = load_be64(in);
  if (total != (uint64_t)nelem * elem_size) return -4;
  const size_t block_bytes = load_be32(in + 8);
  if (block_bytes == 0 || block_bytes % (kBlockedMult * elem_size)) return -2;
  const size_t block_elems = block_bytes / elem_size;
  const uint8_t* p = in + 12;
  const uint8_t* end = in + in_size;

  uint8_t* tmp = new uint8_t[block_bytes];
  size_t done = 0;
  while (done < nelem - nelem % kBlockedMult) {
    size_t this_elems = block_elems;
    if (done + this_elems > nelem) this_elems = (nelem - done) - (nelem - done) % kBlockedMult;
    if (this_elems == 0) break;
    size_t this_bytes = this_elems * elem_size;
    if (p + 4 > end) { delete[] tmp; return -1; }
    uint32_t c = load_be32(p); p += 4;
    if (p + c > end) { delete[] tmp; return -1; }
    int d = LZ4_decompress_safe((const char*)p, (char*)tmp, (int)c,
                                (int)this_bytes);
    if (d != (int)this_bytes) { delete[] tmp; return -3; }
    unshuffle_block(tmp, out + done * elem_size, this_elems, elem_size);
    p += c;
    done += this_elems;
  }
  delete[] tmp;
  size_t left_bytes = (nelem - done) * elem_size;
  if (left_bytes) {
    if (p + left_bytes > end) return -1;
    std::memcpy(out + done * elem_size, p, left_bytes);
    p += left_bytes;
  }
  return (int64_t)(p - in);
}

}  // extern "C"
