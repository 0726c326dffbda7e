// The fused rank rows as the walk kernels read them (sm_90a).
//
// One definition of the row layouts, shared by lf_walk.cu (the LF walk)
// and gap_chain.cu (the merge engine's gap chains and anchors):
//   step(r, &sym)     the LF step: sym = BWT[r], returns C[sym] + rank(sym, r)
//   symrank<R>(r, &sym)  sym = BWT[r] and rank(sym, r), without C
//   rank<R>(c, r)     occurrences of symbol c in BWT[0, r), without C (what
//                     the reference's rank_batch_f returns)
// All read the one row of r's block and nothing else.  R is the rank
// type: uint32_t in the narrow forms (n < 2^32; the sums wrap as the
// uint32 words do), unsigned long long in the 64-bit forms, where the
// stored occ word is the count's lo word and WideTerms adds the hi word
// and the 64-bit C.
//
// Row layouts (bwtb3m_tpu_torch/ops/focc_bp.py, ops/focc.py):
//   sector (sigma <= 4), 32 bytes per 64-symbol block, 32-byte aligned:
//     words 0..1 / 2..3            bit planes 0 / 1, LSB first
//     words 4..7                   occ checkpoints of symbols 0..3
//   The unit of a random read from device memory on Hopper is the 32-byte
//   sector, so a step on these rows moves one sector where the 128-byte
//   row moves four: the walks are bound by the sectors they gather.
//   bit-plane (sigma <= 8), 128 bytes per 256-symbol block:
//     words 0..7 / 8..15 / 16..23  bit planes 0 / 1 / 2, LSB first
//     words 24..24+sigma-1         occ checkpoints (counts before the block)
//   byte rows (sigma <= 256), roww bytes per block (multiple of 128):
//     bytes 0..255                 the block's symbols
//     bytes 256 + 4c .. +3         occ checkpoint of symbol c, little endian
//   wavelet rows (256 < sigma <= 2^21, n < 2^31; ops/wavelet_rows.py),
//   a fourth family with the same three calls but no block rows: an 8-ary
//   wavelet matrix of `levels` levels of base-8 digits, each level nblk
//   64-byte blocks, 64-byte aligned
//     words 0..6                   digits 0..6 of the level before the
//                                  block (7s: 96 b less their sum)
//     words 7..15                  bit planes 0, 1, 2 of the next 96
//                                  digits, 3 words each, LSB first
//   step, symrank and rank descend the levels, one block per level.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bwt_rows {

constexpr int kSectorRowBytes = 32;
constexpr int kBpRowBytes = 128;

// Sector rows: the row is two independent 16-byte loads, the planes in
// the first and the four occ words in the second; C lives in registers.
// The in-block count is one 64-bit popcount under a prefix mask:
// off < 64, so the shift is always defined, and off == 0 gives mask 0.
struct SectorRows {
  static constexpr int kShift = 6;
  static constexpr int kMaxSigma = 4;
  const uint8_t* rows;
  uint32_t c[4];

  template <class R>
  __device__ __forceinline__ void load(R r, uint4* planes, uint4* occ) const {
    const uint4* row =
        reinterpret_cast<const uint4*>(rows + (size_t)(r >> 6) * kSectorRowBytes);
    *planes = __ldg(row);
    *occ = __ldg(row + 1);
  }

  // planes = (plane 0 word 0, plane 0 word 1, plane 1 word 0, plane 1
  // word 1).  Positions before off whose 2 plane bits equal sym's, plus
  // the occ checkpoint of sym: rank(sym, r) for r = block * 64 + off.
  template <class R>
  __device__ __forceinline__ static R count(const uint4& planes, const uint4& occ,
                                            uint32_t sym, uint32_t off) {
    const uint32_t e0 = (sym & 1u) - 1u, e1 = ((sym >> 1) & 1u) - 1u;
    const uint32_t lo = (planes.x ^ e0) & (planes.z ^ e1);
    const uint32_t hi = (planes.y ^ e0) & (planes.w ^ e1);
    const unsigned long long match = ((unsigned long long)hi << 32) | lo;
    const unsigned long long mask = (1ull << off) - 1ull;
    const uint32_t o = sym == 0u ? occ.x : (sym == 1u ? occ.y : (sym == 2u ? occ.z : occ.w));
    return (R)o + (R)__popcll(match & mask);
  }

  __device__ __forceinline__ uint32_t c_of(uint32_t sym) const {
    return sym == 0u ? c[0] : (sym == 1u ? c[1] : (sym == 2u ? c[2] : c[3]));
  }

  template <class R>
  __device__ __forceinline__ R symrank(R r, uint32_t* sym_out) const {
    uint4 planes, occ;
    load(r, &planes, &occ);
    const uint32_t off = (uint32_t)r & 63u;
    const uint32_t bit = off & 31u;
    const uint32_t p0 = off < 32u ? planes.x : planes.y;
    const uint32_t p1 = off < 32u ? planes.z : planes.w;
    const uint32_t sym = ((p0 >> bit) & 1u) | (((p1 >> bit) & 1u) << 1);
    *sym_out = sym;
    return count<R>(planes, occ, sym, off);
  }

  __device__ __forceinline__ uint32_t step(uint32_t r, uint32_t* sym_out) const {
    const uint32_t k = symrank<uint32_t>(r, sym_out);
    return c_of(*sym_out) + k;
  }

  template <class R>
  __device__ __forceinline__ R rank(uint32_t sym, R r) const {
    uint4 planes, occ;
    load(r, &planes, &occ);
    return count<R>(planes, occ, sym, (uint32_t)r & 63u);
  }
};

// Bit-plane rows: the whole row is loaded as 8 x 16 bytes, C lives in
// registers, and word / occ selection is an unrolled select (no local
// memory, no dependent load).
struct BitPlaneRows {
  static constexpr int kShift = 8;
  static constexpr int kMaxSigma = 8;
  const uint8_t* rows;
  uint32_t c[8];

  template <class R>
  __device__ __forceinline__ void load(R r, uint32_t w[32]) const {
    const uint4* row =
        reinterpret_cast<const uint4*>(rows + (size_t)(r >> 8) * kBpRowBytes);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = __ldg(row + q);
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }

  // Positions before off in the row whose 3 plane bits equal sym's, plus
  // the occ checkpoint of sym: rank(sym, r) for r = block * 256 + off.
  template <class R>
  __device__ __forceinline__ static R count(const uint32_t w[32], uint32_t sym,
                                            uint32_t off) {
    // e_j = ~0 where bit j of sym is 0: (plane ^ e_j) marks positions whose
    // bit j equals sym's bit j
    const uint32_t e0 = (sym & 1u) - 1u, e1 = ((sym >> 1) & 1u) - 1u,
                   e2 = ((sym >> 2) & 1u) - 1u;
    uint32_t cnt = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int keep = (int)off - 32 * k;
      // keep == 0 and keep == 32 selected explicitly: a shift by 32 is
      // undefined
      const uint32_t mask =
          keep <= 0 ? 0u : (keep >= 32 ? 0xFFFFFFFFu : ((1u << keep) - 1u));
      cnt += __popc((w[k] ^ e0) & (w[8 + k] ^ e1) & (w[16 + k] ^ e2) & mask);
    }
    uint32_t occ = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((uint32_t)j == sym) occ = w[24 + j];
    }
    return (R)occ + (R)cnt;
  }

  __device__ __forceinline__ uint32_t c_of(uint32_t sym) const {
    uint32_t base = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((uint32_t)j == sym) base = c[j];
    }
    return base;
  }

  template <class R>
  __device__ __forceinline__ R symrank(R r, uint32_t* sym_out) const {
    uint32_t w[32];
    load(r, w);
    const uint32_t off = (uint32_t)r & 255u;
    const uint32_t wi = off >> 5;
    const uint32_t bit = off & 31u;
    uint32_t p0 = 0, p1 = 0, p2 = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if ((uint32_t)k == wi) {
        p0 = w[k];
        p1 = w[8 + k];
        p2 = w[16 + k];
      }
    }
    const uint32_t sym =
        ((p0 >> bit) & 1u) | (((p1 >> bit) & 1u) << 1) | (((p2 >> bit) & 1u) << 2);
    *sym_out = sym;
    return count<R>(w, sym, off);
  }

  __device__ __forceinline__ uint32_t step(uint32_t r, uint32_t* sym_out) const {
    const uint32_t k = symrank<uint32_t>(r, sym_out);
    return c_of(*sym_out) + k;
  }

  template <class R>
  __device__ __forceinline__ R rank(uint32_t sym, R r) const {
    uint32_t w[32];
    load(r, w);
    return count<R>(w, sym, (uint32_t)r & 255u);
  }
};

// Byte rows: a SIMD byte compare over the words before the offset, then
// the occ word of the symbol.
struct ByteRows {
  static constexpr int kShift = 8;
  static constexpr int kMaxSigma = 256;
  const uint8_t* rows;
  const uint32_t* C;
  int roww;

  template <class R>
  __device__ __forceinline__ R count(const uint8_t* row, uint32_t sym,
                                     uint32_t off) const {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
    const uint32_t pat = sym * 0x01010101u;
    const uint32_t nfull = off >> 2;
    uint32_t bits = 0;  // 8 bits per matching byte
    for (uint32_t k = 0; k < nfull; ++k) bits += __popc(__vcmpeq4(__ldg(rw + k), pat));
    const uint32_t rem = off & 3u;
    if (rem) {
      bits += __popc(__vcmpeq4(__ldg(rw + nfull), pat) & ((1u << (8u * rem)) - 1u));
    }
    return (R)__ldg(rw + 64 + sym) + (R)(bits >> 3);
  }

  __device__ __forceinline__ uint32_t c_of(uint32_t sym) const { return __ldg(C + sym); }

  template <class R>
  __device__ __forceinline__ R symrank(R r, uint32_t* sym_out) const {
    const uint8_t* row = rows + (size_t)(r >> 8) * (size_t)roww;
    const uint32_t off = (uint32_t)r & 255u;
    const uint32_t sym = __ldg(row + off);
    *sym_out = sym;
    return count<R>(row, sym, off);
  }

  __device__ __forceinline__ uint32_t step(uint32_t r, uint32_t* sym_out) const {
    const uint32_t k = symrank<uint32_t>(r, sym_out);
    return c_of(*sym_out) + k;
  }

  template <class R>
  __device__ __forceinline__ R rank(uint32_t sym, R r) const {
    return count<R>(rows + (size_t)(r >> 8) * (size_t)roww, sym, (uint32_t)r & 255u);
  }
};

// Wavelet rows, an 8-ary matrix.  A descent from position i reads at each
// level l the block of i, the digit d there and k, the d digits before i,
// and goes on at zc[l][d] + k, zc[l][d] being the level's digits below d;
// the levels' blocks depend on each other, so a step is `levels`
// dependent 64-byte reads (four 16-byte loads each): 5 at 5,000 symbols,
// 6 at 100,000, 7 at 2^21 (every Unicode code point).
// Past the L2 the walks are bound by the card's rate of dependent random
// reads, and a random 64 bytes costs little more than a random 32 (the
// 4-ary matrix of 32-byte sectors, 7 reads a step, was 1.32x slower;
// PERF.md), so a step's time is its level count.  Along BWT[i]'s own
// digits the descent yields the symbol and the end position f, and
// LF(i) = D[sym] + f; along c's digits, rank(c, i) = f - start[c].  The
// digit table zc sits in shared memory (8 words a level); D and start
// are read from shared memory where a kernel staged them
// (stage_wavelet), else with __ldg.  Ranks are uint32 (the callers keep
// n below 2^31); the division by 96 is by a constant (multiply-high).
// Symbols are uint32 here whatever the text's width (uint16 up to 65,536
// symbols, uint32 past them: the kernels' T).
constexpr int kWmMaxLevels = 7;
constexpr int kWmRadix = 8;
constexpr uint32_t kWmBlockDigits = 96;

// What the host passes: the blocks ([levels][nblk] x 64 bytes, 64-byte
// aligned), the digit table (uint32 [levels][8]: digits below d), D and
// start (uint32 [sigma]); stage: 0 none, 1 D, 2 start into shared memory.
struct WaveletArgs {
  const uint4* blk;
  unsigned long long nblk;
  int levels;
  int sigma;
  const uint32_t* zc;
  const uint32_t* D;
  const uint32_t* start;
  int stage;
};

struct WaveletRows {
  static constexpr int kShift = 0;
  static constexpr int kMaxSigma = 1 << 21;
  const uint4* blk;
  unsigned long long nblk;
  int levels;
  const uint32_t* zc;  // shared memory, [levels][8]
  const uint32_t* D;
  const uint32_t* start;
  bool staged;

  __device__ __forceinline__ uint32_t tab(const uint32_t* t, uint32_t c) const {
    return staged ? t[c] : __ldg(t + c);
  }

  // rank_d(i) on level l: the digits d of the level before position i,
  // d being the digit at i where want < 0, else want.  The in-block count
  // is ops/wavelet_rows.py::digit_rank over the three plane words of each
  // word index: XOR each plane with ~0 where d's bit is 0, AND the three,
  // popcount under the prefix mask; no branch on the word index.
  __device__ __forceinline__ uint32_t level(int l, uint32_t i, int want,
                                            uint32_t* d_out) const {
    const uint32_t s = i / kWmBlockDigits;
    const uint32_t off = i - s * kWmBlockDigits;
    const uint4* p = blk + 4 * ((size_t)l * nblk + s);
    const uint4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2), q3 = __ldg(p + 3);
    const uint32_t cnt[7] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z};
    const uint32_t p0[3] = {q1.w, q2.x, q2.y};
    const uint32_t p1[3] = {q2.z, q2.w, q3.x};
    const uint32_t p2[3] = {q3.y, q3.z, q3.w};
    const uint32_t wi = off >> 5, sh = off & 31u;
    uint32_t d;
    if (want < 0) {
      uint32_t a0 = 0, a1 = 0, a2 = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if ((uint32_t)k == wi) {
          a0 = p0[k];
          a1 = p1[k];
          a2 = p2[k];
        }
      }
      d = ((a0 >> sh) & 1u) | (((a1 >> sh) & 1u) << 1) | (((a2 >> sh) & 1u) << 2);
    } else {
      d = (uint32_t)want;
    }
    // e_j = ~0 where bit j of d is 0: (plane ^ e_j) marks the digits whose
    // bit j equals d's
    const uint32_t e0 = (d & 1u) - 1u, e1 = ((d >> 1) & 1u) - 1u, e2 = ((d >> 2) & 1u) - 1u;
    const uint32_t part = (1u << sh) - 1u;  // sh <= 31
    uint32_t k_in = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t m = (p0[k] ^ e0) & (p1[k] ^ e1) & (p2[k] ^ e2);
      const uint32_t mask = (uint32_t)k < wi ? 0xFFFFFFFFu : ((uint32_t)k == wi ? part : 0u);
      k_in += __popc(m & mask);
    }
    uint32_t before = s * kWmBlockDigits;  // the 7s: 96 s less the others
#pragma unroll
    for (int j = 0; j < 7; ++j) before -= cnt[j];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if ((uint32_t)j == d) before = cnt[j];
    }
    *d_out = d;
    return before + k_in;
  }

  // Descent along BWT[i]'s digits (c < 0) or along c's: returns f, and the
  // symbol read in *sym.
  __device__ __forceinline__ uint32_t descend(uint32_t i, int c, uint32_t* sym) const {
    uint32_t s = 0;
#pragma unroll
    for (int l = 0; l < kWmMaxLevels; ++l) {
      if (l < levels) {
        const int want = c < 0 ? -1 : (int)(((uint32_t)c >> (3 * (levels - 1 - l))) & 7u);
        uint32_t d;
        const uint32_t k = level(l, i, want, &d);
        i = zc[kWmRadix * l + d] + k;
        s = (s << 3) | d;
      }
    }
    *sym = s;
    return i;
  }

  template <class R>
  __device__ __forceinline__ R symrank(R r, uint32_t* sym_out) const {
    const uint32_t f = descend((uint32_t)r, -1, sym_out);
    return (R)(f - tab(start, *sym_out));
  }

  __device__ __forceinline__ uint32_t step(uint32_t r, uint32_t* sym_out) const {
    const uint32_t f = descend(r, -1, sym_out);
    return tab(D, *sym_out) + f;
  }

  template <class R>
  __device__ __forceinline__ R rank(uint32_t sym, R r) const {
    uint32_t s;
    const uint32_t f = descend((uint32_t)r, (int)sym, &s);
    return (R)(f - tab(start, sym));
  }
};

// The block's wavelet rows: the digit table into shared memory and, where
// the host asked (a.stage), D or start into s_tab (a.sigma words of
// dynamic shared memory; the host keeps them and the static digit table
// within the 48 KB a launch takes without opting in,
// ops/wavelet_rows.py::SMEM_LIMIT).  Every thread of the block must call
// it.
__device__ __forceinline__ WaveletRows stage_wavelet(const WaveletArgs& a, uint32_t* s_tab) {
  __shared__ uint32_t s_zc[kWmRadix * kWmMaxLevels];
  WaveletRows w;
  w.blk = a.blk;
  w.nblk = a.nblk;
  w.levels = a.levels;
  for (int k = threadIdx.x; k < kWmRadix * a.levels; k += blockDim.x) s_zc[k] = __ldg(a.zc + k);
  w.zc = s_zc;
  w.D = a.D;
  w.start = a.start;
  w.staged = a.stage != 0;
  if (a.stage) {
    const uint32_t* src = a.stage == 1 ? a.D : a.start;
    for (int k = threadIdx.x; k < a.sigma; k += blockDim.x) s_tab[k] = __ldg(src + k);
  }
  __syncthreads();
  if (a.stage == 1) {
    w.D = s_tab;
  } else if (a.stage == 2) {
    w.start = s_tab;
  }
  return w;
}

// The 64-bit forms' additions to a row's rank: the hi word of the occ
// checkpoint, #{k : thr[sym][k] <= row} << 32 (ops/wideocc.py), and the
// 64-bit C.  Both tables sit in shared memory (at most 256 x 8 x 4 +
// 256 x 8 bytes), staged by stage_wide at the start of a block: a rank's
// hi word is kThrK compares against the lane's symbol's row of thr, with
// no load from device memory.
constexpr int kThrK = 8;

struct WideTerms {
  const uint32_t* thr;               // [sigma * kThrK], 0xFFFFFFFF unused
  const unsigned long long* C;       // [sigma]

  __device__ __forceinline__ unsigned long long hi(uint32_t sym,
                                                   unsigned long long row) const {
    const uint32_t* t = thr + sym * kThrK;
    uint32_t h = 0;
#pragma unroll
    for (int k = 0; k < kThrK; ++k) h += (unsigned long long)t[k] <= row;
    return (unsigned long long)h << 32;
  }
};

// Copies thr [sigma * kThrK] and, where given, C [sigma] into the block's
// shared arrays; every thread of the block must call it.
__device__ __forceinline__ WideTerms stage_wide(const uint32_t* thr,
                                                const unsigned long long* C, int sigma,
                                                uint32_t* s_thr,
                                                unsigned long long* s_c) {
  for (int k = threadIdx.x; k < sigma * kThrK; k += blockDim.x) s_thr[k] = __ldg(thr + k);
  if (C) {
    for (int k = threadIdx.x; k < sigma; k += blockDim.x) s_c[k] = __ldg(C + k);
  }
  __syncthreads();
  return WideTerms{s_thr, s_c};
}

__device__ __forceinline__ BitPlaneRows make_bp(const uint8_t* rows, const uint32_t* C,
                                                int sigma) {
  BitPlaneRows b;
  b.rows = rows;
#pragma unroll
  for (int j = 0; j < 8; ++j) b.c[j] = j < sigma ? __ldg(C + j) : 0u;
  return b;
}

__device__ __forceinline__ SectorRows make_sector(const uint8_t* rows, const uint32_t* C,
                                                  int sigma) {
  SectorRows b;
  b.rows = rows;
#pragma unroll
  for (int j = 0; j < 4; ++j) b.c[j] = j < sigma ? __ldg(C + j) : 0u;
  return b;
}

}  // namespace bwt_rows
