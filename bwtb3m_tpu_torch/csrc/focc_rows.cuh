// The fused rank rows as the walk kernels read them (sm_90a).
//
// One definition of the row layouts, shared by lf_walk.cu (the LF walk)
// and gap_chain.cu (the merge engine's gap chains and anchors):
//   step(r, &sym)  the LF step: sym = BWT[r], returns C[sym] + rank(sym, r)
//   rank(c, r)     occurrences of symbol c in BWT[0, r), without C (what
//                  the reference's rank_batch_f returns)
// Both read the one row of block r >> 8 and nothing else.
//
// Row layouts (bwtb3m_tpu_torch/ops/focc_bp.py, ops/focc.py):
//   bit-plane (sigma <= 8), 128 bytes per 256-symbol block:
//     words 0..7 / 8..15 / 16..23  bit planes 0 / 1 / 2, LSB first
//     words 24..24+sigma-1         occ checkpoints (counts before the block)
//   byte rows (sigma <= 256), roww bytes per block (multiple of 128):
//     bytes 0..255                 the block's symbols
//     bytes 256 + 4c .. +3         occ checkpoint of symbol c, little endian
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bwt_rows {

constexpr int kBpRowBytes = 128;

// Bit-plane rows: the whole row is loaded as 8 x 16 bytes, C lives in
// registers, and word / occ selection is an unrolled select (no local
// memory, no dependent load).
struct BitPlaneRows {
  const uint8_t* rows;
  uint32_t c[8];

  __device__ __forceinline__ void load(uint32_t r, uint32_t w[32]) const {
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
  __device__ __forceinline__ static uint32_t count(const uint32_t w[32], uint32_t sym,
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
    return occ + cnt;
  }

  __device__ __forceinline__ uint32_t step(uint32_t r, uint32_t* sym_out) const {
    uint32_t w[32];
    load(r, w);
    const uint32_t off = r & 255u;
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
    uint32_t base = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((uint32_t)j == sym) base = c[j];
    }
    *sym_out = sym;
    return base + count(w, sym, off);
  }

  __device__ __forceinline__ uint32_t rank(uint32_t sym, uint32_t r) const {
    uint32_t w[32];
    load(r, w);
    return count(w, sym, r & 255u);
  }
};

// Byte rows: a SIMD byte compare over the words before the offset, then
// the occ word of the symbol.
struct ByteRows {
  const uint8_t* rows;
  const uint32_t* C;
  int roww;

  __device__ __forceinline__ uint32_t count(const uint8_t* row, uint32_t sym,
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
    return __ldg(rw + 64 + sym) + (bits >> 3);
  }

  __device__ __forceinline__ uint32_t step(uint32_t r, uint32_t* sym_out) const {
    const uint8_t* row = rows + (size_t)(r >> 8) * (size_t)roww;
    const uint32_t off = r & 255u;
    const uint32_t sym = __ldg(row + off);
    *sym_out = sym;
    return __ldg(C + sym) + count(row, sym, off);
  }

  __device__ __forceinline__ uint32_t rank(uint32_t sym, uint32_t r) const {
    return count(rows + (size_t)(r >> 8) * (size_t)roww, sym, r & 255u);
  }
};

__device__ __forceinline__ BitPlaneRows make_bp(const uint8_t* rows, const uint32_t* C,
                                                int sigma) {
  BitPlaneRows b;
  b.rows = rows;
#pragma unroll
  for (int j = 0; j < 8; ++j) b.c[j] = j < sigma ? __ldg(C + j) : 0u;
  return b;
}

}  // namespace bwt_rows
