// Native host codecs of bwtb3m_tpu_torch.
//
// The port's own copy of the entry points it calls from
// bwtb3m_tpu/native/bwtb3m_native.cpp, as a small C library bound with
// ctypes.  The loader (bwtb3m_tpu_torch/native/__init__.py) compiles this
// file with g++ at first use into bwtb3m_tpu_torch/build/.
//
// Contents:
//   - LZ4 block compress/decompress (public LZ4 block format)
//   - Elias-gamma decode (the bit-vector files of io/bits.py)
//   - the merge engine's host ops: the three-way rotation comparator,
//     the byte histogram, the BWA .pac unpack
//   - the RLB1 .bwt codec (io/rl.py)
//   - the Phi/Kasai PLCP oracle (lcp/plcp.py::kasai_plcp)
//   - SA-IS suffix sorting (native.sais: the CPU baseline and host oracle)
//
// Left in the reference package: c_gap_interleave, c_gt0 and
// c_pack_bits_u8 serve only its host zip and legacy engine, which the port
// maps onto the scaled engine; c_pack_bits, c_unpack_bits and c_run_scan
// have no caller in either package.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ------------------------------------------------------------------- LZ4

// Greedy LZ4 block compression (public block format). Returns compressed
// size, or -1 if dst too small. dst should be n + n/255 + 16 bytes.
int64_t c_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_cap) {
  const int64_t MINMATCH = 4;
  std::vector<int64_t> table((size_t)1 << 16, -1);
  auto hash = [](uint32_t v) -> uint32_t {
    return (v * 2654435761u) >> 16;
  };
  int64_t op = 0, anchor = 0, i = 0;
  int64_t limit = n - 12;

  auto emit_len = [&](int64_t v) -> bool {
    while (v >= 255) {
      if (op >= dst_cap) return false;
      dst[op++] = 255;
      v -= 255;
    }
    if (op >= dst_cap) return false;
    dst[op++] = (uint8_t)v;
    return true;
  };
  auto emit_seq = [&](int64_t lit_start, int64_t lit_len, int64_t offset,
                      int64_t mlen) -> bool {
    int64_t ml = mlen - MINMATCH;
    if (op >= dst_cap) return false;
    uint8_t token = (uint8_t)(((lit_len < 15 ? lit_len : 15) << 4) |
                              (ml < 15 ? ml : 15));
    dst[op++] = token;
    if (lit_len >= 15 && !emit_len(lit_len - 15)) return false;
    if (op + lit_len + 2 > dst_cap) return false;
    std::memcpy(dst + op, src + lit_start, (size_t)lit_len);
    op += lit_len;
    dst[op++] = (uint8_t)(offset & 0xff);
    dst[op++] = (uint8_t)(offset >> 8);
    if (ml >= 15 && !emit_len(ml - 15)) return false;
    return true;
  };

  while (i <= limit) {
    uint32_t v;
    std::memcpy(&v, src + i, 4);
    uint32_t h = hash(v);
    int64_t cand = table[h];
    table[h] = i;
    uint32_t cv = 0;
    if (cand >= 0 && i - cand <= 0xFFFF) std::memcpy(&cv, src + cand, 4);
    if (cand >= 0 && i - cand <= 0xFFFF && cv == v) {
      int64_t m = 4;
      int64_t maxm = n - 5 - i;
      while (m < maxm && src[cand + m] == src[i + m]) ++m;
      if (!emit_seq(anchor, i - anchor, i - cand, m)) return -1;
      i += m;
      anchor = i;
    } else {
      ++i;
    }
  }
  // trailing literals
  int64_t lit = n - anchor;
  if (op >= dst_cap) return -1;
  dst[op++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
  if (lit >= 15 && !emit_len(lit - 15)) return -1;
  if (op + lit > dst_cap) return -1;
  std::memcpy(dst + op, src + anchor, (size_t)lit);
  op += lit;
  return op;
}

// Returns decompressed size, or -1 on corrupt input / overflow.
int64_t c_lz4_decompress(const uint8_t* src, int64_t csize, uint8_t* dst,
                         int64_t usize) {
  int64_t ip = 0, op = 0;
  while (ip < csize) {
    uint8_t token = src[ip++];
    int64_t ll = token >> 4;
    if (ll == 15) {
      uint8_t b;
      do {
        if (ip >= csize) return -1;
        b = src[ip++];
        ll += b;
      } while (b == 255);
    }
    if (ip + ll > csize || op + ll > usize) return -1;
    std::memcpy(dst + op, src + ip, (size_t)ll);
    ip += ll;
    op += ll;
    if (ip >= csize) break;  // last sequence: literals only
    int64_t offset = src[ip] | ((int64_t)src[ip + 1] << 8);
    ip += 2;
    int64_t ml = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= csize) return -1;
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    int64_t ref = op - offset;
    if (ref < 0 || op + ml > usize) return -1;
    for (int64_t j = 0; j < ml; ++j) dst[op + j] = dst[ref + j];
    op += ml;
  }
  return op;
}

// ------------------------------------------------------------- gamma

// Decode `count` Elias-gamma codes from an LSB-first bit stream.
// Returns bits consumed, or -1 on overrun.
int64_t c_gamma_decode(const uint8_t* bytes, int64_t nbits, int64_t count,
                       uint64_t* out) {
  int64_t i = 0;
  for (int64_t k = 0; k < count; ++k) {
    int64_t nz = 0;
    while (i < nbits && !((bytes[i >> 3] >> (i & 7)) & 1)) { ++nz; ++i; }
    if (i + nz + 1 > nbits) return -1;
    uint64_t v = 0;
    for (int64_t j = 0; j <= nz; ++j) {
      v = (v << 1) | (uint64_t)((bytes[i >> 3] >> (i & 7)) & 1);
      ++i;
    }
    out[k] = v;
  }
  return i;
}

// ------------------------------------------------------- merge-engine host ops

// Three-way circular rotation compare vs rotation e, batched:
// out[j] = sign(rot(xs[j]) - rot(e)) in {-1, 0, +1}, where rot(p) is the
// infinite repetition of text starting at p; equal after n symbols -> 0.
// This is the gt-bitvector oracle of the gap recurrence (SURVEY.md
// hard-part 3) evaluated only for the positions the chains can consult.
// `text` is the plain n-byte text: spans compare through chunks clipped
// at each side's wrap point (a doubled copy of the text would cost 2n
// extra host bytes).
// T is the symbol type: uint8_t, or uint16_t / uint32_t for the dense ids
// of an alphabet of more than 256 / 65,536 distinct symbols (the merge
// engine's 16- and 32-bit texts); memcmp tests equality, the symbols' own
// compare orders them.
// (Templates take C++ linkage inside this extern "C" block.)
extern "C++" {
template <class T>
static void cmp_rot_range(const T* text, int64_t n, int64_t e,
                          const int64_t* xs, int64_t b0, int64_t b1,
                          int8_t* out) {
  for (int64_t j = b0; j < b1; ++j) {
    int64_t ox = xs[j] % n;
    int64_t oe = e;
    int64_t l = 0;
    int8_t r = 0;
    while (l < n) {
      int64_t chunk = n - l < 4096 ? n - l : 4096;
      if (n - ox < chunk) chunk = n - ox;
      if (n - oe < chunk) chunk = n - oe;
      if (std::memcmp(text + ox, text + oe, (size_t)chunk * sizeof(T)) == 0) {
        l += chunk;
        ox += chunk; if (ox == n) ox = 0;
        oe += chunk; if (oe == n) oe = 0;
        continue;
      }
      for (int64_t t = 0;; ++t) {
        if (text[ox + t] != text[oe + t]) {
          r = text[ox + t] < text[oe + t] ? -1 : 1;
          break;
        }
      }
      break;
    }
    out[j] = r;
  }
}
}  // extern "C++"

// Multithreaded byte histogram: out[256] int64 counts, at memory speed
// (numpy's bincount converts every byte to int64 first).
static void hist_u8_range(const uint8_t* text, int64_t b0, int64_t b1,
                          int64_t* out256) {
  int64_t local[256] = {0};
  for (int64_t i = b0; i < b1; ++i) ++local[text[i]];
  for (int t = 0; t < 256; ++t)
    __atomic_fetch_add(&out256[t], local[t], __ATOMIC_RELAXED);
}

void c_hist_u8(const uint8_t* text, int64_t n, int64_t nthreads,
               int64_t* out256) {
  if (nthreads <= 1 || n < (1 << 20)) {
    hist_u8_range(text, 0, n, out256);
    return;
  }
  std::vector<std::thread> ths;
  int64_t per = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t b0 = t * per, b1 = b0 + per < n ? b0 + per : n;
    if (b0 >= b1) break;
    ths.emplace_back(hist_u8_range, text, b0, b1, out256);
  }
  for (auto& th : ths) th.join();
}

extern "C++" {
template <class T>
static void cmp_rot_threads(const T* text, int64_t n, int64_t e, const int64_t* xs,
                            int64_t nx, int64_t nthreads, int8_t* out) {
  if (nthreads <= 1 || nx < 4096) {
    cmp_rot_range<T>(text, n, e, xs, 0, nx, out);
    return;
  }
  std::vector<std::thread> ths;
  int64_t per = (nx + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t b0 = t * per, b1 = b0 + per < nx ? b0 + per : nx;
    if (b0 >= b1) break;
    ths.emplace_back(cmp_rot_range<T>, text, n, e, xs, b0, b1, out);
  }
  for (auto& th : ths) th.join();
}
}  // extern "C++"

void c_cmp_rot(const uint8_t* text, int64_t n, int64_t e, const int64_t* xs,
               int64_t nx, int64_t nthreads, int8_t* out) {
  cmp_rot_threads<uint8_t>(text, n, e, xs, nx, nthreads, out);
}

void c_cmp_rot_u16(const uint16_t* text, int64_t n, int64_t e, const int64_t* xs,
                   int64_t nx, int64_t nthreads, int8_t* out) {
  cmp_rot_threads<uint16_t>(text, n, e, xs, nx, nthreads, out);
}

void c_cmp_rot_u32(const uint32_t* text, int64_t n, int64_t e, const int64_t* xs,
                   int64_t nx, int64_t nthreads, int8_t* out) {
  cmp_rot_threads<uint32_t>(text, n, e, xs, nx, nthreads, out);
}

// Decode `nruns` (huffman(sym), gamma(len)) pairs from an LSB-first bit
// stream. canon_syms/canon_lens are the canonical code table sorted by
// (length, symbol). Returns bits consumed or -1.
int64_t c_rlh_decode(const uint8_t* bytes, int64_t nbits, int64_t nruns,
                     const uint32_t* canon_syms, const uint8_t* canon_lens,
                     int64_t nsyms, int32_t* run_syms, int64_t* run_lens) {
  // canonical decode tables per length
  uint32_t first_code[64] = {0};
  int64_t offset[64] = {0};
  int64_t cnt[64] = {0};
  int maxlen = 0;
  for (int64_t j = 0; j < nsyms; ++j) {
    cnt[canon_lens[j]]++;
    if (canon_lens[j] > maxlen) maxlen = canon_lens[j];
  }
  {
    uint32_t code = 0;
    int64_t idx = 0;
    for (int l = 1; l <= maxlen; ++l) {
      code <<= 1;
      first_code[l] = code;
      offset[l] = idx;
      code += (uint32_t)cnt[l];
      idx += cnt[l];
    }
  }
  int64_t i = 0;
  for (int64_t k = 0; k < nruns; ++k) {
    // huffman symbol: read bits MSB-first until a valid code
    uint32_t code = 0;
    int l = 0;
    int32_t sym = -1;
    while (l < maxlen + 1) {
      if (i >= nbits) return -1;
      code = (code << 1) | (uint32_t)((bytes[i >> 3] >> (i & 7)) & 1);
      ++i;
      ++l;
      if (cnt[l] && code >= first_code[l] &&
          code < first_code[l] + (uint32_t)cnt[l]) {
        sym = (int32_t)canon_syms[offset[l] + (code - first_code[l])];
        break;
      }
    }
    if (sym < 0) return -1;
    run_syms[k] = sym;
    // gamma length
    int64_t nz = 0;
    while (i < nbits && !((bytes[i >> 3] >> (i & 7)) & 1)) { ++nz; ++i; }
    if (i + nz + 1 > nbits) return -1;
    uint64_t v = 0;
    for (int64_t j = 0; j <= nz; ++j) {
      v = (v << 1) | (uint64_t)((bytes[i >> 3] >> (i & 7)) & 1);
      ++i;
    }
    run_lens[k] = (int64_t)v;
  }
  return i;
}


// BWA .pac 2-bit unpack (base i at bits (3-(i&3))*2 of byte i>>2, see
// io/pac.py) with an optional +shift (pacterm maps bases to {1..4}).
// LUT-per-byte + threads: memory-bound, where the broadcasting numpy
// unpack in io/pac.py stages four arrays per byte.
static void unpack_pac_range(const uint8_t* pac, int64_t b0, int64_t b1,
                             const uint8_t* lut, uint8_t* out) {
  for (int64_t i = b0; i < b1; ++i) {
    std::memcpy(out + i * 4, lut + (int64_t)pac[i] * 4, 4);
  }
}

void c_unpack_pac(const uint8_t* pac, int64_t nbytes, int shift,
                  int64_t nthreads, uint8_t* out) {
  uint8_t lut[256 * 4];
  for (int v = 0; v < 256; ++v) {
    for (int j = 0; j < 4; ++j) {
      lut[v * 4 + j] = (uint8_t)(((v >> ((3 - j) * 2)) & 3) + shift);
    }
  }
  if (nthreads <= 1 || nbytes < (1 << 20)) {
    unpack_pac_range(pac, 0, nbytes, lut, out);
    return;
  }
  std::vector<std::thread> ths;
  int64_t per = (nbytes + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t b0 = t * per, b1 = b0 + per < nbytes ? b0 + per : nbytes;
    if (b0 >= b1) break;
    ths.emplace_back(unpack_pac_range, pac, b0, b1, lut, out);
  }
  for (auto& th : ths) th.join();
}

// ------------------------------------------------------------- PLCP

// Phi/Kasai PLCP for the circular text (verification oracle).
void c_kasai_plcp(const int32_t* text, const int64_t* sa, int64_t n,
                  int64_t* plcp) {
  std::vector<int64_t> isa((size_t)n);
  for (int64_t r = 0; r < n; ++r) isa[sa[r]] = r;
  int64_t l = 0;
  for (int64_t p = 0; p < n; ++p) {
    int64_t r = isa[p];
    if (r == 0) { plcp[p] = 0; l = 0; continue; }
    int64_t q = sa[r - 1];
    while (l < n && text[(p + l) % n] == text[(q + l) % n]) ++l;
    plcp[p] = l;
    if (l > 0) --l;
  }
}

// --------------------------------------------------------------- RLB1 codec

// Single-pass RLB1 writer (layout documented in io/rl.py + FORMATS.md;
// role of the reference's huffman::RLEncoder emitting the .bwt), at
// stream speed where the numpy encoder makes a run-splitting union1d
// pass.  Narrow symbols with count table only (sigma <= 256); returns 0
// or -1.
int64_t c_rl_encode_u8(const char* path, const uint8_t* syms, int64_t n,
                       uint32_t sigma, uint32_t block_size) {
  if (sigma > 256 || block_size == 0) return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int64_t nb = n ? (n + block_size - 1) / block_size : 1;
  std::vector<uint64_t> block_off(nb);
  std::vector<uint64_t> cum((size_t)(nb + 1) * sigma, 0);
  std::vector<uint64_t> running(sigma, 0);
  std::vector<uint8_t> bsym, blen;
  std::vector<uint64_t> bbig;
  uint8_t head[34];
  std::memcpy(head, "RLB1", 4);
  head[4] = 1;  // version
  head[5] = 0;  // flags: narrow symbols, counts present
  auto put_u32 = [](uint8_t* p, uint32_t v) {
    for (int i = 0; i < 4; ++i) p[i] = (uint8_t)(v >> (8 * i));
  };
  auto put_u64 = [](uint8_t* p, uint64_t v) {
    for (int i = 0; i < 8; ++i) p[i] = (uint8_t)(v >> (8 * i));
  };
  put_u32(head + 6, sigma);
  put_u64(head + 10, (uint64_t)n);
  put_u32(head + 18, block_size);
  put_u64(head + 22, 0);  // footer offset, patched below
  if (std::fwrite(head, 1, 30, f) != 30) { std::fclose(f); return -1; }
  for (int64_t b = 0; b < nb; ++b) {
    block_off[b] = (uint64_t)std::ftell(f);
    int64_t lo = b * (int64_t)block_size;
    int64_t hi = lo + block_size < n ? lo + block_size : n;
    bsym.clear(); blen.clear(); bbig.clear();
    std::memcpy(cum.data() + (size_t)b * sigma, running.data(),
                sigma * sizeof(uint64_t));
    int64_t i = lo;
    while (i < hi) {
      uint8_t s = syms[i];
      int64_t j = i + 1;
      while (j < hi && syms[j] == s) ++j;
      int64_t len = j - i;
      bsym.push_back(s);
      if (len >= 255) { blen.push_back(255); bbig.push_back((uint64_t)len); }
      else blen.push_back((uint8_t)len);
      running[s] += (uint64_t)len;
      i = j;
    }
    uint8_t bh[8];
    put_u32(bh, (uint32_t)bsym.size());
    put_u32(bh + 4, (uint32_t)bbig.size());
    std::fwrite(bh, 1, 8, f);
    if (!bsym.empty()) {
      std::fwrite(bsym.data(), 1, bsym.size(), f);
      std::fwrite(blen.data(), 1, blen.size(), f);
    }
    if (!bbig.empty())
      std::fwrite(bbig.data(), 8, bbig.size(), f);
  }
  std::memcpy(cum.data() + (size_t)nb * sigma, running.data(),
              sigma * sizeof(uint64_t));
  uint64_t footer_off = (uint64_t)std::ftell(f);
  std::fwrite(block_off.data(), 8, block_off.size(), f);
  std::fwrite(cum.data(), 8, cum.size(), f);
  std::fseek(f, 22, SEEK_SET);
  uint8_t fo[8];
  put_u64(fo, footer_off);
  std::fwrite(fo, 1, 8, f);
  std::fclose(f);
  return 0;
}

// Whole-file RLB1 decode into a uint8 buffer. Returns n or -1 (bad magic,
// wide symbols, or cap too small).
int64_t c_rl_decode_u8(const char* path, uint8_t* out, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint8_t head[30];
  if (std::fread(head, 1, 30, f) != 30 || std::memcmp(head, "RLB1", 4)) {
    std::fclose(f); return -1;
  }
  uint8_t flags = head[5];
  if (flags & 1) { std::fclose(f); return -1; }  // wide symbols
  auto get_u32 = [](const uint8_t* p) {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= (uint32_t)p[i] << (8 * i);
    return v;
  };
  auto get_u64 = [](const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= (uint64_t)p[i] << (8 * i);
    return v;
  };
  int64_t n = (int64_t)get_u64(head + 10);
  uint32_t block_size = get_u32(head + 18);
  if (n > cap || block_size == 0) { std::fclose(f); return -1; }
  int64_t nb = n ? (n + block_size - 1) / block_size : 1;
  std::vector<uint8_t> buf;
  std::vector<uint64_t> big;
  int64_t o = 0;
  for (int64_t b = 0; b < nb; ++b) {
    uint8_t bh[8];
    if (std::fread(bh, 1, 8, f) != 8) { std::fclose(f); return -1; }
    uint32_t nruns = get_u32(bh), nbig = get_u32(bh + 4);
    buf.resize((size_t)nruns * 2);
    big.resize(nbig);
    if (nruns && std::fread(buf.data(), 1, (size_t)nruns * 2, f) !=
                     (size_t)nruns * 2) { std::fclose(f); return -1; }
    if (nbig && std::fread(big.data(), 8, nbig, f) != nbig) {
      std::fclose(f); return -1;
    }
    uint32_t bi = 0;
    for (uint32_t k = 0; k < nruns; ++k) {
      uint8_t s = buf[k];
      uint8_t l8 = buf[nruns + k];
      int64_t len = l8 == 255 ? (int64_t)big[bi++] : l8;
      if (o + len > n) { std::fclose(f); return -1; }
      std::memset(out + o, s, (size_t)len);
      o += len;
    }
  }
  std::fclose(f);
  return o == n ? n : -1;
}

}  // extern "C"

// ------------------------------------------------------------------ SA-IS

// SA-IS suffix-array construction (Nong/Zhang/Chan, the induced-sorting
// algorithm divsufsort-class engines are built on).  Role: the honest CPU
// baseline + host oracle standing in for the reference's per-block
// divsufsort (libmaus2 `suffixsort::divsufsort`, SURVEY.md section 2.2) —
// not a copy of any reference code; written from the published algorithm.
// Requires s[n-1] to be the unique smallest symbol (sentinel).

namespace sais_impl {

static inline bool is_lms(const uint8_t* t, int64_t i) {
  return i > 0 && t[i] && !t[i - 1];
}

static void get_buckets(const int64_t* s, int64_t* bkt, int64_t n, int64_t K,
                        bool end) {
  std::fill(bkt, bkt + K + 1, 0);
  for (int64_t i = 0; i < n; ++i) bkt[s[i]]++;
  int64_t sum = 0;
  for (int64_t i = 0; i <= K; ++i) {
    sum += bkt[i];
    bkt[i] = end ? sum : sum - bkt[i];
  }
}

static void induce_l(const uint8_t* t, int64_t* SA, const int64_t* s,
                     int64_t* bkt, int64_t n, int64_t K) {
  get_buckets(s, bkt, n, K, false);
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = SA[i] - 1;
    if (SA[i] > 0 && !t[j]) SA[bkt[s[j]]++] = j;
  }
}

static void induce_s(const uint8_t* t, int64_t* SA, const int64_t* s,
                     int64_t* bkt, int64_t n, int64_t K) {
  get_buckets(s, bkt, n, K, true);
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t j = SA[i] - 1;
    if (SA[i] > 0 && t[j]) SA[--bkt[s[j]]] = j;
  }
}

static void sais(const int64_t* s, int64_t* SA, int64_t n, int64_t K) {
  if (n == 1) { SA[0] = 0; return; }
  std::vector<uint8_t> t(n);
  t[n - 1] = 1;
  if (n >= 2) t[n - 2] = 0;
  for (int64_t i = n - 3; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
  std::vector<int64_t> bkt(K + 1);

  // stage 1: sort LMS substrings by one induced pass
  std::fill(SA, SA + n, (int64_t)-1);
  get_buckets(s, bkt.data(), n, K, true);
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(t.data(), i)) SA[--bkt[s[i]]] = i;
  induce_l(t.data(), SA, s, bkt.data(), n, K);
  induce_s(t.data(), SA, s, bkt.data(), n, K);

  // compact sorted LMS positions into SA[0..n1)
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i)
    if (is_lms(t.data(), SA[i])) SA[n1++] = SA[i];

  // name LMS substrings into SA[n1..n)
  std::fill(SA + n1, SA + n, (int64_t)-1);
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = SA[i];
    bool diff = false;
    for (int64_t d = 0; d < n; ++d) {
      if (prev == -1 || s[pos + d] != s[prev + d] ||
          t[pos + d] != t[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (is_lms(t.data(), pos + d) || is_lms(t.data(), prev + d)))
        break;  // both substrings ended equal
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // stage 2: order the LMS suffixes (recursively if names collide)
  int64_t* SA1 = SA;
  int64_t* s1 = SA + n - n1;
  if (name < n1) {
    sais(s1, SA1, n1, name - 1);
  } else {
    for (int64_t i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // stage 3: induce the full order from sorted LMS suffixes
  for (int64_t i = 1, j = 0; i < n; ++i)
    if (is_lms(t.data(), i)) s1[j++] = i;  // LMS positions in text order
  for (int64_t i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];
  std::fill(SA + n1, SA + n, (int64_t)-1);
  get_buckets(s, bkt.data(), n, K, true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t j = SA[i];
    SA[i] = -1;
    SA[--bkt[s[j]]] = j;
  }
  induce_l(t.data(), SA, s, bkt.data(), n, K);
  induce_s(t.data(), SA, s, bkt.data(), n, K);
}

}  // namespace sais_impl

extern "C" {

// Suffix array of text (int32 symbols >= 0) with an implicit unique
// terminator appended that sorts below everything: out[i] = start of the
// i-th smallest suffix of text (terminator's trivial suffix excluded).
// For a pacterm text (terminator 0 already present and unique) this is
// the circular rotation order directly.
void c_sais(const int32_t* text, int64_t n, int64_t K, int64_t* out) {
  std::vector<int64_t> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = (int64_t)text[i] + 1;
  s[n] = 0;
  std::vector<int64_t> SA(n + 1);
  sais_impl::sais(s.data(), SA.data(), n + 1, K + 1);
  std::memcpy(out, SA.data() + 1, (size_t)n * sizeof(int64_t));
}

}  // extern "C"
