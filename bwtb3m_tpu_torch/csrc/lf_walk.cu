// The batched LF-walk kernel over the fused rank rows (sm_90a).
//
// Port of bwtb3m_tpu/ops/lf_pallas.py::lf_walk_pallas (the Pallas kernel
// _lf_kernel): every lane walks LF steps from its start rank and ends on
// the final rank.  checkbwt and bwtcomputessa run the same kernel with a
// per-step visit, which replaces the XLA walk programs of the reference
// package:
//   Visit::kNone     lf_walk_pallas: the final rank only
//   Visit::kVerify   bwtb3m_tpu/engine/verify.py::_verify_chunk: count the
//                    steps whose symbol differs from the text read
//   Visit::kHarvest  bwtb3m_tpu/engine/ssa.py::_harvest_chunk with its host
//                    loop _harvest_fused: write the SA / ISA samples
//   Visit::kSelect   bwtb3m_tpu/engine/ssa.py::_select_chunk: walk until the
//                    current rank's bit is set in a bitmap of the .preisa
//                    ranks, report that rank and the steps taken.  The
//                    reference runs every lane for the full masked step
//                    count; here a lane tests the bit (one more random
//                    4-byte read per step) and leaves its loop at the hit,
//                    so a warp diverges: hits come after 0..prate steps.
//
// One thread owns one walk lane.  Every LF step reads the lane's rank row,
// and the symbol, the occ checkpoint and the in-block count all come from
// that row.  The chain r -> LF(r) is a dependent load per step, so a lane
// alone is bound by load latency; ~10^5 lanes in flight (one per preisa
// seed) and a row read as independent 16-byte loads, with no second
// dependent load inside a step, hide it.
//
// What bounds it then is the random reads a step makes.  The card reads
// device memory in 32-byte sectors: a 128-byte bit-plane row is four
// sectors and eight loads per step, a sector row (sigma <= 4: DNA) one
// sector and two loads.  Measured by chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W: at n = 400,000,009 (200 MB of rows, far past the 50 MB
// L2) 97,657 lanes x 4,096 steps take 11.5 ms on sector rows and 17.7 ms
// on bit-plane rows (verify visit 14.2 / 21.0, harvest visit 13.7 / 24.2):
// 35 G against 23 G steps/s.  With the rows inside the L2 (2^24 symbols)
// sector rows walk 87-105 G steps/s and bit-plane rows 31 G, at every
// table size: a row's eight loads, each a gather over 32 lines per warp,
// keep the L1 busy.  Past the L2 the sector walk follows the card's rate
// of random sector reads, ~38 G/s.  That is 1.2 TB/s of sectors, a third
// of the 3.35 TB/s the card streams, and bit-plane rows move 23 G x 128
// bytes = 3.0 TB/s, so a miss seems to cost device memory 64 bytes
// whatever the sector asks; cudaLimitMaxL2FetchGranularity = 32 changes
// nothing.  More than ~131,072 lanes lower the rate; PERF.md has the runs.
// Ranks and positions are uint32 in the narrow form (n < 2^32 on the paths
// that call it).  The 64-bit form, bwt_lf_walk_w, is a second instantiation
// of the same templates with 64-bit ranks and positions for texts of 2^32
// symbols or more: it reads the same rows, adds the occ checkpoint's hi
// word from a table of wrap rows staged in shared memory and reads a
// 64-bit C (focc_rows.cuh::WideTerms, ops/wideocc.py).
//
// Row layouts and the LF step: focc_rows.cuh (shared with gap_chain.cu).
//
// The entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "focc_rows.cuh"

namespace {

constexpr int kThreads = 256;

using bwt_rows::BitPlaneRows;
using bwt_rows::ByteRows;
using bwt_rows::kBpRowBytes;
using bwt_rows::kSectorRowBytes;
using bwt_rows::kThrK;
using bwt_rows::make_bp;
using bwt_rows::make_sector;
using bwt_rows::SectorRows;
using bwt_rows::WideTerms;

enum class Visit { kNone, kVerify, kHarvest, kSelect };

// The lanes and what a step visits.  Lane i starts at rank r0[i] (and, for
// a visit, at text position p0[i]) and takes seg_len[i] steps.  I is the
// rank and position type: uint32_t in the narrow form (n < 2^32), unsigned
// long long in the 64-bit form.
template <class I>
struct Walk {
  const I* r0;
  const I* p0;
  const int32_t* seg_len;
  I* r_out;              // final rank per lane
  I n;
  const uint8_t* text;   // kVerify: densified text
  int32_t* bad;          // kVerify: mismatches per lane
  I sarate, isarate;     // the 64-bit form: sarate is a power of two
  I* sa;                 // kHarvest: SA[r / sarate] = p
  I* isa;                // kHarvest: ISA[p / isarate] = r
  const uint32_t* bitwords;  // kSelect: bit r set where rank r ends the walk
  int32_t* steps;        // kSelect: steps taken to the hit, -1 without one
};

// One LF step: sym = BWT[r], returns C[sym] + rank(sym, r); the 64-bit
// form adds the occ checkpoint's hi word and reads the 64-bit C.
template <class I, class Rows>
__device__ __forceinline__ I lf(const Rows& rows, const WideTerms& wt, I r, uint32_t* sym) {
  if constexpr (sizeof(I) == 4) {
    return rows.step(r, sym);
  } else {
    const I k = rows.template symrank<I>(r, sym);
    return wt.C[*sym] + wt.hi(*sym, r >> Rows::kShift) + k;
  }
}

template <Visit V, class I, class Rows>
__device__ __forceinline__ void walk_lane(const Rows& rows, const WideTerms& wt,
                                          const Walk<I>& w, int i) {
  constexpr bool kWide = sizeof(I) == 8;
  I r = w.r0[i];
  I p = V == Visit::kVerify || V == Visit::kHarvest ? w.p0[i] : 0u;
  const int len = w.seg_len[i];
  int32_t bad = 0;
  int32_t hit = -1;
  // the 64-bit harvest keeps p's quotient and remainder by isarate and
  // counts them down (a 64-bit division per step would cost more than
  // the step); SA indices are a shift, sarate being a power of two
  I isa_q = 0, isa_ph = 0, sa_mask = 0;
  int sa_shift = 0;
  if constexpr (kWide && V == Visit::kHarvest) {
    isa_q = p / w.isarate;
    isa_ph = p - isa_q * w.isarate;
    sa_mask = w.sarate - 1;
    sa_shift = __ffsll((long long)w.sarate) - 1;
  }
  for (int k = 0; k < len; ++k) {
    if constexpr (V == Visit::kSelect) {
      if ((__ldg(w.bitwords + (r >> 5)) >> (r & 31u)) & 1u) {
        hit = k;
        break;
      }
    }
    if constexpr (V == Visit::kHarvest) {
      // every rank and every position is visited by exactly one (lane,
      // step), so the sample writes are direct and race-free
      if constexpr (kWide) {
        if ((r & sa_mask) == 0) w.sa[r >> sa_shift] = p;
        if (isa_ph == 0) w.isa[isa_q] = r;
      } else {
        if (r % w.sarate == 0) w.sa[r / w.sarate] = p;
        if (p % w.isarate == 0) w.isa[p / w.isarate] = r;
      }
    }
    uint32_t sym;
    r = lf<I>(rows, wt, r, &sym);  // sym = BWT[r] = text[p - 1]
    if constexpr (V == Visit::kVerify || V == Visit::kHarvest) {
      if constexpr (kWide && V == Visit::kHarvest) {
        if (p == 0) {        // the lane seeded at position 0 wraps
          isa_q = (w.n - 1) / w.isarate;
          isa_ph = (w.n - 1) - isa_q * w.isarate;
        } else if (isa_ph == 0) {
          isa_ph = w.isarate - 1;
          --isa_q;
        } else {
          --isa_ph;
        }
      }
      p = p == 0 ? w.n - 1 : p - 1;
    }
    if constexpr (V == Visit::kVerify) bad += sym != (uint32_t)__ldg(w.text + p);
  }
  w.r_out[i] = r;
  if constexpr (V == Visit::kVerify) w.bad[i] = bad;
  if constexpr (V == Visit::kSelect) w.steps[i] = hit;
}

template <Visit V, class I>
__global__ void lf_walk_bp_kernel(const uint8_t* rows, const uint32_t* C, int sigma,
                                  Walk<I> w, int nlanes, const uint32_t* thr,
                                  const unsigned long long* C64) {
  WideTerms wt{};
  if constexpr (sizeof(I) == 8) {
    __shared__ uint32_t s_thr[BitPlaneRows::kMaxSigma * kThrK];
    __shared__ unsigned long long s_c[BitPlaneRows::kMaxSigma];
    wt = bwt_rows::stage_wide(thr, C64, sigma, s_thr, s_c);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  if constexpr (sizeof(I) == 8) {
    walk_lane<V, I>(BitPlaneRows{rows, {}}, wt, w, i);   // C is wt's
  } else {
    walk_lane<V, I>(make_bp(rows, C, sigma), wt, w, i);
  }
}

template <Visit V, class I>
__global__ void lf_walk_sector_kernel(const uint8_t* rows, const uint32_t* C, int sigma,
                                      Walk<I> w, int nlanes, const uint32_t* thr,
                                      const unsigned long long* C64) {
  WideTerms wt{};
  if constexpr (sizeof(I) == 8) {
    __shared__ uint32_t s_thr[SectorRows::kMaxSigma * kThrK];
    __shared__ unsigned long long s_c[SectorRows::kMaxSigma];
    wt = bwt_rows::stage_wide(thr, C64, sigma, s_thr, s_c);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  if constexpr (sizeof(I) == 8) {
    walk_lane<V, I>(SectorRows{rows, {}}, wt, w, i);     // C is wt's
  } else {
    walk_lane<V, I>(make_sector(rows, C, sigma), wt, w, i);
  }
}

template <Visit V, class I>
__global__ void lf_walk_byte_kernel(ByteRows rows, int sigma, Walk<I> w, int nlanes,
                                    const uint32_t* thr, const unsigned long long* C64) {
  WideTerms wt{};
  if constexpr (sizeof(I) == 8) {
    __shared__ uint32_t s_thr[ByteRows::kMaxSigma * kThrK];
    __shared__ unsigned long long s_c[ByteRows::kMaxSigma];
    wt = bwt_rows::stage_wide(thr, C64, sigma, s_thr, s_c);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  walk_lane<V, I>(rows, wt, w, i);
}

template <Visit V, class I>
void launch(const void* rows, int roww, const void* C, int sigma, const Walk<I>& w,
            int nlanes, const void* thr, const void* C64, cudaStream_t s) {
  const int grid = (nlanes + kThreads - 1) / kThreads;
  const auto* rp = static_cast<const uint8_t*>(rows);
  const auto* cp = static_cast<const uint32_t*>(C);
  const auto* tp = static_cast<const uint32_t*>(thr);
  const auto* c64 = static_cast<const unsigned long long*>(C64);
  if (roww == kSectorRowBytes) {
    lf_walk_sector_kernel<V, I><<<grid, kThreads, 0, s>>>(rp, cp, sigma, w, nlanes, tp, c64);
  } else if (roww == kBpRowBytes) {
    lf_walk_bp_kernel<V, I><<<grid, kThreads, 0, s>>>(rp, cp, sigma, w, nlanes, tp, c64);
  } else {
    lf_walk_byte_kernel<V, I><<<grid, kThreads, 0, s>>>(ByteRows{rp, cp, roww}, sigma, w,
                                                        nlanes, tp, c64);
  }
}

}  // namespace

// The row width selects the layout: 32 bytes sector rows, 128 bytes
// bit-plane rows, anything else byte rows (at least 384 bytes wide).  A
// non-null text selects the verify visit, a
// non-null sa_out the harvest visit, a non-null bitwords the select visit
// (seg_len is then each lane's cap of steps); p0 is read only by the verify
// and harvest visits.  Ranks, positions and samples are uint32 (int32
// tensors holding uint32 bits).  Return value: cudaGetLastError() after
// the launch.
extern "C" int bwt_lf_walk(const void* rows, int roww, const void* C, int sigma,
                           long long n, const void* r0, const void* p0,
                           const void* seg_len, void* r_out, const void* text,
                           void* bad, int sarate, int isarate, void* sa_out,
                           void* isa_out, const void* bitwords, void* steps_out,
                           int nlanes, void* stream) {
  Walk<uint32_t> w;
  w.r0 = static_cast<const uint32_t*>(r0);
  w.p0 = static_cast<const uint32_t*>(p0);
  w.seg_len = static_cast<const int32_t*>(seg_len);
  w.r_out = static_cast<uint32_t*>(r_out);
  w.n = (uint32_t)n;
  w.text = static_cast<const uint8_t*>(text);
  w.bad = static_cast<int32_t*>(bad);
  w.sarate = (uint32_t)sarate;
  w.isarate = (uint32_t)isarate;
  w.sa = static_cast<uint32_t*>(sa_out);
  w.isa = static_cast<uint32_t*>(isa_out);
  w.bitwords = static_cast<const uint32_t*>(bitwords);
  w.steps = static_cast<int32_t*>(steps_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (text) {
    launch<Visit::kVerify>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else if (sa_out) {
    launch<Visit::kHarvest>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else if (bitwords) {
    launch<Visit::kSelect>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else {
    launch<Visit::kNone>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  }
  return (int)cudaGetLastError();
}

// The 64-bit form (texts of 2^32 symbols or more, or BWTB3M_FORCE_WIDE):
// the same rows, plus thr (uint32 [sigma * 8], ops/wideocc.py) and the
// 64-bit C (C64, [sigma]); ranks, positions and samples are 64-bit (int64
// tensors).  Final rank, verify and harvest visits (the select visit stays
// narrow, as in the reference); sarate must be a power of two.
extern "C" int bwt_lf_walk_w(const void* rows, int roww, const void* C64, const void* thr,
                             int sigma, long long n, const void* r0, const void* p0,
                             const void* seg_len, void* r_out, const void* text, void* bad,
                             long long sarate, long long isarate, void* sa_out,
                             void* isa_out, int nlanes, void* stream) {
  using U = unsigned long long;
  Walk<U> w{};
  w.r0 = static_cast<const U*>(r0);
  w.p0 = static_cast<const U*>(p0);
  w.seg_len = static_cast<const int32_t*>(seg_len);
  w.r_out = static_cast<U*>(r_out);
  w.n = (U)n;
  w.text = static_cast<const uint8_t*>(text);
  w.bad = static_cast<int32_t*>(bad);
  w.sarate = (U)sarate;
  w.isarate = (U)isarate;
  w.sa = static_cast<U*>(sa_out);
  w.isa = static_cast<U*>(isa_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (text) {
    launch<Visit::kVerify>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  } else if (sa_out) {
    launch<Visit::kHarvest>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  } else {
    launch<Visit::kNone>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  }
  return (int)cudaGetLastError();
}

// Sets (bytes > 0) and reads back cudaLimitMaxL2FetchGranularity, the
// bytes the L2 fetches from device memory on a miss; a negative return is
// minus a cudaError_t.
extern "C" int bwt_l2_fetch_granularity(int bytes) {
  if (bytes > 0) {
    const cudaError_t e = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
    if (e != cudaSuccess) return -(int)e;
  }
  size_t v = 0;
  const cudaError_t e = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  return e != cudaSuccess ? -(int)e : (int)v;
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
