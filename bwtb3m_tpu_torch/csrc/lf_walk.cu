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
//   Visit::kLocate   bwtb3m_tpu/index/fm.py::FMIndex.locate_batch: walk to the
//                    first rank that is a multiple of the sampled SA's rate,
//                    report that rank and the steps taken
//   Visit::kDecode   bwtb3m_tpu/index/fm.py::FMIndex.extract (bwtdecodeblock):
//                    the verify visit with its comparison replaced by a
//                    store of each emitted symbol at its text offset, on
//                    a lane at every ISA and .sa sample of the range
//                    (index/fm.py::decode_lanes_sa)
//   lf_select        bwtb3m_tpu/engine/ssa.py::_select_chunk: walk until the
//                    current rank's bit is set in a bitmap of the .preisa
//                    ranks, report that rank and the steps taken.  Its own
//                    kernel, select_kernel below: lanes that end refill.
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
// Alphabets past 256 symbols: bwt_lf_walk_wm instantiates the same walk
// (final rank, verify, harvest; narrow, uint32) over the wavelet rows
// (focc_rows.cuh::WaveletRows, ops/wavelet_rows.py) and replaces the
// reference's legacy walks over its OccTable: ops/lf.py::lf_walk,
// engine/verify.py::_walk_verify_run and engine/ssa.py::_harvest_walk.
// Its text is uint16 (the dense symbol ids).  A step is one descent, a
// dependent 64-byte block read per level of three bits (5 for 5,000
// symbols), where the other families read one row: a miss costing 64
// bytes whatever is asked (above), the block is as cheap as a sector.
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
using bwt_rows::WaveletArgs;
using bwt_rows::WaveletRows;
using bwt_rows::WideTerms;

enum class Visit { kNone, kVerify, kHarvest, kLocate, kDecode };

// The locate visit's walk length is not bounded by the rate: the .sa is
// sampled by rank, so a backward walk meets a sampled rank after about
// rate steps on average, with a geometric tail that a repetitive text
// stretches.  Each lane walks to its end; on a BWT whose LF is one cycle
// of n ranks it meets rank 0 within n - 1 steps, so a lane still walking
// after n steps (LF of several cycles: not the BWT of a primitive text)
// stops and reports -1 instead of walking forever.
//
// The locate and decode visits run one thread a lane, as the others:
// lanes end at different steps and a block keeps its SM slot until its
// longest lane ends.  A persistent grid whose threads take the next lane
// from a counter as theirs ends (bwt_lf_select's loop) was measured in
// turns against it, in four forms (the select loop; with the lane after
// a thread's own taken and loaded ahead; with each lane walked in a loop
// of its own; lanes in a fixed order, no counter) at 1, 2, 4 and 8
// blocks per SM (chip_ab.py --only fm, PERF.md; NVIDIA H100 80GB HBM3,
// 700 W).  None won: at 1.2 G symbols 2^20 locate lanes took 1.11-1.43
// ms against 1.02-1.03 ms, the decode's 524,356 lanes 1.15-1.48 ms
// against 1.19-1.22 ms, and at 2^22 16,384 locate lanes of 10^5-10^6
// steps 282-520 ms against 262 ms.  Past the L2 one thread a lane
// already keeps the card at its rate of random sector reads, and a loop
// that takes lanes adds to every step (the counter's atomics, each new
// lane's start loads, the convergence barriers around a warp-synchronous
// take: cuobjdump -sass).  What held the decode visit back was its lanes:
// one per ISA sample, 65 lanes of up to 262,144 steps for 2^24 symbols
// at 1.2 G, each at its step latency (193 ms).  Its lanes now start at
// the .sa samples too: 524,356 lanes of 32 steps on average and 405 at
// most, 1.2-1.5 ms; its scattered byte stores take 13% of that (0.94 ms
// with them masked), so the row reads set its pace.

// The lanes and what a step visits.  Lane i starts at rank r0[i] (and, for
// a visit, at text position p0[i]) and takes seg_len[i] steps.  I is the
// rank and position type: uint32_t in the narrow form (n < 2^32), unsigned
// long long in the 64-bit form; T the text's symbol type (uint16_t on the
// wavelet rows).
template <class I, class T = uint8_t>
struct Walk {
  const I* r0;
  const I* p0;
  const int32_t* seg_len;
  I* r_out;              // final rank per lane
  I n;
  const T* text;         // kVerify: densified text
  int32_t* bad;          // kVerify: mismatches per lane
  I sarate, isarate;     // the 64-bit form: sarate is a power of two
  I* sa;                 // kHarvest: SA[r / sarate] = p
  I* isa;                // kHarvest: ISA[p / isarate] = r
  I rate;                // kLocate: the sampled SA's rate (any, >= 1)
  long long* steps;      // kLocate: steps to the sampled rank, -1 after n
  T* out;                // kDecode: out[(p - base) mod n] = BWT[r] where
  I base, out_len;       //   that offset is below out_len
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

// The locate visit: LF steps from r0[i] until the rank is a multiple of
// the rate (a mask where the rate is a power of two, else a modulo).
template <class I, class T, class Rows>
__device__ __forceinline__ void locate_lane(const Rows& rows, const WideTerms& wt,
                                            const Walk<I, T>& w, int i) {
  const I rate = w.rate;
  const bool pow2 = (rate & (rate - 1)) == 0;
  I r = w.r0[i];
  long long k = 0;
  while (pow2 ? (r & (rate - 1)) != 0 : r % rate != 0) {
    if ((I)k == w.n) {
      k = -1;
      break;
    }
    uint32_t sym;
    r = lf<I>(rows, wt, r, &sym);
    ++k;
  }
  w.r_out[i] = r;
  w.steps[i] = k;
}

template <Visit V, class I, class T, class Rows>
__device__ __forceinline__ void walk_lane(const Rows& rows, const WideTerms& wt,
                                          const Walk<I, T>& w, int i) {
  if constexpr (V == Visit::kLocate) {
    locate_lane(rows, wt, w, i);
    return;
  }
  constexpr bool kWide = sizeof(I) == 8;
  constexpr bool kPos = V == Visit::kVerify || V == Visit::kHarvest || V == Visit::kDecode;
  I r = w.r0[i];
  I p = kPos ? w.p0[i] : 0u;
  const int len = w.seg_len[i];
  int32_t bad = 0;
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
    if constexpr (kPos) {
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
    if constexpr (V == Visit::kDecode) {
      // text[p] = sym; lanes whose walks cover a position twice (a range
      // of n symbols from a sample past its end) store the same symbol
      const I o = p >= w.base ? p - w.base : p + (w.n - w.base);
      if (o < w.out_len) w.out[o] = (T)sym;
    }
  }
  w.r_out[i] = r;
  if constexpr (V == Visit::kVerify) w.bad[i] = bad;
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

// The wavelet rows: D staged in shared memory where sigma words fit
// (the host passes the bytes), the text uint16.
template <Visit V>
__global__ void lf_walk_wm_kernel(WaveletArgs a, Walk<uint32_t, uint16_t> w, int nlanes) {
  extern __shared__ uint32_t s_tab[];
  const WaveletRows rows = bwt_rows::stage_wavelet(a, s_tab);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  walk_lane<V, uint32_t>(rows, WideTerms{}, w, i);
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

// ---------------------------------------------------------------- select
//
// The select walk (port of bwtb3m_tpu/engine/ssa.py::_select_chunk): lane
// i LF-steps from rank r0[i] until bit r of a bitmap of the .preisa ranks
// is set, tested before each of at most cap steps, and reports (rank,
// steps), steps = -1 without a hit.
//
// What bounds it.  A step reads its rank row (one 32-byte sector on
// sector rows) at a random rank, and the bit of the same rank: with the
// bitmap (n / 8 bytes, 150 MB at 1.2 G symbols) far past the 50 MB L2,
// that is a second random miss, and since the lane has to know the bit
// before it may step, the two misses came one after the other.  The
// marks are sparse (one per .preisa interval of 16,384 positions at 1.2
// G: 73,243 marks), so more than 99.9% of those reads return 0.  And
// lanes end after 0..cap steps, so in a grid of one thread per lane a
// block kept its SM slot until its longest lane ended, about half its
// threads idle.
//
// What the design does about it.
//   A summary bitmap, one bit per block of 2^shift ranks (shift = 8: 586
//   KB at 1.2 G symbols, 1.56 MB at 3.2 G), set where the block holds a
//   mark, stays in the L2.  A step issues its row load and its summary
//   load together (both depend on r alone), so it waits on one miss; the
//   exact bitmap word is read only where the summary bit is set (about
//   2^shift / prate of the steps, 1.6% at 1.2 G).  The row is read and
//   stepped even on the step that hits; its result is then dropped.
//   Lanes refill: a persistent grid of a few blocks per SM, each thread
//   taking the next wanted rank from a counter (one atomicAdd per warp
//   for the threads that need one) when its lane hits or reaches cap, so
//   no thread idles while another lane of its block walks on.  Results
//   are written at the wanted rank's slot, whichever thread took it.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, 2^20
// wanted ranks on sector rows: 8.58 G steps at n = 1.2 G in 269 ms (31.9
// G steps/s; one thread per lane, the bitmap alone: 517 ms), 17.16 G
// steps at 3.2 G in 559 ms (1,072 ms): the rate of random sector reads
// that the LF walk follows past the L2.  Of 1, 2, 4 and 8 blocks per SM
// and summary blocks of 2^6 to 2^12 ranks, 4 blocks (135,168 resident
// lanes) and 2^8 were fastest (ops/lf_walk.py; PERF.md has the sweep).

struct Select {
  const uint32_t* r0;        // wanted ranks
  uint32_t* r_out;           // hit rank (or where the walk stopped)
  int32_t* steps;            // steps to the hit, -1 without one
  const uint32_t* bitwords;  // bit r set where r is a .preisa rank
  const uint32_t* summary;   // bit b set where block b of 2^shift ranks has one
  int* next;                 // the next wanted rank to take, from 0
  int shift, cap, nlanes;
};

// The next wanted rank for each thread of the warp that asks together:
// one atomicAdd for all of them.
__device__ __forceinline__ int take_lane(int* next) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(next, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + __popc(mask & ((1u << lane) - 1u));
}

template <class Rows>
__device__ __forceinline__ void select_lanes(const Rows& rows, const Select& s) {
  int i = take_lane(s.next);
  uint32_t r = i < s.nlanes ? __ldg(s.r0 + i) : 0u;
  int k = 0;
  while (i < s.nlanes) {
    int32_t done = -2;                  // -2: the lane walks on
    if (k == s.cap) {
      done = -1;
    } else {
      const uint32_t sw = __ldg(s.summary + (r >> (s.shift + 5)));
      uint32_t sym;
      const uint32_t nxt = rows.step(r, &sym);
      if (((sw >> ((r >> s.shift) & 31u)) & 1u) &&
          ((__ldg(s.bitwords + (r >> 5)) >> (r & 31u)) & 1u)) {
        done = k;
      } else {
        r = nxt;
        ++k;
      }
    }
    if (done != -2) {
      s.r_out[i] = r;
      s.steps[i] = done;
      i = take_lane(s.next);
      if (i < s.nlanes) {
        r = __ldg(s.r0 + i);
        k = 0;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) select_sector_kernel(const uint8_t* rows,
                                                                 const uint32_t* C,
                                                                 int sigma, Select s) {
  select_lanes(make_sector(rows, C, sigma), s);
}

__global__ void __launch_bounds__(kThreads) select_bp_kernel(const uint8_t* rows,
                                                             const uint32_t* C, int sigma,
                                                             Select s) {
  select_lanes(make_bp(rows, C, sigma), s);
}

__global__ void __launch_bounds__(kThreads) select_byte_kernel(ByteRows rows, Select s) {
  select_lanes(rows, s);
}

}  // namespace

// The row width selects the layout: 32 bytes sector rows, 128 bytes
// bit-plane rows, anything else byte rows (at least 384 bytes wide).  A
// non-null steps_out selects the locate visit (to a multiple of rate;
// seg_len and p0 unread), a non-null dec_out the decode visit (out_len
// symbols from text position base, uint8), a non-null text the verify
// visit, a
// non-null sa_out the harvest visit; p0 is read only by the verify,
// harvest and decode visits.  Ranks, positions and samples are uint32
// (int32 tensors holding uint32 bits), steps_out int64.  Return value:
// cudaGetLastError() after the launch.
template <class I, class T>
void set_visits(Walk<I, T>& w, void* steps_out, long long rate, void* dec_out,
                long long base, long long out_len) {
  w.rate = (I)rate;
  w.steps = static_cast<long long*>(steps_out);
  w.out = static_cast<T*>(dec_out);
  w.base = (I)base;
  w.out_len = (I)out_len;
}

extern "C" int bwt_lf_walk(const void* rows, int roww, const void* C, int sigma,
                           long long n, const void* r0, const void* p0,
                           const void* seg_len, void* r_out, const void* text,
                           void* bad, int sarate, int isarate, void* sa_out,
                           void* isa_out, void* steps_out, long long rate,
                           void* dec_out, long long base, long long out_len,
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
  set_visits(w, steps_out, rate, dec_out, base, out_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps_out) {
    launch<Visit::kLocate>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else if (dec_out) {
    launch<Visit::kDecode>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else if (text) {
    launch<Visit::kVerify>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else if (sa_out) {
    launch<Visit::kHarvest>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  } else {
    launch<Visit::kNone>(rows, roww, C, sigma, w, nlanes, nullptr, nullptr, s);
  }
  return (int)cudaGetLastError();
}

// The 64-bit form (texts of 2^32 symbols or more, or BWTB3M_FORCE_WIDE):
// the same rows, plus thr (uint32 [sigma * 8], ops/wideocc.py) and the
// 64-bit C (C64, [sigma]); ranks, positions and samples are 64-bit (int64
// tensors).  Final rank, verify, harvest, locate and decode visits (the
// select visit stays narrow, as in the reference); the harvest's sarate
// must be a power of two, the locate's rate any.
extern "C" int bwt_lf_walk_w(const void* rows, int roww, const void* C64, const void* thr,
                             int sigma, long long n, const void* r0, const void* p0,
                             const void* seg_len, void* r_out, const void* text, void* bad,
                             long long sarate, long long isarate, void* sa_out,
                             void* isa_out, void* steps_out, long long rate,
                             void* dec_out, long long base, long long out_len,
                             int nlanes, void* stream) {
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
  set_visits(w, steps_out, rate, dec_out, base, out_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps_out) {
    launch<Visit::kLocate>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  } else if (dec_out) {
    launch<Visit::kDecode>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  } else if (text) {
    launch<Visit::kVerify>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  } else if (sa_out) {
    launch<Visit::kHarvest>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  } else {
    launch<Visit::kNone>(rows, roww, nullptr, sigma, w, nlanes, thr, C64, s);
  }
  return (int)cudaGetLastError();
}

// The walk over wavelet rows (sigma > 256, n < 2^31): blocks ([levels]
// [nblk] x 64 bytes), the digit table zc (uint32 [levels][8]) and D
// (uint32 [sigma]) of ops/wavelet_rows.py; text (verify) is the densified
// text as uint16, and so is the decode visit's out; otherwise as
// bwt_lf_walk.  D sits in shared memory when smem_bytes (the host's
// choice, sigma * 4 or 0) is not 0.
extern "C" int bwt_lf_walk_wm(const void* blocks, long long nblk, int levels,
                              const void* zc, const void* D, int sigma,
                              int smem_bytes, long long n, const void* r0,
                              const void* p0, const void* seg_len, void* r_out,
                              const void* text, void* bad, int sarate, int isarate,
                              void* sa_out, void* isa_out, void* steps_out,
                              long long rate, void* dec_out, long long base,
                              long long out_len, int nlanes, void* stream) {
  WaveletArgs a;
  a.blk = static_cast<const uint4*>(blocks);
  a.nblk = (unsigned long long)nblk;
  a.levels = levels;
  a.sigma = sigma;
  a.zc = static_cast<const uint32_t*>(zc);
  a.D = static_cast<const uint32_t*>(D);
  a.start = nullptr;
  a.stage = smem_bytes ? 1 : 0;
  Walk<uint32_t, uint16_t> w;
  w.r0 = static_cast<const uint32_t*>(r0);
  w.p0 = static_cast<const uint32_t*>(p0);
  w.seg_len = static_cast<const int32_t*>(seg_len);
  w.r_out = static_cast<uint32_t*>(r_out);
  w.n = (uint32_t)n;
  w.text = static_cast<const uint16_t*>(text);
  w.bad = static_cast<int32_t*>(bad);
  w.sarate = (uint32_t)sarate;
  w.isarate = (uint32_t)isarate;
  w.sa = static_cast<uint32_t*>(sa_out);
  w.isa = static_cast<uint32_t*>(isa_out);
  set_visits(w, steps_out, rate, dec_out, base, out_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (nlanes + kThreads - 1) / kThreads;
  if (steps_out) {
    lf_walk_wm_kernel<Visit::kLocate><<<grid, kThreads, smem_bytes, s>>>(a, w, nlanes);
  } else if (dec_out) {
    lf_walk_wm_kernel<Visit::kDecode><<<grid, kThreads, smem_bytes, s>>>(a, w, nlanes);
  } else if (text) {
    lf_walk_wm_kernel<Visit::kVerify><<<grid, kThreads, smem_bytes, s>>>(a, w, nlanes);
  } else if (sa_out) {
    lf_walk_wm_kernel<Visit::kHarvest><<<grid, kThreads, smem_bytes, s>>>(a, w, nlanes);
  } else {
    lf_walk_wm_kernel<Visit::kNone><<<grid, kThreads, smem_bytes, s>>>(a, w, nlanes);
  }
  return (int)cudaGetLastError();
}

// The select walk on narrow rank rows (the row width selects the layout,
// as for bwt_lf_walk): nlanes wanted ranks r0 (uint32), cap steps at
// most; writes r_out (uint32) and steps (int32) per wanted rank.  bitwords
// holds one bit per rank (n / 32 + 1 words), summary one bit per block of
// 2^shift ranks (shift >= 5), set where the block holds a set bit of
// bitwords.  next is one int32 on the card, 0 at the launch (nlanes plus
// the grid's threads must stay below 2^31); blocks is the persistent
// grid, kThreads threads each.  Return value: cudaGetLastError() after the
// launch.
extern "C" int bwt_lf_select(const void* rows, int roww, const void* C, int sigma,
                             const void* r0, void* r_out, void* steps,
                             const void* bitwords, const void* summary, int shift,
                             int cap, int nlanes, void* next, int blocks,
                             void* stream) {
  Select s;
  s.r0 = static_cast<const uint32_t*>(r0);
  s.r_out = static_cast<uint32_t*>(r_out);
  s.steps = static_cast<int32_t*>(steps);
  s.bitwords = static_cast<const uint32_t*>(bitwords);
  s.summary = static_cast<const uint32_t*>(summary);
  s.next = static_cast<int*>(next);
  s.shift = shift;
  s.cap = cap;
  s.nlanes = nlanes;
  const auto* rp = static_cast<const uint8_t*>(rows);
  const auto* cp = static_cast<const uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (roww == kSectorRowBytes) {
    select_sector_kernel<<<blocks, kThreads, 0, st>>>(rp, cp, sigma, s);
  } else if (roww == kBpRowBytes) {
    select_bp_kernel<<<blocks, kThreads, 0, st>>>(rp, cp, sigma, s);
  } else {
    select_byte_kernel<<<blocks, kThreads, 0, st>>>(ByteRows{rp, cp, roww}, s);
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
