// The merge engine's gap-chain kernel (sm_90a).
//
// Alphabets past 256 distinct symbols: bwt_gap_chain_mk_wm runs the
// recording and anchor forms over the wavelet rows of the right region
// (focc_rows.cuh::WaveletRows), one merge per launch, with a uint16 text;
// it replaces the reference's legacy engine's chain and anchor walks
// (bwtb3m_tpu/ops/gap.py::_chain_steps, _anchor_steps), which the port
// maps onto its scaled engine.
//
// Port of bwtb3m_tpu/ops/gapdev.py::_chain_chunk_impl / ::_anchor_chunk_impl
// (one pair merge) and of bwtb3m_tpu/ops/gapbatch.py::_chain_chunk_mk_impl /
// ::_anchor_chunk_mk_impl (the K pair merges of one level of the merge tree
// as one lane population).  One entry, bwt_gap_chain_mk, serves both: a
// single pair merge is a level of one.
//
// A merge k puts a left block [s, m) into a right region M = [m, e).  Lane
// j belongs to merge kid[j] and walks text positions p = starts[j],
// starts[j]-1, ... for lens[j] steps from the seed r = R(starts[j] + 1).
// Each step:
//
//   c  = text[p]                      flat uint8 device text
//   g  = bit (p - lo0) of the merge's gt bytes: rot(p+1) > rot(e)
//   r' = c_first[c] + rank(c, r) - [k0 < r && c == k1] + [c == k2 && g]
//
// with (k0, k1, k2) = (isa_m, text[m-1], text[e-1]) and rank over the fused
// rank rows (focc_rows.cuh, shared with lf_walk.cu).  The K right regions'
// rows are concatenated, each region starting on a row boundary and keeping
// its trailing checkpoint row, with region-local occ counts; a lane walks
// with the global rank rbase_k + local, so rank(c, r) lands in its own
// region's rows unchanged.  The per-merge constants live in a table of K
// small structs (c_first and k0 already offset by rbase_k) that a lane reads
// once before its loop, where the reference kept a [lanes, sigma] table per
// lane and selected from it with a compare mask.
//
// The recording form adds one to gap[r'] (one int32 histogram over the
// level's rank space), writes r' into the merge's samples at (p - samp_p0) /
// rate where p is a multiple of rate (every position is walked by one
// (lane, step), so the write is race-free; the value is R(p), the rank
// after the step at p), and ends with the lane's final rank.  The anchor
// form takes the same steps and keeps only the final rank.
//
// One thread per lane; every step makes one dependent rank-row load, as
// in the LF walk (one 32-byte sector on sector rows, sigma <= 4; four on
// bit-plane rows), plus one histogram atomic, which is fire-and-forget
// (its result is unused, so it compiles to a reduction that does not stall
// the lane).  The text and gt bytes do not depend on the rank chain and
// overlap with it.  The reference read text and gt from phase-aligned
// 256-symbol rows with every lane padded to one shared column per step;
// here each lane reads its own byte and takes exactly its own steps, so no
// padding or masking is needed.
//
// What bounds it: the scattered atomic.  Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W, at the root merge of a 400,000,009-symbol
// build (268,435,456 steps over 65,536 lanes, 131,564,553 ranks, a 526 MB
// histogram): the recording form takes about 33 ms on sector rows and 36 ms
// on bit-plane rows; the same walk without the atomic and the sample write
// (the anchor form over the same lanes at full length) 8 / 15 ms, which
// is the LF walk's rate (32 G steps/s on sector rows).  So 21-25 ms are the
// atomic's: it reads and writes back a random sector of a histogram ten
// times the L2, two more random accesses to device memory per step beside
// the row's one, at the ~38 G random sectors/s the card gives.  2^17 or
// 2^18 lanes are slower (40-44 ms; more text and gt lines compete for the
// L1) and 2^15 a little faster (28 ms); the callers keep 65,536 (PERF.md).
//
// Ranks and positions are uint32 in the narrow form, bwt_gap_chain_mk (the
// caller keeps positions below 2^32, refuses wide merges and keeps a
// level's rank space below 2^32).  The 64-bit form, bwt_gap_chain_mk_w, is
// a second instantiation of the same templates for one merge whose rank
// space or left block reaches 2^32 or whose positions pass it (port of
// bwtb3m_tpu/ops/gapwide.py::_chain_chunk_w_impl / ::_anchor_chunk_w_impl):
// 64-bit ranks, positions, constants and samples, the rank's hi word from
// the wrap rows in shared memory (focc_rows.cuh::WideTerms), and 64-bit
// histogram cells.  A cell counts the left suffixes between two adjacent
// right ones and the cells sum to the left block's length, and one cell
// can hold all of it (a poly-A left block against a right block without
// A).  The narrow form's left block stays below 2^32, so its cells are
// uint32, atomicAdd'ed as such and read as such by the zip's cumsum
// (ops/devzip.py::gap_cum); the wide form's left block may be 2^32 or
// more, so its cells are 64-bit, 8 bytes per rank, and the zip's int64
// cumsum is then taken in place (engine/merge_scaled.py).  The entry points
// launch on the caller's stream, do not synchronise and return
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "focc_rows.cuh"

namespace {

constexpr int kThreads = 256;

using bwt_rows::kThrK;
using bwt_rows::WideTerms;

// The constants of one pair merge, in words of the rank type I.  The
// layout is the wrapper's (ops/gapbatch.py::MERGE_WORDS words per merge).
template <class I>
struct Merge {
  I c_first;    // index of the merge's first c_first word
  I k0;         // rbase + isa_m
  I k1, k2;     // sym_before_m, sym_last
  I lo0;        // text position of the merge's gt bit 0
  I gt_base;    // byte of the merge's gt bit 0 in gt
  I samp_base;  // index of the merge's first sample in samp
  I samp_p0;    // first sampled position (a multiple of rate)
};

// I: ranks, positions and samples (uint32_t narrow, unsigned long long in
// the 64-bit form); Cell: the histogram's cells (uint32_t, unsigned long
// long); T: the text's symbols (uint16_t on the wavelet rows).
template <class I, class Cell, class T = uint8_t>
struct Chain {
  const T* text;            // dense text, n symbols
  const uint8_t* gt;        // wrap-term bits, LSB first
  const I* c_first;         // c_first[m.c_first + c]: rbase + right rotations below c
  const Merge<I>* table;    // K merges
  const int32_t* kid;       // merge of each lane
  const int64_t* starts;    // first walk position of each lane
  const I* seeds;           // R(starts + 1)
  const int32_t* lens;      // steps of each lane
  I* r_out;                 // final rank of each lane
  Cell* gap;                // recording form: histogram of every R
  I* samp;                  // recording form: R at the sampled positions
  I rate;
};

template <bool kRecord, class I, class Cell, class T, class Rows>
__device__ __forceinline__ void chain_lane(const Rows& rows, const WideTerms& wt,
                                           const Chain<I, Cell, T>& ch, int j) {
  const Merge<I> m = ch.table[ch.kid[j]];
  const I* c_first = ch.c_first + m.c_first;
  const uint8_t* gt = ch.gt + m.gt_base;
  I* samp = ch.samp + m.samp_base;
  I r = ch.seeds[j];
  I p = (I)ch.starts[j];
  const int len = ch.lens[j];
  I phase = kRecord ? p % ch.rate : 0u;  // p mod rate, counted down
  for (int k = 0; k < len; ++k) {
    const uint32_t c = __ldg(ch.text + p);
    const I off = p - m.lo0;
    const uint32_t g = (__ldg(gt + (off >> 3)) >> ((uint32_t)off & 7u)) & 1u;
    I rk;
    if constexpr (sizeof(I) == 4) {
      rk = rows.rank(c, r);
    } else {
      rk = rows.template rank<I>(c, r) + wt.hi(c, r >> Rows::kShift);
    }
    r = __ldg(c_first + c) + rk - (I)(m.k0 < r && c == m.k1) + (I)(c == m.k2 && g);
    if constexpr (kRecord) {
      atomicAdd(ch.gap + r, (Cell)1);
      if (phase == 0) {
        samp[(p - m.samp_p0) / ch.rate] = r;
        phase = ch.rate;
      }
      --phase;
    }
    --p;
  }
  ch.r_out[j] = r;
}

template <bool kRecord, class Rows, class I, class Cell>
__global__ void chain_kernel(Rows rows, Chain<I, Cell> ch, int nlanes, const uint32_t* thr,
                             int sigma) {
  WideTerms wt{};
  if constexpr (sizeof(I) == 8) {
    __shared__ uint32_t s_thr[Rows::kMaxSigma * kThrK];
    wt = bwt_rows::stage_wide(thr, nullptr, sigma, s_thr, nullptr);
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nlanes) return;
  chain_lane<kRecord>(rows, wt, ch, j);
}

template <bool kRecord, class I, class Cell>
void launch_form(const uint8_t* rows, int roww, const Chain<I, Cell>& ch, int nlanes,
                 const uint32_t* thr, int sigma, cudaStream_t s) {
  const int grid = (nlanes + kThreads - 1) / kThreads;
  if (roww == bwt_rows::kSectorRowBytes) {
    chain_kernel<kRecord><<<grid, kThreads, 0, s>>>(bwt_rows::SectorRows{rows, {}}, ch,
                                                    nlanes, thr, sigma);
  } else if (roww == bwt_rows::kBpRowBytes) {
    chain_kernel<kRecord><<<grid, kThreads, 0, s>>>(bwt_rows::BitPlaneRows{rows, {}}, ch,
                                                    nlanes, thr, sigma);
  } else {
    chain_kernel<kRecord><<<grid, kThreads, 0, s>>>(
        bwt_rows::ByteRows{rows, nullptr, roww}, ch, nlanes, thr, sigma);
  }
}

// The row width selects the layout: 32 bytes sector rows, 128 bytes
// bit-plane rows, anything else byte rows.  A non-null gap selects the
// recording form (then samp must be non-null too); a null gap the anchor
// form.  Returns cudaGetLastError() after the launch.
template <class I, class Cell>
int launch(const void* rows_v, int roww, const Chain<I, Cell>& ch, int nlanes,
           const void* thr, int sigma, void* stream) {
  const auto* rows = static_cast<const uint8_t*>(rows_v);
  const auto* tp = static_cast<const uint32_t*>(thr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch.gap != nullptr) {
    launch_form<true>(rows, roww, ch, nlanes, tp, sigma, s);
  } else {
    launch_form<false>(rows, roww, ch, nlanes, tp, sigma, s);
  }
  return (int)cudaGetLastError();
}

template <class I, class Cell, class T = uint8_t>
Chain<I, Cell, T> make_chain(const void* text, const void* gt, const void* c_first,
                             const void* table, const void* kid, const void* starts,
                             const void* seeds, const void* lens, void* r_out, void* gap,
                             void* samp, long long rate) {
  Chain<I, Cell, T> ch{};
  ch.text = static_cast<const T*>(text);
  ch.gt = static_cast<const uint8_t*>(gt);
  ch.c_first = static_cast<const I*>(c_first);
  ch.table = static_cast<const Merge<I>*>(table);
  ch.kid = static_cast<const int32_t*>(kid);
  ch.starts = static_cast<const int64_t*>(starts);
  ch.seeds = static_cast<const I*>(seeds);
  ch.lens = static_cast<const int32_t*>(lens);
  ch.r_out = static_cast<I*>(r_out);
  ch.gap = static_cast<Cell*>(gap);
  ch.samp = static_cast<I*>(samp);
  ch.rate = (I)rate;
  return ch;
}

// The wavelet rows (one merge, narrow): start staged in shared memory
// where the host gave the bytes for it, the text uint16.
template <bool kRecord>
__global__ void chain_wm_kernel(bwt_rows::WaveletArgs a,
                                Chain<uint32_t, uint32_t, uint16_t> ch, int nlanes) {
  extern __shared__ uint32_t s_tab[];
  const bwt_rows::WaveletRows rows = bwt_rows::stage_wavelet(a, s_tab);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nlanes) return;
  chain_lane<kRecord>(rows, WideTerms{}, ch, j);
}

}  // namespace

// The K pair merges of one level (K = 1: one pair merge): lane j belongs to
// merge kid[j], whose constants are table[kid[j]]; rows are the concatenated
// rank rows, seeds, final ranks and histogram cells global, uint32 (int32
// tensors holding uint32 bits).
extern "C" int bwt_gap_chain_mk(const void* rows, int roww, const void* text, const void* gt,
                                const void* c_first, const void* table, const void* kid,
                                const void* starts, const void* seeds, const void* lens,
                                void* r_out, void* gap, void* samp, int rate, int nlanes,
                                void* stream) {
  return launch(rows, roww,
                make_chain<uint32_t, uint32_t>(text, gt, c_first, table, kid, starts,
                                               seeds, lens, r_out, gap, samp, rate),
                nlanes, nullptr, 0, stream);
}

// The 64-bit form (a merge whose rank space or left block reaches 2^32,
// whose positions pass 2^32, or BWTB3M_FORCE_WIDE): one merge's rank rows
// with their wrap rows thr (uint32 [sigma * 8], ops/wideocc.py); c_first,
// the merge table, seeds, final ranks and samples are 64-bit, and so are
// the histogram's cells.
extern "C" int bwt_gap_chain_mk_w(const void* rows, int roww, const void* thr, int sigma,
                                  const void* text, const void* gt, const void* c_first,
                                  const void* table, const void* kid, const void* starts,
                                  const void* seeds, const void* lens, void* r_out,
                                  void* gap, void* samp, long long rate, int nlanes,
                                  void* stream) {
  using U = unsigned long long;
  return launch(rows, roww,
                make_chain<U, U>(text, gt, c_first, table, kid, starts, seeds, lens,
                                 r_out, gap, samp, rate),
                nlanes, thr, sigma, stream);
}

// One pair merge over wavelet rows (more than 256 distinct symbols, n <
// 2^31; ops/wavelet_rows.py): the right region's blocks ([levels][nblk]
// x 64 bytes), the digit table zc (uint32 [levels][8]) and start (uint32
// [sigma]); text is the dense text as uint16; the rest as
// bwt_gap_chain_mk with one merge.  start sits in shared memory when
// smem_bytes is not 0.
extern "C" int bwt_gap_chain_mk_wm(const void* blocks, long long nblk, int levels,
                                   const void* zc, const void* start, int sigma,
                                   int smem_bytes, const void* text, const void* gt,
                                   const void* c_first, const void* table, const void* kid,
                                   const void* starts, const void* seeds, const void* lens,
                                   void* r_out, void* gap, void* samp, int rate, int nlanes,
                                   void* stream) {
  bwt_rows::WaveletArgs a;
  a.blk = static_cast<const uint4*>(blocks);
  a.nblk = (unsigned long long)nblk;
  a.levels = levels;
  a.sigma = sigma;
  a.zc = static_cast<const uint32_t*>(zc);
  a.D = nullptr;
  a.start = static_cast<const uint32_t*>(start);
  a.stage = smem_bytes ? 2 : 0;
  const auto ch = make_chain<uint32_t, uint32_t, uint16_t>(
      text, gt, c_first, table, kid, starts, seeds, lens, r_out, gap, samp, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (nlanes + kThreads - 1) / kThreads;
  if (gap != nullptr) {
    chain_wm_kernel<true><<<grid, kThreads, smem_bytes, s>>>(a, ch, nlanes);
  } else {
    chain_wm_kernel<false><<<grid, kThreads, smem_bytes, s>>>(a, ch, nlanes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
