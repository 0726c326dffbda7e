// The merge engine's gap-chain kernel (sm_90a).
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
// Ranks and positions are uint32 (the caller asserts n < 2^32, refuses
// wide merges and keeps a level's rank space below 2^32).  The entry point
// launches on the caller's stream, does not synchronise and returns
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "focc_rows.cuh"

namespace {

constexpr int kThreads = 256;

// The constants of one pair merge.  The layout is the wrapper's
// (ops/gapbatch.py::MERGE_WORDS uint32 words per merge).
struct Merge {
  uint32_t c_first;  // index of the merge's first c_first word
  uint32_t k0;       // rbase + isa_m
  uint32_t k1, k2;   // sym_before_m, sym_last
  uint32_t lo0;      // text position of the merge's gt bit 0
  uint32_t gt_base;  // byte of the merge's gt bit 0 in gt
  uint32_t samp_base;  // index of the merge's first sample in samp
  uint32_t samp_p0;  // first sampled position (a multiple of rate)
};

struct Chain {
  const uint8_t* text;      // dense text, n symbols
  const uint8_t* gt;        // wrap-term bits, LSB first
  const uint32_t* c_first;  // c_first[m.c_first + c]: rbase + right rotations below c
  const Merge* table;       // K merges
  const int32_t* kid;       // merge of each lane
  const int64_t* starts;    // first walk position of each lane
  const int32_t* seeds;     // R(starts + 1), uint32 bits
  const int32_t* lens;      // steps of each lane
  int32_t* r_out;           // final rank of each lane, uint32 bits
  int32_t* gap;             // recording form: histogram of every R
  int32_t* samp;            // recording form: R at the sampled positions
  uint32_t rate;
};

template <bool kRecord, class Rows>
__device__ __forceinline__ void chain_lane(const Rows& rows, const Chain& ch, int j) {
  const Merge m = ch.table[ch.kid[j]];
  const uint32_t* c_first = ch.c_first + m.c_first;
  const uint8_t* gt = ch.gt + m.gt_base;
  int32_t* samp = ch.samp + m.samp_base;
  uint32_t r = (uint32_t)ch.seeds[j];
  uint32_t p = (uint32_t)ch.starts[j];
  const int len = ch.lens[j];
  uint32_t phase = kRecord ? p % ch.rate : 0u;  // p mod rate, counted down
  for (int k = 0; k < len; ++k) {
    const uint32_t c = __ldg(ch.text + p);
    const uint32_t off = p - m.lo0;
    const uint32_t g = (__ldg(gt + (off >> 3)) >> (off & 7u)) & 1u;
    const uint32_t rk = rows.rank(c, r);
    r = __ldg(c_first + c) + rk - (uint32_t)(m.k0 < r && c == m.k1) +
        (uint32_t)(c == m.k2 && g);
    if (kRecord) {
      atomicAdd(ch.gap + r, 1);
      if (phase == 0) {
        samp[(p - m.samp_p0) / ch.rate] = (int32_t)r;
        phase = ch.rate;
      }
      --phase;
    }
    --p;
  }
  ch.r_out[j] = (int32_t)r;
}

template <bool kRecord>
__global__ void chain_bp_kernel(const uint8_t* rows, Chain ch, int nlanes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nlanes) return;
  const bwt_rows::BitPlaneRows b{rows, {}};
  chain_lane<kRecord>(b, ch, j);
}

template <bool kRecord>
__global__ void chain_sector_kernel(const uint8_t* rows, Chain ch, int nlanes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nlanes) return;
  const bwt_rows::SectorRows b{rows, {}};
  chain_lane<kRecord>(b, ch, j);
}

template <bool kRecord>
__global__ void chain_byte_kernel(bwt_rows::ByteRows rows, Chain ch, int nlanes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nlanes) return;
  chain_lane<kRecord>(rows, ch, j);
}

// The row width selects the layout: 32 bytes sector rows, 128 bytes
// bit-plane rows, anything else byte rows.  A non-null gap selects the
// recording form (then samp must be non-null too); a null gap the anchor
// form.  Returns cudaGetLastError() after the launch.
int launch(const void* rows_v, int roww, const Chain& ch, int nlanes, void* stream) {
  const auto* rows = static_cast<const uint8_t*>(rows_v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (nlanes + kThreads - 1) / kThreads;
  const bool rec = ch.gap != nullptr;
  if (roww == bwt_rows::kSectorRowBytes) {
    if (rec) chain_sector_kernel<true><<<grid, kThreads, 0, s>>>(rows, ch, nlanes);
    else chain_sector_kernel<false><<<grid, kThreads, 0, s>>>(rows, ch, nlanes);
  } else if (roww == bwt_rows::kBpRowBytes) {
    if (rec) chain_bp_kernel<true><<<grid, kThreads, 0, s>>>(rows, ch, nlanes);
    else chain_bp_kernel<false><<<grid, kThreads, 0, s>>>(rows, ch, nlanes);
  } else {
    const bwt_rows::ByteRows b{rows, nullptr, roww};
    if (rec) chain_byte_kernel<true><<<grid, kThreads, 0, s>>>(b, ch, nlanes);
    else chain_byte_kernel<false><<<grid, kThreads, 0, s>>>(b, ch, nlanes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The K pair merges of one level (K = 1: one pair merge): lane j belongs to
// merge kid[j], whose constants are table[kid[j]]; rows are the concatenated
// rank rows, seeds and final ranks global.
extern "C" int bwt_gap_chain_mk(const void* rows, int roww, const void* text, const void* gt,
                                const void* c_first, const void* table, const void* kid,
                                const void* starts, const void* seeds, const void* lens,
                                void* r_out, void* gap, void* samp, int rate, int nlanes,
                                void* stream) {
  Chain ch{};
  ch.text = static_cast<const uint8_t*>(text);
  ch.gt = static_cast<const uint8_t*>(gt);
  ch.c_first = static_cast<const uint32_t*>(c_first);
  ch.table = static_cast<const Merge*>(table);
  ch.kid = static_cast<const int32_t*>(kid);
  ch.starts = static_cast<const int64_t*>(starts);
  ch.seeds = static_cast<const int32_t*>(seeds);
  ch.lens = static_cast<const int32_t*>(lens);
  ch.r_out = static_cast<int32_t*>(r_out);
  ch.gap = static_cast<int32_t*>(gap);
  ch.samp = static_cast<int32_t*>(samp);
  ch.rate = (uint32_t)rate;
  return launch(rows, roww, ch, nlanes, stream);
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
