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
// Ranks and positions are uint32 (n < 2^31 on the paths that call this
// kernel).
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
using bwt_rows::make_bp;
using bwt_rows::make_sector;

enum class Visit { kNone, kVerify, kHarvest, kSelect };

// The lanes and what a step visits.  Lane i starts at rank r0[i] (and, for
// a visit, at text position p0[i]) and takes seg_len[i] steps.
struct Walk {
  const int32_t* r0;
  const int32_t* p0;
  const int32_t* seg_len;
  int32_t* r_out;        // final rank per lane
  uint32_t n;
  const uint8_t* text;   // kVerify: densified text
  int32_t* bad;          // kVerify: mismatches per lane
  uint32_t sarate, isarate;
  int32_t* sa;           // kHarvest: SA[r / sarate] = p
  int32_t* isa;          // kHarvest: ISA[p / isarate] = r
  const uint32_t* bitwords;  // kSelect: bit r set where rank r ends the walk
  int32_t* steps;        // kSelect: steps taken to the hit, -1 without one
};

template <Visit V, class Rows>
__device__ __forceinline__ void walk_lane(const Rows& rows, const Walk& w, int i) {
  uint32_t r = (uint32_t)w.r0[i];
  uint32_t p = V == Visit::kVerify || V == Visit::kHarvest ? (uint32_t)w.p0[i] : 0u;
  const int len = w.seg_len[i];
  int32_t bad = 0;
  int32_t hit = -1;
  for (int k = 0; k < len; ++k) {
    if (V == Visit::kSelect) {
      if ((__ldg(w.bitwords + (r >> 5)) >> (r & 31u)) & 1u) {
        hit = k;
        break;
      }
    }
    if (V == Visit::kHarvest) {
      // every rank and every position is visited by exactly one (lane,
      // step), so the sample writes are direct and race-free
      if (r % w.sarate == 0) w.sa[r / w.sarate] = (int32_t)p;
      if (p % w.isarate == 0) w.isa[p / w.isarate] = (int32_t)r;
    }
    uint32_t sym;
    r = rows.step(r, &sym);  // sym = BWT[r] = text[p - 1]
    if (V == Visit::kVerify || V == Visit::kHarvest) p = p == 0 ? w.n - 1 : p - 1;
    if (V == Visit::kVerify) bad += sym != (uint32_t)__ldg(w.text + p);
  }
  w.r_out[i] = (int32_t)r;
  if (V == Visit::kVerify) w.bad[i] = bad;
  if (V == Visit::kSelect) w.steps[i] = hit;
}

template <Visit V>
__global__ void lf_walk_bp_kernel(const uint8_t* rows, const uint32_t* C, int sigma,
                                  Walk w, int nlanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  walk_lane<V>(make_bp(rows, C, sigma), w, i);
}

template <Visit V>
__global__ void lf_walk_sector_kernel(const uint8_t* rows, const uint32_t* C, int sigma,
                                      Walk w, int nlanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  walk_lane<V>(make_sector(rows, C, sigma), w, i);
}

template <Visit V>
__global__ void lf_walk_byte_kernel(ByteRows rows, Walk w, int nlanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  walk_lane<V>(rows, w, i);
}

template <Visit V>
void launch(const void* rows, int roww, const void* C, int sigma, const Walk& w,
            int nlanes, cudaStream_t s) {
  const int grid = (nlanes + kThreads - 1) / kThreads;
  const auto* rp = static_cast<const uint8_t*>(rows);
  const auto* cp = static_cast<const uint32_t*>(C);
  if (roww == kSectorRowBytes) {
    lf_walk_sector_kernel<V><<<grid, kThreads, 0, s>>>(rp, cp, sigma, w, nlanes);
  } else if (roww == kBpRowBytes) {
    lf_walk_bp_kernel<V><<<grid, kThreads, 0, s>>>(rp, cp, sigma, w, nlanes);
  } else {
    lf_walk_byte_kernel<V><<<grid, kThreads, 0, s>>>(ByteRows{rp, cp, roww}, w, nlanes);
  }
}

}  // namespace

// The row width selects the layout: 32 bytes sector rows, 128 bytes
// bit-plane rows, anything else byte rows (at least 384 bytes wide).  A
// non-null text selects the verify visit, a
// non-null sa_out the harvest visit, a non-null bitwords the select visit
// (seg_len is then each lane's cap of steps); p0 is read only by the verify
// and harvest visits.  Return value: cudaGetLastError() after the launch.
extern "C" int bwt_lf_walk(const void* rows, int roww, const void* C, int sigma,
                           long long n, const void* r0, const void* p0,
                           const void* seg_len, void* r_out, const void* text,
                           void* bad, int sarate, int isarate, void* sa_out,
                           void* isa_out, const void* bitwords, void* steps_out,
                           int nlanes, void* stream) {
  Walk w;
  w.r0 = static_cast<const int32_t*>(r0);
  w.p0 = static_cast<const int32_t*>(p0);
  w.seg_len = static_cast<const int32_t*>(seg_len);
  w.r_out = static_cast<int32_t*>(r_out);
  w.n = (uint32_t)n;
  w.text = static_cast<const uint8_t*>(text);
  w.bad = static_cast<int32_t*>(bad);
  w.sarate = (uint32_t)sarate;
  w.isarate = (uint32_t)isarate;
  w.sa = static_cast<int32_t*>(sa_out);
  w.isa = static_cast<int32_t*>(isa_out);
  w.bitwords = static_cast<const uint32_t*>(bitwords);
  w.steps = static_cast<int32_t*>(steps_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (text) {
    launch<Visit::kVerify>(rows, roww, C, sigma, w, nlanes, s);
  } else if (sa_out) {
    launch<Visit::kHarvest>(rows, roww, C, sigma, w, nlanes, s);
  } else if (bitwords) {
    launch<Visit::kSelect>(rows, roww, C, sigma, w, nlanes, s);
  } else {
    launch<Visit::kNone>(rows, roww, C, sigma, w, nlanes, s);
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
